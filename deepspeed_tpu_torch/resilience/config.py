"""ResilienceConfig — the ``"resilience"`` config block, as the JAX
package's ``resilience/config.py`` parses it.

The checkpoint keys are ported: ``verify_on_load``,
``fallback_on_corruption``, ``keep_last_n``, ``save_retries``,
``load_retries``, ``retry_backoff_s`` and ``retry_max_backoff_s``. The
rest of the block is parsed and checked as in the JAX package; what asks
for preemption handling, autosave or the training sentinel
(``handle_signals``, ``emergency_checkpoint_dir``, ``autosave_interval >
0``, ``sentinel_policy`` other than ``"off"``) is refused by the training
config naming ROADMAP.md row A12 (``UNPORTED_KEYS``).
"""

import dataclasses
from typing import Optional

from ..runtime.config_utils import ConfigError, DeepSpeedConfigModel

__all__ = ["ResilienceConfig", "SENTINEL_POLICIES", "UNPORTED_KEYS",
           "unported_keys"]

SENTINEL_POLICIES = ("off", "warn", "skip", "rollback")

#: key -> "asks for it", for the keys whose features are ROADMAP.md row A12
UNPORTED_KEYS = {
    "handle_signals": bool,
    "emergency_checkpoint_dir": lambda v: v is not None,
    "autosave_interval": lambda v: int(v) > 0,
    "sentinel_policy": lambda v: v != "off",
}


def unported_keys(block) -> list:
    """The keys of a ``resilience`` block that ask for a feature of row
    A12."""
    block = block if isinstance(block, dict) else {}
    return sorted(k for k, asks in UNPORTED_KEYS.items()
                  if k in block and asks(block[k]))


@dataclasses.dataclass
class ResilienceConfig(DeepSpeedConfigModel):
    # ---- checkpoint integrity -------------------------------------------
    #: verify the per-file SHA-256 manifest before loading a tag
    verify_on_load: bool = True
    #: on a corrupt/partial tag, fall back newest→oldest to the most
    #: recent valid tag instead of failing the load
    fallback_on_corruption: bool = True
    #: keep only the newest N tags after each successful save (0 = keep all)
    keep_last_n: int = 0

    # ---- retryable IO ---------------------------------------------------
    #: retry attempts (beyond the first try) for each engine save/load call
    save_retries: int = 0
    load_retries: int = 0
    #: first backoff delay; doubles per retry up to retry_max_backoff_s,
    #: with uniform jitter in [0.5x, 1.5x]
    retry_backoff_s: float = 0.5
    retry_max_backoff_s: float = 8.0

    # ---- preemption, autosave, sentinel (ROADMAP.md row A12) -------------
    handle_signals: bool = False
    emergency_checkpoint_dir: Optional[str] = None
    autosave_interval: int = 0
    autosave_dir: Optional[str] = None
    sentinel_policy: str = "off"
    sentinel_patience: int = 1
    sentinel_grad_norm_threshold: float = 0.0
    max_rollbacks: int = 3

    def validate(self):
        if self.sentinel_policy not in SENTINEL_POLICIES:
            raise ConfigError(
                f"resilience.sentinel_policy must be one of "
                f"{SENTINEL_POLICIES}, got {self.sentinel_policy!r}")
        for name in ("keep_last_n", "save_retries", "load_retries",
                     "autosave_interval"):
            if getattr(self, name) < 0:
                raise ConfigError(f"resilience.{name} must be >= 0")
        if self.sentinel_patience < 1:
            raise ConfigError("resilience.sentinel_patience must be >= 1")
        if self.max_rollbacks < 0:
            raise ConfigError("resilience.max_rollbacks must be >= 0")
        if self.retry_backoff_s < 0 or self.retry_max_backoff_s < 0:
            raise ConfigError("resilience retry backoffs must be >= 0")
        if self.sentinel_grad_norm_threshold < 0:
            raise ConfigError(
                "resilience.sentinel_grad_norm_threshold must be >= 0")
        if self.autosave_interval and not self.autosave_dir:
            raise ConfigError(
                "resilience.autosave_interval requires autosave_dir")
