"""``comm_compression``: the policy of the compression-aware collective
dispatch, the JAX package's ``comm/compression.py``.

Every collective of ``comm/comm.py`` consults this module's
process-global config. Per collective the policy is one of:

- ``"off"``: the collective runs exactly as it did before the dispatch
  existed (the same ``torch.distributed`` call);
- ``"fp32"``: full-precision payloads, accounted through the same
  dispatch (the byte baseline the compressed runs are measured against);
- ``"int8"``: blockwise int8 payload + one f32 scale a block (ZeRO++
  qwZ / qgZ, arxiv 2306.10209);
- ``"fp8_block"``: the same codec with an fp8 (e4m3) carrier.

``hierarchical`` turns the quantized reduce-scatter into the two-level
exchange: a full-precision reduce-scatter within a host, then the
quantized exchange across hosts (``comm/quantized.py``,
``parallel/topology.hierarchical_axis_groups``).

The config is process-global, as the comms logger is. ``DeepSpeedEngine``
installs it from the ``"comm_compression"`` block at init.
"""

import dataclasses
import os
from typing import Sequence

from ..runtime.config_utils import ConfigError, DeepSpeedConfigModel

#: collectives the dispatch can compress (ppermute is point-to-point and
#: stays full precision; ``scatter`` rides the broadcast policy)
COMPRESSIBLE_OPS = ("all_reduce", "all_gather", "reduce_scatter",
                    "all_to_all", "broadcast")
POLICIES = ("off", "fp32", "int8", "fp8_block")


@dataclasses.dataclass
class CommCompressionConfig(DeepSpeedConfigModel):
    """The ``"comm_compression"`` config block."""
    enabled: bool = False
    #: per-collective policy: off | fp32 | int8 | fp8_block
    all_reduce: str = "off"
    all_gather: str = "off"
    reduce_scatter: str = "off"
    all_to_all: str = "off"
    broadcast: str = "off"
    #: values per f32 scale block of the blockwise wire codec
    block_size: int = 256
    #: mesh axes whose collectives may compress; collectives over any other
    #: axis (pipe/model/seq) always run at full precision
    allowed_axes: Sequence[str] = ("data", "expert")
    #: two-level reduce-scatter (intra-host full precision, inter-host
    #: quantized) when the axis spans hosts
    hierarchical: bool = True
    #: members of the compressed axis per host; 0 = the launcher's
    #: LOCAL_WORLD_SIZE. The multi-rank tests on one machine set it to
    #: model a multi-host wire.
    devices_per_host: int = 0
    #: tensors smaller than this many bytes never compress
    min_bytes: int = 2048

    def validate(self):
        for op in COMPRESSIBLE_OPS:
            pol = getattr(self, op)
            if pol not in POLICIES:
                raise ConfigError(
                    f"comm_compression.{op} must be one of {POLICIES}, "
                    f"got {pol!r}")
            if pol == "fp8_block":
                from ..ops.quant_core import FP8_DTYPE
                if FP8_DTYPE is None:
                    raise ConfigError(
                        "comm_compression: fp8_block needs a torch with "
                        "float8_e4m3fn; use int8")
        if self.block_size < 1:
            raise ConfigError("comm_compression.block_size must be >= 1")
        if self.devices_per_host < 0:
            raise ConfigError(
                "comm_compression.devices_per_host must be >= 0")
        if self.min_bytes < 0:
            raise ConfigError("comm_compression.min_bytes must be >= 0")
        self.allowed_axes = tuple(self.allowed_axes)

    # ---------------------------------------------------------------- policy
    def _axis_allowed(self, axis_name) -> bool:
        axes = axis_name if isinstance(axis_name, (tuple, list)) \
            else (axis_name,)
        return all(str(a) in self.allowed_axes for a in axes)

    def policy_for(self, op: str, axis_name, nbytes: int) -> str:
        """The effective policy of one collective call."""
        if not self.enabled:
            return "off"
        pol = getattr(self, op, "off")
        if pol == "off":
            return "off"
        if not self._axis_allowed(axis_name):
            return "off"
        if pol in ("int8", "fp8_block") and nbytes < self.min_bytes:
            # still dispatched (the byte accounting stays comparable), at
            # full precision
            return "fp32"
        return pol

    def local_members(self, axis_size: int) -> int:
        """Members of a size-``axis_size`` compressed axis that share a
        host: the configured ``devices_per_host``, else the launcher's
        ``LOCAL_WORLD_SIZE``, when it splits the axis into (host, local);
        0 when no split exists (one host, or indivisible)."""
        n = self.devices_per_host
        if n == 0:
            n = int(os.environ.get("LOCAL_WORLD_SIZE", 0) or 0)
        if n <= 1 or n >= axis_size or axis_size % n:
            return 0
        return n

    @property
    def zero_path_active(self) -> bool:
        """Whether the engine routes the ZeRO exchanges through the explicit
        path: any policy a ZeRO step uses is not off (``fp32`` counts: it
        is the byte baseline of the compressed path)."""
        return self.enabled and any(
            getattr(self, op) != "off"
            for op in ("all_reduce", "all_gather", "reduce_scatter"))


_CC = CommCompressionConfig()


def get_comm_compression() -> CommCompressionConfig:
    return _CC


def configure_comm_compression(config) -> CommCompressionConfig:
    """Install the process-global policy from a config object or the raw
    dict of the ``comm_compression`` block; returns it."""
    global _CC
    if isinstance(config, dict):
        config = CommCompressionConfig.from_dict(config)
    _CC = config
    return _CC


def reset_comm_compression():
    global _CC
    _CC = CommCompressionConfig()
