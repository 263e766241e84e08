"""Random layer-token-drop (random-LTD), as the JAX package's
``runtime/data_pipeline/random_ltd.py``: the kept-token schedule. The
model samples, gathers and scatters each layer's tokens itself
(``ops/random_ltd_ops.py``, ``models/gpt2.py``), so that the indices are
drawn outside a layer's activation checkpoint; the block runs on the
gathered tokens at positions ``0..keep-1``, as the JAX block does.
"""

from typing import Dict


class RandomLTDScheduler:
    """Kept tokens per step: ``fixed_linear`` from ``min_value`` to
    ``max_value`` over ``require_steps``, in steps of ``seq_per_step``."""

    def __init__(self, config: Dict):
        sched = config.get("random_ltd_schedule", {})
        self.min_value = int(sched.get("min_value",
                                       config.get("min_value", 128)))
        self.max_value = int(sched.get("max_value",
                                       config.get("max_value", 1024)))
        sc = sched.get("schedule_config", {})
        self.seq_per_step = int(sc.get("seq_per_step", 16))
        self.require_steps = int(sc.get("require_steps", 1000))
        self.schedule_type = sched.get("schedule_type", "fixed_linear")
        if self.schedule_type != "fixed_linear":
            raise ValueError(f"unknown random-ltd schedule "
                             f"{self.schedule_type}")

    def get_current_seq(self, global_step: int) -> int:
        frac = min(1.0, max(0, global_step) / max(1, self.require_steps))
        val = self.min_value + frac * (self.max_value - self.min_value)
        if val >= self.max_value:
            return self.max_value
        val = int(val) - int(val) % self.seq_per_step
        return max(self.min_value, val)

    def is_fully_ramped(self, global_step: int) -> bool:
        return self.get_current_seq(global_step) >= self.max_value

