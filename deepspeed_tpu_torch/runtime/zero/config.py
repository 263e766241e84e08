"""ZeRO configuration: the JAX package's ``DeepSpeedZeroConfig`` key surface
(``runtime/zero/config.py``), with the same keys, aliases, legacy offload
flags and ``ConfigError``s.

Stages 0-3 run (``runtime/zero/partition.py``, ``runtime/engine.py``);
``stage3_param_persistence_threshold`` keeps small leaves replicated at
stage 3, as in the JAX package. An active ``offload_optimizer`` or
``offload_param`` raises ``NotImplementedError`` naming ROADMAP.md row
A11. The bucket and prefetch knobs are parsed for config compatibility;
the bucketed exchange is the ``overlap_schedule`` block
(``runtime/zero/overlap_schedule.py``).
"""

import dataclasses
from enum import IntEnum
from typing import Optional

from ..config_utils import ConfigError, DeepSpeedConfigModel


class ZeroStageEnum(IntEnum):
    disabled = 0
    optimizer_states = 1
    gradients = 2
    weights = 3
    max_stage = 3


class OffloadDeviceEnum:
    none = "none"
    cpu = "cpu"
    nvme = "nvme"


@dataclasses.dataclass
class DeepSpeedZeroOffloadParamConfig(DeepSpeedConfigModel):
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False

    def validate(self):
        if self.device not in ("none", "cpu", "nvme"):
            raise ConfigError(f"offload_param.device must be none|cpu|nvme, got {self.device}")


@dataclasses.dataclass
class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigModel):
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0

    @property
    def pipeline(self) -> bool:
        return bool(self.pipeline_read or self.pipeline_write)

    def validate(self):
        if self.device not in ("none", "cpu", "nvme"):
            raise ConfigError(f"offload_optimizer.device must be none|cpu|nvme, got {self.device}")


def _device(o):
    """The offload device of a nested config or its dict (``validate`` runs
    both before and after the nested dicts are converted)."""
    if o is None:
        return OffloadDeviceEnum.none
    dev = o.get("device") if isinstance(o, dict) else getattr(o, "device", None)
    return dev or OffloadDeviceEnum.none


@dataclasses.dataclass
class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    """One-to-one key surface with the JAX package's DeepSpeedZeroConfig."""
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: Optional[DeepSpeedZeroOffloadParamConfig] = None
    offload_optimizer: Optional[DeepSpeedZeroOffloadOptimizerConfig] = None
    sub_group_size: int = 1_000_000_000
    stage3_max_live_parameters: int = 1_000_000_000
    stage3_max_reuse_distance: int = 1_000_000_000
    stage3_prefetch_bucket_size: int = 50_000_000
    stage3_param_persistence_threshold: int = 100_000
    stage3_model_persistence_threshold: int = 9_223_372_036_854_775_807
    stage3_gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    memory_efficient_linear: bool = True

    ALIASES = {
        "stage3_gather_fp16_weights_on_model_save":
            "stage3_gather_16bit_weights_on_model_save",
        "cpu_offload_param": "offload_param",
        "cpu_offload_use_pin_memory": "offload_param",
        "cpu_offload": "offload_optimizer",
    }

    @classmethod
    def from_dict(cls, data=None, **overrides):
        data = dict(data or {})
        # legacy boolean offload flags -> nested configs
        if data.pop("cpu_offload", None):
            data.setdefault("offload_optimizer", {"device": "cpu"})
        if data.pop("cpu_offload_params", None):
            data.setdefault("offload_param", {"device": "cpu"})
        data.pop("cpu_offload_use_pin_memory", None)
        obj = super().from_dict(data, **overrides)
        if isinstance(obj.offload_param, dict):
            obj.offload_param = DeepSpeedZeroOffloadParamConfig.from_dict(obj.offload_param)
        if isinstance(obj.offload_optimizer, dict):
            obj.offload_optimizer = DeepSpeedZeroOffloadOptimizerConfig.from_dict(
                obj.offload_optimizer)
        obj.validate()
        return obj

    def validate(self):
        if not 0 <= int(self.stage) <= ZeroStageEnum.max_stage:
            raise ConfigError(f"zero_optimization.stage must be in [0, 3], got {self.stage}")
        if self.overlap_comm is None:
            self.overlap_comm = int(self.stage) == ZeroStageEnum.weights
        if self.zero_quantized_weights or self.zero_quantized_gradients:
            raise ConfigError(
                "zero_quantized_weights/gradients (ZeRO++ knobs, post-dating "
                "the reference version) are not wired into the dp gradient "
                "reduction; for compressed communication use the 1-bit "
                "optimizer family (optimizer.type: OneBitAdam/OneBitLamb/"
                "ZeroOneAdam — ops/compressed_collectives.py)")
        if _device(self.offload_param) != OffloadDeviceEnum.none:
            if int(self.stage) != ZeroStageEnum.weights:
                raise ConfigError(
                    f"offload_param requires zero_optimization.stage=3 "
                    f"(got stage {self.stage})")
            if _device(self.offload_optimizer) == OffloadDeviceEnum.none:
                raise ConfigError(
                    "offload_param requires offload_optimizer: weights that "
                    "exceed HBM imply fp32 masters + moments (16 bytes/param)"
                    " cannot stay on-device either")
        # what the JAX package accepts and this port cannot run yet
        if _device(self.offload_optimizer) != OffloadDeviceEnum.none or \
                _device(self.offload_param) != OffloadDeviceEnum.none:
            raise NotImplementedError(
                "ZeRO offload (offload_optimizer / offload_param) is not "
                "ported yet: ROADMAP.md row A11")
