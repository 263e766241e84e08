"""Inference config: the JSON surface of the JAX package's
``DeepSpeedInferenceConfig`` (dtype, tensor_parallel.tp_size,
max_out_tokens, replace_with_kernel_inject, ...), with the same keys,
aliases and ``ConfigError``s. Dtype names map to ``torch`` dtypes.

``checkpoint`` names a training checkpoint directory (either package's)
that the engine loads at start. ``tensor_parallel.tp_size`` (or
``mp_size``) serves over the rank mesh's ``model`` axis; ``quant`` (or
``dtype: int8``, which means int8 weights with bf16 compute) serves int8
weight-only (``inference/quantization.py``).
"""

import dataclasses
from typing import Any, Optional

import torch

from ..runtime.config_utils import ConfigError, DeepSpeedConfigModel
from ..utils.logging import logger

_DTYPES = {
    "float32": torch.float32, "fp32": torch.float32,
    "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "int8": torch.int8,
}


@dataclasses.dataclass
class DeepSpeedTPConfig(DeepSpeedConfigModel):
    enabled: bool = True
    tp_size: int = 1
    mpu: Any = None
    tp_group: Any = None

    def validate(self):
        if self.tp_size < 1:
            raise ConfigError(f"tp_size must be >= 1, got {self.tp_size}")


@dataclasses.dataclass
class DeepSpeedMoEConfig(DeepSpeedConfigModel):
    enabled: bool = False
    ep_size: int = 1
    moe_experts: Any = dataclasses.field(default_factory=lambda: [1])
    type: str = "standard"


@dataclasses.dataclass
class QuantizationConfig(DeepSpeedConfigModel):
    enabled: bool = False
    bits: int = 8
    group_size: int = 64


@dataclasses.dataclass
class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    kernel_inject: bool = False            # replace_with_kernel_inject
    dtype: Any = "bfloat16"
    tensor_parallel: Any = None            # dict -> DeepSpeedTPConfig
    injection_policy: Any = None
    replace_method: str = "auto"
    moe: Any = None
    quant: Any = None
    checkpoint: Optional[str] = None
    base_dir: str = ""
    max_tokens: int = 1024                 # alias: max_out_tokens
    min_out_tokens: int = 1
    max_batch_size: Optional[int] = None
    enable_cuda_graph: bool = False        # accepted; warns (runs eagerly)
    triangular_masking: bool = True
    return_tuple: bool = True
    training_mp_size: int = 1
    replace_with_kernel_inject: bool = False
    mp_size: int = 1                       # deprecated alias for tp_size
    seed: int = 0
    # bounds the JAX package's compiled-program cache; accepted and checked
    # for config compatibility, the eager port compiles no programs
    compiled_cache_size: int = 64

    ALIASES = {"max_out_tokens": "max_tokens"}

    def validate(self):
        if isinstance(self.dtype, str):
            key = self.dtype.lower().replace("torch.", "")
            if key not in _DTYPES:
                raise ConfigError(f"unknown inference dtype {self.dtype!r}; "
                                  f"one of {sorted(_DTYPES)}")
            self.dtype = _DTYPES[key]
        if self.tensor_parallel is None:
            self.tensor_parallel = DeepSpeedTPConfig(
                tp_size=max(self.mp_size, 1))
        elif isinstance(self.tensor_parallel, dict):
            self.tensor_parallel = DeepSpeedTPConfig.from_dict(
                self.tensor_parallel)
        if self.mp_size > 1 and self.tensor_parallel.tp_size == 1:
            self.tensor_parallel.tp_size = self.mp_size
        if isinstance(self.moe, dict):
            self.moe = DeepSpeedMoEConfig.from_dict(self.moe)
        elif isinstance(self.moe, bool):
            self.moe = DeepSpeedMoEConfig(enabled=self.moe)
        if isinstance(self.quant, dict):
            self.quant = QuantizationConfig.from_dict(self.quant)
        elif isinstance(self.quant, bool):
            self.quant = QuantizationConfig(enabled=self.quant)
        if self.dtype is torch.int8:
            # int8 means weight-only quantized serving with bf16 compute
            if self.quant is None:
                self.quant = QuantizationConfig(enabled=True)
            self.quant.enabled = True
            self.dtype = torch.bfloat16
        if self.quant is not None and self.quant.enabled and \
                self.quant.bits != 8:
            raise ConfigError(
                f"weight-only quantized serving supports bits=8 "
                f"(got {self.quant.bits})")
        if self.enable_cuda_graph:
            logger.warning("enable_cuda_graph is not ported yet: the engine "
                           "runs eagerly")
        if self.kernel_inject or self.replace_with_kernel_inject:
            self.kernel_inject = self.replace_with_kernel_inject = True
        if self.max_tokens < 1:
            raise ConfigError("max_tokens must be >= 1")
        if self.compiled_cache_size < 0:
            raise ConfigError("compiled_cache_size must be >= 0 "
                              "(0 disables eviction)")

