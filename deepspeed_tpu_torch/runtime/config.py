"""DeepSpeedConfig: the training config of the JAX package's
``runtime/config.py``, for the blocks this port runs.

Parsed as in the JAX package, with the same ``ConfigError`` texts: the
batch triangle (``train_batch_size = micro × gradient_accumulation_steps ×
dp``), ``fp16`` / ``bf16``, ``optimizer``, ``scheduler``,
``gradient_clipping``, ``gradient_accumulation_dtype``, ``steps_per_print``,
``seed``, ``zero_optimization``, ``comms_logger``, ``comm_compression``,
``overlap_schedule``, ``activation_checkpointing``,
``progressive_layer_drop``, ``data_efficiency.data_routing``
(random-LTD), ``checkpoint``, ``nebula``, ``load_universal_checkpoint`` and
the checkpoint keys of ``resilience``.

Every other block the JAX config parses is accepted while it is disabled
(or at its default) and raises ``NotImplementedError`` naming its
ROADMAP.md row when it asks for something: see ``UNPORTED``.
"""

import dataclasses
import json
import os
from typing import Any, Dict, Optional

from . import constants as C
from .config_utils import ConfigError, DeepSpeedConfigModel
from .zero.config import DeepSpeedZeroConfig
from ..resilience.config import ResilienceConfig, unported_keys
from ..utils.logging import logger


@dataclasses.dataclass
class FP16Config(DeepSpeedConfigModel):
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0
    fp16_master_weights_and_grads: bool = False

    @property
    def dynamic_loss_scale(self):
        return self.loss_scale == 0


@dataclasses.dataclass
class BF16Config(DeepSpeedConfigModel):
    enabled: bool = False
    immediate_grad_update: bool = False


@dataclasses.dataclass
class OptimizerConfig(DeepSpeedConfigModel):
    type: str = "adamw"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    legacy_fusion: bool = False

    def validate(self):
        self.type = self.type.lower()


@dataclasses.dataclass
class SchedulerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CommsLoggerConfig(DeepSpeedConfigModel):
    """The ``comms_logger`` block (reference utils/comms_logging.py)."""
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    """The ``activation_checkpointing`` block (the JAX package's, and the
    reference's ``checkpointing.configure()``)."""
    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


@dataclasses.dataclass
class CheckpointConfig(DeepSpeedConfigModel):
    """The ``checkpoint`` block, as the JAX package parses it.
    ``async_save`` warns and takes the msgpack engine (no orbax on the
    card); ``tag_validation`` is parsed and checked, as there."""
    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: Dict[str, Any] = dataclasses.field(default_factory=dict)
    async_save: bool = False

    def validate(self):
        if str(self.tag_validation).lower() not in ("ignore", "warn", "fail"):
            raise ConfigError(
                "checkpoint.tag_validation must be Ignore|Warn|Fail")


def _enabled(block):
    return isinstance(block, dict) and bool(block.get("enabled"))


def _above_one(value):
    return int(value) > 1


def _truthy(value):
    return bool(value)


def _data_sampling(block):
    """data_efficiency asks for curriculum data sampling when it is enabled
    and its ``data_sampling`` part is (``data_routing``, random-LTD, is
    ported)."""
    return _enabled(block) and _enabled(block.get(C.DATA_SAMPLING))


# key -> (ROADMAP.md row, what the port cannot run yet, "asks for it")
UNPORTED = {
    C.PIPELINE_PARALLEL_SIZE: ("A11", "pipeline parallelism", _above_one),
    C.SEQUENCE_PARALLEL_SIZE: ("A11", "sequence parallelism", _above_one),
    C.EXPERT_PARALLEL_SIZE: ("A11", "expert parallelism", _above_one),
    C.PIPELINE: ("A11", "the pipeline engine", _enabled),
    C.DATA_EFFICIENCY: ("A12", "curriculum data sampling "
                        "(data_efficiency.data_sampling)", _data_sampling),
    C.CURRICULUM_LEARNING_LEGACY: ("A12", "curriculum learning", _enabled),
    C.COMPRESSION_TRAINING: ("A12", "compression training", _truthy),
    C.QUANTIZE_TRAINING: ("A12", "MoQ quantize_training", _enabled),
    C.ELASTICITY: ("A12", "elasticity", _enabled),
    C.TELEMETRY: ("A12", "telemetry", _enabled),
    C.STATUSZ: ("A12", "the statusz server", _enabled),
    C.FLIGHT_RECORDER: ("A12", "the flight recorder", _enabled),
    C.HOSTAGG: ("A12", "host aggregation", _enabled),
    C.FLOPS_PROFILER: ("A12", "the flops profiler", _enabled),
    C.TENSORBOARD: ("A12", "the tensorboard monitor", _enabled),
    C.WANDB: ("A12", "the wandb monitor", _enabled),
    C.CSV_MONITOR: ("A12", "the csv monitor", _enabled),
    C.PROMETHEUS: ("A12", "the prometheus monitor", _enabled),
    C.COMPILE_PLANE: ("A13", "the compile plane", _enabled),
    C.PERF_PLANE: ("A13", "the perf plane", _enabled),
    C.RESILIENCE: ("A12", "preemption handling, autosave or the training "
                   "sentinel (resilience.handle_signals, "
                   "emergency_checkpoint_dir, autosave_interval > 0, "
                   "sentinel_policy other than 'off')",
                   lambda block: bool(unported_keys(block))),
    C.WALL_CLOCK_BREAKDOWN: ("A12", "wall_clock_breakdown timers", _truthy),
    C.MEMORY_BREAKDOWN: ("A12", "memory_breakdown", _truthy),
    "hybrid_engine": ("A12", "the hybrid engine", _enabled),
    "lora": ("A12", "LoRA", _enabled),
}


class DeepSpeedConfig:
    """Parse and validate the training config, as the JAX package's
    ``DeepSpeedConfig`` does for the blocks this port runs."""

    def __init__(self, config: Any, world_size: Optional[int] = None,
                 mpu=None):
        if isinstance(config, str):
            if not os.path.exists(config):
                raise ConfigError(f"Config file not found: {config}")
            with open(config) as f:
                self._param_dict = json.load(f)
        elif isinstance(config, dict):
            self._param_dict = dict(config)
        elif config is None:
            self._param_dict = {}
        else:
            raise ConfigError(
                f"Expected a dict or json path for config, got {type(config)}")

        pd = self._param_dict
        # kept as the JAX package keeps it: nothing reads it, the rank
        # mesh's 'model' axis is the tensor parallelism
        self.mpu = mpu
        for key, (row, what, asks) in UNPORTED.items():
            if key in pd and asks(pd[key]):
                raise NotImplementedError(
                    f"config '{key}' asks for {what}, which is not ported "
                    f"yet: ROADMAP.md row {row}")

        # ---- parallel sizes: data and tensor parallelism over the ranks;
        #      pipeline, sequence and expert parallelism are refused above
        #      (row A11). The batch triangle is over the dp world.
        self.tensor_parallel_size = int(pd.get(C.TENSOR_PARALLEL_SIZE, 1))
        self.pipeline_parallel_size = int(pd.get(C.PIPELINE_PARALLEL_SIZE, 1))
        self.sequence_parallel_size = int(pd.get(C.SEQUENCE_PARALLEL_SIZE, 1))
        self.expert_parallel_size = int(pd.get(C.EXPERT_PARALLEL_SIZE, 1))
        # the world is the topology's ranks (1 without a process group)
        self.world_size = 1 if world_size is None else int(world_size)
        model_parallel = (self.tensor_parallel_size *
                          self.pipeline_parallel_size *
                          self.sequence_parallel_size)
        if self.world_size % model_parallel != 0:
            raise ConfigError(
                f"world size {self.world_size} not divisible by "
                f"tp*pp*sp={model_parallel}")
        self.data_parallel_size = self.world_size // model_parallel

        # ---- batch triangle ----
        self.train_batch_size = pd.get(C.TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = pd.get(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = pd.get(C.GRADIENT_ACCUMULATION_STEPS)
        self._configure_train_batch_size()

        # ---- subsystem models ----
        self.optimizer = (OptimizerConfig.from_dict(pd[C.OPTIMIZER])
                          if C.OPTIMIZER in pd else None)
        self.scheduler = (SchedulerConfig.from_dict(pd[C.SCHEDULER])
                          if C.SCHEDULER in pd else None)
        self.fp16 = FP16Config.from_dict(pd.get(C.FP16, {}))
        bf16_dict = pd.get(C.BFLOAT16, pd.get(C.BFLOAT16_OLD, {}))
        self.bf16 = BF16Config.from_dict(bf16_dict)
        if self.fp16.enabled and self.bf16.enabled:
            raise ConfigError("fp16 and bf16 cannot both be enabled")
        self.zero_config = DeepSpeedZeroConfig.from_dict(pd.get(C.ZERO_OPTIMIZATION, {}))
        self.comms_logger = CommsLoggerConfig.from_dict(
            pd.get(C.COMMS_LOGGER, {}))
        # the quantized / hierarchical collective policy (comm/
        # compression.py): per-collective off|fp32|int8|fp8_block wire
        # formats behind the comm dispatch
        from ..comm.compression import CommCompressionConfig
        self.comm_compression = CommCompressionConfig.from_dict(
            pd.get(C.COMM_COMPRESSION) or {})
        # the bucketed ZeRO exchange (runtime/zero/overlap_schedule.py):
        # size-targeted layer-order buckets through coalesced collectives
        from .zero.overlap_schedule import OverlapScheduleConfig
        self.overlap_schedule = OverlapScheduleConfig.from_dict(
            pd.get(C.OVERLAP_SCHEDULE) or {})
        # the engine turns remat on whenever the block is present
        self.activation_checkpointing = \
            ActivationCheckpointingConfig.from_dict(
                pd.get(C.ACTIVATION_CHECKPOINTING) or {})
        self.progressive_layer_drop = pd.get(C.PROGRESSIVE_LAYER_DROP) or {}
        self.data_efficiency = pd.get(C.DATA_EFFICIENCY) or {}
        self.checkpoint_config = CheckpointConfig.from_dict(
            pd.get(C.CHECKPOINT, {}))
        # checkpoint integrity, fallback, retention and retries
        self.resilience = ResilienceConfig.from_dict(pd.get(C.RESILIENCE, {}))
        # every tag is universal: whole arrays load under any layout
        self.load_universal_checkpoint = pd.get(C.LOAD_UNIVERSAL_CHECKPOINT,
                                                False)

        # ---- scalars ----
        self.steps_per_print = pd.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT)
        self.gradient_clipping = float(pd.get(C.GRADIENT_CLIPPING,
                                              C.GRADIENT_CLIPPING_DEFAULT))
        self.sparse_gradients_enabled = pd.get(C.SPARSE_GRADIENTS,
                                               C.SPARSE_GRADIENTS_DEFAULT)
        self.gradient_accumulation_dtype = pd.get(C.GRADIENT_ACCUMULATION_DTYPE, None)
        if self.gradient_accumulation_dtype is not None and \
                str(self.gradient_accumulation_dtype) not in (
                    "fp32", "float32", "bf16", "bfloat16"):
            raise ConfigError(
                f"gradient_accumulation_dtype must be fp32|bf16, got "
                f"{self.gradient_accumulation_dtype}")
        self.dataloader_drop_last = pd.get(C.DATALOADER_DROP_LAST,
                                           C.DATALOADER_DROP_LAST_DEFAULT)
        self.seed = pd.get("seed", 42)

    # -- batch triangle solver, as the JAX package's (config.py:501-542)
    def _configure_train_batch_size(self):
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        dp = self.data_parallel_size

        if all(v is not None for v in (train, micro, gas)):
            if train != micro * gas * dp:
                raise ConfigError(
                    f"Check batch related parameters. train_batch_size is not equal to "
                    f"micro_batch_per_gpu * gradient_acc_step * world_size "
                    f"{train} != {micro} * {gas} * {dp}")
        elif train is not None and micro is not None:
            gas = train // (micro * dp)
            if train % (micro * dp) != 0:
                raise ConfigError(
                    f"train_batch_size {train} not divisible by micro_batch*dp {micro * dp}")
        elif train is not None and gas is not None:
            micro = train // (gas * dp)
            if train % (gas * dp) != 0:
                raise ConfigError(
                    f"train_batch_size {train} not divisible by gas*dp {gas * dp}")
        elif micro is not None and gas is not None:
            train = micro * gas * dp
        elif train is not None:
            gas = 1
            micro = train // dp
            if train % dp != 0:
                raise ConfigError(f"train_batch_size {train} not divisible by dp {dp}")
        elif micro is not None:
            gas = 1
            train = micro * dp
        else:
            raise ConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu needs to be provided")

        if train <= 0 or micro <= 0 or gas <= 0:
            raise ConfigError(
                f"batch sizes must be positive: train={train} micro={micro} gas={gas}")
        self.train_batch_size = int(train)
        self.train_micro_batch_size_per_gpu = int(micro)
        self.gradient_accumulation_steps = int(gas)

    @property
    def zero_enabled(self):
        return self.zero_config.stage > 0

    @property
    def zero_optimization_stage(self):
        return self.zero_config.stage

    def print_config(self):
        logger.info(f"DeepSpeedConfig: {json.dumps(self._param_dict, indent=2, default=str)}")
