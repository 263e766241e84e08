"""Config keys and defaults: a copy of the JAX package's
``runtime/constants.py``, so that one JSON config means the same to both
packages."""

#############################################
# Batch-size triangle
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

#############################################
# Optimizer / scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_TYPE = "type"
OPTIMIZER_PARAMS = "params"
MAX_GRAD_NORM = "max_grad_norm"
SCHEDULER = "scheduler"
SCHEDULER_TYPE = "type"
SCHEDULER_PARAMS = "params"

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
ADAGRAD_OPTIMIZER = "adagrad"
SGD_OPTIMIZER = "sgd"
LION_OPTIMIZER = "lion"
DEEPSPEED_OPTIMIZERS = [
    ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER,
    ZERO_ONE_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER, ADAGRAD_OPTIMIZER,
    SGD_OPTIMIZER, LION_OPTIMIZER
]

#############################################
# Precision
#############################################
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_LOSS_SCALE = "loss_scale"
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_HYSTERESIS = "hysteresis"
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_AUTO_CAST = "auto_cast"

BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"
BFLOAT16_ENABLED = "enabled"

#############################################
# Gradients
#############################################
GRADIENT_CLIPPING = "gradient_clipping"
PRESCALE_GRADIENTS = "prescale_gradients"
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
SPARSE_GRADIENTS = "sparse_gradients"
COMMUNICATION_DATA_TYPE = "communication_data_type"

#############################################
# ZeRO
#############################################
ZERO_OPTIMIZATION = "zero_optimization"

#############################################
# Logging / observability
#############################################
STEPS_PER_PRINT = "steps_per_print"
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
DUMP_STATE = "dump_state"
COMMS_LOGGER = "comms_logger"
COMM_COMPRESSION = "comm_compression"
OVERLAP_SCHEDULE = "overlap_schedule"
MEMORY_BREAKDOWN = "memory_breakdown"
TENSORBOARD = "tensorboard"
WANDB = "wandb"
CSV_MONITOR = "csv_monitor"
PROMETHEUS = "prometheus"
TELEMETRY = "telemetry"
STATUSZ = "statusz"
FLIGHT_RECORDER = "flight_recorder"
HOSTAGG = "hostagg"
COMPILE_PLANE = "compile_plane"
PERF_PLANE = "perf_plane"
FLOPS_PROFILER = "flops_profiler"
RESILIENCE = "resilience"

#############################################
# Activation checkpointing
#############################################
ACTIVATION_CHECKPOINTING = "activation_checkpointing"

#############################################
# Misc subsystems
#############################################
GRADIENT_ACCUMULATION_DTYPE = "gradient_accumulation_dtype"
ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
ZERO_FORCE_DS_CPU_OPTIMIZER = "zero_force_ds_cpu_optimizer"
DISABLE_ALLGATHER = "disable_allgather"
DATALOADER_DROP_LAST = "dataloader_drop_last"
PIPELINE = "pipeline"
COMPRESSION_TRAINING = "compression_training"
DATA_EFFICIENCY = "data_efficiency"
DATA_SAMPLING = "data_sampling"      # data_efficiency's curriculum part
CURRICULUM_LEARNING_LEGACY = "curriculum_learning"
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
ELASTICITY = "elasticity"
AUTOTUNING = "autotuning"
# the measured-trials sweep (autotuning/measure.py AutotuneConfig):
# consumed by `ds_tpu_tune --measure`, carried inert by the engine
AUTOTUNE = "autotune"
EIGENVALUE = "eigenvalue"
QUANTIZE_TRAINING = "quantize_training"
CHECKPOINT = "checkpoint"
LOAD_UNIVERSAL_CHECKPOINT = "load_universal_checkpoint"
USE_DATA_BEFORE_EXPERT_PARALLEL = "use_data_before_expert_parallelism"
SEQUENCE_PARALLEL_SIZE = "sequence_parallel_size"
TENSOR_PARALLEL_SIZE = "tensor_parallel_size"
PIPELINE_PARALLEL_SIZE = "pipeline_parallel_size"
EXPERT_PARALLEL_SIZE = "expert_parallel_size"

#############################################
# Defaults
#############################################
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None
STEPS_PER_PRINT_DEFAULT = 10
GRADIENT_CLIPPING_DEFAULT = 0.0
PRESCALE_GRADIENTS_DEFAULT = False
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0
SPARSE_GRADIENTS_DEFAULT = False
WALL_CLOCK_BREAKDOWN_DEFAULT = False
DUMP_STATE_DEFAULT = False
DATALOADER_DROP_LAST_DEFAULT = False

FP16_ENABLED_DEFAULT = False
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER_DEFAULT = 16
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE_DEFAULT = 1.0
BFLOAT16_ENABLED_DEFAULT = False
