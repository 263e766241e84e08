"""deepspeed_tpu_torch — the PyTorch / CUDA port of deepspeed_tpu for NVIDIA
Hopper.

The JAX package ``deepspeed_tpu`` is the reference this port is held
against; the port imports neither JAX nor that package. Its kernels are
hand-written for ``sm_90a`` (``csrc/``) and built by ``nvcc`` at first use
(``ops/kernel_build.py``); each has a plain PyTorch version that tensors on
the CPU take. It serves GPT-2, LLaMA, OPT, GPT-NeoX, GPT-J, BLOOM,
GPT-Neo and BERT, and HF modules of those families (``module_inject``),
through ``init_inference``, and trains them through ``initialize`` ->
``DeepSpeedEngine.train_batch``;
``ops/sparse_attention_utils.SparseAttentionUtils`` puts block-sparse
attention into BERT. Checkpoints are the JAX package's format: a tag
either package writes loads in the other. Training runs over
``torch.distributed`` ranks (``comm``, ``init_distributed``, the rank
topology of ``parallel``) with ZeRO stages 0-3 (``zero``).
"""

__version__ = "0.1.0"

from .utils.logging import logger, log_dist  # noqa: E402
from . import comm  # noqa: E402
from . import zero  # noqa: E402
from .comm import init_distributed  # noqa: E402
from .parallel import (DeviceMeshManager, ProcessTopology,  # noqa: E402
                       initialize_mesh)


def init_inference(model, config=None, device=None, **kwargs):
    """Initialise the inference engine, as ``deepspeed_tpu.init_inference``.

    ``model`` is a deepspeed_tpu_torch model (``GPT2Model``,
    ``LlamaModel``, ``OPTModel``, ``GPTNeoXModel`` (GPT-NeoX and GPT-J),
    ``BloomModel``, ``GPTNeoModel``, ``BertModel``: ``engine(ids)`` scores
    each, and ``generate`` serves the decoders), an HF module of an
    injected architecture (``module_inject``: GPT-2, OPT, LLaMA/Mistral,
    BLOOM, GPT-NeoX, GPT-Neo, GPT-J, BERT, DistilBERT), or the path of a
    Megatron-LM GPT checkpoint directory (``checkpoint/megatron.py``: its tp x pp shards
    merged whole on every rank, then, at ``tensor_parallel.tp_size`` > 1,
    each rank keeping its part, as a JAX tree loads); ``config`` a dict (merged with ``kwargs``) or a
    ``DeepSpeedInferenceConfig``. The engine runs on ``cuda`` unless
    ``device`` says otherwise, and raises when no GPU is present."""
    from .inference.config import DeepSpeedInferenceConfig
    from .inference.engine import InferenceEngine
    if config is None:
        config = {}
    if isinstance(config, dict):
        config = DeepSpeedInferenceConfig.from_dict({**config, **kwargs})
    if isinstance(model, str):
        from .checkpoint.megatron import load_megatron_checkpoint
        spec, params = load_megatron_checkpoint(model)
        return InferenceEngine(spec, config, params=params, device=device)
    return InferenceEngine(model, config, device=device)


def _config_dict(config):
    if isinstance(config, str):
        import json
        with open(config) as f:
            return json.load(f)
    return config if isinstance(config, dict) else {}


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, mesh_manager=None, device=None):
    """Initialize the training engine, as ``deepspeed_tpu.initialize``, in
    its argument order. ``model`` is a deepspeed_tpu_torch model (e.g.
    ``GPT2Model``, or ``BertModel``, whose dict batches may carry
    ``masked_positions`` / ``masked_labels``) holding the initial weights; ``model_parameters`` is
    accepted and unused, as in the JAX package. The engine runs on
    ``cuda`` unless ``device`` says otherwise, and raises when no GPU is
    present. ``mesh_manager`` is the rank topology
    (``initialize_mesh(dp=...)``; default: data parallelism over every
    rank of the process group). Returns ``(engine, optimizer, dataloader,
    lr_scheduler)``.

    ``tensor_parallel_size`` (or a ``mesh_manager`` with ``tp > 1``) trains
    the model tensor-parallel; an ``mpu`` is accepted and kept, as in the
    JAX package. The hybrid engine, the pipeline engine and LoRA raise
    naming their ROADMAP.md rows, as does a client optimizer object."""
    from .runtime.engine import DeepSpeedEngine
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if config is None:
        raise ValueError("DeepSpeed requires --deepspeed_config or the config "
                         "kwarg")
    cfg = _config_dict(config)
    for key, what, row in (("hybrid_engine", "the hybrid engine", "A12"),
                           ("lora", "LoRA", "A12")):
        if (cfg.get(key) or {}).get("enabled"):
            raise NotImplementedError(f"{what} is not ported yet: "
                                      f"ROADMAP.md row {row}")
    if int(cfg.get("pipeline_parallel_size", 1)) > 1:
        raise NotImplementedError("the pipeline engine is not ported yet: "
                                  "ROADMAP.md row A11")
    engine = DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler, mpu=mpu,
                             collate_fn=collate_fn, config=config,
                             mesh_manager=mesh_manager, device=device)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)
