"""deepspeed_tpu_torch — the PyTorch / CUDA port of deepspeed_tpu for NVIDIA
Hopper.

The JAX package ``deepspeed_tpu`` is the reference this port is held
against; the port imports neither JAX nor that package. Its kernels are
hand-written for ``sm_90a`` (``csrc/``) and built by ``nvcc`` at first use
(``ops/kernel_build.py``); each has a plain PyTorch version that tensors on
the CPU take. This slice serves GPT-2 through ``init_inference``.
"""

__version__ = "0.1.0"

from .utils.logging import logger, log_dist  # noqa: E402


def init_inference(model, config=None, device=None, **kwargs):
    """Initialise the inference engine, as ``deepspeed_tpu.init_inference``.

    ``model`` is a deepspeed_tpu_torch model (e.g. ``GPT2Model``);
    ``config`` a dict (merged with ``kwargs``) or a
    ``DeepSpeedInferenceConfig``. The engine runs on ``cuda`` unless
    ``device`` says otherwise, and raises when no GPU is present."""
    from .inference.config import DeepSpeedInferenceConfig
    from .inference.engine import InferenceEngine
    if config is None:
        config = {}
    if isinstance(config, dict):
        config = DeepSpeedInferenceConfig.from_dict({**config, **kwargs})
    if isinstance(model, str):
        raise NotImplementedError(
            "serving a Megatron checkpoint directory is not ported yet: "
            "ROADMAP.md row A7")
    return InferenceEngine(model, config, device=device)
