"""deepspeed_tpu_torch.zero — the user-facing ZeRO namespace, as the JAX
package's ``zero.py``.

- ``Init``: the engine partitions the parameters when it is built (each
  rank keeps its shards of the masters and, under stage 3, frees the
  model's whole tensors), so the context manager validates its arguments
  and is otherwise a no-op, as in the JAX package.
- ``GatheredParameters(engine, modifier_rank=...)``: gathers the engine's
  masters whole (a collective: every rank enters it), yields them as a
  JAX-layout tree of float32 numpy arrays, and with ``modifier_rank`` set
  writes that rank's changes back into every rank's shards on exit. A
  bare tree is read-only, as in the JAX package.
- ``register_external_parameter``: a no-op (the layer hook gathers what
  the layer loop asks for).
"""

import contextlib

import numpy as np
import torch

from .utils.logging import log_dist

_INIT_KEYS = {"module", "data_parallel_group", "mem_efficient_linear",
              "remote_device", "pin_memory", "config_dict_or_path",
              "config", "enabled", "dtype", "mpu", "param_dict",
              "sequence_data_parallel_group"}


class Init:
    """Source-compatible ``with deepspeed_tpu_torch.zero.Init(): ...``.
    Unknown arguments raise."""

    def __init__(self, **kwargs):
        unknown = set(kwargs) - _INIT_KEYS
        if unknown:
            raise ValueError(f"zero.Init: unknown arguments {sorted(unknown)}")
        self.enabled = kwargs.get("enabled", True)
        if self.enabled:
            log_dist("zero.Init: the engine partitions the parameters when "
                     "it is built; the context is a compatibility no-op",
                     ranks=[0])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _is_engine(target) -> bool:
    return hasattr(target, "whole_master") and hasattr(target, "_config")


@contextlib.contextmanager
def GatheredParameters(target, modifier_rank=None, fwd_module=None,
                       enabled=True):
    """The whole float32 masters as a JAX-layout tree of numpy arrays.

    ``target``: a ``DeepSpeedEngine`` (any stage; every rank must enter,
    the gather is a collective), or a bare tree (read-only: a copy).
    ``modifier_rank``: None reads only; a rank's index writes that rank's
    tree back into every rank's masters (and moments stay as they are)
    on exit."""
    if not enabled:
        yield target.get_fp32_params() if _is_engine(target) else target
        return
    if not _is_engine(target):
        if modifier_rank is not None:
            raise ValueError(
                "zero.GatheredParameters: write-back (modifier_rank set) "
                "needs the ENGINE, not a bare params tree")
        yield _to_numpy(target)
        return
    engine = target
    host = [engine.whole_master(i).detach().to("cpu", torch.float32)
            .numpy().copy() for i in range(len(engine._names))]
    tree = engine.module.jax_tree(host, stack=np.stack)
    yield tree
    if modifier_rank is None:
        return
    from .comm import comm
    values = engine.module.from_jax_tree(tree)
    for i, v in enumerate(values):
        t = torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float32,
                            device=engine.device)
        with comm.full_precision():
            comm.broadcast(t, src=modifier_rank, axis_name=engine._dp_group)
        engine.set_whole_master(i, t)
    log_dist("zero.GatheredParameters: the changes are written back into "
             "the engine", ranks=[0])


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu").numpy().copy()
    return np.array(tree)


def register_external_parameter(module, parameter):
    """A no-op kept for source compatibility: the stage-3 hook gathers
    every leaf the layer loop reads."""
    del module, parameter
