"""The tensor-fragment API: the JAX package's ``utils/tensor_fragment.py``
(reference ``utils/tensor_fragment.py:91-124``).

Under ZeRO a parameter's master and moments live as shards across the
ranks; these calls read or write one parameter's whole value by its JAX
leaf path (``"blocks/qkv_w"`` is the stacked ``[L, ...]`` leaf, ``"wte"``
a top-level one), whatever the stage. They gather across the ranks, so
every rank calls them, in the same order.
"""

from typing import List, Optional

import numpy as np
import torch


def list_param_paths(engine) -> List[str]:
    """The JAX leaf paths of the engine's parameters, in the JAX tree's
    order."""
    from ..elasticity.logical import leaf_paths
    return list(leaf_paths(engine.param_shapes))


def _indices(engine, path: str):
    """The engine's parameter indices of a leaf, in layer order (one for a
    top-level leaf); a path may be a unique substring of a leaf's."""
    paths = list_param_paths(engine)
    if path not in paths:
        matches = [p for p in paths if path in p]
        if len(matches) != 1:
            raise KeyError(
                f"param path {path!r} not found "
                f"({'ambiguous' if matches else 'no match'}); available: "
                f"{paths[:20]}{'...' if len(paths) > 20 else ''}")
        path = matches[0]
    idx = [i for i, (leaf, _) in enumerate(engine._layout) if leaf == path]
    return path, sorted(idx, key=lambda i: engine._layout[i][1] or 0)


def _stacked(engine, path, whole_of) -> np.ndarray:
    path, idx = _indices(engine, path)
    rows = [whole_of(i).detach().to("cpu", torch.float32).numpy()
            for i in idx]
    return rows[0].copy() if engine._layout[idx[0]][1] is None \
        else np.stack(rows)


def safe_get_full_fp32_param(engine, path: str) -> np.ndarray:
    """The whole f32 master of the addressed leaf."""
    return _stacked(engine, path, engine.whole_master)


def safe_set_full_fp32_param(engine, path: str, value) -> None:
    """Write the whole f32 value of the addressed leaf (every rank passes
    the same value)."""
    path, idx = _indices(engine, path)
    value = np.asarray(value, dtype=np.float32)
    top = engine._layout[idx[0]][1] is None
    want = engine._shapes[idx[0]] if top else \
        (len(idx),) + engine._shapes[idx[0]]
    assert value.shape == tuple(want), f"shape {value.shape} != {want}"
    for j, i in enumerate(idx):
        engine.set_whole_master(i, torch.from_numpy(
            np.ascontiguousarray(value if top else value[j])))


def safe_get_full_grad(engine, path: str) -> Optional[np.ndarray]:
    """The effective whole gradient of the addressed leaf between
    ``backward()`` and ``step()``: the accumulated gradients summed over
    the ranks, divided by ``scale * count * dp``, as ``step()`` will apply
    them (None outside that window)."""
    acc = engine._grad_acc
    if acc is None:
        return None
    from ..comm import comm
    partitioned = engine._stage >= 2
    # the explicit exchange averaged the gradients over the ranks already
    averaged = engine._explicit

    def whole_of(i):
        g = acc[i].to(torch.float32).clone()
        if partitioned:
            return engine.whole(i, g)
        if not averaged:
            with comm.full_precision():
                g = comm.all_reduce(g, axis_name=engine._dp_group)
        return engine.tp_whole(i, g)

    g = _stacked(engine, path, whole_of)
    denom = float(engine.scaler_state.scale) * max(
        1, engine._grad_acc_count) * (1 if averaged else
                                      engine.dp_world_size)
    return g / denom


_STATE_ALIASES = {"exp_avg": "mu", "exp_avg_sq": "nu", "momentum": "mu",
                  "variance": "nu", "mu": "mu", "nu": "nu", "m": "mu",
                  "v": "nu"}


def safe_get_full_optimizer_state(engine, path: str,
                                  state_name: str) -> Optional[np.ndarray]:
    """One optimizer-state tensor (``exp_avg`` / ``exp_avg_sq``) of the
    addressed leaf, whole."""
    if engine.opt_state is None or state_name not in _STATE_ALIASES:
        return None
    parts = getattr(engine.opt_state, _STATE_ALIASES[state_name])
    return _stacked(engine, path, lambda i: engine.whole(i, parts[i]))
