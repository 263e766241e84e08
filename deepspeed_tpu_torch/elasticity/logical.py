"""Logical shardings — the topology-free half of a checkpoint: the JAX
package's ``elasticity/logical.py``, over the port's rank topology.

Checkpoints store whole (global) arrays (``runtime/checkpointing.py``), so
any tag loads whatever layout wrote it. What an array alone cannot answer
is *what layout the run intended* and *whether the live model matches what
was saved*. This module records both:

- ``shardings.json`` — written into every checkpoint tag next to
  ``model_states.msgpack``: one record per leaf (global shape, dtype, and
  the spec the JAX package's planner gives it: ``[null, ["data",
  "expert"], null]`` for a leaf sharded over the dp axes on its dim 1)
  for params and optimizer state, plus the saving run's topology
  (pp/dp/ep/sp/tp axis sizes, world size, process count: one process a
  rank here, where the JAX package runs one process for every device of
  a host) and batch triangle. The integrity manifest covers it like every
  other file of the tag.
- **per-leaf structure diff** — the loader compares the live model's leaf
  set against the checkpoint's before any state changes: a mismatch
  raises ``CheckpointLoadError`` naming every missing and extra leaf (and
  shape mismatches).

Leaves are named as the JAX package names them: map keys and list indices
joined by ``/`` (``blocks/qkv_w``, ``mu/blocks/qkv_w``), dict keys in
sorted order, ``None`` no leaf.
"""

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from ..resilience.manifest import CheckpointLoadError

__all__ = ["SHARDINGS_NAME", "spec_to_json", "spec_from_json",
           "logical_records", "build_logical_manifest",
           "write_logical_manifest", "read_logical_manifest",
           "leaf_paths", "leaf_diff", "require_leaf_match"]

#: file name inside a checkpoint tag directory
SHARDINGS_NAME = "shardings.json"


def _leaves(tree, path=()):
    """``(path, leaf)`` pairs in the JAX package's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _path_str(path) -> str:
    return "/".join(str(k) for k in path) if path else "<root>"


def _dtype_str(dtype) -> str:
    from ..runtime.checkpoint_engine.msgpack_codec import dtype_name
    return dtype_name(dtype)


def spec_to_json(spec) -> List[Any]:
    """A spec (a sequence of axis names, None for a replicated dim, or a
    sequence of names for a multi-axis dim) -> its JSON list."""
    out: List[Any] = []
    for entry in tuple(spec):
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            out.append([str(a) for a in entry])
        else:
            out.append(str(entry))
    return out


def spec_from_json(doc) -> List[Any]:
    """JSON list -> spec entries (the inverse of ``spec_to_json``), as a
    plain list: a PartitionSpec is JAX's."""
    return [None if e is None else tuple(e) if isinstance(e, list)
            else str(e) for e in doc]


def logical_records(tree, spec_fn=None) -> Dict[str, dict]:
    """Per-leaf ``{path: {shape, dtype, spec}}`` of a tree of arrays (or
    anything with ``shape`` and ``dtype``); ``spec_fn(path, shape)`` gives
    a leaf's spec (default: replicated)."""
    out: Dict[str, dict] = {}
    for path, leaf in _leaves(tree):
        shape = [int(d) for d in leaf.shape]
        name = _path_str(path)
        spec = [None] * len(shape) if spec_fn is None or not shape else \
            spec_to_json(spec_fn(name, tuple(shape)))
        out[name] = {"shape": shape, "dtype": _dtype_str(leaf.dtype),
                     "spec": spec}
    return out


def build_logical_manifest(engine) -> Dict[str, Any]:
    """The shardings.json document for one engine: topology + batch
    triangle + per-leaf logical shardings for params and (when present)
    optimizer state, from ``engine.param_shapes`` and
    ``engine.opt_state_shapes``."""
    cfg = engine._config
    opt = engine.opt_state_shapes
    mm, planner = engine.mesh_manager, engine.planner

    def opt_spec(path, shape):
        # mu/<leaf> and nu/<leaf> take the leaf's optimizer-state spec
        return planner.opt_spec(path.split("/", 1)[1], shape)

    return {
        "version": 1,
        "topology": {
            "axes": {"pp": mm.pp, "dp": mm.dp, "ep": mm.ep, "sp": mm.sp,
                     "tp": mm.tp},
            "world_size": int(mm.world_size),
            "processes": int(mm.world_size),
            "zero_stage": int(engine.zero_stage),
        },
        "batch": {
            "train_batch_size": int(cfg.train_batch_size),
            "micro": int(cfg.train_micro_batch_size_per_gpu),
            "gas": int(cfg.gradient_accumulation_steps),
            "dp": int(engine.dp_world_size),
        },
        "seed": int(getattr(cfg, "seed", 0)),
        "params": logical_records(engine.param_shapes, planner.param_spec),
        "opt_state": logical_records(opt, opt_spec) if opt is not None
        else None,
    }


def write_logical_manifest(engine, ckpt_dir: str) -> str:
    """Write ``<ckpt_dir>/shardings.json`` atomically (tmp + fsync +
    replace, as the integrity manifest that will cover it)."""
    doc = build_logical_manifest(engine)
    out = os.path.join(ckpt_dir, SHARDINGS_NAME)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, out)
    return out


def read_logical_manifest(ckpt_dir: str) -> Optional[Dict[str, Any]]:
    """The shardings.json document of a tag directory, or None for a tag
    written without one."""
    path = os.path.join(ckpt_dir, SHARDINGS_NAME)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


# ------------------------------------------------------------- leaf diff

def leaf_paths(tree) -> Dict[str, Tuple[int, ...]]:
    """{path: shape} for every leaf of a tree (shape () for leaves
    without one)."""
    out: Dict[str, Tuple[int, ...]] = {}
    for path, leaf in _leaves(tree):
        shape = tuple(getattr(leaf, "shape", ()) or ())
        out[_path_str(path)] = tuple(int(d) for d in shape)
    return out


def leaf_diff(expected_tree, got_tree) -> Dict[str, list]:
    """Structure diff between the live model's tree and a loaded one:
    ``missing`` (live leaves absent from the checkpoint), ``extra``
    (checkpoint leaves the live model has no home for), and
    ``shape_mismatch`` entries 'path: saved (a, b) vs live (c, d)'."""
    want = leaf_paths(expected_tree)
    got = leaf_paths(got_tree)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    shape_mismatch = []
    for path in sorted(set(want) & set(got)):
        if want[path] and got[path] and want[path] != got[path]:
            shape_mismatch.append(
                f"{path}: saved {got[path]} vs live {want[path]}")
    return {"missing": missing, "extra": extra,
            "shape_mismatch": shape_mismatch}


def require_leaf_match(expected_tree, got_tree, what: str, where: str):
    """Raise ``CheckpointLoadError`` naming every missing/extra leaf when
    the loaded tree cannot restore into the live model. The loaders call
    this before any state changes."""
    diff = leaf_diff(expected_tree, got_tree)
    if not (diff["missing"] or diff["extra"] or diff["shape_mismatch"]):
        return
    parts = []
    if diff["missing"]:
        parts.append(f"missing from checkpoint: {diff['missing']}")
    if diff["extra"]:
        parts.append(f"extra in checkpoint: {diff['extra']}")
    if diff["shape_mismatch"]:
        parts.append(f"shape mismatch: {diff['shape_mismatch']}")
    raise CheckpointLoadError(
        f"{what} at {where} does not match the live model "
        f"({len(diff['missing'])} missing / {len(diff['extra'])} extra / "
        f"{len(diff['shape_mismatch'])} reshaped leaf(s)): "
        + "; ".join(parts), leaf_diff=diff)
