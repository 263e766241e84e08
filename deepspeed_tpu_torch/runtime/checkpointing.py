"""Engine checkpoint save/load: the JAX package's
``runtime/checkpointing.py``, on its exact on-disk format.

A tag holds whole arrays in the JAX package's tree, not a torch
``state_dict``, so a tag written by either package loads in the other:

    <dir>/latest                          — tag file
    <dir>/zero_to_fp32.py                 — standalone fp32 export script
    <dir>/<tag>/model_states.msgpack      — f32 masters, {wte, ...,
                                            blocks: {<leaf>: [L, ...]}}
    <dir>/<tag>/optim_states.msgpack      — {opt_state: {count, mu, nu},
                                            offload: None, scaler: {...}}
    <dir>/<tag>/engine_state.json         — counters, lr scheduler, client
                                            state, weights_version, rng_key
    <dir>/<tag>/ds_config.json            — config snapshot
    <dir>/<tag>/shardings.json            — logical shardings: the JAX
                                            planner's per-leaf specs and
                                            the rank topology
    <dir>/<tag>/manifest.json             — per-file SHA-256 integrity map

The masters, ``mu`` and ``nu`` are lists aligned with the model's
``named_parameters()``; ``ModelSpec.jax_tree`` / ``from_jax_tree`` map each
to the JAX tree. A tag holds whole arrays whatever the ZeRO stage and rank
count that wrote it, so any tag loads under any stage and rank count.

Save: the files are written in flax's msgpack format by the port's codec
(``checkpoint_engine/msgpack_codec.py``) one leaf at a time — a stacked
leaf one layer at a time — each gathered whole across the ranks when it
is partitioned (over the dp ranks, then over the tp ranks for a leaf the
model shards: a collective, so every rank walks the same leaves in the
same order, and only rank 0 writes), straight from the device to the
file, hashed on the fly. A tag's bytes are the same at every tp and dp.
Only rank 0 writes the tag's other files; the ranks
meet at a barrier before ``save_checkpoint`` returns.

Load: every rank reads the files one leaf at a time into host memory,
as the JAX package stages a tag on the host; the whole tag is staged there until every read and the leaf
gate have finished (and, over several ranks, until every rank has read it),
and only then does each rank copy its part of each leaf into the device
state. The device holds one leaf's part at a time beyond the engine's own
state.

Fault tolerance (``resilience/``, config block ``resilience``): every tag
carries an integrity manifest written at commit time and verified on
load; ``latest`` advances only after ``checkpoint_engine.commit()``
succeeds, through an fsynced atomic rename; a corrupt or partial latest
tag falls back newest→oldest to the most recent valid tag; engine
save/load IO retries with jittered exponential backoff
(``resilience/ckpt_retries``); keep-last-N retention runs after each
successful save. The JAX package's goodput ledger is ROADMAP.md row A12.
"""

import dataclasses
import json
import os
import time
from contextlib import nullcontext
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..resilience.config import ResilienceConfig
from ..resilience.manifest import (CheckpointLoadError, gc_checkpoints,
                                   list_tags, verify_manifest,
                                   write_manifest)
from ..resilience.retry import retry_io
from ..utils.logging import logger, log_dist
from .checkpoint_engine.checkpoint_engine import (MsgpackCheckpointEngine,
                                                  _fsync_dir,
                                                  get_checkpoint_engine)
from .checkpoint_engine.msgpack_codec import ArrayLeaf
from .fp16.loss_scaler import LossScaleState


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A leaf's shape and dtype (``jax.ShapeDtypeStruct``'s role; not a
    tuple, so tree walks take it as a leaf)."""
    shape: tuple
    dtype: Any


def _rcfg(config) -> ResilienceConfig:
    r = getattr(config, "resilience", None)
    return r if r is not None else ResilienceConfig()


def _bump(tracer, tag: str, n: int = 1, owner=None):
    """Increment a monotonic telemetry counter (gauge holds the total).
    ``owner`` ties the tag to the engine."""
    if tracer is None:
        return
    cur = tracer.counters().get(tag)
    val = (cur[0] if isinstance(cur, tuple) else cur or 0.0) + n
    tracer.set_counter(tag, float(val), owner=owner)


def _retrying(ckpt_engine, rcfg: ResilienceConfig, tracer, attempts: int,
              owner=None):
    """Engine save/load calls wrapped in jittered-backoff retry; each retry
    bumps ``resilience/ckpt_retries``."""

    def call(fn, *args, label, **kwargs):
        return retry_io(
            fn, *args, attempts=attempts,
            base_delay=rcfg.retry_backoff_s,
            max_delay=rcfg.retry_max_backoff_s,
            on_retry=lambda i, e: _bump(tracer, "resilience/ckpt_retries",
                                        owner=owner),
            label=label, **kwargs)

    return call


def _write_latest(save_dir, tag):
    """Advance the ``latest`` pointer durably: fsynced tmp + atomic rename
    + parent-dir fsync — a crash can only ever leave the OLD pointer."""
    path = os.path.join(save_dir, "latest")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(tag))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(save_dir)


def _read_latest(load_dir) -> Optional[str]:
    path = os.path.join(load_dir, "latest")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        tag = f.read().strip()
    return tag or None


def _next_weights_version(save_dir, exclude_tag=None) -> int:
    """Monotonic ``weights_version`` for a new tag: 1 + the highest
    version any existing sibling tag carries (1 when none do). The scan
    excludes the tag being written so an overwritten tag does not bump
    itself. Tags without the field count as 0."""
    best = 0
    try:
        tags = list_tags(save_dir)
    except OSError:
        tags = []
    for t in tags:
        if exclude_tag is not None and str(t) == str(exclude_tag):
            continue
        path = os.path.join(save_dir, str(t), "engine_state.json")
        try:
            with open(path) as f:
                best = max(best,
                           int(json.load(f).get("weights_version", 0)))
        except (OSError, ValueError, TypeError):
            continue
    return best + 1


def read_weights_version(load_dir, tag=None) -> int:
    """The monotonic ``weights_version`` a checkpoint tag carries in its
    ``engine_state.json`` (0 for tags without one). ``tag=None`` resolves
    ``latest``; a ``load_dir`` that IS the tag directory also works."""
    load_dir = str(load_dir)
    if tag is None:
        tag = _read_latest(load_dir)
    d = os.path.join(load_dir, str(tag)) if tag else load_dir
    try:
        with open(os.path.join(d, "engine_state.json")) as f:
            return int(json.load(f).get("weights_version", 0))
    except (OSError, ValueError, TypeError):
        return 0


# ------------------------------------------------------------- the trees

class _Whole:
    """One parameter's whole tensor, made when it is written: ``get()``
    gathers it across the ranks when it is partitioned (a collective)."""

    __slots__ = ("shape", "dtype", "get")

    def __init__(self, shape, dtype, get):
        self.shape, self.dtype, self.get = tuple(shape), dtype, get


def _wholes(engine, parts, dtype=None, masters=False):
    """``_Whole``s of a list aligned with the engine's parameters: this
    rank's parts of each (``mu``, ``nu``), or with ``masters`` the f32
    masters; cast to ``dtype`` when given."""
    out = []
    for i, shape in enumerate(engine._shapes):
        if masters:
            get = (lambda i=i: engine.whole_master(i))
            dt = torch.float32
        else:
            get = (lambda i=i, t=parts[i]: engine.whole(i, t))
            dt = parts[i].dtype
        out.append(_Whole(shape, dt if dtype is None else dtype, get))
    return out


def _stacked(rows):
    """A ``[L, ...]`` leaf written one layer at a time from the device."""
    dtype = rows[0].dtype
    return ArrayLeaf((len(rows),) + rows[0].shape, dtype,
                     lambda: (r.get().detach().to(dtype) for r in rows))


def param_tree(engine, wholes):
    """The JAX tree of a list of ``_Whole``s aligned with the engine's
    parameters, each leaf made (and gathered) when it is written."""
    tree = engine.module.jax_tree(wholes, stack=_stacked)
    return {k: v if k == "blocks" else ArrayLeaf(
        v.shape, v.dtype, lambda v=v: [v.get().detach().to(v.dtype)])
        for k, v in tree.items()}


def _walk_arrays(tree):
    """Make every array of ``tree`` in the writer's order without writing
    it: what a rank that does not write runs while rank 0 writes, so that
    both issue the same gathers in the same order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk_arrays(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            _walk_arrays(v)
    elif isinstance(tree, ArrayLeaf):
        for _ in tree.pieces():
            pass


def shapes_tree(module, tensors):
    """The JAX tree of ``ShapeDtype`` of a list aligned with ``module``'s
    parameters (nothing is copied)."""
    return module.jax_tree(
        [ShapeDtype(tuple(t.shape), t.dtype) for t in tensors],
        stack=lambda rows: ShapeDtype((len(rows),) + rows[0].shape,
                                      rows[0].dtype))


def _global_shapes(engine, dtype=torch.float32):
    return engine.module.jax_tree(
        [ShapeDtype(shape, dtype) for shape in engine._shapes],
        stack=lambda rows: ShapeDtype((len(rows),) + rows[0].shape,
                                      rows[0].dtype))


def param_shapes(engine):
    """The masters' JAX tree of ``ShapeDtype`` (the engine's
    ``param_shapes``: whole shapes, at any stage)."""
    return _global_shapes(engine)


def opt_state_shapes(engine):
    """The optimizer state's JAX tree of ``ShapeDtype``, or None."""
    if engine.opt_state is None:
        return None
    return {"count": ShapeDtype((), np.int32),
            "mu": _global_shapes(engine), "nu": _global_shapes(engine)}


def _optim_tree(engine):
    st = engine.opt_state
    sc = engine.scaler_state
    return {
        "opt_state": {"count": np.asarray(st.count, np.int32),
                      "mu": param_tree(engine, _wholes(engine, st.mu)),
                      "nu": param_tree(engine, _wholes(engine, st.nu))}
        if st is not None else None,
        "offload": None,
        "scaler": {"scale": float(sc.scale),
                   "good_steps": int(sc.good_steps),
                   "hysteresis": int(sc.hysteresis)},
    }


def _writer() -> bool:
    from ..comm import comm
    return comm.get_rank() == 0


def _to_device(device, cast=None):
    """``on_leaf`` for the codec: each array read goes to ``device`` (cast
    there by ``cast``) and its host buffer is dropped; 0-d leaves stay
    on the host."""
    def on_leaf(path, arr):
        if getattr(arr, "ndim", 0) == 0:
            return arr
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
        if device is not None:
            t = t.to(device)
        return cast(t) if cast is not None else t
    return on_leaf


# ------------------------------------------------------------------ save

def save_checkpoint(engine, save_dir, tag=None, client_state=None,
                    save_latest=True):
    if tag is None:
        tag = f"global_step{engine.global_steps}"
    save_dir = str(save_dir)
    rcfg = _rcfg(engine._config)
    tracer = getattr(engine, "tracer", None)
    ckpt_engine = get_checkpoint_engine(engine._config)
    _save = _retrying(ckpt_engine, rcfg, tracer, rcfg.save_retries,
                      owner=engine)
    ckpt_dir = os.path.join(save_dir, str(tag))
    span = tracer.span("save_checkpoint", cat="resilience",
                       args={"tag": str(tag)}) \
        if tracer is not None else nullcontext()
    is_writer = _writer()
    t0 = time.perf_counter()
    with span:
        hash_s = _save_checkpoint_files(engine, ckpt_engine, _save, ckpt_dir,
                                        tag, client_state, is_writer)
        if is_writer:
            # seal BEFORE advancing 'latest': an async write failure
            # surfaces here (raise or False) and the pointer keeps naming
            # the previous good checkpoint — never a torn tag
            if ckpt_engine.commit(tag) is False:
                raise IOError(
                    f"checkpoint_engine.commit({tag!r}) failed; 'latest' "
                    f"still names the previous checkpoint")
            # integrity manifest at commit time, from the writer's intended
            # bytes where known — a torn write mismatches it on load
            write_manifest(ckpt_dir, tag=str(tag),
                           intents=getattr(ckpt_engine, "written", None))
            _emit_zero_to_fp32_script(save_dir)
            if save_latest:
                _write_latest(save_dir, tag)
            if rcfg.keep_last_n:
                gc_checkpoints(save_dir, rcfg.keep_last_n,
                               protect=(str(tag),))
    from ..comm import comm
    comm.barrier()
    seconds = time.perf_counter() - t0
    log_dist(f"saved checkpoint {ckpt_dir}", ranks=[0])
    # remembered for sentinel rollback and emergency preemption saves
    engine._last_save_dir = save_dir
    history = getattr(engine, "_ckpt_history", None)
    if history is not None:
        history.append({"kind": "save", "tag": str(tag),
                        "step": engine.global_steps, "seconds": seconds,
                        "bytes": _tag_bytes(ckpt_dir),
                        "hash_seconds": hash_s})
    return ckpt_dir


def _tag_bytes(ckpt_dir) -> int:
    return sum(os.path.getsize(os.path.join(ckpt_dir, n))
               for n in ("model_states.msgpack", "optim_states.msgpack")
               if os.path.isfile(os.path.join(ckpt_dir, n)))


def _gathers(engine, stage_min=1) -> bool:
    """Whether writing the engine's state gathers across the ranks: dp
    shards from ``stage_min`` on, or tp parts."""
    return (engine.dp_world_size > 1 and engine._stage >= stage_min) or \
        engine.mp_world_size > 1


def _save_state_file(engine, ckpt_engine, _save, path, tree, is_writer,
                     label):
    """Rank 0 writes ``tree`` to ``path``; another rank walks its arrays
    when any of them is gathered (so the gathers match), else does
    nothing. Returns the seconds spent hashing."""
    if not is_writer:
        if _gathers(engine):
            _walk_arrays(tree)
        return 0.0
    # over several ranks a retried write would issue its gathers again on
    # rank 0 alone: one attempt
    if _gathers(engine):
        ckpt_engine.save(tree, path)
    else:
        _save(ckpt_engine.save, tree, path, label=label)
    digest = getattr(ckpt_engine, "last_digest", None)
    return digest.hash_seconds if digest is not None else 0.0


def _save_checkpoint_files(engine, ckpt_engine, _save, ckpt_dir, tag,
                           client_state, is_writer=True):
    """Write the tag's files (the state files' gathers on every rank, the
    writes on rank 0); returns the seconds spent hashing the state files
    while they were written."""
    if is_writer:
        ckpt_engine.create(tag)
        os.makedirs(ckpt_dir, exist_ok=True)
    hash_s = 0.0
    for name, tree in (("model_states",
                        param_tree(engine, _wholes(engine, None,
                                                   masters=True))),
                       ("optim_states", _optim_tree(engine))):
        hash_s += _save_state_file(
            engine, ckpt_engine, _save,
            os.path.join(ckpt_dir, f"{name}.msgpack"), tree, is_writer,
            label=f"ckpt save {name}")
    if not is_writer:
        return hash_s
    engine_state = {
        "global_steps": engine.global_steps,
        "global_samples": engine.global_samples,
        "micro_steps": engine.micro_steps,
        "skipped_steps": engine.skipped_steps,
        "zero_stage": engine.zero_stage,
        "lr_scheduler": (engine.lr_scheduler.state_dict()
                         if engine.lr_scheduler is not None and
                         hasattr(engine.lr_scheduler, "state_dict") else None),
        "client_state": client_state or {},
        "dp_world_size": engine.dp_world_size,
        # monotonic across the tags of this directory: what a rollout
        # deploys and a KV handoff is checked against
        "weights_version": _next_weights_version(
            os.path.dirname(ckpt_dir), exclude_tag=tag),
        # the per-step key root: restored bit for bit, so the
        # fold_in(micro_steps) stream continues across a resume
        "rng_key": [int(w) for w in engine._base_rng],
    }
    with open(os.path.join(ckpt_dir, "engine_state.json"), "w") as f:
        json.dump(engine_state, f, indent=2, default=str)
    with open(os.path.join(ckpt_dir, "ds_config.json"), "w") as f:
        json.dump(engine._config._param_dict, f, indent=2, default=str)
    # logical-sharding manifest, written before write_manifest runs so the
    # integrity manifest covers it like every other file of the tag
    from ..elasticity.logical import write_logical_manifest
    write_logical_manifest(engine, ckpt_dir)
    return hash_s


# ------------------------------------------------------------------ load

def _engine_for_layout(config, model_states_path):
    """Pick the engine that matches what's on disk (msgpack is a file),
    falling back to the configured engine. An orbax tag (a directory at
    that path) cannot be read: there is no orbax on the card."""
    if os.path.isdir(model_states_path):
        raise CheckpointLoadError(
            f"{model_states_path} is an orbax-layout tag (a directory of "
            f"shards, written with checkpoint.async_save); the port reads "
            f"msgpack tags only: there is no orbax on the card")
    if os.path.isfile(model_states_path):
        return MsgpackCheckpointEngine()
    return get_checkpoint_engine(config)


def load_checkpoint(engine, load_dir, tag=None, load_optimizer_states=True,
                    load_lr_scheduler_states=True, load_module_only=False):
    """Restore engine state. With ``tag=None``, resolves ``latest`` and —
    when the resilience config allows — falls back newest→oldest to the
    most recent tag that passes manifest verification and deserializes.
    Raises ``CheckpointLoadError`` (naming the directory scanned and every
    tag found) when nothing is loadable."""
    load_dir = str(load_dir)
    rcfg = _rcfg(engine._config)
    tracer = getattr(engine, "tracer", None)
    explicit = tag is not None
    tags_found = list_tags(load_dir)
    if explicit:
        candidates = [str(tag)]
    else:
        latest_tag = _read_latest(load_dir)
        if latest_tag is None:
            raise CheckpointLoadError(
                f"cannot load checkpoint: no (or empty) 'latest' pointer "
                f"in {load_dir!r}; tags found: {tags_found or 'none'}. "
                f"Pass tag= explicitly, or save a checkpoint first.")
        candidates = [latest_tag]
        if rcfg.fallback_on_corruption:
            candidates += [t for t in tags_found if t != latest_tag]

    span = tracer.span("load_checkpoint", cat="resilience",
                       args={"dir": load_dir}) \
        if tracer is not None else nullcontext()
    errors = []
    t0 = time.perf_counter()
    with span:
        for i, cand in enumerate(candidates):
            ckpt_dir = os.path.join(load_dir, cand)
            if not os.path.isdir(ckpt_dir):
                errors.append(f"{cand}: tag directory missing")
                continue
            hash_s = 0.0
            if rcfg.verify_on_load:
                v0 = time.perf_counter()
                problems = verify_manifest(ckpt_dir)
                hash_s = time.perf_counter() - v0
                if problems:
                    logger.warning(
                        f"checkpoint {ckpt_dir} failed integrity "
                        f"verification: {problems}")
                    errors.append(f"{cand}: " + "; ".join(problems))
                    continue
            try:
                staged = _read_tag(engine, ckpt_dir, rcfg, tracer,
                                   load_optimizer_states, load_module_only)
                error = None
            except Exception as e:  # torn state that slipped past verify
                if isinstance(e, CheckpointLoadError) and \
                        e.leaf_diff is not None:
                    # structure drift, not corruption: every tag of this
                    # directory has the same leaf set, so falling back
                    # newest->oldest can only mask the real error
                    raise
                staged, error = None, f"{type(e).__name__}: {e}"
            if not _all_read(engine, staged is not None):
                error = error or "another rank could not read the tag"
                logger.warning(f"checkpoint {ckpt_dir} unreadable: {error}")
                errors.append(f"{cand}: {error}")
                continue
            result = _apply_tag(engine, ckpt_dir, staged,
                                load_lr_scheduler_states, load_module_only)
            if i > 0:
                # rolled back past the (corrupt) latest to an older tag
                _bump(tracer, "resilience/rollbacks", owner=engine)
                log_dist(
                    f"checkpoint fallback: tag '{candidates[0]}' invalid; "
                    f"restored older valid tag '{cand}'", ranks=[0])
            history = getattr(engine, "_ckpt_history", None)
            if history is not None:
                history.append({"kind": "load", "tag": cand,
                                "step": engine.global_steps,
                                "seconds": time.perf_counter() - t0,
                                "bytes": _tag_bytes(ckpt_dir),
                                "hash_seconds": hash_s})
            return result
    raise CheckpointLoadError(
        f"no loadable checkpoint under {load_dir!r}: tried {candidates}; "
        f"tags found: {tags_found or 'none'}"
        + (f"; errors: {errors}" if errors else ""))


class _Parts:
    """A leaf as a rank stages it: its shape on disk (what the leaf gate
    reads) and this rank's part of each of its rows (of the leaf itself
    when it is not stacked), in host memory; no parts when the leaf has no
    home in the live model or another shape there."""

    __slots__ = ("shape", "parts")

    def __init__(self, shape, parts):
        self.shape, self.parts = tuple(shape), parts

    def __getitem__(self, layer):
        return self.parts[layer]


def _stage_parts(engine):
    """``on_leaf`` for the codec: each array read is cut, while only it is
    in host memory, to this rank's parts of the engine's parameters it
    holds (rows of a stacked leaf by layer; its tp part, then the dp part
    of that), and the whole buffer is dropped, so that a rank stages about
    the tag over tp x dp plus one leaf;
    0-d leaves stay numpy. Pageable memory: pinned staging was no faster
    on a cold load, as PERF.md records, and torch's caching host allocator
    would keep the pinned tag for the process's life."""
    homes = {}
    for i, (leaf, layer) in enumerate(engine._layout):
        homes.setdefault(leaf, []).append((i, layer))
    want = {leaf: (len(idx),) + engine._shapes[idx[0][0]]
            if idx[0][1] is not None else engine._shapes[idx[0][0]]
            for leaf, idx in homes.items()}

    def on_leaf(path, arr):
        if getattr(arr, "ndim", 0) == 0:
            return arr
        t = torch.from_numpy(arr) if isinstance(arr, np.ndarray) else arr
        leaf = "/".join(str(k) for k in path[-2:]) \
            if len(path) >= 2 and path[-2] == "blocks" else str(path[-1])
        if want.get(leaf) != tuple(t.shape):
            return _Parts(t.shape, [])
        idx = homes[leaf]
        if idx[0][1] is None:
            parts = [engine._pshards[idx[0][0]].take_whole(t)]
        else:
            parts = [None] * len(idx)
            for i, layer in idx:
                parts[layer] = engine._pshards[i].take_whole(t[layer])
        if sum(p.numel() for p in parts) < t.numel():
            parts = [p.clone() for p in parts]   # let the whole leaf go
        return _Parts(t.shape, parts)
    return on_leaf


def _aligned(engine, tree, what, where, drift=True):
    """A staged JAX tree (of ``_Parts``) as a list of this rank's parts
    aligned with the engine's parameters, after the leaf gate against the
    masters' shapes: a drifted leaf set raises ``CheckpointLoadError``
    with the per-leaf diff (``drift``), or ``ValueError`` for the
    optimizer state, which the JAX package's loader also treats as an
    unreadable tag."""
    from ..elasticity.logical import leaf_diff, require_leaf_match
    if drift:
        require_leaf_match(engine.param_shapes, tree, what=what, where=where)
    else:
        diff = leaf_diff(engine.param_shapes, tree)
        if any(diff.values()):
            raise ValueError(f"{what} at {where} does not match the live "
                             f"model: {diff}")
    return [p.parts[0] if isinstance(p, _Parts) else p
            for p in engine.module.from_jax_tree(tree)]


def _all_read(engine, ok: bool) -> bool:
    """Whether every rank read the tag (one decision for all ranks, so
    none restores a tag another falls back past)."""
    from ..comm import comm
    if comm.get_world_size() == 1:
        return ok
    flag = torch.tensor([0.0 if ok else 1.0], device=engine.device)
    comm.all_reduce(flag, op=comm.ReduceOp.MAX, axis_name=None)
    return not bool(flag.item())


def _read_tag(engine, ckpt_dir, rcfg, tracer, load_optimizer_states,
              load_module_only):
    """Read a tag into host memory and gate its leaves; the engine does not
    change. Returns the staged state."""
    ckpt_engine = _engine_for_layout(engine._config,
                                     os.path.join(ckpt_dir,
                                                  "model_states.msgpack"))
    _load = _retrying(ckpt_engine, rcfg, tracer, rcfg.load_retries,
                      owner=engine)
    need_optim = (load_optimizer_states and not load_module_only and
                  engine.opt_state is not None)
    # every read and the leaf gate finish before any engine state
    # mutates, so a torn file cannot leave the engine half-restored: the
    # tag is staged in host memory, leaf by leaf, as the JAX package
    # stages it, each rank keeping its parts only
    on_leaf = _stage_parts(engine)
    params = _load(ckpt_engine.load,
                   os.path.join(ckpt_dir, "model_states.msgpack"),
                   on_leaf=on_leaf, label="ckpt load model_states")
    optim = _load(ckpt_engine.load,
                  os.path.join(ckpt_dir, "optim_states.msgpack"),
                  on_leaf=on_leaf, label="ckpt load optim_states") \
        if need_optim else None
    masters = _aligned(engine, params, "model_states", ckpt_dir)
    opt = None
    if need_optim and optim.get("opt_state") is not None:
        st = optim["opt_state"]
        opt = (int(np.asarray(st["count"])),
               _aligned(engine, st["mu"], "optim_states mu", ckpt_dir,
                        drift=False),
               _aligned(engine, st["nu"], "optim_states nu", ckpt_dir,
                        drift=False))
    engine_state = None
    state_path = os.path.join(ckpt_dir, "engine_state.json")
    if os.path.isfile(state_path):
        with open(state_path) as f:
            engine_state = json.load(f)
    return {"masters": masters, "opt": opt, "need_optim": need_optim,
            "scaler": optim.get("scaler", {}) if need_optim else None,
            "engine_state": engine_state}


def _apply_tag(engine, ckpt_dir, staged, load_lr_scheduler_states,
               load_module_only):
    """Copy a staged tag into the engine: each rank its parts, a leaf at a
    time."""
    masters, opt = staged["masters"], staged["opt"]
    engine_state, need_optim = staged["engine_state"], staged["need_optim"]
    # ---- from here on the engine changes
    engine._drop_step_state()
    engine.set_master_parts(masters)
    del masters
    client_state: Dict[str, Any] = {}
    if engine_state is not None:
        if not load_module_only:
            engine.global_steps = engine_state.get("global_steps", 0)
            engine.global_samples = engine_state.get("global_samples", 0)
            engine.micro_steps = engine_state.get("micro_steps", 0)
            engine.skipped_steps = engine_state.get("skipped_steps", 0)
            if engine_state.get("rng_key") is not None:
                engine._base_rng = tuple(int(w) for w in
                                         engine_state["rng_key"])
            if (load_lr_scheduler_states and engine.lr_scheduler is not None
                    and engine_state.get("lr_scheduler") is not None):
                engine.lr_scheduler.load_state_dict(
                    engine_state["lr_scheduler"])
        client_state = engine_state.get("client_state", {})
    if need_optim:
        if opt is not None:
            count, mu, nu = opt
            with torch.no_grad():
                for dst, src in zip(engine.opt_state.mu + engine.opt_state.nu,
                                    mu + nu):
                    dst.copy_(src)
            engine.opt_state = engine.opt_state._replace(count=count)
        sc = staged["scaler"]
        engine.scaler_state = LossScaleState(
            scale=float(sc.get("scale", 1.0)),
            good_steps=int(sc.get("good_steps", 0)),
            hysteresis=int(sc.get("hysteresis", 2)))
    log_dist(f"loaded checkpoint {ckpt_dir}", ranks=[0])
    return ckpt_dir, client_state


# ------------------------------------------------------- exports, serving

def save_16bit_model(engine, save_dir, save_filename="pytorch_model.msgpack"):
    """Consolidated 16-bit export (the reference's ``save_16bit_model``):
    the whole masters cast to the compute dtype, one file, written by rank
    0 (every rank calls it: under stage 3 the leaves are gathered)."""
    tree = param_tree(engine, _wholes(engine, None, engine._compute_dtype,
                                      masters=True))
    path = os.path.join(save_dir, save_filename)
    if not _writer():
        if _gathers(engine, stage_min=3):
            _walk_arrays(tree)
        return path
    ckpt_engine = get_checkpoint_engine(engine._config)
    os.makedirs(save_dir, exist_ok=True)
    ckpt_engine.create(save_filename)
    ckpt_engine.save(tree, path)
    ckpt_engine.commit(save_filename)  # async engines: wait + surface errors
    return path


def load_params_for_inference(load_dir, tag=None, like=None, device=None,
                              cast=None):
    """Load params from a training checkpoint dir for serving: each leaf
    goes to ``device`` as it is read and is cast there by ``cast``.
    Integrity-checked like the training path: the tag must pass manifest
    verification, with newest→oldest fallback when ``latest`` is corrupt.
    ``like`` (a tree of anything with ``shape``) gates the leaf set."""
    load_dir = str(load_dir)
    if tag is not None:
        candidates = [str(tag)]
    else:
        latest_tag = _read_latest(load_dir)
        if latest_tag is None and os.path.exists(
                os.path.join(load_dir, "model_states.msgpack")):
            candidates = [""]       # load_dir IS the tag directory
        elif latest_tag is None:
            raise CheckpointLoadError(
                f"cannot load serving params: no 'latest' pointer in "
                f"{load_dir!r}; tags found: {list_tags(load_dir) or 'none'}")
        else:
            candidates = [latest_tag] + [t for t in list_tags(load_dir)
                                         if t != latest_tag]
    ckpt_dir, errors = None, []
    for cand in candidates:
        d = os.path.join(load_dir, cand) if cand else load_dir
        problems = verify_manifest(d)
        if problems:
            logger.warning(f"serving load: {d} failed verification: "
                           f"{problems}")
            errors.append(f"{cand or load_dir}: " + "; ".join(problems))
            continue
        ckpt_dir = d
        break
    if ckpt_dir is None:
        raise CheckpointLoadError(
            f"no loadable checkpoint under {load_dir!r}: tried "
            f"{candidates}; errors: {errors}")
    params = get_fp32_state_dict_from_checkpoint(
        ckpt_dir, on_leaf=_to_device(device, cast))
    if like is not None:
        # per-leaf diff: the error names the exact missing/extra leaves
        # (CheckpointLoadError.leaf_diff)
        from ..elasticity.logical import require_leaf_match
        require_leaf_match(like, params, what="serving params",
                           where=ckpt_dir)
    log_dist(f"loaded inference params from {ckpt_dir}", ranks=[0])
    return params


_ZERO_TO_FP32 = '''#!/usr/bin/env python
"""Standalone fp32 export for this checkpoint directory: run it next to
the tags, get one consolidated file of the f32 params (flax's msgpack
format, byte for byte what the JAX package's script writes). Needs
deepspeed_tpu_torch, not JAX.

Usage: python zero_to_fp32.py [checkpoint_dir] [output_file]
"""
import os
import sys


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    ckpt_dir = sys.argv[1] if len(sys.argv) > 1 else here
    out = sys.argv[2] if len(sys.argv) > 2 else \\
        os.path.join(ckpt_dir, "fp32_model.msgpack")
    latest = os.path.join(ckpt_dir, "latest")
    if os.path.isfile(latest):
        with open(latest) as f:
            ckpt_dir = os.path.join(ckpt_dir, f.read().strip())
    if not os.path.isfile(os.path.join(ckpt_dir, "model_states.msgpack")):
        tags = sorted(d for d in os.listdir(ckpt_dir)
                      if os.path.isfile(os.path.join(
                          ckpt_dir, d, "model_states.msgpack")))
        if not tags:
            sys.exit(f"no model_states.msgpack under {ckpt_dir}; pass the "
                     f"tag directory explicitly")
        print(f"no 'latest' pointer; using newest tag {tags[-1]}")
        ckpt_dir = os.path.join(ckpt_dir, tags[-1])
    try:
        from deepspeed_tpu_torch.runtime import checkpointing
    except ModuleNotFoundError:
        sys.path.insert(0, os.getcwd())  # run from the repo root
        from deepspeed_tpu_torch.runtime import checkpointing
    from deepspeed_tpu_torch.runtime.checkpoint_engine import msgpack_codec
    params = checkpointing.get_fp32_state_dict_from_checkpoint(ckpt_dir)
    with open(out, "wb") as f:
        msgpack_codec.serialize(params, f)
    print(f"wrote consolidated fp32 params to {out}")


if __name__ == "__main__":
    main()
'''


def _emit_zero_to_fp32_script(save_dir):
    """Every checkpoint dir carries a self-contained fp32 consolidation
    script, as the reference's does."""
    path = os.path.join(save_dir, "zero_to_fp32.py")
    try:
        with open(path, "w") as f:
            f.write(_ZERO_TO_FP32)
        os.chmod(path, 0o755)
    except OSError as e:  # the checkpoint itself is intact
        logger.warning(f"could not write zero_to_fp32.py: {e}")


def get_fp32_state_dict_from_checkpoint(ckpt_dir, on_leaf=None):
    """Offline reader (the zero_to_fp32.py equivalent): the f32 param tree
    of a tag directory, without building an engine (numpy arrays, or what
    ``on_leaf`` makes of each as it is read). An orbax tag raises
    ``CheckpointLoadError`` naming its layout."""
    path = os.path.join(ckpt_dir, "model_states.msgpack")
    if os.path.isdir(path):
        _engine_for_layout(None, path)
    return MsgpackCheckpointEngine().load(path, on_leaf=on_leaf)
