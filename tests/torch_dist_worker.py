"""Rank workers for the port's multi-rank tests, and the spawner.

This module imports no JAX and nothing of the JAX package: a rank process
unpickles its target by module, and a test module would bring JAX in
without the conftest's CPU setup. ``spawn(fn, world, tmp_path, payload)``
runs ``fn(rank, world, payload)`` (a function of this module or of another
module that imports no JAX, such as ``torch_tp_worker``) on ``world`` gloo
ranks: processes forked from a forkserver that has imported this module
and ``fn``'s (and with them torch and the port) once, so a spawn after the first costs little; the ranks
meet through a file store under ``tmp_path`` (no port is taken). Each
rank's return value comes back pickled; a rank's exception is raised in
the parent with its traceback.

The workers run the port's engine on numpy weights and batches the test
made (the JAX package's side of each comparison runs in the test
process) and return numpy results.
"""

import contextlib
import importlib
import multiprocessing
import os
import pickle
import shutil
import traceback

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.models.bert import BertConfig, BertModel
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.models import bloom, gpt_neo, gpt_neox, opt
from deepspeed_tpu_torch.parallel.tensor_parallel import rule_spec
from deepspeed_tpu_torch.runtime import engine as engine_module
from deepspeed_tpu_torch.runtime.zero import partition
from deepspeed_tpu_torch.utils import tensor_fragment

MODELS = {"gpt2": (GPT2Config, GPT2Model), "llama": (LlamaConfig, LlamaModel),
          "bert": (BertConfig, BertModel),
          "opt": (opt.OPTConfig, opt.OPTModel),
          "bloom": (bloom.BloomConfig, bloom.BloomModel),
          "neo": (gpt_neo.GPTNeoConfig, gpt_neo.GPTNeoModel),
          "neox": (gpt_neox.GPTNeoXConfig, gpt_neox.GPTNeoXModel),
          "gptj": (gpt_neox.gptj_config, gpt_neox.GPTNeoXModel)}


class OneRankPlanner(partition.ZeroShardingPlanner):
    """The planner's rule applied over a dp world of one rank, where the
    real planner shards nothing: each leaf's largest dim is partitioned
    over the one rank, so stages 1-3 take every gather and reduce-scatter
    of several ranks, each an identity."""

    def _leaf_spec(self, path, shape, dp_sharded):
        spec = rule_spec(path, self.rules, len(shape))
        if dp_sharded:
            spec = partition._add_dp_axis(spec, tuple(shape),
                                          partition.DP_AXES, 1,
                                          self.persistence_threshold)
        return tuple(spec)


@contextlib.contextmanager
def one_rank_planner():
    """Engines made inside the block plan with ``OneRankPlanner``."""
    saved = engine_module.ZeroShardingPlanner
    engine_module.ZeroShardingPlanner = OneRankPlanner
    try:
        yield
    finally:
        engine_module.ZeroShardingPlanner = saved


# ---------------------------------------------------------------- spawner

def spawn(fn, world, tmp_path, payload, timeout=240):
    """``[fn(rank, world, payload) for each rank]``, each on its own gloo
    rank."""
    return join(start(fn, world, tmp_path, payload), timeout)


def start(fn, world, tmp_path, payload):
    """Start ``spawn``'s ranks and return at once (the caller may work
    meanwhile); ``join`` waits for them and returns their results."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(sorted({__name__, fn.__module__}))
    run_dir = os.path.join(str(tmp_path), f"ranks_{fn.__name__}")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    procs = [ctx.Process(target=_entry, args=(
        fn.__module__, fn.__name__, rank, world, run_dir, payload))
        for rank in range(world)]
    for p in procs:
        p.start()
    return procs, run_dir


def join(started, timeout=240):
    procs, run_dir = started
    world = len(procs)
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = []
    for rank in range(world):
        err = os.path.join(run_dir, f"error{rank}.txt")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {rank}:\n{f.read()}")
    if errors:
        raise RuntimeError("\n".join(errors))
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes} (timeout {timeout} s)")
    out = []
    for rank in range(world):
        with open(os.path.join(run_dir, f"result{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(module, name, rank, world, run_dir, payload):
    try:
        torch.set_num_threads(1)
        comm.init_distributed(dist_backend="gloo", device="cpu",
                              init_method=f"file://{run_dir}/store",
                              rank=rank, world_size=world, verbose=False)
        fn = getattr(importlib.import_module(module), name)
        result = fn(rank, world, payload)
        with open(os.path.join(run_dir, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(run_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
    finally:
        comm.destroy_process_group()


# ---------------------------------------------------------------- helpers

def model(family, kw, tree=None):
    """A port model of ``family`` (config fields ``kw``), weights from the
    JAX-layout numpy ``tree`` when given."""
    cfg_cls, cls = MODELS[family]
    m = cls(cfg_cls(**kw))
    if tree is not None:
        m.load_jax_params(tree)
    return m


def engine_for(case, tree_key="tree"):
    return deepspeed_tpu_torch.initialize(
        model=model(case["family"], case["kw"], case.get(tree_key)),
        config=case["config"], device="cpu")[0]


def state(engine):
    """Whole masters, ``mu`` and ``nu`` as ``{path: numpy}`` maps (a
    collective: every rank calls it), and the Adam count."""
    paths = tensor_fragment.list_param_paths(engine)
    return {
        "params": {p: tensor_fragment.safe_get_full_fp32_param(engine, p)
                   for p in paths},
        "mu": {p: tensor_fragment.safe_get_full_optimizer_state(
            engine, p, "exp_avg") for p in paths},
        "nu": {p: tensor_fragment.safe_get_full_optimizer_state(
            engine, p, "exp_avg_sq") for p in paths},
        "count": int(engine.opt_state.count)}


def _micro(batch, i):
    return {k: v[i] for k, v in batch.items()}


def run_steps(engine, batches, loop="train_batch", scale_at=None):
    """Global steps over ``[gas, micro * dp, ...]`` batches; per step the
    loss, gradient norm, overflow flag and loss scale (``scale_at``:
    ``{step: loss scale}`` set before those steps)."""
    out = []
    for step, batch in enumerate(batches):
        if step in (scale_at or {}):
            engine.scaler_state = engine.scaler_state._replace(
                scale=float(scale_at[step]))
        if loop == "train_batch":
            loss = engine.train_batch(batch=batch)
            scale, overflow = engine.cur_scale, None
        else:
            gas = len(next(iter(batch.values())))
            for i in range(gas):
                engine.backward(engine(_micro(batch, i)))
            metrics = engine.step()
            loss, overflow = metrics["loss"], metrics["overflow"]
            scale = engine.cur_scale
        out.append({"loss": float(loss),
                    "grad_norm": float(engine.get_global_grad_norm()),
                    "skipped": engine.skipped_steps, "scale": scale,
                    "overflow": overflow})
    return out


# ---------------------------------------------------------------- workers

def train_cases(rank, world, payload):
    """Each case of ``payload["cases"]``: an engine from the case's weights
    and config, its steps, then its whole state (rank 0 returns it; every
    rank returns its step records and gather statistics)."""
    results = []
    for case in payload["cases"]:
        engine = engine_for(case)
        steps = run_steps(engine, case["batches"],
                          case.get("loop", "train_batch"),
                          case.get("scale_at"))
        st = state(engine)
        results.append({"steps": steps, "state": st if rank == 0 else None,
                        "gathers": engine.zero_gather_stats.as_dict(),
                        "layer_bytes": _layer_bytes(engine),
                        "top_bytes": _top_bytes(engine),
                        "comm": comm.comm_per_op_stats()})
    return results


def _layer_bytes(engine):
    """The compute-dtype bytes of one layer's partitioned leaves (the
    largest layer)."""
    per = {}
    itemsize = torch.empty((), dtype=engine._compute_dtype).element_size()
    for (leaf, layer), shape, ps in zip(engine._layout, engine._shapes,
                                        engine._pshards):
        if layer is not None and ps.partitioned:
            per[layer] = per.get(layer, 0) + int(np.prod(shape)) * itemsize
    return max(per.values()) if per else 0


def _top_bytes(engine):
    """The compute-dtype bytes of every top-level leaf."""
    itemsize = torch.empty((), dtype=engine._compute_dtype).element_size()
    return sum(int(np.prod(shape)) * itemsize
               for (leaf, layer), shape in zip(engine._layout,
                                               engine._shapes)
               if layer is None)


def checkpoint_cases(rank, world, payload):
    """The multi-rank checkpoint sequence (``test_torch_zero_checkpoint``):
    a JAX dp-2 tag loaded and re-saved; the run continued; a 2-rank tag
    saved; a 1-rank tag loaded; a torn tag refused with the engine
    untouched."""
    case = payload["case"]
    out = {}
    engine = engine_for(case)
    engine.load_checkpoint(payload["jax_dir"])
    out["loaded"] = state(engine)
    engine.save_checkpoint(payload["resaved_dir"])
    engine.save_16bit_model(payload["resaved_dir"], "model_16bit.msgpack")
    fp32 = engine.get_fp32_params()
    out["fp32_params"] = {k: (v.numpy() if k != "blocks" else
                              {n: t.numpy() for n, t in v.items()})
                          for k, v in fp32.items()}
    out["steps"] = run_steps(engine, payload["batches"])
    out["continued"] = state(engine)
    engine.save_checkpoint(payload["two_rank_dir"])
    fresh = engine_for(dict(case, tree=None))
    fresh.load_checkpoint(payload["one_rank_dir"])
    out["from_one_rank"] = state(fresh)
    out["staged"] = _staged_bytes(fresh, payload["one_rank_dir"])
    # a torn tag, read without the manifest check: the read fails and the
    # engine keeps its state, bit for bit
    torn = engine_for(dict(case, config=dict(case["config"], resilience={
        "verify_on_load": False, "fallback_on_corruption": False})))
    torn.load_checkpoint(payload["one_rank_dir"])
    before = state(torn)
    try:
        torn.load_checkpoint(payload["torn_dir"])
        out["torn_raised"] = False
    except Exception as e:  # the load's CheckpointLoadError
        out["torn_raised"] = type(e).__name__
    after = state(torn)
    out["torn_untouched"] = all(
        np.array_equal(before[k][p], after[k][p])
        for k in ("params", "mu", "nu") for p in before[k]) and \
        before["count"] == after["count"] and torn.global_steps == \
        int(payload["one_rank_steps"])
    return out if rank == 0 else {"torn_raised": out["torn_raised"],
                                  "torn_untouched": out["torn_untouched"],
                                  "staged": out["staged"]}


def _staged_bytes(engine, load_dir):
    """What a load of ``load_dir``'s latest tag stages in host memory on
    this rank (masters, ``mu``, ``nu``), beside the bytes of the engine's
    own parts of them and of the whole state."""
    from deepspeed_tpu_torch.runtime import checkpointing as ckpt
    with open(os.path.join(load_dir, "latest")) as f:
        tag_dir = os.path.join(load_dir, f.read().strip())
    staged = ckpt._read_tag(engine, tag_dir, ckpt._rcfg(engine._config),
                            None, True, False)
    _, mu, nu = staged["opt"]
    st = engine.opt_state
    return {"staged": sum(t.nbytes for t in staged["masters"] + mu + nu),
            "parts": sum(t.nbytes for t in list(engine._masters) + st.mu +
                         st.nu),
            "whole": 3 * 4 * sum(int(np.prod(s)) for s in engine._shapes)}


def collectives(rank, world, payload):
    """Every collective of the comm layer on ``world`` ranks: the results
    and the accounting."""
    from deepspeed_tpu_torch.comm.logging import get_comms_logger
    from deepspeed_tpu_torch.parallel import topology
    comm.reset_comm_stats()
    cl = get_comms_logger()
    cl.enabled = True
    cl.reset()
    r = float(rank)
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2) + 10 * r
    out = {}
    out["all_reduce"] = comm.all_reduce(x.clone()).numpy()
    out["all_reduce_avg"] = comm.all_reduce(
        x.clone(), op=comm.ReduceOp.AVG).numpy()
    out["all_reduce_max"] = comm.all_reduce(
        x.clone(), op=comm.ReduceOp.MAX).numpy()
    out["all_gather0"] = comm.all_gather(x).numpy()
    out["all_gather1"] = comm.all_gather(x, axis=1).numpy()
    out["all_gather_stack"] = comm.all_gather(x, tiled=False).numpy()
    out["reduce_scatter0"] = comm.reduce_scatter(x).numpy()
    out["reduce_scatter1"] = comm.reduce_scatter(x, axis=1).numpy()
    out["ag_coalesced"] = [t.numpy() for t in comm.all_gather_coalesced(
        [x, x[:, :1] * 2], axes=[0, 1])]
    out["rs_coalesced"] = [t.numpy() for t in comm.reduce_scatter_coalesced(
        [x, x * 3], axes=[0, 1])]
    out["all_to_all"] = comm.all_to_all(x, "data", split_axis=0,
                                        concat_axis=1).numpy()
    out["broadcast"] = comm.broadcast(x.clone(), src=1).numpy()
    out["scatter"] = comm.scatter(x, src=1).numpy()
    out["gather"] = comm.gather(x).numpy()
    out["reduce"] = comm.reduce(x.clone()).numpy()
    out["ppermute"] = comm.send_recv_next(x, "data").numpy()
    out["single"] = comm.all_to_all(x, "expert").numpy()   # a 1-rank axis
    out["object"] = comm.broadcast_object({"rank": rank}, src=1)
    out["axis"] = (comm.axis_index("data"), comm.axis_size("data"),
                   comm.axis_size("model"), comm.get_rank("data"))
    out["stats"] = comm.comm_stats()
    out["per_op"] = comm.comm_per_op_stats()
    out["logged"] = {op: {str(k): v for k, v in sizes.items()}
                     for op, sizes in cl.comms_dict.items()}
    try:
        comm.isend(x, 0)
    except ValueError as e:
        out["isend"] = str(e)
    mm = topology.initialize_mesh(dp=world)
    out["mesh"] = (mm.dp_world_size, mm.dp_rank, mm.group("model") is
                   comm.SINGLE, mm.group(("data", "expert")) is None)
    cl.enabled = False
    return out
