"""Rank workers of the port's tensor-parallel tests (``tests/test_torch_tp_*.py``).

Like ``torch_dist_worker`` (whose ``spawn`` runs them on gloo ranks) this
module imports no JAX and nothing of the JAX package. Each worker makes
the rank mesh with its ``model`` axis (``initialize_mesh(tp=2)``, or dp 2
x tp 2 on 4 ranks), builds the port's models on it from the JAX-layout
numpy trees the test made, runs them, and returns numpy results; where a
case asks for it, rank 0 also runs the same case at tp 1 (a model built
with ``tp=1``: no collective) for the tp-1 side of the comparison.
"""

import os

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.parallel.topology import initialize_mesh
from deepspeed_tpu_torch.serving import SamplingParams, ServingEngine

import torch_dist_worker as dw


def model(family, kw, tree=None, tp=None):
    """A port model of ``family`` built on the rank mesh (``tp=None``) or
    at ``tp=1``, weights from the whole JAX tree when given."""
    cfg_cls, cls = dw.MODELS[family]
    m = cls(cfg_cls(**kw), tp=tp)
    if tree is not None:
        m.load_jax_params(tree)
    return m


def serve(engine, cfg, submits, stagger=(), one_at_a_time=False):
    """Token streams of ``[(prompt, SamplingParams kwargs)]`` served to the
    end (``stagger``: submit indices before which the server ticks once;
    ``one_at_a_time``: each request served alone, as the prefix-cache
    cases need), and the prefix cache's hits."""
    srv = ServingEngine(engine, cfg)
    rids = []
    for i, (p, kw) in enumerate(submits):
        if i in stagger:
            srv.step()
        rids.append(srv.submit(p, SamplingParams(**kw)))
        if one_at_a_time:
            srv.run_until_idle()
    srv.run_until_idle()
    assert {srv.result(r).state.value for r in rids} == {"finished"}
    out = [list(srv.result(r).tokens) for r in rids]
    cache = srv.scheduler.prefix_cache
    hits = cache.stats()["hits"] if cache is not None else None
    srv.shutdown()
    return out, hits


def _inference_case(case, tp):
    """One case's outputs on an engine at ``tp`` (None: the rank mesh's,
    1: tp 1)."""
    f32 = {"dtype": "float32"}
    if case.get("whole") and tp is None:
        # a whole model handed to a tp-2 engine: sharded in place
        m = model(case["family"], case["kw"], case["tree"], tp=1)
        engine = deepspeed_tpu_torch.init_inference(
            m, dict(f32, tensor_parallel={"tp_size": 2}), device="cpu")
    else:
        m = model(case["family"], case["kw"], case["tree"], tp=tp)
        engine = deepspeed_tpu_torch.init_inference(m, f32, device="cpu")
    out = {"tp": engine.tp.size,
           "local_numel": sum(p.numel() for p in m.parameters()),
           "whole_numel": sum(int(np.prod(s)) for s in m.whole_shapes())}
    with torch.inference_mode():
        out["logits"] = engine(torch.as_tensor(case["ids"])).numpy()
    out["generate"] = [engine.generate(np.asarray(p)[None], **kw)[0].numpy()
                       for p, kw in case["generate"]]
    out["serve"] = {name: serve(engine, cfg, submits, **opts)
                    for name, (cfg, submits, opts) in case["serve"].items()}
    out["jax_params"] = m.jax_params()
    return out


def inference_cases(rank, world, payload):
    """Each case of ``payload["cases"]`` at tp 2 on every rank, and at tp 1
    on rank 0; the ``model`` axis's collectives counted; then the
    refusals."""
    initialize_mesh(tp=2)
    comm.reset_comm_stats()
    out = {"tp2": [_inference_case(c, None) for c in payload["cases"]],
           "model_axis": comm.comm_axis_stats("model")}
    if rank == 0:
        out["tp1"] = [_inference_case(c, 1) for c in payload["cases"]]
    out["refusals"] = refusals(rank, world, payload["refusals"])
    return out


def _raised(fn):
    """The message of what ``fn()`` raised (its type first), or None."""
    try:
        fn()
    except Exception as e:  # the refusal under test
        return f"{type(e).__name__}: {e}"
    return None


def refusals(rank, world, payload):
    """Each ROADMAP.md row A8b2 refusal on the tp-2 mesh: ``{case: the
    exception's type and message}`` (None where nothing was raised)."""
    from deepspeed_tpu_torch.models.bert import BertConfig, BertModel
    initialize_mesh(tp=2)
    f32 = {"dtype": "float32"}
    tp2 = dict(f32, tensor_parallel={"tp_size": 2})
    gpt2 = model("gpt2", payload["gpt2"], payload["tree"])
    engine = deepspeed_tpu_torch.init_inference(gpt2, f32, device="cpu")
    pool = engine.init_slot_pool(2, 32)
    slots = {"num_slots": 2, "max_model_len": 32}
    bert = dict(vocab_size=96, n_positions=64, n_embd=64, n_layer=2,
                n_head=4, pad_vocab_to_multiple=8)
    train = {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
             "tensor_parallel_size": 2,
             "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    cases = {
        "bert serving": lambda: deepspeed_tpu_torch.init_inference(
            BertModel(BertConfig(**bert)), tp2, device="cpu"),
        "bert training": lambda: deepspeed_tpu_torch.initialize(
            model=BertModel(BertConfig(**bert)), config=train,
            device="cpu"),
        "dropout": lambda: model("gpt2", dict(payload["gpt2"],
                                              dropout=0.1)),
        "kv heads below tp": lambda: model(
            "llama", dict(payload["llama"], n_kv_head=1)),
        "lane extraction": lambda: engine.slot_extract_lane(pool, 0),
        "lane insertion": lambda: engine.slot_insert_lane(
            pool, 0, {n: c[:, :1].clone() for n, c in pool.items()}),
        "prefill role": lambda: ServingEngine(engine,
                                              dict(slots, role="prefill")),
        "draft model": lambda: ServingEngine(engine, dict(
            slots, speculative={"enabled": True, "k": 2, "draft": {
                "mode": "model", "n_layer": 1}})),
        "request deadlines": lambda: ServingEngine(
            engine, dict(slots, request_timeout_s=5.0)),
        "request timeout": lambda: ServingEngine(engine, slots).submit(
            np.arange(4), SamplingParams(max_new_tokens=2, timeout_s=5.0)),
        "megatron directory": lambda: deepspeed_tpu_torch.init_inference(
            os.path.join(payload["tmp"], "megatron"), tp2, device="cpu"),
    }
    return {name: _raised(fn) for name, fn in cases.items()}


def checkpoint_cases(rank, world, payload):
    """The tensor-parallel checkpoint sequence
    (``test_torch_tp_checkpoint``) on the tp-2 mesh: a JAX dp 1 x tp 2 tag
    loaded and re-saved; one step, then a tp-2 tag saved; a fresh engine
    resuming it, and another resuming a tp-1 tag; the resumed runs take
    one more step."""
    case, data = payload["case"], payload["batches"]
    out = {}
    engine = dw.engine_for(case)
    engine.load_checkpoint(payload["jax_dir"])
    out["loaded"] = dw.state(engine)
    engine.save_checkpoint(payload["resaved_dir"])
    out["steps"] = dw.run_steps(engine, data[:1])
    engine.save_checkpoint(payload["tp2_dir"])
    out["saved"] = dw.state(engine)
    out["next"] = dw.run_steps(engine, data[1:])
    out["continued"] = dw.state(engine)
    resumed = dw.engine_for(dict(case, tree=None))
    resumed.load_checkpoint(payload["tp2_dir"])
    out["resumed"] = dw.state(resumed)
    out["resumed_next"] = dw.run_steps(resumed, data[1:])
    out["resumed_continued"] = dw.state(resumed)
    from_one = dw.engine_for(dict(case, tree=None))
    from_one.load_checkpoint(payload["one_dir"])
    out["from_one"] = dw.state(from_one)
    out["staged"] = dw._staged_bytes(from_one, payload["one_dir"])
    return out
