"""Rank workers of the port's tensor-parallel tests (``tests/test_torch_tp_*.py``).

Like ``torch_dist_worker`` (whose ``spawn`` runs them on gloo ranks) this
module imports no JAX and nothing of the JAX package. Each worker makes
the rank mesh with its ``model`` axis (``initialize_mesh(tp=2)``, or dp 2
x tp 2 on 4 ranks), builds the port's models on it from the JAX-layout
numpy trees the test made, runs them, and returns numpy results; where a
case asks for it, rank 0 also runs the same case at tp 1 (a model built
with ``tp=1``: no collective) for the tp-1 side of the comparison.
"""

import copy

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
    on rank 0; the ``model`` axis's collectives counted."""
    initialize_mesh(tp=2)
    comm.reset_comm_stats()
    out = {"tp2": [_inference_case(c, None) for c in payload["cases"]],
           "model_axis": comm.comm_axis_stats("model")}
    if rank == 0:
        out["tp1"] = [_inference_case(c, 1) for c in payload["cases"]]
    return out


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


# ---------------------------------------------- the cases of row A8b2

# every layout the sparse attention took in this process, by its bytes
LAYOUTS = {}


def sparse_surgery(m, sparse):
    """DeepSpeed's sparse surgery ``sparse = (kind, config kwargs)`` on a
    BERT model; the block-sparse attention on K6/K7's plain versions
    (``impl="pallas"``), where ``auto`` takes the dense-masked path on the
    CPU."""
    import functools
    from deepspeed_tpu_torch.ops import sparse_attention_ops as ops
    from deepspeed_tpu_torch.ops.sparse_attention_utils import \
        SparseAttentionUtils
    if not isinstance(ops.sparse_attention, functools.partial):
        def recorded(q, k, v, layout, *args, real=ops.sparse_attention,
                     **kw):
            LAYOUTS[np.asarray(layout).tobytes()] = np.array(layout)
            return real(q, k, v, layout, *args, **kw)
        ops.sparse_attention = functools.partial(recorded, impl="pallas")
    kind, kw = sparse
    cls = {"fixed": ops.FixedSparsityConfig,
           "bigbird": ops.BigBirdSparsityConfig}[kind]
    return SparseAttentionUtils.\
        replace_model_self_attention_with_sparse_self_attention(
            m, sparsity_config=cls(**kw))


def tp_train_cases(rank, world, payload):
    """Each case of ``payload["cases"]``: a whole model from the case's
    tree (the sparse surgery when it names one) handed to an engine at
    its ``tensor_parallel_size``, its steps and whole state (rank 0's);
    then, where the case names a JAX tag, that tag loaded and saved
    again."""
    out = []
    for case in payload["cases"]:
        m = model(case["family"], case["kw"], case["tree"], tp=1)
        if case.get("sparse"):
            sparse_surgery(m, case["sparse"])
        engine = deepspeed_tpu_torch.initialize(
            model=m, config=case["config"], device="cpu")[0]
        steps = dw.run_steps(engine, case["batches"])
        st = dw.state(engine)
        if case.get("jax_tag"):
            engine.load_checkpoint(case["jax_tag"])
            engine.save_checkpoint(case["resaved"])
        out.append({"steps": steps, "state": st if rank == 0 else None,
                    "tp": engine.mp_world_size})
    return out


def tp_infer_case(case):
    """One inference case at its ``tp``: a whole model (the sparse surgery
    when the case names one) sharded by the engine; its logits, the
    layouts its sparse attention took, and the ``generate`` streams of a
    decoder."""
    m = model(case["family"], case["kw"], case["tree"], tp=1)
    if case.get("sparse"):
        sparse_surgery(m, case["sparse"])
    LAYOUTS.clear()
    engine = deepspeed_tpu_torch.init_inference(
        m, {"dtype": "float32", "tensor_parallel": {"tp_size": case["tp"]}},
        device="cpu")
    out = {"tp": engine.tp.size, "heads": m._head_range(),
           "kv_heads": getattr(m, "kv_heads", None)}
    with torch.inference_mode():
        out["logits"] = engine(torch.as_tensor(case["ids"])).numpy()
    out["layouts"] = list(LAYOUTS.values())
    out["generate"] = [engine.generate(np.asarray(p)[None], **kw)[0].numpy()
                       for p, kw in case.get("generate", ())]
    if case.get("serve"):
        cfg, submits = case["serve"]
        out["serve"] = serve(engine, cfg, submits)[0]
        pool = engine.init_slot_pool(2, 16)
        out["pool_heads"] = int(pool["k"].shape[2])
    return out


def tp_cases(rank, world, payload):
    """The inference cases of ``payload["infer"]``, then the training
    cases of ``payload["cases"]`` (``tp_train_cases``)."""
    infer = [tp_infer_case(c) for c in payload.get("infer", ())]
    return {"infer": infer, "train": tp_train_cases(rank, world, payload)}


# ------------------------------------ the decoder families of row A10

def whole_grads(m):
    """The gradients of ``m``'s parameters as a JAX-layout tree of numpy
    arrays, each sharded leaf gathered whole over the ``model`` group."""
    return m.jax_tree([(p.grad if sp is None else
                        sp.gather(p.grad, m.tp.group)).numpy()
                       for p, sp in zip(m.parameters(), m.tp_splits())],
                      stack=np.stack)


def family_cases(rank, world, payload):
    """Each family case of ``payload["cases"]`` at tp 2: a model built on
    the mesh from the whole tree, its logits and a served stream; where
    the case has a ``batch``, the loss of ``apply`` and its gradients
    gathered whole."""
    initialize_mesh(tp=2)
    out = []
    for case in payload["cases"]:
        m = model(case["family"], case["kw"], case["tree"])
        engine = deepspeed_tpu_torch.init_inference(
            m, {"dtype": "float32"}, device="cpu")
        res = {"tp": engine.tp.size}
        with torch.inference_mode():
            res["logits"] = engine(torch.as_tensor(case["ids"])).numpy()
        res["serve"] = serve(engine, *case["serve"])[0]
        if case.get("batch"):
            m = model(case["family"], case["kw"], case["tree"])
            loss = m.apply({k: torch.as_tensor(v).long()
                            for k, v in case["batch"].items()})
            loss.backward()
            res["loss"] = loss.item()
            res["grads"] = whole_grads(m)
        out.append(res)
    return out


def disagg(pre_engine, dec_engine, cfg, submits):
    """A ``prefill``-role server on ``pre_engine`` handing each lane, as
    wire bytes, to a ``decode``-role one on ``dec_engine``: the streams
    and the frames sent."""
    from deepspeed_tpu_torch.serving import KVHandoff
    frames = []
    dec = ServingEngine(dec_engine, dict(cfg, role="decode"))

    def sink(handoff, request):
        frames.append(handoff.to_bytes())
        dec.submit_handoff(KVHandoff.from_bytes(frames[-1]), request)

    pre = ServingEngine(pre_engine, dict(cfg, role="prefill"),
                        handoff_sink=sink)
    rids = [pre.submit(p, SamplingParams(**kw)) for p, kw in submits]
    while pre.step() + dec.step():
        pass
    reqs = [pre.result(r) for r in rids]
    assert {r.state.value for r in reqs} == {"finished"}
    out = [list(r.tokens) for r in reqs]
    pre.shutdown()
    dec.shutdown()
    return out, frames


def deadlines(engine, cfg, submits, script, skew):
    """Requests under a clock this rank reads ``skew`` seconds off: after
    each tick of ``script`` (the clock's value before it) each request's
    state; then the streams."""
    now = [0.0]
    srv = ServingEngine(engine, cfg, clock=lambda: now[0] + skew)
    rids = [srv.submit(p, SamplingParams(**kw)) for p, kw in submits]
    states = []
    for t in script:
        now[0] = t
        srv.step()
        states.append([srv.result(r).state.value for r in rids])
    srv.run_until_idle()
    states.append([srv.result(r).state.value for r in rids])
    out = [list(srv.result(r).tokens) for r in rids]
    timeouts = srv.metrics.timeouts
    srv.shutdown()
    return states, out, timeouts


def broadcasts():
    """Broadcasts this rank has made so far."""
    from deepspeed_tpu_torch.comm import comm
    return comm.comm_per_op_stats().get("broadcast", 0)


def serving_cases(rank, world, payload):
    """GPT-2 served at tp 2 beside the same weights at tp 1 on each rank:
    the unified streams; a tp-2 prefill engine feeding a tp-1 decode
    engine and the reverse (streams and frames); ``mode: "model"``
    drafts (the seed's draft gathered whole, then the test's draft tree
    loaded); deadlines under per-rank clocks that disagree; a Megatron
    directory at tp 2 and merged at tp 1."""
    import resource
    from deepspeed_tpu_torch.serving.config import DraftConfig
    initialize_mesh(tp=2)
    f32 = {"dtype": "float32"}
    two = deepspeed_tpu_torch.init_inference(
        model("gpt2", payload["kw"], payload["tree"], tp=1),
        dict(f32, tensor_parallel={"tp_size": 2}), device="cpu")
    one = deepspeed_tpu_torch.init_inference(
        model("gpt2", payload["kw"], payload["tree"], tp=1), f32,
        device="cpu")
    cfg, submits = payload["cfg"], payload["submits"]
    made = broadcasts()
    out = {"unified": serve(two, cfg, submits)[0]}
    out["unified_broadcasts"] = broadcasts() - made
    out["tp2_to_tp1"] = disagg(two, one, cfg, submits)
    out["tp1_to_tp2"] = disagg(one, two, cfg, submits)
    # a known lane (the test's numbers) through each engine's pool and
    # back, framed under the first served frame's header
    import dataclasses
    from deepspeed_tpu_torch.serving import KVHandoff
    known = {n: torch.from_numpy(a) for n, a in payload["lane"].items()}
    head = KVHandoff.from_bytes(out["tp2_to_tp1"][1][0])
    out["known_frames"] = {}
    for name, eng in (("tp2", two), ("tp1", one)):
        pool = eng.slot_insert_lane(eng.init_slot_pool(3, cfg[
            "max_model_len"]), 1, known)
        lane = eng.slot_extract_lane(pool, 1)
        out["known_frames"][name] = dataclasses.replace(
            head, lane=lane).to_bytes()
        out[f"pool_heads_{name}"] = int(pool["k"].shape[2])

    dcfg = payload["draft"]
    seeded = {}
    for name, eng in (("tp2", two), ("tp1", one)):
        draft = eng.init_draft(DraftConfig.from_dict(dcfg))
        # a copy: a tp-1 leaf's array is the parameter's own memory
        seeded[name] = copy.deepcopy(draft.model.jax_params())
        draft.model.load_jax_params(payload["draft_tree"])
    out["draft_seeded"] = seeded
    spec = dict(cfg, speculative={"enabled": True, "k": 2, "draft": dcfg})
    srv = ServingEngine(two, spec)
    rids = [srv.submit(p, SamplingParams(**kw)) for p, kw in submits]
    srv.run_until_idle()
    out["spec"] = ([list(srv.result(r).tokens) for r in rids],
                   srv.metrics.spec_accepted)
    srv.shutdown()

    made = broadcasts()
    out["deadlines"] = deadlines(two, payload["deadline_cfg"],
                                 payload["deadline_submits"],
                                 payload["script"], skew=100.0 * rank)
    out["deadline_broadcasts"] = broadcasts() - made

    ids = torch.as_tensor(payload["megatron_ids"])
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    meg = deepspeed_tpu_torch.init_inference(
        payload["megatron_grid"], dict(f32, tensor_parallel={"tp_size": 2}),
        device="cpu")
    out["megatron_rss_kib"] = (rss0, resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss)
    with torch.inference_mode():
        out["megatron"] = {
            "tp": meg.tp.size, "logits": meg(ids).numpy(),
            "generate": meg.generate(ids, max_new_tokens=6).numpy()}
    return out
