"""Serving under tensor parallelism, the cases row A8b of the port left,
held against the JAX package on the CPU (float32, the tiny GPT-2 of
``torch_pairs``; 2 gloo ranks at tp 2, the JAX engine on a dp 1 x tp 2
mesh). ``KVHandoff``: a lane extracted at tp 2 is every kv head (the
ranks' gathered), so its frames are byte for byte the JAX tp-2 engine's
and the port's tp-1 ones; a tp-2 prefill engine feeds a tp-1 decode
engine and the reverse, each serving the unified streams bitwise.
``mode: "model"`` drafts are built at the target's tp (one seed, one
draft at every tp) and, on the JAX draft's tree, serve the JAX tp-2
engine's streams and acceptance bitwise. Deadlines: each rank reads its
own clock, 100 s apart, but the scheduler reads tp rank 0's, broadcast:
both ranks expire the same requests at the same tick, as the JAX engine
does under rank 0's clock; the ranks agree on a reading, in a tensor on
the engine's device, only where a deadline reads it. A tp 2 x pp 2
Megatron-LM directory served at tp 2: the logits within 2e-5 and the
greedy streams bitwise the merged directory's at tp 1 and the JAX
package's. One spawn; the JAX side runs
meanwhile."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.serving.config import DraftConfig as JaxDraft
from deepspeed_tpu.serving import SamplingParams as JaxSamplingParams
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving.fleet.handoff import KVHandoff as JaxKVHandoff

import torch_dist_worker
import torch_pairs as tp
import torch_tp_pairs as tpp
import torch_tp_worker
from unit.test_megatron_ckpt import _full_tensors, _write_ckpt

CFG = {"num_slots": 3, "max_model_len": 64}
DRAFT = {"mode": "model", "n_layer": 1, "n_embd": 32, "n_head": 2,
         "seed": 3}
DEADLINE_CFG = {"num_slots": 1, "max_model_len": 64,
                "request_timeout_s": 30.0}
# the clock rank 0 reads before each tick: the 5 s request expires at 10,
# the 30 s default at 40, the 50 s one at 60
SCRIPT = (0.0, 1.0, 10.0, 20.0, 40.0, 60.0)
F32 = {"dtype": "float32"}


def _jax_serve(engine, cfg, submits, clock=None):
    kw = {} if clock is None else {"clock": clock}
    srv = JaxServingEngine(engine, cfg, **kw)
    rids = [srv.submit(p, JaxSamplingParams(**s)) for p, s in submits]
    return srv, rids


def _jax_disagg(engine, submits):
    frames = []
    dec = JaxServingEngine(engine, dict(CFG, role="decode"))

    def sink(handoff, request):
        frames.append(handoff.to_bytes())
        dec.submit_handoff(JaxKVHandoff.from_bytes(frames[-1]), request)

    pre = JaxServingEngine(engine, dict(CFG, role="prefill"),
                           handoff_sink=sink)
    rids = [pre.submit(p, JaxSamplingParams(**s)) for p, s in submits]
    while pre.step() + dec.step():
        pass
    return [list(pre.result(r).tokens) for r in rids], frames


def _jax_deadlines(engine, submits):
    now = [0.0]
    srv, rids = _jax_serve(engine, DEADLINE_CFG, submits,
                           clock=lambda: now[0])
    states = []
    for t in SCRIPT:
        now[0] = t
        srv.step()
        states.append([srv.result(r).state.value for r in rids])
    srv.run_until_idle()
    states.append([srv.result(r).state.value for r in rids])
    return states, [list(srv.result(r).tokens) for r in rids], \
        srv.metrics.timeouts


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serving")
    tree = tp.tree("gpt2", seed=4)
    submits = tpp.mixed((5, 12, 7, 3), 21)
    deadline_submits = [
        (p, dict(max_new_tokens=20, **kw)) for p, kw in zip(
            tp.prompts((4, 6, 5), seed=3),
            (dict(timeout_s=50.0), dict(timeout_s=5.0), {}))]
    full = _full_tensors(np.random.default_rng(6))
    _write_ckpt(str(tmp / "grid"), full, tp=2, pp=2, version=0)
    _write_ckpt(str(tmp / "flat"), full, tp=1, pp=1)
    meg_ids = np.random.default_rng(7).integers(0, 64, (2, 6))
    shape = (tp.GPT2["n_layer"], 1, tp.GPT2["n_head"], CFG["max_model_len"],
             tp.GPT2["n_embd"] // tp.GPT2["n_head"])
    lane = {n: np.random.default_rng(8 + i).standard_normal(shape).astype(
        np.float32) for i, n in enumerate("kv")}
    je = tpp.jax_inference("gpt2", tree)
    jdraft = je.init_draft(JaxDraft.from_dict(DRAFT))
    draft_tree = jax.tree.map(np.asarray, jax.device_get(jdraft.params))
    started = torch_dist_worker.start(
        torch_tp_worker.serving_cases, tpp.TP, tmp,
        {"kw": tp.GPT2, "tree": tree, "cfg": CFG, "submits": submits,
         "draft": DRAFT, "draft_tree": draft_tree,
         "deadline_cfg": DEADLINE_CFG, "deadline_submits": deadline_submits,
         "script": SCRIPT, "megatron_grid": str(tmp / "grid"), "lane": lane,
         "megatron_ids": meg_ids})
    jax_side = {"disagg": _jax_disagg(je, submits),
                "deadlines": _jax_deadlines(je, deadline_submits)}
    head = JaxKVHandoff.from_bytes(jax_side["disagg"][1][0])
    # the port carries no trace context (ROADMAP.md row A12): null there
    jax_side["known_frame"] = dataclasses.replace(
        head, lane=lane, trace=None).to_bytes()
    srv, rids = _jax_serve(je, dict(CFG, speculative={
        "enabled": True, "k": 2, "draft": DRAFT}), submits)
    srv.run_until_idle()
    jax_side["spec"] = ([list(srv.result(r).tokens) for r in rids],
                        srv.metrics.spec_accepted)
    jm = deepspeed_tpu.init_inference(str(tmp / "flat"), F32)
    jm_ids = jnp.asarray(meg_ids.astype(np.int32))
    jax_side["megatron_logits"] = np.asarray(jm.forward(jm_ids))
    jax_side["megatron_generate"] = np.asarray(
        jm.generate(jm_ids, max_new_tokens=6))
    flat = deepspeed_tpu_torch.init_inference(str(tmp / "flat"), F32,
                                              device="cpu")
    with torch.inference_mode():
        ids = torch.as_tensor(meg_ids)
        jax_side["megatron_flat"] = (flat(ids).numpy(), flat.generate(
            ids, max_new_tokens=6).numpy())
    return torch_dist_worker.join(started), jax_side


@pytest.mark.parametrize("flow", ("tp2_to_tp1", "tp1_to_tp2"))
def test_roles_across_tp_serve_the_unified_streams(run, flow):
    ranks, jax_side = run
    for r in ranks:
        streams, _ = r[flow]
        assert streams == r["unified"] == jax_side["disagg"][0]


def _header(frame):
    n = int.from_bytes(frame[6:10], "little")
    return frame[:10 + n]


def test_frames_are_the_jax_frames_with_every_kv_head(run):
    """A known lane inserted into a tp-2 pool (each rank keeping its 2 of
    4 heads) and extracted again frames byte for byte as at tp 1 and as
    the JAX package frames it (its trace context, which the port does
    not carry, left out). The served flows' frames: a tp-2 prefill
    engine's headers byte for byte the tp-1 one's, their lanes of every
    head within 2e-5 of the JAX tp-2 engine's (the K/V differ in the last
    bits: the row-parallel sums and XLA's matmuls round in another order
    than one torch matmul)."""
    ranks, jax_side = run
    want = jax_side["disagg"][1]
    known = jax_side["known_frame"]
    for r in ranks:
        assert r["known_frames"]["tp2"] == r["known_frames"]["tp1"] == known
        assert (r["pool_heads_tp2"], r["pool_heads_tp1"]) == (2, 4)
        assert [_header(f) for f in r["tp2_to_tp1"][1]] == \
            [_header(f) for f in r["tp1_to_tp2"][1]]
        for flow in ("tp2_to_tp1", "tp1_to_tp2"):
            for f, w in zip(r[flow][1], want):
                got, exp = (np.frombuffer(x[len(_header(x)):], np.float32)
                            for x in (f, w))
                np.testing.assert_allclose(got, exp, atol=tpp.LOGITS_ATOL,
                                           rtol=0)


def test_model_draft_streams_are_bitwise_the_jax_tp2_engine(run):
    ranks, jax_side = run
    for r in ranks:
        assert r["spec"] == jax_side["spec"]
        seeded = r["draft_seeded"]
        for k, v in seeded["tp1"].items():
            if k == "blocks":
                for n, leaf in v.items():
                    np.testing.assert_array_equal(seeded["tp2"][k][n], leaf)
            else:
                np.testing.assert_array_equal(seeded["tp2"][k], v)
    assert jax_side["spec"][1] > 0


def test_skewed_clocks_expire_alike_on_every_rank_as_jax(run):
    ranks, jax_side = run
    want = jax_side["deadlines"]
    assert want[2] == 3 and "timeout" in want[0][-1]
    for r in ranks:
        assert r["deadlines"] == want


def test_skewed_clocks_are_agreed_only_where_a_deadline_reads_them(run):
    """With no deadline in play no decision reads the clock, and a tick
    makes no collective; with deadlines each submit and tick agrees on
    one reading, on every rank alike."""
    ranks, _ = run
    made = {r["deadline_broadcasts"] for r in ranks}
    assert [r["unified_broadcasts"] for r in ranks] == [0, 0]
    assert len(made) == 1 and made.pop() > len(SCRIPT)


def test_the_clock_is_agreed_in_a_tensor_on_the_engines_device(monkeypatch):
    """An NCCL group carries CUDA tensors only, so the reading crosses the
    ``model`` group on the engine's device (here ``meta``, which the
    stand-in broadcast records), and the value used is the one the
    broadcast brings (tp rank 0's)."""
    import types
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.serving import engine as serving_engine
    seen = []

    def broadcast(x, src, group):
        seen.append((x.device, x.dtype, src, group))
        return torch.tensor([7.5], dtype=torch.float64)

    monkeypatch.setattr(comm, "broadcast", broadcast)
    eng = types.SimpleNamespace(device=torch.device("meta"),
                                tp=types.SimpleNamespace(group="model"))
    assert serving_engine.tp_agree(eng)(3.0) == 7.5
    assert seen == [(torch.device("meta"), torch.float64, 0, "model")]


def test_a_megatron_directory_serves_at_tp2(run):
    """tp 2 x pp 2 shards merged on each rank, the rank keeping its part:
    the logits within 2e-5 of the merged tp-1 serve's and of the JAX
    package's, the greedy streams bitwise both."""
    ranks, jax_side = run
    flat_logits, flat_generate = jax_side["megatron_flat"]
    np.testing.assert_array_equal(flat_generate,
                                  jax_side["megatron_generate"])
    for r in ranks:
        got = r["megatron"]
        assert got["tp"] == 2
        for want in (flat_logits, jax_side["megatron_logits"]):
            np.testing.assert_allclose(got["logits"], want,
                                       atol=tpp.LOGITS_ATOL, rtol=0)
        np.testing.assert_array_equal(got["generate"], flat_generate)


