"""Prefill/decode disaggregation on the port: the ``KVHandoff`` frame and
the ``prefill`` / ``decode`` roles, held against the JAX package's on the
CPU in float32 with the same numpy weights.

Frames cross between the packages: float32 lanes bit for bit both ways,
and a JAX bfloat16 frame (its dtype written ``'<V2'``) loads in the port
as ``torch.bfloat16`` with the same bits. A prefill engine handing each
lane to a decode engine serves bitwise the unified streams and the JAX
package's disaggregated streams."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pairs as tp
from deepspeed_tpu.serving import SamplingParams as JaxSamplingParams
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving.fleet.handoff import \
    InProcessTransport as JaxTransport
from deepspeed_tpu.serving.fleet.handoff import KVHandoff as JaxKVHandoff
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.serving import (QueueFull, RequestState,
                                         SamplingParams, ServingEngine)
from deepspeed_tpu_torch.serving.fleet import InProcessTransport, KVHandoff

BASE = {"num_slots": 3, "max_model_len": 64, "max_prefills_per_tick": 2}


@pytest.fixture(scope="module")
def gpt2():
    return tp.engines("gpt2")


@pytest.fixture(scope="module")
def llama():
    return tp.engines("llama")


def _subs(lengths=(5, 9, 3, 12, 7), seed=51):
    kinds = [{}, dict(temperature=0.9, top_k=12, seed=4), {},
             dict(temperature=0.7, top_p=0.8, seed=99)]
    return [(p, dict(max_new_tokens=6 + i % 3, **kinds[i % len(kinds)]))
            for i, p in enumerate(tp.prompts(lengths, seed=seed))]


def _unified(engine_cls, sp_cls, engine, subs, cfg=BASE):
    srv = engine_cls(engine, cfg)
    rids = [srv.submit(p, sp_cls(**kw)) for p, kw in subs]
    srv.run_until_idle()
    out = [list(srv.result(r).tokens) for r in rids]
    srv.shutdown()
    return out


def _disagg(engine_cls, sp_cls, transport_cls, engine, subs, wire=None,
            decode_cfg=None):
    """A prefill engine whose sink (through the transport, and
    ``wire(handoff)`` if given) feeds a decode engine. Returns the
    streams and both engines."""
    dec = engine_cls(engine, {**BASE, "role": "decode",
                              **(decode_cfg or {})})
    sent = []

    def sink(handoff, request):
        sent.append(handoff)
        dec.submit_handoff(wire(handoff) if wire else handoff, request)

    transport = transport_cls(sink)
    pre = engine_cls(engine, {**BASE, "role": "prefill"},
                     handoff_sink=transport.send)
    rids = [pre.submit(p, sp_cls(**kw)) for p, kw in subs]
    while pre.step() + dec.step():
        pass
    reqs = [pre.result(r) for r in rids]
    assert {r.state.value for r in reqs} == {"finished"}
    assert transport.sent == len(subs)
    assert transport.bytes_moved == sum(h.nbytes() for h in sent)
    return [list(r.tokens) for r in reqs], pre, dec


def _lane(engine, prompt, max_len=32):
    pool = engine.init_slot_pool(2, max_len)
    pool, first = engine.slot_prefill(pool, 0, prompt)
    return first, engine.slot_extract_lane(pool, 0)


# ------------------------------------------------------------------ frames

def test_frame_round_trip(gpt2):
    """A frame carries the lane bit for bit and the whole sampling law;
    the lane comes back as tensors over the frame."""
    _, te = gpt2
    prompt = tp.prompts((10,), seed=61)[0]
    first, lane = _lane(te, prompt)
    assert all(isinstance(t, torch.Tensor) for t in lane.values())
    h = KVHandoff(prompt=prompt, first_token=first, kv_len=10, lane=lane,
                  temperature=0.7, top_k=12, top_p=0.8, seed=99,
                  max_new_tokens=5, eos_token_id=3, request_id=4,
                  source="r0", tenant="acme", trace={"trace_id": "t1"},
                  weights_version=2)
    h2 = KVHandoff.from_bytes(h.to_bytes())
    for name in ("first_token", "kv_len", "temperature", "top_k", "top_p",
                 "seed", "max_new_tokens", "eos_token_id", "request_id",
                 "source", "tenant", "trace", "weights_version"):
        assert getattr(h2, name) == getattr(h, name), name
    np.testing.assert_array_equal(h2.prompt, prompt)
    assert h2.nbytes() == h.nbytes() == sum(
        t.numel() * 4 for t in lane.values())
    for n in lane:
        assert h2.lane[n].dtype == torch.float32
        assert torch.equal(h2.lane[n], lane[n])
    with pytest.raises(ValueError, match="bad magic"):
        KVHandoff.from_bytes(b"XXXX" + h.to_bytes()[4:])


def test_f32_frames_cross_both_ways(gpt2):
    """A JAX ``to_bytes`` frame loads in the port bit for bit, and the
    port's loads in the JAX package; the headers are the same bytes."""
    je, te = gpt2
    prompt = tp.prompts((9,), seed=62)[0]
    jfirst, jlane = _lane(je, prompt)
    first, lane = _lane(te, prompt)
    assert jfirst == first
    meta = dict(prompt=prompt, first_token=first, kv_len=9,
                temperature=0.5, seed=7, max_new_tokens=4)
    jblob = JaxKVHandoff(lane=jlane, **meta).to_bytes()
    blob = KVHandoff(lane=lane, **meta).to_bytes()
    got = KVHandoff.from_bytes(jblob)
    want = JaxKVHandoff.from_bytes(blob)
    for n in ("k", "v"):
        np.testing.assert_array_equal(got.lane[n].numpy(),
                                      np.asarray(jlane[n]))
        np.testing.assert_array_equal(want.lane[n], lane[n].numpy())
    hlen = 6 + 4 + int.from_bytes(blob[6:10], "little")
    assert blob[:hlen] == jblob[:hlen]


def test_bf16_frames(gpt2):
    """A bfloat16 lane's header reads ``'<V2'`` as the JAX package writes
    it, and a JAX bfloat16 frame loads as ``torch.bfloat16`` with the
    same bits."""
    je, te = gpt2
    rng = np.random.default_rng(63)
    x = rng.standard_normal((2, 1, 4, 8, 16)).astype(np.float32)
    jlane = {n: np.asarray(jnp.asarray(x * (i + 1), jnp.bfloat16))
             for i, n in enumerate(("k", "v"))}
    lane = {n: torch.from_numpy(x * (i + 1)).to(torch.bfloat16)
            for i, n in enumerate(("k", "v"))}
    meta = dict(prompt=np.arange(5, dtype=np.int32), first_token=1,
                kv_len=5)
    blob = KVHandoff(lane=lane, **meta).to_bytes()
    jblob = JaxKVHandoff(lane=jlane, **meta).to_bytes()
    assert b'"dtype": "<V2"' in blob and blob == jblob
    got = KVHandoff.from_bytes(jblob)
    for n in ("k", "v"):
        assert got.lane[n].dtype == torch.bfloat16
        np.testing.assert_array_equal(got.lane[n].view(torch.int16).numpy(),
                                      jlane[n].view(np.int16))
        assert torch.equal(got.lane[n], lane[n])
    assert got.nbytes() == 2 * x.size * 2


# ------------------------------------------------------------------- roles

@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_roles_serve_the_unified_and_jax_streams(family, request):
    """Greedy and seeded-sampled requests through a prefill engine, an
    ``InProcessTransport`` and the wire codec into a decode engine: the
    streams are bitwise the unified ones and the JAX package's
    disaggregated ones; the decode side prefills nothing."""
    je, te = request.getfixturevalue(family)
    subs = _subs()
    uni = _unified(ServingEngine, SamplingParams, te, subs)
    got, pre, dec = _disagg(ServingEngine, SamplingParams,
                            InProcessTransport, te, subs,
                            wire=lambda h: KVHandoff.from_bytes(h.to_bytes()))
    want, jpre, jdec = _disagg(JaxServingEngine, JaxSamplingParams,
                               JaxTransport, je, subs)
    assert got == uni == want
    assert pre.metrics.handoffs_out == dec.metrics.handoffs_in == len(subs)
    assert pre.metrics.completed == 0
    assert dec.metrics.completed == jdec.metrics.completed == len(subs)
    assert dec.scheduler.pool.total_allocs == len(subs)
    assert pre.metrics.summary()["kv_handoffs_out"] == len(subs)
    assert pre.scheduler.spec is None and pre.scheduler.draft is None
    for srv in (pre, dec, jpre, jdec):
        srv.shutdown()


def test_decode_role_with_speculation_and_prefill_cache(gpt2):
    """The decode side speculates (its draft lane rebuilt from the prompt)
    and the prefill side parks handed-off prompts in its prefix cache:
    the streams stay the unified ones."""
    je, te = gpt2
    shared = tp.prompts((20,), seed=64)[0]
    subs = [(np.concatenate([shared, t]).astype(np.int32), kw)
            for (t, kw) in _subs((3, 6, 4), seed=65)]
    uni = _unified(ServingEngine, SamplingParams, te, subs)
    spec = {"speculative": {"enabled": True, "k": 2,
                            "draft": {"mode": "self", "layers": 1}}}
    got, pre, dec = _disagg(ServingEngine, SamplingParams,
                            InProcessTransport, te, subs, decode_cfg=spec)
    assert got == uni
    assert dec.metrics.spec_ticks > 0
    dec.shutdown()
    pre = ServingEngine(te, {**BASE, "role": "prefill",
                             "prefix_cache": {"enabled": True}},
                        handoff_sink=lambda h, r: None)
    for p, kw in subs:
        pre.submit(p, SamplingParams(**kw))
        pre.run_until_idle()
    pc = pre.scheduler.prefix_cache
    assert pc.hits == 2 and pc.donations >= 1
    pre.shutdown()


def test_direct_submit_handoff_delivers_the_first_token(gpt2):
    """Without a Request, the decode engine rebuilds one from the frame,
    delivers the sampled first token at once and decodes the rest: the
    stream is generate()'s."""
    _, te = gpt2
    prompt = tp.prompts((10,), seed=66)[0]
    first, lane = _lane(te, prompt)
    h = KVHandoff.from_bytes(KVHandoff(
        prompt=prompt, first_token=first, kv_len=10, lane=lane,
        max_new_tokens=5, tenant="zen").to_bytes())
    srv = ServingEngine(te, {"num_slots": 2, "max_model_len": 32,
                             "role": "decode"})
    seen = []
    rid = srv.submit_handoff(h, on_token=lambda r, t: seen.append(t))
    assert seen == [first]
    req = srv.result(rid)
    assert req.state is RequestState.RUNNING and req.tenant == "zen"
    srv.run_until_idle()
    assert req.state is RequestState.FINISHED and seen == req.tokens
    want = te.generate(prompt[None], max_new_tokens=5)[0].numpy()
    np.testing.assert_array_equal(req.output_ids, want)
    with pytest.raises(ValueError, match="exceeds"):
        srv.submit_handoff(KVHandoff(prompt=prompt, first_token=first,
                                     kv_len=30, lane=lane,
                                     max_new_tokens=5))
    srv.shutdown()


def test_weights_version_mismatch_prefills_locally(gpt2):
    """A lane from another weights_version is refused and the request
    prefilled in the decode engine's pool: the same stream, on both the
    Request path and the direct one; ``None`` is accepted."""
    _, te = gpt2
    subs = _subs((5, 9), seed=67)
    uni = _unified(ServingEngine, SamplingParams, te, subs)
    v1 = InferenceEngine(te.module, DeepSpeedInferenceConfig.from_dict(
        tp.F32), device="cpu")
    v1.weights_version = 1
    dec = ServingEngine(v1, {**BASE, "role": "decode"})
    pre = ServingEngine(te, {**BASE, "role": "prefill"},
                        handoff_sink=lambda h, r: dec.submit_handoff(h, r))
    rids = [pre.submit(p, SamplingParams(**kw)) for p, kw in subs]
    while pre.step() + dec.step():
        pass
    assert [pre.result(r).tokens for r in rids] == uni
    assert dec.metrics.handoffs_refused == 2 and dec.metrics.handoffs_in == 0
    # the direct path: a rebuilt Request, refused, prefilled here
    prompt, kw = subs[0]
    first, lane = _lane(te, prompt, BASE["max_model_len"])
    frame = dict(prompt=prompt, first_token=first, kv_len=len(prompt),
                 lane=lane, max_new_tokens=kw["max_new_tokens"])
    rid = dec.submit_handoff(KVHandoff(weights_version=0, **frame))
    rid2 = dec.submit_handoff(KVHandoff(weights_version=None, **frame))
    dec.run_until_idle()
    assert dec.result(rid).tokens == dec.result(rid2).tokens == uni[0]
    assert dec.metrics.handoffs_refused == 3 and dec.metrics.handoffs_in == 1
    for srv in (pre, dec):
        srv.shutdown()


def test_full_handoff_queue_raises_queue_full(gpt2):
    """The handoff queue shares ``max_queue`` with the prompt queue."""
    _, te = gpt2
    prompt = tp.prompts((6,), seed=68)[0]
    first, lane = _lane(te, prompt)
    srv = ServingEngine(te, {"num_slots": 1, "max_model_len": 32,
                             "max_queue": 2, "role": "decode"})
    for _ in range(2):
        srv.submit_handoff(KVHandoff(prompt=prompt, first_token=first,
                                     kv_len=6, lane=lane, max_new_tokens=3))
    with pytest.raises(QueueFull):
        srv.submit_handoff(KVHandoff(prompt=prompt, first_token=first,
                                     kv_len=6, lane=lane, max_new_tokens=3))
    assert srv.metrics.rejected == 1
    srv.run_until_idle()
    srv.shutdown()


def test_prefill_role_needs_a_sink(gpt2):
    _, te = gpt2
    srv = ServingEngine(te, {**BASE, "role": "prefill"})
    srv.submit(tp.prompts((6,), seed=69)[0], SamplingParams(max_new_tokens=3))
    with pytest.raises(RuntimeError, match="handoff_sink"):
        srv.step()
