"""The int8 slot pool (``inference/kv_quant.py``, serving's ``kv_quant``)
of the port held against the JAX package (float32, the tiny models of
``torch_pairs``).

- The pool after prefills, decode ticks and a verify tick: the port runs
  the JAX package's algorithm a layer at a time (dequantize, the float
  step, quantize every column again; a verify keeps the old bytes of the
  columns it did not keep). The port's pool is bitwise that algorithm run
  whole on the port's model (the ``_jax_steps`` oracle below: whole-pool
  dequantize, the float step, whole-pool quantize, the verify's roll-back
  in quantized space), and
  against the JAX package's own pool the payload ``q`` is bitwise and the
  scales within 2e-6 relative: the two packages' f32 K/V differ in their
  last bits, which moves a column's absmax scale by an ulp.
- ``ServingEngine`` streams with ``kv_quant`` (plain, chunked prefill,
  self-draft speculation, the prefix cache) are the JAX package's bit for
  bit.
- int8 ``KVHandoff`` frames: byte-identical to the JAX package's for the
  same lane, read by each package from the other's, and a lane extracted
  and inserted again is the same bytes (into a float pool, dequantized).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.serving.fleet.handoff import KVHandoff as JaxKVHandoff
from deepspeed_tpu_torch.inference.kv_quant import (QuantizedSlotPool,
                                                     dequantize_pool,
                                                     pool_nbytes,
                                                     quantize_kv,
                                                     quantize_pool)
from deepspeed_tpu_torch.serving.fleet import KVHandoff

import torch_pairs as tp
import torch_tp_pairs as tpp
import torch_tp_worker

FAMILIES = ("gpt2", "llama")
S, LEN = 4, 64
SCALE_RTOL = 2e-6


def _script():
    """Prompts, decode tokens and a verify block (a slot accepts)."""
    prompts = tp.prompts([5, 9, 17, 3], seed=1)
    return prompts, [np.array([1, 2, 3, 4]), np.array([7, 8, 9, 10]),
                     np.array([11, 12, 13, 14])], \
        np.array([[1, 2], [3, 4], [5, 6], [7, 8]])


def _jax_steps(te, prompts, decodes, draft):
    """The JAX package's int8-pool algorithm on the port's model: every
    step dequantizes the whole pool, runs the float step and quantizes
    the whole pool again (a prefill quantizes its fresh lane whole)."""
    model = te.module
    ref = te.init_slot_pool(S, LEN)                     # float, zeroed
    pool = quantize_pool(ref, te.dtype)
    with torch.inference_mode():
        for s, p in enumerate(prompts):
            lane = model.init_kv_cache(1, LEN, dtype=te.dtype, device="cpu")
            bucket = min(1 << max(0, len(p) - 1).bit_length(), LEN)
            ids = np.zeros((1, bucket), np.int64)
            ids[0, :len(p)] = p
            model.apply_with_cache(torch.as_tensor(ids), lane, 0)
            q = quantize_pool(lane, te.dtype)
            for n in ("k", "v"):
                pool.q[n][:, s:s + 1] = q.q[n]
                pool.scales[n][:, s:s + 1] = q.scales[n]
        pos = np.array([len(p) for p in prompts])
        for toks in decodes:
            fp = dequantize_pool(pool, te.dtype)
            model.decode_with_slots(torch.as_tensor(toks)[:, None], fp,
                                    torch.as_tensor(pos))
            pool = quantize_pool(fp, te.dtype)
            pos = pos + 1
        toks = decodes[-1]
        fp = dequantize_pool(pool, te.dtype)
        block = np.concatenate([toks[:, None], draft], axis=1)
        model.verify_with_slots(torch.as_tensor(block), fp, pos)
        return pool, quantize_pool(fp, te.dtype), pos


@pytest.fixture(scope="module", params=FAMILIES)
def ticks(request):
    family = request.param
    je, te = tp.engines(family)
    prompts, decodes, draft = _script()
    jp = je.init_slot_pool(S, LEN, quantize=True)
    pool = te.init_slot_pool(S, LEN, quantize=True)
    firsts = []
    for s, p in enumerate(prompts):
        jp, jt = je.slot_prefill(jp, s, p)
        pool, t = te.slot_prefill(pool, s, p)
        firsts.append((jt, t))
    pos = np.array([len(p) for p in prompts])
    for toks in decodes:
        jp, jn = je.slot_decode_step(jp, toks, pos, np.zeros(S, np.float32))
        pool, n = te.slot_decode_step(pool, toks, pos,
                                      np.zeros(S, np.float32))
        firsts.append((list(np.asarray(jn)), list(n)))
        pos = pos + 1
    old = {k: v.clone() for k, v in te._tensors(pool).items()}
    jp, jtg, ja = je.slot_verify_step(jp, decodes[-1], draft, pos,
                                      np.zeros(S, np.float32))
    pool, tg, acc = te.slot_verify_step(pool, decodes[-1], draft, pos,
                                        np.zeros(S, np.float32))
    return dict(family=family, je=je, te=te, jp=jp, pool=pool, old=old,
                firsts=firsts, verify=((np.asarray(jtg), np.asarray(ja)),
                                       (tg, acc)), pos=pos)


def test_pool_is_the_jax_algorithm_bit_for_bit(ticks):
    te, pool = ticks["te"], ticks["pool"]
    prompts, decodes, draft = _script()
    before, fresh, pos = _jax_steps(te, prompts, decodes, draft)
    for n in ("k", "v"):          # the pool the verify started from
        assert torch.equal(ticks["old"][f"q/{n}"], before.q[n])
        assert torch.equal(ticks["old"][f"scales/{n}"], before.scales[n])
    # after the verify: the columns it wrote and kept hold the new bytes,
    # every other column its old ones
    acc = ticks["verify"][1][1]
    cols = torch.arange(LEN)[None, :]
    keep = (cols >= torch.as_tensor(pos)[:, None]) & \
        (cols <= torch.as_tensor(pos + acc)[:, None])
    for n in ("k", "v"):
        q = torch.where(keep[None, :, None, :, None], fresh.q[n], before.q[n])
        s = torch.where(keep[None, :, None, :], fresh.scales[n],
                        before.scales[n])
        assert torch.equal(pool.q[n], q)
        assert torch.equal(pool.scales[n], s)


def test_pool_matches_the_jax_pool(ticks):
    jp, pool = ticks["jp"], ticks["pool"]
    for a, b in ticks["firsts"]:
        assert a == b
    (jtg, ja), (tg, acc) = ticks["verify"]
    np.testing.assert_array_equal(tg, jtg)
    np.testing.assert_array_equal(acc, ja)
    for n in ("k", "v"):
        np.testing.assert_array_equal(pool.q[n].numpy(), np.asarray(jp.q[n]))
        np.testing.assert_allclose(pool.scales[n].numpy(),
                                   np.asarray(jp.scales[n]), rtol=SCALE_RTOL)
    assert pool_nbytes(pool) == sum(
        np.asarray(x).nbytes for x in (jp.q["k"], jp.q["v"],
                                       jp.scales["k"], jp.scales["v"]))


def test_int8_handoff_frames_cross_both_ways(ticks):
    """The JAX package's int8 lane framed by each package: the same bytes;
    each reads the other's; the port's own lane extracted and inserted
    is the same bytes, and into a float pool it is the dequantized
    lane."""
    je, te, jp, pool = ticks["je"], ticks["te"], ticks["jp"], ticks["pool"]
    jlane = je.slot_extract_lane(jp, 1)
    lane = QuantizedSlotPool(
        {n: torch.from_numpy(np.array(v)) for n, v in jlane.q.items()},
        {n: torch.from_numpy(np.array(v)) for n, v in jlane.scales.items()})
    prompt = tp.prompts((9,), seed=1)[0]
    meta = dict(prompt=prompt, first_token=3, kv_len=9, temperature=0.5,
                seed=7, max_new_tokens=4)
    jblob = JaxKVHandoff(lane=jlane, **meta).to_bytes()
    blob = KVHandoff(lane=lane, **meta).to_bytes()
    assert blob == jblob and b'"quantized": true' in blob
    got = KVHandoff.from_bytes(jblob)
    want = JaxKVHandoff.from_bytes(blob)
    assert isinstance(got.lane, QuantizedSlotPool)
    for n in ("k", "v"):
        np.testing.assert_array_equal(got.lane.q[n].numpy(),
                                      np.asarray(jlane.q[n]))
        np.testing.assert_array_equal(np.asarray(want.lane.scales[n]),
                                      lane.scales[n].numpy())
    assert got.nbytes() == sum(np.asarray(x).nbytes for x in (
        jlane.q["k"], jlane.q["v"], jlane.scales["k"], jlane.scales["v"]))
    # the port's lane: extracted, framed, inserted into another slot
    mine = KVHandoff.from_bytes(KVHandoff(
        lane=te.slot_extract_lane(pool, 2), **meta).to_bytes())
    other = te.init_slot_pool(S, LEN, quantize=True)
    other = te.slot_insert_lane(other, 0, mine.lane)
    for n in ("k", "v"):
        assert torch.equal(other.q[n][:, 0], pool.q[n][:, 2])
        assert torch.equal(other.scales[n][:, 0], pool.scales[n][:, 2])
    fp = te.slot_insert_lane(te.init_slot_pool(S, LEN), 3, mine.lane)
    deq = dequantize_pool(mine.lane, te.dtype)
    for n in ("k", "v"):
        assert torch.equal(fp[n][:, 3:4], deq[n])
    # a float lane into an int8 pool: quantized on the way in
    flane = te.slot_extract_lane(fp, 3)
    back = te.slot_insert_lane(te.init_slot_pool(S, LEN, quantize=True), 1,
                               flane)
    q, s = quantize_kv(flane["k"])
    assert torch.equal(back.q["k"][:, 1:2], q)
    assert torch.equal(back.scales["k"][:, 1:2], s)


KV = {"kv_quant": {"enabled": True}}
SERVE = ("plain", "chunked", "spec", "prefix")


@pytest.fixture(scope="module", params=FAMILIES)
def served(request):
    je, te = tp.engines(request.param)
    out = {}
    for name, (cfg, submits, opts) in tpp.serve_cases().items():
        cfg = dict(cfg, **KV)
        out[name] = (torch_tp_worker.serve(te, cfg, submits, **opts),
                     tpp.jax_serve(je, cfg, submits, **opts))
    return out, te


@pytest.mark.parametrize("name", SERVE)
def test_serving_streams_with_kv_quant_match_the_jax_package(served, name):
    out, te = served
    (streams, hits), (jstreams, jhits) = out[name]
    assert streams == jstreams
    assert hits == jhits


def test_kv_quant_reaches_the_pool_and_the_metrics():
    from deepspeed_tpu_torch.serving import ServingEngine
    _, te = tp.engines("gpt2")
    srv = ServingEngine(te, {"num_slots": 2, "max_model_len": 32, **KV})
    plain = ServingEngine(te, {"num_slots": 2, "max_model_len": 32})
    try:
        assert srv.scheduler.pool.quantized
        assert isinstance(srv.scheduler.pool.cache, QuantizedSlotPool)
        summary = srv.metrics.summary()
        assert summary["kv_pool_int8"] is True
        hd = te.module.config.n_embd // te.module.config.n_head
        assert summary["kv_pool_gib"] == round(
            srv.scheduler.pool.nbytes() / 2 ** 30, 6)
        ratio = srv.scheduler.pool.nbytes() / plain.scheduler.pool.nbytes()
        # int8 + an f32 scale per hd values, over the f32 pool's 4 bytes
        assert ratio == pytest.approx((1 + 4 / hd) / 4, rel=1e-4)
        from deepspeed_tpu_torch.serving import SamplingParams
        srv.submit(tp.prompts([6], seed=2)[0],
                   SamplingParams(max_new_tokens=4))
        srv.run_until_idle()
        assert srv.decode_executables() == 1
        assert te.slot_decode_executables(2, 32, quantized=False) == 0
    finally:
        srv.shutdown()
        plain.shutdown()
