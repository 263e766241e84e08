"""The port's slot paths held against the JAX package's on the CPU, in
float32 with the same numpy weights: ``decode_with_slots`` and
``chunk_prefill_with_cache`` for GPT-2 and for LLaMA (4 heads on 2 kv heads,
a sliding window), with the slot rows at different positions, and the
engine's slot API (prefill, suffix and chunk prefill, the fused decode
step, lane copy / extract / insert). Tokens must be equal and logits and
cache lanes agree within 1e-5: both sides compute in float32 and differ
only in the order of sums."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pairs as tp

ATOL = 1e-5
S, MAX_LEN = 3, 64


@pytest.fixture(scope="module", params=sorted(tp.FAMILIES))
def pair(request):
    return request.param, tp.engines(request.param)


def _cache(port, seed):
    """A random ``[L, S, H_kv, MAX_LEN, hd]`` cache (earlier context in every
    column), as numpy."""
    cfg = port.module.config
    shape = (cfg.n_layer, S, port.module.kv_heads, MAX_LEN, cfg.head_dim)
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}


def _torch(cache):
    return {n: torch.from_numpy(c.copy()) for n, c in cache.items()}


def _close(got, want):
    for n in ("k", "v"):
        np.testing.assert_allclose(np.asarray(got[n]), np.asarray(want[n]),
                                   atol=ATOL, rtol=0)


def test_decode_with_slots_matches_jax(pair):
    family, (jax_engine, port) = pair
    cache = _cache(port, 1)
    # rows at different positions; the window (24) cuts the 40th's keys
    positions = np.array([5, 40, 0], np.int32)
    ids = np.array([[7], [50], [3]], np.int32)
    want_logits, want_cache = jax_engine.module.decode_with_slots(
        jax_engine.params, jnp.asarray(ids), {n: jnp.asarray(c)
                                             for n, c in cache.items()},
        jnp.asarray(positions))
    with torch.inference_mode():
        got_logits, got_cache = port.module.decode_with_slots(
            torch.from_numpy(ids).long(), _torch(cache),
            torch.from_numpy(positions))
    assert tuple(got_logits.shape) == (S, 1, port.module.config.padded_vocab)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=ATOL, rtol=0)
    _close(got_cache, want_cache)
    # only the fed columns changed
    changed = (got_cache["k"].numpy() != cache["k"]).any(axis=(0, 2, 4))
    assert [list(np.nonzero(row)[0]) for row in changed] == \
        [[p] for p in positions]


def test_chunk_prefill_with_cache_matches_jax(pair):
    family, (jax_engine, port) = pair
    cache = _cache(port, 2)
    lane = {n: c[:, 1:2] for n, c in cache.items()}
    ids = np.asarray(tp.prompts([16], seed=3)[0])[None]
    start = 24
    want = jax_engine.module.chunk_prefill_with_cache(
        jax_engine.params, jnp.asarray(ids),
        {n: jnp.asarray(c) for n, c in lane.items()}, jnp.int32(start))
    with torch.inference_mode():
        got = port.module.chunk_prefill_with_cache(
            torch.from_numpy(ids).long(), _torch(lane), start)
    _close(got, want)
    # and the chunk wrote exactly what apply_with_cache writes
    with torch.inference_mode():
        _, full = port.module.apply_with_cache(torch.from_numpy(ids).long(),
                                               _torch(lane), start)
    for n in ("k", "v"):
        assert torch.equal(got[n], full[n])


def _lanes_close(got_pool, want_pool, slots):
    for n in ("k", "v"):
        got = got_pool[n].numpy()[:, slots]
        want = np.asarray(want_pool[n])[:, slots]
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_slot_api_matches_jax_engine(pair):
    """Prefill (sampled and greedy), chunk + suffix prefill, a fused decode
    step over mixed rows, and lane copy / extract / insert: the same tokens
    and lanes as the JAX engine's."""
    family, (je, te) = pair
    p0, p1, p2 = tp.prompts([11, 5, 21], seed=4)
    jpool, tpool = je.init_slot_pool(S, MAX_LEN), te.init_slot_pool(S, MAX_LEN)
    assert tuple(tpool["k"].shape) == tuple(jpool["k"].shape)
    assert tpool["k"].device.type == "cpu"
    toks = {}
    for slot, prompt, kw in ((0, p0, dict(temperature=0.9, top_k=5,
                                          seed=3)),
                             (1, p1, {})):
        jpool, jt = je.slot_prefill(jpool, slot, prompt, **kw)
        tpool, tt = te.slot_prefill(tpool, slot, prompt, **kw)
        assert jt == tt
        toks[slot] = tt
    # slot 2: a 16-token chunk, then the 5-token suffix samples
    jpool = je.slot_chunk_prefill(jpool, 2, p2[:16], 0)
    tpool = te.slot_chunk_prefill(tpool, 2, p2[:16], 0)
    _lanes_close(tpool, jpool, [2])
    kw = dict(temperature=1.1, top_p=0.8, seed=-7)
    jpool, jt = je.slot_suffix_prefill(jpool, 2, p2[16:], 16, **kw)
    tpool, tt = te.slot_suffix_prefill(tpool, 2, p2[16:], 16, **kw)
    assert jt == tt
    toks[2] = tt
    _lanes_close(tpool, jpool, [0, 1, 2])
    assert te.slot_chunk_executables(S, MAX_LEN, 16) == 1
    # one fused decode step: sampled, greedy and top-k/top-p rows
    args = (np.array([toks[0], toks[1], toks[2]], np.int32),
            np.array([11, 5, 21], np.int32),
            np.array([0.7, 0.0, 1.3], np.float32),
            np.array([0, 0, 4], np.int32),
            np.array([0.9, 1.0, 0.95], np.float32),
            np.array([5, 0, 2 ** 31 - 1], np.int32))
    jpool, jnext = je.slot_decode_step(jpool, *args[:3], top_ks=args[3],
                                       top_ps=args[4], seeds=args[5])
    tpool, tnext = te.slot_decode_step(tpool, *args[:3], top_ks=args[3],
                                       top_ps=args[4], seeds=args[5])
    np.testing.assert_array_equal(tnext, np.asarray(jnext))
    _lanes_close(tpool, jpool, [0, 1, 2])
    assert te.slot_decode_executables(S, MAX_LEN) == 1
    # lanes: copy 0 -> 1, extract 1, insert it into 2
    jpool = je.slot_copy_lane(jpool, 0, 1)
    tpool = te.slot_copy_lane(tpool, 0, 1)
    jlane = je.slot_extract_lane(jpool, 1)
    tlane = te.slot_extract_lane(tpool, 1)
    for n in ("k", "v"):
        np.testing.assert_allclose(tlane[n].numpy(), np.asarray(jlane[n]),
                                   atol=ATOL, rtol=0)
        # a copy, never a view of the pool
        assert tlane[n].data_ptr() != tpool[n].data_ptr()
    tlane["k"].zero_()
    assert not bool((tpool["k"][:, 1] == 0).all())
    jpool = je.slot_insert_lane(jpool, 2, jlane)
    tpool = te.slot_insert_lane(tpool, 2, jlane)
    _lanes_close(tpool, jpool, [0, 1, 2])


def test_slot_api_refusals():
    """BERT has no slot path; an int8 pool names its row."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.bert import BertConfig, BertModel
    bert = deepspeed_tpu_torch.init_inference(BertModel(BertConfig(
        vocab_size=64, n_positions=32, n_embd=32, n_layer=1, n_head=2)),
        tp.F32, device="cpu")
    for call in (lambda: bert.init_slot_pool(2, 16),
                 lambda: bert.slot_decode_step({}, [0], [0], [0.0])):
        with pytest.raises(TypeError, match="KV-cache"):
            call()
    _, port = tp.engines("gpt2")
    # the int8 pool: payload 0 and scale 1 in every column, as the JAX
    # package's quantize_pool leaves a zero pool
    qpool = port.init_slot_pool(2, 16, quantize=True)
    assert qpool["k"].dtype == torch.int8 and not qpool["k"].any()
    assert (qpool.scales["v"] == 1).all()
    assert tuple(qpool.scales["k"].shape) == tuple(qpool["k"].shape[:-1])
    pool = port.init_slot_pool(2, 16)
    with pytest.raises(ValueError):
        port.slot_prefill(pool, 0, np.arange(17) % tp.VOCAB)
    with pytest.raises(ValueError):
        port.slot_chunk_prefill(pool, 0, np.arange(8), 12)
