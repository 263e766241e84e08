"""The radix prefix cache on the port's slot pool, held against the JAX
package's on the CPU in float32 with the same numpy weights.

``RadixPrefixCache`` takes the JAX class's decisions step for step under
one seeded random script, ``reuse_plan`` agrees on a grid, and the
scheduler with the cache (inline and chunked admissions, with and
without speculation) serves bitwise the JAX package's streams and the
cache-off streams, with the JAX package's hits and prefill work. A
parked lane survives the decode and verify writes of later ticks."""

import numpy as np
import pytest
import torch

import torch_pairs as tp
from deepspeed_tpu.serving import SamplingParams as JaxSamplingParams
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving.fleet.prefix_cache import \
    RadixPrefixCache as JaxRadixPrefixCache
from deepspeed_tpu.serving.fleet.prefix_cache import \
    reuse_plan as jax_reuse_plan
from deepspeed_tpu_torch.serving import (RequestState, SamplingParams,
                                         ServingEngine)
from deepspeed_tpu_torch.serving.config import PrefixCacheConfig
from deepspeed_tpu_torch.serving.fleet import RadixPrefixCache, reuse_plan
from deepspeed_tpu_torch.serving.scheduler import \
    reuse_plan as scheduler_reuse_plan

CACHE = {"prefix_cache": {"enabled": True, "min_prefix_len": 8}}
CHUNKED = {"chunked_prefill": {"enabled": True, "chunk_tokens": 16}}


@pytest.fixture(scope="module")
def gpt2():
    return tp.engines("gpt2")


@pytest.fixture(scope="module")
def llama():
    return tp.engines("llama")


# ---------------------------------------------------------- the radix trie

def _script(n_ops, seed):
    """A seeded random script of cache operations over token sequences
    that share prefixes (so lookups hit, donations collide and edges
    split)."""
    rng = np.random.default_rng(seed)
    stems = [list(rng.integers(0, 6, 12)) for _ in range(3)]

    def seq():
        stem = stems[rng.integers(len(stems))]
        cut = int(rng.integers(2, len(stem) + 1))
        return stem[:cut] + list(rng.integers(0, 6, rng.integers(0, 8)))

    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["lookup", "donate", "release", "pin", "unpin",
                           "evict", "remove"], p=[.3, .3, .15, .07, .07,
                                                  .06, .05])
        slot = int(rng.integers(0, 10))
        s = seq()
        ops.append((kind, slot, s, int(rng.integers(1, len(s) + 3)),
                    int(rng.integers(0, 12))))
    return ops


@pytest.mark.parametrize("cfg", [None, {"min_prefix_len": 3},
                                 {"min_prefix_len": 2,
                                  "max_cached_slots": 3}])
def test_radix_cache_takes_the_jax_decisions(cfg):
    """Every return value and ``stats()`` after every step equal the JAX
    class's, over 600 seeded lookups, donations, releases, pins,
    evictions and removals."""
    pc_cfg = None if cfg is None else PrefixCacheConfig.from_dict(cfg)
    got, want = RadixPrefixCache(pc_cfg), JaxRadixPrefixCache(pc_cfg)
    hits = {id(got): [], id(want): []}
    for kind, slot, tokens, kv_len, used in _script(600, seed=7):
        out = []
        for pc in (got, want):
            held = hits[id(pc)]
            if kind == "lookup":
                hit = pc.lookup(np.asarray(tokens, np.int32))
                if hit is not None:
                    held.append(hit)
                r = None if hit is None else (hit.slot, hit.matched)
            elif kind == "donate":
                r = pc.donate(slot, tokens, kv_len)
            elif kind == "release":
                r = None
                if held:
                    pc.release(held.pop(0), used_tokens=used)
            elif kind == "pin":
                r = pc.pin(slot)
            elif kind == "unpin":
                r = pc.unpin(slot)
            elif kind == "evict":
                r = pc.evict_lru()
            else:
                r = pc.remove_slot(slot)
            out.append((r, pc.stats(), sorted(pc.entries),
                        pc.cached_slots, pc.evictable))
        assert out[0] == out[1], (kind, slot, tokens)
    assert got.hits > 20 and got.donations > 20 and got.evictions > 0


def test_reuse_plan_equal_on_a_grid():
    """``reuse_plan`` gives the JAX package's ``(offset, suffix)`` on every
    point of a grid, and the scheduler re-exports it."""
    assert scheduler_reuse_plan is reuse_plan
    for max_len in (16, 64, 96):
        for prompt_len in range(1, max_len + 1):
            for matched in range(0, prompt_len + 3):
                assert reuse_plan(prompt_len, matched, max_len) == \
                    jax_reuse_plan(prompt_len, matched, max_len)


# ------------------------------------------------------- the scheduler

def _cohorts(shared_len=24, tails=(4, 5, 9, 30, 2), seed=11):
    shared = tp.prompts((shared_len,), seed=seed)[0]
    out = []
    for i, tail in enumerate(tp.prompts(tails, seed=seed + 1)):
        kw = dict(max_new_tokens=5 + i % 3)
        if i % 2:
            kw.update(temperature=0.8, top_k=9, seed=i)
        out.append((np.concatenate([shared, tail]).astype(np.int32), kw))
    return out


def _serial(engine_cls, sp_cls, engine, cfg, subs):
    """Serve one request at a time (each finished lane is donated before
    the next admission). Returns the streams and the serving engine."""
    srv = engine_cls(engine, cfg)
    rids = []
    for p, kw in subs:
        rids.append(srv.submit(p, sp_cls(**kw)))
        srv.run_until_idle()
    assert {srv.result(r).state for r in rids} == {
        srv.result(rids[0]).state}
    assert srv.result(rids[0]).state.value == "finished"
    out = [list(srv.result(r).tokens) for r in rids]
    return out, srv


def _prefill_tokens(tracer_spans):
    """Tokens that went through the stack at admission: whole prompts of
    ``prefill`` spans, the suffixes of ``prefix_reuse`` spans and the
    chunks."""
    n = 0
    for s in tracer_spans:
        if s.name == "prefill":
            n += s.args.get("suffix", s.args.get("prompt_len", 0))
        elif s.name == "prefix_reuse" and not s.args.get("chunked"):
            n += s.args["suffix"]
        elif s.name == "prefill_chunk":
            n += s.args["chunk"]
    return n


@pytest.mark.parametrize("family,chunked", [("gpt2", False),
                                            ("gpt2", True),
                                            ("llama", False)])
def test_cached_streams_equal_jax_and_uncached(family, chunked, request):
    """A shared prefix served one request at a time: with the cache, the
    streams are bitwise the cache-off streams and the JAX package's
    cached streams, with the JAX package's hits, saved tokens and
    lookups, and fewer prompt tokens through the stack."""
    from deepspeed_tpu_torch.telemetry import configure_tracer
    je, te = request.getfixturevalue(family)
    base = {"num_slots": 3, "max_model_len": 96, "max_queue": 8,
            **(CHUNKED if chunked else {})}
    subs = _cohorts()
    tr = configure_tracer(enabled=True, buffer_size=8192)
    try:
        tr.clear()
        off, srv_off = _serial(ServingEngine, SamplingParams, te, base,
                               subs)
        cost_off = _prefill_tokens(tr.spans())
        tr.clear()
        on, srv = _serial(ServingEngine, SamplingParams, te,
                          {**base, **CACHE}, subs)
        cost_on = _prefill_tokens(tr.spans())
        reuse = [s for s in tr.spans() if s.name == "prefix_reuse"]
    finally:
        configure_tracer(enabled=False)
        tr.clear()
    jon, jsrv = _serial(JaxServingEngine, JaxSamplingParams, je,
                        {**base, **CACHE}, subs)
    assert on == off == jon
    pc, jpc = srv.scheduler.prefix_cache, jsrv.scheduler.prefix_cache
    assert pc.stats() == jpc.stats()
    assert pc.hits >= 3 and all(s.args["matched"] >= 24 for s in reuse)
    assert len(reuse) == pc.hits and cost_on < cost_off
    assert sorted(srv.scheduler.pool.cached) == sorted(pc.entries)
    for s in (srv, srv_off, jsrv):
        s.shutdown()


def test_parked_lane_survives_later_decode_and_verify(llama):
    """A finished request's parked lane keeps its cached columns bit for
    bit while other requests decode (a dummy write a tick at
    ``lengths[slot]``) and verify (k + 1 dummy columns from there), and a
    later hit on it serves the plain stream."""
    _, te = llama
    cfg = {"num_slots": 3, "max_model_len": 96, **CACHE,
           "speculative": {"enabled": True, "k": 4,
                           "draft": {"mode": "self", "layers": 1}}}
    srv = ServingEngine(te, cfg)
    (pa, kwa), (pb, kwb), (pc_, kwc) = _cohorts(tails=(4, 30, 7))[:3]
    ra = srv.submit(pa, SamplingParams(**kwa))
    srv.run_until_idle()
    sched = srv.scheduler
    (slot,) = sched.pool.cached
    kv_len = int(sched.pool.lengths[slot])
    # a finishing block may leave its last token's K/V in the lane too
    out = srv.result(ra).output_ids
    assert len(pa) <= kv_len <= len(out)
    assert sched.prefix_cache.entries[slot].key == tuple(out[:kv_len])
    lane = {n: c[:, slot, :, :kv_len].clone()
            for n, c in sched.pool.cache.items()}
    # a request with another prefix: it runs on the free slot, while the
    # parked one takes the dummy writes
    other = tp.prompts((10,), seed=99)[0]
    rb = srv.submit(other, SamplingParams(max_new_tokens=12))
    srv.run_until_idle()
    assert srv.result(rb).state is RequestState.FINISHED
    assert sched.metrics.spec_ticks >= 3
    for n, c in sched.pool.cache.items():
        assert torch.equal(c[:, slot, :, :kv_len], lane[n])
    rc = srv.submit(pc_, SamplingParams(**kwc))
    srv.run_until_idle()
    assert sched.prefix_cache.hits == 1
    plain = ServingEngine(te, {"num_slots": 2, "max_model_len": 96})
    rp = plain.submit(pc_, SamplingParams(**kwc))
    plain.run_until_idle()
    assert srv.result(rc).tokens == plain.result(rp).tokens
    srv.shutdown()
    plain.shutdown()


def test_speculation_with_the_prefix_cache(gpt2):
    """Speculation and the prefix cache together, chunked: the draft lane
    is prefilled from the whole prompt at admission, and the streams are
    the plain ones and the JAX package's."""
    je, te = gpt2
    base = {"num_slots": 2, "max_model_len": 96, "max_queue": 8}
    spec = {**base, **CACHE, **CHUNKED,
            "speculative": {"enabled": True, "k": 2,
                            "draft": {"mode": "self", "layers": 1}}}
    subs = _cohorts(tails=(30, 9, 3, 17))
    off, _ = _serial(ServingEngine, SamplingParams, te, base, subs)
    on, srv = _serial(ServingEngine, SamplingParams, te, spec, subs)
    jon, jsrv = _serial(JaxServingEngine, JaxSamplingParams, je, spec, subs)
    assert on == off == jon
    assert srv.scheduler.prefix_cache.hits >= 2
    assert srv.metrics.spec_accepted == jsrv.metrics.spec_accepted
    srv.shutdown()
    jsrv.shutdown()


def test_pinning_blocks_eviction_under_pressure(gpt2):
    """A pinned entry survives the allocation pressure that evicts every
    unpinned one; unpinned, it is evictable again (the JAX package's
    case)."""
    _, te = gpt2
    srv = ServingEngine(te, {"num_slots": 2, "max_model_len": 64,
                             "prefix_cache": {"enabled": True,
                                              "min_prefix_len": 4}})
    pc = srv.scheduler.prefix_cache
    pa, pb = tp.prompts((8, 9), seed=21)
    for p in (pa, pb):
        srv.submit(p, SamplingParams(max_new_tokens=3))
        srv.run_until_idle()
    assert pc.cached_slots == 2 and srv.scheduler.pool.free_count == 0
    pinned = pc.lookup(np.concatenate([pa, [1, 2, 3]]))
    assert pinned is not None
    rc = srv.submit(tp.prompts((10,), seed=22)[0],
                    SamplingParams(max_new_tokens=3))
    srv.run_until_idle()
    assert srv.result(rc).state is RequestState.FINISHED
    assert pinned.entry.slot in pc.entries and pc.evictions >= 1
    for slot in list(pc.entries):
        pc.pin(slot)
    assert pc.evict_lru() is None
    for slot in list(pc.entries):
        pc.unpin(slot)
    pc.release(pinned)
    assert pc.evict_lru() is not None
    srv.shutdown()


def test_prefix_gauges(gpt2):
    """The cache's counters reach the ``serving/prefix_*`` gauges."""
    from deepspeed_tpu_torch.telemetry import configure_tracer
    _, te = gpt2
    tr = configure_tracer(enabled=True)
    try:
        srv = ServingEngine(te, {"num_slots": 2, "max_model_len": 96,
                                 "monitor_interval": 1, **CACHE})
        for p, kw in _cohorts()[:2]:
            srv.submit(p, SamplingParams(**kw))
            srv.run_until_idle()
        assert tr.counter_value("serving/prefix_cache_hits") == 1.0
        assert tr.counter_value("serving/prefix_cached_slots") == 2.0
        srv.shutdown()
    finally:
        configure_tracer(enabled=False)
        tr.clear()
