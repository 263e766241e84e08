"""Speculative decoding on the port's slot pool, held against the JAX
package's on the CPU in float32 with the same numpy weights: the cases of
``tests/unit/test_specdecode.py`` that this slice covers, re-run on the
port, and the two packages side by side.

``verify_with_slots`` gives the JAX logits and written columns within
1e-5 (both compute in float32 and differ only in the order of sums),
including a row whose block runs past the lane; forced full, partial and
zero acceptance keep the JAX package's columns and restore every other
column bit for bit; the served streams, greedy and seeded-sampled, are
bitwise the non-speculative streams and the JAX package's speculative
streams."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pairs as tp
from deepspeed_tpu.serving import SamplingParams as JaxSamplingParams
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving.config import DraftConfig as JaxDraftConfig
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.serving import (RequestState, SamplingParams,
                                         ServingEngine)
from deepspeed_tpu_torch.serving.config import DraftConfig

ATOL = 1e-5
S, MAX_LEN = 3, 64


@pytest.fixture(scope="module")
def gpt2():
    return tp.engines("gpt2")


@pytest.fixture(scope="module")
def llama():
    return tp.engines("llama")


def _spec(k=2, layers=1, **extra):
    cfg = {"num_slots": 4, "max_model_len": MAX_LEN,
           "speculative": {"enabled": True, "k": k,
                           "draft": {"mode": "self", "layers": layers}}}
    cfg.update(extra)
    return cfg


def _serve(engine_cls, sp_cls, engine, cfg, submits, stagger=(2,)):
    """Submit ``[(prompt, kwargs)]`` (two ticks before the ``stagger``-th
    ones), run until idle; returns the token lists and the engine (shut
    down)."""
    srv = engine_cls(engine, cfg)
    rids = []
    for i, (p, kw) in enumerate(submits):
        if i in stagger:
            srv.step()
            srv.step()
        rids.append(srv.submit(p, sp_cls(**kw)))
    srv.run_until_idle()
    assert {srv.result(r).state.value for r in rids} == {"finished"}
    out = [list(srv.result(r).tokens) for r in rids]
    srv.shutdown()
    return out, srv


def _mixed(lengths, seed, new=8):
    kinds = [{}, dict(temperature=0.9, seed=5),
             dict(temperature=1.2, top_k=7, seed=-3), {},
             dict(temperature=0.7, top_p=0.85, seed=2 ** 31 - 1)]
    return [(p, dict(max_new_tokens=new + i % 3, **kinds[i % len(kinds)]))
            for i, p in enumerate(tp.prompts(lengths, seed=seed))]


def _cache(port, seed):
    cfg = port.module.config
    shape = (cfg.n_layer, S, port.module.kv_heads, MAX_LEN, cfg.head_dim)
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}


# ------------------------------------------------------ verify_with_slots

@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_verify_with_slots_matches_jax(family, request):
    """Rows at different columns (the window of 24 cuts the second's keys,
    the third's block runs past the lane): logits and every written column
    as the JAX package's, the columns past the lane dropped."""
    je, te = request.getfixturevalue(family)
    cache = _cache(te, 1)
    positions = np.array([5, 40, MAX_LEN - 2], np.int32)
    ids = np.stack(tp.prompts([4, 4, 4], seed=2)).astype(np.int32)
    want_logits, want_cache = je.module.verify_with_slots(
        je.params, jnp.asarray(ids),
        {n: jnp.asarray(c) for n, c in cache.items()},
        jnp.asarray(positions))
    with torch.inference_mode():
        got_logits, got_cache = te.module.verify_with_slots(
            torch.from_numpy(ids).long(),
            {n: torch.from_numpy(c.copy()) for n, c in cache.items()},
            positions)
    assert tuple(got_logits.shape) == (S, 4, te.module.config.padded_vocab)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=ATOL, rtol=0)
    for n in ("k", "v"):
        np.testing.assert_allclose(got_cache[n].numpy(),
                                   np.asarray(want_cache[n]), atol=ATOL,
                                   rtol=0)
    changed = (got_cache["k"].numpy() != cache["k"]).any(axis=(0, 2, 4))
    assert [list(np.nonzero(row)[0]) for row in changed] == \
        [list(range(5, 9)), list(range(40, 44)), [MAX_LEN - 2, MAX_LEN - 1]]


def test_decode_with_slots_is_verify_of_one(gpt2):
    """A one-token verify is the decode step, bit for bit; the decode step
    still refuses a column past the lane, where verify drops it."""
    _, te = gpt2
    cache = _cache(te, 3)
    ids = torch.tensor([[7], [50], [3]])
    pos = np.array([5, 40, 0], np.int32)
    with torch.inference_mode():
        a, ca = te.module.decode_with_slots(
            ids, {n: torch.from_numpy(c.copy()) for n, c in cache.items()},
            pos)
        b, cb = te.module.verify_with_slots(
            ids, {n: torch.from_numpy(c.copy()) for n, c in cache.items()},
            pos)
        assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"])
        with pytest.raises(ValueError, match="outside the cache length"):
            te.module.decode_with_slots(
                ids, {n: torch.from_numpy(c.copy())
                      for n, c in cache.items()},
                np.array([5, MAX_LEN, 0]))


# ------------------------------------------------- forced accept/rollback

@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("force", ["full", "partial", "zero"])
def test_forced_acceptance_and_rollback(family, force, request):
    """Craft the draft block: the accept count is forced, the kept
    columns equal the JAX package's, every other column equals the
    pre-verify pool bit for bit (the dummy row included), and greedy
    decoding continued through the rolled-back pool gives generate()'s
    stream."""
    je, te = request.getfixturevalue(family)
    k = 4
    prompt = tp.prompts((6,), seed=21)[0]
    ref = te.generate(prompt[None], max_new_tokens=12)[0, 6:].numpy()
    pools = {}
    for name, eng in (("jax", je), ("port", te)):
        pool = eng.init_slot_pool(2, 32)
        pool, first = eng.slot_prefill(pool, 0, prompt)
        assert first == ref[0]
        pools[name] = pool
    good = ref[1:1 + k].astype(np.int32)
    drafts = np.zeros((2, k), np.int32)
    drafts[0] = good
    expect = k
    if force == "partial":
        drafts[0, 2] = (good[2] + 5) % tp.VOCAB
        expect = 2
    elif force == "zero":
        drafts[0] = (good + 7) % tp.VOCAB
        expect = 0
    toks = np.array([ref[0], 0], np.int32)
    pos = np.array([6, 0], np.int32)
    temps = np.zeros((2,), np.float32)
    before = {n: c.clone() for n, c in pools["port"].items()}
    jpool, jtgt, jacc = je.slot_verify_step(pools["jax"], toks, drafts, pos,
                                            temps)
    tpool, ttgt, tacc = te.slot_verify_step(pools["port"], toks, drafts, pos,
                                            temps)
    assert tacc.tolist() == np.asarray(jacc).tolist()
    assert int(tacc[0]) == expect
    np.testing.assert_array_equal(ttgt, np.asarray(jtgt))
    keep = np.zeros((2, 32), bool)
    for s in range(2):
        keep[s, pos[s]:pos[s] + tacc[s] + 1] = True
    for n in ("k", "v"):
        got, old = tpool[n].numpy(), before[n].numpy()
        np.testing.assert_allclose(got, np.asarray(jpool[n]), atol=ATOL,
                                   rtol=0)
        rolled = ~keep[None, :, None, :, None] & np.ones(got.shape, bool)
        np.testing.assert_array_equal(got[rolled], old[rolled])
    emitted = [int(ref[0])] + ttgt[0, :expect + 1].tolist()
    assert emitted == ref[:len(emitted)].tolist()
    length, pending = 6 + 1 + expect, emitted[-1]
    while len(emitted) < 12:
        toks[0], pos[0] = pending, length
        tpool, nxt = te.slot_decode_step(tpool, toks, pos, temps)
        pending = int(nxt[0])
        emitted.append(pending)
        length += 1
    assert emitted == ref.tolist()


# ------------------------------------------------------------ the streams

@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_streams_equal_plain_and_jax_speculative(family, request):
    """Staggered greedy and seeded-sampled requests: speculation on is
    bitwise speculation off and bitwise the JAX package's speculative
    streams, with the same acceptance; greedy streams are generate()'s;
    one verify shape and one draft shape ran."""
    je, te = request.getfixturevalue(family)
    subs = _mixed((5, 9, 3, 12, 7), seed=12)
    off, _ = _serve(ServingEngine, SamplingParams, te,
                    {"num_slots": 4, "max_model_len": MAX_LEN}, subs)
    on, srv = _serve(ServingEngine, SamplingParams, te, _spec(), subs)
    jon, jsrv = _serve(JaxServingEngine, JaxSamplingParams, je, _spec(),
                       subs)
    assert on == off == jon
    for (p, kw), toks in zip(subs, on):
        if not kw.get("temperature"):
            want = te.generate(p[None], max_new_tokens=len(toks))[0]
            assert toks == want[len(p):].tolist()
    m, jm = srv.metrics, jsrv.metrics
    assert m.spec_ticks > 0 and m.spec_emitted > m.spec_ticks
    assert (m.spec_ticks, m.spec_accepted, m.spec_emitted) == \
        (jm.spec_ticks, jm.spec_accepted, jm.spec_emitted)
    assert te.slot_verify_executables(4, MAX_LEN, 2) == 1
    assert te.slot_draft_executables(srv.scheduler.draft, 4, MAX_LEN, 2) == 1


def test_eos_inside_accepted_block(gpt2):
    """A request whose EOS lands inside an accepted block stops at the
    EOS, as the plain path does, and frees its slot."""
    _, te = gpt2
    prompt = tp.prompts((6,), seed=13)[0]
    gen = te.generate(prompt[None], max_new_tokens=8)[0, 6:].numpy()
    eos = int(gen[2])
    srv = ServingEngine(te, _spec(k=4, layers=2))
    rid = srv.submit(prompt, SamplingParams(max_new_tokens=8,
                                            eos_token_id=eos))
    srv.run_until_idle()
    req = srv.result(rid)
    assert req.state is RequestState.FINISHED and req.tokens[-1] == eos
    stop = list(gen).index(eos) + 1
    assert req.tokens == gen[:stop].tolist()
    assert srv.metrics.spec_accepted >= 1        # it ended inside a block
    assert srv.scheduler.pool.free_count == 4
    srv.shutdown()


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_full_depth_self_draft_always_accepts(family, request):
    """``layers == n_layer`` makes the draft the target: every tick
    accepts all k and emits k + 1 tokens."""
    _, te = request.getfixturevalue(family)
    srv = ServingEngine(te, _spec(k=2, layers=2, num_slots=2))
    prompt = tp.prompts((5,), seed=51)[0]
    rid = srv.submit(prompt, SamplingParams(max_new_tokens=9))
    srv.run_until_idle()
    want = te.generate(prompt[None], max_new_tokens=9)[0].numpy()
    np.testing.assert_array_equal(srv.result(rid).output_ids, want)
    m = srv.metrics
    assert m.spec_acceptance_ema == pytest.approx(1.0)
    assert m.spec_ticks == 3 and m.spec_emitted == 8
    assert m.spec_accepted == m.spec_proposed == 6
    srv.shutdown()


def test_self_draft_shares_the_targets_storage(llama):
    """A self draft holds the target's first ``layers`` blocks and its top
    leaves: the same Parameters, no copy."""
    _, te = llama
    draft = te.init_draft(DraftConfig.from_dict({"mode": "self",
                                                 "layers": 1}))
    assert te.init_draft(DraftConfig.from_dict(
        {"mode": "self", "layers": 1})) is draft           # cached
    model = draft.model
    assert model.config.n_layer == 1 and len(model.blocks) == 1
    assert type(model) is type(te.module)
    target = {p.data_ptr() for p in te.module.parameters()}
    assert {p.data_ptr() for p in model.parameters()} <= target
    for name in model.top_leaves:
        assert getattr(model, name) is getattr(te.module, name)
    assert model.blocks[0] is te.module.blocks[0]
    assert draft.describe == "self(layers=1)"
    with pytest.raises(ValueError, match="outside"):
        te.init_draft(DraftConfig.from_dict({"mode": "self", "layers": 3}))


def test_model_draft_parity_with_jax_params(gpt2):
    """``mode="model"``: a separate small draft of the same family. With
    the JAX draft's params carried across, the port proposes the JAX
    draft's tokens, and serving gives the plain streams with the JAX
    package's acceptance."""
    je, te = gpt2
    dcfg = {"mode": "model", "n_layer": 1, "n_embd": 32, "n_head": 2,
            "seed": 3}
    jdraft = je.init_draft(JaxDraftConfig.from_dict(dcfg))
    draft = te.init_draft(DraftConfig.from_dict(dcfg))
    assert draft.mode == "model" and draft.model.config.n_embd == 32
    assert draft.model.wte.data_ptr() != te.module.wte.data_ptr()
    draft.model.load_jax_params(jax.device_get(jdraft.params))
    prompts = tp.prompts((6, 9), seed=52)
    n = 2
    arrays = (np.zeros((n,), np.int32), np.zeros((n,), np.int32),
              np.zeros((n,), np.float32), np.zeros((n,), np.int32),
              np.ones((n,), np.float32), np.zeros((n,), np.int32))
    toks, pos, temps, tks, tps, seeds = arrays
    temps[1], seeds[1] = 0.9, 4
    props = []
    for eng, d in ((je, jdraft), (te, draft)):
        dpool = eng.init_draft_pool(d, n, 32)
        for s, p in enumerate(prompts):
            dpool = eng.draft_prefill(d, dpool, s, p)
            toks[s], pos[s] = p[-1], len(p)
        _, prop = eng.slot_draft_propose(d, dpool, toks, pos, temps, tks,
                                         tps, seeds, 4)
        props.append(np.asarray(prop))
    np.testing.assert_array_equal(props[1], props[0])
    cfg = {"num_slots": 2, "max_model_len": MAX_LEN,
           "speculative": {"enabled": True, "k": 2, "draft": dcfg}}
    subs = _mixed((6, 9, 4), seed=53)
    on, srv = _serve(ServingEngine, SamplingParams, te, cfg, subs)
    jon, jsrv = _serve(JaxServingEngine, JaxSamplingParams, je, cfg, subs)
    off, _ = _serve(ServingEngine, SamplingParams, te,
                    {"num_slots": 2, "max_model_len": MAX_LEN}, subs)
    assert on == jon == off
    assert srv.metrics.spec_accepted == jsrv.metrics.spec_accepted


def test_one_verify_shape_per_k(gpt2):
    """Many ticks at one k run one verify shape; a second k adds one."""
    _, te = gpt2
    engine = InferenceEngine(te.module, DeepSpeedInferenceConfig.from_dict(
        tp.F32), device="cpu")
    prompts = tp.prompts((5, 9, 3, 12), seed=31)
    for k in (2, 4):
        srv = ServingEngine(engine, _spec(k=k, layers=1))
        for p in prompts:
            srv.submit(p, SamplingParams(max_new_tokens=10))
        srv.run_until_idle()
        assert engine.slot_verify_executables(4, MAX_LEN, k) == 1
        srv.shutdown()
    verify = [s for s in engine._slot_shapes if s[0] == "slot_verify"]
    draft = [s for s in engine._slot_shapes if s[0] == "slot_draft"]
    assert sorted(s[3] for s in verify) == [2, 4] and len(draft) == 2
    assert engine.slot_decode_executables(4, MAX_LEN) == 0


def test_gpt2_served_at_n_positions_with_drafts(gpt2):
    """GPT-2 served at ``max_model_len == n_positions`` with a request that
    fills it: the drafts and the verify block run past the learned
    positions (clamped, as the JAX package's gather clamps) and past the
    lane (dropped), and the streams are the plain ones and the JAX
    package's."""
    je, te = gpt2
    n_pos = te.module.config.n_positions
    prompts = tp.prompts((n_pos - 9, 20), seed=71)
    subs = [(prompts[0], dict(max_new_tokens=9)),
            (prompts[1], dict(max_new_tokens=12, temperature=0.8, seed=1))]
    cfg = {"num_slots": 2, "max_model_len": n_pos,
           "speculative": {"enabled": True, "k": 4,
                           "draft": {"mode": "self", "layers": 1}}}
    on, srv = _serve(ServingEngine, SamplingParams, te, cfg, subs)
    jon, _ = _serve(JaxServingEngine, JaxSamplingParams, je, cfg, subs)
    off, _ = _serve(ServingEngine, SamplingParams, te,
                    {"num_slots": 2, "max_model_len": n_pos}, subs)
    assert on == off == jon
    assert [len(t) for t in on] == [9, 12]
    assert srv.metrics.spec_ticks > 0


def test_spec_metrics_in_summary_and_gauges(gpt2):
    """The speculative counters reach the summary and the ``spec/*``
    gauges under the JAX package's names."""
    from deepspeed_tpu_torch.telemetry import configure_tracer
    _, te = gpt2
    tr = configure_tracer(enabled=True)
    try:
        tr.clear()
        srv = ServingEngine(te, _spec(k=2, layers=2, num_slots=2))
        srv.submit(tp.prompts((5,), seed=61)[0],
                   SamplingParams(max_new_tokens=8))
        srv.run_until_idle()
        spec = srv.metrics.summary()["speculative"]
        assert spec["k"] == 2 and spec["acceptance_rate"] == 1.0
        assert tr.counter_value("spec/acceptance_ema") == 1.0
        names = {s.name for s in tr.spans()}
        assert {"draft_propose", "spec_verify"} <= names
        srv.shutdown()
        assert tr.counter_value("spec/acceptance_ema") is None
    finally:
        configure_tracer(enabled=False)
        tr.clear()


def test_draft_config_carries_across(gpt2):
    """The draft block parses as the JAX package's; a target-depth draft
    is the default self depth's double."""
    for cfg in ({"mode": "self", "layers": 2}, {"mode": "model"},
                {"mode": "model", "n_layer": 1, "n_embd": 32,
                 "n_head": 2, "seed": 7}):
        assert DraftConfig.from_dict(cfg).to_dict() == \
            JaxDraftConfig.from_dict(cfg).to_dict()
    _, te = gpt2
    draft = te.init_draft(DraftConfig.from_dict({"mode": "self"}))
    assert draft.layers == te.module.config.n_layer // 2
    assert dataclasses.replace(draft.model.config, n_layer=2) == \
        te.module.config
