"""The port's continuous-batching serving held against the JAX package's on
the CPU, in float32 with the same numpy weights.

The cases of ``tests/unit/test_serving.py`` and
``tests/unit/test_chunked_prefill.py`` that this slice covers, re-run on
the port (generate parity and compile-once decode, EOS and slot reuse,
backpressure, deadlines, streaming and drain, submit validation, family
parity, bounded latency windows, SLO burn rate, chunked prefill, DRR
tenant admission, config validation); then the two packages side by side:
the same staggered requests, greedy and seeded-sampled, through both
``ServingEngine``s give bitwise the same token streams and the same
admission order, chunked prefill gives the monolithic streams, and beam
search gives the JAX package's output. Unported serving blocks raise
naming their ROADMAP.md rows."""

import numpy as np
import pytest
import torch

import torch_pairs as tp
from deepspeed_tpu.runtime.config_utils import ConfigError as JaxConfigError
from deepspeed_tpu.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving import TenantQueues as JaxTenantQueues
from deepspeed_tpu.serving import Request as JaxRequest
from deepspeed_tpu.serving import SamplingParams as JaxSamplingParams
from deepspeed_tpu.telemetry import get_tracer as jax_get_tracer
from deepspeed_tpu_torch.runtime.config_utils import ConfigError
from deepspeed_tpu_torch.serving import (ChunkedPrefillConfig, QueueFull,
                                         Request, RequestState,
                                         SamplingParams, ServingConfig,
                                         ServingEngine, TenantConfig,
                                         TenantQueues)
from deepspeed_tpu_torch.serving.config import SLOConfig
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.telemetry import Tracer, configure_tracer, get_tracer


@pytest.fixture(scope="module")
def gpt2():
    return tp.engines("gpt2")


@pytest.fixture(scope="module")
def llama():
    return tp.engines("llama")


def _generate(engine, prompt, new, **kw):
    return engine.generate(prompt[None], max_new_tokens=new, **kw)[0].numpy()


# ------------------------------------------------- the JAX package's cases

def test_greedy_token_parity_with_generate(gpt2):
    """Requests admitted at staggered ticks, with differing prompt lengths,
    give bitwise what a standalone generate() gives; the decode step ran
    one shape."""
    _, port = gpt2
    srv = ServingEngine(port, {"num_slots": 4, "max_model_len": 64})
    prompts = tp.prompts((5, 9, 3, 12, 7))
    rids = [srv.submit(p, SamplingParams(max_new_tokens=6))
            for p in prompts[:3]]
    srv.step()
    srv.step()
    rids += [srv.submit(p, SamplingParams(max_new_tokens=6))
             for p in prompts[3:]]
    srv.run_until_idle()
    for rid, p in zip(rids, prompts):
        req = srv.result(rid)
        assert req.state is RequestState.FINISHED
        np.testing.assert_array_equal(req.output_ids, _generate(port, p, 6))
    assert srv.decode_executables() == 1
    assert srv.scheduler.pool.cache["k"].device.type == "cpu"


def test_eos_retires_and_slot_is_reused(gpt2):
    _, port = gpt2
    prompts = tp.prompts((6, 6, 6, 6, 6), seed=1)
    eos = int(_generate(port, prompts[0], 1)[-1])
    srv = ServingEngine(port, {"num_slots": 2, "max_model_len": 64})
    sp = SamplingParams(max_new_tokens=5, eos_token_id=eos)
    rids = [srv.submit(p, sp) for p in prompts]
    srv.run_until_idle()
    pool = srv.scheduler.pool
    assert pool.free_count == 2 and pool.total_allocs == 5
    assert srv.result(rids[0]).tokens == [eos]        # retired at once
    for rid, p in zip(rids, prompts):
        req = srv.result(rid)
        assert req.state is RequestState.FINISHED and len(req.tokens) <= 5
        gen = _generate(port, p, 5, eos_token_id=eos)[len(p):]
        np.testing.assert_array_equal(np.asarray(req.tokens),
                                      gen[:len(req.tokens)])
        if len(req.tokens) < 5:
            assert req.tokens[-1] == eos and (gen[len(req.tokens):] ==
                                              eos).all()


def test_backpressure_queue_full(gpt2):
    _, port = gpt2
    srv = ServingEngine(port, {"num_slots": 1, "max_model_len": 64,
                               "max_queue": 2, "default_max_new_tokens": 4})
    prompts = tp.prompts((4, 4, 4), seed=2)
    srv.submit(prompts[0])
    srv.submit(prompts[1])
    with pytest.raises(QueueFull):
        srv.submit(prompts[2])
    assert srv.metrics.rejected == 1
    srv.step()
    rid = srv.submit(prompts[2], SamplingParams(max_new_tokens=2))
    srv.run_until_idle()
    assert srv.result(rid).state is RequestState.FINISHED


def test_deadline_timeout_fires(gpt2):
    _, port = gpt2
    now = [0.0]
    srv = ServingEngine(port, {"num_slots": 1, "max_model_len": 64},
                        clock=lambda: now[0])
    a, b = tp.prompts((4, 4), seed=3)
    ra = srv.submit(a, SamplingParams(max_new_tokens=8, timeout_s=50))
    rb = srv.submit(b, SamplingParams(max_new_tokens=8, timeout_s=5))
    srv.step()
    assert srv.result(rb).state is RequestState.QUEUED
    now[0] = 10.0
    srv.step()
    assert srv.result(rb).state is RequestState.TIMEOUT
    assert srv.result(ra).state is RequestState.RUNNING
    now[0] = 60.0
    srv.step()
    assert srv.result(ra).state is RequestState.TIMEOUT
    assert srv.scheduler.pool.free_count == 1
    assert srv.metrics.timeouts == 2


def test_streaming_callback_cancel_and_drain(gpt2):
    _, port = gpt2
    seen = []
    srv = ServingEngine(port, {"num_slots": 1, "max_model_len": 64})
    p, q = tp.prompts((5, 6), seed=4)
    rid = srv.submit(p, SamplingParams(max_new_tokens=4),
                     on_token=lambda req, tok: seen.append(tok))
    queued = srv.submit(q, SamplingParams(max_new_tokens=4))
    assert srv.queue_depth == 2 and srv.cancel(queued)
    assert srv.result(queued).state is RequestState.CANCELLED
    assert not srv.cancel(queued)
    srv.step()
    assert srv.active_requests == 1 and not srv.cancel(rid)
    srv.drain()
    req = srv.result(rid)
    assert req.state is RequestState.FINISHED
    assert seen == req.tokens and len(seen) == 4
    with pytest.raises(RuntimeError):
        srv.submit(p)


def test_submit_validation(gpt2):
    _, port = gpt2
    srv = ServingEngine(port, {"num_slots": 1, "max_model_len": 16})
    with pytest.raises(ValueError):
        srv.submit(np.arange(12, dtype=np.int32),
                   SamplingParams(max_new_tokens=8))
    with pytest.raises(ValueError):
        srv.submit(np.asarray([], np.int32))
    for bad in (dict(temperature=-1.0), dict(top_k=3), dict(tenant="a/b"),
                dict(tenant=""), dict(max_new_tokens=0),
                dict(temperature=1.0, top_p=0.0), dict(timeout_s=0)):
        with pytest.raises(ValueError):
            SamplingParams(**bad).validate()
        with pytest.raises(ValueError):
            JaxSamplingParams(**bad).validate()
    with pytest.raises(ValueError, match="n_positions"):
        ServingEngine(port, {"max_model_len": 4096})


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_family_parity_through_serving(family, request):
    _, port = request.getfixturevalue(family)
    srv = ServingEngine(port, {"num_slots": 3, "max_model_len": 64})
    prompts = tp.prompts((4, 30, 5), seed=7)
    rids = [srv.submit(p, SamplingParams(max_new_tokens=5)) for p in prompts]
    srv.run_until_idle()
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(srv.result(rid).output_ids,
                                      _generate(port, p, 5))


def test_latency_windows_bounded_memory():
    m = ServingMetrics(slo=SLOConfig.from_dict({"window": 32}))
    for _ in range(10_000):
        m.record_ttft(1.0)
    for _ in range(32):
        m.record_ttft(0.002)
        m.record_decode_step(0.001, n_active=1)
    assert len(m.ttft_ms) == 32 and len(m.token_ms) == 32
    assert m.ttft_ms.maxlen == 32 and m.e2e_ms.maxlen == 32
    assert m.percentiles()["ttft_ms"]["p99"] == pytest.approx(2.0)
    assert m.tokens_out == 10_000 + 64
    m.close()


def test_slo_burn_rate_tracking():
    m = ServingMetrics(slo=SLOConfig.from_dict({"window": 100,
                                                "ttft_ms": 50.0,
                                                "target": 0.99}))
    for i in range(100):
        m.record_ttft(0.010 if i % 10 else 0.100)
    status = m.slo_status()
    assert status["metrics"]["ttft_ms"]["violation_rate"] == \
        pytest.approx(0.10)
    assert status["burn_rate"] == pytest.approx(10.0)
    m.record_tick(queue_depth=0, slot_utilization=0.0)
    counters = get_tracer().counters()
    assert counters["serving/slo_burn_rate"][0] == pytest.approx(10.0)
    assert counters["serving/ttft_ms_p50"][0] == pytest.approx(10.0)
    m.close()
    assert "serving/slo_burn_rate" not in get_tracer().counters()


@pytest.mark.parametrize("decay", [None, 30.0])
def test_slo_burn_decay_matches_jax(decay):
    """With ``slo.decay_s`` an idle replica's burn relaxes to 0 on read;
    without it the window is frozen: both packages' metrics the same."""
    from deepspeed_tpu.serving.config import SLOConfig as JaxSLO
    from deepspeed_tpu.serving.metrics import ServingMetrics as JaxMetrics
    clock = {"t": 1000.0}
    slo = {"window": 64, "ttft_ms": 50.0, "target": 0.99, "decay_s": decay}
    ms = [cls(slo=scls.from_dict(slo), monitor_interval=1,
              clock=lambda: clock["t"])
          for cls, scls in ((ServingMetrics, SLOConfig),
                            (JaxMetrics, JaxSLO))]
    for m in ms:
        for i in range(16):
            m.record_ttft(0.100 if i % 2 else 0.01, tenant="acme")
        m.record_tick(queue_depth=0, slot_utilization=0.0)
    assert ms[0].last_burn_rate == ms[1].last_burn_rate == \
        pytest.approx(50.0)
    clock["t"] += 31.0
    assert ms[0].last_burn_rate == ms[1].last_burn_rate
    assert ms[0].tenant_status() == ms[1].tenant_status()
    assert ms[0].percentiles() == ms[1].percentiles()
    assert (ms[0].last_burn_rate == 0.0) == (decay is not None)
    for m in ms:
        m.close()


CHUNKED = {"chunked_prefill": {"enabled": True, "chunk_tokens": 16}}


def _serve(engine_cls, engine, cfg, submits, stagger=()):
    """Serve ``[(prompt, SamplingParams)]`` to the end; ``stagger`` holds
    the submit indices before which the server ticks once. Returns the
    token lists in submit order and the order the requests got their
    first token in."""
    srv = engine_cls(engine, cfg)
    first = []
    rids = []
    for i, (p, sp) in enumerate(submits):
        if i in stagger:
            srv.step()
        rids.append(srv.submit(
            p, sp, on_token=lambda req, tok: first.append(req.request_id)
            if len(req.tokens) == 1 else None))
    srv.run_until_idle()
    out = [list(srv.result(r).tokens) for r in rids]
    states = {srv.result(r).state.value for r in rids}
    order = [rids.index(r) for r in first]
    if engine_cls is ServingEngine:
        assert srv.decode_executables() == 1
    srv.shutdown()
    assert states == {"finished"}, states
    return out, order


def _mixed(sp_cls, lengths, seed):
    """Greedy and seeded-sampled requests over two tenants."""
    kinds = [dict(), dict(temperature=0.9, seed=5),
             dict(temperature=1.2, top_k=7, seed=-3), dict(),
             dict(temperature=0.7, top_p=0.85, seed=2 ** 31 - 1),
             dict(temperature=1.0, top_k=20, top_p=0.9, seed=9)]
    return [(p, sp_cls(max_new_tokens=6 + i % 3,
                       tenant="a" if i % 3 else "b",
                       **kinds[i % len(kinds)]))
            for i, p in enumerate(tp.prompts(lengths, seed=seed))]


TENANTS = {"tenants": {"enabled": True, "weights": {"a": 2.0},
                       "quantum_tokens": 8}}


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_streams_identical_to_jax_serving(family, request):
    """The same requests, submitted over ticks to both ServingEngines with
    DRR tenants on: bitwise the same streams, in the same admission
    order."""
    je, te = request.getfixturevalue(family)
    lengths = (5, 12, 7, 3, 14, 6, 9)
    cfg = {"num_slots": 3, "max_model_len": 64, "max_prefills_per_tick": 2,
           **TENANTS}
    want, want_order = _serve(JaxServingEngine, je, cfg,
                              _mixed(JaxSamplingParams, lengths, 11), (3, 5))
    got, got_order = _serve(ServingEngine, te, cfg,
                            _mixed(SamplingParams, lengths, 11), (3, 5))
    assert got == want
    assert got_order == want_order


def test_chunked_streams_equal_monolithic_and_jax(gpt2):
    """Chunked prefill is invisible in the streams (greedy and sampled),
    and the chunked run equals the JAX package's chunked run."""
    je, te = gpt2
    lengths = (40, 7, 53, 18)
    base = {"num_slots": 3, "max_model_len": 96, "max_queue": 8}
    mono, _ = _serve(ServingEngine, te, base,
                     _mixed(SamplingParams, lengths, 12))
    chunked, _ = _serve(ServingEngine, te, {**base, **CHUNKED},
                        _mixed(SamplingParams, lengths, 12))
    jchunked, _ = _serve(JaxServingEngine, je, {**base, **CHUNKED},
                         _mixed(JaxSamplingParams, lengths, 12))
    assert chunked == mono == jchunked
    assert te.slot_chunk_executables(3, 96, 16) == 1


def test_prefilling_request_expires_and_frees_slot(gpt2):
    _, port = gpt2
    clock = [0.0]
    srv = ServingEngine(port, {"num_slots": 2, "max_model_len": 96,
                               "max_queue": 8, **CHUNKED},
                        clock=lambda: clock[0])
    rid = srv.submit(tp.prompts([50], seed=61)[0],
                     SamplingParams(max_new_tokens=4, timeout_s=5.0))
    srv.step()
    assert srv.result(rid).state is RequestState.PREFILLING
    assert srv.active_requests == 1
    clock[0] = 10.0
    srv.step()
    assert srv.result(rid).state is RequestState.TIMEOUT
    assert not srv.scheduler.prefilling
    assert srv.scheduler.pool.free_count == 2


def test_lazy_expiry_at_pop_and_sweep(gpt2):
    _, port = gpt2
    clock = [0.0]
    srv = ServingEngine(port, {"num_slots": 1, "max_model_len": 64,
                               "max_queue": 16}, clock=lambda: clock[0])
    run = srv.submit(tp.prompts([8], seed=95)[0],
                     SamplingParams(max_new_tokens=10))
    srv.step()
    dead = [srv.submit(p, SamplingParams(max_new_tokens=2, timeout_s=1.0))
            for p in tp.prompts((8, 8, 8), seed=96)]
    live = srv.submit(tp.prompts([8], seed=99)[0],
                      SamplingParams(max_new_tokens=2))
    clock[0] = 5.0
    srv.run_until_idle()
    assert srv.result(run).state is RequestState.FINISHED
    assert all(srv.result(r).state is RequestState.TIMEOUT for r in dead)
    assert srv.result(live).state is RequestState.FINISHED
    assert srv.metrics.timeouts == 3


def _req(cls, sp_cls, tenant, n, rid):
    return cls(request_id=rid, prompt=np.zeros((n,), np.int32),
               sampling=sp_cls(tenant=tenant), max_new_tokens=1)


@pytest.mark.parametrize("cfg", [None, {"enabled": True,
                                        "weights": {"a": 2.0},
                                        "quantum_tokens": 32}])
def test_tenant_queue_pop_order_matches_jax(cfg):
    """FIFO without the block; deficit round-robin with it (weights 2:1:1,
    and a whale whose 8x longer prompts get ~1/8 of the pops): the same
    pop order as the JAX package's queue."""
    from deepspeed_tpu.serving.config import TenantConfig as JaxTenantConfig
    queues = [TenantQueues(None if cfg is None else
                           TenantConfig.from_dict(cfg)),
              JaxTenantQueues(None if cfg is None else
                              JaxTenantConfig.from_dict(cfg))]
    orders = []
    for q, cls, sp_cls in ((queues[0], Request, SamplingParams),
                           (queues[1], JaxRequest, JaxSamplingParams)):
        rid = 0
        for i in range(30):
            for t, n in (("a", 32), ("b", 32), ("c", 32), ("whale", 256)):
                q.append(_req(cls, sp_cls, t, n, rid))
                rid += 1
        orders.append([q.popleft().request_id for _ in range(80)])
    assert orders[0] == orders[1]
    served = {}
    for rid in orders[0][:60]:
        t = ("a", "b", "c", "whale")[rid % 4]
        served[t] = served.get(t, 0) + 1
    if cfg is not None:
        assert served["a"] == pytest.approx(2 * served["b"], abs=2)
        assert served["b"] >= 6 * served.get("whale", 0)


@pytest.mark.parametrize("family,kw", [
    ("gpt2", dict(num_beams=3)),
    ("gpt2", dict(num_beams=2, eos_token_id="first", length_penalty=0.6)),
    ("llama", dict(num_beams=4, eos_token_id="first"))])
def test_beam_search_identical_to_jax(family, kw, request):
    import jax.numpy as jnp
    je, te = request.getfixturevalue(family)
    prompts = np.stack(tp.prompts((9, 9), seed=21))
    kw = dict(kw)
    if kw.get("eos_token_id") == "first":
        # an EOS the beams really meet: the greedy stream's third token
        kw["eos_token_id"] = int(te.generate(prompts, max_new_tokens=3)
                                 [0, -1])
    want = np.asarray(je.generate(jnp.asarray(prompts), max_new_tokens=7,
                                  **kw))
    got = te.generate(prompts, max_new_tokens=7, **kw).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ config

GOOD = [{}, {"num_slots": 4, "max_seq_len": 128},
        {"slo": {"window": 16, "ttft_ms": 20.0, "decay_s": 3.0}},
        {"chunked_prefill": {"enabled": True, "chunk_tokens": 64},
         "tenants": {"enabled": True, "weights": {"a": 2.0},
                     "rates": {"a": 10.0}}},
        {"speculative": {"k": 2, "draft": {"mode": "model"}},
         "prefix_cache": {"min_prefix_len": 4}, "kv_quant": {},
         "monitor": False, "csv_monitor": {"enabled": False},
         "telemetry": {"enabled": False}, "resilience": {},
         "fleet": {"enabled": False}, "cost": {"ema_alpha": 0.5},
         "loadgen": {}, "compile_plane": {"enabled": False}},
        # served since speculation, the prefix cache and the roles were
        # ported (they raised naming ROADMAP.md row A6b / A12 before)
        {"speculative": {"enabled": True}},
        {"prefix_cache": {"enabled": True}},
        {"role": "decode"}]
BAD = [{"num_slots": 0}, {"max_model_len": 1}, {"max_queue": 0},
       {"max_prefills_per_tick": 0}, {"request_timeout_s": 0},
       {"no_such_key": 1}, {"role": "router"},
       {"slo": {"window": 4}}, {"slo": {"target": 1.0}},
       {"max_model_len": 64, "chunked_prefill": {"enabled": True,
                                                 "chunk_tokens": 128}},
       {"chunked_prefill": {"chunk_tokens": 100}},
       {"tenants": {"weights": {"a": -1}}},
       {"tenants": {"quantum_tokens": 0}},
       {"speculative": {"k": 3}}, {"prefix_cache": {"min_prefix_len": 0}},
       {"cost": {"ema_alpha": 0}}, {"loadgen": {"duration_s": 0}}]
# the int8 slot pool (kv_quant), once refused here: parsed as the JAX one
GOOD = GOOD + [{"kv_quant": {"enabled": True}}]
UNPORTED = [({"speculative": {"enabled": True, "acceptance_floor": 0.5}},
             "A12"),
            ({"monitor": True}, "A12"),
            ({"csv_monitor": {"enabled": True}}, "A12"),
            ({"telemetry": {"enabled": True}}, "A12"),
            ({"statusz": {"enabled": True}}, "A12"),
            ({"flight_recorder": {"enabled": True}}, "A12"),
            ({"resilience": {"handle_signals": True}}, "A12"),
            ({"fleet": {"enabled": True}}, "A12"),
            ({"loadgen": {"seed": 3}}, "A12"),
            ({"soak": {"tail_s": 1.0}}, "A12"),
            ({"cost": {"enabled": True}}, "A12"),
            ({"compile_plane": {"enabled": True}}, "A13"),
            ({"perf_plane": {"enabled": True}}, "A13")]


@pytest.mark.parametrize("cfg", GOOD)
def test_config_parses_as_jax(cfg):
    got = ServingConfig.from_dict(cfg)
    want = JaxServingConfig.from_dict(cfg)
    for key in ("num_slots", "max_model_len", "max_queue",
                "max_prefills_per_tick", "default_max_new_tokens",
                "request_timeout_s", "monitor_interval", "role"):
        assert getattr(got, key) == getattr(want, key), key
    for key in ("slo", "chunked_prefill", "tenants", "speculative",
                "prefix_cache", "kv_quant", "cost", "loadgen", "soak"):
        assert getattr(got, key).to_dict() == getattr(want, key).to_dict()


@pytest.mark.parametrize("cfg", BAD)
def test_config_errors_as_jax(cfg):
    with pytest.raises(JaxConfigError):
        JaxServingConfig.from_dict(cfg)
    with pytest.raises(ConfigError):
        ServingConfig.from_dict(cfg)
    if "chunked_prefill" in cfg and len(cfg) == 1:
        with pytest.raises(ConfigError):
            ChunkedPrefillConfig.from_dict(cfg["chunked_prefill"])
    if "tenants" in cfg:
        with pytest.raises(ConfigError):
            TenantConfig.from_dict(cfg["tenants"])


@pytest.mark.parametrize("cfg,row", UNPORTED)
def test_unported_blocks_raise_naming_their_row(cfg, row, gpt2):
    with pytest.raises(NotImplementedError, match=row):
        ServingConfig.from_dict(cfg)
    with pytest.raises(NotImplementedError, match=row):
        ServingEngine(gpt2[1], cfg)


def test_serving_needs_a_gpu_without_device_cpu():
    """The serving engine runs where its inference engine does: ``cuda``
    unless ``device="cpu"``, which raises without a GPU."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.init_inference(GPT2Model(GPT2Config(**tp.GPT2)),
                                           tp.F32)
    jax_get_tracer()       # the two packages keep separate tracers
    assert get_tracer() is not jax_get_tracer()


def test_tracer_core_as_jax():
    """Disabled, a span is the shared no-op singleton; enabled, nested and
    async spans land in the ring (its wraparound counted) and the serving
    engine's request lifecycle is recorded; gauges owned by a producer go
    when it releases them. The same records as the JAX package's tracer."""
    from deepspeed_tpu.telemetry.trace import Tracer as JaxTracer
    for cls in (Tracer, JaxTracer):
        tr = cls(buffer_size=16)
        assert tr.span("a") is tr.span("b")          # no allocation
        tr.configure(enabled=True)
        with tr.span("outer", args={"n": 1}) as sp:
            with tr.span("inner") as inner:
                inner.sync_on(torch.zeros(2) if cls is Tracer else None)
            sp.set(m=2)
        tr.async_begin("request", 7)
        tr.async_end("request", 7)
        for _ in range(20):
            with tr.span("tick"):
                pass
        assert len(tr.spans()) == 16 and tr.dropped == 8
        owner = object()
        tr.set_counter("serving/queue_depth", 3.0, owner=owner)
        assert tr.counter_value("serving/queue_depth") == 3.0
        tr.release_counters(owner)
        assert tr.counter_value("serving/queue_depth") is None
    tr = configure_tracer(enabled=True)
    try:
        tr.clear()
        _, port = tp.engines("gpt2")
        srv = ServingEngine(port, {"num_slots": 2, "max_model_len": 32})
        srv.submit(tp.prompts([5])[0], SamplingParams(max_new_tokens=3))
        srv.run_until_idle()
        names = [(s.name, s.ph) for s in tr.spans()]
        for want in (("request", "b"), ("request/queued", "e"),
                     ("prefill", "X"), ("decode_step", "X"),
                     ("request", "e")):
            assert want in names, want
        srv.shutdown()
    finally:
        configure_tracer(enabled=False)
        tr.clear()
