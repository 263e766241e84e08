"""Serving metrics + sliding-window SLO tracking, as the JAX package's
``serving/metrics.py`` keeps them.

TTFT / per-token latency / end-to-end latency / queue depth / slot
utilization, recorded host-side by the scheduler. Every gauge lands in the
process-wide counters of the tracer (``telemetry/trace.py``), written with
this instance as their *owner*, so ``close()`` retracts them. The monitor
fan-out of the JAX package (``flush()`` into ``MonitorMaster``) is row
A12.

Latency percentile sources are **bounded sliding windows**
(``deque(maxlen=slo.window)``): a replica serving millions of requests
keeps O(window) memory, and the percentiles describe *recent* behavior.
The SLO tracker compares the windows against the configured targets
(``slo.ttft_ms`` / ``tpot_ms`` / ``e2e_ms`` at ``slo.target``) and
publishes a burn-rate gauge: observed violation rate / allowed violation
rate (>1 = out of budget). Per-tenant windows give the ``tenant/*`` gauges.
The speculative ticks feed the ``spec/*`` gauges (acceptance and
tokens-per-tick EMAs, the draft / verify wall split), the KV handoffs and
the prefix cache their ``serving/*`` counters, under the JAX package's
series names. ``FleetMetrics`` is row A12.
"""

import time
from collections import deque
from typing import Dict, List, Optional

from ..telemetry.trace import get_tracer


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[idx]


class _TenantStats:
    """One tenant's bounded SLO windows + counters: the per-tenant
    dimension of the serving metrics. Memory is O(window) per TRACKED
    tenant, and the tracked set is capped (tenants.max_tracked) with
    overflow folded into ``__other__`` — tenant strings are
    client-controlled and must not become an unbounded gauge family.
    The ``*_t`` deques are the sample timestamps, appended in lockstep
    with the values (same maxlen, so count-eviction stays aligned) —
    what ``slo.decay_s`` ages the window by."""

    __slots__ = ("ttft_ms", "e2e_ms", "ttft_t", "e2e_t", "submitted",
                 "completed", "tokens_out", "prompt_tokens", "timeouts")

    def __init__(self, window: int):
        self.ttft_ms: "deque[float]" = deque(maxlen=window)
        self.e2e_ms: "deque[float]" = deque(maxlen=window)
        self.ttft_t: "deque[float]" = deque(maxlen=window)
        self.e2e_t: "deque[float]" = deque(maxlen=window)
        self.submitted = 0
        self.completed = 0
        self.tokens_out = 0
        #: prompt tokens submitted under this tenant — with tokens_out,
        #: the cost plane's per-tenant denominators
        self.prompt_tokens = 0
        self.timeouts = 0


class ServingMetrics:
    """Host-side counters mirrored into the telemetry gauges."""

    def __init__(self, monitor_interval: int = 16, tracer=None, slo=None,
                 tenants=None, clock=None):
        self.monitor_interval = monitor_interval
        self.tracer = tracer or get_tracer()
        #: the slot pool's resident bytes and flavor (set by the
        #: scheduler: an int8 pool under ``kv_quant``)
        self.kv_pool_bytes = 0
        self.kv_pool_quantized = False
        self.slo = slo
        window = int(getattr(slo, "window", 1024) or 1024)
        self.window = window
        #: wall-clock aging of the windows (slo.decay_s): None = count-
        #: bounded only; set = samples older than decay_s leave the
        #: window, so an IDLE replica's burn rate relaxes to 0 instead of
        #: freezing at whatever its last traffic looked like. The clock
        #: is injectable for tests.
        self._decay_s = getattr(slo, "decay_s", None)
        self._clock = clock or time.monotonic
        #: per-tenant SLO windows (``dstpu_tenant_*`` gauge family,
        #: owner = this instance so close() retracts them)
        self.tenant_stats: Dict[str, _TenantStats] = {}
        self._tenant_cap = int(getattr(tenants, "max_tracked", 64) or 64)
        # bounded percentile sources: O(window) forever; the _t deques
        # are per-sample timestamps appended in lockstep (same maxlen)
        self.ttft_ms: "deque[float]" = deque(maxlen=window)
        self.token_ms: "deque[float]" = deque(maxlen=window)
        self.e2e_ms: "deque[float]" = deque(maxlen=window)
        self._ttft_t: "deque[float]" = deque(maxlen=window)
        self._token_t: "deque[float]" = deque(maxlen=window)
        self._e2e_t: "deque[float]" = deque(maxlen=window)
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.timeouts = 0
        self.tokens_out = 0
        self.ticks = 0
        self.handoffs_in = 0      # KV lanes received into this pool
        self.handoffs_out = 0     # KV lanes extracted and handed off
        self.handoffs_refused = 0  # lanes refused at a weights_version
                                   # boundary (prefilled locally)
        # speculative ticks: acceptance EMA, tokens-per-tick EMA and the
        # draft / verify wall split (the spec/* gauges)
        self.spec_ticks = 0
        self.spec_accepted = 0            # accepted draft tokens, lifetime
        self.spec_proposed = 0            # k x active, lifetime
        self.spec_emitted = 0             # tokens emitted by spec ticks
        self.spec_acceptance_ema: Optional[float] = None
        self.spec_tokens_per_tick_ema: Optional[float] = None
        self.spec_draft_ms = 0.0          # last tick's draft wall
        self.spec_verify_ms = 0.0         # last tick's verify wall
        self.spec_k = 0
        #: last computed SLO burn rate (refreshed every monitor_interval
        #: ticks by _emit_slo_gauges); None until targets produce one.
        #: The per-tick flight-recorder path reads this instead of
        #: re-walking the O(window) percentile sources every tick.
        self.last_burn_rate = None
        self._closed = False

    # ----------------------------------------------------------- decay
    @property
    def last_burn_rate(self) -> Optional[float]:
        """The cached burn rate — but with ``slo.decay_s`` set, reading
        it first ages the windows by wall clock and, when anything aged
        out, refreshes the burn + tenant gauges from the pruned windows.
        An idle replica's burn therefore relaxes to 0 on the next READ
        (the router's scoring/autoscale path) with no tick required,
        while an active replica's fresh samples never age out."""
        if self._decay_s and self._prune():
            self._emit_slo_gauges()
        return self._last_burn

    @last_burn_rate.setter
    def last_burn_rate(self, value: Optional[float]):
        self._last_burn = value

    def _window_pairs(self):
        yield self.ttft_ms, self._ttft_t
        yield self.token_ms, self._token_t
        yield self.e2e_ms, self._e2e_t
        for st in self.tenant_stats.values():
            yield st.ttft_ms, st.ttft_t
            yield st.e2e_ms, st.e2e_t

    def _prune(self) -> bool:
        """Age out samples older than ``slo.decay_s`` (values and
        timestamps leave in lockstep). Cheap when nothing expired: one
        peek per window. Returns True when anything was removed."""
        if not self._decay_s:
            return False
        cutoff = self._clock() - float(self._decay_s)
        removed = False
        for vals, stamps in self._window_pairs():
            while stamps and stamps[0] < cutoff:
                stamps.popleft()
                if vals:
                    vals.popleft()
                removed = True
        return removed

    # ------------------------------------------------------------- recording
    def _tenant(self, name) -> _TenantStats:
        """The tenant's stats bucket, folding overflow past the tracked
        cap into ``__other__``."""
        name = name or "default"
        stats = self.tenant_stats.get(name)
        if stats is None:
            if len(self.tenant_stats) >= self._tenant_cap and \
                    name != "__other__":
                return self._tenant("__other__")
            stats = self.tenant_stats[name] = _TenantStats(self.window)
        return stats

    def record_submit(self, tenant=None, prompt_tokens: int = 0):
        self.submitted += 1
        t = self._tenant(tenant)
        t.submitted += 1
        t.prompt_tokens += int(prompt_tokens)

    def record_reject(self):
        self.rejected += 1
        self._gauge("serving/rejected", self.rejected)

    def record_timeout(self, tenant=None):
        self.timeouts += 1
        self._gauge("serving/timeouts", self.timeouts)
        self._tenant(tenant).timeouts += 1

    def _now(self) -> float:
        """Sample timestamp for the decay clock; 0.0 (never read) when
        decay is off, so the hot recording paths stay clock-free."""
        return self._clock() if self._decay_s else 0.0

    def record_ttft(self, seconds: float, tenant=None):
        self.ttft_ms.append(seconds * 1e3)
        self._ttft_t.append(self._now())
        self.tokens_out += 1         # the first token is sampled at prefill
        self._gauge("serving/ttft_ms", seconds * 1e3)
        t = self._tenant(tenant)
        t.ttft_ms.append(seconds * 1e3)
        t.ttft_t.append(self._now())
        t.tokens_out += 1

    def record_decode_step(self, seconds: float, n_active: int):
        """One fused decode step advanced ``n_active`` requests by one
        token: the per-token latency every active request observed is the
        step wall time."""
        self.token_ms.append(seconds * 1e3)
        self._token_t.append(self._now())
        self.tokens_out += n_active

    def record_tenant_tokens(self, tenant, n: int = 1):
        """Attribute ``n`` decode tokens to ``tenant`` (the aggregate
        ``tokens_out`` is counted by the decode-step recorders)."""
        self._tenant(tenant).tokens_out += n

    def record_completion(self, request):
        self.completed += 1
        self._gauge("serving/completed", self.completed)
        tstats = self._tenant(getattr(request, "tenant", None))
        tstats.completed += 1
        finish = getattr(request, "finish_time", None)
        submit = getattr(request, "submit_time", None)
        if finish is not None and submit is not None and finish >= submit:
            e2e = (finish - submit) * 1e3
            self.e2e_ms.append(e2e)
            self._e2e_t.append(self._now())
            self._gauge("serving/e2e_ms", e2e)
            tstats.e2e_ms.append(e2e)
            tstats.e2e_t.append(self._now())

    def record_spec_tick(self, step_s: float, n_active: int, k: int,
                         accepted: int, emitted: int, draft_s: float,
                         verify_s: float, ema_alpha: float = 0.2):
        """One speculative tick advanced ``n_active`` requests by
        ``emitted`` tokens in all (``accepted`` of them draft-proposed).
        The per-token latency each request saw is the tick wall over its
        own emitted count, taken as the mean."""
        self.spec_ticks += 1
        self.spec_k = k
        self.spec_accepted += accepted
        self.spec_proposed += k * n_active
        self.spec_emitted += emitted
        self.tokens_out += emitted
        per_req = max(1.0, emitted / max(1, n_active))
        self.token_ms.append(step_s * 1e3 / per_req)
        self._token_t.append(self._now())
        self.spec_draft_ms = draft_s * 1e3
        self.spec_verify_ms = verify_s * 1e3
        rate = accepted / max(1, k * n_active)
        tpt = emitted / max(1, n_active)
        if self.spec_acceptance_ema is None:
            self.spec_acceptance_ema = rate
            self.spec_tokens_per_tick_ema = tpt
        else:
            a = ema_alpha
            self.spec_acceptance_ema += a * (rate - self.spec_acceptance_ema)
            self.spec_tokens_per_tick_ema += \
                a * (tpt - self.spec_tokens_per_tick_ema)
        if self.spec_ticks % self.monitor_interval == 0 or \
                self.spec_ticks == 1:
            self._gauge("spec/acceptance_ema", self.spec_acceptance_ema)
            self._gauge("spec/tokens_per_tick", self.spec_tokens_per_tick_ema)
            self._gauge("spec/k", k)
            self._gauge("spec/draft_ms", self.spec_draft_ms)
            self._gauge("spec/verify_ms", self.spec_verify_ms)
            self._gauge("spec/accepted_total", self.spec_accepted)
            self._gauge("spec/emitted_total", self.spec_emitted)

    def record_handoff_in(self):
        self.handoffs_in += 1
        self._gauge("serving/kv_handoffs_in", self.handoffs_in)

    def record_handoff_out(self):
        self.handoffs_out += 1
        self._gauge("serving/kv_handoffs_out", self.handoffs_out)

    def record_handoff_refused(self):
        self.handoffs_refused += 1
        self._gauge("serving/kv_handoffs_refused", self.handoffs_refused)

    def record_prefix_cache(self, cache):
        """Mirror the radix cache's counters into gauges, at the monitor
        cadence of the queue / utilization gauges."""
        if self.ticks % self.monitor_interval == 0 or self.ticks == 1:
            self._gauge("serving/prefix_cache_hit_rate", cache.hit_rate)
            self._gauge("serving/prefix_cache_hits", cache.hits)
            self._gauge("serving/prefix_cached_slots", cache.cached_slots)
            self._gauge("serving/prefix_tokens_saved", cache.tokens_saved)

    def record_tick(self, queue_depth: int, slot_utilization: float):
        self.ticks += 1
        if self.ticks % self.monitor_interval == 0 or self.ticks == 1:
            self._gauge("serving/queue_depth", queue_depth)
            self._gauge("serving/slot_utilization", slot_utilization)
            self._emit_slo_gauges()

    # ------------------------------------------------------------------ SLO
    def _slo_targets(self) -> Dict[str, Optional[float]]:
        return {"ttft_ms": getattr(self.slo, "ttft_ms", None),
                "tpot_ms": getattr(self.slo, "tpot_ms", None),
                "e2e_ms": getattr(self.slo, "e2e_ms", None)}

    def _windows(self) -> Dict[str, "deque[float]"]:
        return {"ttft_ms": self.ttft_ms, "tpot_ms": self.token_ms,
                "e2e_ms": self.e2e_ms}

    def percentiles(self) -> Dict[str, Dict[str, float]]:
        """p50/p95/p99 over the sliding windows, per latency metric."""
        self._prune()
        out = {}
        for name, window in self._windows().items():
            vals = sorted(window)
            out[name] = {"p50": round(_percentile(vals, 0.50), 3),
                         "p95": round(_percentile(vals, 0.95), 3),
                         "p99": round(_percentile(vals, 0.99), 3),
                         "n": len(vals)}
        return out

    def slo_status(self) -> Dict[str, object]:
        """Per-metric in-window violation fraction + the overall burn
        rate (worst metric). Metrics without a configured target report
        percentiles only."""
        self._prune()
        target = float(getattr(self.slo, "target", 0.99) or 0.99)
        allowed = max(1e-9, 1.0 - target)
        targets = self._slo_targets()
        metrics = {}
        burn = 0.0
        for name, window in self._windows().items():
            limit = targets.get(name)
            entry = {"target_ms": limit, "n": len(window)}
            if limit is not None and window:
                bad = sum(1 for v in window if v > limit)
                rate = bad / len(window)
                entry["violation_rate"] = round(rate, 6)
                entry["burn_rate"] = round(rate / allowed, 4)
                burn = max(burn, entry["burn_rate"])
            metrics[name] = entry
        return {"target_quantile": target, "burn_rate": round(burn, 4),
                "metrics": metrics}

    def tenant_status(self) -> Dict[str, Dict[str, object]]:
        """Per-tenant SLO view: latency percentiles over the tenant's
        own windows, the burn rate against the SHARED slo targets
        (tenant isolation means every tenant is held to the same SLO —
        per-tenant targets would hide the whale's damage), and the
        share of served tokens."""
        self._prune()
        target = float(getattr(self.slo, "target", 0.99) or 0.99)
        allowed = max(1e-9, 1.0 - target)
        targets = self._slo_targets()
        total_tokens = max(1, sum(t.tokens_out
                                  for t in self.tenant_stats.values()))
        out: Dict[str, Dict[str, object]] = {}
        for name, st in self.tenant_stats.items():
            burn = 0.0
            for metric, window in (("ttft_ms", st.ttft_ms),
                                   ("e2e_ms", st.e2e_ms)):
                limit = targets.get(metric)
                if limit is not None and window:
                    rate = sum(1 for v in window if v > limit) / len(window)
                    burn = max(burn, rate / allowed)
            ttft = sorted(st.ttft_ms)
            out[name] = {
                "submitted": st.submitted,
                "completed": st.completed,
                "timeouts": st.timeouts,
                "tokens_out": st.tokens_out,
                "prompt_tokens": st.prompt_tokens,
                "token_share": round(st.tokens_out / total_tokens, 4),
                "ttft_ms_p50": round(_percentile(ttft, 0.50), 3),
                "ttft_ms_p99": round(_percentile(ttft, 0.99), 3),
                "burn_rate": round(burn, 4),
            }
        return out

    def _emit_slo_gauges(self):
        pct = self.percentiles()
        for name, ps in pct.items():
            if ps["n"]:
                for q in ("p50", "p95", "p99"):
                    self._gauge(f"serving/{name}_{q}", ps[q])
        if any(v is not None for v in self._slo_targets().values()):
            self.last_burn_rate = self.slo_status()["burn_rate"]
            self._gauge("serving/slo_burn_rate", self.last_burn_rate)
        # the dstpu_tenant_* family: one tenant= labeled series per
        # metric (telemetry/export.py), owner= this instance so a
        # closed replica's tenant gauges vanish with it
        for tenant, row in self.tenant_status().items():
            for metric in ("ttft_ms_p50", "ttft_ms_p99", "burn_rate",
                           "completed", "tokens_out", "prompt_tokens",
                           "token_share"):
                self._gauge(f"tenant/{tenant}/{metric}", row[metric])

    # ------------------------------------------------------------- fan-out
    def _gauge(self, tag: str, value: float):
        """A gauge in the shared telemetry counters, owned by this
        instance."""
        self.tracer.set_counter(tag, float(value), self.ticks, owner=self)

    def close(self):
        """Retract this instance's gauges from the shared counter space —
        prometheus_dump()/​/metrics must not keep reporting a closed
        engine's last values as live. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.tracer.release_counters(self)

    # ------------------------------------------------------------- summary
    def kv_pool(self, nbytes: int, quantized: bool):
        """Record the slot pool's resident bytes and flavor."""
        self.kv_pool_bytes = int(nbytes)
        self.kv_pool_quantized = bool(quantized)

    def summary(self, wall_seconds: Optional[float] = None) -> dict:
        pct = self.percentiles()
        out = {
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "timeouts": self.timeouts,
            "tokens_out": self.tokens_out,
            "ticks": self.ticks,
            "kv_handoffs_in": self.handoffs_in,
            "kv_handoffs_out": self.handoffs_out,
            "ttft_ms_p50": pct["ttft_ms"]["p50"],
            "ttft_ms_p95": pct["ttft_ms"]["p95"],
            "ttft_ms_p99": pct["ttft_ms"]["p99"],
            "token_ms_p50": pct["tpot_ms"]["p50"],
            "token_ms_p95": pct["tpot_ms"]["p95"],
            "token_ms_p99": pct["tpot_ms"]["p99"],
            "e2e_ms_p50": pct["e2e_ms"]["p50"],
            "e2e_ms_p95": pct["e2e_ms"]["p95"],
            "kv_pool_gib": round(self.kv_pool_bytes / 2 ** 30, 6),
            "kv_pool_int8": self.kv_pool_quantized,
        }
        if any(v is not None for v in self._slo_targets().values()):
            out["slo"] = self.slo_status()
        if len(self.tenant_stats) > 1 or (
                self.tenant_stats and "default" not in self.tenant_stats):
            out["tenants"] = self.tenant_status()
        if self.spec_ticks:
            out["speculative"] = {
                "ticks": self.spec_ticks,
                "k": self.spec_k,
                "acceptance_rate": round(
                    self.spec_accepted / max(1, self.spec_proposed), 4),
                "acceptance_ema": round(self.spec_acceptance_ema or 0.0, 4),
                "tokens_per_tick_ema": round(
                    self.spec_tokens_per_tick_ema or 0.0, 3),
                "draft_ms_last": round(self.spec_draft_ms, 3),
                "verify_ms_last": round(self.spec_verify_ms, 3),
            }
        if wall_seconds:
            out["tokens_per_s"] = round(self.tokens_out / wall_seconds, 2)
        return out
