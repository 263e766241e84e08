"""Serving config: the JSON surface of the JAX package's
``serving/config.py``, with the same keys, defaults, aliases and
``ConfigError``s.

``ServingConfig`` and its ``slo``, ``chunked_prefill``, ``tenants``,
``speculative``, ``prefix_cache`` and ``kv_quant`` blocks run here, as do the three
roles (``unified``, ``prefill``, ``decode``). The blocks of the JAX
package that this port does not serve yet are parsed (the ones defined in
this module with the JAX package's own ``ConfigError``s) and accepted
while they are absent or disabled; enabled, they raise
``NotImplementedError`` naming their ROADMAP.md row (``UNPORTED``):
``monitor`` and its sinks, ``telemetry``, ``statusz``,
``flight_recorder``, ``speculative.acceptance_floor`` above 0 (it fires
the flight recorder), ``resilience.handle_signals``, ``fleet``,
``loadgen``, ``soak`` and ``cost`` (A12), ``compile_plane`` and
``perf_plane`` (A13).
"""

import dataclasses
from typing import Any, Optional

from ..runtime.config_utils import ConfigError, DeepSpeedConfigModel


@dataclasses.dataclass
class SLOConfig(DeepSpeedConfigModel):
    """The serving ``"slo"`` block (serving/metrics.py): sliding-window
    latency percentiles + error-budget burn rate against configurable
    targets. ``window`` bounds the percentile sources (a long-running
    replica's memory stays O(window)); each ``*_ms`` target is optional —
    unset targets track percentiles but contribute no violations. The
    burn-rate gauge is observed violation rate ÷ allowed violation rate
    (``1 - target``): 1.0 = burning budget exactly as fast as allowed,
    >1 = out of SLO."""
    #: sliding-window size (latency samples kept per metric)
    window: int = 1024
    #: time-to-first-token target, ms (p{quantile} must stay under it)
    ttft_ms: Optional[float] = None
    #: time-per-output-token target, ms (fused decode-step wall time)
    tpot_ms: Optional[float] = None
    #: end-to-end request latency target, ms
    e2e_ms: Optional[float] = None
    #: fraction of samples that must meet each target (0.99 = "p99 SLO")
    target: float = 0.99
    #: age samples out of the sliding windows by WALL CLOCK after this
    #: many seconds (None = count-bounded only). Without it an idle
    #: replica's windows are frozen history — its last burn rate reads
    #: as live forever, which starves it in the router's burn-penalty
    #: score and can pin autoscaling; with it, ``last_burn_rate`` and
    #: the dstpu_tenant_* burn gauges relax to 0 once the replica has
    #: been idle for ``decay_s``.
    decay_s: Optional[float] = None

    def validate(self):
        if self.window < 8:
            raise ConfigError("slo.window must be >= 8")
        if not (0.0 < self.target < 1.0):
            raise ConfigError("slo.target must be in (0, 1)")
        for name in ("ttft_ms", "tpot_ms", "e2e_ms"):
            val = getattr(self, name)
            if val is not None and val <= 0:
                raise ConfigError(f"slo.{name} must be > 0 when set")
        if self.decay_s is not None and self.decay_s <= 0:
            raise ConfigError("slo.decay_s must be > 0 when set")


@dataclasses.dataclass
class PrefixCacheConfig(DeepSpeedConfigModel):
    """The ``"prefix_cache"`` block: radix reuse of retired slots' KV
    lanes (``serving/fleet/prefix_cache.py``)."""
    enabled: bool = False
    #: shortest shared prefix worth a lane copy (shorter prompts also
    #: never donate their slot)
    min_prefix_len: int = 8
    #: cap on slots parked in the cache (0 = bounded only by the pool;
    #: eviction is on-demand LRU either way)
    max_cached_slots: int = 0

    def validate(self):
        if self.min_prefix_len < 1:
            raise ConfigError("prefix_cache.min_prefix_len must be >= 1")
        if self.max_cached_slots < 0:
            raise ConfigError("prefix_cache.max_cached_slots must be >= 0")


@dataclasses.dataclass
class KVQuantConfig(DeepSpeedConfigModel):
    """The ``"kv_quant"`` block: store the slot pool int8 with per-column
    f32 scales (``inference/kv_quant.py``): about half a bf16 pool's bytes
    at head dim 128."""
    enabled: bool = False

    def validate(self):
        pass


@dataclasses.dataclass
class ChunkedPrefillConfig(DeepSpeedConfigModel):
    """The ``"chunked_prefill"`` block (serving/scheduler.py): Sarathi-
    style stall-free batching on static shapes. A prompt whose unshared
    suffix exceeds ``chunk_tokens`` is admitted as a PREFILLING request
    that holds its slot across ticks and writes one ``chunk_tokens``-sized
    K/V chunk per tick (``InferenceEngine.slot_chunk_prefill`` — logits
    head DCE'd, one compiled program per pow2 chunk flavor), with the
    final sub-chunk going through the existing pow2 suffix-prefill
    machinery so the first token still derives from ``(seed, position)``
    only. Each tick's work is bounded by ``decode + at most chunk_tokens
    of prefill``, so in-flight TPOT stays bounded regardless of prompt
    length."""
    enabled: bool = False
    #: prefill tokens per tick. Must be a power of two: the chunk program
    #: compiles exactly once per (chunk_tokens, pool) flavor, like the
    #: suffix-prefill buckets it is built from.
    chunk_tokens: int = 256

    def validate(self):
        if self.chunk_tokens < 16 or \
                (self.chunk_tokens & (self.chunk_tokens - 1)):
            raise ConfigError(
                f"chunked_prefill.chunk_tokens must be a power of two "
                f">= 16 (one compiled chunk flavor), got {self.chunk_tokens}")


@dataclasses.dataclass
class TenantConfig(DeepSpeedConfigModel):
    """The ``"tenants"`` block: the tenant dimension of the serving
    plane. With ``enabled``, the scheduler's single FIFO becomes
    per-tenant queues served by deficit round-robin — admission work
    (prefill tokens) is granted proportionally to ``weights`` among
    backlogged tenants, so one whale tenant cannot head-of-line-block
    everyone else's TTFT. The FleetRouter additionally enforces
    per-tenant token-bucket rate limits (``rate_tokens_per_s`` /
    ``burst_tokens``, cost = prompt + requested new tokens), rejecting
    over-limit submits with a 429-style ``RateLimited`` QueueFull.
    Per-tenant SLO windows (serving/metrics.py) export
    ``dstpu_tenant_*`` gauges either way."""
    enabled: bool = False
    #: DRR weight for tenants not named in ``weights``
    default_weight: float = 1.0
    #: {tenant: weight} — a weight-2 tenant gets twice the admission
    #: tokens of a weight-1 tenant while both are backlogged
    weights: Any = None
    #: DRR quantum per weight unit, in prompt tokens per round
    quantum_tokens: int = 256
    #: router token-bucket refill for tenants not named in ``rates``
    #: (tokens/second; 0 = unlimited)
    rate_tokens_per_s: float = 0.0
    #: {tenant: tokens_per_s} per-tenant refill overrides
    rates: Any = None
    #: token-bucket capacity (burst allowance), tokens
    burst_tokens: int = 8192
    #: cap on distinct tenants with live metric windows; excess tenants
    #: fold into ``__other__`` (gauge cardinality stays bounded even if
    #: a client sprays random tenant strings)
    max_tracked: int = 64

    def validate(self):
        if self.default_weight <= 0:
            raise ConfigError("tenants.default_weight must be > 0")
        if self.weights is None:
            self.weights = {}
        if not isinstance(self.weights, dict) or not all(
                isinstance(k, str) and isinstance(v, (int, float)) and v > 0
                for k, v in self.weights.items()):
            raise ConfigError(
                "tenants.weights must be a {tenant: positive weight} dict")
        if self.quantum_tokens < 1:
            raise ConfigError("tenants.quantum_tokens must be >= 1")
        if self.rate_tokens_per_s < 0:
            raise ConfigError("tenants.rate_tokens_per_s must be >= 0")
        if self.rates is None:
            self.rates = {}
        if not isinstance(self.rates, dict) or not all(
                isinstance(k, str) and isinstance(v, (int, float)) and v >= 0
                for k, v in self.rates.items()):
            raise ConfigError(
                "tenants.rates must be a {tenant: tokens_per_s} dict")
        if self.burst_tokens < 1:
            raise ConfigError("tenants.burst_tokens must be >= 1")
        if self.max_tracked < 1:
            raise ConfigError("tenants.max_tracked must be >= 1")

    def weight_of(self, tenant: str) -> float:
        return float(self.weights.get(tenant, self.default_weight))

    def rate_of(self, tenant: str) -> float:
        return float(self.rates.get(tenant, self.rate_tokens_per_s))


@dataclasses.dataclass
class DraftConfig(DeepSpeedConfigModel):
    """The draft flavor inside the ``"speculative"`` block: ``self`` (the
    target's first ``layers`` blocks) or ``model`` (a small config of the
    same family)."""
    mode: str = "self"      # self | model
    #: self mode: early-exit depth (0 = target n_layer // 2)
    layers: int = 0
    #: model mode: draft dims (0 = inherit the target's)
    n_layer: int = 2
    n_embd: int = 0
    n_head: int = 0
    #: model mode: draft param init seed (until a trained draft loads)
    seed: int = 0

    def validate(self):
        if self.mode not in ("self", "model"):
            raise ConfigError(
                f"speculative.draft.mode must be self|model, "
                f"got {self.mode!r}")
        if self.layers < 0:
            raise ConfigError("speculative.draft.layers must be >= 0")
        if self.mode == "model" and self.n_layer < 1:
            raise ConfigError("speculative.draft.n_layer must be >= 1")


@dataclasses.dataclass
class SpeculativeConfig(DeepSpeedConfigModel):
    """The ``"speculative"`` block: draft-model speculative decoding over
    the slot pool, ``k`` draft tokens a slot a tick
    (``inference/speculative.py``). An ``acceptance_floor`` above 0 fires
    the flight recorder, which raises naming ROADMAP.md row A12."""
    enabled: bool = False
    #: draft tokens proposed per slot per tick. Must be a power of two:
    #: each (num_slots, max_model_len, k) flavor of the verify program
    #: compiles exactly once, and pow2 buckets keep the flavor count
    #: logarithmic if an adaptive policy later varies k.
    k: int = 4
    #: draft flavor (dict -> DraftConfig)
    draft: Any = None
    #: acceptance-rate EMA floor: crossing BELOW it (edge-triggered,
    #: after warmup_ticks) fires the flight recorder with kind
    #: "acceptance_drop" — speculation that stopped paying for itself
    #: is an incident worth a postmortem bundle. 0 disables.
    acceptance_floor: float = 0.0
    #: speculative ticks before the floor rule arms
    warmup_ticks: int = 8
    #: EMA smoothing for the acceptance gauge
    ema_alpha: float = 0.2

    def validate(self):
        if self.k < 1 or (self.k & (self.k - 1)):
            raise ConfigError(
                f"speculative.k must be a power of two >= 1 (one compiled "
                f"verify flavor per k bucket), got {self.k}")
        if not (0.0 <= self.acceptance_floor <= 1.0):
            raise ConfigError(
                "speculative.acceptance_floor must be in [0, 1]")
        if self.warmup_ticks < 1:
            raise ConfigError("speculative.warmup_ticks must be >= 1")
        if not (0.0 < self.ema_alpha <= 1.0):
            raise ConfigError("speculative.ema_alpha must be in (0, 1]")
        if isinstance(self.draft, dict):
            self.draft = DraftConfig.from_dict(self.draft)
        elif self.draft is None:
            self.draft = DraftConfig()
        self.draft.validate()


@dataclasses.dataclass
class LoadgenConfig(DeepSpeedConfigModel):
    """The ``"loadgen"`` block: the seeded trace-driven load generator of
    the JAX package's soak harness. Parsed; set to anything but its
    defaults, it raises naming ROADMAP.md row A12."""
    seed: int = 0
    #: trace horizon, seconds of simulated wall-clock
    duration_s: float = 10.0
    #: mean request rate at the diurnal midline, requests/second
    base_rate: float = 6.0
    #: peak-to-midline rate swing, fraction of base_rate in [0, 1)
    diurnal_amplitude: float = 0.5
    #: sinusoid period; 0 = one full cycle over duration_s
    diurnal_period_s: float = 0.0
    #: distinct steady tenants (t0..tN-1); abuse spikes add "abuser"
    tenants: int = 4
    #: zipf skew over the steady tenants (larger = whalier)
    zipf_alpha: float = 1.2
    #: lognormal prompt-length median (tokens) / sigma / hard cap
    prompt_len_median: int = 12
    prompt_len_sigma: float = 0.6
    prompt_len_max: int = 96
    #: lognormal output-length median (tokens) / sigma / hard cap
    output_len_median: int = 8
    output_len_sigma: float = 0.5
    output_len_max: int = 32
    #: fraction of requests whose prompt starts with a cohort prefix
    shared_prefix_fraction: float = 0.35
    #: distinct shared-prefix cohorts and the prefix length (tokens)
    prefix_cohorts: int = 3
    prefix_len: int = 16
    #: abuse spikes: count, requests per spike, tenant they bill to
    abuse_spikes: int = 1
    abuse_spike_requests: int = 12
    abuse_tenant: str = "abuser"
    #: token-id vocabulary for generated prompts
    vocab: int = 256

    def validate(self):
        if self.duration_s <= 0:
            raise ConfigError("loadgen.duration_s must be > 0")
        if self.base_rate <= 0:
            raise ConfigError("loadgen.base_rate must be > 0")
        if not (0.0 <= self.diurnal_amplitude < 1.0):
            raise ConfigError(
                "loadgen.diurnal_amplitude must be in [0, 1)")
        if self.tenants < 1:
            raise ConfigError("loadgen.tenants must be >= 1")
        if self.zipf_alpha <= 1.0:
            raise ConfigError(
                "loadgen.zipf_alpha must be > 1 (zipf divergence)")
        for name in ("prompt_len_median", "prompt_len_max",
                     "output_len_median", "output_len_max",
                     "prefix_len", "vocab"):
            if getattr(self, name) < 1:
                raise ConfigError(f"loadgen.{name} must be >= 1")
        if not (0.0 <= self.shared_prefix_fraction <= 1.0):
            raise ConfigError(
                "loadgen.shared_prefix_fraction must be in [0, 1]")
        if self.prefix_cohorts < 1:
            raise ConfigError("loadgen.prefix_cohorts must be >= 1")
        if self.abuse_spikes < 0 or self.abuse_spike_requests < 1:
            raise ConfigError(
                "loadgen.abuse_spikes must be >= 0 and "
                "abuse_spike_requests >= 1")
        if "/" in self.abuse_tenant:
            raise ConfigError("loadgen.abuse_tenant must not contain '/'")


@dataclasses.dataclass
class SoakConfig(DeepSpeedConfigModel):
    """The ``"soak"`` block: chaos schedule and invariant tolerances of the
    JAX package's soak harness. Parsed; set to anything but its
    defaults, it raises naming ROADMAP.md row A12."""
    #: when to kill a live replica, as a fraction of duration_s (<0 off)
    kill_replica_at_frac: float = 0.3
    #: when the autoscale-forcing burst starts, fraction of duration_s
    #: (<0 off), how long it lasts (fraction), and the rate multiplier
    #: stacked on top of the diurnal rate while it runs
    burst_at_frac: float = 0.55
    burst_duration_frac: float = 0.15
    burst_rate_mult: float = 4.0
    #: when to start a rolling weight update mid-soak, as a fraction of
    #: duration_s (<0 off) — a same-version rollout through the full
    #: plane (canary replay in shadow, SLO-gated shift, one-at-a-time
    #: replace), so the bitwise verify has a ground truth
    rollout_at_frac: float = -1.0
    #: invariant (c): SLO burn must fall back to <= 1.0 within this many
    #: seconds after each chaos event
    recovery_window_s: float = 20.0
    #: invariant (a): |sum(goodput buckets) - wall| tolerance, relative
    goodput_tolerance: float = 0.02
    #: invariant (e): critical-path decomposition slack (relative to e2e
    #: mean, with an absolute floor in ms)
    critical_path_tolerance: float = 0.05
    critical_path_floor_ms: float = 0.5
    #: burn/live-replica sampling cadence during the drive loop
    sample_interval_s: float = 0.1
    #: wall-clock grace after the trace drains: lets scale-down + drains
    #: complete and burn samples decay before the scorecard folds
    tail_s: float = 2.0

    def validate(self):
        if self.burst_rate_mult < 1.0:
            raise ConfigError("soak.burst_rate_mult must be >= 1")
        if self.burst_duration_frac < 0 or self.burst_duration_frac > 1:
            raise ConfigError(
                "soak.burst_duration_frac must be in [0, 1]")
        if self.recovery_window_s <= 0:
            raise ConfigError("soak.recovery_window_s must be > 0")
        if not (0.0 < self.goodput_tolerance < 1.0):
            raise ConfigError("soak.goodput_tolerance must be in (0, 1)")
        if not (0.0 < self.critical_path_tolerance < 1.0):
            raise ConfigError(
                "soak.critical_path_tolerance must be in (0, 1)")
        if self.sample_interval_s <= 0:
            raise ConfigError("soak.sample_interval_s must be > 0")
        if self.tail_s < 0:
            raise ConfigError("soak.tail_s must be >= 0")


@dataclasses.dataclass
class CostConfig(DeepSpeedConfigModel):
    """The ``"cost"`` block: per-request / per-tenant chip-second and HBM
    attribution. Parsed; enabled, it raises naming ROADMAP.md row A12."""
    enabled: bool = False
    #: EMA smoothing for the observed per-token prefill cost — the rate
    #: radix-cache savings are priced at
    ema_alpha: float = 0.25
    #: accrue HBM-byte-seconds per occupied slot (footprint x residency)
    hbm: bool = True
    #: cap on distinct tenants with live cost totals; excess folds into
    #: ``__other__`` (same bounded-cardinality rule as tenants.max_tracked)
    max_tracked: int = 64

    def validate(self):
        if not (0.0 < self.ema_alpha <= 1.0):
            raise ConfigError("cost.ema_alpha must be in (0, 1]")
        if self.max_tracked < 1:
            raise ConfigError("cost.max_tracked must be >= 1")


@dataclasses.dataclass
class ServingConfig(DeepSpeedConfigModel):
    """Continuous-batching serving knobs (deepspeed_tpu_torch/serving/)."""

    # slot pool: one KV cache [L, num_slots, H_kv, max_model_len, hd],
    # allocated once; admission never reshapes it
    num_slots: int = 8
    max_model_len: int = 512          # KV-cache columns per slot

    # admission control / robustness
    max_queue: int = 64               # bounded queue; submit() past this
                                      # raises QueueFull (backpressure)
    max_prefills_per_tick: int = 1    # prefill admission budget per tick
                                      # (bounds tail latency of decode ticks)
    default_max_new_tokens: int = 64
    request_timeout_s: Optional[float] = None  # default per-request deadline

    # metrics fan-out through a monitor (row A12)
    monitor: bool = False
    monitor_interval: int = 16        # ticks between gauge emissions
    tensorboard: Any = None
    wandb: Any = None
    csv_monitor: Any = None
    prometheus: Any = None

    # planes of the JAX package not ported yet (see UNPORTED)
    telemetry: Any = None
    statusz: Any = None

    # slo (dict -> SLOConfig): sliding-window TTFT/TPOT/e2e percentiles
    # and error-budget burn rate (serving/metrics.py)
    slo: Any = None

    flight_recorder: Any = None
    compile_plane: Any = None
    perf_plane: Any = None
    resilience: Any = None

    # replica role: "unified" serves end to end; "prefill" hands each
    # prefilled lane to a handoff sink, "decode" takes lanes through
    # ServingEngine.submit_handoff (serving/fleet/handoff.py)
    role: str = "unified"

    prefix_cache: Any = None          # dict -> PrefixCacheConfig
    kv_quant: Any = None              # dict -> KVQuantConfig
    speculative: Any = None           # dict -> SpeculativeConfig

    # chunked_prefill (dict -> ChunkedPrefillConfig): interleave long
    # prompts' prefill with decode ticks in chunk_tokens-sized chunks
    chunked_prefill: Any = None

    # tenants (dict -> TenantConfig): per-tenant weighted-fair admission
    # (DRR) and per-tenant SLO windows
    tenants: Any = None

    fleet: Any = None
    loadgen: Any = None               # dict -> LoadgenConfig
    soak: Any = None                  # dict -> SoakConfig
    cost: Any = None                  # dict -> CostConfig

    ALIASES = {"max_seq_len": "max_model_len"}

    def validate(self):
        if self.num_slots < 1:
            raise ConfigError(f"num_slots must be >= 1, got {self.num_slots}")
        if self.max_model_len < 2:
            raise ConfigError(
                f"max_model_len must be >= 2, got {self.max_model_len}")
        if self.max_queue < 1:
            raise ConfigError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_prefills_per_tick < 1:
            raise ConfigError("max_prefills_per_tick must be >= 1")
        if self.default_max_new_tokens < 1:
            raise ConfigError("default_max_new_tokens must be >= 1")
        if self.request_timeout_s is not None and self.request_timeout_s <= 0:
            raise ConfigError("request_timeout_s must be > 0 when set")
        if self.monitor_interval < 1:
            raise ConfigError("monitor_interval must be >= 1")
        if isinstance(self.slo, dict):
            self.slo = SLOConfig.from_dict(self.slo)
        elif self.slo is None:
            self.slo = SLOConfig()
        if self.role not in ("unified", "prefill", "decode"):
            raise ConfigError(
                f"serving.role must be unified|prefill|decode, "
                f"got {self.role!r}")
        for name, cls in (("prefix_cache", PrefixCacheConfig),
                          ("kv_quant", KVQuantConfig),
                          ("speculative", SpeculativeConfig),
                          ("chunked_prefill", ChunkedPrefillConfig),
                          ("tenants", TenantConfig),
                          ("loadgen", LoadgenConfig),
                          ("soak", SoakConfig),
                          ("cost", CostConfig)):
            val = getattr(self, name)
            if isinstance(val, dict):
                val = cls.from_dict(val)
            elif val is None:
                val = cls()
            val.validate()
            setattr(self, name, val)
        if self.chunked_prefill.enabled and \
                self.chunked_prefill.chunk_tokens > self.max_model_len:
            raise ConfigError(
                f"chunked_prefill.chunk_tokens="
                f"{self.chunked_prefill.chunk_tokens} exceeds "
                f"max_model_len={self.max_model_len}")
        for key, (row, what, asks) in UNPORTED.items():
            if asks(self, key):
                raise NotImplementedError(
                    f"serving config '{key}' asks for {what}, which is not "
                    f"ported yet: ROADMAP.md row {row}")


def _enabled(cfg, key):
    val = getattr(cfg, key)
    if isinstance(val, dict):
        return bool(val.get("enabled"))
    return bool(getattr(val, "enabled", False))


def _truthy(cfg, key):
    return bool(getattr(cfg, key))


def _set(cfg, key):
    """A block without an ``enabled`` key (the soak harness's): set to
    anything but its defaults, it asks for that harness."""
    val = getattr(cfg, key)
    return val != type(val)()


def _handles_signals(cfg, key):
    return bool((getattr(cfg, key) or {}).get("handle_signals"))


def _acceptance_floor(cfg, key):
    val = getattr(cfg, key)
    return bool(getattr(val, "enabled", False) and
                getattr(val, "acceptance_floor", 0.0) > 0)


# key -> (ROADMAP.md row, what the port cannot serve yet, "asks for it")
UNPORTED = {
    "speculative": ("A12", "the acceptance-drop trigger of the flight "
                    "recorder (acceptance_floor > 0)", _acceptance_floor),
    "monitor": ("A12", "the serving monitor", _truthy),
    "tensorboard": ("A12", "the tensorboard monitor", _enabled),
    "wandb": ("A12", "the wandb monitor", _enabled),
    "csv_monitor": ("A12", "the csv monitor", _enabled),
    "prometheus": ("A12", "the prometheus monitor", _enabled),
    "telemetry": ("A12", "telemetry export", _enabled),
    "statusz": ("A12", "the statusz server", _enabled),
    "flight_recorder": ("A12", "the flight recorder", _enabled),
    "resilience": ("A12", "preemption handling", _handles_signals),
    "fleet": ("A12", "the fleet router", _enabled),
    "loadgen": ("A12", "the load generator", _set),
    "soak": ("A12", "the soak harness", _set),
    "cost": ("A12", "the cost plane", _enabled),
    "compile_plane": ("A13", "the compile plane", _enabled),
    "perf_plane": ("A13", "the perf plane", _enabled),
}
