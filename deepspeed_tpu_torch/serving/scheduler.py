"""Continuous-batching request scheduler, as the JAX package's
``serving/scheduler.py`` runs it.

Orca-style iteration-level scheduling on static shapes: each ``tick()``
(1) expires requests past their deadline, (2) inserts received KV lanes
(the ``decode`` role), (3) admits queued requests into free slots:
prefill writes the prompt's K/V into the slot's cache lane and samples the
request's FIRST token (so TTFT is one prefill away from admission), or,
with ``chunked_prefill``, a long prompt lands one chunk a tick while
everyone else decodes, and (4) runs ONE fused decode step over all slots,
advancing every in-flight request by one token, or, with ``speculative``,
one draft proposal and one batched verify that advance each by its
accepted prefix plus one. Requests retire on EOS or max-tokens and their
slot returns to the free list, or, with ``prefix_cache``, is parked as a
reusable prefix that later admissions copy (lane copy + suffix prefill);
no shape ever changes. Admission order is FIFO, or deficit round-robin
over tenants with the ``tenants`` block. A ``prefill``-role scheduler
hands each prefilled lane to ``handoff_sink`` as a ``KVHandoff`` instead
of decoding it.

The cost ledger and the distributed trace contexts of the JAX package are
ROADMAP.md row A12.
"""

import dataclasses
import enum
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

import numpy as np

from ..telemetry.trace import get_tracer
from ..utils.logging import logger
from .fleet.handoff import KVHandoff
from .fleet.prefix_cache import RadixPrefixCache, reuse_plan
from .kv_slots import SlotPool
from .metrics import ServingMetrics


class QueueFull(RuntimeError):
    """Backpressure: the bounded admission queue is at capacity."""


class RateLimited(QueueFull):
    """429-style backpressure: the tenant's token bucket is empty. A
    subclass of QueueFull so existing retry-with-backoff handling works
    unchanged; ``tenant`` and ``retry_after_s`` let an API front-end
    surface a proper 429 with a Retry-After header. The router that
    raises it (its token buckets) is row A12."""

    def __init__(self, message: str, tenant: str = "default",
                 retry_after_s: float = 1.0):
        super().__init__(message)
        self.tenant = tenant
        self.retry_after_s = retry_after_s
        self.status = 429


class RequestState(enum.Enum):
    QUEUED = "queued"
    #: chunked prefill in progress: the request holds its slot across
    #: ticks while its prompt's K/V lands chunk by chunk, interleaved
    #: with everyone else's decode ticks (chunked_prefill config block)
    PREFILLING = "prefilling"
    RUNNING = "running"
    FINISHED = "finished"
    TIMEOUT = "timeout"
    CANCELLED = "cancelled"


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling controls: greedy (temperature 0, the
    default), or temperature / top-k / top-p sampling with a
    deterministic per-request ``seed`` — every sampled token's PRNG key
    derives only from ``(seed, cache position)``, so the stream is
    reproducible across ticks, slots and replays
    Beam search stays on the offline generate() path."""
    temperature: float = 0.0
    top_k: int = 0                         # 0 = off
    top_p: float = 1.0                     # 1.0 = off
    seed: int = 0
    max_new_tokens: Optional[int] = None   # None -> config default
    eos_token_id: Optional[int] = None
    timeout_s: Optional[float] = None      # None -> config default
    #: the tenant this request bills to: selects its DRR admission
    #: queue and weight and the tenant SLO window its latencies land in
    tenant: str = "default"

    def validate(self):
        if not self.tenant or not isinstance(self.tenant, str) or \
                "/" in self.tenant:
            raise ValueError(
                f"tenant must be a non-empty string without '/' "
                f"(it names a gauge tag segment), got {self.tenant!r}")
        if self.max_new_tokens is not None and self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.temperature <= 0.0 and (self.top_k or self.top_p < 1.0):
            raise ValueError(
                "top_k/top_p require temperature > 0 (temperature<=0 means "
                "greedy decoding, which would silently ignore them)")
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError("timeout_s must be > 0")


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray                     # int32 [T]
    sampling: SamplingParams
    max_new_tokens: int
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    on_token: Optional[Callable] = None    # on_token(request, token:int)
    submit_time: float = 0.0
    deadline: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    #: chunked prefill progress: prompt tokens whose K/V is already in
    #: the slot lane (columns [0, prefill_pos) valid)
    prefill_pos: int = 0
    #: True once the request left the queue (its request/decode span is
    #: open) — a PREFILLING request that expires must close that span,
    #: not the queued one
    prefill_started: bool = False
    #: tick number of this request's last chunk (a freshly admitted
    #: chunked request must not take a second chunk in the same tick)
    prefill_tick: int = -1

    @property
    def tenant(self) -> str:
        return getattr(self.sampling, "tenant", None) or "default"

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.TIMEOUT,
                              RequestState.CANCELLED)

    @property
    def output_ids(self) -> np.ndarray:
        """prompt + generated tokens."""
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])


class TenantQueues:
    """Admission queue with a tenant dimension: per-tenant FIFOs served
    by deficit round-robin (DRR), replacing the single global FIFO.

    With tenancy disabled (or only one tenant ever enqueues) this is
    byte-for-byte the old deque: strict arrival order. With
    ``tenants.enabled``, each tenant gets its own FIFO and ``popleft()``
    runs DRR over the backlogged tenants — every round-robin visit adds
    ``weight(tenant) * quantum_tokens`` to the tenant's deficit, and a
    request pops only when the deficit covers its admission cost (its
    prompt length, the prefill work the scheduler is about to buy it).
    Over any backlogged interval, admitted prefill tokens converge to the
    weight ratios — a whale tenant spraying 4k-token prompts drains its
    deficit 256x faster than a 16-token tenant and cannot starve it.

    The deque surface the rest of the stack uses is preserved:
    ``append`` / ``popleft`` / ``remove`` / ``len`` / ``iter`` / truth.
    """

    def __init__(self, config=None):
        self._cfg = config
        self.enabled = bool(getattr(config, "enabled", False))
        # tenant -> FIFO; insertion order gives a stable RR order
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._deficit: Dict[str, float] = {}
        self._rr: List[str] = []           # backlogged tenants, RR order
        self._rr_idx = 0
        self._fifo: "deque[Request]" = deque()   # disabled-mode fast path
        self._n = 0

    @staticmethod
    def _tenant_of(req) -> str:
        return getattr(req, "tenant", None) or "default"

    @staticmethod
    def _cost(req) -> float:
        """Admission cost in DRR currency: the prefill work this request
        buys on pop (its prompt tokens)."""
        return float(max(1, int(req.prompt.size)))

    def _quantum(self, tenant: str) -> float:
        cfg = self._cfg
        return cfg.weight_of(tenant) * float(cfg.quantum_tokens)

    # -------------------------------------------------------------- deque API
    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def __iter__(self):
        if not self.enabled:
            return iter(self._fifo)
        import itertools
        return itertools.chain.from_iterable(self._queues.values())

    def append(self, req):
        self._n += 1
        if not self.enabled:
            self._fifo.append(req)
            return
        tenant = self._tenant_of(req)
        dq = self._queues.get(tenant)
        if dq is None:
            dq = self._queues[tenant] = deque()
        if not dq and tenant not in self._rr:
            self._rr.append(tenant)
        dq.append(req)

    def remove(self, req):
        """deque semantics: raises ValueError when absent."""
        if not self.enabled:
            self._fifo.remove(req)       # ValueError propagates
            self._n -= 1
            return
        dq = self._queues.get(self._tenant_of(req))
        if dq is None:
            raise ValueError("request not in queue")
        dq.remove(req)                   # ValueError propagates
        self._n -= 1
        if not dq:
            self._retire(self._tenant_of(req))

    def _retire(self, tenant: str):
        """Tenant went idle: drop it from the rotation and zero its
        deficit (classic DRR — an idle tenant must not bank credit)."""
        self._deficit[tenant] = 0.0
        if tenant in self._rr:
            idx = self._rr.index(tenant)
            self._rr.remove(tenant)
            if idx < self._rr_idx:
                self._rr_idx -= 1
            if self._rr:
                self._rr_idx %= len(self._rr)
            else:
                self._rr_idx = 0

    def popleft(self):
        """DRR pop: stays on the current tenant while its deficit covers
        the head request, else tops the next tenant up by its quantum and
        moves on. Terminates: every full rotation adds a positive quantum
        to each backlogged tenant and costs are bounded by the prompt
        length cap."""
        if self._n == 0:
            raise IndexError("pop from an empty TenantQueues")
        self._n -= 1
        if not self.enabled:
            return self._fifo.popleft()
        while True:
            tenant = self._rr[self._rr_idx % len(self._rr)]
            dq = self._queues[tenant]
            cost = self._cost(dq[0])
            if self._deficit.get(tenant, 0.0) >= cost:
                req = dq.popleft()
                self._deficit[tenant] -= cost
                if not dq:
                    self._retire(tenant)
                return req
            self._deficit[tenant] = \
                self._deficit.get(tenant, 0.0) + self._quantum(tenant)
            self._rr_idx = (self._rr_idx + 1) % len(self._rr)


class ContinuousBatchingScheduler:
    """Admission queue + slot pool + fused decode tick.

    Three roles share this loop (``config.role``): ``unified`` admits
    prompts, prefills and decodes; ``prefill`` admits prompts, prefills,
    then extracts the slot lane into a ``KVHandoff`` for ``handoff_sink``
    instead of binding it for decode; ``decode`` also drains a handoff
    queue, inserting received lanes into its own pool, and runs the token
    loop. With ``prefix_cache.enabled``, finished slots are donated to a
    radix cache and admissions that share a cached prefix take the lane
    copy + suffix prefill path. With ``speculative.enabled``, a draft
    pool beside the target pool is kept in lockstep with it.
    """

    def __init__(self, engine, config, metrics: ServingMetrics = None,
                 clock: Callable[[], float] = time.monotonic,
                 handoff_sink: Optional[Callable] = None,
                 agree: Optional[Callable[[float], float]] = None):
        self.engine = engine
        self.config = config
        self.clock = clock
        #: a clock reading on this rank -> the one every rank of a tensor-
        #: parallel group uses (``serving/engine.py``'s ``tp_agree``);
        #: None on one rank
        self.agree = agree
        #: whether any deadline is in play: until then no decision reads
        #: the clock, and ``_decision_time`` makes no collective. Set from
        #: the config and the requests, the same on every rank.
        self._deadlines = config.request_timeout_s is not None
        self.role = getattr(config, "role", "unified")
        self.handoff_sink = handoff_sink
        self.metrics = metrics or ServingMetrics()
        quantize = bool(getattr(getattr(config, "kv_quant", None),
                                "enabled", False))
        self.pool = SlotPool(engine, config.num_slots, config.max_model_len,
                             quantize=quantize)
        self.metrics.kv_pool(self.pool.nbytes(), quantize)
        #: admission queue: per-tenant FIFOs + deficit round-robin when
        #: the tenants block is on, a plain FIFO otherwise (deque API)
        self.queue = TenantQueues(getattr(config, "tenants", None))
        #: (KVHandoff, Request) pairs awaiting a slot (decode role)
        self.handoff_queue: "deque" = deque()
        #: chunked prefill in flight: slot -> PREFILLING Request, in
        #: admission order; each holds its slot across ticks while its
        #: prompt lands chunk by chunk (chunked_prefill config block)
        self.prefilling: "OrderedDict[int, Request]" = OrderedDict()
        self.chunked = getattr(config, "chunked_prefill", None)
        if not getattr(self.chunked, "enabled", False):
            self.chunked = None
        #: ticks between unconditional queue deadline sweeps: queued
        #: expiry is otherwise lazy (at pop time) plus event-driven (the
        #: tracked minimum queued deadline), so deep queues do not make
        #: every tick linear in queued requests
        self.expire_sweep_interval = 64
        self._queue_min_deadline: Optional[float] = None
        self.prefix_cache = None
        pc_cfg = getattr(config, "prefix_cache", None)
        if getattr(pc_cfg, "enabled", False):
            self.prefix_cache = RadixPrefixCache(pc_cfg)
        # speculative decoding: a draft model and a draft slot pool in
        # lockstep with the target pool. A prefill role never decodes, so
        # it has no draft.
        self.spec = None
        self.draft = None
        self.draft_cache = None
        spec_cfg = getattr(config, "speculative", None)
        if getattr(spec_cfg, "enabled", False) and self.role != "prefill":
            self.spec = spec_cfg
            self.draft = engine.init_draft(spec_cfg.draft)
            self.draft_cache = engine.init_draft_pool(
                self.draft, config.num_slots, config.max_model_len)
        self._tick_no = 0
        # per-request async spans (queue -> prefill -> decode -> complete)
        self.tracer = get_tracer()

    # -------------------------------------------------------------- enqueue
    def enqueue(self, request: Request):
        """Admission control: bounded queue -> QueueFull backpressure."""
        if len(self.queue) >= self.config.max_queue:
            self.metrics.record_reject()
            raise QueueFull(
                f"serving queue at capacity ({self.config.max_queue}); "
                f"retry with backoff")
        timeout = (request.sampling.timeout_s
                   if request.sampling.timeout_s is not None
                   else self.config.request_timeout_s)
        self._deadlines |= timeout is not None
        now = self._decision_time()
        request.submit_time = now
        if timeout is not None:
            request.deadline = now + timeout
            if self._queue_min_deadline is None or \
                    request.deadline < self._queue_min_deadline:
                self._queue_min_deadline = request.deadline
        self.queue.append(request)
        tr = self.tracer
        tr.async_begin("request", request.request_id, cat="serving",
                       args={"prompt_len": int(request.prompt.size),
                             "max_new_tokens": request.max_new_tokens,
                             "tenant": request.tenant})
        tr.async_begin("request/queued", request.request_id, cat="serving")
        self.metrics.record_submit(tenant=request.tenant,
                                   prompt_tokens=int(request.prompt.size))

    def enqueue_handoff(self, handoff, request: Request):
        """Admission control for the handoff path (decode role): the
        handoff queue shares ``max_queue`` with the prompt queue."""
        if len(self.handoff_queue) + len(self.queue) >= self.config.max_queue:
            self.metrics.record_reject()
            raise QueueFull(
                f"serving handoff queue at capacity "
                f"({self.config.max_queue}); retry with backoff")
        self._deadlines |= request.deadline is not None
        self.handoff_queue.append((handoff, request))
        self.tracer.async_begin(
            "request/handoff_queued", request.request_id, cat="serving",
            args={"kv_len": int(handoff.kv_len), "source": handoff.source})

    # ----------------------------------------------------------------- tick
    def tick(self) -> int:
        """One scheduling iteration. Returns the number of requests still
        in flight (queued + handed off + prefilling + running) after the
        tick. With chunked prefill, each tick's prefill work is budgeted
        in units of ``chunk_tokens``: admissions (DRR-ordered) spend the
        budget, then the OLDEST in-flight chunked prefill always advances
        one chunk, and every active slot still decodes every tick."""
        self._tick_no += 1
        now = self._decision_time()
        self._expire(now)
        self._admit_handoffs(now)
        budget = (self.chunked.chunk_tokens if self.chunked is not None
                  else None)
        budget = self._admit(now, budget)
        self._advance_prefills(now, budget)
        self._decode()
        self.metrics.record_tick(len(self.queue), self.pool.utilization)
        if self.prefix_cache is not None:
            self.metrics.record_prefix_cache(self.prefix_cache)
        return (len(self.queue) + len(self.handoff_queue) +
                len(self.pool.active_slots) + len(self.prefilling))

    def _decision_time(self) -> float:
        """The clock where a decision reads it: a deadline set at submit,
        and each tick's expiries and admissions. Under tensor parallelism
        every rank runs this scheduler on the same requests, so the
        reading is the one ``agree`` gives every rank; with no deadline in
        play no decision depends on it, and no collective is made. The
        other reads (timings, TTFT) stay this rank's own."""
        now = self.clock()
        if self.agree is not None and self._deadlines:
            now = self.agree(now)
        return now

    def _alloc_slot(self) -> Optional[int]:
        """Claim a slot, evicting the LRU prefix-cache entry when the
        free list is dry: live admissions outrank cached prefixes (pinned
        entries excepted)."""
        slot = self.pool.alloc()
        if slot is None and self.prefix_cache is not None:
            victim = self.prefix_cache.evict_lru()
            if victim is not None:
                self.pool.free(victim)
                slot = self.pool.alloc()
        return slot

    def _release_slot(self, slot: int, req: Request, donate_seq=None):
        """Retire a slot: donate its lane to the prefix cache when it
        holds reusable K/V (a FINISHED request's whole sequence, or the
        prompt a prefill-role scheduler just handed off), else return it
        to the free list."""
        cache = self.prefix_cache
        kv_len = int(self.pool.lengths[slot])
        if cache is not None and donate_seq is None and \
                req.state is RequestState.FINISHED:
            donate_seq = req.output_ids[:kv_len]
        if cache is not None and donate_seq is not None:
            accepted, evicted = cache.donate(slot, donate_seq, kv_len)
            if evicted is not None:
                self.pool.free(evicted)
            if accepted:
                self.pool.retire_to_cache(slot)
                return
        self.pool.free(slot)

    def _expire(self, now: float):
        """Deadline enforcement. Running and prefilling requests are
        checked every tick (O(slots)). Queued requests expire lazily at
        pop time (``_pop_live``) plus in a sweep that runs when the
        tracked minimum queued deadline has passed (so timeouts still
        fire the tick they expire) or every ``expire_sweep_interval``
        ticks."""
        for slot in self.pool.active_slots:
            req = self.pool.requests[slot]
            if req.deadline is not None and now > req.deadline:
                self._finish(req, RequestState.TIMEOUT, now)
                self.pool.free(slot)
        for slot in list(self.prefilling):
            req = self.prefilling[slot]
            if req.deadline is not None and now > req.deadline:
                del self.prefilling[slot]
                self._finish(req, RequestState.TIMEOUT, now)
                self.pool.free(slot)
        due = (self._queue_min_deadline is not None and
               now > self._queue_min_deadline)
        if not due and self._tick_no % self.expire_sweep_interval:
            return
        expired = []
        new_min = None
        for req in self.queue:
            if req.deadline is None:
                continue
            if now > req.deadline:
                expired.append(req)
            elif new_min is None or req.deadline < new_min:
                new_min = req.deadline
        self._queue_min_deadline = new_min
        for req in expired:
            try:
                self.queue.remove(req)
            except ValueError:
                continue
            self._finish(req, RequestState.TIMEOUT, now)

    def _pop_live(self, now: float) -> Optional[Request]:
        """Pop the next admissible request, finishing expired ones on
        the way out (the lazy half of deadline enforcement)."""
        while self.queue:
            req = self.queue.popleft()
            if req.deadline is not None and now > req.deadline:
                self._finish(req, RequestState.TIMEOUT, now)
                continue
            return req
        return None

    def _admit_handoffs(self, now: float):
        """Insert received KV lanes into free slots (decode role): no
        prefill, the prompt's K/V arrives computed; only the lane insert
        and the bind happen here."""
        tr = self.tracer
        while self.handoff_queue:
            slot = self._alloc_slot()
            if slot is None:
                return
            handoff, req = self.handoff_queue.popleft()
            tr.async_end("request/handoff_queued", req.request_id,
                         cat="serving")
            tr.async_begin("request/decode", req.request_id, cat="serving",
                           args={"slot": slot, "handoff": True})
            with tr.span("kv_handoff_in", cat="serving",
                         args={"request_id": req.request_id, "slot": slot,
                               "kv_len": int(handoff.kv_len),
                               "bytes": handoff.nbytes(),
                               "source": handoff.source}):
                self.pool.cache = self.engine.slot_insert_lane(
                    self.pool.cache, slot, handoff.lane)
            req.state = RequestState.RUNNING
            self.metrics.record_handoff_in()
            if self._should_finish(req, handoff.first_token):
                self._finish(req, RequestState.FINISHED, self.clock())
                self._release_slot(slot, req)
            else:
                self.pool.bind(slot, req, int(handoff.kv_len),
                               int(handoff.first_token), req.sampling)
                if self.spec is not None:
                    # the draft lane has no handoff: rebuild it from the
                    # prompt (the draft is the cheap side of the trade)
                    self.draft_cache = self.engine.draft_prefill(
                        self.draft, self.draft_cache, slot, req.prompt)

    def _advance_prefills(self, now: float, budget):
        """Advance in-flight chunked prefills, oldest first. The HEAD
        request always moves one chunk (small admissions cannot starve a
        prefill already holding a slot); younger ones follow only while
        budget remains. A request whose final chunk lands completes its
        admission (first token sampled, slot bound for decode) in the same
        tick."""
        if not self.prefilling:
            return
        first = True
        for slot in list(self.prefilling):
            if not first and (budget is None or budget <= 0):
                break
            req = self.prefilling.get(slot)
            if req is None or req.prefill_tick == self._tick_no:
                continue                 # admitted (and chunked) this tick
            spent = self._chunk_step(slot, req)
            if budget is not None:
                budget -= spent
            first = False

    def _admit(self, now: float, budget=None):
        """Move queued requests into free slots, at most
        ``max_prefills_per_tick`` a tick (admission bursts cannot starve
        in-flight decode). A prompt whose unshared suffix fits
        ``chunk_tokens`` (or any prompt, when chunking is off) prefills
        inline; a longer one starts a chunked admission. With a prefix
        cache, a prompt sharing a cached prefix admits by lane copy +
        suffix (or chunk) prefill: only the unshared tail runs through
        the stack. ``budget`` (chunked mode) is the tick's prefill-token
        budget; each admission spends its prefill work against it, and
        the rest is returned for the in-flight chunks."""
        admitted = 0
        tr = self.tracer
        while self.queue and admitted < self.config.max_prefills_per_tick \
                and (budget is None or budget > 0):
            slot = self._alloc_slot()
            if slot is None:
                return budget
            req = self._pop_live(now)
            if req is None:
                self.pool.free(slot)
                return budget
            tr.async_end("request/queued", req.request_id, cat="serving")
            tr.async_begin("request/decode", req.request_id, cat="serving",
                           args={"slot": slot})
            req.prefill_started = True
            hit = None
            if self.prefix_cache is not None:
                hit = self.prefix_cache.lookup(req.prompt)
            # chunk only the unshared suffix: a prefix hit may take a long
            # prompt below the chunking threshold
            suffix = int(req.prompt.size) - \
                (hit.matched if hit is not None else 0)
            if self.chunked is not None and \
                    suffix > self.chunked.chunk_tokens:
                spent = self._start_chunked(slot, req, hit)
            else:
                first = self._prefill_into(slot, req, hit)
                spent = suffix
                self._complete_admission(slot, req, first)
            if budget is not None:
                budget -= spent
            admitted += 1
        return budget

    def _prefix_span(self, slot: int, req: Request, hit, reused: int,
                     **args):
        """The span of a prefix hit's lane copy (and suffix prefill)."""
        return self.tracer.span(
            "prefix_reuse", cat="serving",
            args={"request_id": req.request_id, "slot": slot,
                  "src_slot": hit.slot, "matched": hit.matched,
                  "reused": reused, "suffix": int(req.prompt.size) - reused,
                  **args})

    def _start_chunked(self, slot: int, req: Request, hit) -> int:
        """Begin a chunked admission: the prefix hit's lane copy, if any,
        then the first chunk. The request holds its slot in PREFILLING
        state; ``_advance_prefills`` moves it forward on later ticks.
        Returns the prefill tokens spent now."""
        t = int(req.prompt.size)
        start = 0
        if hit is not None:
            start = min(int(hit.matched), t - 1)
            try:
                if start > 0:
                    with self._prefix_span(slot, req, hit, start,
                                           chunked=True):
                        self.pool.cache = self.engine.slot_copy_lane(
                            self.pool.cache, hit.slot, slot)
            finally:
                self.prefix_cache.release(hit, used_tokens=max(0, start))
        req.state = RequestState.PREFILLING
        req.prefill_pos = start
        # dummy decode writes for an unbound slot land at column
        # lengths[slot]: keep it at the end of the valid prefix, where the
        # next chunk starts and overwrites them
        self.pool.lengths[slot] = start
        self.prefilling[slot] = req
        return self._chunk_step(slot, req)

    def _chunk_step(self, slot: int, req: Request) -> int:
        """One chunk of prefill for a PREFILLING request. Intermediate
        chunks write exactly ``chunk_tokens`` of K/V through the
        sampling-free ``slot_chunk_prefill``; the FINAL chunk runs the pow2
        suffix prefill, sampling the first token at the same ``(seed,
        position)`` key a monolithic prefill uses, and completes the
        admission. Returns the prefill tokens spent."""
        tr = self.tracer
        t = int(req.prompt.size)
        p = int(req.prefill_pos)
        rem = t - p
        req.prefill_tick = self._tick_no
        if rem > self.chunked.chunk_tokens:
            chunk = self.chunked.chunk_tokens
            with tr.span("prefill_chunk", cat="serving",
                         args={"request_id": req.request_id, "slot": slot,
                               "start": p, "chunk": chunk,
                               "remaining": rem - chunk}):
                self.pool.cache = self.engine.slot_chunk_prefill(
                    self.pool.cache, slot, req.prompt[p:p + chunk], p)
            req.prefill_pos = p + chunk
            self.pool.lengths[slot] = req.prefill_pos
            return chunk
        # final chunk: suffix prefill from an offset whose pow2 bucket fits
        # max_len (the offset may back off below prefill_pos; those columns
        # recompute to the same K/V)
        offset, _sfx = reuse_plan(t, p, self.config.max_model_len)
        sp = req.sampling
        with tr.span("prefill", cat="serving",
                     args={"request_id": req.request_id, "slot": slot,
                           "prompt_len": t, "chunked": True,
                           "suffix": t - offset}):
            self.pool.cache, first = self.engine.slot_suffix_prefill(
                self.pool.cache, slot, req.prompt[offset:], offset,
                temperature=sp.temperature, top_k=sp.top_k,
                top_p=sp.top_p, seed=sp.seed)
        self.prefilling.pop(slot, None)
        self._complete_admission(slot, req, int(first))
        return rem

    def _complete_admission(self, slot: int, req: Request, first: int):
        """Shared tail of every prefill path (inline or final chunk):
        record TTFT, deliver the first token, then bind for decode, hand
        off or finish."""
        t_first = self.clock()
        req.state = RequestState.RUNNING
        req.first_token_time = t_first
        self.metrics.record_ttft(t_first - req.submit_time,
                                 tenant=req.tenant)
        self._deliver(req, first)
        if self._should_finish(req, first):
            self._finish(req, RequestState.FINISHED, t_first)
            self._release_slot(slot, req)
        elif self.role == "prefill":
            self._hand_off(slot, req, first)
        else:
            self.pool.bind(slot, req, len(req.prompt), first, req.sampling)
            if self.spec is not None:
                self.draft_cache = self.engine.draft_prefill(
                    self.draft, self.draft_cache, slot, req.prompt)

    def _prefill_into(self, slot: int, req: Request, hit) -> int:
        """Full prefill of the request's prompt into ``slot``, or, when
        the radix cache holds a shared prefix (``hit``, looked up by the
        caller so the chunk-or-inline decision sees the unshared suffix),
        the lane copy + suffix prefill. Returns the first sampled
        token."""
        sp = req.sampling
        if hit is not None:
            offset, _suffix = reuse_plan(int(req.prompt.size), hit.matched,
                                         self.config.max_model_len)
            try:
                if offset > 0:
                    with self._prefix_span(slot, req, hit, offset):
                        self.pool.cache = self.engine.slot_copy_lane(
                            self.pool.cache, hit.slot, slot)
                        self.pool.cache, first = \
                            self.engine.slot_suffix_prefill(
                                self.pool.cache, slot, req.prompt[offset:],
                                offset, temperature=sp.temperature,
                                top_k=sp.top_k, top_p=sp.top_p, seed=sp.seed)
                    return first
            finally:
                self.prefix_cache.release(hit, used_tokens=offset)
        with self.tracer.span("prefill", cat="serving",
                              args={"request_id": req.request_id,
                                    "slot": slot,
                                    "prompt_len": int(req.prompt.size)}):
            # slot_prefill returns the first token as a Python int, read
            # from the device, so the span's duration is honest
            self.pool.cache, first = self.engine.slot_prefill(
                self.pool.cache, slot, req.prompt,
                temperature=sp.temperature, top_k=sp.top_k,
                top_p=sp.top_p, seed=sp.seed)
        return first

    def _hand_off(self, slot: int, req: Request, first: int):
        """Prefill role: package the prefilled lane as a ``KVHandoff``,
        release the slot (donating the prompt's lane to the prefix cache)
        and deliver to the sink. The Request travels with the handoff:
        the decode side keeps appending to the same token list and
        callbacks."""
        tr = self.tracer
        with tr.span("kv_handoff_out", cat="serving",
                     args={"request_id": req.request_id, "slot": slot,
                           "kv_len": int(req.prompt.size)}):
            lane = self.engine.slot_extract_lane(self.pool.cache, slot)
        # the producing version rides the frame: the decode side refuses
        # a lane from other weights
        version = int(getattr(self.engine, "weights_version", 0) or 0)
        handoff = KVHandoff(
            prompt=req.prompt, first_token=int(first),
            kv_len=int(req.prompt.size), lane=lane,
            temperature=req.sampling.temperature,
            top_k=req.sampling.top_k, top_p=req.sampling.top_p,
            seed=req.sampling.seed,
            max_new_tokens=req.max_new_tokens,
            eos_token_id=req.sampling.eos_token_id,
            request_id=req.request_id,
            tenant=req.tenant,
            weights_version=version)
        tr.async_end("request/decode", req.request_id, cat="serving",
                     args={"handed_off": True})
        # the lane was only written, never bound: park it in the prefix
        # cache (or free it) before the sink possibly re-enters us
        self.pool.lengths[slot] = int(req.prompt.size)
        self._release_slot(slot, req, donate_seq=req.prompt)
        self.metrics.record_handoff_out()
        if self.handoff_sink is None:
            raise RuntimeError(
                "role=prefill needs a handoff_sink: a prefill engine has "
                "nowhere to send its completed KV state")
        self.handoff_sink(handoff, req)

    def _decode(self):
        """One fused decode step over all slots; retire on EOS/max."""
        active = self.pool.active_slots
        if not active:
            return
        if self.spec is not None:
            return self._decode_speculative(active)
        toks, positions, temps, top_ks, top_ps, seeds = \
            self.pool.decode_arrays()
        t0 = self.clock()
        with self.tracer.span("decode_step", cat="serving",
                              args={"n_active": len(active),
                                    "tick": self._tick_no}):
            # slot_decode_step returns host ndarrays (already synced)
            self.pool.cache, nxt = self.engine.slot_decode_step(
                self.pool.cache, toks, positions, temps,
                top_ks=top_ks, top_ps=top_ps, seeds=seeds)
        self.metrics.record_decode_step(self.clock() - t0, len(active))
        now = self.clock()
        for slot in active:
            req = self.pool.requests[slot]
            tok = int(nxt[slot])
            self.pool.lengths[slot] += 1      # fed token's K/V is in cache
            self.pool.pending[slot] = tok
            finishing = self._should_finish(req, tok, pending=1)
            self._deliver(req, tok)
            self.metrics.record_tenant_tokens(req.tenant)
            if finishing:
                self._finish(req, RequestState.FINISHED, now)
                self._release_slot(slot, req)

    def _decode_speculative(self, active):
        """One speculative tick: the draft proposes k tokens a slot, the
        target verifies all of them in one batched forward with the
        rollback inside the step, and every active slot advances by its
        accepted prefix + 1 (between 1 and k + 1 tokens), the emitted
        stream bitwise the non-speculative path's."""
        toks, positions, temps, top_ks, top_ps, seeds = \
            self.pool.decode_arrays()
        k = self.spec.k
        tr = self.tracer
        t0 = self.clock()
        with tr.span("draft_propose", cat="serving",
                     args={"n_active": len(active), "k": k,
                           "tick": self._tick_no}):
            self.draft_cache, draft_toks = self.engine.slot_draft_propose(
                self.draft, self.draft_cache, toks, positions, temps,
                top_ks, top_ps, seeds, k)
        t_draft = self.clock()
        with tr.span("spec_verify", cat="serving",
                     args={"n_active": len(active), "k": k,
                           "tick": self._tick_no}):
            self.pool.cache, out_toks, accepts = self.engine.slot_verify_step(
                self.pool.cache, toks, draft_toks, positions, temps,
                top_ks, top_ps, seeds)
        t_verify = self.clock()
        now = self.clock()
        accepted_total = emitted_total = 0
        for slot in active:
            req = self.pool.requests[slot]
            a = int(accepts[slot])
            p = int(self.pool.lengths[slot])
            delivered = 0
            finishing = False
            for j in range(a + 1):
                tok = int(out_toks[slot, j])
                finishing = self._should_finish(req, tok, pending=1)
                self._deliver(req, tok)
                delivered += 1
                if finishing:
                    break
            # columns p..p+a hold the fed token + accepted drafts; the
            # final emitted token (the bonus or the first mismatch) is the
            # new pending one, its K/V not in the cache yet
            self.pool.lengths[slot] = p + 1 + min(delivered, a)
            accepted_total += a
            emitted_total += delivered
            self.metrics.record_tenant_tokens(req.tenant, delivered)
            if finishing:
                self._finish(req, RequestState.FINISHED, now)
                self._release_slot(slot, req)
            else:
                self.pool.pending[slot] = int(out_toks[slot, a])
        self.metrics.record_spec_tick(
            step_s=now - t0, n_active=len(active), k=k,
            accepted=accepted_total, emitted=emitted_total,
            draft_s=t_draft - t0, verify_s=t_verify - t_draft,
            ema_alpha=self.spec.ema_alpha)

    # -------------------------------------------------------------- helpers
    def _deliver(self, req: Request, tok: int):
        req.tokens.append(tok)
        if req.on_token is not None:
            try:
                req.on_token(req, tok)
            except Exception as e:   # user callback must not kill the loop
                logger.warning(
                    f"serving: on_token callback failed for request "
                    f"{req.request_id}: {e}")

    def _should_finish(self, req: Request, tok: int,
                       pending: int = 0) -> bool:
        """``pending`` counts tokens sampled but not yet appended (the
        decode loop asks before delivering)."""
        eos = req.sampling.eos_token_id
        return (len(req.tokens) + pending >= req.max_new_tokens or
                (eos is not None and tok == eos))

    def _finish(self, req: Request, state: RequestState, now: float):
        req.state = state
        req.finish_time = now
        tr = self.tracer
        if req.first_token_time is None and not req.prefill_started:
            # expired straight out of the queue: close the queued phase
            tr.async_end("request/queued", req.request_id, cat="serving")
        else:
            # admitted (incl. a PREFILLING request that expired before
            # its first token): the decode-phase span is the open one
            tr.async_end("request/decode", req.request_id, cat="serving")
        tr.async_end(
            "request", req.request_id, cat="serving",
            args={"state": state.value, "tokens": len(req.tokens),
                  "ttft_ms": None if req.first_token_time is None else
                  round((req.first_token_time - req.submit_time) * 1e3, 3)})
        if state is RequestState.TIMEOUT:
            self.metrics.record_timeout(tenant=req.tenant)
        elif state is RequestState.FINISHED:
            self.metrics.record_completion(req)
