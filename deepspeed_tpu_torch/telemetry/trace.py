"""Structured tracer: the core of the JAX package's ``telemetry/trace.py``.

One per-process ``Tracer`` owns a fixed-capacity ring buffer of ``Span``
records plus a gauge space. Spans are host-side wall-time intervals opened
with ``tracer.span("decode_step")`` context managers; under CUDA's
asynchronous launches a raw host interval measures only the launches, so
spans carry explicit sync points: ``sp.sync_on(outputs)`` waits for the
device (``torch.cuda.synchronize``) before the end timestamp is taken.

Three record kinds:

- complete spans (``ph='X'``): nested host intervals (prefill, decode
  ticks). Nesting is depth-tracked per thread.
- async spans (``ph='b'``/``'e'``): intervals that outlive any one stack
  frame, e.g. a serving request's queue -> prefill -> decode -> complete
  lifecycle, keyed by request id.
- counters: latest-value gauges (queue depth, TTFT percentiles, SLO burn
  rate) in one process-wide space, each optionally owned by a producer
  that retracts its gauges when it closes.

Disabled is the default and costs nothing: ``span()`` returns a shared
no-op singleton, no ``Span`` object is allocated. Counters stay live
regardless. The exporters (Chrome trace, snapshot, Prometheus) and the
JAX package's ``RecompileWatchdog`` (XLA recompiles) are not ported yet:
ROADMAP.md rows A12 and A13.
"""

import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Tracer", "get_tracer", "configure_tracer"]

_NOSYNC = object()


def _default_sync():
    """Full-device sync for ``sync=True`` spans: waits for the work queued
    on the current CUDA device (nothing to wait for on the CPU)."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _on_cuda(value) -> bool:
    """Whether ``value`` (a tensor, or a dict / list / tuple of them) holds
    a CUDA tensor."""
    if isinstance(value, dict):
        return any(_on_cuda(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(_on_cuda(v) for v in value)
    return getattr(getattr(value, "device", None), "type", None) == "cuda"


def _block_on(value):
    """Wait until ``value``'s CUDA work is done: a device sync when it
    holds a CUDA tensor (a stream does not say which kernels made it)."""
    if _on_cuda(value):
        import torch
        torch.cuda.synchronize()


class Span:
    """One record in the ring buffer. Also its own context manager, so an
    enabled ``tracer.span(...)`` costs exactly one allocation."""

    __slots__ = ("name", "cat", "ts_us", "dur_us", "depth", "tid", "args",
                 "ph", "aid", "_tracer", "_sync", "_sync_val")

    def __init__(self, tracer, name: str, cat: str = "host",
                 args: Optional[Dict[str, Any]] = None, sync: bool = False,
                 ph: str = "X", aid: Optional[int] = None):
        self.name = name
        self.cat = cat
        self.args = args
        self.ph = ph
        self.aid = aid
        self.ts_us = 0.0
        self.dur_us = 0.0
        self.depth = 0
        self.tid = threading.get_ident()
        self._tracer = tracer
        self._sync = sync
        self._sync_val = _NOSYNC

    def sync_on(self, value):
        """Block on ``value`` (tensors, or a dict / list / tuple of them) at
        span exit before the end timestamp: the honest duration under
        CUDA's asynchronous launches."""
        self._sync_val = value
        return value

    def set(self, **kwargs):
        """Attach/update args on an open span."""
        if self.args is None:
            self.args = {}
        self.args.update(kwargs)

    def __enter__(self):
        tr = self._tracer
        self.depth = tr._enter_depth()
        self.ts_us = time.perf_counter_ns() / 1e3
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._sync_val is not _NOSYNC:
            _block_on(self._sync_val)
        elif self._sync:
            _default_sync()
        self.dur_us = time.perf_counter_ns() / 1e3 - self.ts_us
        tr = self._tracer
        tr._exit_depth()
        # drop the references a retained record doesn't need
        self._sync_val = _NOSYNC
        tr._record(self)
        return False


class _NullSpan:
    """Shared no-op span: what a disabled tracer hands out. A singleton —
    the zero-cost-when-disabled contract is that no object is allocated."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def sync_on(self, value):
        return value

    def set(self, **kwargs):
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Per-process structured tracer: span ring buffer + counter pipeline."""

    def __init__(self, buffer_size: int = 65536, enabled: bool = False):
        self.enabled = enabled
        self.sync_spans = True
        self._cap = max(16, int(buffer_size))
        self._ring: List[Optional[Span]] = [None] * self._cap
        self._head = 0          # next write index
        self._total = 0         # spans ever recorded (wraparound detector)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._counters: Dict[str, Any] = {}
        # gauge ownership: tag -> id(owner) for gauges registered by a
        # closable producer (an engine); release_counters(owner) drops the
        # tags that owner still holds, so /metrics and prometheus_dump
        # never report stale values from a closed engine. Last writer
        # wins: a tag two co-resident engines both write belongs to
        # whichever wrote it last, and only that one's close() removes it.
        self._counter_owners: Dict[str, int] = {}

    # ------------------------------------------------------------ configure
    def configure(self, config=None, **overrides):
        """Apply a ``TelemetryConfig`` (or kwargs): enabled, buffer_size,
        sync_spans. Resizing the buffer clears recorded spans."""
        kv = {}
        if config is not None:
            for k in ("enabled", "buffer_size", "sync_spans"):
                if hasattr(config, k):
                    kv[k] = getattr(config, k)
        kv.update(overrides)
        if "buffer_size" in kv and int(kv["buffer_size"]) != self._cap:
            with self._lock:
                self._cap = max(16, int(kv["buffer_size"]))
                self._ring = [None] * self._cap
                self._head = 0
                self._total = 0
        if "sync_spans" in kv:
            self.sync_spans = bool(kv["sync_spans"])
        if "enabled" in kv:
            self.enabled = bool(kv["enabled"])
        return self

    # ----------------------------------------------------------------- spans
    def span(self, name: str, cat: str = "host",
             args: Optional[Dict[str, Any]] = None, sync: bool = False):
        """Open a nested wall-time span. ``sync=True`` fences the device at
        exit; for accuracy prefer ``sp.sync_on(step_outputs)``. Disabled
        tracer: returns the shared no-op singleton (no allocation)."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, cat=cat, args=args,
                    sync=sync and self.sync_spans)

    def async_begin(self, name: str, aid: int, cat: str = "async",
                    args: Optional[Dict[str, Any]] = None):
        """Open one side of an async span (an interval that outlives the
        current stack frame, e.g. a serving request). Pair with
        ``async_end`` on the same (name, aid)."""
        if not self.enabled:
            return
        sp = Span(self, name, cat=cat, args=args, ph="b", aid=aid)
        sp.ts_us = time.perf_counter_ns() / 1e3
        self._record(sp)

    def async_end(self, name: str, aid: int, cat: str = "async",
                  args: Optional[Dict[str, Any]] = None):
        if not self.enabled:
            return
        sp = Span(self, name, cat=cat, args=args, ph="e", aid=aid)
        sp.ts_us = time.perf_counter_ns() / 1e3
        self._record(sp)

    def _record(self, span: Span):
        with self._lock:
            self._ring[self._head] = span
            self._head = (self._head + 1) % self._cap
            self._total += 1

    def _enter_depth(self) -> int:
        d = getattr(self._tls, "depth", 0)
        self._tls.depth = d + 1
        return d

    def _exit_depth(self):
        self._tls.depth = max(0, getattr(self._tls, "depth", 1) - 1)

    def spans(self) -> List[Span]:
        """Recorded spans, oldest first (at most ``buffer_size``; older
        records are overwritten — the ring never grows)."""
        with self._lock:
            if self._total < self._cap:
                return [s for s in self._ring[:self._head] if s is not None]
            return ([s for s in self._ring[self._head:] if s is not None] +
                    [s for s in self._ring[:self._head] if s is not None])

    @property
    def dropped(self) -> int:
        """Spans overwritten by ring wraparound."""
        return max(0, self._total - self._cap)

    # -------------------------------------------------------------- counters
    def set_counter(self, tag: str, value: float, step: Optional[int] = None,
                    owner: Any = None):
        """Gauge update. ``owner`` ties the tag to a closable producer for
        ``release_counters``."""
        self._counters[tag] = (value, step)
        if owner is not None:
            self._counter_owners[tag] = id(owner)
        # owner=None leaves any existing ownership standing: the
        # TelemetryMonitor sink mirrors an engine's own events back into
        # the gauge space ownerless, and that mirror must not strip the
        # engine's right to retract its tags at close()

    def release_counters(self, owner: Any):
        """Drop every gauge still owned by ``owner`` (engine close path):
        a closed engine's queue depth / step time must not linger in
        prometheus_dump() or /metrics as if it were live."""
        oid = id(owner)
        for tag in [t for t, o in self._counter_owners.items() if o == oid]:
            del self._counter_owners[tag]
            self._counters.pop(tag, None)

    def counters(self) -> Dict[str, Any]:
        return dict(self._counters)

    def counter_value(self, tag: str, default=None):
        """Latest value of one gauge (without its step), or ``default`` —
        the cheap single-tag read for per-tick consumers that must not pay
        for a full counters() copy."""
        val = self._counters.get(tag)
        return val[0] if val is not None else default

    # ------------------------------------------------------------------ misc
    def clear(self):
        with self._lock:
            self._ring = [None] * self._cap
            self._head = 0
            self._total = 0
        self._counters.clear()
        self._counter_owners.clear()


_TRACER: Optional[Tracer] = None


def get_tracer() -> Tracer:
    """The process-global tracer (created disabled; ``DSTPU_TELEMETRY=1``
    enables it from the environment for script-level use)."""
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer(
            enabled=os.environ.get("DSTPU_TELEMETRY", "") in ("1", "true"))
    return _TRACER


def configure_tracer(config=None, **overrides) -> Tracer:
    """Configure the global tracer from a ``TelemetryConfig`` block
    (the serving config's ``telemetry`` block) or kwargs; returns it."""
    return get_tracer().configure(config, **overrides)
