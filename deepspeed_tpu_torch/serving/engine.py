"""ServingEngine: continuous-batching facade over InferenceEngine.

The online counterpart of ``InferenceEngine.generate()`` (one static
batch): requests arrive one at a time via ``submit(prompt, ...) ->
request_id``, are admitted into a fixed pool of decode slots, and every
``step()`` advances ALL in-flight requests by one token through one fused
decode step. Per-token streaming runs through ``on_token`` callbacks; the
bounded admission queue with backpressure, per-request deadlines and
graceful drain are as in the JAX package.

    engine = deepspeed_tpu_torch.init_inference(model, config={...})
    srv = ServingEngine(engine, {"num_slots": 8, "max_model_len": 512})
    rid = srv.submit(prompt_ids, SamplingParams(max_new_tokens=32),
                     on_token=lambda req, tok: print(tok))
    srv.run_until_idle()
    print(srv.result(rid).output_ids)
    srv.shutdown()

The engine's device (``cuda`` unless ``init_inference`` was given
``device="cpu"``) holds the slot pool. Speculative decoding
(``speculative``), the radix prefix cache (``prefix_cache``) and the
disaggregated roles run here: a ``role: "prefill"`` engine hands each
prefilled lane to ``handoff_sink(handoff, request)`` as a ``KVHandoff``
(``serving/fleet/handoff.py``), and a ``role: "decode"`` engine takes it
through ``submit_handoff``. The fleet router, the statusz server, the
flight recorder, the compile/perf planes and preemption handling are not
ported yet; their config blocks raise naming ROADMAP.md rows A12 and A13
(``serving/config.py``).
"""

import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..telemetry.trace import get_tracer
from ..utils.logging import log_dist
from .config import ServingConfig
from .metrics import ServingMetrics
from .scheduler import (ContinuousBatchingScheduler, QueueFull, Request,
                        RequestState, SamplingParams)

__all__ = ["ServingEngine", "SamplingParams", "QueueFull", "RequestState"]


def tp_agree(engine):
    """``agree(value)``: tp rank 0's ``value``, broadcast over ``engine``'s
    ``model`` group in a tensor on the engine's device (an NCCL group
    carries CUDA tensors only). Every rank runs the scheduler and makes
    every call in one order, so the ranks call it in lock-step."""
    from ..comm import comm

    def agree(value):
        box = torch.tensor([float(value)], dtype=torch.float64,
                           device=engine.device)
        return float(comm.broadcast(box, 0, engine.tp.group).item())
    return agree


class ServingEngine:
    """Slot-based continuous-batching serving on top of InferenceEngine."""

    def __init__(self, engine, config: Union[ServingConfig, dict, None] = None,
                 clock: Callable[[], float] = time.monotonic,
                 handoff_sink: Optional[Callable] = None):
        if config is None:
            config = ServingConfig()
        elif isinstance(config, dict):
            config = ServingConfig.from_dict(config)
        else:
            config.validate()
        self.config = config
        self.engine = engine
        n_pos = getattr(getattr(engine.module, "config", None),
                        "n_positions", None)
        if n_pos is not None and config.max_model_len > n_pos:
            raise ValueError(
                f"serving.max_model_len={config.max_model_len} exceeds the "
                f"model's context length n_positions={n_pos}")
        self.tracer = get_tracer()
        self.metrics = ServingMetrics(monitor_interval=config.monitor_interval,
                                      tracer=self.tracer, slo=config.slo,
                                      tenants=config.tenants)
        self.scheduler = ContinuousBatchingScheduler(
            engine, config, metrics=self.metrics, clock=clock,
            handoff_sink=handoff_sink,
            # every tp rank runs this scheduler on the same requests, so
            # every decision read off the clock must read one value
            agree=tp_agree(engine) if engine.tp.active else None)
        self._requests: Dict[int, Request] = {}
        self._next_id = 0
        self._draining = False
        log_dist(
            f"ServingEngine initialized: slots={config.num_slots} "
            f"max_model_len={config.max_model_len} "
            f"max_queue={config.max_queue} device={engine.device}",
            ranks=[0])

    # ---------------------------------------------------------------- submit
    def submit(self, prompt, sampling: Optional[SamplingParams] = None,
               on_token: Optional[Callable] = None) -> int:
        """Enqueue one request. Returns its request_id; raises ``QueueFull``
        when the bounded admission queue is at capacity (backpressure: the
        caller sheds load or retries with backoff) and ``RuntimeError``
        after shutdown/drain began."""
        if self._draining:
            raise RuntimeError("ServingEngine is draining; submit rejected")
        sampling = sampling or SamplingParams()
        sampling.validate()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        max_new = (sampling.max_new_tokens
                   if sampling.max_new_tokens is not None
                   else self.config.default_max_new_tokens)
        if prompt.size + max_new > self.config.max_model_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) "
                f"exceeds serving.max_model_len={self.config.max_model_len}")
        req = Request(request_id=self._next_id, prompt=prompt,
                      sampling=sampling, max_new_tokens=max_new,
                      on_token=on_token)
        self.scheduler.enqueue(req)     # raises QueueFull on backpressure
        self._requests[req.request_id] = req
        self._next_id += 1
        return req.request_id

    def submit_handoff(self, handoff, request: Optional[Request] = None,
                       on_token: Optional[Callable] = None) -> int:
        """Enqueue a completed prefill (``serving/fleet/handoff.py``) for
        decode in this engine's pool. With ``request`` (the prefill
        engine's, handed to its sink) the same Request continues: its
        token list, callbacks and deadline travel with the KV state.
        Without one, a Request is rebuilt from the handoff's metadata and
        the already-sampled first token is delivered here. A lane from
        another ``weights_version`` is refused and the request prefilled
        locally. Raises ``QueueFull`` past ``max_queue`` (shared with the
        prompt queue) and ``ValueError`` when the handoff cannot fit this
        pool."""
        if self._draining:
            raise RuntimeError("ServingEngine is draining; handoff rejected")
        kv_len = int(handoff.kv_len)
        max_new = (request.max_new_tokens if request is not None
                   else int(handoff.max_new_tokens))
        if kv_len + max_new > self.config.max_model_len:
            raise ValueError(
                f"handoff kv_len ({kv_len}) + max_new_tokens ({max_new}) "
                f"exceeds serving.max_model_len={self.config.max_model_len}")
        # K/V computed by one model and read by another is silent
        # corruption: refuse it. None is a producer without versions.
        incoming = getattr(handoff, "weights_version", None)
        refused = incoming is not None and \
            int(incoming) != self.weights_version
        deliver_first = request is None
        if request is None:
            sampling = SamplingParams(
                temperature=handoff.temperature, top_k=int(handoff.top_k),
                top_p=float(handoff.top_p), seed=int(handoff.seed),
                max_new_tokens=handoff.max_new_tokens,
                eos_token_id=handoff.eos_token_id,
                tenant=handoff.tenant or "default")
            request = Request(
                request_id=self._next_id,
                prompt=np.asarray(handoff.prompt, np.int32).reshape(-1),
                sampling=sampling, max_new_tokens=handoff.max_new_tokens,
                on_token=on_token)
            self._next_id += 1
            request.submit_time = self.scheduler.clock()
            if not refused:
                self.tracer.async_begin(
                    "request", request.request_id, cat="serving",
                    args={"prompt_len": int(request.prompt.size),
                          "max_new_tokens": request.max_new_tokens,
                          "handoff": True})
        if refused:
            return self._refuse_handoff(handoff, request,
                                        fresh=deliver_first)
        self.scheduler.enqueue_handoff(handoff, request)   # QueueFull here
        self._requests[request.request_id] = request
        if deliver_first:
            request.state = RequestState.RUNNING
            request.first_token_time = self.scheduler.clock()
            self.scheduler._deliver(request, int(handoff.first_token))
        return request.request_id

    def _refuse_handoff(self, handoff, request: Request, fresh: bool) -> int:
        """Refuse a lane from another ``weights_version`` and prefill the
        request in this engine's pool instead. The ``(seed, column)``
        sampling keys regenerate the same stream from the local prefill:
        the refusal costs one prompt pass. ``fresh`` marks a Request just
        rebuilt here (no lifecycle span open yet)."""
        if len(self.scheduler.queue) >= self.config.max_queue:
            # reject before changing the request, so the caller can retry
            # the untouched handoff elsewhere
            self.metrics.record_reject()
            raise QueueFull(
                f"serving queue at capacity ({self.config.max_queue}); "
                f"handoff refusal cannot re-prefill")
        producer = getattr(handoff, "weights_version", None)
        self.metrics.record_handoff_refused()
        with self.tracer.span(
                "handoff_refused", cat="serving",
                args={"request_id": request.request_id,
                      "producer_version": producer,
                      "local_version": self.weights_version,
                      "source": getattr(handoff, "source", None)}):
            pass
        if not fresh:
            # the request lived a prefill on the producing side: close its
            # lifecycle span and reset it; enqueue() reopens the span
            self.tracer.async_end("request", request.request_id,
                                  cat="serving",
                                  args={"handoff_refused": True})
            request.state = RequestState.QUEUED
            request.tokens.clear()
            request.prefill_pos = 0
            request.prefill_started = False
            request.first_token_time = None
        self.scheduler.enqueue(request)
        self._requests[request.request_id] = request
        log_dist(
            f"serving: KV handoff for request {request.request_id} "
            f"refused (producer weights_version {producer} != local "
            f"{self.weights_version}); prefilling locally", ranks=[0])
        return request.request_id

    # ------------------------------------------------------------------ step
    def step(self) -> int:
        """One scheduler tick: expire deadlines, admit into free slots
        (prefill), one fused decode step over all active slots. Returns the
        requests still in flight."""
        return self.scheduler.tick()

    def run_until_idle(self, max_ticks: int = 100_000) -> int:
        """Tick until no request is queued or running. Returns ticks run."""
        for i in range(max_ticks):
            if self.step() == 0:
                return i + 1
        return max_ticks

    # --------------------------------------------------------------- results
    def result(self, request_id: int) -> Request:
        return self._requests[request_id]

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued request (running requests finish their course)."""
        req = self._requests.get(request_id)
        if req is None or req.state is not RequestState.QUEUED:
            return False
        try:
            self.scheduler.queue.remove(req)
        except ValueError:
            return False
        req.state = RequestState.CANCELLED
        req.finish_time = self.scheduler.clock()
        self._close_request_spans(req)
        return True

    # ------------------------------------------------------------- lifecycle
    def drain(self, serve_queued: bool = True, max_ticks: int = 100_000):
        """Graceful shutdown: stop admissions, finish in-flight work.
        ``serve_queued=False`` additionally cancels everything still
        queued (only running slots complete)."""
        self._draining = True
        if not serve_queued:
            while self.scheduler.queue:
                req = self.scheduler.queue.popleft()
                req.state = RequestState.CANCELLED
                req.finish_time = self.scheduler.clock()
                self._close_request_spans(req)
        return self.run_until_idle(max_ticks=max_ticks)

    def _close_request_spans(self, req):
        """Cancellation bypasses the scheduler's _finish: close the
        request's open async spans so the trace stays balanced."""
        self.tracer.async_end("request/queued", req.request_id,
                              cat="serving")
        self.tracer.async_end("request", req.request_id, cat="serving",
                              args={"state": req.state.value,
                                    "tokens": len(req.tokens)})

    def shutdown(self, serve_queued: bool = True):
        """Drain, then retract this engine's gauges from the shared counter
        space."""
        self.drain(serve_queued=serve_queued)
        self.metrics.close()

    # ------------------------------------------------------------- inspection
    @property
    def weights_version(self) -> int:
        """The ``weights_version`` this engine serves (0 = unversioned),
        compared with each KV handoff's."""
        return int(getattr(self.engine, "weights_version", 0) or 0)

    @property
    def queue_depth(self) -> int:
        return len(self.scheduler.queue)

    @property
    def active_requests(self) -> int:
        """Requests holding a slot: decoding OR mid-chunked-prefill (a
        PREFILLING request is active work, not queue depth)."""
        return (len(self.scheduler.pool.active_slots) +
                len(self.scheduler.prefilling))

    def decode_executables(self) -> int:
        """How many decode-step shapes ran on this engine's pool: the JAX
        package's compile-once count, 1 across differing prompt lengths,
        for this engine's pool flavor (float or int8)."""
        return self.engine.slot_decode_executables(
            self.config.num_slots, self.config.max_model_len,
            quantized=self.scheduler.pool.quantized)
