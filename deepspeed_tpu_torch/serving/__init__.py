"""Continuous-batching serving: the slot-based KV cache (``kv_slots``), the
iteration-level scheduler (``scheduler``), the ``ServingEngine`` facade
(``engine``), the serving config (``config``) and the TTFT / latency /
utilization metrics (``metrics``) of the JAX package's ``serving/``. The
fleet layer (router, KV handoff, prefix cache) and the load generator are
not ported yet: ROADMAP.md rows A6b and A12.
"""

from .config import (ChunkedPrefillConfig, DraftConfig, KVQuantConfig,
                     LoadgenConfig, PrefixCacheConfig, ServingConfig,
                     SLOConfig, SoakConfig, SpeculativeConfig,
                     TenantConfig)
from .engine import ServingEngine
from .kv_slots import SlotPool
from .metrics import ServingMetrics
from .scheduler import (ContinuousBatchingScheduler, QueueFull,
                        RateLimited, Request, RequestState, SamplingParams,
                        TenantQueues)

__all__ = [
    "ServingConfig", "SLOConfig", "PrefixCacheConfig", "KVQuantConfig",
    "SpeculativeConfig", "DraftConfig", "ChunkedPrefillConfig",
    "TenantConfig", "LoadgenConfig", "SoakConfig",
    "ServingEngine", "SlotPool", "ServingMetrics",
    "ContinuousBatchingScheduler", "QueueFull", "RateLimited", "Request",
    "RequestState", "SamplingParams", "TenantQueues",
]
