"""Continuous-batching serving: the slot-based KV cache (``kv_slots``), the
iteration-level scheduler (``scheduler``), the ``ServingEngine`` facade
(``engine``), the serving config (``config``), the TTFT / latency /
utilization metrics (``metrics``) and, of the fleet layer (``fleet/``),
the radix prefix cache and the prefill/decode KV handoff, as the JAX
package's ``serving/`` has them. The router, rollout and the load
generator are not ported yet: ROADMAP.md row A12.
"""

from .config import (ChunkedPrefillConfig, DraftConfig, KVQuantConfig,
                     LoadgenConfig, PrefixCacheConfig, ServingConfig,
                     SLOConfig, SoakConfig, SpeculativeConfig,
                     TenantConfig)
from .engine import ServingEngine
from .fleet import KVHandoff, RadixPrefixCache
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
    "KVHandoff", "RadixPrefixCache",
]
