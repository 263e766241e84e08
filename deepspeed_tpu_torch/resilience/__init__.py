"""deepspeed_tpu_torch.resilience — the checkpoint half of the JAX
package's fault tolerance: SHA-256 manifests, newest→oldest valid-tag
fallback, keep-last-N retention, retryable checkpoint IO, and the
deterministic fault-injection registry those paths are tested through.
Preemption handling and the training sentinel are ROADMAP.md row A12.
"""

from .config import ResilienceConfig, SENTINEL_POLICIES
from .faults import KNOWN_FAULTS, FaultInjector, fault, get_injector
from .manifest import (CheckpointLoadError, MANIFEST_NAME, gc_checkpoints,
                       list_tags, verify_manifest, write_manifest)
from .retry import retry_io

__all__ = [
    "ResilienceConfig", "SENTINEL_POLICIES",
    "KNOWN_FAULTS", "FaultInjector", "fault", "get_injector",
    "MANIFEST_NAME", "write_manifest", "verify_manifest", "list_tags",
    "gc_checkpoints", "CheckpointLoadError",
    "retry_io",
]
