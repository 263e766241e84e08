"""The fleet layer of the JAX package's ``serving/fleet/`` that the port
serves: the radix prefix cache over the slot pool (``prefix_cache``) and
the KV handoff between ``prefill`` and ``decode`` engines (``handoff``).
The router, replica handles, rollout and the fleet config are ROADMAP.md
row A12.
"""

from .handoff import InProcessTransport, KVHandoff
from .prefix_cache import PrefixHit, RadixPrefixCache, reuse_plan

__all__ = ["KVHandoff", "InProcessTransport", "RadixPrefixCache",
           "PrefixHit", "reuse_plan"]
