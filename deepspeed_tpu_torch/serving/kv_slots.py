"""Slot-based KV-cache pool.

The pool is ONE statically-shaped cache ``[L, num_slots, H_kv,
max_model_len, hd]`` allocated at startup, as in the JAX package. A request
is admitted by claiming a free slot (prefill writes the slot's lane),
advanced by the fused all-slot decode step, and retired by returning the
slot to the free list: no shape ever changes, so every decode step runs
the same shapes.

``SlotPool`` owns the device tensors plus the host-side per-slot registers
(length counter, pending token, sampling controls) that the scheduler
feeds to ``InferenceEngine.slot_decode_step`` each tick.
"""

from typing import List, Optional

import numpy as np


def tree_nbytes(tree) -> int:
    """Logical bytes of a dict / list / tuple of tensors or arrays, read
    from their shapes on the host (no device sync): ``sum(numel *
    itemsize)``, the JAX package's ``costplane.tree_nbytes``."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    numel = getattr(tree, "numel", None)
    if callable(numel):                       # torch.Tensor
        return int(numel()) * int(tree.element_size())
    size, dtype = getattr(tree, "size", None), getattr(tree, "dtype", None)
    if size is None or dtype is None:
        return 0
    return int(size) * int(dtype.itemsize)    # numpy


class SlotPool:
    """Fixed pool of decode slots over one static KV cache."""

    def __init__(self, engine, num_slots: int, max_model_len: int,
                 quantize: bool = False):
        self.engine = engine
        self.num_slots = num_slots
        self.max_model_len = max_model_len
        #: the int8 pool of ``kv_quant`` (inference/kv_quant.py), or the
        #: serving dtype's
        self.quantized = bool(quantize)
        self.cache = engine.init_slot_pool(num_slots, max_model_len,
                                           quantize=self.quantized)
        # host-side slot registers, copied to the device each tick
        self.lengths = np.zeros((num_slots,), np.int32)   # tokens in cache
        self.pending = np.zeros((num_slots,), np.int32)   # next token to feed
        self.temps = np.zeros((num_slots,), np.float32)
        # per-request sampling registers: top-k / top-p truncation and the
        # request seed; sampling keys derive only from (seed, position)
        self.top_ks = np.zeros((num_slots,), np.int32)
        self.top_ps = np.ones((num_slots,), np.float32)
        self.seeds = np.zeros((num_slots,), np.int32)
        self.requests: List[Optional[object]] = [None] * num_slots
        self._free = list(range(num_slots - 1, -1, -1))  # pop(): slot 0 first
        #: slots parked in the prefix cache: not free, not active; their
        #: lanes stay resident as reusable prefixes until LRU eviction
        self.cached: set = set()
        self.total_allocs = 0

    # ------------------------------------------------------------ lifecycle
    def alloc(self) -> Optional[int]:
        """Claim a free slot, or None when the pool is saturated."""
        if not self._free:
            return None
        slot = self._free.pop()
        self.total_allocs += 1
        return slot

    def free(self, slot: int):
        """Retire a slot back to the free list (EOS / max-tokens /
        timeout / prefix-cache eviction). The lane's stale K/V needs no
        scrubbing: the next prefill writes the lane and the decode mask
        never looks past the new request's length."""
        if self.requests[slot] is None and slot in self._free:
            return
        self._detach(slot)
        self.lengths[slot] = 0
        self.cached.discard(slot)
        self._free.append(slot)

    def retire_to_cache(self, slot: int):
        """Park a finished request's slot in the prefix cache: detached
        from decode (no request, nothing pending) but not freed, its K/V
        resident as a reusable prefix. ``lengths`` keeps the valid-column
        count, so the per-tick dummy writes for a parked slot (a decode
        column, or a verify block's ``k + 1``) land from column
        ``lengths[slot]`` on, past the cached content: the cached prefix
        is never clobbered."""
        self._detach(slot)
        self.cached.add(slot)

    def _detach(self, slot: int):
        """No request, nothing pending, greedy neutral registers."""
        self.requests[slot] = None
        self.pending[slot] = 0
        self.temps[slot] = 0.0
        self.top_ks[slot] = 0
        self.top_ps[slot] = 1.0
        self.seeds[slot] = 0

    def bind(self, slot: int, request, length: int, first_token: int,
             sampling=None):
        """Attach an admitted request to its slot after prefill.
        ``sampling`` is the request's SamplingParams (or None for the
        greedy defaults): its temperature / top-k / top-p / seed become
        this slot's per-tick registers."""
        self.requests[slot] = request
        self.lengths[slot] = length
        self.pending[slot] = first_token
        self.temps[slot] = getattr(sampling, "temperature", 0.0)
        self.top_ks[slot] = getattr(sampling, "top_k", 0)
        self.top_ps[slot] = getattr(sampling, "top_p", 1.0)
        self.seeds[slot] = getattr(sampling, "seed", 0)

    # ------------------------------------------------------------ queries
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> List[int]:
        return [s for s in range(self.num_slots)
                if self.requests[s] is not None]

    def nbytes(self) -> int:
        """Resident bytes of the pool (an int8 pool's payload and
        scales)."""
        from ..inference.kv_quant import pool_nbytes
        return pool_nbytes(self.cache)

    @property
    def utilization(self) -> float:
        return 1.0 - len(self._free) / self.num_slots

    def decode_arrays(self):
        """(toks, positions, temps, top_ks, top_ps, seeds) for one fused
        decode or verify step. Free slots carry dummy values (token 0 at
        column 0, greedy); their lane writes land in a lane the next
        prefill rewrites, and the scheduler drops their sampled tokens."""
        return (self.pending.copy(), self.lengths.copy(), self.temps.copy(),
                self.top_ks.copy(), self.top_ps.copy(), self.seeds.copy())
