"""Radix prefix cache over the slot KV pool, the JAX package's
``serving/fleet/prefix_cache.py``, decision for decision.

Whole retired slots are the cache: when a request finishes, its slot,
whose lane already holds the K/V of every token it processed, is
*donated* here instead of returning to the free list. A later request
whose prompt shares a prefix with a cached sequence is admitted by
``slot_copy_lane`` (a lane copy on the device) and
``slot_suffix_prefill`` (only the unshared tail runs through the stack).

The index is a radix tree (edge-compressed trie) over token sequences.
Lookup walks the query as deep as tokens match and returns the
most-recently-used entry under the divergence point; the match length,
not the entry's full length, is what the admission reuses, so a cached
``ABCDEF`` still serves an ``ABCXYZ`` query up to ``ABC``.

Entries are ref-count pinned while an admission copies from them (and by
anything else that calls ``pin``); eviction is LRU over unpinned entries
and happens on demand, when the scheduler needs a slot and the free list
is empty. The cache allocates no device memory of its own: it only
defers the recycling of lanes the pool already holds.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ...inference.engine import _next_pow2

__all__ = ["RadixPrefixCache", "PrefixHit", "reuse_plan"]


def reuse_plan(prompt_len: int, matched_len: int,
               max_len: int) -> Tuple[int, int]:
    """(offset, suffix_len) for a prefix-reuse admission.

    The suffix is prefilled at a pow2 bucket starting at ``offset``;
    both constraints are folded in here: at least one suffix token must
    run (the sampled next token needs a query position — a fully-cached
    prompt still prefills its last token), and the bucket must fit below
    ``max_len`` (when it would not, the offset backs off so reuse never
    corrupts the lane tail — ``offset = max_len - bucket`` always fits
    because ``prompt_len <= max_len``). ``offset == 0`` means reuse is
    not worth it: fall back to a full prefill."""
    matched = min(matched_len, prompt_len - 1)
    if matched <= 0:
        return 0, prompt_len
    suffix = prompt_len - matched
    bucket = min(_next_pow2(suffix), max_len)
    offset = min(matched, max_len - bucket)
    return max(0, offset), prompt_len - max(0, offset)


class _Node:
    """Radix node: compressed edges keyed by first token; at most one
    cache entry terminates at a node (duplicate keys are rejected at
    donation)."""
    __slots__ = ("edges", "entry", "parent", "pkey")

    def __init__(self, parent=None, pkey=None):
        self.edges: Dict[int, Tuple[tuple, "_Node"]] = {}
        self.entry: Optional["_Entry"] = None
        self.parent = parent
        self.pkey = pkey          # first token of the edge from parent


@dataclasses.dataclass
class _Entry:
    slot: int
    key: tuple                    # the cached token sequence
    kv_len: int                   # valid cache columns in the lane
    node: _Node
    refs: int = 0
    last_use: int = 0


@dataclasses.dataclass
class PrefixHit:
    """One pinned lookup result: copy ``slot``'s lane and suffix-prefill
    from column ``matched``. Call ``cache.release(hit, used)`` when the
    copy is done (or abandoned) — the pin blocks eviction meanwhile."""
    slot: int
    matched: int
    entry: _Entry


class RadixPrefixCache:
    """Trie of donated slots + ref-counts + LRU eviction."""

    def __init__(self, config=None, tracer=None):
        self.min_prefix_len = int(getattr(config, "min_prefix_len", 8)
                                  if config is not None else 8)
        self.max_entries = int(getattr(config, "max_cached_slots", 0)
                               if config is not None else 0)
        self.root = _Node()
        self.entries: Dict[int, _Entry] = {}       # slot -> entry
        self._by_key: Dict[tuple, _Entry] = {}
        self._stamp = 0
        # counters surfaced as serving/prefix_* gauges and in /statusz
        self.lookups = 0
        self.hits = 0
        self.tokens_saved = 0
        self.donations = 0
        self.evictions = 0

    # -------------------------------------------------------------- lookup
    def lookup(self, tokens) -> Optional[PrefixHit]:
        """Longest-shared-prefix probe. Returns a PINNED hit when at least
        ``min_prefix_len`` tokens match (and at least one suffix token
        remains to prefill), else None."""
        self.lookups += 1
        tokens = tuple(int(t) for t in np.asarray(tokens).reshape(-1))
        node, depth = self._walk(tokens)
        matched = min(depth, len(tokens) - 1)
        if matched < self.min_prefix_len:
            return None
        entry = self._best_entry(node)
        if entry is None:
            return None
        matched = min(matched, entry.kv_len)
        if matched < self.min_prefix_len:
            return None
        self.hits += 1
        entry.refs += 1
        self._stamp += 1
        entry.last_use = self._stamp
        return PrefixHit(slot=entry.slot, matched=matched, entry=entry)

    def release(self, hit: PrefixHit, used_tokens: int = 0):
        """Unpin a lookup; ``used_tokens`` is the prefix length actually
        reused (post ``reuse_plan``), fed to the tokens-saved counter."""
        hit.entry.refs = max(0, hit.entry.refs - 1)
        self.tokens_saved += max(0, int(used_tokens))

    def pin(self, slot: int) -> bool:
        """Explicit pin of a cached slot (blocks eviction until unpin)."""
        e = self.entries.get(slot)
        if e is None:
            return False
        e.refs += 1
        return True

    def unpin(self, slot: int) -> bool:
        e = self.entries.get(slot)
        if e is None:
            return False
        e.refs = max(0, e.refs - 1)
        return True

    def _walk(self, tokens: tuple) -> Tuple[_Node, int]:
        """Deepest (node, depth) whose subtree shares ``depth`` leading
        tokens with the query."""
        node, depth = self.root, 0
        while depth < len(tokens):
            edge = node.edges.get(tokens[depth])
            if edge is None:
                break
            label, child = edge
            j = 0
            while (j < len(label) and depth + j < len(tokens)
                   and label[j] == tokens[depth + j]):
                j += 1
            depth += j
            node = child          # full or partial edge match: entries
            if j < len(label):    # under `child` share exactly `depth`
                break
        return node, depth

    def _best_entry(self, node: _Node) -> Optional[_Entry]:
        """Most-recently-used entry in ``node``'s subtree (small pools:
        a DFS is cheaper than maintaining per-node aggregates)."""
        best = None
        stack = [node]
        while stack:
            n = stack.pop()
            if n.entry is not None and \
                    (best is None or n.entry.last_use > best.last_use):
                best = n.entry
            for _label, child in n.edges.values():
                stack.append(child)
        return best

    # ------------------------------------------------------------ donation
    def donate(self, slot: int, tokens, kv_len: int
               ) -> Tuple[bool, Optional[int]]:
        """Offer a retiring slot's lane to the cache. Returns
        ``(accepted, evicted_slot)``: when accepted the caller must NOT
        free the slot (the lane stays resident as the cache entry);
        ``evicted_slot`` — an LRU entry displaced by the ``max_cached_slots``
        cap — must be freed by the caller. Rejected donations (too short,
        exact key already cached, slot already donated) leave the slot to
        the normal free path."""
        key = tuple(int(t) for t in np.asarray(tokens).reshape(-1))[:kv_len]
        if len(key) < self.min_prefix_len or slot in self.entries:
            return False, None
        if key in self._by_key:
            # the resident entry is at least as useful; refresh its LRU
            self._stamp += 1
            self._by_key[key].last_use = self._stamp
            return False, None
        node = self._insert(key)
        if node.entry is not None:   # same terminal node, different kv_len
            return False, None
        self._stamp += 1
        entry = _Entry(slot=slot, key=key, kv_len=min(kv_len, len(key)),
                       node=node, last_use=self._stamp)
        node.entry = entry
        self.entries[slot] = entry
        self._by_key[key] = entry
        self.donations += 1
        evicted = None
        if self.max_entries and len(self.entries) > self.max_entries:
            evicted = self.evict_lru(exclude=slot)
        return True, evicted

    def _insert(self, key: tuple) -> _Node:
        node, i = self.root, 0
        while i < len(key):
            first = key[i]
            edge = node.edges.get(first)
            if edge is None:
                child = _Node(parent=node, pkey=first)
                node.edges[first] = (key[i:], child)
                return child
            label, child = edge
            j = 0
            while (j < len(label) and i + j < len(key)
                   and label[j] == key[i + j]):
                j += 1
            if j == len(label):
                node, i = child, i + j
                continue
            # split the edge at the divergence point
            mid = _Node(parent=node, pkey=first)
            node.edges[first] = (label[:j], mid)
            mid.edges[label[j]] = (label[j:], child)
            child.parent, child.pkey = mid, label[j]
            node, i = mid, i + j
        return node

    # ------------------------------------------------------------ eviction
    def evict_lru(self, exclude: Optional[int] = None) -> Optional[int]:
        """Drop the least-recently-used UNPINNED entry; returns its slot
        (for the caller to free) or None when everything is pinned."""
        victim = None
        for e in self.entries.values():
            if e.refs > 0 or e.slot == exclude:
                continue
            if victim is None or e.last_use < victim.last_use:
                victim = e
        if victim is None:
            return None
        self._remove(victim)
        self.evictions += 1
        return victim.slot

    def remove_slot(self, slot: int) -> bool:
        """Forcibly drop a slot's entry (pool teardown), pinned or not."""
        e = self.entries.get(slot)
        if e is None:
            return False
        self._remove(e)
        return True

    def _remove(self, entry: _Entry):
        self.entries.pop(entry.slot, None)
        self._by_key.pop(entry.key, None)
        node = entry.node
        node.entry = None
        # prune now-empty leaf chains (no merge: single-edge pass-through
        # nodes are harmless and the next donation may re-split anyway)
        while (node is not None and node.parent is not None
               and not node.edges and node.entry is None):
            parent = node.parent
            parent.edges.pop(node.pkey, None)
            node = parent

    # ------------------------------------------------------------- queries
    @property
    def cached_slots(self) -> int:
        return len(self.entries)

    @property
    def evictable(self) -> int:
        return sum(1 for e in self.entries.values() if e.refs == 0)

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def stats(self) -> dict:
        return {"cached_slots": self.cached_slots,
                "pinned": self.cached_slots - self.evictable,
                "lookups": self.lookups, "hits": self.hits,
                "hit_rate": round(self.hit_rate, 4),
                "tokens_saved": self.tokens_saved,
                "donations": self.donations, "evictions": self.evictions}
