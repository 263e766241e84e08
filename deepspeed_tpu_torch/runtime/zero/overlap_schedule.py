"""The bucketed compute–communication overlap schedule of the ZeRO
exchange: the JAX package's ``runtime/zero/overlap_schedule.py``.

The explicit exchange (``compressed_step.py``) moves every leaf in its own
collective, all before the forward and all after the backward. This
schedule partitions the leaves into size-targeted buckets in layer order
and overlaps their exchanges with the compute:

1. **Partition** (``build_schedule``, on the JAX leaf view: the stacked
   ``[L, ...]`` paths and shapes of ``engine.param_shapes``, so the plan
   and its ``info`` are the JAX plan): layer-stacked leaves are cut along
   the layer dim on one uniform chunk grid, so a bucket holds "layers
   lo..hi of every weight kind"; embeddings first, then the layer chunks,
   then the tail.
2. **Exchange a bucket** through the coalesced dispatch
   (``comm.all_gather_coalesced`` / ``reduce_scatter_coalesced``): one
   collective a bucket, each leaf with its per-leaf codec under a
   quantized policy, the bytes of the per-leaf models accounted.
3. **Order the issues.** Stage 3's gathers are issued asynchronously
   (``async_op``), bucket by bucket in layer order, before the forward;
   the top-level leaves' buckets are waited for before the forward and a
   layer's bucket by the layer itself, through the model's ``_zero_hook``.
   Each bucket's gathered (stage 3) or cast (stage 2) tensors pass through
   an autograd ``Function`` at the bucket boundary, whose backward runs
   once the bucket's layers have all finished their backward and issues
   the bucket's gradient reduce-scatter, asynchronously, in reverse layer
   order; the update waits for them.

The values are the per-leaf explicit exchange's bit for bit at any
``bucket_bytes`` where a segment is a whole leaf or the policy keeps full
precision; under a quantized policy with layer chunking a layer slice
takes its own blocks, as in the JAX package. ``overlap: false`` makes one
fused bucket a direction. ``pin_order`` is accepted: in eager mode the
issue order is program order.

Scope: pure data-parallel ZeRO, as the explicit exchange.
"""

import dataclasses
import re
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...comm import comm
from ...parallel.topology import DATA_AXIS
from ..config_utils import ConfigError, DeepSpeedConfigModel
from .compressed_step import ExplicitExchange

__all__ = ["OverlapScheduleConfig", "Segment", "layer_chunks",
           "partition_buckets", "build_schedule", "make_bucketed_micro_grad"]


@dataclasses.dataclass
class OverlapScheduleConfig(DeepSpeedConfigModel):
    """The ``"overlap_schedule"`` config block."""
    enabled: bool = False
    #: target payload bytes a bucket (full-tensor bytes; a single
    #: oversized segment still gets its own bucket)
    bucket_bytes: int = 4 << 20
    #: False = one fused bucket a direction (bucket_bytes is ignored)
    overlap: bool = True
    #: keep the layer-order issue sequence (eager issue order is program
    #: order)
    pin_order: bool = True
    #: slice layer-stacked leaves along the layer dim so buckets follow
    #: consumption order
    layer_chunking: bool = True

    def validate(self):
        if self.bucket_bytes < 1:
            raise ConfigError(
                "overlap_schedule.bucket_bytes must be >= 1")


# ---------------------------------------------------------------- partitioner

#: leaf paths consumed before the layer stack (embeddings)
_EMBED_RE = re.compile(r"wte|wpe|embed|tok_|pos_", re.IGNORECASE)


@dataclasses.dataclass(frozen=True)
class Segment:
    """One schedulable slice of a leaf: the whole leaf, or layers [lo, hi)
    of a layer-stacked leaf (sliced along dim 0)."""
    leaf: int                    # flat leaf index
    lo: int = -1                 # layer slice start (-1 = whole leaf)
    hi: int = -1
    dim: int = 0                 # gather/scatter dim (leaf dim numbering)
    nbytes: int = 0              # full-tensor payload bytes
    path: str = ""

    @property
    def sliced(self) -> bool:
        return self.lo >= 0


def layer_chunks(n_layer: int, per_layer_bytes: int,
                 target_bytes: int) -> List[Tuple[int, int]]:
    """Uniform [lo, hi) layer ranges whose stacked payload approaches the
    bucket target (one grid for every stacked leaf)."""
    if n_layer <= 0:
        return []
    per = max(1, int(round(target_bytes / max(1, per_layer_bytes))))
    per = min(per, n_layer)
    return [(lo, min(lo + per, n_layer))
            for lo in range(0, n_layer, per)]


def partition_buckets(segments: Sequence[Segment],
                      target_bytes: int) -> List[List[Segment]]:
    """Greedy contiguous fill: consecutive segments share a bucket while
    the payload stays under the target; an oversized segment gets its own
    bucket. Segment order is kept."""
    buckets: List[List[Segment]] = []
    cur: List[Segment] = []
    cur_bytes = 0
    for seg in segments:
        if cur and cur_bytes + seg.nbytes > target_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(seg)
        cur_bytes += seg.nbytes
    if cur:
        buckets.append(cur)
    return buckets


def _leaf_meta(engine):
    """(paths, shapes, dtype bytes, gather dims, scatter dims) of every
    leaf of the JAX parameter tree, in its flatten order."""
    from .compressed_step import jax_leaves
    leaves = jax_leaves(engine)
    itemsize = torch.empty((), dtype=engine._compute_dtype).element_size()
    return ([lf.path for lf in leaves], [lf.shape for lf in leaves],
            itemsize, [lf.gdim for lf in leaves], [lf.sdim for lf in leaves])


def build_schedule(engine, cfg: Optional[OverlapScheduleConfig] = None):
    """The static bucket plan of an engine: ``(gather_buckets, rs_buckets,
    ar_leaves, info)``. Gather buckets cover the dp-sharded parameter
    leaves (stage 3), rs buckets the dp-sharded gradient leaves (stages
    2-3); ``ar_leaves`` are the replicated-gradient leaves, all-reduced
    one by one."""
    cfg = cfg or engine._config.overlap_schedule
    paths, shapes, itemsize, gdims, sdims = _leaf_meta(engine)
    n_layer = int(getattr(getattr(engine.module, "config", None),
                          "n_layer", 0) or 0)
    target = cfg.bucket_bytes if cfg.overlap else (1 << 62)

    def stacked(i) -> bool:
        return (cfg.layer_chunking and n_layer > 1 and
                "blocks" in paths[i] and len(shapes[i]) >= 2 and
                shapes[i][0] == n_layer)

    def nbytes(i, lo=-1, hi=-1) -> int:
        n = int(np.prod(shapes[i] or (1,))) * itemsize
        if lo >= 0:
            n = n * (hi - lo) // shapes[i][0]
        return n

    stacked_idx = [i for i in range(len(paths)) if stacked(i)]
    per_layer = sum(nbytes(i) for i in stacked_idx) // max(1, n_layer)
    chunks = layer_chunks(n_layer, per_layer, target) if stacked_idx else []

    def ordered_segments(dims) -> List[Segment]:
        embed, tail, by_chunk = [], [], {c: [] for c in range(len(chunks))}
        for i in range(len(paths)):
            if dims[i] < 0:
                continue
            if stacked(i) and dims[i] != 0:
                for c, (lo, hi) in enumerate(chunks):
                    by_chunk[c].append(Segment(
                        i, lo, hi, dims[i], nbytes(i, lo, hi), paths[i]))
                continue
            seg = Segment(i, dim=dims[i], nbytes=nbytes(i), path=paths[i])
            (embed if _EMBED_RE.search(paths[i]) else tail).append(seg)
        out = list(embed)
        for c in range(len(chunks)):
            out += by_chunk[c]
        return out + tail

    gather_buckets = partition_buckets(ordered_segments(gdims), target)
    rs_buckets = partition_buckets(ordered_segments(sdims), target)
    ar_leaves = [i for i in range(len(paths)) if sdims[i] < 0]
    info = {
        "n_leaves": len(paths),
        "layer_chunks": chunks,
        "gather_buckets": len(gather_buckets),
        "rs_buckets": len(rs_buckets),
        "all_reduce_leaves": len(ar_leaves),
        "bucket_bytes": cfg.bucket_bytes if cfg.overlap else 0,
        "overlap": cfg.overlap,
    }
    return gather_buckets, rs_buckets, ar_leaves, info


# ------------------------------------------------------------- micro gradient

class _Boundary(torch.autograd.Function):
    """The tensors of one bucket, unchanged; its backward (all the bucket's
    gradients present) hands them to the schedule, which issues the
    bucket's reduce-scatter. ``dummy`` is the differentiated input that
    makes autograd run it."""

    @staticmethod
    def forward(ctx, sched, k, dummy, *tensors):
        ctx.sched, ctx.k = sched, k
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        ctx.sched.bucket_ready(ctx.k, list(grads))
        return (None, None, torch.zeros((), device=grads[0].device)) + \
            (None,) * len(grads)


class BucketedExchange(ExplicitExchange):
    """The bucketed variant of the explicit micro gradient: the same
    interface (``inputs``, ``rng``, ``backward``), the same values, the
    schedule above. ``issue_log`` records a step's issues in order:
    ``("gather", k)`` and ``("reduce_scatter", k)``."""

    def __init__(self, engine, cfg=None):
        super().__init__(engine)
        self.cfg = cfg or engine._config.overlap_schedule
        self.gather_buckets, self.rs_buckets, self.ar_leaves, self.info = \
            build_schedule(engine, self.cfg)
        if self.gather_buckets and self.gather_buckets != self.rs_buckets:
            raise ValueError("overlap_schedule: stage 3's gather and "
                             "reduce-scatter buckets differ")
        self._leaf_index = {lf.name: j for j, lf in enumerate(self.leaves)}
        # (leaf, layer or None) -> (rs bucket, position of its tensor)
        self.where = {}
        for k, bucket in enumerate(self.rs_buckets):
            pos = 0
            for seg in bucket:
                for key in self._seg_keys(seg):
                    self.where[key] = (k, pos)
                    pos += 1
        self.issue_log: List[Tuple[str, int]] = []

    def _seg_keys(self, seg: Segment):
        """The (leaf, layer) keys of a segment's per-parameter tensors."""
        leaf = self.leaves[seg.leaf]
        if not leaf.stacked:
            return [(seg.leaf, None)]
        lo, hi = (seg.lo, seg.hi) if seg.sliced else (0, len(leaf.idx))
        return [(seg.leaf, layer) for layer in range(lo, hi)]

    def _seg_shard(self, seg: Segment, by_idx):
        """The rank's part of a segment (the stacked shard, sliced)."""
        x = self.stack(self.leaves[seg.leaf], by_idx, seg.dim)
        return x[seg.lo:seg.hi] if seg.sliced else x

    def _seg_split(self, seg: Segment, value):
        """``[tensor for each of the segment's keys]`` of a segment's
        gathered (whole) value."""
        if not self.leaves[seg.leaf].stacked:
            return [value]
        return list(value.unbind(0))

    # -- forward
    def inputs(self, pc):
        by_idx = {i: pc[n] for i, n in enumerate(self.names)}
        st = SimpleNamespace(by_idx=by_idx, gathers=[], outs={}, ready={},
                             pending={}, next_rs=len(self.rs_buckets) - 1,
                             dummy=torch.zeros((), device=self.engine.device,
                                               requires_grad=True))
        self.issue_log = []
        for k, bucket in enumerate(self.gather_buckets):
            with torch.no_grad():
                xs = [self._seg_shard(s, by_idx).detach() for s in bucket]
            st.gathers.append(comm.all_gather_coalesced(
                xs, DATA_AXIS, axes=[s.dim for s in bucket], async_op=True))
            self.issue_log.append(("gather", k))
        self.state = st
        names_map = {}
        for i, n in enumerate(self.names):
            key = self._key_of(i)
            if key in self.where and key[1] is None:
                k, pos = self.where[key]
                names_map[n] = self._bucket(k)[pos]
            else:               # a layer's bucketed leaves: through the hook
                names_map[n] = pc[n]
        return names_map, self._hook, st

    def _key_of(self, i):
        leaf, layer = self.engine._layout[i]
        return self._leaf_index[leaf], layer

    def _bucket(self, k):
        """Bucket ``k``'s tensors on the autograd graph (waiting for its
        gather under stage 3), made once a step."""
        st = self.state
        if k not in st.outs:
            bucket = self.rs_buckets[k]
            if self.gather_buckets:
                tensors = []
                for seg, g in zip(bucket, st.gathers[k].wait()):
                    tensors += self._seg_split(seg, g)
            else:
                tensors = [st.by_idx[self.leaves[li].idx[layer]
                                     if layer is not None else
                                     self.leaves[li].idx[0]]
                           for seg in bucket
                           for li, layer in self._seg_keys(seg)]
            st.outs[k] = _Boundary.apply(self, k, st.dummy, *tensors)
        return st.outs[k]

    def _hook(self, block, leaves):
        """The layer loop's hook: the layer's bucketed leaves (waiting for
        their buckets), the others as they are."""
        layer = self.engine._layer_of[id(block)]
        out = dict(leaves)
        prefix = "blocks/"
        for name in leaves:
            li = self._leaf_index.get(prefix + name)
            if li is None or (li, layer) not in self.where:
                continue
            k, pos = self.where[(li, layer)]
            out[name] = self._bucket(k)[pos]
        return SimpleNamespace(**out)

    # -- backward
    def bucket_ready(self, k, grads):
        """Bucket ``k``'s gradients are complete: issue the reduce-scatters
        that are due, in reverse bucket order."""
        st = self.state
        st.ready[k] = grads
        while st.next_rs >= 0 and st.next_rs in st.ready:
            self._issue_rs(st.next_rs)
            st.next_rs -= 1

    def _issue_rs(self, k):
        st = self.state
        bucket = self.rs_buckets[k]
        grads = st.ready.pop(k)
        xs, pos = [], 0
        for seg in bucket:
            n = len(self._seg_keys(seg))
            part = grads[pos:pos + n]
            pos += n
            leaf = self.leaves[seg.leaf]
            xs.append(torch.stack(part) if leaf.stacked else part[0])
        st.pending[k] = comm.reduce_scatter_coalesced(
            xs, DATA_AXIS, axes=[s.dim for s in bucket],
            op=comm.ReduceOp.AVG, async_op=True)
        self.issue_log.append(("reduce_scatter", k))

    def _flush(self):
        """Issue every reduce-scatter not issued yet, in reverse bucket
        order; a bucket the loss never reached sends zeros."""
        st = self.state
        while st.next_rs >= 0:
            k = st.next_rs
            if k not in st.ready:
                st.ready[k] = [torch.zeros_like(t) for t in st.outs[k]]
            self._issue_rs(k)
            st.next_rs -= 1

    def backward(self, scaled_loss, state):
        st = state
        for k in range(len(self.rs_buckets)):      # every bucket on graph
            self._bucket(k)
        ar_idx = [i for li in self.ar_leaves for i in self.leaves[li].idx]
        params = [st.by_idx[i] for i in ar_idx]
        grads = torch.autograd.grad(scaled_loss, [st.dummy] + params,
                                    allow_unused=True)[1:]
        self._flush()
        gmap = {i: torch.zeros_like(p) if g is None else g
                for i, p, g in zip(ar_idx, params, grads)}
        out = {}
        for li in self.ar_leaves:
            leaf = self.leaves[li]
            r = comm.all_reduce(self.stack(leaf, gmap).contiguous(),
                                op=comm.ReduceOp.AVG, axis_name=DATA_AXIS)
            out.update(self.unstack(leaf, r))
        per_leaf = {}
        for k, bucket in enumerate(self.rs_buckets):
            for seg, v in zip(bucket, st.pending.pop(k).wait()):
                per_leaf.setdefault(seg.leaf, []).append((seg, v))
        for li, parts in per_leaf.items():
            leaf = self.leaves[li]
            if len(parts) == 1 and not parts[0][0].sliced:
                v = parts[0][1]
            else:
                parts = sorted(parts, key=lambda p: p[0].lo)
                v = torch.cat([p[1] for p in parts], dim=0)
            out.update(self.unstack(leaf, v.contiguous(), leaf.sdim))
        loss = comm.all_reduce(scaled_loss.detach().reshape(1).clone(),
                               op=comm.ReduceOp.AVG,
                               axis_name=DATA_AXIS)[0]
        self.state = None
        return [out[i].contiguous() for i in range(len(self.names))], loss


def make_bucketed_micro_grad(engine, cfg=None):
    """The engine's bucketed explicit exchange."""
    return BucketedExchange(engine, cfg)
