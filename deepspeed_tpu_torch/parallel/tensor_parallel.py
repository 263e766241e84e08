"""Tensor parallelism: the collectives GSPMD inserts for the JAX package,
written out (Megatron's column- and row-parallel layers).

The JAX package shards a model by its ``partition_rules()``: ``model`` on
the vocab rows of the embedding and LM head, on the columns of the fused
``qkv`` and first MLP projections, on the rows of the attention and second
MLP projections; XLA then inserts every collective. Here each rank holds
its part of those leaves and the layers call the collectives below over
the ``model`` group of the rank topology (``parallel/topology.py``),
through ``comm/comm.py``, so ``comm_stats()`` / ``comm_axis_stats("model")``
count them. Each is a ``torch.autograd.Function``:

- ``copy_to_tp``: identity forward, all-reduce backward (a column-parallel
  layer's input);
- ``reduce_from_tp``: all-reduce forward, identity backward (a row-parallel
  layer's output, before its replicated bias is added once);
- ``gather_from_tp``: all-gather on the last dim forward, this rank's slice
  backward (the logits of ``forward`` and ``generate``);
- ``vocab_parallel_embedding``: rows outside the rank's vocab range masked
  to zero, then ``reduce_from_tp``;
- ``vocab_parallel_lse``: the NLL's per-row max, sum of exp and target
  logit combined over the ranks (max and sums all-reduced), so that no rank
  builds the whole ``[B, T, V]`` logits (``models/gpt2.py``'s
  ``_ChunkedNLL`` calls it).

At tp 1 each is the identity, with no collective and no copy.

``TPSplit`` is where a parameter's tp part lies in its whole (JAX) tensor:
a contiguous block of one dim, as the rule's ``model`` entry lays it out,
except for the fused ``qkv`` leaves. There the JAX rule's block of columns
would mix q and k heads across ranks; a rank here holds ``[q_r | k_r |
v_r]``, its own heads of each of q, k and v in that order (``H / tp``
query heads and ``H_kv / tp`` kv heads), so the attention kernels read q,
k and v as column sections of the rank's projection, as at tp 1. ``take``
and ``gather`` go through that map; checkpoints, ``load_jax_params`` and
``jax_params`` see the JAX leaf whole. With fewer kv heads than ranks
(Megatron's rule: ``tp`` a multiple of ``H_kv``) a section splits into
fewer ``parts`` than ranks: rank ``r`` holds block ``r parts / tp``, so
``tp / H_kv`` ranks share each kv head; ``gather`` takes each block once,
from the first rank that holds it, ``owned_mask`` says which of a rank's
elements count in a gradient norm, and ``sum_shared_grads`` sums a shared
block's gradient over the ranks that hold it (GSPMD's transpose of the
replicated columns).
"""

import re
from typing import Optional, Sequence

import torch

from ..comm import comm
from .topology import MODEL_AXIS


class TPInfo:
    """A model's place on the ``model`` axis: ``size`` ranks, this one's
    index ``rank``, and the process group (``comm.SINGLE`` at tp 1)."""

    __slots__ = ("size", "rank", "group")

    def __init__(self, size: int = 1, rank: int = 0, group=comm.SINGLE):
        self.size, self.rank, self.group = int(size), int(rank), group

    @property
    def active(self) -> bool:
        return self.size > 1

    def __repr__(self):
        return f"TPInfo(size={self.size}, rank={self.rank})"


def from_mesh(mm) -> TPInfo:
    """The ``TPInfo`` of a rank mesh's ``model`` axis."""
    if mm is None or mm.tp == 1:
        return TPInfo()
    return TPInfo(mm.tp, mm.tp_rank, mm.group(MODEL_AXIS))


def current() -> TPInfo:
    """The global rank mesh's ``model`` axis (tp 1 when no mesh was made
    for this world): what a model built without ``tp=`` takes."""
    from .topology import current_mesh
    return from_mesh(current_mesh())


def resolve(tp) -> TPInfo:
    """``tp`` as a ``TPInfo``: None for :func:`current`, an int 1, or a
    ``TPInfo`` as it is."""
    if tp is None:
        return current()
    if isinstance(tp, TPInfo):
        return tp
    if int(tp) == 1:
        return TPInfo()
    raise ValueError(f"tp={tp!r}: pass a TPInfo (parallel.tensor_parallel."
                     f"from_mesh(initialize_mesh(tp=...))) or 1")


def match_rule(path: str, rules):
    """The spec of the first of ``rules`` (``(regex, spec)`` pairs, a
    model's ``partition_rules()``) whose pattern is found in ``path``, or
    None."""
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return None


def rule_spec(path: str, rules, ndim: int) -> list:
    """The matching rule's spec for a leaf of ``ndim`` dims, padded with
    None on the right (all None when no rule matches)."""
    spec = match_rule(path, rules or [])
    if spec is None:
        return [None] * ndim
    spec = list(spec)
    assert len(spec) <= ndim, f"rule for {path} has rank {len(spec)} > {ndim}"
    return spec + [None] * (ndim - len(spec))


class TPSplit:
    """A parameter's tensor-parallel part: of its whole shape
    ``whole_shape``, rank ``rank`` of ``world`` holds along ``dim`` one
    contiguous block (``sections`` None) or, for each of ``sections``
    (consecutive spans of ``dim``: q, k and v of a fused projection), one
    block of that span, the blocks concatenated in section order. Span
    ``j`` splits into ``parts[j]`` blocks (default ``world``; fewer, and
    ``world`` a multiple of it, for kv heads shared by several ranks) and
    rank ``r`` holds block ``r parts[j] / world``."""

    __slots__ = ("whole_shape", "dim", "rank", "world", "sections", "parts")

    def __init__(self, whole_shape, dim: int, rank: int, world: int,
                 sections: Optional[Sequence[int]] = None,
                 parts: Optional[Sequence[int]] = None):
        self.whole_shape = tuple(int(s) for s in whole_shape)
        self.dim, self.rank, self.world = int(dim), int(rank), int(world)
        self.sections = None if sections is None else \
            [int(s) for s in sections]
        spans = self.sections or [self.whole_shape[self.dim]]
        self.parts = [self.world] * len(spans) if parts is None else \
            [int(p) for p in parts]
        if sum(spans) != self.whole_shape[self.dim] or \
                len(self.parts) != len(spans) or \
                any(s % p or self.world % p
                    for s, p in zip(spans, self.parts)):
            raise ValueError(f"dim {self.dim} of {self.whole_shape} "
                             f"(sections {spans}, parts {self.parts}) does "
                             f"not split over {self.world} ranks")

    @property
    def shared(self) -> bool:
        """Whether some block is held by more than one rank."""
        return any(p != self.world for p in self.parts)

    def _spans(self):
        return self.sections or [self.whole_shape[self.dim]]

    def _block(self, p: int) -> int:
        return self.rank * p // self.world

    @property
    def local_shape(self) -> tuple:
        shape = list(self.whole_shape)
        shape[self.dim] = sum(s // p for s, p in zip(self._spans(),
                                                     self.parts))
        return tuple(shape)

    def take(self, whole):
        """This rank's part of ``whole`` (contiguous)."""
        if self.sections is None and not self.shared:
            n = whole.shape[self.dim] // self.world
            return whole.narrow(self.dim, self.rank * n, n).contiguous()
        spans = self._spans()
        out = [sec.narrow(self.dim, self._block(p) * (s // p), s // p)
               for s, p, sec in zip(spans, self.parts,
                                    whole.split(spans, self.dim))]
        return torch.cat(out, dim=self.dim)

    def gather(self, part, group):
        """The whole tensor from every rank's ``part`` (an all-gather over
        ``group``, the ``model`` axis)."""
        full = comm.all_gather(part.detach(), group, axis=self.dim)
        if self.sections is None and not self.shared:
            return full
        return self.assemble(full.chunk(self.world, self.dim))

    def assemble(self, parts):
        """The whole tensor from every rank's part, in rank order (a shared
        block from the first rank that holds it)."""
        if self.sections is None and not self.shared:
            return torch.cat(list(parts), dim=self.dim)
        local = [s // p for s, p in zip(self._spans(), self.parts)]
        per_rank = [x.split(local, self.dim) for x in parts]
        return torch.cat([per_rank[b * self.world // p][j]
                          for j, p in enumerate(self.parts)
                          for b in range(p)], dim=self.dim)

    def owned_mask(self):
        """A bool ``[local dim]`` mask of the rank's elements along ``dim``
        that it alone counts (a shared block counts on its first rank),
        or None when the rank holds no shared block."""
        if not self.shared:
            return None
        return torch.cat([torch.full((s // p,), self.rank %
                                     (self.world // p) == 0)
                          for s, p in zip(self._spans(), self.parts)])


# --------------------------------------------------------------------------
# the collectives
# --------------------------------------------------------------------------

def _all_reduce(x, tp):
    out = x.contiguous().clone()
    comm.all_reduce(out, axis_name=tp.group)
    return out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, x.shape[-1]
        return comm.all_gather(x.contiguous(), tp.group, axis=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        n = ctx.n
        return g.narrow(-1, ctx.tp.rank * n, n).contiguous(), None


def copy_to_tp(x, tp: TPInfo):
    """Identity forward, all-reduce over the ``model`` group backward."""
    return _CopyToTP.apply(x, tp) if tp.active else x


def reduce_from_tp(x, tp: TPInfo):
    """All-reduce over the ``model`` group forward, identity backward."""
    return _ReduceFromTP.apply(x, tp) if tp.active else x


def gather_from_tp(x, tp: TPInfo):
    """Every rank's ``x`` concatenated on the last dim forward; this
    rank's slice of the gradient backward."""
    return _GatherFromTP.apply(x, tp) if tp.active else x


def vocab_parallel_embedding(ids, weight, tp: TPInfo):
    """``weight[ids]`` where ``weight`` is this rank's block of vocab rows
    (``[V / tp, D]``): rows outside the block are zero, then summed over
    the ranks."""
    if not tp.active:
        return weight[ids]
    v = weight.shape[0]
    local = ids - tp.rank * v
    inside = (local >= 0) & (local < v)
    rows = weight[torch.where(inside, local, 0)]
    return reduce_from_tp(torch.where(inside[..., None], rows, 0), tp)


def vocab_parallel_lse(m, s, tgt, tp: TPInfo):
    """A vocab-parallel NLL's per-row statistics over the whole vocab from
    each rank's over its block: the max ``m`` (all-reduced max), the sum
    of ``exp(logit - m)`` (each rank's rescaled to the common max, then
    summed) and the target logit (held by one rank, zero on the others,
    summed). Float32 ``[N]`` each; returns the three."""
    if not tp.active:
        return m, s, tgt
    big = comm.all_reduce(m.clone(), op=comm.ReduceOp.MAX,
                          axis_name=tp.group)
    stats = torch.stack([s * torch.exp(m - big), tgt])
    comm.all_reduce(stats, axis_name=tp.group)
    return big, stats[0], stats[1]


class _SumSharedGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, split, tp):
        ctx.split, ctx.tp = split, tp
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        split = ctx.split
        local = [s // p for s, p in zip(split._spans(), split.parts)]
        out = []
        for sec, p in zip(g.split(local, split.dim), split.parts):
            if p == split.world:
                out.append(sec)
                continue
            # each block's slot holds its ranks' gradients, zero elsewhere:
            # the sum over every rank is the sum over the block's ranks
            slots = sec.new_zeros((p,) + tuple(sec.shape))
            slots[split._block(p)] = sec
            comm.all_reduce(slots, axis_name=ctx.tp.group)
            out.append(slots[split._block(p)])
        return torch.cat(out, dim=split.dim), None, None


def sum_shared_grads(w, split: Optional[TPSplit], tp: TPInfo):
    """Identity forward; backward, the gradient of each block ``split``
    shares between ranks summed over those ranks (the kv heads of
    ``qkv_w`` when ``H_kv < tp``), so that every rank holding it steps
    alike."""
    if split is None or not split.shared or not torch.is_grad_enabled() \
            or not w.requires_grad:
        return w
    return _SumSharedGrads.apply(w, split, tp)
