"""ZeRO stage 3: per-layer parameter gathers on the port's layer loops.

The JAX package shards the parameters and lets XLA insert an all-gather
of each layer's leaves inside the layer scan (and a reduce-scatter of
their gradients). Here the engine holds only its shard of each
partitioned leaf, and the model's layer loop asks for a layer's leaves
through ``ModelSpec._layer_leaves``: under stage 3 that returns a
``LayerLeaves`` handle, and the loop runs the layer inside
``handle.gathered(...)``, which

- gathers the layer's partitioned leaves (one coalesced all-gather, in
  the compute dtype) through ``_Gather``, an autograd ``Function`` whose
  backward reduce-scatters the layer's full gradients into the shards;
- while the layer runs, packs every tensor autograd saves that lies in a
  gathered leaf's storage (the weights a matmul keeps for its backward)
  as a handle, through ``torch.autograd.graph.saved_tensors_hooks``, so
  the gathered leaves are freed when the layer returns. The backward
  unpacks a handle by gathering the layer again (once, kept until the
  layer's ``_Gather`` backward has run).

Under activation checkpointing with recompute the hooks stay off: the
checkpoint keeps none of the layer's tensors and its recompute calls
``gathered`` again, which gathers again. Top-level partitioned leaves
(embeddings, the LM head) are gathered once a micro step, before the
forward, through the same ``_Gather``, and live until its backward.

Persistent (replicated) leaves are not gathered: the engine hands them to
``functional_call`` by name, as at stage 0. ``GatherStats`` counts the
gathered bytes alive (forward gathers are counted until their tensors
are freed, backward regathers until the layer's gradients are reduced)
and their peak; the comms logger gives the collectives' bytes.
"""

import contextlib
import weakref
from types import SimpleNamespace

import torch

from ...comm import comm


class GatherStats:
    """Gathered parameter bytes alive now (``live``) and their peak
    (``peak``), also for the layer leaves alone (``live_layers``,
    ``peak_layers``), and the number of gathers (``gathers``, and
    ``regathers`` in the backward)."""

    def __init__(self):
        self.live = self.peak = 0
        self.live_layers = self.peak_layers = 0
        self.gathers = self.regathers = 0

    def add(self, nbytes, layer):
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        if layer:
            self.live_layers += nbytes
            self.peak_layers = max(self.peak_layers, self.live_layers)

    def sub(self, nbytes, layer):
        self.live -= nbytes
        if layer:
            self.live_layers -= nbytes

    def as_dict(self):
        return dict(vars(self))


class LeafGroup:
    """The partitioned leaves gathered together (one layer's, or the
    top-level ones): their shards, ``ParamShard``s and names, and the
    collectives over the dp group."""

    def __init__(self, names, shards, pshards, group, stats, layer):
        self.names, self.shards, self.pshards = names, shards, pshards
        self.group, self.stats, self.layer = group, stats, layer
        self._cache = None

    def gather(self, shards):
        """Whole tensors from the shards: one coalesced all-gather for the
        leaves sharded on a dim, a broadcast from its owner for a leaf
        held whole by one rank."""
        out = [None] * len(shards)
        dim_idx = [i for i, ps in enumerate(self.pshards) if ps.kind == "dim"]
        if dim_idx:
            full = comm.all_gather_coalesced(
                [shards[i] for i in dim_idx], self.group,
                axes=[self.pshards[i].dim for i in dim_idx])
            for i, t in zip(dim_idx, full):
                out[i] = t
        for i, ps in enumerate(self.pshards):
            if out[i] is None:
                out[i] = ps.gather(shards[i], self.group)
        return out

    def reduce(self, grads):
        """The shards' part of the sum over ranks of the whole gradients."""
        out = [None] * len(grads)
        dim_idx = [i for i, ps in enumerate(self.pshards) if ps.kind == "dim"]
        if dim_idx:
            parts = comm.reduce_scatter_coalesced(
                [grads[i] for i in dim_idx], self.group,
                axes=[self.pshards[i].dim for i in dim_idx])
            for i, t in zip(dim_idx, parts):
                out[i] = t.contiguous()
        for i, ps in enumerate(self.pshards):
            if out[i] is None:
                out[i] = ps.reduce(grads[i], self.group)
        return out

    def nbytes(self):
        """The bytes of the group's whole leaves."""
        return sum(torch.Size(ps.shape).numel() * s.element_size()
                   for ps, s in zip(self.pshards, self.shards))

    # -- the backward's regather, kept until the layer's grads are reduced
    def regathered(self):
        if self._cache is None:
            with torch.no_grad():
                self._cache = self.gather([s.detach() for s in self.shards])
            self.stats.regathers += 1
            self.stats.add(self.nbytes(), self.layer)
        return self._cache

    def release(self):
        if self._cache is not None:
            self._cache = None
            self.stats.sub(self.nbytes(), self.layer)


class _Gather(torch.autograd.Function):
    """Shards -> whole leaves; the backward reduce-scatters the whole
    gradients into the shards' gradients (and drops the layer's regather)."""

    @staticmethod
    def forward(ctx, lg, *shards):
        ctx.lg = lg
        return tuple(lg.gather(list(shards)))

    @staticmethod
    def backward(ctx, *grads):
        lg = ctx.lg
        out = lg.reduce(list(grads))
        lg.release()
        return (None,) + tuple(out)


def gather_leaves(lg: LeafGroup):
    """The group's whole leaves (on the autograd graph of its shards),
    counted alive in ``lg.stats`` until the tensors are freed."""
    full = _Gather.apply(lg, *lg.shards)
    lg.stats.gathers += 1
    for t in full:
        nbytes = t.numel() * t.element_size()
        lg.stats.add(nbytes, lg.layer)
        weakref.finalize(t, lg.stats.sub, nbytes, lg.layer)
    return list(full)


class _Packed:
    __slots__ = ("lg", "index", "size", "stride", "offset")

    def __init__(self, lg, index, t):
        self.lg, self.index = lg, index
        self.size, self.stride = tuple(t.size()), tuple(t.stride())
        self.offset = t.storage_offset()


class LayerLeaves:
    """One layer's leaves under stage 3: the replicated ones as they are,
    the partitioned ones as a ``LeafGroup`` to gather. Open it with
    ``gathered(recomputed)``."""

    def __init__(self, replicated, lg: LeafGroup):
        self.replicated, self.lg = replicated, lg

    @contextlib.contextmanager
    def gathered(self, recomputed: bool = False):
        """The layer's leaves, whole, as a namespace, for the ``with``
        block. Unless the layer runs under a recomputing checkpoint
        (``recomputed``), tensors autograd saves in the gathered storage
        are packed as handles and gathered again in the backward."""
        lg = self.lg
        full = gather_leaves(lg)
        leaves = SimpleNamespace(**self.replicated,
                                 **dict(zip(lg.names, full)))
        if recomputed or not torch.is_grad_enabled():
            yield leaves
            return
        ptrs = {t.untyped_storage().data_ptr(): i for i, t in enumerate(full)}
        device = full[0].device if full else None

        def pack(t):
            i = ptrs.get(t.untyped_storage().data_ptr()) \
                if t.device == device else None
            return t if i is None else _Packed(lg, i, t)

        def unpack(h):
            if not isinstance(h, _Packed):
                return h
            whole = h.lg.regathered()[h.index]
            return whole.as_strided(h.size, h.stride, h.offset)

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield leaves
        del full, leaves
