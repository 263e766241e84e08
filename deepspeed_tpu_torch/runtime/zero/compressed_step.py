"""The explicit (compression-aware) ZeRO exchange: the JAX package's
``runtime/zero/compressed_step.py``.

The engine's stage path (``runtime/engine.py``, ``stage3.py``) reduces
the gradients where the port's stage engine does: a weighted share of
the global loss a rank, sums over the ranks, one f32 all-reduce a step
at stages 0-1. When a ``comm_compression`` policy is active (or the
``overlap_schedule``), the engine takes this module's micro gradient
instead, which follows the JAX package's explicit ``shard_map`` exchange
and not the port's stage engine:

1. stage-3 parameter shards are gathered with ``comm.all_gather`` before
   the forward, every partitioned leaf (blockwise int8 / fp8 on the wire
   under policy: ZeRO++ qwZ);
2. the model runs on the whole parameters and the rank's own rows: its
   loss is the mean over those rows, dropout keyed
   ``fold_in(rng, dp index)`` and drawn from row 0 of the local batch;
3. every micro step exchanges every gradient in the compute dtype, an
   average over the ranks: dp-sharded leaves through
   ``comm.reduce_scatter`` (hierarchical under policy: ZeRO++ qgZ),
   replicated ones through ``comm.all_reduce`` (at stages 0-1 every leaf:
   an all-reduce a micro step); the loss is all-reduced AVG too.

Every exchange runs on the JAX package's leaf view (``jax_leaves``): a
stacked ``blocks/<leaf>`` is the ``[L, ...]`` tensor of the rank's
per-layer tensors, so the codec's blocks follow the JAX shard's layout
(a ``dim`` shard flattened in C order as its slice of the dp dim; a
``layer`` shard as the rank's layers concatenated in order), one scale
for the whole shard where its size does not divide by the block.

Scope (checked at engine init, ``explicit_scope_error``): pure data
parallelism (pp = tp = sp = ep = 1), no offload.
"""

import dataclasses
from types import SimpleNamespace
from typing import List, Optional

import torch

from ...comm import comm
from ...inference import prng
from ...parallel.topology import DATA_AXIS
from .config import _device


def _dp_dim(spec) -> int:
    """Index of the dim a spec shards over the data axis, -1 if replicated
    with respect to it."""
    for i, s in enumerate(spec):
        if s == DATA_AXIS or (isinstance(s, (tuple, list)) and
                              DATA_AXIS in s):
            return i
    return -1


def explicit_scope_error(engine, feature: str) -> Optional[str]:
    """Why the explicit ZeRO exchange cannot run under this config, or
    None (the JAX text). ``feature`` names the block that asked for it
    (``comm_compression`` or ``overlap_schedule``)."""
    mm = engine.mesh_manager
    if mm.pp > 1 or mm.tp > 1 or mm.sp > 1 or mm.ep > 1:
        return (f"{feature}: the explicit ZeRO exchange supports "
                "pure data parallelism only (pp=tp=sp=ep=1); got "
                f"pp={mm.pp} tp={mm.tp} sp={mm.sp} ep={mm.ep}. Disable "
                "the block or drop the model-parallel axes")
    zc = engine._config.zero_config
    if _device(zc.offload_optimizer) != "none" or \
            _device(zc.offload_param) != "none":
        return (f"{feature}: not supported together with "
                "ZeRO-Offload / param offload (the offload runners own "
                "their own step functions)")
    return None


@dataclasses.dataclass
class JaxLeaf:
    """One leaf of the JAX parameter tree, as the port holds it."""
    name: str            # "wte", "blocks/qkv_w"
    path: str            # jax.tree_util.keystr of it
    idx: List[int]       # the port's parameter indices, in layer order
    stacked: bool        # a blocks/<leaf> [L, ...]
    shape: tuple         # the whole JAX shape
    gdim: int            # dp dim of its parameter spec (-1: replicated)
    sdim: int            # dp dim of its gradient spec


def jax_leaves(engine) -> List[JaxLeaf]:
    """The engine's parameters as the JAX tree's leaves, in
    ``jax.tree.leaves`` order (dict keys sorted at every level), with the
    planner's dp dims of their parameter and gradient specs."""
    groups = {}
    for i, (leaf, layer) in enumerate(engine._layout):
        groups.setdefault(leaf, []).append((-1 if layer is None else layer,
                                            i))
    out = []
    for name in sorted(groups, key=lambda n: tuple(n.split("/"))):
        parts = name.split("/")
        idx = [i for _, i in sorted(groups[name])]
        # the engine's whole shapes (stage 3 empties the module's tensors)
        shape = tuple(engine._shapes[idx[0]])
        if len(parts) > 1:
            shape = (len(idx),) + shape
        out.append(JaxLeaf(
            name=name, path="".join(f"['{p}']" for p in parts),
            idx=idx, stacked=len(parts) > 1, shape=shape,
            gdim=_dp_dim(engine.planner.param_spec(name, shape)),
            sdim=_dp_dim(engine.planner.grad_spec(name, shape))))
    return out


class ExplicitExchange:
    """The per-leaf explicit micro gradient of one engine. ``inputs``
    makes a micro step's parameters (gathering stage 3's); ``loss`` runs
    the model on them; ``backward`` differentiates, exchanges and returns
    the rank's gradients (aligned with the engine's parameters, its shards
    where they are partitioned) and the averaged loss."""

    def __init__(self, engine):
        self.engine = engine
        self.leaves = jax_leaves(engine)
        self.pshards = engine._pshards
        self.names = engine._names

    # -- the leaf view of the rank's tensors
    def owned(self, leaf: JaxLeaf, dim: int) -> List[int]:
        """The parameter indices whose tensors form the rank's part of a
        leaf partitioned on ``dim``: every layer, or (a stacked leaf
        partitioned on its layer dim) the rank's own layers."""
        if leaf.stacked and dim == 0:
            return [i for i in leaf.idx
                    if self.pshards[i].rank == self.pshards[i].owner]
        return list(leaf.idx)

    def stack(self, leaf: JaxLeaf, tensors, dim: int = -1):
        """The leaf's tensor from per-parameter ``tensors`` (a dict by
        parameter index): the rank's shard on ``dim`` (or the whole leaf
        for -1), a stacked leaf ``[L or L/n, ...]``."""
        idx = self.owned(leaf, dim) if dim >= 0 else leaf.idx
        if not leaf.stacked:
            return tensors[idx[0]]
        return torch.stack([tensors[i] for i in idx])

    def unstack(self, leaf: JaxLeaf, value, dim: int = -1):
        """``{parameter index: tensor}`` of a leaf's tensor (the inverse of
        ``stack``); a layer-partitioned leaf's other layers get empty
        tensors, as their shards are."""
        if not leaf.stacked:
            return {leaf.idx[0]: value}
        idx = self.owned(leaf, dim) if dim >= 0 else leaf.idx
        out = {i: t for i, t in zip(idx, value.unbind(0))}
        for i in leaf.idx:
            if i not in out:
                out[i] = value.new_empty((0,))
        return out

    # -- one micro step
    def inputs(self, pc):
        """``(name map for functional_call, state)``: stage 3's
        partitioned leaves gathered whole (per leaf, before the forward),
        as fresh leaves the backward differentiates."""
        by_idx = {i: pc[n] for i, n in enumerate(self.names)}
        full = dict(by_idx)
        for leaf in self.leaves:
            if leaf.gdim < 0:
                continue
            with torch.no_grad():
                g = comm.all_gather(self.stack(leaf, by_idx, leaf.gdim)
                                    .detach(), DATA_AXIS, axis=leaf.gdim)
            for i, t in self.unstack(leaf, g).items():
                full[i] = t.requires_grad_()
        names_map = {self.names[i]: t for i, t in full.items()}
        return names_map, None, SimpleNamespace(full=full)

    def rng(self, rng):
        """The rank's key: ``fold_in(rng, dp index)``."""
        return None if rng is None else prng.fold_in_words(
            rng, self.engine._dp_rank)

    def backward(self, scaled_loss, state):
        """Differentiate ``scaled_loss`` (the rank's mean times the loss
        scale) with respect to the step's parameters and exchange every
        gradient (AVG over the ranks): ``(per-parameter gradients, the
        averaged scaled loss)``."""
        order = list(range(len(self.names)))
        params = [state.full[i] for i in order]
        grads = torch.autograd.grad(scaled_loss, params, allow_unused=True)
        grads = {i: torch.zeros_like(p) if g is None else g
                 for i, p, g in zip(order, params, grads)}
        out = {}
        for leaf in self.leaves:
            g = self.stack(leaf, grads)
            if leaf.sdim < 0:
                r = comm.all_reduce(g.contiguous(), op=comm.ReduceOp.AVG,
                                    axis_name=DATA_AXIS)
                out.update(self.unstack(leaf, r))
            else:
                r = comm.reduce_scatter(g, DATA_AXIS, axis=leaf.sdim,
                                        op=comm.ReduceOp.AVG)
                out.update(self.unstack(leaf, r.contiguous(), leaf.sdim))
        loss = comm.all_reduce(scaled_loss.detach().reshape(1).clone(),
                               op=comm.ReduceOp.AVG,
                               axis_name=DATA_AXIS)[0]
        return [out[i].contiguous() for i in order], loss


def make_compressed_micro_grad(engine):
    """The engine's per-leaf explicit exchange."""
    return ExplicitExchange(engine)
