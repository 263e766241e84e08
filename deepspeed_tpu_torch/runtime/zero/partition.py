"""ZeRO as a per-leaf partition rule: the JAX package's
``runtime/zero/partition.py``, over ranks.

The JAX package expresses each stage as where each leaf of its parameter
tree lives on the mesh, and GSPMD inserts the gathers and reduce-scatters.
The planner here is its rule, applied to the same tree (the JAX tree's
shapes: GPT-2's ``blocks/qkv_w`` is ``[L, d, 3d]``):

  stage 1: optimizer state sharded over the dp axes;
  stage 2: + gradients;
  stage 3: + parameters, except leaves under
           ``stage3_param_persistence_threshold`` elements (counted on
           the stacked leaf), which stay replicated.

A sharded leaf takes the largest still-free dim that divides by the dp
world (``_add_dp_axis``). The engine then holds each of the port's
per-layer parameters as a ``ParamShard``: a spec on a stacked leaf's dim
``k + 1`` shards the per-layer tensor's dim ``k``; a spec on the layer dim
gives whole layers to ranks (rank ``r`` owns layers ``[r L/dp, (r + 1)
L/dp)``), as the JAX mesh lays them out. The rules are the model's
``partition_rules()``: at tp > 1 their ``model`` entries stay (the
planner drops the entries of size-1 axes, as the JAX one does), so a leaf
can be sharded on ``model`` and on the dp axes at once, on two dims.
``ParamShard`` then composes the two: a rank's part is its tensor-parallel
part (the model's ``TPSplit``, which for the fused ``qkv`` leaves is the
rank's heads of each of q, k and v, not the rule's block of columns)
first, and the dp part of that second.
"""

from typing import Optional, Sequence, Tuple

import numpy as np

from ...parallel.tensor_parallel import rule_spec
from ...parallel.topology import DATA_AXIS, DP_AXES, EXPERT_AXIS, MODEL_AXIS


def _uses_axis(spec: list, axis: str) -> bool:
    return any(s == axis or (isinstance(s, (tuple, list)) and axis in s)
               for s in spec)


def _add_dp_axis(spec: list, shape: Tuple[int, ...], dp_axes, dp_world: int,
                 min_size: int) -> list:
    """Shard the largest still-free, dp-divisible dim over the dp axes."""
    if int(np.prod(shape or (1,))) < max(min_size, dp_world):
        return spec
    best = None
    for i, (s, dim) in enumerate(zip(spec, shape)):
        if s is None and dim % dp_world == 0:
            if best is None or dim > shape[best]:
                best = i
    if best is not None:
        spec[best] = dp_axes
    return spec


def spec_str(spec) -> str:
    """A spec as the JAX package prints a ``PartitionSpec``."""
    return "PartitionSpec" + repr(tuple(spec))


class ZeroShardingPlanner:
    """Per-leaf specs for params, grads and optimizer state, as tuples of
    entries (None, or the tuple of dp axes)."""

    def __init__(self, mesh_manager, stage: int,
                 rules: Optional[Sequence] = None,
                 persistence_threshold: int = 0):
        self.mm = mesh_manager
        self.stage = stage
        self.persistence_threshold = persistence_threshold

        # entries naming a size-1 axis become None, as in the JAX planner
        def _live(entry):
            if entry is None:
                return None
            if isinstance(entry, (tuple, list)):
                kept = tuple(a for a in entry if self.mm.axis_size(a) > 1)
                return kept if kept else None
            return entry if self.mm.axis_size(entry) > 1 else None

        self.rules = [(pat, tuple(_live(e) for e in spec))
                      for pat, spec in (rules or [])]

    def _leaf_spec(self, path: str, shape, dp_sharded: bool) -> tuple:
        spec = rule_spec(path, self.rules, len(shape))
        if dp_sharded:
            if _uses_axis(spec, EXPERT_AXIS):
                dp_axes, dp_world = DATA_AXIS, self.mm.dp
            else:
                dp_axes, dp_world = DP_AXES, self.mm.dp_world_size
            if dp_world > 1:
                spec = _add_dp_axis(spec, tuple(shape), dp_axes, dp_world,
                                    self.persistence_threshold)
        return tuple(spec)

    def param_spec(self, path: str, shape) -> tuple:
        return self._leaf_spec(path, shape, dp_sharded=self.stage >= 3)

    def grad_spec(self, path: str, shape) -> tuple:
        return self._leaf_spec(path, shape, dp_sharded=self.stage >= 2)

    def opt_spec(self, path: str, shape) -> tuple:
        return self._leaf_spec(path, shape, dp_sharded=self.stage >= 1)

    def describe(self, shapes):
        """``[(path, shape, spec string)]`` of a ``{path: shape}`` map, as
        the JAX planner's ``describe`` prints its table."""
        return [(path, tuple(shape), spec_str(self.param_spec(path, shape)))
                for path, shape in shapes.items()]


class ParamShard:
    """Where one of the port's parameters lives across the ranks. Over the
    dp ranks, of the model's tensor ``shape`` (the rank's tensor-parallel
    part at tp > 1):

    - ``replicated``: every rank holds it whole;
    - ``dim``: rank ``r`` holds slice ``[r n, (r + 1) n)`` of ``dim``;
    - ``layer``: one rank (``owner``) holds it whole, the others an empty
      tensor (a spec on a stacked leaf's layer dim).

    ``tp``: the parameter's ``TPSplit`` (None when the tp ranks hold it
    whole). ``take``, ``gather`` and ``reduce`` act over the dp ranks on
    the model's tensor; ``take_whole`` and ``gather_whole`` map the whole
    (JAX) tensor, the tp part first and the dp part of it second.
    """

    __slots__ = ("kind", "dim", "owner", "shape", "rank", "world", "tp")

    def __init__(self, kind, shape, rank, world, dim=None, owner=None,
                 tp=None):
        self.kind, self.shape, self.rank, self.world = kind, tuple(shape), \
            rank, world
        self.dim, self.owner, self.tp = dim, owner, tp

    @property
    def whole_shape(self) -> tuple:
        """The JAX leaf's (per-layer) shape."""
        return self.shape if self.tp is None else self.tp.whole_shape

    @property
    def partitioned(self) -> bool:
        return self.kind != "replicated"

    @property
    def local_shape(self) -> tuple:
        if self.kind == "dim":
            shape = list(self.shape)
            shape[self.dim] //= self.world
            return tuple(shape)
        if self.kind == "layer" and self.rank != self.owner:
            return (0,)
        return self.shape

    def take(self, full):
        """This rank's part of the whole tensor ``full`` (contiguous)."""
        if self.kind == "dim":
            n = self.shape[self.dim] // self.world
            return full.narrow(self.dim, self.rank * n, n).contiguous()
        if self.kind == "layer" and self.rank != self.owner:
            return full.new_empty((0,))
        return full

    def gather(self, part, group):
        """The whole tensor from every rank's ``part`` (a collective over
        ``group`` for a partitioned parameter)."""
        from ...comm import comm
        if self.kind == "dim":
            return comm.all_gather(part, group, axis=self.dim)
        if self.kind == "layer":
            full = part.clone() if self.rank == self.owner else \
                part.new_empty(self.shape)
            return comm.broadcast(full, self.owner, group)
        return part

    def reduce(self, full, group):
        """This rank's part of the sum over ranks of ``full``."""
        from ...comm import comm
        if self.kind == "dim":
            return comm.reduce_scatter(full, group, axis=self.dim).contiguous()
        comm.all_reduce(full, axis_name=group)
        return self.take(full)

    def take_tp(self, whole):
        """The rank's tensor-parallel part of the whole tensor (the model's
        tensor)."""
        return whole if self.tp is None else self.tp.take(whole)

    def take_whole(self, whole):
        """The rank's part of the whole (JAX) tensor: the tensor-parallel
        part first, then the dp part of that."""
        return self.take(self.take_tp(whole))

    def gather_whole(self, part, dp_group, tp_group):
        """The whole (JAX) tensor from every rank's ``part``: gathered over
        the dp ranks, then over the tp ranks (collectives)."""
        x = self.gather(part, dp_group) if self.partitioned else part
        return x if self.tp is None else self.tp.gather(x, tp_group)


def param_shards(module, planner, rank: int, world: int, stage_min: int = 1):
    """A ``ParamShard`` for each of ``module``'s parameters (aligned with
    ``named_parameters()``), from the planner's partition spec of its JAX
    leaf (``opt_spec``: the layout of the masters and moments; stage 3's
    parameters and stage 2's gradients share it); all replicated below
    stage ``stage_min``. Each carries the parameter's ``TPSplit``; the dp
    dim is the spec's dp entry (the ``model`` entry is the split's)."""
    shapes = leaf_shapes(module)
    n_layers = len(getattr(module, "blocks", []))
    out = []
    for (leaf, layer), (_, p), split in zip(module.jax_layout(),
                                            module.named_parameters(),
                                            module.tp_splits()):
        shape = tuple(p.shape)
        spec = planner.opt_spec(leaf, shapes[leaf]) \
            if planner.stage >= stage_min else (None,) * len(shapes[leaf])
        dims = [i for i, e in enumerate(spec)
                if e is not None and e != MODEL_AXIS]
        if not dims:
            ps = ParamShard("replicated", shape, rank, world, tp=split)
        elif layer is None:
            ps = ParamShard("dim", shape, rank, world, dim=dims[0], tp=split)
        elif dims[0] == 0:
            per = n_layers // world
            ps = ParamShard("layer", shape, rank, world, owner=layer // per,
                            tp=split)
        else:
            ps = ParamShard("dim", shape, rank, world, dim=dims[0] - 1,
                            tp=split)
        out.append(ps)
    return out


def leaf_shapes(module):
    """``{JAX leaf path: shape}`` of a port model (stacked leaves
    ``[L, ...]``), from its parameters' layout: whole shapes, also at
    tp > 1."""
    shapes = {}
    for (leaf, layer), shape in zip(module.jax_layout(),
                                    module.whole_shapes()):
        if layer is None:
            shapes[leaf] = tuple(shape)
        else:
            shapes[leaf] = (len(module.blocks),) + tuple(shape)
    return shapes
