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
L/dp)``), as the JAX mesh lays them out. Model parallelism is refused
before a planner is made (rows A8b, A11), so every rule axis other than
the dp axes has size 1 and drops out, as the JAX planner drops it.
"""

import re
from typing import Optional, Sequence, Tuple

import numpy as np

from ...parallel.topology import DATA_AXIS, DP_AXES, EXPERT_AXIS


def _match_rule(path: str, rules):
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return None


def _tp_spec(path: str, rules, ndim: int) -> list:
    """A rule's spec for the leaf, padded with None on the right."""
    spec = _match_rule(path, rules or [])
    if spec is None:
        return [None] * ndim
    spec = list(spec)
    assert len(spec) <= ndim, f"rule for {path} has rank {len(spec)} > {ndim}"
    return spec + [None] * (ndim - len(spec))


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
        spec = _tp_spec(path, self.rules, len(shape))
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
    """Where one of the port's parameters lives across the dp ranks:

    - ``replicated``: every rank holds it whole;
    - ``dim``: rank ``r`` holds slice ``[r n, (r + 1) n)`` of ``dim``;
    - ``layer``: one rank (``owner``) holds it whole, the others an empty
      tensor (a spec on a stacked leaf's layer dim).
    """

    __slots__ = ("kind", "dim", "owner", "shape", "rank", "world")

    def __init__(self, kind, shape, rank, world, dim=None, owner=None):
        self.kind, self.shape, self.rank, self.world = kind, tuple(shape), \
            rank, world
        self.dim, self.owner = dim, owner

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


def param_shards(module, planner, rank: int, world: int, stage_min: int = 1):
    """A ``ParamShard`` for each of ``module``'s parameters (aligned with
    ``named_parameters()``), from the planner's partition spec of its JAX
    leaf (``opt_spec``: the layout of the masters and moments; stage 3's
    parameters and stage 2's gradients share it); all replicated below
    stage ``stage_min``."""
    shapes = leaf_shapes(module)
    n_layers = len(getattr(module, "blocks", []))
    out = []
    for (leaf, layer), (_, p) in zip(module.jax_layout(),
                                     module.named_parameters()):
        shape = tuple(p.shape)
        spec = planner.opt_spec(leaf, shapes[leaf]) \
            if planner.stage >= stage_min else (None,) * len(shapes[leaf])
        dims = [i for i, e in enumerate(spec) if e is not None]
        if not dims:
            out.append(ParamShard("replicated", shape, rank, world))
        elif layer is None:
            out.append(ParamShard("dim", shape, rank, world, dim=dims[0]))
        elif dims[0] == 0:
            per = n_layers // world
            out.append(ParamShard("layer", shape, rank, world,
                                  owner=layer // per))
        else:
            out.append(ParamShard("dim", shape, rank, world,
                                  dim=dims[0] - 1))
    return out


def leaf_shapes(module):
    """``{JAX leaf path: shape}`` of a port model (stacked leaves
    ``[L, ...]``), from its parameters' layout."""
    shapes = {}
    for (leaf, layer), (_, p) in zip(module.jax_layout(),
                                     module.named_parameters()):
        if layer is None:
            shapes[leaf] = tuple(p.shape)
        else:
            shapes[leaf] = (len(module.blocks),) + tuple(p.shape)
    return shapes
