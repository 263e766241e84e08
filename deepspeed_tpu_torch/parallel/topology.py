"""The rank topology: the JAX package's ``parallel/topology.py`` over
``torch.distributed`` ranks instead of devices.

The axis order is the JAX package's, outer to inner:

    ('pipe', 'data', 'expert', 'seq', 'model')

Rank ``r`` sits at ``ProcessTopology``'s grid coordinate of ``r`` (the same
numpy grid), so a rank's data-parallel index is the JAX mesh's device index
along ``data``. ``data`` x ``expert`` form the data-parallel world that
ZeRO shards over (``DP_AXES``); ``dp_world_size`` is ``dp * ep``.
``model`` is the innermost axis: rank ``r``'s tensor-parallel index is its
coordinate there, so a tp group is ``tp`` consecutive ranks, and the tp
ranks of one dp index read the same rows of a batch. The manager makes
one process group for each slice of each axis of more than
one rank (every rank calls ``new_group`` for every slice, in the same
order, as torch requires); an axis slice that is the whole world uses the
default group (but for ``model``, which always has its own group, so
that ``comm_axis_stats("model")`` counts the tensor-parallel collectives),
and a one-rank axis needs no group: its collectives are the identity.

What runs here: the ``data`` and ``model`` axes (the models' tensor
parallelism: ``parallel/tensor_parallel.py``); ``pp``, ``sp`` or ``ep``
above 1 name ROADMAP.md row A11, as the config does.

The hierarchical (host, local) split of an axis (the two-level
reduce-scatter of ``comm/quantized.py``): ``hierarchical_axis_groups``
gives the JAX package's member lists (intra: ``local`` consecutive
members, host-major; inter: the members at one local offset across the
hosts), ``data_host_groups`` those of the ``data`` axis, and
``host_process_groups`` turns them into process groups: every rank makes
the groups of every slice of the axis, in the same order, once per
(axis, local), as torch requires.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
MESH_AXES = (PIPE_AXIS, DATA_AXIS, EXPERT_AXIS, SEQ_AXIS, MODEL_AXIS)

# the composite data-parallel axes ZeRO shards over
DP_AXES = (DATA_AXIS, EXPERT_AXIS)


def hierarchical_axis_groups(axis_size: int, devices_per_host: int):
    """Split a flat axis of ``axis_size`` members into (host, local)
    subaxes: ``(intra_groups, inter_groups)`` as member-index lists. Intra
    groups hold the ``devices_per_host`` consecutive members of one host
    (host-major member order); inter groups hold the members at the same
    local offset across hosts. ``(None, None)`` when no split exists
    (``devices_per_host`` <= 1, >= ``axis_size``, or not a divisor)."""
    local = int(devices_per_host)
    if local <= 1 or local >= axis_size or axis_size % local:
        return None, None
    hosts = axis_size // local
    intra = [[h * local + l for l in range(local)] for h in range(hosts)]
    inter = [[h * local + l for h in range(hosts)] for l in range(local)]
    return intra, inter


class ProcessTopology:
    """Named-axis cartesian topology over ranks (the JAX package's numpy
    grid, reference ``pipe/topology.py:12``)."""

    def __init__(self, axes: Sequence[str], dims: Sequence[int]):
        assert len(axes) == len(dims)
        self.axes = list(axes)
        self.dims = list(int(d) for d in dims)
        self._grid = np.arange(int(np.prod(self.dims))).reshape(self.dims)

    def get_rank(self, **coords) -> int:
        idx = tuple(coords[a] for a in self.axes)
        return int(self._grid[idx])

    def get_coord(self, rank: int):
        pos = np.argwhere(self._grid == rank)[0]
        return dict(zip(self.axes, (int(p) for p in pos)))

    def get_dim(self, axis: str) -> int:
        return self.dims[self.axes.index(axis)]

    def get_axis_names(self) -> List[str]:
        return list(self.axes)

    def world_size(self) -> int:
        return int(np.prod(self.dims))

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """Every group of ranks that differ only along ``axis``."""
        ax = self.axes.index(axis)
        moved = np.moveaxis(self._grid, ax, -1).reshape(-1, self.dims[ax])
        return [list(map(int, row)) for row in moved]

    def get_axes_comm_lists(self, axes: Sequence[str]) -> List[List[int]]:
        """Every group of ranks that differ only along ``axes`` (in grid
        order: the first axis outermost)."""
        idx = [self.axes.index(a) for a in axes]
        moved = np.moveaxis(self._grid, idx, list(range(-len(idx), 0)))
        size = int(np.prod([self.dims[i] for i in idx]))
        return [list(map(int, row)) for row in moved.reshape(-1, size)]

    def filter_match(self, **coords) -> List[int]:
        return [r for r in range(self.world_size())
                if all(self.get_coord(r)[k] == v for k, v in coords.items())]


def _refuse(pp, ep, sp):
    for name, size in (("pipeline", pp), ("expert", ep), ("sequence", sp)):
        if size > 1:
            raise NotImplementedError(
                f"{name} parallelism ({name[0]}p={size}) is not ported yet: "
                f"ROADMAP.md row A11")


class DeviceMeshManager:
    """The rank mesh and its process groups: one rank a device. The JAX
    package's ``DeviceMeshManager`` surface (sizes, ``batch_spec``) with
    ``group(axis)`` in place of a ``jax.sharding.Mesh``."""

    def __init__(self, pp: int = 1, dp: Optional[int] = None, ep: int = 1,
                 sp: int = 1, tp: int = 1, world_size: Optional[int] = None,
                 rank: Optional[int] = None):
        from ..comm import comm
        _refuse(pp, ep, sp)
        n = comm.get_world_size() if world_size is None else int(world_size)
        fixed = pp * ep * sp * tp
        if dp is None:
            if n % fixed:
                raise ValueError(
                    f"{n} ranks not divisible by pp*ep*sp*tp={fixed}")
            dp = n // fixed
        total = pp * dp * ep * sp * tp
        if total != n:
            raise ValueError(
                f"mesh {pp}x{dp}x{ep}x{sp}x{tp}={total} != world size {n}")
        self.topology = ProcessTopology(MESH_AXES, (pp, dp, ep, sp, tp))
        self.pp, self.dp, self.ep, self.sp, self.tp = pp, dp, ep, sp, tp
        self.world_size = n
        self.rank = comm.get_rank() if rank is None else int(rank)
        self.coords = self.topology.get_coord(self.rank)
        self._groups: Dict[tuple, object] = {}
        self._host_groups: Dict[tuple, tuple] = {}
        self._build_groups()

    def _build_groups(self):
        """A process group for every slice of more than one rank of each
        axis and of ``DP_AXES``; all ranks make them in the same order."""
        from ..comm import comm
        for axes in [(a,) for a in MESH_AXES] + [DP_AXES]:
            lists = self.topology.get_axes_comm_lists(axes)
            size = len(lists[0])
            if size == 1 or not comm.is_initialized():
                self._groups[axes] = comm.SINGLE
                continue
            if size == self.world_size and axes != (MODEL_AXIS,):
                # the default group; the model axis keeps a group of its
                # own, so its collectives are accounted under its name
                self._groups[axes] = None
                continue
            for ranks in lists:
                g = comm.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axes] = g
                    comm.name_group(g, axes[0] if len(axes) == 1 else axes)

    # ---- sizes ----
    @property
    def dp_world_size(self) -> int:
        """The full data-parallel degree (data x expert)."""
        return self.dp * self.ep

    @property
    def dp_rank(self) -> int:
        """This rank's index in the data-parallel world."""
        return self.coords[DATA_AXIS] * self.ep + self.coords[EXPERT_AXIS]

    @property
    def tp_rank(self) -> int:
        """This rank's index on the ``model`` axis."""
        return self.coords[MODEL_AXIS]

    def axis_size(self, axis: str) -> int:
        return self.topology.get_dim(axis)

    def group(self, axis):
        """The process group of ``axis`` (a name or a tuple of names) that
        holds this rank: None for the default group, ``comm.SINGLE`` for
        one rank."""
        key = (axis,) if isinstance(axis, str) else tuple(axis)
        if key not in self._groups:
            raise KeyError(f"no process group for mesh axes {key}; the "
                           f"axes are {MESH_AXES}")
        return self._groups[key]

    def data_host_groups(self, devices_per_host: int = 0):
        """``(intra, inter)`` member lists splitting the ``data`` axis into
        (host, local) subaxes; ``devices_per_host`` 0 = the launcher's
        ``LOCAL_WORLD_SIZE``."""
        if devices_per_host == 0:
            import os
            devices_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", 1) or 1)
        return hierarchical_axis_groups(self.axis_size(DATA_AXIS),
                                        devices_per_host)

    def host_process_groups(self, axis, local: int):
        """``(intra, inter)`` process groups of this rank for the (host,
        local) split of ``axis`` (a mesh axis name or tuple of names, or
        None for the world) with ``local`` members a host; ``(None,
        None)`` when the split does not exist. The groups are made at the
        first call for an (axis, local), by every rank (a collective)."""
        from ..comm import comm
        if axis is None:
            lists = [list(range(self.world_size))]
        elif isinstance(axis, (str, tuple, list)):
            axes = (axis,) if isinstance(axis, str) else tuple(axis)
            lists = self.topology.get_axes_comm_lists(axes)
        else:
            raise ValueError("a hierarchical exchange needs a mesh axis "
                             "name (or None for the world), not a process "
                             "group")
        key = (str(axis), int(local))
        if key in self._host_groups:
            return self._host_groups[key]
        intra_l, inter_l = hierarchical_axis_groups(len(lists[0]), local)
        found = (None, None)
        if intra_l is not None:
            intra = inter = None
            for ranks in lists:
                for members in intra_l:
                    g = comm.new_group([ranks[m] for m in members])
                    if self.rank in [ranks[m] for m in members]:
                        intra = g
                        comm.name_group(g, f"{axis}:intra")
                for members in inter_l:
                    g = comm.new_group([ranks[m] for m in members])
                    if self.rank in [ranks[m] for m in members]:
                        inter = g
                        comm.name_group(g, f"{axis}:inter")
            found = (intra, inter)
        self._host_groups[key] = found
        return found

    def batch_spec(self, shard_seq: bool = True):
        """The batch dim over the dp axes (the JAX package's
        ``P(DP_AXES)``, as a tuple of entries)."""
        return (DP_AXES,)


_MESH_MANAGER: Optional[DeviceMeshManager] = None


def initialize_mesh(pp=1, dp=None, ep=1, sp=1, tp=1, world_size=None,
                    rank=None) -> DeviceMeshManager:
    """Make (or replace) the global rank mesh over the default process
    group (every rank calls it)."""
    global _MESH_MANAGER
    _MESH_MANAGER = DeviceMeshManager(pp=pp, dp=dp, ep=ep, sp=sp, tp=tp,
                                      world_size=world_size, rank=rank)
    return _MESH_MANAGER


def get_mesh_manager() -> DeviceMeshManager:
    """The global rank mesh; a data-parallel one over the whole world when
    none was made."""
    global _MESH_MANAGER
    from ..comm import comm
    if _MESH_MANAGER is None or (
            _MESH_MANAGER.world_size != comm.get_world_size()):
        _MESH_MANAGER = DeviceMeshManager()
    return _MESH_MANAGER


def current_mesh() -> Optional[DeviceMeshManager]:
    """The global rank mesh when one was made for this world, else None
    (nothing is made)."""
    from ..comm import comm
    if _MESH_MANAGER is None or (
            _MESH_MANAGER.world_size != comm.get_world_size()):
        return None
    return _MESH_MANAGER


def reset_mesh():
    global _MESH_MANAGER
    _MESH_MANAGER = None


def mesh_for_tp(tp: int) -> DeviceMeshManager:
    """The global rank mesh when one was made for this world with ``tp``
    on its ``model`` axis, else a new global one at ``tp`` (every rank
    calls it)."""
    mm = current_mesh()
    if mm is None or mm.tp != tp:
        mm = initialize_mesh(tp=tp)
    return mm
