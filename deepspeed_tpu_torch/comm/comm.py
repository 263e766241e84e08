"""deepspeed_tpu_torch.comm — the communication layer, the JAX package's
``comm/comm.py`` over ``torch.distributed``.

Two planes, as in the JAX package:

1. **Host plane**: ``init_distributed`` makes the process group, reading
   the launcher's ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` /
   ``MASTER_PORT`` and the OMPI and SLURM variables as the JAX package
   does; ``get_rank``, ``get_world_size``, ``barrier`` and
   ``broadcast_object``. The backend is ``nccl`` when the device is
   ``cuda`` (the default) and ``gloo`` when the caller asks for the CPU;
   there is no fall-back from one to the other. A caller may also ask for
   ``gloo`` on ``cuda``: gloo carries CUDA tensors through host memory,
   which is how several ranks share one card (NCCL refuses two ranks on
   one device).
2. **Collectives** on process groups: ``all_reduce``, ``all_gather``,
   ``reduce_scatter``, their coalesced forms, ``all_to_all``,
   ``broadcast``, ``ppermute`` and the reference's names (``reduce``,
   ``gather``, ``scatter``, the ``*_into_tensor`` aliases). An
   ``axis_name`` (``"data"``, ``("data", "expert")``, ...) names the
   process group of that mesh axis in the port's rank topology
   (``parallel/topology.py``); a ``ProcessGroup`` is taken as it is.
   They are functional, as the JAX package's: each returns its result
   (``all_reduce`` and ``broadcast`` also write it into their input, as
   torch's do). Rooted ops keep the JAX package's superset semantics:
   every member gets the result.

Without a process group the world is one rank and every collective is the
identity. Every collective goes through one accounting point: the wire
bytes a ring implementation puts on each member's links (the JAX
package's ``_BASE_WIRE`` model), into ``comm_stats`` / ``comm_per_op_stats``,
the comms logger and a tracer span, and by mesh axis into
``comm_axis_stats``; the wire bytes are split into intra-host and
inter-host bytes where a (host, local) split is known.

Compression (``comm_compression``, ``comm/compression.py``): each call
makes one dispatch decision from the process-global policy. Under
``int8`` / ``fp8_block`` the collective runs its quantized form
(``comm/quantized.py``: blockwise payloads + f32 scales, the
reduce-scatter two-level when ``hierarchical``) and accounts the JAX
package's wire-byte model of it; ``off`` and ``fp32`` run the plain
``torch.distributed`` call. Host-driven point-to-point (``isend`` /
``recv``) raises, as in the JAX package.
"""

import contextlib
import datetime
import os
import threading
from typing import Optional, Sequence

import torch

from ..telemetry.trace import get_tracer
from ..utils.logging import logger
from .compression import (configure_comm_compression,  # noqa: F401
                          get_comm_compression, reset_comm_compression)
from .logging import get_comms_logger
from .quantized import Pending


class ReduceOp:
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PRODUCT = "prod"


def _dist():
    import torch.distributed as dist
    return dist


# --------------------------------------------------------------------------
# Host plane
# --------------------------------------------------------------------------

def _env_world_rank(world_size=-1, rank=-1):
    env = os.environ
    nprocs = world_size if world_size > 0 else int(
        env.get("WORLD_SIZE", env.get("OMPI_COMM_WORLD_SIZE",
                                      env.get("SLURM_NTASKS", "1"))))
    proc_id = rank if rank >= 0 else int(
        env.get("RANK", env.get("OMPI_COMM_WORLD_RANK",
                                env.get("SLURM_PROCID", "0"))))
    return nprocs, proc_id


def env_world_size() -> int:
    """The world size the launcher's variables give (1 without them)."""
    return _env_world_rank()[0]


def init_distributed(dist_backend: Optional[str] = None,
                     auto_mpi_discovery: bool = True,
                     distributed_port: int = 29500,
                     verbose: bool = True,
                     timeout=None,
                     init_method: Optional[str] = None,
                     dist_init_required: Optional[bool] = None,
                     config=None,
                     rank: int = -1,
                     world_size: int = -1,
                     device=None):
    """Make the default process group, as ``deepspeed.init_distributed``.

    The world size and rank come from the arguments, else from
    ``WORLD_SIZE`` / ``RANK`` (torchrun), ``OMPI_COMM_WORLD_*`` or
    ``SLURM_NTASKS`` / ``SLURM_PROCID``; the rendezvous from
    ``init_method``, else ``tcp://MASTER_ADDR:MASTER_PORT`` (defaults
    ``127.0.0.1`` and ``distributed_port``). The backend is
    ``dist_backend``, else ``nccl`` when ``device`` is ``cuda`` (the
    default) and ``gloo`` for ``cpu``; ``nccl`` without a GPU raises.
    With NCCL each process takes the GPU ``LOCAL_RANK``. Called again
    once a group exists, it does nothing."""
    dist = _dist()
    if dist.is_initialized():
        return
    if dist_init_required is False:
        return
    nprocs, proc_id = _env_world_rank(world_size, rank)
    dev = torch.device("cuda" if device is None else device)
    backend = dist_backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "xla":
        raise ValueError("init_distributed: the 'xla' backend is the JAX "
                         "package's; pass 'nccl' (the card) or 'gloo' "
                         "(the CPU)")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: nccl needs a CUDA device and "
                           "none is available; pass dist_backend='gloo' "
                           "and device='cpu' to run on the CPU")
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ.get("MASTER_PORT", str(distributed_port))
        init_method = f"tcp://{addr}:{port}"
    if backend == "nccl":
        torch.cuda.set_device(get_local_rank() % torch.cuda.device_count())
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = timeout if isinstance(
            timeout, datetime.timedelta) else datetime.timedelta(
                seconds=float(timeout))
    if verbose:
        logger.info(f"Initializing torch.distributed: backend={backend} "
                    f"init_method={init_method} rank={proc_id} "
                    f"world={nprocs}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=nprocs, rank=proc_id, **kwargs)


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None) -> int:
    """This rank's index in ``group`` (a group or an axis name; None for
    the world)."""
    return _member_index(_group_of(group))


def get_world_size(group=None) -> int:
    return _members(_group_of(group))


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def get_backend() -> Optional[str]:
    return _dist().get_backend() if is_initialized() else None


def barrier(group=None, timeout_ms: Optional[int] = None):
    """All ranks of the group meet (nothing to do without a group)."""
    g = _group_of(group)
    if g is SINGLE:
        return
    dist = _dist()
    if dist.get_backend(g) == "nccl":
        dist.barrier(group=g, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=g)


def broadcast_object(obj, src: int = 0):
    """``src``'s Python object on every rank (pickled)."""
    if not is_initialized() or get_world_size() == 1:
        return obj
    box = [obj]
    _dist().broadcast_object_list(box, src=src)
    return box[0]


def destroy_process_group():
    """Tear the default group down, with the topology's groups."""
    from ..parallel import topology
    topology.reset_mesh()
    if is_initialized():
        _dist().destroy_process_group()


# --------------------------------------------------------------------------
# Groups
# --------------------------------------------------------------------------

class _Single:
    """The group of one rank (a size-1 mesh axis, or no process group):
    every collective over it is the identity."""

    def __repr__(self):
        return "<single-rank group>"


SINGLE = _Single()


def _group_of(axis_name):
    """The process group an ``axis_name`` names: None (the world), a
    ``ProcessGroup`` as it is, or a mesh axis (a name or a tuple of names)
    of the port's rank topology; ``SINGLE`` when it holds one rank."""
    if not is_initialized():
        return SINGLE
    if axis_name is None or isinstance(axis_name, _dist().ProcessGroup):
        return axis_name
    if axis_name is SINGLE:
        return SINGLE
    from ..parallel.topology import get_mesh_manager
    return get_mesh_manager().group(axis_name)


def _members(group) -> int:
    if group is SINGLE:
        return 1
    return _dist().get_world_size(group)


def _member_index(group) -> int:
    if group is SINGLE:
        return 0
    return _dist().get_rank(group)


def _global_rank(group, member: int) -> int:
    if group is None:
        return member
    return _dist().get_global_rank(group, member)


# --------------------------------------------------------------------------
# Accounting: the JAX package's per-member ring wire-byte model
# --------------------------------------------------------------------------

_BASE_WIRE = {
    "all_reduce": lambda nb, n: 2 * (n - 1) * nb // n,
    "all_gather": lambda nb, n: (n - 1) * nb,
    "reduce_scatter": lambda nb, n: (n - 1) * nb // n,
    "all_to_all": lambda nb, n: (n - 1) * nb // n,
    "broadcast": lambda nb, n: 2 * (n - 1) * nb // n,
    "scatter": lambda nb, n: 2 * (n - 1) * nb // n,
    "ppermute": lambda nb, n: nb,
}


def _base_wire(op: str, logical: int, n: int) -> int:
    """Wire bytes a member puts on its links for ``op`` over ``n`` members
    (nothing crosses a link for one member)."""
    if n <= 1:
        return 0
    return _BASE_WIRE[op](logical, n)


_COMM_OPS = 0
_COMM_WIRE_BYTES = 0
_COMM_LOGICAL_BYTES = 0
_COMM_INTER_BYTES = 0
_COMM_INTRA_BYTES = 0
_COMM_PER_OP: dict = {}
_COMM_PER_AXIS: dict = {}
# process groups made for mesh axes, by id: their axis label in the
# per-axis accounting when a collective is handed the group itself
_GROUP_NAMES: dict = {}


def name_group(group, axis_name):
    """Account the collectives issued on ``group`` under ``axis_name``
    (the topology names each group it makes)."""
    if group is not None and group is not SINGLE:
        _GROUP_NAMES[id(group)] = str(axis_name)


def comm_stats():
    """Cumulative accounting of the collectives issued: ``ops``, ``bytes``
    (wire bytes a member sent), ``logical_bytes`` (the payload handed in),
    and the wire bytes split into ``inter_host_bytes`` /
    ``intra_host_bytes`` when the launcher gives ``LOCAL_WORLD_SIZE``."""
    return {"ops": _COMM_OPS, "bytes": _COMM_WIRE_BYTES,
            "logical_bytes": _COMM_LOGICAL_BYTES,
            "inter_host_bytes": _COMM_INTER_BYTES,
            "intra_host_bytes": _COMM_INTRA_BYTES}


def comm_per_op_stats():
    """``{op name: count}`` of the collectives issued."""
    return dict(_COMM_PER_OP)


def comm_axis_stats(axis_name=None):
    """The accounting by mesh axis: ``{axis: {"ops", "bytes",
    "logical_bytes", "per_op": {op: count}}}`` (the axis as the
    collective named it: ``"model"``, ``"('data', 'expert')"``,
    ``"world"``), or one axis's record (zeros when none ran)."""
    if axis_name is not None:
        rec = _COMM_PER_AXIS.get(str(axis_name))
        return _axis_record() if rec is None else \
            dict(rec, per_op=dict(rec["per_op"]))
    return {k: dict(v, per_op=dict(v["per_op"]))
            for k, v in _COMM_PER_AXIS.items()}


def _axis_record():
    return {"ops": 0, "bytes": 0, "logical_bytes": 0, "per_op": {}}


def reset_comm_stats():
    global _COMM_OPS, _COMM_WIRE_BYTES, _COMM_LOGICAL_BYTES
    global _COMM_INTER_BYTES, _COMM_INTRA_BYTES
    _COMM_OPS = _COMM_WIRE_BYTES = _COMM_LOGICAL_BYTES = 0
    _COMM_INTER_BYTES = _COMM_INTRA_BYTES = 0
    _COMM_PER_OP.clear()
    _COMM_PER_AXIS.clear()


def _split_inter(wire: int, n: int) -> int:
    """Inter-host share of a flat ring's wire bytes: with L members a host
    laid out host-major, n / L of the n ring links cross hosts (0 when the
    group fits on one host, or the layout is unknown). L is the
    ``comm_compression`` block's ``devices_per_host``, else the launcher's
    ``LOCAL_WORLD_SIZE``."""
    if n <= 1:
        return 0
    local = get_comm_compression().local_members(n)
    if not local:
        return 0
    return wire * (n // local) // n


def _size_bytes(x) -> int:
    return x.numel() * x.element_size()


def _axis_label(axis_name) -> str:
    if axis_name is None:
        return "world"
    if isinstance(axis_name, (str, tuple, list)):
        return str(axis_name)
    return _GROUP_NAMES.get(id(axis_name), "group")


def _account(op, logical, n, axis_name, wire=None, inter=None,
             policy="off"):
    """Record one collective: counters, the comms logger and a span (the
    span is a no-op while the tracer is off). ``inter``: the inter-host
    wire bytes when the collective knows its legs (the hierarchical
    reduce-scatter), else the flat ring's share; the span carries the
    policy when it is not ``off``."""
    global _COMM_OPS, _COMM_WIRE_BYTES, _COMM_LOGICAL_BYTES
    global _COMM_INTER_BYTES, _COMM_INTRA_BYTES
    wire = _base_wire(op, logical, n) if wire is None else wire
    if inter is None:
        inter = _split_inter(wire, n)
    _COMM_OPS += 1
    _COMM_WIRE_BYTES += wire
    _COMM_LOGICAL_BYTES += logical
    _COMM_INTER_BYTES += inter
    _COMM_INTRA_BYTES += wire - inter
    _COMM_PER_OP[op] = _COMM_PER_OP.get(op, 0) + 1
    label = _axis_label(axis_name)
    rec = _COMM_PER_AXIS.setdefault(label, _axis_record())
    rec["ops"] += 1
    rec["bytes"] += wire
    rec["logical_bytes"] += logical
    rec["per_op"][op] = rec["per_op"].get(op, 0) + 1
    cl = get_comms_logger()
    if cl.enabled:
        cl.append(op, wire, label, n)
    tracer = get_tracer()
    if not tracer.enabled:
        return tracer.span(op)
    args = {"op": op, "bytes": logical, "wire_bytes": wire, "axis": label,
            "participants": n}
    if policy != "off":
        args["policy"] = policy
    return tracer.span(op, cat="comm", args=args)


# --------------------------------------------------------------------------
# Collectives
# --------------------------------------------------------------------------

_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.AVG: "SUM", ReduceOp.MAX: "MAX",
              ReduceOp.MIN: "MIN", ReduceOp.PRODUCT: "PRODUCT"}
_SUMLIKE = (ReduceOp.SUM, ReduceOp.AVG)
_QUANTIZED = ("int8", "fp8_block")


def _torch_op(op):
    if op not in _TORCH_OPS:
        raise ValueError(f"Unsupported reduce op {op}")
    return getattr(_dist().ReduceOp, _TORCH_OPS[op])


_EXACT = threading.local()


@contextlib.contextmanager
def full_precision():
    """Collectives issued inside the block ignore the ``comm_compression``
    policy: the engines' own exchanges (the parameter refresh, the
    gradient norm, checkpoints, the stage path's gathers) are the ones XLA
    inserts in the JAX package, which no policy reaches there either."""
    _EXACT.depth = getattr(_EXACT, "depth", 0) + 1
    try:
        yield
    finally:
        _EXACT.depth -= 1


def _dispatch(op, logical, axis_name, n, quantizable=True):
    """The single dispatch decision of a call: ``(config, policy)``.
    Policy ``off`` (and ``fp32``) runs the plain ``torch.distributed``
    call."""
    cc = get_comm_compression()
    exact = getattr(_EXACT, "depth", 0) > 0
    policy = cc.policy_for(op, axis_name, logical) \
        if (quantizable and n > 1 and not exact) else "off"
    return cc, policy


def _host_split(cc, axis_name, n):
    """``(local, intra group, inter group)`` of a hierarchical exchange on
    ``axis_name``, or ``(0, None, None)`` when none applies."""
    local = cc.local_members(n) if cc.hierarchical else 0
    if not local:
        return 0, None, None
    from ..parallel.topology import get_mesh_manager
    intra, inter = get_mesh_manager().host_process_groups(axis_name, local)
    return local, intra, inter


def all_reduce(x, op: str = ReduceOp.SUM, axis_name="data"):
    """Reduce ``x`` over the group, in place; returns it. Policy
    int8 / fp8_block (a sum or an average whose size divides by the group)
    moves it as a quantized reduce-scatter plus all-gather."""
    _torch_op(op)
    group = _group_of(axis_name)
    n = _members(group)
    logical = _size_bytes(x)
    cc, policy = _dispatch("all_reduce", logical, axis_name, n,
                           quantizable=op in _SUMLIKE)
    if policy in _QUANTIZED and x.numel() % n == 0:
        from .quantized import (quantized_all_reduce,
                                quantized_all_reduce_wire_bytes)
        wire = quantized_all_reduce_wire_bytes(x.numel(), n, cc.block_size)
        with _account("all_reduce", logical, n, axis_name, wire=wire,
                      policy=policy):
            x.copy_(quantized_all_reduce(x, group, n, cc.block_size, policy,
                                         avg=op == ReduceOp.AVG))
        return x
    with _account("all_reduce", logical, n, axis_name):
        if group is not SINGLE:
            _dist().all_reduce(x, op=_torch_op(op), group=group)
        if op == ReduceOp.AVG and n > 1:
            x.div_(n)
    return x


def _gather_flat(x, group, n, async_op=False):
    """``[n * x.numel()]``: every member's ``x`` (contiguous), in member
    order (with ``async_op``: ``(buffer, work)``)."""
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    work = _dist().all_gather_into_tensor(out, x.contiguous().view(-1),
                                          group=group, async_op=async_op)
    return (out, work) if async_op else out


def all_gather(x, axis_name="data", axis: int = 0, tiled: bool = True):
    """Every member's ``x``, concatenated along ``axis`` (``tiled``) or
    stacked on a new leading axis. Policy int8 / fp8_block ships the
    shard blockwise-quantized (the ZeRO-3 parameter gather, ZeRO++
    qwZ)."""
    group = _group_of(axis_name)
    n = _members(group)
    logical = _size_bytes(x)
    cc, policy = _dispatch("all_gather", logical, axis_name, n,
                           quantizable=tiled)
    if policy in _QUANTIZED:
        from .quantized import (quantized_all_gather,
                                quantized_all_gather_wire_bytes)
        wire = quantized_all_gather_wire_bytes(x.numel(), n, cc.block_size)
        with _account("all_gather", logical, n, axis_name, wire=wire,
                      policy=policy):
            return quantized_all_gather(x, group, axis, n, cc.block_size,
                                        policy)
    with _account("all_gather", logical, n, axis_name):
        if group is SINGLE:
            return x.clone() if tiled else x.unsqueeze(0).clone()
        flat = _gather_flat(x, group, n).view((n,) + tuple(x.shape))
    if not tiled or x.dim() == 0:
        return flat
    return torch.cat(flat.unbind(0), dim=axis)


def reduce_scatter(x, axis_name="data", axis: int = 0, op: str = ReduceOp.SUM):
    """Member i's part of the reduced ``x``: the i-th of n equal slices
    along ``axis``. Policy int8 / fp8_block quantizes the exchange; with
    ``comm_compression.hierarchical`` and a (host, local) split it is the
    two-level ZeRO++ qgZ exchange (full precision within a host,
    quantized across hosts)."""
    _torch_op(op)
    group = _group_of(axis_name)
    n = _members(group)
    if x.shape[axis] % n:
        raise ValueError(f"reduce_scatter: dim {axis} ({x.shape[axis]}) "
                         f"must divide by the group size {n}")
    logical = _size_bytes(x)
    cc, policy = _dispatch("reduce_scatter", logical, axis_name, n,
                           quantizable=op in _SUMLIKE)
    if policy in _QUANTIZED:
        from . import quantized as qz
        avg = op == ReduceOp.AVG
        local, intra_g, inter_g = _host_split(cc, axis_name, n)
        if local:
            intra_b, inter_b = qz.hierarchical_reduce_scatter_wire_bytes(
                x.numel(), n, local, cc.block_size, x.element_size())
            with _account("reduce_scatter", logical, n, axis_name,
                          wire=intra_b + inter_b, inter=inter_b,
                          policy=policy):
                return qz.hierarchical_reduce_scatter(
                    x, axis, n, local, intra_g, inter_g, cc.block_size,
                    policy, avg)
        wire = qz.quantized_reduce_scatter_wire_bytes(x.numel(), n,
                                                      cc.block_size)
        with _account("reduce_scatter", logical, n, axis_name, wire=wire,
                      policy=policy):
            return qz.quantized_reduce_scatter(x, group, axis, n,
                                               cc.block_size, policy, avg)
    with _account("reduce_scatter", logical, n, axis_name):
        if group is SINGLE:
            return x.clone()
        rows = x.movedim(axis, 0).contiguous()
        out = torch.empty((rows.shape[0] // n,) + tuple(rows.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _dist().reduce_scatter_tensor(out, rows, op=_torch_op(op),
                                      group=group)
        if op == ReduceOp.AVG:
            out.div_(n)
        return out.movedim(0, axis)


# ---------------------------------------------------------------- coalesced
# Bucketed forms for the overlap schedule (runtime/zero/overlap_schedule.py):
# a bucket of leaves moves in one collective. One op is accounted, whose
# logical and wire bytes are the sums of the per-leaf models, so N buckets
# and N leaves account the same bytes and differ only in the op count.
# Under a quantized policy each leaf keeps its per-leaf codec (same blocks,
# same scales), so the values are bitwise the per-leaf collectives'. With
# ``async_op`` they return a handle whose ``wait()`` gives the leaves.

def all_gather_coalesced(xs: Sequence, axis_name="data",
                         axes: Optional[Sequence[int]] = None,
                         async_op: bool = False):
    """A bucket of shards gathered in one collective; returns each leaf as
    ``all_gather(x, axis_name, axis)`` would."""
    xs = list(xs)
    axes = [0] * len(xs) if axes is None else list(axes)
    group = _group_of(axis_name)
    n = _members(group)
    logical = sum(_size_bytes(x) for x in xs)
    cc, policy = _dispatch("all_gather", logical, axis_name, n)
    if policy in _QUANTIZED:
        from .quantized import (quantized_all_gather_coalesced,
                                quantized_all_gather_coalesced_wire_bytes)
        wire = quantized_all_gather_coalesced_wire_bytes(
            [x.numel() for x in xs], n, cc.block_size)
        with _account("all_gather", logical, n, axis_name, wire=wire,
                      policy=policy):
            return quantized_all_gather_coalesced(
                xs, group, axes, n, cc.block_size, policy, async_op=async_op)
    wire = sum(_base_wire("all_gather", _size_bytes(x), n) for x in xs)
    with _account("all_gather", logical, n, axis_name, wire=wire):
        if group is SINGLE:
            outs = [x.clone() for x in xs]
            return Pending([], lambda: outs) if async_op else outs
        flat = torch.cat([x.contiguous().view(-1) for x in xs])
        g, work = _gather_flat(flat, group, n, async_op=True)

    def finish():
        work.wait()
        rows = g.view(n, -1)
        outs, off = [], 0
        for x, a in zip(xs, axes):
            seg = rows[:, off:off + x.numel()].reshape((n,) + tuple(x.shape))
            off += x.numel()
            outs.append(torch.cat(seg.unbind(0), dim=a))
        return outs
    pending = Pending([], finish)
    return pending if async_op else pending.wait()


def reduce_scatter_coalesced(xs: Sequence, axis_name="data",
                             axes: Optional[Sequence[int]] = None,
                             op: str = ReduceOp.SUM, async_op: bool = False):
    """A bucket of full tensors reduce-scattered in one collective;
    returns each leaf's part as ``reduce_scatter(x, axis_name, axis,
    op)`` would."""
    _torch_op(op)
    xs = list(xs)
    axes = [0] * len(xs) if axes is None else list(axes)
    group = _group_of(axis_name)
    n = _members(group)
    logical = sum(_size_bytes(x) for x in xs)
    cc, policy = _dispatch("reduce_scatter", logical, axis_name, n,
                           quantizable=op in _SUMLIKE)
    if policy in _QUANTIZED and \
            all(x.shape[a] % n == 0 for x, a in zip(xs, axes)):
        from . import quantized as qz
        avg = op == ReduceOp.AVG
        sizes = [x.numel() for x in xs]
        local, intra_g, inter_g = _host_split(cc, axis_name, n)
        if local:
            intra_b, inter_b = \
                qz.hierarchical_reduce_scatter_coalesced_wire_bytes(
                    sizes, n, local, cc.block_size, xs[0].element_size())
            with _account("reduce_scatter", logical, n, axis_name,
                          wire=intra_b + inter_b, inter=inter_b,
                          policy=policy):
                return qz.hierarchical_reduce_scatter_coalesced(
                    xs, axes, n, local, intra_g, inter_g, cc.block_size,
                    policy, avg, async_op=async_op)
        wire = qz.quantized_reduce_scatter_coalesced_wire_bytes(
            sizes, n, cc.block_size)
        with _account("reduce_scatter", logical, n, axis_name, wire=wire,
                      policy=policy):
            return qz.quantized_reduce_scatter_coalesced(
                xs, group, axes, n, cc.block_size, policy, avg,
                async_op=async_op)
    wire = sum(_base_wire("reduce_scatter", _size_bytes(x), n) for x in xs)
    with _account("reduce_scatter", logical, n, axis_name, wire=wire):
        if group is SINGLE:
            outs = [x.clone() for x in xs]
            return Pending([], lambda: outs) if async_op else outs
        rows = torch.cat([x.movedim(a, 0).reshape(n, -1)
                          for x, a in zip(xs, axes)], dim=1)
        red = torch.empty(rows.shape[1], dtype=rows.dtype, device=rows.device)
        work = _dist().reduce_scatter_tensor(red, rows.reshape(-1),
                                             op=_torch_op(op), group=group,
                                             async_op=True)

    def finish():
        work.wait()
        if op == ReduceOp.AVG:
            red.div_(n)
        outs, off = [], 0
        for x, a in zip(xs, axes):
            moved = x.movedim(a, 0)
            size = x.numel() // n
            seg = red[off:off + size].reshape((moved.shape[0] // n,) +
                                              tuple(moved.shape[1:]))
            off += size
            outs.append(seg.movedim(0, a))
        return outs
    pending = Pending([], finish)
    return pending if async_op else pending.wait()


def all_to_all(x, axis_name="expert", split_axis: int = 0,
               concat_axis: int = 0):
    """Member i's ``split_axis`` slice j goes to member j, which
    concatenates what it receives along ``concat_axis`` (the MoE dispatch
    and combine). Policy int8 / fp8_block quantizes each slice."""
    group = _group_of(axis_name)
    n = _members(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} "
                         f"({x.shape[split_axis]}) must divide by the "
                         f"group size {n}")
    logical = _size_bytes(x)
    cc, policy = _dispatch("all_to_all", logical, axis_name, n)
    if policy in _QUANTIZED:
        from .quantized import (quantized_all_to_all,
                                quantized_all_to_all_wire_bytes)
        wire = quantized_all_to_all_wire_bytes(x.numel(), n, cc.block_size)
        with _account("all_to_all", logical, n, axis_name, wire=wire,
                      policy=policy):
            return quantized_all_to_all(x, group, split_axis, concat_axis, n,
                                        cc.block_size, policy)
    with _account("all_to_all", logical, n, axis_name):
        if group is SINGLE:
            return x.clone()
        send = x.movedim(split_axis, 0).contiguous()
        recv = torch.empty_like(send)
        _dist().all_to_all_single(recv, send, group=group)
    parts = recv.movedim(0, split_axis).chunk(n, dim=split_axis)
    return torch.cat(parts, dim=concat_axis)


def _broadcast_impl(x, src, axis_name, op_label):
    """The shared broadcast (``broadcast`` and ``scatter`` account under
    their own names and put the same bytes on the wire), in place."""
    group = _group_of(axis_name)
    n = _members(group)
    logical = _size_bytes(x)
    cc, policy = _dispatch("broadcast", logical, axis_name, n)
    if policy in _QUANTIZED:
        from .quantized import (quantized_broadcast,
                                quantized_broadcast_wire_bytes)
        wire = quantized_broadcast_wire_bytes(x.numel(), n, cc.block_size)
        with _account(op_label, logical, n, axis_name, wire=wire,
                      policy=policy):
            x.copy_(quantized_broadcast(x, _global_rank(group, src), group,
                                        n, cc.block_size, policy))
        return x
    with _account(op_label, logical, n, axis_name,
                  wire=_base_wire("broadcast", logical, n)):
        if group is not SINGLE:
            _dist().broadcast(x, src=_global_rank(group, src), group=group)
    return x


def broadcast(x, src: int = 0, axis_name="data"):
    """Member ``src``'s ``x`` on every member, in place; returns it."""
    return _broadcast_impl(x, src, axis_name, "broadcast")


def ppermute(x, perm: Sequence, axis_name="pipe"):
    """Point-to-point exchange along an axis: ``(src, dst)`` member pairs;
    a member no pair sends to gets zeros."""
    group = _group_of(axis_name)
    n = _members(group)
    with _account("ppermute", _size_bytes(x), n, axis_name):
        if group is SINGLE:
            return x.clone() if any(s == d for s, d in perm) \
                else torch.zeros_like(x)
        dist = _dist()
        me = _member_index(group)
        out = torch.zeros_like(x)
        src = x.contiguous()
        ops = []
        for s, d in perm:
            if s == me:
                ops.append(dist.P2POp(dist.isend, src, _global_rank(group, d),
                                      group))
            if d == me:
                ops.append(dist.P2POp(dist.irecv, out, _global_rank(group, s),
                                      group))
        for req in dist.batch_isend_irecv(ops) if ops else []:
            req.wait()
        return out


def send_recv_next(x, axis_name="pipe"):
    """Shift +1 along the axis (member i -> i + 1), wrapping."""
    n = axis_size(axis_name)
    return ppermute(x, [(i, (i + 1) % n) for i in range(n)], axis_name)


def send_recv_prev(x, axis_name="pipe"):
    n = axis_size(axis_name)
    return ppermute(x, [(i, (i - 1) % n) for i in range(n)], axis_name)


# --------------------------------------------------------------------------
# The reference's names
# --------------------------------------------------------------------------

def all_gather_into_tensor(x, axis_name="data", axis: int = 0):
    return all_gather(x, axis_name, axis=axis)


allgather_fn = all_gather_into_tensor


def reduce_scatter_tensor(x, axis_name="data", axis: int = 0,
                          op: str = ReduceOp.SUM):
    return reduce_scatter(x, axis_name, axis=axis, op=op)


reduce_scatter_fn = reduce_scatter_tensor


def all_to_all_single(x, axis_name="expert", split_axis: int = 0,
                      concat_axis: int = 0):
    return all_to_all(x, axis_name, split_axis=split_axis,
                      concat_axis=concat_axis)


def reduce(x, dst: int = 0, axis_name="data", op: str = ReduceOp.SUM):
    """Rooted reduce; every member receives the result (a superset of
    torch's, as in the JAX package)."""
    del dst
    return all_reduce(x, op=op, axis_name=axis_name)


def gather(x, dst: int = 0, axis_name="data", axis: int = 0):
    """Rooted gather; every member receives the result."""
    del dst
    return all_gather(x, axis_name, axis=axis)


def scatter(x, src: int = 0, axis_name="data", axis: int = 0):
    """Member i receives ``src``'s i-th slice along ``axis`` (the other
    members' ``x`` is ignored): the JAX package's broadcast-and-slice,
    accounted as ``scatter``."""
    group = _group_of(axis_name)
    n = _members(group)
    if x.shape[axis] % n:
        raise ValueError(f"scatter: dim {axis} ({x.shape[axis]}) must "
                         f"divide by the group size {n}")
    full = _broadcast_impl(x.clone(), src, axis_name, "scatter")
    chunk = full.shape[axis] // n
    return full.narrow(axis, _member_index(group) * chunk, chunk).clone()


def new_group(ranks):
    """A ``torch.distributed`` process group of ``ranks`` (every rank must
    call it, as torch requires); usable as the ``axis_name`` / ``group``
    of every collective here."""
    return _dist().new_group(ranks=list(ranks))


def get_global_rank(group=None, group_rank: int = 0) -> int:
    """A group-local rank as a global rank (``group``: a process group or
    a rank list; None for the world)."""
    if group is None:
        return group_rank
    if isinstance(group, (list, tuple)):
        return list(group)[group_rank]
    return _dist().get_global_rank(group, group_rank)


def monitored_barrier(group=None, timeout=None, wait_all_ranks=False):
    """Barrier with logging on entry and exit."""
    del wait_all_ranks, timeout
    logger.info(f"monitored_barrier enter (rank {get_rank()})")
    barrier(group)
    logger.info(f"monitored_barrier exit (rank {get_rank()})")


def _no_host_p2p(name, alternative):
    raise ValueError(
        f"comm.{name} is not supported: collectives here run in a fixed "
        f"order on every rank of a group, and host-driven point-to-point "
        f"has no place in it. Use {alternative} (a matched exchange every "
        f"member of the axis issues).")


def isend(tensor, dst, **kw):
    _no_host_p2p("isend", "comm.ppermute / send_recv_next")


def irecv(tensor, src, **kw):
    _no_host_p2p("irecv", "comm.ppermute / send_recv_prev")


def send(tensor, dst, **kw):
    _no_host_p2p("send", "comm.ppermute / send_recv_next")


def recv(tensor, src, **kw):
    _no_host_p2p("recv", "comm.ppermute / send_recv_prev")


def has_all_gather_into_tensor() -> bool:
    return True


def has_reduce_scatter_tensor() -> bool:
    return True


def axis_index(axis_name) -> int:
    """This rank's index along a mesh axis."""
    return _member_index(_group_of(axis_name))


def axis_size(axis_name) -> int:
    return _members(_group_of(axis_name))


def log_summary():
    get_comms_logger().log_summary()
