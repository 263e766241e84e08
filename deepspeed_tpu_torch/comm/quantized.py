"""Quantized and hierarchical collectives: the JAX package's
``comm/quantized.py`` over ``torch.distributed``.

The compressed forms the dispatch (``comm/comm.py``) routes to under a
``comm_compression`` policy. Each moves the compressed carrier: the
``torch.distributed`` calls here carry int8 payloads (an fp8 payload
travels as its int8 view: gloo has no fp8) plus small f32 scale
tensors.

Wire format: the blockwise codec of ``ops/quant_core.py``, contiguous
blocks of ``block`` values with one f32 scale a block (ZeRO++ qwZ, arxiv
2306.10209 §4.1). The member rows of each exchange are the JAX code's:
a reduce-scatter's row ``m`` is member ``m``'s chunk along the scattered
dim, flattened in C order, and ``_effective_block`` keeps a block from
straddling two rows (one scale a row when the block does not divide it).
The hierarchical reduce-scatter is the qgZ gradient exchange: a
full-precision reduce-scatter within a host, then the quantized exchange
across hosts.

Every collective has a ``*_wire_bytes`` companion: the per-member link
bytes the dispatch accounts (the JAX package's models), split into
intra-host and inter-host bytes where the (host, local) split is known.

The functions take the process group(s) and the member count, and an
``async_op``: when set they return a ``Pending`` whose ``wait()`` gives
the result (the bucketed ZeRO schedule issues its buckets that way);
otherwise the result itself.
"""

from typing import Optional, Tuple

import torch

from ..ops.quant_core import (FP8_DTYPE, block_count, dequantize_blockwise,
                              quantize_blockwise, wire_nbytes)


def _dist():
    import torch.distributed as dist
    return dist


class Pending:
    """An issued exchange: ``wait()`` waits for its collectives, runs the
    steps that follow them (a second leg, the dequantize and sum) and
    returns the result, once."""

    def __init__(self, works, finish):
        self._works, self._finish = works, finish
        self._done, self._value = False, None

    def wait(self):
        if not self._done:
            for w in self._works:
                if w is not None:
                    w.wait()
            self._value = self._finish()
            self._done = True
            self._works = self._finish = None
        return self._value


def _result(pending: Pending, async_op: bool):
    return pending if async_op else pending.wait()


def _carrier(q):
    """The int8 view a payload travels as (fp8 has no gloo dtype)."""
    return q if q.dtype == torch.int8 else q.view(torch.int8)


def _restore(carried, dtype):
    return carried if dtype == torch.int8 else carried.view(dtype)


def _wire_dtype(wire):
    return torch.int8 if wire == "int8" else FP8_DTYPE


def _all_gather_flat(x, group, n, async_op):
    """``([n, x.numel()] buffer, work)``: every member's flat ``x``."""
    out = torch.empty((n, x.numel()), dtype=x.dtype, device=x.device)
    work = _dist().all_gather_into_tensor(out.view(-1),
                                          x.contiguous().view(-1),
                                          group=group, async_op=async_op)
    return out, work


def _all_to_all_rows(rows, group, async_op):
    """``(received [g, ...], work)``: row ``j`` of ``rows`` goes to member
    ``j``; received row ``j`` came from member ``j``."""
    rows = rows.contiguous()
    out = torch.empty_like(rows)
    work = _dist().all_to_all_single(out, rows, group=group,
                                     async_op=async_op)
    return out, work


def _effective_block(row_size: int, block: Optional[int]) -> Optional[int]:
    """A block that never straddles the per-member rows of an exchange:
    the configured block when it divides the row, else one scale a row."""
    if block and block > 0 and row_size % block == 0:
        return block
    return row_size


def _gathered(gq, gs, n, shape, axis, dtype):
    """Member payloads ``gq [n, size]`` and scales ``gs [n, nb]`` ->
    the dequantized tiled concatenation along ``axis``."""
    nb = gs.shape[1]
    deq = gq.reshape(n, nb, -1).to(torch.float32) * gs[:, :, None]
    deq = deq.reshape((n,) + tuple(shape))
    out = torch.movedim(deq, 0, axis)
    full = list(shape)
    full[axis] *= n
    return out.reshape(full).to(dtype)


# ------------------------------------------------------------------ all_gather

def quantized_all_gather(x, group, axis: int, n: int, block: int, wire: str,
                         async_op: bool = False):
    """Blockwise-quantized tiled all-gather: each member ships its shard as
    int8/fp8 + per-block f32 scales; the receivers dequantize and
    concatenate along ``axis`` (the ZeRO-3 parameter gather)."""
    q, scales = quantize_blockwise(x, block, wire)
    gq, w1 = _all_gather_flat(_carrier(q), group, n, async_op)
    gs, w2 = _all_gather_flat(scales, group, n, async_op)
    return _result(Pending([w1, w2], lambda: _gathered(
        _restore(gq, q.dtype), gs, n, x.shape, axis, x.dtype)), async_op)


def quantized_all_gather_wire_bytes(size: int, n: int, block: int) -> int:
    """Per-member link bytes: ``n - 1`` copies of the compressed shard."""
    return (n - 1) * wire_nbytes(size, block)


# -------------------------------------------------------------- reduce_scatter

def _rows_quantize(rows, block: int, wire: str):
    """Quantize ``[n, row]`` with blocks aligned to rows: ``(q [n, row],
    scales [n, nb_row])``."""
    n, row = rows.shape
    eff = _effective_block(row, block)
    q, scales = quantize_blockwise(rows, eff, wire)
    return q, scales.reshape(n, -1)


def _dequant_sum(rq, rs):
    """Received rows ``[g, row]`` and their scales -> their f32 sum."""
    g = rq.shape[0]
    nb = rs.shape[1]
    deq = rq.reshape(g, nb, -1).to(torch.float32) * rs[:, :, None]
    return deq.reshape(g, -1).sum(dim=0)


def _a2a_quantized(rows, group, block, wire, async_op):
    """Issue one quantized reduce-scatter leg: quantize the
    per-destination rows and all-to-all them. Returns ``(works, finish)``
    where ``finish()`` dequantizes the received rows and sums them."""
    q, scales = _rows_quantize(rows, block, wire)
    rq, w1 = _all_to_all_rows(_carrier(q), group, async_op)
    rs, w2 = _all_to_all_rows(scales, group, async_op)
    return [w1, w2], lambda: _dequant_sum(_restore(rq, q.dtype), rs)


def _leaf_rows(x, axis, n: int):
    """``[n, x.numel() // n]``: row ``m`` is member ``m``'s chunk along
    ``axis``."""
    return torch.movedim(x, axis, 0).reshape(n, -1)


def _unleaf_rows(total, shape, axis, n: int, dtype):
    """The inverse of ``_leaf_rows`` for the reduced chunk."""
    rest = tuple(s for i, s in enumerate(shape) if i != axis)
    out = total.reshape((shape[axis] // n,) + rest)
    return torch.movedim(out, 0, axis).to(dtype)


def quantized_reduce_scatter(x, group, axis: int, n: int, block: int,
                             wire: str, avg: bool, async_op: bool = False):
    """Flat quantized reduce-scatter: quantize the ``n`` per-destination
    chunks, all-to-all them, dequantize and sum locally."""
    works, finish = _a2a_quantized(_leaf_rows(x, axis, n), group, block,
                                   wire, async_op)

    def done():
        total = finish()
        if avg:
            total = total * (1.0 / n)
        return _unleaf_rows(total, tuple(x.shape), axis, n, x.dtype)
    return _result(Pending(works, done), async_op)


def quantized_reduce_scatter_wire_bytes(size: int, n: int,
                                        block: int) -> int:
    """Per-member link bytes: ``n - 1`` of its ``n`` compressed chunks."""
    row = size // n
    eff = _effective_block(row, block)
    return (n - 1) * wire_nbytes(row, eff)


def _host_major_rows(x, axis, n, local):
    """``[local, dim / local * rest]``: the leaf with its (host, local)
    chunk grid swapped, so that the two-level exchange lands member
    ``h local + l``'s result in standard reduce-scatter order."""
    hosts = n // local
    xm = torch.movedim(x, axis, 0)
    dim = xm.shape[0]
    chunk = dim // n
    y = xm.reshape((hosts, local, chunk) + tuple(xm.shape[1:]))
    y = y.transpose(0, 1).reshape((dim,) + tuple(xm.shape[1:]))
    return y.reshape(local, -1)


def _intra_reduce_scatter(rows, intra_group):
    """Full-precision reduce-scatter of ``[local, w]`` rows within the
    host: this member's ``[w]`` sum."""
    out = torch.empty(rows.shape[1], dtype=rows.dtype, device=rows.device)
    _dist().reduce_scatter_tensor(out, rows.contiguous().view(-1),
                                  group=intra_group)
    return out


def hierarchical_reduce_scatter(x, axis: int, n: int, local: int,
                                intra_group, inter_group, block: int,
                                wire: str, avg: bool, async_op: bool = False):
    """Two-level ZeRO++-style reduce-scatter over ``n`` members laid out
    host-major with ``local`` members a host: the (host, local) chunk grid
    swapped locally, a full-precision reduce-scatter within each host,
    then the blockwise-quantized all-to-all and dequantize-sum across
    hosts (the only inter-host traffic)."""
    hosts = n // local
    part = _intra_reduce_scatter(_host_major_rows(x, axis, n, local),
                                 intra_group)
    works, finish = _a2a_quantized(part.reshape(hosts, -1), inter_group,
                                   block, wire, async_op)

    def done():
        total = finish()
        if avg:
            total = total * (1.0 / n)
        return _unleaf_rows(total, tuple(x.shape), axis, n, x.dtype)
    return _result(Pending(works, done), async_op)


def hierarchical_reduce_scatter_wire_bytes(
        size: int, n: int, local: int, block: int,
        elem_bytes: int) -> Tuple[int, int]:
    """``(intra_bytes, inter_bytes)`` per member: the full-precision
    intra-host reduce-scatter of the whole payload, then the quantized
    inter-host exchange of the host-reduced ``1 / local`` slice."""
    hosts = n // local
    intra = (local - 1) * (size // local) * elem_bytes
    row = size // (local * hosts)
    eff = _effective_block(row, block)
    inter = (hosts - 1) * wire_nbytes(row, eff)
    return intra, inter


# ------------------------------------------------- coalesced (bucketed) forms
#
# One collective pair per bucket of leaves (runtime/zero/overlap_schedule.py):
# every leaf is quantized with exactly the per-leaf rules above (same blocks,
# same scales) and only the wire payloads are concatenated, so the values
# are bitwise those of the per-leaf collectives, for any bucketing.

def quantized_all_gather_coalesced(xs, group, axes, n: int, block: int,
                                   wire: str, async_op: bool = False):
    """A bucket of shards gathered blockwise-quantized in one collective
    pair (payload + scales); each leaf bitwise ``quantized_all_gather``'s."""
    qs, ss = [], []
    for x in xs:
        q, s = quantize_blockwise(x, block, wire)
        qs.append(_carrier(q).reshape(-1))
        ss.append(s)
    gq, w1 = _all_gather_flat(torch.cat(qs), group, n, async_op)
    gs, w2 = _all_gather_flat(torch.cat(ss), group, n, async_op)

    def done():
        outs, off, soff = [], 0, 0
        for x, axis in zip(xs, axes):
            nb = block_count(x.numel(), block)
            q = _restore(gq[:, off:off + x.numel()], _wire_dtype(wire))
            s = gs[:, soff:soff + nb]
            off += x.numel()
            soff += nb
            outs.append(_gathered(q, s, n, x.shape, axis, x.dtype))
        return outs
    return _result(Pending([w1, w2], done), async_op)


def quantized_all_gather_coalesced_wire_bytes(sizes, n: int,
                                              block: int) -> int:
    return sum(quantized_all_gather_wire_bytes(s, n, block) for s in sizes)


def _coalesced_a2a(rows_list, group, block, wire, async_op):
    """Per-leaf quantized rows ``[g, w_i]`` concatenated into one
    all-to-all pair; ``finish()`` gives each leaf's f32 sum ``[w_i]``."""
    qs, ss = [], []
    for rows in rows_list:
        q, s = _rows_quantize(rows, block, wire)
        qs.append(q)
        ss.append(s)
    cq = torch.cat([_carrier(q) for q in qs], dim=1)
    rq, w1 = _all_to_all_rows(cq, group, async_op)
    rs, w2 = _all_to_all_rows(torch.cat(ss, dim=1), group, async_op)

    def finish():
        outs, off, soff = [], 0, 0
        for q, s in zip(qs, ss):
            w, nb = q.shape[1], s.shape[1]
            outs.append(_dequant_sum(_restore(rq[:, off:off + w], q.dtype),
                                     rs[:, soff:soff + nb]))
            off += w
            soff += nb
        return outs
    return [w1, w2], finish


def quantized_reduce_scatter_coalesced(xs, group, axes, n: int, block: int,
                                       wire: str, avg: bool,
                                       async_op: bool = False):
    """Flat quantized reduce-scatter of a bucket in one all-to-all pair;
    each leaf bitwise ``quantized_reduce_scatter``'s."""
    works, finish = _coalesced_a2a(
        [_leaf_rows(x, a, n) for x, a in zip(xs, axes)], group, block, wire,
        async_op)

    def done():
        outs = []
        for total, x, a in zip(finish(), xs, axes):
            if avg:
                total = total * (1.0 / n)
            outs.append(_unleaf_rows(total, tuple(x.shape), a, n, x.dtype))
        return outs
    return _result(Pending(works, done), async_op)


def quantized_reduce_scatter_coalesced_wire_bytes(sizes, n: int,
                                                  block: int) -> int:
    return sum(quantized_reduce_scatter_wire_bytes(s, n, block)
               for s in sizes)


def hierarchical_reduce_scatter_coalesced(xs, axes, n: int, local: int,
                                          intra_group, inter_group,
                                          block: int, wire: str, avg: bool,
                                          async_op: bool = False):
    """The two-level reduce-scatter of a bucket: one intra-host
    full-precision reduce-scatter and one inter-host quantized all-to-all
    pair for all its leaves; each leaf bitwise
    ``hierarchical_reduce_scatter``'s."""
    hosts = n // local
    zs = [_host_major_rows(x, a, n, local) for x, a in zip(xs, axes)]
    part = _intra_reduce_scatter(torch.cat(zs, dim=1), intra_group)
    rows, off = [], 0
    for z in zs:
        rows.append(part[off:off + z.shape[1]].reshape(hosts, -1))
        off += z.shape[1]
    works, finish = _coalesced_a2a(rows, inter_group, block, wire, async_op)

    def done():
        outs = []
        for total, x, a in zip(finish(), xs, axes):
            if avg:
                total = total * (1.0 / n)
            outs.append(_unleaf_rows(total, tuple(x.shape), a, n, x.dtype))
        return outs
    return _result(Pending(works, done), async_op)


def hierarchical_reduce_scatter_coalesced_wire_bytes(
        sizes, n: int, local: int, block: int,
        elem_bytes: int) -> Tuple[int, int]:
    intra = inter = 0
    for s in sizes:
        i, e = hierarchical_reduce_scatter_wire_bytes(s, n, local, block,
                                                      elem_bytes)
        intra += i
        inter += e
    return intra, inter


# ------------------------------------------------------------------ all_reduce

def quantized_all_reduce(x, group, n: int, block: int, wire: str,
                         avg: bool):
    """Quantized ring-style sum / average: a quantized reduce-scatter of
    the flattened tensor, then a quantized all-gather of the reduced
    chunks (both legs on the compressed wire). Needs ``x.numel() % n ==
    0``: the dispatch keeps full precision otherwise."""
    chunk = quantized_reduce_scatter(x.reshape(-1), group, 0, n, block, wire,
                                     avg)
    full = quantized_all_gather(chunk, group, 0, n, block, wire)
    return full.reshape(x.shape).to(x.dtype)


def quantized_all_reduce_wire_bytes(size: int, n: int, block: int) -> int:
    return (quantized_reduce_scatter_wire_bytes(size, n, block) +
            quantized_all_gather_wire_bytes(size // n, n, block))


# ------------------------------------------------------------------ all_to_all

def quantized_all_to_all(x, group, split_axis: int, concat_axis: int,
                         n: int, block: int, wire: str):
    """Blockwise-quantized tiled all-to-all (the MoE dispatch / combine
    wire): the ``n`` per-destination slices quantized, exchanged, and
    reassembled dequantized as the tiled all-to-all lays them out."""
    xm = torch.movedim(x, split_axis, 0)
    ds = xm.shape[0] // n
    rows = xm.reshape(n, -1)
    q, scales = _rows_quantize(rows, block, wire)
    rq, _ = _all_to_all_rows(_carrier(q), group, False)
    rs, _ = _all_to_all_rows(scales, group, False)
    nb = rs.shape[1]
    deq = _restore(rq, q.dtype).reshape(n, nb, -1).to(torch.float32) \
        * rs[:, :, None]
    blocks = deq.reshape((n, ds) + tuple(xm.shape[1:]))
    blocks = torch.movedim(blocks, 1, split_axis + 1)
    out = torch.movedim(blocks, 0, concat_axis)
    shape = list(x.shape)
    shape[split_axis] //= n
    shape[concat_axis] *= n
    return out.reshape(shape).to(x.dtype)


def quantized_all_to_all_wire_bytes(size: int, n: int, block: int) -> int:
    row = size // n
    eff = _effective_block(row, block)
    return (n - 1) * wire_nbytes(row, eff)


# ------------------------------------------------------------------- broadcast

def quantized_broadcast(x, src_rank: int, group, n: int, block: int,
                        wire: str):
    """Quantized broadcast: ``src``'s payload and scales, bit for bit on
    every member (the JAX package's masked integer psum reconstructs the
    same bytes), dequantized in ``x``'s dtype. ``src_rank`` is the global
    rank of the source."""
    q, scales = quantize_blockwise(x, block, wire)
    carried = _carrier(q).contiguous()
    dist = _dist()
    dist.broadcast(carried, src=src_rank, group=group)
    dist.broadcast(scales, src=src_rank, group=group)
    return dequantize_blockwise(_restore(carried, q.dtype), scales, x.dtype)


def quantized_broadcast_wire_bytes(size: int, n: int, block: int) -> int:
    return int(2 * (n - 1) / n * wire_nbytes(size, block))
