"""K6 and K7: block-sparse attention forward and backward, hand-written
Hopper kernels.

K6 replaces the TPU kernel ``_fwd_kernel`` of
``deepspeed_tpu/ops/pallas/block_sparse_attention.py`` (via ``_fwd``), K7
its backward ``_dq_kernel`` + ``_dkv_kernel`` (via ``_bwd``). Both
compute bidirectional attention over only the live coarse tiles of a
sparsity layout ``[H, nb, nb]`` (fine block ``fb``, 16 by default): the
host plan (``build_plan``, bitwise the JAX package's) lists, for each
(head, q tile), the live key tiles (``kcols``, ``nnz``) and, for each
(head, k tile), the live q tiles (``qrows_t``, ``nnz_t``); inside a live
tile the fine layout masks each (q, k) fine-block pair with -1e30; the
online softmax keeps f32 m/l/acc, clamps ``l >= 1e-30`` and rounds P (and
dS) to the input type before their products; lse is f32. A fine row with
no live block in any visited tile gets the mean of V over the visited
columns and a coarse row with ``nnz = 0`` gets out 0, as on the TPU,
because the kernels visit exactly the plan's tiles in the plan's order.

The TPU's ``(8, 128)`` fine-window packing (``pack_fine_windows``,
``_expand_fine``) was a Mosaic constraint: the Hopper kernels read the fine
layout itself, ``[H, nb, nb]`` uint8. Plans and layouts live on the device
in a bounded cache keyed like the JAX one (the layout's digest, shape, fine
block and tile, and the device), uploaded once per layout.

``block_sparse_attention_fwd`` and ``block_sparse_attention_bwd`` launch
the kernels for CUDA tensors and count their launches; each takes its plain
PyTorch version (``block_sparse_attention_plain``,
``block_sparse_attention_bwd_plain``: the kernels' 64-row sub-tiles of each
visited coarse tile, their update order and rounding points) only for
tensors on the CPU. ``delta = rowsum(dO * O)`` is computed in torch, as the
JAX ``_bwd`` does outside its kernels. ``BlockSparseAttention`` is the
autograd ``Function``. What bounds each kernel on the H100 and what its
design does about it is noted in its CUDA source.

bf16 and f16 up to head dim 128 run on the tensor-core kernels
(:func:`tensor_core_path` asks the kernels' own dispatch), which skip dead
64 x 64 sub-tiles and, with a fine block that is a multiple of 16, dead
16 x 16 steps, where no bit of the result depends on them. That needs to
know which fine rows have a live block at all (the device plan's
``live_rows``, ``layout.any(-1)``): a row without one keeps the TPU's
result (the mean of V over the visited columns, p = 1 on its masked
columns in the backward), so its tiles are all computed. Asked with
``tensor_core=True``, the plain versions repeat the tensor-core kernels'
arithmetic as the flash attention's plain versions do (S and dP summed as
the tensor cores sum them, ``mma_scores``; the softmax in the log2
domain): the kernel checks on the card ask for it where the kernels take
the tensor cores. By default they sum with ``torch.matmul`` and the
natural-log softmax (the scalar kernels' arithmetic).
"""

import ctypes
import hashlib
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from .flash_attention import (DTYPE_CODES, LN2, LOG2E, MAX_HEAD_DIM,
                              NEG_INF, _f32, _logits, attention_delta,
                              check_on_card, kernel_route, mma_scores)

SUB = 64            # the kernels' q-row and k-row sub-tiles of a coarse tile
# the JAX package's bound on fine blocks per coarse tile (the rows of its
# (8, 128) fine window), kept so that tiles and the dispatch match
_MAX_FINE_PER_TILE = 8


class _Plan(NamedTuple):
    """Host-side routing plan for one (layout, tile) pair."""
    kcols: np.ndarray      # [H, nt, max_nnz] i32 — live key-tile ids (padded
    #                        with the last live id)
    nnz: np.ndarray        # [H, nt] i32
    qrows_t: np.ndarray    # [H, nt, max_nnz_t] i32 — transposed plan
    nnz_t: np.ndarray      # [H, nt] i32
    coarse: np.ndarray     # [H, nt, nt] bool
    tile: int
    fine_block: int


def build_plan(layout: np.ndarray, fine_block: int, tile: int) -> _Plan:
    layout = np.asarray(layout, bool)
    h, nb, _ = layout.shape
    r = tile // fine_block
    if tile % fine_block or nb % r:
        raise ValueError(f"tile {tile} incompatible with layout blocks "
                         f"{fine_block} x {nb}")
    nt = nb // r
    coarse = layout.reshape(h, nt, r, nt, r).any(axis=(2, 4))

    def compact(mat):  # [H, nt, nt] -> padded index lists along last dim
        nnz = mat.sum(-1).astype(np.int32)
        width = max(1, int(nnz.max()))
        idx = np.zeros((h, nt, width), np.int32)
        for hh in range(h):
            for i in range(nt):
                cols = np.nonzero(mat[hh, i])[0]
                idx[hh, i, :len(cols)] = cols
                if len(cols):          # pad with a live id
                    idx[hh, i, len(cols):] = cols[-1]
        return idx, nnz

    kcols, nnz = compact(coarse)
    qrows_t, nnz_t = compact(coarse.transpose(0, 2, 1))
    return _Plan(kcols, nnz, qrows_t, nnz_t, coarse, tile, fine_block)


def default_tile(t: int, fine_block: int) -> int:
    for cand in (256, 128):
        if (t % cand == 0 and cand % fine_block == 0 and cand <= t and
                cand // fine_block <= _MAX_FINE_PER_TILE):
            return cand
    return fine_block if fine_block >= 128 else 0


def supported(q, layout, fine_block: int, tile: int = 0) -> bool:
    """The JAX kernel's envelope; for CUDA tensors also a coarse tile that
    is a multiple of the Hopper kernels' 64-row sub-tiles (every tile of a
    fine block of 16, 32, 64, 128 or 256; only a fine block >= 128 that is
    not a multiple of 64 is its own tile and is left out). The layout has
    a row a head of ``q`` (a tensor-parallel rank's rows of the whole
    layout at its heads)."""
    t, d = q.shape[-2], q.shape[-1]
    tile = tile or default_tile(t, fine_block)
    if tile < 128:
        return False
    if tile // fine_block > _MAX_FINE_PER_TILE:
        return False
    if q.device.type == "cuda" and tile % SUB:
        return False
    lay = np.asarray(layout)
    nb = lay.shape[-1]
    return (q.ndim == 4 and (lay.ndim != 3 or lay.shape[0] == q.shape[1])
            and t % tile == 0 and d % 8 == 0 and d <= 256 and
            nb * fine_block == t)


# ------------------------------------------------------------ device plans

class DevicePlan(NamedTuple):
    """A plan and its fine layout as tensors on one device: ``kcols``,
    ``nnz``, ``qrows_t``, ``nnz_t`` int32, ``layout`` ``[H, nb, nb]`` uint8
    and ``live_rows`` ``[H, nb]`` uint8 (1 where the fine row has a live
    block: ``layout.any(-1)``, which the tensor-core kernels' skips need),
    all contiguous."""
    kcols: torch.Tensor
    nnz: torch.Tensor
    qrows_t: torch.Tensor
    nnz_t: torch.Tensor
    layout: torch.Tensor
    tile: int
    fine_block: int
    live_rows: torch.Tensor

    @classmethod
    def from_plan(cls, plan: _Plan, layout, device):
        def put(x, dtype=torch.int32):
            return torch.from_numpy(np.ascontiguousarray(x)).to(
                device=device, dtype=dtype)
        layout = np.asarray(layout, bool)
        return cls(put(plan.kcols), put(plan.nnz), put(plan.qrows_t),
                   put(plan.nnz_t), put(layout.astype(np.uint8), torch.uint8),
                   plan.tile, plan.fine_block,
                   put(layout.any(-1).astype(np.uint8), torch.uint8))


_PLAN_CACHE = OrderedDict()
_PLAN_CACHE_MAX = 32


def get_plan(layout, fine_block: int, tile: int, device) -> DevicePlan:
    """The device plan of ``layout`` at (fine_block, tile) on ``device``,
    built and uploaded at its first use, keyed as the JAX package's (the
    layout's digest and shape, the fine block, the tile) and the device; a
    bounded FIFO, as the JAX package's."""
    layout = np.asarray(layout, bool)
    device = torch.device(device)
    key = (hashlib.sha1(np.ascontiguousarray(layout).tobytes()).hexdigest(),
           layout.shape, fine_block, tile, str(device))
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        while len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
        plan = _PLAN_CACHE[key] = DevicePlan.from_plan(
            build_plan(layout, fine_block, tile), layout, device)
    return plan


# ------------------------------------------------------------ plain tiles

def _gathered(x, heads, idx, tile):
    """The f32 tiles ``idx`` [H, nt] of x [B, H, T, D], picked per (head,
    tile): [B, H, nt, tile, D]."""
    b, h, t, d = x.shape
    return x.to(torch.float32).reshape(b, h, t // tile, tile, d)[:, heads,
                                                                   idx]


def _keep(plan, heads, rows, cols):
    """The fine keep-mask of the coarse tiles (rows, cols), each [H, nt]:
    [H, nt, tile, tile] bool."""
    fb, tile = plan.fine_block, plan.tile
    (h, nt), r = plan.nnz.shape, tile // fb
    lay = plan.layout.to(torch.bool).reshape(h, nt, r, nt, r)
    win = lay[heads, rows, :, cols, :]                     # [H, nt, r, r]
    return win.repeat_interleave(fb, -2).repeat_interleave(fb, -1)


def _sub_tiles(tile):
    step = SUB if tile % SUB == 0 else tile
    return [slice(s, s + step) for s in range(0, tile, step)]


def block_sparse_attention_plain(q, k, v, plan: DevicePlan, scale,
                                 tensor_core=False):
    """K6's arithmetic in plain PyTorch over [B, H, T, D]: for each q tile,
    its live k tiles in the plan's order, each in 64-key sub-tiles, update
    f32 m, l and acc with the fine mask (-1e30), P rounded to the input
    type before P.V. With ``tensor_core`` the logits are the tensor cores'
    sums in log2 units and P = exp2(s - m), lse = m ln(2) + log(l), as the
    tensor-core kernel computes them (some 60x the time); without, S sums
    with ``torch.matmul`` (the scalar kernel's arithmetic). The kernels'
    skips change no bit, so this visits every sub-tile. Returns ``(out
    [B, H, T, D] in q's dtype, lse [B, H, T] f32)``."""
    b, h, t, d = q.shape
    tile, f32 = plan.tile, torch.float32
    nt = t // tile
    exp = torch.exp2 if tensor_core else torch.exp
    heads = torch.arange(h, device=q.device)[:, None]
    tiles = torch.arange(nt, device=q.device)[None, :]
    kcols, nnz = plan.kcols.long(), plan.nnz.long()
    qt = q.to(f32).reshape(b, h, nt, tile, d)
    m = torch.full((b, h, nt, tile, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qt)
    for j in range(kcols.shape[-1]):
        live = (j < nnz)[None, :, :, None, None]
        cols = kcols[:, :, j]
        kt = _gathered(k, heads, cols, tile)
        vt = _gathered(v, heads, cols, tile)
        keep = _keep(plan, heads, tiles, cols)
        for sub in _sub_tiles(tile):
            s = _logits(qt, kt[..., sub, :], scale, tensor_core)
            s = torch.where(keep[..., sub], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = exp(m - m_new)
            p = exp(s - m_new)
            l_new = l * alpha + p.sum(-1, keepdim=True)
            acc_new = acc * alpha + torch.matmul(p.to(q.dtype).to(f32),
                                                 vt[..., sub, :])
            m = torch.where(live, m_new, m)
            l = torch.where(live, l_new, l)
            acc = torch.where(live, acc_new, acc)
    lc = torch.clamp_min(l, 1e-30)
    out = (acc / lc).to(q.dtype).reshape(b, h, t, d)
    lse = m * LN2 + torch.log(lc) if tensor_core else m + torch.log(lc)
    return out, lse.reshape(b, h, t)


def block_sparse_attention_bwd_plain(q, k, v, dout, lse, delta,
                                     plan: DevicePlan, scale,
                                     tensor_core=False):
    """K7's arithmetic in plain PyTorch: ``dq`` over each q tile's live k
    tiles (64-key sub-tiles, in the plan's order), ``dk``/``dv`` over each k
    tile's live q tiles from the transposed plan (64-row sub-tiles), with
    ``p = exp(s - lse)``, ``ds = p (dO V^T - delta) scale``, P and dS
    rounded to the input type before their products and f32 sums. With
    ``tensor_core`` (as in :func:`block_sparse_attention_plain`) s and dp
    are the tensor cores' sums and ``p = exp2(s log2(e) - lse log2(e))``,
    as the tensor-core kernels compute them. Returns ``(dq, dk, dv)``, each
    [B, H, T, D] in q's dtype."""
    b, h, t, d = q.shape
    tile, f32, dt = plan.tile, torch.float32, q.dtype
    nt = t // tile
    exp = torch.exp2 if tensor_core else torch.exp
    if tensor_core:
        scale = _f32(scale)
        lse = lse * LOG2E
    heads = torch.arange(h, device=q.device)[:, None]
    tiles = torch.arange(nt, device=q.device)[None, :]
    lse_t = lse.reshape(b, h, nt, tile, 1)
    delta_t = delta.reshape(b, h, nt, tile, 1)

    def rounded(x):
        return x.to(dt).to(f32)

    def dp_of(dos, vs):
        return (mma_scores(dos, vs) if tensor_core else
                torch.matmul(dos, vs.transpose(-1, -2)))

    # dq: per q tile over its live k tiles
    qt = q.to(f32).reshape(b, h, nt, tile, d)
    dot = dout.to(f32).reshape(b, h, nt, tile, d)
    dq = torch.zeros_like(qt)
    kcols, nnz = plan.kcols.long(), plan.nnz.long()
    for j in range(kcols.shape[-1]):
        live = (j < nnz)[None, :, :, None, None]
        cols = kcols[:, :, j]
        kt = _gathered(k, heads, cols, tile)
        vt = _gathered(v, heads, cols, tile)
        keep = _keep(plan, heads, tiles, cols)
        for sub in _sub_tiles(tile):
            ks, vs = kt[..., sub, :], vt[..., sub, :]
            s = torch.where(keep[..., sub],
                            _logits(qt, ks, scale, tensor_core), NEG_INF)
            p = exp(s - lse_t)
            dp = dp_of(dot, vs)
            ds = rounded(p * (dp - delta_t) * scale)
            dq = torch.where(live, dq + torch.matmul(ds, ks), dq)

    # dk, dv: per k tile over its live q tiles
    kt = k.to(f32).reshape(b, h, nt, tile, d)
    vt = v.to(f32).reshape(b, h, nt, tile, d)
    dk, dv = torch.zeros_like(kt), torch.zeros_like(vt)
    qrows, nnz_t = plan.qrows_t.long(), plan.nnz_t.long()
    for j in range(qrows.shape[-1]):
        live = (j < nnz_t)[None, :, :, None, None]
        rows = qrows[:, :, j]
        qs_t = _gathered(q, heads, rows, tile)
        dos_t = _gathered(dout, heads, rows, tile)
        lse_r = lse_t[:, heads, rows]
        delta_r = delta_t[:, heads, rows]
        keep = _keep(plan, heads, rows, tiles)       # [H, nt, q, k]
        for sub in _sub_tiles(tile):
            qs, dos = qs_t[..., sub, :], dos_t[..., sub, :]
            s = torch.where(keep[..., sub, :],
                            _logits(qs, kt, scale, tensor_core), NEG_INF)
            p = exp(s - lse_r[..., sub, :])
            dv = torch.where(live, dv + torch.matmul(
                rounded(p).transpose(-1, -2), dos), dv)
            dp = dp_of(dos, vt)
            ds = rounded(p * (dp - delta_r[..., sub, :]) * scale)
            dk = torch.where(live, dk + torch.matmul(ds.transpose(-1, -2),
                                                     qs), dk)
    return tuple(x.to(dt).reshape(b, h, t, d) for x in (dq, dk, dv))


def tensor_core_path(dtype, d) -> bool:
    """Whether the block-sparse kernels take their tensor-core instances
    (forward and backward) for this dtype and head dim, as their own
    dispatch decides it (``tensor_core_route``, asked through the forward
    library's ``dstorch_block_sparse_tensor_cores``). Card only."""
    return kernel_route("block_sparse_attention_fwd",
                        "dstorch_block_sparse_tensor_cores", dtype, d)


# ------------------------------------------------------------- launchers

def _head_strides(x):
    return [x.stride(0), x.stride(1), x.stride(2)]


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _plan_args(plan: DevicePlan):
    return (plan.kcols.data_ptr(), plan.nnz.data_ptr(),
            plan.layout.data_ptr(), plan.live_rows.data_ptr(),
            plan.kcols.shape[-1], plan.tile, plan.fine_block)


def launch_fwd(q, k, v, out, lse, plan: DevicePlan, scale):
    """Launch K6 on [B, H, T, D] views (unit last stride) into ``out`` and
    ``lse`` ([B, H, T] f32, contiguous)."""
    from ..kernel_build import load
    fn = load("block_sparse_attention_fwd").dstorch_block_sparse_fwd
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 5 + [ptr] * 4 + [i] * 3 + [i] * 4 + \
            [ptr, ctypes.c_float, i, ptr]
        fn.restype = ctypes.c_int
    b, h, t, d = q.shape
    strides = (ctypes.c_longlong * 12)(
        *[s for x in (q, k, v, out) for s in _head_strides(x)])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), *_plan_args(plan), b, t, h, d, strides,
                 float(scale), DTYPE_CODES[q.dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"block_sparse_attention_fwd kernel launch failed "
                           f"with CUDA error {err}")


def launch_bwd(q, k, v, dout, lse, delta, dq, dk, dv, plan: DevicePlan,
               scale):
    """Launch K7 (the dk/dv kernel over the transposed plan, then the dq
    kernel) on [B, H, T, D] views; ``lse`` and ``delta`` are [B, H, T] f32,
    contiguous."""
    from ..kernel_build import load
    fn = load("block_sparse_attention_bwd").dstorch_block_sparse_bwd
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 9 + [ptr] * 4 + [i] * 3 + [ptr] * 2 + \
            [i] + [i] * 4 + [ptr, ctypes.c_float, i, ptr]
        fn.restype = ctypes.c_int
    b, h, t, d = q.shape
    strides = (ctypes.c_longlong * 21)(
        *[s for x in (q, k, v, dout, dq, dk, dv) for s in _head_strides(x)])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), *_plan_args(plan),
                 plan.qrows_t.data_ptr(), plan.nnz_t.data_ptr(),
                 plan.qrows_t.shape[-1], b, t, h, d, strides, float(scale),
                 DTYPE_CODES[q.dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"block_sparse_attention_bwd kernel launch failed "
                           f"with CUDA error {err}")


# ------------------------------------------------------------------ K6/K7

def _check(q, k, v, plan: DevicePlan):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"block-sparse attention wants q, k, v of one shape "
                         f"[B, H, T, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"block-sparse attention takes float32, bfloat16 or "
                        f"float16 q/k/v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device == plan.kcols.device):
        raise ValueError("q, k, v and the plan must lie on one device")
    _, h, t, d = q.shape
    lh, nb, _ = plan.layout.shape
    if lh != h or nb * plan.fine_block != t or t % plan.tile or \
            d % 8 or d > MAX_HEAD_DIM or \
            (q.device.type != "cpu" and plan.tile % SUB):
        raise ValueError(
            f"block-sparse attention does not support q {tuple(q.shape)} "
            f"with a [{lh}, {nb}, {nb}] layout of fine block "
            f"{plan.fine_block} and tile {plan.tile} (check supported() "
            f"before calling)")


def block_sparse_attention_fwd(q, k, v, plan: DevicePlan, scale):
    """Block-sparse attention over [B, H, T, D] q/k/v under ``plan``.
    Returns ``(out, lse)``: out [B, H, T, D] in q's dtype (a view of a
    [B, T, H, D] buffer on the card, so that merging the heads is free), lse
    [B, H, T] float32. Launches K6 for CUDA tensors and raises on anything
    it does not take; CPU tensors go through
    :func:`block_sparse_attention_plain`."""
    _check(q, k, v, plan)
    if q.device.type == "cpu":
        return block_sparse_attention_plain(q, k, v, plan, scale)
    check_on_card(q, k, v)
    b, h, t, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    launch_fwd(q, k, v, out, lse, plan, scale)
    block_sparse_attention_fwd.launches += 1
    return out, lse


block_sparse_attention_fwd.launches = 0


def block_sparse_attention_bwd(q, k, v, out, lse, dout, plan: DevicePlan,
                               scale):
    """The gradients ``(dq, dk, dv)`` of :func:`block_sparse_attention_fwd`,
    each [B, H, T, D] in q's dtype. Launches K7 for CUDA tensors and raises
    on anything it does not take; CPU tensors go through
    :func:`block_sparse_attention_bwd_plain`."""
    _check(q, k, v, plan)
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != q.shape[:3]:
        raise ValueError(
            f"block-sparse attention backward: out {tuple(out.shape)}, dout "
            f"{tuple(dout.shape)} and lse {tuple(lse.shape)} do not match q "
            f"{tuple(q.shape)}")
    if dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"dout must have q's dtype {q.dtype} and lse "
                        f"float32, got {dout.dtype} and {lse.dtype}")
    delta = attention_delta(out, dout)
    if q.device.type == "cpu":
        return block_sparse_attention_bwd_plain(q, k, v, dout, lse, delta,
                                                plan, scale)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    check_on_card(q, k, v, dout)
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    launch_bwd(q, k, v, dout, lse, delta, dq, dk, dv, plan, scale)
    block_sparse_attention_bwd.launches += 1
    return dq, dk, dv


block_sparse_attention_bwd.launches = 0


class BlockSparseAttention(torch.autograd.Function):
    """Block-sparse attention over [B, H, T, D] q, k, v: K6 forward (saving
    q, k, v, out and lse), K7 backward."""

    @staticmethod
    def forward(ctx, q, k, v, plan, scale):
        out, lse = block_sparse_attention_fwd(q, k, v, plan, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plan, ctx.scale = plan, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = block_sparse_attention_bwd(
            q, k, v, out, lse, dout.to(q.dtype), ctx.plan, ctx.scale)
        return dq, dk, dv, None, None


def sparse_attention_kernel(q, k, v, layout, fine_block: int,
                            softmax_scale=None, tile: int = 0):
    """Block-skipping sparse attention behind the SparsityConfig layout
    contract, as the JAX package's ``sparse_attention_pallas``. q/k/v:
    [B, H, T, D]; layout: [H, nb, nb] bool numpy. Differentiable."""
    t, d = q.shape[-2], q.shape[-1]
    tile = tile or default_tile(t, fine_block)
    if not supported(q, layout, fine_block, tile):
        raise ValueError(
            f"unsupported shapes for the block-sparse kernel: "
            f"t={t} d={d} tile={tile} fine_block={fine_block}")
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    plan = get_plan(layout, fine_block, tile, q.device)
    return BlockSparseAttention.apply(q, k, v, plan, scale)
