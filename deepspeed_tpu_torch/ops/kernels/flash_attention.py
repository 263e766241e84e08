"""K3/K4 and K3b/K5/K4b: the ``[B, H, T, D]`` flash attention forward and
backward, hand-written Hopper kernels.

The forward replaces the TPU kernels of
``deepspeed_tpu/ops/pallas/flash_attention.py`` for both of its regimes:
``_fwd_kernel`` (K3, K/V resident in VMEM) and, where a head's K/V exceed
``_RESIDENT_MAX_KV_BYTES`` (``T * D * itemsize > 1 MiB``, LLaMA past
T = 4096 in bf16), ``_fwd_kernel_streamed`` (K4, K/V blocks on a third
grid axis). All compute one function with the same -1e30 fill, update
order and ``l >= 1e-30`` clamp, and the Hopper kernel streams 64-row K/V
tiles through shared memory at any T, so one kernel serves both. The
backward likewise replaces the resident fused ``_bwd_fused_kernel`` (K3b,
the default), the split ``_bwd_dq_kernel`` + ``_bwd_dkv_kernel`` (K5,
``DSTPU_FLASH_BWD`` set to anything but ``fused``) and the streamed
``_bwd_dq_kernel_streamed`` + ``_bwd_dkv_kernel_streamed`` (K4b): K5's
split is the Hopper design. Each wrapper counts its launches by regime:
``launches`` for the resident one (K3, K3b/K5) and ``streamed_launches``
for the streamed one (K4, K4b), so that a run can show which TPU kernel a
path stood for. The kernels are the ones K1/K2 use (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``), given ``[B, H, T, D]`` strides instead of
packed ones: q, k, v, o and every gradient are read and written through
their own (batch, head, token) strides with a unit last stride, so any
such view is taken without a copy.

``flash_attention_fwd`` and ``flash_attention_bwd`` launch the kernels for
CUDA tensors and count their launches; each takes its plain PyTorch version
(``flash_attention_plain``, ``flash_attention_bwd_plain``: the kernels'
64-row tile loop and rounding points) only for tensors on the CPU.
``delta = rowsum(dO * O)`` is computed in torch, as the JAX ``_bwd`` does
outside its kernels. ``FlashAttention`` is the autograd ``Function``.

The launchers and plain versions here serve K1/K2 too
(``flash_attention_packed.py`` views its packed tensors as ``[B, H, T, D]``).
What bounds each kernel on the H100 and what its design does about it is
noted in its CUDA source.
"""

import ctypes

import torch

NEG_INF = -1e30
BLOCK_Q = BLOCK_K = 64     # the CUDA kernels' tiles, repeated by the plain versions
MAX_HEAD_DIM = 256
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# above this K/V footprint per head the JAX package streams K/V through its
# grid (K4/K4b) instead of keeping it resident (K3/K3b/K5)
_RESIDENT_MAX_KV_BYTES = 1 << 20


def streamed(q) -> bool:
    """True where the JAX package takes its streamed kernels (K4/K4b)."""
    return q.shape[-2] * q.shape[-1] * q.element_size() > \
        _RESIDENT_MAX_KV_BYTES


def _count(fn, q):
    """One more launch of ``fn`` in q's regime."""
    if streamed(q):
        fn.streamed_launches += 1
    else:
        fn.launches += 1


# ------------------------------------------------------------- launchers

def _head_strides(x):
    """(batch, head, token) strides of a [B, H, T, D] view."""
    return [x.stride(0), x.stride(1), x.stride(2)]


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def launch_fwd(q, k, v, out, lse, causal, scale, window):
    """Launch the forward kernel on [B, H, T, D] views (any strides, unit
    last stride) into ``out`` (same shape) and ``lse`` ([B, H, T] f32,
    contiguous). The caller has checked shapes, types and devices."""
    from ..kernel_build import load
    fn = load("flash_attention_fwd").dstorch_flash_attention_fwd
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 5 + [i] * 4 + [ptr, ctypes.c_float, i, i, i,
                                             ptr]
        fn.restype = ctypes.c_int
    b, h, t, d = q.shape
    strides = (ctypes.c_longlong * 12)(
        *[s for x in (q, k, v, out) for s in _head_strides(x)])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, t, h, d, strides, float(scale),
                 int(causal), int(window or 0), DTYPE_CODES[q.dtype],
                 _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed with "
                           f"CUDA error {err}")


def launch_bwd(q, k, v, dout, lse, delta, dq, dk, dv, causal, scale,
               window):
    """Launch the backward kernels on [B, H, T, D] views (any strides, unit
    last stride); ``lse`` and ``delta`` are [B, H, T] f32, contiguous."""
    from ..kernel_build import load
    fn = load("flash_attention_bwd").dstorch_flash_attention_bwd
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 9 + [i] * 4 + [ptr, ctypes.c_float, i, i, i,
                                             ptr]
        fn.restype = ctypes.c_int
    b, h, t, d = q.shape
    strides = (ctypes.c_longlong * 21)(
        *[s for x in (q, k, v, dout, dq, dk, dv) for s in _head_strides(x)])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b, t, h, d, strides,
                 float(scale), int(causal), int(window or 0),
                 DTYPE_CODES[q.dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed with "
                           f"CUDA error {err}")


def check_on_card(*xs):
    """Raise unless every tensor lies on one CUDA device with a unit last
    stride (the kernels' only layout requirement)."""
    if xs[0].device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got "
                         f"{xs[0].device}")
    for x in xs:
        if x.device != xs[0].device:
            raise ValueError("flash attention tensors must lie on one device")
        if x.stride(-1) != 1:
            raise ValueError(f"flash attention wants a unit last stride, got "
                             f"strides {x.stride()}")


# ------------------------------------------------------------ plain tiles

def _q_tiles_visiting(j, nq, causal, window):
    """The q tiles whose K loop in the forward kernel reaches k tile ``j``:
    tile i runs j0(i) <= j < nk(i), a contiguous range of i."""
    def visits(i):
        q_off = i * BLOCK_Q
        nk = -(-(q_off + BLOCK_Q) // BLOCK_K) if causal else None
        j0 = (max(q_off - window + 1, 0) // BLOCK_K
              if causal and window is not None else 0)
        return j0 <= j and (nk is None or j < nk)
    tiles = [i for i in range(nq) if visits(i)]
    return (tiles[0], tiles[-1] + 1) if tiles else (0, 0)


def _tiles(t, causal, window, device):
    """(rows, cols, keep-mask or None) of every k tile the kernels visit,
    in ascending order."""
    pos = torch.arange(t, device=device)
    for j in range(t // BLOCK_K):
        lo, hi = _q_tiles_visiting(j, t // BLOCK_Q, causal, window)
        if lo == hi:
            continue
        rows = slice(lo * BLOCK_Q, hi * BLOCK_Q)
        cols = slice(j * BLOCK_K, (j + 1) * BLOCK_K)
        keep = None
        if causal:
            q_pos, k_pos = pos[rows, None], pos[None, cols]
            keep = q_pos >= k_pos
            if window is not None:
                keep &= (q_pos - k_pos) < window
        yield rows, cols, keep


def flash_attention_plain(q, k, v, causal=True, scale=None, window=None):
    """The forward kernel's arithmetic in plain PyTorch over [B, H, T, D]:
    for each 64-row k tile, the q tiles that reach it update their f32
    running max, sum and accumulator; P is rounded to the input dtype before
    P.V. Returns ``(out [B, H, T, D] in q's dtype, lse [B, H, T] f32)``."""
    b, h, t, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    f32 = torch.float32
    m = torch.full((b, h, t, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, h, t, 1), dtype=f32, device=q.device)
    acc = torch.zeros((b, h, t, d), dtype=f32, device=q.device)
    for rows, cols, keep in _tiles(t, causal, window, q.device):
        s = torch.matmul(q[:, :, rows].to(f32),
                         k[:, :, cols].to(f32).transpose(-1, -2)) * scale
        if keep is not None:
            s = torch.where(keep, s, NEG_INF)
        m_old = m[:, :, rows]
        m_new = torch.maximum(m_old, s.amax(-1, keepdim=True))
        alpha = torch.exp(m_old - m_new)
        p = torch.exp(s - m_new)
        l[:, :, rows] = l[:, :, rows] * alpha + p.sum(-1, keepdim=True)
        acc[:, :, rows] = acc[:, :, rows] * alpha + torch.matmul(
            p.to(q.dtype).to(f32), v[:, :, cols].to(f32))
        m[:, :, rows] = m_new
    lc = torch.clamp_min(l, 1e-30)
    return (acc / lc).to(q.dtype), (m + torch.log(lc)).squeeze(-1)


def attention_delta(out, dout):
    """``delta = rowsum(dO * O)`` over [B, H, T, D], ``[B, H, T]`` float32
    and contiguous, as the JAX package computes it outside its backward
    kernels."""
    return (dout.to(torch.float32) * out.to(torch.float32)).sum(-1) \
        .contiguous()


def flash_attention_bwd_plain(q, k, v, dout, lse, delta, causal=True,
                              scale=None, window=None):
    """The backward kernels' arithmetic in plain PyTorch over [B, H, T, D].
    For each 64-row k tile, the q tiles that reach it compute
    ``p = exp(s - lse)``, ``dv += round(p)^T dO``,
    ``ds = p (dO V^T - delta) scale``, ``dk += round(ds)^T Q`` and
    ``dq += round(ds) K`` (dq summed over the k tiles in ascending order, as
    the dq kernel does), with ``round`` to the input dtype and f32 sums.
    Returns ``(dq, dk, dv)``, each [B, H, T, D] in q's dtype."""
    b, h, t, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    f32, dt = torch.float32, q.dtype
    qf, kf, vf, dof = (x.to(f32) for x in (q, k, v, dout))
    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    for rows, cols, keep in _tiles(t, causal, window, q.device):
        s = torch.matmul(qf[:, :, rows], kf[:, :, cols].transpose(-1, -2)) \
            * scale
        if keep is not None:
            s = torch.where(keep, s, NEG_INF)
        p = torch.exp(s - lse[:, :, rows, None])
        dv[:, :, cols] = torch.matmul(p.to(dt).to(f32).transpose(-1, -2),
                                      dof[:, :, rows])
        dp = torch.matmul(dof[:, :, rows], vf[:, :, cols].transpose(-1, -2))
        ds = (p * (dp - delta[:, :, rows, None]) * scale).to(dt).to(f32)
        dk[:, :, cols] = torch.matmul(ds.transpose(-1, -2), qf[:, :, rows])
        dq[:, :, rows] += torch.matmul(ds, kf[:, :, cols])
    return dq.to(dt), dk.to(dt), dv.to(dt)


# ------------------------------------------------------------------- K3

def _check(q, k, v, causal, window):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash attention wants q, k, v of one shape "
                         f"[B, H, T, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash attention takes float32, bfloat16 or float16 "
                        f"q/k/v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    t, d = q.shape[-2], q.shape[-1]
    if t < BLOCK_Q or t % BLOCK_Q or d > MAX_HEAD_DIM or \
            (window is not None and (not causal or window <= 0)):
        raise ValueError(
            f"flash attention does not support t={t} d={d} causal={causal} "
            f"window={window}: the kernels take T a multiple of {BLOCK_Q}, "
            f"D <= {MAX_HEAD_DIM} and a window only with causal attention "
            f"(check ops.flash_attention.supported() before calling)")
    return d


def flash_attention_fwd(q, k, v, causal=True, softmax_scale=None,
                        window=None):
    """Attention over [B, H, T, D] q/k/v. Returns ``(out, lse)``: out
    [B, H, T, D] in q's dtype (a view of a [B, T, H, D] buffer on the card,
    so that merging the heads afterwards is free), lse [B, H, T] float32.
    Launches the CUDA kernel for CUDA tensors and raises on anything it does
    not take; CPU tensors go through :func:`flash_attention_plain`."""
    d = _check(q, k, v, causal, window)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, window)
    check_on_card(q, k, v)
    b, h, t, _ = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    launch_fwd(q, k, v, out, lse, causal, scale, window)
    _count(flash_attention_fwd, q)
    return out, lse


flash_attention_fwd.launches = flash_attention_fwd.streamed_launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                        softmax_scale=None, window=None):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention_fwd`, each
    [B, H, T, D] in q's dtype. ``out`` and ``lse`` are the forward's
    outputs, ``dout`` the gradient of ``out``. Launches the CUDA kernels
    for CUDA tensors and raises on anything they do not take; CPU tensors
    go through :func:`flash_attention_bwd_plain`."""
    d = _check(q, k, v, causal, window)
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != q.shape[:3]:
        raise ValueError(
            f"flash attention backward: out {tuple(out.shape)}, dout "
            f"{tuple(dout.shape)} and lse {tuple(lse.shape)} do not match q "
            f"{tuple(q.shape)}")
    if dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"dout must have q's dtype {q.dtype} and lse "
                        f"float32, got {dout.dtype} and {lse.dtype}")
    if any(x.device != q.device for x in (out, lse, dout)):
        raise ValueError("q, out, lse and dout must lie on one device")
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    delta = attention_delta(out, dout)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, lse, delta, causal,
                                         scale, window)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    check_on_card(q, k, v, dout)
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    launch_bwd(q, k, v, dout, lse, delta, dq, dk, dv, causal, scale, window)
    _count(flash_attention_bwd, q)
    return dq, dk, dv


flash_attention_bwd.launches = flash_attention_bwd.streamed_launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention over [B, H, T, D] q, k, v: the K3/K4 forward (saving q, k,
    v, out and lse), the K3b/K5/K4b backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softmax_scale, window):
        out, lse = flash_attention_fwd(q, k, v, causal, softmax_scale,
                                       window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attn_args = (causal, softmax_scale, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.to(q.dtype), *ctx.attn_args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=True, softmax_scale=None, window=None):
    """Differentiable attention over [B, H, T, D]; returns [B, H, T, D]."""
    return FlashAttention.apply(q, k, v, causal, softmax_scale, window)
