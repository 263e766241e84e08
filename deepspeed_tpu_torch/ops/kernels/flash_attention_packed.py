"""K1 and K2: the packed flash attention forward and backward, hand-written
Hopper kernels.

K1 replaces the TPU kernel ``_fwd_kernel`` and K2 the TPU kernel
``_bwd_kernel`` of ``deepspeed_tpu/ops/pallas/flash_attention_packed.py``
(the forward and the custom VJP of its ``packed_flash_attention``). q, k
and v are ``[B, T, H*D]`` (the column thirds of the ``[B, T, 3*H*D]`` qkv
projection, read in place through their strides); the output is
``[B, T, H*D]`` and lse is ``[B, H, T]`` f32.

``packed_flash_attention_fwd`` launches ``csrc/flash_attention_packed.cu``
and ``packed_flash_attention_bwd`` launches
``csrc/flash_attention_packed_bwd.cu`` for CUDA tensors. Each takes its
plain PyTorch version (``packed_flash_attention_plain``,
``packed_flash_attention_bwd_plain``: the kernel's 64-row tile loop and
rounding points) only for tensors on the CPU. ``PackedFlashAttention`` is
the autograd ``Function`` over one ``[B, T, 3*H*D]`` qkv tensor: K1 forward,
K2 backward, the gradient written straight into the thirds of one
``[B, T, 3*H*D]`` buffer. What bounds each kernel on the H100 and what its
design does about it is noted in its CUDA source.
"""

import ctypes

import torch

NEG_INF = -1e30
_LANES = 128
BLOCK_Q = BLOCK_K = 64     # the CUDA kernel's tiles, repeated by the plain version
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def supported(t: int, d: int, n_head: int, causal: bool, window) -> bool:
    """The TPU kernel's envelope, kept so both packages take the packed path
    for the same shapes: D divides 128, T % 128 == 0, T <= 4096,
    H % (128 / D) == 0, and a window only with causal attention."""
    if d > _LANES or _LANES % d or t % 128:
        return False
    if n_head % (_LANES // d):
        return False
    if window is not None and (not causal or window <= 0):
        return False
    return t <= 4096


def _check(q, k, v, n_head, causal, window):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"packed flash attention wants q, k, v of one shape "
                         f"[B, T, H*D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"packed flash attention takes float32, bfloat16 or "
                        f"float16 q/k/v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    b, t, hd_total = q.shape
    if hd_total % n_head:
        raise ValueError(f"H*D={hd_total} is not a multiple of n_head={n_head}")
    d = hd_total // n_head
    if not supported(t, d, n_head, causal, window):
        raise ValueError(
            f"packed flash attention does not support t={t} d={d} "
            f"n_head={n_head} causal={causal} window={window} (check "
            f"supported() before calling)")
    return b, t, d


def packed_flash_attention_fwd(q, k, v, n_head, causal=True,
                               softmax_scale=None, window=None):
    """Attention over packed ``[B, T, H*D]`` q/k/v. Returns ``(out, lse)``:
    out ``[B, T, H*D]`` in q's dtype, lse ``[B, H, T]`` float32. Launches the
    CUDA kernel for CUDA tensors and raises on anything it does not take;
    CPU tensors go through :func:`packed_flash_attention_plain`."""
    b, t, d = _check(q, k, v, n_head, causal, window)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return packed_flash_attention_plain(q, k, v, n_head, causal, scale,
                                            window)
    if q.device.type != "cuda":
        raise ValueError(f"packed flash attention runs on CUDA or CPU "
                         f"tensors, got {q.device}")
    for x in (q, k, v):
        if x.stride() != q.stride() or x.stride(-1) != 1:
            raise ValueError(
                f"q, k and v must share strides with a unit last stride "
                f"(views of one qkv projection or contiguous), got "
                f"{q.stride()}, {k.stride()}, {v.stride()}")
    out = torch.empty((b, t, n_head * d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n_head, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, t, n_head, d, q.stride(0), q.stride(1),
            float(scale), int(causal), int(window or 0), _DTYPE_CODES[q.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_packed kernel launch failed "
                           f"with CUDA error {err}")
    packed_flash_attention_fwd.launches += 1
    return out, lse


packed_flash_attention_fwd.launches = 0


def packed_flash_attention(q, k, v, n_head, causal=True, softmax_scale=None,
                           window=None):
    """The attention output alone, in the packed layout."""
    return packed_flash_attention_fwd(q, k, v, n_head, causal, softmax_scale,
                                      window)[0]


def _launcher():
    from ..kernel_build import load
    fn = load("flash_attention_packed").dstorch_flash_attention_packed_fwd
    if fn.argtypes is None:
        ptr, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i, i, i, i, i64, i64,
                       ctypes.c_float, i, i, i, ptr]
        fn.restype = ctypes.c_int
    return fn


def _bwd_launcher():
    from ..kernel_build import load
    fn = load("flash_attention_packed_bwd").dstorch_flash_attention_packed_bwd
    if fn.argtypes is None:
        ptr, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr] * 9 + [i, i, i, i] + [i64] * 6 + \
            [ctypes.c_float, i, i, i, ptr]
        fn.restype = ctypes.c_int
    return fn


def _q_tiles_visiting(j, nq, causal, window):
    """The q tiles whose K loop in the kernel reaches k tile ``j``: tile i
    runs j0(i) <= j < nk(i), a contiguous range of i."""
    def visits(i):
        q_off = i * BLOCK_Q
        nk = -(-(q_off + BLOCK_Q) // BLOCK_K) if causal else None
        j0 = (max(q_off - window + 1, 0) // BLOCK_K
              if causal and window is not None else 0)
        return j0 <= j and (nk is None or j < nk)
    tiles = [i for i in range(nq) if visits(i)]
    return (tiles[0], tiles[-1] + 1) if tiles else (0, 0)


def packed_flash_attention_plain(q, k, v, n_head, causal=True, scale=None,
                                 window=None):
    """The kernel's arithmetic in plain PyTorch: for each 64-row k tile, the
    q tiles that reach it update their f32 running max, sum and accumulator;
    P is rounded to the input dtype before P.V. Returns ``(out, lse)`` as
    :func:`packed_flash_attention_fwd` does."""
    b, t, hd_total = q.shape
    d = hd_total // n_head
    scale = scale if scale is not None else d ** -0.5

    def heads(x):                                   # [B, H, T, D], a view
        return x.view(b, t, n_head, d).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    f32 = torch.float32
    m = torch.full((b, n_head, t, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, n_head, t, 1), dtype=f32, device=q.device)
    acc = torch.zeros((b, n_head, t, d), dtype=f32, device=q.device)
    pos = torch.arange(t, device=q.device)
    for j in range(t // BLOCK_K):
        lo, hi = _q_tiles_visiting(j, t // BLOCK_Q, causal, window)
        if lo == hi:
            continue
        rows = slice(lo * BLOCK_Q, hi * BLOCK_Q)
        cols = slice(j * BLOCK_K, (j + 1) * BLOCK_K)
        s = torch.matmul(qh[:, :, rows].to(f32),
                         kh[:, :, cols].to(f32).transpose(-1, -2)) * scale
        if causal:
            q_pos, k_pos = pos[rows, None], pos[None, cols]
            keep = q_pos >= k_pos
            if window is not None:
                keep &= (q_pos - k_pos) < window
            s = torch.where(keep, s, NEG_INF)
        m_old = m[:, :, rows]
        m_new = torch.maximum(m_old, s.amax(-1, keepdim=True))
        alpha = torch.exp(m_old - m_new)
        p = torch.exp(s - m_new)
        l[:, :, rows] = l[:, :, rows] * alpha + p.sum(-1, keepdim=True)
        acc[:, :, rows] = acc[:, :, rows] * alpha + torch.matmul(
            p.to(q.dtype).to(f32), vh[:, :, cols].to(f32))
        m[:, :, rows] = m_new
    lc = torch.clamp_min(l, 1e-30)
    out = (acc / lc).to(q.dtype).transpose(1, 2).reshape(b, t, hd_total)
    return out, (m + torch.log(lc)).squeeze(-1)


# --------------------------------------------------------------------- K2

def attention_delta(out, dout, n_head):
    """``delta = rowsum(dO * O)`` per head, ``[B, H, T]`` float32, as the
    JAX package computes it outside its backward kernel."""
    b, t, hd_total = out.shape
    prod = dout.to(torch.float32) * out.to(torch.float32)
    return prod.view(b, t, n_head, hd_total // n_head).sum(-1) \
        .transpose(1, 2).contiguous()


def packed_flash_attention_bwd(qkv, out, lse, dout, n_head, causal=True,
                               softmax_scale=None, window=None):
    """The gradient of K1 with respect to its packed ``[B, T, 3*H*D]`` qkv
    input: one ``[B, T, 3*H*D]`` tensor holding dq, dk and dv in its column
    thirds, in qkv's dtype. ``out`` and ``lse`` are K1's outputs, ``dout``
    the gradient of ``out``. Launches the CUDA kernel for CUDA tensors and
    raises on anything it does not take; CPU tensors go through
    :func:`packed_flash_attention_bwd_plain`."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"packed flash attention backward wants qkv of shape "
                         f"[B, T, 3*H*D], got {tuple(qkv.shape)}")
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    b, t, d = _check(q, k, v, n_head, causal, window)
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (b, n_head, t):
        raise ValueError(
            f"packed flash attention backward: out {tuple(out.shape)}, dout "
            f"{tuple(dout.shape)} and lse {tuple(lse.shape)} do not match q "
            f"{tuple(q.shape)}")
    if dout.dtype != qkv.dtype or lse.dtype != torch.float32:
        raise TypeError(f"dout must have qkv's dtype {qkv.dtype} and lse "
                        f"float32, got {dout.dtype} and {lse.dtype}")
    if any(x.device != qkv.device for x in (out, lse, dout)):
        raise ValueError("qkv, out, lse and dout must lie on one device")
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    delta = attention_delta(out, dout, n_head)
    if qkv.device.type == "cpu":
        grads = packed_flash_attention_bwd_plain(
            q, k, v, dout, lse, delta, n_head, causal, scale, window)
        return torch.cat(grads, dim=-1)
    if qkv.device.type != "cuda":
        raise ValueError(f"packed flash attention runs on CUDA or CPU "
                         f"tensors, got {qkv.device}")
    if qkv.stride(-1) != 1:
        raise ValueError(f"qkv must have a unit last stride, got "
                         f"{qkv.stride()}")
    dout = dout.contiguous()
    lse = lse.contiguous()
    dqkv = torch.empty((b, t, 3 * n_head * d), dtype=qkv.dtype,
                       device=qkv.device)
    dq, dk, dv = dqkv.split(n_head * d, dim=-1)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = _bwd_launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, t, n_head, d, qkv.stride(0), qkv.stride(1),
            dout.stride(0), dout.stride(1), dqkv.stride(0), dqkv.stride(1),
            float(scale), int(causal), int(window or 0),
            _DTYPE_CODES[qkv.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_packed_bwd kernel launch failed "
                           f"with CUDA error {err}")
    packed_flash_attention_bwd.launches += 1
    return dqkv


packed_flash_attention_bwd.launches = 0


def packed_flash_attention_bwd_plain(q, k, v, dout, lse, delta, n_head,
                                     causal=True, scale=None, window=None):
    """The kernel's arithmetic in plain PyTorch. For each 64-row k tile, the
    q tiles that reach it compute ``p = exp(s - lse)``, ``dv += round(p)^T
    dO``, ``ds = p (dO V^T - delta) scale``, ``dk += round(ds)^T Q`` and
    ``dq += round(ds) K`` (dq summed over the k tiles in ascending order,
    as the dq kernel does), with ``round`` to the input dtype and f32 sums.
    Returns ``(dq, dk, dv)``, each ``[B, T, H*D]`` in q's dtype."""
    b, t, hd_total = q.shape
    d = hd_total // n_head
    scale = scale if scale is not None else d ** -0.5
    f32, dt = torch.float32, q.dtype

    def heads(x):                                   # [B, H, T, D] f32
        return x.view(b, t, n_head, d).transpose(1, 2).to(f32)

    qh, kh, vh, doh = heads(q), heads(k), heads(v), heads(dout)
    dq, dk, dv = (torch.zeros_like(qh) for _ in range(3))
    pos = torch.arange(t, device=q.device)
    for j in range(t // BLOCK_K):
        lo, hi = _q_tiles_visiting(j, t // BLOCK_Q, causal, window)
        if lo == hi:
            continue
        rows = slice(lo * BLOCK_Q, hi * BLOCK_Q)
        cols = slice(j * BLOCK_K, (j + 1) * BLOCK_K)
        s = torch.matmul(qh[:, :, rows], kh[:, :, cols].transpose(-1, -2)) \
            * scale
        if causal:
            q_pos, k_pos = pos[rows, None], pos[None, cols]
            keep = q_pos >= k_pos
            if window is not None:
                keep &= (q_pos - k_pos) < window
            s = torch.where(keep, s, NEG_INF)
        p = torch.exp(s - lse[:, :, rows, None])
        dv[:, :, cols] = torch.matmul(p.to(dt).to(f32).transpose(-1, -2),
                                      doh[:, :, rows])
        dp = torch.matmul(doh[:, :, rows], vh[:, :, cols].transpose(-1, -2))
        ds = (p * (dp - delta[:, :, rows, None]) * scale).to(dt).to(f32)
        dk[:, :, cols] = torch.matmul(ds.transpose(-1, -2), qh[:, :, rows])
        dq[:, :, rows] += torch.matmul(ds, kh[:, :, cols])

    def packed(x):
        return x.to(dt).transpose(1, 2).reshape(b, t, hd_total)

    return packed(dq), packed(dk), packed(dv)


class PackedFlashAttention(torch.autograd.Function):
    """Attention over one packed ``[B, T, 3*H*D]`` qkv tensor: K1 forward
    (saving qkv, out and lse), K2 backward. The gradient is one
    ``[B, T, 3*H*D]`` tensor written by K2 through the strides K1 reads, so
    autograd makes no copy to join the q, k and v gradients."""

    @staticmethod
    def forward(ctx, qkv, n_head, causal, softmax_scale, window):
        q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
        out, lse = packed_flash_attention_fwd(q, k, v, n_head, causal,
                                              softmax_scale, window)
        ctx.save_for_backward(qkv, out, lse)
        ctx.attn_args = (n_head, causal, softmax_scale, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        dqkv = packed_flash_attention_bwd(qkv, out, lse, dout.to(qkv.dtype),
                                          *ctx.attn_args)
        return dqkv, None, None, None, None


def packed_flash_attention_qkv(qkv, n_head, causal=True, softmax_scale=None,
                               window=None):
    """Differentiable packed attention of a ``[B, T, 3*H*D]`` qkv
    projection; returns ``[B, T, H*D]``."""
    return PackedFlashAttention.apply(qkv, n_head, causal, softmax_scale,
                                      window)
