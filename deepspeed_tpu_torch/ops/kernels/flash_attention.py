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

The bf16 and f16 forward runs on the tensor cores at every head dim:
``mma.sync`` up to 128, Hopper's ``wgmma`` at the 256 ceiling; the
backward up to 128, with its scalar pair at 256; f32 is scalar
(:func:`tensor_core_path` asks each direction's own dispatch). Asked with
``tensor_core=True``, the plain versions repeat two things of that
arithmetic that decide the input-type rounding of P and dS: S = Q K^T and
dP = dO V^T are summed as the tensor cores sum them (``mma_scores``), and
the softmax runs in the log2 domain (``exp2`` of the logits times
``scale * log2(e)``, both in float32), as the kernels compute it. A sum in
another order would move P or dS across a rounding boundary now and then,
and in a row with a small sum one such flip moves the output by several
rounding steps of its type; so the kernel checks on the card ask for it
where the kernels take the tensor cores (``wgmma`` sums its 16-deep steps
as ``mma.sync`` does, bit for bit on the card: ``kernel-check wgmma
sums``). By default the plain versions sum with ``torch.matmul`` and the
natural-log softmax, on every device: the scalar kernels' arithmetic (f32,
and the backward at the 256 ceiling), whose sequential f32 FMA chains
``torch.matmul`` repeats, and some 60x cheaper than the repeated
tensor-core sums.
"""

import ctypes

import numpy as np
import torch

NEG_INF = -1e30
BLOCK_Q = BLOCK_K = 64     # the CUDA kernels' tiles, repeated by the plain versions
MAX_HEAD_DIM = 256
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# above this K/V footprint per head the JAX package streams K/V through its
# grid (K4/K4b) instead of keeping it resident (K3/K3b/K5)
_RESIDENT_MAX_KV_BYTES = 1 << 20
# float32 log2(e) and ln(2), the tensor-core kernels' kLog2e and kLn2
LOG2E = float(np.float32(1.4426950408889634))
LN2 = float(np.float32(0.6931471805599453))
# the tensor cores' sum: addends aligned to the largest exponent, cut
# toward zero 2^-25 below it (mma_scores)
_MMA_ALIGN_BITS = 25
_MMA_STEP = 16             # products a mma.m16n8k16 adds per output
_NO_EXP = -(1 << 14)       # a zero's exponent: never the largest
_MMA_CHUNK = 1 << 27       # elements of [..., M, N, 16] held at once


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


# ------------------------------------------------ the tensor cores' sums

def kernel_route(library, entry, dtype, d) -> bool:
    """The answer of a kernel library's route entry (``entry(dtype code,
    head dim)``: 1 tensor cores, 0 scalar, -1 refused), which reports its
    own dispatch. Loads the library, so it answers on a machine that builds
    the kernels."""
    from ..kernel_build import load
    fn = getattr(load(library), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
    route = fn(DTYPE_CODES[dtype], int(d))
    if route not in (0, 1):
        raise ValueError(f"the {library} kernels take no {dtype} at head "
                         f"dim {d}")
    return bool(route)


def tensor_core_path(dtype, d, backward=False) -> bool:
    """Whether the forward (or, with ``backward``, the backward) kernels
    take their tensor-core instances for this dtype and head dim, as each
    direction's own dispatch decides it (``fwd_tensor_core_route`` and
    ``tensor_core_route`` in ``csrc/flash_attention_mma.cuh``), asked
    through its library's route entry:
    ``dstorch_flash_attention_tensor_cores`` or
    ``dstorch_flash_attention_bwd_tensor_cores``."""
    if backward:
        return kernel_route("flash_attention_bwd",
                            "dstorch_flash_attention_bwd_tensor_cores",
                            dtype, d)
    return kernel_route("flash_attention_fwd",
                        "dstorch_flash_attention_tensor_cores", dtype, d)


def _probe(entry, rows, a, b, c):
    """``c + a @ b^T`` for CUDA tiles ``a`` [n, rows, 16] and ``b``
    [n, 8, 16] (bf16 or f16) and ``c`` [n, rows, 8] float32, one product a
    tile by the forward library's probe ``entry``."""
    n = a.shape[0]
    if a.shape != (n, rows, 16) or b.shape != (n, 8, 16) or \
            c.shape != (n, rows, 8) or b.dtype != a.dtype or \
            a.dtype not in (torch.bfloat16, torch.float16) or \
            c.dtype != torch.float32:
        raise ValueError(f"{entry} wants a [n, {rows}, 16] and b [n, 8, 16] "
                         f"bf16/f16, c [n, {rows}, 8] f32; got {a.shape} "
                         f"{a.dtype}, {b.shape} {b.dtype}, {c.shape} "
                         f"{c.dtype}")
    check_on_card(a, b, c)
    from ..kernel_build import load
    fn = getattr(load("flash_attention_fwd"), entry)
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 4 + [i, i, ptr]
        fn.restype = ctypes.c_int
    a, b, c = (x.contiguous() for x in (a, b, c))
    d = torch.empty_like(c)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), n,
                 DTYPE_CODES[a.dtype], _stream(a))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {err}")
    return d


def mma_on_card(a, b, c):
    """``c + a @ b^T`` for CUDA tiles ``a`` [n, 16, 16] and ``b`` [n, 8, 16]
    (bf16 or f16) and ``c`` [n, 16, 8] float32, one
    ``mma.sync.m16n8k16`` a tile (the instruction of the ``mma.sync``
    kernels' products, ``dstorch_mma_probe``): the card's sums, which
    :func:`mma_step` models. On no attention path; not counted."""
    return _probe("dstorch_mma_probe", 16, a, b, c)


def wgmma_on_card(a, b, c):
    """``c + a @ b^T`` for CUDA tiles ``a`` [n, 64, 16] and ``b`` [n, 8, 16]
    (bf16 or f16) and ``c`` [n, 64, 8] float32, one ``wgmma.mma_async
    m64n8k16`` a tile with both operands read from shared memory through
    the D-256 forward's panel layout and descriptors
    (``dstorch_wgmma_probe``): the sums of that kernel's products, which
    :func:`mma_step` models too. On no attention path; not counted."""
    return _probe("dstorch_wgmma_probe", 64, a, b, c)


def _exponent(x):
    """floor(log2 |x|) of each float32 element, ``_NO_EXP`` for zeros."""
    e = torch.frexp(x).exponent - 1
    return torch.where(x == 0, _NO_EXP, e)


def _pow2(n, dtype):
    """2**n, exact, for integers n in dtype's normal range."""
    if dtype == torch.float32:
        return ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return ((n.to(torch.int64) + 1023) << 52).view(torch.float64)


def _to_f32_toward_zero(x):
    """float64 -> float32, rounded toward zero: where rounding to nearest
    went away from zero, the next float32 toward zero, whose bit pattern
    is one less for either sign (``torch.nextafter`` gives the same, much
    slower on the CPU)."""
    y = x.to(torch.float32)
    over = y.to(torch.float64).abs() > x.abs()
    return torch.where(over, (y.view(torch.int32) - 1).view(torch.float32),
                       y)


def mma_step(acc, a, b):
    """``acc + a @ b^T`` for one 16-column step: ``acc`` [..., M, N] f32,
    ``a`` [..., M, k], ``b`` [..., N, k] with k <= 16 values of the input
    type, summed as one ``mma.sync.aligned.m16n8k16`` (f32 accumulators)
    sums them on the H100: the k products are exact; each of them and
    ``acc`` is cut toward zero at 2^-25 of the largest exponent among them
    (a product's exponent is the sum of its factors' exponents, floor(log2
    |x|)); the cut values are added exactly and the sum is rounded toward
    zero to float32. Bit for bit the card's result on every recorded
    sample (``tests/data/mma_m16n8k16_h100.npz``)."""
    f32 = torch.float32
    a, b = a.to(f32), b.to(f32)
    prod = a.unsqueeze(-2) * b.unsqueeze(-3)              # [..., M, N, k]
    e = (_exponent(a).unsqueeze(-2) + _exponent(b).unsqueeze(-3)).amax(-1)
    emax = torch.maximum(e, _exponent(acc)).clamp_min(-100)
    shift = _MMA_ALIGN_BITS - emax       # the cut falls on integers
    up = _pow2(shift, f32)
    cut = (prod * up.unsqueeze(-1)).trunc_().sum(-1, dtype=torch.float64)
    cut += (acc * up).trunc_().to(torch.float64)
    return _to_f32_toward_zero(cut * _pow2(-shift, torch.float64))


def mma_scores(a, b):
    """``a @ b^T`` ([..., M, D] and [..., N, D] of the input type ->
    [..., M, N] float32) as the tensor-core kernels sum S = Q K^T and
    dP = dO V^T: 16-column steps of D in order (:func:`mma_step`), from a
    zero accumulator; rows in chunks to bound the [..., M, N, 16]
    products held at once."""
    n = b.shape[-2] * _MMA_STEP * max(1, a[..., :1, :1].numel())
    rows = max(1, _MMA_CHUNK // n)
    out = []
    for r in range(0, a.shape[-2], rows):
        ar = a[..., r:r + rows, :]
        acc = torch.zeros(ar.shape[:-1] + (b.shape[-2],), dtype=torch.float32,
                          device=a.device)
        for c in range(0, a.shape[-1], _MMA_STEP):
            acc = mma_step(acc, ar[..., c:c + _MMA_STEP],
                           b[..., c:c + _MMA_STEP])
        out.append(acc)
    return torch.cat(out, dim=-2)


def _f32(x):
    """A Python float rounded to float32 (the kernels' float arguments)."""
    return float(np.float32(x))


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


def _logits(q, k, scale, tensor_core):
    """The kernels' scaled logits of q rows against k rows, float32: on the
    tensor-core path S summed as the tensor cores sum it, times
    ``scale * log2(e)`` (log2 units); else ``torch.matmul``, times
    ``scale``."""
    f32 = torch.float32
    if tensor_core:
        return mma_scores(q, k) * _f32(_f32(scale) * LOG2E)
    return torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * scale


def flash_attention_plain(q, k, v, causal=True, scale=None, window=None,
                          tensor_core=False):
    """The forward kernel's arithmetic in plain PyTorch over [B, H, T, D]:
    for each 64-row k tile, the q tiles that reach it update their f32
    running max, sum and accumulator; P is rounded to the input dtype before
    P.V. With ``tensor_core`` the logits are the tensor cores' sums in log2
    units and P = exp2(s - m), as the tensor-core kernel computes them
    (some 60x the time); without, S sums with ``torch.matmul`` (the scalar
    kernels' arithmetic). Returns ``(out [B, H, T, D] in q's dtype, lse
    [B, H, T] f32)``."""
    b, h, t, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    exp = torch.exp2 if tensor_core else torch.exp
    f32 = torch.float32
    m = torch.full((b, h, t, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, h, t, 1), dtype=f32, device=q.device)
    acc = torch.zeros((b, h, t, d), dtype=f32, device=q.device)
    for rows, cols, keep in _tiles(t, causal, window, q.device):
        s = _logits(q[:, :, rows], k[:, :, cols], scale, tensor_core)
        if keep is not None:
            s = torch.where(keep, s, NEG_INF)
        m_old = m[:, :, rows]
        m_new = torch.maximum(m_old, s.amax(-1, keepdim=True))
        alpha = exp(m_old - m_new)
        p = exp(s - m_new)
        l[:, :, rows] = l[:, :, rows] * alpha + p.sum(-1, keepdim=True)
        acc[:, :, rows] = acc[:, :, rows] * alpha + torch.matmul(
            p.to(q.dtype).to(f32), v[:, :, cols].to(f32))
        m[:, :, rows] = m_new
    lc = torch.clamp_min(l, 1e-30)
    lse = m * LN2 + torch.log(lc) if tensor_core else m + torch.log(lc)
    return (acc / lc).to(q.dtype), lse.squeeze(-1)


def attention_delta(out, dout):
    """``delta = rowsum(dO * O)`` over [B, H, T, D], ``[B, H, T]`` float32
    and contiguous, as the JAX package computes it outside its backward
    kernels."""
    return (dout.to(torch.float32) * out.to(torch.float32)).sum(-1) \
        .contiguous()


def flash_attention_bwd_plain(q, k, v, dout, lse, delta, causal=True,
                              scale=None, window=None, tensor_core=False):
    """The backward kernels' arithmetic in plain PyTorch over [B, H, T, D].
    For each 64-row k tile, the q tiles that reach it compute
    ``p = exp(s - lse)``, ``dv += round(p)^T dO``,
    ``ds = p (dO V^T - delta) scale``, ``dk += round(ds)^T Q`` and
    ``dq += round(ds) K`` (dq summed over the k tiles in ascending order, as
    the dq kernel does), with ``round`` to the input dtype and f32 sums.
    With ``tensor_core`` (as in :func:`flash_attention_plain`) s and dp are
    the tensor cores' sums and ``p = exp2(s log2(e) - lse log2(e))``, as
    the tensor-core kernels compute them. Returns ``(dq, dk, dv)``, each
    [B, H, T, D] in q's dtype."""
    b, h, t, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    f32, dt = torch.float32, q.dtype
    qf, kf, vf, dof = (x.to(f32) for x in (q, k, v, dout))
    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    exp = torch.exp2 if tensor_core else torch.exp
    if tensor_core:
        scale = _f32(scale)
        lse = lse * LOG2E
    for rows, cols, keep in _tiles(t, causal, window, q.device):
        s = _logits(q[:, :, rows], k[:, :, cols], scale, tensor_core)
        if keep is not None:
            s = torch.where(keep, s, NEG_INF)
        p = exp(s - lse[:, :, rows, None])
        dv[:, :, cols] = torch.matmul(p.to(dt).to(f32).transpose(-1, -2),
                                      dof[:, :, rows])
        dp = (mma_scores(dout[:, :, rows], v[:, :, cols]) if tensor_core else
              torch.matmul(dof[:, :, rows], vf[:, :, cols].transpose(-1, -2)))
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
