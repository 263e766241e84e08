"""K1 and K2: the packed flash attention forward and backward,
hand-written Hopper kernels.

K1 replaces the TPU kernel ``_fwd_kernel`` and K2 the TPU kernel
``_bwd_kernel`` of ``deepspeed_tpu/ops/pallas/flash_attention_packed.py``
(the forward and the custom VJP of its ``packed_flash_attention``). q, k
and v are ``[B, T, H*D]`` (the column thirds of the ``[B, T, 3*H*D]`` qkv
projection, read in place through their strides); the output is
``[B, T, H*D]`` and lse is ``[B, H, T]`` f32.

The kernels are the ``[B, H, T, D]`` flash attention kernels of
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``
(``flash_attention.py`` holds their launchers and plain versions), given
the packed layout's strides: a ``[B, T, H*D]`` tensor is viewed as
``[B, H, T, D]`` without a copy. ``packed_flash_attention_fwd`` and
``packed_flash_attention_bwd`` launch them for CUDA tensors and count their
own launches, apart from the ``[B, H, T, D]`` entry points'. Each takes its
plain PyTorch version (``packed_flash_attention_plain``,
``packed_flash_attention_bwd_plain``: the kernels' 64-row tile loop and
rounding points) only for tensors on the CPU. ``PackedFlashAttention`` is
the autograd ``Function`` over one ``[B, T, 3*H*D]`` qkv tensor: K1 forward,
K2 backward, the gradient written straight into the thirds of one
``[B, T, 3*H*D]`` buffer. What bounds each kernel on the H100 and what its
design does about it is noted in its CUDA source.
"""

import torch

from . import flash_attention as fa

_LANES = 128


def _heads(x, n_head):
    """A [B, T, H*D] tensor as [B, H, T, D] (a view wherever the layout
    allows one, as it does for the kernels' outputs)."""
    b, t, hd_total = x.shape
    return x.reshape(b, t, n_head, hd_total // n_head).transpose(1, 2)


def _packed(x):
    """A [B, H, T, D] tensor as [B, T, H*D]."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


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
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in fa.DTYPE_CODES:
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
    fa.check_on_card(q, k, v)
    out = torch.empty((b, t, n_head * d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n_head, t), dtype=torch.float32, device=q.device)
    fa.launch_fwd(_heads(q, n_head), _heads(k, n_head), _heads(v, n_head),
                  _heads(out, n_head), lse, causal, scale, window)
    packed_flash_attention_fwd.launches += 1
    return out, lse


packed_flash_attention_fwd.launches = 0


def packed_flash_attention(q, k, v, n_head, causal=True, softmax_scale=None,
                           window=None):
    """The attention output alone, in the packed layout."""
    return packed_flash_attention_fwd(q, k, v, n_head, causal, softmax_scale,
                                      window)[0]


def packed_flash_attention_plain(q, k, v, n_head, causal=True, scale=None,
                                 window=None, tensor_core=False):
    """The kernel's arithmetic in plain PyTorch
    (:func:`flash_attention.flash_attention_plain` on the ``[B, H, T, D]``
    views, ``tensor_core`` as there). Returns ``(out, lse)`` as
    :func:`packed_flash_attention_fwd` does."""
    out, lse = fa.flash_attention_plain(
        _heads(q, n_head), _heads(k, n_head), _heads(v, n_head), causal,
        scale, window, tensor_core)
    return _packed(out), lse


# --------------------------------------------------------------------- K2

def attention_delta(out, dout, n_head):
    """``delta = rowsum(dO * O)`` per head, ``[B, H, T]`` float32, as the
    JAX package computes it outside its backward kernel."""
    return fa.attention_delta(_heads(out, n_head), _heads(dout, n_head))


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
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    fa.check_on_card(qkv, dout)
    dqkv = torch.empty((b, t, 3 * n_head * d), dtype=qkv.dtype,
                       device=qkv.device)
    fa.launch_bwd(*(_heads(x, n_head) for x in (q, k, v, dout)),
                  lse.contiguous(), delta,
                  *(_heads(x, n_head) for x in dqkv.split(n_head * d, -1)),
                  causal, scale, window)
    packed_flash_attention_bwd.launches += 1
    return dqkv


packed_flash_attention_bwd.launches = 0


def packed_flash_attention_bwd_plain(q, k, v, dout, lse, delta, n_head,
                                     causal=True, scale=None, window=None,
                                     tensor_core=False):
    """The kernel's arithmetic in plain PyTorch
    (:func:`flash_attention.flash_attention_bwd_plain` on the
    ``[B, H, T, D]`` views, ``tensor_core`` as there). Returns
    ``(dq, dk, dv)``, each ``[B, T, H*D]`` in q's dtype."""
    grads = fa.flash_attention_bwd_plain(
        *(_heads(x, n_head) for x in (q, k, v, dout)), lse, delta, causal,
        scale, window, tensor_core)
    return tuple(_packed(g) for g in grads)


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
