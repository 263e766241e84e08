"""Attention over ``[B, H, T, D]`` with backend dispatch.

``reference_attention`` is the plain path, masked exactly as the JAX
package's: logits filled with -1e30 (not -inf), the causal mask offset by
``t_k - t_q`` so the last query sees every key, an optional sliding
``window``, a boolean ``mask`` and an additive ``bias``, and the default
scale ``d ** -0.5``.

``flash_attention`` follows the JAX package's dispatch: where the JAX
package takes its ``[B, H, T, D]`` Pallas kernels, this port takes its
Hopper kernels (``kernels/flash_attention.py``) on the card, and their
plain versions on the CPU, as the JAX package runs its kernels in
interpret mode there. One Hopper forward and one backward stand for both
of the JAX package's regimes: the resident kernels (K3 forward, the K3b/K5
backward) and, above ``T * D * itemsize = 1 MiB``, the streamed long-T
kernels (K4, K4b); the wrappers count the two regimes' launches apart.
"""

import torch

from .kernels import flash_attention as fa
from .kernels.flash_attention import NEG_INF


def reference_attention(q, k, v, causal=True, mask=None, softmax_scale=None,
                        bias=None, window=None):
    """Plain attention. q, k, v: ``[B, H, T, D]`` (q may have Tq != Tk for
    decode). ``bias`` is an additive logits bias broadcastable to
    ``[B, H, Tq, Tk]``; ``window`` (with causal) keeps only keys with
    ``q_pos - k_pos < window``."""
    t_q, d = q.shape[-2], q.shape[-1]
    t_k = k.shape[-2]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    if window is not None and not causal:
        raise ValueError("sliding window requires causal=True")
    logits = (torch.matmul(q, k.transpose(-1, -2)) * scale).to(torch.float32)
    if bias is not None:
        logits = logits + bias.to(torch.float32)
    if causal:
        q_pos = torch.arange(t_q, device=q.device)[:, None] + (t_k - t_q)
        k_pos = torch.arange(t_k, device=q.device)[None, :]
        keep = q_pos >= k_pos
        if window is not None:
            keep &= (q_pos - k_pos) < window
        logits = torch.where(keep, logits, NEG_INF)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def supported(q, k, causal=True, mask=None, window=None) -> bool:
    """The JAX ``[B, H, T, D]`` Pallas kernels' envelope."""
    if mask is not None:
        return False
    if window is not None and (not causal or window <= 0):
        return False
    if q.dim() != 4 or q.shape[-2] != k.shape[-2]:
        return False
    if q.shape[1] != k.shape[1]:
        return False
    t, d = q.shape[-2], q.shape[-1]
    if t > 128 * 1024:
        return False
    return t >= 128 and t % 128 == 0 and d % 8 == 0 and d <= 256


def flash_attention(q, k, v, causal=True, mask=None, softmax_scale=None,
                    backend="auto", bias=None, window=None):
    """Dispatch as the JAX package does. ``backend="pallas"`` takes the
    kernel path and raises on an unsupported call; ``"xla"`` forces the
    plain path; ``"auto"`` takes the kernel path for supported shapes on the
    card and the plain path elsewhere (with a one-time warning on the
    card)."""
    if backend == "pallas":
        if bias is not None or not supported(q, k, causal, mask, window):
            raise ValueError(
                f"pallas flash attention does not support this call "
                f"(q={tuple(q.shape)} k={tuple(k.shape)} causal={causal} "
                f"mask={'yes' if mask is not None else 'no'} "
                f"bias={'yes' if bias is not None else 'no'} "
                f"window={window}); pass backend='xla' explicitly")
        return fa.flash_attention(q, k, v, causal, softmax_scale, window)
    if backend == "auto" and q.device.type == "cuda":
        if bias is None and supported(q, k, causal, mask, window):
            return fa.flash_attention(q, k, v, causal, softmax_scale, window)
        _warn_plain_fallback(q, bias)
    if backend not in ("auto", "xla"):
        raise ValueError(f"unknown attention backend {backend!r}")
    return reference_attention(q, k, v, causal=causal, mask=mask,
                               softmax_scale=softmax_scale, bias=bias,
                               window=window)


_warned_fallback = False


def _warn_plain_fallback(q, bias):
    """One-time visibility for the plain path on the card: it materialises
    ``[B, H, Tq, Tk]`` float32 logits."""
    global _warned_fallback
    if _warned_fallback:
        return
    _warned_fallback = True
    from ..utils.logging import logger
    why = "attention bias (ALiBi)" if bias is not None else \
        f"unsupported shape {tuple(q.shape)}"
    logger.warning(
        f"flash_attention: falling back to the plain attention path on the "
        f"GPU ({why} is not supported by the kernel); this materializes "
        f"full [B,H,Tq,Tk] fp32 attention logits")
