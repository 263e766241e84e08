"""Attention over ``[B, H, T, D]`` with backend dispatch.

``reference_attention`` is the plain path, masked exactly as the JAX
package's: logits filled with -1e30 (not -inf), the causal mask offset by
``t_k - t_q`` so the last query sees every key, an optional sliding
``window``, a boolean ``mask`` and an additive ``bias``, the default
scale ``d ** -0.5``, and attention-probability dropout (``dropout_rate``
under the key ``dropout_rng``, the mask over ``[B, H, Tq, Tk]`` bit for bit
the JAX package's: ``ops/dropout.py``).

``flash_attention`` follows the JAX package's dispatch: where the JAX
package takes its ``[B, H, T, D]`` Pallas kernels, this port takes its
Hopper kernels (``kernels/flash_attention.py``) on the card, and their
plain versions on the CPU, as the JAX package runs its kernels in
interpret mode there. One Hopper forward and one backward stand for both
of the JAX package's regimes: the resident kernels (K3 forward, the K3b/K5
backward) and, above ``T * D * itemsize = 1 MiB``, the streamed long-T
kernels (K4, K4b); the wrappers count the two regimes' launches apart.
Dropout is outside the kernels' envelope, as it is outside the Pallas
kernels': with ``dropout_rate > 0`` the dispatch takes the plain path
(``backend="pallas"`` raises), even without a key, as the JAX dispatch does.
"""

import torch

from .dropout import token_dropout
from .kernels import flash_attention as fa
from .kernels.flash_attention import NEG_INF


def reference_attention(q, k, v, causal=True, mask=None, softmax_scale=None,
                        dropout_rate=0.0, dropout_rng=None, bias=None,
                        window=None):
    """Plain attention. q, k, v: ``[B, H, T, D]`` (q may have Tq != Tk for
    decode). ``bias`` is an additive logits bias broadcastable to
    ``[B, H, Tq, Tk]``; ``window`` (with causal) keeps only keys with
    ``q_pos - k_pos < window``; with ``dropout_rate > 0`` and a key the
    probabilities (in q's dtype) are dropped under that key."""
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
    if dropout_rate > 0.0 and dropout_rng is not None:
        probs = token_dropout(probs, dropout_rng, dropout_rate)
    return torch.matmul(probs, v)


def supported(q, k, causal=True, mask=None, window=None,
              dropout_rate=0.0) -> bool:
    """The JAX ``[B, H, T, D]`` Pallas kernels' envelope."""
    if mask is not None or dropout_rate > 0.0:
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
                    dropout_rate=0.0, dropout_rng=None, backend="auto",
                    bias=None, window=None):
    """Dispatch as the JAX package does. ``backend="pallas"`` takes the
    kernel path and raises on an unsupported call; ``"xla"`` forces the
    plain path; ``"auto"`` takes the kernel path for supported shapes on the
    card and the plain path elsewhere (with a one-time warning on the
    card)."""
    if backend == "pallas":
        if bias is not None or not supported(q, k, causal, mask, window,
                                             dropout_rate):
            raise ValueError(
                f"pallas flash attention does not support this call "
                f"(q={tuple(q.shape)} k={tuple(k.shape)} causal={causal} "
                f"mask={'yes' if mask is not None else 'no'} "
                f"bias={'yes' if bias is not None else 'no'} "
                f"window={window} dropout={dropout_rate}); pass "
                f"backend='xla' explicitly")
        return fa.flash_attention(q, k, v, causal, softmax_scale, window)
    if backend == "auto" and q.device.type == "cuda":
        if bias is None and supported(q, k, causal, mask, window,
                                      dropout_rate):
            return fa.flash_attention(q, k, v, causal, softmax_scale, window)
        _warn_plain_fallback(q, bias, dropout_rate)
    if backend not in ("auto", "xla"):
        raise ValueError(f"unknown attention backend {backend!r}")
    return reference_attention(q, k, v, causal=causal, mask=mask,
                               softmax_scale=softmax_scale,
                               dropout_rate=dropout_rate,
                               dropout_rng=dropout_rng, bias=bias,
                               window=window)


_warned_fallback = False


def _warn_plain_fallback(q, bias, dropout_rate=0.0):
    """One-time visibility for the plain path on the card: it materialises
    ``[B, H, Tq, Tk]`` float32 logits."""
    global _warned_fallback
    if _warned_fallback:
        return
    _warned_fallback = True
    from ..utils.logging import logger
    why = "attention bias (ALiBi)" if bias is not None else \
        f"attention dropout {dropout_rate}" if dropout_rate > 0.0 else \
        f"unsupported shape {tuple(q.shape)}"
    logger.warning(
        f"flash_attention: falling back to the plain attention path on the "
        f"GPU ({why} is not supported by the kernel); this materializes "
        f"full [B,H,Tq,Tk] fp32 attention logits")
