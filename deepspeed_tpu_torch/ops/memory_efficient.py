"""Normalisation, activations and cross-entropy of the training hot path,
as the JAX package's ``ops/memory_efficient.py`` computes them: autograd
``Function``s whose backward saves only thin residuals and does its math
in float32.

- ``layer_norm`` saves ``x``, ``scale``, ``bias`` and the per-row
  ``mean`` / ``rstd``, and recomputes the normalised tensor in backward.
- ``gelu``, ``gelu_exact``, ``silu`` and ``quick_gelu`` save only ``x``
  and evaluate a closed-form derivative.
- ``dense_xent_sum`` saves the logits and the per-row ``lse`` and streams
  ``softmax - onehot`` in backward, never keeping an f32 log-softmax.

Statistics and gradients accumulate in float32; results and gradients
are cast back to the input dtypes. Under ``torch.no_grad`` /
``inference_mode`` no graph holds the residuals past the call.
"""

import math

import torch

_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715
_F32 = torch.float32


# ------------------------------------------------------------------ layer norm

def _ln_stats(xf, eps):
    mean = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mean).mean(-1, keepdim=True)
    return mean, torch.rsqrt(var + eps)


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        xf = x.to(_F32)
        mean, rstd = _ln_stats(xf, eps)
        y = (xf - mean) * rstd * scale.to(_F32) + bias.to(_F32)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        gf = g.to(_F32)
        xhat = (x.to(_F32) - mean) * rstd           # recomputed, not saved
        dxhat = gf * scale.to(_F32)
        m1 = dxhat.mean(-1, keepdim=True)
        m2 = (dxhat * xhat).mean(-1, keepdim=True)
        dx = rstd * (dxhat - m1 - xhat * m2)
        reduce_dims = tuple(range(x.dim() - 1))
        dscale = (gf * xhat).sum(reduce_dims)
        dbias = gf.sum(reduce_dims)
        return (dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(bias.dtype),
                None)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm with float32 statistics and ``rsqrt(var + eps)``; saves
    ``(x, scale, bias, mean, rstd)``."""
    return _LayerNorm.apply(x, scale, bias, eps)


# ----------------------------------------------------------------- activations

def _gelu_tanh_f32(x):
    u = _SQRT_2_OVER_PI * (x + _GELU_C * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(u))


def _gelu_tanh_grad_f32(x):
    u = _SQRT_2_OVER_PI * (x + _GELU_C * x * x * x)
    t = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du


def _gelu_exact_f32(x):
    return 0.5 * x * (1.0 + torch.erf(x * (2.0 ** -0.5)))


def _gelu_exact_grad_f32(x):
    cdf = 0.5 * (1.0 + torch.erf(x * (2.0 ** -0.5)))
    pdf = torch.exp(-0.5 * x * x) * (1.0 / math.sqrt(2.0 * math.pi))
    return cdf + x * pdf


def _silu_f32(x):
    return x * torch.sigmoid(x)


def _silu_grad_f32(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def _quick_gelu_f32(x):
    return x * torch.sigmoid(1.702 * x)


def _quick_gelu_grad_f32(x):
    s = torch.sigmoid(1.702 * x)
    return s * (1.0 + 1.702 * x * (1.0 - s))


_UNARY = {"gelu": (_gelu_tanh_f32, _gelu_tanh_grad_f32),
          "gelu_exact": (_gelu_exact_f32, _gelu_exact_grad_f32),
          "silu": (_silu_f32, _silu_grad_f32),
          "quick_gelu": (_quick_gelu_f32, _quick_gelu_grad_f32)}


class _Unary(torch.autograd.Function):
    """Elementwise activation whose backward saves only the input and
    evaluates the closed-form derivative in float32."""

    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        ctx.save_for_backward(x)
        return _UNARY[name][0](x.to(_F32)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        grad = _UNARY[ctx.name][1](x.to(_F32))
        return (g.to(_F32) * grad).to(x.dtype), None


def gelu(x):
    """tanh-approximate GELU (GPT-2's ``gelu_new``)."""
    return _Unary.apply(x, "gelu")


def gelu_exact(x):
    """erf GELU."""
    return _Unary.apply(x, "gelu_exact")


def silu(x):
    return _Unary.apply(x, "silu")


def quick_gelu(x):
    """CLIP's ``x * sigmoid(1.702 x)``."""
    return _Unary.apply(x, "quick_gelu")


def relu(x):
    return torch.relu(x)


# -------------------------------------------------------------- cross entropy

class _DenseXentSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, valid):
        lf = logits.to(_F32)
        m = lf.amax(-1, keepdim=True)
        lse = m + torch.log(torch.exp(lf - m).sum(-1, keepdim=True))
        tgt = torch.gather(lf, -1, labels.unsqueeze(-1))
        nll = torch.where(valid.unsqueeze(-1), lse - tgt, 0.0)
        ctx.save_for_backward(logits, lse, labels, valid)
        return nll.sum()

    @staticmethod
    def backward(ctx, g):
        logits, lse, labels, valid = ctx.saved_tensors
        # softmax - onehot, in one new f32 buffer updated in place (the
        # saved logits stay untouched when they are f32 already)
        d = (logits.to(_F32) - lse).exp_()
        d.scatter_add_(-1, labels.unsqueeze(-1),
                       torch.full_like(lse, -1.0))
        d.mul_(torch.where(valid, g.to(_F32), 0.0).unsqueeze(-1))
        return d.to(logits.dtype), None, None


def dense_xent_sum(logits, labels, valid):
    """Sum over valid tokens of the NLL of ``labels`` under ``logits``
    (``[..., V]``, any float dtype; ``labels`` int64 already clamped into
    range; ``valid`` bool), without keeping an f32 log-softmax: the
    backward recomputes ``softmax - onehot`` from the saved logits and
    ``lse``. Divide by the valid count outside."""
    return _DenseXentSum.apply(logits, labels, valid)
