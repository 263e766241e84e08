"""Normalisation and activations of the decoder, computed as the JAX
package's ``ops/memory_efficient.py`` computes them: statistics and
activations in float32, the result cast back to the input dtype.

Forward only: the autograd Functions that save thin residuals come with
the training slice (ROADMAP.md row A2).
"""

import torch

_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm with float32 statistics and ``rsqrt(var + eps)``."""
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mean).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    y = xhat * scale.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype)


def gelu(x):
    """tanh-approximate GELU (GPT-2's ``gelu_new``)."""
    xf = x.to(torch.float32)
    u = _SQRT_2_OVER_PI * (xf + _GELU_C * xf * xf * xf)
    return (0.5 * xf * (1.0 + torch.tanh(u))).to(x.dtype)


def gelu_exact(x):
    """erf GELU."""
    xf = x.to(torch.float32)
    return (0.5 * xf * (1.0 + torch.erf(xf * (2.0 ** -0.5)))).to(x.dtype)


def silu(x):
    xf = x.to(torch.float32)
    return (xf * torch.sigmoid(xf)).to(x.dtype)


def relu(x):
    return torch.relu(x)
