"""Dropout on the JAX package's threefry keys: the hand-written Hopper
kernel ``csrc/threefry_dropout.cu`` and its plain PyTorch version.

It replaces no Pallas kernel. It computes, in one pass, what the JAX
package's ``_token_dropout`` (``deepspeed_tpu/models/gpt2.py:97-102``) and
the attention-probability dropout of its plain attention
(``deepspeed_tpu/ops/flash_attention.py:45-47``) compute:
``x * bernoulli(key, 1 - rate, x.shape) / (1 - rate)``, with the mask bit
for bit ``jax.random``'s (``inference/prng.py``) and the divisor ``1 -
rate`` rounded to x's dtype first, as JAX's weak-typed Python float is
(bf16 0.8984375 for rate 0.1). :func:`threefry_dropout` launches the
kernel for CUDA tensors and counts its launches; it takes
:func:`threefry_dropout_plain` only for tensors on the CPU. What bounds
the kernel on the H100 and what its design does about it is noted in its
CUDA source.
"""

import ctypes

import numpy as np
import torch

from ...inference import prng

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def divisor(rate: float, dtype) -> float:
    """``1 - rate`` rounded to ``dtype`` (as a float that holds it
    exactly)."""
    return float(torch.tensor(1.0 - rate, dtype=torch.float64).to(dtype))


def threshold(rate: float) -> float:
    """The keep threshold, ``float32(1 - rate)``, as ``bernoulli`` takes
    its ``p``."""
    return float(np.float32(1.0 - rate))


def _check(x, rate):
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"threefry dropout takes float32, bfloat16 or "
                        f"float16 tensors, got {x.dtype}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")


def _check_map(offset, inner, stride, n):
    """The counter map as ``(offset, inner, stride)``, with ``inner`` 0
    (the contiguous map) wherever it maps as the contiguous one does."""
    offset, inner, stride = int(offset), int(inner), int(stride)
    if not 0 <= offset < 1 << 64:
        raise ValueError(f"dropout counter offset must lie in [0, 2**64), "
                         f"got {offset}")
    if inner < 0 or (inner and stride < inner):
        raise ValueError(f"dropout counter map needs 0 < inner <= stride, "
                         f"got inner {inner}, stride {stride}")
    if inner == 0 or inner == stride or inner >= n:
        return offset, 0, 0
    last = offset + (n - 1) // inner * stride + (n - 1) % inner
    if last >= 1 << 64:
        raise ValueError(f"dropout counters run past 2**64 (last {last})")
    return offset, inner, stride


def threefry_dropout(x, key, rate: float, offset: int = 0, inner: int = 0,
                     stride: int = 0):
    """``x * keep / (1 - rate)`` with ``keep = bernoulli(key, 1 - rate,
    x.shape)`` as ``jax.random`` draws it; ``key`` is a ``(word0, word1)``
    tuple (or anything :func:`prng.as_key` takes). ``offset`` starts the
    element counters there: ``x`` is then the elements ``[offset, offset +
    n)`` of a larger draw (a rank's rows of the global batch). With
    ``inner`` (0 < ``inner`` <= ``stride``) element ``i`` takes counter
    ``offset + (i // inner) * stride + i % inner`` (a tp rank's heads of
    each row: ``inner`` its heads' elements of a row, ``stride`` all
    heads'); ``inner`` 0 or equal to ``stride`` is the contiguous map,
    and the same launch. Launches the CUDA kernel for a CUDA tensor (made
    contiguous first) and raises on anything it does not take; CPU tensors
    go through :func:`threefry_dropout_plain`."""
    _check(x, rate)
    where = _check_map(offset, inner, stride, x.numel())
    if x.device.type == "cpu":
        return threefry_dropout_plain(x, key, rate, *where)
    if x.device.type != "cuda":
        raise ValueError(f"threefry dropout runs on CUDA or CPU tensors, "
                         f"got {x.device}")
    k0, k1 = prng.as_key(key)
    x = x.contiguous()
    out = torch.empty_like(x)
    launch(x, out, k0, k1, threshold(rate), divisor(rate, x.dtype), *where)
    threefry_dropout.launches += 1
    threefry_dropout.mapped_launches += int(where[1] != 0)
    return out


# launches in all, and those under the two-level (head-strided) map
threefry_dropout.launches = 0
threefry_dropout.mapped_launches = 0


def launch(x, out, k0, k1, thresh, div, offset=0, inner=0, stride=0):
    """Launch the kernel on contiguous ``x`` into ``out`` (same shape and
    dtype), element counters from ``offset`` under the map of ``inner``
    and ``stride`` (0: contiguous). The caller has checked types, devices
    and the map."""
    from ..kernel_build import load
    fn = load("threefry_dropout").dstorch_threefry_dropout
    if fn.argtypes is None:
        ptr, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        ull = ctypes.c_ulonglong
        fn.argtypes = [ptr, ptr, ctypes.c_longlong, ull, ull, ull, u, u,
                       ctypes.c_float, ctypes.c_float, i, i, ptr]
        fn.restype = ctypes.c_int
    vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), offset, inner,
                 stride, k0, k1, thresh, div, DTYPE_CODES[x.dtype], vec,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry_dropout kernel launch failed with CUDA "
                           f"error {err}")


def threefry_dropout_plain(x, key, rate: float, offset: int = 0,
                           inner: int = 0, stride: int = 0):
    """The kernel's arithmetic in plain PyTorch, on any device: the mask by
    ``prng.bernoulli`` (int64 threefry, the counters of ``offset``,
    ``inner`` and ``stride``), ``float32(x) * keep`` divided elementwise
    by the rounded divisor (a full tensor, so no path takes a reciprocal),
    rounded to x's dtype."""
    _check(x, rate)
    offset, inner, stride = _check_map(offset, inner, stride, x.numel())
    keep = prng.bernoulli(key, 1.0 - rate, tuple(x.shape), device=x.device,
                          offset=offset, inner=inner, stride=stride)
    y = x.to(torch.float32) * keep
    return torch.div(y, torch.full_like(y, divisor(rate, x.dtype))).to(
        x.dtype)
