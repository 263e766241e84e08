"""The quantization core: the JAX package's ``ops/quant_core.py`` on
tensors.

One implementation of the scale and rounding math every quantizing
module of the port rides: the quantized collectives
(``comm/quantized.py``), the int8 slot pool (``inference/kv_quant.py``)
and, through the same rounding rule, weight-only serving
(``inference/quantization.py``). Symmetric and asymmetric scales,
round-and-clip, the blockwise wire codec (int8, or fp8 e4m3 for
``fp8_block``) with one f32 scale per contiguous block, and the sign
(1-bit) codec.

The codec is the JAX package's bit for bit, as its compiled programs
compute it: the block scale is ``absmax / qmax`` (1 for an all-zero
block), which XLA compiles into a multiply by the f32 reciprocal of the
constant ``qmax``, so it is that here (``_per``); the payload is
``x / scale`` divided in f32 (a division: ``scale`` is no constant),
rounded half to even (``torch.round``, as ``jnp.rint``), clipped and
cast; the fp8 payload is the f32 quotient cast to
``torch.float8_e4m3fn`` (round to nearest even, as the JAX cast). A
``block`` that does not divide the tensor's size takes one scale for the
whole tensor.
"""

from typing import Optional, Tuple

import numpy as np
import torch

INT8_QMAX = 127.0
#: fp8 e4m3 finite max: the "fp8-style blockwise" wire format's target
FP8_QMAX = 448.0
FP8_DTYPE = getattr(torch, "float8_e4m3fn", None)

#: wire formats the blockwise codec understands
WIRE_FORMATS = ("int8", "fp8_block")


# ---------------------------------------------------------------- scale math

def _per(c: float) -> float:
    """The f32 reciprocal of a constant divisor: XLA compiles ``x / c``
    into ``x * (1 / c)`` when ``c`` is a compile-time constant."""
    return float(np.float32(1.0) / np.float32(c))


def qrange(bits: int, symmetric: bool) -> Tuple[float, float]:
    """Integer target range; symmetric keeps zero exactly representable."""
    if symmetric:
        qmax = float(2 ** (bits - 1) - 1)
        return -qmax, qmax
    return 0.0, float(2 ** bits - 1)


def symmetric_scale(absmax, qmax: float):
    """``absmax / qmax`` in f32, 1 where ``absmax`` is 0 (a 0 scale would
    NaN the dequantize; 1 keeps q = 0 exact)."""
    absmax = absmax.to(torch.float32)
    return torch.where(absmax > 0, absmax * _per(qmax),
                       torch.ones_like(absmax))


def asymmetric_scale_zero(lo, hi, qmin: float, qmax: float):
    """``(scale, zero_point)`` mapping ``[lo, hi]`` onto ``[qmin, qmax]``."""
    lo = torch.as_tensor(lo, dtype=torch.float32)
    hi = torch.as_tensor(hi, dtype=torch.float32)
    scale = torch.where(hi > lo, (hi - lo) * _per(qmax - qmin),
                        torch.ones_like(hi))
    zero = qmin - lo / scale
    return scale, zero


def round_clip(scaled, qmin: float, qmax: float, carrier,
               stochastic: bool = False, generator=None):
    """Round (to nearest, half to even; or stochastically) then clip into
    the carrier dtype. Stochastic rounding needs an explicit
    ``torch.Generator``: a fixed stream would add the same noise on every
    call."""
    if stochastic:
        if generator is None:
            raise ValueError(
                "stochastic=True requires a torch.Generator — a fixed "
                "stream would add the SAME noise every call, biasing the "
                "rounding")
        noise = torch.rand(scaled.shape, generator=generator,
                           device=scaled.device,
                           dtype=torch.float32) - 0.5
        q = torch.floor(scaled + 0.5 + noise)
    else:
        q = torch.round(scaled)
    return torch.clamp(q, qmin, qmax).to(carrier)


# ------------------------------------------------------------ blockwise codec

def block_count(size: int, block: Optional[int]) -> int:
    """Number of scale blocks the flat codec uses for ``size`` values."""
    if not block or block <= 0 or size % block != 0:
        return 1
    return size // block


def quantize_blockwise(x, block: Optional[int] = 256, wire: str = "int8"):
    """``x`` (any shape, any float dtype) -> ``(q, scales)``: ``q`` of
    ``x``'s shape in the wire dtype (int8, or fp8 e4m3 for ``fp8_block``),
    ``scales`` f32 ``[block_count]``. The pair is the wire payload of the
    quantized collectives: ``q.numel()`` bytes + 4 per block."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"unknown wire format {wire!r}; one of {WIRE_FORMATS}")
    if wire == "fp8_block" and FP8_DTYPE is None:
        raise ValueError("fp8_block wire format needs torch.float8_e4m3fn; "
                         "use int8")
    nb = block_count(x.numel(), block)
    xg = x.reshape(nb, -1).to(torch.float32)
    absmax = xg.abs().amax(dim=1, keepdim=True)
    if wire == "int8":
        scale = symmetric_scale(absmax, INT8_QMAX)
        q = round_clip(xg / scale, -INT8_QMAX, INT8_QMAX, torch.int8)
    else:
        scale = symmetric_scale(absmax, FP8_QMAX)
        # the cast rounds to nearest even; the values are pre-scaled into
        # the finite range, so it never saturates
        q = (xg / scale).to(FP8_DTYPE)
    return q.reshape(x.shape), scale.reshape(nb)


def dequantize_blockwise(q, scales, dtype=torch.float32):
    """``(q, scales)`` -> a float tensor of ``q``'s shape in ``dtype``."""
    nb = scales.shape[0]
    xg = q.reshape(nb, -1).to(torch.float32) * scales.reshape(nb, 1)
    return xg.reshape(q.shape).to(dtype)


def fake_quantize_blockwise(x, block: Optional[int] = 256, wire: str = "int8"):
    """Quantize then dequantize, in the input dtype (the error-injection
    oracle of the tests)."""
    q, s = quantize_blockwise(x, block, wire)
    return dequantize_blockwise(q, s, dtype=x.dtype)


def pertensor_int8(x):
    """``(q int8, scalar f32 scale)``: the per-tensor special case."""
    q, s = quantize_blockwise(x, block=None, wire="int8")
    return q, s.reshape(())


def wire_nbytes(size: int, block: Optional[int], wire: str = "int8") -> int:
    """Bytes the blockwise codec puts on the wire for ``size`` values: one
    a value (int8 and fp8 alike) + one f32 scale a block."""
    return size + 4 * block_count(size, block)


# ----------------------------------------------------------------- sign codec

def absmean_scale(x, dim=None, keepdim=False):
    """``mean(|x|)``: the 1-bit codec's scale."""
    a = x.abs()
    return a.mean() if dim is None else a.mean(dim=dim, keepdim=keepdim)


def sign_quantize(x):
    """``x`` -> ``(int8 signs, scalar f32 scale = mean|x|)``."""
    scale = absmean_scale(x).to(torch.float32)
    sign = torch.where(x >= 0, torch.ones((), dtype=torch.int8),
                       -torch.ones((), dtype=torch.int8))
    return sign, scale


def sign_dequantize(sign, scale):
    return sign.to(torch.float32) * scale
