"""The quantized KV slot pool: the JAX package's ``inference/kv_quant.py``.

The slot pool (``serving/kv_slots.py``) is ``[L, num_slots, H, max_len,
hd]`` in the serving dtype, resident for the process's life. Stored int8
with one f32 scale per cache column (``[layer, slot, head, position]``,
absmax over the column's ``hd`` values, through ``ops/quant_core``'s
``symmetric_scale`` and ``round_clip``) it takes about
``(1 + 4 / hd) / 2`` of a bf16 pool's bytes.

``QuantizedSlotPool`` holds ``q`` (``{"k", "v"}`` int8 ``[..., hd]``) and
``scales`` (the same without ``hd``); ``pool["k"]`` is the int8 ``k``
payload, so shape probes read the pool's dims as on a float pool. The
models' cache loops (``models/gpt2.py``) take a layer's K/V through
``layer_kv``, dequantized into the serving dtype, write the step's K/V
into it at full precision, attend, and hand it back to ``commit``, which
quantizes it into the pool as the JAX package's slot programs do, a
layer at a time: a decode step and a lane write (prefill, suffix and
chunk prefill) quantize every column again (the JAX package dequantizes
the pool or the lane and quantizes it whole: a column's scale can move
by an ulp, as the compiled ``absmax * (1/127)`` is not idempotent), a
verify step only the columns it wrote (the JAX package copies the old
bytes of every other column back).
"""

import torch

from ..ops.quant_core import INT8_QMAX, round_clip, symmetric_scale

__all__ = ["QuantizedSlotPool", "quantize_kv", "dequantize_kv",
           "quantize_pool", "dequantize_pool", "pool_nbytes"]


def quantize_kv(x):
    """One cache leaf ``[..., hd]`` -> ``(q int8 [..., hd], scales f32
    [...])``, per-column symmetric scales."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    scale = symmetric_scale(absmax, INT8_QMAX)
    q = round_clip(xf / scale[..., None], -INT8_QMAX, INT8_QMAX, torch.int8)
    return q, scale


def dequantize_kv(q, scales, dtype=torch.float32):
    """``(q, scales)`` -> a float leaf of ``q``'s shape in ``dtype``."""
    return (q.to(torch.float32) * scales[..., None]).to(dtype)


class QuantizedSlotPool:
    """int8 KV pool + per-column f32 scales; ``dtype`` is the serving
    dtype its layers are dequantized into; ``rewrite`` what ``commit``
    quantizes: ``"all"`` columns (decode, lane writes) or the
    ``"written"`` ones (verify)."""

    def __init__(self, q, scales, dtype=torch.float32):
        self.q, self.scales, self.dtype = q, scales, dtype
        self.rewrite = "all"

    def __getitem__(self, name):
        return self.q[name]

    def lane(self, slot: int) -> "QuantizedSlotPool":
        """Slot ``slot``'s lane: views of the pool (``[L, 1, ...]``)."""
        return QuantizedSlotPool(
            {n: c[:, slot:slot + 1] for n, c in self.q.items()},
            {n: c[:, slot:slot + 1] for n, c in self.scales.items()},
            self.dtype)

    def layer_kv(self, layer: int):
        """Layer ``layer``'s K and V, dequantized into the serving dtype
        (fresh tensors the step writes into)."""
        return tuple(dequantize_kv(self.q[n][layer], self.scales[n][layer],
                                   self.dtype) for n in ("k", "v"))

    def commit(self, layer: int, kv, index):
        """Quantize layer ``layer``'s ``kv`` (as ``layer_kv`` gave it, with
        the step's columns written) into the pool: every column, or under
        ``rewrite == "written"`` the columns ``index`` (an index into
        ``[rows, heads, columns]``) alone."""
        for n, c in zip(("k", "v"), kv):
            if self.rewrite == "all":
                q, s = quantize_kv(c)
                self.q[n][layer].copy_(q)
                self.scales[n][layer].copy_(s)
            else:
                q, s = quantize_kv(c[index])
                self.q[n][layer][index] = q
                self.scales[n][layer][index] = s

    def fill(self, index, q=0, scale=1.0):
        """Set the columns ``index`` of every layer (an index into ``[L,
        rows, heads, columns]``) to ``q`` / ``scale``: 0 / 1 is a zero
        column, as ``quantize_kv`` leaves it."""
        for n in ("k", "v"):
            self.q[n][index] = q
            self.scales[n][index] = scale


def quantize_pool(pool, dtype=None) -> QuantizedSlotPool:
    """A float pool ``{"k", "v"}`` -> ``QuantizedSlotPool``."""
    pairs = {n: quantize_kv(c) for n, c in pool.items()}
    dtype = next(iter(pool.values())).dtype if dtype is None else dtype
    return QuantizedSlotPool({n: p[0] for n, p in pairs.items()},
                             {n: p[1] for n, p in pairs.items()}, dtype)


def dequantize_pool(pool: QuantizedSlotPool, dtype=torch.float32):
    """``QuantizedSlotPool`` -> a float pool ``{"k", "v"}`` in ``dtype``."""
    return {n: dequantize_kv(pool.q[n], pool.scales[n], dtype)
            for n in pool.q}


def pool_nbytes(pool) -> int:
    """Resident bytes of a pool: a float pool's, or a quantized pool's
    payload + scales."""
    if isinstance(pool, QuantizedSlotPool):
        tensors = list(pool.q.values()) + list(pool.scales.values())
    else:
        tensors = list(pool.values())
    return sum(t.numel() * t.element_size() for t in tensors)
