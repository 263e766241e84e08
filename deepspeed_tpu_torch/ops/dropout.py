"""Dropout keyed as the JAX package keys it.

The counterpart of ``_token_dropout`` (``deepspeed_tpu/models/gpt2.py:97-102``:
``x * bernoulli(fold_in(rng, salt), 1 - rate, x.shape) / (1 - rate)``) and
of the attention-probability dropout of the plain attention
(``deepspeed_tpu/ops/flash_attention.py:45-47``, the key used as it is).
:func:`token_dropout` is an autograd ``Function`` that saves no mask: its
forward and its backward are both ``kernels/threefry_dropout``'s pass under
the same key (JAX's transpose is ``(g / c) * keep``, the same values), on
the card the hand-written kernel, on the CPU its plain version. Keys are
``(word0, word1)`` tuples of Python ints made on the host
(``inference/prng.py``), so a dropout costs no device wait and a layer's
recompute under activation checkpointing draws the same mask.

Under data parallelism a rank holds rows ``[first, first + B)`` of the
JAX package's global batch. Every tensor dropped here has the batch as
its leading dim, and the JAX package's draw over the global array gives
element ``i`` the bits of counter ``i`` (``jax_threefry_partitionable``),
so the rank draws its rows by starting the counters at ``first`` times
the elements of a row. The engine sets ``first`` for its micro steps
(:func:`batch_rows`), for the forward and the backward (a recompute reads
it again); it is a process-wide value, not a thread-local one, because
the backward may run on autograd's device threads.

Under tensor parallelism a rank's attention probabilities ``[B, h, T,
T']`` are heads ``[h0, h0 + h)`` of the JAX package's ``[B_global, H, T,
T']`` draw: a strided slice of its counters. Inside :func:`rank_heads`
the probabilities' dropout takes the two-level counter map the kernel
takes, element ``i`` at ``offset + (i // inner) * stride + i % inner``
with ``inner = h T T'``, ``stride = H T T'`` and ``offset = first H T T'
+ h0 T T'``. Everything else (the embeddings and the sublayer outputs,
whole on every rank after the row-parallel all-reduce) keeps the
contiguous map, so every tp rank draws the same whole mask there. The
model enters the block around its attention call only; the map is read
when the dropout's forward runs, and its backward keeps it.
"""

import contextlib

import torch

from ..inference import prng
from .kernels.threefry_dropout import threefry_dropout

_FIRST_ROW = 0
_HEADS = None          # (first head, heads of the whole draw) or None


def first_row() -> int:
    """The global batch row of this rank's first row (0 on one rank)."""
    return _FIRST_ROW


@contextlib.contextmanager
def batch_rows(first: int):
    """Draw as rows ``first ..`` of the global batch for the block."""
    global _FIRST_ROW
    saved, _FIRST_ROW = _FIRST_ROW, int(first)
    try:
        yield
    finally:
        _FIRST_ROW = saved


@contextlib.contextmanager
def rank_heads(first: int, total: int):
    """Inside the block, a dropped ``[B, h, ...]`` tensor is heads
    ``[first, first + h)`` of a ``total``-head draw (see the module
    note)."""
    global _HEADS
    saved, _HEADS = _HEADS, (int(first), int(total))
    try:
        yield
    finally:
        _HEADS = saved


def counter_map(shape, first=0, heads=None):
    """``(offset, inner, stride)`` of a ``shape`` tensor's elements in the
    draw: rows from ``first`` of the global batch, and with ``heads =
    (h0, H)`` its dim-1 heads ``[h0, h0 + shape[1])`` of ``H``.
    ``inner == stride`` is the contiguous map."""
    if not shape:
        return 0, 0, 0
    row = 1
    for s in shape[1:]:
        row *= s
    if heads is None or len(shape) < 2:
        return first * row, row, row
    h0, total = heads
    stride = total * (row // shape[1])
    return first * stride + h0 * (row // shape[1]), row, stride


class _TokenDropout(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, k0, k1, rate, where):
        ctx.key, ctx.rate, ctx.where = (k0, k1), rate, where
        return threefry_dropout(x, (k0, k1), rate, *where)

    @staticmethod
    def backward(ctx, g):
        return (threefry_dropout(g, ctx.key, ctx.rate, *ctx.where), None,
                None, None, None)


def token_dropout(x, key, rate: float):
    """``x * keep / (1 - rate)``, ``keep = jax.random.bernoulli(key, 1 -
    rate, x.shape)`` (this rank's rows, and inside :func:`rank_heads` its
    heads, of the global draw: see the module note); ``x`` itself when
    ``rate`` is 0 or ``key`` is None."""
    if key is None or rate == 0.0:
        return x
    k0, k1 = prng.as_key(key)
    where = counter_map(tuple(x.shape), _FIRST_ROW, _HEADS)
    return _TokenDropout.apply(x, k0, k1, float(rate), where)


def salted_dropout(x, rng, train: bool, salt: int, rate: float):
    """The JAX package's ``_token_dropout(x, rng, train, salt, rate)``: no
    dropout unless training with a key and a rate, else
    :func:`token_dropout` under ``fold_in(rng, salt)``."""
    if not train or rate == 0.0 or rng is None:
        return x
    return token_dropout(x, prng.fold_in_words(rng, salt), rate)
