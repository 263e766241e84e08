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
"""

import contextlib

import torch

from ..inference import prng
from .kernels.threefry_dropout import threefry_dropout

_FIRST_ROW = 0


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


class _TokenDropout(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, k0, k1, rate, offset):
        ctx.key, ctx.rate, ctx.offset = (k0, k1), rate, offset
        return threefry_dropout(x, (k0, k1), rate, offset)

    @staticmethod
    def backward(ctx, g):
        return (threefry_dropout(g, ctx.key, ctx.rate, ctx.offset), None,
                None, None, None)


def token_dropout(x, key, rate: float):
    """``x * keep / (1 - rate)``, ``keep = jax.random.bernoulli(key, 1 -
    rate, x.shape)`` (this rank's rows of the global draw: see the module
    note); ``x`` itself when ``rate`` is 0 or ``key`` is None."""
    if key is None or rate == 0.0:
        return x
    k0, k1 = prng.as_key(key)
    offset = _FIRST_ROW * (x.numel() // x.shape[0]) if x.dim() else 0
    return _TokenDropout.apply(x, k0, k1, float(rate), offset)


def salted_dropout(x, rng, train: bool, salt: int, rate: float):
    """The JAX package's ``_token_dropout(x, rng, train, salt, rate)``: no
    dropout unless training with a key and a rate, else
    :func:`token_dropout` under ``fold_in(rng, salt)``."""
    if not train or rate == 0.0 or rng is None:
        return x
    return token_dropout(x, prng.fold_in_words(rng, salt), rate)
