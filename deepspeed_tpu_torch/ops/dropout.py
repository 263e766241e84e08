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
"""

import torch

from ..inference import prng
from .kernels.threefry_dropout import threefry_dropout


class _TokenDropout(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, k0, k1, rate):
        ctx.key, ctx.rate = (k0, k1), rate
        return threefry_dropout(x, (k0, k1), rate)

    @staticmethod
    def backward(ctx, g):
        return threefry_dropout(g, ctx.key, ctx.rate), None, None, None


def token_dropout(x, key, rate: float):
    """``x * keep / (1 - rate)``, ``keep = jax.random.bernoulli(key, 1 -
    rate, x.shape)``; ``x`` itself when ``rate`` is 0 or ``key`` is None."""
    if key is None or rate == 0.0:
        return x
    k0, k1 = prng.as_key(key)
    return _TokenDropout.apply(x, k0, k1, float(rate))


def salted_dropout(x, rng, train: bool, salt: int, rate: float):
    """The JAX package's ``_token_dropout(x, rng, train, salt, rate)``: no
    dropout unless training with a key and a rate, else
    :func:`token_dropout` under ``fold_in(rng, salt)``."""
    if not train or rate == 0.0 or rng is None:
        return x
    return token_dropout(x, prng.fold_in_words(rng, salt), rate)
