"""Sequence-parallel attention entry point, as the JAX package's
``ops/seq_parallel.py`` ``sp_attention``.

The JAX package shards T over a ``seq`` mesh axis and runs Ulysses (an
all-to-all between heads and sequence) or ring attention across devices.
The port has no device mesh yet (the engines refuse one, naming ROADMAP.md
row A8), so the ``seq`` axis has size 1 and ``sp_attention`` is what the
JAX function is then: argument checks and one ``flash_attention`` call.
"""

from .flash_attention import flash_attention

SP_IMPLS = ("ulysses", "ring")


def sp_attention(q, k, v, causal=True, softmax_scale=None, dropout_rate=0.0,
                 dropout_rng=None, impl="ulysses", backend="auto", bias=None,
                 window=None):
    """Attention over ``[B, H, T, D]`` with the JAX signature. ``impl``
    names the sequence-parallel strategy the JAX package would take over a
    live ``seq`` axis; here it is validated only. Attention dropout is not
    ported (ROADMAP.md row A2b)."""
    if impl not in SP_IMPLS:
        raise ValueError(f"sp_attention impl must be 'ulysses' or 'ring', "
                         f"got {impl!r}")
    if window is not None and not causal:
        raise ValueError("sliding window requires causal=True")
    if dropout_rate > 0.0:
        raise NotImplementedError(
            f"attention dropout (rate {dropout_rate}) is not ported yet: "
            f"ROADMAP.md row A2b")
    return flash_attention(q, k, v, causal=causal,
                           softmax_scale=softmax_scale, backend=backend,
                           bias=bias, window=window)
