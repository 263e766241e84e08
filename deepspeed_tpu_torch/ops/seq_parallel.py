"""Sequence-parallel attention entry point, as the JAX package's
``ops/seq_parallel.py`` ``sp_attention``.

The JAX package shards T over a ``seq`` mesh axis and runs Ulysses (an
all-to-all between heads and sequence) or ring attention across devices.
The port's rank topology takes no ``seq`` axis above 1 yet (it raises
naming ROADMAP.md row A11), so the axis has size 1 and ``sp_attention`` is
what the JAX function is then: argument checks and one ``flash_attention``
call, attention dropout included. (Over a live ``seq`` axis the JAX package
refuses dropout under ring attention; with no such axis here, neither
package does.)
"""

from .flash_attention import flash_attention

SP_IMPLS = ("ulysses", "ring")


def sp_attention(q, k, v, causal=True, softmax_scale=None, dropout_rate=0.0,
                 dropout_rng=None, impl="ulysses", backend="auto", bias=None,
                 window=None):
    """Attention over ``[B, H, T, D]`` with the JAX signature. ``impl``
    names the sequence-parallel strategy the JAX package would take over a
    live ``seq`` axis; here it is validated only."""
    if impl not in SP_IMPLS:
        raise ValueError(f"sp_attention impl must be 'ulysses' or 'ring', "
                         f"got {impl!r}")
    if window is not None and not causal:
        raise ValueError("sliding window requires causal=True")
    return flash_attention(q, k, v, causal=causal,
                           softmax_scale=softmax_scale,
                           dropout_rate=dropout_rate, dropout_rng=dropout_rng,
                           backend=backend, bias=bias, window=window)
