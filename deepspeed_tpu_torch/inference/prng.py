"""Threefry-2x32 keys and draws, bit for bit as ``jax.random`` makes them.

The JAX package keys every sampled token by ``jax.random`` with its default
settings (``threefry2x32``, ``jax_threefry_partitionable=True``, 64-bit
types off). These functions give the same uint32 words, held in int64
tensors with ``& 0xFFFFFFFF`` after each add and shift, on any device:

- ``prng_key(seed)``: ``jax.random.PRNGKey``. With 64-bit types off the
  seed is cut to its low 32 bits and the high word is 0.
- ``fold_in(key, data)``: the hash of the counter pair ``(0, data)``.
- ``split(key, num)``: key ``i`` is the hash of ``(0, i)`` (the
  partitionable, fold-like split).
- ``random_bits(key, shape)``: word ``i`` (the flat index, as a 64-bit
  counter ``(hi, lo)``) is the xor of the two hash words.
- ``uniform``, ``gumbel`` (mode ``"low"``) and ``categorical`` (the
  Gumbel-max draw) as ``jax/_src/random.py`` computes them in float32.

A key is an int64 tensor whose last axis holds the two words.
"""

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = torch.finfo(torch.float32).tiny


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counters ``(x1, x2)`` under
    key ``(k1, k2)``; all int64 tensors of uint32 values, broadcast
    against each other. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = (x1 + ks[0]) & M32, (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed, device=None):
    """``jax.random.PRNGKey(seed)`` for a Python int or an integer tensor of
    seeds: int64 ``[..., 2]``. With 64-bit types off, as the JAX package
    runs, the seed becomes an int32 and ``threefry_seed`` gives ``(0,
    seed mod 2**32)`` (the high word is the int32 shifted right by 32: 0),
    for negative and 64-bit seeds alike."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    return torch.stack([torch.zeros_like(seed), seed & M32], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in``: ``key [..., 2]`` with ``data`` (broadcast
    against the key's batch shape, taken as uint32)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([o0, o1], dim=-1)


def split(key, num: int = 2):
    """``jax.random.split(key, num)`` for one key ``[2]``: ``[num, 2]``."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key[0], key[1], idx >> 32, idx & M32)
    return torch.stack([o0, o1], dim=-1)


def random_bits(key, shape):
    """32 random bits per element of ``shape`` for each key of ``key
    [..., 2]``: int64 ``key.shape[:-1] + shape`` of uint32 values (one
    ``jax.random.bits`` call per key, as under ``vmap``)."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    o0, o1 = threefry2x32(k1, k2, idx >> 32, idx & M32)
    return o0 ^ o1


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform`` in float32: the top 23 bits become the
    mantissa of a float in [1, 2), less 1, scaled to [minval, maxval)."""
    bits = random_bits(key, shape)
    one = 0x3F800000                       # float32 1.0
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, shape):
    """``jax.random.gumbel(mode="low")`` in float32:
    ``-log(-log(uniform(minval=tiny, maxval=1)))``."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY_F32, 1.0)))


def categorical(key, logits):
    """``jax.random.categorical(key, logits, axis=-1)`` (Gumbel-max): for a
    single key ``[2]`` one draw over all of ``logits``' rows together (the
    counters run over the whole array), for keys ``[..., 2]`` matching
    ``logits.shape[:-1]`` one draw a row (``vmap`` over rows). Returns int64
    indices."""
    if key.dim() == 1:
        noise = gumbel(key, tuple(logits.shape))
    else:
        noise = gumbel(key, tuple(logits.shape[-1:]))
    return torch.argmax(noise + logits.to(torch.float32), dim=-1)
