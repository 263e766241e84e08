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
- ``bernoulli`` (mode ``"low"``: ``uniform(key, shape) < float32(p)``) and
  ``permutation`` (``_shuffle``: ``ceil(3 ln n / ln(2**32 - 1))`` rounds,
  each ``key, sub = split(key)`` and a stable sort on ``random_bits(sub,
  (n,))``).

A key is an int64 tensor whose last axis holds the two words. The
training path derives a few keys a layer and micro step on the host; it
holds them as ``(word0, word1)`` tuples of Python ints, which
``threefry2x32`` hashes as well as tensors (``as_key``, ``fold_in_words``,
``split_words``, ``bernoulli_scalar``): no tensor op and no device wait a
key.
"""

import numpy as np
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


def random_bits(key, shape, offset: int = 0, inner: int = 0,
                stride: int = 0):
    """32 random bits per element of ``shape`` for each key of ``key
    [..., 2]``: int64 ``key.shape[:-1] + shape`` of uint32 values (one
    ``jax.random.bits`` call per key, as under ``vmap``). With ``offset``
    the counters start there: the elements of ``shape`` are those at flat
    indices ``[offset, offset + n)`` of a larger array drawn under the
    same key (a rank's rows of a global draw: with
    ``jax_threefry_partitionable`` an element's bits depend only on its
    flat index). With ``inner`` (0 < ``inner`` <= ``stride``) element
    ``i`` takes flat index ``offset + (i // inner) * stride + i %
    inner``: segments of ``inner`` elements ``stride`` apart (a rank's
    heads of every row)."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    if 0 < inner < n and inner != stride:
        idx = (idx // inner) * stride + idx % inner
    idx = (idx + offset).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    o0, o1 = threefry2x32(k1, k2, idx >> 32, idx & M32)
    return o0 ^ o1


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            offset: int = 0, inner: int = 0, stride: int = 0):
    """``jax.random.uniform`` in float32: the top 23 bits become the
    mantissa of a float in [1, 2), less 1, scaled to [minval, maxval)
    (``offset``, ``inner``, ``stride``: see :func:`random_bits`)."""
    bits = random_bits(key, shape, offset, inner, stride)
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


# ------------------------------------------------------ host key words

def as_key(key):
    """A key as a ``(word0, word1)`` tuple of Python ints, from a tuple, a
    numpy array (a JAX key's ``np.asarray``) or a tensor ``[2]``."""
    if isinstance(key, torch.Tensor):
        key = key.tolist()
    w0, w1 = (int(w) & M32 for w in np.asarray(key).reshape(2).tolist())
    return w0, w1


def fold_in_words(key, data):
    """``jax.random.fold_in`` of a ``(word0, word1)`` key with an int."""
    k0, k1 = as_key(key)
    return threefry2x32(k0, k1, 0, int(data) & M32)


def split_words(key, num: int = 2, first: int = 0):
    """``jax.random.split`` of a ``(word0, word1)`` key: ``num`` tuples,
    keys ``first .. first + num - 1`` of a larger split (the partitionable
    split's key ``i`` depends only on ``i``)."""
    k0, k1 = as_key(key)
    return [threefry2x32(k0, k1, i >> 32, i & M32)
            for i in range(first, first + num)]


def uniform_scalar(key):
    """``jax.random.uniform(key, ())`` in float32, as a numpy float32: one
    hash of the counter ``(0, 0)``."""
    o0, o1 = threefry2x32(*as_key(key), 0, 0)
    bits = np.uint32((((o0 ^ o1) >> 9) | 0x3F800000) & M32)
    return bits.view(np.float32) - np.float32(1.0)


def bernoulli_scalar(key, p) -> bool:
    """``jax.random.bernoulli(key, p)`` for a scalar ``p`` (taken to
    float32, as JAX takes it): ``uniform(key, ()) < p``."""
    return bool(uniform_scalar(key) < np.float32(p))


def key_tensor(key, device=None):
    """A key (tuple, array or tensor ``[..., 2]``) as an int64 tensor."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device, dtype=torch.int64)
    return torch.tensor(as_key(key), dtype=torch.int64, device=device)


def bernoulli(key, p, shape, device=None, offset: int = 0, inner: int = 0,
              stride: int = 0):
    """``jax.random.bernoulli(key, p, shape)`` (mode ``"low"``) for one key:
    a bool tensor, ``uniform(key, shape) < float32(p)`` (``offset``,
    ``inner``, ``stride``: where the draw's elements lie in a larger
    draw, see :func:`random_bits`)."""
    key = key_tensor(key, device)
    return uniform(key, tuple(shape), offset=offset, inner=inner,
                   stride=stride) < torch.tensor(
        float(np.float32(p)), dtype=torch.float32, device=key.device)


def shuffle_rounds(n: int) -> int:
    """The number of sort rounds of ``jax.random.permutation`` over ``n``
    elements (``_shuffle``): 1 up to n = 1625, 2 above, as JAX computes it
    in float64."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key, n: int):
    """``jax.random.permutation(key, n)`` for keys ``[..., 2]`` (one
    permutation a key, as under ``vmap``): int64 ``key.shape[:-1] + (n,)``.
    Each round splits the key and sorts stably on fresh 32-bit words, as
    ``lax.sort_key_val`` (stable) does."""
    key = key_tensor(key)
    lead = key.shape[:-1]
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(
        lead + (n,)).contiguous()
    for _ in range(shuffle_rounds(n)):
        z = torch.zeros_like(key[..., 0])
        n0, n1 = threefry2x32(key[..., 0], key[..., 1], z, z)
        s0, s1 = threefry2x32(key[..., 0], key[..., 1], z, z + 1)
        key = torch.stack([n0, n1], dim=-1)
        bits = random_bits(torch.stack([s0, s1], dim=-1), (n,))
        order = torch.sort(bits, dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x
