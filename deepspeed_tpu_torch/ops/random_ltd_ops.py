"""Random-LTD token ops, as the JAX package's ``ops/random_ltd_ops.py``.

``sample_token_indices`` draws each row's kept tokens as the JAX function
does, bit for bit: ``split(key, B)``, then a row's ``permutation(T)[:keep]``,
sorted (so kept tokens keep their order); a data-parallel rank draws its
rows of the global batch's draw. The keys and indices are made on
the host (int64, CPU) and moved to the device once a layer.
``token_gather`` / ``token_scatter`` are ``torch.gather`` / ``scatter``
along the token axis.
"""

import torch

from ..inference import prng


def sample_token_indices(key, keep: int, batch: int, seqlen: int,
                         first_row: int = 0):
    """``[batch, keep]`` sorted int64 indices of the kept tokens (CPU):
    rows ``first_row .. first_row + batch - 1`` of the JAX function's draw
    over a larger batch (a rank's rows of the global batch; row ``i``'s key
    is ``split(key, B)[i]``, which depends only on ``i``)."""
    keys = torch.tensor(prng.split_words(key, batch, first_row),
                        dtype=torch.int64)
    return prng.permutation(keys, seqlen)[:, :keep].sort(dim=1).values


def _index(indices, like):
    """``indices [B, K]`` broadcast over the trailing dims of ``like``."""
    idx = indices.reshape(indices.shape + (1,) * (like.dim() - 2))
    return idx.expand(indices.shape + like.shape[2:])


def token_gather(x, indices):
    """x: ``[B, T, ...]``; indices: ``[B, K]`` -> ``[B, K, ...]``."""
    return torch.gather(x, 1, _index(indices, x))


def token_scatter(base, values, indices):
    """The inverse of :func:`token_gather`: ``values [B, K, ...]`` placed at
    ``indices`` of a copy of ``base [B, T, ...]`` (the dropped tokens keep
    ``base``)."""
    return torch.scatter(base, 1, _index(indices, values), values)
