"""Deterministic per-request sampling: the sampling half of the JAX
package's ``inference/speculative.py``.

Every sampled token is drawn with a key that derives only from the
request's seed and the cache column the token will be fed at,
``fold_in(PRNGKey(seed), column)``, with ``jax.random``'s threefry2x32 key
schedule (``prng.py``). So a request regenerates the same stream whatever
tick, slot or replica serves it, and the port's streams are the JAX
package's. The draft runtimes of speculative decoding (``DraftRuntime``,
``build_draft``) are not ported yet: ROADMAP.md row A6b.
"""

import numpy as np
import torch

from . import prng

__all__ = ["row_keys", "sample_rows", "sampling_arrays"]


def row_keys(seeds, cols):
    """One key per row, ``fold_in(PRNGKey(seeds[s]), cols[s])``: int64
    ``[S, 2]``. ``seeds`` are int32 values, ``cols`` cache columns."""
    seeds = torch.as_tensor(seeds).to(torch.int64)
    return prng.fold_in(prng.prng_key(seeds), torch.as_tensor(
        cols, device=seeds.device).to(torch.int64))


def _softmax(x):
    """``jax.nn.softmax`` over the last axis: ``exp(x - max) / sum``."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def sample_rows(logits, temps, top_ks, top_ps, keys, vocab):
    """Per-row greedy / temperature / top-k / top-p sampling with per-row
    keys, as the JAX package's ``sample_rows``. ``logits [S, V_padded]``;
    ``temps``/``top_ps`` float32 ``[S]``; ``top_ks`` ``[S]`` (0 = off);
    ``keys [S, 2]``. Greedy rows (``temps <= 0``) take the float32 argmax
    over the real vocab. Sampled rows follow HF's warper order:
    temperature, then top-k, then top-p on the top-k-renormalised
    distribution, then a Gumbel-max draw. When no row samples, the sampled
    branch (whose result every row would discard) is not computed.
    Returns int64 ``[S]``."""
    last = logits[:, :vocab].to(torch.float32)
    greedy = torch.argmax(last, dim=-1)
    # decided on the host when the controls come from there (the serving
    # path's numpy registers), so that a greedy tick waits on no device
    if not bool((torch.as_tensor(temps) > 0).any()):
        return greedy
    temps = torch.as_tensor(temps, dtype=torch.float32, device=last.device)
    top_ks = torch.as_tensor(top_ks, device=last.device).to(torch.int64)
    top_ps = torch.as_tensor(top_ps, dtype=torch.float32, device=last.device)
    v = last.shape[-1]
    scaled = last / torch.clamp_min(temps, 1e-6)[:, None]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, 1, torch.clamp(top_ks - 1, 0, v - 1)[:, None])
    k_on = (top_ks > 0)[:, None]
    masked = torch.where(k_on & (scaled < kth), -torch.inf, scaled)
    # top-p on the top-k survivors (exactly the first k sorted entries)
    eff_k = torch.where(top_ks > 0, top_ks, v)
    col = torch.arange(v, device=last.device)
    desc = torch.where(col[None, :] < eff_k[:, None], desc, -torch.inf)
    probs = _softmax(desc)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_ps[:, None]
    thresh = torch.where(keep, desc, torch.inf).amin(-1, keepdim=True)
    p_on = (top_ps < 1.0)[:, None]
    masked = torch.where(p_on & (masked < thresh), -torch.inf, masked)
    sampled = prng.categorical(keys.to(last.device), masked)
    return torch.where(temps <= 0.0, greedy, sampled)


def sampling_arrays(n: int):
    """Neutral per-slot sampling registers (greedy, no truncation):
    (temps f32, top_ks i32, top_ps f32, seeds i32)."""
    return (np.zeros((n,), np.float32), np.zeros((n,), np.int32),
            np.ones((n,), np.float32), np.zeros((n,), np.int32))
