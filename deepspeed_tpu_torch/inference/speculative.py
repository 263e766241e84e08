"""Speculative decoding over the slot pool: the draft runtimes and the
deterministic per-request sampling of the JAX package's
``inference/speculative.py``.

A draft model proposes ``k`` tokens a slot
(``InferenceEngine.slot_draft_propose``, ``k + 1`` draft decode steps);
the target verifies all of them in one batched forward
(``GPT2Model.verify_with_slots`` through ``slot_verify_step``), accepts
the longest prefix that matches its own sample and rolls the rejected
K/V columns back inside the step.

Every sampled token is drawn with a key that derives only from the
request's seed and the cache column the token will be fed at,
``fold_in(PRNGKey(seed), column)``, with ``jax.random``'s threefry2x32 key
schedule (``prng.py``). So a request regenerates the same stream whatever
tick, slot or replica serves it, speculation on or off, and the port's
streams are the JAX package's. The draft samples with the same keys as
the target, which couples the two draws and raises acceptance.

Draft flavors (``speculative.draft``):

- ``mode="self"``: the target's first ``layers`` blocks under its own
  final norm and head; the draft's parameters are the target's
  ``Parameter`` objects, no copy.
- ``mode="model"``: a smaller config of the same family (``n_layer``,
  ``n_embd``, ``n_head``), its weights drawn by the port's own init from
  ``seed``.
"""

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from . import prng

__all__ = ["DraftRuntime", "build_draft", "draft_key", "row_keys",
           "sample_rows", "sampling_arrays"]


def draft_key(cfg) -> tuple:
    """Hashable identity of a draft config: the engine keeps one
    ``DraftRuntime`` per key, so serving engines over one
    ``InferenceEngine`` share draft weights."""
    return ("self" if cfg.mode == "self" else "model",
            int(getattr(cfg, "layers", 0)), int(getattr(cfg, "n_layer", 0)),
            int(getattr(cfg, "n_embd", 0)), int(getattr(cfg, "n_head", 0)),
            int(getattr(cfg, "seed", 0)))


@dataclasses.dataclass
class DraftRuntime:
    """A draft model ready to propose."""
    model: Any
    mode: str
    layers: int
    key: tuple

    @property
    def describe(self) -> str:
        cfg = self.model.config
        if self.mode == "self":
            return f"self(layers={self.layers})"
        return f"model({cfg.n_layer}L/{cfg.n_embd}d)"


def _self_draft(target, layers: int):
    """A model of the target's family over its first ``layers`` blocks and
    its top leaves: the same ``Parameter`` objects, nothing allocated."""
    model = type(target).__new__(type(target))
    nn.Module.__init__(model)
    model.config = dataclasses.replace(target.config, n_layer=layers)
    # the target's parts, on its tp ranks (none at tp 1)
    model.tp, model._splits = target.tp, target._splits
    for name in model.top_leaves:
        setattr(model, name, getattr(target, name))
    model.blocks = nn.ModuleList(target.blocks[:layers])
    return model.eval()


def build_draft(engine, cfg) -> DraftRuntime:
    """Build a ``DraftRuntime`` for ``engine`` from a ``DraftConfig``-shaped
    object (``mode`` / ``layers`` / ``n_layer`` / ``n_embd`` / ``n_head``
    / ``seed``), as the JAX package's ``build_draft``."""
    target = engine.module
    tcfg = target.config
    mode = getattr(cfg, "mode", "self")
    if mode == "self":
        layers = int(getattr(cfg, "layers", 0)) or max(1, tcfg.n_layer // 2)
        if not 1 <= layers <= tcfg.n_layer:
            raise ValueError(
                f"speculative.draft.layers={layers} outside "
                f"[1, {tcfg.n_layer}]")
        return DraftRuntime(model=_self_draft(target, layers), mode="self",
                            layers=layers, key=draft_key(cfg))
    if mode != "model":
        raise ValueError(f"speculative.draft.mode must be self|model, "
                         f"got {mode!r}")
    over = {name: int(getattr(cfg, name, 0))
            for name in ("n_layer", "n_embd", "n_head")
            if int(getattr(cfg, name, 0))}
    dcfg = dataclasses.replace(tcfg, **over)
    if dcfg.n_embd % dcfg.n_head:
        raise ValueError(
            f"draft n_embd={dcfg.n_embd} not divisible by "
            f"n_head={dcfg.n_head}")
    # at the target's tp on its mesh: each leaf drawn whole, the rank
    # keeping its part, so one seed gives one draft at every tp
    gen = torch.Generator().manual_seed(int(getattr(cfg, "seed", 0)))
    model = type(target)(dcfg, generator=gen, device=engine.device,
                         dtype=engine.dtype, tp=target.tp).eval()
    return DraftRuntime(model=model, mode="model", layers=dcfg.n_layer,
                        key=draft_key(cfg))


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
