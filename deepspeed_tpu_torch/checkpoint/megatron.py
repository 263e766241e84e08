"""Megatron-LM GPT checkpoint loader — offline TP×PP merge into a
deepspeed_tpu_torch model: the JAX package's ``checkpoint/megatron.py``.

One loader walks the ``mp_rank_XX`` (tp-only) or ``mp_rank_XX_YYY`` (tp×pp)
shards of a Megatron-LM GPT checkpoint, merges the tensor-parallel
partitions (column-parallel on dim 0, row-parallel on dim 1,
vocab-parallel embeddings on dim 0), remaps each pipeline stage's LOCAL
layer numbering onto the global stack, converts the fused qkv rows of
whichever ``checkpoint_version`` the shard declares (0, 1.0 or 2.0; any
other raises, as in the JAX package) into the head-major q|k|v
convention, and returns ``(GPT2Model, params)``: the params a JAX-layout
tree of float32 numpy arrays, bitwise the JAX package's, ready for
``init_inference`` or ``initialize``.

QKV row layouts by version (h = hidden, n = heads, p = tp degree,
np = n/p, hn = h/n):
  v0   : [(3·np·hn), h] per shard — [Q|K|V] component-major; tp-merge must
         split each shard into thirds and concat per component
  v1.0 : [(np·hn·3), h] — element-interleaved per head (hn, 3)
  v2.0 : [(np·3·hn), h] — per-head [q|k|v] blocks (the classic layout)

DeepSpeed-MoE checkpoints (expert shards, a ``deepspeed_moe`` gate) raise
naming ROADMAP.md row A10: the MoE GPT is not ported.
"""

import glob
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..resilience.manifest import CheckpointLoadError
from ..module_inject.policy import deinterleave_qkv_bias, deinterleave_qkv_rows


_QKV = r"attention\.query_key_value\.(weight|bias)"
_COLUMN_PARALLEL = (_QKV, r"mlp\.dense_h_to_4h\.(weight|bias)")
_ROW_PARALLEL = (r"attention\.dense\.weight",
                 r"mlp\.dense_4h_to_h\.weight")


def _merge_qkv_v0(shards: List[np.ndarray]) -> np.ndarray:
    """v0: each shard is [Q|K|V] component-major — split thirds, concat per
    component across shards (reference merge_query_key_value ckpt_ver 0)."""
    assert shards[0].shape[0] % 3 == 0
    thirds = [np.split(s, 3, axis=0) for s in shards]
    return np.concatenate(
        [np.concatenate([t[i] for t in thirds], axis=0) for i in range(3)],
        axis=0)


def _merge(key: str, shards, ckpt_ver):
    """Merge one transformer-layer tensor across TP shards."""
    if re.search(_QKV, key) and ckpt_ver == 0:
        return _merge_qkv_v0(shards) if len(shards) > 1 else shards[0]
    if len(shards) == 1:
        return shards[0]
    if any(re.search(p, key) for p in _COLUMN_PARALLEL):
        return np.concatenate(shards, axis=0)
    if any(re.search(p, key) for p in _ROW_PARALLEL):
        return np.concatenate(shards, axis=1)
    return shards[0]            # replicated (layernorms, row-parallel bias)


def _qkv_to_ours(w: np.ndarray, b: np.ndarray, ckpt_ver, n_head: int,
                 hd: int) -> Tuple[np.ndarray, np.ndarray]:
    """Merged fused-qkv rows (+bias) of the given checkpoint_version →
    ([D, 3D] weight, [3D] bias) in this repo's head-major q|k|v columns."""
    if ckpt_ver == 0:
        # already [Q|K|V] component-major, head-major within each
        return w.T, b
    if ckpt_ver == 1.0:
        # per head (hn, 3) element-interleave → (3, n, hn)
        d = w.shape[1]
        wr = w.reshape(n_head, hd, 3, d)
        wq = np.concatenate([wr[:, :, i].reshape(n_head * hd, d)
                             for i in range(3)], axis=0)
        br = b.reshape(n_head, hd, 3)
        bq = np.concatenate([br[:, :, i].reshape(n_head * hd)
                             for i in range(3)])
        return wq.T, bq
    if ckpt_ver == 2.0:
        return (deinterleave_qkv_rows(w, n_head, hd),
                deinterleave_qkv_bias(b, n_head, hd))
    raise ValueError(
        f"unsupported Megatron checkpoint_version {ckpt_ver!r} "
        f"(known: 0, 1.0, 2.0 — reference state_dict_factory.py:220)")


def _np(t):
    """Torch tensor OR ndarray → fp32 ndarray (checkpoints may hold
    either)."""
    return np.asarray(t.detach().cpu().float().numpy()
                      if hasattr(t, "detach") else t, dtype=np.float32)


def _shard_paths(ckpt_dir: str, tag: Optional[str]):
    """-> list of (tp_rank, pp_rank, path), pp_rank -1 for tp-only
    layouts."""
    root = _resolve_tag_root(ckpt_dir, tag)

    def pick(d):
        """One .pt per shard dir: model_optim_rng.pt or an unambiguous
        single candidate (a bare glob would double-count
        distrib_optim.pt)."""
        p = os.path.join(d, "model_optim_rng.pt")
        if os.path.exists(p):
            return p
        cands = sorted(glob.glob(os.path.join(d, "*.pt")))
        if len(cands) != 1:
            raise ValueError(
                f"ambiguous Megatron shard dir {d!r}: no "
                f"model_optim_rng.pt and candidates {cands}")
        return cands[0]

    out = []
    for d in sorted(glob.glob(os.path.join(root, "mp_rank_*"))):
        m = re.match(r"mp_rank_(\d+)_(\d+)$", os.path.basename(d))
        if m:
            out.append((int(m.group(1)), int(m.group(2)), pick(d)))
            continue
        m = re.match(r"mp_rank_(\d+)$", os.path.basename(d))
        if m:
            out.append((int(m.group(1)), -1, pick(d)))
    if not out:
        raise FileNotFoundError(
            f"no Megatron mp_rank_* shards under {root!r}")
    pp_modes = {pp == -1 for _, pp, _ in out}
    if len(pp_modes) > 1:
        raise ValueError(
            f"mixed mp_rank_XX and mp_rank_XX_YYY dirs under {root!r}")
    return sorted(out)


def _read_shard(path) -> Tuple[Dict[str, np.ndarray], Any, Any]:
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    lm = ckpt["model"]["language_model"]
    flat = {}
    emb = lm.get("embedding") or {}
    if "word_embeddings" in emb:
        flat["wte"] = _np(emb["word_embeddings"]["weight"])
    if "position_embeddings" in emb:
        flat["wpe"] = _np(emb["position_embeddings"]["weight"])
    enc = lm.get("transformer", lm.get("encoder"))
    if enc is None:
        raise KeyError(
            "checkpoint has neither 'transformer' nor 'encoder' under "
            "language_model — not a Megatron-LM GPT checkpoint")
    for k, v in enc.items():
        # newer Megatron renamed attention -> self_attention; normalize
        # to the classic names the mapping below uses
        flat[k.replace(".self_attention.", ".attention.")] = _np(v)
    return flat, ckpt.get("args"), ckpt.get("checkpoint_version", 0)


#: the per-layer tensors a GPT shard must carry, by flavor (moe swaps
#: the dense MLP pair for the gate; experts live in separate shards)
_LAYER_KEYS = ("input_layernorm.weight", "input_layernorm.bias",
               "attention.query_key_value.weight",
               "attention.query_key_value.bias",
               "attention.dense.weight", "attention.dense.bias",
               "post_attention_layernorm.weight",
               "post_attention_layernorm.bias")
_DENSE_MLP_KEYS = ("mlp.dense_h_to_4h.weight", "mlp.dense_h_to_4h.bias",
                   "mlp.dense_4h_to_h.weight", "mlp.dense_4h_to_h.bias")
_MOE_MLP_KEYS = ("mlp.deepspeed_moe.gate.wg.weight",)
_GLOBAL_KEYS = ("wte", "wpe", "final_layernorm.weight",
                "final_layernorm.bias")


def _require_complete(merged: Dict[str, np.ndarray], layer_ids, is_moe,
                      ckpt_dir: str):
    """Structure gate for the merged shard set: every leaf the model
    builder will consume must exist BEFORE assembly starts. A truncated
    or mixed-family checkpoint (the old assumption: saved leaf count ==
    live leaf count) fails here with the exact missing/extra leaf names
    — not with a bare ``KeyError: 'layers.7.mlp...'`` halfway through
    stacking (resilience.CheckpointLoadError carries the per-leaf diff,
    mirroring the elastic loader's ``require_leaf_match``)."""
    per_layer = _LAYER_KEYS + (_MOE_MLP_KEYS if is_moe else _DENSE_MLP_KEYS)
    want = set(_GLOBAL_KEYS)
    for i in layer_ids:
        want.update(f"layers.{i}.{k}" for k in per_layer)
    have = set(merged)
    missing = sorted(want - have)
    if not missing:
        return
    extra = sorted(have - want)
    raise CheckpointLoadError(
        f"megatron checkpoint at {ckpt_dir!r} does not assemble into a "
        f"{len(layer_ids)}-layer {'MoE' if is_moe else 'dense'} GPT: "
        f"{len(missing)} leaf(s) missing "
        f"({missing[:8]}{'...' if len(missing) > 8 else ''});"
        f" {len(extra)} unconsumed leaf(s) present "
        f"({extra[:8]}{'...' if len(extra) > 8 else ''})",
        leaf_diff={"missing": missing, "extra": extra,
                   "shape_mismatch": []})


def load_megatron_checkpoint(ckpt_dir: str, tag: Optional[str] = None,
                             n_head: Optional[int] = None
                             ) -> Tuple[Any, Any]:
    """Load a Megatron-LM GPT checkpoint directory → (GPT2Model, params).

    Handles tp-only (``mp_rank_XX``) and tp×pp (``mp_rank_XX_YYY``)
    layouts; pipeline stages' local ``layers.N`` indices are offset onto
    the global stack in pp order (reference
    checkpoint/deepspeed_checkpoint.py:33 + reshape_meg_2d.py).
    ``n_head`` may be omitted when the checkpoint stores its training args
    (Megatron saves them under ``checkpoint['args']``)."""
    from ..models.gpt2 import GPT2Config, GPT2Model

    triples = _shard_paths(ckpt_dir, tag)
    pp_ranks = sorted({pp for _, pp, _ in triples})
    args = None
    ckpt_ver = None

    # per pp stage: merge tp shards, then remap local layer ids
    merged: Dict[str, np.ndarray] = {}
    layer_offset = 0
    for pp in pp_ranks:
        shards = []
        for tp, pp_r, path in triples:
            if pp_r != pp:
                continue
            flat, a, ver = _read_shard(path)
            args = args or a
            if ckpt_ver is None:
                ckpt_ver = ver
            elif ver != ckpt_ver:
                raise ValueError(
                    f"inconsistent checkpoint_version across shards: "
                    f"{ckpt_ver} vs {ver} ({path})")
            shards.append(flat)
        stage: Dict[str, np.ndarray] = {}
        keys = set().union(*[set(s) for s in shards])
        for k in keys:
            have = [s[k] for s in shards if k in s]
            if k == "wte":
                stage[k] = np.concatenate(have, axis=0)
            elif k == "wpe":
                stage[k] = have[0]
            else:
                stage[k] = _merge(k, have, ckpt_ver)
        # remap this stage's local layer numbering onto the global stack
        local_ids = sorted({int(m.group(1)) for k in stage
                            if (m := re.match(r"layers\.(\d+)\.", k))})
        remap = {i: layer_offset + j for j, i in enumerate(local_ids)}
        for k, v in stage.items():
            m = re.match(r"layers\.(\d+)\.(.*)", k)
            if m:
                merged[f"layers.{remap[int(m.group(1))]}.{m.group(2)}"] = v
            elif k in merged and pp != pp_ranks[0]:
                # embeddings live on the first stage; later stages may
                # carry tied copies (word_embeddings_for_head) — first wins
                continue
            else:
                merged[k] = v
        layer_offset += len(local_ids)

    if "wte" not in merged:
        raise KeyError("no word_embeddings found on the first pipeline "
                       "stage — not a GPT checkpoint?")
    if n_head is None:
        if args is None or not hasattr(args, "num_attention_heads"):
            raise ValueError(
                "checkpoint stores no args; pass n_head= explicitly")
        n_head = int(args.num_attention_heads)

    layer_ids = sorted({int(m.group(1)) for k in merged
                        if (m := re.match(r"layers\.(\d+)\.", k))})
    n_layer = len(layer_ids)
    v, d = merged["wte"].shape
    hd = d // n_head
    is_moe = any(".mlp.deepspeed_moe.gate." in k for k in merged)
    _require_complete(merged, layer_ids, is_moe, ckpt_dir)
    if is_moe:
        inner = 4 * d  # ExpertFFN is fixed 4x (checked against shards below)
    else:
        inner = merged["layers.0.mlp.dense_h_to_4h.weight"].shape[0]
        if inner % d != 0:
            raise ValueError(f"ffn size {inner} not a multiple of hidden {d}")
    cfg = GPT2Config(vocab_size=v, n_positions=merged["wpe"].shape[0],
                     n_embd=d, n_layer=n_layer, n_head=n_head,
                     mlp_ratio=inner // d, pad_vocab_to_multiple=1)
    # whole: an engine at tp > 1 keeps each rank's part, as of a JAX tree
    spec = GPT2Model(cfg, tp=1)

    def layer(i, name):
        return merged[f"layers.{i}.{name}"]

    qkv = [_qkv_to_ours(layer(i, "attention.query_key_value.weight"),
                        layer(i, "attention.query_key_value.bias"),
                        ckpt_ver, n_head, hd) for i in layer_ids]

    blocks = {
        "ln1_scale": np.stack([layer(i, "input_layernorm.weight")
                               for i in layer_ids]),
        "ln1_bias": np.stack([layer(i, "input_layernorm.bias")
                              for i in layer_ids]),
        "qkv_w": np.stack([w for w, _ in qkv]),
        "qkv_b": np.stack([b for _, b in qkv]),
        "attn_proj_w": np.stack([layer(i, "attention.dense.weight").T
                                 for i in layer_ids]),
        "attn_proj_b": np.stack([layer(i, "attention.dense.bias")
                                 for i in layer_ids]),
        "ln2_scale": np.stack([layer(i, "post_attention_layernorm.weight")
                               for i in layer_ids]),
        "ln2_bias": np.stack([layer(i, "post_attention_layernorm.bias")
                              for i in layer_ids]),
    }
    if is_moe:
        # Megatron gate Linear is [E, M]; our TopKGate wg is [M, E]
        blocks["moe_gate_wg"] = np.stack(
            [layer(i, "mlp.deepspeed_moe.gate.wg.weight").T
             for i in layer_ids])
    else:
        blocks.update({
            "mlp_fc_w": np.stack([layer(i, "mlp.dense_h_to_4h.weight").T
                                  for i in layer_ids]),
            "mlp_fc_b": np.stack([layer(i, "mlp.dense_h_to_4h.bias")
                                  for i in layer_ids]),
            "mlp_proj_w": np.stack([layer(i, "mlp.dense_4h_to_h.weight").T
                                    for i in layer_ids]),
            "mlp_proj_b": np.stack([layer(i, "mlp.dense_4h_to_h.bias")
                                    for i in layer_ids]),
        })
    params = {
        "wte": merged["wte"],
        "wpe": merged["wpe"],
        "blocks": blocks,
        "ln_f_scale": merged["final_layernorm.weight"],
        "ln_f_bias": merged["final_layernorm.bias"],
    }

    moe = _load_expert_shards(ckpt_dir, tag, layer_ids, merged)
    if is_moe and moe is None:
        raise FileNotFoundError(
            f"checkpoint has deepspeed_moe gate weights but no "
            f"layer_*_expert_*_mp_rank_* expert shards under "
            f"{_resolve_tag_root(ckpt_dir, tag)!r} — partial MoE checkpoint")
    if moe is not None:
        return _to_moe_model(cfg, params, moe)
    return spec, params


def _resolve_tag_root(ckpt_dir: str, tag: Optional[str]):
    """Resolve the checkpoint root via latest_checkpointed_iteration.txt
    (shared by main-shard and expert-shard discovery)."""
    if tag is None:
        latest = os.path.join(ckpt_dir, "latest_checkpointed_iteration.txt")
        if os.path.exists(latest):
            with open(latest) as f:
                it = f.read().strip()
            tag = "release" if it == "release" else f"iter_{int(it):07d}"
    return os.path.join(ckpt_dir, tag) if tag else ckpt_dir


def _load_expert_shards(ckpt_dir, tag, layer_ids, merged):
    """DeepSpeed-MoE expert shards (``layer_<L>_expert_<E>_mp_rank_<TP>_
    model_states.pt``): None for a dense checkpoint; the MoE GPT they
    would build is ROADMAP.md row A10."""
    root = _resolve_tag_root(ckpt_dir, tag)
    if not glob.glob(os.path.join(
            root, "layer_*_expert_*_mp_rank_*_model_states.pt")):
        return None
    raise NotImplementedError(
        f"{root!r} is a DeepSpeed-MoE checkpoint (expert shards); the MoE "
        f"GPT is not ported yet: ROADMAP.md row A10")


def _to_moe_model(cfg, params, moe):
    raise NotImplementedError("the MoE GPT is not ported yet: ROADMAP.md "
                              "row A10")
