"""GPT-NeoX / GPT-J family: partial rotary and the parallel residual.

The JAX package's ``models/gpt_neox.py`` over the port's ``GPT2Model``.
One class covers both flavors, which differ in config flags:

- GPT-NeoX: two LayerNorms a block feeding the parallel residual
  ``x + attn(ln1 x) + mlp(ln2 x)``, partial rotate_half rotary
  (``rotary_pct``), qkv and projection biases, exact GELU;
- GPT-J (``gptj_config``): one LayerNorm feeding both branches
  (``shared_ln``), partial interleaved rotary (rotate_every_two), no
  attention biases, an LM head with a bias (``lm_head_b``), tanh GELU.

Both have no position table and an untied LM head. Attention goes through
``ops/seq_parallel.sp_attention`` -> ``ops/flash_attention``, as in the
JAX package: on the card the ``[B, H, T, D]`` Hopper kernel (K3; at GPT-J's
head dim 256 its wgmma instance), never the packed K1. The KV-cache and
slot paths are the GPT-2 base's. Tensor parallelism is the base's under
the JAX ``partition_rules()``: a rank holds its heads of q, k and v (and
of ``qkv_b``), its block of MLP columns, and its vocab rows of ``wte``,
``lm_head`` and ``lm_head_b``; rotary runs on the rank's heads, and the
head bias is added to the rank's logits before they are gathered, and to
each vocab chunk of the vocab-parallel loss.
"""

import dataclasses
from typing import Optional

import torch

from .gpt2 import GPT2Config, GPT2Model, _activation
from .llama import apply_rope, rope_cos_sin
from ..inference import prng
from ..ops import memory_efficient as me
from ..ops.seq_parallel import sp_attention
from ..parallel import tensor_parallel as tpl


@dataclasses.dataclass(frozen=True)
class GPTNeoXConfig(GPT2Config):
    activation: str = "gelu_exact"    # HF NeoX hidden_act="gelu" (erf)
    rotary_pct: float = 0.25
    rotary_ndims: Optional[int] = None  # explicit rotary dims (GPT-J rotary_dim)
    rope_theta: float = 10000.0
    use_parallel_residual: bool = True
    shared_ln: bool = False           # GPT-J: ln_1 feeds attn AND mlp
    rotary_interleaved: bool = False  # GPT-J rotate_every_two convention
    attn_bias: bool = True            # GPT-J: False
    head_bias: bool = False           # GPT-J lm_head has a bias

    @property
    def rot_dims(self):
        if self.rotary_ndims is not None:
            return self.rotary_ndims
        return int(self.head_dim * self.rotary_pct)


def gptj_config(**kw) -> GPTNeoXConfig:
    """GPT-J flavor of the shared config."""
    base = dict(activation="gelu", shared_ln=True, rotary_interleaved=True,
                attn_bias=False, head_bias=True, use_parallel_residual=True)
    base.update(kw)
    return GPTNeoXConfig(**base)


# presets matching EleutherAI shapes
PYTHIA_160M = GPTNeoXConfig(vocab_size=50304, n_embd=768, n_layer=12,
                            n_head=12)
NEOX_20B = GPTNeoXConfig(vocab_size=50432, n_embd=6144, n_layer=44,
                         n_head=64, n_positions=2048)
GPTJ_6B = gptj_config(vocab_size=50400, n_embd=4096, n_layer=28, n_head=16,
                      rotary_ndims=64, n_positions=2048)


def apply_rope_interleaved(x, angles):
    """GPT-J rotate_every_two: pairs are (x[2i], x[2i+1]).
    x: [B, H, T, rot]; angles: [T, rot/2] or [B, T, rot/2] (float32),
    their cos and sin cast to x's dtype."""
    cos, sin = torch.cos(angles).to(x.dtype), torch.sin(angles).to(x.dtype)
    if angles.dim() == 3:               # [B, T, r] -> [B, 1, T, r]
        cos, sin = cos[:, None], sin[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape)


class GPTNeoXModel(GPT2Model):
    """GPT-NeoX / GPT-J with the JAX package's parameter layout: ``wte``,
    ``lm_head`` (+ ``lm_head_b``), ``ln_f_*``; per layer ``ln1_*`` (and
    ``ln2_*`` unless ``shared_ln``), ``qkv_w`` (+ ``qkv_b``),
    ``attn_proj_w`` (+ ``attn_proj_b``), ``mlp_fc_*``, ``mlp_proj_*``."""

    has_position_table = False

    def __init__(self, config: GPTNeoXConfig = PYTHIA_160M,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=None, tp=None):
        if not 0 < config.rot_dims <= config.head_dim or \
                config.rot_dims % 2:
            raise ValueError(f"rotary dims {config.rot_dims} must be even "
                             f"and in (0, head_dim={config.head_dim}]")
        super().__init__(config, generator, device, dtype, tp)

    @property
    def top_leaves(self):
        return ("wte", "ln_f_scale", "ln_f_bias", "lm_head") + \
            (("lm_head_b",) if self.config.head_bias else ())

    @property
    def block_leaves(self):
        cfg = self.config
        names = ["ln1_scale", "ln1_bias", "qkv_w", "attn_proj_w",
                 "mlp_fc_w", "mlp_fc_b", "mlp_proj_w", "mlp_proj_b"]
        if cfg.attn_bias:
            names += ["qkv_b", "attn_proj_b"]
        if not cfg.shared_ln:
            names += ["ln2_scale", "ln2_bias"]
        return tuple(names)

    def partition_rules(self):
        return [
            (r"wte$", ("model", None)),
            (r"lm_head$", ("model", None)),
            (r"lm_head_b$", ("model",)),
            (r"blocks/qkv_w$", ("pipe", None, "model")),
            (r"blocks/qkv_b$", ("pipe", "model")),
            (r"blocks/attn_proj_w$", ("pipe", "model", None)),
            (r"blocks/mlp_fc_w$", ("pipe", None, "model")),
            (r"blocks/mlp_fc_b$", ("pipe", "model")),
            (r"blocks/mlp_proj_w$", ("pipe", "model", None)),
            (r"blocks/", ("pipe",)),
        ]

    def _leaf_shapes(self):
        cfg = self.config
        d, f, v = cfg.n_embd, cfg.mlp_ratio * cfg.n_embd, cfg.padded_vocab
        top = {"wte": (v, d), "ln_f_scale": (d,), "ln_f_bias": (d,),
               "lm_head": (v, d), "lm_head_b": (v,)}
        block = {"ln1_scale": (d,), "ln1_bias": (d,),
                 "ln2_scale": (d,), "ln2_bias": (d,),
                 "qkv_w": (d, 3 * d), "qkv_b": (3 * d,),
                 "attn_proj_w": (d, d), "attn_proj_b": (d,),
                 "mlp_fc_w": (d, f), "mlp_fc_b": (f,),
                 "mlp_proj_w": (f, d), "mlp_proj_b": (d,)}
        return top, block

    # ------------------------------------------------- family hook overrides
    def _embed(self, input_ids, start_pos=0, positions=None):
        # rotary: positions enter through attention, not the embedding
        return tpl.vocab_parallel_embedding(
            input_ids, self.wte.to(self._compute_dtype()), self.tp)

    def _unembed_weight(self, dtype):
        return self.lm_head.to(dtype)

    def _head_bias(self, dtype):
        """GPT-J's ``lm_head_b`` (the rank's vocab slice at tp > 1)."""
        return self.lm_head_b.to(dtype) if self.config.head_bias else None

    # ----------------------------------------------------------------- block
    def _partial_rope(self, x, pos):
        """Rotary on the first ``rot_dims`` of each head: rotate_half, or
        interleaved for GPT-J; the rest passes through."""
        cfg = self.config
        rot = cfg.rot_dims
        x_rot, x_pass = x[..., :rot], x[..., rot:]
        if cfg.rotary_interleaved:
            inv = 1.0 / (cfg.rope_theta ** (torch.arange(
                0, rot, 2, dtype=torch.float32, device=x.device) / rot))
            angles = pos.to(torch.float32)[..., None] * inv
            x_rot = apply_rope_interleaved(x_rot, angles)
        else:
            cos, sin = rope_cos_sin(pos, rot, cfg.rope_theta, x.dtype)
            x_rot = apply_rope(x_rot, cos, sin)
        return torch.cat([x_rot, x_pass], dim=-1) \
            if rot < x.shape[-1] else x_rot

    def _attn_branch(self, ln1, p, attn_fn, start_pos, positions, rng,
                     train):
        cfg = self.config
        b, t, _ = ln1.shape
        h, hd = self._heads, cfg.head_dim
        qkv = ln1 @ p.qkv_w.to(ln1.dtype)
        if cfg.attn_bias:
            qkv = qkv + p.qkv_b.to(ln1.dtype)
        q, k, v = (y.reshape(b, t, h, hd).transpose(1, 2)
                   for y in qkv.split(h * hd, dim=-1))
        pos = positions if positions is not None else \
            start_pos + torch.arange(t, device=ln1.device)
        q = self._partial_rope(q, pos)
        k = self._partial_rope(k, pos)
        if attn_fn is not None:
            attn = attn_fn(q, k, v)
        else:
            dropping = train and cfg.dropout > 0 and rng is not None
            with self._probs_heads():
                attn = sp_attention(
                    q, k, v, causal=True,
                    dropout_rate=cfg.dropout if train else 0.0,
                    dropout_rng=prng.fold_in_words(rng, 3) if dropping
                    else None, impl=cfg.sp_attention,
                    backend=cfg.attn_backend)
        attn = attn.transpose(1, 2).reshape(b, t, h * hd)
        return self._row_out(attn, p.attn_proj_w,
                             p.attn_proj_b if cfg.attn_bias else None)

    def _mlp_branch(self, ln2, p):
        hmid = ln2 @ p.mlp_fc_w.to(ln2.dtype) + p.mlp_fc_b.to(ln2.dtype)
        hmid = _activation(hmid, self.config.activation)
        return self._row_out(hmid, p.mlp_proj_w, p.mlp_proj_b)

    def _block(self, x, p, attn_fn=None, start_pos=0, positions=None,
               rng=None, train=False, extra=None):
        cfg = self.config
        eps = cfg.layer_norm_epsilon
        ln1 = tpl.copy_to_tp(me.layer_norm(x, p.ln1_scale, p.ln1_bias, eps),
                             self.tp)
        attn = self._attn_branch(ln1, p, attn_fn, start_pos, positions, rng,
                                 train)
        if cfg.use_parallel_residual:
            mlp_in = ln1 if cfg.shared_ln else tpl.copy_to_tp(
                me.layer_norm(x, p.ln2_scale, p.ln2_bias, eps), self.tp)
            mlp = self._mlp_branch(mlp_in, p)
            return x + self._dropout(attn, rng, train, 0) + \
                self._dropout(mlp, rng, train, 1)
        h = x + self._dropout(attn, rng, train, 0)
        ln2 = tpl.copy_to_tp(me.layer_norm(h, p.ln2_scale, p.ln2_bias, eps),
                             self.tp)
        return h + self._dropout(self._mlp_branch(ln2, p), rng, train, 1)
