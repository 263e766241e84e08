"""LLaMA family: RMSNorm, rotary, SwiGLU and grouped-query attention.

The JAX package's ``models/llama.py`` over the port's ``GPT2Model``: the
same decoder stack, serving and training paths, with LLaMA's family hooks.
No position table (rotary inside attention, HF's rotate_half convention),
RMSNorm without biases, a SwiGLU MLP (gate/up/down), optional
grouped-query attention (``n_kv_head < n_head``), an untied LM head and an
optional sliding window.

Attention always goes through ``ops/seq_parallel.sp_attention`` ->
``ops/flash_attention.flash_attention``, as in the JAX package: on the card
the ``[B, H, T, D]`` Hopper kernels (K3 forward, the K3b/K5 backward), with
the kv heads repeated for the kernels first. The KV-cache path keeps
``kv_heads`` heads in the cache and repeats them in the plain cache
attention; ``_decode_attn_mask`` applies the window there. Training
drops as the JAX family does (salt 3 on the attention probabilities, which
then take the plain attention; 0 and 1 on the two sublayer outputs); the
layer wrappers (progressive layer drop, random-LTD, remat) come from the
GPT-2 base, and so does tensor parallelism: at tp > 1 a rank holds ``H /
tp`` query heads and ``H_kv / tp`` kv heads of ``qkv_w``, its block of
``gate_w`` / ``up_w`` columns and of ``attn_proj_w`` / ``down_w`` rows, and
its vocab rows of ``wte`` and ``lm_head`` (the JAX package's
``partition_rules()``); ``n_head``, ``n_kv_head``, the padded vocab and
the MLP width must divide by tp. With fewer kv heads than ranks the kv
heads are replicated, as Megatron does (``tp`` must be a multiple of
``n_kv_head``): rank ``r`` holds kv head ``r n_kv_head / tp`` beside its
query heads, its cache holds that one head, and in training the shared
kv columns' gradients are summed over the ranks that hold them
(``tensor_parallel.sum_shared_grads``), the norm counting them once.
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from .gpt2 import GPT2Config, GPT2Model, normal_
from ..inference import prng
from ..parallel import tensor_parallel as tpl
from ..ops.seq_parallel import sp_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig(GPT2Config):
    vocab_size: int = 32000
    n_positions: int = 2048
    activation: str = "silu"
    n_kv_head: Optional[int] = None     # None => MHA
    rope_theta: float = 10000.0
    mlp_hidden: Optional[int] = None    # intermediate size; None => mlp_ratio*d
    sliding_window: Optional[int] = None  # Mistral windowed causal attention
    tie_word_embeddings: bool = False
    layer_norm_epsilon: float = 1e-5    # rms_norm eps

    @property
    def kv_head_count(self):
        return self.n_kv_head or self.n_head

    @property
    def intermediate(self):
        return self.mlp_hidden or self.mlp_ratio * self.n_embd


# presets matching Meta shapes
LLAMA_7B = LlamaConfig(n_embd=4096, n_layer=32, n_head=32, mlp_hidden=11008)
LLAMA_13B = LlamaConfig(n_embd=5120, n_layer=40, n_head=40, mlp_hidden=13824)
LLAMA2_70B = LlamaConfig(n_embd=8192, n_layer=80, n_head=64, n_kv_head=8,
                         mlp_hidden=28672, n_positions=4096)


def _rms_norm(x, scale, eps):
    """f32 statistics, ``y * scale`` in f32, then the input's dtype."""
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def rope_cos_sin(pos, head_dim, theta, dtype):
    """cos/sin tables for HF rotate_half rotary. ``pos``: [T] or [B, T].
    Returns cos/sin of shape ``pos.shape + (head_dim,)`` (the half-table
    duplicated), angles in f32, cast to ``dtype``."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=pos.device) / head_dim))
    angles = pos.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def apply_rope(x, cos, sin):
    """x: [B, H, T, hd]; cos/sin: [T, hd] (shared) or [B, T, hd] (per-row
    positions). HF rotate_half convention."""
    if cos.dim() == 3:                  # [B, T, hd] -> [B, 1, T, hd]
        cos, sin = cos[:, None], sin[:, None]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


class LlamaModel(GPT2Model):
    """LLaMA with the JAX package's parameter layout (``wte``, ``lm_head``
    unless tied, ``ln_f_scale``; per layer ``ln1_scale``, ``qkv_w`` whose
    columns are q | k | v with ``kv_heads`` heads in k and v,
    ``attn_proj_w``, ``ln2_scale``, ``gate_w``, ``up_w``, ``down_w``).

    Built on ``device`` in ``dtype`` and drawn from ``generator`` on its
    own device: a CUDA generator fills LLaMA-7B on the card in its compute
    type, never holding 27 GB of f32 on the host, while one CPU seed gives
    the same weights as ever."""

    block_leaves = ("ln1_scale", "qkv_w", "attn_proj_w", "ln2_scale",
                    "gate_w", "up_w", "down_w")
    has_position_table = False

    def __init__(self, config: LlamaConfig = LLAMA_7B,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=None, tp=None):
        if config.n_embd != config.n_head * config.head_dim:
            raise ValueError(f"n_embd={config.n_embd} is not n_head="
                             f"{config.n_head} x head_dim")
        if config.n_head % config.kv_head_count:
            raise ValueError(f"n_head={config.n_head} must be a multiple of "
                             f"n_kv_head={config.kv_head_count}")
        super().__init__(config, generator, device, dtype, tp)

    def partition_rules(self):
        return [
            (r"wte$", ("model", None)),
            (r"lm_head$", ("model", None)),
            (r"blocks/qkv_w$", ("pipe", None, "model")),
            (r"blocks/attn_proj_w$", ("pipe", "model", None)),
            (r"blocks/(gate_w|up_w)$", ("pipe", None, "model")),
            (r"blocks/down_w$", ("pipe", "model", None)),
            (r"blocks/", ("pipe",)),
        ]

    def _qkv_sections(self):
        cfg = self.config
        hd = cfg.head_dim
        return [cfg.n_head * hd, cfg.kv_head_count * hd,
                cfg.kv_head_count * hd]

    def _qkv_parts(self):
        """Blocks of q, k and v: the kv sections split into ``n_kv_head``
        blocks when there are fewer kv heads than ranks (each shared by
        ``tp / n_kv_head`` ranks)."""
        n, hk = self.tp.size, self.config.kv_head_count
        return [n, min(n, hk), min(n, hk)]

    def _tp_counts(self):
        cfg = self.config
        n, hk = self.tp.size, cfg.kv_head_count
        counts = {"n_head": cfg.n_head, "n_kv_head": hk,
                  "padded_vocab": cfg.padded_vocab,
                  "mlp_hidden": cfg.intermediate}
        if n > hk:
            if n % hk:
                raise ValueError(
                    f"{type(self).__name__} at tp={n}: n_kv_head={hk} kv "
                    f"heads are replicated over the ranks only when tp is a "
                    f"multiple of n_kv_head")
            del counts["n_kv_head"]
        return counts

    @property
    def top_leaves(self):
        return ("wte", "ln_f_scale") if self.config.tie_word_embeddings \
            else ("wte", "lm_head", "ln_f_scale")

    @property
    def kv_heads(self) -> int:
        return max(1, self.config.kv_head_count // self.tp.size)

    @property
    def _kv_total(self) -> int:
        return self.config.kv_head_count

    def _leaf_shapes(self):
        cfg = self.config
        d, m = cfg.n_embd, cfg.intermediate
        hd, hk = cfg.head_dim, cfg.kv_head_count
        top = {"wte": (cfg.padded_vocab, d), "lm_head": (cfg.padded_vocab, d),
               "ln_f_scale": (d,)}
        block = {"ln1_scale": (d,), "qkv_w": (d, (cfg.n_head + 2 * hk) * hd),
                 "attn_proj_w": (d, d), "ln2_scale": (d,),
                 "gate_w": (d, m), "up_w": (d, m), "down_w": (m, d)}
        return top, block

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init_weights(self, generator):
        """The JAX init's shapes and stds: N(0, 0.02) for wte, lm_head, qkv,
        gate and up; N(0, 0.02 / sqrt(2 L)) for attn_proj and down; norm
        scales 1. Drawn from ``generator`` on its device."""
        cfg = self.config
        std = cfg.initializer_range
        proj_std = std / math.sqrt(2 * cfg.n_layer)
        splits = self._split_by_id()

        def normal(p, s):
            normal_(p, s, generator, splits.get(id(p)))

        normal(self.wte, std)
        if not cfg.tie_word_embeddings:
            normal(self.lm_head, std)
        for blk in self.blocks:
            normal(blk.qkv_w, std)
            normal(blk.attn_proj_w, proj_std)
            normal(blk.gate_w, std)
            normal(blk.up_w, std)
            normal(blk.down_w, proj_std)
            blk.ln1_scale.fill_(1.0)
            blk.ln2_scale.fill_(1.0)
        self.ln_f_scale.fill_(1.0)

    # ------------------------------------------------- family hook overrides
    def _embed(self, input_ids, start_pos=0, positions=None):
        # rotary: positions enter through attention, not the embedding
        return tpl.vocab_parallel_embedding(
            input_ids, self.wte.to(self._compute_dtype()), self.tp)

    def _final_norm(self, x):
        return _rms_norm(x, self.ln_f_scale, self.config.layer_norm_epsilon)

    def _unembed_weight(self, dtype):
        head = self.wte if self.config.tie_word_embeddings else self.lm_head
        return head.to(dtype)

    def _decode_attn_mask(self, q_pos, k_pos):
        keep = k_pos <= q_pos
        if self.config.sliding_window is not None:
            keep &= (q_pos - k_pos) < self.config.sliding_window
        return keep

    # ----------------------------------------------------------------- block
    def _attn_sublayer(self, x, p, attn_fn=None, start_pos=0,
                       positions=None, rng=None, train=False, extra=None):
        cfg = self.config
        b, t, _ = x.shape
        h, hk, hd = self._heads, self.kv_heads, cfg.head_dim
        ln1 = tpl.copy_to_tp(_rms_norm(x, p.ln1_scale, cfg.layer_norm_epsilon),
                             self.tp)
        w = tpl.sum_shared_grads(p.qkv_w, self._splits.get("blocks.0.qkv_w"),
                                 self.tp)
        qkv = ln1 @ w.to(ln1.dtype)
        q, k, v = qkv.split([h * hd, hk * hd, hk * hd], dim=-1)
        q = q.reshape(b, t, h, hd).transpose(1, 2)
        k = k.reshape(b, t, hk, hd).transpose(1, 2)
        v = v.reshape(b, t, hk, hd).transpose(1, 2)
        pos = positions if positions is not None else \
            start_pos + torch.arange(t, device=x.device)
        cos, sin = rope_cos_sin(pos, hd, cfg.rope_theta, q.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if attn_fn is not None:
            attn = attn_fn(q, k, v)       # decode: cache stores hk-head k/v
        else:
            if hk != h:                   # GQA: repeat kv heads for the kernel
                k = torch.repeat_interleave(k, h // hk, dim=1)
                v = torch.repeat_interleave(v, h // hk, dim=1)
            dropping = train and cfg.dropout > 0 and rng is not None
            with self._probs_heads():
                attn = sp_attention(
                    q, k, v, causal=True,
                    dropout_rate=cfg.dropout if train else 0.0,
                    dropout_rng=prng.fold_in_words(rng, 3) if dropping
                    else None, impl=cfg.sp_attention,
                    backend=cfg.attn_backend, window=cfg.sliding_window)
        attn = attn.transpose(1, 2).reshape(b, t, h * hd)
        attn = self._row_out(attn, p.attn_proj_w)
        return x + self._dropout(attn, rng, train, 0)

    def _mlp_sublayer(self, x, p, rng=None, train=False):
        cfg = self.config
        ln2 = tpl.copy_to_tp(_rms_norm(x, p.ln2_scale, cfg.layer_norm_epsilon),
                             self.tp)
        g = ln2 @ p.gate_w.to(ln2.dtype)
        u = ln2 @ p.up_w.to(ln2.dtype)
        out = self._row_out(F.silu(g) * u, p.down_w)
        return x + self._dropout(out, rng, train, 1)

    def flops_per_token(self, seq_len: Optional[int] = None):
        """Training FLOPs/token: 6 x (block weights + one V x d head) +
        the attention term (12·L·D·T), as the JAX package counts."""
        cfg = self.config
        d, l, m = cfg.n_embd, cfg.n_layer, cfg.intermediate
        hd, hk = cfg.head_dim, cfg.kv_head_count
        block = l * (d * (cfg.n_head + 2 * hk) * hd + d * d + 3 * d * m)
        flops = 6 * (block + cfg.padded_vocab * d)
        if seq_len:
            flops += 12 * l * d * seq_len
        return flops
