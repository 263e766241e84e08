"""BERT family — bidirectional post-LN encoder with MLM head.

The JAX package's ``models/bert.py`` as an ``nn.Module``: post-LN residuals
(``x = LN(x + sublayer(x))``), bidirectional attention with an optional
padding mask, segment (token-type) embeddings, and a masked-LM head
(dense + gelu + LN transform, decoder tied to ``wte`` plus a vocab bias).
The parameters carry the JAX leaf names and ``[in, out]`` layouts
(``top_leaves``, ``block_leaves``), so ``load_jax_params`` / ``jax_params``
move a JAX tree in and out.

Attention: without a mask, ``ops/flash_attention.flash_attention(causal=
False)``, which on the card is the ``[B, H, T, D]`` Hopper kernel (K3, or
K4 past the resident regime) and its backward; with a padding mask, the
plain path, as in the JAX package. ``attn_override(q, k, v, mask)`` over
``[B, H, T, D]`` replaces the attention: ``SparseAttentionUtils`` installs
block-sparse attention there (K6 forward, K7 backward).

Batch: ``{"input_ids" [B,T], optional "token_type_ids" [B,T],
"attention_mask" [B,T] (1=keep), "labels" [B,T] (-100 = unmasked)}`` or,
for the MLM head on the masked positions only, ``"masked_positions"``
[B, P] and ``"masked_labels"`` [B, P].

Training with a key ``rng`` drops as the JAX family does: the embeddings
under ``fold_in(rng, 2)``, and in layer ``i`` (key ``fold_in(rng, i)``) the
attention and MLP outputs under salts 0 and 1 and, without an
``attn_override``, the attention probabilities under salt 3 (an override
forgoes that dropout: its hook takes no key). ``config.remat`` checkpoints
each layer (``runtime/activation_checkpointing``). There is no progressive
layer drop or random-LTD: ``apply`` takes no ``pld_theta`` or
``ltd_keep``, so the engine refuses both for BERT, as the JAX engine does.

Tensor parallelism (``tp``, as for GPT-2: the GPT-2 base's
``TensorParallelLayers`` over the JAX package's ``partition_rules()``):
``qkv_w`` / ``qkv_b`` hold the rank's heads of each of q, k and v,
``attn_out_w`` and ``out_w`` are row-parallel (their biases added once
after the all-reduce), ``inter_w`` / ``inter_b`` column-parallel, ``wte``
and the MLM bias vocab-parallel: the logits are gathered whole over the
vocab, and the MLM loss is the vocab-parallel NLL (``_ChunkedNLL``), no
rank building whole logits. ``wpe``, ``tte``, the LayerNorms and the MLM
transform are whole on every rank. The sparse surgery's attention takes
the rank's rows of the whole layout (``SparseSelfAttention`` reads the
model's ``_head_range()``), and the dropout of the dense path's
probabilities draws the rank's heads of the whole mask.
"""

import dataclasses
from typing import Optional

import torch

from .api import ModelSpec, open_leaves
from .gpt2 import (GPT2Config, BlockParams, TensorParallelLayers, _ChunkedNLL,
                   _activation, _param, normal_)
from ..inference import prng
from ..parallel import tensor_parallel as tpl
from ..ops import memory_efficient as me
from ..ops.dropout import salted_dropout
from ..ops.flash_attention import flash_attention
from ..runtime.activation_checkpointing import checkpointing


@dataclasses.dataclass(frozen=True)
class BertConfig(GPT2Config):
    vocab_size: int = 30522
    n_positions: int = 512
    type_vocab_size: int = 2
    activation: str = "gelu_exact"   # HF hidden_act="gelu" (erf)


BERT_BASE = BertConfig(n_embd=768, n_layer=12, n_head=12)
BERT_LARGE = BertConfig(n_embd=1024, n_layer=24, n_head=16)


class BertModel(TensorParallelLayers, ModelSpec):
    """BERT with the JAX package's parameter layout, built on ``device`` in
    ``dtype`` and drawn from ``generator`` (default: seed 0 on the CPU) on
    the generator's own device; at ``tp`` (default: the rank mesh's
    ``model`` axis) each sharded leaf drawn whole and the rank's part
    kept."""

    causal_attention = False
    top_leaves = ("wte", "wpe", "tte", "emb_ln_scale", "emb_ln_bias",
                  "mlm_dense_w", "mlm_dense_b", "mlm_ln_scale", "mlm_ln_bias",
                  "mlm_bias")
    block_leaves = ("qkv_w", "qkv_b", "attn_out_w", "attn_out_b",
                    "attn_ln_scale", "attn_ln_bias", "inter_w", "inter_b",
                    "out_w", "out_b", "out_ln_scale", "out_ln_bias")

    def __init__(self, config: BertConfig = BERT_BASE,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=None, tp=None):
        super().__init__()
        self.config = config
        # attention override hook: attn_override(q, k, v, mask) -> attn,
        # q/k/v [B,H,T,D]. Set by SparseAttentionUtils model surgery
        # (reference sparse_attention_utils.py:81 replaces the torch
        # BertSelfAttention module; here the function is the module)
        self.attn_override = None
        self.tp = tpl.resolve(tp)
        self._check_tp()
        self._splits = self._make_splits()
        top, block = self._leaf_shapes()
        for name in self.top_leaves:
            setattr(self, name, _param(self._local(name, top[name]), device,
                                       dtype))
        self.blocks = torch.nn.ModuleList(
            BlockParams({n: self._local(f"blocks.{i}.{n}", block[n])
                         for n in self.block_leaves}, device, dtype)
            for i in range(config.n_layer))
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    def partition_rules(self):
        """The JAX package's rules (``deepspeed_tpu/models/bert.py``)."""
        return [
            (r"wte$", ("model", None)),
            (r"(wpe|tte)$", (None, None)),
            (r"mlm_bias$", ("model",)),
            (r"blocks/qkv_w$", ("pipe", None, "model")),
            (r"blocks/qkv_b$", ("pipe", "model")),
            (r"blocks/attn_out_w$", ("pipe", "model", None)),
            (r"blocks/inter_w$", ("pipe", None, "model")),
            (r"blocks/inter_b$", ("pipe", "model")),
            (r"blocks/out_w$", ("pipe", "model", None)),
            (r"blocks/", ("pipe",)),
        ]

    def _leaf_shapes(self):
        """``(top, block)``: the shape of every JAX leaf by name."""
        cfg = self.config
        d, v, m = cfg.n_embd, cfg.padded_vocab, cfg.mlp_ratio * cfg.n_embd
        top = {"wte": (v, d), "wpe": (cfg.n_positions, d),
               "tte": (cfg.type_vocab_size, d), "emb_ln_scale": (d,),
               "emb_ln_bias": (d,), "mlm_dense_w": (d, d),
               "mlm_dense_b": (d,), "mlm_ln_scale": (d,),
               "mlm_ln_bias": (d,), "mlm_bias": (v,)}
        block = {"qkv_w": (d, 3 * d), "qkv_b": (3 * d,),
                 "attn_out_w": (d, d), "attn_out_b": (d,),
                 "attn_ln_scale": (d,), "attn_ln_bias": (d,),
                 "inter_w": (d, m), "inter_b": (m,), "out_w": (m, d),
                 "out_b": (d,), "out_ln_scale": (d,), "out_ln_bias": (d,)}
        return top, block

    def _tp_counts(self):
        cfg = self.config
        return {"n_head": cfg.n_head, "padded_vocab": cfg.padded_vocab,
                "intermediate": cfg.mlp_ratio * cfg.n_embd}

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init_weights(self, generator):
        """The JAX init's shapes and stds: N(0, 0.02) for every weight
        matrix and embedding, LN scales 1, every bias 0. Drawn from
        ``generator`` on its device, each leaf whole."""
        std = self.config.initializer_range
        splits = self._split_by_id()

        def normal(p):
            normal_(p, std, generator, splits.get(id(p)))

        for name in ("wte", "wpe", "tte", "mlm_dense_w"):
            normal(getattr(self, name))
        for blk in self.blocks:
            for name in ("qkv_w", "attn_out_w", "inter_w", "out_w"):
                normal(getattr(blk, name))
        for owner, names in ((self, self.top_leaves),
                             *((blk, self.block_leaves)
                               for blk in self.blocks)):
            for name in names:
                if name.endswith("_scale"):
                    getattr(owner, name).fill_(1.0)
                elif name.endswith("_b") or name.endswith("_bias"):
                    getattr(owner, name).zero_()

    # --------------------------------------------------------------- forward
    def _compute_dtype(self):
        dt = self.wte.dtype
        return dt if dt.is_floating_point else getattr(torch, self.config.dtype)

    def _ln(self, x, scale, bias):
        return me.layer_norm(x, scale, bias, self.config.layer_norm_epsilon)

    def _dropout(self, x, rng, train, salt):
        return salted_dropout(x, rng, train, salt, self.config.dropout)

    def _block(self, x, p, mask, rng=None, train=False):
        """Post-LN encoder block (HF BertLayer semantics); at tp > 1 on the
        rank's heads and MLP columns."""
        cfg = self.config
        b, t, _ = x.shape
        h, hd = self._heads, cfg.head_dim
        xin = tpl.copy_to_tp(x, self.tp)
        qkv = xin @ p.qkv_w.to(x.dtype) + p.qkv_b.to(x.dtype)
        q, k, v = (y.reshape(b, t, h, hd).transpose(1, 2)
                   for y in qkv.split(h * hd, dim=-1))
        if self.attn_override is not None:
            attn = self.attn_override(q, k, v, mask)
        else:
            dropping = train and cfg.dropout > 0 and rng is not None
            with self._probs_heads():
                attn = flash_attention(
                    q, k, v, causal=False, mask=mask,
                    dropout_rate=cfg.dropout if train else 0.0,
                    dropout_rng=prng.fold_in_words(rng, 3) if dropping
                    else None, backend=cfg.attn_backend)
        attn = attn.transpose(1, 2).reshape(b, t, h * hd)
        attn = self._row_out(attn, p.attn_out_w, p.attn_out_b)
        x = self._ln(x + self._dropout(attn, rng, train, 0), p.attn_ln_scale,
                     p.attn_ln_bias)
        xin = tpl.copy_to_tp(x, self.tp)
        mid = _activation(xin @ p.inter_w.to(x.dtype) +
                          p.inter_b.to(x.dtype), cfg.activation)
        out = self._row_out(mid, p.out_w, p.out_b)
        return self._ln(x + self._dropout(out, rng, train, 1),
                        p.out_ln_scale, p.out_ln_bias)

    def encode(self, input_ids, token_type_ids=None, attention_mask=None,
               rng=None, train=True):
        """Embeddings + encoder stack. Returns [B, T, D] in the compute
        dtype; dropout only with a key ``rng`` while training."""
        dt = self._compute_dtype()
        t = input_ids.shape[-1]
        if t > self.wpe.shape[0]:
            raise ValueError(f"{t} tokens exceed the model's n_positions="
                             f"{self.wpe.shape[0]}")
        x = tpl.vocab_parallel_embedding(input_ids, self.wte.to(dt),
                                         self.tp) + self.wpe[:t].to(dt)
        if token_type_ids is not None:
            x = x + self.tte.to(dt)[token_type_ids]
        else:
            x = x + self.tte[0].to(dt)
        rng = None if rng is None else prng.as_key(rng)
        x = self._dropout(self._ln(x, self.emb_ln_scale, self.emb_ln_bias),
                          rng, train, 2)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].to(torch.bool)
        policy = self._remat_policy()
        recomputed = policy is not None and policy.recompute
        for i, p in enumerate(self.blocks):
            layer_rng = None if rng is None else prng.fold_in_words(rng, i)

            def run(h, leaves=self._layer_leaves(p), layer_rng=layer_rng):
                with open_leaves(leaves, recomputed) as lv:
                    return self._block(h, lv, mask, layer_rng, train)

            x = run(x) if policy is None else \
                checkpointing.run(policy, run, x)
        return x

    def _mlm_transform(self, x):
        """The MLM head's dense + activation + LN (whole on every rank)."""
        cfg = self.config
        x = x @ self.mlm_dense_w.to(x.dtype) + self.mlm_dense_b.to(x.dtype)
        return self._ln(_activation(x, cfg.activation), self.mlm_ln_scale,
                        self.mlm_ln_bias)

    def _mlm_head(self, x):
        """Transform + tied decoder + vocab bias on hidden states x: the
        whole ``[..., padded_vocab]`` logits (gathered at tp > 1)."""
        x = self._mlm_transform(x)
        logits = tpl.copy_to_tp(x, self.tp) @ self.wte.to(x.dtype).T + \
            self.mlm_bias.to(x.dtype)
        return tpl.gather_from_tp(logits, self.tp)

    def mlm_logits(self, input_ids, token_type_ids=None,
                   attention_mask=None):
        """``[B, T, padded_vocab]`` MLM logits in the compute dtype
        (inference: ``train=False``, as the JAX inference engine calls its
        model)."""
        return self._mlm_head(self.encode(input_ids, token_type_ids,
                                          attention_mask, train=False))

    def logits(self, input_ids):
        """MLM logits: the inference engine's scoring contract."""
        return self.mlm_logits(input_ids)

    forward = logits

    # ------------------------------------------------------------ training
    def apply(self, batch, rng=None, train=True):
        """Masked-LM loss over labels != -100 (HF convention, unshifted).

        If the batch carries ``masked_positions`` [B, P] (+ ``masked_labels``
        [B, P], -100 = slot unused), the vocab head runs ONLY on those P
        gathered positions. ``rng`` / ``train``: dropout, as in
        :meth:`encode`. Overrides ``nn.Module.apply(fn)``: on a model of
        this port, ``apply`` is the loss, as in the JAX package."""
        fields = batch if isinstance(batch, dict) else {"input_ids": batch}
        input_ids = fields["input_ids"]
        x = self.encode(input_ids, fields.get("token_type_ids"),
                        fields.get("attention_mask"), rng=rng, train=train)
        mpos = fields.get("masked_positions")
        if mpos is not None:
            x = torch.gather(x, 1, mpos[..., None].expand(-1, -1,
                                                          x.shape[-1]))
        labels, valid = self._mlm_labels(fields)
        safe = torch.where(valid, labels, 0).long()
        if self.tp.active:
            # vocab-parallel: the rank's block of logits and bias, the
            # NLL's statistics combined over the ranks
            h = tpl.copy_to_tp(self._mlm_transform(x), self.tp)
            n = h.shape[0] * h.shape[1]
            wte = self.wte.to(h.dtype)
            total = _ChunkedNLL.apply(
                h.reshape(n, h.shape[-1]), wte, self.mlm_bias.to(h.dtype),
                safe.reshape(n), valid.reshape(n), wte.shape[0], self.tp)
        else:
            total = me.dense_xent_sum(self._mlm_head(x), safe, valid)
        return total / torch.clamp_min(valid.sum(), 1)

    def _mlm_labels(self, fields):
        """The labels ``apply`` scores (``masked_labels`` when the batch
        gathers ``masked_positions``) and their valid mask."""
        labels = fields["masked_labels"] \
            if fields.get("masked_positions") is not None else \
            fields.get("labels", fields["input_ids"])
        return labels, (labels >= 0) & (labels < self.config.vocab_size)

    def loss_count(self, batch):
        """The valid masked-LM targets of ``batch`` (``apply``'s
        divisor)."""
        fields = batch if isinstance(batch, dict) else {"input_ids": batch}
        return self._mlm_labels(fields)[1].sum()

    def flops_per_token(self, seq_len: Optional[int] = None):
        """Training FLOPs/token: 6 x (block weights + head) + the attention
        term (12·L·D·T), as the JAX package counts."""
        cfg = self.config
        d, l = cfg.n_embd, cfg.n_layer
        block = (4 + 2 * cfg.mlp_ratio) * l * d * d
        flops = 6 * (block + cfg.padded_vocab * d + d * d)
        if seq_len:
            flops += 12 * l * d * seq_len
        return flops
