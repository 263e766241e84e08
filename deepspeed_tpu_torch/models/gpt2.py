"""GPT-2 family: serving and training.

The JAX package's ``models/gpt2.py`` as an ``nn.Module``: one
``BlockParams`` per layer in an ``nn.ModuleList``, each holding the JAX
parameter leaves of its layer under the same names and in the same
``[in, out]`` layout (``x @ w``), so ``load_jax_params`` copies a JAX tree
across leaf by leaf. The leaf names are the class's ``top_leaves`` and
``block_leaves``, so a family that subclasses ``GPT2Model`` (LLaMA) loads
and exports its own tree through the same methods, and the family hooks
(``_embed``, ``_attn_sublayer``, ``_decode_attn_mask``, ...) are the JAX
base class's, with the JAX base's family hooks for the decoders built on
it (OPT, BLOOM, GPT-Neo, GPT-NeoX / GPT-J): ``_layer_extras`` (per-layer
constants handed to each layer), ``_train_attn_bias(_ex)`` (a training
attention bias, which keeps the layer on the plain attention, as in the
JAX dispatch), ``_decode_attn_bias`` and ``_decode_attn_mask_ex`` on
every cache and slot path, and ``_head_bias`` on every logits path and in
the loss. The attention of ``forward``-style calls (scoring and
training) takes the packed Hopper kernels whenever ``_packed_attn_ok``
holds, exactly where the JAX package takes its packed Pallas kernel: K1
forward, K2 backward, through the autograd ``Function`` of
``ops/kernels/flash_attention_packed.py``. The KV-cache path
(``apply_with_cache``) computes its attention with the plain
``reference_attention`` under the family's ``_decode_attn_mask``, kv heads
repeated for grouped-query attention, as the JAX package does; so do the
serving slot paths built on it: ``decode_with_slots`` (one token a row at
per-row cache columns, the continuous-batching step) and
``chunk_prefill_with_cache`` (a prompt chunk's K/V, no logits).

Training: ``apply(batch, rng, train, pld_theta, ltd_keep)`` is the
next-token loss, dense (``_lm_loss``) or vocab-chunked
(``_chunked_lm_loss``, an autograd ``Function`` that never holds ``[B, T,
V]`` logits), dispatched as in the JAX package. With a key ``rng`` (a
``(word0, word1)`` pair, ``inference/prng.py``) and ``config.dropout > 0``
it drops as the JAX package does, bit for bit: layer ``i``'s key is
``fold_in(rng, i)``, with salts 0 (attention output), 1 (MLP output), 2
(embeddings, under ``rng`` itself) and 3 (attention probabilities, which
take the plain attention, as the JAX package leaves its packed kernel
while dropping); ``ops/dropout.py`` runs the hand-written threefry
dropout kernel on the card. The layer wrappers nest as the JAX layer
scan's do: random-LTD (``ltd_keep``: the block runs on a sorted random
subset of tokens, at positions ``0..keep-1``) inside progressive layer
drop (``pld_theta``: a host coin under ``fold_in(layer_key, 1002)``, a
dropped layer is the identity) inside activation checkpointing
(``config.remat`` / ``remat_policy``:
``runtime/activation_checkpointing``). Without a key there is no dropout
and no wrapper. ``act_bits`` (the compression library's activation
fake-quant) raises naming ROADMAP.md row A12.

Tensor parallelism (``tp``: the rank mesh's ``model`` axis, or a
``TPInfo`` passed in; ``parallel/tensor_parallel.py``): the model is built
at its rank's shapes by the JAX package's ``partition_rules()``, and each
layer runs Megatron's split. ``qkv`` and ``mlp_fc`` are column-parallel
(the rank's ``H / tp`` heads of each of q, k and v, its block of MLP
columns) behind ``copy_to_tp``; ``attn_proj`` and ``mlp_proj`` are
row-parallel, their products summed by ``reduce_from_tp`` before the
replicated bias is added once. ``wte`` is vocab-parallel, and so is the
tied head: ``forward``'s and the cache paths' logits are gathered whole
over the vocab (a head bias, GPT-J's, the rank's slice added first), and
the loss is the vocab-parallel NLL of ``_ChunkedNLL`` (with that slice in
each chunk's logits). The KV cache holds the rank's heads, and the packed
kernels run on them. Embeddings, LayerNorms and the residual stream are
whole on every rank. ``init_weights`` draws every leaf whole, a leaf at a
time, and keeps the rank's part, so one seed gives the same weights at
every tp.
"""

import contextlib
import dataclasses
import functools
import math
import os
from typing import Optional

import torch
from torch import nn

from .api import ModelSpec, open_leaves
from ..parallel import tensor_parallel as tpl
from ..parallel.topology import MODEL_AXIS
from ..inference import prng
from ..ops import memory_efficient as me
from ..ops.dropout import first_row, rank_heads, salted_dropout
from ..ops.flash_attention import flash_attention, reference_attention
from ..ops.kernels import flash_attention_packed as k1
from ..ops.random_ltd_ops import (sample_token_indices, token_gather,
                                  token_scatter)
from ..runtime.activation_checkpointing import checkpointing
from ..runtime.progressive_layer_drop import keep_prob_for_layer


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    activation: str = "gelu"       # gelu | relu (OPT family)
    mlp_ratio: int = 4
    pos_offset: int = 0            # learned-position offset (OPT uses 2)
    # training knobs, kept so one config serves both packages
    remat: bool = False
    remat_policy: Optional[str] = None
    scan_unroll: int = 1
    loss_chunking: str = "auto"    # auto | always | never
    loss_chunk_target: int = 8192
    # auto | pallas | xla. "pallas" is the hand-written kernel here, and
    # raises where it does not apply
    attn_backend: str = "auto"
    sp_attention: str = "ulysses"  # ulysses | ring (when the 'seq' axis is live)
    dtype: str = "float32"         # compute dtype when params are not floating
    pad_vocab_to_multiple: int = 128

    @property
    def padded_vocab(self):
        m = self.pad_vocab_to_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def head_dim(self):
        return self.n_embd // self.n_head


GPT2_125M = GPT2Config(n_embd=768, n_layer=12, n_head=12)
GPT2_350M = GPT2Config(n_embd=1024, n_layer=24, n_head=16)
GPT2_760M = GPT2Config(n_embd=1536, n_layer=24, n_head=16)
GPT2_1_3B = GPT2Config(n_embd=2048, n_layer=24, n_head=32)

_ACTIVATIONS = {"gelu": me.gelu, "gelu_exact": me.gelu_exact,
                "relu": me.relu, "silu": me.silu,
                "quick_gelu": me.quick_gelu}

def _activation(x, name):
    fn = _ACTIVATIONS.get(name)
    if fn is None:
        raise ValueError(f"unknown activation {name!r}")
    return fn(x)


def _param(shape, device=None, dtype=None):
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype))


class BlockParams(nn.Module):
    """One decoder layer's parameters, named as the JAX leaves."""

    def __init__(self, shapes, device=None, dtype=None):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, _param(shape, device, dtype))


def normal_(p, std, generator, split=None):
    """Fill ``p`` with N(0, std) drawn in float32 by ``generator`` on the
    generator's own device, then cast to p's dtype and device. With a
    ``TPSplit`` the whole leaf is drawn and ``p`` keeps the rank's part,
    so the stream is the same at every tp."""
    shape = p.shape if split is None else split.whole_shape
    x = torch.randn(shape, generator=generator, device=generator.device) * std
    p.copy_(x if split is None else split.take(x))


def _rule_dim(path, rules, ndim):
    """The dim a partition rule puts ``model`` on (None when it does not),
    the rule matched and padded as the planner does."""
    spec = tpl.rule_spec(path, rules, ndim)
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


class TensorParallelLayers:
    """Megatron's split of a family's leaves over the ``model`` axis, for a
    ``ModelSpec`` whose class names its ``partition_rules()`` (the JAX
    package's), ``_leaf_shapes()`` and the column spans of its fused
    ``qkv`` (``_qkv_sections``) and sets ``self.tp``: the ``TPSplit`` of
    each leaf a rule puts ``model`` on (``_make_splits``), the rank's
    query heads, a whole model's in-place sharding and the row-parallel
    projection. GPT-2, LLaMA and BERT take it."""

    tensor_parallel = True

    def _qkv_sections(self):
        """The column spans of q, k and v in the fused projection."""
        d = self.config.n_embd
        return [d, d, d]

    def _qkv_parts(self):
        """The blocks each of q, k and v splits into (one a rank)."""
        return [self.tp.size] * 3

    def _tp_counts(self):
        """``{what: count}`` that must divide by tp."""
        cfg = self.config
        return {"n_head": cfg.n_head, "padded_vocab": cfg.padded_vocab}

    def _check_tp(self):
        """At tp > 1: the counts the rank's parts split divide by tp
        (dropout draws each rank's heads of the whole mask: ``ops/
        dropout.py``)."""
        n = self.tp.size
        if n == 1:
            return
        counts = self._tp_counts()
        if any(v % n for v in counts.values()):
            raise ValueError(
                f"{type(self).__name__} at tp={n}: "
                + ", ".join(f"{k}={v}" for k, v in counts.items())
                + f" must each divide by tp={n}")

    def _make_splits(self):
        """``{parameter name: TPSplit}`` of the leaves the rules shard
        (empty at tp 1)."""
        if not self.tp.active:
            return {}
        rules = self.partition_rules()
        top, block = self._leaf_shapes()
        out = {}
        for name in self.top_leaves:
            dim = _rule_dim(name, rules, len(top[name]))
            if dim is not None:
                out[name] = tpl.TPSplit(top[name], dim, self.tp.rank,
                                        self.tp.size)
        for name in self.block_leaves:
            dim = _rule_dim(f"blocks/{name}", rules, len(block[name]) + 1)
            if dim is None:
                continue
            qkv = name.startswith("qkv_")
            for i in range(self.config.n_layer):
                out[f"blocks.{i}.{name}"] = tpl.TPSplit(
                    block[name], dim - 1, self.tp.rank, self.tp.size,
                    self._qkv_sections() if qkv else None,
                    self._qkv_parts() if qkv else None)
        return out

    def _local(self, name, shape):
        split = self._splits.get(name)
        return shape if split is None else split.local_shape

    def tp_splits(self):
        return [self._splits.get(n) for n, _ in self.named_parameters()]

    @torch.no_grad()
    def shard_tp(self, tp):
        """Keep, in place, ``tp``'s rank part of each sharded leaf of this
        whole (tp 1) model: what the engines do with a model built before
        the mesh. Returns the model."""
        tp = tpl.resolve(tp)
        if self.tp.active:
            if (self.tp.size, self.tp.rank) != (tp.size, tp.rank):
                raise ValueError(f"the model was built at {self.tp}, the "
                                 f"engine runs {tp}")
            return self
        self.tp = tp
        self._check_tp()
        self._splits = self._make_splits()
        for name, p in self.named_parameters():
            split = self._splits.get(name)
            if split is not None:
                p.data = split.take(p.data)
        return self

    @property
    def _heads(self) -> int:
        """The query heads this rank computes."""
        return self.config.n_head // self.tp.size

    def _split_by_id(self):
        return {id(p): self._splits.get(n)
                for n, p in self.named_parameters()}

    def _head_range(self):
        """``(first query head of this rank, n_head)``: where the rank's
        heads lie among all of them."""
        return self.tp.rank * self._heads, self.config.n_head

    def _probs_heads(self):
        """Where the attention probabilities a rank drops lie in the JAX
        draw: its heads of ``n_head`` (:func:`ops.dropout.rank_heads`) at
        tp > 1; the contiguous map at tp 1."""
        return rank_heads(*self._head_range()) if self.tp.active else \
            contextlib.nullcontext()

    def _row_out(self, a, w, bias=None):
        """A row-parallel projection: ``a @ w`` summed over the tp ranks,
        then the replicated bias added once."""
        out = tpl.reduce_from_tp(a @ w.to(a.dtype), self.tp)
        return out if bias is None else out + bias.to(a.dtype)


class GPT2Model(TensorParallelLayers, ModelSpec):
    """GPT-2 with the JAX package's parameter layout. The weights are made
    on ``device`` in ``dtype`` (default: the CPU, float32) and drawn from
    ``generator`` (default: seed 0 on the CPU) on the generator's device, so
    one CPU seed gives the same weights whatever the device."""

    causal_attention = True
    # JAX leaf names: top-level leaves, and those of one layer (the
    # [L, ...] leaves of params["blocks"])
    top_leaves = ("wte", "wpe", "ln_f_scale", "ln_f_bias")
    block_leaves = ("ln1_scale", "ln1_bias", "qkv_w", "qkv_b", "attn_proj_w",
                    "attn_proj_b", "ln2_scale", "ln2_bias", "mlp_fc_w",
                    "mlp_fc_b", "mlp_proj_w", "mlp_proj_b")

    def __init__(self, config: GPT2Config = GPT2_125M,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=None, tp=None):
        super().__init__()
        self.config = config
        self.tp = tpl.resolve(tp)
        self._check_tp()
        self._splits = self._make_splits()
        top, block = self._leaf_shapes()
        for name in self.top_leaves:
            setattr(self, name, _param(self._local(name, top[name]), device,
                                       dtype))
        self.blocks = nn.ModuleList(
            BlockParams({n: self._local(f"blocks.{i}.{n}", block[n])
                         for n in self.block_leaves}, device, dtype)
            for i in range(config.n_layer))
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    # ------------------------------------------------- tensor parallelism
    def partition_rules(self):
        """The JAX package's tensor- and pipeline-parallel rules, on the
        JAX tree's (stacked) shapes; the planner drops size-1 axes."""
        return [
            (r"wte$", ("model", None)),
            (r"wpe$", (None, None)),
            (r"blocks/qkv_w$", ("pipe", None, "model")),
            (r"blocks/qkv_b$", ("pipe", "model")),
            (r"blocks/attn_proj_w$", ("pipe", "model", None)),
            (r"blocks/mlp_fc_w$", ("pipe", None, "model")),
            (r"blocks/mlp_fc_b$", ("pipe", "model")),
            (r"blocks/mlp_proj_w$", ("pipe", "model", None)),
            (r"blocks/", ("pipe",)),
        ]

    def _leaf_shapes(self):
        """``(top, block)``: the shape of every JAX leaf by name."""
        cfg = self.config
        d, f = cfg.n_embd, cfg.mlp_ratio * cfg.n_embd
        top = {"wte": (cfg.padded_vocab, d),
               "wpe": (cfg.n_positions + cfg.pos_offset, d),
               "ln_f_scale": (d,), "ln_f_bias": (d,)}
        block = {"ln1_scale": (d,), "ln1_bias": (d,),
                 "qkv_w": (d, 3 * d), "qkv_b": (3 * d,),
                 "attn_proj_w": (d, d), "attn_proj_b": (d,),
                 "ln2_scale": (d,), "ln2_bias": (d,),
                 "mlp_fc_w": (d, f), "mlp_fc_b": (f,),
                 "mlp_proj_w": (f, d), "mlp_proj_b": (d,)}
        return top, block

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init_weights(self, generator):
        """The JAX init's shapes and stds, leaf by leaf in ``top_leaves``
        then ``block_leaves`` order: LN scales (``*_scale``) 1 and every
        bias (``*_bias``, ``*_b``) 0; N(0, 0.02 / sqrt(2 L)) for the two
        output projections; N(0, 0.02) for every other matrix (wte, wpe,
        an untied head, qkv, fc). Drawn from ``generator`` on its device;
        the GPT-2 families without a leaf (BLOOM's wpe, GPT-J's biases)
        draw the others in the same order."""
        cfg = self.config
        std = cfg.initializer_range
        proj_std = std / math.sqrt(2 * cfg.n_layer)
        splits = self._split_by_id()

        def init(p, name):
            if name.endswith("_scale"):
                p.fill_(1.0)
            elif name.endswith(("_bias", "_b")):
                p.zero_()
            else:
                normal_(p, proj_std if name in ("attn_proj_w", "mlp_proj_w")
                        else std, generator, splits.get(id(p)))

        for name in self.top_leaves:
            init(getattr(self, name), name)
        for blk in self.blocks:
            for name in self.block_leaves:
                init(getattr(blk, name), name)

    # ------------------------------------------------------------- pieces
    def _compute_dtype(self):
        dt = self.wte.dtype
        return dt if dt.is_floating_point else getattr(torch, self.config.dtype)

    def _embed(self, input_ids, start_pos=0, positions=None):
        """Token + learned-position embeddings in the compute dtype.
        ``positions`` [B, T] overrides ``start_pos`` for per-row offsets
        (left-padded batches)."""
        cfg = self.config
        dt = self._compute_dtype()
        t = input_ids.shape[-1]
        if positions is not None:
            # clamped, as the JAX package's gather clamps: a speculative
            # block may run past n_positions, and its logits there are
            # never read
            idx = torch.clamp(positions + cfg.pos_offset, 0,
                              self.wpe.shape[0] - 1)
            wpe = self.wpe.to(dt)[idx]
        else:
            first = start_pos + cfg.pos_offset
            if first < 0 or first + t > self.wpe.shape[0]:
                raise ValueError(
                    f"positions [{start_pos}, {start_pos + t}) exceed the "
                    f"model's n_positions={cfg.n_positions}")
            wpe = self.wpe[first:first + t].to(dt)
        return tpl.vocab_parallel_embedding(input_ids, self.wte.to(dt),
                                            self.tp) + wpe

    def _final_norm(self, x):
        return me.layer_norm(x, self.ln_f_scale, self.ln_f_bias,
                             self.config.layer_norm_epsilon)

    def _unembed_weight(self, dtype):
        """[V, D] weight of the LM head (tied to wte; the rank's vocab rows
        at tp > 1)."""
        return self.wte.to(dtype)

    def _head_logits(self, x):
        """``[..., padded_vocab]`` logits of the hidden states ``x``, the
        family's head bias added: the rank's vocab block, gathered whole
        at tp > 1."""
        logits = tpl.copy_to_tp(x, self.tp) @ self._unembed_weight(x.dtype).T
        head_b = self._head_bias(logits.dtype)
        if head_b is not None:
            logits = logits + head_b
        return tpl.gather_from_tp(logits, self.tp)

    def _attn_sublayer(self, x, p, attn_fn=None, start_pos=0,
                       positions=None, rng=None, train=False, extra=None):
        """ln1 -> qkv -> attention -> proj -> residual (+dropout).
        ``attn_fn(q, k, v)`` over ``[B, H, T, D]`` replaces the attention
        (the KV-cache path). ``start_pos`` and ``positions`` [B, T] are the
        tokens' positions, which GPT-2 reads in ``_embed`` and rotary
        families here. ``rng`` is the layer's key, ``extra`` its entry of
        ``_layer_extras()``. A family's training bias
        (``_train_attn_bias_ex``: ALiBi, GPT-Neo's window) sends the layer
        to the plain attention, as the JAX dispatch does."""
        cfg = self.config
        b, t, _ = x.shape
        h, hd = self._heads, cfg.head_dim
        d = h * hd                      # the rank's heads' width
        ln1 = tpl.copy_to_tp(me.layer_norm(x, p.ln1_scale, p.ln1_bias,
                                           cfg.layer_norm_epsilon), self.tp)
        qkv = ln1 @ p.qkv_w.to(ln1.dtype) + p.qkv_b.to(ln1.dtype)
        bias = None if attn_fn is not None else \
            self._train_attn_bias_ex(t, extra, x.device)
        dropping = train and cfg.dropout > 0 and rng is not None
        if (attn_fn is None and bias is None and not dropping and
                self.causal_attention and self._packed_attn_ok(x, t, hd, h)):
            # the kernels read q/k/v as the column thirds of the qkv
            # projection through its strides (no head transpose, no copy);
            # the backward writes dq/dk/dv into one [B, T, 3D] gradient
            attn = k1.packed_flash_attention_qkv(qkv, h)
            attn = self._row_out(attn, p.attn_proj_w, p.attn_proj_b)
            return x + self._dropout(attn, rng, train, 0)
        q, k, v = qkv.split(d, dim=-1)
        q = q.reshape(b, t, h, hd).transpose(1, 2)
        k = k.reshape(b, t, h, hd).transpose(1, 2)
        v = v.reshape(b, t, h, hd).transpose(1, 2)
        if attn_fn is not None:
            attn = attn_fn(q, k, v)
        else:
            with self._probs_heads():
                attn = flash_attention(
                    q, k, v, causal=self.causal_attention,
                    dropout_rate=cfg.dropout if train else 0.0,
                    dropout_rng=prng.fold_in_words(rng, 3) if dropping
                    else None, backend=cfg.attn_backend, bias=bias)
        attn = attn.transpose(1, 2).reshape(b, t, d)
        attn = self._row_out(attn, p.attn_proj_w, p.attn_proj_b)
        return x + self._dropout(attn, rng, train, 0)

    def _packed_attn_ok(self, x, t: int, hd: int, h: int) -> bool:
        """Packed-kernel eligibility, decided as in the JAX package: backend
        ``pallas`` always tries it (and the kernel raises if the shape is
        unsupported), ``auto`` takes it on the card, ``xla`` never; the
        shape must be one the kernel supports. The sequence-parallel axis
        has size 1 here. ``DSTPU_PACKED_ATTN=0`` disables it."""
        if os.environ.get("DSTPU_PACKED_ATTN", "1") == "0":
            return False
        if self.config.attn_backend == "pallas":
            pass
        elif self.config.attn_backend != "auto" or x.device.type != "cuda":
            return False
        return k1.supported(t, hd, h, True, None)

    def _mlp_sublayer(self, x, p, rng=None, train=False):
        """ln2 -> fc -> activation -> proj -> residual (+dropout)."""
        cfg = self.config
        ln2 = tpl.copy_to_tp(me.layer_norm(x, p.ln2_scale, p.ln2_bias,
                                           cfg.layer_norm_epsilon), self.tp)
        hmid = ln2 @ p.mlp_fc_w.to(ln2.dtype) + p.mlp_fc_b.to(ln2.dtype)
        hmid = _activation(hmid, cfg.activation)
        out = self._row_out(hmid, p.mlp_proj_w, p.mlp_proj_b)
        return x + self._dropout(out, rng, train, 1)

    def _block(self, x, p, attn_fn=None, start_pos=0, positions=None,
               rng=None, train=False, extra=None):
        return self._mlp_sublayer(
            self._attn_sublayer(x, p, attn_fn, start_pos, positions, rng,
                                train, extra), p, rng, train)

    def _dropout(self, x, rng, train, salt):
        return salted_dropout(x, rng, train, salt, self.config.dropout)

    # ---- family hooks of the JAX base (BLOOM, GPT-Neo override them) ----
    def _layer_extras(self):
        """Per-layer constants, one entry a layer, handed to each layer
        (not parameters: no gradients, no optimizer state), or None.
        GPT-Neo's local/global flags; None here."""
        return None

    def _train_attn_bias(self, t, device):
        """Additive bias of the ``[t, t]`` training attention logits
        (broadcast to ``[B, H, t, t]``; ALiBi), or None."""
        return None

    def _train_attn_bias_ex(self, t, extra, device):
        """The layer-aware training bias; the base defers to
        :meth:`_train_attn_bias`."""
        return self._train_attn_bias(t, device)

    def _decode_attn_bias(self, q_pos, k_pos):
        """Additive bias of the cache attention's logits over the cache
        columns ``k_pos`` (ALiBi), or None."""
        return None

    def _decode_attn_mask_ex(self, q_pos, k_pos, extra):
        """The layer-aware keep-mask over the cache; the base defers to
        :meth:`_decode_attn_mask`."""
        return self._decode_attn_mask(q_pos, k_pos)

    # ------------------------------------------------------------- forward
    def hidden_states(self, input_ids, rng=None, train=True, pld_theta=None,
                      ltd_keep=None, act_bits=None):
        """The decoder stack up to and including the final LayerNorm:
        ``[B, T, D]`` in the compute dtype. Without ``rng`` (inference)
        there is no dropout and no layer wrapper; ``pld_theta`` and
        ``ltd_keep`` as the JAX ``hidden_states`` takes them."""
        if act_bits is not None:
            raise NotImplementedError(
                f"{type(self).__name__} training with act_bits={act_bits} "
                f"(activation fake-quant, the compression library's) is not "
                f"ported yet: ROADMAP.md row A12")
        cfg = self.config
        rng = None if rng is None else prng.as_key(rng)
        x = self._dropout(self._embed(input_ids), rng, train, 2)
        wrappers = train and rng is not None
        t = x.shape[1]
        policy = self._remat_policy()
        extras = self._layer_extras()
        for i, p in enumerate(self.blocks):
            layer_rng = None if rng is None else prng.fold_in_words(rng, i)
            if wrappers and pld_theta is not None:
                keep_p = keep_prob_for_layer(pld_theta, i, cfg.n_layer)
                if not prng.bernoulli_scalar(
                        prng.fold_in_words(layer_rng, 1002), keep_p):
                    continue          # a dropped layer: the identity
            idx = None
            if wrappers and ltd_keep is not None and ltd_keep < t:
                idx = sample_token_indices(
                    prng.fold_in_words(layer_rng, 1001), ltd_keep,
                    x.shape[0], t, first_row()).to(x.device,
                                                   non_blocking=True)
            x = self._wrapped_block(x, self._layer_leaves(p), layer_rng,
                                    train, idx, policy,
                                    None if extras is None else extras[i])
        return self._final_norm(x)

    def _wrapped_block(self, x, leaves, layer_rng, train, idx, policy,
                       extra=None):
        """One layer: on the tokens ``idx`` only (random-LTD) when given,
        under ``policy``'s checkpoint when given; its leaves opened
        (gathered, under ZeRO stage 3) inside the checkpointed function."""
        recomputed = policy is not None and policy.recompute

        def run(h):
            with open_leaves(leaves, recomputed) as lv:
                if idx is None:
                    return self._block(h, lv, rng=layer_rng, train=train,
                                       extra=extra)
                out = self._block(token_gather(h, idx), lv, rng=layer_rng,
                                  train=train, extra=extra)
            return token_scatter(h, out, idx)

        if policy is None:
            return run(x)
        return checkpointing.run(policy, run, x)

    def logits(self, input_ids):
        """``[B, T, padded_vocab]`` logits in the compute dtype (inference:
        ``train=False``, as the JAX inference engine calls its model)."""
        x = self.hidden_states(input_ids, train=False)
        return self._head_logits(x)

    forward = logits

    # ------------------------------------------------------------ training
    has_position_table = True

    def _head_bias(self, dtype):
        """``[V]`` LM-head bias or None (GPT-2 has none)."""
        return None

    def apply(self, batch, rng=None, train=True, pld_theta=None,
              ltd_keep=None, act_bits=None):
        """Next-token LM loss (float32 scalar), as the JAX ``apply``.
        ``batch``: ``{"input_ids": [B, T]}`` (+ optional ``"labels"``
        ``[B, T]``, -100 = ignore) or the ids tensor itself.

        ``rng``, ``train``, ``pld_theta``, ``ltd_keep``: see
        :meth:`hidden_states`.

        This overrides ``nn.Module.apply(fn)``: on a model of this port,
        ``apply`` is the loss, as in the JAX package's model protocol."""
        input_ids = batch["input_ids"] if isinstance(batch, dict) else batch
        x = self.hidden_states(input_ids, rng=rng, train=train,
                               pld_theta=pld_theta, ltd_keep=ltd_keep,
                               act_bits=act_bits)
        return self._head_loss_from_hidden(
            x, self._unembed_weight(x.dtype), batch,
            head_b=self._head_bias(x.dtype))

    def loss_count(self, batch):
        """The valid next-token targets of ``batch`` (``apply``'s
        divisor)."""
        return self._shifted_labels(batch, self.config.vocab_size)[1].sum()

    @staticmethod
    def _shifted_labels(batch, vocab_size):
        """Next-token labels ``[B, T-1]``, clamped to 0 where invalid, and
        the valid mask (``0 <= label < vocab_size``; -100 = ignore)."""
        input_ids = batch["input_ids"] if isinstance(batch, dict) else batch
        src = batch["labels"] if isinstance(batch, dict) and \
            "labels" in batch else input_ids
        labels = src[:, 1:]
        valid = (labels >= 0) & (labels < vocab_size)
        return torch.where(valid, labels, 0).long(), valid

    def _lm_loss(self, logits, batch):
        """Shifted next-token NLL over dense logits, divided by the valid
        count."""
        labels, valid = self._shifted_labels(batch, self.config.vocab_size)
        total = me.dense_xent_sum(logits[:, :-1], labels, valid)
        return total / torch.clamp_min(valid.sum(), 1)

    @staticmethod
    def _loss_chunk(v: int, target: int = 8192) -> int:
        """Vocab-chunk width of the online-softmax loss: the largest
        divisor of v that is <= target, UNLESS that divisor is tiny (prime
        or near-prime vocabs would degrade to thousands of near-empty
        matmuls); then plain ``target`` with a ragged tail."""
        for c in range(min(target, v), 0, -1):
            if v % c == 0:
                if c >= min(target, v) // 8:
                    return c
                break  # largest divisor is tiny: use a ragged tail instead
        return min(target, v)

    def _chunked_lm_loss(self, h, wte, batch, head_b=None, chunk=None):
        """Shifted next-token NLL without ``[B, T, V]`` logits: an online
        logsumexp over vocab chunks (:class:`_ChunkedNLL`; ``chunk`` rows
        of ``wte`` at a time, by default ``_loss_chunk``'s), divided by the
        valid count. At tp > 1 ``wte`` is the rank's vocab block and the
        statistics are combined over the ranks."""
        labels, valid = self._shifted_labels(batch, self.config.vocab_size)
        h = h[:, :-1]
        n = h.shape[0] * h.shape[1]
        if chunk is None:
            chunk = self._loss_chunk(wte.shape[0],
                                     self.config.loss_chunk_target)
        total = _ChunkedNLL.apply(h.reshape(n, h.shape[-1]), wte, head_b,
                                  labels.reshape(n), valid.reshape(n), chunk,
                                  self.tp)
        return total / torch.clamp_min(valid.sum(), 1)

    # dense-logits path above this many logit elements would cost multiple
    # GB of f32 activations: switch to the chunked loss there
    _DENSE_LOSS_MAX_ELEMS = 600_000_000

    def _head_loss_from_hidden(self, x, wte, batch, head_b=None):
        """Dense-vs-chunked loss dispatch, as in the JAX package."""
        cfg = self.config
        n_logits = x.shape[0] * max(1, x.shape[1] - 1) * wte.shape[0] * \
            self.tp.size
        use_chunked = (cfg.loss_chunking == "always" or
                       (cfg.loss_chunking == "auto" and
                        n_logits > self._DENSE_LOSS_MAX_ELEMS))
        if self.tp.active:
            # vocab-parallel: the dense loss is one chunk of the rank's
            # block, its slice of a head bias added to each chunk's
            # logits; no rank builds the whole logits
            return self._chunked_lm_loss(
                tpl.copy_to_tp(x, self.tp), wte, batch, head_b=head_b,
                chunk=None if use_chunked else wte.shape[0])
        if use_chunked:
            return self._chunked_lm_loss(x, wte, batch, head_b=head_b)
        logits = x @ wte.T
        if head_b is not None:
            logits = logits + head_b
        return self._lm_loss(logits, batch)

    def flops_per_token(self, seq_len: Optional[int] = None):
        """Training FLOPs/token: 6N + attention term (12·L·D·T)."""
        cfg = self.config
        d, l = cfg.n_embd, cfg.n_layer
        block_params = (4 + 2 * cfg.mlp_ratio) * l * d * d
        n_params = block_params + cfg.padded_vocab * d
        if self.has_position_table:
            n_params += (cfg.n_positions + cfg.pos_offset) * d
        flops = 6 * n_params
        if seq_len:
            flops += 12 * l * d * seq_len  # attention matmuls (fwd+bwd)
        return flops

    # ------------------------------------------------------- decode protocol
    @property
    def kv_heads(self) -> int:
        """The kv heads of this rank's cache."""
        return self.config.n_head // self.tp.size

    @property
    def _kv_total(self) -> int:
        """The kv heads of the whole model."""
        return self.config.n_head

    def kv_split(self, shape):
        """The ``TPSplit`` of a cache tensor of ``shape`` (``[L, S,
        kv heads, T, hd]``, the rank's heads or the whole) over its kv
        heads: the rank's block, or its one head when ranks share them."""
        whole = list(shape)
        whole[2] = self._kv_total
        n = self.tp.size
        return tpl.TPSplit(whole, 2, self.tp.rank, n,
                           parts=[min(n, self._kv_total)])

    def init_kv_cache(self, batch_size: int, max_len: int,
                      dtype=torch.bfloat16, device=None):
        cfg = self.config
        device = self.wte.device if device is None else device
        shape = (cfg.n_layer, batch_size, self.kv_heads, max_len, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def _decode_attn_mask(self, q_pos, k_pos):
        """Boolean keep-mask over the KV cache for query positions ``q_pos``
        and cache columns ``k_pos`` (broadcast against each other).
        Sliding-window families tighten it."""
        return k_pos <= q_pos

    def _cache_masks(self, q_pos, k_pos, expand, pad_valid=None):
        """``[(mask, extra)]`` a layer: the keep-mask over the cache
        (``_decode_attn_mask_ex`` of query positions ``q_pos`` and cache
        columns ``k_pos``, shaped by ``expand``, and-ed with the left-pad
        mask ``pad_valid``) and the layer's extra. Computed once when the
        family has no per-layer constants, as in the JAX package."""
        extras = self._layer_extras()

        def mask(extra):
            m = expand(self._decode_attn_mask_ex(q_pos, k_pos, extra))
            return m if pad_valid is None else m & pad_valid
        if extras is None:
            return [(mask(None), None)] * len(self.blocks)
        return [(mask(e), e) for e in extras]

    @staticmethod
    def _cache_attn(q, k, v, k_cache, v_cache, start_pos, mask, bias=None):
        """Write this call's K/V into cache columns ``[start_pos,
        start_pos + T)`` (in place: the cache is the engine's buffer) and
        attend over the whole cache under ``mask`` and ``bias``."""
        t = k.shape[-2]
        k_cache[:, :, start_pos:start_pos + t] = k.to(k_cache.dtype)
        v_cache[:, :, start_pos:start_pos + t] = v.to(v_cache.dtype)
        return GPT2Model._attend_cache(q, k_cache, v_cache, mask, bias)

    @staticmethod
    def _slot_cache_attn(q, k, v, k_cache, v_cache, write, mask, bias=None):
        """Slot write: ``write = (rows, offsets, columns)`` sends row
        ``rows[i]``'s K/V of block offset ``offsets[i]`` to cache column
        ``columns[i]`` (in place; the JAX package's one-hot select over the
        lane writes the same values), then attention over the whole cache
        under ``mask`` and ``bias``."""
        rows, offs, cols = write
        k_cache[rows, :, cols] = k[rows, :, offs].to(k_cache.dtype)
        v_cache[rows, :, cols] = v[rows, :, offs].to(v_cache.dtype)
        return GPT2Model._attend_cache(q, k_cache, v_cache, mask, bias)

    @staticmethod
    def _attend_cache(q, k_cache, v_cache, mask, bias=None):
        """The plain attention over a whole cache under ``mask`` (and the
        family's additive ``bias``). Grouped-query attention: each cached
        kv head serves ``H / kv_heads`` consecutive query heads
        (``jnp.repeat`` order 0,0,1,1, not ``Tensor.repeat``'s 0,1,0,1)."""
        kq, vq = k_cache.to(q.dtype), v_cache.to(q.dtype)
        if q.shape[1] != kq.shape[1]:
            rep = q.shape[1] // kq.shape[1]
            kq = torch.repeat_interleave(kq, rep, dim=1)
            vq = torch.repeat_interleave(vq, rep, dim=1)
        return reference_attention(q, kq, vq, causal=False, mask=mask,
                                   bias=bias)

    def apply_with_cache(self, input_ids, cache, start_pos: int,
                         pad_counts=None):
        """Forward with a KV cache. ``input_ids`` [B, T] (the prompt for
        prefill, [B, 1] for decode) fill cache columns ``[start_pos,
        start_pos + T)``. ``pad_counts`` [B]: LEFT-padding tokens per row;
        cache columns below it are never keys and logical positions shift
        down by it. Updates ``cache`` in place and returns
        ``(logits [B, T, V], cache)``."""
        b, t = input_ids.shape
        max_len = cache["k"].shape[-2]
        if start_pos < 0 or start_pos + t > max_len:
            raise ValueError(f"cache columns [{start_pos}, {start_pos + t}) "
                             f"exceed the cache length {max_len}")
        dev = input_ids.device
        steps = start_pos + torch.arange(t, device=dev)
        positions = None
        if pad_counts is not None:
            positions = torch.clamp_min(steps[None, :] - pad_counts[:, None], 0)
        x = self._embed(input_ids, start_pos=start_pos, positions=positions)

        k_pos = torch.arange(max_len, device=dev)[None, :]
        pad_valid = None
        if pad_counts is not None:     # left-pad columns are never keys
            pad_valid = (k_pos >= pad_counts[:, None])[:, None, None, :]
        masks = self._cache_masks(steps[:, None], k_pos,
                                  lambda m: m[None, None], pad_valid)
        bias = self._decode_attn_bias(steps[:, None], k_pos)
        written = (slice(None), slice(None), slice(start_pos, start_pos + t))
        for layer, (p, (mask, extra)) in enumerate(zip(self.blocks, masks)):
            kc, vc = _layer_cache(cache, layer)
            attn_fn = functools.partial(
                self._cache_attn, k_cache=kc, v_cache=vc,
                start_pos=start_pos, mask=mask, bias=bias)
            x = self._block(x, p, attn_fn, start_pos, positions, extra=extra)
            _commit_cache(cache, layer, (kc, vc), written)
        x = self._final_norm(x)
        return self._head_logits(x), cache

    def chunk_prefill_with_cache(self, input_ids, cache, start_pos: int):
        """One chunk of a long prompt through the stack, its K/V written to
        cache columns ``[start_pos, start_pos + T)``, no logits: the
        intermediate chunks of a chunked admission sample no token, so the
        final norm and the LM head are left out (the JAX package's XLA
        drops them as dead code). Returns the cache."""
        b, t = input_ids.shape
        max_len = cache["k"].shape[-2]
        if start_pos < 0 or start_pos + t > max_len:
            raise ValueError(f"cache columns [{start_pos}, {start_pos + t}) "
                             f"exceed the cache length {max_len}")
        dev = input_ids.device
        steps = start_pos + torch.arange(t, device=dev)
        x = self._embed(input_ids, start_pos=start_pos)
        k_pos = torch.arange(max_len, device=dev)[None, :]
        masks = self._cache_masks(steps[:, None], k_pos,
                                  lambda m: m[None, None])
        bias = self._decode_attn_bias(steps[:, None], k_pos)
        written = (slice(None), slice(None), slice(start_pos, start_pos + t))
        for layer, (p, (mask, extra)) in enumerate(zip(self.blocks, masks)):
            kc, vc = _layer_cache(cache, layer)
            attn_fn = functools.partial(
                self._cache_attn, k_cache=kc, v_cache=vc,
                start_pos=start_pos, mask=mask, bias=bias)
            x = self._block(x, p, attn_fn, start_pos, extra=extra)
            _commit_cache(cache, layer, (kc, vc), written)
        return cache

    def decode_with_slots(self, input_ids, cache, positions):
        """One decode token per row at per-row cache positions: the
        continuous-batching step. Each row of ``cache`` is a decode slot at
        its own length: row ``s`` writes its token's K/V at cache column
        ``positions[s]`` (in place) and attends columns ``<= positions[s]``
        (under the family's ``_decode_attn_mask``). ``input_ids [S, 1]``,
        ``positions [S]``. Returns ``(logits [S, 1, V], cache)``."""
        b, t = input_ids.shape
        if t != 1:
            raise ValueError(f"decode_with_slots is single-token: got T={t}")
        max_len = cache["k"].shape[-2]
        positions = torch.as_tensor(positions).to(torch.int64)
        # checked where the positions are (on the host, for the serving
        # path: no device wait); the JAX package drops such a row's write
        if bool(((positions < 0) | (positions >= max_len)).any()):
            raise ValueError(f"decode positions {positions.tolist()} lie "
                             f"outside the cache length {max_len}")
        return self.verify_with_slots(input_ids, cache, positions)

    def verify_with_slots(self, input_ids, cache, positions):
        """A block of T tokens per row at per-row cache positions: the
        speculative verify step (T = 1 is ``decode_with_slots``). Row
        ``s`` feeds ``input_ids[s]``; token ``j`` writes its K/V at cache
        column ``positions[s] + j`` (in place) and attends columns
        ``<= positions[s] + j`` under the family's ``_decode_attn_mask``.
        Writes at or past the cache length are dropped, as the JAX
        package's one-hot select drops them; their logits are never read.
        ``positions [S]`` are read on the host (where the serving path
        keeps them), so the step waits on no device.
        Returns ``(logits [S, T, V], cache)``."""
        b, t = input_ids.shape
        max_len = cache["k"].shape[-2]
        dev = input_ids.device
        cols = torch.as_tensor(positions).to("cpu", torch.int64)[:, None] + \
            torch.arange(t)[None, :]                          # [S, T]
        rows, offs = torch.nonzero(cols < max_len, as_tuple=True)
        write = torch.stack([rows, offs, cols[rows, offs]]).to(dev)
        pos2d = cols.to(dev)
        x = self._embed(input_ids, positions=pos2d)
        k_pos = torch.arange(max_len, device=dev)[None, None, :]
        masks = self._cache_masks(pos2d[:, :, None], k_pos,
                                  lambda m: m[:, None])
        bias = self._decode_attn_bias(pos2d[:, :, None], k_pos)
        written = (write[0], slice(None), write[2])
        for layer, (p, (mask, extra)) in enumerate(zip(self.blocks, masks)):
            kc, vc = _layer_cache(cache, layer)
            attn_fn = functools.partial(
                self._slot_cache_attn, k_cache=kc, v_cache=vc, write=write,
                mask=mask, bias=bias)
            x = self._block(x, p, attn_fn, 0, pos2d, extra=extra)
            _commit_cache(cache, layer, (kc, vc), written)
        x = self._final_norm(x)
        return self._head_logits(x), cache

def _layer_cache(cache, layer):
    """Layer ``layer``'s ``(k, v)`` cache tensors: views of a float pool,
    or an int8 pool's columns dequantized (``inference/kv_quant.py``)."""
    if isinstance(cache, dict):
        return cache["k"][layer], cache["v"][layer]
    return cache.layer_kv(layer)


def _commit_cache(cache, layer, kv, written):
    """An int8 pool takes the columns a layer wrote (``written``, an
    index into ``[rows, heads, columns]``), quantized; a float pool was
    written in place."""
    if not isinstance(cache, dict):
        cache.commit(layer, kv, written)


def _chunk_logits(hf, wte, head_b, lo, hi):
    """float32 logits of vocab rows ``[lo, hi)``, computed in hf's dtype
    and then widened, as the JAX scan body does."""
    logits = hf @ wte[lo:hi].T
    if head_b is not None:
        logits = logits + head_b[lo:hi]
    return logits.to(torch.float32)


class _ChunkedNLL(torch.autograd.Function):
    """Sum over valid rows of ``lse - target_logit`` with the vocab taken
    ``chunk`` rows of ``wte`` at a time: the JAX package's online-logsumexp
    scan (``models/gpt2.py`` ``_chunked_lm_loss``). The forward keeps only
    ``(m, s, tgt)`` per row; the backward recomputes each chunk's logits
    and turns ``softmax - onehot`` into the chunk's share of ``dh``,
    ``dwte`` and ``dhead_b``. ``dh`` accumulates in h's dtype across chunks,
    as the scan's cotangent of a loop constant does. The ragged last chunk
    is just narrower: the columns the JAX scan pads and masks to -inf add
    nothing to ``m``, ``s`` or the gradients, so they are not computed.

    Vocab-parallel (``tp`` active): ``wte`` is the rank's block of vocab
    rows, the labels are taken relative to its first row, and ``(m, s,
    tgt)`` are combined over the ranks (``vocab_parallel_lse``) before the
    NLL; the backward's ``dh`` is the rank's share, summed over the ranks
    by the ``copy_to_tp`` in front of ``hf``."""

    @staticmethod
    def forward(ctx, hf, wte, head_b, labels, valid, chunk, tp=None):
        n, v = hf.shape[0], wte.shape[0]
        if tp is not None and tp.active:
            labels = labels - tp.rank * v
        f32 = torch.float32
        m = torch.full((n,), -torch.inf, dtype=f32, device=hf.device)
        s = torch.zeros((n,), dtype=f32, device=hf.device)
        tgt = torch.zeros((n,), dtype=f32, device=hf.device)
        for lo in range(0, v, chunk):
            hi = min(lo + chunk, v)
            logits = _chunk_logits(hf, wte, head_b, lo, hi)
            nm = torch.maximum(m, logits.amax(1))
            s = s * torch.exp(m - nm) + torch.exp(logits - nm[:, None]).sum(1)
            inb = (labels >= lo) & (labels < hi)
            idx = torch.clamp(labels - lo, 0, hi - lo - 1)
            tl = torch.gather(logits, 1, idx[:, None])[:, 0]
            tgt = torch.where(inb, tl, tgt)
            m = nm
        if tp is not None:
            m, s, tgt = tpl.vocab_parallel_lse(m, s, tgt, tp)
        nll = torch.where(valid, (m + torch.log(s)) - tgt, 0.0)
        ctx.chunk = chunk
        ctx.has_bias = head_b is not None
        ctx.save_for_backward(hf, wte, head_b, labels, valid, m, s, tgt)
        return nll.sum()

    @staticmethod
    def backward(ctx, g):
        hf, wte, head_b, labels, valid, m, s, _ = ctx.saved_tensors
        chunk = ctx.chunk
        lse = m + torch.log(s)
        coef = torch.where(valid, g.to(torch.float32), 0.0)
        dh = torch.zeros_like(hf)
        dwte = torch.empty_like(wte)
        dhead_b = torch.empty_like(head_b) if ctx.has_bias else None
        for lo in range(0, wte.shape[0], chunk):
            hi = min(lo + chunk, wte.shape[0])
            dl = _chunk_logits(hf, wte, head_b, lo, hi)
            dl.sub_(lse[:, None]).exp_().mul_(coef[:, None])
            inb = (labels >= lo) & (labels < hi)
            idx = torch.clamp(labels - lo, 0, hi - lo - 1)
            dl.scatter_add_(1, idx[:, None],
                            torch.where(inb, -coef, 0.0)[:, None])
            dl = dl.to(hf.dtype)
            dh += dl @ wte[lo:hi]
            dwte[lo:hi] = dl.T @ hf
            if dhead_b is not None:
                dhead_b[lo:hi] = dl.sum(0)
        return dh, dwte, dhead_b, None, None, None, None
