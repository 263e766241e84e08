"""Injection policies: HF torch modules -> a port model and its weights.

The JAX package's ``module_inject/policy.py``: injection reads the
architecture and the weights out of an HF module once and emits

    (deepspeed_tpu_torch ModelSpec, JAX-layout parameter tree)

which the inference engine loads through the model's ``load_jax_params``
(``inference/engine.py``). The tree is the JAX policy's, leaf for leaf,
as float32 numpy arrays, so either package can load it. Each policy
registers itself by HF class name (``register_policy``), ``policy_for``
walks the module's MRO, and each raises the JAX policy's errors on the
same inputs. The model is built on ``device`` (the engine's); the HF
module stays where it is. CLIP, the UNet and the VAE are registered and
refuse, naming ROADMAP.md row A10, until their models are ported.
"""

import functools
import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..utils.logging import logger

_POLICIES: Dict[str, Callable] = {}


def register_policy(*hf_class_names):
    def deco(fn):
        for name in hf_class_names:
            _POLICIES[name] = fn
        return fn
    return deco


def policy_for(model) -> Callable:
    for klass in type(model).__mro__:
        if klass.__name__ in _POLICIES:
            return _POLICIES[klass.__name__]
    raise ValueError(
        f"no injection policy for {type(model).__name__}; known: "
        f"{sorted(_POLICIES)} (reference replace_policy.py registry)")


def _np(t):
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def _lin_w(lin):
    """HF nn.Linear stores [out, in]; transpose into our x @ w convention."""
    return _np(lin.weight).T


def _stack(layers, field):
    return np.stack([field(h) for h in layers])


def _build(cls, cfg, device):
    """The port's ``cls(cfg)`` on ``device`` (default: the CPU), its
    initial weights drawn there; the engine loads the injected tree over
    them."""
    gen = torch.Generator(device=device or "cpu").manual_seed(0)
    return cls(cfg, generator=gen, device=device)


def deinterleave_qkv_rows(w, n_head, head_dim):
    """[3D, D] fused qkv whose rows are per-head [q|k|v] blocks (BLOOM,
    GPT-NeoX, Megatron-LM layout) → [D, 3D] head-major q|k|v (this repo's
    convention)."""
    d = w.shape[1]
    w = w.reshape(n_head, 3, head_dim, d)
    return np.concatenate([w[:, i].reshape(n_head * head_dim, d)
                           for i in range(3)], axis=0).T


def deinterleave_qkv_bias(b, n_head, head_dim):
    b = b.reshape(n_head, 3, head_dim)
    return np.concatenate([b[:, i].reshape(n_head * head_dim)
                           for i in range(3)])


def _rope_scaling_check(hf_cfg):
    scaling = getattr(hf_cfg, "rope_scaling", None)
    if scaling and scaling.get("rope_type",
                               scaling.get("type", "default")) != "default":
        raise ValueError(
            f"rope_scaling={scaling!r} is not supported (plain rotary only); "
            f"logits would silently diverge from HF")


@register_policy("GPT2LMHeadModel", "GPT2Model")
def gpt2_policy(model, device=None) -> Tuple[Any, Any]:
    """HF GPT-2 → GPT2Model. HF Conv1D stores weights [in, out]: our
    convention (x @ w) directly, no transpose."""
    from ..models.gpt2 import GPT2Config, GPT2Model

    hf = model.transformer if hasattr(model, "transformer") else model
    hf_cfg = model.config
    cfg = GPT2Config(
        vocab_size=hf_cfg.vocab_size,
        n_positions=hf_cfg.n_positions,
        n_embd=hf_cfg.n_embd,
        n_layer=hf_cfg.n_layer,
        n_head=hf_cfg.n_head,
        layer_norm_epsilon=hf_cfg.layer_norm_epsilon,
        pad_vocab_to_multiple=1,
    )
    stack = functools.partial(_stack, hf.h)
    blocks = {
        "ln1_scale": stack(lambda h: _np(h.ln_1.weight)),
        "ln1_bias": stack(lambda h: _np(h.ln_1.bias)),
        "qkv_w": stack(lambda h: _np(h.attn.c_attn.weight)),
        "qkv_b": stack(lambda h: _np(h.attn.c_attn.bias)),
        "attn_proj_w": stack(lambda h: _np(h.attn.c_proj.weight)),
        "attn_proj_b": stack(lambda h: _np(h.attn.c_proj.bias)),
        "ln2_scale": stack(lambda h: _np(h.ln_2.weight)),
        "ln2_bias": stack(lambda h: _np(h.ln_2.bias)),
        "mlp_fc_w": stack(lambda h: _np(h.mlp.c_fc.weight)),
        "mlp_fc_b": stack(lambda h: _np(h.mlp.c_fc.bias)),
        "mlp_proj_w": stack(lambda h: _np(h.mlp.c_proj.weight)),
        "mlp_proj_b": stack(lambda h: _np(h.mlp.c_proj.bias)),
    }
    params = {
        "wte": _np(hf.wte.weight),
        "wpe": _np(hf.wpe.weight),
        "blocks": blocks,
        "ln_f_scale": _np(hf.ln_f.weight),
        "ln_f_bias": _np(hf.ln_f.bias),
    }
    return _build(GPT2Model, cfg, device), params


@register_policy("OPTForCausalLM", "OPTModel")
def opt_policy(model, device=None) -> Tuple[Any, Any]:
    """HF OPT → OPTModel. HF Linear stores [out, in] (transposed into
    x @ w); separate q/k/v projections concat into the fused qkv. OPT-350M
    (post-LN, word_embed_proj_dim != hidden) is rejected."""
    from ..models.opt import OPTConfig, OPTModel

    hf_cfg = model.config
    if not getattr(hf_cfg, "do_layer_norm_before", True):
        raise ValueError("post-LN OPT variants (350M) are not supported")
    if getattr(hf_cfg, "word_embed_proj_dim",
               hf_cfg.hidden_size) != hf_cfg.hidden_size:
        raise ValueError("OPT word_embed_proj_dim != hidden_size "
                         "is not supported")
    act = getattr(hf_cfg, "activation_function", "relu")
    if act not in ("relu", "gelu", "gelu_new"):
        raise ValueError(f"unsupported OPT activation {act!r}")
    if hf_cfg.ffn_dim % hf_cfg.hidden_size != 0:
        raise ValueError(
            f"ffn_dim {hf_cfg.ffn_dim} not a multiple of hidden_size "
            f"{hf_cfg.hidden_size} — cfg.mlp_ratio would silently disagree "
            f"with the loaded weights")
    dec = model.model.decoder if hasattr(model, "model") else model.decoder
    cfg = OPTConfig(
        vocab_size=hf_cfg.vocab_size,
        n_positions=hf_cfg.max_position_embeddings,
        n_embd=hf_cfg.hidden_size,
        n_layer=hf_cfg.num_hidden_layers,
        n_head=hf_cfg.num_attention_heads,
        mlp_ratio=hf_cfg.ffn_dim // hf_cfg.hidden_size,
        activation="relu" if act == "relu" else "gelu",  # Galactica = gelu
        pad_vocab_to_multiple=1,
    )
    stack = functools.partial(_stack, dec.layers)

    def qkv_w(h):
        a = h.self_attn
        return np.concatenate([_lin_w(a.q_proj), _lin_w(a.k_proj),
                               _lin_w(a.v_proj)], axis=1)

    def qkv_b(h):
        a = h.self_attn
        return np.concatenate([_np(a.q_proj.bias), _np(a.k_proj.bias),
                               _np(a.v_proj.bias)])

    blocks = {
        "ln1_scale": stack(lambda h: _np(h.self_attn_layer_norm.weight)),
        "ln1_bias": stack(lambda h: _np(h.self_attn_layer_norm.bias)),
        "qkv_w": stack(qkv_w),
        "qkv_b": stack(qkv_b),
        "attn_proj_w": stack(lambda h: _lin_w(h.self_attn.out_proj)),
        "attn_proj_b": stack(lambda h: _np(h.self_attn.out_proj.bias)),
        "ln2_scale": stack(lambda h: _np(h.final_layer_norm.weight)),
        "ln2_bias": stack(lambda h: _np(h.final_layer_norm.bias)),
        "mlp_fc_w": stack(lambda h: _lin_w(h.fc1)),
        "mlp_fc_b": stack(lambda h: _np(h.fc1.bias)),
        "mlp_proj_w": stack(lambda h: _lin_w(h.fc2)),
        "mlp_proj_b": stack(lambda h: _np(h.fc2.bias)),
    }
    params = {
        "wte": _np(dec.embed_tokens.weight),
        # HF embed_positions already carries the +2 offset rows
        "wpe": _np(dec.embed_positions.weight),
        "blocks": blocks,
        "ln_f_scale": _np(dec.final_layer_norm.weight),
        "ln_f_bias": _np(dec.final_layer_norm.bias),
    }
    return _build(OPTModel, cfg, device), params


@register_policy("LlamaForCausalLM", "MistralForCausalLM")
def llama_policy(model, device=None) -> Tuple[Any, Any]:
    """HF LLaMA/Mistral → LlamaModel. HF Linear stores [out, in]
    (transposed into x @ w); q/k/v concat into the fused qkv; rotary needs
    no weight permutation (both sides use the rotate_half convention)."""
    from ..models.llama import LlamaConfig, LlamaModel

    hf_cfg = model.config
    act = getattr(hf_cfg, "hidden_act", "silu")
    if act not in ("silu", "swish"):
        raise ValueError(f"unsupported LLaMA activation {act!r}")
    _rope_scaling_check(hf_cfg)
    if getattr(hf_cfg, "attention_bias", False):
        raise ValueError("attention_bias=True LLaMA variants not supported")
    explicit_hd = getattr(hf_cfg, "head_dim", None)
    if explicit_hd is not None and \
            explicit_hd != hf_cfg.hidden_size // hf_cfg.num_attention_heads:
        raise ValueError(
            f"head_dim={explicit_hd} != hidden_size/num_heads "
            f"({hf_cfg.hidden_size}/{hf_cfg.num_attention_heads}) "
            f"is not supported")
    dec = model.model if hasattr(model, "model") else model
    window = getattr(hf_cfg, "sliding_window", None)
    cfg = LlamaConfig(
        vocab_size=hf_cfg.vocab_size,
        n_positions=hf_cfg.max_position_embeddings,
        n_embd=hf_cfg.hidden_size,
        n_layer=hf_cfg.num_hidden_layers,
        n_head=hf_cfg.num_attention_heads,
        n_kv_head=getattr(hf_cfg, "num_key_value_heads",
                          hf_cfg.num_attention_heads),
        mlp_hidden=hf_cfg.intermediate_size,
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
        # a window >= context can never mask anything: None keeps
        # full-context attention
        sliding_window=window if window is not None and
        window < hf_cfg.max_position_embeddings else None,
        layer_norm_epsilon=hf_cfg.rms_norm_eps,
        tie_word_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
        pad_vocab_to_multiple=1,
    )
    stack = functools.partial(_stack, dec.layers)

    def qkv_w(h):
        a = h.self_attn
        return np.concatenate([_lin_w(a.q_proj), _lin_w(a.k_proj),
                               _lin_w(a.v_proj)], axis=1)

    blocks = {
        "ln1_scale": stack(lambda h: _np(h.input_layernorm.weight)),
        "qkv_w": stack(qkv_w),
        "attn_proj_w": stack(lambda h: _lin_w(h.self_attn.o_proj)),
        "ln2_scale": stack(lambda h: _np(h.post_attention_layernorm.weight)),
        "gate_w": stack(lambda h: _lin_w(h.mlp.gate_proj)),
        "up_w": stack(lambda h: _lin_w(h.mlp.up_proj)),
        "down_w": stack(lambda h: _lin_w(h.mlp.down_proj)),
    }
    params = {
        "wte": _np(dec.embed_tokens.weight),
        "blocks": blocks,
        "ln_f_scale": _np(dec.norm.weight),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _np(model.lm_head.weight)
    return _build(LlamaModel, cfg, device), params


def _interleaved_blocks(layers, attn, proj, fc, fc_out):
    """The block leaves of HF layers with a head-interleaved fused
    ``query_key_value`` (BLOOM, GPT-NeoX), de-interleaved into head-major
    q|k|v; ``attn(b)`` is the module holding it, ``proj(b)``, ``fc(b)``,
    ``fc_out(b)`` the output and MLP Linears."""
    stack = functools.partial(_stack, layers)
    return stack, {
        "ln1_scale": stack(lambda b: _np(b.input_layernorm.weight)),
        "ln1_bias": stack(lambda b: _np(b.input_layernorm.bias)),
        "attn_proj_w": stack(lambda b: _lin_w(proj(b))),
        "attn_proj_b": stack(lambda b: _np(proj(b).bias)),
        "ln2_scale": stack(lambda b: _np(b.post_attention_layernorm.weight)),
        "ln2_bias": stack(lambda b: _np(b.post_attention_layernorm.bias)),
        "mlp_fc_w": stack(lambda b: _lin_w(fc(b))),
        "mlp_fc_b": stack(lambda b: _np(fc(b).bias)),
        "mlp_proj_w": stack(lambda b: _lin_w(fc_out(b))),
        "mlp_proj_b": stack(lambda b: _np(fc_out(b).bias)),
    }


def _qkv_leaves(stack, attn, h, hd):
    return {"qkv_w": stack(lambda b: deinterleave_qkv_rows(
                _np(attn(b).query_key_value.weight), h, hd)),
            "qkv_b": stack(lambda b: deinterleave_qkv_bias(
                _np(attn(b).query_key_value.bias), h, hd))}


@register_policy("BloomForCausalLM", "BloomModel")
def bloom_policy(model, device=None) -> Tuple[Any, Any]:
    """HF BLOOM → BloomModel. The HF fused query_key_value weight is
    head-interleaved ([H, 3, hd, D] rows): de-interleaved into our
    head-major q|k|v concat convention."""
    from ..models.bloom import BloomConfig, BloomModel

    hf_cfg = model.config
    if getattr(hf_cfg, "apply_residual_connection_post_layernorm", False):
        raise ValueError(
            "apply_residual_connection_post_layernorm BLOOM variants are "
            "not supported; residuals would silently diverge from HF")
    h = hf_cfg.n_head
    d = hf_cfg.hidden_size
    hd = d // h
    cfg = BloomConfig(
        vocab_size=hf_cfg.vocab_size,
        n_positions=getattr(hf_cfg, "seq_length", 2048),
        n_embd=d,
        n_layer=hf_cfg.n_layer,
        n_head=h,
        layer_norm_epsilon=hf_cfg.layer_norm_epsilon,
        pad_vocab_to_multiple=1,
    )
    tr = model.transformer if hasattr(model, "transformer") else model
    attn = lambda b: b.self_attention  # noqa: E731
    stack, blocks = _interleaved_blocks(
        tr.h, attn, lambda b: b.self_attention.dense,
        lambda b: b.mlp.dense_h_to_4h, lambda b: b.mlp.dense_4h_to_h)
    blocks.update(_qkv_leaves(stack, attn, h, hd))
    params = {
        "wte": _np(tr.word_embeddings.weight),
        "emb_ln_scale": _np(tr.word_embeddings_layernorm.weight),
        "emb_ln_bias": _np(tr.word_embeddings_layernorm.bias),
        "blocks": blocks,
        "ln_f_scale": _np(tr.ln_f.weight),
        "ln_f_bias": _np(tr.ln_f.bias),
    }
    return _build(BloomModel, cfg, device), params


@register_policy("GPTNeoXForCausalLM")
def gpt_neox_policy(model, device=None) -> Tuple[Any, Any]:
    """HF GPT-NeoX/Pythia → GPTNeoXModel. The fused query_key_value is
    head-interleaved like BLOOM's: de-interleaved into head-major
    q|k|v."""
    from ..models.gpt_neox import GPTNeoXConfig, GPTNeoXModel

    hf_cfg = model.config
    act = getattr(hf_cfg, "hidden_act", "gelu")
    if act not in ("gelu", "gelu_new", "gelu_fast", "gelu_pytorch_tanh"):
        raise ValueError(f"unsupported NeoX activation {act!r}")
    _rope_scaling_check(hf_cfg)
    if hf_cfg.intermediate_size % hf_cfg.hidden_size != 0:
        raise ValueError("intermediate_size must be a multiple of "
                         "hidden_size")
    h = hf_cfg.num_attention_heads
    d = hf_cfg.hidden_size
    hd = d // h
    cfg = GPTNeoXConfig(
        vocab_size=hf_cfg.vocab_size,
        n_positions=hf_cfg.max_position_embeddings,
        n_embd=d,
        n_layer=hf_cfg.num_hidden_layers,
        n_head=h,
        mlp_ratio=hf_cfg.intermediate_size // d,
        rotary_pct=hf_cfg.rotary_pct,
        rope_theta=getattr(hf_cfg, "rotary_emb_base", 10000.0),
        use_parallel_residual=getattr(hf_cfg, "use_parallel_residual", True),
        activation="gelu_exact" if act == "gelu" else "gelu",
        layer_norm_epsilon=hf_cfg.layer_norm_eps,
        pad_vocab_to_multiple=1,
    )
    nx = model.gpt_neox if hasattr(model, "gpt_neox") else model
    attn = lambda b: b.attention  # noqa: E731
    stack, blocks = _interleaved_blocks(
        nx.layers, attn, lambda b: b.attention.dense,
        lambda b: b.mlp.dense_h_to_4h, lambda b: b.mlp.dense_4h_to_h)
    blocks.update(_qkv_leaves(stack, attn, h, hd))
    params = {
        "wte": _np(nx.embed_in.weight),
        "blocks": blocks,
        "ln_f_scale": _np(nx.final_layer_norm.weight),
        "ln_f_bias": _np(nx.final_layer_norm.bias),
        "lm_head": _np(model.embed_out.weight),
    }
    return _build(GPTNeoXModel, cfg, device), params


@register_policy("GPTNeoForCausalLM", "GPTNeoModel")
def gpt_neo_policy(model, device=None) -> Tuple[Any, Any]:
    """HF GPT-Neo → GPTNeoModel: separate q/k/v Linears WITHOUT bias
    (out_proj keeps one), alternating global/local attention from
    config.attention_layers, and Neo's UNSCALED q·k, folded into the q
    weight as q *= sqrt(head_dim) so the scaled attention reproduces
    it."""
    from ..models.gpt_neo import GPTNeoConfig, GPTNeoModel

    hf = model.transformer if hasattr(model, "transformer") else model
    hf_cfg = model.config
    cfg = GPTNeoConfig(
        vocab_size=hf_cfg.vocab_size,
        n_positions=hf_cfg.max_position_embeddings,
        n_embd=hf_cfg.hidden_size,
        n_layer=hf_cfg.num_layers,
        n_head=hf_cfg.num_heads,
        layer_norm_epsilon=hf_cfg.layer_norm_epsilon,
        activation="gelu",  # gelu_new == tanh-approx gelu (our default)
        local_window=getattr(hf_cfg, "window_size", 256),
        attention_layers=tuple(hf_cfg.attention_layers),
        pad_vocab_to_multiple=1,
    )
    d = cfg.n_embd
    qscale = math.sqrt(cfg.head_dim)

    def qkv_w(h):
        a = h.attn.attention
        return np.concatenate([_lin_w(a.q_proj) * qscale, _lin_w(a.k_proj),
                               _lin_w(a.v_proj)], axis=-1)

    stack = functools.partial(_stack, hf.h)
    blocks = {
        "ln1_scale": stack(lambda h: _np(h.ln_1.weight)),
        "ln1_bias": stack(lambda h: _np(h.ln_1.bias)),
        "qkv_w": stack(qkv_w),
        "qkv_b": np.zeros((cfg.n_layer, 3 * d), np.float32),  # Neo: no bias
        "attn_proj_w": stack(lambda h: _lin_w(h.attn.attention.out_proj)),
        "attn_proj_b": stack(lambda h: _np(h.attn.attention.out_proj.bias)),
        "ln2_scale": stack(lambda h: _np(h.ln_2.weight)),
        "ln2_bias": stack(lambda h: _np(h.ln_2.bias)),
        "mlp_fc_w": stack(lambda h: _lin_w(h.mlp.c_fc)),
        "mlp_fc_b": stack(lambda h: _np(h.mlp.c_fc.bias)),
        "mlp_proj_w": stack(lambda h: _lin_w(h.mlp.c_proj)),
        "mlp_proj_b": stack(lambda h: _np(h.mlp.c_proj.bias)),
    }
    params = {
        "wte": _np(hf.wte.weight),
        "wpe": _np(hf.wpe.weight),
        "blocks": blocks,
        "ln_f_scale": _np(hf.ln_f.weight),
        "ln_f_bias": _np(hf.ln_f.bias),
    }
    return _build(GPTNeoModel, cfg, device), params


@register_policy("GPTJForCausalLM")
def gptj_policy(model, device=None) -> Tuple[Any, Any]:
    """HF GPT-J → GPTNeoXModel in its GPT-J flavor: shared block
    LayerNorm, interleaved partial rotary, no attention biases, LM head
    with bias."""
    from ..models.gpt_neox import GPTNeoXModel, gptj_config

    hf_cfg = model.config
    act = getattr(hf_cfg, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu", "gelu_pytorch_tanh"):
        raise ValueError(f"unsupported GPT-J activation {act!r}")
    d = hf_cfg.n_embd
    inner = getattr(hf_cfg, "n_inner", None) or 4 * d
    if inner % d != 0:
        raise ValueError("n_inner must be a multiple of n_embd")
    cfg = gptj_config(
        vocab_size=hf_cfg.vocab_size,
        n_positions=hf_cfg.n_positions,
        n_embd=d,
        n_layer=hf_cfg.n_layer,
        n_head=hf_cfg.n_head,
        mlp_ratio=inner // d,
        rotary_ndims=hf_cfg.rotary_dim,
        activation="gelu_exact" if act == "gelu" else "gelu",
        layer_norm_epsilon=hf_cfg.layer_norm_epsilon,
        pad_vocab_to_multiple=1,
    )
    tr = model.transformer if hasattr(model, "transformer") else model
    stack = functools.partial(_stack, tr.h)

    def qkv_w(blk):
        a = blk.attn
        return np.concatenate([_lin_w(a.q_proj), _lin_w(a.k_proj),
                               _lin_w(a.v_proj)], axis=1)

    blocks = {
        "ln1_scale": stack(lambda b: _np(b.ln_1.weight)),
        "ln1_bias": stack(lambda b: _np(b.ln_1.bias)),
        "qkv_w": stack(qkv_w),
        "attn_proj_w": stack(lambda b: _lin_w(b.attn.out_proj)),
        "mlp_fc_w": stack(lambda b: _lin_w(b.mlp.fc_in)),
        "mlp_fc_b": stack(lambda b: _np(b.mlp.fc_in.bias)),
        "mlp_proj_w": stack(lambda b: _lin_w(b.mlp.fc_out)),
        "mlp_proj_b": stack(lambda b: _np(b.mlp.fc_out.bias)),
    }
    params = {
        "wte": _np(tr.wte.weight),
        "blocks": blocks,
        "ln_f_scale": _np(tr.ln_f.weight),
        "ln_f_bias": _np(tr.ln_f.bias),
        "lm_head": _np(model.lm_head.weight),
        "lm_head_b": _np(model.lm_head.bias),
    }
    return _build(GPTNeoXModel, cfg, device), params


def _bert_blocks(layers, qkv, attn_out, attn_ln, inter, out, out_ln):
    """The BERT block leaves of HF encoder layers; ``qkv(b)`` gives the
    q, k and v Linears, the others their Linears and LayerNorms."""
    stack = functools.partial(_stack, layers)
    return {
        "qkv_w": stack(lambda b: np.concatenate(
            [_lin_w(m) for m in qkv(b)], axis=1)),
        "qkv_b": stack(lambda b: np.concatenate(
            [_np(m.bias) for m in qkv(b)])),
        "attn_out_w": stack(lambda b: _lin_w(attn_out(b))),
        "attn_out_b": stack(lambda b: _np(attn_out(b).bias)),
        "attn_ln_scale": stack(lambda b: _np(attn_ln(b).weight)),
        "attn_ln_bias": stack(lambda b: _np(attn_ln(b).bias)),
        "inter_w": stack(lambda b: _lin_w(inter(b))),
        "inter_b": stack(lambda b: _np(inter(b).bias)),
        "out_w": stack(lambda b: _lin_w(out(b))),
        "out_b": stack(lambda b: _np(out(b).bias)),
        "out_ln_scale": stack(lambda b: _np(out_ln(b).weight)),
        "out_ln_bias": stack(lambda b: _np(out_ln(b).bias)),
    }


@register_policy("BertForMaskedLM", "BertForPreTraining")
def bert_policy(model, device=None) -> Tuple[Any, Any]:
    """HF BERT → BertModel: post-LN encoder; separate q/k/v concat into
    the fused qkv; MLM transform + tied decoder + vocab bias."""
    from ..models.bert import BertConfig, BertModel

    hf_cfg = model.config
    act = getattr(hf_cfg, "hidden_act", "gelu")
    if act not in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(f"unsupported BERT activation {act!r}")
    if hf_cfg.intermediate_size % hf_cfg.hidden_size != 0:
        raise ValueError("intermediate_size must be a multiple of "
                         "hidden_size")
    cfg = BertConfig(
        vocab_size=hf_cfg.vocab_size,
        n_positions=hf_cfg.max_position_embeddings,
        type_vocab_size=hf_cfg.type_vocab_size,
        n_embd=hf_cfg.hidden_size,
        n_layer=hf_cfg.num_hidden_layers,
        n_head=hf_cfg.num_attention_heads,
        mlp_ratio=hf_cfg.intermediate_size // hf_cfg.hidden_size,
        activation="gelu_exact" if act == "gelu" else "gelu",
        layer_norm_epsilon=hf_cfg.layer_norm_eps,
        pad_vocab_to_multiple=1,
    )
    bert = model.bert if hasattr(model, "bert") else model
    emb = bert.embeddings
    blocks = _bert_blocks(
        bert.encoder.layer,
        lambda b: (b.attention.self.query, b.attention.self.key,
                   b.attention.self.value),
        lambda b: b.attention.output.dense,
        lambda b: b.attention.output.LayerNorm,
        lambda b: b.intermediate.dense, lambda b: b.output.dense,
        lambda b: b.output.LayerNorm)
    pred = model.cls.predictions
    params = {
        "wte": _np(emb.word_embeddings.weight),
        "wpe": _np(emb.position_embeddings.weight),
        "tte": _np(emb.token_type_embeddings.weight),
        "emb_ln_scale": _np(emb.LayerNorm.weight),
        "emb_ln_bias": _np(emb.LayerNorm.bias),
        "blocks": blocks,
        "mlm_dense_w": _lin_w(pred.transform.dense),
        "mlm_dense_b": _np(pred.transform.dense.bias),
        "mlm_ln_scale": _np(pred.transform.LayerNorm.weight),
        "mlm_ln_bias": _np(pred.transform.LayerNorm.bias),
        "mlm_bias": _np(pred.bias),
    }
    return _build(BertModel, cfg, device), params


@register_policy("DistilBertForMaskedLM")
def distil_bert_policy(model, device=None) -> Tuple[Any, Any]:
    """HF DistilBERT → BertModel: BERT without token-type embeddings (tte
    maps to a zero row) and with renamed submodules; the same post-LN
    encoder + MLM transform head."""
    from ..models.bert import BertConfig, BertModel

    hf_cfg = model.config
    act = getattr(hf_cfg, "activation", "gelu")
    if act not in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(f"unsupported DistilBERT activation {act!r}")
    if hf_cfg.hidden_dim % hf_cfg.dim != 0:
        raise ValueError("hidden_dim must be a multiple of dim")
    cfg = BertConfig(
        vocab_size=hf_cfg.vocab_size,
        n_positions=hf_cfg.max_position_embeddings,
        type_vocab_size=1,
        n_embd=hf_cfg.dim,
        n_layer=hf_cfg.n_layers,
        n_head=hf_cfg.n_heads,
        mlp_ratio=hf_cfg.hidden_dim // hf_cfg.dim,
        activation="gelu_exact" if act == "gelu" else "gelu",
        layer_norm_epsilon=1e-12,
        pad_vocab_to_multiple=1,
    )
    db = model.distilbert if hasattr(model, "distilbert") else model
    emb = db.embeddings
    blocks = _bert_blocks(
        db.transformer.layer,
        lambda b: (b.attention.q_lin, b.attention.k_lin, b.attention.v_lin),
        lambda b: b.attention.out_lin, lambda b: b.sa_layer_norm,
        lambda b: b.ffn.lin1, lambda b: b.ffn.lin2,
        lambda b: b.output_layer_norm)
    params = {
        "wte": _np(emb.word_embeddings.weight),
        "wpe": _np(emb.position_embeddings.weight),
        "tte": np.zeros((1, hf_cfg.dim), np.float32),
        "emb_ln_scale": _np(emb.LayerNorm.weight),
        "emb_ln_bias": _np(emb.LayerNorm.bias),
        "blocks": blocks,
        "mlm_dense_w": _lin_w(model.vocab_transform),
        "mlm_dense_b": _np(model.vocab_transform.bias),
        "mlm_ln_scale": _np(model.vocab_layer_norm.weight),
        "mlm_ln_bias": _np(model.vocab_layer_norm.bias),
        "mlm_bias": _np(model.vocab_projector.bias),
    }
    return _build(BertModel, cfg, device), params


@register_policy("CLIPModel", "UNet2DConditionModel", "AutoencoderKL")
def unported_policy(model, device=None):
    """CLIP, the diffusers UNet and the VAE: their models (``clip.py``,
    ``diffusion.py``) are not ported yet."""
    raise NotImplementedError(
        f"injecting a {type(model).__name__} is not ported yet: ROADMAP.md "
        f"row A10 (CLIP, UNet and VAE)")


def replace_transformer_layer(model, config=None, device=None
                              ) -> Tuple[Any, Any]:
    """Entry point (reference module_inject/replace_module.py:276):
    ``(port model on device, JAX-layout tree)`` by the module's policy;
    an architecture without one raises (no silent wrap)."""
    policy = policy_for(model)
    spec, params = policy(model, device=device)
    logger.info(f"injected {type(model).__name__} -> "
                f"{type(spec).__name__} ({policy.__name__})")
    return spec, params
