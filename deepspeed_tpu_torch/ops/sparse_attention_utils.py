"""Sparse-attention model surgery, as the JAX package's
``ops/sparse_attention_utils.py`` ``SparseAttentionUtils`` (reference
ops/sparse_attention/sparse_attention_utils.py:14).

The JAX package's models are functional specs whose weights are a separate
pytree, so its surgery takes and returns ``(model, params)``. The port's
models own their weights, so the pair maps onto the model alone:

- ``extend_position_embedding(model, max_position)`` replaces the model's
  ``wpe`` parameter with the tiled table and its config's ``n_positions``,
  in place, and returns the model (the JAX package rebuilds the model and
  returns ``(model, params)`` with the extended ``wpe``);
- ``replace_model_self_attention_with_sparse_self_attention(model,
  max_position, sparsity_config)`` installs the block-sparse attention on
  the model's ``attn_override`` hook and, when ``max_position`` exceeds the
  table, extends it first (the JAX package does that when ``params`` is
  passed); it returns the model.

Like the JAX package, surgery supports bidirectional encoders exposing the
``attn_override`` hook (the BERT family) and refuses decoders (GPT-2). On
a tensor-parallel model the installed attention takes the rank's rows of
the layout made for every head.
"""

import dataclasses

import torch
from torch import nn

from .sparse_attention_ops import FixedSparsityConfig, SparseSelfAttention
from ..utils.logging import log_dist


class SparseAttentionUtils:
    """Utility surface matching the reference class name & methods."""

    @staticmethod
    @torch.no_grad()
    def extend_position_embedding(model, max_position):
        """Tile the position table to a longer horizon (reference :14
        ``extend_position_embedding`` repeats the weight rows). Replaces
        ``model.wpe`` and ``model.config`` in place and returns the
        model."""
        wpe = model.wpe
        original = wpe.shape[0]
        if max_position <= original:
            raise ValueError(f"max_position={max_position} must exceed the "
                             f"current table ({original})")
        multiples = -(-max_position // original)
        model.wpe = nn.Parameter(
            wpe.detach().repeat(multiples, 1)[:max_position].clone(),
            requires_grad=wpe.requires_grad)
        model.config = dataclasses.replace(model.config,
                                           n_positions=max_position)
        log_dist(f"extended position embeddings {original} -> {max_position}",
                 ranks=[0])
        return model

    @staticmethod
    def update_tokenizer_model_max_length(tokenizer, max_position):
        """Reference :64 — works on any HF tokenizer."""
        tokenizer.model_max_length = max_position
        tokenizer.init_kwargs["model_max_length"] = max_position
        return tokenizer

    @staticmethod
    def replace_model_self_attention_with_sparse_self_attention(
            model, max_position=None, sparsity_config=None):
        """Swap the model's attention for block-sparse attention
        (reference :81). Supports bidirectional encoders exposing the
        ``attn_override`` hook (BertModel family); ``max_position`` above the
        position table extends it first. Returns the patched model."""
        if sparsity_config is None:
            sparsity_config = FixedSparsityConfig(
                num_heads=model.config.n_head)
        if getattr(model, "causal_attention", False) or \
                not hasattr(model, "attn_override"):
            raise ValueError(
                f"{type(model).__name__} does not support sparse-attention "
                f"surgery; supported: bidirectional encoders with the "
                f"attn_override hook (BertModel family) — the reference "
                f"supports bert/roberta only "
                f"(sparse_attention_utils.py:110)")
        if max_position is not None and max_position > model.wpe.shape[0]:
            SparseAttentionUtils.extend_position_embedding(model,
                                                           max_position)

        sa = SparseSelfAttention(sparsity_config)   # one layout cache +
        #                                             padding-mask merge

        def sparse_attn(q, k, v, mask):
            # at tp > 1 the rank's rows of the whole layout (the model may
            # be sharded after the surgery: read where it runs)
            heads = model._head_range() if model.tp.active else None
            return sa(q, k, v, key_padding_mask=mask, heads=heads)

        model.attn_override = sparse_attn
        log_dist(f"sparse attention installed: "
                 f"{type(sparsity_config).__name__} block="
                 f"{sparsity_config.block}", ranks=[0])
        return model

    @staticmethod
    def pad_to_block_size(block_size, input_ids, attention_mask=None,
                          token_type_ids=None, position_ids=None,
                          inputs_embeds=None, pad_token_id=0,
                          model_embeddings=None):
        """Pad sequence inputs to a multiple of the sparsity block
        (reference :143). Returns (pad_len, input_ids, attention_mask,
        token_type_ids, position_ids, inputs_embeds) — padded positions
        carry attention_mask 0 so they can't leak into real tokens."""
        t = (input_ids if input_ids is not None else inputs_embeds).shape[1]
        pad_len = (-t) % block_size
        if pad_len == 0:
            return (0, input_ids, attention_mask, token_type_ids,
                    position_ids, inputs_embeds)

        def pad(x, value=0):
            if x is None:
                return None
            x = torch.as_tensor(x)
            widths = [0, 0] * (x.dim() - 2) + [0, pad_len]
            return torch.nn.functional.pad(x, widths, value=value)

        if attention_mask is None:
            # always materialize the mask once padding happens — for
            # inputs_embeds-only calls too, or the pad rows would attend
            src = torch.as_tensor(input_ids if input_ids is not None
                                  else inputs_embeds)
            attention_mask = torch.ones(tuple(src.shape[:2]),
                                        dtype=torch.int32, device=src.device)
        input_ids = pad(input_ids, pad_token_id)
        attention_mask = pad(attention_mask, 0)
        token_type_ids = pad(token_type_ids, 0)
        position_ids = pad(position_ids, 0)
        if inputs_embeds is not None and model_embeddings is not None:
            inputs_embeds = torch.as_tensor(inputs_embeds)
            pad_embed = torch.as_tensor(model_embeddings)[pad_token_id]
            tail = pad_embed.to(inputs_embeds.dtype).expand(
                inputs_embeds.shape[0], pad_len, inputs_embeds.shape[2])
            inputs_embeds = torch.cat([inputs_embeds, tail], dim=1)
        return (pad_len, input_ids, attention_mask, token_type_ids,
                position_ids, inputs_embeds)

    @staticmethod
    def unpad_sequence_output(pad_len, sequence_output):
        """Reference :193 — strip the pad tail after the forward."""
        if pad_len:
            return sequence_output[:, :-pad_len]
        return sequence_output
