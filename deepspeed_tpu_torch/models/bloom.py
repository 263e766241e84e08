"""BLOOM family: ALiBi attention, an embedding LayerNorm, no position table.

The JAX package's ``models/bloom.py`` over the port's ``GPT2Model``: the
block is GPT-2's (fused qkv, gelu MLP); the token embeddings are followed
by a LayerNorm (``emb_ln_*``) instead of a position table, and the
attention logits get the ALiBi bias. As the JAX package does, the bias is
``slope_h * k`` (key position only): HF adds ``slope_h * (k - q)``, and a
per-row constant leaves the softmax unchanged, so one ``[1, H, 1, T]``
bias serves training and every cache path, and left padding needs no
shift. A layer with a bias takes the plain attention (no Hopper kernel),
as the JAX dispatch takes its XLA path; on the card the dispatch warns
once. At tp > 1 a rank takes the slopes of its own heads.
"""

import dataclasses
import math

import torch

from .gpt2 import GPT2Config, GPT2Model
from ..ops import memory_efficient as me
from ..parallel import tensor_parallel as tpl


@dataclasses.dataclass(frozen=True)
class BloomConfig(GPT2Config):
    vocab_size: int = 250880
    activation: str = "gelu"


BLOOM_560M = BloomConfig(n_embd=1024, n_layer=24, n_head=16)
BLOOM_7B = BloomConfig(n_embd=4096, n_layer=30, n_head=32)


def alibi_slopes(n_heads: int):
    """Per-head ALiBi slopes (HF transformers build_alibi_tensor layout)."""
    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        return pow2(n_heads)
    closest = 2 ** math.floor(math.log2(n_heads))
    return (pow2(closest) +
            pow2(2 * closest)[0::2][: n_heads - closest])


class BloomModel(GPT2Model):
    """GPT-2's layout without ``wpe``, with ``emb_ln_scale`` /
    ``emb_ln_bias``."""

    has_position_table = False
    top_leaves = ("wte", "emb_ln_scale", "emb_ln_bias", "ln_f_scale",
                  "ln_f_bias")

    def _leaf_shapes(self):
        top, block = super()._leaf_shapes()
        d = self.config.n_embd
        del top["wpe"]
        top.update(emb_ln_scale=(d,), emb_ln_bias=(d,))
        return top, block

    # ------------------------------------------------- family hook overrides
    def _embed(self, input_ids, start_pos=0, positions=None):
        # ALiBi: per-row position shifts are softmax-invariant, so
        # positions are ignored here too
        x = tpl.vocab_parallel_embedding(
            input_ids, self.wte.to(self._compute_dtype()), self.tp)
        return me.layer_norm(x, self.emb_ln_scale, self.emb_ln_bias,
                             self.config.layer_norm_epsilon)

    def _slopes(self, device):
        """``[H_rank]`` float32 slopes of this rank's heads."""
        first, n = self._head_range()
        return torch.tensor(alibi_slopes(n)[first:first + self._heads],
                            dtype=torch.float32, device=device)

    def _train_attn_bias(self, t, device):
        # [1, H, 1, t]: slope_h * key position (row-shift-equivalent to
        # HF's slope_h * (k - q))
        return self._slopes(device)[None, :, None, None] * \
            torch.arange(t, dtype=torch.float32, device=device)

    def _decode_attn_bias(self, q_pos, k_pos):
        # [1, H, 1, C] over the cache columns of any cache path
        cols = k_pos.reshape(-1).to(torch.float32)
        return self._slopes(k_pos.device)[None, :, None, None] * cols
