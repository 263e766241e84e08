"""GPT-Neo family: the GPT-2 block with alternating global and local
attention, the JAX package's ``models/gpt_neo.py``.

Even layers attend globally, odd ones (by default; ``attention_layers``
names each) through a causal sliding window of ``local_window`` keys. The
per-layer flag is the layer's ``_layer_extras()`` entry (1.0 local, 0.0
global): in training and scoring it scales a ``-1e9`` bias on the keys
outside the window (zero on a global layer), and on the cache paths it
tightens the keep-mask. A layer with that bias takes the plain attention,
as the JAX dispatch takes its XLA path, so with the alternation no GPT-Neo
layer runs a Hopper kernel; only an all-global model (no extras) takes
GPT-2's packed kernel. GPT-Neo's attention is unscaled: the injection
policy folds ``sqrt(head_dim)`` into the q weights, so the model computes
the scaled product as GPT-2 does.
"""

import dataclasses
from typing import Tuple

import torch

from .gpt2 import GPT2Config, GPT2Model


@dataclasses.dataclass(frozen=True)
class GPTNeoConfig(GPT2Config):
    local_window: int = 256
    #: per-layer kinds ("global" | "local"); empty = HF default alternation
    attention_layers: Tuple[str, ...] = ()

    def resolved_attention_layers(self):
        if self.attention_layers:
            if len(self.attention_layers) != self.n_layer:
                raise ValueError(
                    f"attention_layers has {len(self.attention_layers)} "
                    f"entries for n_layer={self.n_layer}")
            return self.attention_layers
        return tuple("global" if i % 2 == 0 else "local"
                     for i in range(self.n_layer))


class GPTNeoModel(GPT2Model):
    """GPT-2's layout and paths with the per-layer local window."""

    def _layer_extras(self):
        kinds = self.config.resolved_attention_layers()
        if all(k == "global" for k in kinds):
            return None  # degenerate: plain GPT-2 attention
        return [1.0 if k == "local" else 0.0 for k in kinds]

    def _train_attn_bias_ex(self, t, extra, device):
        if extra is None:
            return None
        q = torch.arange(t, device=device)[:, None]
        k = torch.arange(t, device=device)[None, :]
        outside = (q - k) >= self.config.local_window
        # a global layer's flag 0 gives a zero bias
        return (extra * torch.where(outside, -1e9, 0.0))[None]

    def _decode_attn_mask_ex(self, q_pos, k_pos, extra):
        base = k_pos <= q_pos
        if extra is None or extra <= 0:
            return base
        return base & ((q_pos - k_pos) < self.config.local_window)
