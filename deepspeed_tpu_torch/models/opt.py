"""OPT family (Meta AI): the JAX package's ``models/opt.py``.

OPT is GPT-2 with ReLU MLPs and learned positions offset by 2 (HF's
``OPTLearnedPositionalEmbedding``), the same pre-LN decoder and tied LM
head, so the port's ``OPTModel`` is the port's ``GPT2Model`` under those
two settings: on the card its scoring attention is the packed Hopper
kernel (K1 forward, K2 backward), as GPT-2's. Post-LN variants (OPT-350M)
and ``word_embed_proj_dim != hidden_size`` are refused by the injection
policy (``module_inject/policy.py``), as in the JAX package.
"""

import dataclasses

from .gpt2 import GPT2Config, GPT2Model


@dataclasses.dataclass(frozen=True)
class OPTConfig(GPT2Config):
    activation: str = "relu"
    pos_offset: int = 2
    layer_norm_epsilon: float = 1e-5


# presets matching HF facebook/opt-* shapes
OPT_125M = OPTConfig(vocab_size=50272, n_positions=2048, n_embd=768,
                     n_layer=12, n_head=12)
OPT_1_3B = OPTConfig(vocab_size=50272, n_positions=2048, n_embd=2048,
                     n_layer=24, n_head=32)
OPT_6_7B = OPTConfig(vocab_size=50272, n_positions=2048, n_embd=4096,
                     n_layer=32, n_head=32)
OPT_13B = OPTConfig(vocab_size=50272, n_positions=2048, n_embd=5120,
                    n_layer=40, n_head=40)


class OPTModel(GPT2Model):
    """GPT-2's layout and paths under OPT's contract: relu (or gelu, for
    OPT-architecture variants such as Galactica) MLPs and position offset
    2, which sizes ``wpe`` to ``n_positions + 2`` rows."""

    def __init__(self, config: OPTConfig = OPT_125M, generator=None,
                 device=None, dtype=None, tp=None):
        if config.activation not in ("relu", "gelu") or \
                config.pos_offset != 2:
            raise ValueError("OPTConfig contract: relu/gelu MLPs + position "
                             "offset 2")
        super().__init__(config, generator, device, dtype, tp)
