"""Shared helpers for the serving tests of the port: one numpy weight tree
served by the JAX package's ``InferenceEngine`` and by the port's, in
float32 on the CPU. Small sizes: 2 layers, width 64. The decoder families
of ROADMAP.md row A10 (OPT, BLOOM, GPT-Neo, GPT-NeoX, GPT-J) take the
same sizes; GPT-Neo's window (8) is shorter than the longer prompts."""

import jax
import numpy as np

from deepspeed_tpu.inference import config as jconfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2Model
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaModel as JaxLlamaModel
from deepspeed_tpu.models import bloom as jbloom, gpt_neo as jneo
from deepspeed_tpu.models import gpt_neox as jneox, opt as jopt
from deepspeed_tpu_torch.inference import config as tconfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.models import bloom as tbloom, gpt_neo as tneo
from deepspeed_tpu_torch.models import gpt_neox as tneox, opt as topt

VOCAB = 96
GPT2 = dict(vocab_size=VOCAB, n_positions=128, n_embd=64, n_layer=2,
            n_head=4, pad_vocab_to_multiple=8, dtype="float32")
# grouped-query attention (4 heads on 2 kv heads) and a sliding window
# shorter than the longer prompts
LLAMA = dict(vocab_size=VOCAB, n_positions=128, n_embd=64, n_layer=2,
             n_head=4, n_kv_head=2, mlp_hidden=96, sliding_window=24,
             pad_vocab_to_multiple=8, dtype="float32")
FAMILIES = {"gpt2": (GPT2, JaxGPT2Config, JaxGPT2Model, GPT2Config,
                     GPT2Model),
            "llama": (LLAMA, JaxLlamaConfig, JaxLlamaModel, LlamaConfig,
                      LlamaModel),
            "opt": (GPT2, jopt.OPTConfig, jopt.OPTModel, topt.OPTConfig,
                    topt.OPTModel),
            "bloom": (GPT2, jbloom.BloomConfig, jbloom.BloomModel,
                      tbloom.BloomConfig, tbloom.BloomModel),
            "neo": (dict(GPT2, local_window=8), jneo.GPTNeoConfig,
                    jneo.GPTNeoModel, tneo.GPTNeoConfig, tneo.GPTNeoModel),
            "neox": (GPT2, jneox.GPTNeoXConfig, jneox.GPTNeoXModel,
                     tneox.GPTNeoXConfig, tneox.GPTNeoXModel),
            "gptj": (dict(GPT2, rotary_ndims=8), jneox.gptj_config,
                     jneox.GPTNeoXModel, tneox.gptj_config,
                     tneox.GPTNeoXModel)}
F32 = {"dtype": "float32"}


def random_tree(jax_model, seed=0, wte_std=0.5, scale=1.0):
    """A JAX-layout weight tree of ``jax_model``'s init shapes, every leaf
    random: norm scales around 1, ``wte`` N(0, wte_std), ``qkv_w`` N(0,
    0.2), the rest N(0, 0.1), the deviations of all but ``wte`` times
    ``scale``; leaves drawn in sorted path order."""
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(node, name=""):
        if isinstance(node, dict):
            return {k: fill(node[k], k) for k in sorted(node)}
        std = wte_std if name == "wte" else \
            scale * {"qkv_w": 0.2}.get(name, 0.1)
        center = 1.0 if name.endswith("_scale") else 0.0
        return (center + rng.standard_normal(node.shape) * std).astype(
            np.float32)
    return fill(shapes)


def tree(family, seed=0):
    """A JAX-layout weight tree of the family's small config: every leaf
    random (norm scales around 1), wide enough that logits have clear
    argmaxes."""
    kw, jcfg_cls, jmodel_cls = FAMILIES[family][:3]
    if family not in ("gpt2", "llama"):
        return random_tree(jmodel_cls(jcfg_cls(**kw)), seed)
    cfg = jcfg_cls(**kw)
    rng = np.random.default_rng(seed)
    d, L = cfg.n_embd, cfg.n_layer

    def leaf(*shape, center=0.0, std=0.1):
        return (center + rng.standard_normal(shape) * std).astype(np.float32)

    if family == "gpt2":
        f = cfg.mlp_ratio * d
        blocks = {"ln1_scale": leaf(L, d, center=1.0), "ln1_bias": leaf(L, d),
                  "qkv_w": leaf(L, d, 3 * d, std=0.2),
                  "qkv_b": leaf(L, 3 * d), "attn_proj_w": leaf(L, d, d),
                  "attn_proj_b": leaf(L, d),
                  "ln2_scale": leaf(L, d, center=1.0), "ln2_bias": leaf(L, d),
                  "mlp_fc_w": leaf(L, d, f), "mlp_fc_b": leaf(L, f),
                  "mlp_proj_w": leaf(L, f, d), "mlp_proj_b": leaf(L, d)}
        return {"wte": leaf(cfg.padded_vocab, d, std=0.5),
                "wpe": leaf(cfg.n_positions, d), "blocks": blocks,
                "ln_f_scale": leaf(d, center=1.0), "ln_f_bias": leaf(d)}
    m = cfg.intermediate
    qkv = (cfg.n_head + 2 * cfg.kv_head_count) * cfg.head_dim
    return {"wte": leaf(cfg.padded_vocab, d, std=0.5),
            "lm_head": leaf(cfg.padded_vocab, d, std=0.1),
            "ln_f_scale": leaf(d, center=1.0),
            "blocks": {"ln1_scale": leaf(L, d, center=1.0),
                       "qkv_w": leaf(L, d, qkv, std=0.2),
                       "attn_proj_w": leaf(L, d, d),
                       "ln2_scale": leaf(L, d, center=1.0),
                       "gate_w": leaf(L, d, m), "up_w": leaf(L, d, m),
                       "down_w": leaf(L, m, d)}}


def engines(family, seed=0):
    """``(JAX engine, port engine)`` serving the same float32 weights."""
    kw, jcfg_cls, jmodel_cls, tcfg_cls, tmodel_cls = FAMILIES[family]
    weights = tree(family, seed)
    jax_engine = JaxEngine(jmodel_cls(jcfg_cls(**kw)),
                           jconfig.DeepSpeedInferenceConfig.from_dict(F32),
                           params=weights)
    port = InferenceEngine(tmodel_cls(tcfg_cls(**kw)),
                           tconfig.DeepSpeedInferenceConfig.from_dict(F32),
                           params=weights, device="cpu")
    return jax_engine, port


def prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (t,), dtype=np.int32) for t in lengths]
