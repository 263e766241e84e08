"""HF module injection of the port (``deepspeed_tpu_torch.module_inject``)
held against the JAX package's and against HF itself on the CPU, float32.
Each HF model is a random-init tiny config built here (nothing is
downloaded). For every ported policy (GPT-2, OPT, LLaMA, BLOOM,
GPT-NeoX, GPT-Neo, GPT-J, BERT, DistilBERT): the injected tree is the
JAX policy's bitwise (keys, shapes, values); ``init_inference(hf,
device="cpu")`` gives HF's logits within 2e-3 (the JAX package's own
bound) and the JAX engine's within 1e-5; a decoder's greedy ``generate``
equals HF's full-context recompute; ``auto_tp_rules`` equals the JAX
package's at tp 2 and 4. The JAX policies' refusals are the port's; CLIP,
the UNet and the VAE refuse naming ROADMAP.md row A10; an unknown module
lists the known policies; ``initialize`` takes port models only."""

import os

os.environ.setdefault("USE_TF", "0")     # transformers: torch models only

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.module_inject import auto_tp_rules as jax_auto_tp_rules  # noqa: E402
from deepspeed_tpu.module_inject import policy_for as jax_policy_for  # noqa: E402
from deepspeed_tpu_torch.models import bloom as tbloom  # noqa: E402
from deepspeed_tpu_torch.module_inject import (auto_tp_rules,  # noqa: E402
                                               policy_for,
                                               replace_transformer_layer)

transformers = pytest.importorskip("transformers")

V = 128
HF = {
    "gpt2": ("GPT2Config", "GPT2LMHeadModel", dict(
        vocab_size=V, n_positions=64, n_embd=32, n_layer=2, n_head=4)),
    "opt": ("OPTConfig", "OPTForCausalLM", dict(
        vocab_size=V, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, ffn_dim=256, max_position_embeddings=64,
        do_layer_norm_before=True, word_embed_proj_dim=64,
        activation_function="relu", dropout=0.0)),
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(
        vocab_size=V, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64)),
    "bloom": ("BloomConfig", "BloomForCausalLM", dict(
        vocab_size=V, hidden_size=64, n_layer=2, n_head=4,
        hidden_dropout=0.0, attention_dropout=0.0)),
    "gpt_neox": ("GPTNeoXConfig", "GPTNeoXForCausalLM", dict(
        vocab_size=V, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=256, rotary_pct=0.25,
        max_position_embeddings=64, use_parallel_residual=True,
        hidden_act="gelu")),
    "gpt_neo": ("GPTNeoConfig", "GPTNeoForCausalLM", dict(
        vocab_size=V, max_position_embeddings=64, hidden_size=32,
        num_layers=2, num_heads=4, attention_types=[[["global", "local"], 1]],
        window_size=8, intermediate_size=None, embed_dropout=0.0,
        attention_dropout=0.0, resid_dropout=0.0)),
    "gptj": ("GPTJConfig", "GPTJForCausalLM", dict(
        vocab_size=V, n_embd=64, n_layer=2, n_head=4, rotary_dim=8,
        n_positions=64, activation_function="gelu_new")),
    "bert": ("BertConfig", "BertForMaskedLM", dict(
        vocab_size=V, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=256,
        max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)),
    "distil_bert": ("DistilBertConfig", "DistilBertForMaskedLM", dict(
        vocab_size=V, dim=64, n_layers=2, n_heads=4, hidden_dim=256,
        max_position_embeddings=64, dropout=0.0, attention_dropout=0.0)),
}
ENCODERS = ("bert", "distil_bert")
HF_ATOL, JAX_ATOL = 2e-3, 1e-5


def hf_model(name, **changes):
    cfg_cls, model_cls, kw = HF[name]
    torch.manual_seed(0)
    cfg = getattr(transformers, cfg_cls)(**dict(kw, **changes))
    return getattr(transformers, model_cls)(cfg).eval()


def ids(seed=0):
    # 24 tokens: past GPT-Neo's 8-token local window
    return np.random.default_rng(seed).integers(0, V, (2, 24))


def _leaves_with_paths(tree):
    return [(jax.tree_util.keystr(p), leaf)
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("name", list(HF))
def test_policy_serves_as_hf_and_the_jax_package(name):
    hf = hf_model(name)
    # the tree, bitwise the JAX policy's
    jspec, jtree = jax_policy_for(hf)(hf)
    spec, tree = policy_for(hf)(hf)
    assert type(spec).__name__ == type(jspec).__name__
    assert spec.config.__dict__ == jspec.config.__dict__
    want, got = _leaves_with_paths(jtree), _leaves_with_paths(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32, path
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=path)
    # AutoTP's rules on the port's tree, as the JAX package's on its own
    for n in (2, 4):
        assert auto_tp_rules(tree, n) == jax_auto_tp_rules(jtree, n)
    # served: HF's logits, the JAX engine's
    x = ids()
    with torch.no_grad():
        ref = hf(torch.from_numpy(x)).logits.numpy()
    engine = deepspeed_tpu_torch.init_inference(hf, {"dtype": "float32"},
                                                device="cpu")
    assert type(engine.module).__name__ == type(jspec).__name__
    jengine = deepspeed_tpu.init_inference(hf, {"dtype": "float32"})
    with torch.inference_mode():
        logits = engine(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(logits[..., :V], ref, atol=HF_ATOL)
    np.testing.assert_allclose(
        logits, np.asarray(jengine(x.astype(np.int32))), atol=JAX_ATOL)
    if name in ENCODERS:
        return
    # greedy generate: HF's full-context recompute (not HF generate(),
    # whose pad masking changes the trajectory)
    cur = x[:, :12]
    for _ in range(5):
        with torch.no_grad():
            nxt = hf(torch.from_numpy(cur)).logits[:, -1].argmax(-1).numpy()
        cur = np.concatenate([cur, nxt[:, None]], 1)
    out = engine.generate(x[:, :12], max_new_tokens=5).numpy()
    np.testing.assert_array_equal(out, cur)


@pytest.mark.parametrize("name,changes,match", [
    ("opt", dict(do_layer_norm_before=False), "post-LN"),
    ("opt", dict(word_embed_proj_dim=32), "word_embed_proj_dim"),
    ("opt", dict(activation_function="silu"), "activation"),
    ("llama", dict(hidden_act="gelu"), "activation"),
    ("llama", dict(rope_scaling={"rope_type": "linear", "factor": 2.0}),
     "rope_scaling"),
    ("gpt_neox", dict(rope_scaling={"rope_type": "linear", "factor": 2.0}),
     "rope_scaling"),
    ("gpt_neox", dict(hidden_act="relu"), "activation"),
    ("gptj", dict(activation_function="relu"), "activation"),
    ("bloom", dict(apply_residual_connection_post_layernorm=True),
     "apply_residual_connection_post_layernorm"),
    ("bert", dict(hidden_act="relu"), "activation"),
])
def test_refusals_are_the_jax_policies(name, changes, match):
    hf = hf_model(name, **changes)
    with pytest.raises(ValueError, match=match) as want:
        jax_policy_for(hf)(hf)
    with pytest.raises(ValueError, match=match) as got:
        deepspeed_tpu_torch.init_inference(hf, {"dtype": "float32"},
                                           device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("hf_class", ["CLIPModel", "UNet2DConditionModel",
                                      "AutoencoderKL"])
def test_unported_architectures_name_their_row(hf_class):
    module = type(hf_class, (torch.nn.Module,), {})()
    with pytest.raises(NotImplementedError, match="A10"):
        replace_transformer_layer(module)


def test_unknown_modules_and_training_an_hf_module_refuse():
    with pytest.raises(ValueError, match="no injection policy") as err:
        deepspeed_tpu_torch.init_inference(torch.nn.Linear(2, 2),
                                           device="cpu")
    assert "GPTJForCausalLM" in str(err.value)
    with pytest.raises(TypeError, match="init_inference"):
        deepspeed_tpu_torch.initialize(model=hf_model("gpt2"), config={
            "train_batch_size": 2, "train_micro_batch_size_per_gpu": 2},
            device="cpu")


def test_injection_builds_on_the_engine_device_and_keeps_the_hf_module():
    hf = hf_model("gptj")
    before = {k: v.clone() for k, v in hf.state_dict().items()}
    engine = deepspeed_tpu_torch.init_inference(
        hf, {"dtype": "bfloat16", "replace_with_kernel_inject": True},
        device="cpu")
    assert engine._config.replace_with_kernel_inject
    assert engine.module.lm_head_b.dtype == torch.bfloat16
    assert all(p.device.type == "cpu" for p in engine.module.parameters())
    for k, v in hf.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert next(hf.parameters()).dtype == torch.float32


def test_alibi_slopes_close_to_hf():
    """HF's ``build_alibi_tensor`` against the port's slopes times the key
    position (the JAX package's bitwise check is in
    ``test_torch_families``)."""
    from transformers.models.bloom.modeling_bloom import build_alibi_tensor
    for n in (4, 8, 6, 12, 16):
        hf = build_alibi_tensor(torch.ones(1, 5), n, torch.float32)
        ours = np.asarray(tbloom.alibi_slopes(n), np.float32)
        np.testing.assert_allclose(hf[:, 0].numpy(),
                                   ours[:, None] * np.arange(5)[None, :],
                                   rtol=1e-6)
