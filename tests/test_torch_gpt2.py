"""The port's GPT-2 (deepspeed_tpu_torch.models.gpt2) held against the JAX
package's on the CPU: the same numpy weights and token ids go through both,
in float32."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from deepspeed_tpu.models.gpt2 import GPT2Config as JaxConfig
from deepspeed_tpu.models.gpt2 import GPT2Model as JaxModel
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as tfa

SMALL = dict(vocab_size=250, n_positions=256, n_embd=128, n_layer=2,
             n_head=2, pad_vocab_to_multiple=128)   # D = 64, vocab -> 256
ATOL = 2e-4


def _models(attn_backend="pallas"):
    kw = dict(SMALL, attn_backend=attn_backend)
    return (JaxModel(JaxConfig(**kw)),
            tgpt2.GPT2Model(tgpt2.GPT2Config(**kw)))


def _tree(seed=0):
    """A JAX-layout GPT-2 tree of numpy arrays, every leaf random (LN
    scales around 1) so that each one is exercised."""
    rng = np.random.default_rng(seed)
    cfg = JaxConfig(**SMALL)
    d, f, L = cfg.n_embd, cfg.mlp_ratio * cfg.n_embd, cfg.n_layer

    def leaf(*shape, center=0.0, std=0.02):
        return (center + rng.standard_normal(shape) * std).astype(np.float32)

    blocks = {"ln1_scale": leaf(L, d, center=1.0, std=0.1),
              "ln1_bias": leaf(L, d), "qkv_w": leaf(L, d, 3 * d),
              "qkv_b": leaf(L, 3 * d), "attn_proj_w": leaf(L, d, d),
              "attn_proj_b": leaf(L, d),
              "ln2_scale": leaf(L, d, center=1.0, std=0.1),
              "ln2_bias": leaf(L, d), "mlp_fc_w": leaf(L, d, f),
              "mlp_fc_b": leaf(L, f), "mlp_proj_w": leaf(L, f, d),
              "mlp_proj_b": leaf(L, d)}
    return {"wte": leaf(cfg.padded_vocab, d), "wpe": leaf(cfg.n_positions, d),
            "blocks": blocks, "ln_f_scale": leaf(d, center=1.0, std=0.1),
            "ln_f_bias": leaf(d)}


def _jax_tree(tree):
    return {k: (_jax_tree(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items()}


def _ids(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"],
                                                (b, t), dtype=np.int32)


def test_params_round_trip_and_init_shapes():
    import jax
    jmodel, tmodel = _models()
    tree = _tree()
    back = tmodel.load_jax_params(tree).jax_params()
    assert back.keys() == tree.keys()
    for name in tgpt2.GPT2Model.top_leaves:
        np.testing.assert_array_equal(back[name], tree[name])
    for name in tgpt2.GPT2Model.block_leaves:
        np.testing.assert_array_equal(back["blocks"][name],
                                      tree["blocks"][name])
    # a fresh module has the JAX init's shapes and stds
    fresh = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL)).jax_params()
    want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    assert jax.tree.map(lambda x: tuple(x.shape), want) == \
        jax.tree.map(lambda x: tuple(x.shape), fresh)
    assert abs(fresh["blocks"]["qkv_w"].std() - 0.02) < 2e-3
    assert abs(fresh["blocks"]["mlp_proj_w"].std() - 0.02 / 2.0) < 1e-3
    assert (fresh["blocks"]["ln1_scale"] == 1).all()
    assert (fresh["blocks"]["qkv_b"] == 0).all()


def test_load_jax_params_refuses_mismatched_trees():
    _, tmodel = _models()
    tree = _tree()
    tree["blocks"]["qkv_w"] = tree["blocks"]["qkv_w"][:, :, :10]
    with pytest.raises(ValueError, match="qkv_w"):
        tmodel.load_jax_params(tree)
    tree = _tree()
    del tree["ln_f_bias"]
    with pytest.raises(KeyError, match="ln_f_bias"):
        tmodel.load_jax_params(tree)


@pytest.mark.parametrize("t,backend,packed", [(128, "pallas", True),
                                              (96, "auto", False)])
def test_logits_match_jax(monkeypatch, t, backend, packed):
    """T=128 takes the packed-kernel branch in both packages (the port's
    plain K1 on the CPU); T=96 takes the plain attention path."""
    jmodel, tmodel = _models(backend)
    tree = _tree()
    tmodel.load_jax_params(tree)
    calls = []
    plain = tfa.packed_flash_attention_plain
    monkeypatch.setattr(tfa, "packed_flash_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    ids = _ids(2, t)
    want = jmodel.logits(_jax_tree(tree), jnp.asarray(ids), train=False)
    with torch.inference_mode():
        got = tmodel.logits(torch.from_numpy(ids).long())
    assert len(calls) == (SMALL["n_layer"] if packed else 0)
    assert got.shape == (2, t, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("pad_counts", [None, [0, 3]])
def test_apply_with_cache_matches_jax(pad_counts):
    """Prefill then three one-token decode steps through the KV cache."""
    jmodel, tmodel = _models()
    tree = _tree(seed=1)
    tmodel.load_jax_params(tree)
    jparams = _jax_tree(tree)
    ids = _ids(2, 13, seed=2)
    prompt, steps = ids[:, :10], ids[:, 10:]
    jpc = None if pad_counts is None else jnp.asarray(pad_counts, jnp.int32)
    tpc = None if pad_counts is None else torch.tensor(pad_counts)
    jcache = jmodel.init_kv_cache(2, 32, dtype=jnp.float32)
    tcache = tmodel.init_kv_cache(2, 32, dtype=torch.float32)
    with torch.inference_mode():
        for start, chunk in [(0, prompt)] + [
                (10 + i, steps[:, i:i + 1]) for i in range(3)]:
            want, jcache = jmodel.apply_with_cache(
                jparams, jnp.asarray(chunk), jcache, jnp.int32(start),
                pad_counts=jpc)
            got, tcache = tmodel.apply_with_cache(
                torch.from_numpy(chunk).long(), tcache, start,
                pad_counts=tpc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=ATOL)


def test_positions_past_the_table_raise():
    _, tmodel = _models()
    cache = tmodel.init_kv_cache(1, 512, dtype=torch.float32)
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="n_positions"):
        tmodel.apply_with_cache(torch.zeros((1, 4), dtype=torch.long),
                                cache, 254)
