"""The port's LLaMA (deepspeed_tpu_torch.models.llama) held against the JAX
package's on the CPU: the same numpy weights and token ids go through both,
in float32. The tiny config has grouped-query attention (4 query heads on
2 kv heads, where ``Tensor.repeat``'s head order 0,1,0,1 differs from
``jnp.repeat``'s 0,0,1,1) and, in some cases, a sliding window shorter
than the sequence."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import config as jiconfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.models.llama import LlamaConfig as JaxConfig
from deepspeed_tpu.models.llama import LlamaModel as JaxModel
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu_torch.inference import config as ticonfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.ops.kernels import flash_attention as tfk
from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as tfa

TINY = dict(vocab_size=256, n_positions=256, n_embd=64, n_layer=2,
            n_head=4, n_kv_head=2, mlp_hidden=96, pad_vocab_to_multiple=8)
VARIANTS = {"mha": dict(TINY, n_kv_head=None), "gqa": TINY,
            "gqa_window": dict(TINY, sliding_window=48)}
T = 128
# f32 on both sides; only the order of sums differs
ATOL = 1e-5
LOSS_TOL, GRAD_TOL = 1e-5, 2e-5


def _tree(kw, seed=0):
    """A JAX-layout LLaMA tree of numpy f32 arrays, every leaf random (norm
    scales around 1) so that each one is exercised."""
    cfg = JaxConfig(**kw)
    rng = np.random.default_rng(seed)
    d, m, L = cfg.n_embd, cfg.intermediate, cfg.n_layer
    qkv = (cfg.n_head + 2 * cfg.kv_head_count) * cfg.head_dim

    def leaf(*shape, center=0.0, std=0.05):
        return (center + rng.standard_normal(shape) * std).astype(np.float32)

    tree = {"wte": leaf(cfg.padded_vocab, d, std=0.5),
            "ln_f_scale": leaf(d, center=1.0, std=0.1),
            "blocks": {"ln1_scale": leaf(L, d, center=1.0, std=0.1),
                       "qkv_w": leaf(L, d, qkv, std=0.2),
                       "attn_proj_w": leaf(L, d, d),
                       "ln2_scale": leaf(L, d, center=1.0, std=0.1),
                       "gate_w": leaf(L, d, m), "up_w": leaf(L, d, m),
                       "down_w": leaf(L, m, d)}}
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = leaf(cfg.padded_vocab, d, std=0.1)
    return tree


def _models(kw):
    return JaxModel(JaxConfig(**kw)), tllama.LlamaModel(tllama.LlamaConfig(**kw))


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ids(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, t),
                                                dtype=np.int32)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_params_round_trip_and_init_shapes(tied):
    kw = dict(TINY, tie_word_embeddings=tied)
    jmodel, tmodel = _models(kw)
    tree = _tree(kw)
    back = tmodel.load_jax_params(tree).jax_params()
    assert back.keys() == tree.keys()
    assert ("lm_head" in back) is not tied
    for name in tmodel.top_leaves:
        np.testing.assert_array_equal(back[name], tree[name])
    for name in tmodel.block_leaves:
        np.testing.assert_array_equal(back["blocks"][name],
                                      tree["blocks"][name])
    # a fresh module has the JAX init's shapes and stds
    want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    fresh = tllama.LlamaModel(tllama.LlamaConfig(**kw)).jax_params()
    assert jax.tree.map(lambda x: tuple(x.shape), want) == \
        jax.tree.map(lambda x: tuple(x.shape), fresh)
    assert abs(fresh["blocks"]["gate_w"].std() - 0.02) < 3e-3
    assert abs(fresh["blocks"]["down_w"].std() - 0.01) < 2e-3
    assert (fresh["blocks"]["ln1_scale"] == 1).all()
    # one seed on the CPU gives the same weights at any dtype's precision
    again = tllama.LlamaModel(tllama.LlamaConfig(**kw),
                              dtype=torch.bfloat16).jax_params()
    np.testing.assert_allclose(again["wte"], fresh["wte"], rtol=1e-2)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_match_jax(variant):
    kw = dict(VARIANTS[variant], attn_backend="xla")
    jmodel, tmodel = _models(kw)
    tree = _tree(kw)
    tmodel.load_jax_params(tree)
    ids = _ids(2, T)
    want = jmodel.logits(_jax_tree(tree), jnp.asarray(ids), train=False)
    with torch.inference_mode():
        got = tmodel.logits(torch.from_numpy(ids).long())
    assert got.shape == (2, T, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_logits_match_jax_on_the_kernel_path(monkeypatch):
    """``attn_backend="pallas"`` on both sides: the JAX package runs K3 in
    interpret mode, the port K3's plain version, once per layer, with the
    kv heads repeated first; the packed K1 is never taken."""
    kw = dict(VARIANTS["gqa_window"], attn_backend="pallas")
    jmodel, tmodel = _models(kw)
    tree = _tree(kw, seed=1)
    tmodel.load_jax_params(tree)
    calls = []
    plain = tfk.flash_attention_plain
    monkeypatch.setattr(tfk, "flash_attention_plain",
                        lambda *a, **k: calls.append(a[0].shape) or
                        plain(*a, **k))
    packed_before = tfa.packed_flash_attention_fwd.launches
    ids = _ids(2, T, seed=1)
    want = jmodel.logits(_jax_tree(tree), jnp.asarray(ids), train=False)
    with torch.inference_mode():
        got = tmodel.logits(torch.from_numpy(ids).long())
    assert calls == [(2, 4, T, 16)] * TINY["n_layer"]
    assert tfa.packed_flash_attention_fwd.launches == packed_before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("pad_counts", [None, [0, 3]],
                         ids=["unpadded", "left_padded"])
def test_apply_with_cache_matches_jax(pad_counts):
    """Prefill then three one-token decode steps through the KV cache with
    grouped-query heads and a window (8) that the cache path must apply
    through ``_decode_attn_mask``: logits and the cache against the JAX
    package's ``apply_with_cache``."""
    kw = dict(TINY, sliding_window=8, attn_backend="xla")
    jmodel, tmodel = _models(kw)
    tree = _tree(kw, seed=2)
    tmodel.load_jax_params(tree)
    jparams = _jax_tree(tree)
    ids = _ids(2, 13, seed=2)
    prompt, steps = ids[:, :10], ids[:, 10:]
    jpc = None if pad_counts is None else jnp.asarray(pad_counts, jnp.int32)
    tpc = None if pad_counts is None else torch.tensor(pad_counts)
    jcache = jmodel.init_kv_cache(2, 32, dtype=jnp.float32)
    tcache = tmodel.init_kv_cache(2, 32, dtype=torch.float32)
    assert tcache["k"].shape == (2, 2, 2, 32, 16)      # kv_heads = 2
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
                                       atol=ATOL, err_msg=f"step {start}")
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=ATOL)


def test_cache_path_matches_full_forward_with_left_padding():
    """A left-padded batch through prefill and decode gives each row the
    logits of the full forward over its own unpadded tokens: rotary reads
    the per-row positions and the window counts real tokens only."""
    kw = dict(TINY, sliding_window=6, attn_backend="xla")
    _, tmodel = _models(kw)
    tmodel.load_jax_params(_tree(kw, seed=3))
    seqs = [_ids(1, 15, seed=4)[0], _ids(1, 11, seed=5)[0]]
    pads = [0, 4]
    prompt = np.stack([np.concatenate([np.zeros(p, np.int32), s[:12 - p]])
                       for s, p in zip(seqs, pads)])
    cache = tmodel.init_kv_cache(2, 16, dtype=torch.float32)
    with torch.inference_mode():
        logits, cache = tmodel.apply_with_cache(
            torch.from_numpy(prompt).long(), cache, 0, torch.tensor(pads))
        got = [logits[:, -1]]
        for i in range(3):
            tok = torch.tensor([[seqs[0][12 + i]], [seqs[1][8 + i]]])
            logits, cache = tmodel.apply_with_cache(tok, cache, 12 + i,
                                                    torch.tensor(pads))
            got.append(logits[:, -1])
        got = torch.stack(got, dim=1)
        for row, (s, p) in enumerate(zip(seqs, pads)):
            full = tmodel.logits(torch.from_numpy(s[None]).long())[0]
            n = 12 - p
            torch.testing.assert_close(got[row], full[n - 1:n + 3],
                                       atol=ATOL, rtol=0)


def test_greedy_stream_identical_to_jax():
    """The JAX engine and the port's serve the same weights: greedy streams
    of a left-padded batch are equal token for token."""
    kw = dict(TINY, sliding_window=8, attn_backend="xla")
    tree = _tree(kw, seed=6)
    f32 = {"dtype": "float32"}
    jax_engine = JaxEngine(JaxModel(JaxConfig(**kw)),
                           jiconfig.DeepSpeedInferenceConfig.from_dict(f32),
                           params=tree)
    port = deepspeed_tpu_torch.init_inference(
        tllama.LlamaModel(tllama.LlamaConfig(**kw)), f32, device="cpu")
    assert isinstance(port, InferenceEngine)
    port.module.load_jax_params(tree)
    prompts = _ids(2, 12, seed=7)
    mask = np.ones_like(prompts)
    mask[1, :5] = 0
    prompts = np.where(mask == 1, prompts, 0).astype(np.int32)
    want = np.asarray(jax_engine.generate(jnp.asarray(prompts),
                                          attention_mask=jnp.asarray(mask),
                                          max_new_tokens=10))
    got = port.generate(prompts, attention_mask=mask,
                        max_new_tokens=10).numpy()
    np.testing.assert_array_equal(got, want)
    assert ticonfig.DeepSpeedInferenceConfig.from_dict(f32).dtype == \
        torch.float32


def test_loss_and_every_gradient_match_jax():
    """``jax.grad`` of the JAX ``apply`` (plain attention) against autograd
    of the port's, whose attention is K3 with the K3b/K5 backward (their
    plain versions on the CPU), GQA and a window."""
    kw = VARIANTS["gqa_window"]
    tree = _tree(kw, seed=8)
    rng = np.random.default_rng(8)
    ids = rng.integers(0, TINY["vocab_size"], (2, T)).astype(np.int32)
    labels = ids.copy()
    labels[rng.random((2, T)) < 0.1] = -100
    batch = {"input_ids": ids, "labels": labels}
    jmodel = JaxModel(JaxConfig(**dict(kw, attn_backend="xla")))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply(p, jb, rng=None, train=True)))(_jax_tree(tree))
    tmodel = tllama.LlamaModel(tllama.LlamaConfig(**dict(
        kw, attn_backend="pallas")))
    tmodel.load_jax_params(tree)
    loss = tmodel.apply({k: torch.from_numpy(v).long()
                         for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_TOL)
    for name in tmodel.top_leaves:
        np.testing.assert_allclose(getattr(tmodel, name).grad.numpy(),
                                   np.asarray(want[name]), atol=GRAD_TOL,
                                   rtol=1e-4, err_msg=name)
    for name in tmodel.block_leaves:
        got = np.stack([getattr(blk, name).grad.numpy()
                        for blk in tmodel.blocks])
        np.testing.assert_allclose(got, np.asarray(want["blocks"][name]),
                                   atol=GRAD_TOL, rtol=1e-4,
                                   err_msg=f"blocks/{name}")


def test_fp32_train_batch_trajectory_matches_jax_engine():
    """Three fp32 AdamW steps (gas 2) from the JAX engine's initial weights:
    losses and final weights within 1e-5."""
    kw = VARIANTS["gqa_window"]
    config = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2,
              "optimizer": {"type": "adamw",
                            "params": {"lr": 1e-3, "weight_decay": 0.01}},
              "gradient_clipping": 1.0, "steps_per_print": 0}
    jax_engine = deepspeed_tpu.initialize(
        model=JaxModel(JaxConfig(**dict(kw, attn_backend="xla"))),
        config=config,
        mesh_manager=initialize_mesh(dp=1, devices=jax.devices("cpu")[:1]))[0]
    model = tllama.LlamaModel(tllama.LlamaConfig(**dict(
        kw, attn_backend="pallas")))
    model.load_jax_params(jax.tree.map(np.asarray, jax_engine.params))
    engine = deepspeed_tpu_torch.initialize(model=model, config=config,
                                            device="cpu")[0]
    rng = np.random.default_rng(9)
    for step in range(3):
        batch = {"input_ids": rng.integers(0, TINY["vocab_size"],
                                           (2, 2, T)).astype(np.int32)}
        want = jax_engine.train_batch(batch=batch)
        got = engine.train_batch(batch=batch)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                                   err_msg=f"step {step}")
    got_tree = engine.module.jax_params()
    for name in model.top_leaves:
        np.testing.assert_allclose(got_tree[name],
                                   np.asarray(jax_engine.params[name]),
                                   atol=1e-5, err_msg=name)
    for name in model.block_leaves:
        np.testing.assert_allclose(
            got_tree["blocks"][name],
            np.asarray(jax_engine.params["blocks"][name]), atol=1e-5,
            err_msg=f"blocks/{name}")


def test_flops_per_token_and_refusals():
    kw = VARIANTS["gqa"]
    jmodel, tmodel = _models(kw)
    assert tmodel.flops_per_token(T) == jmodel.flops_per_token(T)
    assert tmodel.kv_heads == 2
    # dropout: the JAX apply's loss under the
    # same key; without a key, no dropout in either package
    drop = dict(kw, dropout=0.1)
    jdrop = JaxModel(JaxConfig(**dict(drop, attn_backend="xla")))
    tdrop = tllama.LlamaModel(tllama.LlamaConfig(**drop))
    tdrop.load_jax_params(_tree(kw))
    ids = _ids(2, T, seed=3)
    key = jax.random.PRNGKey(2)
    for rng, trng in ((key, tuple(np.asarray(key).tolist())), (None, None)):
        want = jdrop.apply(_jax_tree(_tree(kw)), {"input_ids": jnp.asarray(
            ids)}, rng=rng, train=True)
        got = tdrop.apply({"input_ids": torch.from_numpy(ids).long()},
                          rng=trng)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    with pytest.raises(ValueError, match="multiple of n_kv_head"):
        tllama.LlamaModel(tllama.LlamaConfig(**dict(kw, n_kv_head=3)))
