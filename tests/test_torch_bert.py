"""The port's BERT (deepspeed_tpu_torch.models.bert) and its sparse-attention
surgery (ops/sparse_attention_utils.py) held against the JAX package's on
the CPU: the same numpy weights, token ids and masked positions go through
both, in float32.

The JAX package's surgery takes its dense-masked path on the CPU; the
port's is run both that way and, with ``impl="pallas"``, through the K6/K7
plain versions (the Hopper kernels' arithmetic), which compute the same
function: only the order of sums differs. Tolerances: hidden states,
logits and gradients 1e-5 (+ 1e-5 relative: the MLM logits reach |5|
here), loss 1e-5 relative, the 3-step trajectory 1e-5."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.bert import BertConfig as JaxConfig
from deepspeed_tpu.models.bert import BertModel as JaxModel
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2
from deepspeed_tpu.ops import sparse_attention_ops as jops
from deepspeed_tpu.ops.sparse_attention_utils import \
    SparseAttentionUtils as JaxUtils
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.ops import sparse_attention_ops as tops
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as tbsa
from deepspeed_tpu_torch.ops.kernels import flash_attention as tfk
from deepspeed_tpu_torch.ops.sparse_attention_utils import \
    SparseAttentionUtils as TorchUtils

TINY = dict(vocab_size=256, n_positions=128, n_embd=64, n_layer=2, n_head=4,
            pad_vocab_to_multiple=8)
T = 256                       # after surgery extends 128 positions to 256
SPARSITY = dict(num_heads=4, block=16, num_local_blocks=4,
                num_global_blocks=1, different_layout_per_head=True,
                num_different_global_patterns=4)
ATOL, RTOL, LOSS_TOL = 1e-5, 1e-5, 1e-5


def _tree(kw, seed=0):
    """A JAX-layout BERT tree of numpy f32 arrays, every leaf random (LN
    scales around 1) so that each one is exercised."""
    cfg = JaxConfig(**kw)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JaxModel(cfg).init, jax.random.PRNGKey(0))

    def leaf(name, shape):
        if name.endswith("_scale"):
            return (1 + rng.standard_normal(shape) * 0.1).astype(np.float32)
        std = 0.5 if name in ("wte", "wpe", "tte") else 0.1
        return (rng.standard_normal(shape) * std).astype(np.float32)

    tree = {k: leaf(k, v.shape) for k, v in shapes.items() if k != "blocks"}
    tree["blocks"] = {k: leaf(k, v.shape)
                      for k, v in shapes["blocks"].items()}
    return tree


def _models(kw, seed=0):
    """(JAX model, JAX params, port model) on the same weights."""
    tree = _tree(kw, seed)
    tmodel = tbert.BertModel(tbert.BertConfig(**kw)).load_jax_params(tree)
    return JaxModel(JaxConfig(**kw)), jax.tree.map(jnp.asarray, tree), tmodel


def _surgery(jmodel, jparams, tmodel, t=T):
    """The same Fixed layout installed on both models, positions extended
    to ``t``."""
    jmodel, jparams = JaxUtils.\
        replace_model_self_attention_with_sparse_self_attention(
            jmodel, max_position=t, params=jparams,
            sparsity_config=jops.FixedSparsityConfig(**SPARSITY))
    TorchUtils.replace_model_self_attention_with_sparse_self_attention(
        tmodel, max_position=t,
        sparsity_config=tops.FixedSparsityConfig(**SPARSITY))
    return jmodel, jparams, tmodel


@pytest.fixture
def kernel_route(monkeypatch):
    """The port's surgery takes the K6/K7 plain versions (impl="pallas")
    instead of the dense-masked path that ``auto`` takes on the CPU; the
    calls into them are counted."""
    calls = []
    real = tbsa.block_sparse_attention_plain
    monkeypatch.setattr(tbsa, "block_sparse_attention_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(tops, "sparse_attention", functools.partial(
        tops.sparse_attention, impl="pallas"))
    return calls


def _batch(b, t, seed, n_masked=None):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 250, (b, t)).astype(np.int32)
    out = {"input_ids": ids,
           "token_type_ids": (np.arange(t)[None] >= t // 2).repeat(b, 0)
           .astype(np.int32)}
    if n_masked is None:
        labels = np.where(rng.random((b, t)) < 0.15, ids, -100)
        out["labels"] = labels.astype(np.int32)
    else:
        pos = np.stack([np.sort(rng.choice(t, n_masked, replace=False))
                        for _ in range(b)]).astype(np.int32)
        labels = np.take_along_axis(ids, pos, 1)
        labels[:, -1] = -100                       # an unused slot
        out.update(masked_positions=pos, masked_labels=labels.astype(
            np.int32))
    return out


def _torch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def test_params_round_trip_and_init_shapes():
    jmodel, _, tmodel = _models(TINY)
    tree = _tree(TINY)
    back = tmodel.jax_params()
    assert back.keys() == tree.keys()
    for name in tmodel.top_leaves:
        np.testing.assert_array_equal(back[name], tree[name])
    for name in tmodel.block_leaves:
        np.testing.assert_array_equal(back["blocks"][name],
                                      tree["blocks"][name])
    want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    fresh = tbert.BertModel(tbert.BertConfig(**TINY)).jax_params()
    assert jax.tree.map(lambda x: tuple(x.shape), want) == \
        jax.tree.map(lambda x: tuple(x.shape), fresh)
    assert abs(fresh["blocks"]["inter_w"].std() - 0.02) < 3e-3
    assert (fresh["blocks"]["out_ln_scale"] == 1).all()
    assert (fresh["mlm_bias"] == 0).all()
    assert tbert.BERT_LARGE == tbert.BertConfig(n_embd=1024, n_layer=24,
                                                n_head=16)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_encode_and_mlm_logits_match_jax(backend):
    """Dense attention: plain (``xla``) or K3 non-causal's plain version
    (``pallas``) on the port's side, the JAX plain path; token types and,
    on the plain path, a padding mask."""
    kw = dict(TINY, attn_backend=backend)
    jmodel, jparams, tmodel = _models(kw)
    jmodel = JaxModel(JaxConfig(**dict(kw, attn_backend="xla")))
    batch = _batch(2, 128, seed=1)
    mask = np.ones((2, 128), np.int32)
    mask[1, 100:] = 0
    am = None if backend == "pallas" else mask
    before = tfk.flash_attention_fwd.launches
    want = jmodel.encode(jparams, jnp.asarray(batch["input_ids"]),
                         jnp.asarray(batch["token_type_ids"]),
                         None if am is None else jnp.asarray(am), train=False)
    with torch.inference_mode():
        got = tmodel.encode(*(torch.from_numpy(x).long() for x in (
            batch["input_ids"], batch["token_type_ids"])),
            None if am is None else torch.from_numpy(am))
        logits = tmodel.logits(torch.from_numpy(batch["input_ids"]).long())
    assert tfk.flash_attention_fwd.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jmodel.logits(
            jparams, jnp.asarray(batch["input_ids"]), train=False)),
        atol=ATOL, rtol=RTOL)
    assert logits.shape == (2, 128, 256)


@pytest.mark.parametrize("route", ["dense", "kernel"])
def test_mlm_logits_after_surgery_match_jax(request, route):
    """After the surgery (positions 128 -> 256, the Fixed layout of
    DeepSpeed's sparse-attention example, per-head global patterns): the
    dense-masked path, or K6's plain version once per layer."""
    calls = request.getfixturevalue("kernel_route") if route == "kernel" \
        else None
    jmodel, jparams, tmodel = _surgery(*_models(TINY, seed=2))
    assert tmodel.config.n_positions == T and tmodel.wpe.shape[0] == T
    ids = _batch(2, T, seed=3)["input_ids"]
    want = jmodel.mlm_logits(jparams, jnp.asarray(ids), train=False)
    with torch.inference_mode():
        got = tmodel.mlm_logits(torch.from_numpy(ids).long())
    if calls is not None:
        assert len(calls) == TINY["n_layer"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("masked", [False, True],
                         ids=["labels", "masked_positions"])
def test_loss_and_every_gradient_match_jax(kernel_route, masked):
    """``jax.grad`` of the JAX ``apply`` after surgery (its dense-masked
    path) against autograd of the port's through K6/K7's plain versions."""
    jmodel, jparams, tmodel = _surgery(*_models(TINY, seed=4))
    batch = _batch(2, T, seed=5, n_masked=40 if masked else None)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply(p, jb, rng=None, train=True)))(jparams)
    loss = tmodel.apply(_torch(batch))
    loss.backward()
    assert len(kernel_route) == TINY["n_layer"]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_TOL)
    for name in tmodel.top_leaves:
        np.testing.assert_allclose(getattr(tmodel, name).grad.numpy(),
                                   np.asarray(want[name]), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    for name in tmodel.block_leaves:
        got = np.stack([getattr(blk, name).grad.numpy()
                        for blk in tmodel.blocks])
        np.testing.assert_allclose(got, np.asarray(want["blocks"][name]),
                                   atol=ATOL, rtol=RTOL,
                                   err_msg=f"blocks/{name}")


def test_fp32_train_batch_trajectory_matches_jax_engine(kernel_route):
    """Three fp32 AdamW steps (gas 2) of the surgered model on dict batches
    with ``masked_positions``: losses and final weights within 1e-5."""
    config = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2,
              "optimizer": {"type": "adamw",
                            "params": {"lr": 1e-3, "weight_decay": 0.01}},
              "gradient_clipping": 1.0, "steps_per_print": 0}
    jmodel, jparams, tmodel = _surgery(*_models(TINY, seed=6))
    jax_engine = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=jparams, config=config,
        mesh_manager=initialize_mesh(dp=1, devices=jax.devices("cpu")[:1]))[0]
    tmodel.load_jax_params(jax.tree.map(np.asarray, jax_engine.params))
    engine = deepspeed_tpu_torch.initialize(model=tmodel, config=config,
                                            device="cpu")[0]
    for step in range(3):
        micro = [_batch(2, T, seed=10 + 2 * step + i, n_masked=40)
                 for i in range(2)]
        batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
        want = jax_engine.train_batch(batch=batch)
        got = engine.train_batch(batch=batch)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                                   err_msg=f"step {step}")
    assert len(kernel_route) == 3 * 2 * TINY["n_layer"]
    got_tree = engine.module.jax_params()
    for name in tmodel.top_leaves:
        np.testing.assert_allclose(got_tree[name],
                                   np.asarray(jax_engine.params[name]),
                                   atol=1e-5, err_msg=name)
    for name in tmodel.block_leaves:
        np.testing.assert_allclose(
            got_tree["blocks"][name],
            np.asarray(jax_engine.params["blocks"][name]), atol=1e-5,
            err_msg=f"blocks/{name}")


def test_surgery_utilities_match_jax(monkeypatch):
    """extend (tiled rows), pad / unpad, the padding-mask route (dense,
    not the kernel) and the refusal on GPT-2, each as the JAX package."""
    jmodel, jparams, tmodel = _models(TINY, seed=7)
    jm2, jp2 = JaxUtils.extend_position_embedding(jmodel, jparams, 300)
    assert TorchUtils.extend_position_embedding(tmodel, 300) is tmodel
    assert tmodel.config.n_positions == jm2.config.n_positions == 300
    np.testing.assert_array_equal(tmodel.wpe.detach().numpy(),
                                  np.asarray(jp2["wpe"]))
    with pytest.raises(ValueError, match="must exceed"):
        TorchUtils.extend_position_embedding(tmodel, 300)

    ids = _batch(2, 200, seed=8)["input_ids"]
    tt = np.zeros_like(ids)
    want = JaxUtils.pad_to_block_size(16, jnp.asarray(ids),
                                      token_type_ids=jnp.asarray(tt))
    got = TorchUtils.pad_to_block_size(16, torch.from_numpy(ids),
                                       token_type_ids=torch.from_numpy(tt))
    assert got[0] == want[0] == 8
    for g, w in zip(got[1:], want[1:]):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    e = np.ones((2, 24, 8), np.float32)
    emb = np.arange(32, dtype=np.float32).reshape(4, 8)
    want = JaxUtils.pad_to_block_size(16, None, inputs_embeds=jnp.asarray(e),
                                      pad_token_id=2, model_embeddings=emb)
    got = TorchUtils.pad_to_block_size(16, None,
                                       inputs_embeds=torch.from_numpy(e),
                                       pad_token_id=2, model_embeddings=emb)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    out = torch.zeros((2, 208, 4))
    assert TorchUtils.unpad_sequence_output(8, out).shape == (2, 200, 4)
    assert TorchUtils.unpad_sequence_output(0, out) is out

    # padded batch after surgery: the dense-masked path on both sides
    jmodel, jparams, tmodel = _surgery(*_models(TINY, seed=9))
    monkeypatch.setattr(tbsa, "sparse_attention_kernel",
                        lambda *a, **kw: pytest.fail("kernel taken"))
    (pad_len, pids, pmask, *_) = TorchUtils.pad_to_block_size(
        16, torch.from_numpy(ids))
    jpad = JaxUtils.pad_to_block_size(16, jnp.asarray(ids))
    with torch.inference_mode():
        got = tmodel.encode(pids.long(), attention_mask=pmask)
    want = jmodel.encode(jparams, jpad[1], attention_mask=jpad[2],
                         train=False)
    np.testing.assert_allclose(
        TorchUtils.unpad_sequence_output(pad_len, got).numpy(),
        np.asarray(JaxUtils.unpad_sequence_output(jpad[0], want)),
        atol=ATOL, rtol=RTOL)

    gpt_kw = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=1,
                  n_head=4)
    for utils, model in ((JaxUtils, JaxGPT2(JaxGPT2Config(**gpt_kw))),
                         (TorchUtils, GPT2Model(GPT2Config(**gpt_kw)))):
        with pytest.raises(ValueError, match="surgery"):
            utils.replace_model_self_attention_with_sparse_self_attention(
                model)


def test_inference_engine_scores_bert_and_refuses_generate():
    jmodel, jparams, tmodel = _models(TINY, seed=11)
    engine = deepspeed_tpu_torch.init_inference(tmodel, {"dtype": "fp32"},
                                                device="cpu")
    ids = _batch(2, 64, seed=12)["input_ids"]
    np.testing.assert_allclose(
        engine(ids).numpy(),
        np.asarray(jmodel.logits(jparams, jnp.asarray(ids), train=False)),
        atol=ATOL, rtol=RTOL)
    with pytest.raises(TypeError, match="KV-cache"):
        engine.generate(ids, max_new_tokens=2)


def test_flops_per_token_and_refusals():
    jmodel, _, tmodel = _models(TINY)
    assert tmodel.flops_per_token(T) == jmodel.flops_per_token(T)
    # dropout and remat: the JAX apply's loss
    # under the same key, both with and without remat
    batch = _batch(2, 64, seed=6)
    key = jax.random.PRNGKey(3)
    want = None
    for kw in (dict(dropout=0.1), dict(dropout=0.1, remat=True)):
        jmodel, jparams, tmodel = _models(dict(TINY, **kw), seed=2)
        if want is None:
            want = jmodel.apply(jparams, {k: jnp.asarray(v) for k, v in
                                          batch.items()}, rng=key, train=True)
        got = tmodel.apply(_torch(batch), rng=tuple(np.asarray(key).tolist()))
        np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_TOL)
    with pytest.raises(ValueError, match="n_positions"):
        tmodel.encode(torch.zeros((1, 200), dtype=torch.long))


@pytest.mark.parametrize("policy", ["everything_saveable", "nothing_saveable",
                                    "dots_saveable",
                                    "dots_with_no_batch_dims_saveable"])
def test_dropout_and_remat_after_surgery_match_jax(kernel_route, policy):
    """Dropout 0.1 under one key and each remat policy, after the sparse
    surgery: ``jax.grad`` of the JAX ``apply`` (its dense-masked path)
    against autograd of the port's through K6/K7's plain versions, which
    a recompute runs again (the override forgoes probability dropout in
    both packages; the residual and embedding dropouts apply)."""
    kw = dict(TINY, dropout=0.1, remat=True, remat_policy=policy)
    jmodel, jparams, tmodel = _surgery(*_models(kw, seed=7))
    batch = _batch(1, T, seed=8)
    key = jax.random.PRNGKey(5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply(p, jb, rng=key, train=True)))(jparams)
    loss = tmodel.apply(_torch(batch), rng=tuple(np.asarray(key).tolist()))
    loss.backward()
    recomputes = 0 if policy == "everything_saveable" else TINY["n_layer"]
    assert len(kernel_route) == TINY["n_layer"] + recomputes
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_TOL)
    for name in tmodel.top_leaves:
        np.testing.assert_allclose(getattr(tmodel, name).grad.numpy(),
                                   np.asarray(want[name]), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    for name in tmodel.block_leaves:
        got = np.stack([getattr(blk, name).grad.numpy()
                        for blk in tmodel.blocks])
        np.testing.assert_allclose(got, np.asarray(want["blocks"][name]),
                                   atol=ATOL, rtol=RTOL,
                                   err_msg=f"blocks/{name}")
