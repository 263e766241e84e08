"""The training half of the port's GPT-2 held against the JAX package's on
the CPU: the same numpy weights and batches go through the JAX
``GPT2Model.apply`` (differentiated by ``jax.grad``) and the port's
``GPT2Model.apply`` (differentiated by autograd), in float32.

The port runs its packed attention (``attn_backend="pallas"``: the plain
versions of K1 and K2 on the CPU); the JAX side takes its plain attention
(``"xla"``), which keeps it cheap."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.models.gpt2 import GPT2Config as JaxConfig
from deepspeed_tpu.models.gpt2 import GPT2Model as JaxModel
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as tfa

SMALL = dict(vocab_size=250, n_positions=256, n_embd=128, n_layer=2,
             n_head=2, pad_vocab_to_multiple=128)   # D = 64, vocab -> 256
# a prime vocab, unpadded, so the chunked loss has a ragged tail: chunks of
# 64 over 251 rows (_loss_chunk finds no divisor of 251 near the target)
RAGGED = dict(SMALL, vocab_size=251, pad_vocab_to_multiple=1,
              loss_chunking="always", loss_chunk_target=64)
B, T = 2, 128
# f32 on both sides: the packed attention's tiles and the loss's sums run
# in another order than the JAX package's, nothing else differs
LOSS_TOL, GRAD_TOL = 1e-5, 2e-5


def _tree(cfg, seed=0):
    """A JAX-layout GPT-2 tree of numpy f32 arrays, every leaf random."""
    rng = np.random.default_rng(seed)
    d, f, L = cfg.n_embd, cfg.mlp_ratio * cfg.n_embd, cfg.n_layer

    def leaf(*shape, center=0.0, std=0.05):
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


def _batch(vocab, seed=0):
    """input_ids and labels with a few -100 (ignored) positions."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, T)).astype(np.int32)
    labels = ids.copy()
    labels[rng.random((B, T)) < 0.1] = -100
    return {"input_ids": ids, "labels": labels}


def _jax_loss_and_grads(kw, tree, batch):
    model = JaxModel(JaxConfig(**dict(kw, attn_backend="xla")))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jtree = jax.tree.map(jnp.asarray, tree)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.apply(p, jb, rng=None, train=True)))(jtree)
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_loss_and_grads(kw, tree, batch):
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**dict(kw, attn_backend="pallas")))
    model.load_jax_params(tree)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    before = tfa.packed_flash_attention_fwd.launches
    loss = model.apply(tb)
    loss.backward()
    assert tfa.packed_flash_attention_fwd.launches == before  # CPU: plain
    grads = {name: getattr(model, name).grad.numpy()
             for name in tgpt2.GPT2Model.top_leaves}
    grads["blocks"] = {
        name: np.stack([getattr(blk, name).grad.numpy()
                        for blk in model.blocks])
        for name in tgpt2.GPT2Model.block_leaves}
    return loss, grads


@pytest.mark.parametrize("kw", [SMALL, RAGGED], ids=["dense", "chunked"])
def test_apply_loss_and_every_gradient_match_jax(kw):
    cfg = JaxConfig(**kw)
    tree, batch = _tree(cfg), _batch(cfg.vocab_size)
    want_loss, want = _jax_loss_and_grads(kw, tree, batch)
    loss, got = _port_loss_and_grads(kw, tree, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_TOL)
    for name in tgpt2.GPT2Model.top_leaves:
        np.testing.assert_allclose(got[name], want[name], atol=GRAD_TOL,
                                   rtol=1e-4, err_msg=name)
    for name in tgpt2.GPT2Model.block_leaves:
        np.testing.assert_allclose(got["blocks"][name],
                                   want["blocks"][name], atol=GRAD_TOL,
                                   rtol=1e-4, err_msg=f"blocks/{name}")


def test_chunked_loss_equals_dense_and_saves_three_rows():
    """The chunked Function gives the dense loss and gradients on the same
    weights, and keeps only (m, s, tgt) per token beside its inputs."""
    cfg = tgpt2.GPT2Config(**dict(RAGGED, attn_backend="xla"))
    tree, batch = _tree(cfg, seed=4), _batch(cfg.vocab_size, seed=4)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    results = []
    for chunking in ("never", "always"):
        model = tgpt2.GPT2Model(dataclasses.replace(cfg,
                                                    loss_chunking=chunking))
        model.load_jax_params(tree)
        loss = model.apply(tb)
        if chunking == "always":
            node = loss.grad_fn.next_functions[0][0]
            assert type(node).__name__ == "_ChunkedNLLBackward"
            rows = [t for t in node.saved_tensors if t is not None and
                    t.dim() == 1 and
                    t.dtype == torch.float32]
            assert len(rows) == 3 and rows[0].shape == (B * (T - 1),)
        loss.backward()
        results.append((loss.item(), model.wte.grad.clone(),
                        model.blocks[0].qkv_w.grad.clone()))
    (l0, w0, q0), (l1, w1, q1) = results
    np.testing.assert_allclose(l1, l0, rtol=LOSS_TOL)
    torch.testing.assert_close(w1, w0, atol=GRAD_TOL, rtol=1e-4)
    torch.testing.assert_close(q1, q0, atol=GRAD_TOL, rtol=1e-4)


def test_loss_chunk_and_flops_per_token_match_jax():
    for v, target in ((50304, 8192), (50257, 8192), (251, 64), (256, 100),
                      (1000, 7)):
        assert tgpt2.GPT2Model._loss_chunk(v, target) == \
            JaxModel._loss_chunk(v, target)
    for kw in (SMALL, dict(SMALL, n_layer=3, n_embd=192, n_head=3)):
        port = tgpt2.GPT2Model(tgpt2.GPT2Config(**kw))
        ref = JaxModel(JaxConfig(**kw))
        for seq in (None, 128, 1024):
            assert port.flops_per_token(seq) == ref.flops_per_token(seq)
    assert tgpt2.GPT2Model._DENSE_LOSS_MAX_ELEMS == \
        JaxModel._DENSE_LOSS_MAX_ELEMS


@pytest.mark.parametrize("what", ["dropout", "remat", "pld_theta",
                                  "ltd_keep", "act_bits"])
def test_unported_training_options_raise_naming_a2b(what):
    """These options raised naming ROADMAP.md row A2b until it was ported;
    now each one's loss and gradients match the JAX ``apply``'s under one
    key (f32): dropout 0.1 (the plain attention, as the JAX package leaves
    its packed kernel while dropping), remat (the packed attention's
    plain versions recomputed), progressive layer drop (theta 0.5) and
    random-LTD (64 of 128 tokens, off the packed envelope). ``act_bits``
    still raises, now naming row A12."""
    kw, call, backend = dict(SMALL), {}, "pallas"
    if what == "dropout":
        kw["dropout"], backend = 0.1, "auto"
    elif what == "remat":
        kw["remat"] = True
    elif what == "pld_theta":
        call[what] = np.float32(0.5)
    elif what == "ltd_keep":
        call[what], backend = 64, "auto"
    else:
        model = tgpt2.GPT2Model(tgpt2.GPT2Config(**kw))
        with pytest.raises(NotImplementedError, match="A12"):
            model.apply({"input_ids": torch.zeros((1, 128), dtype=torch.long)},
                        act_bits=8)
        return
    key = jax.random.PRNGKey(9)
    cfg = JaxConfig(**kw)
    tree, batch = _tree(cfg, seed=5), _batch(cfg.vocab_size, seed=5)
    jmodel = JaxModel(JaxConfig(**dict(kw, attn_backend="xla")))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jcall = {k: jnp.float32(v) if k == "pld_theta" else v
             for k, v in call.items()}
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply(p, jb, rng=key, train=True, **jcall)))(
            jax.tree.map(jnp.asarray, tree))
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**dict(kw,
                                                    attn_backend=backend)))
    model.load_jax_params(tree)
    loss = model.apply({k: torch.from_numpy(v).long()
                        for k, v in batch.items()},
                       rng=tuple(np.asarray(key).tolist()), **call)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_TOL)
    for name in tgpt2.GPT2Model.top_leaves:
        np.testing.assert_allclose(getattr(model, name).grad.numpy(),
                                   np.asarray(want[name]), atol=GRAD_TOL,
                                   rtol=1e-4, err_msg=name)
    for name in tgpt2.GPT2Model.block_leaves:
        got = np.stack([np.zeros(tuple(getattr(blk, name).shape), np.float32)
                        if getattr(blk, name).grad is None else
                        getattr(blk, name).grad.numpy()
                        for blk in model.blocks])
        np.testing.assert_allclose(got, np.asarray(want["blocks"][name]),
                                   atol=GRAD_TOL, rtol=1e-4,
                                   err_msg=f"blocks/{name}")
