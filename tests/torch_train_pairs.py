"""Shared helpers for the training-parity tests of the port (dropout,
remat, progressive layer drop, random-LTD, the user loop): one numpy
weight tree, one batch and one key through the JAX package's ``apply``
(differentiated by ``jax.grad``, jitted) and the port's (autograd), in
float32 on the CPU. Small sizes: 2 layers, width 64."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.models.bert import BertConfig as JaxBertConfig
from deepspeed_tpu.models.bert import BertModel as JaxBertModel
from deepspeed_tpu_torch.inference import prng
from deepspeed_tpu_torch.models.bert import BertConfig, BertModel

import torch_pairs

B, T = 2, 32
DROPOUT = 0.1
# float32 on both sides: the masks are the same bits; XLA multiplies by
# the reciprocal of 1 - rate where the port divides (one rounding step),
# and sums run in another order
ATOL, RTOL = 1e-5, 1e-5
BERT = dict(vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4,
            pad_vocab_to_multiple=8)


def keys(seed):
    """``(JAX key, the port's key words)`` of one seed."""
    key = jax.random.PRNGKey(seed)
    return key, prng.as_key(np.asarray(key))


def bert_tree(kw, seed=0):
    """A JAX-layout BERT tree of numpy f32 arrays, every leaf random."""
    shapes = jax.eval_shape(JaxBertModel(JaxBertConfig(**kw)).init,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name.endswith("_scale"):
            return (1 + rng.standard_normal(shape) * 0.1).astype(np.float32)
        std = 0.5 if name in ("wte", "wpe", "tte") else 0.1
        return (rng.standard_normal(shape) * std).astype(np.float32)

    tree = {k: leaf(k, v.shape) for k, v in shapes.items() if k != "blocks"}
    tree["blocks"] = {k: leaf(k, v.shape)
                      for k, v in shapes["blocks"].items()}
    return tree


def models(family, seed=0, **overrides):
    """``(JAX model, JAX params, port model)`` of ``family`` (``gpt2``,
    ``llama`` or ``bert``) on the same weights, config fields overridden.
    The JAX side takes its plain attention; so does the port on the CPU
    (``auto``)."""
    if family == "bert":
        kw = dict(BERT, **overrides)
        tree = bert_tree(BERT, seed)
        jmodel = JaxBertModel(JaxBertConfig(**dict(kw, attn_backend="xla")))
        tmodel = BertModel(BertConfig(**kw))
    else:
        base, jcfg, jcls, tcfg, tcls = torch_pairs.FAMILIES[family]
        kw = dict(base, **overrides)
        tree = torch_pairs.tree(family, seed)
        jmodel = jcls(jcfg(**dict(kw, attn_backend="xla")))
        tmodel = tcls(tcfg(**kw))
    tmodel.load_jax_params(tree)
    return jmodel, jax.tree.map(jnp.asarray, tree), tmodel


def with_config(model, **changes):
    """The port model with its (frozen) config fields changed."""
    model.config = dataclasses.replace(model.config, **changes)
    return model


def batch(seed=0, b=B, t=T, vocab=torch_pairs.VOCAB):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, vocab, (b, t)).astype(np.int32)}


def jax_loss_and_grads(jmodel, jparams, data, **kwargs):
    """The JAX ``apply``'s loss and ``jax.grad`` (jitted; ``kwargs``
    static)."""
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.apply(p, b, **kwargs)))(jparams, jb)
    return float(loss), grads


def port_loss_and_grads(tmodel, data, **kwargs):
    """The port's loss (autograd), its gradients left on the module."""
    tmodel.zero_grad(set_to_none=True)
    loss = tmodel.apply({k: torch.from_numpy(v).long()
                         for k, v in data.items()}, **kwargs)
    loss.backward()
    return loss.item()


def grads_tree(tmodel):
    """The port's gradients as a JAX-layout tree of numpy arrays."""
    def arr(p):
        return np.zeros(tuple(p.shape), np.float32) if p.grad is None \
            else p.grad.numpy()
    tree = {n: arr(getattr(tmodel, n)) for n in tmodel.top_leaves}
    tree["blocks"] = {n: np.stack([arr(getattr(blk, n))
                                   for blk in tmodel.blocks])
                      for n in tmodel.block_leaves}
    return tree


def assert_trees_close(got, want, atol=ATOL, rtol=RTOL):
    for name, value in got.items():
        if name == "blocks":
            assert_trees_close(value, want["blocks"], atol, rtol)
            continue
        np.testing.assert_allclose(value, np.asarray(want[name]), atol=atol,
                                   rtol=rtol, err_msg=name)


def assert_matches_jax(family, seed=0, data=None, jax_kwargs=None,
                       port_kwargs=None, **overrides):
    """Loss and every gradient of one micro batch, port vs JAX, within
    ATOL / RTOL. Returns the port model (gradients on it) and the loss."""
    jmodel, jparams, tmodel = models(family, seed, **overrides)
    data = batch(seed + 1) if data is None else data
    want_loss, want = jax_loss_and_grads(jmodel, jparams, data,
                                         **(jax_kwargs or {}))
    loss = port_loss_and_grads(tmodel, data, **(port_kwargs or {}))
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
    assert_trees_close(grads_tree(tmodel), want)
    return tmodel, loss
