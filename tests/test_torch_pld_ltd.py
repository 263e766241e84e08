"""Progressive layer drop and random-LTD in the port held against the JAX
package's on the CPU.

Bit for bit: the float32 keep probability the JAX layer scan traces, the
theta and kept-token schedules, each row's kept-token indices
(``split`` + ``permutation`` + sort), and the gather/scatter. Within
1e-5 (f32, 2 layers, dropout 0.1 under one key): GPT-2's and LLaMA's loss
and gradients with ``pld_theta``, with ``ltd_keep`` (the gathered block at
positions ``0..keep-1``, rotary included) and with both, where the layers
each package drops are the same."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops import random_ltd_ops as jltd
from deepspeed_tpu.runtime import progressive_layer_drop as jpld
from deepspeed_tpu.runtime.data_pipeline import random_ltd as jsched
from deepspeed_tpu_torch.inference import prng
from deepspeed_tpu_torch.ops import random_ltd_ops as tltd
from deepspeed_tpu_torch.runtime import progressive_layer_drop as tpld
from deepspeed_tpu_torch.runtime.data_pipeline import random_ltd as tsched

import torch_train_pairs as tt

# DeepSpeed's GPT example schedule for random-LTD
GPT_LTD = {"enabled": True, "random_ltd_schedule": {
    "min_value": 128, "max_value": 1024, "schedule_type": "fixed_linear",
    "schedule_config": {"seq_per_step": 16, "require_steps": 200000}}}


def test_keep_probability_is_the_traced_float32():
    traced = jax.jit(lambda th, i, n: jpld.keep_prob_for_layer(th, i, n),
                     static_argnums=2)
    for theta in (0.5, 0.1, 0.9999, 0.73):
        th = np.float32(tpld.ProgressiveLayerDrop(theta, 0.1)
                        .update_state(7))
        for n in (2, 12, 24):
            for i in range(n):
                want = traced(jnp.float32(th), jnp.int32(i), n)
                got = tpld.keep_prob_for_layer(th, i, n)
                assert isinstance(got, np.float32)
                assert got == np.float32(want), (theta, n, i)


def test_schedules_match_jax():
    for theta, gamma in ((0.5, 0.001), (0.5, 0.1), (0.2, 0.01)):
        t, j = tpld.ProgressiveLayerDrop(theta, gamma), \
            jpld.ProgressiveLayerDrop(theta, gamma)
        for step in (0, 1, 5, 100, 10 ** 5):
            assert t.update_state(step) == j.update_state(step)
            assert t.get_state() == j.get_state()
    for config in (GPT_LTD, {"min_value": 64, "max_value": 512,
                             "random_ltd_schedule": {"schedule_config": {
                                 "seq_per_step": 8, "require_steps": 10}}}):
        t, j = tsched.RandomLTDScheduler(config), \
            jsched.RandomLTDScheduler(config)
        for step in (0, 1, 3, 7, 9, 10, 11, 1000, 10 ** 6):
            assert t.get_current_seq(step) == j.get_current_seq(step)
            assert t.is_fully_ramped(step) == j.is_fully_ramped(step)
    with pytest.raises(ValueError, match="schedule"):
        tsched.RandomLTDScheduler({"random_ltd_schedule": {
            "schedule_type": "cosine"}})


@pytest.mark.parametrize("b,t,keep", [(2, 7, 3), (8, 1024, 128),
                                      (2, 2048, 1000), (1, 4096, 512)])
def test_kept_token_indices_bitwise_jax(b, t, keep):
    key, words = tt.keys(t + keep)
    want = np.asarray(jltd.sample_token_indices(key, keep, b, t))
    got = tltd.sample_token_indices(words, keep, b, t)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_and_scatter_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 20, 4, 5)).astype(np.float32)
    key, words = tt.keys(4)
    idx = jltd.sample_token_indices(key, 6, 3, 20)
    tidx = tltd.sample_token_indices(words, 6, 3, 20)
    gathered = tltd.token_gather(torch.from_numpy(x), tidx)
    np.testing.assert_array_equal(gathered.numpy(), np.asarray(
        jltd.token_gather(jnp.asarray(x), idx)))
    vals = gathered * 3 - 1
    np.testing.assert_array_equal(
        tltd.token_scatter(torch.from_numpy(x), vals, tidx).numpy(),
        np.asarray(jltd.token_scatter(jnp.asarray(x), jnp.asarray(
            vals.numpy()), idx)))


@pytest.mark.parametrize("wrappers", ["pld", "ltd", "pld+ltd"])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_apply_with_layer_drop_and_token_drop_matches_jax(family, wrappers):
    """theta 0.2 keeps layer 0 of 2 with p 0.6 and layer 1 with p 0.2:
    under seed 7's key layer 0 drops and layer 1 runs, in both packages
    (the dropped layer's gradients are 0)."""
    key, words = tt.keys(7)
    kw = {}
    if "pld" in wrappers:
        kw["pld_theta"] = np.float32(0.2)
    if "ltd" in wrappers:
        kw["ltd_keep"] = 12
    jkw = dict(kw, rng=key)
    if "pld_theta" in kw:
        jkw["pld_theta"] = jnp.float32(kw["pld_theta"])
    model, _ = tt.assert_matches_jax(family, seed=3, jax_kwargs=jkw,
                                     port_kwargs=dict(kw, rng=words),
                                     dropout=tt.DROPOUT)
    coins = [prng.bernoulli_scalar(
        prng.fold_in_words(prng.fold_in_words(words, i), 1002),
        tpld.keep_prob_for_layer(np.float32(0.2), i, 2)) for i in range(2)]
    assert coins == [False, True]
    ran = [p.qkv_w.grad is not None and bool(p.qkv_w.grad.any())
           for p in model.blocks]
    assert ran == ([False, True] if "pld" in wrappers else [True, True])
