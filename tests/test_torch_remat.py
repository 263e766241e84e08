"""Activation checkpointing in the port held against the JAX package's on
the CPU.

The ``activation_checkpointing`` block maps to the JAX policy names
(``configure``), and ``cpu_checkpointing`` warns and takes the default
policy in both engines off a TPU. Each model family under each policy
(``everything_saveable``, ``nothing_saveable``, ``dots_saveable``,
``dots_with_no_batch_dims_saveable``) gives the JAX model's loss and
gradients within 1e-5 (f32, 2 layers, dropout 0.1 under one key), and in
the port a recompute draws the same dropout masks: the gradients with and
without remat are bitwise equal, and the layer's ops (the dropout's
kernel path among them) run again in the backward."""

import numpy as np
import pytest
import jax
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime.activation_checkpointing import \
    checkpointing as jckpt
from deepspeed_tpu_torch.ops.kernels import threefry_dropout as tfd
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime import engine as tengine
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing as tckpt

import torch_pairs
import torch_train_pairs as tt

POLICY_NAMES = ["everything_saveable", "nothing_saveable", "dots_saveable",
                "dots_with_no_batch_dims_saveable"]
BASE = {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
        "steps_per_print": 0}


@pytest.mark.parametrize("block", [
    {}, {"partition_activations": True}, {"cpu_checkpointing": True},
    {"partition_activations": True, "cpu_checkpointing": True,
     "number_checkpoints": 4}])
def test_config_blocks_map_to_the_jax_policy_names(block):
    config = dict(BASE, activation_checkpointing=block)
    want = jckpt.configure(
        deepspeed_config=jconfig.DeepSpeedConfig(config, world_size=1))
    got = tckpt.configure(deepspeed_config=tconfig.DeepSpeedConfig(config))
    assert got == want
    assert tckpt.current_policy_name() == jckpt.current_policy_name()
    assert tckpt.policy_name_from_config(None) == \
        jckpt.policy_name_from_config(None) == tckpt.DEFAULT_POLICY
    assert set(tckpt.POLICIES) == set(jckpt.POLICIES)
    assert tckpt.get_policy(None).name == tckpt.DEFAULT_POLICY
    with pytest.raises(ValueError, match="unknown remat policy"):
        tckpt.get_policy("dots_everywhere")


def test_cpu_checkpointing_warns_and_takes_the_default_policy(monkeypatch):
    """Both engines, off a TPU: a warning, then remat on the model with
    ``dots_with_no_batch_dims_saveable``."""
    config = dict(BASE, activation_checkpointing={"cpu_checkpointing": True})
    kw, jcfg, jcls, tcfg, tcls = torch_pairs.FAMILIES["gpt2"]
    jengine = deepspeed_tpu.initialize(
        model=jcls(jcfg(**kw)), config=config,
        mesh_manager=initialize_mesh(dp=1, devices=jax.devices("cpu")[:1]))[0]
    warned = []
    monkeypatch.setattr(tengine.logger, "warning", warned.append)
    engine = deepspeed_tpu_torch.initialize(model=tcls(tcfg(**kw)),
                                            config=config, device="cpu")[0]
    assert any("cpu_checkpointing" in w for w in warned)
    for cfg in (engine.module.config, jengine.module.config):
        assert cfg.remat and \
            cfg.remat_policy == "dots_with_no_batch_dims_saveable"
    warned.clear()
    monkeypatch.setattr(tckpt.logger, "warning", warned.append)
    assert tckpt.get_policy("offload_dots").name == tckpt.DEFAULT_POLICY
    assert warned


@pytest.mark.parametrize("policy", POLICY_NAMES)
@pytest.mark.parametrize("family", ["gpt2", "llama", "bert"])
def test_remat_policies_match_jax(family, policy):
    key, words = tt.keys(3)
    data = tt.batch(4, vocab=96)
    tt.assert_matches_jax(family, seed=2, data=data,
                          jax_kwargs={"rng": key},
                          port_kwargs={"rng": words}, dropout=tt.DROPOUT,
                          remat=True, remat_policy=policy)


@pytest.mark.parametrize("policy", ["nothing_saveable",
                                    "dots_with_no_batch_dims_saveable"])
def test_recompute_draws_the_same_masks_and_reruns_the_layer(monkeypatch,
                                                             policy):
    """Gradients with remat equal those without, bit for bit; with remat
    the dropout's kernel path runs once more per dropout (the layer's
    recompute) before its backward."""
    calls = []
    real = tfd.threefry_dropout_plain
    monkeypatch.setattr(tfd, "threefry_dropout_plain",
                        lambda *a: calls.append(1) or real(*a))
    _, words = tt.keys(5)
    data = tt.batch(6)
    grads, counts = {}, {}
    for remat in (False, True):
        _, _, model = tt.models("gpt2", seed=1, dropout=tt.DROPOUT,
                                remat=remat, remat_policy=policy)
        calls.clear()
        tt.port_loss_and_grads(model, data, rng=words)
        grads[remat], counts[remat] = tt.grads_tree(model), len(calls)
    for name, value in grads[False].items():
        if name != "blocks":
            assert np.array_equal(value, grads[True][name]), name
    for name, value in grads[False]["blocks"].items():
        assert np.array_equal(value, grads[True]["blocks"][name]), name
    # per layer: 3 dropouts forward and 3 backward; the embeddings' dropout
    # sits outside the layers. The recompute stops once it has remade every
    # tensor the backward needs (early stop): the attention probabilities'
    # and the attention output's dropouts, not the MLP output's (its sum
    # saves nothing)
    n_layer = torch_pairs.GPT2["n_layer"]
    assert counts[False] == 2 * (3 * n_layer + 1)
    assert counts[True] == counts[False] + 2 * n_layer


def test_remat_runs_plain_forward_without_grad():
    """Under ``no_grad`` (inference) a remat model runs its layers as they
    are: same logits as without remat."""
    _, _, plain = tt.models("llama", seed=7)
    _, _, remat = tt.models("llama", seed=7, remat=True,
                            remat_policy="nothing_saveable")
    ids = torch.from_numpy(tt.batch(8)["input_ids"]).long()
    with torch.no_grad():
        assert torch.equal(plain.logits(ids), remat.logits(ids))


def test_checkpoint_and_wrapper_recompute_the_same_function():
    """The Megatron-style ``checkpoint(fn, *args)`` and
    ``checkpoint_wrapper(fn)`` under the configured policy: the same value
    and gradient as ``fn`` itself."""
    tckpt.configure(deepspeed_config=tconfig.DeepSpeedConfig(
        dict(BASE, activation_checkpointing={"partition_activations": True})))
    w = torch.linspace(-1, 1, 12).reshape(3, 4).requires_grad_()

    def fn(x):
        return torch.tanh(x @ w).sum()

    x = torch.linspace(0, 2, 6).reshape(2, 3)
    grads = []
    for run in (fn, lambda v: tckpt.checkpoint(fn, v),
                tckpt.checkpoint_wrapper(fn, "dots_saveable")):
        w.grad = None
        run(x).backward()
        grads.append(w.grad.clone())
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], grads[2])
