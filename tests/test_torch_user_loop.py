"""DeepSpeed's user loop (``loss = engine(batch); engine.backward(loss);
engine.step()``) and the keyed ``train_batch`` of the port's engine held
against the JAX package's engine on the CPU.

Both engines start from the JAX engine's initial weights and take the
same batches. Three global steps of the user loop (gas 2, dropout 0.1,
progressive layer drop on) give the JAX engine's micro losses and final
masters within 1e-5 (f32; the dropout masks and layer coins are the same
bits, keyed ``fold_in(base, micro_steps)``); so do ``train_batch`` steps
with dropout, layer drop, random-LTD and remat (keys ``fold_in(fold_in(
base, global_steps), i)``). AdamW at lr 1e-4: Adam moves each weight by
about lr a step whatever its gradient's size, so the f32 rounding
differences of the two implementations reach the masters at about lr
times their relative size (at lr 1e-3 they read 7.6e-6 without dropout
and 1.5e-5 with it after three steps). Without dropout the user loop and
``train_batch`` share one accumulation and one update: their masters are
bitwise equal (bf16 on fp32 masters)."""

import numpy as np
import pytest
import jax
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu_torch.runtime.config_utils import ConfigError

import torch_pairs
import torch_train_pairs as tt

MICRO, GAS, T = 2, 2, 32
PLD = {"enabled": True, "theta": 0.5, "gamma": 0.1}
LTD = {"enabled": True, "data_routing": {"enabled": True, "random_ltd": {
    "enabled": True, "random_ltd_schedule": {
        "min_value": 16, "max_value": 32, "schedule_type": "fixed_linear",
        "schedule_config": {"seq_per_step": 8, "require_steps": 4}}}}}
BASE = {"train_batch_size": MICRO * GAS,
        "train_micro_batch_size_per_gpu": MICRO,
        "gradient_accumulation_steps": GAS,
        "optimizer": {"type": "adamw",
                      "params": {"lr": 1e-4, "weight_decay": 0.01}},
        "gradient_clipping": 1.0, "steps_per_print": 0}


def _engines(config, family="gpt2", **overrides):
    """The JAX engine on one CPU device and the port's, from the JAX
    engine's initial weights."""
    kw, jcfg, jcls, tcfg, tcls = torch_pairs.FAMILIES[family]
    kw = dict(kw, **overrides)
    jax_engine = deepspeed_tpu.initialize(
        model=jcls(jcfg(**dict(kw, attn_backend="xla"))), config=config,
        mesh_manager=initialize_mesh(dp=1, devices=jax.devices("cpu")[:1]))[0]
    model = tcls(tcfg(**kw))
    model.load_jax_params(jax.tree.map(np.asarray, jax_engine.params))
    engine = deepspeed_tpu_torch.initialize(model=model, config=config,
                                            device="cpu")[0]
    return jax_engine, engine


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, torch_pairs.VOCAB,
                                       (GAS, MICRO, T)).astype(np.int32)}
            for _ in range(n)]


def _micro(batch, i):
    return {k: v[i] for k, v in batch.items()}


def test_user_loop_matches_the_jax_engine():
    jax_engine, engine = _engines(dict(BASE, progressive_layer_drop=PLD),
                                  dropout=tt.DROPOUT)
    for step, batch in enumerate(_batches(3)):
        for i in range(GAS):
            want = jax_engine.forward(_micro(batch, i))
            jax_engine.backward(want)
            loss = engine(_micro(batch, i))
            assert loss.requires_grad and loss.dtype == torch.float32
            engine.backward(loss)
            np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5,
                                       err_msg=f"step {step} micro {i}")
            assert engine.is_gradient_accumulation_boundary() == \
                jax_engine.is_gradient_accumulation_boundary() == \
                (i == GAS - 1)
        jax_engine.step()
        engine.step()
        assert engine._last_modifiers[0] == np.float32(
            jax_engine._last_modifiers[0])
    assert engine.global_steps == jax_engine.global_steps == 3
    assert engine.micro_steps == jax_engine.micro_steps == 3 * GAS
    tt.assert_trees_close(engine.module.jax_params(), jax_engine.params)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_keyed_train_batch_matches_the_jax_engine(family):
    """Dropout, layer drop, random-LTD (16 then 24 of 32 tokens) and the
    default remat policy through ``train_batch``."""
    config = dict(BASE, progressive_layer_drop=PLD, data_efficiency=LTD,
                  activation_checkpointing={})
    jax_engine, engine = _engines(config, family, dropout=tt.DROPOUT)
    assert engine.module.config.remat and \
        engine.module.config.remat_policy == \
        jax_engine.module.config.remat_policy
    keeps = []
    for step, batch in enumerate(_batches(3, seed=1)):
        want = jax_engine.train_batch(batch=batch)
        got = engine.train_batch(batch=batch)
        keeps.append(engine._last_modifiers[1])
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                                   err_msg=f"step {step}")
    assert keeps == [16, 16, 24]
    tt.assert_trees_close(engine.module.jax_params(), jax_engine.params)


def test_user_loop_and_train_batch_share_one_update():
    """No dropout: two global steps of the user loop leave the masters
    bitwise those of two ``train_batch`` steps (bf16 on fp32 masters)."""
    config = dict(BASE, bf16={"enabled": True})
    kw, _, _, tcfg, tcls = torch_pairs.FAMILIES["gpt2"]
    engines = []
    for _ in range(2):
        model = tcls(tcfg(**kw)).load_jax_params(torch_pairs.tree("gpt2"))
        engines.append(deepspeed_tpu_torch.initialize(
            model=model, config=config, device="cpu")[0])
    fused, loop = engines
    for batch in _batches(2, seed=2):
        want = fused.train_batch(batch=batch)
        losses = []
        for i in range(GAS):
            losses.append(loop(_micro(batch, i)))
            loop.backward(losses[-1])
        metrics = loop.step()
        assert torch.equal(metrics["loss"], want)
        assert torch.equal(sum(losses) / GAS, want)
    for a, b in zip(fused.module.parameters(), loop.module.parameters()):
        assert torch.equal(a, b)
    assert loop.global_steps == fused.global_steps == 2
    assert torch.equal(loop.get_global_grad_norm(),
                       fused.get_global_grad_norm())


def test_user_loop_refusals_and_the_a12_rows():
    _, _, _, tcfg, tcls = torch_pairs.FAMILIES["gpt2"]
    model = tcls(tcfg(**torch_pairs.GPT2))
    engine = deepspeed_tpu_torch.initialize(model=model, config=BASE,
                                            device="cpu")[0]
    with pytest.raises(RuntimeError, match="without backward"):
        engine.step()
    with pytest.raises(RuntimeError, match="without forward"):
        engine.backward()
    batch = _batches(1)[0]
    engine.backward(engine(_micro(batch, 0)))       # loss=None is forward's
    with pytest.raises(RuntimeError, match="call step"):
        engine.train_batch(batch=batch)
    engine.step()
    assert engine.global_steps == 1 and engine._grad_acc is None
    with pytest.raises(NotImplementedError, match="A12"):
        model.apply({"input_ids": torch.zeros((1, 8), dtype=torch.long)},
                    act_bits=8)
    with pytest.raises(NotImplementedError, match="data_sampling.*A12"):
        deepspeed_tpu_torch.initialize(
            model=model, device="cpu", config=dict(BASE, data_efficiency={
                "enabled": True, "data_sampling": {"enabled": True}}))
    # BERT's apply takes no pld_theta / ltd_keep: both engines refuse
    _, _, bert = tt.models("bert")
    for block in ({"progressive_layer_drop": PLD},
                  {"data_efficiency": LTD}):
        with pytest.raises(ConfigError, match="cannot honor"):
            deepspeed_tpu_torch.initialize(model=bert, device="cpu",
                                           config=dict(BASE, **block))
