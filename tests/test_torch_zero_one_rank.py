"""ZeRO on one rank (no process group: every collective the identity) and
the ZeRO user API, on the CPU.

- On one rank the planner partitions nothing, as the JAX planner shards
  nothing at dp 1: stages 1-3 run stage 0, the masters being the model's
  parameters.
- Partitioned over the one rank (the test planner ``OneRankPlanner``),
  stages 1-3 give stage 0's losses, masters and moments bit for bit for
  GPT-2, LLaMA and BERT (float32 and bf16 compute; with dropout,
  progressive layer drop and random-LTD; under activation checkpointing,
  whose recompute gathers a stage-3 layer again), through ``train_batch``
  and through the user loop.
- ``zero.GatheredParameters`` reads the whole masters at stage 3 and
  writes a change back into the shards; a bare tree is read-only.
- ``utils/tensor_fragment``'s whole-value reads and writes against the JAX
  package's on a dp-1 engine (the gradient between ``backward`` and
  ``step``, the moments, a set master), and ``runtime/zero/tiling``
  against the JAX functions.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu.runtime.zero import tiling as jtiling
from deepspeed_tpu.utils import tensor_fragment as jtf
from deepspeed_tpu_torch import zero
from deepspeed_tpu_torch.runtime.zero import tiling
from deepspeed_tpu_torch.utils import tensor_fragment as tf

import torch_dist_worker
import torch_pairs
import torch_train_pairs as tt

MICRO, GAS, T = 2, 2, 32
LTD = {"enabled": True, "data_routing": {"enabled": True, "random_ltd": {
    "enabled": True, "random_ltd_schedule": {
        "min_value": 16, "max_value": 32, "schedule_type": "fixed_linear",
        "schedule_config": {"seq_per_step": 8, "require_steps": 4}}}}}


def _config(stage, **extra):
    return dict({"train_batch_size": MICRO * GAS,
                 "train_micro_batch_size_per_gpu": MICRO,
                 "gradient_accumulation_steps": GAS,
                 "optimizer": {"type": "adamw",
                               "params": {"lr": 1e-3, "weight_decay": 0.01}},
                 "gradient_clipping": 1.0, "steps_per_print": 0,
                 "zero_optimization": {
                     "stage": stage,
                     "stage3_param_persistence_threshold": 500}}, **extra)


def _kw(family, **over):
    if family == "bert":
        return dict(tt.BERT, **over)
    kw = {k: v for k, v in torch_pairs.FAMILIES[family][0].items()
          if k != "dtype"}
    return dict(kw, **over)


def _batches(family, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 96, (GAS, MICRO, T))}
            for _ in range(n)]


def _run(family, stage, kw, extra, loop, one_rank=True):
    with torch_dist_worker.one_rank_planner() if one_rank else \
            contextlib.nullcontext():
        engine = deepspeed_tpu_torch.initialize(
            model=torch_dist_worker.model(family, kw),
            config=_config(stage, **extra), device="cpu")[0]
    steps = torch_dist_worker.run_steps(engine, _batches(family), loop)
    n = len(engine._names)
    state = [engine.whole_master(i) for i in range(n)] + \
        [engine.whole(i, m) for i, m in enumerate(engine.opt_state.mu)] + \
        [engine.whole(i, v) for i, v in enumerate(engine.opt_state.nu)]
    return [s["loss"] for s in steps], state, engine


CASES = {
    "gpt2": ("gpt2", {}, {}, "train_batch"),
    "gpt2 bf16 user loop": ("gpt2", {}, {"bf16": {"enabled": True}}, "user"),
    "gpt2 dropout pld ltd": ("gpt2", {"dropout": 0.1},
                             {"progressive_layer_drop": {
                                 "enabled": True, "theta": 0.5,
                                 "gamma": 0.1}, "data_efficiency": LTD},
                             "train_batch"),
    "gpt2 dropout remat": ("gpt2", {"dropout": 0.1},
                           {"activation_checkpointing": {}}, "train_batch"),
    "llama bf16": ("llama", {}, {"bf16": {"enabled": True}}, "train_batch"),
    "bert dropout remat": ("bert", {"dropout": 0.1},
                           {"activation_checkpointing": {}}, "train_batch"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_stages_1_to_3_are_stage_0_bit_for_bit(name):
    family, kw, extra, loop = CASES[name]
    ref_losses, ref_state, _ = _run(family, 0, _kw(family, **kw), extra,
                                    loop)
    for stage in (1, 2, 3):
        losses, state, engine = _run(family, stage, _kw(family, **kw),
                                     extra, loop)
        assert losses == ref_losses, stage
        assert all(torch.equal(a, b) for a, b in zip(state, ref_state)), \
            stage
        assert engine._stage == stage
        if stage == 3:
            stats = engine.zero_gather_stats
            assert stats.gathers > 0 and stats.live == 0
            assert all(p.numel() == 0 for p in engine.module.parameters())


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_one_rank_runs_stage_0_with_one_set_of_masters(stage):
    """The planner partitions nothing on one rank: the engine runs stage 0
    (no second copy of the masters, the model's parameters kept), bit for
    bit stage 0's run."""
    family, kw, extra, loop = CASES["gpt2 bf16 user loop"]
    ref_losses, ref_state, _ = _run(family, 0, _kw(family, **kw), extra,
                                    loop, one_rank=False)
    losses, state, engine = _run(family, stage, _kw(family, **kw), extra,
                                 loop, one_rank=False)
    assert engine.zero_stage == stage and engine._stage == 0
    assert not any(ps.partitioned for ps in engine._pshards)
    assert all(m is p for m, p in zip(engine._masters, engine._params))
    assert engine.zero_gather_stats.gathers == 0
    assert losses == ref_losses
    assert all(torch.equal(a, b) for a, b in zip(state, ref_state))


def test_gathered_parameters_reads_and_writes_back_at_stage3():
    with torch_dist_worker.one_rank_planner():
        engine = deepspeed_tpu_torch.initialize(
            model=torch_dist_worker.model("gpt2", _kw("gpt2")),
            config=_config(3), device="cpu")[0]
    assert engine._stage == 3
    with zero.GatheredParameters(engine) as tree:
        assert tree["blocks"]["qkv_w"].shape == (2, 64, 192)
        before = tree["blocks"]["qkv_w"].copy()
    with zero.GatheredParameters(engine, modifier_rank=0) as tree:
        tree["blocks"]["qkv_w"][1, 3] = 7.0
    got = tf.safe_get_full_fp32_param(engine, "blocks/qkv_w")
    want = before.copy()
    want[1, 3] = 7.0
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="ENGINE"):
        with zero.GatheredParameters({"w": torch.ones(2)}, modifier_rank=0):
            pass
    with zero.GatheredParameters({"w": torch.ones(2)}) as tree:
        assert isinstance(tree["w"], np.ndarray)
    with zero.Init():
        pass
    with pytest.raises(ValueError):
        zero.Init(no_such_arg=1)


def test_tensor_fragment_matches_the_jax_package():
    """On a dp-1 engine of each package from the same weights: the whole
    gradient between ``backward`` and ``step`` (the user loop), the
    moments after it, and a master set by path."""
    kw, jcfg, jcls = torch_pairs.FAMILIES["gpt2"][:3]
    kw = {k: v for k, v in kw.items() if k != "dtype"}
    cfg = _config(2)
    jax_engine = deepspeed_tpu.initialize(
        model=jcls(jcfg(**dict(kw, attn_backend="xla"))), config=cfg,
        mesh_manager=initialize_mesh(dp=1, devices=jax.devices("cpu")[:1]))[0]
    engine = deepspeed_tpu_torch.initialize(
        model=torch_dist_worker.model("gpt2", kw, jax.tree.map(
            np.asarray, jax_engine.params)), config=cfg, device="cpu")[0]
    batch = _batches("gpt2")[0]
    for i in range(GAS):
        mb = {k: v[i] for k, v in batch.items()}
        jax_engine.backward(jax_engine.forward(mb))
        engine.backward(engine(mb))
    assert tf.list_param_paths(engine) == jtf.list_param_paths(jax_engine)
    for path in ("wte", "blocks/qkv_w", "blocks/ln1_scale"):
        np.testing.assert_allclose(tf.safe_get_full_grad(engine, path),
                                   jtf.safe_get_full_grad(jax_engine, path),
                                   atol=1e-6, rtol=1e-4, err_msg=path)
    jax_engine.step()
    engine.step()
    for name in ("exp_avg", "exp_avg_sq"):
        np.testing.assert_allclose(
            tf.safe_get_full_optimizer_state(engine, "blocks/mlp_fc_w", name),
            jtf.safe_get_full_optimizer_state(jax_engine, "blocks/mlp_fc_w",
                                              name), atol=1e-7, rtol=1e-4)
    assert tf.safe_get_full_grad(engine, "wte") is None
    value = np.full((2, 64), 0.5, np.float32)
    tf.safe_set_full_fp32_param(engine, "blocks/ln1_scale", value)
    np.testing.assert_array_equal(
        tf.safe_get_full_fp32_param(engine, "blocks/ln1_scale"), value)
    with pytest.raises(KeyError):
        tf.safe_get_full_fp32_param(engine, "no_such_leaf")


@pytest.mark.parametrize("out_axis", [True, False])
def test_tiled_linear_matches_the_jax_function(out_axis):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    w = rng.standard_normal((3, 12, 4) if out_axis else (3, 4, 8)
                            ).astype(np.float32)
    b = rng.standard_normal((3, 4) if out_axis else (3, 8)).astype(np.float32)
    want = np.asarray(jtiling.tiled_linear(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(b), out_axis))
    got = tiling.tiled_linear(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), out_axis).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    w2, b2 = w.reshape(12, -1), b.reshape(-1)[:w.size // 12]
    np.testing.assert_allclose(
        tiling.zero_linear(torch.from_numpy(x), torch.from_numpy(w2),
                           torch.from_numpy(b2)).numpy(),
        np.asarray(jtiling.zero_linear(jnp.asarray(x), jnp.asarray(w2),
                                       jnp.asarray(b2))),
        atol=1e-5, rtol=1e-5)
    layer = tiling.TiledLinear(12, 8, splits=2)
    assert layer(torch.from_numpy(x)).shape == (2, 5, 8)
