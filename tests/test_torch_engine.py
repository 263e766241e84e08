"""The port's training engine held against the JAX package's on the CPU.

Both engines start from the same weights (the JAX engine's initial
parameters, loaded into the port's model) and take the same batches; the
losses per step and the final parameters are compared. The pieces under
the engine (optimizer, loss scaler, schedules, config parsing) are
compared one by one on small inputs."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxConfig
from deepspeed_tpu.models.gpt2 import GPT2Model as JaxModel
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime import dataloader as jdata
from deepspeed_tpu.runtime import lr_schedules as jsched
from deepspeed_tpu.runtime import optimizers as jopt
from deepspeed_tpu.runtime.fp16 import loss_scaler as jscaler
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as tfa
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime import dataloader as tdata
from deepspeed_tpu_torch.runtime import lr_schedules as tsched
from deepspeed_tpu_torch.runtime import optimizers as topt
from deepspeed_tpu_torch.runtime.config_utils import ConfigError
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tscaler

SMALL = dict(vocab_size=250, n_positions=128, n_embd=128, n_layer=2,
             n_head=2, pad_vocab_to_multiple=128)
MICRO, GAS, T = 2, 2, 128
BASE = {"train_batch_size": MICRO * GAS,
        "train_micro_batch_size_per_gpu": MICRO,
        "gradient_accumulation_steps": GAS,
        "optimizer": {"type": "adamw",
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                                 "warmup_num_steps": 3}},
        "gradient_clipping": 1.0, "steps_per_print": 0}


def _engines(config):
    """The JAX engine on one CPU device and the port's engine, from the
    JAX engine's initial weights."""
    jax_engine = deepspeed_tpu.initialize(
        model=JaxModel(JaxConfig(**dict(SMALL, attn_backend="xla"))),
        config=config,
        mesh_manager=initialize_mesh(dp=1, devices=jax.devices("cpu")[:1]))[0]
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**dict(SMALL,
                                                    attn_backend="pallas")))
    model.load_jax_params(jax.tree.map(np.asarray, jax_engine.params))
    engine, optimizer, loader, scheduler = deepspeed_tpu_torch.initialize(
        model=model, config=config, device="cpu")
    assert optimizer is engine.optimizer and scheduler is engine.lr_scheduler
    assert loader is None
    return jax_engine, engine


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, SMALL["vocab_size"],
                                       (GAS, MICRO, T)).astype(np.int32)}
            for _ in range(n)]


def _port_tree(engine):
    return tgpt2.GPT2Model.jax_params(engine.module)


def _assert_trees_close(got, want, atol, rtol=0):
    for name in tgpt2.GPT2Model.top_leaves:
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   atol=atol, rtol=rtol, err_msg=name)
    for name in tgpt2.GPT2Model.block_leaves:
        np.testing.assert_allclose(got["blocks"][name],
                                   np.asarray(want["blocks"][name]),
                                   atol=atol, rtol=rtol, err_msg=name)


def test_fp32_trajectory_matches_jax_engine():
    """Five steps of fp32 AdamW (decay 0.01), WarmupLR, clipping 1.0 and
    gas 2: three from batches, two drawn through each package's own
    ``RepeatingLoader(DeepSpeedDataLoader)``. Losses and final params
    within 1e-5 (f32 on both sides, sums in another order)."""
    jax_engine, engine = _engines(BASE)
    batches = _batches(3)
    rng = np.random.default_rng(7)
    data = {"input_ids": rng.integers(0, SMALL["vocab_size"],
                                      (2 * GAS * MICRO, T)).astype(np.int32)}
    j_iter = jdata.RepeatingLoader(jax_engine.deepspeed_io(data))
    t_iter = tdata.RepeatingLoader(engine.deepspeed_io(data))
    before = tfa.packed_flash_attention_bwd.launches
    for step in range(5):
        if step < 3:
            want = jax_engine.train_batch(batch=batches[step])
            got = engine.train_batch(batch=batches[step])
        else:
            want = jax_engine.train_batch(data_iter=j_iter)
            got = engine.train_batch(data_iter=t_iter)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                                   err_msg=f"step {step}")
        assert engine.get_lr() == pytest.approx(jax_engine.get_lr())
    assert tfa.packed_flash_attention_bwd.launches == before  # CPU: plain
    assert engine.global_steps == jax_engine.global_steps == 5
    assert engine.global_samples == jax_engine.global_samples
    assert engine.micro_steps == jax_engine.micro_steps == 5 * GAS
    assert engine.skipped_steps == 0
    assert np.isfinite(float(engine.get_global_grad_norm()))
    _assert_trees_close(_port_tree(engine), jax_engine.params, atol=1e-5)
    assert all(p.dtype == torch.float32 for p in engine.module.parameters())


def test_bf16_trajectory_matches_jax_engine():
    """Three bf16 steps on fp32 masters. The two packages round bf16
    activations at other points (and the JAX side takes its plain
    attention), so a loss agrees to ~1e-2 relative; Adam's first updates
    are near ±lr (1e-3 at most here) per element, so masters agree within
    two updates' size."""
    jax_engine, engine = _engines(dict(BASE, bf16={"enabled": True}))
    for batch in _batches(3, seed=1):
        want = jax_engine.train_batch(batch=batch)
        got = engine.train_batch(batch=batch)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-2)
    assert engine.module.wte.dtype == torch.float32
    _assert_trees_close(_port_tree(engine), jax_engine.params, atol=2e-3)


def test_fp16_overflow_skips_and_backs_off_as_jax():
    """A loss scale of 2^40 overflows f16 gradients in both packages: every
    step is skipped, the masters stay put, the scale backs off after the
    hysteresis of 2 is used up."""
    config = dict(BASE, fp16={"enabled": True, "initial_scale_power": 40})
    jax_engine, engine = _engines(config)
    start = _port_tree(engine)
    for batch in _batches(3, seed=2):
        jax_engine.train_batch(batch=batch)
        engine.train_batch(batch=batch)
        assert engine.cur_scale == jax_engine.cur_scale
        assert engine.skipped_steps == jax_engine.skipped_steps
    assert engine.skipped_steps == 3 and engine.cur_scale == 2.0 ** 39
    assert engine.get_lr() == pytest.approx(jax_engine.get_lr())
    _assert_trees_close(_port_tree(engine), start, atol=0)


@pytest.mark.parametrize("name", ["adam", "adamw", "fusedadam", "cpu_adam"])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_adam_family_matches_jax(name, bias_correction):
    params_cfg = {"lr": 3e-3, "betas": (0.8, 0.95), "eps": 1e-6,
                  "weight_decay": 0.05, "bias_correction": bias_correction}
    rng = np.random.default_rng(3)
    params = [rng.standard_normal(s).astype(np.float32)
              for s in ((4, 5), (7,))]
    j = jopt.get_optimizer(name, params_cfg)
    t = topt.get_optimizer(name, params_cfg)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    js, ts = j.init(jp), t.init(tp)
    for step in range(3):
        grads = [rng.standard_normal(p.shape).astype(np.float32)
                 for p in params]
        jp, js = j.update([jnp.asarray(g) for g in grads], js, jp, 2e-3)
        tp, ts = t.update([torch.from_numpy(g) for g in grads], ts, tp, 2e-3)
    assert t.defaults == j.defaults and t.name == j.name
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


def test_loss_scaler_matches_jax():
    for fp16 in ({"enabled": True, "hysteresis": 2},
                 {"enabled": True, "loss_scale": 128.0},
                 {"enabled": True, "initial_scale_power": 4,
                  "hysteresis": 1}):
        jcfg = jconfig.FP16Config.from_dict(fp16)
        tcfg = tconfig.FP16Config.from_dict(fp16)
        js = jscaler.init_loss_scale_state(jcfg)
        ts = tscaler.init_loss_scale_state(tcfg)
        pattern = [True, False, False, True, True, True, False, True, True]
        for finite in pattern:
            kw = dict(dynamic=tcfg.dynamic_loss_scale, scale_window=3,
                      min_scale=2.0, max_hysteresis=tcfg.hysteresis)
            js = jscaler.update_loss_scale(js, jnp.bool_(finite), **kw)
            ts = tscaler.update_loss_scale(ts, finite, **kw)
            assert (ts.scale, ts.good_steps, ts.hysteresis) == \
                (float(js.scale), int(js.good_steps), int(js.hysteresis))
    grads = [torch.ones(3), torch.tensor([1.0, float("inf")])]
    assert not bool(tscaler.grads_finite(grads))
    assert bool(tscaler.grads_finite(grads[:1]))


@pytest.mark.parametrize("name,params", [
    ("WarmupLR", {"warmup_num_steps": 5, "warmup_max_lr": 0.01}),
    ("WarmupLR", {"warmup_num_steps": 5, "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 12, "warmup_num_steps": 4}),
    ("WarmupCosineLR", {"total_num_steps": 12, "warmup_num_steps": 4}),
    ("LRRangeTest", {"lr_range_test_step_size": 3,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_first_step_size": 4, "decay_step_size": 2,
                  "decay_lr_rate": 0.1}),
])
def test_lr_schedules_match_jax(name, params):
    j = jsched.get_lr_scheduler(name, params)
    t = tsched.get_lr_scheduler(name, params)
    for _ in range(15):
        assert t.get_last_lr() == j.get_last_lr()
        j.step()
        t.step()
    with pytest.raises(ValueError, match="not a valid LR schedule"):
        tsched.get_lr_scheduler("Nope", {})


@pytest.mark.parametrize("batch", [
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
     "gradient_accumulation_steps": 3},
    {"train_batch_size": 9, "train_micro_batch_size_per_gpu": 2},
    {"train_batch_size": 9, "gradient_accumulation_steps": 2},
    {"gradient_accumulation_steps": 2},
    {"train_batch_size": 0, "train_micro_batch_size_per_gpu": 1,
     "gradient_accumulation_steps": 0},
    {},
])
def test_batch_triangle_errors_match_jax(batch):
    with pytest.raises(Exception) as want:
        jconfig.DeepSpeedConfig(batch, world_size=1)
    with pytest.raises(ConfigError) as got:
        tconfig.DeepSpeedConfig(batch)
    assert str(got.value) == str(want.value)


def test_batch_triangle_solutions_match_jax():
    for batch in ({"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2},
                  {"train_batch_size": 8, "gradient_accumulation_steps": 4},
                  {"train_micro_batch_size_per_gpu": 3,
                   "gradient_accumulation_steps": 5},
                  {"train_batch_size": 6}, {"train_micro_batch_size_per_gpu": 5}):
        j = jconfig.DeepSpeedConfig(batch, world_size=1)
        t = tconfig.DeepSpeedConfig(batch)
        for key in ("train_batch_size", "train_micro_batch_size_per_gpu",
                    "gradient_accumulation_steps"):
            assert getattr(t, key) == getattr(j, key)


# one asking value per unported key
_ASKS = {"tensor_parallel_size": 2, "pipeline_parallel_size": 2,
         "sequence_parallel_size": 2, "expert_parallel_size": 2,
         "compression_training": {"x": 1},
         "resilience": {"handle_signals": True},
         "wall_clock_breakdown": True, "memory_breakdown": True,
         "data_efficiency": {"enabled": True,
                             "data_sampling": {"enabled": True}}}


@pytest.mark.parametrize("key", sorted(tconfig.UNPORTED))
def test_unported_config_values_raise_naming_their_row(key):
    row = tconfig.UNPORTED[key][0]
    value = _ASKS.get(key, {"enabled": True})
    with pytest.raises(NotImplementedError, match=f"row {row}$"):
        tconfig.DeepSpeedConfig(dict(BASE, **{key: value}))
    off = 1 if key.endswith("_size") else \
        False if key.endswith("breakdown") else \
        {} if key in _ASKS else {"enabled": False}
    tconfig.DeepSpeedConfig(dict(BASE, **{key: off}))   # disabled: accepted


@pytest.mark.parametrize("change,row", [
    ({"zero_optimization": {"stage": 3, "offload_optimizer": {
        "device": "cpu"}, "offload_param": {"device": "cpu"}}}, "A11"),
    ({"zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
     "A11"),
    ({"optimizer": {"type": "lamb"}}, "A11"),
    ({"hybrid_engine": {"enabled": True}}, "A12"),
    ({"lora": {"enabled": True}}, "A12"),
    ({"pipeline_parallel_size": 2}, "A11"),
])
def test_unported_training_features_raise_naming_their_row(change, row):
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL))
    with pytest.raises(NotImplementedError, match=row):
        deepspeed_tpu_torch.initialize(model=model,
                                       config=dict(BASE, **change),
                                       device="cpu")


@pytest.mark.parametrize("key,block", [
    ("comm_compression", {"enabled": True, "all_gather": "int8",
                          "reduce_scatter": "fp8_block", "block_size": 64,
                          "devices_per_host": 2}),
    ("overlap_schedule", {"enabled": True, "bucket_bytes": 1 << 16,
                          "overlap": False, "pin_order": False})])
def test_a8c_blocks_parse_as_the_jax_config(key, block):
    """``comm_compression`` and ``overlap_schedule`` (once refused naming
    row A8c) parse into the JAX package's dataclasses, field for field;
    disabled, or ``enabled: false`` with policies set, they are
    accepted."""
    want = getattr(jconfig.DeepSpeedConfig(dict(BASE, **{key: block}),
                                           world_size=1), key)
    got = getattr(tconfig.DeepSpeedConfig(dict(BASE, **{key: block})), key)
    assert got.to_dict() == want.to_dict()
    off = tconfig.DeepSpeedConfig(dict(BASE, **{key: dict(
        block, enabled=False)}))
    assert not getattr(off, key).enabled


def test_comm_compression_policy_key_is_refused_as_the_jax_config():
    """``{"policy": ...}`` is not a key of the JAX block: ``initialize``
    refuses it with the JAX package's ``ConfigError`` text."""
    change = {"comm_compression": {"policy": "int8"}}
    with pytest.raises(Exception) as jerr:
        jconfig.DeepSpeedConfig(dict(BASE, **change), world_size=1)
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL))
    from deepspeed_tpu_torch.runtime.config_utils import ConfigError
    with pytest.raises(ConfigError) as terr:
        deepspeed_tpu_torch.initialize(model=model,
                                       config=dict(BASE, **change),
                                       device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_engine_surface_and_what_it_refuses():
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL))
    with pytest.raises(NotImplementedError, match="A11"):
        deepspeed_tpu_torch.initialize(model=model, config=BASE,
                                       optimizer=object(), device="cpu")
    with pytest.raises(ConfigError, match="sparse_gradients"):
        deepspeed_tpu_torch.initialize(
            model=model, config=dict(BASE, sparse_gradients=True),
            device="cpu")
    with pytest.raises(ValueError, match="config"):
        deepspeed_tpu_torch.initialize(model=model, device="cpu")
    data = {"input_ids": np.zeros((8, T), np.int64)}
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=BASE, training_data=data, device="cpu")
    assert isinstance(loader, tdata.DeepSpeedDataLoader)
    assert loader is engine.training_dataloader
    assert len(list(loader)) == 8 // MICRO
    # checkpoints are ported: an empty directory has nothing to load
    from deepspeed_tpu_torch.resilience import CheckpointLoadError
    with pytest.raises(CheckpointLoadError, match="latest"):
        engine.load_checkpoint("x")
    # the user loop: nothing to step yet
    with pytest.raises(RuntimeError, match="without backward"):
        engine.step()
    assert not engine.is_gradient_accumulation_boundary()
    assert engine.train_batch_size == MICRO * GAS
    assert engine.gradient_accumulation_steps == GAS
    assert engine.train_micro_batch_size_per_gpu == MICRO
    assert not engine.zero_optimization() and engine.cur_scale == 1.0
    assert not engine.fp16_enabled() and not engine.bfloat16_enabled()
    ids = torch.randint(0, SMALL["vocab_size"], (MICRO, T),
                        generator=torch.Generator().manual_seed(0))
    loss = engine.eval_batch({"input_ids": ids})
    assert loss.dtype == torch.float32 and np.isfinite(loss.item())
    assert engine.global_steps == 0


def test_initialize_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    model = tgpt2.GPT2Model(tgpt2.GPT2Config(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(model=model, config=BASE)
