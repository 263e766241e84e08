"""Checkpoints of the port held against the JAX package's on the CPU: a tag
written by either package loads in the other and the run continues as the
writer's own continuation does (float32, within 1e-5); a JAX tag re-saved
by the port is byte for byte the JAX package's files; the port's own
resume is bitwise an uninterrupted run, through ``train_batch``, through
the user loop with dropout, progressive layer drop and random-LTD, and
with fp16 loss-scaler state. Small sizes: GPT-2 and LLaMA at 2 layers,
width 64."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
import torch_pairs
from deepspeed_tpu.elasticity import logical as jlogical
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu.resilience import CheckpointLoadError as JaxLoadError
from deepspeed_tpu.runtime import checkpointing as jckpt
from deepspeed_tpu_torch.elasticity import logical as tlogical
from deepspeed_tpu_torch.resilience import CheckpointLoadError
from deepspeed_tpu_torch.runtime import checkpointing as tckpt
from deepspeed_tpu_torch.runtime.config_utils import ConfigError

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO, GAS, T = 2, 2, 32
BASE = {"train_batch_size": MICRO * GAS,
        "train_micro_batch_size_per_gpu": MICRO,
        "gradient_accumulation_steps": GAS,
        "optimizer": {"type": "adamw",
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                                 "warmup_num_steps": 3}},
        "gradient_clipping": 1.0, "steps_per_print": 0}
ATOL = 1e-5
STATE_FILES = ("model_states.msgpack", "optim_states.msgpack")


def _kw(family, **over):
    kw = {k: v for k, v in torch_pairs.FAMILIES[family][0].items()
          if k != "dtype"}
    kw.update(over)
    return kw


def _jax_engine(family, config=BASE, **over):
    _, jcfg, jcls, _, _ = torch_pairs.FAMILIES[family]
    return deepspeed_tpu.initialize(
        model=jcls(jcfg(**_kw(family, attn_backend="xla", **over))),
        config=config,
        mesh_manager=initialize_mesh(dp=1, devices=jax.devices("cpu")[:1]))[0]


def _port_engine(family, config=BASE, seed=0, **over):
    _, _, _, tcfg, tcls = torch_pairs.FAMILIES[family]
    model = tcls(tcfg(**_kw(family, **over)),
                 generator=torch.Generator().manual_seed(seed))
    return deepspeed_tpu_torch.initialize(model=model, config=config,
                                          device="cpu")[0]


def _batches(n, seed=0, vocab=torch_pairs.VOCAB):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (GAS, MICRO, T)).astype(
        np.int32)} for _ in range(n)]


def _port_state(engine):
    """Masters, mu and nu as JAX trees of numpy arrays."""
    def tree(ts):
        return engine.module.jax_tree([t.detach().numpy() for t in ts],
                                      stack=np.stack)
    st = engine.opt_state
    return {"params": tree(engine._masters), "mu": tree(st.mu),
            "nu": tree(st.nu), "count": st.count}


def _jax_state(engine):
    st = engine.opt_state
    return {"params": jax.tree.map(np.asarray, engine.params),
            "mu": jax.tree.map(np.asarray, st.mu),
            "nu": jax.tree.map(np.asarray, st.nu), "count": int(st.count)}


def _assert_close(got, want, atol=ATOL):
    assert got["count"] == want["count"]
    for part in ("params", "mu", "nu"):
        g, w = tlogical.leaf_paths(got[part]), tlogical.leaf_paths(want[part])
        assert g == w
        flat_g = dict(tlogical._leaves(got[part]))
        flat_w = dict(tlogical._leaves(want[part]))
        for path in flat_w:
            np.testing.assert_allclose(flat_g[path], flat_w[path],
                                       atol=atol, rtol=0,
                                       err_msg=f"{part}/{path}")


def _assert_bitwise(a, b):
    for x, y in zip(a._masters + a.opt_state.mu + a.opt_state.nu,
                    b._masters + b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x, y)
    assert a.opt_state.count == b.opt_state.count
    for key in ("global_steps", "global_samples", "micro_steps",
                "skipped_steps", "_base_rng"):
        assert getattr(a, key) == getattr(b, key), key
    assert a.get_lr() == b.get_lr()
    assert a.scaler_state == b.scaler_state


# ---------------------------------------------------------------- packages

@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_jax_tag_resumes_in_the_port(tmp_path, family):
    """The JAX engine trains 2 steps and saves; the port loads the tag and
    trains 2 more; its masters and moments match the JAX engine's own
    continuation."""
    batches = _batches(4)
    jax_engine = _jax_engine(family)
    for b in batches[:2]:
        jax_engine.train_batch(batch=b)
    jax_engine.save_checkpoint(tmp_path)
    port = _port_engine(family, seed=7)
    path, client = port.load_checkpoint(tmp_path)
    assert path.endswith("global_step2") and client == {}
    assert (port.global_steps, port.micro_steps) == (2, 4)
    assert port._base_rng == tuple(int(w) for w in np.asarray(
        jax_engine._base_rng))
    for b in batches[2:]:
        jax_engine.train_batch(batch=b)
        port.train_batch(batch=b)
    _assert_close(_port_state(port), _jax_state(jax_engine))
    assert port.get_lr() == pytest.approx(jax_engine.get_lr())


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_port_tag_resumes_in_jax(tmp_path, family):
    batches = _batches(4, seed=1)
    port = _port_engine(family, seed=3)
    for b in batches[:2]:
        port.train_batch(batch=b)
    port.save_checkpoint(tmp_path, client_state={"epoch": 3})
    jax_engine = _jax_engine(family)
    path, client = jax_engine.load_checkpoint(tmp_path)
    assert client == {"epoch": 3} and jax_engine.global_steps == 2
    for b in batches[2:]:
        jax_engine.train_batch(batch=b)
        port.train_batch(batch=b)
    _assert_close(_port_state(port), _jax_state(jax_engine))


def test_jax_tag_resaved_by_the_port_is_byte_identical(tmp_path):
    jax_engine = _jax_engine("gpt2")
    for b in _batches(2, seed=2):
        jax_engine.train_batch(batch=b)
    jax_engine.save_checkpoint(tmp_path / "jax")
    port = _port_engine("gpt2", seed=9)
    port.load_checkpoint(tmp_path / "jax")
    port.save_checkpoint(tmp_path / "port")
    tag = "global_step2"
    names = sorted(os.listdir(tmp_path / "jax" / tag))
    assert names == sorted(os.listdir(tmp_path / "port" / tag))
    assert set(STATE_FILES) <= set(names)
    for name in names:     # the manifest too: every hash is equal
        assert (tmp_path / "jax" / tag / name).read_bytes() == \
            (tmp_path / "port" / tag / name).read_bytes(), name


def test_leaf_drift_raises_with_the_jax_leaf_diff(tmp_path):
    port = _port_engine("gpt2")
    port.train_batch(batch=_batches(1)[0])
    port.save_checkpoint(tmp_path)
    deeper = _port_engine("gpt2", n_layer=3)
    with pytest.raises(CheckpointLoadError) as ei:
        deeper.load_checkpoint(tmp_path)
    jax_deeper = _jax_engine("gpt2", n_layer=3)
    saved = jckpt.get_fp32_state_dict_from_checkpoint(
        str(tmp_path / "global_step1"))
    want = jlogical.leaf_diff(jax_deeper.param_shapes, saved)
    assert ei.value.leaf_diff == want and want["shape_mismatch"]
    with pytest.raises(JaxLoadError) as ei2:
        jax_deeper.load_checkpoint(tmp_path)
    assert ei2.value.leaf_diff == ei.value.leaf_diff
    assert deeper.global_steps == 0      # nothing moved


# ------------------------------------------------------------- port resume

def test_resume_through_train_batch_is_bitwise(tmp_path):
    batches = _batches(4, seed=4)
    whole = _port_engine("llama")
    for b in batches:
        whole.train_batch(batch=b)
    first = _port_engine("llama")
    for b in batches[:2]:
        first.train_batch(batch=b)
    first.save_checkpoint(tmp_path)
    resumed = _port_engine("llama", seed=11)   # other initial weights
    resumed.load_checkpoint(tmp_path)
    for b in batches[2:]:
        resumed.train_batch(batch=b)
    _assert_bitwise(resumed, whole)


LOOP = dict(BASE,
            progressive_layer_drop={"enabled": True, "theta": 0.5,
                                    "gamma": 0.1},
            data_efficiency={"enabled": True, "data_routing": {
                "enabled": True, "random_ltd": {
                    "enabled": True, "random_ltd_schedule": {
                        "min_value": 16, "max_value": 32,
                        "schedule_config": {"seq_per_step": 8,
                                            "require_steps": 4}}}}})


def _loop_steps(engine, batches):
    out = []
    for b in batches:
        for micro in b["input_ids"]:
            loss = engine({"input_ids": torch.as_tensor(micro).long()})
            engine.backward(loss)
        engine.step()
        out.append((loss.item(), engine._last_modifiers))
    return out


def test_resume_through_the_user_loop_with_dropout_pld_ltd_is_bitwise(
        tmp_path):
    """Keys, layer coins and kept-token indices continue across the
    resume: dropout 0.1, progressive layer drop, random-LTD."""
    batches = _batches(4, seed=5)
    whole = _port_engine("gpt2", LOOP, dropout=0.1)
    want = _loop_steps(whole, batches)
    first = _port_engine("gpt2", LOOP, dropout=0.1)
    _loop_steps(first, batches[:2])
    first.save_checkpoint(tmp_path)
    resumed = _port_engine("gpt2", LOOP, seed=12, dropout=0.1)
    resumed.load_checkpoint(tmp_path)
    got = _loop_steps(resumed, batches[2:])
    assert got == want[2:]
    assert want[2][1][1] != want[0][1][1]       # the LTD schedule moved
    _assert_bitwise(resumed, whole)


def test_resume_with_fp16_loss_scaler_state_is_bitwise(tmp_path):
    cfg = dict(BASE, fp16={"enabled": True, "initial_scale_power": 40,
                           "loss_scale_window": 2, "hysteresis": 1})
    batches = _batches(5, seed=6)
    whole = _port_engine("gpt2", cfg)
    for b in batches:
        whole.train_batch(batch=b)
    first = _port_engine("gpt2", cfg)
    for b in batches[:3]:
        first.train_batch(batch=b)
    assert first.skipped_steps > 0              # the scaler has moved
    first.save_checkpoint(tmp_path)
    resumed = _port_engine("gpt2", cfg, seed=13)
    resumed.load_checkpoint(tmp_path)
    assert resumed.scaler_state == first.scaler_state
    for b in batches[3:]:
        resumed.train_batch(batch=b)
    _assert_bitwise(resumed, whole)


# ------------------------------------------------------------------ options

def test_load_options_and_client_state(tmp_path):
    src = _port_engine("gpt2")
    for b in _batches(3, seed=7):
        src.train_batch(batch=b)
    src.save_checkpoint(tmp_path, client_state={"epoch": 2, "it": [1, 2]})

    only = _port_engine("gpt2", seed=5)
    mu0 = [m.clone() for m in only.opt_state.mu]
    _, client = only.load_checkpoint(tmp_path, load_module_only=True)
    assert client == {"epoch": 2, "it": [1, 2]}
    assert all(torch.equal(a, b) for a, b in zip(only._masters, src._masters))
    assert only.global_steps == 0 and only.opt_state.count == 0
    assert all(torch.equal(a, b) for a, b in zip(only.opt_state.mu, mu0))

    no_opt = _port_engine("gpt2", seed=5)
    no_opt.load_checkpoint(tmp_path, load_optimizer_states=False)
    assert no_opt.global_steps == 3 and no_opt.opt_state.count == 0
    assert no_opt.lr_scheduler.last_batch_iteration == \
        src.lr_scheduler.last_batch_iteration

    no_sched = _port_engine("gpt2", seed=5)
    no_sched.load_checkpoint(tmp_path, load_lr_scheduler_states=False)
    assert no_sched.opt_state.count == 3
    assert no_sched.lr_scheduler.last_batch_iteration == -1
    assert [h["kind"] for h in no_sched._ckpt_history] == ["load"]
    assert src._last_save_dir == str(tmp_path)
    assert src._ckpt_history[-1]["bytes"] > 0


def test_fp32_params_16bit_export_and_the_jax_reader(tmp_path):
    cfg = dict(BASE, bf16={"enabled": True})
    port = _port_engine("gpt2", cfg)
    port.train_batch(batch=_batches(1)[0])
    tree = port.get_fp32_params()
    assert torch.equal(tree["blocks"]["qkv_w"][1], port.module.blocks[1].qkv_w)
    path = port.save_16bit_model(str(tmp_path))
    from flax import serialization
    with open(path, "rb") as f:
        got = serialization.msgpack_restore(f.read())
    assert str(got["wte"].dtype) == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(got["blocks"]["qkv_w"], np.float32),
        torch.stack([b.qkv_w for b in port.module.blocks]).detach().to(
            torch.bfloat16).float().numpy())


def test_config_blocks_parse_and_refuse_as_documented(tmp_path, caplog):
    port = _port_engine("gpt2", dict(
        BASE, checkpoint={"tag_validation": "Fail", "async_save": True},
        load_universal_checkpoint=True,
        resilience={"keep_last_n": 2, "sentinel_policy": "off",
                    "autosave_interval": 0}))
    port.train_batch(batch=_batches(1)[0])
    port.save_checkpoint(tmp_path)            # async_save: msgpack, warned
    assert (tmp_path / "global_step1" / "model_states.msgpack").is_file()
    with pytest.raises(ConfigError):
        _port_engine("gpt2", dict(BASE, checkpoint={"tag_validation": "x"}))
    for block in ({"handle_signals": True},
                  {"emergency_checkpoint_dir": "/x"},
                  {"autosave_interval": 5, "autosave_dir": "/x"},
                  {"sentinel_policy": "rollback"}):
        with pytest.raises(NotImplementedError, match="row A12$"):
            _port_engine("gpt2", dict(BASE, resilience=block))


def test_orbax_layout_tag_names_its_layout(tmp_path):
    tag = tmp_path / "global_step1"
    (tag / "model_states.msgpack").mkdir(parents=True)
    (tmp_path / "latest").write_text("global_step1")
    with pytest.raises(CheckpointLoadError, match="orbax"):
        _port_engine("gpt2").load_checkpoint(tmp_path)
    with pytest.raises(CheckpointLoadError, match="orbax"):
        tckpt.get_fp32_state_dict_from_checkpoint(str(tag))


# ------------------------------------------------------------ zero_to_fp32

_BLOCK_JAX = (
    "import sys\n"
    "class _Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        top = name.split('.')[0]\n"
    "        if top in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack',\n"
    "                   'deepspeed_tpu'):\n"
    "            raise ImportError(f'blocked: {name}')\n"
    "sys.meta_path.insert(0, _Block())\n"
    "sys.argv = sys.argv[1:]\n"
    "import runpy\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n")


def test_zero_to_fp32_without_jax_writes_the_jax_scripts_bytes(tmp_path):
    jax_engine = _jax_engine("gpt2")
    jax_engine.train_batch(batch=_batches(1)[0])
    jax_engine.save_checkpoint(tmp_path / "jax")
    jax_engine.save_checkpoint(tmp_path / "port")    # the same tag twice
    port = _port_engine("gpt2")
    port.load_checkpoint(tmp_path / "port")
    port.save_checkpoint(tmp_path / "port")          # rewrites the script
    script = (tmp_path / "port" / "zero_to_fp32.py").read_text()
    assert "deepspeed_tpu_torch" in script
    assert "from flax" not in script and "import flax" not in script
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out_port = tmp_path / "port.msgpack"
    res = subprocess.run(
        [sys.executable, "-c", _BLOCK_JAX, str(tmp_path / "port" /
                                               "zero_to_fp32.py"),
         str(tmp_path / "port"), str(out_port)],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    from flax import serialization
    want = serialization.msgpack_serialize(
        jckpt.get_fp32_state_dict_from_checkpoint(
            str(tmp_path / "jax" / "global_step1")))
    assert out_port.read_bytes() == want


def test_checkpoint_modules_import_no_jax_flax_or_msgpack():
    code = (
        "import importlib, sys\n"
        "names = ['runtime.checkpointing', "
        "'runtime.checkpoint_engine.msgpack_codec', "
        "'runtime.checkpoint_engine.checkpoint_engine', "
        "'runtime.checkpoint_engine.nebula_checkpoint_engine', "
        "'resilience', 'resilience.manifest', 'elasticity.logical', "
        "'checkpoint.megatron', 'module_inject.policy']\n"
        "for n in names:\n"
        "    importlib.import_module('deepspeed_tpu_torch.' + n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'deepspeed_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
