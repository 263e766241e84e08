"""The port's inference entry points held against the JAX package on the CPU:
``init_inference`` / ``InferenceEngine.forward`` / ``generate`` and the
inference config, with the same numpy weights and prompts in both."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.inference import config as jconfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxConfig
from deepspeed_tpu.models.gpt2 import GPT2Model as JaxModel
from deepspeed_tpu.runtime.config_utils import ConfigError as JaxConfigError
from deepspeed_tpu_torch.inference import config as tconfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.runtime.config_utils import ConfigError

SMALL = dict(vocab_size=250, n_positions=256, n_embd=128, n_layer=2,
             n_head=2, pad_vocab_to_multiple=128, attn_backend="pallas")
F32 = {"dtype": "float32"}
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    cfg = JaxConfig(**SMALL)
    d, f, L = cfg.n_embd, cfg.mlp_ratio * cfg.n_embd, cfg.n_layer

    def leaf(*shape, center=0.0, std=0.02):
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


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) serving the same float32 weights."""
    tree = _tree()
    jax_engine = JaxEngine(JaxModel(JaxConfig(**SMALL)),
                           jconfig.DeepSpeedInferenceConfig.from_dict(F32),
                           params=tree)
    port = InferenceEngine(GPT2Model(GPT2Config(**SMALL)),
                           tconfig.DeepSpeedInferenceConfig.from_dict(F32),
                           params=tree, device="cpu")
    return jax_engine, port


def _prompts(b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], (b, t), dtype=np.int32)


def test_forward_matches_jax(engines):
    jax_engine, port = engines
    ids = _prompts(2, 128)
    want = np.asarray(jax_engine.forward(jnp.asarray(ids)))
    got = port(ids)
    assert got.dtype == torch.float32 and got.shape == (2, 128, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


@pytest.mark.parametrize("kind", ["plain", "eos", "left_padded",
                                  "to_n_positions"])
def test_greedy_generate_identical_to_jax(engines, kind):
    jax_engine, port = engines
    kw, mask = {"max_new_tokens": 8}, None
    prompts = _prompts(2, 12, seed=1)
    if kind == "eos":
        # stop on a token the first row really emits, so freezing happens
        first = port.generate(prompts, max_new_tokens=8).numpy()
        kw["eos_token_id"] = int(first[0, 14])
    elif kind == "left_padded":
        mask = np.ones_like(prompts)
        mask[1, :5] = 0
        prompts = np.where(mask == 1, prompts, 0).astype(np.int32)
    elif kind == "to_n_positions":
        prompts = _prompts(1, SMALL["n_positions"] - 6, seed=2)
        kw["max_new_tokens"] = 6               # prompt + new == n_positions
    want = np.asarray(jax_engine.generate(
        jnp.asarray(prompts), attention_mask=None if mask is None
        else jnp.asarray(mask), **kw))
    got = port.generate(prompts, attention_mask=mask, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    if kind == "eos":
        eos = kw["eos_token_id"]
        hit = np.argmax(got[0, 12:] == eos)
        assert (got[0, 12 + hit:] == eos).all()


@pytest.mark.parametrize("kw", [dict(temperature=0.8),
                                dict(temperature=1.3, top_k=7),
                                dict(temperature=1.0, top_p=0.9),
                                dict(temperature=0.7, top_k=40, top_p=0.95,
                                     eos_token_id=5)])
def test_sampled_generate_identical_to_jax(engines, kw):
    """Sampled streams are the JAX package's: ``PRNGKey(seed)`` draws the
    first token and a ``split`` of the running key each next one, with
    threefry2x32 ported bit for bit."""
    jax_engine, port = engines
    prompts = _prompts(3, 10, seed=4)
    for seed in (0, 17):
        want = np.asarray(jax_engine.generate(
            jnp.asarray(prompts), max_new_tokens=8, seed=seed, **kw))
        got = port.generate(prompts, max_new_tokens=8, seed=seed, **kw)
        np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_degenerates_to_greedy_and_repeats_per_seed(engines):
    _, port = engines
    prompts = _prompts(2, 12, seed=3)
    greedy = port.generate(prompts, max_new_tokens=8)
    top1 = port.generate(prompts, max_new_tokens=8, temperature=0.7,
                         top_k=1, seed=5)
    tiny_p = port.generate(prompts, max_new_tokens=8, temperature=1.0,
                           top_p=1e-6, seed=5)
    assert torch.equal(top1, greedy) and torch.equal(tiny_p, greedy)
    kw = dict(max_new_tokens=8, temperature=1.0, top_k=40, top_p=0.9)
    a = port.generate(prompts, seed=11, **kw)
    b = port.generate(prompts, seed=11, **kw)
    assert torch.equal(a, b)


def test_generate_refusals_match_jax(engines):
    jax_engine, port = engines
    prompts = _prompts(1, 250)
    bad = [dict(max_new_tokens=7),                       # past n_positions
           dict(top_p=0.0), dict(top_k=5),               # greedy + top-k
           dict(num_beams=0), dict(length_penalty=2.0),
           dict(num_beams=2, temperature=1.0)]
    for kw in bad:
        with pytest.raises(ValueError):
            jax_engine.generate(jnp.asarray(prompts), **kw)
        with pytest.raises(ValueError):
            port.generate(prompts, **kw)
    with pytest.raises(ValueError, match="LEFT padding"):
        port.generate(prompts[:, :4], attention_mask=[[1, 0, 1, 1]])
    # beam search runs; with a padded batch it raises as the JAX package's
    for engine, ids in ((jax_engine, jnp.asarray(prompts[:, :4])),
                        (port, prompts[:, :4])):
        with pytest.raises(NotImplementedError, match="beam"):
            engine.generate(ids, num_beams=2, attention_mask=[[1, 1, 1, 1]])
    assert torch.equal(port.generate(prompts, max_length=100),
                       torch.from_numpy(prompts).long())


GOOD_CONFIGS = [
    {}, {"dtype": "fp16"}, {"dtype": "torch.bfloat16"}, {"dtype": "float32"},
    {"max_out_tokens": 2048}, {"tensor_parallel": {"tp_size": 1}},
    {"tensor_parallel": {"tp_size": 2}}, {"mp_size": 2},
    {"replace_with_kernel_inject": True, "enable_cuda_graph": True},
    {"moe": True, "quant": {"enabled": False, "bits": 8}, "seed": 3,
     "compiled_cache_size": 0, "max_batch_size": 4},
    {"checkpoint": "ckpt/"},
    # int8 weight-only serving (the JAX package's; once refused here)
    {"dtype": "int8"}, {"quant": {"enabled": True}},
]
BAD_CONFIGS = [{"dtype": "int4"}, {"no_such_key": 1}, {"max_tokens": 0},
               {"tensor_parallel": {"tp_size": 0}},
               {"compiled_cache_size": -1},
               {"quant": {"enabled": True, "bits": 4}}]


def _normal(d):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            v = _normal(v)
        elif k == "dtype":
            v = str(v).replace("torch.", "") if isinstance(v, torch.dtype) \
                else jnp.dtype(v).name
        out[k] = v
    return out


@pytest.mark.parametrize("cfg", GOOD_CONFIGS)
def test_config_parses_as_jax(cfg):
    want = jconfig.DeepSpeedInferenceConfig.from_dict(cfg).to_dict()
    got = tconfig.DeepSpeedInferenceConfig.from_dict(cfg).to_dict()
    assert _normal(got) == _normal(want)


@pytest.mark.parametrize("cfg", BAD_CONFIGS)
def test_config_errors_as_jax(cfg):
    with pytest.raises(JaxConfigError):
        jconfig.DeepSpeedInferenceConfig.from_dict(cfg)
    with pytest.raises(ConfigError):
        tconfig.DeepSpeedInferenceConfig.from_dict(cfg)


def test_init_inference_entry_points():
    model = GPT2Model(GPT2Config(**SMALL))
    engine = deepspeed_tpu_torch.init_inference(model, F32, device="cpu",
                                                max_out_tokens=64)
    assert engine._config.max_tokens == 64
    assert engine.module.wte.dtype == torch.float32
    bf16 = deepspeed_tpu_torch.init_inference(model, device="cpu")
    assert bf16.module.wte.dtype == torch.bfloat16     # the default dtype
    with pytest.raises(FileNotFoundError, match="mp_rank"):
        deepspeed_tpu_torch.init_inference("megatron/ckpt", device="cpu")
    # a module that is not a port model is injected, as in the JAX
    # package: one with no policy raises the JAX policy_for's ValueError,
    # which lists the known policies
    with pytest.raises(ValueError, match="no injection policy for Linear; "
                       "known: .*GPT2LMHeadModel"):
        deepspeed_tpu_torch.init_inference(torch.nn.Linear(2, 2),
                                           device="cpu")


def test_init_inference_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.init_inference(
            GPT2Model(GPT2Config(**SMALL)), F32)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import deepspeed_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deepspeed_tpu'))\n"
        "want = {'models.bert', 'ops.sparse_attention_ops', "
        "'ops.sparse_attention_utils', 'ops.kernels.block_sparse_attention', "
        "'serving', 'serving.engine', 'serving.scheduler', "
        "'inference.prng', 'telemetry.trace', 'comm', 'comm.comm', "
        "'comm.logging', 'zero', 'parallel', 'parallel.topology', "
        "'parallel.tensor_parallel', "
        "'runtime.zero.partition', 'runtime.zero.stage3', "
        "'runtime.zero.tiling', 'utils.tensor_fragment', "
        "'module_inject', 'module_inject.policy', 'module_inject.auto_tp', "
        "'models.gpt_neox', 'models.opt', 'models.bloom', "
        "'models.gpt_neo'}\n"
        "missing = sorted(w for w in want if pkg.__name__ + '.' + w "
        "not in mods)\n"
        "print(len(mods), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(mods) < 10 else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
