"""Serving from checkpoints, port against the JAX package on the CPU:
``init_inference(model, {"checkpoint": dir})`` on a tag the JAX engine
wrote serves the JAX ``InferenceEngine``'s greedy streams bit for bit, at
the same ``weights_version``; ``load_version`` stands up a view without
touching the serving engine; and the Megatron-LM loader builds the JAX
package's tree bit for bit for every qkv version and tp/pp layout of
``tests/unit/test_megatron_ckpt.py``, served by ``init_inference(dir)``."""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
import torch_pairs
from deepspeed_tpu.checkpoint.megatron import \
    load_megatron_checkpoint as jax_load_megatron
from deepspeed_tpu.inference import config as jconfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu_torch.checkpoint.megatron import load_megatron_checkpoint
from deepspeed_tpu_torch.elasticity.logical import _leaves
from deepspeed_tpu_torch.resilience import CheckpointLoadError
from unit.test_megatron_ckpt import _full_tensors, _write_ckpt

TRAIN = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
         "gradient_accumulation_steps": 2,
         "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
         "steps_per_print": 0}
F32 = {"dtype": "float32"}


def _jax_tag(family, path, seed=0, steps=1):
    """A tag the JAX engine writes after ``steps`` steps from the family's
    random tree."""
    kw, jcfg, jcls, _, _ = torch_pairs.FAMILIES[family]
    engine = deepspeed_tpu.initialize(
        model=jcls(jcfg(**dict(kw, attn_backend="xla"))), config=TRAIN,
        mesh_manager=initialize_mesh(dp=1, devices=jax.devices("cpu")[:1]))[0]
    engine.params = jax.tree.map(jax.numpy.asarray,
                                 torch_pairs.tree(family, seed))
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        engine.train_batch(batch={"input_ids": rng.integers(
            0, torch_pairs.VOCAB, (2, 2, 24)).astype(np.int32)})
    engine.save_checkpoint(path)
    return engine


def _prompts(seed=1, n=3, t=12):
    return np.random.default_rng(seed).integers(
        0, torch_pairs.VOCAB, (n, t)).astype(np.int32)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_serving_a_jax_tag_streams_as_the_jax_engine(tmp_path, family):
    _jax_tag(family, tmp_path, steps=2)
    kw, jcfg, jcls, tcfg, tcls = torch_pairs.FAMILIES[family]
    cfg = dict(F32, checkpoint=str(tmp_path))
    want_engine = JaxEngine(jcls(jcfg(**kw)),
                            jconfig.DeepSpeedInferenceConfig.from_dict(cfg))
    got_engine = deepspeed_tpu_torch.init_inference(
        tcls(tcfg(**kw), generator=torch.Generator().manual_seed(5)), cfg,
        device="cpu")
    assert got_engine.weights_version == want_engine.weights_version == 1
    ids = _prompts()
    want = np.asarray(want_engine.generate(ids, max_new_tokens=8))
    got = got_engine.generate(torch.from_numpy(ids).long(),
                              max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)
    tree = got_engine.module.jax_params()
    for path, leaf in _leaves(jax.tree.map(np.asarray, want_engine.params)):
        got_leaf = dict(_leaves(tree))[path]
        np.testing.assert_array_equal(got_leaf, leaf, err_msg=str(path))


def test_bf16_serving_casts_each_leaf_and_load_version_is_a_view(tmp_path):
    _jax_tag("gpt2", tmp_path / "a", seed=0)
    _jax_tag("gpt2", tmp_path / "b", seed=3)
    kw, _, _, tcfg, tcls = torch_pairs.FAMILIES["gpt2"]
    kw = dict(kw, dtype="bfloat16")
    engine = deepspeed_tpu_torch.init_inference(
        tcls(tcfg(**kw)), {"dtype": "bf16", "checkpoint": str(tmp_path / "a")},
        device="cpu")
    masters = engine.module.jax_params()
    saved = deepspeed_tpu_torch.runtime.checkpointing \
        .get_fp32_state_dict_from_checkpoint(str(tmp_path / "a" /
                                                  "global_step1"))
    for path, leaf in _leaves(saved):
        want = torch.from_numpy(leaf).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(dict(_leaves(masters))[path], want)
    before = [p.clone() for p in engine.module.parameters()]
    view = engine.load_version(str(tmp_path / "b"))
    assert all(torch.equal(a, b) for a, b in
               zip(before, engine.module.parameters()))
    fresh = deepspeed_tpu_torch.init_inference(
        tcls(tcfg(**kw)), {"dtype": "bf16", "checkpoint": str(tmp_path / "b")},
        device="cpu")
    ids = torch.from_numpy(_prompts(2)).long()
    assert torch.equal(view.generate(ids, max_new_tokens=6),
                       fresh.generate(ids, max_new_tokens=6))
    assert view.weights_version == fresh.weights_version == 1
    assert not torch.equal(view.generate(ids, max_new_tokens=6),
                           engine.generate(ids, max_new_tokens=6))


def test_serving_refuses_a_drifted_tag_before_copying(tmp_path):
    _jax_tag("gpt2", tmp_path)
    kw, _, _, tcfg, tcls = torch_pairs.FAMILIES["gpt2"]
    engine = deepspeed_tpu_torch.init_inference(
        tcls(tcfg(**dict(kw, n_layer=3))), F32, device="cpu")
    before = [p.clone() for p in engine.module.parameters()]
    with pytest.raises(CheckpointLoadError) as ei:
        engine.load_checkpoint(str(tmp_path))
    assert len(ei.value.leaf_diff["shape_mismatch"]) == 12
    assert all(torch.equal(a, b) for a, b in
               zip(before, engine.module.parameters()))
    assert engine.weights_version == 0


# ----------------------------------------------------------------- Megatron

def _same_tree(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                      err_msg=str(k))


LAYOUTS = [(1, 1, 2.0), (2, 1, 2.0), (2, 2, 2.0), (2, 1, 0), (2, 1, 1.0),
           (2, 2, 0), (1, 1, 1.0)]


@pytest.mark.parametrize("tp,pp,version", LAYOUTS)
def test_megatron_tree_is_the_jax_packages(tmp_path, tp, pp, version):
    full = _full_tensors(np.random.default_rng(tp * 10 + pp))
    _write_ckpt(str(tmp_path), full, tp=tp, pp=pp, version=version)
    jspec, jparams = jax_load_megatron(str(tmp_path))
    spec, params = load_megatron_checkpoint(str(tmp_path))
    assert spec.config.n_layer == jspec.config.n_layer
    assert spec.config.n_head == jspec.config.n_head
    assert spec.config.padded_vocab == jspec.config.padded_vocab
    _same_tree(params, jparams)


def test_megatron_refusals_match_jax(tmp_path):
    full = _full_tensors(np.random.default_rng(4))
    _write_ckpt(str(tmp_path / "v3"), full, tp=1, version=3.0)
    for load in (jax_load_megatron, load_megatron_checkpoint):
        with pytest.raises(ValueError, match="checkpoint_version"):
            load(str(tmp_path / "v3"))
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path / "nope"))
    del full["layers.1.mlp.dense_4h_to_h.bias"]
    _write_ckpt(str(tmp_path / "torn"), full, tp=1)
    with pytest.raises(CheckpointLoadError, match="missing"):
        load_megatron_checkpoint(str(tmp_path / "torn"))


def test_megatron_moe_checkpoint_raises_naming_its_row(tmp_path):
    full = _full_tensors(np.random.default_rng(5))
    _write_ckpt(str(tmp_path), full, tp=1)
    torch.save({}, tmp_path / "layer_0_expert_0_mp_rank_00_model_states.pt")
    with pytest.raises(NotImplementedError, match="A10"):
        load_megatron_checkpoint(str(tmp_path))


def test_init_inference_serves_a_megatron_dir_as_jax(tmp_path):
    full = _full_tensors(np.random.default_rng(6))
    _write_ckpt(str(tmp_path / "grid"), full, tp=2, pp=2, version=0)
    _write_ckpt(str(tmp_path / "flat"), full, tp=1, pp=1)
    want_engine = deepspeed_tpu.init_inference(str(tmp_path / "flat"), F32)
    engines = [deepspeed_tpu_torch.init_inference(str(tmp_path / d), F32,
                                                  device="cpu")
               for d in ("grid", "flat")]
    ids = np.random.default_rng(7).integers(0, 64, (2, 6)).astype(np.int32)
    want = np.asarray(want_engine.generate(ids, max_new_tokens=6))
    for engine in engines:
        got = engine.generate(torch.from_numpy(ids).long(),
                              max_new_tokens=6).numpy()
        np.testing.assert_array_equal(got, want)
