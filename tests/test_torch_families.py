"""The port's OPT, BLOOM and GPT-Neo (``deepspeed_tpu_torch.models.{opt,
bloom,gpt_neo}``) held against the JAX package's on the CPU, float32,
the same numpy weights and ids through both (``torch_family_pairs``):
parameter trees, logits, the loss and every gradient, the KV-cache path
with left padding, ``generate`` (BLOOM's left-padded batches) and
``ServingEngine`` streams (BLOOM, GPT-Neo) bitwise. OPT takes GPT-2's
packed attention (K1's plain version here, the JAX package's packed
kernel in interpret mode); BLOOM's ALiBi and GPT-Neo's window are biases
that keep every layer on the plain attention, as in the JAX package.

Tensor parallelism: every family of row A10 (with GPT-NeoX and GPT-J)
on 2 gloo ranks at tp 2, in one spawn, against the JAX engine on a dp 1 x
tp 2 mesh: logits within 2e-5, a served stream of greedy and sampled
requests bitwise; GPT-J's loss and gradients through its vocab-parallel
head bias within 2e-5 of ``jax.value_and_grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker
import torch_family_pairs as fp
import torch_pairs as tp
import torch_tp_pairs as tpp
import torch_tp_worker
from deepspeed_tpu.models.bloom import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu_torch.models import bloom as tbloom, gpt_neo as tneo
from deepspeed_tpu_torch.models.opt import OPTConfig, OPTModel
from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as tfa

FAMILIES = ["opt", "bloom", "neo"]
TP_FAMILIES = ["gptj", "neox", "bloom", "opt", "neo"]
TP_ATOL = 2e-5


@pytest.mark.parametrize("family", FAMILIES)
def test_params_round_trip_and_init_shapes(family):
    fp.round_trip(family)


@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_jax(family):
    fp.logits_vs_jax(family)


def test_opt_logits_match_jax_on_the_packed_kernel_path():
    """``attn_backend="pallas"`` at 2 heads of 64 (the packed kernels'
    envelope): the JAX package's packed kernel in interpret mode, the
    port's K1 plain version once a layer (weights at a fifth of the
    deviations, as ``test_torch_gpt2``'s: the two tile their online
    softmax apart)."""
    before = tfa.packed_flash_attention_fwd.launches
    calls = []
    plain = tfa.packed_flash_attention_plain
    tfa.packed_flash_attention_plain = lambda *a, **k: \
        calls.append(a[0].shape) or plain(*a, **k)
    try:
        fp.logits_vs_jax("opt", backend="pallas", seed=6, scale=0.2,
                         n_embd=128, n_head=2)
    finally:
        tfa.packed_flash_attention_plain = plain
    assert len(calls) == fp.TINY["n_layer"]
    assert tfa.packed_flash_attention_fwd.launches == before   # the CPU


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_every_gradient_match_jax(family):
    fp.loss_and_grads_vs_jax(family)


@pytest.mark.parametrize("family", FAMILIES)
def test_cache_path_matches_jax_and_the_full_forward(family):
    fp.cache_vs_jax(family)


def test_bloom_generate_and_left_padded_batches_bitwise_jax():
    fp.generate_vs_jax(tp.engines("bloom"))


@pytest.mark.parametrize("family", ["bloom", "neo"])
def test_serving_streams_bitwise_jax(family):
    fp.serving_vs_jax(tp.engines(family))


def test_alibi_slopes_bitwise_jax():
    """The slopes as the JAX package's, bitwise (HF's
    ``build_alibi_tensor`` in ``test_torch_module_inject``); a model's
    training bias holds its heads' slopes times the key position."""
    for n in (4, 8, 6, 12, 16):
        np.testing.assert_array_equal(
            np.asarray(tbloom.alibi_slopes(n), np.float32),
            np.asarray(jax_alibi_slopes(n), np.float32))
    m = tbloom.BloomModel(tbloom.BloomConfig(**fp.TINY))
    bias = m._train_attn_bias(3, torch.device("cpu"))
    assert bias.shape == (1, 4, 1, 3)
    np.testing.assert_array_equal(bias[0, :, 0, 2].numpy(), 2 * np.asarray(
        tbloom.alibi_slopes(4), np.float32))


def test_neo_local_window_binds_on_every_path():
    """The alternating local window changes the logits against all-global
    attention (a policy mapping local layers as global would not), the
    cache path agrees with the full forward, a local layer's cache mask
    keeps exactly the window, and layers with extras keep off the
    kernels (all-global GPT-Neo has no extras)."""
    kw = dict(fp.TINY, local_window=4, attn_backend="xla")
    alt = tneo.GPTNeoModel(tneo.GPTNeoConfig(
        **kw, attention_layers=("global", "local")))
    glob = tneo.GPTNeoModel(tneo.GPTNeoConfig(
        **kw, attention_layers=("global", "global")))
    glob.load_state_dict(alt.state_dict())
    x = torch.from_numpy(fp.ids(1, 16, seed=3)).long()
    with torch.inference_mode():
        la, lg = alt.logits(x), glob.logits(x)
        assert not torch.allclose(la, lg, atol=1e-5)
        cache = alt.init_kv_cache(1, 32, dtype=torch.float32)
        ld, _ = alt.apply_with_cache(x, cache, 0)
    torch.testing.assert_close(ld, la, atol=1e-4, rtol=1e-4)
    assert alt._layer_extras() == [0.0, 1.0] and glob._layer_extras() is None
    q, k = torch.arange(8)[:, None], torch.arange(8)[None, :]
    keep = alt._decode_attn_mask_ex(q, k, 1.0)
    assert keep.sum(1).tolist() == [1, 2, 3, 4, 4, 4, 4, 4]
    assert alt._decode_attn_mask_ex(q, k, 0.0).sum(1).tolist() == \
        list(range(1, 9))
    assert alt._train_attn_bias_ex(8, 0.0, x.device).abs().max() == 0
    assert alt._train_attn_bias_ex(8, None, x.device) is None


def test_opt_contract_and_presets():
    with pytest.raises(ValueError, match="position offset 2"):
        OPTModel(OPTConfig(**dict(fp.TINY, pos_offset=0)))
    m = OPTModel(OPTConfig(**fp.TINY))
    assert m.wpe.shape[0] == fp.TINY["n_positions"] + 2


# ------------------------------------------------------ tensor parallel

@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """Every family at tp 2 on 2 gloo ranks (one spawn), and the JAX
    engine's side, computed while the ranks run."""
    cases = [tpp.family_case(f, loss=(f == "gptj")) for f in TP_FAMILIES]
    started = torch_dist_worker.start(
        torch_tp_worker.family_cases, 2,
        tmp_path_factory.mktemp("tp_families"), {"cases": cases})
    jax_side = []
    for case in cases:
        je = tpp.jax_inference(case["family"], case["tree"])
        side = {"logits": np.asarray(je(jnp.asarray(case["ids"]))),
                "serve": tpp.jax_serve(je, *case["serve"])[0]}
        if case.get("batch"):
            kw, jcfg, jcls = tp.FAMILIES[case["family"]][:3]
            jmodel = jcls(jcfg(**kw))
            jb = {k: jnp.asarray(v.astype(np.int32))
                  for k, v in case["batch"].items()}
            side["loss"], side["grads"] = jax.jit(jax.value_and_grad(
                lambda p: jmodel.apply(p, jb, rng=None, train=True)))(
                    fp.jtree(case["tree"]))
        jax_side.append(side)
    return dict(zip(TP_FAMILIES, zip(
        cases, zip(*torch_dist_worker.join(started)), jax_side)))


@pytest.mark.parametrize("family", TP_FAMILIES)
def test_tp2_logits_and_streams_match_the_jax_tp2_engine(tp_run, family):
    case, ranks, want = tp_run[family]
    for got in ranks:
        assert got["tp"] == 2
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   atol=TP_ATOL)
        assert got["serve"] == want["serve"]


def test_tp2_gptj_loss_and_grads_through_the_vocab_parallel_head_bias(
        tp_run):
    _, ranks, want = tp_run["gptj"]
    for got in ranks:
        np.testing.assert_allclose(got["loss"], float(want["loss"]),
                                   atol=TP_ATOL)
        flat = jax.tree_util.tree_leaves_with_path(want["grads"])
        for path, leaf in flat:
            keys = [p.key for p in path]
            node = got["grads"]
            for k in keys:
                node = node[k]
            np.testing.assert_allclose(node, np.asarray(leaf),
                                       atol=TP_ATOL, rtol=1e-4,
                                       err_msg="/".join(keys))
        assert np.abs(got["grads"]["lm_head_b"]).max() > 0


@pytest.mark.parametrize("family", TP_FAMILIES)
def test_trains_through_initialize(family):
    """``initialize`` -> ``train_batch`` (bf16 on f32 masters, ZeRO stage
    2, gas 2) on a repeated batch: the loss falls, as the JAX package's
    family tests check; the families without a position table hold no
    ``wpe``."""
    import deepspeed_tpu_torch
    model = fp.models(family)[1]
    engine = deepspeed_tpu_torch.initialize(model=model, config={
        "train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
        "gradient_accumulation_steps": 2, "bf16": {"enabled": True},
        "optimizer": {"type": "adamw", "params": {"lr": 3e-3}},
        "zero_optimization": {"stage": 2}}, device="cpu")[0]
    batch = {"input_ids": fp.ids(8, 16, seed=9).reshape(2, 4, 16)}
    losses = [float(engine.train_batch(batch=batch)) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert hasattr(model, "wpe") == (family in ("opt", "neo"))
