"""The port's GPT-NeoX / GPT-J family (``deepspeed_tpu_torch.models.
gpt_neox``) held against the JAX package's on the CPU, float32, the same
numpy weights and ids through both (``torch_family_pairs``): parameter
trees, logits (the plain path, and the kernel path where the JAX package
runs K3 in interpret mode and the port K3's plain version, once a layer),
the loss and every gradient through K3's plain backward, the KV-cache
path with left padding, ``generate`` and ``ServingEngine`` streams
bitwise. GPT-NeoX runs partial rotate_half rotary with two LayerNorms (and
once without the parallel residual), GPT-J interleaved rotary on one
shared LayerNorm with an LM-head bias."""

import numpy as np
import pytest
import torch

import torch_family_pairs as fp
import torch_pairs as tp
from deepspeed_tpu_torch.models import gpt_neox as tneox
from deepspeed_tpu_torch.ops.kernels import flash_attention as tfk
from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as tfa

FLAVORS = ["neox", "gptj"]


@pytest.fixture(scope="module", params=FLAVORS)
def engines(request):
    return tp.engines(request.param)


@pytest.mark.parametrize("family", FLAVORS)
def test_params_round_trip_and_init_shapes(family):
    fp.round_trip(family)
    m = fp.models(family)[1]
    assert "wpe" not in m.top_leaves and "lm_head" in m.top_leaves
    assert ("lm_head_b" in m.top_leaves) == (family == "gptj")
    assert ("qkv_b" in m.block_leaves) == (family == "neox")
    assert ("ln2_scale" in m.block_leaves) == (family == "neox")


@pytest.mark.parametrize("family", FLAVORS + ["neox_serial"])
def test_logits_match_jax(family):
    fp.logits_vs_jax(family)


@pytest.mark.parametrize("family", FLAVORS)
def test_logits_match_jax_on_the_kernel_path(monkeypatch, family):
    """``attn_backend="pallas"``: the JAX package's K3 in interpret mode,
    the port's K3 plain version once a layer on the rotated q and k; the
    packed K1 never."""
    calls = []
    plain = tfk.flash_attention_plain
    monkeypatch.setattr(tfk, "flash_attention_plain",
                        lambda *a, **k: calls.append(a[0].shape) or
                        plain(*a, **k))
    before = tfa.packed_flash_attention_fwd.launches
    fp.logits_vs_jax(family, backend="pallas", seed=6)
    assert calls == [(2, 4, fp.T, 16)] * fp.TINY["n_layer"]
    assert tfa.packed_flash_attention_fwd.launches == before


@pytest.mark.parametrize("family", FLAVORS)
def test_loss_and_every_gradient_match_jax(family):
    fp.loss_and_grads_vs_jax(family)


@pytest.mark.parametrize("family", FLAVORS)
def test_cache_path_matches_jax_and_the_full_forward(family):
    fp.cache_vs_jax(family)


def test_generate_and_left_padded_batches_bitwise_jax(engines):
    fp.generate_vs_jax(engines)


def test_serving_streams_bitwise_jax(engines):
    fp.serving_vs_jax(engines)


def test_interleaved_rotary_pairs_and_presets():
    """GPT-J's rotate_every_two rotates the pairs (x[2i], x[2i+1]); the
    presets carry the published widths."""
    x = torch.arange(8, dtype=torch.float32).reshape(1, 1, 1, 8)
    angles = torch.full((1, 4), np.pi / 2)
    got = tneox.apply_rope_interleaved(x, angles)[0, 0, 0]
    np.testing.assert_allclose(got.numpy(), [-1, 0, -3, 2, -5, 4, -7, 6],
                               atol=1e-6)
    assert (tneox.GPTJ_6B.n_embd, tneox.GPTJ_6B.head_dim,
            tneox.GPTJ_6B.rot_dims) == (4096, 256, 64)
    assert (tneox.NEOX_20B.head_dim, tneox.NEOX_20B.rot_dims) == (96, 24)
    with pytest.raises(ValueError, match="rotary dims"):
        tneox.GPTNeoXModel(tneox.gptj_config(**dict(fp.TINY,
                                                    rotary_ndims=7)))
