"""Dropout on the JAX package's keys, held against ``jax.random`` and the
JAX package's dropout on the CPU.

Bit for bit: ``prng.bernoulli``, ``prng.permutation`` (1 sort round at T
<= 1625, 2 above) and the host key path (``fold_in_words``,
``split_words``, ``bernoulli_scalar``) against ``jax.random``; the port's
``token_dropout`` forward and backward against the JAX package's
``_token_dropout`` and its ``jax.vjp`` (eager: the JAX program divides by
``1 - rate`` rounded to the input's dtype; jitted, XLA multiplies f32 by
the reciprocal instead, one rounding step away). The plain attention with
probability dropout matches the JAX one within 1e-6 (f32). The kernel
itself runs only on the card (``tests/test_torch_cuda_kernels.py``)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.models.gpt2 import _token_dropout
from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu.ops import seq_parallel as jsp
from deepspeed_tpu_torch.inference import prng
from deepspeed_tpu_torch.ops import dropout as tdrop
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import kernel_build
from deepspeed_tpu_torch.ops.kernels import threefry_dropout as tfd

from torch_train_pairs import keys

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _same_bits(got, want):
    """Equal values, read in float32 (-0.0 == 0.0: x * 0 keeps x's sign)."""
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)))


@pytest.mark.parametrize("n", [7, 1024, 2048, 4096])
def test_permutation_bitwise_jax(n):
    key, words = keys(n)
    assert prng.shuffle_rounds(n) == (1 if n <= 1625 else 2)
    np.testing.assert_array_equal(prng.permutation(words, n).numpy(),
                                  np.asarray(jax.random.permutation(key, n)))
    batch = jax.random.split(key, 3)
    got = prng.permutation(torch.from_numpy(np.asarray(batch).astype(
        np.int64)), n)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.vmap(
            lambda k: jax.random.permutation(k, n))(batch)))


@pytest.mark.parametrize("shape", [(7,), (3, 50, 7), (2, 4, 33, 33)])
def test_bernoulli_and_host_keys_bitwise_jax(shape):
    key, words = keys(11)
    for p in (0.9, 0.5, 1.0 - 0.1):
        np.testing.assert_array_equal(
            prng.bernoulli(words, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(key, p, shape)))
    for data in (0, 1, 2, 3, 1001, 1002, 2 ** 31 + 5):
        assert prng.fold_in_words(words, data) == tuple(
            np.asarray(jax.random.fold_in(key, data)).tolist())
    assert prng.split_words(words, 4) == [
        tuple(k) for k in np.asarray(jax.random.split(key, 4)).tolist()]
    draws = [(prng.fold_in_words(words, i), np.float32(p))
             for i in range(64) for p in (0.3, 0.75)]
    want = [bool(jax.random.bernoulli(jax.random.fold_in(key, i), p))
            for i in range(64) for p in (np.float32(0.3), np.float32(0.75))]
    assert [prng.bernoulli_scalar(k, p) for k, p in draws] == want
    assert prng.uniform_scalar(words) == np.float32(
        jax.random.uniform(key, ()))
    assert prng.as_key(torch.tensor(words)) == words


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_token_dropout_and_its_vjp_bitwise_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 100, 77)).astype(np.float32)
    g = rng.standard_normal((3, 100, 77)).astype(np.float32)
    x[0, 0, :5] = [-1.5, -0.0, 0.0, 2.0, -3.0]
    key, words = keys(5)
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    want, vjp = jax.vjp(lambda v: _token_dropout(v, key, True, 7, 0.1), xj)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    got = tdrop.salted_dropout(xt, words, True, 7, 0.1)
    _same_bits(got.detach(), want)
    got.backward(torch.from_numpy(g).to(tdt))
    _same_bits(xt.grad, vjp(gj)[0])
    # the dropped elements: x * 0 keeps x's sign, as in JAX
    dropped = ~prng.bernoulli(prng.fold_in_words(words, 7), 0.9, x.shape)
    assert 0 < int(dropped.sum()) < x.size // 5
    assert torch.equal(torch.signbit(got.detach()[dropped]),
                       torch.signbit(xt.detach()[dropped]))


def test_threefry_dropout_plain_version_and_refusals():
    """The plain version takes the divisor rounded to x's dtype (bf16
    0.8984375 for rate 0.1), keeps f16 bitwise the JAX eager program too,
    and passes x through at rate 0 or without a key."""
    assert tfd.divisor(0.1, torch.bfloat16) == 0.8984375
    assert tfd.divisor(0.1, torch.float32) == float(np.float32(0.9))
    assert tfd.threshold(0.1) == float(np.float32(0.9))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 13)).astype(np.float16)
    key, words = keys(2)
    want = _token_dropout(jnp.asarray(x), key, True, 1, 0.25)
    _same_bits(tfd.threefry_dropout_plain(torch.from_numpy(x),
                                          prng.fold_in_words(words, 1),
                                          0.25), want)
    t = torch.from_numpy(x)
    assert tdrop.token_dropout(t, None, 0.1) is t
    assert tdrop.token_dropout(t, words, 0.0) is t
    assert tdrop.salted_dropout(t, words, False, 0, 0.1) is t
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tfd.threefry_dropout(t.double(), words, 0.1)
    with pytest.raises(ValueError, match="rate"):
        tfd.threefry_dropout(t, words, 1.0)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfd.threefry_dropout(t.to("meta"), words, 0.1)
    assert tfd.threefry_dropout.launches == 0      # CPU: the plain version
    assert "threefry_dropout" in kernel_build.sources()
    assert kernel_build._kernel_name(
        "_ZN47_GLOBAL__N__threefry_dropout_cu_a1b2c3d423threefry_dropout_"
        "kernelI13__nv_bfloat16EEvPKT_PS2_yNS_8DropArgsEi") == \
        "threefry_dropout_kernel<bf16>"


@pytest.mark.parametrize("causal", [True, False])
def test_attention_probability_dropout_matches_jax(causal):
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((2, 3, 40, 16)).astype(np.float32)
               for _ in range(3))
    key, words = keys(9)
    want = jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=causal, dropout_rate=0.2,
                               dropout_rng=key, backend="xla")
    got = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, dropout_rate=0.2,
                              dropout_rng=words, backend="auto")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    plain = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=causal, backend="xla")
    assert (got - plain).abs().max() > 1e-3         # it did drop
    # dropout is outside the kernels' envelope in both packages
    qt = torch.zeros((1, 2, 128, 16))
    assert not tfa.supported(qt, qt, dropout_rate=0.1)
    with pytest.raises(ValueError, match="dropout=0.1"):
        tfa.flash_attention(qt, qt, qt, dropout_rate=0.1, backend="pallas")
    # sequence-parallel entry: no seq axis, so dropout passes straight on
    js = jsp.sp_attention(*(jnp.asarray(a) for a in (q, k, v)),
                          causal=causal, dropout_rate=0.2, dropout_rng=key,
                          backend="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(js), atol=1e-6,
                               rtol=0)


def test_scoring_takes_no_dropout_and_keeps_the_kernel_envelope(monkeypatch):
    """``logits`` (the inference engine's call) runs with ``train=False``,
    as the JAX inference engine calls its model: a model configured with
    dropout scores as without it, and its attention is asked for no
    dropout, so on the card it stays on the kernels."""
    from deepspeed_tpu_torch.models import llama as tllama
    import torch_train_pairs as tt
    asked = []
    real = tllama.sp_attention
    monkeypatch.setattr(tllama, "sp_attention", lambda *a, **kw: asked.append(
        kw["dropout_rate"]) or real(*a, **kw))
    ids = torch.from_numpy(tt.batch(3)["input_ids"]).long()
    with torch.no_grad():
        _, _, plain = tt.models("llama", seed=2)
        _, _, drop = tt.models("llama", seed=2, dropout=0.3)
        assert torch.equal(plain.logits(ids), drop.logits(ids))
        for family in ("gpt2", "bert"):
            _, _, a = tt.models(family, seed=2)
            _, _, b = tt.models(family, seed=2, dropout=0.3)
            assert torch.equal(a.logits(ids), b.logits(ids))
    assert asked and set(asked) == {0.0}
