"""K3 and the K3b/K5 backward of the port held against the JAX package's
``[B, H, T, D]`` Pallas flash attention on the CPU.

The port's kernel wrappers take their plain versions for CPU tensors (the
CUDA kernels' 64-row tile loop and rounding points); the JAX package runs
its Pallas kernels in interpret mode. The same numpy inputs go to both.
Tolerances are the JAX oracle tests' own: forward 2e-5 in f32, gradients
5e-5 (5e-4 with a window, as ``tests/unit/test_pallas_flash.py`` allows)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops import seq_parallel as jsp
from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.ops import flash_attention as tdispatch
from deepspeed_tpu_torch.ops import seq_parallel as tsp
from deepspeed_tpu_torch.ops.kernels import flash_attention as tfk

FWD_TOL = 2e-5


def _inputs(shape, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.5).astype(np.float32)
            for _ in range(n)]


def _jax_fwd(q, k, v, causal, scale, window):
    return np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale, None,
        None, True, window))


@pytest.mark.parametrize("shape,causal,window,scale", [
    ((1, 2, 256, 32), True, None, None),
    ((1, 2, 256, 32), False, None, None),
    ((1, 2, 256, 32), True, 96, None),
    ((1, 2, 256, 32), True, None, 0.1),
    ((1, 2, 256, 80), True, None, None),
    ((1, 1, 256, 256), True, 100, None),
], ids=["causal", "noncausal", "window", "scale", "d80", "d256_window"])
def test_forward_matches_jax_kernel(shape, causal, window, scale):
    q, k, v = _inputs(shape)
    want = _jax_fwd(q, k, v, causal, scale, window)
    before = tfk.flash_attention_fwd.launches
    out, lse = tfk.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                       causal, scale, window)
    assert tfk.flash_attention_fwd.launches == before  # CPU: plain version
    assert out.shape == shape and lse.shape == shape[:3]
    np.testing.assert_allclose(out.numpy(), want, atol=FWD_TOL)


@pytest.mark.parametrize("mode", ["fused", "split"], ids=["K3b", "K5"])
@pytest.mark.parametrize("shape,causal,window,tol", [
    ((1, 2, 256, 32), True, None, 5e-5),
    ((1, 2, 256, 32), False, None, 5e-5),
    ((1, 2, 256, 32), True, 96, 5e-4),
], ids=["causal", "noncausal", "window"])
def test_gradients_match_jax_backward(monkeypatch, mode, shape, causal,
                                      window, tol):
    """Through the autograd Function on the port's side, ``jax.grad`` of
    the custom VJP on the JAX side, with ``DSTPU_FLASH_BWD`` choosing the
    JAX package's fused (K3b) or split (K5) backward."""
    monkeypatch.setenv("DSTPU_FLASH_BWD", mode)
    q, k, v, g = _inputs(shape, seed=1, n=4)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, causal, None, None, None, True,
                                  window)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = tfk.flash_attention_bwd.launches
    out = tdispatch.flash_attention(tq, tk, tv, causal=causal,
                                    backend="pallas", window=window)
    out.backward(torch.from_numpy(g))
    assert tfk.flash_attention_bwd.launches == before
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=tol,
                                   err_msg=f"d{name}")


def test_bf16_rounding_points_match_jax_kernel():
    """bf16 inputs: P rounded to bf16 before P.V, as in the JAX kernel;
    the outputs agree to bf16's rounding of the result."""
    q, k, v = _inputs((1, 2, 256, 32), seed=2)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jfa.flash_attention(jq, jk, jv, True, None, None, None,
                                          True, None).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out, _ = tfk.flash_attention_fwd(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want, atol=8e-3)


def test_dispatch_takes_plain_versions_on_the_cpu(monkeypatch):
    """``pallas`` on the CPU takes the kernels' plain versions (as the JAX
    package takes interpret mode) and counts no launch; ``auto`` on the CPU
    and ``xla`` take the plain attention."""
    q, k, v = map(torch.from_numpy, _inputs((1, 2, 128, 16), seed=3))
    calls = []
    plain = tfk.flash_attention_plain
    monkeypatch.setattr(tfk, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    before = tfk.flash_attention_fwd.launches
    out = tdispatch.flash_attention(q, k, v, backend="pallas", window=40)
    assert calls == [1] and tfk.flash_attention_fwd.launches == before
    ref = tdispatch.flash_attention(q, k, v, backend="xla", window=40)
    auto = tdispatch.flash_attention(q, k, v, backend="auto", window=40)
    assert calls == [1]
    torch.testing.assert_close(out, ref, atol=FWD_TOL, rtol=0)
    torch.testing.assert_close(auto, ref, atol=0, rtol=0)


def test_dispatch_refusals():
    q = torch.zeros((1, 2, 96, 16))
    with pytest.raises(ValueError, match="does not support"):
        tdispatch.flash_attention(q, q, q, backend="pallas")   # T % 128
    q = torch.zeros((1, 2, 128, 16))
    with pytest.raises(ValueError, match="does not support"):
        tdispatch.flash_attention(q, q, q, backend="pallas",
                                  bias=torch.zeros((2, 128, 128)))
    with pytest.raises(ValueError, match="unknown attention backend"):
        tdispatch.flash_attention(q, q, q, backend="triton")
    # the streamed regime (T * D * itemsize > 1 MiB): the JAX package's
    # K4/K4b, which the kernels now take; on a device that is neither CUDA
    # nor the CPU (meta) the wrapper refuses it as any other shape
    big = torch.empty((1, 1, 8192, 64), device="meta")
    assert tfk.streamed(big)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tdispatch.flash_attention(big, big, big, backend="pallas")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tdispatch.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"),
                                  backend="pallas")


def test_kernel_wrapper_refusals():
    q = torch.zeros((1, 2, 128, 16))
    with pytest.raises(ValueError, match="one shape"):
        tfk.flash_attention_fwd(q, q[:, :1], q)
    with pytest.raises(TypeError):
        tfk.flash_attention_fwd(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="does not support"):
        tfk.flash_attention_fwd(q, q, q, causal=False, window=8)
    wide = torch.zeros((1, 1, 128, 264))
    with pytest.raises(ValueError, match="does not support"):
        tfk.flash_attention_fwd(wide, wide, wide)


def test_sp_attention_without_a_seq_axis():
    q, k, v = map(torch.from_numpy, _inputs((1, 2, 128, 16), seed=4))
    out = tsp.sp_attention(q, k, v, impl="ring", backend="pallas", window=50)
    torch.testing.assert_close(
        out, tdispatch.flash_attention(q, k, v, backend="xla", window=50),
        atol=FWD_TOL, rtol=0)
    with pytest.raises(ValueError, match="impl"):
        tsp.sp_attention(q, k, v, impl="megatron")
    with pytest.raises(ValueError, match="causal"):
        tsp.sp_attention(q, k, v, causal=False, window=8)
    # attention dropout: the JAX package's
    # plain attention under the same key, within the forward tolerance
    key = jax.random.PRNGKey(4)
    want = jsp.sp_attention(*(jnp.asarray(a.numpy()) for a in (q, k, v)),
                            dropout_rate=0.1, dropout_rng=key, backend="xla")
    got = tsp.sp_attention(q, k, v, dropout_rate=0.1,
                           dropout_rng=np.asarray(key))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=0)


# ------------------------------------------------ streamed regime (K4/K4b)

@pytest.fixture
def streamed_threshold(monkeypatch):
    """Both packages' residency threshold shrunk to 1 KiB, as
    ``tests/unit/test_pallas_flash.py`` does, so that small CPU shapes take
    the streamed regime; the JAX package's ``_fwd_streamed`` and
    ``_bwd_streamed`` are spied on to show that its streamed kernels ran."""
    monkeypatch.setattr(jfa, "_RESIDENT_MAX_KV_BYTES", 1024)
    monkeypatch.setattr(tfk, "_RESIDENT_MAX_KV_BYTES", 1024)
    ran = []
    for name in ("_fwd_streamed", "_bwd_streamed"):
        real = getattr(jfa, name)
        monkeypatch.setattr(jfa, name, lambda *a, _r=real, _n=name, **kw:
                            ran.append(_n) or _r(*a, **kw))
    return ran


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 100)],
                         ids=["causal", "noncausal", "window"])
def test_streamed_forward_matches_jax_streamed_kernel(streamed_threshold,
                                                      causal, window):
    shape = (1, 2, 512, 32)
    q, k, v = _inputs(shape, seed=10)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert tfk.streamed(tq)
    want = _jax_fwd(q, k, v, causal, None, window)
    assert streamed_threshold == ["_fwd_streamed"]
    out = tdispatch.flash_attention(tq, tk, tv, causal=causal,
                                    backend="pallas", window=window)
    np.testing.assert_allclose(out.numpy(), want, atol=FWD_TOL)


@pytest.mark.parametrize("causal,window,tol", [(True, None, 5e-5),
                                               (True, 100, 5e-4)],
                         ids=["causal", "window"])
def test_streamed_gradients_match_jax_streamed_kernels(streamed_threshold,
                                                       causal, window, tol):
    """``jax.grad`` through the JAX streamed backward (K4b) against the
    port's autograd Function on the same inputs."""
    q, k, v, g = _inputs((1, 2, 384, 32), seed=11, n=4)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, causal, None, None, None, True,
                                  window)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    assert streamed_threshold == ["_fwd_streamed", "_bwd_streamed"]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = (tfk.flash_attention_bwd.launches,
              tfk.flash_attention_bwd.streamed_launches)
    out = tdispatch.flash_attention(tq, tk, tv, causal=causal,
                                    backend="pallas", window=window)
    out.backward(torch.from_numpy(g))
    # the CPU takes the plain versions: no launch in either regime
    assert (tfk.flash_attention_bwd.launches,
            tfk.flash_attention_bwd.streamed_launches) == before
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=tol,
                                   err_msg=f"d{name}")
