"""The port's autograd Functions of ops/memory_efficient.py held against the
JAX package's custom VJPs: the same numpy inputs and output gradients go
through ``jax.vjp`` and through ``torch.autograd``, in float32 and bf16."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops import memory_efficient as jme
from deepspeed_tpu_torch.ops import memory_efficient as tme

# f32: the same formulas, sums in another order; bf16: one rounding step
# of a result or gradient of size ~1 (bf16 keeps 8 bits, 2^-8 = 3.9e-3)
TOL = {"float32": 2e-5, "bfloat16": 1.6e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x, dtype, grad=False):
    t = torch.from_numpy(np.asarray(x, np.float32)).to(dtype)
    return t.requires_grad_() if grad else t


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dname):
    jdt, tdt = DTYPES[dname]
    rng = _rng(0)
    x = rng.standard_normal((2, 8, 64)) * 2 + 0.5
    scale = 1 + 0.1 * rng.standard_normal(64)
    bias = 0.1 * rng.standard_normal(64)
    g = rng.standard_normal((2, 8, 64))
    want, vjp = jax.vjp(lambda a, b, c: jme.layer_norm(a, b, c, 1e-5),
                        *(jnp.asarray(v, jdt) for v in (x, scale, bias)))
    want_grads = vjp(jnp.asarray(g, jdt))
    xs = [_t(v, tdt, grad=True) for v in (x, scale, bias)]
    y = tme.layer_norm(*xs, 1e-5)
    assert type(y.grad_fn).__name__ == "_LayerNormBackward"
    y.backward(_t(g, tdt))
    tol = TOL[dname]
    _close(y, want, tol)
    # dscale/dbias sum 16 rows of size ~1: a few rounding steps in bf16
    for got, w, t in zip(xs, want_grads, (tol, 4 * tol, 4 * tol)):
        assert got.grad.dtype == tdt
        _close(got.grad, w, t)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["gelu", "gelu_exact", "silu",
                                  "quick_gelu"])
def test_activation_matches_jax(name, dname):
    jdt, tdt = DTYPES[dname]
    rng = _rng(1)
    x = rng.standard_normal((4, 96)) * 3
    g = rng.standard_normal((4, 96))
    want, vjp = jax.vjp(getattr(jme, name), jnp.asarray(x, jdt))
    (want_dx,) = vjp(jnp.asarray(g, jdt))
    xt = _t(x, tdt, grad=True)
    y = getattr(tme, name)(xt)
    assert len(y.grad_fn.saved_tensors) == 1    # only x is saved
    y.backward(_t(g, tdt))
    # bf16 values reach |x| ~ 10: one rounding step is 2^-8 of the value
    tol = TOL[dname] * (4 if dname == "bfloat16" else 1)
    _close(y, want, tol)
    _close(xt.grad, want_dx, tol)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_dense_xent_sum_matches_jax(dname):
    jdt, tdt = DTYPES[dname]
    rng = _rng(2)
    logits = rng.standard_normal((2, 7, 50)) * 3
    labels = rng.integers(0, 50, (2, 7))
    valid = rng.random((2, 7)) > 0.3
    want, vjp = jax.vjp(
        lambda lg: jme.dense_xent_sum(lg, jnp.asarray(labels, jnp.int32),
                                      jnp.asarray(valid)),
        jnp.asarray(logits, jdt))
    (want_dl,) = vjp(jnp.float32(0.7))
    lt = _t(logits, tdt, grad=True)
    total = tme.dense_xent_sum(lt, torch.from_numpy(labels),
                               torch.from_numpy(valid))
    assert total.dtype == torch.float32
    # logits, lse, labels, valid: no f32 log-softmax
    assert [tuple(t.shape) for t in total.grad_fn.saved_tensors] == \
        [(2, 7, 50), (2, 7, 1), (2, 7), (2, 7)]
    before = lt.detach().clone()
    total.backward(torch.tensor(0.7))
    assert torch.equal(lt.detach(), before)    # backward leaves logits be
    # the sum runs in f32 over bf16 logits in both: f32 tolerance on it
    np.testing.assert_allclose(total.item(), float(want), rtol=2e-6)
    assert lt.grad.dtype == tdt
    _close(lt.grad, want_dl, TOL[dname] / 8)   # gradients are ~1/50
