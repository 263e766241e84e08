"""The tensor cores' float32 sums that the bf16/f16 flash attention plain
versions repeat when asked (``tensor_core=True``;
``ops/kernels/flash_attention.mma_step``), held bit for bit against
outputs of ``mma.sync.aligned.m16n8k16`` recorded on an NVIDIA H100 80GB
HBM3: the samples the rule was fitted on (``tests/data/
mma_m16n8k16_h100.npz``) and samples recorded afterwards in a run of their
own (``tests/data/mma_m16n8k16_h100_check.npz``, drawn and recorded by
``tests/data/record_mma_m16n8k16.py``); each holds A [n, 16, 16] and
B [n, 8, 16] as 16-bit patterns, C and D = A B^T + C [n, 16, 8] as float32.
Then the plain versions' tensor-core path against the JAX package's Pallas
kernels (interpret mode) at bf16 and f16, at the head dims the tensor-core
kernels take: up to 128 (``mma.sync``) and, for the forward, 256 and a
masked 192 (``wgmma``, whose 16-deep steps sum as ``mma.sync``'s on the
card: ``kernel-check wgmma sums``). Tolerances against JAX are the
existing bf16 tests' (forward 8e-3, gradients 2e-2 absolute: one rounding
step of the working type either way moves a value by a few 1e-3); f16
keeps 3 more bits (forward 2e-3)."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.ops import kernel_build
from deepspeed_tpu_torch.ops.kernels import flash_attention as tfk

DATA = pathlib.Path(__file__).parent / "data"
DTYPES = [("bf16", torch.bfloat16), ("f16", torch.float16)]


def _recorded(path, name, dtype):
    z = np.load(path)
    a, b = (torch.from_numpy(z[f"{name}_{x}"].view(np.int16)).view(dtype)
            for x in "ab")
    c, d = (torch.from_numpy(z[f"{name}_{x}"]) for x in "cd")
    return a, b, c, d


def _check_mma_step(a, b, c, d):
    got = tfk.mma_step(c, a, b)
    assert torch.equal(got, d), int((got != d).sum())
    # the samples tell the rule apart from a float32 sum
    f32_sum = c + torch.matmul(a.float(), b.float().transpose(-1, -2))
    assert not torch.equal(f32_sum, d)


@pytest.mark.parametrize("name,dtype", DTYPES)
def test_mma_step_matches_recorded_h100_outputs(name, dtype):
    """The samples the rule was fitted on."""
    _check_mma_step(*_recorded(DATA / "mma_m16n8k16_h100.npz", name, dtype))


@pytest.mark.parametrize("name,dtype", DTYPES)
def test_mma_step_matches_h100_outputs_it_was_not_fitted_on(name, dtype):
    """Samples drawn and recorded after the rule was fixed."""
    _check_mma_step(*_recorded(DATA / "mma_m16n8k16_h100_check.npz", name,
                               dtype))


@pytest.mark.parametrize("d", [8, 80, 128])
def test_mma_scores_steps_over_the_head_dim_in_order(monkeypatch, d):
    """16-column steps from a zero accumulator, the last one ragged, and
    the same result when the rows are cut into chunks."""
    rng = np.random.default_rng(d)
    a = torch.from_numpy(rng.standard_normal((2, 40, d))).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((2, 24, d))).to(torch.bfloat16)
    acc = torch.zeros((2, 40, 24))
    for c in range(0, d, 16):
        acc = tfk.mma_step(acc, a[..., c:c + 16], b[..., c:c + 16])
    got = tfk.mma_scores(a, b)
    assert torch.equal(got, acc)
    monkeypatch.setattr(tfk, "_MMA_CHUNK", 24 * 16 * 2 * 3)
    assert torch.equal(tfk.mma_scores(a, b), acc)
    exact = torch.matmul(a.double(), b.double().transpose(-1, -2))
    torch.testing.assert_close(got.double(), exact, rtol=1e-5, atol=1e-5)


def test_tensor_core_path_follows_the_kernels_dispatch(monkeypatch):
    """tensor_core_path answers with each direction's own dispatch: the
    forward library's ``dstorch_flash_attention_tensor_cores`` (2-byte
    types up to the 256 ceiling) and, with ``backward``, the backward
    library's ``dstorch_flash_attention_bwd_tensor_cores`` (up to 128),
    asked with the entry points' dtype codes (on the card,
    tests/test_torch_cuda_kernels.py holds their answers against the
    kernel instances that run)."""
    asked = []
    fwd = {(1, 64): 1, (2, 128): 1, (1, 80): 1, (1, 256): 1, (1, 200): 1,
           (2, 256): 1, (0, 64): 0, (0, 256): 0}
    bwd = {(1, 64): 1, (1, 256): 0, (1, 200): 0, (0, 256): 0}

    class Entry:
        argtypes = restype = None

        def __init__(self, name, routes):
            self.name, self.routes = name, routes

        def __call__(self, dtype, d):
            asked.append((self.name, dtype, d))
            return self.routes.get((dtype, d), -1)

    class Forward:
        dstorch_flash_attention_tensor_cores = Entry("fwd", fwd)

    class Backward:
        dstorch_flash_attention_bwd_tensor_cores = Entry("bwd", bwd)

    monkeypatch.setattr(kernel_build, "load", lambda name: {
        "flash_attention_fwd": Forward(),
        "flash_attention_bwd": Backward()}[name])
    assert tfk.tensor_core_path(torch.bfloat16, 64)
    assert tfk.tensor_core_path(torch.float16, 128)
    assert tfk.tensor_core_path(torch.bfloat16, 80)
    assert tfk.tensor_core_path(torch.bfloat16, 256)
    assert tfk.tensor_core_path(torch.bfloat16, 200)
    assert tfk.tensor_core_path(torch.float16, 256)
    assert not tfk.tensor_core_path(torch.float32, 64)
    assert not tfk.tensor_core_path(torch.float32, 256)
    assert tfk.tensor_core_path(torch.bfloat16, 64, backward=True)
    assert not tfk.tensor_core_path(torch.bfloat16, 256, backward=True)
    assert not tfk.tensor_core_path(torch.bfloat16, 200, backward=True)
    assert not tfk.tensor_core_path(torch.float32, 256, backward=True)
    assert asked == [("fwd",) + key for key in fwd] + \
        [("bwd",) + key for key in bwd]
    with pytest.raises(ValueError, match="take no"):
        tfk.tensor_core_path(torch.bfloat16, 300)
    with pytest.raises(ValueError, match="take no"):
        tfk.tensor_core_path(torch.bfloat16, 300, backward=True)


def _inputs(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.5).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("dtype,jdtype,atol", [
    (torch.bfloat16, jnp.bfloat16, 8e-3), (torch.float16, jnp.float16, 2e-3)],
    ids=["bf16", "f16"])
@pytest.mark.parametrize("shape,window", [((1, 2, 256, 64), None),
                                          ((1, 2, 128, 128), 100),
                                          ((1, 2, 128, 256), None),
                                          ((1, 2, 128, 192), 100)],
                         ids=["d64", "d128_window", "d256", "d192_window"])
def test_tensor_core_plain_matches_jax_kernel(dtype, jdtype, atol, shape,
                                              window):
    q, k, v = _inputs(shape, seed=4)
    want = np.asarray(jfa.flash_attention(
        *(jnp.asarray(x, jdtype) for x in (q, k, v)), True, None, None, None,
        True, window).astype(jnp.float32))
    out, _ = tfk.flash_attention_plain(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)), window=window,
        tensor_core=True)
    assert out.dtype == dtype
    np.testing.assert_allclose(out.float().numpy(), want, atol=atol)


def test_tensor_core_plain_gradients_match_jax_bf16():
    """The plain backward's tensor-core arithmetic (s and dp as the tensor
    cores sum them, exp2) on the plain forward's output, against
    ``jax.grad`` of the JAX package's kernels in bf16."""
    q, k, v, g = _inputs((1, 2, 128, 64), seed=5, n=4)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, True, None, None, None, True,
                                  None)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    dout = torch.from_numpy(g).to(torch.bfloat16)
    out, lse = tfk.flash_attention_plain(tq, tk, tv, tensor_core=True)
    grads = tfk.flash_attention_bwd_plain(
        tq, tk, tv, dout, lse, tfk.attention_delta(out, dout),
        tensor_core=True)
    for name, got, w in zip("qkv", grads, want):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=2e-2, err_msg=f"d{name}")


def _kernel_visits(t, causal, window, device):
    """``_tiles``' triples as the D-256 kernel visits them: per 128-row q
    block, every k tile of the block's range (from the window's first tile
    of its first row to the diagonal tile of its last), for all its rows."""
    pos = torch.arange(t, device=device)
    for q0 in range(0, t, 128):
        rows = slice(q0, min(q0 + 128, t))
        nk = min(t // 64, (q0 + 128 + 63) // 64) if causal else t // 64
        j0 = (max(q0 - window + 1, 0) // 64
              if causal and window is not None else 0)
        for j in range(j0, nk):
            cols = slice(64 * j, 64 * j + 64)
            keep = None
            if causal:
                diff = pos[rows, None] - pos[None, cols]
                keep = diff >= 0
                if window is not None:
                    keep &= diff < window
            yield rows, cols, keep


@pytest.mark.parametrize("t,causal,window", [(256, True, None),
                                             (320, True, 100),
                                             (192, False, None)])
def test_128_row_tiles_visit_nothing_the_64_row_plain_version_misses(
        monkeypatch, t, causal, window):
    """The D-256 kernel's two warpgroups visit every k tile of their
    128-row q block: a tile fully masked for a row adds exactly nothing to
    it (alpha 1 and p 0 past its diagonal; wiped by alpha 0 at its first
    live tile before its window). The plain version with those visits
    gives its own result bit for bit."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs((1, 2, t, 256), seed=6))
    want = tfk.flash_attention_plain(q, k, v, causal, None, window, True)
    monkeypatch.setattr(tfk, "_tiles", _kernel_visits)
    got = tfk.flash_attention_plain(q, k, v, causal, None, window, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
