"""The block-sparse plain versions' tensor-core arithmetic and what the
tensor-core K6/K7 kernels rely on, on the CPU.

``tensor_core=True`` makes ``block_sparse_attention_plain`` and
``block_sparse_attention_bwd_plain`` sum S and dP as the H100's
``mma.m16n8k16`` does and run the softmax in the log2 domain, as the
tensor-core kernels compute them; it is held against the JAX package's
Pallas kernels (interpret mode) in bf16 and f16. The tolerances are
``tests/test_torch_tensor_core_sums.py``'s: bf16 forward 8e-3, gradients
2e-2 absolute (one rounding step of the working type either way moves a
value by a few 1e-3); f16 keeps 3 more bits (forward 2e-3). lse, f32 in
both, to 1e-4 (``chip_smoke.py``'s LSE_TOL) where the row has a live block;
a row without one has lse ~ -1e30 in both (-1e30 in the JAX kernel,
-1e30 ln(2) in log2 units here).

``tensor_core=False`` (the default, the scalar kernels' arithmetic) must
give bitwise the result of the plain versions as they were before the
option existed, copied below as ``_before_fwd`` and ``_before_bwd``. The
device plan's ``live_rows`` is ``layout.any(-1)``. And the kernels' skips
(dead 16 x 16 steps of rows that have a live block contribute nothing)
change no bit of the plain forward's result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention_ops as jops
from deepspeed_tpu.ops.pallas import block_sparse_attention as jbsa
from deepspeed_tpu_torch.ops import kernel_build
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as tbsa
from deepspeed_tpu_torch.ops.kernels import flash_attention as tfk

T, FB, TILE = 256, 16, 128
GRAD_TOL, LSE_TOL = 2e-2, 1e-4
DTYPES = [(torch.bfloat16, jnp.bfloat16, 8e-3), (torch.float16, jnp.float16,
                                                  2e-3)]


def _edge_layout(h=2, t=T, fb=FB, tile=TILE):
    """The diagonal and one far block, except that fine row 5 of head 0 has
    no live block at all (its coarse tile stays live through the other
    rows) and head 1's second coarse tile has no live block (its coarse
    row has nnz = 0)."""
    nb, r = t // fb, tile // fb
    layout = np.zeros((h, nb, nb), bool)
    for i in range(nb):
        layout[:, i, i] = True
    layout[0, 3, nb - 1] = True
    layout[0, 5, :] = False
    layout[1, r:2 * r, :] = False
    return layout


def _layout(name, fb=FB, t=T):
    if name == "edge":
        return _edge_layout(fb=fb, t=t)
    if name == "fixed":
        return jops.FixedSparsityConfig(
            num_heads=2, block=fb, num_local_blocks=4,
            num_global_blocks=1).make_layout(t)
    return jops.BigBirdSparsityConfig(
        num_heads=2, block=fb, num_random_blocks=1,
        num_sliding_window_blocks=3, num_global_blocks=1,
        seed=0).make_layout(t)


def _inputs(shape, seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.5).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("dtype,jdtype,atol", DTYPES, ids=["bf16", "f16"])
@pytest.mark.parametrize("name", ["fixed", "bigbird", "edge"])
def test_tensor_core_plain_k6_k7_match_jax_kernels(name, dtype, jdtype,
                                                   atol):
    layout = _layout(name)
    q, k, v, g = _inputs((1, 2, T, 64), seed=5, n=4)
    scale = 64 ** -0.5
    # the JAX op's forward and backward rules, as jax.grad of
    # sum(out * g) runs them (the cotangent of out is g in out's dtype)
    key = ("test_torch_block_sparse_tensor_core", name)
    _, fine = jbsa._get_plan(key, layout, FB, TILE)
    want_out, res = jbsa._bsa_fwd(
        *(jnp.asarray(x, jdtype) for x in (q, k, v)), fine, key, scale, True)
    want_lse = res[-1]
    want = jbsa._bsa_bwd(key, scale, True, res, jnp.asarray(g, jdtype))[:3]
    tplan = tbsa.get_plan(layout, FB, TILE, "cpu")
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    dout = torch.from_numpy(g).to(dtype)
    out, lse = tbsa.block_sparse_attention_plain(tq, tk, tv, tplan, scale,
                                                 tensor_core=True)
    assert out.dtype == dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(want_out.astype(jnp.float32)),
        atol=atol)
    want_lse = np.asarray(want_lse)[..., 0]
    live = want_lse > -1e29
    np.testing.assert_allclose(lse.numpy()[live], want_lse[live],
                               atol=LSE_TOL)
    assert (lse.numpy()[~live] < -1e29).all()
    if name == "edge":      # an empty fine row; a coarse row with nnz = 0
        assert not live.all() and not live[0, 0, 5 * FB:6 * FB].any()
    grads = tbsa.block_sparse_attention_bwd_plain(
        tq, tk, tv, dout, lse, tfk.attention_delta(out, dout), tplan, scale,
        tensor_core=True)
    for x, got, w in zip("qkv", grads, want):
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=GRAD_TOL, err_msg=f"d{x}")


# ------------------------------------- the plain versions before the option

def _before_fwd(q, k, v, plan, scale):
    b, h, t, d = q.shape
    tile, f32 = plan.tile, torch.float32
    nt = t // tile
    heads = torch.arange(h, device=q.device)[:, None]
    tiles = torch.arange(nt, device=q.device)[None, :]
    kcols, nnz = plan.kcols.long(), plan.nnz.long()
    qt = q.to(f32).reshape(b, h, nt, tile, d)
    m = torch.full((b, h, nt, tile, 1), tbsa.NEG_INF, dtype=f32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qt)
    for j in range(kcols.shape[-1]):
        live = (j < nnz)[None, :, :, None, None]
        cols = kcols[:, :, j]
        kt = tbsa._gathered(k, heads, cols, tile)
        vt = tbsa._gathered(v, heads, cols, tile)
        keep = tbsa._keep(plan, heads, tiles, cols)
        for sub in tbsa._sub_tiles(tile):
            s = torch.matmul(qt, kt[..., sub, :].transpose(-1, -2)) * scale
            s = torch.where(keep[..., sub], s, tbsa.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l_new = l * alpha + p.sum(-1, keepdim=True)
            acc_new = acc * alpha + torch.matmul(p.to(q.dtype).to(f32),
                                                 vt[..., sub, :])
            m = torch.where(live, m_new, m)
            l = torch.where(live, l_new, l)
            acc = torch.where(live, acc_new, acc)
    lc = torch.clamp_min(l, 1e-30)
    out = (acc / lc).to(q.dtype).reshape(b, h, t, d)
    return out, (m + torch.log(lc)).reshape(b, h, t)


def _before_bwd(q, k, v, dout, lse, delta, plan, scale):
    b, h, t, d = q.shape
    tile, f32, dt = plan.tile, torch.float32, q.dtype
    nt = t // tile
    heads = torch.arange(h, device=q.device)[:, None]
    tiles = torch.arange(nt, device=q.device)[None, :]
    lse_t = lse.reshape(b, h, nt, tile, 1)
    delta_t = delta.reshape(b, h, nt, tile, 1)

    def rounded(x):
        return x.to(dt).to(f32)

    qt = q.to(f32).reshape(b, h, nt, tile, d)
    dot = dout.to(f32).reshape(b, h, nt, tile, d)
    dq = torch.zeros_like(qt)
    kcols, nnz = plan.kcols.long(), plan.nnz.long()
    for j in range(kcols.shape[-1]):
        live = (j < nnz)[None, :, :, None, None]
        cols = kcols[:, :, j]
        kt = tbsa._gathered(k, heads, cols, tile)
        vt = tbsa._gathered(v, heads, cols, tile)
        keep = tbsa._keep(plan, heads, tiles, cols)
        for sub in tbsa._sub_tiles(tile):
            ks, vs = kt[..., sub, :], vt[..., sub, :]
            s = torch.where(keep[..., sub],
                            torch.matmul(qt, ks.transpose(-1, -2)) * scale,
                            tbsa.NEG_INF)
            p = torch.exp(s - lse_t)
            dp = torch.matmul(dot, vs.transpose(-1, -2))
            ds = rounded(p * (dp - delta_t) * scale)
            dq = torch.where(live, dq + torch.matmul(ds, ks), dq)
    kt = k.to(f32).reshape(b, h, nt, tile, d)
    vt = v.to(f32).reshape(b, h, nt, tile, d)
    dk, dv = torch.zeros_like(kt), torch.zeros_like(vt)
    qrows, nnz_t = plan.qrows_t.long(), plan.nnz_t.long()
    for j in range(qrows.shape[-1]):
        live = (j < nnz_t)[None, :, :, None, None]
        rows = qrows[:, :, j]
        qs_t = tbsa._gathered(q, heads, rows, tile)
        dos_t = tbsa._gathered(dout, heads, rows, tile)
        lse_r = lse_t[:, heads, rows]
        delta_r = delta_t[:, heads, rows]
        keep = tbsa._keep(plan, heads, rows, tiles)
        for sub in tbsa._sub_tiles(tile):
            qs, dos = qs_t[..., sub, :], dos_t[..., sub, :]
            s = torch.where(keep[..., sub, :],
                            torch.matmul(qs, kt.transpose(-1, -2)) * scale,
                            tbsa.NEG_INF)
            p = torch.exp(s - lse_r[..., sub, :])
            dv = torch.where(live, dv + torch.matmul(
                rounded(p).transpose(-1, -2), dos), dv)
            dp = torch.matmul(dos, vt.transpose(-1, -2))
            ds = rounded(p * (dp - delta_r[..., sub, :]) * scale)
            dk = torch.where(live, dk + torch.matmul(ds.transpose(-1, -2),
                                                     qs), dk)
    return tuple(x.to(dt).reshape(b, h, t, d) for x in (dq, dk, dv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["bigbird", "edge"])
def test_default_arithmetic_is_bitwise_the_former_one(name, dtype):
    layout = _layout(name)
    plan = tbsa.get_plan(layout, FB, TILE, "cpu")
    q, k, v, g = (torch.from_numpy(x).to(dtype)
                  for x in _inputs((1, 2, T, 32), seed=6, n=4))
    scale = 32 ** -0.5
    out, lse = tbsa.block_sparse_attention_plain(q, k, v, plan, scale)
    want_out, want_lse = _before_fwd(q, k, v, plan, scale)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    delta = tfk.attention_delta(out, g)
    got = tbsa.block_sparse_attention_bwd_plain(q, k, v, g, lse, delta, plan,
                                                scale)
    want = _before_bwd(q, k, v, g, lse, delta, plan, scale)
    for x, a, b in zip("qkv", got, want):
        assert torch.equal(a, b), f"d{x}"


# --------------------------------------------- the plan's row flags, skips

@pytest.mark.parametrize("name", ["fixed", "bigbird", "edge"])
def test_plan_live_rows_are_layout_any(name):
    layout = _layout(name)
    plan = tbsa.get_plan(layout, FB, TILE, "cpu")
    assert plan.live_rows.dtype == torch.uint8
    assert plan.live_rows.shape == layout.shape[:2]
    np.testing.assert_array_equal(plan.live_rows.numpy(),
                                  layout.any(-1).astype(np.uint8))


def _fwd_with_skips(q, k, v, plan, layout, scale):
    """The plain forward (tensor cores) with the tensor-core kernel's skips
    at 16 x 16 granularity: in a fine row that has a live block, a dead
    (16 q rows, 16 keys) step adds nothing to l and O (its p is taken as
    0)."""
    b, h, t, d = q.shape
    tile, f32, fb = plan.tile, torch.float32, plan.fine_block
    nt = t // tile
    heads = torch.arange(h)[:, None]
    tiles = torch.arange(nt)[None, :]
    kcols, nnz = plan.kcols.long(), plan.nnz.long()
    flagged = torch.from_numpy(layout.any(-1)).repeat_interleave(fb, -1)
    flagged = flagged.reshape(h, nt, tile, 1)
    qt = q.to(f32).reshape(b, h, nt, tile, d)
    m = torch.full((b, h, nt, tile, 1), tbsa.NEG_INF, dtype=f32)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qt)
    for j in range(kcols.shape[-1]):
        live = (j < nnz)[None, :, :, None, None]
        cols = kcols[:, :, j]
        kt = tbsa._gathered(k, heads, cols, tile)
        vt = tbsa._gathered(v, heads, cols, tile)
        keep = tbsa._keep(plan, heads, tiles, cols)
        for sub in tbsa._sub_tiles(tile):
            s = tfk._logits(qt, kt[..., sub, :], scale, True)
            s = torch.where(keep[..., sub], s, tbsa.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.where(keep[..., sub] | ~flagged, torch.exp2(s - m_new),
                            0.0)
            l_new = l * alpha + p.sum(-1, keepdim=True)
            acc_new = acc * alpha + torch.matmul(p.to(q.dtype).to(f32),
                                                 vt[..., sub, :])
            m = torch.where(live, m_new, m)
            l = torch.where(live, l_new, l)
            acc = torch.where(live, acc_new, acc)
    lc = torch.clamp_min(l, 1e-30)
    return (acc / lc).to(q.dtype).reshape(b, h, t, d)


@pytest.mark.parametrize("name,fb", [("bigbird", 16), ("edge", 16),
                                     ("edge", 32)])
def test_skipping_dead_steps_changes_no_bit(name, fb):
    """A row with a live block: a dead pair adds exp2(-1e30 - m) = 0 once m
    is real, and before that adds what its first live column wipes; a row
    without one is computed in full (its mean of V over the visited
    columns, as on the TPU)."""
    layout = _layout(name, fb=fb)
    plan = tbsa.get_plan(layout, fb, TILE, "cpu")
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs((1, 2, T, 32), seed=7, n=3))
    want, _ = tbsa.block_sparse_attention_plain(q, k, v, plan, 0.25,
                                                tensor_core=True)
    got = _fwd_with_skips(q, k, v, plan, layout, 0.25)
    assert torch.equal(got, want)


def test_tensor_core_path_follows_the_sparse_kernels_dispatch(monkeypatch):
    """bsa.tensor_core_path answers with the block-sparse library's own
    dispatch (``dstorch_block_sparse_tensor_cores``), asked with the entry
    points' dtype codes."""
    asked = []
    routes = {(1, 64): 1, (2, 128): 1, (1, 256): 0, (0, 64): 0}

    class Entry:
        argtypes = restype = None

        def __call__(self, dtype, d):
            asked.append((dtype, d))
            return routes.get((dtype, d), -1)

    class Library:
        dstorch_block_sparse_tensor_cores = Entry()

    monkeypatch.setattr(kernel_build, "load", lambda name: {
        "block_sparse_attention_fwd": Library()}[name])
    assert tbsa.tensor_core_path(torch.bfloat16, 64)
    assert tbsa.tensor_core_path(torch.float16, 128)
    assert not tbsa.tensor_core_path(torch.bfloat16, 256)
    assert not tbsa.tensor_core_path(torch.float32, 64)
    assert asked == list(routes)
    with pytest.raises(ValueError, match="take no"):
        tbsa.tensor_core_path(torch.bfloat16, 300)
