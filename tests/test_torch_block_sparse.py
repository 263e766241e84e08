"""The port's block-sparse attention (layouts, host plan, K6/K7 plain
versions, dispatch) held against the JAX package's on the CPU.

Layouts, ``layout_to_mask`` and the plan are discrete: they must match
bitwise. The K6/K7 plain versions (the Hopper kernels' sub-tiles, update
order and rounding points, taken for CPU tensors) are held against the JAX
package's Pallas kernels in interpret mode and ``jax.grad`` of them, in
f32, to the JAX oracle tests' tolerances: forward and lse 2e-5, gradients
5e-5."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops import sparse_attention_ops as jops
from deepspeed_tpu.ops.pallas import block_sparse_attention as jbsa
from deepspeed_tpu_torch.ops import sparse_attention_ops as tops
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as tbsa

FWD_TOL, GRAD_TOL = 2e-5, 5e-5
T = 512

# (name, config class name, kwargs) for both packages
LAYOUTS = [
    ("dense", "SparsityConfig", dict(num_heads=2, block=16)),
    ("fixed", "FixedSparsityConfig",
     dict(num_heads=4, block=16, num_local_blocks=4, num_global_blocks=1)),
    ("fixed_per_head", "FixedSparsityConfig",
     dict(num_heads=4, block=16, num_local_blocks=4, num_global_blocks=1,
          different_layout_per_head=True, num_different_global_patterns=4,
          horizontal_global_attention=True)),
    ("fixed_unidirectional", "FixedSparsityConfig",
     dict(num_heads=2, block=32, num_local_blocks=2,
          attention="unidirectional")),
    ("bigbird", "BigBirdSparsityConfig",
     dict(num_heads=2, block=16, num_random_blocks=1,
          num_sliding_window_blocks=3, num_global_blocks=1, seed=0)),
    ("bigbird_per_head", "BigBirdSparsityConfig",
     dict(num_heads=4, block=16, num_random_blocks=2,
          different_layout_per_head=True, seed=7)),
    ("bigbird_unidirectional", "BigBirdSparsityConfig",
     dict(num_heads=2, block=16, attention="unidirectional", seed=3)),
    ("bslongformer", "BSLongformerSparsityConfig",
     dict(num_heads=2, block=16, num_sliding_window_blocks=3,
          global_block_indices=(0,))),
    ("bslongformer_spans", "BSLongformerSparsityConfig",
     dict(num_heads=2, block=16, global_block_indices=(0, 10),
          global_block_end_indices=(2, 12), attention="unidirectional")),
    ("variable", "VariableSparsityConfig",
     dict(num_heads=2, block=16, num_random_blocks=1,
          local_window_blocks=(2, 4), global_block_indices=(0, 5),
          horizontal_global_attention=True, seed=5)),
    ("variable_unidirectional", "VariableSparsityConfig",
     dict(num_heads=2, block=32, local_window_blocks=(3,),
          global_block_indices=(1,), global_block_end_indices=(3,),
          attention="unidirectional")),
]


def _layouts(name, cls, kw, t=T):
    return (getattr(jops, cls)(**kw).make_layout(t),
            getattr(tops, cls)(**kw).make_layout(t))


@pytest.mark.parametrize("name,cls,kw", LAYOUTS, ids=[c[0] for c in LAYOUTS])
def test_layouts_and_masks_bitwise_equal(name, cls, kw):
    want, got = _layouts(name, cls, kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tops.layout_to_mask(got, kw["block"]),
                                  jops.layout_to_mask(want, kw["block"]))
    with pytest.raises(ValueError, match="not divisible"):
        getattr(tops, cls)(**kw).make_layout(T + 8)


@pytest.mark.parametrize("name,tile", [("fixed_per_head", 128),
                                       ("bigbird_per_head", 256),
                                       ("bslongformer", 128),
                                       ("variable", 256),
                                       ("fixed_unidirectional", 256)])
def test_build_plan_bitwise_equal(name, tile):
    _, cls, kw = next(c for c in LAYOUTS if c[0] == name)
    layout, _ = _layouts(name, cls, kw)
    want = jbsa.build_plan(layout, kw["block"], tile)
    got = tbsa.build_plan(layout, kw["block"], tile)
    for field in ("kcols", "nnz", "qrows_t", "nnz_t", "coarse"):
        w, g = getattr(want, field), getattr(got, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert (got.tile, got.fine_block) == (want.tile, want.fine_block)
    with pytest.raises(ValueError, match="incompatible"):
        tbsa.build_plan(layout, kw["block"], 3 * kw["block"] + 1)


def test_default_tile_and_supported_agree_with_jax():
    """Over a grid of (T, fine block, D), on CPU (and meta) tensors: the
    same tile and the same envelope, so the dispatch matches."""
    for t in (128, 256, 384, 512, 1024, 4096):
        for fb in (8, 16, 32, 64, 128, 256):
            assert tbsa.default_tile(t, fb) == jbsa.default_tile(t, fb), \
                (t, fb)
            if t % fb:
                continue
            layout = np.ones((1, t // fb, t // fb), bool)
            for d in (16, 60, 64, 128, 256, 264):
                want = jbsa.supported(jnp.zeros((1, 1, t, d)), layout, fb)
                got = tbsa.supported(torch.empty((1, 1, t, d),
                                                 device="meta"), layout, fb)
                assert got == want, (t, fb, d)


def _jax_fwd_lse(q, k, v, layout, fb, tile, scale):
    """Out and lse of the JAX kernel (interpret mode) through its ``_fwd``."""
    plan = jbsa.build_plan(layout, fb, tile)
    fine = jnp.asarray(jbsa.pack_fine_windows(layout, tile, fb))
    out, lse = jbsa._fwd(*map(jnp.asarray, (q, k, v)), plan, fine, scale,
                         True)
    return np.asarray(out), np.asarray(lse)[..., 0]


def _edge_layout(nb, r):
    """A hand-built layout of two heads: the diagonal and one far block,
    except that fine row 5 of head 0 has no live block at all (its coarse
    tile stays live through the other rows), and head 1's second coarse
    tile (fine rows r..2r-1, r fine blocks a tile) has no live block, so
    its coarse row has nnz = 0."""
    layout = np.zeros((2, nb, nb), bool)
    for i in range(nb):
        layout[:, i, i] = True
    layout[0, 3, nb - 1] = True
    layout[0, 5, :] = False
    layout[1, r:2 * r, :] = False
    return layout


CASES = [("fixed_per_head", 16, 128), ("bigbird_per_head", 64, 128),
         ("bslongformer", 16, 128), ("edge", 16, 128), ("edge", 64, 128)]


def _case_layout(name, fb, tile=128):
    if name == "edge":
        return _edge_layout(T // fb, tile // fb)
    _, cls, kw = next(c for c in LAYOUTS if c[0] == name)
    return getattr(jops, cls)(**dict(kw, block=fb)).make_layout(T)


@pytest.mark.parametrize("name,fb,tile", CASES,
                         ids=[f"{n}-fb{f}-tile{t}" for n, f, t in CASES])
def test_plain_k6_k7_match_jax_interpret_kernels(name, fb, tile):
    layout = _case_layout(name, fb, tile)
    h = layout.shape[0]
    rng = np.random.default_rng(fb + h)
    q, k, v, g = [(rng.standard_normal((2, h, T, 32)) * 0.5)
                  .astype(np.float32) for _ in range(4)]
    scale = 32 ** -0.5
    want_out, want_lse = _jax_fwd_lse(q, k, v, layout, fb, tile, scale)
    if name == "edge":
        plan = tbsa.build_plan(layout, fb, tile)
        assert plan.nnz[1, 1] == 0 and not layout[0, 5].any()
        assert want_lse[:, 1, tile:2 * tile].max() < -1e29   # nnz = 0 rows
        np.testing.assert_array_equal(want_out[:, 1, tile:2 * tile], 0)

    def jloss(q_, k_, v_):
        return jnp.sum(jbsa.sparse_attention_pallas(
            q_, k_, v_, layout, fb, tile=tile, interpret=True) *
            jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    plan = tbsa.get_plan(layout, fb, tile, "cpu")
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = tbsa.block_sparse_attention_fwd.launches
    out, lse = tbsa.block_sparse_attention_fwd(tq, tk, tv, plan, scale)
    assert tbsa.block_sparse_attention_fwd.launches == before
    np.testing.assert_allclose(out.numpy(), want_out, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=FWD_TOL,
                               rtol=1e-6)
    tq, tk, tv = (x.clone().requires_grad_() for x in (tq, tk, tv))
    before = tbsa.block_sparse_attention_bwd.launches
    tbsa.sparse_attention_kernel(tq, tk, tv, layout, fb, tile=tile).backward(
        torch.from_numpy(g))
    assert tbsa.block_sparse_attention_bwd.launches == before
    for name_, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   err_msg=f"d{name_}")


def test_bf16_rounding_points_match_jax_kernel():
    """bf16 inputs: P rounded to bf16 before P.V, as in the JAX kernel."""
    layout = _case_layout("bslongformer", 16)
    rng = np.random.default_rng(3)
    q, k, v = [(rng.standard_normal((1, 2, T, 32)) * 0.5).astype(np.float32)
               for _ in range(3)]
    want = np.asarray(jbsa.sparse_attention_pallas(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), layout, 16,
        interpret=True).astype(jnp.float32))
    got = tbsa.sparse_attention_kernel(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        layout, 16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=8e-3)


@pytest.fixture
def qkv():
    rng = np.random.default_rng(4)
    return [(rng.standard_normal((1, 2, 256, 16)) * 0.5).astype(np.float32)
            for _ in range(3)]


def test_dispatch_matches_jax(monkeypatch, qkv):
    """``auto`` on the CPU takes the dense-masked path (as the JAX package
    off the TPU); ``pallas`` takes the kernels' plain versions; ``dense``
    the dense path; all equal the JAX package's dense path to 2e-5, and an
    unsupported shape raises under ``pallas``."""
    layout = jops.BigBirdSparsityConfig(num_heads=2, block=16,
                                        seed=1).make_layout(256)
    want = np.asarray(jops.sparse_attention(*map(jnp.asarray, qkv), layout,
                                            16))
    calls = []
    real = tbsa.sparse_attention_kernel
    monkeypatch.setattr(tbsa, "sparse_attention_kernel",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    t = [torch.from_numpy(x) for x in qkv]
    for impl, kernel_calls in (("auto", 0), ("dense", 0), ("pallas", 1)):
        got = tops.sparse_attention(*t, layout, 16, impl=impl)
        assert len(calls) == kernel_calls, impl
        np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL,
                                   err_msg=impl)
    with pytest.raises(ValueError, match="unsupported"):
        tops.sparse_attention(*(x[:, :, :, :12] for x in t), layout, 16,
                              impl="pallas")
    with pytest.raises(ValueError, match="unknown"):
        tops.sparse_attention(*t, layout, 16, impl="triton")
    assert set(vars(tops.get_ops())) == set(vars(jops.get_ops()))


def test_sparse_self_attention_padding_mask_takes_dense_path(monkeypatch,
                                                             qkv):
    cfg_kw = dict(num_heads=2, block=16, num_local_blocks=2)
    jsa = jops.SparseSelfAttention(jops.FixedSparsityConfig(**cfg_kw))
    tsa = tops.SparseSelfAttention(tops.FixedSparsityConfig(**cfg_kw))
    keep = np.ones((1, 256), np.int32)
    keep[:, 200:] = 0
    monkeypatch.setattr(tbsa, "sparse_attention_kernel",
                        lambda *a, **kw: pytest.fail("kernel taken"))
    want = np.asarray(jsa(*map(jnp.asarray, qkv),
                          key_padding_mask=jnp.asarray(keep)))
    got = tsa(*map(torch.from_numpy, qkv),
              key_padding_mask=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL)
    lay = tsa.layout(256)
    assert lay is tsa.layout(256)
    np.testing.assert_array_equal(lay, jsa.layout(256))
    with pytest.raises(ValueError, match="pad_to_block_size"):
        tsa.layout(250)


def test_plan_cache_uploads_once_and_is_bounded(monkeypatch):
    layout = jops.FixedSparsityConfig(num_heads=2, block=16).make_layout(256)
    built = []
    real = tbsa.build_plan
    monkeypatch.setattr(tbsa, "build_plan",
                        lambda *a: built.append(1) or real(*a))
    monkeypatch.setattr(tbsa, "_PLAN_CACHE", type(tbsa._PLAN_CACHE)())
    plan = tbsa.get_plan(layout, 16, 128, "cpu")
    # an equal layout (another array) finds the same plan by its digest
    assert tbsa.get_plan(layout.copy(), 16, 128, "cpu") is plan
    assert built == [1]
    assert plan.kcols.dtype == torch.int32 and plan.layout.dtype == \
        torch.uint8 and tuple(plan.layout.shape) == layout.shape
    # another tile or fine block is another plan
    assert tbsa.get_plan(layout, 16, 256, "cpu") is not plan
    assert built == [1, 1]
    monkeypatch.setattr(tbsa, "_PLAN_CACHE", type(tbsa._PLAN_CACHE)())
    for seed in range(tbsa._PLAN_CACHE_MAX + 3):
        lay = jops.BigBirdSparsityConfig(num_heads=1, block=16,
                                         seed=seed).make_layout(256)
        tbsa.get_plan(lay, 16, 128, "cpu")
    assert len(tbsa._PLAN_CACHE) == tbsa._PLAN_CACHE_MAX


def test_kernel_wrapper_refusals():
    layout = np.ones((2, 16, 16), bool)
    plan = tbsa.get_plan(layout, 16, 128, "cpu")
    q = torch.zeros((1, 2, 256, 16))
    with pytest.raises(ValueError, match="one shape"):
        tbsa.block_sparse_attention_fwd(q, q[:, :1], q, plan, 0.25)
    with pytest.raises(TypeError):
        tbsa.block_sparse_attention_fwd(q.double(), q.double(), q.double(),
                                        plan, 0.25)
    with pytest.raises(ValueError, match="does not support"):
        tbsa.block_sparse_attention_fwd(q[:, :, :128], q[:, :, :128],
                                        q[:, :, :128], plan, 0.25)
    # neither the CPU nor CUDA: the wrapper never takes the plain version
    meta = torch.empty((1, 2, 256, 16), device="meta")
    meta_plan = tbsa.DevicePlan(*(x.to("meta") for x in plan[:5]),
                                plan.tile, plan.fine_block,
                                plan.live_rows.to("meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tbsa.block_sparse_attention_fwd(meta, meta, meta, meta_plan, 0.25)
