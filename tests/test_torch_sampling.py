"""The port's keys and draws held against ``jax.random`` on the CPU
(threefry2x32, ``jax_threefry_partitionable``, 64-bit types off, as the JAX
package runs): ``row_keys`` (``fold_in(PRNGKey(seed), col)``), ``split``
and the uniform bits are bitwise equal; Gumbel noise agrees within 2 float32
ulp (each of its two logs may round one ulp apart between XLA and torch);
``sample_rows`` on identical float32 logits draws the JAX package's tokens,
any mismatch lying at a row whose perturbed top-2 gap is under 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import speculative as jspec
from deepspeed_tpu_torch.inference import prng
from deepspeed_tpu_torch.inference import speculative as tspec

TINY = np.finfo(np.float32).tiny


def _seeds_cols(n=2400, seed=0):
    rng = np.random.default_rng(seed)
    seeds = np.concatenate([[0, -1, 2 ** 31 - 1, -2 ** 31, 1, 42],
                            rng.integers(-2 ** 31, 2 ** 31, n - 6)])
    cols = rng.integers(0, 1 << 20, n)
    cols[:6] = [0, 1, 2047, 2048, 123456, 7]
    return seeds.astype(np.int32), cols.astype(np.int32)


def _u32(x):
    return np.asarray(x).astype(np.uint32).astype(np.int64)


def test_row_keys_bitwise():
    seeds, cols = _seeds_cols()
    want = _u32(jspec.row_keys(jnp.asarray(seeds), jnp.asarray(cols)))
    got = tspec.row_keys(torch.from_numpy(seeds), torch.from_numpy(cols))
    assert got.shape == (seeds.size, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, -1, 2 ** 31 - 1, 7, 2 ** 32 + 5,
                                  2 ** 40 + 7, -2 ** 40])
def test_prng_key_split_fold_in_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    got = prng.prng_key(seed)
    np.testing.assert_array_equal(got.numpy(), _u32(key))
    np.testing.assert_array_equal(prng.split(got, 3).numpy(),
                                  _u32(jax.random.split(key, 3)))
    for data in (0, 5, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(got, data).numpy(),
            _u32(jax.random.fold_in(key, np.uint32(data))))


def test_uniform_bits_and_gumbel():
    seeds, cols = _seeds_cols(n=600, seed=1)
    keys = jspec.row_keys(jnp.asarray(seeds), jnp.asarray(cols))
    tkeys = torch.from_numpy(_u32(keys))
    shape = (97,)
    want_bits = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, shape))(keys)).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(tkeys, shape).numpy(),
                                  want_bits)
    want_u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, shape, minval=TINY, maxval=1.0))(keys))
    got_u = prng.uniform(tkeys, shape, TINY, 1.0).numpy()
    np.testing.assert_array_equal(got_u.view(np.int32),
                                  want_u.view(np.int32))
    want_g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, shape))(keys))
    got_g = prng.gumbel(tkeys, shape).numpy()
    ulp = np.spacing(np.maximum(np.abs(want_g), 1.0).astype(np.float32))
    assert float((np.abs(got_g - want_g) / ulp).max()) <= 2.0


def _mixed_rows(n, v, seed):
    """Logits and per-row controls over every sampling mode: greedy,
    temperature only, top-k, top-p, both; some top-k above the vocab."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, v)) * 3).astype(np.float32)
    mode = np.arange(n) % 5
    temps = np.where(mode == 0, 0.0, rng.uniform(0.3, 1.5, n))
    top_ks = np.where((mode == 2) | (mode == 4), rng.integers(1, v + 8, n), 0)
    top_ps = np.where((mode == 3) | (mode == 4), rng.uniform(0.05, 0.99, n),
                      1.0)
    seeds, cols = _seeds_cols(n, seed=seed + 1)
    return (logits, temps.astype(np.float32), top_ks.astype(np.int32),
            top_ps.astype(np.float32), seeds, cols)


def test_sample_rows_matches_jax():
    v_real, v_pad = 96, 104
    logits, temps, top_ks, top_ps, seeds, cols = _mixed_rows(3000, v_pad, 2)
    keys = jspec.row_keys(jnp.asarray(seeds), jnp.asarray(cols))
    want = np.asarray(jspec.sample_rows(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.asarray(top_ps), keys, v_real))
    got = tspec.sample_rows(torch.from_numpy(logits), temps, top_ks, top_ps,
                            torch.from_numpy(_u32(keys)), v_real).numpy()
    bad = np.nonzero(got != want)[0]
    # a mismatch may only sit where the two perturbed logits tie within
    # the Gumbel noise's ulps
    gumbel = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (v_real,)))(keys))
    scaled = logits[:, :v_real] / np.maximum(temps, 1e-6)[:, None]
    for r in bad:
        pert = scaled[r] + gumbel[r]
        assert temps[r] > 0, f"greedy row {r} differs"
        assert abs(pert[got[r]] - pert[want[r]]) < 1e-5, \
            f"row {r}: {got[r]} vs {want[r]}"
    print(f"sample_rows: {bad.size} of {len(got)} rows differ, all at "
          f"perturbed top-2 gaps under 1e-5")
    assert bad.size <= 3
    # every row stayed in the real vocab and inside its top-k
    assert got.max() < v_real
    rank = (scaled > scaled[np.arange(len(got)), got][:, None]).sum(-1)
    k_on = top_ks > 0
    assert (rank[k_on] < top_ks[k_on]).all()


def test_generate_key_schedule_matches_jax():
    """``generate``'s schedule: ``PRNGKey(seed)`` draws the first token over
    the whole batch, each next draw uses the second key of a split."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((4, 50)) * 2).astype(np.float32)
    jkey, tkey = jax.random.PRNGKey(11), prng.prng_key(11)
    for _ in range(6):
        want = np.asarray(jax.random.categorical(jkey, jnp.asarray(logits)))
        got = prng.categorical(tkey, torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(got, want)
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey)
        np.testing.assert_array_equal(tsub.numpy(), _u32(jsub))
        jkey, tkey = jsub, tsub


def test_all_greedy_rows_skip_the_draw():
    logits = torch.randn(5, 40)
    keys = tspec.row_keys(torch.zeros(5, dtype=torch.int64),
                          torch.arange(5))
    out = tspec.sample_rows(logits, np.zeros(5, np.float32),
                            np.zeros(5, np.int32), np.ones(5, np.float32),
                            keys, 32)
    assert torch.equal(out, logits[:, :32].argmax(-1))
    temps, top_ks, top_ps, seeds = tspec.sampling_arrays(3)
    assert temps.dtype == np.float32 and top_ks.dtype == np.int32
    assert (top_ps == 1).all() and (seeds == 0).all()
