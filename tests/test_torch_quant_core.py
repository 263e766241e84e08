"""The port's quantization core (``ops/quant_core.py``) held bitwise to the
JAX package's on the same numpy inputs: the scale math, round-and-clip,
the blockwise codec in int8 and ``fp8_block`` (blocks that divide the
size and blocks that do not, all-zero blocks), its wire-byte model, the
sign codec, the KV pool's per-column codec (``inference/kv_quant.py``)
and the weight-only rule (``inference/quantization.quantize_leaf``).
The f32 -> ``float8_e4m3fn`` conversion is held bitwise over every f32
value that rounds into e4m3's finite range, on both sides of each
rounding boundary.

The JAX functions run under ``jax.jit``, as every caller in the JAX
package runs them (its collectives, engines and slot programs are
compiled). XLA compiles a division by a constant (``absmax / 127``,
``/ 448``) into a multiply by the constant's f32 reciprocal, which the
port computes; run eagerly, the JAX functions divide, and their scales
differ from the compiled ones by an ulp in a few percent of blocks (the
last test shows it)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference import kv_quant as jkv
from deepspeed_tpu.inference import quantization as jq
from deepspeed_tpu.ops import quant_core as jqc
from deepspeed_tpu_torch.inference import kv_quant as tkv
from deepspeed_tpu_torch.inference import quantization as tq
from deepspeed_tpu_torch.ops import quant_core as tqc


def _x(shape, seed, scale=1.0, zero_blocks=0, block=64):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    flat = x.reshape(-1)
    for b in range(zero_blocks):
        flat[b * block:(b + 1) * block] = 0.0
    return x


def _bits(a):
    a = np.asarray(a)
    if a.dtype.itemsize == 1:
        return a.view(np.uint8)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _t_bits(t):
    if t.dtype == tqc.FP8_DTYPE:
        return t.view(torch.uint8).numpy()
    if t.dtype == torch.int8:
        return t.numpy().view(np.uint8)
    return t.numpy().view(np.uint32)


_jq_blockwise = jax.jit(jqc.quantize_blockwise, static_argnums=(1, 2))


CASES = [((4, 256), 256, 0), ((3, 100), 64, 0), ((8, 64), 64, 2),
         ((5, 7, 32), 32, 1), ((1000,), None, 0), ((2, 3), 0, 0)]


@pytest.mark.parametrize("wire", ["int8", "fp8_block"])
@pytest.mark.parametrize("shape,block,zeros", CASES)
def test_blockwise_codec_is_the_jax_codec(wire, shape, block, zeros):
    x = _x(shape, 3, scale=2.5, zero_blocks=zeros, block=block or 1)
    jq_, js = _jq_blockwise(jnp.asarray(x), block, wire)
    tq_, ts = tqc.quantize_blockwise(torch.from_numpy(x), block, wire)
    assert tuple(tq_.shape) == tuple(jq_.shape)
    assert ts.shape[0] == jqc.block_count(x.size, block)
    np.testing.assert_array_equal(_t_bits(tq_), _bits(jq_))
    np.testing.assert_array_equal(_t_bits(ts), _bits(js))
    jd = np.asarray(jqc.dequantize_blockwise(jq_, js))
    td = tqc.dequantize_blockwise(tq_, ts).numpy()
    np.testing.assert_array_equal(td.view(np.uint32), jd.view(np.uint32))
    jf = np.asarray(jax.jit(jqc.fake_quantize_blockwise, static_argnums=(
        1, 2))(jnp.asarray(x), block, wire))
    tf = tqc.fake_quantize_blockwise(torch.from_numpy(x), block, wire)
    np.testing.assert_array_equal(tf.numpy().view(np.uint32),
                                  jf.view(np.uint32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_codec_of_half_inputs(dtype):
    x = _x((6, 128), 9, scale=3.0)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq_, js = _jq_blockwise(jx, 64, "int8")
    tq_, ts = tqc.quantize_blockwise(tx, 64, "int8")
    np.testing.assert_array_equal(_t_bits(tq_), _bits(jq_))
    np.testing.assert_array_equal(_t_bits(ts), _bits(js))
    jd = jqc.dequantize_blockwise(jq_, js, dtype=jnp.bfloat16)
    td = tqc.dequantize_blockwise(tq_, ts, dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        td.view(torch.int16).numpy(),
        np.asarray(jd).view(np.int16))


def test_fp8_conversion_over_the_whole_e4m3_range():
    """Every e4m3 value, the midpoints between neighbours and one f32 ulp
    on each side of them, positive and negative: the JAX cast and torch's
    give the same bits."""
    codes = np.arange(256, dtype=np.uint8)
    vals = torch.from_numpy(codes.copy()).view(tqc.FP8_DTYPE) \
        .to(torch.float32).numpy()
    finite = np.sort(np.unique(vals[np.isfinite(vals)]))
    mids = (finite[:-1] + finite[1:]) / 2
    probe = np.concatenate([finite, mids, np.nextafter(mids, np.inf),
                            np.nextafter(mids, -np.inf)]).astype(np.float32)
    probe = np.concatenate([probe, -probe])
    j = np.asarray(jnp.asarray(probe).astype(jqc.FP8_DTYPE)).view(np.uint8)
    t = torch.from_numpy(probe).to(tqc.FP8_DTYPE).view(torch.uint8).numpy()
    np.testing.assert_array_equal(t, j)
    assert probe.size > 1500


def test_scale_math_and_round_clip():
    a = _x((7,), 1, scale=4.0)
    a[2] = 0.0
    np.testing.assert_array_equal(
        tqc.symmetric_scale(torch.from_numpy(np.abs(a)), 127.0).numpy(),
        np.asarray(jax.jit(lambda v: jqc.symmetric_scale(v, 127.0))(
            jnp.abs(jnp.asarray(a)))))
    ts, tz = tqc.asymmetric_scale_zero(-1.5, 3.0, 0.0, 255.0)
    js, jz = jax.jit(lambda lo, hi: jqc.asymmetric_scale_zero(
        lo, hi, 0.0, 255.0))(jnp.float32(-1.5), jnp.float32(3.0))
    assert float(ts) == float(js) and float(tz) == float(jz)
    halves = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 300.0, -300.0],
                      np.float32)
    np.testing.assert_array_equal(
        tqc.round_clip(torch.from_numpy(halves), -127, 127,
                       torch.int8).numpy(),
        np.asarray(jqc.round_clip(jnp.asarray(halves), -127, 127,
                                  jnp.int8)))
    assert tqc.qrange(8, True) == jqc.qrange(8, True)
    assert tqc.qrange(4, False) == jqc.qrange(4, False)
    with pytest.raises(ValueError, match="torch.Generator"):
        tqc.round_clip(torch.zeros(3), -1, 1, torch.int8, stochastic=True)
    g = torch.Generator().manual_seed(0)
    out = tqc.round_clip(torch.full((64,), 0.5), -1, 1, torch.int8,
                         stochastic=True, generator=g)
    assert set(out.tolist()) <= {0, 1}


@pytest.mark.parametrize("size,block", [(1024, 256), (1000, 256), (7, 0),
                                        (4096, None), (640, 64)])
def test_wire_nbytes_and_block_count(size, block):
    assert tqc.block_count(size, block) == jqc.block_count(size, block)
    for wire in ("int8", "fp8_block"):
        assert tqc.wire_nbytes(size, block, wire) == \
            jqc.wire_nbytes(size, block, wire)


def test_pertensor_and_sign_codec():
    x = _x((5, 9), 4)
    tqv, ts = tqc.pertensor_int8(torch.from_numpy(x))
    jqv, js = jax.jit(jqc.pertensor_int8)(jnp.asarray(x))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    assert ts.shape == () and float(ts) == float(js)
    tsg, tsc = tqc.sign_quantize(torch.from_numpy(x))
    jsg, jsc = jqc.sign_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(tsg.numpy(), np.asarray(jsg))
    np.testing.assert_allclose(float(tsc), float(jsc), rtol=1e-6)
    np.testing.assert_allclose(
        tqc.sign_dequantize(tsg, tsc).numpy(),
        np.asarray(jqc.sign_dequantize(jsg, jsc)), rtol=1e-6)


@pytest.mark.parametrize("hd", [16, 128])
def test_kv_column_codec(hd):
    x = _x((2, 3, 4, 10, hd), 6, scale=1.7)
    x[0, 1, 2, 3] = 0.0                        # an all-zero column
    jq_, js = jax.jit(jkv.quantize_kv)(jnp.asarray(x))
    tq_, ts = tkv.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(
        tkv.dequantize_kv(tq_, ts).numpy().view(np.uint32),
        np.asarray(jkv.dequantize_kv(jq_, js)).view(np.uint32))
    pool = {"k": torch.from_numpy(x), "v": torch.from_numpy(-x)}
    qp = tkv.quantize_pool(pool)
    jp = jax.jit(jkv.quantize_pool)({"k": jnp.asarray(x),
                                     "v": jnp.asarray(-x)})
    for n in ("k", "v"):
        np.testing.assert_array_equal(qp.q[n].numpy(), np.asarray(jp.q[n]))
    assert tkv.pool_nbytes(qp) == jkv.pool_nbytes(jp)
    assert tkv.pool_nbytes(pool) == 2 * x.nbytes


@pytest.mark.parametrize("shape,group", [((3, 64, 192), 64), ((64, 100), 64),
                                         ((2, 16, 32), 16)])
def test_weight_only_rule(shape, group):
    w = _x(shape, 11, scale=0.3)
    jw = jax.jit(jq.quantize_leaf, static_argnums=1)(jnp.asarray(w), group)
    tq_, ts = tq.quantize_leaf(torch.from_numpy(w), group)
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(jw.scale).view(np.uint32))
    qw = tq.QuantizedWeight(tq_, ts)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = qw.to(dt)
        want = np.asarray(jw.astype(jdt))
        assert got.dtype == dt
        np.testing.assert_array_equal(
            got.view(torch.int16 if dt == torch.bfloat16 else torch.int32)
            .numpy(), want.view(np.int16 if dt == torch.bfloat16
                                else np.int32))
    assert qw.nbytes == jw.nbytes
    with pytest.raises(AssertionError):
        tq.quantize_leaf(torch.from_numpy(w), group, bits=4)


def test_eager_jax_divides_where_compiled_jax_multiplies():
    """The record of why the port multiplies by the reciprocal: the JAX
    codec run eagerly divides by 127, compiled it multiplies by
    ``f32(1 / 127)``; the port's scales are the compiled ones."""
    x = _x((1024, 256), 21)
    eager = np.asarray(jqc.quantize_blockwise(jnp.asarray(x), 256)[1])
    compiled = np.asarray(_jq_blockwise(jnp.asarray(x), 256, "int8")[1])
    port = tqc.quantize_blockwise(torch.from_numpy(x), 256)[1].numpy()
    np.testing.assert_array_equal(port.view(np.uint32),
                                  compiled.view(np.uint32))
    assert (eager != compiled).any()
