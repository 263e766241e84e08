"""The port's msgpack codec (``runtime/checkpoint_engine/msgpack_codec.py``)
held byte for byte to ``flax.serialization.msgpack_serialize`` /
``msgpack_restore``, the writer of the JAX package's checkpoint files:
trees of f32, bf16, f16, int32, bool, 0-d and numpy scalars, None, nested
dicts and lists, and chunked leaves (both packages' chunk size lowered to
a few hundred bytes so small arrays chunk). Each side reads the other's
bytes."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from deepspeed_tpu_torch.runtime.checkpoint_engine import msgpack_codec as codec


def _rng(seed=0):
    return np.random.default_rng(seed)


def _trees():
    r = _rng()
    return {
        "f32": {"w": r.standard_normal((3, 5)).astype(np.float32)},
        "f16 int32 bool": {"h": r.standard_normal((4, 6)).astype(np.float16),
                           "i": r.integers(-9, 9, (7,)).astype(np.int32),
                           "m": r.random((2, 3)) > 0.5},
        "scalars": {"count": np.asarray(3, np.int32),
                    "np": np.float32(1.5), "npi": np.int64(-4),
                    "py": [0, 127, 128, -1, -33, 255, 256, 65536, 2 ** 40,
                           -(2 ** 40), 1.25, True, False, None]},
        "nested": {"z": {"b": None, "a": [np.arange(5), {"q": "x" * 40}]},
                   "a": {}, "l": [], "s": "é", "raw": b"\x00\x01"},
        "uint8 fixext sizes": {f"n{n}": np.zeros(n, np.uint8)
                               for n in range(0, 9)},
        "wide ints": {"u": np.arange(300, dtype=np.int64).reshape(3, 100)},
        "long containers": {"l": list(range(20)),
                            "d": {f"k{i:02d}": i for i in range(20)}},
        "adam-like": {"opt_state": {"count": np.asarray(2, np.int32),
                                    "mu": {"w": np.ones((2, 2), np.float32)},
                                    "nu": {"w": np.zeros((2, 2),
                                                         np.float32)}},
                      "offload": None,
                      "scaler": {"scale": 65536.0, "good_steps": 3,
                                 "hysteresis": 2}},
    }


def _equal(got, want):
    """Same structure and bit-equal leaves (numpy or torch)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    elif isinstance(want, torch.Tensor) or isinstance(got, torch.Tensor):
        a = got if isinstance(got, torch.Tensor) else torch.from_numpy(
            np.asarray(got))
        b = want if isinstance(want, torch.Tensor) else torch.from_numpy(
            np.asarray(want))
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("name", sorted(_trees()))
def test_bytes_equal_flax_and_each_reads_the_other(name):
    tree = _trees()[name]
    want = serialization.msgpack_serialize(tree)
    assert codec.dumps(tree) == want
    _equal(codec.loads(want), serialization.msgpack_restore(want))
    _equal(serialization.msgpack_restore(codec.dumps(tree)),
           serialization.msgpack_restore(want))


def test_bf16_is_flax_bfloat16_and_reads_back_as_torch():
    x = _rng(1).standard_normal((4, 6)).astype(np.float32)
    want = serialization.msgpack_serialize(
        {"w": jnp.asarray(x, jnp.bfloat16), "s": jnp.bfloat16(2.5)})
    t = torch.from_numpy(x).to(torch.bfloat16)
    got = codec.dumps({"w": t, "s": torch.tensor(2.5, dtype=torch.bfloat16)})
    assert got == want
    back = codec.loads(want)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], t)
    flax_back = serialization.msgpack_restore(got)
    np.testing.assert_array_equal(
        np.asarray(flax_back["w"], np.float32), t.float().numpy())


@pytest.fixture
def small_chunks(monkeypatch):
    """Both packages chunk arrays above 256 bytes."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(codec, "MAX_CHUNK_SIZE", 256)


@pytest.mark.parametrize("dtype", ["float32", "float16", "int32", "bool",
                                   "int64"])
def test_chunked_leaves_equal_flax(small_chunks, dtype):
    r = _rng(2)
    big = r.standard_normal((23, 17)).astype(dtype)
    tree = {"big": big, "small": np.arange(3, dtype=np.int32),
            "in_list": [big],            # flax chunks dict values only
            "deep": {"x": big.reshape(-1)}}
    want = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in want
    assert codec.dumps(tree) == want
    _equal(codec.loads(want), serialization.msgpack_restore(want))
    top = big.reshape(-1)                # a whole-tree array chunks too
    assert codec.dumps(top) == serialization.msgpack_serialize(top)
    np.testing.assert_array_equal(
        codec.loads(serialization.msgpack_serialize(top)), top)


def test_chunked_bf16_and_streamed_pieces(small_chunks):
    x = torch.from_numpy(_rng(3).standard_normal((5, 40)).astype(
        np.float32)).to(torch.bfloat16)
    want = serialization.msgpack_serialize(
        {"w": jnp.asarray(x.float().numpy(), jnp.bfloat16)})
    assert codec.dumps({"w": x}) == want
    # the same leaf written a row at a time (how a stacked leaf is written)
    rows = codec.ArrayLeaf(x.shape, torch.bfloat16, lambda: list(x))
    assert codec.dumps({"w": rows}) == want
    assert torch.equal(codec.loads(want)["w"], x)


def test_array_leaf_streams_pieces_of_any_size():
    x = _rng(4).standard_normal((6, 7)).astype(np.float32)
    flat = x.reshape(-1)
    cuts = [0, 5, 5, 17, 41, 42]
    pieces = [flat[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    leaf = codec.ArrayLeaf(x.shape, np.float32, lambda: pieces)
    assert codec.dumps({"x": leaf}) == serialization.msgpack_serialize(
        {"x": x})
    short = codec.ArrayLeaf(x.shape, np.float32, lambda: pieces[:-1])
    with pytest.raises(ValueError, match="short"):
        codec.dumps({"x": short})
    extra = codec.ArrayLeaf((2,), np.float32, lambda: [flat[:3]])
    with pytest.raises(ValueError, match="more than"):
        codec.dumps({"x": extra})


def test_serialize_reports_digest_and_restore_calls_on_leaf(tmp_path):
    import hashlib
    tree = _trees()["adam-like"]
    path = tmp_path / "s.msgpack"
    with open(path, "wb") as f:
        digest = codec.serialize(tree, f)
    data = path.read_bytes()
    assert digest.size == len(data)
    assert digest.sha256 == hashlib.sha256(data).hexdigest()
    seen = []

    def on_leaf(p, arr):
        seen.append(p)
        return ("moved", arr.shape)
    with open(path, "rb") as f:
        back = codec.restore(f, on_leaf)
    assert seen == [("opt_state", "count"), ("opt_state", "mu", "w"),
                    ("opt_state", "nu", "w")]
    assert back["opt_state"]["mu"]["w"] == ("moved", (2, 2))
    assert back["scaler"] == tree["scaler"]


def test_refusals_match_flax():
    for bad in ({"t": (1, 2)}, {"o": object()}):
        with pytest.raises(TypeError):
            serialization.msgpack_serialize(bad)
        with pytest.raises(TypeError):
            codec.dumps(bad)
    data = serialization.msgpack_serialize(_trees()["f32"])
    with pytest.raises(ValueError, match="truncated"):
        codec.loads(data[:len(data) // 2])
    with pytest.raises(ValueError):
        codec.loads(b"\xc1")
    flipped = bytes([data[0] ^ 0xFF]) + data[1:]     # io_read_corrupt
    with pytest.raises(ValueError):
        serialization.msgpack_restore(flipped)
    with pytest.raises(ValueError, match="extra data"):
        codec.loads(flipped)


def test_torch_cpu_tensors_write_as_numpy():
    x = _rng(5).standard_normal((3, 3)).astype(np.float32)
    tree_np = {"a": x, "b": np.arange(4, dtype=np.int32),
               "m": np.array([True, False])}
    tree_t = {k: torch.from_numpy(v) for k, v in tree_np.items()}
    assert codec.dumps(tree_t) == serialization.msgpack_serialize(tree_np)
    stream = io.BytesIO()
    codec.serialize(tree_t, stream)
    assert stream.getvalue() == codec.dumps(tree_np)


def test_describe_reads_the_structure_only(small_chunks, tmp_path):
    big = _rng(6).standard_normal((23, 17)).astype(np.float32)
    tree = {"blocks": {"w": big, "b": np.zeros(3, np.float16)},
            "count": np.asarray(1, np.int32), "s": np.float32(2),
            "scaler": {"scale": 1.0}, "none": None}
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    with open(path, "rb") as f:
        leaves, chunked = codec.describe(f)
        assert f.tell() == path.stat().st_size
    assert leaves == {"blocks/b": ((3,), "float16"),
                      "blocks/w": ((23, 17), "float32"),
                      "count": ((), "int32")}
    assert chunked == ["blocks/w"]
