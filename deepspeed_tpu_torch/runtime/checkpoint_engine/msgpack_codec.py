"""The checkpoint file format of the JAX package, streamed: the subset of
msgpack that ``flax.serialization.msgpack_serialize`` /
``msgpack_restore`` write and read, in pure Python over numpy and torch.

The format, as flax writes it:

- nested maps (keys in sorted order, as ``jax.tree_util`` rebuilds dicts),
  arrays (lists), ``None``, bool, int, float (float64), str and bytes, in
  msgpack's smallest encodings (``use_bin_type=True``); a tuple is refused,
  as flax's ``strict_types`` packer refuses it;
- an array as msgpack ext type 1, whose payload is the msgpack of
  ``(shape, dtype name, C-order bytes)``; a numpy scalar as ext type 3 (its
  0-d array);
- an array that is a map value (or the whole tree) and holds more than
  ``MAX_CHUNK_SIZE`` bytes as the map ``{"__msgpack_chunked_array__": True,
  "shape": {"0": d0, ...}, "chunks": {"0": flat[:c], "1": ...}}``, keys in
  that order, ``c = MAX_CHUNK_SIZE // itemsize`` elements a chunk;
- ``bfloat16`` named ``"bfloat16"``; numpy has no such type, so it is read
  back as a ``torch.bfloat16`` tensor.

Neither side builds the file in memory. ``serialize`` writes each array's
ext header from its shape and dtype, then its bytes straight from the host
copy (a numpy array, a torch tensor on any device, or an ``ArrayLeaf``
whose bytes come in pieces, e.g. one layer of a stacked leaf at a time),
and returns the file's SHA-256 and length, hashed on the fly. ``restore``
reads each array into a buffer allocated for it (``readinto``), and hands
every array to ``on_leaf``, whose result takes its place in the tree: a
loader moves each leaf to its device there and drops the host copy, so the
host holds one leaf at a time. For the same tree, the bytes are flax's.
"""

import hashlib
import io
import math
import struct
import time
from typing import Any, Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["MAX_CHUNK_SIZE", "ArrayLeaf", "Digest", "serialize", "restore",
           "describe", "dumps", "loads", "dtype_name"]

#: an array above this many bytes is split into chunks (flax's constant)
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
_READ_BLOCK = 1 << 30           # one os read moves at most ~2 GiB

_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8", torch.bool: "bool"}


def dtype_name(dtype) -> str:
    """The flax name of a numpy dtype, a torch dtype or a name."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_NAMES:
            raise TypeError(f"no checkpoint encoding for {dtype}")
        return _TORCH_NAMES[dtype]
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def _itemsize(name: str) -> int:
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


class ArrayLeaf:
    """An array known by its shape and dtype whose C-order bytes come from
    ``pieces()``, an iterable of host arrays (numpy or CPU torch) produced
    while it is written: the writer holds one piece at a time."""

    __slots__ = ("shape", "dtype", "pieces")

    def __init__(self, shape, dtype, pieces: Callable[[], Iterable]):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype_name(dtype)
        self.pieces = pieces

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * _itemsize(self.dtype)


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor, ArrayLeaf))


def _bytes_of(a) -> memoryview:
    """The C-order bytes of a host array as a flat byte view."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.device.type != "cpu":
            a = a.cpu()
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        a = a.numpy()
    a = np.ascontiguousarray(a)
    return memoryview(a.reshape(-1).view(np.uint8))


def _array_parts(x):
    """``(shape, dtype name, nbytes, byte pieces)`` of an array leaf."""
    if isinstance(x, ArrayLeaf):
        return x.shape, x.dtype, x.nbytes, (_bytes_of(p) for p in x.pieces())
    name = dtype_name(x.dtype)
    shape = tuple(int(d) for d in x.shape)
    return shape, name, math.prod(shape) * _itemsize(name), \
        (_bytes_of(p) for p in (x,))


# ---------------------------------------------------------------- headers

def _int(v: int) -> bytes:
    if v >= 0:
        if v < 0x80:
            return bytes([v])
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if v <= top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        if v >= -0x20:
            return struct.pack(">b", v)
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if v >= low:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"int {v} does not fit msgpack")


def _sized(n: int, fix: Optional[int], fixmax: int, codes) -> bytes:
    """Header of a str/bin/array/map of ``n`` entries: the fix form below
    ``fixmax``, else the 8/16/32-bit length form that fits."""
    if fix is not None and n < fixmax:
        return bytes([fix | n])
    for code, fmt, top in codes:
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"length {n} does not fit msgpack")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xa0, 32, ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff),
                                     (0xdb, ">I", 0xffffffff))) + b


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff),
                               (0xc6, ">I", 0xffffffff)))


def _array_header(n: int) -> bytes:
    return _sized(n, 0x90, 16, ((None, "", 0), (0xdc, ">H", 0xffff),
                                (0xdd, ">I", 0xffffffff)))


def _map_header(n: int) -> bytes:
    return _sized(n, 0x80, 16, ((None, "", 0), (0xde, ">H", 0xffff),
                                (0xdf, ">I", 0xffffffff)))


_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


def _ext_header(code: int, n: int) -> bytes:
    if n in _FIXEXT:
        return bytes([_FIXEXT[n], code])
    for ext, fmt, top in ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff),
                          (0xc9, ">I", 0xffffffff)):
        if n <= top:
            return bytes([ext]) + struct.pack(fmt, n) + bytes([code])
    raise OverflowError(f"ext of {n} bytes does not fit msgpack")


def _ndarray_head(shape, name: str, nbytes: int, code=_EXT_NDARRAY) -> bytes:
    """Everything of an array's ext before its data bytes: the ext header
    (its length counted from the shape and dtype) and the payload's
    ``(shape, name, bin header)``."""
    inner = (_array_header(3) + _array_header(len(shape)) +
             b"".join(_int(d) for d in shape) + _str(name) +
             _bin_header(nbytes))
    return _ext_header(code, len(inner) + nbytes) + inner


# ------------------------------------------------------------------ writer

class Digest(NamedTuple):
    sha256: str             # hex digest of the bytes written
    size: int               # bytes written
    hash_seconds: float     # host time spent hashing them


class _Writer:
    def __init__(self, f):
        self.f = f
        self.sha = hashlib.sha256()
        self.size = 0
        self.hash_s = 0.0
        self.rest = None        # the unwritten end of the last piece

    def write(self, b):
        t = time.perf_counter()
        self.sha.update(b)
        self.hash_s += time.perf_counter() - t
        self.f.write(b)
        self.size += len(b)

    def stream(self, pieces, n: int):
        """Write the next ``n`` bytes of the byte-piece iterator (a piece
        that straddles the end keeps its rest in ``self.rest``)."""
        while n:
            piece = self.rest if self.rest is not None else \
                next(pieces, None)
            if piece is None:
                raise ValueError(f"array pieces end {n} bytes short")
            self.rest = None
            if len(piece) > n:
                piece, self.rest = piece[:n], piece[n:]
            self.write(piece)
            n -= len(piece)


def _pack_array(x, w: _Writer, chunkable: bool):
    shape, name, nbytes, pieces = _array_parts(x)
    if chunkable and nbytes > MAX_CHUNK_SIZE:
        item = _itemsize(name)
        per = max(1, int(MAX_CHUNK_SIZE / item))
        total = math.prod(shape)
        starts = range(0, total, per)
        w.write(_map_header(3) + _str(_CHUNKED) + b"\xc3" + _str("shape") +
                _map_header(len(shape)) +
                b"".join(_str(str(i)) + _int(d) for i, d in enumerate(shape)) +
                _str("chunks") + _map_header(len(starts)))
        for i, s in enumerate(starts):
            count = min(per, total - s)
            w.write(_str(str(i)) + _ndarray_head((count,), name, count * item))
            w.stream(pieces, count * item)
    else:
        w.write(_ndarray_head(shape, name, nbytes))
        w.stream(pieces, nbytes)
    if (w.rest is not None and len(w.rest)) or any(len(p) for p in pieces):
        raise ValueError(f"array pieces hold more than {nbytes} bytes")
    w.rest = None


def _pack(obj, w: _Writer, chunkable: bool = False):
    t = type(obj)
    if obj is None:
        w.write(b"\xc0")
    elif obj is True or obj is False:
        w.write(b"\xc3" if obj else b"\xc2")
    elif t is int:
        w.write(_int(obj))
    elif t is float:
        w.write(b"\xcb" + struct.pack(">d", obj))
    elif t is str:
        w.write(_str(obj))
    elif t is bytes:
        w.write(_bin_header(len(obj)) + obj)
    elif t is dict:
        w.write(_map_header(len(obj)))
        for k in sorted(obj):
            _pack(k, w)
            _pack(obj[k], w, chunkable=True)
    elif t is list:
        w.write(_array_header(len(obj)))
        for v in obj:
            _pack(v, w)
    elif _is_array(obj):
        _pack_array(obj, w, chunkable)
    elif isinstance(obj, np.generic):
        a = np.asarray(obj)
        w.write(_ndarray_head((), a.dtype.name, a.nbytes, _EXT_NPSCALAR))
        w.write(_bytes_of(a))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def serialize(tree, f) -> Digest:
    """Write ``tree`` to the binary file ``f`` in flax's msgpack format,
    streaming each array; returns the bytes' SHA-256, length and hashing
    time."""
    w = _Writer(f)
    _pack(tree, w, chunkable=True)
    return Digest(w.sha.hexdigest(), w.size, w.hash_s)


def dumps(tree) -> bytes:
    """``serialize`` into bytes (``flax.serialization.msgpack_serialize``)."""
    buf = io.BytesIO()
    serialize(tree, buf)
    return buf.getvalue()


# ------------------------------------------------------------------ reader

_SCALARS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
            0xca: ">f", 0xcb: ">d"}
_STR, _BIN = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}, \
    {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
_ARRAY, _MAP = {0xdc: ">H", 0xdd: ">I"}, {0xde: ">H", 0xdf: ">I"}
_EXT = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_FIXEXT_SIZE = {v: k for k, v in _FIXEXT.items()}


def _empty(count: int, name: str):
    """A flat host buffer for ``count`` elements: numpy, or a torch tensor
    for bfloat16."""
    if name == "bfloat16":
        return torch.empty(count, dtype=torch.bfloat16)
    return np.empty(count, dtype=np.dtype(name))


def _view(buf) -> memoryview:
    if isinstance(buf, torch.Tensor):
        buf = buf.view(torch.int16).numpy()
    return memoryview(buf.reshape(-1).view(np.uint8))


def _unchunk(d):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if any(isinstance(c, torch.Tensor) for c in chunks):
        flat = torch.cat([torch.as_tensor(c) for c in chunks])
    else:
        flat = np.concatenate(chunks)
    return flat.reshape(shape)


class _Reader:
    def __init__(self, f, on_leaf):
        self.f = f
        self.on_leaf = on_leaf
        self.chunked_paths = []

    def take(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise ValueError(f"truncated checkpoint stream: wanted {n} "
                             f"bytes, got {len(b)}")
        return b

    def fill(self, mv: memoryview):
        done = 0
        while done < len(mv):
            got = self.f.readinto(mv[done:done + _READ_BLOCK])
            if not got:
                raise ValueError(f"truncated checkpoint stream: an array "
                                 f"wanted {len(mv)} bytes, got {done}")
            done += got

    def unpack_from(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def alloc(self, count: int, name: str):
        return _empty(count, name)

    def read_into(self, flat, offset: int, count: int):
        self.fill(_view(flat[offset:offset + count]))

    def leaf(self, path, value, parts: bool):
        return value if parts or self.on_leaf is None else \
            self.on_leaf(path, value)

    # --------------------------------------------------------------- values
    def value(self, path=(), chunkable=False, parts=False):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f, path, chunkable, parts)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f, path, parts)
        if 0xa0 <= b <= 0xbf:
            return self.take(b & 0x1f).decode("utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self.unpack_from(_SCALARS[b])
        if b in _STR:
            return self.take(self.unpack_from(_STR[b])).decode("utf-8")
        if b in _BIN:
            return self.take(self.unpack_from(_BIN[b]))
        if b in _ARRAY:
            return self.array(self.unpack_from(_ARRAY[b]), path, parts)
        if b in _MAP:
            return self.map(self.unpack_from(_MAP[b]), path, chunkable,
                            parts)
        if b in _EXT or b in _FIXEXT_SIZE:
            return self.ext(*self.ext_head(b), path, parts)
        raise ValueError(f"not a msgpack type byte: 0x{b:02x}")

    def ext_head(self, b):
        """``(type code, payload size)`` after the ext's first byte."""
        size = _FIXEXT_SIZE.get(b)
        if size is None:
            size = self.unpack_from(_EXT[b])
        return self.take(1)[0], size

    def array(self, n, path, parts):
        return [self.value(path + (i,), parts=parts) for i in range(n)]

    def map(self, n, path, chunkable, parts):
        out = {}
        for i in range(n):
            key = self.value()
            if i == 0 and key == _CHUNKED and chunkable:
                out[key] = self.value()
                return self.chunked(n - 1, out, path, parts)
            out[key] = self.value(path + (key,), chunkable=True, parts=parts)
        if chunkable and _CHUNKED in out:
            return self.leaf(path, _unchunk(out), parts)
        return out

    def chunked(self, n, out, path, parts):
        """A chunked array, read chunk by chunk into one buffer when its
        shape comes before its chunks (flax's order)."""
        flat = None
        for _ in range(n):
            key = self.value()
            if key == "chunks" and "shape" in out:
                shape = tuple(out["shape"][str(i)]
                              for i in range(len(out["shape"])))
                flat = self.chunks_into(math.prod(shape))
                out[key] = None
            else:
                out[key] = self.value(path + (key,), parts=True)
        arr = flat.reshape(shape) if flat is not None else _unchunk(out)
        self.chunked_paths.append(path)
        return self.leaf(path, arr, parts)

    def chunks_into(self, total: int):
        b = self.take(1)[0]
        n = b & 0x0f if 0x80 <= b <= 0x8f else self.unpack_from(_MAP[b])
        flat, offset = None, 0
        for i in range(n):
            if self.value() != str(i):
                raise ValueError("chunked array: chunks out of order")
            code, size = self.ext_head(self.take(1)[0])
            if code != _EXT_NDARRAY:
                raise ValueError("chunked array: a chunk is not an ndarray")
            shape, name, nbytes = self.payload_head(size)
            if flat is None:
                flat = self.alloc(total, name)
            count = nbytes // _itemsize(name)
            self.read_into(flat, offset, count)
            offset += count
        if offset != total:
            raise ValueError(f"chunked array holds {offset} of {total} "
                             f"elements")
        return flat

    def payload_head(self, size):
        """Parse an ndarray payload up to its data: ``(shape, dtype name,
        data bytes)``, checked against the ext's ``size``."""
        start = self.f.tell() if hasattr(self.f, "tell") else None
        if self.take(1)[0] != 0x93:
            raise ValueError("ndarray payload is not a 3-tuple")
        shape = tuple(self.value())
        name = self.value()
        if isinstance(name, bytes):
            name = name.decode()
        nbytes = self.unpack_from(_BIN[self.take(1)[0]])
        if start is not None and self.f.tell() - start + nbytes != size:
            raise ValueError("ndarray payload length disagrees with its ext")
        if nbytes != math.prod(shape) * _itemsize(name):
            raise ValueError(f"ndarray of shape {shape} {name} holds "
                             f"{nbytes} bytes")
        return shape, name, nbytes

    def ext(self, code, size, path, parts):
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, name, nbytes = self.payload_head(size)
            buf = self.alloc(math.prod(shape), name)
            self.read_into(buf, 0, buf.shape[0])
            arr = buf.reshape(shape)
            if code == _EXT_NPSCALAR:
                return arr[()]
            return self.leaf(path, arr, parts)
        raise ValueError(f"unknown msgpack ext type {code}")


def restore(f, on_leaf: Optional[Callable[[tuple, Any], Any]] = None):
    """Read a tree written in flax's msgpack format from the binary file
    ``f``. Arrays come back as numpy arrays (bfloat16 as torch tensors);
    ``on_leaf(path, array)``, when given, is called on each one as it is
    read (path: the tuple of map keys and list indices) and its result
    takes the array's place. Raises ``ValueError`` on a truncated or
    malformed stream, or bytes after the tree (msgpack's ``ExtraData``)."""
    tree = _Reader(f, on_leaf).value(chunkable=True)
    if f.read(1):
        raise ValueError("extra data after the checkpoint tree")
    return tree


class _Spec:
    """A skimmed array: its shape and dtype name, no data."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype

    def reshape(self, shape):
        return _Spec(shape, self.dtype)

    def __getitem__(self, index):
        return self


class _Skimmer(_Reader):
    """Reads a file's structure and seeks over the array data."""

    def alloc(self, count, name):
        return _Spec((count,), name)

    def read_into(self, flat, offset, count):
        self.f.seek(count * _itemsize(flat.dtype), 1)


def describe(f):
    """The leaves of a checkpoint file without reading their data:
    ``({path: (shape, dtype name)}, [paths of chunked leaves])``, paths
    ``/``-joined. ``f`` must be seekable."""
    leaves = {}

    def on_leaf(path, spec):
        leaves["/".join(str(k) for k in path)] = (spec.shape, spec.dtype)
        return None
    reader = _Skimmer(f, on_leaf)
    reader.value(chunkable=True)
    return leaves, ["/".join(str(k) for k in p)
                    for p in reader.chunked_paths]


def loads(data: bytes, on_leaf=None):
    """``restore`` from bytes (``flax.serialization.msgpack_restore``)."""
    return restore(io.BytesIO(data), on_leaf)
