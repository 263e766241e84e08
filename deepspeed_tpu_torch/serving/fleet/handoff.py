"""KV handoff: a prefill's state crossing from a ``prefill``-role serving
engine to a ``decode``-role one, the JAX package's
``serving/fleet/handoff.py``.

The boundary object is ``KVHandoff``: one slot lane (the prompt's K/V,
``slot_extract_lane``'s host tensors), the sampled first token and the
request's sampling law, so the decode side continues the stream bit for
bit. ``to_bytes`` / ``from_bytes`` frame it as the JAX package does: the
magic ``DSKV1\\n``, a little-endian u32 header length, a JSON header
(metadata, then each buffer's path, numpy dtype string and shape), then
the raw little-endian buffers in header order. Frames cross between the
two packages: numpy has no bfloat16, and the JAX package writes a bf16
buffer's dtype as ``'<V2'`` (ml_dtypes' 2-byte void), so the port writes
``'<V2'`` for a bf16 lane and reads any 2-byte void buffer as
``torch.bfloat16``. An int8 pool's lane (``inference/kv_quant.py``)
travels as its payload and scales, the JAX package's ``q/<k|v>`` and
``scales/<k|v>`` buffers with ``"quantized": true`` in the header: the
wire carries the quantized lane, and the decode pool inserts it verbatim.
"""

import dataclasses
import json
import struct
import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["KVHandoff", "InProcessTransport"]

_MAGIC = b"DSKV1\n"
_BF16 = "<V2"


def _dtype_str(t: torch.Tensor) -> str:
    """The numpy dtype string the JAX package writes for a buffer."""
    if t.dtype == torch.bfloat16:
        return _BF16
    return np.dtype(str(t.dtype).replace("torch.", "")).str


def _raw(t: torch.Tensor) -> bytes:
    """A tensor's bytes, little-endian, row-major."""
    return t.detach().to("cpu").contiguous().view(torch.uint8).numpy() \
        .tobytes()


def _flatten_lane(lane):
    """``(ordered (path, tensor) pairs, quantized?)`` of either lane
    flavor."""
    from ...inference.kv_quant import QuantizedSlotPool
    if isinstance(lane, QuantizedSlotPool):
        pairs = [(f"q/{k}", v) for k, v in sorted(lane.q.items())]
        pairs += [(f"scales/{k}", v) for k, v in sorted(lane.scales.items())]
        return pairs, True
    return sorted(lane.items()), False


def _unflatten_lane(pairs, quantized: bool):
    if not quantized:
        return dict(pairs)
    from ...inference.kv_quant import QuantizedSlotPool
    q = {k[len("q/"):]: v for k, v in pairs.items() if k.startswith("q/")}
    s = {k[len("scales/"):]: v for k, v in pairs.items()
         if k.startswith("scales/")}
    return QuantizedSlotPool(q, s)


def _view(blob, dtype: str, shape, offset: int) -> torch.Tensor:
    """A tensor over ``blob``'s bytes (no copy) of a header's dtype and
    shape; a 2-byte void is bfloat16."""
    dt = np.dtype(dtype)
    count = int(np.prod(shape)) if shape else 1
    tdtype = torch.bfloat16 if dt.kind == "V" and dt.itemsize == 2 else \
        torch.from_numpy(np.empty(0, dt)).dtype
    with warnings.catch_warnings():
        # a bytes frame is read-only; the lane is only read (an insert
        # copies it into the pool)
        warnings.filterwarnings("ignore", message=".*not writable.*")
        out = torch.frombuffer(blob, dtype=tdtype, count=count,
                               offset=offset)
    return out.reshape(shape)


@dataclasses.dataclass
class KVHandoff:
    """One completed prefill, ready for a decode pool.

    ``lane`` is ``{"k", "v": [L, 1, H_kv, max_len, hd]}`` host tensors
    shaped like one pool slot; ``kv_len`` says how many columns are
    valid (the insert copies the whole lane and the decode mask never
    reads past ``kv_len`` until the columns are rewritten).
    ``first_token`` was already sampled and delivered (TTFT happens on
    the prefill side); decode feeds it at column ``kv_len``."""
    prompt: np.ndarray              # int32 [T]: the prefilled tokens
    first_token: int
    kv_len: int                     # valid cache columns (== len(prompt))
    lane: Any                       # {"k", "v"} host tensors
    temperature: float = 0.0
    #: the rest of the sampling law: the decode side must reproduce the
    #: prefill side's stream bit for bit
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    request_id: Optional[int] = None
    source: Optional[str] = None    # producing replica name
    tenant: Optional[str] = None
    #: the JAX package's distributed trace header, carried as a plain
    #: dict (the trace context itself is ROADMAP.md row A12)
    trace: Optional[Dict[str, Any]] = None
    #: the producing engine's weights_version: a decode engine whose own
    #: version differs refuses the lane and prefills locally. ``None``
    #: means a producer without versions (accepted).
    weights_version: Optional[int] = None

    # ------------------------------------------------------------- framing
    def to_bytes(self) -> bytes:
        """Magic, u32 header length, JSON header, then raw buffers in
        header order (the JAX package's frame)."""
        pairs, quantized = _flatten_lane(self.lane)
        header = {
            "prompt": [int(t) for t in np.asarray(self.prompt).reshape(-1)],
            "first_token": int(self.first_token),
            "kv_len": int(self.kv_len),
            "temperature": float(self.temperature),
            "top_k": int(self.top_k),
            "top_p": float(self.top_p),
            "seed": int(self.seed),
            "max_new_tokens": int(self.max_new_tokens),
            "eos_token_id": self.eos_token_id,
            "request_id": self.request_id,
            "source": self.source,
            "tenant": self.tenant,
            "trace": self.trace,
            "weights_version": self.weights_version,
            "quantized": quantized,
            "buffers": [{"path": p, "dtype": _dtype_str(t),
                         "shape": list(t.shape)} for p, t in pairs],
        }
        hdr = json.dumps(header).encode("utf-8")
        out = [_MAGIC, struct.pack("<I", len(hdr)), hdr]
        out += [_raw(t) for _p, t in pairs]
        return b"".join(out)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "KVHandoff":
        """Parse a frame (either package's). The lane's tensors are views
        of ``blob``."""
        if blob[:len(_MAGIC)] != _MAGIC:
            raise ValueError("not a KVHandoff frame (bad magic)")
        off = len(_MAGIC)
        (hlen,) = struct.unpack_from("<I", blob, off)
        off += 4
        header = json.loads(blob[off:off + hlen].decode("utf-8"))
        off += hlen
        lane = {}
        for buf in header["buffers"]:
            t = _view(blob, buf["dtype"], buf["shape"], off)
            lane[buf["path"]] = t
            off += t.numel() * t.element_size()
        return cls(
            prompt=np.asarray(header["prompt"], np.int32),
            first_token=header["first_token"],
            kv_len=header["kv_len"],
            lane=_unflatten_lane(lane, bool(header.get("quantized"))),
            temperature=header["temperature"],
            top_k=header.get("top_k", 0),
            top_p=header.get("top_p", 1.0),
            seed=header.get("seed", 0),
            max_new_tokens=header["max_new_tokens"],
            eos_token_id=header["eos_token_id"],
            request_id=header["request_id"],
            source=header["source"],
            tenant=header.get("tenant"),
            trace=header.get("trace"),
            weights_version=header.get("weights_version"))

    def nbytes(self) -> int:
        """Payload bytes a transport would move (the lane's buffers)."""
        return sum(t.numel() * t.element_size()
                   for _, t in _flatten_lane(self.lane)[0])


class InProcessTransport:
    """The trivial transport: deliver the handoff object to a sink
    callable in the same process. A transport between hosts would ship
    ``handoff.to_bytes()`` behind the same ``send``."""

    def __init__(self, sink: Callable[[KVHandoff, Any], None]):
        self._sink = sink
        self.sent = 0
        self.bytes_moved = 0

    def send(self, handoff: KVHandoff, request: Any = None):
        self.sent += 1
        self.bytes_moved += handoff.nbytes()
        self._sink(handoff, request)
