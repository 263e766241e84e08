"""Pluggable checkpoint persistence backend: the JAX package's
``runtime/checkpoint_engine/checkpoint_engine.py``.

The reference ``CheckpointEngine`` ABC (create/save/load/commit). The
default backend writes trees in flax's msgpack format through the port's
own codec (``msgpack_codec.py``), streamed leaf by leaf: the file is never
built in memory, and its SHA-256 is computed while it is written. The JAX
package's orbax engine (async, multi-host) has no counterpart: there is no
orbax on the card, so ``checkpoint.async_save`` warns and takes msgpack,
as the JAX package does when orbax is unavailable.
"""

import os
from typing import Any

from ...utils.logging import logger
from . import msgpack_codec


def _fsync_dir(path):
    """fsync a directory so a just-renamed entry survives a crash — the
    rename alone only orders the *file* data, not the directory entry."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without directory fds
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class CheckpointEngine:

    #: True if save() is a cross-process collective that must be invoked on
    #: every process; False if only the writer process calls save().
    collective = False

    def __init__(self, config_params=None):
        #: abs path -> (sha256, size) of the bytes save() INTENDED to write;
        #: the integrity manifest (resilience/manifest.py) trusts these over
        #: a disk re-read, so a torn write mismatches its own manifest
        self.written = {}

    def create(self, tag):
        """Notify start of a new checkpoint `tag`."""

    def makedirs(self, path, exist_ok=False):
        os.makedirs(path, exist_ok=exist_ok)

    def save(self, state_dict: Any, path: str):
        raise NotImplementedError

    def load(self, path: str, map_location=None) -> Any:
        raise NotImplementedError

    def commit(self, tag):
        """Flush/seal all files of `tag`."""
        return True


class _FlipFirstByte:
    """A binary file whose first byte reads inverted (``io_read_corrupt``)."""

    def __init__(self, f):
        self.f = f
        self.first = True

    def _flip(self, b):
        if self.first and len(b):
            b[0] ^= 0xFF
            self.first = False

    def read(self, n):
        b = bytearray(self.f.read(n))
        self._flip(b)
        return bytes(b)

    def readinto(self, mv):
        n = self.f.readinto(mv)
        self._flip(memoryview(mv)[:n].cast("B"))
        return n

    def tell(self):
        return self.f.tell()


class MsgpackCheckpointEngine(CheckpointEngine):
    """Default: one flax-msgpack file per state tree, streamed.

    ``last_digest`` holds the last save's ``Digest`` (SHA-256, bytes,
    hashing seconds). ``load(path, on_leaf=...)`` passes each array to
    ``on_leaf`` as it is read (``msgpack_codec.restore``)."""

    last_digest = None

    def save(self, state_dict, path):
        from ...resilience.faults import fault
        if fault("io_write_fail"):
            raise OSError(f"injected write failure: {path}")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            digest = msgpack_codec.serialize(state_dict, f)
            # record intent BEFORE the torn-write fault: a truncated file
            # then mismatches its own manifest, exactly like a real
            # mid-save crash
            self.written[os.path.abspath(path)] = (digest.sha256,
                                                   digest.size)
            if fault("io_truncate"):
                f.truncate(max(1, digest.size // 2))
            f.flush()
            # fsync before the rename: os.replace is atomic in the
            # namespace but NOT durable — a crash after an unfsynced
            # rename can persist a zero-length file under the final name
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(os.path.abspath(path)))
        self.last_digest = digest

    def load(self, path, map_location=None, on_leaf=None):
        from ...resilience.faults import fault
        with open(path, "rb") as f:
            src = _FlipFirstByte(f) if fault("io_read_corrupt") else f
            return msgpack_codec.restore(src, on_leaf)


_NEBULA_ENGINES = {}


def get_checkpoint_engine(config) -> CheckpointEngine:
    nebula = dict((getattr(config, "_param_dict", None) or {}).get(
        "nebula") or {})
    if nebula.get("enabled"):
        # the nebula block selects the async/tiered engine. One engine (and
        # one writer thread) per distinct config — get_checkpoint_engine
        # is called on every save/load and must not leak threads.
        key = tuple(sorted((k, str(v)) for k, v in nebula.items()))
        if key not in _NEBULA_ENGINES:
            from .nebula_checkpoint_engine import NebulaCheckpointEngine
            _NEBULA_ENGINES[key] = NebulaCheckpointEngine(nebula)
        return _NEBULA_ENGINES[key]
    if getattr(config, "checkpoint_config", None) and \
            getattr(config.checkpoint_config, "async_save", False):
        logger.warning("orbax engine unavailable (there is no orbax on the "
                       "card: async_save is not ported); using msgpack")
    return MsgpackCheckpointEngine()
