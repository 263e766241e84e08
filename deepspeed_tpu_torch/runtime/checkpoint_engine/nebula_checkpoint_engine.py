"""Nebula-style async + tiered checkpoint engine: the JAX package's
``runtime/checkpoint_engine/nebula_checkpoint_engine.py``.

The reference Nebula service is proprietary; its behaviour contract is
reproduced:

  - save() enqueues to a background writer thread, so serialization of
    one state file overlaps the gathering of the next (``save_checkpoint``
    commits, and so waits, before returning, which also keeps the live
    masters from changing while they are written);
  - commit(tag) seals a version: waits for the tag's writes, then copies
    it to the persistent storage tier (``persistent_storage_path``);
  - only the newest ``num_of_version_in_retention`` versions are kept in
    the persistent tier;
  - load() prefers the persistent tier when ``enable_nebula_load`` is on
    and the primary file is missing.

Config block (reference nebula/config.py keys):
    "nebula": {"enabled": true, "persistent_storage_path": "...",
               "persistent_time_interval": 100,
               "num_of_version_in_retention": 2,
               "enable_nebula_load": true}
"""

import os
import queue
import shutil
import threading
from typing import Any, Optional

from ...utils.logging import log_dist, logger
from .checkpoint_engine import CheckpointEngine, MsgpackCheckpointEngine


class NebulaCheckpointEngine(CheckpointEngine):

    def __init__(self, config_params=None):
        super().__init__(config_params)
        cfg = dict(config_params or {})
        self.persistent_path: Optional[str] = cfg.get(
            "persistent_storage_path")
        self.retention = int(cfg.get("num_of_version_in_retention", 2))
        self.enable_load = bool(cfg.get("enable_nebula_load", True))
        self._inner = MsgpackCheckpointEngine()
        self._q: "queue.Queue" = queue.Queue()
        self._errors = []
        self._tag_files = {}
        self._cur_tag = None
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()
        log_dist(f"Nebula checkpoint engine: async writes, persistent "
                 f"tier={self.persistent_path or 'disabled'} "
                 f"retention={self.retention}", ranks=[0])

    # ---------------------------------------------------------- worker
    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            state, path, done = item
            try:
                self._inner.save(state, path)
            except Exception as e:  # surfaced at commit()
                self._errors.append((path, e))
            finally:
                done.set()

    # ------------------------------------------------------------- api
    def create(self, tag):
        self._cur_tag = str(tag)
        self._tag_files.setdefault(self._cur_tag, [])

    def save(self, state_dict: Any, path: str):
        done = threading.Event()
        self._q.put((state_dict, path, done))
        self._tag_files.setdefault(self._cur_tag, []).append((path, done))

    def load(self, path: str, map_location=None, on_leaf=None):
        if not os.path.exists(path) and self.enable_load and \
                self.persistent_path:
            alt = self._persistent_file(path)
            if alt and os.path.exists(alt):
                logger.info(f"nebula: primary {path} missing; loading the "
                            f"persistent-tier copy {alt}")
                path = alt
        return self._inner.load(path, map_location, on_leaf)

    def commit(self, tag):
        tag = str(tag)
        for _, done in self._tag_files.get(tag, []):
            done.wait()
        if self._errors:
            errs = self._errors
            self._errors = []
            raise IOError(f"nebula async writes failed: {errs}")
        if self.persistent_path:
            self._persist(tag)
            self._retire_old_versions()
        self._tag_files.pop(tag, None)  # sealed: drop the bookkeeping
        return True

    # ------------------------------------------------------- persistence
    def _persistent_file(self, path):
        """Map a primary checkpoint file to its persistent-tier twin."""
        tag = os.path.basename(os.path.dirname(path))
        return os.path.join(self.persistent_path, tag,
                            os.path.basename(path)) \
            if self.persistent_path else None

    def _persist(self, tag):
        dst_dir = os.path.join(self.persistent_path, tag)
        os.makedirs(dst_dir, exist_ok=True)
        for path, _ in self._tag_files.get(tag, []):
            if os.path.exists(path):
                shutil.copy2(path, os.path.join(dst_dir,
                                                os.path.basename(path)))
        log_dist(f"nebula: version {tag} sealed into {dst_dir}", ranks=[0])

    def _retire_old_versions(self):
        if not self.persistent_path or self.retention <= 0:
            return
        versions = sorted(
            (d for d in os.listdir(self.persistent_path)
             if os.path.isdir(os.path.join(self.persistent_path, d))),
            key=lambda d: os.path.getmtime(
                os.path.join(self.persistent_path, d)))
        for stale in versions[:-self.retention]:
            shutil.rmtree(os.path.join(self.persistent_path, stale),
                          ignore_errors=True)

    def close(self):
        self._q.put(None)
        self._worker.join(timeout=30)
