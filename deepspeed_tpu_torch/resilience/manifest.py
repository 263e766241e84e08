"""Checkpoint integrity: per-file SHA-256 manifest, tag discovery and
retention: the JAX package's ``resilience/manifest.py``.

``write_manifest`` runs at commit time (after ``checkpoint_engine.commit``
sealed every file of a tag, before ``latest`` advances);
``verify_manifest`` runs at load time. A torn write survives an
``os.replace`` rename only as a size/hash mismatch against the manifest,
which is exactly what load-time verification catches, and what the
newest→oldest fallback in ``runtime/checkpointing.py`` then recovers from.

Hashing "intent": a checkpoint engine that knows the bytes it *meant* to
write (``MsgpackCheckpointEngine`` records the SHA-256 its writer computed
on the fly in ``engine.written``) supplies those digests, so a write torn
between buffer and disk mismatches its own manifest. Files with no
recorded intent (``engine_state.json``, ``shardings.json``) are hashed from
disk.
"""

import hashlib
import json
import os
import re
import shutil
from typing import Dict, List, Optional, Tuple

from ..utils.logging import logger

__all__ = ["MANIFEST_NAME", "write_manifest", "verify_manifest",
           "list_tags", "gc_checkpoints", "file_sha256",
           "CheckpointLoadError"]

MANIFEST_NAME = "manifest.json"
_STEP_RE = re.compile(r"(\d+)\s*$")


class CheckpointLoadError(RuntimeError):
    """No loadable checkpoint. The message names the directory scanned and
    every tag found, so the fix (wrong dir vs. all tags corrupt vs. nothing
    ever saved) is actionable from the traceback alone.

    When the failure is a structure mismatch between the checkpoint and
    the live model, ``leaf_diff`` carries the per-leaf breakdown
    (``missing`` / ``extra`` / ``shape_mismatch`` — see
    elasticity/logical.py) so callers can react programmatically."""

    def __init__(self, message, leaf_diff=None):
        super().__init__(message)
        self.leaf_diff = leaf_diff


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _checkpoint_files(ckpt_dir: str) -> List[str]:
    """Every regular file of the tag, relative paths, manifest excluded.
    Recurses so orbax shard directories are covered file-by-file."""
    out = []
    for root, _dirs, files in os.walk(ckpt_dir):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), ckpt_dir)
            if rel != MANIFEST_NAME and not rel.endswith(".tmp"):
                out.append(rel)
    return sorted(out)


def write_manifest(ckpt_dir: str, tag: str = "",
                   intents: Optional[Dict[str, Tuple[str, int]]] = None
                   ) -> str:
    """Write ``<ckpt_dir>/manifest.json`` covering every file of the tag.

    ``intents`` maps absolute file path -> (sha256, size) of the bytes the
    writer intended; entries present there are trusted over a disk re-read.
    The manifest itself is written atomically (tmp + fsync + replace)."""
    intents = intents or {}
    files = {}
    for rel in _checkpoint_files(ckpt_dir):
        path = os.path.join(ckpt_dir, rel)
        intent = intents.get(os.path.abspath(path))
        if intent is not None:
            digest, size = intent
        else:
            digest, size = file_sha256(path), os.path.getsize(path)
        files[rel] = {"sha256": digest, "size": size}
    payload = json.dumps({"version": 1, "tag": str(tag), "files": files},
                         indent=2, sort_keys=True)
    out = os.path.join(ckpt_dir, MANIFEST_NAME)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, out)
    return out


def verify_manifest(ckpt_dir: str, require_manifest: bool = False
                    ) -> List[str]:
    """Verify a tag directory against its manifest. Returns a list of
    problems (empty = valid). A pre-resilience checkpoint with no manifest
    passes with a shallow existence check unless ``require_manifest``."""
    if not os.path.isdir(ckpt_dir):
        return [f"tag directory missing: {ckpt_dir}"]
    mpath = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        if require_manifest:
            return [f"no {MANIFEST_NAME} in {ckpt_dir}"]
        # legacy tag: at least the model states must exist and be non-empty
        states = os.path.join(ckpt_dir, "model_states.msgpack")
        if os.path.isfile(states) and os.path.getsize(states) > 0:
            return []
        if os.path.isdir(states):
            return []
        return [f"no manifest and no model_states.msgpack in {ckpt_dir}"]
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        entries = dict(manifest["files"])
    except (ValueError, KeyError, OSError) as e:
        return [f"unreadable manifest {mpath}: {e}"]
    problems = []
    for rel, meta in sorted(entries.items()):
        path = os.path.join(ckpt_dir, rel)
        if not os.path.isfile(path):
            problems.append(f"missing file: {rel}")
            continue
        size = os.path.getsize(path)
        if size != int(meta["size"]):
            problems.append(
                f"size mismatch: {rel} is {size} bytes, manifest says "
                f"{meta['size']} (truncated/partial write)")
            continue
        if file_sha256(path) != meta["sha256"]:
            problems.append(f"sha256 mismatch: {rel} (corrupt content)")
    return problems


def _tag_sort_key(load_dir: str, tag: str):
    """Newest-first ordering: the trailing step number when the tag carries
    one (global_step123), else directory mtime."""
    m = _STEP_RE.search(tag)
    if m:
        return (1, int(m.group(1)))
    try:
        return (0, os.path.getmtime(os.path.join(load_dir, tag)))
    except OSError:
        return (0, 0.0)


def list_tags(load_dir: str, newest_first: bool = True) -> List[str]:
    """Tag directories under ``load_dir`` that look like checkpoints (hold
    model_states.msgpack or a manifest), newest first."""
    if not os.path.isdir(load_dir):
        return []
    tags = []
    for name in os.listdir(load_dir):
        d = os.path.join(load_dir, name)
        if not os.path.isdir(d):
            continue
        if os.path.exists(os.path.join(d, "model_states.msgpack")) or \
                os.path.isfile(os.path.join(d, MANIFEST_NAME)):
            tags.append(name)
    tags.sort(key=lambda t: _tag_sort_key(load_dir, t),
              reverse=newest_first)
    return tags


def gc_checkpoints(save_dir: str, keep_last_n: int,
                   protect: Tuple[str, ...] = ()) -> List[str]:
    """Keep-last-N retention: remove the oldest tags beyond ``keep_last_n``.
    Never removes a protected tag or the tag ``latest`` points to. Returns
    the removed tag names."""
    if keep_last_n <= 0:
        return []
    protected = set(protect)
    latest_path = os.path.join(save_dir, "latest")
    if os.path.isfile(latest_path):
        with open(latest_path) as f:
            protected.add(f.read().strip())
    tags = list_tags(save_dir, newest_first=True)
    removed = []
    for tag in tags[keep_last_n:]:
        if tag in protected:
            continue
        try:
            shutil.rmtree(os.path.join(save_dir, tag))
            removed.append(tag)
        except OSError as e:  # retention must never fail the save
            logger.warning(f"checkpoint GC could not remove {tag}: {e}")
    if removed:
        logger.info(f"checkpoint GC: removed {len(removed)} old tag(s): "
                    f"{removed}")
    return removed
