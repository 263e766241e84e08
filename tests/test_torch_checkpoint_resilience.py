"""The checkpoint fault tolerance of the port, driven as the JAX package's
``tests/unit/test_resilience.py`` and ``test_multinode_nebula.py`` drive
it: torn, corrupt or truncated tags fall back newest→oldest to the last
valid one, a missing ``latest`` and an all-corrupt directory raise naming
what was scanned, retried writes succeed, a failed save leaves ``latest``
alone, keep-last-N retention never removes ``latest``, and the Nebula
engine writes asynchronously into a persistent tier with retention. Faults
are armed on the port's own injector (``resilience/faults.py``)."""

import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.resilience import (CheckpointLoadError,
                                            gc_checkpoints, get_injector,
                                            list_tags, retry_io,
                                            verify_manifest, write_manifest)
from deepspeed_tpu_torch.resilience.retry import backoff_delays
from deepspeed_tpu_torch.runtime.checkpoint_engine import \
    checkpoint_engine as ce

TINY = GPT2Config(vocab_size=256, n_positions=64, n_embd=64, n_layer=2,
                  n_head=4, pad_vocab_to_multiple=8)


@pytest.fixture
def faultinject():
    inj = get_injector().reset()
    yield inj
    inj.reset()


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    get_injector().reset()


def cfg(**over):
    c = {"train_batch_size": 8, "gradient_accumulation_steps": 1,
         "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
         "zero_optimization": {"stage": 0}, "steps_per_print": 0}
    c.update(over)
    return c


def make_engine(config, seed=0):
    model = GPT2Model(TINY, generator=torch.Generator().manual_seed(seed))
    return deepspeed_tpu_torch.initialize(model=model, config=config,
                                          device="cpu")[0]


def batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 255, (1, 8, 16), dtype=np.int32)}
            for _ in range(n)]


def counter(engine, tag):
    return engine.tracer.counter_value(tag, 0.0)


def _two_checkpoints(tmp_path):
    e = make_engine(cfg())
    for b in batches(2):
        e.train_batch(batch=b)
        e.save_checkpoint(tmp_path)
    assert (tmp_path / "latest").read_text() == "global_step2"
    return e


# ------------------------------------------------- integrity and fallback

def test_manifest_written_and_valid(tmp_path):
    e = make_engine(cfg())
    e.train_batch(batch=batches(1)[0])
    ckpt_dir = e.save_checkpoint(tmp_path)
    assert os.path.isfile(os.path.join(ckpt_dir, "manifest.json"))
    assert verify_manifest(ckpt_dir) == []


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_corrupt_or_truncated_latest_falls_back(tmp_path, damage):
    _two_checkpoints(tmp_path)
    p = tmp_path / "global_step2" / "model_states.msgpack"
    data = bytearray(p.read_bytes())
    if damage == "flip":
        data[10] ^= 0xFF                   # same size, wrong content
    else:
        data = data[:100]                  # partial write
    p.write_bytes(bytes(data))
    e2 = make_engine(cfg(), seed=1)
    before = counter(e2, "resilience/rollbacks")
    path, _ = e2.load_checkpoint(tmp_path)
    assert path.endswith("global_step1") and e2.global_steps == 1
    assert counter(e2, "resilience/rollbacks") - before == 1


def test_corrupt_state_past_verification_falls_back(tmp_path, faultinject):
    """With verification off, the reader itself refuses the torn bytes
    (io_read_corrupt flips the first byte) and the load falls back."""
    _two_checkpoints(tmp_path)
    e2 = make_engine(cfg(resilience={"verify_on_load": False}), seed=1)
    faultinject.arm("io_read_corrupt")
    path, _ = e2.load_checkpoint(tmp_path)
    assert path.endswith("global_step1")
    assert faultinject.fired["io_read_corrupt"] == 1


def test_all_tags_corrupt_raises_with_context(tmp_path):
    e = make_engine(cfg())
    e.train_batch(batch=batches(1)[0])
    e.save_checkpoint(tmp_path)
    (tmp_path / "global_step1" / "model_states.msgpack").write_bytes(b"xx")
    e2 = make_engine(cfg())
    with pytest.raises(CheckpointLoadError) as ei:
        e2.load_checkpoint(tmp_path)
    msg = str(ei.value)
    assert str(tmp_path) in msg and "global_step1" in msg


def test_torn_write_mismatches_its_own_manifest(tmp_path, faultinject):
    """io_truncate models a crash that let os.replace publish half a file:
    the manifest (hash of the INTENDED bytes) disagrees, and load falls
    back to the previous tag."""
    e = make_engine(cfg())
    e.train_batch(batch=batches(1)[0])
    e.save_checkpoint(tmp_path)            # good global_step1
    e.train_batch(batch=batches(1, seed=1)[0])
    faultinject.arm("io_truncate")         # tears the next model_states
    e.save_checkpoint(tmp_path)            # torn global_step2
    assert verify_manifest(str(tmp_path / "global_step2")) != []
    e2 = make_engine(cfg())
    path, _ = e2.load_checkpoint(tmp_path)
    assert path.endswith("global_step1")


def test_missing_latest_raises_actionable_error(tmp_path):
    e = make_engine(cfg())
    with pytest.raises(CheckpointLoadError) as ei:
        e.load_checkpoint(tmp_path)
    assert str(tmp_path) in str(ei.value)
    e.train_batch(batch=batches(1)[0])
    e.save_checkpoint(tmp_path)
    os.remove(tmp_path / "latest")
    with pytest.raises(CheckpointLoadError) as ei:
        make_engine(cfg()).load_checkpoint(tmp_path)
    assert "global_step1" in str(ei.value)   # tags found are named
    with pytest.raises(CheckpointLoadError):
        e.load_checkpoint(tmp_path, tag="no_such_tag")


# ------------------------------------------------------------- retryable IO

def test_save_retries_injected_write_failures(tmp_path, faultinject):
    e = make_engine(cfg(resilience={"save_retries": 3,
                                    "retry_backoff_s": 0.01,
                                    "retry_max_backoff_s": 0.02}))
    e.train_batch(batch=batches(1)[0])
    before = counter(e, "resilience/ckpt_retries")
    faultinject.arm("io_write_fail", times=2)
    e.save_checkpoint(tmp_path)
    assert faultinject.fired["io_write_fail"] == 2
    assert counter(e, "resilience/ckpt_retries") - before == 2
    e2 = make_engine(cfg())
    path, _ = e2.load_checkpoint(tmp_path)
    assert path.endswith("global_step1")


def test_failed_save_never_advances_latest(tmp_path, faultinject):
    e = make_engine(cfg())                 # save_retries=0
    e.train_batch(batch=batches(1)[0])
    e.save_checkpoint(tmp_path)
    e.train_batch(batch=batches(1, seed=1)[0])
    faultinject.arm("io_write_fail", times=5)
    with pytest.raises(OSError):
        e.save_checkpoint(tmp_path)
    assert (tmp_path / "latest").read_text() == "global_step1"
    e2 = make_engine(cfg())
    path, _ = e2.load_checkpoint(tmp_path)
    assert path.endswith("global_step1")


def test_retry_io_backoff_is_jittered_and_capped():
    import random
    delays = backoff_delays(0.5, 2.0, random.Random(0))
    got = [next(delays) for _ in range(6)]
    for i, d in enumerate(got):
        base = min(2.0, 0.5 * 2 ** i)
        assert 0.5 * base <= d <= 1.5 * base
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"
    assert retry_io(flaky, attempts=2, base_delay=0) == "ok"
    calls.clear()
    with pytest.raises(OSError):
        retry_io(flaky, attempts=1, base_delay=0)


# -------------------------------------------------------------- retention

def test_retention_keeps_exactly_n_tags(tmp_path):
    e = make_engine(cfg(resilience={"keep_last_n": 2}))
    for b in batches(4):
        e.train_batch(batch=b)
        e.save_checkpoint(tmp_path)
    assert list_tags(str(tmp_path)) == ["global_step4", "global_step3"]
    assert (tmp_path / "latest").read_text() == "global_step4"
    e2 = make_engine(cfg())
    e2.load_checkpoint(tmp_path)
    assert e2.global_steps == 4


def test_gc_never_removes_latest_or_protected(tmp_path):
    for name in ("global_step1", "global_step2", "global_step3"):
        d = tmp_path / name
        d.mkdir()
        (d / "model_states.msgpack").write_bytes(b"x")
        write_manifest(str(d), tag=name)
    (tmp_path / "latest").write_text("global_step1")  # oldest is live
    removed = gc_checkpoints(str(tmp_path), keep_last_n=1,
                             protect=("global_step2",))
    assert removed == []
    assert gc_checkpoints(str(tmp_path), keep_last_n=1) == ["global_step2"]
    assert (tmp_path / "global_step1").exists()


def test_weights_version_is_monotonic_across_tags(tmp_path):
    from deepspeed_tpu_torch.runtime.checkpointing import \
        read_weights_version
    e = make_engine(cfg())
    for i, b in enumerate(batches(2)):
        e.train_batch(batch=b)
        e.save_checkpoint(tmp_path)
        assert read_weights_version(str(tmp_path)) == i + 1
    e.save_checkpoint(tmp_path, tag="global_step2")   # overwrite: no bump
    assert read_weights_version(str(tmp_path), tag="global_step2") == 2


# ------------------------------------------------------------------ nebula

def _nebula_engine(tmp_path, **over):
    config = {"train_batch_size": 16, "train_micro_batch_size_per_gpu": 8,
              "gradient_accumulation_steps": 2,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
              "zero_optimization": {"stage": 0}, "steps_per_print": 0,
              "nebula": {"enabled": True,
                         "persistent_storage_path": str(tmp_path / "tier2"),
                         "num_of_version_in_retention": 2}}
    config.update(over)
    return make_engine(config)


def _nebula_batch(rng):
    return {"input_ids": rng.integers(0, 255, (2, 8, 32), dtype=np.int32)}


@pytest.mark.parametrize("verify", [False, True])
def test_nebula_engine_async_save_and_persistent_fallback(tmp_path, verify):
    """The persistent tier serves a lost primary file when the manifest
    check is off; with it on, the manifest refuses the tag before the
    engine is asked (as in the JAX package, whose own test of this path
    fails for that reason)."""
    engine = _nebula_engine(tmp_path,
                            resilience={"verify_on_load": verify})
    assert isinstance(ce.get_checkpoint_engine(engine._config),
                      ce.CheckpointEngine)
    rng = np.random.default_rng(0)
    float(engine.train_batch(batch=_nebula_batch(rng)))
    probe = {"input_ids": np.arange(8 * 16, dtype=np.int32).reshape(8, 16)
             % 255}
    ev = float(engine.eval_batch(probe))
    engine.save_checkpoint(str(tmp_path / "primary"))
    tag = open(tmp_path / "primary" / "latest").read().strip()
    tier2 = tmp_path / "tier2" / tag
    assert (tier2 / "model_states.msgpack").exists()
    os.remove(tmp_path / "primary" / tag / "model_states.msgpack")
    engine2 = _nebula_engine(tmp_path,
                             resilience={"verify_on_load": verify})
    if verify:
        with pytest.raises(CheckpointLoadError, match="missing file"):
            engine2.load_checkpoint(str(tmp_path / "primary"))
        return
    engine2.load_checkpoint(str(tmp_path / "primary"))
    np.testing.assert_allclose(ev, float(engine2.eval_batch(probe)),
                               rtol=1e-6)


def test_nebula_version_retention(tmp_path):
    engine = _nebula_engine(tmp_path)
    rng = np.random.default_rng(0)
    for i in range(3):
        float(engine.train_batch(batch=_nebula_batch(rng)))
        engine.save_checkpoint(str(tmp_path / "primary"), tag=f"v{i}")
    kept = sorted(os.listdir(tmp_path / "tier2"))
    assert kept == ["v1", "v2"], kept  # retention=2 keeps the newest two


def test_optimizer_state_drift_falls_back_like_a_torn_tag(tmp_path):
    """A newest tag whose moments do not fit the model is unreadable (the
    JAX package's from_state_dict raises there) and the load falls back;
    nothing moves before the gate."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine import msgpack_codec
    from deepspeed_tpu_torch.resilience import write_manifest
    _two_checkpoints(tmp_path)
    tag = tmp_path / "global_step2"
    with open(tag / "optim_states.msgpack", "rb") as f:
        optim = msgpack_codec.restore(f)
    del optim["opt_state"]["mu"]["wte"]
    with open(tag / "optim_states.msgpack", "wb") as f:
        msgpack_codec.serialize(optim, f)
    write_manifest(str(tag), tag="global_step2")
    e2 = make_engine(cfg(), seed=1)
    path, _ = e2.load_checkpoint(tmp_path)
    assert path.endswith("global_step1") and e2.global_steps == 1
    with pytest.raises(CheckpointLoadError, match="optim_states mu"):
        make_engine(cfg(), seed=1).load_checkpoint(tmp_path,
                                                   tag="global_step2")
