"""Checkpoints past one rank, at ZeRO stage 3, held against the JAX
package on the CPU (tiny GPT-2, float32; ``torch_zero_pairs``).

The JAX engine on a dp-2 mesh trains a step and saves; 2 gloo ranks of
the port load that tag (bit for bit the saved state), re-save it
(``model_states.msgpack`` and ``optim_states.msgpack`` byte for byte the
JAX package's files; ``shardings.json`` the JAX package's document but
for the process count), export it (``save_16bit_model``,
``get_fp32_params``) and continue two steps as the JAX engine does
(within the parity tolerances); their 2-rank tag loads into one rank and
a one-rank tag into 2 ranks, bit for bit; a torn tag, read without the
manifest check, raises on both ranks and leaves the engine's state as it
was. One spawn of 2 ranks."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from deepspeed_tpu_torch.runtime.checkpoint_engine import msgpack_codec

import torch_dist_worker
import torch_zero_pairs as zp

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE_FILES = ("model_states.msgpack", "optim_states.msgpack")


def _port_state(engine):
    return torch_dist_worker.state(engine)


def _assert_equal(got, want):
    assert got["count"] == want["count"]
    for part in ("params", "mu", "nu"):
        assert sorted(got[part]) == sorted(want[part])
        for path, value in want[part].items():
            np.testing.assert_array_equal(got[part][path], value,
                                          err_msg=f"{part}/{path}")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    cfg = zp.config(3)
    data = zp.batches(3, seed=50)
    jax_engine, kw = zp.jax_engine("gpt2", cfg)
    tree = jax.tree.map(np.asarray, jax_engine.params)
    jax_engine.train_batch(batch=data[0])
    jax_engine.save_checkpoint(str(tmp / "jax"))
    saved = zp.jax_state(jax_engine)
    want_steps = zp.jax_run(jax_engine, data[1:])
    want = zp.jax_state(jax_engine)
    case = {"family": "gpt2", "kw": kw, "tree": tree, "config": cfg}
    # a one-rank run of the port (this process: no process group) on the
    # global micro batch, saved
    one_case = dict(case, config=dict(cfg, train_micro_batch_size_per_gpu=4))
    one = torch_dist_worker.engine_for(one_case)
    torch_dist_worker.run_steps(one, zp.batches(2, seed=51))
    one.save_checkpoint(str(tmp / "one"))
    one_state = _port_state(one)
    shutil.copytree(tmp / "one", tmp / "torn")
    optim = tmp / "torn" / "global_step2" / "optim_states.msgpack"
    with open(optim, "r+b") as f:
        f.truncate(os.path.getsize(optim) // 2)
    ranks = torch_dist_worker.spawn(
        torch_dist_worker.checkpoint_cases, zp.DP, tmp,
        {"case": case, "jax_dir": str(tmp / "jax"),
         "resaved_dir": str(tmp / "resaved"), "batches": data[1:],
         "two_rank_dir": str(tmp / "two"), "one_rank_dir": str(tmp / "one"),
         "torn_dir": str(tmp / "torn"), "one_rank_steps": 2})
    return {"tmp": tmp, "saved": saved, "want": (want_steps, want),
            "one_state": one_state, "ranks": ranks, "one_case": one_case}


def test_a_jax_dp2_tag_loads_bitwise_and_resaves_byte_identical(run):
    _assert_equal(run["ranks"][0]["loaded"], run["saved"])
    tag = "global_step1"
    for name in STATE_FILES:
        assert (run["tmp"] / "jax" / tag / name).read_bytes() == \
            (run["tmp"] / "resaved" / tag / name).read_bytes(), name


def test_shardings_json_is_the_jax_document(run):
    """The JAX package's specs (stage 3 over ('data', 'expert')) and
    topology; only the process count differs (one process a rank here,
    one process for both devices there)."""
    tag = "global_step1"
    with open(run["tmp"] / "jax" / tag / "shardings.json") as f:
        want = json.load(f)
    with open(run["tmp"] / "resaved" / tag / "shardings.json") as f:
        got = json.load(f)
    assert want["topology"]["processes"] == 1
    assert got["topology"]["processes"] == 2
    got["topology"]["processes"] = 1
    assert got == want
    assert ["data", "expert"] in got["params"]["blocks/qkv_w"]["spec"]


def test_the_run_continues_as_the_jax_engine(run):
    ranks = run["ranks"]
    zp.assert_case(ranks[0]["continued"], run["want"],
                   [{"steps": ranks[0]["steps"]}])


def test_exports_at_stage3(run):
    """``get_fp32_params`` and ``save_16bit_model`` (float32 compute here)
    give the loaded masters whole; the tag's ``zero_to_fp32.py`` writes
    the masters of the 2-rank tag."""
    saved = run["saved"]["params"]
    got = run["ranks"][0]["fp32_params"]
    for path, value in saved.items():
        leaf = got["blocks"][path.split("/")[1]] if "/" in path else got[path]
        np.testing.assert_array_equal(leaf, value, err_msg=path)
    with open(run["tmp"] / "resaved" / "model_16bit.msgpack", "rb") as f:
        exported = msgpack_codec.restore(f)
    with open(run["tmp"] / "resaved" / "global_step1" /
              "model_states.msgpack", "rb") as f:
        assert msgpack_codec.dumps(exported) == f.read()
    out = run["tmp"] / "fp32.msgpack"
    subprocess.run([sys.executable, str(run["tmp"] / "two" / "zero_to_fp32.py"),
                    str(run["tmp"] / "two"), str(out)], check=True,
                   cwd=_REPO, capture_output=True)
    with open(out, "rb") as f:
        consolidated = msgpack_codec.restore(f)
    want = run["ranks"][0]["continued"]["params"]
    for path, value in want.items():
        leaf = consolidated["blocks"][path.split("/")[1]] if "/" in path \
            else consolidated[path]
        np.testing.assert_array_equal(leaf, value, err_msg=path)


def test_a_two_rank_tag_loads_into_one_rank(run):
    engine = torch_dist_worker.engine_for(dict(run["one_case"], tree=None))
    engine.load_checkpoint(str(run["tmp"] / "two"))
    assert engine.global_steps == 3
    _assert_equal(_port_state(engine), run["ranks"][0]["continued"])


def test_a_one_rank_tag_loads_into_two_ranks(run):
    _assert_equal(run["ranks"][0]["from_one_rank"], run["one_state"])


def test_a_torn_tag_leaves_both_ranks_untouched(run):
    for r in run["ranks"]:
        assert r["torn_raised"] == "CheckpointLoadError"
        assert r["torn_untouched"]


def test_a_load_stages_only_the_ranks_parts(run):
    """Each rank stages in host memory its own parts of the masters and
    moments (as many bytes as the engine holds of them), not the tag: at
    stage 3 on 2 ranks about half of it."""
    for r in run["ranks"]:
        got = r["staged"]
        assert got["staged"] == got["parts"]
        assert got["parts"] < 0.6 * got["whole"]
