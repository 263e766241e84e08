"""Checkpoints under tensor parallelism, held against the JAX package on
the CPU (tiny GPT-2, float32, ZeRO stage 0). The JAX engine on a dp 1 x
tp 2 mesh trains a step and saves; 2 gloo ranks of the port at tp 2 load
that tag (bit for bit the saved state), re-save it (the state files byte
for byte the JAX package's; ``shardings.json`` the JAX package's
document, ``model`` entries and all, but for the process count), take a
step and save a tp-2 tag. A tp-1 engine loads that tag bit for bit, and
its re-saved tag is byte for byte the tp-2 one; the JAX engine reads it
bit for bit; a fresh tp-2 engine resumes it bit for bit (its next step
too), and another resumes a tp-1 tag bit for bit, staging only its tp
part of each leaf. The ``qkv`` map (each rank's heads of q, k and v) and
its composition with a dp shard are checked on plain tensors."""

import json
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.parallel import tensor_parallel as tpl
from deepspeed_tpu_torch.runtime.zero.partition import ParamShard

import torch_dist_worker
import torch_pairs as tp
import torch_tp_pairs as tpp
import torch_tp_worker
import torch_zero_pairs as zp

STATE_FILES = ("model_states.msgpack", "optim_states.msgpack")


def _tag(d):
    with open(os.path.join(d, "latest")) as f:
        return os.path.join(d, f.read().strip())


def _bytes(d, name):
    with open(os.path.join(_tag(d), name), "rb") as f:
        return f.read()


def _assert_equal(got, want):
    assert got["count"] == want["count"]
    for part in ("params", "mu", "nu"):
        assert sorted(got[part]) == sorted(want[part])
        for path, value in want[part].items():
            np.testing.assert_array_equal(got[part][path], value,
                                          err_msg=f"{part}/{path}")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ckpt")
    import deepspeed_tpu
    _, c = tpp.train_case("gpt2", 0, 1, seed=40)
    data = tpp.train_batches(1, seed=41)
    kw, jcfg, jcls = tp.FAMILIES["gpt2"][:3]
    jengine = deepspeed_tpu.initialize(
        model=jcls(jcfg(**dict(c["kw"], attn_backend="xla"))),
        config=c["config"], mesh_manager=tpp.jax_mesh())[0]
    jengine.train_batch(batch=data[0])
    jengine.save_checkpoint(str(tmp / "jax"))
    saved = zp.jax_state(jengine)
    # a tp-1 tag of the port (this process: no process group)
    one_case = dict(c, config={k: v for k, v in c["config"].items()
                               if k != "tensor_parallel_size"})
    one = torch_dist_worker.engine_for(one_case)
    torch_dist_worker.run_steps(one, data[:2])
    one.save_checkpoint(str(tmp / "one"))
    one_state = torch_dist_worker.state(one)
    ranks = torch_dist_worker.spawn(
        torch_tp_worker.checkpoint_cases, tpp.TP, tmp,
        {"case": c, "batches": data[1:], "jax_dir": str(tmp / "jax"),
         "resaved_dir": str(tmp / "resaved"), "tp2_dir": str(tmp / "tp2"),
         "one_dir": str(tmp / "one")})
    # the tp-2 tag at tp 1, re-saved; and read by the JAX engine
    back = torch_dist_worker.engine_for(one_case)
    back.load_checkpoint(str(tmp / "tp2"))
    back_state = torch_dist_worker.state(back)
    back.save_checkpoint(str(tmp / "tp1_resaved"))
    jback = deepspeed_tpu.initialize(
        model=jcls(jcfg(**dict(c["kw"], attn_backend="xla"))),
        config=c["config"], mesh_manager=tpp.jax_mesh())[0]
    jback.load_checkpoint(str(tmp / "tp2"))
    return {"tmp": tmp, "saved": saved, "ranks": ranks,
            "one_state": one_state, "back_state": back_state,
            "jax_back": zp.jax_state(jback)}


def test_a_jax_tp2_tag_loads_bitwise_and_resaves_byte_identical(run):
    tmp = run["tmp"]
    for r in run["ranks"]:
        _assert_equal(r["loaded"], run["saved"])
    for name in STATE_FILES:
        assert _bytes(tmp / "resaved", name) == _bytes(tmp / "jax", name)


def test_shardings_json_is_the_jax_document_but_processes(run):
    tmp = run["tmp"]
    docs = []
    for d in ("jax", "resaved"):
        with open(os.path.join(_tag(tmp / d), "shardings.json")) as f:
            docs.append(json.load(f))
    want, got = docs
    for doc in docs:
        doc["topology"].pop("processes")
    assert got == want
    assert got["params"]["blocks/qkv_w"]["spec"] == [None, None, "model"]
    assert got["params"]["wte"]["spec"] == ["model", None]


def test_a_tp2_tag_is_byte_identical_to_the_tp1_tag_of_its_state(run):
    tmp = run["tmp"]
    for name in STATE_FILES:
        assert _bytes(tmp / "tp1_resaved", name) == _bytes(tmp / "tp2", name)


@pytest.mark.parametrize("reader", ["port tp 1", "jax"])
def test_a_tp2_tag_is_read_bit_for_bit(run, reader):
    want = run["ranks"][0]["saved"]
    _assert_equal(run["back_state"] if reader == "port tp 1"
                  else run["jax_back"], want)


def test_tp2_resumes_its_own_tag_bit_for_bit(run):
    for r in run["ranks"]:
        _assert_equal(r["resumed"], r["saved"])
        assert r["resumed_next"] == r["next"]
        _assert_equal(r["resumed_continued"], r["continued"])


def test_tp2_resumes_a_tp1_tag_staging_its_part(run):
    for r in run["ranks"]:
        _assert_equal(r["from_one"], run["one_state"])
        staged = r["staged"]
        assert staged["staged"] == staged["parts"] < 0.6 * staged["whole"]


# ------------------------------------------------ the qkv map, no ranks

@pytest.mark.parametrize("h,hk", [(4, 4), (4, 2), (64, 8)])
def test_qkv_split_holds_each_ranks_heads_of_q_k_and_v(h, hk):
    hd, d, world = 2, 3, 2
    cols = (h + 2 * hk) * hd
    whole = torch.arange(d * cols, dtype=torch.float32).reshape(d, cols)
    sections = [h * hd, hk * hd, hk * hd]
    parts = []
    for rank in range(world):
        split = tpl.TPSplit((d, cols), 1, rank, world, sections)
        part = split.take(whole)
        q, k, v = part.split([h * hd // world, hk * hd // world,
                              hk * hd // world], dim=1)
        heads = lambda lo, n: whole[:, lo + rank * n:lo + (rank + 1) * n]  # noqa: E731
        torch.testing.assert_close(q, heads(0, h * hd // world))
        torch.testing.assert_close(k, heads(h * hd, hk * hd // world))
        torch.testing.assert_close(v, heads((h + hk) * hd, hk * hd // world))
        parts.append(part)
    # the gather's reordering: every rank's part back to the JAX columns
    torch.testing.assert_close(split.assemble(parts), whole)


def test_param_shard_takes_the_tp_part_then_the_dp_part():
    """``take_whole``: the rank's tensor-parallel part first (here the
    qkv heads), then its dp slice of that part."""
    whole = torch.arange(4 * 12, dtype=torch.float32).reshape(4, 12)
    split = tpl.TPSplit((4, 12), 1, 1, 2, [4, 4, 4])
    ps = ParamShard("dim", split.local_shape, 1, 2, dim=0, tp=split)
    assert ps.whole_shape == (4, 12) and ps.local_shape == (2, 6)
    # the rank's heads: columns 2-3 of each of q, k and v
    cols = torch.tensor([2, 3, 6, 7, 10, 11])
    torch.testing.assert_close(ps.take_whole(whole), whole[2:4, cols])
    torch.testing.assert_close(ps.take_tp(whole), whole[:, cols])
    # a dp slice on the part's column dim cuts the rank's heads
    col = ParamShard("dim", split.local_shape, 1, 2, dim=1, tp=split)
    torch.testing.assert_close(col.take_whole(whole), whole[:, cols[3:]])
