"""The bucketed overlap schedule of the ZeRO exchange
(``runtime/zero/overlap_schedule.py``) in the port.

- ``build_schedule``'s buckets and ``info`` are the JAX package's plan,
  segment for segment, for GPT-2 and LLaMA at stages 2 and 3, at several
  ``bucket_bytes``, with ``overlap: false`` and without layer chunking
  (the engines at dp 2: the JAX one on 2 CPU devices, the port's on a
  rank mesh of 2 that exchanges nothing while it plans).
- On 2 gloo ranks, the bucketed gradients of a micro step and the
  masters after 3 steps are bitwise the per-leaf explicit exchange's:
  under ``fp32`` at any bucket size, chunked by layer or fused into one
  bucket, and under ``int8`` with whole-leaf buckets (a layer slice takes
  its own codec blocks under a quantized policy, as in the JAX package).
- The issue order: the gathers in layer order, the reduce-scatters in
  reverse, one bucket a direction with ``overlap: false``; the engine's
  summary carries the plan.
"""

import dataclasses

import jax
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu.runtime.zero import overlap_schedule as jos
from deepspeed_tpu_torch.parallel.topology import DeviceMeshManager
from deepspeed_tpu_torch.runtime.zero import overlap_schedule as tos

import torch_dist_worker
import torch_pairs as tp
import torch_quant_worker
import torch_zero_pairs as zp

PLANS = [dict(bucket_bytes=4 << 10), dict(bucket_bytes=16 << 10),
         dict(bucket_bytes=1 << 20), dict(bucket_bytes=16 << 10,
                                          overlap=False),
         dict(bucket_bytes=16 << 10, layer_chunking=False)]


def _kw(family):
    return {k: v for k, v in tp.FAMILIES[family][0].items() if k != "dtype"}


@pytest.fixture(scope="module")
def engines():
    out = {}
    for family in ("gpt2", "llama"):
        for stage in (2, 3):
            cfg = zp.config(stage, overlap_schedule={"enabled": True})
            _, jcfg, jcls, tcfg, tcls = tp.FAMILIES[family]
            je = deepspeed_tpu.initialize(
                model=jcls(jcfg(**dict(_kw(family), attn_backend="xla"))),
                config=cfg, mesh_manager=initialize_mesh(
                    dp=2, devices=jax.devices("cpu")[:2]))[0]
            te = deepspeed_tpu_torch.initialize(
                model=tcls(tcfg(**_kw(family))), config=cfg, device="cpu",
                mesh_manager=DeviceMeshManager(dp=2, world_size=2,
                                               rank=0))[0]
            out[(family, stage)] = (je, te)
    return out


def _plain(buckets):
    return [[dataclasses.astuple(s) for s in b] for b in buckets]


@pytest.mark.parametrize("plan", range(len(PLANS)))
@pytest.mark.parametrize("stage", [2, 3])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_plan_is_the_jax_plan(engines, family, stage, plan):
    je, te = engines[(family, stage)]
    over = dict(PLANS[plan], enabled=True)
    jg, jr, ja, jinfo = jos.build_schedule(
        je, jos.OverlapScheduleConfig.from_dict(over))
    tg, tr, ta, tinfo = tos.build_schedule(
        te, tos.OverlapScheduleConfig.from_dict(over))
    assert tinfo == jinfo
    assert _plain(tg) == _plain(jg) and _plain(tr) == _plain(jr)
    assert ta == ja
    assert (len(tg) > 0) == (stage == 3)


def test_config_block_is_the_jax_one():
    for block in ({}, {"enabled": True, "bucket_bytes": 123,
                       "pin_order": False}):
        assert tos.OverlapScheduleConfig.from_dict(block).to_dict() == \
            jos.OverlapScheduleConfig.from_dict(block).to_dict()
    for bad in ({"bucket_bytes": 0}, {"no_such": 1}):
        with pytest.raises(Exception) as jerr:
            jos.OverlapScheduleConfig.from_dict(bad)
        with pytest.raises(Exception) as terr:
            tos.OverlapScheduleConfig.from_dict(bad)
        assert str(terr.value) == str(jerr.value)


FP32 = {"enabled": True, "all_gather": "fp32", "reduce_scatter": "fp32",
        "all_reduce": "fp32"}
INT8 = {"enabled": True, "all_gather": "int8", "reduce_scatter": "int8",
        "all_reduce": "int8", "min_bytes": 0, "block_size": 64}
# (name, family, stage, comm_compression, overlap_schedule or None)
RUNS = [
    ("gpt2-3-leaf", "gpt2", 3, FP32, None),
    ("gpt2-3-4k", "gpt2", 3, FP32, {"bucket_bytes": 4 << 10}),
    ("gpt2-3-16k", "gpt2", 3, None, {"bucket_bytes": 16 << 10}),
    ("gpt2-3-fused", "gpt2", 3, FP32, {"overlap": False}),
    ("gpt2-2-leaf", "gpt2", 2, FP32, None),
    ("gpt2-2-8k", "gpt2", 2, FP32, {"bucket_bytes": 8 << 10}),
    ("llama-3-leaf", "llama", 3, FP32, None),
    ("llama-3-8k", "llama", 3, FP32, {"bucket_bytes": 8 << 10}),
    ("gpt2-3-int8-leaf", "gpt2", 3, INT8, None),
    ("gpt2-3-int8-whole", "gpt2", 3, INT8, {"bucket_bytes": 64 << 10,
                                            "layer_chunking": False}),
]
PAIRS = [("gpt2-3-4k", "gpt2-3-leaf"), ("gpt2-3-16k", "gpt2-3-leaf"),
         ("gpt2-3-fused", "gpt2-3-leaf"), ("gpt2-2-8k", "gpt2-2-leaf"),
         ("llama-3-8k", "llama-3-leaf"),
         ("gpt2-3-int8-whole", "gpt2-3-int8-leaf")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = []
    for name, family, stage, cc, sched in RUNS:
        extra = {}
        if cc is not None:
            extra["comm_compression"] = cc
        if sched is not None:
            extra["overlap_schedule"] = dict(sched, enabled=True)
        cases.append({"family": family, "kw": _kw(family),
                      "tree": tp.tree(family, 3), "batches":
                      zp.batches(zp.STEPS, seed=9),
                      "config": zp.config(stage, **extra)})
    ranks = torch_dist_worker.spawn(torch_quant_worker.compressed_cases, 2,
                                    tmp_path_factory.mktemp("sched"),
                                    {"cases": cases}, timeout=600)
    names = [r[0] for r in RUNS]
    return {n: [r[i] for r in ranks] for i, n in enumerate(names)}


@pytest.mark.parametrize("bucketed,per_leaf", PAIRS)
def test_bucketed_exchange_is_the_per_leaf_one_bit_for_bit(runs, bucketed,
                                                           per_leaf):
    a, b = runs[bucketed], runs[per_leaf]
    for name, g in b[0]["grads"].items():
        np.testing.assert_array_equal(a[0]["grads"][name].view(np.uint32),
                                      g.view(np.uint32), err_msg=name)
    for ra, rb in zip(a, b):
        assert [s["loss"] for s in ra["steps"]] == \
            [s["loss"] for s in rb["steps"]]
    for part in ("params", "mu", "nu"):
        for path, v in b[0]["state"][part].items():
            np.testing.assert_array_equal(a[0]["state"][part][path], v,
                                          err_msg=f"{part}/{path}")
    # the same bytes accounted; a fused bucket takes fewer ops than the
    # leaves (small layer-chunked buckets may take more)
    assert a[0]["stats"]["bytes"] == b[0]["stats"]["bytes"]
    if "fused" in bucketed:
        assert a[0]["stats"]["ops"] < b[0]["stats"]["ops"]


@pytest.mark.parametrize("name", ["gpt2-3-4k", "gpt2-3-16k", "gpt2-3-fused",
                                  "gpt2-2-8k", "llama-3-8k"])
def test_issue_order_is_layer_order_then_reverse(runs, name):
    for r in runs[name]:
        info = r["summary"]["overlap_schedule"]
        gathers = [k for kind, k in r["issue"] if kind == "gather"]
        scatters = [k for kind, k in r["issue"] if kind == "reduce_scatter"]
        assert gathers == list(range(info["gather_buckets"]))
        assert scatters == list(range(info["rs_buckets"]))[::-1]
        # every gather issued before any reduce-scatter
        kinds = [kind for kind, _ in r["issue"]]
        assert kinds == sorted(kinds)
        if not info["overlap"]:
            assert info["rs_buckets"] == 1 and info["gather_buckets"] == 1
