"""ZeRO on 2 gloo ranks against the JAX package's dp-2 engine, the rest of
the step (``torch_zero_pairs``): gradient clipping at stage 3, DeepSpeed's
user loop at stage 2 and fp16 with a forced overflow at stage 2.

Clipping: 0.05, below every step's norm. fp16: the loss scale is 2**16
(no overflow), set to 2**24 before the second step, which overflows far
past float16's range (skipped, the scale halved, hysteresis 1), and back
to 2**16 before the third; every rank skips the same step at the same
scale as the JAX package (the overflow decision is all-reduced), the
masters take two updates, and the float16 losses agree to rtol 2e-3
(float16 forward passes in two orders). The three cases run in one spawn
of 2 ranks."""

import numpy as np
import pytest


import torch_dist_worker
import torch_zero_pairs as zp

LR = 1e-4                      # torch_zero_pairs.config's AdamW lr

FP16 = {"enabled": True, "initial_scale_power": 16, "hysteresis": 1}
FORCED = {1: 2.0 ** 24, 2: 2.0 ** 16}     # step -> loss scale set before it
CASES = {
    "clipped stage3": (dict(stage=3, clip=0.05), {}, "train_batch"),
    "user loop stage2": (dict(stage=2), {}, "user"),
    "fp16 overflow stage2": (dict(stage=2, fp16=FP16), {"scale_at": FORCED},
                             "train_batch"),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    wants, cases = {}, []
    for i, (name, (cfg, over, loop)) in enumerate(CASES.items()):
        want, c = zp.case("gpt2", zp.config(**cfg),
                          zp.batches(zp.STEPS, seed=20 + i), loop, **over)
        wants[name] = want
        cases.append(c)
    ranks = torch_dist_worker.spawn(torch_dist_worker.train_cases, zp.DP,
                                    tmp_path_factory.mktemp("zero"),
                                    {"cases": cases})
    return wants, {name: [r[i] for r in ranks]
                   for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", ["clipped stage3", "user loop stage2"])
def test_port_ranks_match_the_jax_dp2_engine(results, name):
    wants, got = results
    zp.assert_case(got[name][0]["state"], wants[name], got[name])


def test_clipping_was_active(results):
    wants, _ = results
    assert all(s["grad_norm"] > 0.05 for s in wants["clipped stage3"][0])


def test_fp16_overflow_skips_the_same_steps(results):
    wants, got = results
    steps, state = wants["fp16 overflow stage2"]
    assert [s["skipped"] for s in steps] == [0, 1, 1]
    for rank in got["fp16 overflow stage2"]:
        assert [s["skipped"] for s in rank["steps"]] == [0, 1, 1]
        assert [s["scale"] for s in rank["steps"]] == \
            [s["scale"] for s in steps] == [2.0 ** 16, 2.0 ** 23, 2.0 ** 16]
        np.testing.assert_allclose([s["loss"] for s in rank["steps"]],
                                   [s["loss"] for s in steps], rtol=2e-3)
    port = got["fp16 overflow stage2"][0]["state"]
    assert port["count"] == state["count"] == 2
    # Adam moves an element by at most about lr a step, so two float16
    # runs part by at most about 2 lr an update where an element's
    # gradient sits near 0
    bound = 2 * LR * state["count"]
    for path, value in state["params"].items():
        assert np.abs(port["params"][path] - value).max() <= bound, path
