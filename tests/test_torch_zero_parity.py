"""ZeRO stages 0-3 of the port on 2 gloo ranks held against the JAX
package's engine on a dp-2 mesh of 2 CPU devices: tiny GPT-2
(``torch_zero_pairs``). Both engines start from the JAX engine's initial
weights and take the same global batches; rank ``r`` trains on rows
``[2 r, 2 r + 2)`` of each micro batch. The losses agree to rtol 1e-5,
the gradient norms and every master, ``mu`` and ``nu`` leaf (gathered
whole) to atol 2e-5 / rtol 1e-4. All stages run in one spawn of 2
ranks."""

import pytest

import torch_dist_worker
import torch_zero_pairs as zp

STAGES = (0, 1, 2, 3)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    wants, cases = [], []
    for stage in STAGES:
        want, c = zp.case("gpt2", zp.config(stage), zp.batches(zp.STEPS,
                                                               seed=stage))
        wants.append(want)
        cases.append(c)
    ranks = torch_dist_worker.spawn(torch_dist_worker.train_cases, zp.DP,
                                    tmp_path_factory.mktemp("zero"),
                                    {"cases": cases})
    return wants, ranks


@pytest.mark.parametrize("stage", STAGES)
def test_port_ranks_match_the_jax_dp2_engine(results, stage):
    wants, ranks = results
    i = STAGES.index(stage)
    zp.assert_case(ranks[0][i]["state"], wants[i], [r[i] for r in ranks])


def test_stage3_gathers_and_reduce_scatters(results):
    """Stage 3 gathered each layer in the forward and again in the
    backward, reduce-scattered the gradients, and freed every gather."""
    _, ranks = results
    for r in ranks:
        got = r[STAGES.index(3)]
        assert got["gathers"]["gathers"] > 0 and \
            got["gathers"]["regathers"] > 0
        assert got["comm"].get("reduce_scatter", 0) > 0
        assert got["gathers"]["live"] == 0


def test_stage0_and_1_reduce_whole_gradients(results):
    """Below stage 2 the gradients are all-reduced whole at the step: no
    reduce-scatter ran in those cases' micro steps."""
    _, ranks = results
    assert ranks[0][0]["comm"].get("reduce_scatter", 0) == 0
