"""ZeRO stages 0-3 of the port on 2 gloo ranks held against the JAX
package's engine on a dp-2 mesh of 2 CPU devices: tiny LLaMA (grouped-
query attention, a sliding window; ``torch_zero_pairs``), with the
tolerances of ``test_torch_zero_parity.py``. All stages run in one spawn
of 2 ranks."""

import pytest

import torch_dist_worker
import torch_zero_pairs as zp

STAGES = (0, 1, 2, 3)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    wants, cases = [], []
    for stage in STAGES:
        want, c = zp.case("llama", zp.config(stage),
                          zp.batches(zp.STEPS, seed=10 + stage))
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
