"""Tensor-parallel training of the port held against the JAX package's
engine on a mesh with a ``model`` axis, on the CPU in float32 (the tiny
models of ``torch_pairs``; LLaMA with 4 heads on 2 kv heads): 2 gloo
ranks at tp 2 (ZeRO stage 0) against the JAX engine on dp 1 x tp 2, and
4 ranks at dp 2 x tp 2 (stages 1 and 3) against dp 2 x tp 2. Both start
from the JAX engine's initial weights (the port's model built whole and
sharded in place by its engine), take 3 global steps of the same batches
at gas 2 with gradient clipping active, and agree on the losses (rtol
1e-5), the clipped steps' gradient norms and every gathered master,
``mu`` and ``nu`` leaf (atol 2e-5, rtol 1e-4), on every rank. An ``mpu``
handed to ``initialize`` is kept and changes nothing."""

import pytest

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

import torch_dist_worker
import torch_pairs as tp
import torch_tp_pairs as tpp
import torch_zero_pairs as zp

CLIP = tpp.CLIP
TP2 = (("gpt2", 0), ("llama", 0))                  # dp 1 x tp 2
DP2_TP2 = (("gpt2", 1), ("gpt2", 3), ("llama", 3))  # dp 2 x tp 2


def _run(cases, world, tmp):
    built = [tpp.train_case(f, s, world // tpp.TP, seed=20 + i)
             for i, (f, s) in enumerate(cases)]
    ranks = torch_dist_worker.spawn(torch_dist_worker.train_cases, world,
                                    tmp, {"cases": [c for _, c in built]})
    return [w for w, _ in built], ranks


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return _run(TP2, 2, tmp_path_factory.mktemp("tp2"))


@pytest.fixture(scope="module")
def dp2_tp2(tmp_path_factory):
    return _run(DP2_TP2, 4, tmp_path_factory.mktemp("dp2tp2"))


def _check(run, i):
    wants, ranks = run
    zp.assert_case(ranks[0][i]["state"], wants[i], [r[i] for r in ranks])
    for step in wants[i][0]:
        assert step["grad_norm"] > CLIP        # clipping was active


@pytest.mark.parametrize("family,stage", TP2)
def test_tp2_matches_the_jax_tp2_engine(tp2, family, stage):
    _check(tp2, TP2.index((family, stage)))


@pytest.mark.parametrize("family,stage", DP2_TP2)
def test_dp2_tp2_matches_the_jax_engine(dp2_tp2, family, stage):
    _check(dp2_tp2, DP2_TP2.index((family, stage)))


def test_stage3_gathers_over_dp_on_the_tp_part(dp2_tp2):
    """Stage 3 gathered each layer's tp part over the dp group (forward
    and backward) and freed every gather."""
    _, ranks = dp2_tp2
    for r in ranks:
        got = r[DP2_TP2.index(("gpt2", 3))]
        assert got["gathers"]["gathers"] > 0 and \
            got["gathers"]["regathers"] > 0
        assert got["gathers"]["live"] == 0


def test_an_mpu_is_kept_and_changes_nothing():
    """DeepSpeed's Megatron ``mpu`` argument: accepted, kept on the config
    (nothing reads it), the losses bit for bit those without it."""
    class Mpu:
        def get_model_parallel_world_size(self):
            return 1

    kw = dict(tp.GPT2)
    cfg = dict(zp.config(0), train_batch_size=tpp.MICRO * tpp.GAS)
    data = tpp.train_batches(1, seed=30)
    losses = []
    for mpu in (None, Mpu()):
        engine = deepspeed_tpu_torch.initialize(
            model=GPT2Model(GPT2Config(**kw)), config=cfg, mpu=mpu,
            device="cpu")[0]
        assert engine._config.mpu is mpu and engine.mp_world_size == 1
        losses.append([float(engine.train_batch(batch=b)) for b in data])
    assert losses[0] == losses[1]
