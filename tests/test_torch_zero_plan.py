"""The port's ZeRO planner, rank topology and comm layer.

- Every leaf's spec from the port's planner equals the JAX package's
  ``ZeroShardingPlanner.param_spec`` / ``grad_spec`` / ``opt_spec`` for
  GPT-2, LLaMA and BERT at dp 2 and dp 4, stages 1-3 (a stage-3
  persistence threshold that keeps some leaves replicated), including a
  GPT-2 of width 66 whose layer-norm leaves land on the layer dim at dp 4.
- The comm layer's collectives on 2 gloo ranks give what their
  definitions say, with the JAX package's wire-byte accounting, the comms
  logger's records and the refusals (one spawn).
- A stage-3 step of a 4-layer GPT-2 on 2 gloo ranks keeps at most two
  layers' gathered leaves (plus the top-level leaves) alive at once, by
  the engine's own counter; and a GPT-2 of width 65 on 2 ranks, whose
  block leaves the planner gives to ranks whole (the layer dim), trains
  at stage 3 as the JAX package's dp-2 engine does (one spawn for both).
"""

import jax
import numpy as np
import pytest

import torch_dist_worker
import torch_pairs
import torch_train_pairs as tt
import torch_zero_pairs as zp
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.models.bert import BertConfig as JBertConfig
from deepspeed_tpu.models.bert import BertModel as JBertModel
from deepspeed_tpu.parallel.topology import DeviceMeshManager as JMesh
from deepspeed_tpu.runtime.zero.partition import \
    ZeroShardingPlanner as JPlanner
from deepspeed_tpu_torch.parallel import topology
from deepspeed_tpu_torch.runtime.zero.partition import (
    ZeroShardingPlanner, leaf_shapes, param_shards, spec_str)

import deepspeed_tpu_torch.models as tmodels  # noqa: F401


def _families():
    out = {}
    for fam in ("gpt2", "llama"):
        kw, jcfg, jcls, tcfg, tcls = torch_pairs.FAMILIES[fam]
        kw = {k: v for k, v in kw.items() if k != "dtype"}
        out[fam] = (jcls(jcfg(**kw)), tcls(tcfg(**kw)))
    kw = dict(tt.BERT)
    from deepspeed_tpu_torch.models.bert import BertConfig, BertModel
    out["bert"] = (JBertModel(JBertConfig(**kw)), BertModel(BertConfig(**kw)))
    kw = dict(torch_pairs.GPT2, n_embd=66, n_head=2, n_layer=4)
    kw.pop("dtype")
    _, jcfg, jcls, tcfg, tcls = torch_pairs.FAMILIES["gpt2"]
    out["gpt2 width 66"] = (jcls(jcfg(**kw)), tcls(tcfg(**kw)))
    return out


FAMILIES = _families()


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_leaf_specs_are_the_jax_planners(family, stage, dp):
    jmodel, tmodel = FAMILIES[family]
    threshold = 4000 if stage == 3 else 0
    jplan = JPlanner(JMesh(dp=dp, devices=jax.devices("cpu")[:dp]), stage,
                     jmodel.partition_rules(), persistence_threshold=threshold)
    tplan = ZeroShardingPlanner(
        topology.DeviceMeshManager(dp=dp, world_size=dp, rank=0), stage,
        persistence_threshold=threshold)
    shapes = leaf_shapes(tmodel)
    jshapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    want_shapes = {p: tuple(x.shape) for p, x in zip(
        jax.tree.leaves(param_path_tree(jshapes)), jax.tree.leaves(jshapes))}
    assert shapes == want_shapes
    for path, shape in shapes.items():
        for kind in ("param_spec", "grad_spec", "opt_spec"):
            assert getattr(tplan, kind)(path, shape) == \
                tuple(getattr(jplan, kind)(path, shape)), (path, kind)
    assert tplan.describe(shapes) == [
        (p, s, str(jplan.param_spec(p, s))) for p, s in shapes.items()]


def param_path_tree(tree):
    from deepspeed_tpu.models.api import param_path_tree as jpaths
    return jpaths(tree)


def test_a_layer_dim_spec_gives_whole_layers_to_ranks():
    """At dp 4 the width-66 GPT-2's ``blocks/ln1_scale [4, 66]`` shards
    its layer dim (66 does not divide by 4): rank r owns layer r whole."""
    jmodel, tmodel = FAMILIES["gpt2 width 66"]
    plan = ZeroShardingPlanner(
        topology.DeviceMeshManager(dp=4, world_size=4, rank=0), 1)
    assert plan.opt_spec("blocks/ln1_scale", (4, 66))[0] == ("data", "expert")
    for rank in range(4):
        shards = param_shards(tmodel, plan, rank, 4)
        names = [n for n, _ in tmodel.named_parameters()]
        for layer in range(4):
            ps = shards[names.index(f"blocks.{layer}.ln1_scale")]
            assert (ps.kind, ps.owner) == ("layer", layer)
            assert ps.local_shape == ((66,) if rank == layer else (0,))
    assert spec_str((None, ("data", "expert"))) == \
        "PartitionSpec(None, ('data', 'expert'))"


def test_topology_refuses_model_parallel_axes():
    # tensor parallelism runs: 'model' is the innermost axis, so a tp group
    # is consecutive ranks and the dp world excludes it
    mm = topology.DeviceMeshManager(dp=2, tp=2, world_size=4, rank=3)
    assert (mm.tp_rank, mm.dp_rank, mm.dp_world_size) == (1, 1, 2)
    assert mm.topology.get_axis_comm_lists("model") == [[0, 1], [2, 3]]
    assert mm.topology.get_axes_comm_lists(("data", "expert")) == \
        [[0, 2], [1, 3]]
    for axis in ("pp", "sp", "ep"):
        with pytest.raises(NotImplementedError, match="row A11"):
            topology.DeviceMeshManager(world_size=2, rank=0, **{axis: 2})
    mm = topology.DeviceMeshManager(dp=4, world_size=4, rank=2)
    assert (mm.dp_world_size, mm.dp_rank, mm.batch_spec()) == \
        (4, 2, (("data", "expert"),))
    assert mm.topology.get_axis_comm_lists("data") == [[0, 1, 2, 3]]
    with pytest.raises(ValueError):
        topology.DeviceMeshManager(dp=3, world_size=4, rank=0)


# ------------------------------------------------------------ collectives

@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return torch_dist_worker.spawn(torch_dist_worker.collectives, 2,
                                   tmp_path_factory.mktemp("comm"), None)


def _x(rank):
    return np.arange(8, dtype=np.float32).reshape(4, 2) + 10 * rank


def test_collectives_compute_their_definitions(collectives):
    xs = [_x(0), _x(1)]
    total = xs[0] + xs[1]
    for rank, out in enumerate(collectives):
        np.testing.assert_array_equal(out["all_reduce"], total)
        np.testing.assert_array_equal(out["all_reduce_avg"], total / 2)
        np.testing.assert_array_equal(out["all_reduce_max"], xs[1])
        np.testing.assert_array_equal(out["all_gather0"], np.concatenate(xs))
        np.testing.assert_array_equal(out["all_gather1"],
                                      np.concatenate(xs, axis=1))
        np.testing.assert_array_equal(out["all_gather_stack"], np.stack(xs))
        np.testing.assert_array_equal(out["reduce_scatter0"],
                                      total[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(out["reduce_scatter1"],
                                      total[:, rank:rank + 1])
        np.testing.assert_array_equal(out["ag_coalesced"][0],
                                      np.concatenate(xs))
        np.testing.assert_array_equal(
            out["ag_coalesced"][1],
            np.concatenate([x[:, :1] * 2 for x in xs], axis=1))
        np.testing.assert_array_equal(out["rs_coalesced"][0],
                                      total[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(out["rs_coalesced"][1],
                                      (total * 3)[:, rank:rank + 1])
        np.testing.assert_array_equal(
            out["all_to_all"], np.concatenate(
                [x[2 * rank:2 * rank + 2] for x in xs], axis=1))
        np.testing.assert_array_equal(out["broadcast"], xs[1])
        np.testing.assert_array_equal(out["scatter"],
                                      xs[1][2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(out["gather"], np.concatenate(xs))
        np.testing.assert_array_equal(out["reduce"], total)
        np.testing.assert_array_equal(out["ppermute"], xs[1 - rank])
        np.testing.assert_array_equal(out["single"], xs[rank])
        assert out["object"] == {"rank": 1}
        assert out["axis"] == (rank, 2, 1, rank)
        assert out["mesh"] == (2, rank, True, True)
        assert "isend is not supported" in out["isend"]


def test_collectives_account_the_jax_wire_model(collectives):
    """Wire bytes per member as the JAX package's ``_base_wire`` counts
    them, the per-op counts, and the comms logger's records with their
    participants."""
    nb = 8 * 4
    w = {op: jcomm._base_wire(op, nb, 2) for op in jcomm._BASE_WIRE}
    want = (3 * w["all_reduce"] + 4 * w["all_gather"] +
            2 * w["reduce_scatter"] +
            (w["all_gather"] + jcomm._base_wire("all_gather", nb // 2, 2)) +
            (w["reduce_scatter"] + w["reduce_scatter"]) + w["all_to_all"] +
            w["broadcast"] + w["scatter"] + w["all_reduce"] + w["ppermute"])
    for out in collectives:
        assert out["stats"]["bytes"] == want
        assert out["per_op"] == {"all_reduce": 4, "all_gather": 5,
                                 "reduce_scatter": 3, "all_to_all": 2,
                                 "broadcast": 1, "scatter": 1, "ppermute": 1}
        # (wire bytes, axis, participants) -> [count, total wire bytes]
        assert out["logged"]["all_reduce"] == {
            f"({w['all_reduce']}, 'data', 2)": [4, 4 * w["all_reduce"]]}
        assert out["logged"]["all_to_all"] == {
            f"({w['all_to_all']}, 'data', 2)": [1, w["all_to_all"]],
            "(0, 'expert', 1)": [1, 0]}


def test_compression_other_than_off_names_a8c():
    """The ``comm_compression`` block is the JAX package's schema (it once
    named row A8c here): one policy a collective, ``configure`` returns the
    installed config, an unknown key such as ``policy`` is a
    ``ConfigError`` and ``enabled: false`` is accepted as off."""
    from deepspeed_tpu.comm.compression import \
        configure_comm_compression as jconfigure
    from deepspeed_tpu.runtime.config_utils import ConfigError as JErr
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.runtime.config_utils import ConfigError
    for block in ({"policy": "off"}, {"policy": "int8"}):
        with pytest.raises(ConfigError, match="unknown config key"):
            comm.configure_comm_compression(block)
        with pytest.raises(JErr, match="unknown config key"):
            jconfigure(block)
    try:
        cfg = comm.configure_comm_compression(
            {"enabled": True, "all_gather": "int8", "reduce_scatter": "fp32"})
        assert comm.get_comm_compression() is cfg
        assert [cfg.policy_for(op, "data", 1 << 20) for op in (
            "all_gather", "reduce_scatter", "all_reduce")] == \
            ["int8", "fp32", "off"]
        off = comm.configure_comm_compression({"enabled": False,
                                               "all_gather": "int8"})
        assert off.policy_for("all_gather", "data", 1 << 20) == "off"
    finally:
        comm.reset_comm_compression()
        from deepspeed_tpu.comm.compression import reset_comm_compression
        reset_comm_compression()


# ------------------------------------------------------------ stage 3

WIDE = dict(torch_pairs.GPT2, n_embd=65, n_head=5)


@pytest.fixture(scope="module")
def stage3(tmp_path_factory):
    kw = {k: v for k, v in torch_pairs.GPT2.items() if k != "dtype"}
    memory = {"family": "gpt2", "kw": dict(kw, n_layer=4), "tree": None,
              "config": zp.config(3), "batches": zp.batches(1, seed=40)}
    want, wide = zp.case("gpt2", zp.config(3), zp.batches(zp.STEPS, seed=41),
                         n_embd=65, n_head=5)
    ranks = torch_dist_worker.spawn(torch_dist_worker.train_cases, zp.DP,
                                    tmp_path_factory.mktemp("stage3"),
                                    {"cases": [memory, wide]})
    return want, ranks


def test_stage3_keeps_at_most_two_layers_gathered(stage3):
    _, ranks = stage3
    for r in ranks:
        got = r[0]
        g, layer, top = got["gathers"], got["layer_bytes"], got["top_bytes"]
        assert layer > 0 and g["peak_layers"] > 0
        assert g["peak_layers"] <= 2 * layer
        assert g["peak"] <= 2 * layer + top
        # 4 layers x 2 micro steps gathered in the forward and again in
        # the backward; nothing left alive
        assert g["regathers"] == 4 * zp.GAS and g["live"] == 0


def test_layer_dim_shards_train_as_the_jax_dp2_engine(stage3):
    want, ranks = stage3
    zp.assert_case(ranks[0][1]["state"], want, [r[1] for r in ranks])
