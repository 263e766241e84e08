"""BERT under tensor parallelism, dense and after DeepSpeed's sparse
surgery, held against the JAX package's ``model`` axis on the CPU
(float32, width 64, 2 layers, 4 heads, 128 positions).

The JAX engine runs sparse BERT on its ``model`` mesh here (its dispatch
takes the dense-masked path off the TPU); the port's ranks take K6/K7's
plain versions (``impl="pallas"``), on the rank's rows of the layout made
for all 4 heads. Fixed (4 global patterns, one a head) and BigBird (its
random blocks drawn a head at a time) give every head its own layout, so
a layout made for a rank's 2 heads would be another one; the rows each
rank's attention took are checked against the JAX package's whole
layout. MLM logits within 2e-5 of the JAX tp-2 engine (dense, Fixed,
BigBird; at tp 2 on 2 ranks and on a dp 2 x tp 2 mesh of 4); 3 clipped
training steps (ZeRO stage 0 at tp 2; stage 3 at dp 2 x tp 2) within 2e-5
in losses, norms and every gathered master and moment. The JAX engine's
tag after its steps, loaded at tp 2 and saved again, and loaded and saved
by a tp-1 engine, is byte for byte the JAX package's. One spawn a world."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker
import torch_tp_pairs as tpp
import torch_tp_worker
import torch_zero_pairs as zp

KINDS = ("dense", "fixed", "bigbird")
TRAIN_TP2 = (("dense", 0), ("fixed", 0), ("bigbird", 0))
TRAIN_DP2_TP2 = (("fixed", 3),)
INFER_DP2_TP2 = ("dense", "fixed")


def _sparse(kind):
    return None if kind == "dense" else kind


def _spawn(tmp, dp, train, infer):
    """The JAX side of each case, then the ranks."""
    built = [tpp.tp_train_case("bert", stage, dp, seed=70 + i,
                               sparse=_sparse(kind),
                               tag_dir=tmp / f"jax_{kind}_{stage}")
             for i, (kind, stage) in enumerate(train)]
    ids = np.random.default_rng(9).integers(
        0, tpp.BERT["vocab_size"], (2, tpp.BERT_T)).astype(np.int64)
    tree = built[0][1]["tree"]
    want_logits, cases = {}, []
    for kind in infer:
        je, kw = tpp.jax_infer("bert", tree, sparse=_sparse(kind))
        want_logits[kind] = np.asarray(je(jnp.asarray(ids)))
        cases.append(tpp.infer_case("bert", tree, kw, ids,
                                    sparse=_sparse(kind)))
    ranks = torch_dist_worker.spawn(
        torch_tp_worker.tp_cases, dp * tpp.TP, tmp,
        {"cases": [c for _, c in built], "infer": cases})
    return {"train": built, "logits": want_logits, "ranks": ranks,
            "infer": infer}


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("bert_tp2"), 1, TRAIN_TP2, KINDS)


@pytest.fixture(scope="module")
def dp2_tp2(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("bert_dp2tp2"), 2, TRAIN_DP2_TP2,
                  INFER_DP2_TP2)


def _logits(run, kind):
    i = run["infer"].index(kind)
    for r in run["ranks"]:
        got = r["infer"][i]
        assert got["tp"] == tpp.TP
        np.testing.assert_allclose(got["logits"], run["logits"][kind],
                                   atol=tpp.LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_tp2_mlm_logits_match_the_jax_tp2_engine(tp2, kind):
    _logits(tp2, kind)


@pytest.mark.parametrize("kind", INFER_DP2_TP2)
def test_dp2_tp2_mlm_logits_match_the_jax_tp2_engine(dp2_tp2, kind):
    _logits(dp2_tp2, kind)


@pytest.mark.parametrize("kind", ("fixed", "bigbird"))
def test_a_rank_layout_is_its_rows_of_the_whole_layout(tp2, kind):
    """Each rank's attention took exactly its heads' rows of the JAX
    package's layout for all 4 heads, and those rows are not the layout
    a 2-head config would make."""
    from deepspeed_tpu.ops import sparse_attention_ops as jops
    cls = {"fixed": jops.FixedSparsityConfig,
           "bigbird": jops.BigBirdSparsityConfig}[kind]
    whole = cls(**tpp.SPARSE[kind]).make_layout(tpp.BERT_T)
    narrow = cls(**dict(tpp.SPARSE[kind], num_heads=2)).make_layout(
        tpp.BERT_T)
    i = tp2["infer"].index(kind)
    for r in tp2["ranks"]:
        got = r["infer"][i]
        h0, total = got["heads"]
        assert total == 4 and len(got["layouts"]) == 1
        rows = got["layouts"][0]
        np.testing.assert_array_equal(rows, whole[h0:h0 + 2])
        if h0:
            assert not np.array_equal(rows, narrow)


def _train(run, i):
    want, case = run["train"][i]
    ranks = [r["train"][i] for r in run["ranks"]]
    zp.assert_case(ranks[0]["state"], want, ranks)
    for step in want[0]:
        assert step["grad_norm"] > tpp.CLIP
    return case


@pytest.mark.parametrize("kind,stage", TRAIN_TP2)
def test_tp2_training_matches_the_jax_tp2_engine(tp2, kind, stage):
    _train(tp2, TRAIN_TP2.index((kind, stage)))


@pytest.mark.parametrize("kind,stage", TRAIN_DP2_TP2)
def test_dp2_tp2_training_matches_the_jax_engine(dp2_tp2, kind, stage):
    _train(dp2_tp2, TRAIN_DP2_TP2.index((kind, stage)))


@pytest.mark.parametrize("mesh", ("tp2", "dp2_tp2"))
def test_tags_are_byte_identical_across_tp_and_packages(request, mesh,
                                                        tmp_path):
    """The JAX engine's tag re-saved by the tp-2 ranks and by a tp-1
    engine: the state files byte for byte the JAX package's."""
    run = request.getfixturevalue(mesh)
    _, case = run["train"][0]
    want = tpp.tag_bytes(case["jax_tag"])
    assert tpp.tag_bytes(case["resaved"]) == want
    tpp.tp1_resave(case, case["jax_tag"], str(tmp_path / "tp1"))
    assert tpp.tag_bytes(str(tmp_path / "tp1")) == want
