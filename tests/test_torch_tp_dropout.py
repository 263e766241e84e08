"""Dropout under tensor parallelism, held against the JAX package's
``model`` axis on the CPU (float32, the tiny models of ``torch_pairs``).

A rank's attention probabilities ``[B, H / tp, T, T]`` are its heads of
the JAX draw over the global ``[B, H, T, T]`` (``jax_threefry_partitionable``:
an element's bits are its flat index's): the plain version of the dropout
kernel under the head-strided counter map (``ops/dropout.counter_map``)
is bitwise that draw's slice, at each rank's heads and at a data-parallel
rank's rows. Then GPT-2, LLaMA and dense BERT at dropout 0.1 train 3
clipped steps on 2 gloo ranks at tp 2 (ZeRO stage 0) and on 4 at dp 2 x
tp 2 (stage 1) against the JAX engine on the same mesh: losses, the
gradient norms and every gathered master and moment within 2e-5, which
only the same masks give. One spawn for each world; the JAX side runs
first."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt2 import _token_dropout
from deepspeed_tpu_torch.inference import prng
from deepspeed_tpu_torch.ops import dropout
from deepspeed_tpu_torch.ops.kernels import threefry_dropout as tfd

import torch_dist_worker
import torch_tp_pairs as tpp
import torch_tp_worker
import torch_zero_pairs as zp

KEY = jax.random.PRNGKey(11)
B, H, T = 2, 4, 24
RATE = 0.1
TP2 = ("gpt2", "llama", "bert")
DP2_TP2 = ("gpt2", "bert")


@pytest.mark.parametrize("rank,first,dp_rows", [
    (0, 0, 0), (1, 0, 0), (1, 2, 2)], ids=["rank0", "rank1", "rank1-dp-row"])
def test_rank_heads_are_a_strided_slice_of_the_whole_draw(rank, first,
                                                          dp_rows):
    """The probabilities' mask of tp rank ``rank`` (heads ``[rank H / 2,
    (rank + 1) H / 2)``) of a dp rank whose rows start at ``first``:
    bitwise the JAX package's mask over the whole ``[B + dp_rows, H, T,
    T]`` sliced to those rows and heads, by ``prng.bernoulli`` and by the
    kernel's plain version alike."""
    whole = (B + dp_rows, H, T, T)
    want = np.asarray(_token_dropout(jnp.ones(whole, jnp.float32), KEY,
                                     True, 0, RATE) != 0)
    h = H // 2
    want = want[first:first + B, rank * h:(rank + 1) * h]
    key = prng.fold_in_words(prng.as_key(np.asarray(KEY)), 0)
    with dropout.batch_rows(first), dropout.rank_heads(rank * h, H):
        where = dropout.counter_map((B, h, T, T), dropout.first_row(),
                                    dropout._HEADS)
        out = dropout.token_dropout(torch.ones(B, h, T, T), key, RATE)
    assert where[1] == h * T * T and where[2] == H * T * T
    assert np.array_equal(out.numpy() != 0, want)
    keep = prng.bernoulli(key, 1 - RATE, (B, h, T, T), offset=where[0],
                          inner=where[1], stride=where[2])
    assert np.array_equal(keep.numpy(), want)
    assert dropout._HEADS is None and dropout.first_row() == 0


def test_inner_equal_to_stride_is_the_contiguous_launch():
    """``inner == stride`` (and ``inner`` past the tensor) normalise to
    the contiguous map: the same bits as no map; a map whose stride is
    below ``inner`` is refused."""
    x = torch.randn(3, 5, 7)
    plain = tfd.threefry_dropout_plain(x, (3, 5), 0.25, 70)
    for inner, stride in ((35, 35), (105, 200)):
        assert torch.equal(tfd.threefry_dropout_plain(
            x, (3, 5), 0.25, 70, inner, stride), plain)
    with pytest.raises(ValueError):
        tfd.threefry_dropout_plain(x, (3, 5), 0.25, 0, 10, 9)


def _run(names, dp, tmp, stage):
    built = [tpp.tp_train_case(n, stage, dp, seed=60 + i, dropout=RATE)
             for i, n in enumerate(names)]
    ranks = torch_dist_worker.spawn(torch_tp_worker.tp_train_cases,
                                    dp * tpp.TP, tmp,
                                    {"cases": [c for _, c in built]})
    return [w for w, _ in built], ranks


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return _run(TP2, 1, tmp_path_factory.mktemp("drop_tp2"), 0)


@pytest.fixture(scope="module")
def dp2_tp2(tmp_path_factory):
    return _run(DP2_TP2, 2, tmp_path_factory.mktemp("drop_dp2tp2"), 1)


def _check(run, i):
    wants, ranks = run
    zp.assert_case(ranks[0][i]["state"], wants[i], [r[i] for r in ranks])
    for step in wants[i][0]:
        assert step["grad_norm"] > tpp.CLIP
    assert all(r[i]["tp"] == tpp.TP for r in ranks)


@pytest.mark.parametrize("name", TP2)
def test_tp2_dropout_training_matches_the_jax_tp2_engine(tp2, name):
    _check(tp2, TP2.index(name))


@pytest.mark.parametrize("name", DP2_TP2)
def test_dp2_tp2_dropout_training_matches_the_jax_engine(dp2_tp2, name):
    _check(dp2_tp2, DP2_TP2.index(name))
