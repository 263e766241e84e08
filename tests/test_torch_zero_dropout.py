"""Dropout and random-LTD under data parallelism: rank ``r`` holds rows
``[r micro, (r + 1) micro)`` of the JAX package's global batch and draws
those rows of each of its global draws, bit for bit (the JAX package runs
with ``jax_threefry_partitionable``: an element's bits depend only on its
flat index). Then GPT-2 with dropout 0.1 at stage 3 on 2 gloo ranks
against the JAX package's dp-2 engine (``torch_zero_pairs``): the masks
are the same bits, so the losses and state agree as in float32 without
dropout. In the same spawn of 2 ranks, GPT-2 at stage 2 with ``-100``
labels spread unevenly over the ranks' rows (one rank's micro batch with
none valid): each rank weights its loss by its share of the global micro
batch's valid targets, so the step is the JAX engine's global mean."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt2 import _token_dropout
from deepspeed_tpu.ops.random_ltd_ops import \
    sample_token_indices as jax_sample
from deepspeed_tpu_torch.inference import prng
from deepspeed_tpu_torch.ops import dropout
from deepspeed_tpu_torch.ops.kernels import threefry_dropout as tfd
from deepspeed_tpu_torch.ops.random_ltd_ops import sample_token_indices

import torch_dist_worker
import torch_zero_pairs as zp

MICRO, DP = 2, 2
KEY = jax.random.PRNGKey(7)


@pytest.mark.parametrize("shape", [(MICRO, 32, 64), (MICRO, 4, 32, 32)],
                         ids=["hidden", "probabilities"])
@pytest.mark.parametrize("rank", range(DP))
def test_rank_dropout_masks_are_rows_of_the_global_mask(shape, rank):
    """Token and attention-probability dropout of rank ``r``'s micro batch
    under ``batch_rows(r micro)``: the mask is bitwise rows ``[r micro,
    (r + 1) micro)`` of the JAX package's over the global batch."""
    global_shape = (MICRO * DP,) + shape[1:]
    ones = jnp.ones(global_shape, jnp.float32)
    want = np.asarray(_token_dropout(ones, KEY, True, 0, 0.1) != 0)
    want = want[rank * MICRO:(rank + 1) * MICRO]
    key = prng.fold_in_words(prng.as_key(np.asarray(KEY)), 0)
    with dropout.batch_rows(rank * MICRO):
        out = dropout.token_dropout(torch.ones(shape), key, 0.1)
    assert np.array_equal(out.numpy() != 0, want)
    assert dropout.first_row() == 0          # restored after the block


def test_kernel_offset_is_the_global_counter():
    """The plain version at an element offset is the tail of the draw
    without one (what the kernel is held to on the card)."""
    x = torch.randn(4, 8, 16)
    whole = tfd.threefry_dropout_plain(x, (3, 5), 0.25)
    tail = tfd.threefry_dropout_plain(x[2:].contiguous(), (3, 5), 0.25,
                                      offset=2 * 8 * 16)
    assert torch.equal(tail, whole[2:])
    with pytest.raises(ValueError):
        tfd.threefry_dropout_plain(x, (3, 5), 0.25, offset=-1)


@pytest.mark.parametrize("rank", range(DP))
def test_rank_random_ltd_rows_are_the_jax_rows(rank):
    """Random-LTD's kept tokens for rank ``r``'s rows: rows ``[r micro,
    (r + 1) micro)`` of the JAX function's draw over the global batch."""
    want = np.asarray(jax_sample(KEY, 12, MICRO * DP, 32))
    got = sample_token_indices(prng.as_key(np.asarray(KEY)), 12, MICRO, 32,
                               first_row=rank * MICRO)
    np.testing.assert_array_equal(got.numpy(),
                                  want[rank * MICRO:(rank + 1) * MICRO])


def _uneven_labels(data):
    """Labels with ``-100`` on rank 0's first 5 positions of row 0, rank
    1's first 20 positions of both rows, and every position of rank 1's
    rows in the last step's second micro batch."""
    out = []
    for batch in data:
        labels = batch["input_ids"].copy()
        labels[:, 0, :5] = -100
        labels[:, zp.MICRO:, :20] = -100
        out.append(dict(batch, labels=labels))
    out[-1]["labels"][1, zp.MICRO:] = -100
    return out


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX records and the ranks' results of this file's dp-2
    comparisons, in one spawn: dropout at stage 3, uneven labels at stage
    2."""
    pairs = [zp.case("gpt2", zp.config(3), zp.batches(zp.STEPS, seed=30),
                     dropout=0.1),
             zp.case("gpt2", zp.config(2), _uneven_labels(
                 zp.batches(2, seed=7)))]
    ranks = torch_dist_worker.spawn(torch_dist_worker.train_cases, zp.DP,
                                    tmp_path_factory.mktemp("zero"),
                                    {"cases": [c for _, c in pairs]})
    return [w for w, _ in pairs], ranks


def test_dropout_ranks_match_the_jax_dp2_engine(engines):
    wants, ranks = engines
    zp.assert_case(ranks[0][0]["state"], wants[0], [r[0] for r in ranks])


def test_uneven_valid_counts_give_the_global_mean(engines):
    wants, ranks = engines
    zp.assert_case(ranks[0][1]["state"], wants[1], [r[1] for r in ranks])
