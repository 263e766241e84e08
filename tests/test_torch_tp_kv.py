"""Fewer kv heads than tensor-parallel ranks, held against the JAX
package's ``model`` axis on the CPU (float32, the tiny LLaMA of
``torch_pairs`` with 4 query heads): one kv head at tp 2 (2 gloo ranks)
and two at tp 4 (4 ranks), each kv head replicated over the ranks whose
query heads read it, as Megatron does (the JAX rule splits ``qkv_w``'s
columns whatever the kv count, and GSPMD does the rest). Logits within
2e-5 of the JAX engine at the same tp, ``generate`` (greedy, sampled,
beam) bitwise, served streams bitwise the port's at tp 1 with each rank's
pool holding its one kv head; 3 clipped training steps within 2e-5 (the
shared kv columns' gradients summed over the ranks that hold them, and
counted once in the norm); the JAX engine's tag re-saved at tp and at tp 1
byte for byte its own. ``tp`` not a multiple of the kv heads raises."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.parallel import tensor_parallel as tpl

import torch_dist_worker
import torch_pairs as tp
import torch_tp_pairs as tpp
import torch_tp_worker
import torch_zero_pairs as zp

MESHES = {"tp2-kv1": (2, 1), "tp4-kv2": (4, 2)}


def _spawn(tmp, tp_size, kv):
    want, case = tpp.tp_train_case("llama", 0, 1, seed=80 + tp_size,
                                   tp_size=tp_size, n_kv_head=kv,
                                   tag_dir=tmp / "jax")
    tree = case["tree"]
    je, kw = tpp.jax_infer("llama", tree, tp_size=tp_size, n_kv_head=kv)
    ids = np.stack(tp.prompts((10, 10), seed=1)).astype(np.int64)
    prompt = tp.prompts([7], seed=2)[0]
    generate = [(prompt, dict(max_new_tokens=5)),
                (prompt, dict(max_new_tokens=5, temperature=0.8, seed=3)),
                (prompt, dict(max_new_tokens=4, num_beams=3))]
    serve = tpp.serve_cases()["plain"][:2]
    jax_side = {"logits": np.asarray(je(jnp.asarray(ids))),
                "generate": [np.asarray(je.generate(
                    jnp.asarray(np.asarray(p)[None]), **g))[0]
                    for p, g in generate]}
    infer = tpp.infer_case("llama", tree, kw, ids, tp_size=tp_size,
                           generate=generate, serve=serve)
    one = dict(infer, tp=1)
    ranks = torch_dist_worker.spawn(
        torch_tp_worker.tp_cases, tp_size, tmp,
        {"cases": [case], "infer": [infer, one]})
    return {"want": want, "case": case, "jax": jax_side, "ranks": ranks,
            "kv": kv, "tp": tp_size}


@pytest.fixture(scope="module", params=list(MESHES))
def run(request, tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp(request.param),
                  *MESHES[request.param])


def test_logits_match_the_jax_engine(run):
    for r in run["ranks"]:
        got = r["infer"][0]
        assert got["tp"] == run["tp"] and got["kv_heads"] == 1
        np.testing.assert_allclose(got["logits"], run["jax"]["logits"],
                                   atol=tpp.LOGITS_ATOL, rtol=0)


def test_generate_is_bitwise_the_jax_engine(run):
    for r in run["ranks"]:
        for got, want in zip(r["infer"][0]["generate"],
                             run["jax"]["generate"]):
            np.testing.assert_array_equal(got, want)


def test_served_streams_are_bitwise_tp1_on_one_kv_head_a_rank(run):
    for r in run["ranks"]:
        got, one = r["infer"]
        assert got["serve"] == one["serve"]
        assert got["pool_heads"] == 1 and one["pool_heads"] == run["kv"]


def test_training_matches_the_jax_engine(run):
    ranks = [r["train"][0] for r in run["ranks"]]
    zp.assert_case(ranks[0]["state"], run["want"], ranks)
    for step in run["want"][0]:
        assert step["grad_norm"] > tpp.CLIP


def test_the_tag_is_byte_identical_at_tp_and_tp1(run, tmp_path):
    case = run["case"]
    want = tpp.tag_bytes(case["jax_tag"])
    assert tpp.tag_bytes(case["resaved"]) == want
    tpp.tp1_resave(case, case["jax_tag"], str(tmp_path / "tp1"))
    assert tpp.tag_bytes(str(tmp_path / "tp1")) == want


def test_tp_not_a_multiple_of_the_kv_heads_raises():
    kw = dict(tp.LLAMA, n_head=12, n_embd=96, n_kv_head=3, mlp_hidden=96)
    with pytest.raises(ValueError) as e:
        LlamaModel(LlamaConfig(**kw), tp=tpl.TPInfo(4, 0))
    assert "n_kv_head=3" in str(e.value) and "tp=4" in str(e.value)


def test_shared_blocks_take_gather_and_count_once():
    """``qkv``'s split at tp 4 over 2 kv heads: rank r holds q block r and
    kv head r // 2; assembling every rank's part gives the whole back;
    only the first rank of a kv head counts it in a norm."""
    whole = torch.arange(2 * 24).reshape(2, 24)      # q 16 | k 4 | v 4
    splits = [tpl.TPSplit((2, 24), 1, r, 4, [16, 4, 4], [4, 2, 2])
              for r in range(4)]
    parts = [s.take(whole) for s in splits]
    assert parts[3].tolist()[0] == [12, 13, 14, 15, 18, 19, 22, 23]
    assert torch.equal(splits[0].assemble(parts), whole)
    masks = [s.owned_mask().tolist() for s in splits]
    assert masks[0] == [True] * 8 and masks[1] == [True] * 4 + [False] * 4
