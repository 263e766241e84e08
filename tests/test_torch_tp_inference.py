"""Tensor parallelism of the port's serving held against the JAX
package's ``model`` axis on the CPU: 2 gloo ranks at tp 2 against the
JAX engine on a dp 1 x tp 2 mesh of 2 CPU devices and against the port
at tp 1 (float32, the tiny models of ``torch_pairs``; LLaMA with 4
heads on 2 kv heads). The logits agree within 2e-5; ``generate``
(greedy, sampled, beam) and ``ServingEngine`` streams (staggered greedy
and sampled requests, chunked prefill, self-draft speculation, the prefix
cache) are bitwise the port's at tp 1 on both ranks, and the JAX package's at
tp 2 (for the serving cases of ``JAX_SERVE``). GPT-2 is built whole and sharded by the engine, LLaMA built
on the mesh at its rank's shapes; ``jax_params`` gathers either whole.
Each count that must divide by tp raises naming the numbers. One spawn of
2 ranks; the JAX side runs while the ranks do. (The cases this file once
checked were refused, row A8b2's, run now: ``test_torch_tp_dropout``,
``test_torch_tp_kv``, ``test_torch_tp_bert``, ``test_torch_tp_serving``.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.parallel import tensor_parallel as tpl
from deepspeed_tpu_torch.parallel.topology import DeviceMeshManager

import torch_dist_worker
import torch_pairs as tp
import torch_tp_pairs as tpp
import torch_tp_worker

FAMILIES = ("gpt2", "llama")
SERVE = tuple(tpp.serve_cases())
# the serving cases also run on the JAX engine (its compiles set this
# file's time): GPT-2 with chunked prefill and the prefix cache, LLaMA
# (grouped-query attention) with self drafts
JAX_SERVE = {"gpt2": ("plain", "chunked", "prefix"),
             "llama": ("plain", "spec")}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results and the JAX engine's, computed while the ranks
    run."""
    tmp = tmp_path_factory.mktemp("tp_inf")
    cases = [tpp.inference_case(f, whole=(f == "gpt2")) for f in FAMILIES]
    started = torch_dist_worker.start(
        torch_tp_worker.inference_cases, 2, tmp,
        {"cases": cases})
    jax_side = []
    for case in cases:
        je = tpp.jax_inference(case["family"], case["tree"])
        jax_side.append({
            "logits": np.asarray(je(jnp.asarray(case["ids"]))),
            "generate": [np.asarray(je.generate(
                jnp.asarray(np.asarray(p)[None]), **kw))[0]
                for p, kw in case["generate"]],
            "serve": {name: tpp.jax_serve(je, cfg, submits, **opts)
                      for name, (cfg, submits, opts)
                      in case["serve"].items()
                      if name in JAX_SERVE[case["family"]]}})
    return cases, torch_dist_worker.join(started), jax_side


@pytest.fixture(scope="module")
def jax_side(run):
    return run[2]


@pytest.mark.parametrize("family", FAMILIES)
def test_tp2_logits_match_the_jax_tp2_engine(run, jax_side, family):
    _, ranks, _ = run
    i = FAMILIES.index(family)
    want = jax_side[i]["logits"]
    for r in ranks:
        got = r["tp2"][i]
        assert got["tp"] == 2
        np.testing.assert_allclose(got["logits"], want, atol=tpp.LOGITS_ATOL,
                                   rtol=0)
    np.testing.assert_allclose(ranks[0]["tp1"][i]["logits"], want,
                               atol=tpp.LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("family", FAMILIES)
def test_generate_is_bitwise_jax_tp2_and_port_tp1(run, jax_side, family):
    _, ranks, _ = run
    i = FAMILIES.index(family)
    for j, want in enumerate(jax_side[i]["generate"]):
        for got in [r["tp2"][i] for r in ranks] + [ranks[0]["tp1"][i]]:
            np.testing.assert_array_equal(got["generate"][j], want)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", SERVE)
def test_serving_streams_are_bitwise_jax_tp2_and_port_tp1(run, jax_side,
                                                         family, name):
    """On both ranks; against the JAX engine where it ran the case
    (``JAX_SERVE``), else against the port at tp 1 alone."""
    _, ranks, _ = run
    i = FAMILIES.index(family)
    want, want_hits = ranks[0]["tp1"][i]["serve"][name]
    if name in JAX_SERVE[family]:
        assert (want, want_hits) == jax_side[i]["serve"][name]
    for r in ranks:
        streams, hits = r["tp2"][i]["serve"][name]
        assert streams == want
        assert hits == want_hits
    if name == "prefix":
        assert want_hits > 0


@pytest.mark.parametrize("family", FAMILIES)
def test_rank_holds_its_part_and_jax_params_is_whole(run, family):
    """No rank holds the whole model: the sharded leaves are half; the
    gathered tree is the loaded one, bit for bit."""
    cases, ranks, _ = run
    i = FAMILIES.index(family)
    tree = cases[i]["tree"]
    for r in ranks:
        got = r["tp2"][i]
        assert got["local_numel"] < 0.6 * got["whole_numel"]
        params = got["jax_params"]
        for k, v in tree.items():
            if k == "blocks":
                for n, leaf in v.items():
                    np.testing.assert_array_equal(params["blocks"][n], leaf)
            else:
                np.testing.assert_array_equal(params[k], v)


def test_model_axis_collectives_are_counted(run):
    _, ranks, _ = run
    for r in ranks:
        stats = r["model_axis"]
        assert stats["ops"] > 0 and stats["per_op"]["all_reduce"] > 0
        assert stats["per_op"]["all_gather"] > 0


@pytest.mark.parametrize("family,over,names", [
    ("gpt2", dict(n_embd=66, n_head=3), ("n_head=3", "padded_vocab=96")),
    ("gpt2", dict(vocab_size=95, pad_vocab_to_multiple=1),
     ("n_head=4", "padded_vocab=95")),
    ("llama", dict(n_head=6, n_embd=96, n_kv_head=3, mlp_hidden=96),
     ("n_head=6", "n_kv_head=3", "padded_vocab=96")),
    ("llama", dict(vocab_size=97, pad_vocab_to_multiple=1),
     ("n_head=4", "n_kv_head=2", "padded_vocab=97")),
])
def test_counts_that_do_not_divide_by_tp_raise(family, over, names):
    """Decided at construction, before any collective: no ranks needed."""
    cfg_cls, cls = {"gpt2": (GPT2Config, GPT2Model),
                    "llama": (LlamaConfig, LlamaModel)}[family]
    kw = dict(tp.FAMILIES[family][0], **over)
    with pytest.raises(ValueError) as e:
        cls(cfg_cls(**kw), tp=tpl.TPInfo(2, 0))
    for name in names:
        assert name in str(e.value)


def test_llama2_70b_kv_heads_split_at_tp2():
    """LLaMA-2-70B's 64 heads on 8 kv heads at tp 2: 32 query and 4 kv
    heads a rank, the qkv columns its heads of each of q, k and v."""
    from deepspeed_tpu_torch.models.llama import LLAMA2_70B
    cfg = LlamaConfig(**{**{f: getattr(LLAMA2_70B, f) for f in (
        "n_embd", "n_head", "n_kv_head", "mlp_hidden")},
        "n_layer": 1, "vocab_size": 256})
    m = LlamaModel.__new__(LlamaModel)
    torch.nn.Module.__init__(m)
    m.config, m.tp = cfg, tpl.TPInfo(2, 1)
    m._check_tp()
    assert (m._heads, m.kv_heads) == (32, 4)
    hd = cfg.head_dim
    split = m._make_splits()["blocks.0.qkv_w"]
    cols = split.take(torch.arange(split.whole_shape[1])[None])[0]
    assert len(cols) == (32 + 2 * 4) * hd
    assert cols[0] == 32 * hd and cols[32 * hd] == 64 * hd + 4 * hd


def test_mesh_model_axis_is_innermost():
    mm = DeviceMeshManager(dp=2, tp=2, world_size=4, rank=2)
    assert (mm.tp, mm.tp_rank, mm.dp_rank, mm.dp_world_size) == (2, 0, 1, 2)
    assert tpl.from_mesh(mm).size == 2 and tpl.from_mesh(mm).rank == 0
