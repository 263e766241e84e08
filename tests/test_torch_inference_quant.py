"""Int8 weight-only serving (``inference/quantization.py``) of the port
held against the JAX package's on the same numpy weights (float32 compute,
the tiny models of ``torch_pairs``): ``quantize_tree``'s ``q`` and
``scale`` bitwise and on the same leaves, the resident bytes, the
logits within 1e-5 (2e-5 at tp 2, whose row-parallel products the ranks
sum) and greedy and sampled ``generate`` streams bitwise, at tp 1 and on
2 gloo ranks at tp 2 (against the JAX int8 engine on a dp 1 x tp 2
mesh); ``dtype: int8`` turns it on and bits other than 8 are
refused with the JAX text; a checkpoint loads in float and is quantized,
and ``with_params`` quantizes the view's weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.inference import config as jconfig
from deepspeed_tpu.inference import quantization as jq
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.runtime.config_utils import ConfigError as JConfigError
from deepspeed_tpu_torch.inference import config as tconfig
from deepspeed_tpu_torch.inference import quantization as tq
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.runtime.config_utils import ConfigError

import torch_dist_worker
import torch_pairs as tp
import torch_quant_worker
import torch_tp_pairs as tpp

FAMILIES = ("gpt2", "llama")
Q32 = {"dtype": "float32", "quant": {"enabled": True}}
LOGITS_ATOL = 1e-5


def engines(family, cfg=Q32, seed=0, mesh=None):
    kw, jcfg, jcls, tcfg, tcls = tp.FAMILIES[family]
    tree = tp.tree(family, seed)
    je = JaxEngine(jcls(jcfg(**kw)),
                   jconfig.DeepSpeedInferenceConfig.from_dict(cfg),
                   params=tree, mesh_manager=mesh)
    te = InferenceEngine(tcls(tcfg(**kw)),
                         tconfig.DeepSpeedInferenceConfig.from_dict(cfg),
                         params=tree, device="cpu")
    return je, te


def _flat(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{n}": x for n, x in v.items()})
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    return request.param, engines(request.param)


def test_quantize_tree_is_the_jax_one(pair):
    family, (je, te) = pair
    jleaves = _flat(je.params)
    qnames = {n for n, v in jleaves.items() if jq.is_quantized(v)}
    got = {}
    for (leaf, layer), p in zip(te.module.jax_layout(),
                                te.module.parameters()):
        if tq.is_quantized(p):
            got.setdefault(leaf, []).append((layer, p))
    assert set(got) == qnames and qnames
    for name, parts in got.items():
        q = torch.stack([p.q for _, p in sorted(parts, key=lambda x: x[0])])
        s = torch.stack([p.scale for _, p in sorted(parts,
                                                     key=lambda x: x[0])])
        np.testing.assert_array_equal(q.numpy(), np.asarray(jleaves[name].q))
        np.testing.assert_array_equal(
            s.numpy().view(np.uint32),
            np.asarray(jleaves[name].scale).view(np.uint32))
    assert tq.tree_nbytes(te.module) == jq.tree_nbytes(je.params)
    assert tq.describe(te.module).split(",")[0] == \
        jq.describe(je.params).split(",")[0]


def test_logits_and_streams_match_the_jax_int8_engine(pair):
    family, (je, te) = pair
    ids = np.stack(tp.prompts((12, 12), seed=3)).astype(np.int64)
    np.testing.assert_allclose(te(ids).numpy(), np.asarray(je(ids)),
                               atol=LOGITS_ATOL, rtol=0)
    prompt = tp.prompts([9], seed=4)[0][None]
    for kw in (dict(max_new_tokens=8),
               dict(max_new_tokens=6, temperature=0.9, top_k=20, seed=5)):
        np.testing.assert_array_equal(
            te.generate(prompt, **kw).numpy(),
            np.asarray(je.generate(prompt, **kw)))


def test_weights_stay_int8_between_calls(pair):
    """No float copy of a quantized weight outlives a call: the module's
    quantized parameters are int8 before and after a forward."""
    family, (_, te) = pair
    n = sum(tq.is_quantized(p) for p in te.module.parameters())
    te(np.zeros((1, 4), np.int64))
    assert n == sum(tq.is_quantized(p) and p.dtype == torch.int8
                    for p in te.module.parameters()) > 0


@pytest.mark.parametrize("cfg", [{"dtype": "int8"},
                                 {"dtype": "int8", "quant": {"group_size": 32}},
                                 {"quant": True}, {"quant": {"enabled": False}}])
def test_dtype_int8_turns_weight_only_serving_on(cfg):
    j = jconfig.DeepSpeedInferenceConfig.from_dict(dict(cfg))
    t = tconfig.DeepSpeedInferenceConfig.from_dict(dict(cfg))
    assert (t.quant is not None and t.quant.enabled) == \
        (j.quant is not None and j.quant.enabled)
    if t.quant is not None:
        assert t.quant.group_size == j.quant.group_size
    assert str(t.dtype).replace("torch.", "") == jnp.dtype(j.dtype).name


def test_bits_other_than_8_are_refused():
    cfg = {"quant": {"enabled": True, "bits": 4}}
    with pytest.raises(JConfigError) as jerr:
        jconfig.DeepSpeedInferenceConfig.from_dict(cfg)
    with pytest.raises(ConfigError) as terr:
        tconfig.DeepSpeedInferenceConfig.from_dict(cfg)
    assert str(terr.value) == str(jerr.value)


def test_checkpoint_loads_float_then_quantizes(tmp_path):
    """A training tag served int8: the weights are the tag's, quantized
    (the logits of an engine handed the tag's tree), and ``with_params``
    quantizes a view's weights."""
    kw = {k: v for k, v in tp.GPT2.items() if k != "dtype"}
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    m = GPT2Model(GPT2Config(**kw))
    m.load_jax_params(tp.tree("gpt2", 1))
    train = deepspeed_tpu_torch.initialize(model=m, config={
        "train_batch_size": 2, "optimizer": {"type": "adamw",
                                             "params": {"lr": 1e-3}}},
        device="cpu")[0]
    train.save_checkpoint(str(tmp_path))
    tree = m.jax_params()
    served = deepspeed_tpu_torch.init_inference(
        GPT2Model(GPT2Config(**kw)), dict(Q32, checkpoint=str(tmp_path)),
        device="cpu")
    direct = InferenceEngine(GPT2Model(GPT2Config(**kw)),
                             tconfig.DeepSpeedInferenceConfig.from_dict(Q32),
                             params=tree, device="cpu")
    ids = np.stack(tp.prompts((10,), seed=6)).astype(np.int64)
    assert sum(tq.is_quantized(p) for p in served.module.parameters()) > 0
    np.testing.assert_array_equal(served(ids).numpy(), direct(ids).numpy())
    view = direct.with_params({k: (torch.as_tensor(v) if not isinstance(
        v, dict) else {n: torch.as_tensor(x) for n, x in v.items()})
        for k, v in tp.tree("gpt2", 2).items()})
    fresh = InferenceEngine(GPT2Model(GPT2Config(**kw)),
                            tconfig.DeepSpeedInferenceConfig.from_dict(Q32),
                            params=tp.tree("gpt2", 2), device="cpu")
    assert sum(tq.is_quantized(p) for p in view.module.parameters()) > 0
    np.testing.assert_array_equal(view(ids).numpy(), fresh(ids).numpy())


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    cases = []
    for family in FAMILIES:
        case = tpp.inference_case(family)
        case["generate"] = case["generate"][:2]          # greedy, sampled
        case.pop("serve")
        cases.append(case)
    jax_side = []
    for case in cases:
        kw, jcfg, jcls = tp.FAMILIES[case["family"]][:3]
        je = JaxEngine(jcls(jcfg(**kw)), jconfig.DeepSpeedInferenceConfig
                       .from_dict(dict(Q32, tensor_parallel={"tp_size": 2})),
                       params=case["tree"], mesh_manager=tpp.jax_mesh())
        case["dequant"] = {k: np.asarray(v.astype(jnp.float32))
                           if jq.is_quantized(v) else None
                           for k, v in _flat(je.params).items()}
        jax_side.append({
            "logits": np.asarray(je(jnp.asarray(case["ids"]))),
            "generate": [np.asarray(je.generate(
                jnp.asarray(np.asarray(p)[None]), **kw))[0]
                for p, kw in case["generate"]]})
    ranks = torch_dist_worker.spawn(torch_quant_worker.int8_serving, 2,
                                    tmp_path_factory.mktemp("q_tp2"),
                                    {"cases": cases})
    return jax_side, ranks


@pytest.mark.parametrize("family", FAMILIES)
def test_tp2_int8_serving_matches_the_jax_tp2_engine(tp2, family):
    jax_side, ranks = tp2
    i = FAMILIES.index(family)
    for r in ranks:
        got = r[i]
        assert got["tp"] == 2 and got["n_quantized"] > 0
        # each rank's part of q and its scales: its part of the JAX
        # package's whole dequantized leaf, bit for bit
        assert got["dequant_worst"] == 0.0
        # tp 2 sums a row-parallel product over the ranks: the tp tests'
        # 2e-5
        np.testing.assert_allclose(got["logits"], jax_side[i]["logits"],
                                   atol=tpp.LOGITS_ATOL, rtol=0)
        for g, w in zip(got["generate"], jax_side[i]["generate"]):
            np.testing.assert_array_equal(g, w)
