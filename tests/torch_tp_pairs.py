"""Shared helpers of the tensor-parallel tests: the JAX package's engines
on a mesh with a ``model`` axis (dp 1 x tp 2 on 2 CPU devices, or dp 2 x
tp 2 on 4), and the cases the port's gloo ranks run
(``torch_tp_worker``). Float32, the tiny models of ``torch_pairs``
(width 64, 2 layers, 4 heads; LLaMA on 2 kv heads, so a rank holds 2
query heads on 1 kv head). Training: 3 global steps at gas 2, micro 2 a
dp rank, AdamW at lr 1e-4 as in ``torch_zero_pairs``, with clipping."""

import jax
import numpy as np

import deepspeed_tpu
from deepspeed_tpu.inference import config as jconfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu.serving import SamplingParams as JaxSamplingParams
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine

import torch_pairs as tp
import torch_zero_pairs as zp

TP = 2
LOGITS_ATOL = 2e-5


def jax_mesh(dp=1, tp_size=TP):
    return initialize_mesh(dp=dp, tp=tp_size,
                           devices=jax.devices("cpu")[:dp * tp_size])


def jax_inference(family, tree):
    """The JAX package's engine at tp 2 (dp 1 x tp 2) on ``tree``."""
    kw, jcfg, jcls = tp.FAMILIES[family][:3]
    cfg = jconfig.DeepSpeedInferenceConfig.from_dict(
        {"dtype": "float32", "tensor_parallel": {"tp_size": TP}})
    return JaxEngine(jcls(jcfg(**kw)), cfg, params=tree,
                     mesh_manager=jax_mesh())


def jax_serve(engine, cfg, submits, stagger=(), one_at_a_time=False):
    """``torch_tp_worker.serve`` on the JAX package's ``ServingEngine``."""
    srv = JaxServingEngine(engine, cfg)
    rids = []
    for i, (p, kw) in enumerate(submits):
        if i in stagger:
            srv.step()
        rids.append(srv.submit(p, JaxSamplingParams(**kw)))
        if one_at_a_time:
            srv.run_until_idle()
    srv.run_until_idle()
    assert {srv.result(r).state.value for r in rids} == {"finished"}
    out = [list(srv.result(r).tokens) for r in rids]
    cache = srv.scheduler.prefix_cache
    hits = cache.stats()["hits"] if cache is not None else None
    srv.shutdown()
    return out, hits


def mixed(lengths, seed, new=6):
    """Greedy and seeded-sampled requests (temperature, top-k, top-p)."""
    kinds = [{}, dict(temperature=0.9, seed=5),
             dict(temperature=1.2, top_k=7, seed=-3), {},
             dict(temperature=0.7, top_p=0.85, seed=2 ** 31 - 1)]
    return [(p, dict(max_new_tokens=new + i % 3, **kinds[i % len(kinds)]))
            for i, p in enumerate(tp.prompts(lengths, seed=seed))]


def serve_cases():
    """``{name: (serving config, requests, options)}``: staggered mixed
    requests, chunked prefill, self-draft speculation, the prefix cache."""
    shared = tp.prompts([20], seed=3)[0]
    return {
        "plain": ({"num_slots": 3, "max_model_len": 64},
                  mixed((5, 12, 7, 3, 14), 11), {"stagger": (3,)}),
        "chunked": ({"num_slots": 3, "max_model_len": 96,
                     "chunked_prefill": {"enabled": True,
                                         "chunk_tokens": 16}},
                    mixed((40, 7, 53), 12), {}),
        "spec": ({"num_slots": 4, "max_model_len": 64,
                  "speculative": {"enabled": True, "k": 2,
                                  "draft": {"mode": "self", "layers": 1}}},
                 mixed((5, 9, 13), 13, new=8), {}),
        "prefix": ({"num_slots": 2, "max_model_len": 64,
                    "prefix_cache": {"enabled": True}},
                   [(np.concatenate([shared, q]), dict(max_new_tokens=5))
                    for q in tp.prompts((3, 5, 4), seed=4)],
                   {"one_at_a_time": True}),
    }


def inference_case(family, whole=False):
    """One family's inference case for ``torch_tp_worker.inference_cases``
    (``whole``: the model is built whole and the engine shards it)."""
    prompt = tp.prompts([7], seed=2)[0]
    return {"family": family, "kw": tp.FAMILIES[family][0],
            "tree": tp.tree(family), "whole": whole,
            "ids": np.stack(tp.prompts((10, 10), seed=1)).astype(np.int64),
            "generate": [(prompt, dict(max_new_tokens=5)),
                         (prompt, dict(max_new_tokens=5, temperature=0.8,
                                       seed=3)),
                         (prompt, dict(max_new_tokens=4, num_beams=3))],
            "serve": serve_cases()}


# ------------------------------------------------------------- training

MICRO, GAS, T, STEPS = 2, 2, 32, 3
CLIP = 0.05          # below every step's norm here: each step is clipped


def train_config(stage, dp):
    return {"train_batch_size": MICRO * GAS * dp,
            "train_micro_batch_size_per_gpu": MICRO,
            "gradient_accumulation_steps": GAS,
            "tensor_parallel_size": TP,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-4, "weight_decay": 0.01}},
            "gradient_clipping": CLIP, "steps_per_print": 0,
            "zero_optimization": {
                "stage": stage, "stage3_param_persistence_threshold": 1000}}


def train_batches(dp, seed):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, tp.VOCAB, (GAS, MICRO * dp, T))
             .astype(np.int32)} for _ in range(STEPS)]


def train_case(family, stage, dp, seed):
    """``(JAX records and state, the workers' case)``."""
    kw, jcfg, jcls = tp.FAMILIES[family][:3]
    kw = {k: v for k, v in kw.items() if k != "dtype"}
    cfg = train_config(stage, dp)
    engine = deepspeed_tpu.initialize(
        model=jcls(jcfg(**dict(kw, attn_backend="xla"))), config=cfg,
        mesh_manager=jax_mesh(dp))[0]
    tree = jax.tree.map(np.asarray, engine.params)
    data = train_batches(dp, seed)
    want = (zp.jax_run(engine, data), zp.jax_state(engine))
    return want, {"family": family, "kw": kw, "tree": tree, "config": cfg,
                  "batches": data}


# ---------------------------------------------- the cases of row A8b2

# BERT: the tiny decoders' width and depth, 128 positions (a Fixed or
# BigBird layout of 8 blocks of 16); the layouts differ between heads
BERT = dict(vocab_size=tp.VOCAB, n_positions=128, n_embd=64, n_layer=2,
            n_head=4, pad_vocab_to_multiple=8)
BERT_T = 128
SPARSE = {"fixed": dict(num_heads=4, block=16, num_local_blocks=4,
                        num_global_blocks=1, different_layout_per_head=True,
                        num_different_global_patterns=4),
          "bigbird": dict(num_heads=4, block=16,
                          different_layout_per_head=True,
                          num_random_blocks=2, num_sliding_window_blocks=3,
                          num_global_blocks=1, seed=3)}


def family(name):
    """``(config kwargs, JAX config class, JAX model class)`` of a family,
    BERT included."""
    if name == "bert":
        from deepspeed_tpu.models.bert import BertConfig, BertModel
        return dict(BERT), BertConfig, BertModel
    kw, jcfg, jcls = tp.FAMILIES[name][:3]
    return {k: v for k, v in kw.items() if k != "dtype"}, jcfg, jcls


def jax_sparse(jmodel, kind):
    """The JAX package's sparse surgery of ``kind`` on ``jmodel``."""
    from deepspeed_tpu.ops import sparse_attention_ops as jops
    from deepspeed_tpu.ops.sparse_attention_utils import \
        SparseAttentionUtils as JaxUtils
    cls = {"fixed": jops.FixedSparsityConfig,
           "bigbird": jops.BigBirdSparsityConfig}[kind]
    return JaxUtils.replace_model_self_attention_with_sparse_self_attention(
        jmodel, sparsity_config=cls(**SPARSE[kind]))


def bert_batches(dp, seed, steps=STEPS):
    """BERT's ``[gas, micro * dp, T]`` batches, 15% of the labels set."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = rng.integers(0, tp.VOCAB, (GAS, MICRO * dp, BERT_T))
        labels = np.where(rng.random(ids.shape) < 0.15, ids, -100)
        out.append({"input_ids": ids.astype(np.int32),
                    "labels": labels.astype(np.int32)})
    return out


def tp_train_case(name, stage, dp, seed, tp_size=TP, sparse=None,
                  tag_dir=None, **over):
    """``train_case`` for any family at any tp: ``over`` changes the
    config (``dropout``, ``n_kv_head``), ``sparse`` installs that
    surgery on both sides, ``tag_dir`` has the JAX engine save a tag
    there after its steps (the workers load it and save it again)."""
    kw, jcfg, jcls = family(name)
    kw = dict(kw, **over)
    cfg = dict(train_config(stage, dp), tensor_parallel_size=tp_size,
               train_batch_size=MICRO * GAS * dp)
    jmodel = jcls(jcfg(**dict(kw, attn_backend="xla")))
    if sparse:
        jmodel = jax_sparse(jmodel, sparse)
    engine = deepspeed_tpu.initialize(model=jmodel, config=cfg,
                                      mesh_manager=jax_mesh(dp, tp_size))[0]
    tree = jax.tree.map(np.asarray, engine.params)
    data = bert_batches(dp, seed) if name == "bert" else \
        train_batches(dp, seed)
    want = (zp.jax_run(engine, data), zp.jax_state(engine))
    case = {"family": name, "kw": kw, "tree": tree, "config": cfg,
            "batches": data,
            "sparse": (sparse, SPARSE[sparse]) if sparse else None}
    if tag_dir is not None:
        engine.save_checkpoint(str(tag_dir))
        case.update(jax_tag=str(tag_dir), resaved=str(tag_dir) + "_port")
    return want, case


def jax_infer(name, tree, tp_size=TP, sparse=None, **over):
    """The JAX package's inference engine of a family at ``tp_size``
    (dp 1) on ``tree``, and the config kwargs of the case."""
    kw, jcfg, jcls = family(name)
    kw = dict(kw, **over)
    jmodel = jcls(jcfg(**kw))
    if sparse:
        jmodel = jax_sparse(jmodel, sparse)
    cfg = jconfig.DeepSpeedInferenceConfig.from_dict(
        {"dtype": "float32", "tensor_parallel": {"tp_size": tp_size}})
    return JaxEngine(jmodel, cfg, params=tree,
                     mesh_manager=jax_mesh(1, tp_size)), kw


def infer_case(name, tree, kw, ids, tp_size=TP, sparse=None, generate=(),
               serve=None):
    """A case of ``torch_tp_worker.tp_infer_case``."""
    return {"family": name, "kw": kw, "tree": tree, "ids": ids,
            "tp": tp_size, "generate": list(generate), "serve": serve,
            "sparse": (sparse, SPARSE[sparse]) if sparse else None}


def tag_bytes(d):
    """The state files of the latest tag under ``d``, by name."""
    import os
    with open(os.path.join(d, "latest")) as f:
        tag = os.path.join(d, f.read().strip())
    out = {}
    for name in ("model_states.msgpack", "optim_states.msgpack"):
        with open(os.path.join(tag, name), "rb") as f:
            out[name] = f.read()
    return out


def tp1_resave(case, src, dst):
    """A tp-1 engine of the port (this process) loading the tag under
    ``src`` and saving it under ``dst``."""
    import deepspeed_tpu_torch
    import torch_tp_worker
    cfg = {k: v for k, v in case["config"].items()
           if k != "tensor_parallel_size"}
    cfg["train_batch_size"] = MICRO * GAS
    m = torch_tp_worker.model(case["family"], case["kw"], case["tree"],
                              tp=1)
    engine = deepspeed_tpu_torch.initialize(model=m, config=cfg,
                                            device="cpu")[0]
    engine.load_checkpoint(src)
    engine.save_checkpoint(dst)


# ------------------------------------ the decoder families of row A10

def family_case(family, loss=False):
    """One family's case for ``torch_tp_worker.family_cases``: logits of
    two rows, three mixed requests served on 3 slots; with ``loss``, a
    batch whose loss and gradients the ranks return (labels with -100)."""
    kw = tp.FAMILIES[family][0]
    case = {"family": family, "kw": kw, "tree": tp.tree(family),
            "ids": np.stack(tp.prompts((12, 12), seed=1)).astype(np.int64),
            "serve": ({"num_slots": 3, "max_model_len": 64},
                      mixed((5, 7, 6), 14))}
    if loss:
        rng = np.random.default_rng(15)
        ids = rng.integers(0, tp.VOCAB, (2, 24)).astype(np.int64)
        labels = ids.copy()
        labels[rng.random(labels.shape) < 0.1] = -100
        case["batch"] = {"input_ids": ids, "labels": labels}
    return case
