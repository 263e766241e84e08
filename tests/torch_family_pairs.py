"""Shared checks of the decoder families of ROADMAP.md row A10 (GPT-NeoX,
GPT-J, OPT, BLOOM, GPT-Neo): the port's model held against the JAX
package's on the CPU, float32, the same numpy weights and ids through
both. Small sizes (vocab 256, width 64, 2 layers, 4 heads; GPT-J rotary 8
of head dim 16; GPT-Neo's window 16, shorter than the sequences). The
serving checks take ``torch_pairs``' engines (vocab 96, weights wide
enough for clear argmaxes). Tolerances: logits, loss and gradients 1e-5
(f32 on both sides; only the order of sums differs; gradients also
relative 1e-4), the cache path against the full forward 1e-4 (the JAX
package's own test), token streams bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepspeed_tpu.models import bloom as jbloom, gpt_neo as jneo
from deepspeed_tpu.models import gpt_neox as jneox, opt as jopt
from deepspeed_tpu.serving import SamplingParams as JaxSamplingParams
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu_torch.models import bloom as tbloom, gpt_neo as tneo
from deepspeed_tpu_torch.models import gpt_neox as tneox, opt as topt
from deepspeed_tpu_torch.serving import SamplingParams, ServingEngine

import torch_pairs as tp

TINY = dict(vocab_size=256, n_positions=256, n_embd=64, n_layer=2,
            n_head=4, pad_vocab_to_multiple=8)
FAMILIES = {
    "neox": (TINY, jneox.GPTNeoXConfig, jneox.GPTNeoXModel,
             tneox.GPTNeoXConfig, tneox.GPTNeoXModel),
    "neox_serial": (dict(TINY, use_parallel_residual=False),
                    jneox.GPTNeoXConfig, jneox.GPTNeoXModel,
                    tneox.GPTNeoXConfig, tneox.GPTNeoXModel),
    "gptj": (dict(TINY, rotary_ndims=8), jneox.gptj_config,
             jneox.GPTNeoXModel, tneox.gptj_config, tneox.GPTNeoXModel),
    "opt": (TINY, jopt.OPTConfig, jopt.OPTModel, topt.OPTConfig,
            topt.OPTModel),
    "bloom": (TINY, jbloom.BloomConfig, jbloom.BloomModel,
              tbloom.BloomConfig, tbloom.BloomModel),
    "neo": (dict(TINY, local_window=16), jneo.GPTNeoConfig, jneo.GPTNeoModel,
            tneo.GPTNeoConfig, tneo.GPTNeoModel),
}
# the attention backend of the port's training path: the kernels' plain
# versions where the family takes a kernel (K3 and its backward; OPT the
# packed K1/K2), the plain attention where a bias keeps it off them
TRAIN_BACKEND = {"neox": "pallas", "neox_serial": "pallas", "gptj": "pallas",
                 "opt": "pallas", "bloom": "auto", "neo": "auto"}
T = 128
ATOL, GRAD_RTOL, CACHE_ATOL = 1e-5, 1e-4, 1e-4


def models(family, **changes):
    kw, jcfg, jcls, tcfg, tcls = FAMILIES[family]
    kw = dict(kw, **changes)
    return jcls(jcfg(**kw)), tcls(tcfg(**kw))


def weights(family, seed=0, scale=1.0, **changes):
    """A JAX-layout tree, every leaf random (logits of order 1)."""
    return tp.random_tree(models(family, **changes)[0], seed, wte_std=0.1,
                          scale=scale)


def ids(b, t, seed=0, vocab=TINY["vocab_size"]):
    return np.random.default_rng(seed).integers(0, vocab, (b, t),
                                                dtype=np.int32)


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def round_trip(family):
    """``jax_params()`` returns the loaded tree bitwise; a fresh module has
    the JAX init's leaves and shapes."""
    jmodel, tmodel = models(family)
    tree = weights(family)
    back = tmodel.load_jax_params(tree).jax_params()
    assert back.keys() == tree.keys()
    assert back["blocks"].keys() == tree["blocks"].keys()
    for name in tmodel.top_leaves:
        np.testing.assert_array_equal(back[name], tree[name], name)
    for name in tmodel.block_leaves:
        np.testing.assert_array_equal(back["blocks"][name],
                                      tree["blocks"][name], name)
    want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    fresh = models(family)[1].jax_params()
    assert jax.tree.map(lambda x: tuple(x.shape), want) == \
        jax.tree.map(lambda x: tuple(x.shape), fresh)


def logits_vs_jax(family, backend="xla", seed=1, scale=1.0, **changes):
    """``logits`` of both packages on one tree (``backend`` on both;
    ``changes`` to the family's config; ``scale`` as ``weights``')."""
    jmodel, tmodel = models(family, attn_backend=backend, **changes)
    tree = weights(family, seed, scale, **changes)
    tmodel.load_jax_params(tree)
    x = ids(2, T, seed)
    want = jmodel.logits(jtree(tree), jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = tmodel.logits(torch.from_numpy(x).long())
    assert got.shape == (2, T, tmodel.config.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def loss_and_grads_vs_jax(family, seed=2):
    """``jax.value_and_grad`` of the JAX ``apply`` (plain attention)
    against autograd of the port's (``TRAIN_BACKEND``), with -100 labels
    sprinkled in."""
    tree = weights(family, seed)
    rng = np.random.default_rng(seed)
    x = ids(2, T, seed)
    labels = x.copy()
    labels[rng.random(labels.shape) < 0.1] = -100
    batch = {"input_ids": x, "labels": labels}
    jmodel = models(family, attn_backend="xla")[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply(p, jb, rng=None, train=True)))(jtree(tree))
    tmodel = models(family, attn_backend=TRAIN_BACKEND[family])[1]
    tmodel.load_jax_params(tree)
    loss = tmodel.apply({k: torch.from_numpy(v).long()
                         for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    for name in tmodel.top_leaves:
        np.testing.assert_allclose(getattr(tmodel, name).grad.numpy(),
                                   np.asarray(want[name]), atol=ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    for name in tmodel.block_leaves:
        got = np.stack([getattr(blk, name).grad.numpy()
                        for blk in tmodel.blocks])
        np.testing.assert_allclose(got, np.asarray(want["blocks"][name]),
                                   atol=ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"blocks/{name}")


def cache_vs_jax(family, seed=3):
    """Prefill and two decode steps through the KV cache of a
    left-padded batch against the JAX ``apply_with_cache`` (logits and
    the cache); then, unpadded, the cache path against the full forward
    (the JAX package's own check, atol 1e-4)."""
    jmodel, tmodel = models(family, attn_backend="xla")
    tree = weights(family, seed)
    tmodel.load_jax_params(tree)
    jparams = jtree(tree)
    x = ids(2, 23, seed)
    steps = [(0, x[:, :20])] + [(20 + i, x[:, 20 + i:21 + i])
                                for i in range(2)]
    jcache = jmodel.init_kv_cache(2, 32, dtype=jnp.float32)
    tcache = tmodel.init_kv_cache(2, 32, dtype=torch.float32)
    with torch.inference_mode():
        for start, chunk in steps:
            want, jcache = jmodel.apply_with_cache(
                jparams, jnp.asarray(chunk), jcache, jnp.int32(start),
                pad_counts=jnp.asarray([0, 3], jnp.int32))
            got, tcache = tmodel.apply_with_cache(
                torch.from_numpy(chunk).long(), tcache, start,
                pad_counts=torch.tensor([0, 3]))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, err_msg=f"{start}")
        np.testing.assert_allclose(tcache["k"].numpy(),
                                   np.asarray(jcache["k"]), atol=ATOL)
        tcache = tmodel.init_kv_cache(2, 32, dtype=torch.float32)
        full = tmodel.logits(torch.from_numpy(x).long())
        for start, chunk in steps:
            got, tcache = tmodel.apply_with_cache(
                torch.from_numpy(chunk).long(), tcache, start)
            np.testing.assert_allclose(
                got.numpy(), full[:, start:start + chunk.shape[1]].numpy(),
                atol=CACHE_ATOL)


def generate_vs_jax(engines, seed=4):
    """Greedy and seeded-sampled ``generate``, and a left-padded batch of
    uneven prompts (the JAX package's
    ``test_left_padded_batch_matches_unpadded_rows``), bitwise the JAX
    engine's; each padded row equals that row generated alone."""
    jax_engine, port = engines
    rows = tp.prompts((6, 10), seed=seed)
    padded = np.zeros((2, 10), np.int32)
    mask = np.zeros((2, 10), np.int32)
    for i, r in enumerate(rows):
        padded[i, 10 - len(r):] = r
        mask[i, 10 - len(r):] = 1
    streams = {}
    for name, kw in (("greedy", {}), ("sampled", dict(
            temperature=0.8, top_k=20, top_p=0.9, seed=7))):
        want = np.asarray(jax_engine.generate(
            jnp.asarray(padded), attention_mask=jnp.asarray(mask),
            max_new_tokens=6, **kw))
        streams[name] = port.generate(padded, attention_mask=mask,
                                      max_new_tokens=6, **kw).numpy()
        np.testing.assert_array_equal(streams[name], want, name)
    for i, r in enumerate(rows):
        solo = port.generate(r[None], max_new_tokens=6).numpy()
        np.testing.assert_array_equal(streams["greedy"][i, 10:],
                                      solo[0, len(r):])


def serving_vs_jax(engines, seed=5):
    """The same staggered requests, greedy and seeded-sampled, through
    both ``ServingEngine``s (the JAX package's
    ``test_family_parity_through_serving``): bitwise the same streams,
    and each greedy stream equal to the port's ``generate``. The prompts
    share one prefill bucket of the JAX engine (one compile); the streams
    run past GPT-Neo's 8-token window."""
    jax_engine, port = engines
    reqs = [(p, dict(max_new_tokens=5 + i % 3, **(
        dict(temperature=0.9, seed=11 + i) if i % 2 else {})))
        for i, p in enumerate(tp.prompts((5, 8, 7, 6), seed=seed))]
    cfg = {"num_slots": 3, "max_model_len": 48}

    def run(srv_cls, params_cls):
        srv = srv_cls(jax_engine if srv_cls is JaxServingEngine else port,
                      cfg)
        rids = []
        for i, (p, kw) in enumerate(reqs):
            if i == 2:
                srv.step()
            rids.append(srv.submit(p, params_cls(**kw)))
        srv.run_until_idle()
        out = [list(srv.result(r).tokens) for r in rids]
        srv.shutdown()
        return out

    want = run(JaxServingEngine, JaxSamplingParams)
    got = run(ServingEngine, SamplingParams)
    assert got == want
    for (p, kw), toks in zip(reqs, got):
        if not kw.get("temperature"):
            ref = port.generate(p[None], max_new_tokens=kw["max_new_tokens"])
            assert ref[0, len(p):].tolist() == toks
