"""Shared helpers of the ZeRO parity tests: the JAX package's engine on a
dp-2 mesh of 2 CPU devices and its records, and the cases the port's gloo
ranks run (``torch_dist_worker.train_cases``). Float32, tiny models
(width 64, 2 layers), 3 global steps at gas 2, micro 2 a rank. AdamW at
lr 1e-4: Adam moves a weight by about lr a step whatever the size of its
gradient, so where a gradient is near 0 the two packages' f32 summation
orders (per micro step and rank in the port, in XLA's order in the JAX
package) reach the masters at about lr times their relative difference."""

import jax
import numpy as np

import deepspeed_tpu
from deepspeed_tpu.parallel.topology import initialize_mesh

import torch_pairs

MICRO, GAS, T, DP, STEPS = 2, 2, 32, 2, 3
LOSS_RTOL = 1e-5
ATOL, RTOL = 2e-5, 1e-4


def config(stage, clip=0.0, **extra):
    return dict({"train_batch_size": MICRO * GAS * DP,
                 "train_micro_batch_size_per_gpu": MICRO,
                 "gradient_accumulation_steps": GAS,
                 "optimizer": {"type": "adamw",
                               "params": {"lr": 1e-4, "weight_decay": 0.01}},
                 "gradient_clipping": clip, "steps_per_print": 0,
                 "zero_optimization": {
                     "stage": stage,
                     "stage3_param_persistence_threshold": 1000}}, **extra)


def batches(n, seed=0, vocab=torch_pairs.VOCAB):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (GAS, MICRO * DP, T))
             .astype(np.int32)} for _ in range(n)]


def jax_engine(family, cfg, **over):
    kw, jcfg, jcls = torch_pairs.FAMILIES[family][:3]
    kw = {k: v for k, v in dict(kw, **over).items() if k != "dtype"}
    return deepspeed_tpu.initialize(
        model=jcls(jcfg(**dict(kw, attn_backend="xla"))), config=cfg,
        mesh_manager=initialize_mesh(dp=DP, devices=jax.devices("cpu")[:DP])
    )[0], kw


def _micro(batch, i):
    return {k: v[i] for k, v in batch.items()}


def jax_run(engine, data, loop="train_batch", scale_at=None):
    """The JAX engine's step records (as the workers record them; the
    gradient norm from the step's metrics)."""
    out, seen, post = [], [], engine._post_step
    engine._post_step = lambda m: (seen.append(m), post(m))[1]
    for step, batch in enumerate(data):
        if step in (scale_at or {}):
            old = engine.scaler_state.scale      # keep its sharding: no
            engine.scaler_state = engine.scaler_state._replace(  # recompile
                scale=jax.device_put(np.float32(scale_at[step]),
                                     old.sharding))
        if loop == "train_batch":
            loss = engine.train_batch(batch=batch)
            overflow = None
        else:
            losses = []
            for i in range(GAS):
                losses.append(float(engine.forward(_micro(batch, i))))
                engine.backward()
            metrics = engine.step()
            loss, overflow = np.mean(losses), bool(metrics["overflow"])
        out.append({"loss": float(loss),
                    "grad_norm": float(seen[-1]["grad_norm"]),
                    "skipped": engine.skipped_steps,
                    "scale": float(engine.cur_scale), "overflow": overflow})
    return out


def jax_state(engine):
    """Whole masters, mu and nu as ``{path: numpy}`` maps."""
    from deepspeed_tpu.utils import tensor_fragment as jtf
    paths = jtf.list_param_paths(engine)
    return {"params": {p: jtf.safe_get_full_fp32_param(engine, p)
                       for p in paths},
            "mu": {p: jtf.safe_get_full_optimizer_state(engine, p, "exp_avg")
                   for p in paths},
            "nu": {p: jtf.safe_get_full_optimizer_state(
                engine, p, "exp_avg_sq") for p in paths},
            "count": int(engine.opt_state.count)}


def case(family, cfg, data, loop="train_batch", scale_at=None, **over):
    """``(JAX records, JAX state, the workers' case)`` of one comparison
    (``scale_at``: ``{step: loss scale}`` set before those steps)."""
    engine, kw = jax_engine(family, cfg, **over)
    tree = jax.tree.map(np.asarray, engine.params)
    want = (jax_run(engine, data, loop, scale_at), jax_state(engine))
    return want, {"family": family, "kw": kw, "tree": tree, "config": cfg,
                  "batches": data, "loop": loop, "scale_at": scale_at}


def assert_case(got, want, ranks, atol=ATOL, rtol=RTOL,
                loss_rtol=LOSS_RTOL):
    """Every rank's step records and rank 0's gathered state against the
    JAX engine's."""
    steps, state = want
    for r in ranks:       # every rank took the same steps
        for g, w in zip(r["steps"], steps):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=loss_rtol)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       atol=atol, rtol=rtol)
            assert g["skipped"] == w["skipped"] and g["scale"] == w["scale"]
            if w["overflow"] is not None:
                assert bool(g["overflow"]) == w["overflow"]
    assert got["count"] == state["count"]
    for part in ("params", "mu", "nu"):
        assert sorted(got[part]) == sorted(state[part])
        for path, value in state[part].items():
            np.testing.assert_allclose(got[part][path], value, atol=atol,
                                       rtol=rtol, err_msg=f"{part}/{path}")


