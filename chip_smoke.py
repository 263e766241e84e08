#!/usr/bin/env python3
"""Drive the PyTorch/H100 port once on one GPU and check it.

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, one line each: environment; build of every kernel source from the
checkout; each kernel against its plain PyTorch version on the card, with
times; the port's two main paths on GPT-2-125M at full width (random
weights from a seed): ``init_inference`` answering ``engine(input_ids)``
scoring calls and ``generate`` requests, then ``initialize`` taking
``train_batch`` steps (bf16 on fp32 masters, AdamW, gradient accumulation);
the gradients of the kernel path against the plain attention path; a
repeated batch whose loss must fall; a profile of each path. Every check
raises on failure, so the script exits non-zero without printing a
result. The last lines are one JSON
object describing every kernel, the card's name and power limit from
``nvidia-smi``, and ``{"ok": true, "device": {...}}``. Without a GPU it
exits non-zero and prints no result. It imports neither JAX nor the JAX
package.
"""

import dataclasses
import json
import statistics
import subprocess
import sys
import time

SEED = 1234
PEAK_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,   # dense tensor cores
              "float32": 67e12}                       # CUDA cores
# kernel-vs-plain tolerances (max abs error of out, of lse), by dtype:
# f32 differs only by summation order; bf16/f16 round the output (~4e-3
# relative for bf16) and may round a P value the other way
KERNEL_TOL = {"float32": (5e-5, 1e-4), "bfloat16": (2e-2, 1e-2),
              "float16": (2e-2, 1e-2)}
# K1 path vs plain-attention path, GPT-2-125M bf16 logits: both round
# activations to bf16 at different points (the kernel rounds P before P.V,
# the plain path rounds the softmax probabilities), which drifts through 12
# layers; a wrong kernel moves the mean by tenths
LOGITS_TOL = {"mean_abs": 1e-2, "max_abs": 0.25}
# a greedy token must equal the full-forward argmax wherever the top-2 gap
# of the full-forward logits exceeds this
ARGMAX_MARGIN = 0.1
# K2-vs-plain tolerances (max abs error of dq, dk, dv; gradients of std
# ~0.1-1 at this shape), by dtype: f32 differs only by summation order;
# bf16/f16 round p and ds before the products and the outputs, and one
# rounding step of p or ds the other way moves a sum by ~1e-2 of its terms
K2_TOL = {"float32": 1e-4, "bfloat16": 5e-2, "float16": 1e-2}
# K1/K2 path vs plain attention path, gradients of one bf16 micro batch of
# GPT-2-125M: both paths round to bf16 at other points (the plain path
# rounds its logits before the softmax), ~1e-2 relative per leaf at a small
# size; a wrong kernel gives errors of order 1
TRAIN_GRAD_TOL = {"rel_l2_per_leaf": 5e-2, "loss_abs": 2e-2}
# a repeated batch (ids from the first 256 tokens) for 10 steps at lr 1e-3:
# the last loss must be below this fraction of the first (ln 50257 = 10.8
# at the start, ln 256 = 5.5 for the batch's unigram distribution alone)
CONVERGE_STEPS, CONVERGE_FRACTION = 10, 0.8
TRAIN_GAS, TRAIN_MICRO, TRAIN_WARMUP, TRAIN_TIMED = 4, 8, 2, 3


def phase(name, **fields):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def median_ms(torch, fn, reps=20, warmup=3):
    """Median of CUDA-event times of ``reps`` single calls, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kept_pairs(t, causal, window):
    """(query, key) pairs the attention keeps."""
    if not causal:
        return t * t
    if window is None:
        return t * (t + 1) // 2
    return sum(min(i + 1, window) for i in range(t))


def check_k1(torch, b, t, h, d, dtype, causal, window):
    """K1 against its plain version on the card, on one [B, T, 3*H*D] qkv
    projection (q/k/v read in place as its column thirds)."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as k1
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda",
                      dtype=torch.float32).to(dtype)
    q, k, v = qkv.split(h * d, dim=-1)
    out, lse = k1.packed_flash_attention_fwd(q, k, v, h, causal=causal,
                                             window=window)
    ref_out, ref_lse = k1.packed_flash_attention_plain(q, k, v, h, causal,
                                                       None, window)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    err_out = (out.float() - ref_out.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    tol_out, tol_lse = KERNEL_TOL[dname]
    check(torch.isfinite(out.float()).all().item(), "K1 output not finite")
    check(err_out <= tol_out and err_lse <= tol_lse,
          f"K1 {dname} causal={causal} window={window}: out err {err_out} "
          f"(tol {tol_out}), lse err {err_lse} (tol {tol_lse})")

    kernel_ms = median_ms(torch, lambda: k1.packed_flash_attention_fwd(
        q, k, v, h, causal=causal, window=window))
    plain_ms = median_ms(torch, lambda: k1.packed_flash_attention_plain(
        q, k, v, h, causal, None, window), reps=5, warmup=1)
    q4, k4, v4 = (x.reshape(b, t, h, d).transpose(1, 2).contiguous()
                  for x in (q, k, v))
    mask = None
    if window is not None:
        pos = torch.arange(t, device="cuda")
        delta = pos[:, None] - pos[None, :]
        mask = (delta >= 0) & (delta < window)
    library_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, is_causal=causal and mask is None))
    itemsize = torch.empty((), dtype=dtype).element_size()
    n_bytes = 4 * b * t * h * d * itemsize + 4 * b * h * t
    flops = 4 * b * h * d * kept_pairs(t, causal, window)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dname] * 1e3
    res = {"dtype": dname, "causal": causal, "window": window,
           "shape": [b, t, h, d], "err_out": err_out, "err_lse": err_lse,
           "tol_out": tol_out, "tol_lse": tol_lse, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    phase("kernel-check K1", **res)
    return res


def check_k2(torch, b, t, h, d, dtype, causal, window):
    """K2 against its plain version on the card: one [B, T, 3*H*D] qkv,
    K1's output and lse, a random output gradient."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as k1
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda",
                      dtype=torch.float32).to(dtype)
    dout = torch.randn((b, t, h * d), generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)
    q, k, v = qkv.split(h * d, dim=-1)
    out, lse = k1.packed_flash_attention_fwd(q, k, v, h, causal=causal,
                                             window=window)
    delta = k1.attention_delta(out, dout, h)

    def kernel():
        return k1.packed_flash_attention_bwd(qkv, out, lse, dout, h,
                                             causal=causal, window=window)

    def plain():
        return k1.packed_flash_attention_bwd_plain(q, k, v, dout, lse, delta,
                                                   h, causal, None, window)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    errs = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got.split(h * d, dim=-1), want)]
    tol = K2_TOL[dname]
    check(torch.isfinite(got.float()).all().item(), "K2 output not finite")
    check(max(errs) <= tol,
          f"K2 {dname} causal={causal} window={window}: dq/dk/dv errors "
          f"{errs} (tol {tol})")

    kernel_ms = median_ms(torch, kernel)
    plain_ms = median_ms(torch, plain, reps=5, warmup=1)
    # the library's backward: SDPA forward+backward minus its forward
    q4, k4, v4 = (x.reshape(b, t, h, d).transpose(1, 2).contiguous()
                  .requires_grad_() for x in (q, k, v))
    g4 = dout.reshape(b, t, h, d).transpose(1, 2).contiguous()
    mask = None
    if window is not None:
        pos = torch.arange(t, device="cuda")
        diff = pos[:, None] - pos[None, :]
        mask = (diff >= 0) & (diff < window)

    def sdpa():
        return F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, is_causal=causal and mask is None)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (q4, k4, v4), g4)

    with torch.no_grad():
        fwd_ms = median_ms(torch, sdpa)
    library_ms = median_ms(torch, sdpa_fwd_bwd) - fwd_ms
    itemsize = torch.empty((), dtype=dtype).element_size()
    # q, k, v, dO read and dq, dk, dv written once; lse and delta (f32) read
    n_bytes = 7 * b * t * h * d * itemsize + 2 * 4 * b * h * t
    # 10 D FLOP per kept (q, k) pair: the TPU kernel's own cost estimate
    # (five products of 2 D each)
    flops = 10 * b * h * d * kept_pairs(t, causal, window)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dname] * 1e3
    res = {"dtype": dname, "causal": causal, "window": window,
           "shape": [b, t, h, d], "err_dq": errs[0], "err_dk": errs[1],
           "err_dv": errs[2], "tol": tol, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "SDPA fwd+bwd minus fwd",
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    phase("kernel-check K2", **res)
    return res


def profile_forward(torch, engine, ids, top=8):
    """Device time by kernel over one scoring call (torch.profiler): the
    busiest kernels, their sum, and the share of the call's wall time in
    which no kernel ran (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        engine(ids)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - s0) * 1e3
    report_profile("profile forward", prof, wall_ms, top)


def kernel_group(key):
    """The group a device kernel's time is reported under."""
    name = key.lower()
    return ("K1 flash_attention_packed" if "fwd_kernel" in name else
            "K2 flash_attention_packed_bwd" if "dkdv_kernel" in name or
            "dq_kernel" in name else
            "optimizer (foreach)" if "foreach" in name or
            "multi_tensor" in name else
            "matmul" if any(s in name for s in (
                "gemm", "nvjet", "xmma", "cutlass", "sm90_")) else
            "elementwise/copy/reduce" if any(s in name for s in (
                "elementwise", "copy", "reduce", "softmax", "scatter",
                "gather", "index")) else
            "other")


def report_profile(name, prof, wall_ms, top=8):
    """One phase line: device time by kernel group, the busiest kernels,
    and the share of the wall time in which no kernel ran (profiler
    overhead included)."""
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        phase(name, device_time="not measured (no device events in the "
              "trace)", wall_ms=wall_ms)
        return
    rows.sort(reverse=True)
    groups = {}
    for ms, _, key in rows:
        group = kernel_group(key)
        groups[group] = groups.get(group, 0.0) + ms
    phase(name, wall_ms=round(wall_ms, 3),
          device_busy_ms=round(busy_ms, 3),
          idle_share=round(1 - busy_ms / wall_ms, 4),
          groups_ms=json.dumps({g: round(v, 3) for g, v in groups.items()}),
          top=json.dumps([[round(ms, 3), n, key[:70]]
                          for ms, n, key in rows[:top]]))


def train_config(lr, gas):
    """bench.py's training config (GPT-2-125M, bf16 on fp32 masters, AdamW,
    ZeRO-0), with its own gas."""
    return {"train_batch_size": TRAIN_MICRO * gas,
            "train_micro_batch_size_per_gpu": TRAIN_MICRO,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "adamw", "params": {"lr": lr}},
            "bf16": {"enabled": True},
            "zero_optimization": {"stage": 0},
            "steps_per_print": 0}


def main_train(torch, cfg, t):
    """The training main path: ``initialize`` -> ``train_batch``, with
    TRAIN_WARMUP + TRAIN_TIMED steps; K1 and K2 launch counts from 0."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model
    from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as k1
    model = GPT2Model(cfg, generator=torch.Generator().manual_seed(SEED))
    engine = deepspeed_tpu_torch.initialize(
        model=model, config=train_config(1e-4, TRAIN_GAS))[0]
    rng = np.random.default_rng(SEED + 5)
    batches = [{"input_ids": rng.integers(
        0, cfg.vocab_size, (TRAIN_GAS, TRAIN_MICRO, t), dtype=np.int64)}
        for _ in range(TRAIN_WARMUP + TRAIN_TIMED)]
    fwd, bwd = k1.packed_flash_attention_fwd, k1.packed_flash_attention_bwd
    fwd.launches = bwd.launches = 0
    step_s, per_step, losses, norms = [], [], [], []
    for batch in batches:
        before = (fwd.launches, bwd.launches)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        loss = engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - s0)
        per_step.append([fwd.launches - before[0], bwd.launches - before[1]])
        losses.append(loss.item())
        norms.append(float(engine.get_global_grad_norm()))
    launches = {"K1": fwd.launches, "K2": bwd.launches}
    want = cfg.n_layer * TRAIN_GAS
    check(all(n == [want, want] for n in per_step),
          f"K1/K2 launched {per_step} times per train_batch, want "
          f"{want} each (n_layer x gas)")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"train losses {losses} or grad norms {norms} not finite")
    tokens = TRAIN_GAS * TRAIN_MICRO * t
    timed = step_s[TRAIN_WARMUP:]
    best = min(timed)
    flops_per_token = model.flops_per_token(t)
    phase("main train", model="GPT2_125M", micro=TRAIN_MICRO, gas=TRAIN_GAS,
          seq=t, dtype="bf16 on fp32 masters", optimizer="adamw lr 1e-4",
          steps=len(step_s), warmup=TRAIN_WARMUP,
          seconds=json.dumps([round(x, 4) for x in step_s]),
          step_s_best=round(best, 4),
          step_s_median=round(statistics.median(timed), 4),
          tokens_per_s=round(tokens / best, 1),
          flops_per_token=flops_per_token,
          tflop_per_s=round(tokens * flops_per_token / best / 1e12, 2),
          share_of_bf16_peak=round(
              tokens * flops_per_token / best / PEAK_FLOPS["bfloat16"], 4),
          losses=json.dumps([round(x, 4) for x in losses]),
          grad_norms=json.dumps([round(x, 4) for x in norms]),
          launches_per_step=json.dumps(per_step), launches=json.dumps(launches),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
    return engine, batches[-1], launches


def train_vs_plain(torch, cfg, batch):
    """Gradients of one bf16 micro batch through K1/K2 against the same
    weights on the plain attention path (autograd through
    ``reference_attention``)."""
    import dataclasses
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model
    mb = {"input_ids": torch.as_tensor(batch["input_ids"][0]).cuda()}
    out = {}
    for backend in ("auto", "xla"):
        model = GPT2Model(dataclasses.replace(cfg, attn_backend=backend),
                          generator=torch.Generator().manual_seed(SEED))
        model = model.to("cuda", torch.bfloat16)
        loss = model.apply(mb)
        loss.backward()
        out[backend] = (loss.item(), {n: p.grad.float() for n, p in
                                      model.named_parameters()})
        del model
    (loss_k, grads_k), (loss_x, grads_x) = out["auto"], out["xla"]
    rel = {n: ((grads_k[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
           for n, g in grads_x.items()}
    worst = max(rel, key=rel.get)
    loss_diff = abs(loss_k - loss_x)
    check(rel[worst] <= TRAIN_GRAD_TOL["rel_l2_per_leaf"] and
          loss_diff <= TRAIN_GRAD_TOL["loss_abs"],
          f"K1/K2 path vs plain path: worst leaf {worst} rel L2 "
          f"{rel[worst]}, loss diff {loss_diff} (tol {TRAIN_GRAD_TOL})")
    phase("train vs plain path", leaves=len(rel), loss_kernels=loss_k,
          loss_plain=loss_x, loss_abs_diff=loss_diff,
          max_rel_l2=rel[worst], worst_leaf=worst,
          median_rel_l2=statistics.median(rel.values()),
          tol=json.dumps(TRAIN_GRAD_TOL))


def train_converges(torch, cfg, t):
    """A repeated batch for CONVERGE_STEPS steps at lr 1e-3: the loss must
    fall below CONVERGE_FRACTION of the first step's."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model
    model = GPT2Model(cfg, generator=torch.Generator().manual_seed(SEED))
    engine = deepspeed_tpu_torch.initialize(
        model=model, config=train_config(1e-3, 1))[0]
    rng = np.random.default_rng(SEED + 6)
    batch = {"input_ids": rng.integers(0, 256, (1, TRAIN_MICRO, t))}
    losses = [engine.train_batch(batch=batch).item()
              for _ in range(CONVERGE_STEPS)]
    check(losses[-1] < CONVERGE_FRACTION * losses[0],
          f"loss on a repeated batch went {losses[0]} -> {losses[-1]}, "
          f"want below {CONVERGE_FRACTION} x the first")
    phase("train converges", steps=CONVERGE_STEPS, lr=1e-3,
          losses=json.dumps([round(x, 4) for x in losses]),
          threshold=f"last < {CONVERGE_FRACTION} x first")


def profile_train(torch, engine, batch):
    """Device time by kernel group over one ``train_batch``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - s0) * 1e3
    report_profile("profile train", prof, wall_ms, top=10)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, GPT2_125M
    from deepspeed_tpu_torch.ops import kernel_build
    from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as k1

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("env", torch=torch.__version__, cuda=torch.version.cuda,
          device=json.dumps(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count(), smi=json.dumps(smi),
          allow_tf32="False (matmul and cudnn)")

    t0 = time.perf_counter()
    built = kernel_build.build()
    for name in kernel_build.sources():
        kernel_build.load(name)
    phase("build", sources=",".join(kernel_build.sources()),
          compiled=json.dumps({k: round(v, 2) for k, v in built.items()}),
          seconds=round(time.perf_counter() - t0, 2))

    cfg = GPT2_125M
    b, t, h, d = 8, 1024, cfg.n_head, cfg.head_dim
    main_case = check_k1(torch, b, t, h, d, torch.bfloat16, True, None)
    check_k1(torch, b, t, h, d, torch.bfloat16, True, 256)
    check_k1(torch, b, t, h, d, torch.bfloat16, False, None)
    check_k1(torch, b, t, h, d, torch.float16, True, None)
    check_k1(torch, b, t, h, d, torch.float32, True, None)
    main_k2 = check_k2(torch, b, t, h, d, torch.bfloat16, True, None)
    check_k2(torch, b, t, h, d, torch.bfloat16, True, 256)
    check_k2(torch, b, t, h, d, torch.bfloat16, False, None)
    check_k2(torch, b, t, h, d, torch.float16, True, None)
    check_k2(torch, b, t, h, d, torch.float32, True, None)

    # ---- main path: init_inference -> engine(ids) and generate
    model = GPT2Model(cfg, generator=torch.Generator().manual_seed(SEED))
    engine = deepspeed_tpu_torch.init_inference(model, {"dtype": "bf16"})
    ids = torch.randint(0, cfg.vocab_size, (b, t),
                        generator=torch.Generator().manual_seed(SEED + 1))
    prompts = torch.randint(0, cfg.vocab_size, (4, 128),
                            generator=torch.Generator().manual_seed(SEED + 2))
    n_fwd, new = 3, 32
    k1.packed_flash_attention_fwd.launches = 0
    fwd_s, per_call = [], []
    for _ in range(n_fwd):
        before = k1.packed_flash_attention_fwd.launches
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        logits = engine(ids)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - s0)
        per_call.append(k1.packed_flash_attention_fwd.launches - before)
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    greedy = engine.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - s0
    greedy2 = engine.generate(prompts, max_new_tokens=new)
    sample_kw = dict(max_new_tokens=new, temperature=0.8, top_k=50,
                     top_p=0.95, seed=SEED)
    sampled = engine.generate(prompts, **sample_kw)
    sampled2 = engine.generate(prompts, **sample_kw)
    torch.cuda.synchronize()
    launches = k1.packed_flash_attention_fwd.launches

    check(per_call == [cfg.n_layer] * n_fwd and launches == sum(per_call),
          f"K1 launched {per_call} times per forward call and {launches} "
          f"in all, want {cfg.n_layer} per call and none in generate")
    check(tuple(logits.shape) == (b, t, cfg.padded_vocab),
          f"logits shape {tuple(logits.shape)}")
    check(torch.isfinite(logits.float()).all().item(), "logits not finite")
    # matmul FLOPs (qkv, proj, fc, proj per layer; the tied LM head) plus
    # the causal attention's two products
    flops = 2 * b * t * (cfg.n_layer * 12 * cfg.n_embd ** 2 +
                         cfg.padded_vocab * cfg.n_embd) + \
        cfg.n_layer * 4 * b * h * d * kept_pairs(t, True, None)
    best = min(fwd_s[1:])
    phase("main forward", shape=list(logits.shape),
          dtype=str(logits.dtype).replace("torch.", ""),
          k1_launches=launches, k1_launches_per_call=per_call, calls=n_fwd,
          seconds=json.dumps([round(s, 4) for s in fwd_s]),
          tokens_per_s=round(b * t / best, 1), model_tflop=flops / 1e12,
          tflop_per_s=round(flops / best / 1e12, 2),
          share_of_bf16_peak=round(flops / best / PEAK_FLOPS["bfloat16"], 4))

    # the same weights on the plain attention path
    model_x = GPT2Model(dataclasses.replace(cfg, attn_backend="xla"),
                        generator=torch.Generator().manual_seed(SEED))
    engine_x = deepspeed_tpu_torch.init_inference(model_x, {"dtype": "bf16"})
    logits_x = engine_x(ids)
    diff = (logits.float() - logits_x.float()).abs()
    mean_abs, max_abs = diff.mean().item(), diff.max().item()
    agree = (logits.argmax(-1) == logits_x.argmax(-1)).float().mean().item()
    check(mean_abs <= LOGITS_TOL["mean_abs"] and
          max_abs <= LOGITS_TOL["max_abs"],
          f"K1 logits vs plain path: mean {mean_abs} max {max_abs} "
          f"(tol {LOGITS_TOL})")
    phase("main vs plain path", mean_abs=mean_abs, max_abs=max_abs,
          argmax_agree=agree, tol=json.dumps(LOGITS_TOL))
    del logits, logits_x, diff

    shape = (prompts.shape[0], prompts.shape[1] + new)
    for name, out in (("greedy", greedy), ("sampled", sampled)):
        check(tuple(out.shape) == shape, f"{name} shape {tuple(out.shape)}")
        check(torch.equal(out[:, :128].cpu(), prompts),
              f"{name} lost its prompt")
        check(0 <= int(out.min()) and int(out.max()) < cfg.vocab_size,
              f"{name} token out of the vocab")
    check(torch.equal(greedy, greedy2), "greedy streams differ across runs")
    check(torch.equal(sampled, sampled2),
          "sampled streams differ for one seed")
    # greedy tokens against the full-forward argmax where it is clear
    full = engine_x(greedy[:, :-1])[:, 127:, :cfg.vocab_size].float()
    top2 = full.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > ARGMAX_MARGIN
    match = full.argmax(-1) == greedy[:, 128:]
    checked = int(clear.sum())
    check(checked > 0 and bool(match[clear].all()),
          f"greedy tokens disagree with the full forward at "
          f"{int((~match & clear).sum())} of {checked} clear positions")
    phase("main generate", requests=shape[0], prompt=128, new_tokens=new,
          greedy_seconds=round(greedy_s, 4),
          tokens_per_s=round(shape[0] * new / greedy_s, 1),
          greedy_repeat_equal=True, sampled_same_seed_equal=True,
          greedy_vs_forward_checked=checked,
          sampled_differs_from_greedy=not torch.equal(sampled, greedy))
    # after the launch counts were read: this call's launches are not counted
    profile_forward(torch, engine, ids)
    del engine, engine_x, model, model_x
    torch.cuda.empty_cache()

    # ---- main path of training: initialize -> train_batch
    train_engine, last_batch, train_launches = main_train(torch, cfg, t)
    # after the launch counts were read: these launches are not counted
    train_vs_plain(torch, cfg, last_batch)
    profile_train(torch, train_engine, last_batch)
    del train_engine
    torch.cuda.empty_cache()
    train_converges(torch, cfg, t)

    kernels = [{
        "name": "flash_attention_packed_fwd", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/flash_attention_packed.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention_packed.py:65",
        "launches": launches + train_launches["K1"],
        "max_abs_err": main_case["err_out"],
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}, {
        "name": "flash_attention_packed_bwd", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/flash_attention_packed_bwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention_packed.py:148",
        "launches": train_launches["K2"],
        "max_abs_err": max(main_k2[k] for k in ("err_dq", "err_dk",
                                                 "err_dv")),
        "ms": main_k2["kernel_ms"], "plain_ms": main_k2["plain_ms"],
        "bound_ms": main_k2["bound_ms"], "bound_by": main_k2["bound_by"],
        "library_ms": main_k2["library_ms"]}]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
