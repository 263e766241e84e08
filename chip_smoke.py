#!/usr/bin/env python3
"""Drive the PyTorch/H100 port once on one GPU and check it.

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, one line each: environment; build of every kernel source from the
checkout (registers and spills; the tensor-core instances must not
spill); the plain versions' model of the tensor cores' sums against the
card's ``mma.sync.m16n8k16`` on samples drawn in this run; a one-tile
fragment check of the bf16 tensor-core flash attention kernels at head
dims 64 and 128; each kernel against its plain PyTorch version on the
card, with times (K1/K2 at GPT-2-125M's packed attention shape, K3 and its
K3b/K5 backward at LLaMA-7B's ``[4, 32, 2048, 128]``, at head dim 64 and
at head dims 80 and 256; the bf16/f16 tensor-core kernels are held to the
plain versions that repeat the tensor cores' sums, and their distance to
the plain versions that sum with ``torch.matmul`` is reported beside, as
``indep_*``); the port's main paths at full width (random weights from a
seed):
GPT-2-125M through ``init_inference`` (``engine(input_ids)`` scoring calls
and ``generate`` requests) and ``initialize`` -> ``train_batch`` (bf16 on
fp32 masters, AdamW, gradient accumulation); LLaMA-7B through
``init_inference`` at full depth and through ``initialize`` ->
``train_batch`` at 4 layers of its width; each against the plain attention
path, a repeated batch whose loss must fall, and a profile of each path;
then LLaMA-2-70B's width at 2 layers with grouped-query attention and a
sliding window. The streamed regime (K4, K4b: Code Llama 7B's attention at
T 16384, a 4096 window at T 32768, non-causal, head dim 64, f32) and the
block-sparse kernels (K6, K7: BERT-large's attention at T 4096 under the
Fixed, BSLongformer and BigBird layouts, each with its live-tile and live-pair
densities and the pairs the tensor-core kernels compute after their skips,
an f32 case on the scalar kernels, and a planted one-tile fault the checks
must catch) are checked the same way; then Code Llama 7B is served at full
depth on ``[1, 16384]`` and trained at 4 layers of its width, each held
against the path on the kernels' plain versions, and BERT-large with
``SparseAttentionUtils``' Fixed sparse surgery is scored at ``[4, 4096]``
(12 of its 24 layers) and trained (15% masked positions), held against
the dense-masked plain path, with a repeated batch at 4 layers and
profiles. Last, the serve path: ``ServingEngine(init_inference(model,
{"dtype": "bf16"}), ...)`` over LLaMA-7B at SERVE_LAYERS of its 32
layers (16 slots x 2048, 48 requests; phase
``serve``: TTFT, TPOT, output tokens/s, decode-tick ms, slot utilization,
pool and peak memory, with the stream checks of ``SERVE_LLAMA``'s comment)
and GPT-2-125M (8 x 1024, 24 requests; ``serve gpt2``), each with a
profiled decode tick (``profile serve``); on the LLaMA-7B engine,
speculative decoding off and with self drafts of all and a quarter of
its layers (``serve spec``, a profiled speculative tick), the radix
prefix cache on
and off over cohorts sharing 1024-token prefixes (``serve prefix``) and a
prefill engine handing bf16 lanes through ``KVHandoff`` frames to a
decode engine (``serve disagg``); on the GPT-2 engine, a 6-layer self
draft at ``max_model_len == n_positions`` (``serve spec gpt2``); with the
checks of ``SPEC_K``'s comment. Slice 7's phases: the threefry dropout
kernel held bit for bit to its plain version, forward and backward, in
f32, bf16 and f16 at BERT-large's hidden states, GPT-2's attention
probabilities and a ragged shape, with a planted fault (one flipped key
word) it must catch (``kernel-check dropout``); BERT-large with dropout
0.1 and the default activation-checkpointing policy trained through
DeepSpeed's user loop (``bert train loop``: K6 launched again in each
recompute; the user loop against ``train_batch``, remat on against off,
the kernel path against the plain-kernel path, a repeated batch);
LLaMA-7B's width with remat off, default and full recompute, then at the
depth only remat makes fit (``llama train remat``); GPT-2-125M with
dropout, progressive layer drop and random-LTD through the user loop
(``gpt2 train loop``: the model's layer coins and kept-token indices
against a plain draw on the card). Slice 8's checkpoint phases: LLaMA-7B's
width at 2 layers trained, saved after two steps and resumed bit for bit
by a fresh engine on other weights (``ckpt train resume``: save and load
seconds, GB/s, hashing share, the host memory each takes against the
largest leaf and the tag); GPT-2-125M's keep-last-2 retention, a retried
write and the fallback past a truncated tag (``ckpt fallback``);
LLaMA-7B at CKPT_SERVE_LAYERS of its 32 layers saved by an
optimizer-less engine and
served from the tag through ``init_inference`` and a ``ServingEngine``,
bitwise the saving model's logits and streams (``ckpt serve``); a tp 2 x pp 2
Megatron-LM GPT-2-125M directory served bitwise as its single shard
(``ckpt megatron``); ``ckpt train resume`` also reports the device peak
of the load beside the engine's resident bytes. Slice 9's phases: the
dropout kernel at a data-parallel rank's element offsets, bit for bit its
plain version and the rows of the global draw (``kernel-check dropout
offset``); then, on an NCCL process group of one rank, GPT-2-125M at the
main train cell through ZeRO stages 0-3 (``zero train``) and LLaMA-7B's
width at 4 layers at stage 3 against stage 0 (``zero train llama``), each
stage's tokens/s, device peak and launches a step, stages 1-3 bit for bit
stage 0; GPT-2-125M saved at stage 3 and resumed bit for bit by a fresh
stage-3 and a fresh stage-0 engine, with each load's device peak beside
the engine's resident bytes (``ckpt zero resume``). Slice 10's phases,
on two ranks of a gloo group over CUDA tensors spawned on the one card
(``tp_phases``): LLaMA-7B at SERVE_LAYERS scoring ``[4, 2048]`` at tp 2 (K3
on 16 heads a rank) against the tp-1 engine's logits (``tp forward``),
served at tp 2 to 8 requests of the serve traffic, each stream equal to
tp 1's or parting at a near-tie (``tp serve``), GPT-2-125M at the main
train cell at tp 2 (``tp train``: K1/K2 on 6 heads), and LLaMA-7B's width
at 4 layers trained at tp 2, its loss and gathered gradients held to tp
1's and a repeated batch converging (``tp train llama``); each with its
tokens/s, peak GiB a rank and the ``model`` axis's collectives. Slice
11's, on the same ranks: BERT-large with the Fixed surgery scored at tp 2
(``tp bert forward``) and trained through the user loop with dropout
(``tp bert train loop``), GPT-2-125M's dropout, layer-drop and random-LTD
loop (``tp gpt2 train loop``: the probabilities dropped on the rank's
heads under the dropout kernel's head map), lanes handed across engines
(``tp serve handoff``), a ``mode: "model"`` draft (``tp serve spec
model``), deadlines under skewed clocks (``tp serve deadlines``), a
Megatron directory (``tp ckpt megatron``) and a synthetic one-kv-head
variant of LLaMA-2-70B's width (``tp llama kv replicated``), each against
tp 1; before them, the dropout kernel and K6/K7 at a rank's heads
(``kernel-check dropout heads``, ``K6 heads``, ``K7 heads``). Slice 13's
(see the comment above ``GPTJ_LAYERS``): K3 at GPT-J-6B's head dim 256
(``kernel-check K3 d256``, on the ``wgmma`` kernel, with a masked
head dim 192 beside it, ``kernel-check K3 d192``; ``kernel-check wgmma
sums`` holds the plain versions' model of the tensor cores' sums to
``wgmma`` as ``kernel-check mma sums`` does to ``mma.sync``), GPT-J-6B
at its published width scored and served (``gptj forward``, ``gptj
serve``), and OPT, BLOOM, GPT-Neo and GPT-NeoX at theirs (``family
...``). Each profile names the flash and block-sparse attention kernel
instances that ran; on these bf16 paths they must be the tensor-core
ones (``mma_*``, ``wgmma_*``). Every check raises
on failure, so the script exits
non-zero without printing a result. The last lines are one JSON
object describing every kernel, the card's name and power limit from
``nvidia-smi``, and ``{"ok": true, "device": {...}}``. Without a GPU it
exits non-zero and prints no result. It imports neither JAX nor the JAX
package.
"""

import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time

SEED = 1234
PEAK_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,   # dense tensor cores
              "float32": 67e12}                       # CUDA cores
# Each kernel against its plain version, elementwise: |kernel - plain| <=
# atol + rtol |plain| for out and for dq, dk, dv, by dtype; lse (f32 in
# both) to LSE_TOL. Both compute in f32 with the same tiles and rounding
# points, so their f32 values differ only by summation order (~1e-6), and
# rounded to bf16 or f16 they differ by at most one rounding step: 2^-7 |x|
# in bf16, 2^-10 |x| in f16. rtol allows two steps, atol values near 0. A
# kernel that leaves one 64-key tile out misses a value by about its own
# size, far outside this (phase "kernel-check K3 planted faults").
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-4, 2 ** -6),
       "float16": (1e-4, 2 ** -9)}
LSE_TOL = 1e-4
# K1 path vs plain-attention path, GPT-2-125M bf16 logits: both round
# activations to bf16 at different points (the kernel rounds P before P.V,
# the plain path rounds the softmax probabilities), which drifts through 12
# layers; a wrong kernel moves the mean by tenths
LOGITS_TOL = {"mean_abs": 1e-2, "max_abs": 0.25}
# a greedy token must equal the full-forward argmax wherever the top-2 gap
# of the full-forward logits exceeds this
ARGMAX_MARGIN = 0.1
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
# K3 / K3b-K5 checks: LLaMA-7B's attention shape, and two head dims off the
# 64/128 ceilings at a small shape
K3_SHAPE, K3_SMALL = (4, 32, 2048, 128), (4, 8, 512)
# LLaMA kernel path vs plain path, bf16 logits. Both round to bf16 at
# different points, and at LLaMA-7B's width this drifts through 32 layers
# to a mean abs difference of 0.077 (max 0.77, on an H100; PERF.md),
# larger than GPT-2's. So each bf16 path is also held against the same
# weights in f32 on the plain path: the kernel path's mean abs error against
# that reference may exceed the plain path's by at most a quarter, and the
# two bf16 paths may differ by at most 0.15 mean and 2.0 max; a wrong kernel
# or head order moves the error by the logits' own scale (~1)
LLAMA_LOGITS_TOL = {"vs_f32_ratio": 1.25, "mean_abs": 0.15, "max_abs": 2.0}
LLAMA_ARGMAX_MARGIN = 0.25
# LLaMA gradients, kernel path vs plain path, one bf16 micro batch of 4
# layers at LLaMA-7B's width: as GPT-2's, doubled for T 2048
LLAMA_GRAD_TOL = {"rel_l2_per_leaf": 1e-1, "loss_abs": 2e-2}
LLAMA_TRAIN_LAYERS, LLAMA_MICRO, LLAMA_GAS, LLAMA_T = 4, 4, 2, 2048
# 2e-4 moves LLaMA-7B's 4096-wide layers about as far per step as 1e-3
# moves GPT-2-125M's 768-wide ones
LLAMA_CONVERGE_LR = 2e-4
# K4 / K4b checks (the streamed regime, T * D * itemsize > 1 MiB): Code
# Llama 7B's attention at T 16384, a 4096 window at T 32768, non-causal,
# f32; timed over (reps, inner, warmup) calls
K4_CASES = [((1, 32, 16384, 128), "bfloat16", True, None),
            ((1, 8, 32768, 128), "bfloat16", True, 4096),
            ((1, 8, 8192, 128), "bfloat16", False, None),
            ((1, 8, 8192, 64), "float32", True, None),
            ((1, 8, 16384, 64), "bfloat16", True, None)]
K4_TIMING = (5, 2, 1)
# Code Llama 7B: served at full depth on [1, 16384]; trained at 4 layers of
# its width (micro 1, T 16384, gas 2). Its checks hold the kernel path to
# the path on the kernels' tiled plain versions with LLaMA's limits (bf16
# drift through 32 layers; the same arithmetic, so the drift is smaller)
CODELLAMA_T, CODELLAMA_TRAIN_LAYERS = 16384, 4
# K6 / K7 checks: BERT-large's attention at T 4096 with fine block 16
K6_SHAPE = (4, 16, 4096, 64)
K6_CASES = [("fixed", "bfloat16"), ("bslongformer", "bfloat16"),
            ("bigbird", "bfloat16"), ("fixed", "float32")]
# BERT-large with the Fixed sparse surgery: scored at [4, 4096] bf16,
# trained at micro 4, T 4096, gas 2 with 15% masked positions; the gradient
# and convergence checks at 4 layers of its width
BERT_T, BERT_MICRO, BERT_GAS, BERT_SMALL_LAYERS = 4096, 4, 2, 4
# scored (bert forward, tp bert forward) at 12 of its 24 layers (cut from
# full depth when the decoder families' phases joined), to keep the
# script inside its time limit
BERT_SERVE_LAYERS = 12
BERT_MASK_RATE = 0.15
# kernel path vs the dense-masked plain path, bf16 logits through 24
# post-LN layers, with the f32 reference as for LLaMA; gradients of one bf16
# micro batch at 4 layers as LLaMA's
BERT_LOGITS_TOL = LLAMA_LOGITS_TOL
BERT_GRAD_TOL = LLAMA_GRAD_TOL
# a repeated batch (256 distinct ids) for 10 steps: 1e-3 moves BERT-large's
# 1024-wide layers about as GPT-2-125M's
BERT_CONVERGE_LR = 1e-3
# Continuous-batching serving (ServingEngine over init_inference): LLaMA-7B
# at SERVE_LAYERS of its 32 layers (cut from full depth to 16, then to 8
# when the quantization phases joined, then to 4 when slice 13's did, to
# keep the script inside its time limit, PERF.md), 16 slots x 2048
# columns (a 2.1 GB bf16 KV pool at 4 layers), two prefills a tick; 48
# requests submitted at
# tick 0, prompts lognormal (median 384, 128-1024 tokens), new tokens lognormal (median 128,
# 64-256), every fourth one sampled (temperature 0.8, top-p 0.95, its own
# seed), and one whose prompt and new tokens fill the 2048 columns.
# GPT-2-125M: 8 slots x 1024, 24 requests at half the lengths. Checks:
# every request finishes; greedy tokens equal the plain full forward's
# argmax where its top-2 gap exceeds the generate margin; 4 requests
# replayed in another admission order come back bit for bit; 8 prompts
# served with chunked prefill (chunk_tokens 256) give the monolithic
# greedy streams, parting only at a token whose top-2 gap is within that
# margin (bf16 chunks run other GEMM shapes), and pass the same argmax
# check; one decode shape ran; the pool lives on the card
SERVE_LLAMA = dict(cfg={"num_slots": 16, "max_model_len": 2048,
                        "max_prefills_per_tick": 2},
                   requests=48, prompt=(384, 128, 1024), new=(128, 64, 256))
SERVE_LAYERS = 4
SERVE_GPT2 = dict(cfg={"num_slots": 8, "max_model_len": 1024,
                       "max_prefills_per_tick": 2},
                  requests=24, prompt=(192, 64, 512), new=(64, 32, 128))
SERVE_SIGMA, SERVE_CHUNK, SERVE_CHUNKED_NEW = 0.5, 256, 64
# Speculation, the prefix cache and disaggregation on the same engines
# (phases serve spec, serve spec gpt2, serve prefix, serve disagg). serve
# spec: SERVE_LLAMA's traffic drawn for 8 requests at half its new tokens
# (16 slots x 2048, the last request filling all 2048 columns; cut from
# 16 at the whole lengths, PERF.md), served three times on one
# engine: speculation off, then k 4 with a self draft of all its layers
# (the draft is the target, so only near-ties between the decode step's
# GEMM shapes and the verify's may reject: every rejected proposal inside
# a stream must sit within SPEC_REJECT_TIE times the margin of the
# target's token under the plain forward, since the draft's own lane
# drifts from the plain forward as the verify's does; acceptance is
# reported), then of a quarter of them (what a user runs). Every stream must equal
# the off stream or part from it only at a near-tie (``tie_gap``: the two
# tokens' logit gap when greedy; when sampled, their Gumbel-perturbed
# score gap times the temperature, or the logit change that moves either
# across the top-k / top-p edge) under the plain forward, within the
# margin. serve spec gpt2: 8 requests at 8 x 1024 == n_positions, one
# filling all 1024 columns, a self draft of 6 layers. serve prefix: 4
# cohorts of 4 requests (cut from 8, PERF.md), each cohort sharing a
# PREFIX_LEN-token prefix with its own lognormal suffix, PREFIX_NEW new
# tokens, a quarter sampled; the 4 leaders first, then the 12 followers;
# with the cache and without.
# serve disagg: a prefill engine (4 x 2048) handing each lane through the
# wire codec to a decode engine (16 x 2048) over serve spec's traffic.
SPEC_K, SPEC_REJECT_TIE = 4, 2
SERVE_SPEC = dict(SERVE_LLAMA, requests=8, new=(64, 32, 128))
SERVE_SPEC_GPT2 = dict(SERVE_GPT2, requests=8)
PREFIX_COHORTS, PREFIX_PER_COHORT, PREFIX_LEN = 4, 4, 1024
PREFIX_SUFFIX, PREFIX_NEW = (96, 32, 256), 64
DISAGG_PREFILL_SLOTS = 4
# Slice 7: dropout on the JAX package's keys (the threefry dropout
# kernel), activation checkpointing, progressive layer drop, random-LTD.
# The dropout kernel is held to its plain version bit for bit, forward and
# backward, in f32, bf16 and f16, at BERT-large's hidden states, GPT-2's
# attention probabilities and a ragged shape (a scalar tail), the keep
# share within 5 sigma of the binomial
DROPOUT_RATE = 0.1                    # GPT-2's and BERT-large's published
DROPOUT_KEY = (SEED, 0x9E3779B9)
DROPOUT_SHAPES = {"bert": (4, 4096, 1024), "gpt2 probs": (8, 12, 1024, 1024),
                  "ragged": (3, 1000, 77)}
# its bound: DROPOUT_INT_OPS integer operations an element (threefry: 2
# counter and key adds, 20 rounds of add, rotate and xor, 5 key injections
# of 2 adds, the xor of the two words; 2 for the uniform's mantissa)
# against the H100 SXM's INT32 rate: 64 INT32 lanes an SM (half the 128
# FP32 lanes behind the 67 TFLOP/s f32 peak, which counts an FMA as two) x
# 132 SMs x 1.98 GHz
DROPOUT_INT_OPS = 75
PEAK_INT32_OPS = 132 * 64 * 1.98e9
# GPT-2 loop: progressive layer drop at theta 0.5 with gamma 0.1 (DeepSpeed's
# is 0.001, under which no layer drops within a few steps) and random-LTD on
# DeepSpeed's GPT example schedule
GPT2_PLD = {"enabled": True, "theta": 0.5, "gamma": 0.1}
GPT2_LTD = {"enabled": True, "data_routing": {"enabled": True, "random_ltd": {
    "enabled": True, "random_ltd_schedule": {
        "min_value": 128, "max_value": 1024, "schedule_type": "fixed_linear",
        "schedule_config": {"seq_per_step": 16, "require_steps": 200000}}}}}
# LLaMA remat: bytes a parameter at the micro step's peak (f32 masters 4,
# Adam's two moments 8, the f32 accumulation 4, the bf16 copies 2, their
# bf16 gradients 2); the deep run takes the most layers whose predicted
# peak (that, plus the default policy's measured bytes a layer) fills at
# most REMAT_FILL of the card
REMAT_BYTES_PER_PARAM, REMAT_FILL, REMAT_TIMED = 20, 0.9, 2
# Slice 8: checkpoints. Tags go under CKPT_DIR (build/ is ignored by git)
# and each phase removes its own. ckpt train resume: the llama train cell
# cut to CKPT_RESUME_LAYERS layers of LLaMA-7B's width (micro 4, T 2048,
# gas 2, bf16 on f32 masters, AdamW under WarmupLR) takes CKPT_STEPS
# steps, saving after CKPT_SAVE_AT; a fresh engine on other weights loads
# the tag and takes the rest, bitwise. ckpt serve: LLaMA-7B at
# CKPT_SERVE_LAYERS layers (of its 32: 5.6 GB of f32 masters, each of
# qkv_w, gate_w, up_w and down_w above the codec's 1 GiB chunk and so
# chunked; 6 is the fewest that keeps them so) saved by an
# optimizer-less engine and served through init_inference's checkpoint
# key, then CKPT_SERVE_REQUESTS requests through a ServingEngine of
# SERVE_LLAMA's pool. ckpt megatron: GPT-2-125M (Megatron's padded vocab
# 50304, a multiple of 128 x tp) written tp 2 x pp 2 at qkv version 0 and
# as one shard at 2.0 (the JAX package reads 0, 1.0 and 2.0 and refuses
# every other version, so the port does too).
CKPT_DIR = "build/ckpt"
CKPT_STEPS, CKPT_SAVE_AT = 4, 2
# Both depths were cut (from 4 and 16 layers, then ckpt serve from 8 to
# 6) when the tensor-parallel phases joined the script, and ckpt train
# resume from 2 to 1 when the quantization phases did, to keep it inside
# its time limit: each
# phase's save and load take ~4 s a GB on the card's machine (PERF.md)
CKPT_RESUME_LAYERS, CKPT_SERVE_LAYERS, CKPT_SERVE_REQUESTS = 1, 6, 8
# ckpt fallback: the main train cell at 4 of GPT-2-125M's 12 layers (its
# five saves of the whole cell's state took ~25 s at 12)
CKPT_FALLBACK_LAYERS = 4
CKPT_MEGATRON_VOCAB, CKPT_MEGATRON_TP, CKPT_MEGATRON_PP = 50304, 2, 2


# numbers one phase hands to a later one (phases' own measurements)
MEASURED = {}
START = time.perf_counter()


def phase(name, **fields):
    """One phase's line; ``t_s``: seconds since this process started."""
    fields["t_s"] = round(time.perf_counter() - START, 1)
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def median_ms(torch, fn, reps=10, inner=5, warmup=3):
    """Milliseconds a call: the median over ``reps`` samples of the
    CUDA-event time of ``inner`` back-to-back calls, divided by ``inner``,
    after warm-up. Calls queued back to back overlap each wrapper's Python
    with the previous call's device work, so a kernel's time is not its
    wrapper's (one call between two events also times the host)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def timed_call(torch, fn):
    """``(fn(), ms)``: one call between two CUDA events. The plain versions
    are timed so: on the tensor-core path they repeat the tensor cores'
    sums elementwise and take seconds a call at the largest shapes."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def errors(got, want):
    """(max abs error, max of |got - want| / (atol + rtol |want|)) of a
    kernel's output against its plain version's, TOL by want's dtype; the
    check holds the ratio to 1."""
    atol, rtol = TOL[str(want.dtype).replace("torch.", "")]
    diff = (got.float() - want.float()).abs()
    return (diff.max().item(),
            (diff / (atol + rtol * want.float().abs())).max().item())


def independent(got, want, lse=None, want_lse=None):
    """``indep_*`` fields of a kernel-check phase: the kernel's outputs
    (and lse) against the plain version that sums with ``torch.matmul``
    (``tensor_core=False``), which knows nothing of the tensor cores' sums
    that the bf16/f16 checks hold the kernels to. Reported, not checked:
    where the sums differ in their last bits, P or dS now and then round to
    the other neighbour, and in a row with a small sum that moves an output
    by a few rounding steps (PERF.md)."""
    found = [errors(g, w) for g, w in zip(got, want)]
    res = {"indep_errs": [e for e, _ in found],
           "indep_ratio": max(r for _, r in found)}
    if lse is not None:
        res["indep_err_lse"] = (lse - want_lse).abs().max().item()
    return res


def mma_samples(torch, dtype, n, seed, rows=16):
    """``n`` tiles for :func:`check_mma_sums`, a [n, rows, 16] and b
    [n, 8, 16] of ``dtype`` and c [n, rows, 8] float32, on the CPU, in five
    families of n / 5 tiles: normal a, b and c; exponents spread over
    2^-4..2^4 (c over 2^-10..2^10); the same with c = 0; near-cancelling
    products (a[:, 8:] = -a[:, :8] (1 + 2^-u), u in 1..12, b = 1) under a c
    of 2^-20..1; and one 16-column step of an attention dot product at head
    dim 128 (q and k normal, c the float32 sum of the columns before the
    step). ``rows`` is 16 for ``mma.sync``'s tiles, 64 for ``wgmma``'s."""
    import numpy as np
    rng = np.random.default_rng(seed)
    m = n // 5
    normal = rng.standard_normal

    def spread(shape, e):
        return normal(shape) * 2.0 ** rng.uniform(-e, e, shape)

    a = [normal((m, rows, 16)), spread((m, rows, 16), 4),
         spread((m, rows, 16), 4)]
    b = [normal((m, 8, 16)), spread((m, 8, 16), 4), spread((m, 8, 16), 4)]
    c = [normal((m, rows, 8)), spread((m, rows, 8), 10),
         np.zeros((m, rows, 8))]
    half = normal((m, rows, 8))
    a.append(np.concatenate(
        [half, -half * (1 + 2.0 ** -rng.integers(1, 13, (m, rows, 8)))], -1))
    b.append(np.ones((m, 8, 16)))
    c.append(normal((m, rows, 8)) * 2.0 ** -rng.uniform(0, 20, (m, rows, 8)))
    rest = n - 4 * m
    q = torch.from_numpy(normal((rest, rows, 128))).to(dtype).float()
    k = torch.from_numpy(normal((rest, 8, 128))).to(dtype).float()
    for i, step in enumerate(rng.integers(0, 8, rest)):
        lo, hi = 16 * step, 16 * step + 16
        a.append(q[i:i + 1, :, lo:hi])
        b.append(k[i:i + 1, :, lo:hi])
        c.append(torch.matmul(q[i:i + 1, :, :lo],
                              k[i:i + 1, :, :lo].transpose(-1, -2)))

    def cat(xs, to):
        return torch.cat([torch.as_tensor(x).float() for x in xs]).to(to)

    return cat(a, dtype), cat(b, dtype), cat(c, torch.float32)


def check_mma_sums(torch, n=5000, wgmma=False):
    """The plain versions' model of the tensor cores' sums
    (``flash_attention.mma_step``) against the card's own
    ``mma.sync.m16n8k16`` (``mma_on_card``, the instruction of the
    ``mma.sync`` kernels' products) on :func:`mma_samples` drawn in this
    run from seed SEED + 11, or, with ``wgmma``, against ``wgmma.mma_async
    m64n8k16`` (``wgmma_on_card``, the D-256 forward's instruction, through
    its panel layout and descriptors) on 64-row samples from seed SEED +
    12: samples the model was not fitted on. Every output must agree bit
    for bit. Phase "kernel-check mma sums" or "kernel-check wgmma sums"."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    rows, seed = (64, SEED + 12) if wgmma else (16, SEED + 11)
    on_card = fa.wgmma_on_card if wgmma else fa.mma_on_card
    res = {"tiles": n, "outputs": n * rows * 8}
    for name, dtype in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        a, b, c = (x.cuda() for x in mma_samples(torch, dtype, n, seed, rows))
        card = on_card(a, b, c)
        model = fa.mma_step(c, a, b)
        f32_sum = c + torch.matmul(a.float(), b.float().transpose(-1, -2))
        res[f"{name}_mismatches"] = int((model != card).sum().item())
        res[f"{name}_f32_sum_mismatches"] = int((f32_sum != card).sum()
                                                .item())
        res[f"{name}_max_abs_diff"] = (model - card).abs().max().item()
    kind = "wgmma" if wgmma else "mma"
    phase(f"kernel-check {kind} sums", **res)
    check(res["bf16_mismatches"] == 0 and res["f16_mismatches"] == 0,
          f"the model of the tensor cores' sums misses the card's {kind}: "
          f"{res}")


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
    tc = k1.fa.tensor_core_path(dtype, d)

    def plain(tensor_core):
        return k1.packed_flash_attention_plain(q, k, v, h, causal, None,
                                               window, tensor_core)

    out, lse = k1.packed_flash_attention_fwd(q, k, v, h, causal=causal,
                                             window=window)
    (ref_out, ref_lse), plain_ms = timed_call(torch, lambda: plain(tc))
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    err_out, ratio_out = errors(out, ref_out)
    err_lse = (lse - ref_lse).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), "K1 output not finite")
    check(ratio_out <= 1 and err_lse <= LSE_TOL,
          f"K1 {dname} causal={causal} window={window}: out err {err_out} "
          f"(ratio {ratio_out} to TOL {TOL[dname]}), lse err {err_lse} "
          f"(tol {LSE_TOL})")
    indep_out, indep_lse = plain(False) if tc else (ref_out, ref_lse)
    indep = independent([out], [indep_out], lse, indep_lse)
    del indep_out, indep_lse

    kernel_ms = median_ms(torch, lambda: k1.packed_flash_attention_fwd(
        q, k, v, h, causal=causal, window=window))
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
           "shape": [b, t, h, d], "tensor_cores": tc, "err_out": err_out,
           "err_lse": err_lse, "ratio_out": ratio_out, "tol": TOL[dname],
           "tol_lse": LSE_TOL, **indep, "kernel_ms": kernel_ms,
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

    tc = k1.fa.tensor_core_path(dtype, d, backward=True)

    def plain(tensor_core):
        return k1.packed_flash_attention_bwd_plain(q, k, v, dout, lse, delta,
                                                   h, causal, None, window,
                                                   tensor_core)

    got = kernel()
    want, plain_ms = timed_call(torch, lambda: plain(tc))
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    errs, ratios = zip(*(errors(g, w)
                         for g, w in zip(got.split(h * d, dim=-1), want)))
    check(torch.isfinite(got.float()).all().item(), "K2 output not finite")
    check(max(ratios) <= 1,
          f"K2 {dname} causal={causal} window={window}: dq/dk/dv errors "
          f"{errs}, ratios {ratios} to TOL {TOL[dname]}")
    indep = independent(got.split(h * d, dim=-1),
                        plain(False) if tc else want)

    kernel_ms = median_ms(torch, kernel)
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
           "shape": [b, t, h, d], "tensor_cores": tc, "err_dq": errs[0],
           "err_dk": errs[1], "err_dv": errs[2], "ratio": max(ratios),
           "tol": TOL[dname], **indep, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "SDPA fwd+bwd minus fwd",
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    phase("kernel-check K2", **res)
    return res


def sdpa_mask(torch, t, causal, window):
    """SDPA's arguments for the kernels' mask: ``is_causal`` or, with a
    window, an explicit boolean keep-mask (0 <= q - k < window), built
    without a [T, T] index matrix."""
    if window is None:
        return None, causal
    keep = torch.ones((t, t), dtype=torch.bool, device="cuda")
    return keep.tril_().triu_(1 - window), False


def k3_inputs(torch, shape, dtype, seed):
    """q, k, v [B, H, T, D] as views of [B, T, H, D] buffers, the layout
    the LLaMA block hands the kernel."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, h, t, d = shape
    return [torch.randn((b, t, h, d), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype).transpose(1, 2)
            for _ in range(3)]


def check_k3(torch, shape, dtype, causal, window, scale=None, name="K3",
             timing=(10, 5, 3)):
    """K3 (or, past the resident regime, K4: ``name``) against its plain
    version on the card; ``timing`` is median_ms's (reps, inner, warmup)
    for the kernel and the library call."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    import torch.nn.functional as F
    b, h, t, d = shape
    q, k, v = k3_inputs(torch, shape, dtype, SEED + 7)
    check(fa.streamed(q) == (name == "K4"),
          f"{name} check at {shape} {dtype}: streamed regime "
          f"{fa.streamed(q)}")
    tc = fa.tensor_core_path(dtype, d)

    def plain(tensor_core):
        return fa.flash_attention_plain(q, k, v, causal, scale, window,
                                        tensor_core)

    out, lse = fa.flash_attention_fwd(q, k, v, causal, scale, window)
    (ref_out, ref_lse), plain_ms = timed_call(torch, lambda: plain(tc))
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    err_out, ratio_out = errors(out, ref_out)
    err_lse = (lse - ref_lse).abs().max().item()
    check(torch.isfinite(out.float()).all().item(),
          f"{name} output not finite")
    check(ratio_out <= 1 and err_lse <= LSE_TOL,
          f"{name} {dname} {shape} causal={causal} window={window} "
          f"scale={scale}: out err {err_out} (ratio {ratio_out} to TOL "
          f"{TOL[dname]}), lse err {err_lse} (tol {LSE_TOL})")
    indep_out, indep_lse = plain(False) if tc else (ref_out, ref_lse)
    indep = independent([out], [indep_out], lse, indep_lse)
    del ref_out, ref_lse, indep_out, indep_lse
    reps, inner, warmup = timing
    kernel_ms = median_ms(torch, lambda: fa.flash_attention_fwd(
        q, k, v, causal, scale, window), reps, inner, warmup)
    mask, is_causal = sdpa_mask(torch, t, causal, window)
    library_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=is_causal, scale=scale), reps,
        inner, warmup)
    del mask
    itemsize = torch.empty((), dtype=dtype).element_size()
    # q, k, v read and o written once; lse (f32) written
    n_bytes = 4 * b * h * t * d * itemsize + 4 * b * h * t
    flops = 4 * b * h * d * kept_pairs(t, causal, window)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dname] * 1e3
    res = {"dtype": dname, "causal": causal, "window": window,
           "scale": scale, "shape": list(shape), "tensor_cores": tc,
           "err_out": err_out, "err_lse": err_lse, "ratio_out": ratio_out,
           "tol": TOL[dname], "tol_lse": LSE_TOL, **indep,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    phase(f"kernel-check {name}", **res)
    return res


def check_k3_bwd(torch, shape, dtype, causal, window, scale=None,
                 name="K3-bwd", timing=(10, 5, 3)):
    """The K3b/K5 backward (or K4b past the resident regime: ``name``)
    against its plain version on the card: the forward's output and lse, a
    random output gradient."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    import torch.nn.functional as F
    b, h, t, d = shape
    q, k, v = k3_inputs(torch, shape, dtype, SEED + 8)
    out, lse = fa.flash_attention_fwd(q, k, v, causal, scale, window)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    delta = fa.attention_delta(out, dout)

    def kernel():
        return fa.flash_attention_bwd(q, k, v, out, lse, dout, causal, scale,
                                      window)

    tc = fa.tensor_core_path(dtype, d, backward=True)

    def plain(tensor_core):
        return fa.flash_attention_bwd_plain(q, k, v, dout, lse, delta,
                                            causal, scale, window,
                                            tensor_core)

    got = kernel()
    want, plain_ms = timed_call(torch, lambda: plain(tc))
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    errs, ratios = zip(*(errors(g, w) for g, w in zip(got, want)))
    check(all(torch.isfinite(g.float()).all().item() for g in got),
          f"{name} output not finite")
    check(max(ratios) <= 1,
          f"{name} {dname} {shape} causal={causal} window={window} "
          f"scale={scale}: dq/dk/dv errors {errs}, ratios {ratios} to TOL "
          f"{TOL[dname]}")
    indep = independent(got, plain(False) if tc else want)
    del want
    reps, inner, warmup = timing
    kernel_ms = median_ms(torch, kernel, reps, inner, warmup)
    q4, k4, v4 = (x.detach().requires_grad_() for x in (q, k, v))
    mask, is_causal = sdpa_mask(torch, t, causal, window)

    def sdpa():
        return F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, is_causal=is_causal, scale=scale)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (q4, k4, v4), dout)

    with torch.no_grad():
        fwd_ms = median_ms(torch, sdpa, reps, inner, warmup)
    library_ms = median_ms(torch, sdpa_fwd_bwd, reps, inner, warmup) - fwd_ms
    del mask
    itemsize = torch.empty((), dtype=dtype).element_size()
    # q, k, v, dO read and dq, dk, dv written once; lse and delta (f32) read
    n_bytes = 7 * b * h * t * d * itemsize + 2 * 4 * b * h * t
    # 10 D FLOP per kept (q, k) pair: five products of 2 D each
    flops = 10 * b * h * d * kept_pairs(t, causal, window)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dname] * 1e3
    res = {"dtype": dname, "causal": causal, "window": window,
           "scale": scale, "shape": list(shape), "tensor_cores": tc,
           "err_dq": errs[0], "err_dk": errs[1], "err_dv": errs[2],
           "ratio": max(ratios), "tol": TOL[dname], **indep,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library": "SDPA fwd+bwd minus fwd",
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    phase(f"kernel-check {name}", **res)
    return res


def check_fragments(torch, d):
    """One 64 x 64 tile (B 1, H 1, T 64) of the bf16 tensor-core kernels at
    head dim d, causal, forward and backward against their plain versions:
    identity-like inputs (q = k = 4 e_(t mod d), so S is 16 on the diagonal
    and 0 elsewhere; v and dO small integers, exact in bf16), where a wrong
    accumulator-to-A fragment mapping or ldmatrix(.trans) address moves
    whole rows or columns; then random inputs. Phase "kernel-check
    fragments"."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    t, bf16 = 64, torch.bfloat16
    pos = torch.arange(t, device="cuda")
    eye = torch.zeros((1, 1, t, d), device="cuda")
    eye[0, 0, pos, pos % d] = 4.0
    ints = ((pos[:, None] * 7 + torch.arange(d, device="cuda")) % 9 - 4)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    cases = {"identity": (eye, eye, ints[None, None].float(),
                          ints.flip(0)[None, None].float()),
             "random": tuple(torch.randn((1, 1, t, d), generator=gen,
                                         device="cuda") for _ in range(4))}
    tc = fa.tensor_core_path(bf16, d) and \
        fa.tensor_core_path(bf16, d, backward=True)
    check(tc, f"bf16 at head dim {d} does not take the tensor cores")
    res = {"d": d}
    for name, xs in cases.items():
        q, k, v, dout = (x.to(bf16) for x in xs)
        out, lse = fa.flash_attention_fwd(q, k, v)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, dout)
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, tensor_core=tc)
        ref = fa.flash_attention_bwd_plain(q, k, v, dout, lse,
                                           fa.attention_delta(out, dout),
                                           tensor_core=tc)
        torch.cuda.synchronize()
        found = [errors(out, ref_out)] + [errors(g, w)
                                         for g, w in zip(grads, ref)]
        err_lse = (lse - ref_lse).abs().max().item()
        res[f"{name}_err"] = [e for e, _ in found] + [err_lse]
        res[f"{name}_ratio"] = max(r for _, r in found)
        check(res[f"{name}_ratio"] <= 1 and err_lse <= LSE_TOL,
              f"tensor-core fragments at d {d}, {name} inputs: out/dq/dk/dv "
              f"errors {found}, lse {err_lse}")
    phase("kernel-check fragments", **res)


def planted_faults(torch, shape, dtype, causal, window):
    """What the K3 checks report for planted faults, each a kernel that
    leaves one 64-key tile out: out and dq of the last 64 query rows
    without keys [T-128, T-64); dk and dv of the last 64 keys without the
    last 64 query rows' terms. Each is computed from the plain versions'
    results and held against them as a kernel's output is; every ratio must
    exceed 1, so that the checks would catch the fault. The plain versions
    sum as the K3 check's do."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    b, h, t, d = shape
    scale = d ** -0.5
    tc = fa.tensor_core_path(dtype, d)
    tc_bwd = fa.tensor_core_path(dtype, d, backward=True)
    q, k, v = k3_inputs(torch, shape, dtype, SEED + 8)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    out, lse = fa.flash_attention_plain(q, k, v, causal, scale, window, tc)
    delta = fa.attention_delta(out, dout)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, dout, lse, delta,
                                              causal, scale, window, tc_bwd)
    last, drop = slice(t - 64, t), slice(t - 128, t - 64)
    qf, kf, vf, dof = (x[:, :, last].float() for x in (q, k, v, dout))
    kd, vd = k[:, :, drop].float(), v[:, :, drop].float()
    pos = torch.arange(t, device="cuda")
    diff = pos[last, None] - pos[None, :]
    keep = diff >= 0 if causal else torch.ones_like(diff, dtype=torch.bool)
    if window is not None:
        keep &= diff < window
    s = torch.matmul(qf, k.float().transpose(-1, -2)) * scale
    p = torch.exp(torch.where(keep, s, fa.NEG_INF) - lse[:, :, last, None])
    p_kept = p.clone()
    p_kept[..., drop] = 0
    out_fault = torch.matmul(p_kept, v.float()) / p_kept.sum(-1, keepdim=True)
    ds = p[..., drop] * (torch.matmul(dof, vd.transpose(-1, -2)) -
                         delta[:, :, last, None]) * scale
    dq_fault = dq[:, :, last].float() - torch.matmul(ds, kd)
    p_ll = p[..., last]
    ds_ll = p_ll * (torch.matmul(dof, vf.transpose(-1, -2)) -
                    delta[:, :, last, None]) * scale
    dv_fault = dv[:, :, last].float() - torch.matmul(p_ll.transpose(-1, -2),
                                                     dof)
    dk_fault = dk[:, :, last].float() - torch.matmul(ds_ll.transpose(-1, -2),
                                                     qf)
    faults = {"out": (out_fault, out), "dq": (dq_fault, dq),
              "dk": (dk_fault, dk), "dv": (dv_fault, dv)}
    found = {}
    for name, (fault, ref) in faults.items():
        err, ratio = errors(fault.to(dtype), ref[:, :, last])
        found[f"err_{name}"], found[f"ratio_{name}"] = err, ratio
        check(ratio > 1, f"a kernel that leaves one k tile out of {name} "
              f"would pass the K3 check: ratio {ratio}")
    phase("kernel-check K3 planted faults", shape=list(shape),
          dtype=str(dtype).replace("torch.", ""), causal=causal,
          window=window, **found)


def profile_forward(torch, engine, ids, top=8, name="profile forward"):
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
    report_profile(name, prof, wall_ms, top)


# an attention kernel instance in a demangled name: mma_fwd_kernel<
# __nv_bfloat16, 128, true>, wgmma_fwd_kernel<__nv_bfloat16, 256, true>,
# dq_kernel<float, 64, false>, mma_sparse_dkdv_kernel<__half, 64, true>,
# sparse_fwd_kernel<...>, ...
ATTENTION_INSTANCE = re.compile(
    r"\b((?:wg)?(?:mma_)?(?:sparse_)?(?:fwd|dkdv|dq)_kernel)<"
    r"(__nv_bfloat16|__half|float), *(\d+), *(true|false)>")
# the tensor-core instances' prefixes: mma.sync, and wgmma at D 256
TENSOR_CORE_KERNELS = ("mma_", "wgmma_")
SHORT_TYPE = {"__nv_bfloat16": "bf16", "__half": "f16", "float": "f32"}


def attention_instance(key):
    """``mma_fwd_kernel<bf16,128,exact>`` for a flash or block-sparse
    attention kernel's demangled name, None for any other kernel."""
    m = ATTENTION_INSTANCE.search(key)
    if m is None:
        return None
    kind = "exact" if m.group(4) == "true" else "masked"
    return f"{m.group(1)}<{SHORT_TYPE[m.group(2)]},{m.group(3)},{kind}>"


def kernel_group(key):
    """The group a device kernel's time is reported under; the attention
    kernels by route: tensor cores (mma_*, wgmma_*) or the scalar f32-FMA
    kernels that f32 (and the backward and block-sparse kernels at the 256
    head-dim ceiling) keep."""
    name = key.lower()
    attn = attention_instance(key)
    route = "" if attn is None else \
        ", tensor cores" if attn.startswith(TENSOR_CORE_KERNELS) else \
        ", scalar"
    return ("block-sparse fwd (K6)" + route if "sparse_fwd_kernel" in name
            else "block-sparse bwd (K7)" + route
            if "sparse_dkdv_kernel" in name or "sparse_dq_kernel" in name else
            "flash attention fwd (K1/K3/K4)" + route if "fwd_kernel" in name
            else "flash attention bwd (K2/K3b-K5/K4b)" + route
            if "dkdv_kernel" in name or "dq_kernel" in name else
            "dropout (threefry)" if "threefry_dropout" in name else
            "optimizer (foreach)" if "foreach" in name or
            "multi_tensor" in name else
            "matmul" if any(s in name for s in (
                "gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")) else
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
    groups, attention = {}, {}
    for ms, count, key in rows:
        group = kernel_group(key)
        groups[group] = groups.get(group, 0.0) + ms
        instance = attention_instance(key)
        if instance is not None:
            attention[instance] = attention.get(instance, 0) + count
    # every path profiled here runs in bf16: its flash and block-sparse
    # attention launches must all be tensor-core instances
    wrong = [k for k in attention if not k.startswith(TENSOR_CORE_KERNELS)]
    check(not wrong, f"{name}: scalar attention kernels ran on this bf16 "
          f"path: {wrong}")
    phase(name, wall_ms=round(wall_ms, 3),
          device_busy_ms=round(busy_ms, 3),
          idle_share=round(1 - busy_ms / wall_ms, 4),
          attention_kernels=json.dumps(attention),
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


def profile_train(torch, engine, batch, name="profile train"):
    """Device time by kernel group over one ``train_batch``; returns the
    trace's ``{kernel: launches}``."""
    return profile_micro(torch, lambda: engine.train_batch(batch=batch), name)


def check_streams(torch, name, engine_x, prompts, outs, vocab, margin):
    """Generate checks: each stream keeps its prompt and stays in the vocab;
    greedy streams repeat, and a seed repeats its sampled stream; greedy
    tokens equal the full-forward argmax of the plain path wherever its
    top-2 gap exceeds ``margin``. ``outs``: greedy, greedy again, sampled,
    sampled again. Returns the number of positions checked."""
    greedy, greedy2, sampled, sampled2 = outs
    b, t = prompts.shape
    new = greedy.shape[1] - t
    for kind, out in (("greedy", greedy), ("sampled", sampled)):
        check(tuple(out.shape) == (b, t + new),
              f"{name} {kind} shape {tuple(out.shape)}")
        check(torch.equal(out[:, :t].cpu(), prompts.cpu()),
              f"{name} {kind} lost its prompt")
        check(0 <= int(out.min()) and int(out.max()) < vocab,
              f"{name} {kind} token out of the vocab")
    check(torch.equal(greedy, greedy2), f"{name}: greedy streams differ "
          f"across runs")
    check(torch.equal(sampled, sampled2),
          f"{name}: sampled streams differ for one seed")
    full = engine_x(greedy[:, :-1])[:, t - 1:, :vocab].float()
    top2 = full.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > margin
    match = full.argmax(-1) == greedy[:, t:]
    checked = int(clear.sum())
    check(checked > 0 and bool(match[clear].all()),
          f"{name}: greedy tokens disagree with the full forward at "
          f"{int((~match & clear).sum())} of {checked} clear positions")
    return checked


def run_generate(torch, engine, prompts, new):
    """Greedy twice and seeded sampling twice; returns the four streams and
    the first greedy call's seconds."""
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
    return (greedy, greedy2, sampled, sampled2), greedy_s


def compare_logits(torch, name, logits, logits_x, tol, logits_f32=None,
                   **extra):
    """Kernel-path logits against the plain path's on the same weights;
    with ``logits_f32`` (the plain path in f32), each bf16 path's mean abs
    error against it too. ``extra`` fields go on the phase line."""
    diff = (logits.float() - logits_x.float()).abs()
    mean_abs, max_abs = diff.mean().item(), diff.max().item()
    agree = (logits.argmax(-1) == logits_x.argmax(-1)).float().mean().item()
    fields = {}
    if logits_f32 is not None:
        err_k = (logits.float() - logits_f32).abs().mean().item()
        err_x = (logits_x.float() - logits_f32).abs().mean().item()
        fields = {"kernel_vs_f32_mean_abs": err_k,
                  "plain_vs_f32_mean_abs": err_x, "ratio": err_k / err_x}
        check(err_k <= tol["vs_f32_ratio"] * err_x,
              f"{name}: kernel-path error vs f32 {err_k}, plain-path "
              f"{err_x} (tol ratio {tol['vs_f32_ratio']})")
    check(mean_abs <= tol["mean_abs"] and max_abs <= tol["max_abs"],
          f"{name}: kernel-path logits vs plain path: mean {mean_abs} max "
          f"{max_abs} (tol {tol})")
    phase(name, mean_abs=mean_abs, max_abs=max_abs, argmax_agree=agree,
          logits_std=logits_x.float().std().item(), **fields, **extra,
          tol=json.dumps(tol))


def f32_logits(torch, model, ids):
    """Logits of ``model``'s weights in f32 on the plain attention path: a
    copy of its family built on the card, used once and freed."""
    ref = type(model)(dataclasses.replace(model.config, attn_backend="xla"),
                      generator=torch.Generator("cuda").manual_seed(0),
                      device="cuda", dtype=torch.float32)
    ref.load_state_dict(model.state_dict())
    with torch.inference_mode():
        logits = ref.logits(ids.cuda())
    del ref
    torch.cuda.empty_cache()
    return logits


def llama_model(torch, cfg, seed, dtype, backend="auto", tp=None):
    """A LLaMA model built on the card in ``dtype``, its weights drawn there
    from ``seed`` (the same weights for every backend, and at every tp:
    ``tp=None`` builds the rank's part on the rank mesh, 1 the whole
    model)."""
    from deepspeed_tpu_torch.models.llama import LlamaModel
    return LlamaModel(dataclasses.replace(cfg, attn_backend=backend),
                      generator=torch.Generator("cuda").manual_seed(seed),
                      device="cuda", dtype=dtype, tp=tp)


def llama_serve(torch):
    """LLaMA-7B through ``init_inference`` at full depth and width: three
    scoring calls on ``[4, 2048]`` (K3 launched 32 times each, K1 never),
    the same weights on the plain path, generate, a profile. Returns K3's
    launches in the scoring calls."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LLAMA_7B
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as k1
    cfg = LLAMA_7B
    b, t, h, d = 4, 2048, cfg.n_head, cfg.head_dim
    s0 = time.perf_counter()
    engine = deepspeed_tpu_torch.init_inference(
        llama_model(torch, cfg, SEED + 10, torch.bfloat16), {"dtype": "bf16"})
    torch.cuda.synchronize()
    init_s = time.perf_counter() - s0
    ids = torch.randint(0, cfg.vocab_size, (b, t),
                        generator=torch.Generator().manual_seed(SEED + 11))
    n_fwd = 3
    fa.flash_attention_fwd.launches = k1.packed_flash_attention_fwd.launches = 0
    fwd_s, per_call = [], []
    for _ in range(n_fwd):
        before = fa.flash_attention_fwd.launches
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        logits = engine(ids)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - s0)
        per_call.append(fa.flash_attention_fwd.launches - before)
    launches = fa.flash_attention_fwd.launches
    check(per_call == [cfg.n_layer] * n_fwd and
          k1.packed_flash_attention_fwd.launches == 0,
          f"K3 launched {per_call} times per LLaMA forward call, want "
          f"{cfg.n_layer}; K1 launched "
          f"{k1.packed_flash_attention_fwd.launches} times, want 0")
    check(tuple(logits.shape) == (b, t, cfg.padded_vocab),
          f"logits shape {tuple(logits.shape)}")
    check(torch.isfinite(logits.float()).all().item(), "logits not finite")
    # matmul FLOPs (qkv, proj, gate/up/down per layer; the LM head) plus
    # the causal attention's two products
    hk = cfg.kv_head_count
    per_token = cfg.n_layer * (cfg.n_embd * (h + 2 * hk) * d +
                               cfg.n_embd ** 2 + 3 * cfg.n_embd *
                               cfg.intermediate) + \
        cfg.padded_vocab * cfg.n_embd
    flops = 2 * b * t * per_token + \
        cfg.n_layer * 4 * b * h * d * kept_pairs(t, True, None)
    best = min(fwd_s[1:])
    phase("llama forward", model="LLAMA_7B", params=engine.module.num_params(),
          init_seconds=round(init_s, 2), shape=list(logits.shape),
          dtype=str(logits.dtype).replace("torch.", ""),
          k3_launches=launches, k3_launches_per_call=per_call,
          k1_launches=k1.packed_flash_attention_fwd.launches, calls=n_fwd,
          seconds=json.dumps([round(x, 4) for x in fwd_s]),
          tokens_per_s=round(b * t / best, 1), model_tflop=flops / 1e12,
          tflop_per_s=round(flops / best / 1e12, 2),
          share_of_bf16_peak=round(flops / best / PEAK_FLOPS["bfloat16"], 4),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))

    engine_x = deepspeed_tpu_torch.init_inference(
        llama_model(torch, cfg, SEED + 10, torch.bfloat16, "xla"),
        {"dtype": "bf16"})
    compare_logits(torch, "llama vs plain path", logits, engine_x(ids),
                   LLAMA_LOGITS_TOL,
                   f32_logits(torch, engine_x.module, ids))
    del logits
    torch.cuda.empty_cache()

    prompts = torch.randint(0, cfg.vocab_size, (4, 128),
                            generator=torch.Generator().manual_seed(SEED + 12))
    new = 32
    outs, greedy_s = run_generate(torch, engine, prompts, new)
    checked = check_streams(torch, "llama generate", engine_x, prompts, outs,
                            cfg.vocab_size, LLAMA_ARGMAX_MARGIN)
    phase("llama generate", requests=4, prompt=128, new_tokens=new,
          greedy_seconds=round(greedy_s, 4),
          tokens_per_s=round(4 * new / greedy_s, 1),
          greedy_repeat_equal=True, sampled_same_seed_equal=True,
          greedy_vs_forward_checked=checked, margin=LLAMA_ARGMAX_MARGIN,
          sampled_differs_from_greedy=not torch.equal(outs[2], outs[0]))
    # after the launch counts were read: this call's launches are not counted
    profile_forward(torch, engine, ids, name="profile llama forward")
    del engine, engine_x
    torch.cuda.empty_cache()
    return launches


def llama_train_config(lr, gas):
    return {"train_batch_size": LLAMA_MICRO * gas,
            "train_micro_batch_size_per_gpu": LLAMA_MICRO,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "adamw", "params": {"lr": lr}},
            "bf16": {"enabled": True},
            "zero_optimization": {"stage": 0},
            "steps_per_print": 0}


def llama_train(torch):
    """LLaMA-7B's width at LLAMA_TRAIN_LAYERS layers through ``initialize``
    -> ``train_batch`` (micro 4, T 2048, gas 2, bf16 on fp32 masters,
    AdamW): K3 forward and backward launched n_layer x gas times a step;
    then the kernel path's gradients against the plain path's, a repeated
    batch whose loss must fall, a profile. Returns the step's launches."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LLAMA_7B
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    cfg = dataclasses.replace(LLAMA_7B, n_layer=LLAMA_TRAIN_LAYERS)
    t, gas, micro = LLAMA_T, LLAMA_GAS, LLAMA_MICRO
    model = llama_model(torch, cfg, SEED + 13, torch.float32)
    engine = deepspeed_tpu_torch.initialize(
        model=model, config=llama_train_config(1e-4, gas))[0]
    rng = np.random.default_rng(SEED + 14)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size,
                                          (gas, micro, t), dtype=np.int64)}
               for _ in range(TRAIN_WARMUP + TRAIN_TIMED)]
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd
    torch.cuda.reset_peak_memory_stats()
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
    launches = {"K3": fwd.launches, "K3b/K5": bwd.launches}
    want = cfg.n_layer * gas
    check(all(n == [want, want] for n in per_step),
          f"K3 forward/backward launched {per_step} times per train_batch, "
          f"want {want} each (n_layer x gas)")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"llama train losses {losses} or grad norms {norms} not finite")
    tokens = gas * micro * t
    timed = step_s[TRAIN_WARMUP:]
    best = min(timed)
    flops_per_token = model.flops_per_token(t)
    phase("llama train", model=f"LLAMA_7B width, {cfg.n_layer} layers",
          params=model.num_params(), micro=micro, gas=gas, seq=t,
          dtype="bf16 on fp32 masters", optimizer="adamw lr 1e-4",
          steps=len(step_s), warmup=TRAIN_WARMUP,
          seconds=json.dumps([round(x, 4) for x in step_s]),
          step_s_best=round(best, 4),
          step_s_median=round(statistics.median(timed), 4),
          tokens_per_s=round(tokens / best, 1),
          flops_per_token=flops_per_token,
          tflop_per_s=round(tokens * flops_per_token / best / 1e12, 2),
          mfu=round(tokens * flops_per_token / best /
                    PEAK_FLOPS["bfloat16"], 4),
          losses=json.dumps([round(x, 4) for x in losses]),
          grad_norms=json.dumps([round(x, 4) for x in norms]),
          launches_per_step=json.dumps(per_step),
          launches=json.dumps(launches),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
    # after the launch counts were read: these launches are not counted
    profile_train(torch, engine, batches[-1], name="profile llama train")
    del engine, model
    torch.cuda.empty_cache()

    # the kernel path's gradients against the plain path's, one micro batch
    mb = {"input_ids": torch.as_tensor(batches[-1]["input_ids"][0]).cuda()}
    out = {}
    for backend in ("auto", "xla"):
        m = llama_model(torch, cfg, SEED + 13, torch.bfloat16, backend)
        loss = m.apply(mb)
        loss.backward()
        out[backend] = (loss.item(), {n: p.grad.float() for n, p in
                                      m.named_parameters()})
        del m, loss
        torch.cuda.empty_cache()
    (loss_k, grads_k), (loss_x, grads_x) = out["auto"], out["xla"]
    rel = {n: ((grads_k[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
           for n, g in grads_x.items()}
    worst = max(rel, key=rel.get)
    loss_diff = abs(loss_k - loss_x)
    check(rel[worst] <= LLAMA_GRAD_TOL["rel_l2_per_leaf"] and
          loss_diff <= LLAMA_GRAD_TOL["loss_abs"],
          f"llama K3 path vs plain path: worst leaf {worst} rel L2 "
          f"{rel[worst]}, loss diff {loss_diff} (tol {LLAMA_GRAD_TOL})")
    phase("llama train vs plain path", leaves=len(rel), loss_kernels=loss_k,
          loss_plain=loss_x, loss_abs_diff=loss_diff, max_rel_l2=rel[worst],
          worst_leaf=worst, median_rel_l2=statistics.median(rel.values()),
          tol=json.dumps(LLAMA_GRAD_TOL))
    del out, grads_k, grads_x
    torch.cuda.empty_cache()

    engine = deepspeed_tpu_torch.initialize(
        model=llama_model(torch, cfg, SEED + 13, torch.float32),
        config=llama_train_config(LLAMA_CONVERGE_LR, 1))[0]
    batch = {"input_ids": rng.integers(0, 256, (1, micro, t))}
    losses = [engine.train_batch(batch=batch).item()
              for _ in range(CONVERGE_STEPS)]
    check(losses[-1] < CONVERGE_FRACTION * losses[0],
          f"llama loss on a repeated batch went {losses[0]} -> {losses[-1]}, "
          f"want below {CONVERGE_FRACTION} x the first")
    phase("llama train converges", steps=CONVERGE_STEPS,
          lr=LLAMA_CONVERGE_LR, losses=json.dumps([round(x, 4)
                                                   for x in losses]),
          threshold=f"last < {CONVERGE_FRACTION} x first")
    del engine
    torch.cuda.empty_cache()
    return launches


def llama_gqa(torch):
    """LLaMA-2-70B's width (d 8192, 64 heads on 8 kv heads, MLP 28672) at 2
    layers with a 1024-token sliding window: a ``[2, 2048]`` forward on K3
    against the plain path, and a greedy generate past the window checked
    against the plain full forward: grouped-query attention, the window
    and the decode-mask hook at a real width."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LLAMA2_70B
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    cfg = dataclasses.replace(LLAMA2_70B, n_layer=2, sliding_window=1024)
    engines = {backend: deepspeed_tpu_torch.init_inference(
        llama_model(torch, cfg, SEED + 15, torch.bfloat16, backend),
        {"dtype": "bf16", "max_tokens": 2048})
        for backend in ("auto", "xla")}
    ids = torch.randint(0, cfg.vocab_size, (2, 2048),
                        generator=torch.Generator().manual_seed(SEED + 16))
    before = fa.flash_attention_fwd.launches
    logits = engines["auto"](ids)
    torch.cuda.synchronize()
    k3 = fa.flash_attention_fwd.launches - before
    check(k3 == cfg.n_layer, f"K3 launched {k3} times in the GQA forward, "
          f"want {cfg.n_layer}")
    compare_logits(torch, "llama gqa vs plain path", logits,
                   engines["xla"](ids), LLAMA_LOGITS_TOL,
                   f32_logits(torch, engines["xla"].module, ids))
    del logits
    prompt_len, new = 1536, 16
    prompts = torch.randint(0, cfg.vocab_size, (2, prompt_len),
                            generator=torch.Generator().manual_seed(SEED + 17))
    outs, greedy_s = run_generate(torch, engines["auto"], prompts, new)
    checked = check_streams(torch, "llama gqa generate", engines["xla"],
                            prompts, outs, cfg.vocab_size,
                            LLAMA_ARGMAX_MARGIN)
    phase("llama gqa", model="LLAMA2_70B width, 2 layers, window 1024",
          params=engines["auto"].module.num_params(),
          kv_heads=cfg.kv_head_count, k3_launches=k3, prompt=prompt_len,
          new_tokens=new, greedy_seconds=round(greedy_s, 4),
          greedy_vs_forward_checked=checked, margin=LLAMA_ARGMAX_MARGIN)
    del engines
    torch.cuda.empty_cache()


# ---------------------------------------------------- K6 / K7 block-sparse

def sparsity_config(ops, kind, heads=16):
    """The layouts of the K6/K7 checks at fine block 16: DeepSpeed's
    documented ``sparse_attention`` example (Fixed, the BERT-large main
    path's), BSLongformer and BigBird, where coarse tiles really are
    skipped."""
    if kind == "fixed":
        return ops.FixedSparsityConfig(
            num_heads=heads, block=16, num_local_blocks=4,
            num_global_blocks=1, different_layout_per_head=True,
            num_different_global_patterns=4)
    if kind == "bslongformer":
        return ops.BSLongformerSparsityConfig(
            num_heads=heads, block=16, num_sliding_window_blocks=3,
            global_block_indices=(0,))
    return ops.BigBirdSparsityConfig(
        num_heads=heads, block=16, num_random_blocks=1,
        num_sliding_window_blocks=3, num_global_blocks=1, seed=0)


def computed_pairs(layout, coarse, fb):
    """The (q, k) pairs the tensor-core K6/K7 compute after their skips, at
    the 16 x 16 granularity of a warp's steps (fine block a multiple of
    16): every pair of a visited coarse tile whose fine block is live or
    whose q row has no live block at all (block_sparse_plan.cuh)."""
    import numpy as np
    r = layout.shape[-1] // coarse.shape[-1]
    visited = np.repeat(np.repeat(coarse, r, 1), r, 2)
    rows_live = layout.any(-1)[:, :, None]
    return int((visited & (layout | ~rows_live)).sum()) * fb * fb


def sparse_case(torch, kind, shape, dtype, seed, heads=None):
    """Inputs of one K6/K7 check: q, k, v as views of [B, T, H, D] buffers
    (the BERT block's layout), the layout, its device plan and densities:
    the live (q, k) pairs (the function's work), the pairs of the visited
    coarse tiles (the scalar kernels' work) and the pairs the tensor-core
    kernels compute after their skips. ``heads = (h0, H)``: q holds heads
    ``[h0, h0 + h)`` of ``H`` (a tensor-parallel rank's), the layout the
    rows of the one made for all ``H``, as ``SparseSelfAttention`` takes
    them."""
    import numpy as np
    from deepspeed_tpu_torch.ops import sparse_attention_ops as ops
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    b, h, t, d = shape
    if heads is None:
        layout = sparsity_config(ops, kind, h).make_layout(t)
    else:
        h0, total = heads
        layout = np.ascontiguousarray(sparsity_config(
            ops, kind, total).make_layout(t)[h0:h0 + h])
    check(bsa.supported(torch.empty((b, h, t, d), device="cuda"), layout, 16),
          f"K6/K7 {kind}: {shape} with a layout of {layout.shape[0]} heads "
          f"is not supported")
    tile = bsa.default_tile(t, 16)
    plan = bsa.get_plan(layout, 16, tile, "cuda")
    coarse = bsa.build_plan(layout, 16, tile).coarse
    q, k, v = k3_inputs(torch, shape, dtype, seed)
    r = 64 // 16                                     # fine blocks a sub-tile
    subtiles = layout.reshape(h, t // 64, r, t // 64, r).any(axis=(2, 4))
    dens = {"layout": kind, "tile": tile,
            "live_tile_density": float(coarse.mean()),
            "live_subtile_density": float(subtiles.mean()),
            "live_fine_density": float(layout.mean()),
            "live_pairs": b * int(layout.sum()) * 16 * 16,
            "visited_pairs": b * int(coarse.sum()) * tile * tile,
            "computed_pairs": b * computed_pairs(layout, coarse, 16)}
    return q, k, v, layout, plan, dens


def check_k6(torch, kind, shape, dtype, heads=None, name="kernel-check K6"):
    """K6 against its plain version on the card, summing as the kernel's
    route does (``tensor_core_path``; ``indep_*``: against the
    ``torch.matmul`` plain version); its bound counts the live fine pairs
    (the function's work), the visited and computed pairs beside it; the
    library call is SDPA with the layout expanded to a boolean mask.
    ``heads``: a rank's heads (``sparse_case``)."""
    from deepspeed_tpu_torch.ops import sparse_attention_ops as ops
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    import torch.nn.functional as F
    b, h, t, d = shape
    q, k, v, layout, plan, dens = sparse_case(torch, kind, shape, dtype,
                                              SEED + 20, heads)
    scale = d ** -0.5
    tc = bsa.tensor_core_path(dtype, d)

    def plain(tensor_core):
        return bsa.block_sparse_attention_plain(q, k, v, plan, scale,
                                                tensor_core)

    out, lse = bsa.block_sparse_attention_fwd(q, k, v, plan, scale)
    (ref_out, ref_lse), plain_ms = timed_call(torch, lambda: plain(tc))
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    err_out, ratio_out = errors(out, ref_out)
    err_lse = (lse - ref_lse).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), "K6 output not finite")
    check(ratio_out <= 1 and err_lse <= LSE_TOL,
          f"K6 {kind} {dname}: out err {err_out} (ratio {ratio_out} to TOL "
          f"{TOL[dname]}), lse err {err_lse} (tol {LSE_TOL})")
    indep_out, indep_lse = plain(False) if tc else (ref_out, ref_lse)
    indep = independent([out], [indep_out], lse, indep_lse)
    del ref_out, ref_lse, indep_out, indep_lse
    kernel_ms = median_ms(torch, lambda: bsa.block_sparse_attention_fwd(
        q, k, v, plan, scale))
    mask = torch.from_numpy(ops.layout_to_mask(layout, 16)).cuda()[None]
    library_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask))
    del mask
    itemsize = torch.empty((), dtype=dtype).element_size()
    n_bytes = 4 * b * h * t * d * itemsize + 4 * b * h * t
    flops = 4 * d * dens["live_pairs"]
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dname] * 1e3
    res = {"dtype": dname, "shape": list(shape), "tensor_cores": tc, **dens,
           "err_out": err_out, "err_lse": err_lse, "ratio_out": ratio_out,
           "tol": TOL[dname], "tol_lse": LSE_TOL, **indep,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library": "SDPA with the layout mask",
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "visited_bound_ms": 4 * d * dens["visited_pairs"] /
           PEAK_FLOPS[dname] * 1e3,
           "computed_bound_ms": 4 * d * dens["computed_pairs"] /
           PEAK_FLOPS[dname] * 1e3}
    if heads is not None:
        res["heads"] = json.dumps([heads[0], heads[0] + h, heads[1]])
    phase(name, **res)
    return res


def check_k7(torch, kind, shape, dtype, heads=None, name="kernel-check K7"):
    """K7 against its plain version on the card (summing as the kernel's
    route does; ``indep_*`` as in K6's): K6's output and lse, a random
    output gradient; the library's backward is SDPA with the layout mask,
    forward + backward minus forward. ``heads``: a rank's heads."""
    from deepspeed_tpu_torch.ops import sparse_attention_ops as ops
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    import torch.nn.functional as F
    b, h, t, d = shape
    q, k, v, layout, plan, dens = sparse_case(torch, kind, shape, dtype,
                                              SEED + 21, heads)
    scale = d ** -0.5
    out, lse = bsa.block_sparse_attention_fwd(q, k, v, plan, scale)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    delta = fa.attention_delta(out, dout)

    def kernel():
        return bsa.block_sparse_attention_bwd(q, k, v, out, lse, dout, plan,
                                              scale)

    tc = bsa.tensor_core_path(dtype, d)

    def plain(tensor_core):
        return bsa.block_sparse_attention_bwd_plain(q, k, v, dout, lse, delta,
                                                    plan, scale, tensor_core)

    got = kernel()
    want, plain_ms = timed_call(torch, lambda: plain(tc))
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    errs, ratios = zip(*(errors(g, w) for g, w in zip(got, want)))
    check(all(torch.isfinite(g.float()).all().item() for g in got),
          "K7 output not finite")
    check(max(ratios) <= 1,
          f"K7 {kind} {dname}: dq/dk/dv errors {errs}, ratios {ratios} to "
          f"TOL {TOL[dname]}")
    indep = independent(got, plain(False) if tc else want)
    del want
    kernel_ms = median_ms(torch, kernel)
    mask = torch.from_numpy(ops.layout_to_mask(layout, 16)).cuda()[None]
    q4, k4, v4 = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (q4, k4, v4), dout)

    with torch.no_grad():
        fwd_ms = median_ms(torch, sdpa)
    library_ms = median_ms(torch, sdpa_fwd_bwd) - fwd_ms
    del mask
    itemsize = torch.empty((), dtype=dtype).element_size()
    n_bytes = 7 * b * h * t * d * itemsize + 2 * 4 * b * h * t
    flops = 10 * d * dens["live_pairs"]
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dname] * 1e3
    res = {"dtype": dname, "shape": list(shape), "tensor_cores": tc, **dens,
           "err_dq": errs[0], "err_dk": errs[1], "err_dv": errs[2],
           "ratio": max(ratios), "tol": TOL[dname], **indep,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library": "SDPA with the layout mask, fwd+bwd minus fwd",
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "visited_bound_ms": 10 * d * dens["visited_pairs"] /
           PEAK_FLOPS[dname] * 1e3,
           "computed_bound_ms": 10 * d * dens["computed_pairs"] /
           PEAK_FLOPS[dname] * 1e3}
    if heads is not None:
        res["heads"] = json.dumps([heads[0], heads[0] + h, heads[1]])
    phase(name, **res)
    return res


def sparse_planted_faults(torch, kind, shape, dtype):
    """What the K6/K7 checks report for planted faults, each a kernel that
    leaves one live coarse tile out of one (head, tile) row: the plain
    versions run on a copy of the plan whose last head's last q tile (K6,
    K7's dq) or last k tile (K7's dk/dv) has one live tile fewer, and are
    held against the true plan's results as a kernel's output is; every
    ratio must exceed 1, so that the checks would catch the fault. The
    plain versions sum as the K6/K7 checks' do."""
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    q, k, v, _, plan, _ = sparse_case(torch, kind, shape, dtype, SEED + 21)
    scale = shape[-1] ** -0.5
    tc = bsa.tensor_core_path(dtype, shape[-1])

    def dropped(counts):
        counts = counts.clone()
        counts[-1, -1] -= 1
        return counts

    fwd_fault = plan._replace(nnz=dropped(plan.nnz))
    dq_fault = fwd_fault
    dkdv_fault = plan._replace(nnz_t=dropped(plan.nnz_t))
    out, lse = bsa.block_sparse_attention_plain(q, k, v, plan, scale, tc)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    delta = fa.attention_delta(out, dout)
    grads = bsa.block_sparse_attention_bwd_plain(q, k, v, dout, lse, delta,
                                                 plan, scale, tc)
    bad_out, _ = bsa.block_sparse_attention_plain(q, k, v, fwd_fault, scale,
                                                  tc)
    bad_dq = bsa.block_sparse_attention_bwd_plain(
        q, k, v, dout, lse, delta, dq_fault, scale, tc)[0]
    _, bad_dk, bad_dv = bsa.block_sparse_attention_bwd_plain(
        q, k, v, dout, lse, delta, dkdv_fault, scale, tc)
    found = {}
    for name, fault, ref in (("out", bad_out, out), ("dq", bad_dq, grads[0]),
                             ("dk", bad_dk, grads[1]),
                             ("dv", bad_dv, grads[2])):
        err, ratio = errors(fault, ref)
        found[f"err_{name}"], found[f"ratio_{name}"] = err, ratio
        check(ratio > 1, f"a kernel that leaves one coarse tile out of "
              f"{name} would pass the K6/K7 check: ratio {ratio}")
    phase("kernel-check K6/K7 planted faults", layout=kind, shape=list(shape),
          dtype=str(dtype).replace("torch.", ""), **found)


# ------------------------------------------------ Code Llama 7B at T 16384

def codellama_config(layers=None):
    """Code Llama 7B (``codellama/CodeLlama-7b-hf`` config.json: LLaMA-7B's
    shape, vocab 32016, rope_theta 1e6, 16384 positions)."""
    from deepspeed_tpu_torch.models.llama import LLAMA_7B
    cfg = dataclasses.replace(LLAMA_7B, vocab_size=32016, rope_theta=1e6,
                              n_positions=CODELLAMA_T)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layer=layers)


class PlainKernelAttention:
    """The kernels' tiled plain versions (``flash_attention_plain``,
    ``flash_attention_bwd_plain``) in place of the ``[B, H, T, D]`` kernels
    for the duration of a ``with`` block: the path the Code Llama checks
    hold the kernel path against (the dense plain path would materialise
    [B, 32, 16384, 16384] f32 logits a layer). Its calls are no launches."""

    def __init__(self, torch):
        from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

        class Plain(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, causal, scale, window):
                out, lse = fa.flash_attention_plain(q, k, v, causal, scale,
                                                    window)
                ctx.save_for_backward(q, k, v, out, lse)
                ctx.args = (causal, scale, window)
                return out

            @staticmethod
            def backward(ctx, dout):
                q, k, v, out, lse = ctx.saved_tensors
                delta = fa.attention_delta(out, dout.to(q.dtype))
                dq, dk, dv = fa.flash_attention_bwd_plain(
                    q, k, v, dout.to(q.dtype), lse, delta, *ctx.args)
                return dq, dk, dv, None, None, None

        self.fa, self.plain = fa, Plain

    def __enter__(self):
        self.kernel = self.fa.flash_attention
        self.fa.flash_attention = lambda q, k, v, causal=True, scale=None, \
            window=None: self.plain.apply(q, k, v, causal, scale, window)
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention = self.kernel


def codellama_serve(torch):
    """Code Llama 7B through ``init_inference`` at full depth and width:
    three scoring calls on ``[1, 16384]`` bf16 (K4 launched 32 times each,
    K3 and K1 never), the same engine on the kernels' plain versions, and a
    profile. Returns K4's launches in the scoring calls."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as k1
    cfg = codellama_config()
    b, t, h, d = 1, CODELLAMA_T, cfg.n_head, cfg.head_dim
    torch.cuda.reset_peak_memory_stats()
    s0 = time.perf_counter()
    engine = deepspeed_tpu_torch.init_inference(
        llama_model(torch, cfg, SEED + 30, torch.bfloat16), {"dtype": "bf16"})
    torch.cuda.synchronize()
    init_s = time.perf_counter() - s0
    ids = torch.randint(0, cfg.vocab_size, (b, t),
                        generator=torch.Generator().manual_seed(SEED + 31))
    fwd = fa.flash_attention_fwd
    fwd.launches = fwd.streamed_launches = 0
    k1.packed_flash_attention_fwd.launches = 0
    fwd_s, per_call = [], []
    for _ in range(3):
        before = fwd.streamed_launches
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        logits = engine(ids)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - s0)
        per_call.append(fwd.streamed_launches - before)
    launches = fwd.streamed_launches
    check(per_call == [cfg.n_layer] * 3 and fwd.launches == 0 and
          k1.packed_flash_attention_fwd.launches == 0,
          f"K4 launched {per_call} times per Code Llama forward call, want "
          f"{cfg.n_layer}; K3 {fwd.launches} and K1 "
          f"{k1.packed_flash_attention_fwd.launches} times, want 0")
    check(tuple(logits.shape) == (b, t, cfg.padded_vocab),
          f"logits shape {tuple(logits.shape)}")
    check(torch.isfinite(logits.float()).all().item(), "logits not finite")
    per_token = cfg.n_layer * (cfg.n_embd * 3 * h * d + cfg.n_embd ** 2 +
                               3 * cfg.n_embd * cfg.intermediate) + \
        cfg.padded_vocab * cfg.n_embd
    flops = 2 * b * t * per_token + \
        cfg.n_layer * 4 * b * h * d * kept_pairs(t, True, None)
    best = min(fwd_s[1:])
    phase("codellama forward", model="Code Llama 7B (LLAMA_7B, vocab 32016, "
          "rope_theta 1e6)", params=engine.module.num_params(),
          init_seconds=round(init_s, 2), shape=list(logits.shape),
          dtype=str(logits.dtype).replace("torch.", ""),
          k4_launches=launches, k4_launches_per_call=per_call,
          k3_launches=fwd.launches, calls=3,
          seconds=json.dumps([round(x, 4) for x in fwd_s]),
          tokens_per_s=round(b * t / best, 1), model_tflop=flops / 1e12,
          tflop_per_s=round(flops / best / 1e12, 2),
          share_of_bf16_peak=round(flops / best / PEAK_FLOPS["bfloat16"], 4),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
    with PlainKernelAttention(torch):
        s0 = time.perf_counter()
        logits_p = engine(ids)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - s0
    check(fwd.streamed_launches == launches, "the plain-kernel path launched "
          "a kernel")
    compare_logits(torch, "codellama vs plain-kernel path", logits, logits_p,
                   LLAMA_LOGITS_TOL, plain_seconds=round(plain_s, 2))
    del logits, logits_p
    torch.cuda.empty_cache()
    profile_forward(torch, engine, ids, name="profile codellama forward")
    del engine
    torch.cuda.empty_cache()
    return launches


def codellama_train(torch):
    """Code Llama 7B's width at CODELLAMA_TRAIN_LAYERS layers through
    ``initialize`` -> ``train_batch`` (micro 1, T 16384, gas 2, bf16 on fp32
    masters, AdamW): K4 and K4b launched n_layer x gas times a step, K3
    never; the gradients against the plain-kernel path; a profile. Returns
    the steps' launches."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    cfg = codellama_config(CODELLAMA_TRAIN_LAYERS)
    t, gas, micro = CODELLAMA_T, 2, 1
    model = llama_model(torch, cfg, SEED + 32, torch.float32)
    engine = deepspeed_tpu_torch.initialize(model=model, config={
        "train_batch_size": micro * gas,
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": gas,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-4}},
        "bf16": {"enabled": True}, "zero_optimization": {"stage": 0},
        "steps_per_print": 0})[0]
    rng = np.random.default_rng(SEED + 33)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, (gas, micro, t),
                                          dtype=np.int64)} for _ in range(3)]
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd
    torch.cuda.reset_peak_memory_stats()
    fwd.launches = fwd.streamed_launches = 0
    bwd.launches = bwd.streamed_launches = 0
    step_s, per_step, losses = [], [], []
    for batch in batches:
        before = (fwd.streamed_launches, bwd.streamed_launches)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        loss = engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - s0)
        per_step.append([fwd.streamed_launches - before[0],
                         bwd.streamed_launches - before[1]])
        losses.append(loss.item())
    launches = {"K4": fwd.streamed_launches, "K4b": bwd.streamed_launches}
    want = cfg.n_layer * gas
    check(all(n == [want, want] for n in per_step) and
          fwd.launches == bwd.launches == 0,
          f"K4/K4b launched {per_step} times per train_batch, want {want} "
          f"each; K3 {fwd.launches}, K3b/K5 {bwd.launches}, want 0")
    check(all(np.isfinite(losses)), f"codellama losses {losses} not finite")
    tokens = gas * micro * t
    best = min(step_s[1:])
    flops_per_token = model.flops_per_token(t)
    phase("codellama train", model=f"Code Llama 7B width, {cfg.n_layer} "
          f"layers", params=model.num_params(), micro=micro, gas=gas, seq=t,
          dtype="bf16 on fp32 masters", optimizer="adamw lr 1e-4",
          steps=len(step_s), warmup=1,
          seconds=json.dumps([round(x, 4) for x in step_s]),
          step_s_best=round(best, 4), tokens_per_s=round(tokens / best, 1),
          flops_per_token=flops_per_token,
          tflop_per_s=round(tokens * flops_per_token / best / 1e12, 2),
          mfu=round(tokens * flops_per_token / best /
                    PEAK_FLOPS["bfloat16"], 4),
          losses=json.dumps([round(x, 4) for x in losses]),
          launches_per_step=json.dumps(per_step),
          launches=json.dumps(launches),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
    profile_train(torch, engine, batches[-1], name="profile codellama train")
    del engine, model
    torch.cuda.empty_cache()

    mb = {"input_ids": torch.as_tensor(batches[-1]["input_ids"][0]).cuda()}
    out = {}
    for route in ("kernels", "plain kernels"):
        m = llama_model(torch, cfg, SEED + 32, torch.bfloat16)
        if route == "kernels":
            loss = m.apply(mb)
            loss.backward()
        else:
            with PlainKernelAttention(torch):
                loss = m.apply(mb)
                loss.backward()
        out[route] = (loss.item(), {n: p.grad.float() for n, p in
                                    m.named_parameters()})
        del m, loss
        torch.cuda.empty_cache()
    grad_phase(torch, "codellama train vs plain-kernel path",
               out["kernels"], out["plain kernels"], LLAMA_GRAD_TOL)
    return launches


def grad_phase(torch, name, kernel, plain, tol):
    """Per-leaf rel. L2 of the kernel path's gradients against another
    path's, and the loss difference, held to ``tol``."""
    (loss_k, grads_k), (loss_x, grads_x) = kernel, plain
    rel = {n: ((grads_k[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
           for n, g in grads_x.items()}
    worst = max(rel, key=rel.get)
    loss_diff = abs(loss_k - loss_x)
    check(rel[worst] <= tol["rel_l2_per_leaf"] and
          loss_diff <= tol["loss_abs"],
          f"{name}: worst leaf {worst} rel L2 {rel[worst]}, loss diff "
          f"{loss_diff} (tol {tol})")
    phase(name, leaves=len(rel), loss_kernels=loss_k, loss_plain=loss_x,
          loss_abs_diff=loss_diff, max_rel_l2=rel[worst], worst_leaf=worst,
          median_rel_l2=statistics.median(rel.values()),
          tol=json.dumps(tol))


# --------------------------------- BERT-large with sparse attention, T 4096

def bert_model(torch, dtype, seed, layers=None, tp=None):
    """BERT-large (``n_layer`` cut to ``layers`` if given) drawn on the card
    from ``seed``, then ``SparseAttentionUtils`` surgery: positions
    extended 512 -> 4096 and DeepSpeed's Fixed sparse_attention example
    installed. Returns the model and the surgery's layout at T 4096 (for
    all heads). ``tp``: as ``llama_model``'s."""
    from deepspeed_tpu_torch.models.bert import BERT_LARGE, BertModel
    from deepspeed_tpu_torch.ops import sparse_attention_ops as ops
    from deepspeed_tpu_torch.ops.sparse_attention_utils import \
        SparseAttentionUtils
    cfg = BERT_LARGE if layers is None else \
        dataclasses.replace(BERT_LARGE, n_layer=layers)
    model = BertModel(cfg, generator=torch.Generator("cuda").manual_seed(seed),
                      device="cuda", dtype=dtype, tp=tp)
    sparsity = sparsity_config(ops, "fixed", cfg.n_head)
    SparseAttentionUtils.\
        replace_model_self_attention_with_sparse_self_attention(
            model, max_position=BERT_T, sparsity_config=sparsity)
    return model, ops.SparseSelfAttention(sparsity).layout(BERT_T)


class DenseAttention:
    """A surgered BERT's block-sparse attention replaced, for a ``with``
    block, by the dense-masked plain path over the same layout."""

    def __init__(self, model, layout):
        from deepspeed_tpu_torch.ops import sparse_attention_ops as ops
        self.model, self.layout, self.ops = model, layout, ops

    def __enter__(self):
        self.saved = self.model.attn_override
        self.model.attn_override = lambda q, k, v, mask: \
            self.ops.sparse_attention(q, k, v, self.layout, 16, impl="dense")
        return self

    def __exit__(self, *exc):
        self.model.attn_override = self.saved


def bert_batch(np, rng, gas, micro, t, ids_from, ids_to):
    """MLM batches ``[gas, micro, ...]``: ids in [ids_from, ids_to) (BERT's
    vocab has its special and unused tokens below 1000), BERT_MASK_RATE of
    the positions masked (their ids replaced by [MASK] = 103) with their
    labels."""
    ids = rng.integers(ids_from, ids_to, (gas, micro, t), dtype=np.int64)
    n = int(round(BERT_MASK_RATE * t))
    pos = np.sort(np.argsort(rng.random((gas, micro, t)), -1)[..., :n], -1)
    labels = np.take_along_axis(ids, pos, -1)
    np.put_along_axis(ids, pos, 103, -1)
    return {"input_ids": ids, "masked_positions": pos,
            "masked_labels": labels}


def bert_serve(torch):
    """BERT-large with the Fixed sparse surgery through ``init_inference``
    at ``[4, 4096]`` bf16 at BERT_SERVE_LAYERS layers: three scoring calls
    (K6 launched once a layer each, K3 never), the dense-masked plain path
    and an f32 reference, a profile. Returns K6's launches in the scoring
    calls."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    model, layout = bert_model(torch, torch.bfloat16, SEED + 40,
                               BERT_SERVE_LAYERS)
    cfg = model.config
    engine = deepspeed_tpu_torch.init_inference(model, {"dtype": "bf16"})
    b, t = BERT_MICRO, BERT_T
    ids = torch.randint(0, cfg.vocab_size, (b, t),
                        generator=torch.Generator().manual_seed(SEED + 41))
    k6 = bsa.block_sparse_attention_fwd
    torch.cuda.reset_peak_memory_stats()
    k6.launches = fa.flash_attention_fwd.launches = 0
    fwd_s, per_call = [], []
    for _ in range(3):
        before = k6.launches
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        logits = engine(ids)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - s0)
        per_call.append(k6.launches - before)
    launches = k6.launches
    check(per_call == [cfg.n_layer] * 3 and
          fa.flash_attention_fwd.launches == 0,
          f"K6 launched {per_call} times per BERT forward call, want "
          f"{cfg.n_layer}; K3 {fa.flash_attention_fwd.launches}, want 0")
    check(tuple(logits.shape) == (b, t, cfg.padded_vocab),
          f"logits shape {tuple(logits.shape)}")
    check(torch.isfinite(logits.float()).all().item(), "logits not finite")
    d, h = cfg.n_embd, cfg.n_head
    live = b * int(layout.sum()) * 16 * 16
    per_token = cfg.n_layer * 12 * d * d + 2 * d * d + cfg.padded_vocab * d
    flops = 2 * b * t * per_token + cfg.n_layer * 4 * cfg.head_dim * live
    best = min(fwd_s[1:])
    phase("bert forward", model="BERT-large + Fixed sparse attention "
          f"(block 16, 4 local, 1 global, 4 patterns), {cfg.n_layer} of 24 "
          f"layers",
          params=model.num_params(), shape=list(logits.shape),
          dtype=str(logits.dtype).replace("torch.", ""),
          live_fine_density=float(layout.mean()), k6_launches=launches,
          k6_launches_per_call=per_call,
          k3_launches=fa.flash_attention_fwd.launches, calls=3,
          seconds=json.dumps([round(x, 4) for x in fwd_s]),
          tokens_per_s=round(b * t / best, 1), model_tflop=flops / 1e12,
          tflop_per_s=round(flops / best / 1e12, 2),
          share_of_bf16_peak=round(flops / best / PEAK_FLOPS["bfloat16"], 4),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
    with DenseAttention(model, layout):
        logits_x = engine(ids)
        ref, _ = bert_model(torch, torch.float32, SEED + 40,
                            BERT_SERVE_LAYERS)
        ref.load_state_dict(model.state_dict())
        with DenseAttention(ref, layout), torch.inference_mode():
            logits_f32 = ref.logits(ids.cuda())
        del ref
    compare_logits(torch, "bert vs plain path", logits, logits_x,
                   BERT_LOGITS_TOL, logits_f32)
    del logits, logits_x, logits_f32
    torch.cuda.empty_cache()
    profile_forward(torch, engine, ids, name="profile bert forward")
    del engine, model
    torch.cuda.empty_cache()
    return launches


def bert_train_config(lr, gas, micro):
    return {"train_batch_size": micro * gas,
            "train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "adamw", "params": {"lr": lr}},
            "bf16": {"enabled": True}, "zero_optimization": {"stage": 0},
            "steps_per_print": 0}


def bert_train(torch):
    """BERT-large with the Fixed surgery through ``initialize`` ->
    ``train_batch`` (micro 4, T 4096, gas 2, bf16 on fp32 masters, AdamW,
    15% masked positions): K6 and K7 launched 24 x 2 times a step, K3
    never; then, at 4 layers, the gradients against the dense-masked plain
    path and a repeated batch whose loss must fall; a profile. Returns the
    steps' launches."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    model, layout = bert_model(torch, torch.float32, SEED + 42)
    cfg = model.config
    t, gas, micro = BERT_T, BERT_GAS, BERT_MICRO
    engine = deepspeed_tpu_torch.initialize(
        model=model, config=bert_train_config(1e-4, gas, micro))[0]
    rng = np.random.default_rng(SEED + 43)
    batches = [bert_batch(np, rng, gas, micro, t, 1000, cfg.vocab_size)
               for _ in range(TRAIN_WARMUP + TRAIN_TIMED)]
    fwd, bwd = bsa.block_sparse_attention_fwd, bsa.block_sparse_attention_bwd
    torch.cuda.reset_peak_memory_stats()
    fwd.launches = bwd.launches = fa.flash_attention_fwd.launches = 0
    step_s, per_step, losses = [], [], []
    for batch in batches:
        before = (fwd.launches, bwd.launches)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        loss = engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - s0)
        per_step.append([fwd.launches - before[0], bwd.launches - before[1]])
        losses.append(loss.item())
    launches = {"K6": fwd.launches, "K7": bwd.launches}
    want = cfg.n_layer * gas
    check(all(n == [want, want] for n in per_step) and
          fa.flash_attention_fwd.launches == 0,
          f"K6/K7 launched {per_step} times per train_batch, want {want} "
          f"each; K3 {fa.flash_attention_fwd.launches}, want 0")
    check(all(np.isfinite(losses)), f"bert losses {losses} not finite")
    tokens = gas * micro * t
    timed = step_s[TRAIN_WARMUP:]
    best = min(timed)
    # the JAX package's count (dense attention) and one with the attention
    # term scaled to the live pairs
    dense_fpt = model.flops_per_token(t)
    sparse_fpt = model.flops_per_token() + \
        12 * cfg.n_layer * cfg.n_embd * t * float(layout.mean())
    phase("bert train", model="BERT-large + Fixed sparse attention",
          params=model.num_params(), micro=micro, gas=gas, seq=t,
          masked_per_row=batches[0]["masked_positions"].shape[-1],
          dtype="bf16 on fp32 masters", optimizer="adamw lr 1e-4",
          steps=len(step_s), warmup=TRAIN_WARMUP,
          seconds=json.dumps([round(x, 4) for x in step_s]),
          step_s_best=round(best, 4),
          step_s_median=round(statistics.median(timed), 4),
          tokens_per_s=round(tokens / best, 1),
          flops_per_token_dense_attention=dense_fpt,
          flops_per_token_live_pairs=sparse_fpt,
          mfu=round(tokens * sparse_fpt / best / PEAK_FLOPS["bfloat16"], 4),
          losses=json.dumps([round(x, 4) for x in losses]),
          launches_per_step=json.dumps(per_step),
          launches=json.dumps(launches),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
    MEASURED["bert train"] = {
        "tokens_per_s": tokens / best,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    profile_train(torch, engine, batches[-1], name="profile bert train")
    del engine, model
    torch.cuda.empty_cache()

    # 4 layers: the kernel path's gradients against the dense-masked path
    batch = bert_batch(np, rng, 1, 2, t, 1000, cfg.vocab_size)
    mb = {k: torch.as_tensor(v[0]).cuda() for k, v in batch.items()}
    out = {}
    for route in ("kernels", "dense"):
        m, lay = bert_model(torch, torch.bfloat16, SEED + 44,
                            BERT_SMALL_LAYERS)
        if route == "kernels":
            loss = m.apply(mb)
            loss.backward()
        else:
            with DenseAttention(m, lay):
                loss = m.apply(mb)
                loss.backward()
        out[route] = (loss.item(), {n: p.grad.float() for n, p in
                                    m.named_parameters()})
        del m, loss
        torch.cuda.empty_cache()
    grad_phase(torch, "bert train vs plain path", out["kernels"],
               out["dense"], BERT_GRAD_TOL)
    del out

    model, _ = bert_model(torch, torch.float32, SEED + 45, BERT_SMALL_LAYERS)
    engine = deepspeed_tpu_torch.initialize(
        model=model, config=bert_train_config(BERT_CONVERGE_LR, 1, micro))[0]
    batch = bert_batch(np, rng, 1, micro, t, 1000, 1256)
    losses = [engine.train_batch(batch=batch).item()
              for _ in range(CONVERGE_STEPS)]
    check(losses[-1] < CONVERGE_FRACTION * losses[0],
          f"bert loss on a repeated batch went {losses[0]} -> {losses[-1]}, "
          f"want below {CONVERGE_FRACTION} x the first")
    phase("bert train converges", layers=BERT_SMALL_LAYERS,
          steps=CONVERGE_STEPS, lr=BERT_CONVERGE_LR,
          losses=json.dumps([round(x, 4) for x in losses]),
          threshold=f"last < {CONVERGE_FRACTION} x first")
    del engine, model
    torch.cuda.empty_cache()
    return launches


# ------------------------------------- the dropout kernel and slice 7's loops

def dropout_bound(n, itemsize):
    """``(bound_ms, bound_by, int_ops, bytes)`` of one dropout pass over
    ``n`` elements: x read once and out written once against the HBM rate,
    DROPOUT_INT_OPS integer operations an element against the INT32 rate."""
    nbytes = 2 * n * itemsize
    ops = DROPOUT_INT_OPS * n
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT32_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def check_dropout(torch):
    """The threefry dropout kernel against its plain version on the card,
    bit for bit (``torch.equal``), forward and backward (the autograd
    ``Function``: the same kernel on the gradient), at each shape of
    DROPOUT_SHAPES in f32, bf16 and f16; the keep share within 5 sigma of
    the binomial; then a planted fault (one flipped key word) the same
    comparison must catch. Times the kernel, its plain version and
    ``torch.nn.functional.dropout`` (PyTorch's one-call dropout, which
    draws other bits) at the same shape. Returns the BERT bf16 case."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import dropout as drop
    from deepspeed_tpu_torch.ops.kernels import threefry_dropout as tfd
    key, rate = DROPOUT_KEY, DROPOUT_RATE
    gen = torch.Generator("cuda").manual_seed(SEED + 60)
    main = None
    for name, shape in DROPOUT_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            xg = x.clone().requires_grad_()
            out = drop.token_dropout(xg, key, rate)
            out.backward(g)
            torch.cuda.synchronize()
            want, plain_ms = timed_call(
                torch, lambda: tfd.threefry_dropout_plain(x, key, rate))
            dwant = tfd.threefry_dropout_plain(g, key, rate)
            fwd_equal = torch.equal(out.detach(), want)
            bwd_equal = torch.equal(xg.grad, dwant)
            err = max((out.detach().float() - want.float()).abs().max()
                      .item(), (xg.grad.float() - dwant.float()).abs().max()
                      .item())
            check(fwd_equal and bwd_equal,
                  f"dropout kernel {name} {dtype}: forward equal "
                  f"{fwd_equal}, backward equal {bwd_equal}, max abs {err}")
            n = x.numel()
            kept = ((want != 0) | (x == 0)).sum().item()
            z = (kept / n - (1 - rate)) / math.sqrt(rate * (1 - rate) / n)
            check(abs(z) <= 5, f"dropout {name} {dtype}: keep share "
                  f"{kept / n} is {z:.2f} sigma from {1 - rate}")
            # planted fault: one flipped key word; the check must catch it
            bad = tfd.threefry_dropout(x, (key[0] ^ 1, key[1]), rate)
            caught = not torch.equal(bad, want)
            mismatched = (bad != want).sum().item()
            check(caught, f"dropout {name} {dtype}: a flipped key word "
                  f"gave the same output")
            kernel_ms = median_ms(
                torch, lambda: tfd.threefry_dropout(x, key, rate), reps=7,
                inner=5, warmup=2)
            library_ms = median_ms(
                torch, lambda: F.dropout(x, rate, training=True), reps=7,
                inner=5, warmup=2)
            bound_ms, bound_by, ops, nbytes = dropout_bound(
                n, x.element_size())
            res = {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms, "err": err}
            phase("kernel-check dropout", shape=list(shape),
                  case=name, dtype=str(dtype).replace("torch.", ""),
                  rate=rate, fwd_bitwise=fwd_equal, bwd_bitwise=bwd_equal,
                  max_abs_err=err, keep_share=round(kept / n, 6),
                  keep_sigma=round(z, 3), fault_caught=caught,
                  fault_mismatched=mismatched, kernel_ms=round(kernel_ms, 4),
                  plain_ms=round(plain_ms, 2), bound_ms=round(bound_ms, 4),
                  bound_by=bound_by, int_ops=ops, bytes=nbytes,
                  int_ops_per_element=DROPOUT_INT_OPS,
                  library_ms=round(library_ms, 4),
                  library="torch.nn.functional.dropout (other bits)")
            if name == "bert" and dtype == torch.bfloat16:
                main = res
            del x, g, xg, out, want, dwant, bad
            torch.cuda.empty_cache()
    return main


def reset_counts():
    """Every kernel wrapper's launch count set to 0 (before a main path)."""
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as k1
    from deepspeed_tpu_torch.ops.kernels import threefry_dropout as tfd
    for fn in (k1.packed_flash_attention_fwd, k1.packed_flash_attention_bwd,
               fa.flash_attention_fwd, fa.flash_attention_bwd,
               bsa.block_sparse_attention_fwd,
               bsa.block_sparse_attention_bwd, tfd.threefry_dropout):
        fn.launches = 0
    for fn in (fa.flash_attention_fwd, fa.flash_attention_bwd):
        fn.streamed_launches = 0
    tfd.threefry_dropout.mapped_launches = 0


def counts():
    """``{kernel: launches}`` of every wrapper now."""
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as k1
    from deepspeed_tpu_torch.ops.kernels import threefry_dropout as tfd
    return {"K1": k1.packed_flash_attention_fwd.launches,
            "K2": k1.packed_flash_attention_bwd.launches,
            "K3": fa.flash_attention_fwd.launches,
            "K3b/K5": fa.flash_attention_bwd.launches,
            "K6": bsa.block_sparse_attention_fwd.launches,
            "K7": bsa.block_sparse_attention_bwd.launches,
            "dropout": tfd.threefry_dropout.launches,
            "dropout heads": tfd.threefry_dropout.mapped_launches}


def counts_since(before):
    now = counts()
    return {k: now[k] - before[k] for k in now}


def user_loop_step(engine, batch):
    """One global step of DeepSpeed's user loop over a ``[gas, micro, ...]``
    batch: ``engine(mb)``, ``engine.backward(loss)`` per micro batch, then
    ``engine.step()``. Returns the step's metrics."""
    gas = len(next(iter(batch.values())))
    for i in range(gas):
        loss = engine({k: v[i] for k, v in batch.items()})
        engine.backward(loss)
    return engine.step()


def run_steps(torch, fn, batches):
    """``fn(batch)`` for each batch, each ended by a synchronize: the
    seconds, the launches and the losses of every step."""
    step_s, per_step, losses = [], [], []
    for batch in batches:
        before = counts()
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        loss = fn(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - s0)
        per_step.append(counts_since(before))
        losses.append(float(loss))
    return step_s, per_step, losses


def profile_micro(torch, fn, name):
    """Device time by kernel group over one micro step (``fn``: forward
    and backward) under ``torch.profiler``; returns ``{kernel key: count}``
    of the trace's device kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - s0) * 1e3
    report_profile(name, prof, wall_ms, top=10)
    return {e.key: e.count for e in prof.key_averages()
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0}


def launches_named(kernels, pattern):
    """Launches in a profile of the kernels whose name matches."""
    return sum(n for k, n in kernels.items() if re.search(pattern, k))


def grads_of(torch, model, mb, **kwargs):
    """``(loss, {name: f32 grad})`` of one micro batch through ``apply``."""
    loss = model.apply(mb, **kwargs)
    loss.backward()
    return loss.item(), {n: (p.grad.float() if p.grad is not None else
                             torch.zeros_like(p, dtype=torch.float32))
                         for n, p in model.named_parameters()}


def bitwise(a, b):
    """Whether two ``grads_of`` results are the same bits."""
    return a[0] == b[0] and all(
        a[1][n].shape == b[1][n].shape and bool((a[1][n] == b[1][n]).all())
        for n in a[1])


class PlainSparseKernels:
    """The K6/K7 kernels' tiled plain versions and the dropout kernel's
    plain version in place of the kernels for a ``with`` block (their
    calls are no launches): the plain-kernel path the BERT loop's kernel
    path is held against."""

    def __init__(self):
        from deepspeed_tpu_torch.ops import dropout as drop
        from deepspeed_tpu_torch.ops.kernels import block_sparse_attention \
            as bsa
        from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
        from deepspeed_tpu_torch.ops.kernels import threefry_dropout as tfd
        self.drop, self.bsa, self.fa, self.tfd = drop, bsa, fa, tfd

    def __enter__(self):
        bsa, fa = self.bsa, self.fa
        self.saved = (bsa.block_sparse_attention_fwd,
                      bsa.block_sparse_attention_bwd, self.drop.threefry_dropout)

        def fwd(q, k, v, plan, scale):
            return bsa.block_sparse_attention_plain(q, k, v, plan, scale)

        def bwd(q, k, v, out, lse, dout, plan, scale):
            delta = fa.attention_delta(out, dout)
            return bsa.block_sparse_attention_bwd_plain(
                q, k, v, dout, lse, delta, plan, scale)

        bsa.block_sparse_attention_fwd = fwd
        bsa.block_sparse_attention_bwd = bwd
        self.drop.threefry_dropout = self.tfd.threefry_dropout_plain
        return self

    def __exit__(self, *exc):
        (self.bsa.block_sparse_attention_fwd,
         self.bsa.block_sparse_attention_bwd,
         self.drop.threefry_dropout) = self.saved


def with_dropout(model, rate, **changes):
    """The model with its (frozen) config's dropout and other fields
    changed."""
    model.config = dataclasses.replace(model.config, dropout=rate, **changes)
    return model


def bert_train_loop(torch):
    """BERT-large with the Fixed surgery, BERT-large's published dropout
    0.1 and ``"activation_checkpointing": {}`` (the default policy),
    trained through DeepSpeed's user loop (micro 4, T 4096, gas 2, bf16 on
    fp32 masters, AdamW): K6 launched 2 x 24 x gas a step (each layer's
    recompute runs it again), K7 24 x gas, the dropout kernel on every
    residual and embedding dropout (the sparse override forgoes the
    probability dropout, as in the JAX package). Then, at 4 layers: the
    user loop against ``train_batch`` without dropout (masters bitwise),
    remat on against off with dropout (gradients), the kernel path
    against the plain-kernel path on the same keys, a repeated batch; a
    profile of one micro step. Returns the loop's launches."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import prng
    model, layout = bert_model(torch, torch.float32, SEED + 42)
    with_dropout(model, DROPOUT_RATE)
    cfg = model.config
    t, gas, micro = BERT_T, BERT_GAS, BERT_MICRO
    config = dict(bert_train_config(1e-4, gas, micro),
                  activation_checkpointing={})
    engine = deepspeed_tpu_torch.initialize(model=model, config=config)[0]
    check(engine.module.config.remat and engine.module.config.remat_policy
          == "dots_with_no_batch_dims_saveable",
          f"activation_checkpointing {{}} gave remat "
          f"{engine.module.config.remat} policy "
          f"{engine.module.config.remat_policy}")
    rng = np.random.default_rng(SEED + 43)
    batches = [bert_batch(np, rng, gas, micro, t, 1000, cfg.vocab_size)
               for _ in range(TRAIN_WARMUP + TRAIN_TIMED)]
    batches = [{k: torch.as_tensor(v).cuda() for k, v in b.items()}
               for b in batches]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_s, per_step, losses = run_steps(
        torch, lambda b: user_loop_step(engine, b)["loss"], batches)
    launches = counts()
    n_layer = cfg.n_layer
    want = {"K6": 2 * n_layer * gas, "K7": n_layer * gas}
    # forward and backward: the embeddings' and 2 a layer; the recompute
    # remakes what the backward needs (early stop)
    drop_min = 2 * gas * (2 * n_layer + 1)
    check(all(n["K6"] == want["K6"] and n["K7"] == want["K7"] and
              n["dropout"] >= drop_min and n["K3"] == 0 for n in per_step),
          f"bert train loop launched {per_step} a step, want K6 "
          f"{want['K6']} (forward + recompute), K7 {want['K7']}, dropout "
          f">= {drop_min}, K3 0")
    check(all(np.isfinite(losses)), f"bert loop losses {losses} not finite")
    tokens = gas * micro * t
    best = min(step_s[TRAIN_WARMUP:])
    sparse_fpt = model.flops_per_token() + \
        12 * cfg.n_layer * cfg.n_embd * t * float(layout.mean())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ref = MEASURED.get("bert train", {})
    phase("bert train loop", model="BERT-large + Fixed sparse attention",
          loop="engine(mb); engine.backward(loss); engine.step()",
          dropout=DROPOUT_RATE, remat="dots_with_no_batch_dims_saveable",
          micro=micro, gas=gas, seq=t, dtype="bf16 on fp32 masters",
          steps=len(step_s), warmup=TRAIN_WARMUP,
          seconds=json.dumps([round(x, 4) for x in step_s]),
          step_s_best=round(best, 4), tokens_per_s=round(tokens / best, 1),
          mfu=round(tokens * sparse_fpt / best / PEAK_FLOPS["bfloat16"], 4),
          peak_mem_gib=round(peak, 2),
          vs_bert_train_tokens=round(tokens / best / ref["tokens_per_s"], 4)
          if ref else "not measured",
          vs_bert_train_peak=round(peak / ref["peak_mem_gib"], 4)
          if ref else "not measured",
          losses=json.dumps([round(x, 4) for x in losses]),
          launches_per_step=json.dumps(per_step),
          launches=json.dumps(launches))
    mb = {k: v[0] for k, v in batches[-1].items()}

    def micro_step():
        engine.backward(engine(mb))

    kernels = profile_micro(torch, micro_step, "profile bert train loop")
    k6 = launches_named(kernels, r"mma_sparse_fwd_kernel")
    drops = launches_named(kernels, r"threefry_dropout_kernel")
    phase("profile bert train loop launches", k6_per_micro=k6,
          dropout_per_micro=drops, want_k6=2 * n_layer)
    check(k6 == 2 * n_layer and drops > 0,
          f"profile of one micro step: K6 {k6} (want {2 * n_layer}: "
          f"forward + recompute), dropout kernel {drops}")
    del engine, model, batches
    torch.cuda.empty_cache()

    layers = BERT_SMALL_LAYERS
    # without dropout the user loop and train_batch share one update
    small = bert_batch(np, rng, gas, micro, t, 1000, cfg.vocab_size)
    small = {k: torch.as_tensor(v).cuda() for k, v in small.items()}
    masters = []
    for route in ("train_batch", "user loop"):
        m, _ = bert_model(torch, torch.float32, SEED + 44, layers)
        e = deepspeed_tpu_torch.initialize(model=m, config=config)[0]
        for _ in range(2):
            if route == "train_batch":
                e.train_batch(batch=small)
            else:
                user_loop_step(e, small)
        masters.append([p.detach().clone() for p in m.parameters()])
        del e, m
        torch.cuda.empty_cache()
    same = all(torch.equal(a, b) for a, b in zip(*masters))
    check(same, "dropout 0: two user-loop steps did not leave the masters "
          "bitwise those of two train_batch steps")
    phase("bert user loop vs train_batch", layers=layers, steps=2,
          dropout=0.0, masters_bitwise=same, leaves=len(masters[0]))
    del masters

    # dropout 0.1: remat on against off, then the kernel path against the
    # plain-kernel path, one micro batch on the same key
    key = prng.fold_in_words(prng.prng_key(SEED).tolist(), 7)
    one = {k: v[0][:1] for k, v in small.items()}
    out = {}
    for name, remat, plain in (("remat", True, False), ("no remat", False,
                                                         False),
                               ("plain kernels", True, True)):
        m, _ = bert_model(torch, torch.bfloat16, SEED + 45, layers)
        with_dropout(m, DROPOUT_RATE, remat=remat)
        if plain:
            with PlainSparseKernels():
                out[name] = grads_of(torch, m, one, rng=key)
        else:
            out[name] = grads_of(torch, m, one, rng=key)
        del m
        torch.cuda.empty_cache()
    grad_phase(torch, "bert loop remat vs no remat", out["remat"],
               out["no remat"], BERT_GRAD_TOL)
    phase("bert loop remat vs no remat bitwise",
          bitwise=bitwise(out["remat"], out["no remat"]))
    grad_phase(torch, "bert loop vs plain-kernel path", out["remat"],
               out["plain kernels"], BERT_GRAD_TOL)
    del out
    torch.cuda.empty_cache()

    m, _ = bert_model(torch, torch.float32, SEED + 46, layers)
    with_dropout(m, DROPOUT_RATE)
    e = deepspeed_tpu_torch.initialize(
        model=m, config=dict(bert_train_config(BERT_CONVERGE_LR, 1, micro),
                             activation_checkpointing={}))[0]
    batch = bert_batch(np, rng, 1, micro, t, 1000, 1256)
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    losses = [float(user_loop_step(e, batch)["loss"])
              for _ in range(CONVERGE_STEPS)]
    check(losses[-1] < CONVERGE_FRACTION * losses[0],
          f"bert loop loss on a repeated batch went {losses[0]} -> "
          f"{losses[-1]}, want below {CONVERGE_FRACTION} x the first")
    phase("bert train loop converges", layers=layers, steps=CONVERGE_STEPS,
          lr=BERT_CONVERGE_LR, dropout=DROPOUT_RATE,
          losses=json.dumps([round(x, 4) for x in losses]),
          threshold=f"last < {CONVERGE_FRACTION} x first")
    del e, m
    torch.cuda.empty_cache()
    return launches


def llama_params(cfg, layers):
    """Parameters of LLaMA-7B's width at ``layers`` layers."""
    d, m = cfg.n_embd, cfg.intermediate
    per_layer = d * (cfg.n_head + 2 * cfg.kv_head_count) * cfg.head_dim + \
        d * d + 3 * d * m + 2 * d
    return layers * per_layer + 2 * cfg.padded_vocab * d + d


def llama_train_remat(torch):
    """LLaMA-7B's width trained through ``train_batch`` (micro 4, T 2048,
    gas 2, bf16 on fp32 masters, AdamW) with activation checkpointing: at
    4 layers with remat off, the default policy and full recompute
    (``partition_activations``), tokens/s and peak memory, K3 launched
    again in each recompute, gradients against remat off; a profile of the
    default policy's step. Then the depth that only remat makes fit, from
    REMAT_BYTES_PER_PARAM and the 4-layer peaks, trained with the default
    policy. Returns the launches of its main-path steps."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LLAMA_7B
    t, gas, micro = LLAMA_T, LLAMA_GAS, LLAMA_MICRO
    cfg = dataclasses.replace(LLAMA_7B, n_layer=LLAMA_TRAIN_LAYERS)
    rng = np.random.default_rng(SEED + 14)
    batches = [{"input_ids": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (gas, micro, t), dtype=np.int64)).cuda()}
        for _ in range(1 + REMAT_TIMED)]
    total = torch.cuda.get_device_properties(0).total_memory
    policies = {"off": None, "default": {},
                "full": {"partition_activations": True}}
    res, launches = {}, {"K3": 0, "K3b/K5": 0}
    for name, block in policies.items():
        config = llama_train_config(1e-4, gas)
        if block is not None:
            config["activation_checkpointing"] = block
        model = llama_model(torch, cfg, SEED + 13, torch.float32)
        engine = deepspeed_tpu_torch.initialize(model=model, config=config)[0]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        step_s, per_step, _ = run_steps(
            torch, lambda b: engine.train_batch(batch=b), batches)
        got = counts()
        launches = {k: launches[k] + got[k] for k in launches}
        recompute = 2 if block is not None else 1
        want = [cfg.n_layer * gas * recompute, cfg.n_layer * gas]
        check(all([n["K3"], n["K3b/K5"]] == want for n in per_step),
              f"llama remat {name}: K3 forward/backward launched "
              f"{[[n['K3'], n['K3b/K5']] for n in per_step]} a step, want "
              f"{want}")
        best = min(step_s[1:])
        res[name] = {"tokens_per_s": gas * micro * t / best,
                     "peak": torch.cuda.max_memory_allocated(),
                     "k3_per_step": per_step[-1]["K3"]}
        if name == "default":
            kernels = profile_train(torch, engine, batches[-1],
                                    name="profile llama train remat")
            k3 = launches_named(kernels, r"mma_fwd_kernel")
            phase("profile llama train remat launches", k3_per_step=k3,
                  want=2 * cfg.n_layer * gas)
            check(k3 == 2 * cfg.n_layer * gas,
                  f"profile of a remat step: K3 {k3}, want "
                  f"{2 * cfg.n_layer * gas} (forward + recompute)")
        del engine, model
        torch.cuda.empty_cache()
    static4 = REMAT_BYTES_PER_PARAM * llama_params(cfg, cfg.n_layer)
    act = {k: (v["peak"] - static4) / cfg.n_layer for k, v in res.items()}
    phase("llama train remat", model=f"LLAMA_7B width, {cfg.n_layer} layers",
          micro=micro, gas=gas, seq=t, dtype="bf16 on fp32 masters",
          tokens_per_s=json.dumps({k: round(v["tokens_per_s"], 1)
                                   for k, v in res.items()}),
          peak_mem_gib=json.dumps({k: round(v["peak"] / 2 ** 30, 2)
                                   for k, v in res.items()}),
          k3_per_step=json.dumps({k: v["k3_per_step"]
                                  for k, v in res.items()}),
          static_gib=round(static4 / 2 ** 30, 2),
          activation_gib_per_layer=json.dumps(
              {k: round(v / 2 ** 30, 3) for k, v in act.items()}))

    # gradients of one bf16 micro batch: each policy against remat off
    mb = {"input_ids": batches[-1]["input_ids"][0]}
    grads = {}
    for name, policy in (("off", None), ("default",
                                         "dots_with_no_batch_dims_saveable"),
                         ("full", "nothing_saveable")):
        m = llama_model(torch, cfg, SEED + 13, torch.bfloat16)
        if policy is not None:
            m.config = dataclasses.replace(m.config, remat=True,
                                           remat_policy=policy)
        grads[name] = grads_of(torch, m, mb)
        del m
        torch.cuda.empty_cache()
    for name in ("default", "full"):
        grad_phase(torch, f"llama remat {name} vs off", grads[name],
                   grads["off"], LLAMA_GRAD_TOL)
    phase("llama remat bitwise",
          default=bitwise(grads["default"], grads["off"]),
          full=bitwise(grads["full"], grads["off"]))
    del grads
    torch.cuda.empty_cache()

    # the depth only remat makes fit: the deepest the default policy's
    # per-layer cost fits in REMAT_FILL of the card, where remat off's
    # per-layer cost would not
    def predicted(layers, policy):
        return REMAT_BYTES_PER_PARAM * llama_params(cfg, layers) + \
            layers * act[policy]
    depth = max(n for n in range(1, LLAMA_7B.n_layer + 1)
                if predicted(n, "default") <= REMAT_FILL * total)
    deep = dataclasses.replace(LLAMA_7B, n_layer=depth)
    model = llama_model(torch, deep, SEED + 15, torch.float32)
    engine = deepspeed_tpu_torch.initialize(
        model=model, config=dict(llama_train_config(1e-4, gas),
                                 activation_checkpointing={}))[0]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_s, per_step, losses = run_steps(
        torch, lambda b: engine.train_batch(batch=b), batches)
    got = counts()
    launches = {k: launches[k] + got[k] for k in launches}
    check(all(n["K3"] == 2 * depth * gas for n in per_step) and
          all(np.isfinite(losses)),
          f"llama deep remat: K3 {[n['K3'] for n in per_step]} a step "
          f"(want {2 * depth * gas}), losses {losses}")
    best = min(step_s[1:])
    tokens = gas * micro * t
    fpt = model.flops_per_token(t)
    peak = torch.cuda.max_memory_allocated()
    phase("llama train remat deep", model=f"LLAMA_7B width, {depth} layers",
          params=model.num_params(), policy="dots_with_no_batch_dims_saveable",
          micro=micro, gas=gas, seq=t,
          seconds=json.dumps([round(x, 4) for x in step_s]),
          tokens_per_s=round(tokens / best, 1),
          mfu=round(tokens * fpt / best / PEAK_FLOPS["bfloat16"], 4),
          peak_mem_gib=round(peak / 2 ** 30, 2),
          predicted_gib=round(predicted(depth, "default") / 2 ** 30, 2),
          predicted_off_gib=round(predicted(depth, "off") / 2 ** 30, 2),
          card_gib=round(total / 2 ** 30, 2),
          fits_without_remat=predicted(depth, "off") <= total,
          losses=json.dumps([round(x, 4) for x in losses]))
    del engine, model
    torch.cuda.empty_cache()
    return launches


def gpt2_train_loop(torch):
    """GPT-2-125M in bench.py's configuration (micro 8, T 1024, gas 4)
    with GPT-2's published dropout 0.1, progressive layer drop (GPT2_PLD:
    theta 0.5, gamma 0.1) and random-LTD on DeepSpeed's GPT example
    schedule, through the user loop: theta, kept tokens and skipped layers
    a step; the model's coins and indices against a plain draw on the
    card; the kernel path against the plain path on the same keys; a
    repeated batch. Dropping, the attention takes the plain path (as the
    JAX package leaves its packed kernel), so this path's kernel is the
    dropout kernel. Returns the loop's launches."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import prng
    from deepspeed_tpu_torch.models import gpt2 as gpt2_mod
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, GPT2_125M
    from deepspeed_tpu_torch.ops import dropout as drop
    from deepspeed_tpu_torch.ops.kernels import threefry_dropout as tfd
    cfg = dataclasses.replace(GPT2_125M, dropout=DROPOUT_RATE)
    t, gas, micro = 1024, TRAIN_GAS, TRAIN_MICRO
    config = dict(train_config(1e-4, gas), progressive_layer_drop=GPT2_PLD,
                  data_efficiency=GPT2_LTD)
    model = GPT2Model(cfg, generator=torch.Generator().manual_seed(SEED))
    engine = deepspeed_tpu_torch.initialize(model=model, config=config)[0]
    rng = np.random.default_rng(SEED + 5)
    batches = [{"input_ids": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (gas, micro, t), dtype=np.int64)).cuda()}
        for _ in range(TRAIN_WARMUP + TRAIN_TIMED)]
    # record the model's host draws: coins (layer, kept) and indices
    draws = []
    real_coin, real_idx = prng.bernoulli_scalar, gpt2_mod.sample_token_indices

    def coin(key, p):
        kept = real_coin(key, p)
        draws.append(("coin", key, float(p), kept))
        return kept

    def indices(key, keep, b, seq, first_row=0):
        idx = real_idx(key, keep, b, seq, first_row)
        draws.append(("idx", key, (keep, b, seq, first_row), idx))
        return idx

    prng.bernoulli_scalar, gpt2_mod.sample_token_indices = coin, indices
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        thetas, keeps, skipped = [], [], []

        def step(b):
            start = len(draws)
            loss = user_loop_step(engine, b)["loss"]
            theta, keep = engine._last_modifiers
            thetas.append(float(theta))
            keeps.append(keep)
            skipped.append(sum(1 for d in draws[start:]
                               if d[0] == "coin" and not d[3]))
            return loss

        step_s, per_step, losses = run_steps(torch, step, batches)
    finally:
        prng.bernoulli_scalar, gpt2_mod.sample_token_indices = \
            real_coin, real_idx
    launches = counts()
    coins = [d for d in draws if d[0] == "coin"]
    n_kept = sum(1 for d in coins if d[3])
    check(len(coins) == len(batches) * gas * cfg.n_layer,
          f"{len(coins)} layer coins, want one a layer and micro step")
    # forward and backward: the embeddings' dropout and three a kept layer
    want_drop = 2 * (len(batches) * gas + 3 * n_kept)
    check(launches["dropout"] == want_drop and launches["K1"] == 0 and
          launches["K3"] == 0,
          f"gpt2 loop launched {launches}, want dropout {want_drop} (2 x "
          f"(micro steps + 3 x kept layers)), K1 and K3 0 (dropping leaves "
          f"the packed path)")
    # the host's draws against a plain draw on the card: the tensor-path
    # bernoulli and permutation of the same keys
    plain_ok, checked = True, 0
    for d in draws:
        if d[0] == "coin":
            again = prng.bernoulli(prng.key_tensor(d[1], "cuda"), d[2],
                                   ()).item()
            plain_ok &= again == d[3]
        else:
            keep, b, seq, first = d[2]
            keys = prng.key_tensor(torch.tensor(prng.split_words(d[1], b,
                                                                 first)),
                                   "cuda")
            again = prng.permutation(keys, seq)[:, :keep].sort(dim=1).values
            plain_ok &= torch.equal(again.cpu(), d[3])
        checked += 1
    check(plain_ok, "the model's layer coins or kept-token indices differ "
          "from the plain draw on the card")
    tokens = gas * micro * t
    best = min(step_s[TRAIN_WARMUP:])
    phase("gpt2 train loop", model="GPT2_125M", dropout=DROPOUT_RATE,
          pld=json.dumps(GPT2_PLD), ltd=json.dumps(GPT2_LTD["data_routing"]
                                                   ["random_ltd"]
                                                   ["random_ltd_schedule"]),
          micro=micro, gas=gas, seq=t, dtype="bf16 on fp32 masters",
          steps=len(step_s), warmup=TRAIN_WARMUP,
          seconds=json.dumps([round(x, 4) for x in step_s]),
          tokens_per_s=round(tokens / best, 1),
          theta_per_step=json.dumps([round(x, 6) for x in thetas]),
          keep_per_step=json.dumps(keeps),
          layers_skipped_per_step=json.dumps(skipped),
          layer_runs=f"{n_kept} of {len(coins)}",
          draws_checked=checked, draws_equal_plain=plain_ok,
          losses=json.dumps([round(x, 4) for x in losses]),
          launches_per_step=json.dumps(per_step),
          launches=json.dumps(launches),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
    # after the launch counts were read: one micro step's device time
    mb = {"input_ids": batches[-1]["input_ids"][0]}
    profile_micro(torch, lambda: engine.backward(engine(mb)),
                  "profile gpt2 train loop")
    del engine, model
    torch.cuda.empty_cache()

    # the kernel path against the plain path on the same keys, one micro
    # batch with the step-0 modifiers
    key = prng.fold_in_words(prng.prng_key(SEED).tolist(), 11)
    kw = {"rng": key, "pld_theta": np.float32(thetas[0]),
          "ltd_keep": keeps[0]}
    out = {}
    for route in ("kernel", "plain"):
        m = GPT2Model(cfg, generator=torch.Generator().manual_seed(SEED))
        m = m.to("cuda", torch.bfloat16)
        if route == "plain":
            drop.threefry_dropout = tfd.threefry_dropout_plain
        try:
            out[route] = grads_of(torch, m, mb, **kw)
        finally:
            drop.threefry_dropout = tfd.threefry_dropout
        del m
    grad_phase(torch, "gpt2 loop vs plain path", out["kernel"], out["plain"],
               TRAIN_GRAD_TOL)
    phase("gpt2 loop vs plain path bitwise",
          bitwise=bitwise(out["kernel"], out["plain"]))
    del out
    torch.cuda.empty_cache()

    m = GPT2Model(cfg, generator=torch.Generator().manual_seed(SEED))
    e = deepspeed_tpu_torch.initialize(
        model=m, config=dict(train_config(1e-3, 1),
                             progressive_layer_drop=GPT2_PLD,
                             data_efficiency=GPT2_LTD))[0]
    batch = {"input_ids": torch.as_tensor(rng.integers(
        0, 256, (1, micro, t))).cuda()}
    losses = [float(user_loop_step(e, batch)["loss"])
              for _ in range(CONVERGE_STEPS)]
    check(losses[-1] < CONVERGE_FRACTION * losses[0],
          f"gpt2 loop loss on a repeated batch went {losses[0]} -> "
          f"{losses[-1]}, want below {CONVERGE_FRACTION} x the first")
    phase("gpt2 train loop converges", steps=CONVERGE_STEPS, lr=1e-3,
          losses=json.dumps([round(x, 4) for x in losses]),
          threshold=f"last < {CONVERGE_FRACTION} x first")
    del e, m
    torch.cuda.empty_cache()
    return launches


def serve_traffic(np, spec, vocab, seed):
    """``[(prompt, SamplingParams kwargs)]`` of one serving run: lognormal
    lengths clipped to their ranges, a quarter sampled with their own
    seeds, and the last request filling ``max_model_len``."""
    rng = np.random.default_rng(seed)
    n, max_len = spec["requests"], spec["cfg"]["max_model_len"]

    def lengths(median, lo, hi):
        return np.clip(np.round(median * np.exp(
            SERVE_SIGMA * rng.standard_normal(n))), lo, hi).astype(int)

    prompts, news = lengths(*spec["prompt"]), lengths(*spec["new"])
    news[-1] = spec["new"][2]
    prompts[-1] = max_len - news[-1]
    traffic = []
    for i in range(n):
        kw = dict(max_new_tokens=int(news[i]))
        if i % 4 == 1:
            kw.update(temperature=0.8, top_p=0.95, seed=SEED + i)
        traffic.append((rng.integers(0, vocab, int(prompts[i])), kw))
    return traffic


def serve_run(torch, engine, cfg, traffic, order=None, on_tick=None,
              on_start=None):
    """Submit ``traffic`` (in ``order``) at tick 0 and tick until idle,
    calling ``on_start(srv)`` first and ``on_tick(srv)`` after each tick.
    Returns the token lists and the requests in traffic order (None for a
    request not in ``order``), the mean slot utilization over the ticks,
    the ticks, the wall seconds and the serving engine (not shut
    down)."""
    from deepspeed_tpu_torch.serving import SamplingParams, ServingEngine
    srv = ServingEngine(engine, cfg)
    if on_start is not None:
        on_start(srv)
    order = list(range(len(traffic))) if order is None else order
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    rids = {i: srv.submit(traffic[i][0], SamplingParams(**traffic[i][1]))
            for i in order}
    util, ticks = [], 0
    while srv.step():
        util.append(srv.active_requests / srv.config.num_slots)
        ticks += 1
        if on_tick is not None:
            on_tick(srv)
    wall = time.perf_counter() - s0
    reqs = [srv.result(rids[i]) if i in rids else None
            for i in range(len(traffic))]
    return ([None if r is None else list(r.tokens) for r in reqs], reqs,
            sum(util) / max(1, len(util)), ticks + 1, wall, srv)


def greedy_vs_forward(torch, engine, traffic, reqs, vocab, margin):
    """Each greedy stream against the plain full forward (the model's
    attention switched to the plain path) of its prompt and tokens: the
    argmax must equal the served token wherever the top-2 gap exceeds
    ``margin``. Returns the positions checked and, by request, where the
    gap exceeds the margin (the clear positions)."""
    model = engine.module
    cfg = model.config
    model.config = dataclasses.replace(cfg, attn_backend="xla")
    checked = wrong = 0
    clear_at = {}
    try:
        for i, ((prompt, kw), req) in enumerate(zip(traffic, reqs)):
            if kw.get("temperature"):
                continue
            ids = torch.as_tensor(req.output_ids[None, :-1].astype("int64"))
            t = len(prompt)
            full = engine(ids)[0, t - 1:, :vocab].float()
            top2 = full.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > margin
            got = torch.as_tensor(req.tokens, device=full.device)
            checked += int(clear.sum())
            wrong += int(((full.argmax(-1) != got) & clear).sum())
            clear_at[i] = clear.cpu().tolist()
    finally:
        model.config = cfg
    check(checked > 0 and wrong == 0,
          f"served greedy tokens disagree with the plain full forward at "
          f"{wrong} of {checked} clear positions")
    return checked, clear_at


def parted_at(chunked, mono):
    """The first position where a chunked-prefill stream and the
    monolithic one differ, or None."""
    return next((j for j, (a, b) in enumerate(zip(chunked, mono))
                 if a != b), None)


def profile_decode_tick(torch, engine, pool, positions, name):
    """One fused decode step over every slot (``slot_decode_step``) under
    torch.profiler: device time by group and the idle share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    n = pool["k"].shape[1]
    toks = np.zeros((n,), np.int32)
    temps = np.zeros((n,), np.float32)
    engine.slot_decode_step(pool, toks, positions, temps)    # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        engine.slot_decode_step(pool, toks, positions, temps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - s0) * 1e3
    report_profile(name, prof, wall_ms, top=10)


def quantile(vals, f):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(f * len(vals)))] if vals else None


def request_latency(reqs):
    """``(TTFT ms, TPOT ms)`` lists of finished requests: submit to first
    token, and the decode time over the tokens after the first."""
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in reqs]
    tpot = [(r.finish_time - r.first_token_time) * 1e3 / (len(r.tokens) - 1)
            for r in reqs if len(r.tokens) > 1]
    return ttft, tpot


def serve_phase(torch, name, engine, spec, margin, seed):
    """The serve path: ``ServingEngine(engine, spec["cfg"])`` over the
    traffic, with its checks and metrics (one phase line), a profiled
    decode tick, the replay and chunked-prefill runs."""
    import numpy as np
    from deepspeed_tpu_torch.serving.kv_slots import tree_nbytes
    cfg = spec["cfg"]
    vocab = engine.module.config.vocab_size
    traffic = serve_traffic(np, spec, vocab, seed)
    torch.cuda.reset_peak_memory_stats()
    streams, reqs, util, ticks, wall, srv = serve_run(torch, engine, cfg,
                                                      traffic)
    states = {r.state.value for r in reqs}
    check(states == {"finished"}, f"{name}: request states {states}")
    check(all(len(r.tokens) == kw["max_new_tokens"]
              for (_, kw), r in zip(traffic, reqs)),
          f"{name}: a request stopped short of its max_new_tokens")
    check(srv.decode_executables() == 1,
          f"{name}: {srv.decode_executables()} decode shapes ran")
    pool = srv.scheduler.pool.cache
    check(all(t.device.type == "cuda" for t in pool.values()),
          f"{name}: the KV pool is not on the card")
    pool_gib = tree_nbytes(pool) / 2 ** 30
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    pct = srv.metrics.percentiles()
    tokens = sum(len(t) for t in streams)
    _, tpot = request_latency(reqs)
    profile_decode_tick(torch, engine, pool, np.full(
        (cfg["num_slots"],), int(np.median([len(p) for p, _ in traffic])),
        np.int32), f"profile {name}")
    srv.shutdown()
    del srv, pool
    torch.cuda.empty_cache()
    checked, clear_at = greedy_vs_forward(torch, engine, traffic, reqs,
                                          vocab, margin)

    # replay: two greedy and two sampled requests, in reverse order behind
    # two others, so they land on other slots and ticks
    greedy = [i for i, (_, kw) in enumerate(traffic)
              if not kw.get("temperature")][:2]
    sampled = [i for i, (_, kw) in enumerate(traffic)
               if kw.get("temperature")][:2]
    replay = greedy + sampled
    fill = [i for i in range(len(traffic)) if i not in replay][:2]
    again, *_rest, srv2 = serve_run(torch, engine, cfg, traffic,
                                    order=fill + replay[::-1])
    srv2.shutdown()
    del srv2
    torch.cuda.empty_cache()
    check(all(again[i] == streams[i] for i in replay),
          f"{name}: replayed requests {replay} came back different")

    # chunked prefill: 8 greedy prompts longer than a chunk
    long = [i for i, (p, kw) in enumerate(traffic)
            if not kw.get("temperature") and len(p) > SERVE_CHUNK][:8]
    sub = [(traffic[i][0], dict(max_new_tokens=min(
        SERVE_CHUNKED_NEW, traffic[i][1]["max_new_tokens"]))) for i in long]
    chunked, chunked_reqs, *_rest, srv3 = serve_run(
        torch, engine, {**cfg, "chunked_prefill": {
            "enabled": True, "chunk_tokens": SERVE_CHUNK}}, sub)
    chunk_shapes = engine.slot_chunk_executables(
        cfg["num_slots"], cfg["max_model_len"], SERVE_CHUNK)
    srv3.shutdown()
    del srv3
    torch.cuda.empty_cache()
    # each chunked stream is a right greedy decode of its own prefix, and
    # parts from the monolithic one only at a token whose top-2 gap (the
    # plain forward of the monolithic stream) is within the margin: a
    # chunk's bf16 products run at other GEMM shapes than the whole
    # prompt's, so its K/V may round a step apart from the monolithic
    # K/V, which moves only near-tied tokens (the f32 CPU tests hold the
    # streams bitwise equal)
    chunk_checked, _ = greedy_vs_forward(torch, engine, sub, chunked_reqs,
                                         vocab, margin)
    parts = {i: parted_at(chunked[k], streams[i]) for k, i in enumerate(long)}
    bad = {i: j for i, j in parts.items()
           if j is not None and clear_at[i][j]}
    check(len(long) == 8 and not bad and chunk_shapes == 1,
          f"{name}: chunked prefill streams part from the monolithic ones "
          f"at tokens whose top-2 gap exceeds the margin: {bad} (request: "
          f"position) of {long}; chunk shapes {chunk_shapes}")
    parted = {i: j for i, j in parts.items() if j is not None}
    phase(name, requests=len(traffic),
          sampled=sum(1 for _, kw in traffic if kw.get("temperature")),
          slots=cfg["num_slots"], max_model_len=cfg["max_model_len"],
          ticks=ticks, seconds=round(wall, 3), output_tokens=tokens,
          output_tokens_per_s=round(tokens / wall, 1),
          ttft_ms_p50=pct["ttft_ms"]["p50"], ttft_ms_p99=pct["ttft_ms"]["p99"],
          tpot_ms_p50=round(quantile(tpot, 0.5), 3),
          tpot_ms_p99=round(quantile(tpot, 0.99), 3),
          decode_tick_ms_p50=pct["tpot_ms"]["p50"],
          decode_tick_ms_p99=pct["tpot_ms"]["p99"],
          mean_slot_utilization=round(util, 4),
          pool_gib=round(pool_gib, 3), peak_mem_gib=round(peak_gib, 2),
          greedy_vs_forward_checked=checked, margin=margin,
          replayed=json.dumps(replay), replay_equal=True,
          chunked=json.dumps(long), chunk_tokens=SERVE_CHUNK,
          chunked_streams_equal=len(long) - len(parted),
          chunked_parted_at=json.dumps(parted),
          chunked_vs_forward_checked=chunk_checked,
          decode_executables=1, pool_device="cuda")


def plain_logits(torch, engine, ids):
    """``[T, vocab]`` float32 logits of the plain full forward (the model's
    attention on the plain path) of one sequence ``ids``."""
    import numpy as np
    model = engine.module
    cfg = model.config
    model.config = dataclasses.replace(cfg, attn_backend="xla")
    try:
        ids = torch.as_tensor(np.asarray(ids, "int64")[None])
        return engine(ids)[0, :, :cfg.vocab_size].float()
    finally:
        model.config = cfg


def tie_gap(torch, logits, kw, col, a, b):
    """How near a tie ``logits`` (one position's) puts tokens ``a`` and
    ``b``, in logit units: greedy, the gap of their logits. Sampled, the
    smallest of the gap of their perturbed scores (logits / T plus the
    Gumbel noise of the key ``(seed, col)``, ``col`` the column the token
    is fed at) times T, and, for either token at the edge of the top-k or
    top-p truncation, the logit change that moves it across the edge: a
    truncation edge is a tie too."""
    from deepspeed_tpu_torch.inference import prng
    from deepspeed_tpu_torch.inference.speculative import row_keys
    temp = kw.get("temperature", 0.0)
    if not temp:
        return abs(float(logits[a] - logits[b]))
    key = row_keys(torch.tensor([kw["seed"]]), torch.tensor([col]))[0]
    scores = logits / temp + prng.gumbel(key.to(logits.device),
                                         tuple(logits.shape))
    gaps = [abs(float(scores[a] - scores[b])) * temp]
    desc, order = torch.sort(logits, descending=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    top_k, top_p = kw.get("top_k", 0), kw.get("top_p", 1.0)
    for x in (a, b):
        r = int(rank[x])
        if top_k and r in (top_k - 1, top_k):
            gaps.append(float(desc[top_k - 1] - desc[top_k]))
        if top_p < 1.0:
            # mass before x (top-k survivors renormalised, as sample_rows
            # does); x leaves or joins the nucleus when drifts of +d on the
            # logits above it and -d below move that mass across top_p:
            # 2d = T |log(top_p (1 - m) / ((1 - top_p) m))|
            kept = desc[:top_k] if top_k else desc
            if r < kept.numel():
                probs = torch.softmax(kept / temp, dim=-1)
                m = float(probs[:r].sum())
                if m > 0:
                    gaps.append(temp * abs(math.log(
                        top_p * (1 - m) / ((1 - top_p) * m))))
    return min(gaps)


def part_gap(torch, engine, prompt, kw, tokens, j, other):
    """``tie_gap`` of position ``j`` of the stream ``tokens`` against the
    token ``other``, under the plain forward of the stream's prefix."""
    import numpy as np
    logits = plain_logits(torch, engine,
                          np.concatenate([prompt, tokens[:j]]))[-1]
    return tie_gap(torch, logits, kw, len(prompt) + j, tokens[j], other)


def rejection_gaps(torch, engine, traffic, reqs, verifies):
    """The ``tie_gap`` of every rejected proposal that fell inside its
    request's stream (``verifies``: ``(request index, position, drafts,
    targets, accepts)`` a slot a verify), under one plain forward of each
    stream: the target's token against the draft's."""
    import numpy as np
    gaps = []
    by_req = {}
    for i, pos, drafts, tgt, a in verifies:
        if a < len(drafts):
            by_req.setdefault(i, []).append((pos, drafts[a], tgt[a], a))
    for i, rejects in by_req.items():
        (prompt, kw), req = traffic[i], reqs[i]
        logits = None
        for pos, d, t, a in rejects:
            j = pos + 1 + a - len(prompt)       # the target token's index
            if j >= len(req.tokens):
                continue                        # past the request's end
            if logits is None:
                logits = plain_logits(torch, engine, req.output_ids[:-1])
            gaps.append(tie_gap(torch, logits[pos + a], kw, pos + 1 + a,
                                t, d))
    return gaps


def stream_parts(torch, name, engine, traffic, streams, base, margin):
    """Each stream against the base run's: equal, or parting at a position
    that the plain forward finds within ``margin`` of a tie (``part_gap``
    of the base stream's token against the other). Returns ``{request:
    [position, gap]}`` of the streams that part."""
    parted = {}
    for i, ((prompt, kw), got, want) in enumerate(zip(traffic, streams,
                                                      base)):
        check(len(got) == len(want), f"{name}: request {i} gave "
              f"{len(got)} tokens, the base run {len(want)}")
        j = parted_at(got, want)
        if j is not None:
            parted[i] = [j, round(part_gap(torch, engine, prompt, kw, want, j,
                                           got[j]), 4)]
    bad = {i: v for i, v in parted.items() if v[1] > margin}
    check(not bad, f"{name}: streams part from the base run at tokens that "
          f"are not near-ties (request: [position, gap]): {bad}, margin "
          f"{margin}")
    return parted


def profile_spec_tick(torch, engine, sched, positions, name):
    """One speculative tick over every slot (``slot_draft_propose`` and
    ``slot_verify_step``) under torch.profiler: device time by group and
    the idle share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    n = sched.pool.num_slots
    toks = np.zeros((n,), np.int32)
    temps = np.zeros((n,), np.float32)

    def tick():
        sched.draft_cache, drafts = engine.slot_draft_propose(
            sched.draft, sched.draft_cache, toks, positions, temps, None,
            None, None, SPEC_K)
        engine.slot_verify_step(sched.pool.cache, toks, drafts, positions,
                                temps)

    tick()                                                     # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - s0) * 1e3
    report_profile(name, prof, wall_ms, top=10)


def spec_phase(torch, name, engine, spec, margin, seed, drafts, profiled):
    """``spec``'s traffic served with speculation off, then with a self
    draft of each ``(label, layers)`` of ``drafts`` (k ``SPEC_K``), on one
    engine: one phase line a run, the draft of ``profiled`` layers
    profiled over one tick. Returns the traffic and the off streams."""
    import numpy as np
    from deepspeed_tpu_torch.serving.kv_slots import tree_nbytes
    cfg = spec["cfg"]
    n_slots, max_len = cfg["num_slots"], cfg["max_model_len"]
    vocab = engine.module.config.vocab_size
    traffic = serve_traffic(np, spec, vocab, seed)
    base = None
    for label, layers in (("off", None),) + tuple(drafts):
        run_cfg = dict(cfg)
        if layers is not None:
            run_cfg["speculative"] = {
                "enabled": True, "k": SPEC_K,
                "draft": {"mode": "self", "layers": layers}}
        walls = {"draft": [], "verify": []}

        def on_tick(srv):
            m = srv.metrics
            if m.spec_ticks > len(walls["draft"]):
                walls["draft"].append(m.spec_draft_ms)
                walls["verify"].append(m.spec_verify_ms)

        # the full-depth draft's verifies are recorded: each rejection
        # must be a near-tie (request ids are traffic indices here)
        verifies, live = [], {}
        full = layers == engine.module.config.n_layer
        if full:
            verify = engine.slot_verify_step

            def recorded(pool, toks, drafts, positions, *args):
                out = verify(pool, toks, drafts, positions, *args)
                slots = live["srv"].scheduler.pool
                for slot, req in enumerate(slots.requests):
                    if req is not None:
                        verifies.append((req.request_id, int(positions[slot]),
                                         list(drafts[slot]),
                                         list(out[1][slot]),
                                         int(out[2][slot])))
                return out

            engine.slot_verify_step = recorded
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            streams, reqs, util, ticks, wall, srv = serve_run(
                torch, engine, run_cfg, traffic, on_tick=on_tick,
                on_start=lambda srv: live.update(srv=srv))
        finally:
            if full:
                del engine.slot_verify_step
        states = {r.state.value for r in reqs}
        check(states == {"finished"}, f"{name} {label}: states {states}")
        check(all(len(r.tokens) == kw["max_new_tokens"]
                  for (_, kw), r in zip(traffic, reqs)),
              f"{name} {label}: a request stopped short of its "
              f"max_new_tokens")
        sched = srv.scheduler
        pools = [sched.pool.cache] + ([sched.draft_cache]
                                      if sched.draft_cache else [])
        check(all(t.device.type == "cuda" for pool in pools
                  for t in pool.values()),
              f"{name} {label}: a KV pool is not on the card")
        ttft, tpot = request_latency(reqs)
        tokens = sum(len(t) for t in streams)
        res = dict(run=label, draft_layers=layers, k=SPEC_K if layers else 0,
                   requests=len(traffic), slots=n_slots,
                   max_model_len=max_len, ticks=ticks,
                   seconds=round(wall, 3), output_tokens=tokens,
                   output_tokens_per_s=round(tokens / wall, 1),
                   ttft_ms_p50=round(quantile(ttft, 0.5), 3),
                   tpot_ms_p50=round(quantile(tpot, 0.5), 3),
                   tpot_ms_p99=round(quantile(tpot, 0.99), 3),
                   pool_gib=round(tree_nbytes(sched.pool.cache) / 2 ** 30, 3),
                   peak_mem_gib=round(torch.cuda.max_memory_allocated() /
                                      2 ** 30, 2))
        if layers is not None:
            m = srv.metrics
            verify = engine.slot_verify_executables(n_slots, max_len, SPEC_K)
            shapes = engine.slot_draft_executables(sched.draft, n_slots,
                                                   max_len, SPEC_K)
            check(verify == 1 and shapes == 1,
                  f"{name} {label}: {verify} verify and {shapes} draft "
                  f"shapes ran")
            # tokens a request gains a tick (spec_proposed is k x the
            # active requests summed over the ticks)
            res.update(acceptance=round(m.spec_accepted / m.spec_proposed, 4),
                       tokens_per_tick=round(
                           m.spec_emitted * SPEC_K / m.spec_proposed, 3),
                       spec_ticks=m.spec_ticks,
                       draft_ms_p50=round(quantile(walls["draft"], 0.5), 3),
                       verify_ms_p50=round(quantile(walls["verify"], 0.5), 3),
                       draft_pool_gib=round(
                           tree_nbytes(sched.draft_cache) / 2 ** 30, 3),
                       verify_shapes=verify, draft_shapes=shapes)
            if layers == profiled:
                profile_spec_tick(torch, engine, sched, np.full(
                    (n_slots,), int(np.median([len(p) for p, _ in traffic])),
                    np.int32), f"profile {name} {label}")
        srv.shutdown()
        del srv, sched, pools
        torch.cuda.empty_cache()
        res["greedy_vs_forward_checked"], _ = greedy_vs_forward(
            torch, engine, traffic, reqs, vocab, margin)
        if base is None:
            base = streams
        else:
            parted = stream_parts(torch, f"{name} {label}", engine, traffic,
                                  streams, base, margin)
            res.update(streams_equal=len(traffic) - len(parted),
                       parted=json.dumps(parted), margin=margin)
        if full:
            gaps = rejection_gaps(torch, engine, traffic, reqs, verifies)
            worst = max(gaps, default=0.0)
            res.update(rejections=len(gaps),
                       rejection_gap_max=round(worst, 4))
            check(worst <= SPEC_REJECT_TIE * margin,
                  f"{name} {label}: a full-depth self draft's proposal was "
                  f"rejected where the plain forward puts the two tokens "
                  f"{worst} apart, above {SPEC_REJECT_TIE} x the margin "
                  f"{margin}")
        phase(name, **res)
    return traffic, base


def prefix_traffic(np, vocab, seed):
    """``PREFIX_COHORTS`` cohorts of ``PREFIX_PER_COHORT`` requests, the
    first ``PREFIX_COHORTS`` the leaders (one a cohort): each prompt its
    cohort's ``PREFIX_LEN``-token prefix and a lognormal suffix, each
    request ``PREFIX_NEW`` new tokens, a quarter sampled."""
    rng = np.random.default_rng(seed)
    n = PREFIX_COHORTS * PREFIX_PER_COHORT
    med, lo, hi = PREFIX_SUFFIX
    suffix = np.clip(np.round(med * np.exp(
        SERVE_SIGMA * rng.standard_normal(n))), lo, hi).astype(int)
    prefixes = [rng.integers(0, vocab, PREFIX_LEN)
                for _ in range(PREFIX_COHORTS)]
    traffic = []
    for i in range(n):
        kw = dict(max_new_tokens=PREFIX_NEW)
        if (i // PREFIX_COHORTS) % 4 == 1:
            kw.update(temperature=0.8, top_p=0.95, seed=SEED + i)
        traffic.append((np.concatenate([prefixes[i % PREFIX_COHORTS],
                                        rng.integers(0, vocab, suffix[i])]),
                        kw))
    return traffic


def prefix_run(torch, engine, cfg, traffic):
    """The leaders, run until they finish, then the followers. Returns the
    requests in traffic order, the prefix-cache hits' matched lengths and
    the serving engine (not shut down)."""
    from deepspeed_tpu_torch.serving import SamplingParams, ServingEngine
    srv = ServingEngine(engine, cfg)
    matched = []
    pc = srv.scheduler.prefix_cache
    if pc is not None:
        lookup = pc.lookup

        def recording(tokens):
            hit = lookup(tokens)
            if hit is not None:
                matched.append(hit.matched)
            return hit

        pc.lookup = recording
    rids = {}
    for batch in (range(PREFIX_COHORTS),
                  range(PREFIX_COHORTS, len(traffic))):
        rids.update({i: srv.submit(traffic[i][0],
                                   SamplingParams(**traffic[i][1]))
                     for i in batch})
        srv.run_until_idle()
    return [srv.result(rids[i]) for i in range(len(traffic))], matched, srv


def prefix_phase(torch, name, engine, cfg, margin, seed):
    """The prefix traffic with the radix cache and without, on one engine:
    hits, prefill tokens, the followers' TTFT, the streams."""
    import numpy as np
    traffic = prefix_traffic(np, engine.module.config.vocab_size, seed)
    runs = {}
    for label, run_cfg in (("off", cfg), ("on", {
            **cfg, "prefix_cache": {"enabled": True}})):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        reqs, matched, srv = prefix_run(torch, engine, run_cfg, traffic)
        wall = time.perf_counter() - s0
        states = {r.state.value for r in reqs}
        check(states == {"finished"}, f"{name} {label}: states {states}")
        check(all(t.device.type == "cuda"
                  for t in srv.scheduler.pool.cache.values()),
              f"{name} {label}: the KV pool is not on the card")
        pc = srv.scheduler.prefix_cache
        ttft, _ = request_latency(reqs[PREFIX_COHORTS:])
        runs[label] = dict(streams=[list(r.tokens) for r in reqs],
                           matched=matched, pc=pc, wall=wall, ttft=ttft,
                           cached=0 if pc is None else pc.cached_slots)
        srv.shutdown()
        del srv
        torch.cuda.empty_cache()
    on = runs["on"]
    pc = on["pc"]
    check(pc.hits > 0 and pc.hits == len(on["matched"]) and
          min(on["matched"]) >= PREFIX_LEN,
          f"{name}: {pc.hits} hits, matched {on['matched']}, each must "
          f"match at least {PREFIX_LEN}")
    parted = stream_parts(torch, name, engine, traffic, on["streams"],
                          runs["off"]["streams"], margin)
    prompt_tokens = sum(len(p) for p, _ in traffic)
    phase(name, requests=len(traffic), cohorts=PREFIX_COHORTS,
          prefix=PREFIX_LEN, slots=cfg["num_slots"],
          max_model_len=cfg["max_model_len"], hits=pc.hits,
          lookups=pc.lookups, hit_rate=round(pc.hit_rate, 4),
          matched_min=min(on["matched"]), evictions=pc.evictions,
          prefill_tokens_off=prompt_tokens,
          prefill_tokens_on=prompt_tokens - pc.tokens_saved,
          followers_ttft_ms_p50_off=round(quantile(runs["off"]["ttft"], 0.5),
                                          3),
          followers_ttft_ms_p99_off=round(quantile(runs["off"]["ttft"],
                                                   0.99), 3),
          followers_ttft_ms_p50_on=round(quantile(on["ttft"], 0.5), 3),
          followers_ttft_ms_p99_on=round(quantile(on["ttft"], 0.99), 3),
          seconds_off=round(runs["off"]["wall"], 3),
          seconds_on=round(on["wall"], 3), cached_slots_end=on["cached"],
          streams_equal=len(traffic) - len(parted),
          parted=json.dumps(parted), margin=margin, pool_device="cuda")


def disagg_phase(torch, name, engine, traffic, base, margin, cfg=None):
    """A prefill engine (``DISAGG_PREFILL_SLOTS`` slots) whose sink sends
    each handoff through the wire codec (``to_bytes`` / ``from_bytes``) to
    a decode engine (``cfg``, by default ``serve spec``'s) over the same
    InferenceEngine, on ``traffic``; each inserted lane is held to the
    extracted one (at tp > 1 the rank's heads of it) and each stream to
    the unified ``base``."""
    from deepspeed_tpu_torch.serving import SamplingParams, ServingEngine
    from deepspeed_tpu_torch.serving.fleet import KVHandoff
    cfg = SERVE_SPEC["cfg"] if cfg is None else cfg
    ms = {"out": [], "codec": [], "in": []}
    sent, equal, nbytes = {}, [], []
    extract, insert = engine.slot_extract_lane, engine.slot_insert_lane

    def timed_extract(pool, slot):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        lane = extract(pool, slot)
        ms["out"].append((time.perf_counter() - s0) * 1e3)
        return lane

    def checked_insert(pool, slot, lane):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        pool = insert(pool, slot, lane)
        torch.cuda.synchronize()
        ms["in"].append((time.perf_counter() - s0) * 1e3)
        orig, kv_len = sent.pop(id(lane))
        if engine.tp.active:            # the rank's heads of the lane
            orig = {n: engine.module.kv_split(t.shape).take(t)
                    for n, t in orig.items()}
        equal.append(all(torch.equal(
            c[:, slot, :, :kv_len],
            orig[n][:, 0, :, :kv_len].to(c.device)) for n, c in pool.items()))
        return pool

    dec = ServingEngine(engine, {**cfg, "role": "decode"})

    def sink(handoff, request):
        s0 = time.perf_counter()
        wired = KVHandoff.from_bytes(handoff.to_bytes())
        ms["codec"].append((time.perf_counter() - s0) * 1e3)
        nbytes.append(handoff.nbytes())
        sent[id(wired.lane)] = (handoff.lane, handoff.kv_len)
        dec.submit_handoff(wired, request)

    engine.slot_extract_lane = timed_extract
    engine.slot_insert_lane = checked_insert
    try:
        pre = ServingEngine(engine, {**cfg, "role": "prefill",
                                     "num_slots": DISAGG_PREFILL_SLOTS},
                            handoff_sink=sink)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        rids = [pre.submit(p, SamplingParams(**kw)) for p, kw in traffic]
        while pre.step() + dec.step():
            pass
        wall = time.perf_counter() - s0
    finally:
        del engine.slot_extract_lane, engine.slot_insert_lane
    reqs = [pre.result(r) for r in rids]
    states = {r.state.value for r in reqs}
    check(states == {"finished"}, f"{name}: states {states}")
    check(len(equal) == len(traffic) and all(equal),
          f"{name}: {equal.count(False)} of {len(equal)} inserted lanes "
          f"differ from the extracted ones")
    check(pre.metrics.handoffs_out == dec.metrics.handoffs_in == len(traffic)
          and pre.metrics.completed == 0,
          f"{name}: {pre.metrics.handoffs_out} handed off, "
          f"{dec.metrics.handoffs_in} received")
    tick_p50 = dec.metrics.percentiles()["tpot_ms"]["p50"]
    pre.shutdown()
    dec.shutdown()
    del pre, dec
    torch.cuda.empty_cache()
    streams = [list(r.tokens) for r in reqs]
    parted = stream_parts(torch, name, engine, traffic, streams, base,
                          margin)
    ttft, tpot = request_latency(reqs)
    tokens = sum(len(t) for t in streams)
    phase(name, requests=len(traffic), prefill_slots=DISAGG_PREFILL_SLOTS,
          decode_slots=cfg["num_slots"], max_model_len=cfg["max_model_len"],
          seconds=round(wall, 3), output_tokens_per_s=round(tokens / wall, 1),
          handoff_mib=round(quantile(nbytes, 0.5) / 2 ** 20, 1),
          out_ms_p50=round(quantile(ms["out"], 0.5), 3),
          codec_ms_p50=round(quantile(ms["codec"], 0.5), 3),
          in_ms_p50=round(quantile(ms["in"], 0.5), 3),
          lanes_equal=sum(equal), ttft_ms_p50=round(quantile(ttft, 0.5), 3),
          tpot_ms_p50=round(quantile(tpot, 0.5), 3),
          decode_tick_ms_p50=tick_p50,
          streams_equal_unified=len(traffic) - len(parted),
          parted=json.dumps(parted), margin=margin)


def serve_llama(torch, cfg=None):
    """LLaMA-7B at full width and SERVE_LAYERS layers, bf16, served through
    ``ServingEngine(init_inference(model, {"dtype": "bf16"}), ...)``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LLAMA_7B
    cfg = dataclasses.replace(LLAMA_7B, n_layer=SERVE_LAYERS) \
        if cfg is None else cfg
    engine = deepspeed_tpu_torch.init_inference(
        llama_model(torch, cfg, SEED + 70, torch.bfloat16), {"dtype": "bf16"})
    serve_phase(torch, "serve", engine, SERVE_LLAMA, LLAMA_ARGMAX_MARGIN,
                SEED + 71)
    layers = engine.module.config.n_layer
    user = max(1, layers // 4)
    traffic, base = spec_phase(torch, "serve spec", engine, SERVE_SPEC,
                               LLAMA_ARGMAX_MARGIN, SEED + 71,
                               (("full", layers), ("user", user)), user)
    prefix_phase(torch, "serve prefix", engine, SERVE_LLAMA["cfg"],
                 LLAMA_ARGMAX_MARGIN, SEED + 74)
    disagg_phase(torch, "serve disagg", engine, traffic, base,
                 LLAMA_ARGMAX_MARGIN)
    del engine
    torch.cuda.empty_cache()


def serve_gpt2(torch, cfg=None):
    """GPT-2-125M served the same way, 8 slots x 1024."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, GPT2_125M
    cfg = GPT2_125M if cfg is None else cfg
    model = GPT2Model(cfg, generator=torch.Generator().manual_seed(SEED + 72))
    engine = deepspeed_tpu_torch.init_inference(model, {"dtype": "bf16"})
    serve_phase(torch, "serve gpt2", engine, SERVE_GPT2, ARGMAX_MARGIN,
                SEED + 73)
    user = max(1, cfg.n_layer // 2)
    spec_phase(torch, "serve spec gpt2", engine, SERVE_SPEC_GPT2,
               ARGMAX_MARGIN, SEED + 75, (("user", user),), None)
    del engine, model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- slice 8

def rss_bytes():
    """This process's resident set (``VmRSS``), bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


class RssPeak:
    """A thread samples ``VmRSS`` every 5 ms inside the ``with`` block;
    ``gib`` is the peak less the value before it, and ``seconds`` the
    block's wall time."""

    def __enter__(self):
        import threading
        self.base = self.peak = rss_bytes()
        self.stop = threading.Event()

        def sample():
            while not self.stop.wait(0.005):
                self.peak = max(self.peak, rss_bytes())
        self.thread = threading.Thread(target=sample, daemon=True)
        self.thread.start()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        self.stop.set()
        self.thread.join(timeout=10)
        self.peak = max(self.peak, rss_bytes())
        self.gib = (self.peak - self.base) / 2 ** 30


def host_staging_bound(name, host_gib, tag_bytes, largest, dp):
    """A load stages this rank's parts of the tag in host memory, one
    leaf whole at a time: its host peak (GiB) may not pass the tag over
    ``dp`` plus the largest leaf, plus 2 % and 0.05 GiB for what else
    the process allocates. Returns the bound."""
    bound = (tag_bytes / dp + largest) / 2 ** 30 * 1.02 + 0.05
    check(host_gib <= bound, f"{name}: the load's host peak {host_gib:.3f} "
          f"GiB passes {bound:.3f} GiB (the tag over dp {dp} and one leaf)")
    return bound


def tag_layout(tag_dir):
    """``(largest leaf bytes, state-file bytes, chunked leaf paths)`` of a
    tag, from its files' structure (no data read)."""
    import os
    from deepspeed_tpu_torch.runtime.checkpoint_engine import msgpack_codec
    from deepspeed_tpu_torch.runtime.checkpoint_engine.msgpack_codec import \
        _itemsize
    largest, total, chunked = 0, 0, []
    for name in ("model_states.msgpack", "optim_states.msgpack"):
        path = os.path.join(tag_dir, name)
        total += os.path.getsize(path)
        with open(path, "rb") as f:
            leaves, paths = msgpack_codec.describe(f)
        chunked += [f"{name.split('.')[0]}:{p}" for p in paths]
        largest = max([largest] + [math.prod(shape) * _itemsize(dt)
                                   for shape, dt in leaves.values()])
    return largest, total, chunked


def io_fields(prefix, rss, bytes_, hash_s, seconds=None):
    seconds = rss.seconds if seconds is None else seconds
    return {f"{prefix}_s": round(seconds, 3),
            f"{prefix}_gb_per_s": round(bytes_ / seconds / 1e9, 3),
            f"{prefix}_hash_share": round(hash_s / seconds, 4),
            f"{prefix}_host_gib": round(rss.gib, 3)}


def state_of(engine):
    """Masters, mu and nu of an engine, in order."""
    st = engine.opt_state
    return list(engine._masters) + list(st.mu) + list(st.nu)


def ckpt_train_resume(torch):
    """The llama train cell at CKPT_RESUME_LAYERS layers takes CKPT_STEPS
    steps (run A), saving after CKPT_SAVE_AT; the engine is deleted and
    the card freed; a fresh engine on weights from another seed loads the
    tag and takes the same last steps. Losses, masters and moments,
    counters, LR and the resumed steps' launches must equal run A's bit
    for bit (else no more than two uninterrupted runs differ). Returns
    the launches of both runs."""
    import gc
    import shutil
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LLAMA_7B
    cfg = dataclasses.replace(LLAMA_7B, n_layer=CKPT_RESUME_LAYERS)
    config = dict(llama_train_config(1e-4, LLAMA_GAS), scheduler={
        "type": "WarmupLR", "params": {"warmup_min_lr": 0.0,
                                       "warmup_max_lr": 1e-4,
                                       "warmup_num_steps": CKPT_STEPS}})
    rng = np.random.default_rng(SEED + 80)
    batches = [{"input_ids": rng.integers(
        0, cfg.vocab_size, (LLAMA_GAS, LLAMA_MICRO, LLAMA_T),
        dtype=np.int64)} for _ in range(CKPT_STEPS)]
    tag_root = f"{CKPT_DIR}/resume"
    shutil.rmtree(tag_root, ignore_errors=True)

    def engine_of(seed):
        model = llama_model(torch, cfg, seed, torch.float32)
        return deepspeed_tpu_torch.initialize(model=model, config=config)[0]

    def host_state(engine):
        return [t.detach().cpu() for t in state_of(engine)]

    def steps(engine, batch_list):
        _, per_step, losses = run_steps(
            torch, lambda b: engine.train_batch(batch=b), batch_list)
        return per_step, losses

    reset_counts()

    engine = engine_of(SEED + 81)
    steps(engine, batches[:CKPT_SAVE_AT])
    torch.cuda.synchronize()
    with RssPeak() as save:
        tag_dir = engine.save_checkpoint(tag_root)
    saved = engine._ckpt_history[-1]
    largest, tag_bytes, chunked = tag_layout(tag_dir)
    a_steps, a_losses = steps(engine, batches[CKPT_SAVE_AT:])
    a_state = host_state(engine)
    a_counters = (engine.global_steps, engine.global_samples,
                  engine.micro_steps, engine.get_lr())
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    free_after_delete = torch.cuda.mem_get_info()[0]

    torch.cuda.reset_peak_memory_stats()
    engine = engine_of(SEED + 82)             # another initial model
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with RssPeak() as load:
        engine.load_checkpoint(tag_root)
    load_peak = torch.cuda.max_memory_allocated()
    host_bound = host_staging_bound("ckpt train resume", load.gib,
                                    tag_bytes, largest, engine.dp_world_size)
    loaded = engine._ckpt_history[-1]
    check(engine.global_steps == CKPT_SAVE_AT,
          f"resumed at step {engine.global_steps}, want {CKPT_SAVE_AT}")
    b_steps, b_losses = steps(engine, batches[CKPT_SAVE_AT:])
    peak = max(load_peak, torch.cuda.max_memory_allocated())
    b_counters = (engine.global_steps, engine.global_samples,
                  engine.micro_steps, engine.get_lr())
    equal = [bool(torch.equal(x.cpu(), y)) for x, y in
             zip(state_of(engine), a_state)]
    check(b_counters == a_counters,
          f"counters/LR after resume {b_counters}, run A {a_counters}")
    check(b_steps == a_steps,
          f"resumed steps launched {b_steps}, run A {a_steps}")
    nondeterministic = None
    if not (all(equal) and b_losses == a_losses):
        # two uninterrupted runs: the resume may differ by no more
        def worst(state):
            return max(float((x.cpu().double() - y.double()).abs().max())
                       for x, y in zip(state, a_state))
        resumed_diff = worst(state_of(engine))
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        engine = engine_of(SEED + 81)
        steps(engine, batches)
        control_diff = worst(state_of(engine))
        nondeterministic = {"resume_max_abs": resumed_diff,
                            "two_runs_max_abs": control_diff}
        check(control_diff > 0 and resumed_diff <= control_diff,
              f"resume differs from run A by {resumed_diff}, two "
              f"uninterrupted runs by {control_diff}")
    phase("ckpt train resume", model=f"LLAMA_7B width, {cfg.n_layer} layers",
          params=engine.module.num_params(), steps=CKPT_STEPS,
          saved_after=CKPT_SAVE_AT, losses_a=json.dumps(a_losses),
          losses_resumed=json.dumps(b_losses), bitwise=all(equal),
          tensors_equal=f"{sum(equal)}/{len(equal)}",
          nondeterministic=json.dumps(nondeterministic),
          global_steps=b_counters[0], micro_steps=b_counters[2],
          lr=b_counters[3][0], launches_resumed_steps=json.dumps(b_steps),
          tag_gb=round(tag_bytes / 1e9, 3),
          largest_leaf_gib=round(largest / 2 ** 30, 3),
          tag_gib=round(tag_bytes / 2 ** 30, 3), chunked=json.dumps(chunked),
          **io_fields("save", save, saved["bytes"], saved["hash_seconds"]),
          **io_fields("load", load, loaded["bytes"], loaded["hash_seconds"]),
          load_host_bound_gib=round(host_bound, 3),
          card_free_gib_before_load=round(free_after_delete / 2 ** 30, 2),
          resident_gib_before_load=round(resident / 2 ** 30, 3),
          load_peak_gib=round(load_peak / 2 ** 30, 3),
          load_extra_gib=round((load_peak - resident) / 2 ** 30, 3),
          peak_mem_gib=round(peak / 2 ** 30, 2))
    launches = counts()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(tag_root, ignore_errors=True)
    return launches


def ckpt_fallback(torch):
    """GPT-2-125M (the main train cell) with keep_last_n 2 and save_retries
    2: three saves (the first tag collected), a save through one injected
    write failure (retried), then the newest tag's optim_states truncated
    on disk: loading falls back to the previous tag with one rollback
    counted and training resumes from it; with every tag truncated, the
    load raises CheckpointLoadError naming each tag. Returns the K1/K2
    launches of its steps."""
    import os
    import shutil
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, GPT2_125M
    from deepspeed_tpu_torch.resilience import (CheckpointLoadError,
                                                get_injector, list_tags)
    cfg = dataclasses.replace(GPT2_125M, n_layer=CKPT_FALLBACK_LAYERS)
    config = dict(train_config(1e-4, TRAIN_GAS), resilience={
        "keep_last_n": 2, "save_retries": 2, "retry_backoff_s": 0.05,
        "retry_max_backoff_s": 0.1})
    root = f"{CKPT_DIR}/fallback"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(SEED + 83)
    batches = [{"input_ids": rng.integers(
        0, cfg.vocab_size, (TRAIN_GAS, TRAIN_MICRO, cfg.n_positions),
        dtype=np.int64)} for _ in range(4)]

    def engine_of(seed):
        model = GPT2Model(cfg, generator=torch.Generator().manual_seed(seed))
        return deepspeed_tpu_torch.initialize(model=model, config=config)[0]

    def counter(engine, tag):
        return engine.tracer.counter_value(tag, 0.0)

    reset_counts()
    engine = engine_of(SEED + 84)
    losses = []
    for b in batches[:3]:
        losses.append(float(engine.train_batch(batch=b)))
        engine.save_checkpoint(root)
    tags3 = list_tags(root)
    check(tags3 == ["global_step3", "global_step2"],
          f"keep_last_n 2 left {tags3}")
    retries0 = counter(engine, "resilience/ckpt_retries")
    losses.append(float(engine.train_batch(batch=batches[3])))
    injector = get_injector()
    injector.arm("io_write_fail", times=1)
    engine.save_checkpoint(root)
    retried = counter(engine, "resilience/ckpt_retries") - retries0
    check(injector.fired.get("io_write_fail") == 1 and retried == 1,
          f"io_write_fail fired {injector.fired}, retries counted {retried}")
    tags4 = list_tags(root)
    check(tags4 == ["global_step4", "global_step3"], f"tags {tags4}")
    newest = os.path.join(root, "global_step4", "optim_states.msgpack")
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    del engine
    torch.cuda.empty_cache()

    engine = engine_of(SEED + 85)
    rollbacks0 = counter(engine, "resilience/rollbacks")
    path, _ = engine.load_checkpoint(root)
    rollbacks = counter(engine, "resilience/rollbacks") - rollbacks0
    check(path.endswith("global_step3") and engine.global_steps == 3 and
          rollbacks == 1, f"fallback loaded {path} at step "
          f"{engine.global_steps} with {rollbacks} rollbacks")
    resumed = float(engine.train_batch(batch=batches[3]))
    check(math.isfinite(resumed) and engine.global_steps == 4,
          f"resumed loss {resumed} at step {engine.global_steps}")
    for tag in ("global_step3",):
        p = os.path.join(root, tag, "optim_states.msgpack")
        with open(p, "r+b") as f:
            f.truncate(os.path.getsize(p) // 2)
    try:
        engine_of(SEED + 86).load_checkpoint(root)
        raised = None
    except CheckpointLoadError as e:
        raised = str(e)
    check(raised is not None and "global_step4" in raised and
          "global_step3" in raised,
          f"every tag truncated: load raised {raised!r}")
    launches = counts()
    phase("ckpt fallback", model=f"GPT2_125M, {cfg.n_layer} layers",
          tags_after_3_saves=tags3,
          write_failures_retried=retried, tags_after_retry=tags4,
          truncated="global_step4/optim_states.msgpack", loaded=path,
          rollbacks=rollbacks, losses=json.dumps([round(x, 4)
                                                  for x in losses]),
          resumed_loss=round(resumed, 4), resumed_loss_before=round(
              losses[3], 4), all_truncated_raises="CheckpointLoadError",
          launches=json.dumps(launches))
    del engine
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return launches


def ckpt_serve(torch):
    """LLaMA-7B at CKPT_SERVE_LAYERS layers: an optimizer-less engine holds
    the f32 masters and saves a tag (chunked leaves); ``init_inference``
    of a model from another seed with the tag in its config serves every
    weight as the masters cast to bf16, [4, 2048] logits and greedy streams
    bitwise those of an engine built on the saving model, at
    weights_version 1; then a ServingEngine over each serves the same
    requests, bitwise. Returns K3's launches in the scoring calls."""
    import gc
    import shutil
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LLAMA_7B
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    cfg = dataclasses.replace(LLAMA_7B, n_layer=CKPT_SERVE_LAYERS)
    root = f"{CKPT_DIR}/serve"
    shutil.rmtree(root, ignore_errors=True)
    need = 4 * sum(math.prod(s) for s in _llama_leaf_shapes(cfg))
    free = shutil.disk_usage("build").free
    check(free > 1.1 * need, f"{free / 1e9:.1f} GB free under build/, the "
          f"tag needs {need / 1e9:.1f} GB")
    model = llama_model(torch, cfg, SEED + 90, torch.float32)
    trainer = deepspeed_tpu_torch.initialize(model=model, config={
        "train_batch_size": 1, "bf16": {"enabled": True},
        "steps_per_print": 0})[0]
    check(trainer.optimizer is None, "the saving engine has an optimizer")
    torch.cuda.synchronize()
    with RssPeak() as save:
        tag_dir = trainer.save_checkpoint(root)
    saved = trainer._ckpt_history[-1]
    largest, tag_bytes, chunked = tag_layout(tag_dir)
    check(chunked, "the full-depth tag has no chunked leaf")

    torch.cuda.reset_peak_memory_stats()
    with RssPeak() as load:
        served = deepspeed_tpu_torch.init_inference(
            llama_model(torch, cfg, SEED + 91, torch.bfloat16),
            {"dtype": "bfloat16", "checkpoint": root})
        torch.cuda.synchronize()
    load_peak = torch.cuda.max_memory_allocated()
    check(served.weights_version == 1,
          f"weights_version {served.weights_version}")
    with torch.no_grad():
        same = [torch.equal(p, m.to(torch.bfloat16)) for p, m in
                zip(served.module.parameters(), trainer._masters)]
    check(all(same), f"{same.count(False)} served weights differ from the "
          f"masters cast to bf16")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    direct = deepspeed_tpu_torch.init_inference(model, {"dtype": "bfloat16"})
    del model
    gc.collect()
    torch.cuda.empty_cache()

    ids = torch.randint(0, cfg.vocab_size, (4, LLAMA_T),
                        generator=torch.Generator().manual_seed(SEED + 92))
    reset_counts()
    logits = served(ids)
    per_call = [fa.flash_attention_fwd.launches]
    logits_direct = direct(ids)
    per_call.append(fa.flash_attention_fwd.launches - per_call[0])
    check(per_call == [cfg.n_layer] * 2,
          f"K3 launched {per_call} times a scoring call, want "
          f"{cfg.n_layer}")
    check(torch.equal(logits, logits_direct),
          "logits from the tag differ from the saving model's")
    del logits, logits_direct
    prompts = torch.randint(0, cfg.vocab_size, (4, 128),
                            generator=torch.Generator().manual_seed(SEED + 93))
    greedy = [e.generate(prompts, max_new_tokens=32) for e in (served,
                                                                direct)]
    check(torch.equal(*greedy), "greedy streams from the tag differ")
    spec = dict(SERVE_LLAMA, requests=CKPT_SERVE_REQUESTS)
    traffic = serve_traffic(np, spec, cfg.vocab_size, SEED + 94)
    streams, walls = [], []
    for engine in (served, direct):
        toks, reqs, _, ticks, wall, srv = serve_run(torch, engine,
                                                    spec["cfg"], traffic)
        srv.shutdown()
        del srv
        torch.cuda.empty_cache()
        states = {r.state.value for r in reqs}
        check(states == {"finished"}, f"ckpt serve: request states {states}")
        streams.append(toks)
        walls.append(round(wall, 3))
    check(streams[0] == streams[1],
          "served streams from the tag differ from the saving model's")
    launches = counts()["K3"]
    phase("ckpt serve", model=f"LLAMA_7B, {cfg.n_layer} layers",
          params=served.module.num_params(), tag_gb=round(tag_bytes / 1e9, 3),
          tag_gib=round(tag_bytes / 2 ** 30, 3),
          largest_leaf_gib=round(largest / 2 ** 30, 3),
          chunked=json.dumps(chunked), disk_free_gb=round(free / 1e9, 1),
          **io_fields("save", save, saved["bytes"], saved["hash_seconds"]),
          load_s=round(load.seconds, 3),
          load_gb_per_s=round(tag_bytes / load.seconds / 1e9, 3),
          load_host_gib=round(load.gib, 3),
          host_below_tag=save.gib < tag_bytes / 2 ** 30 and
          load.gib < tag_bytes / 2 ** 30,
          weights_equal_masters_bf16=True, logits_bitwise=True,
          k3_launches_per_call=json.dumps(per_call), k3_launches=launches,
          greedy_streams_equal=True,
          weights_version=served.weights_version,
          served_requests=len(traffic), served_streams_equal=True,
          serve_seconds=json.dumps(walls),
          load_peak_mem_gib=round(load_peak / 2 ** 30, 2))
    check(save.gib < tag_bytes / 2 ** 30 and load.gib < tag_bytes / 2 ** 30,
          f"save took {save.gib:.2f} GiB of host memory and load "
          f"{load.gib:.2f}, the tag is {tag_bytes / 2 ** 30:.2f} GiB")
    del served, direct
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return launches


def _llama_leaf_shapes(cfg):
    d, m = cfg.n_embd, cfg.intermediate
    qkv = (cfg.n_head + 2 * cfg.kv_head_count) * cfg.head_dim
    return [(cfg.padded_vocab, d)] * 2 + [(d,)] + [
        (cfg.n_layer,) + s for s in ((d,), (d, qkv), (d, d), (d,), (d, m),
                                     (d, m), (m, d))]


def write_megatron(torch, root, full, tp, pp, version, n_head, n_layer):
    """A Megatron-LM GPT checkpoint of ``full`` (Megatron's names, f32
    numpy) in ``tp`` x ``pp`` shards with the qkv rows of ``version``, as
    ``tests/unit/test_megatron_ckpt.py`` writes its fixtures."""
    import os
    import types
    import numpy as np
    hd = full["wpe"].shape[1] // n_head
    per_stage = n_layer // pp

    def relayout(shard, heads):
        w = shard.reshape(heads, 3, hd, -1)
        if version == 1.0:
            return np.transpose(w, (0, 2, 1, 3)).reshape(shard.shape)
        if version == 0:
            return np.transpose(w, (1, 0, 2, 3)).reshape(shard.shape)
        return shard

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    for s in range(pp):
        for r in range(tp):
            trans = {}
            for g in range(s * per_stage, (s + 1) * per_stage):
                for k, v in full.items():
                    if not k.startswith(f"layers.{g}."):
                        continue
                    suffix = k.split(".", 2)[2]
                    if "query_key_value" in k:
                        shard = np.split(v, tp, axis=0)[r]
                        shard = relayout(shard.reshape(shard.shape[0], -1),
                                         n_head // tp).reshape(shard.shape)
                    elif "dense_h_to_4h" in k:
                        shard = np.split(v, tp, axis=0)[r]
                    elif k.endswith(("attention.dense.weight",
                                     "mlp.dense_4h_to_h.weight")):
                        shard = np.split(v, tp, axis=1)[r]
                    else:
                        shard = v
                    trans[f"layers.{g - s * per_stage}.{suffix}"] = t(shard)
            lm = {"transformer": trans}
            if s == 0:
                lm["embedding"] = {
                    "word_embeddings": {"weight": t(np.split(
                        full["wte"], tp, axis=0)[r])},
                    "position_embeddings": {"weight": t(full["wpe"])}}
            if s == pp - 1:
                for k in ("final_layernorm.weight", "final_layernorm.bias"):
                    trans[k] = t(full[k])
            d = os.path.join(root, f"mp_rank_{r:02d}_{s:03d}" if pp > 1
                             else f"mp_rank_{r:02d}")
            os.makedirs(d, exist_ok=True)
            torch.save({"args": types.SimpleNamespace(
                num_attention_heads=n_head), "checkpoint_version": version,
                "model": {"language_model": lm}},
                os.path.join(d, "model_optim_rng.pt"))


def megatron_tensors(np, cfg, vocab, seed):
    """GPT-2-125M's tensors under Megatron's names, random from ``seed``."""
    rng = np.random.default_rng(seed)
    d, f = cfg.n_embd, cfg.mlp_ratio * cfg.n_embd

    def w(*shape, std=0.02, center=0.0):
        return (center + rng.standard_normal(shape, np.float32) * std)

    full = {"wte": w(vocab, d), "wpe": w(cfg.n_positions, d),
            "final_layernorm.weight": w(d, center=1.0),
            "final_layernorm.bias": w(d)}
    for i in range(cfg.n_layer):
        for name, shape, center in (
                ("input_layernorm.weight", (d,), 1.0),
                ("input_layernorm.bias", (d,), 0.0),
                ("attention.query_key_value.weight", (3 * d, d), 0.0),
                ("attention.query_key_value.bias", (3 * d,), 0.0),
                ("attention.dense.weight", (d, d), 0.0),
                ("attention.dense.bias", (d,), 0.0),
                ("post_attention_layernorm.weight", (d,), 1.0),
                ("post_attention_layernorm.bias", (d,), 0.0),
                ("mlp.dense_h_to_4h.weight", (f, d), 0.0),
                ("mlp.dense_h_to_4h.bias", (f,), 0.0),
                ("mlp.dense_4h_to_h.weight", (d, f), 0.0),
                ("mlp.dense_4h_to_h.bias", (d,), 0.0)):
            full[f"layers.{i}.{name}"] = w(*shape, center=center)
    return full


def ckpt_megatron(torch):
    """A Megatron-LM GPT-2-125M directory in tp 2 x pp 2 (qkv version 0)
    and as one shard (2.0), written here with torch.save from one seed:
    both load to bitwise-equal trees, and init_inference(dir, bf16) of each
    scores [8, 1024] with 12 K1 launches a call to bitwise-equal logits and
    serves equal greedy streams. Returns K1's launches."""
    import shutil
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.megatron import \
        load_megatron_checkpoint
    from deepspeed_tpu_torch.models.gpt2 import GPT2_125M
    from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as k1
    cfg = GPT2_125M
    root = f"{CKPT_DIR}/megatron"
    shutil.rmtree(root, ignore_errors=True)
    full = megatron_tensors(np, cfg, CKPT_MEGATRON_VOCAB, SEED + 95)
    t0 = time.perf_counter()
    write_megatron(torch, f"{root}/grid", full, CKPT_MEGATRON_TP,
                   CKPT_MEGATRON_PP, 0, cfg.n_head, cfg.n_layer)
    write_megatron(torch, f"{root}/flat", full, 1, 1, 2.0, cfg.n_head,
                   cfg.n_layer)
    write_s = time.perf_counter() - t0
    trees = [load_megatron_checkpoint(f"{root}/{d}")[1]
             for d in ("grid", "flat")]
    from deepspeed_tpu_torch.elasticity.logical import _leaves
    flat = [dict(_leaves(tr)) for tr in trees]
    check(flat[0].keys() == flat[1].keys() and all(
        np.array_equal(flat[0][k], flat[1][k]) for k in flat[1]),
        "the tp x pp tree differs from the single shard's")
    del trees, flat
    ids = torch.randint(0, cfg.vocab_size, (8, cfg.n_positions),
                        generator=torch.Generator().manual_seed(SEED + 96))
    prompts = ids[:4, :128]
    reset_counts()
    logits, streams, per_call = [], [], []
    for d in ("grid", "flat"):
        s0 = time.perf_counter()
        engine = deepspeed_tpu_torch.init_inference(f"{root}/{d}",
                                                    {"dtype": "bfloat16"})
        torch.cuda.synchronize()
        load_s = time.perf_counter() - s0
        before = k1.packed_flash_attention_fwd.launches
        logits.append(engine(ids))
        per_call.append(k1.packed_flash_attention_fwd.launches - before)
        streams.append(engine.generate(prompts, max_new_tokens=32))
        del engine
    launches = counts()["K1"]
    check(per_call == [cfg.n_layer] * 2,
          f"K1 launched {per_call} times a scoring call, want {cfg.n_layer}")
    check(torch.equal(*logits), "tp x pp logits differ from one shard's")
    check(torch.equal(*streams), "tp x pp greedy streams differ")
    phase("ckpt megatron", model=f"GPT2_125M (vocab {CKPT_MEGATRON_VOCAB})",
          layouts=f"tp{CKPT_MEGATRON_TP} x pp{CKPT_MEGATRON_PP} v0 vs tp1 "
          f"v2.0", write_s=round(write_s, 2), init_inference_s=round(
              load_s, 2), trees_bitwise=True, logits_bitwise=True,
          greedy_equal=True, k1_launches=launches,
          k1_launches_per_call=per_call)
    del logits, streams
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return launches


# ---------------------------------------------------------------- ZeRO

ZERO_STAGES = (0, 1, 2, 3)
ZERO_STEPS, ZERO_LLAMA_STEPS, ZERO_CKPT_STEPS = 3, 2, 4
ZERO_T = 1024                         # the main train cell's sequence
ZERO_STORE = "build/zero_store"
# the dropout kernel at a rank's rows: rank 1 of 2 at BERT's micro batch
# (its counters start after rank 0's 4 sequences), and past 2**32
DROPOUT_OFFSETS = (4 * 4096 * 1024, (1 << 32) + 4 * 4096 * 1024)
# the offset-0 row of PERF.md's table of kernels (the BERT bf16 shape)
DROPOUT_ROW = {"kernel_ms": 0.0962, "bound_ms": 0.0752}


def check_dropout_offset(torch):
    """The dropout kernel at BERT-large's hidden states ``[4, 4096, 1024]``
    (bf16) at non-zero element offsets (a data-parallel rank's rows of the
    global mask): bit for bit its plain version at the same offset, and
    the last rows of the kernel's draw over a batch twice as large from
    the offset less the first half's size (at the first offset, the
    global draw from 0; at the second, a draw from 2**32); timed beside
    the offset-0 row of ``kernel-check dropout``."""
    from deepspeed_tpu_torch.ops.kernels import threefry_dropout as tfd
    key, rate = DROPOUT_KEY, DROPOUT_RATE
    shape = DROPOUT_SHAPES["bert"]
    gen = torch.Generator("cuda").manual_seed(SEED + 61)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    first = torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    res = None
    for offset in DROPOUT_OFFSETS:
        got = tfd.threefry_dropout(x, key, rate, offset)
        want, plain_ms = timed_call(
            torch, lambda: tfd.threefry_dropout_plain(x, key, rate, offset))
        equal = torch.equal(got, want)
        err = (got.float() - want.float()).abs().max().item()
        check(equal, f"dropout kernel at offset {offset}: not its plain "
              f"version's bits (max abs {err})")
        # the rows of a draw over [first; x] from ``offset - first``'s
        # size: at the first offset the global draw from 0
        rows = tfd.threefry_dropout(torch.cat([first, x]), key, rate,
                                    offset - first.numel())[shape[0]:]
        global_rows = torch.equal(got, rows)
        check(global_rows, f"dropout kernel at offset {offset} is not the "
              f"rows of the draw over the batch before it")
        del rows
        kernel_ms = median_ms(
            torch, lambda: tfd.threefry_dropout(x, key, rate, offset),
            reps=7, inner=5, warmup=2)
        bound_ms, bound_by, ops, nbytes = dropout_bound(x.numel(), 2)
        phase("kernel-check dropout offset", shape=list(shape),
              dtype="bfloat16", rate=rate, offset=offset, bitwise=equal,
              global_rows_bitwise=global_rows, max_abs_err=err,
              kernel_ms=round(kernel_ms, 4), plain_ms=round(plain_ms, 2),
              bound_ms=round(bound_ms, 4), bound_by=bound_by,
              offset0_row_ms=DROPOUT_ROW["kernel_ms"],
              offset0_row_bound_ms=DROPOUT_ROW["bound_ms"])
        res = res or {"kernel_ms": kernel_ms, "err": err}
        del got, want
    del x, first
    torch.cuda.empty_cache()
    return res


# a tp-2 rank's heads of GPT-2's attention probabilities (tp gpt2 train
# loop): 6 of 12 heads of [8, 12, 1024, 1024]; and a data-parallel rank's
# rows (its batch starting at row 8 of 16)
DROPOUT_HEADS = {"whole": (8, 12, 1024, 1024), "heads": 6, "dp_first": 8}


def check_dropout_heads(torch):
    """The dropout kernel under the head-strided counter map at a tp-2
    rank's heads of GPT-2's probabilities (bf16): for ranks 0 and 1, and
    rank 1 of a data-parallel rank whose rows start at row 8, bit for bit
    its plain version under the same map and the heads' slice of the
    kernel's contiguous draw over the whole ``[B, 12, T, T]`` (from those
    rows' counter); a flipped key word must be caught. Then the same
    number of elements through the contiguous launch (``inner ==
    stride``, which takes today's kernel instance): its bits the draw
    without a map, both launches timed."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.dropout import counter_map
    from deepspeed_tpu_torch.ops.kernels import threefry_dropout as tfd
    key, rate = DROPOUT_KEY, DROPOUT_RATE
    whole_shape, h = DROPOUT_HEADS["whole"], DROPOUT_HEADS["heads"]
    total = whole_shape[1]
    gen = torch.Generator("cuda").manual_seed(SEED + 62)
    xw = torch.randn(whole_shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    row = xw[0].numel()
    res = None
    for rank, first in ((0, 0), (1, 0), (1, DROPOUT_HEADS["dp_first"])):
        x = xw[:, rank * h:(rank + 1) * h].contiguous()
        where = counter_map(tuple(x.shape), first, (rank * h, total))
        got = tfd.threefry_dropout(x, key, rate, *where)
        want, plain_ms = timed_call(
            torch, lambda: tfd.threefry_dropout_plain(x, key, rate, *where))
        equal = torch.equal(got, want)
        err = (got.float() - want.float()).abs().max().item()
        sliced = torch.equal(got, tfd.threefry_dropout(
            xw, key, rate, first * row)[:, rank * h:(rank + 1) * h])
        bad = tfd.threefry_dropout(x, (key[0] ^ 1, key[1]), rate, *where)
        caught = not torch.equal(bad, got)
        check(equal and sliced and caught,
              f"dropout heads rank {rank} rows from {first}: plain bits "
              f"{equal} (max abs {err}), the whole draw's slice {sliced}, "
              f"a flipped key caught {caught}")
        kernel_ms = median_ms(
            torch, lambda: tfd.threefry_dropout(x, key, rate, *where),
            reps=7, inner=5, warmup=2)
        # the same elements through the contiguous launch: inner == stride
        contiguous = tfd.threefry_dropout(x, key, rate, first * row,
                                          where[1], where[1])
        today = torch.equal(contiguous, tfd.threefry_dropout(
            x, key, rate, first * row))
        check(today, "dropout: the inner == stride launch is not the "
              "launch without a map")
        contiguous_ms = median_ms(
            torch, lambda: tfd.threefry_dropout(x, key, rate, first * row,
                                                where[1], where[1]),
            reps=7, inner=5, warmup=2)
        library_ms = median_ms(
            torch, lambda: F.dropout(x, rate, training=True), reps=7,
            inner=5, warmup=2)
        bound_ms, bound_by, ops, nbytes = dropout_bound(x.numel(), 2)
        res = res or {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms, "err": err}
        phase("kernel-check dropout heads", shape=list(x.shape),
              whole=list(whole_shape), heads=json.dumps(
                  [rank * h, (rank + 1) * h, total]), first_row=first,
              map=json.dumps(list(where)), dtype="bfloat16", rate=rate,
              bitwise=equal, whole_draw_slice_bitwise=sliced,
              fault_caught=caught, max_abs_err=err,
              kernel_ms=round(kernel_ms, 4),
              contiguous_launch_bitwise=today,
              contiguous_ms=round(contiguous_ms, 4),
              plain_ms=round(plain_ms, 2), bound_ms=round(bound_ms, 4),
              bound_by=bound_by, library_ms=round(library_ms, 4))
        del x, got, want, bad, contiguous
    del xw
    torch.cuda.empty_cache()
    return res


def zero_config(config, stage):
    return dict(config, zero_optimization={"stage": stage})


@contextlib.contextmanager
def one_rank_planner(on=True):
    """Engines made inside the block partition each leaf as the ZeRO
    planner would over several ranks, here over the one rank of the card
    (where the planner as shipped partitions nothing and the engine runs
    stage 0): stages 1-3 then take every gather and reduce-scatter, each
    an identity. ``on=False``: the planner as shipped."""
    from deepspeed_tpu_torch.parallel.tensor_parallel import rule_spec
    from deepspeed_tpu_torch.runtime import engine as engine_module
    from deepspeed_tpu_torch.runtime.zero import partition

    class OneRankPlanner(partition.ZeroShardingPlanner):
        def _leaf_spec(self, path, shape, dp_sharded):
            spec = rule_spec(path, self.rules, len(shape))
            if dp_sharded:
                spec = partition._add_dp_axis(spec, tuple(shape),
                                              partition.DP_AXES, 1,
                                              self.persistence_threshold)
            return tuple(spec)

    saved = engine_module.ZeroShardingPlanner
    if on:
        engine_module.ZeroShardingPlanner = OneRankPlanner
    try:
        yield
    finally:
        engine_module.ZeroShardingPlanner = saved


def whole_state(engine):
    """Masters, mu and nu of an engine, whole at any stage, copied to the
    host."""
    n, st = len(engine._names), engine.opt_state
    return ([engine.whole_master(i).detach().cpu() for i in range(n)] +
            [engine.whole(i, st.mu[i]).cpu() for i in range(n)] +
            [engine.whole(i, st.nu[i]).cpu() for i in range(n)])


def zero_stages(torch, name, model_of, config, batches, tokens, want,
                stages=ZERO_STAGES, shipped=()):
    """One engine a ZeRO stage on the same weights and batches (the NCCL
    group of one rank), partitioned over that rank (``one_rank_planner``),
    then each stage of ``shipped`` under the planner as shipped (which
    runs stage 0 on one rank): tokens/s, device peak and launches a step
    for each; every run must equal stage 0 bit for bit (losses, masters,
    moments: every collective is an identity on one rank and AdamW is
    elementwise), compared on the host so that no stage's peak holds
    another's state. ``want``: ``{kernel: launches a step}``. Returns the
    launches of all runs."""
    import gc
    import deepspeed_tpu_torch
    ref, launches = None, {}
    runs = [(stage, True) for stage in stages] + \
        [(stage, False) for stage in shipped]
    for stage, partitioned in runs:
        with one_rank_planner(partitioned):
            engine = deepspeed_tpu_torch.initialize(
                model=model_of(), config=zero_config(config, stage))[0]
        runs_stage = engine._stage
        check(runs_stage == (stage if partitioned else 0),
              f"{name} stage {stage} (partitioned={partitioned}) runs "
              f"stage {runs_stage}")
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step_s, per_step, losses = run_steps(
            torch, lambda b: engine.train_batch(batch=b), batches)
        peak = torch.cuda.max_memory_allocated()
        gathers = engine.zero_gather_stats.as_dict()
        state = whole_state(engine)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        for step in per_step:
            for k, v in step.items():
                launches[k] = launches.get(k, 0) + v
        check(all(step[k] == n for step in per_step for k, n in want.items()),
              f"{name} stage {stage}: launches a step {per_step}, want "
              f"{want}")
        if ref is None:
            ref = (losses, state)
        equal = [bool(torch.equal(a, b)) for a, b in zip(state, ref[1])]
        check(losses == ref[0] and all(equal),
              f"{name} stage {stage}: losses {losses} vs stage "
              f"{stages[0]} {ref[0]}, {sum(equal)}/{len(equal)} tensors "
              f"equal")
        del state
        best = min(step_s[1:] or step_s)
        phase(name, stage=stage, planner="one-rank" if partitioned else
              "shipped", runs_stage=runs_stage, steps=len(step_s),
              seconds=json.dumps([round(x, 4) for x in step_s]),
              tokens_per_s=round(tokens / best, 1),
              peak_mem_gib=round(peak / 2 ** 30, 2),
              resident_gib=round(resident / 2 ** 30, 2),
              losses=json.dumps(losses),
              bitwise_stage0=losses == ref[0] and all(equal),
              launches_per_step=json.dumps(
                  {k: per_step[0][k] for k in want}),
              gathered_peak_gib=round(gathers["peak"] / 2 ** 30, 4),
              gathers=gathers["gathers"], regathers=gathers["regathers"])
    return launches


def zero_train(torch):
    """GPT-2-125M at the main train cell (micro 8, T 1024, gas 4, bf16 on
    fp32 masters, AdamW) at ZeRO stages 0-3, ZERO_STEPS steps each."""
    import numpy as np
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, GPT2_125M
    cfg, t = GPT2_125M, ZERO_T
    rng = np.random.default_rng(SEED + 90)
    batches = [{"input_ids": rng.integers(
        0, cfg.vocab_size, (TRAIN_GAS, TRAIN_MICRO, t), dtype=np.int64)}
        for _ in range(ZERO_STEPS)]
    want = {"K1": cfg.n_layer * TRAIN_GAS, "K2": cfg.n_layer * TRAIN_GAS}
    return zero_stages(
        torch, "zero train",
        lambda: GPT2Model(cfg, generator=torch.Generator().manual_seed(
            SEED + 91)), train_config(1e-4, TRAIN_GAS), batches,
        TRAIN_GAS * TRAIN_MICRO * t, want, shipped=(3,))


def zero_train_llama(torch):
    """LLaMA-7B's width at 4 layers (the llama train cell: micro 4, T 2048,
    gas 2) at stage 3 against stage 0, ZERO_LLAMA_STEPS steps each; the
    states compared on the host."""
    import numpy as np
    from deepspeed_tpu_torch.models.llama import LLAMA_7B
    cfg = dataclasses.replace(LLAMA_7B, n_layer=LLAMA_TRAIN_LAYERS)
    rng = np.random.default_rng(SEED + 92)
    batches = [{"input_ids": rng.integers(
        0, cfg.vocab_size, (LLAMA_GAS, LLAMA_MICRO, LLAMA_T),
        dtype=np.int64)} for _ in range(ZERO_LLAMA_STEPS)]
    n = cfg.n_layer * LLAMA_GAS
    return zero_stages(
        torch, "zero train llama",
        lambda: llama_model(torch, cfg, SEED + 93, torch.float32),
        llama_train_config(1e-4, LLAMA_GAS), batches,
        LLAMA_GAS * LLAMA_MICRO * LLAMA_T, {"K3": n, "K3b/K5": n},
        stages=(0, 3))


def ckpt_zero_resume(torch):
    """GPT-2-125M at stage 3 (the main train cell): run A saves after 2 of
    ZERO_CKPT_STEPS steps; a fresh stage-3 engine and a fresh stage-0
    engine (other initial weights) load the tag and take the last steps,
    each bit for bit run A's; stage 3 partitioned over the card's one
    rank (``one_rank_planner``). The device peak of each load (its peak
    stats reset just before) beside the engine's resident bytes: the tag
    is staged in host memory and each leaf's part copied to the card; the
    host peak of each load within ``host_staging_bound``."""
    import gc
    import shutil
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, GPT2_125M
    cfg, t, save_at = GPT2_125M, ZERO_T, 2
    rng = np.random.default_rng(SEED + 94)
    batches = [{"input_ids": rng.integers(
        0, cfg.vocab_size, (TRAIN_GAS, TRAIN_MICRO, t), dtype=np.int64)}
        for _ in range(ZERO_CKPT_STEPS)]
    tag_root = f"{CKPT_DIR}/zero"
    shutil.rmtree(tag_root, ignore_errors=True)
    launches = {}

    def engine_of(seed, stage):
        with one_rank_planner():
            return deepspeed_tpu_torch.initialize(
                model=GPT2Model(cfg, generator=torch.Generator().manual_seed(
                    seed)),
                config=zero_config(train_config(1e-4, TRAIN_GAS), stage))[0]

    def steps(engine, batch_list):
        _, per_step, losses = run_steps(
            torch, lambda b: engine.train_batch(batch=b), batch_list)
        for step in per_step:
            for k, v in step.items():
                launches[k] = launches.get(k, 0) + v
        return losses

    def free(engine):
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    engine = engine_of(SEED + 95, 3)
    steps(engine, batches[:save_at])
    with RssPeak() as save:
        tag_dir = engine.save_checkpoint(tag_root)
    largest, tag_bytes, _ = tag_layout(tag_dir)
    a_losses = steps(engine, batches[save_at:])
    a_state = whole_state(engine)
    free(engine)
    fields = {"tag_gib": round(tag_bytes / 2 ** 30, 3),
              "largest_leaf_gib": round(largest / 2 ** 30, 3)}
    for stage in (3, 0):
        engine = engine_of(SEED + 96, stage)
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with RssPeak() as load:
            engine.load_checkpoint(tag_root)
        load_peak = torch.cuda.max_memory_allocated()
        bound = host_staging_bound(f"ckpt zero resume into stage {stage}",
                                   load.gib, tag_bytes, largest,
                                   engine.dp_world_size)
        losses = steps(engine, batches[save_at:])
        equal = [bool(torch.equal(a, b)) for a, b in
                 zip(whole_state(engine), a_state)]
        check(losses == a_losses and all(equal),
              f"ckpt zero resume into stage {stage}: losses {losses} vs "
              f"{a_losses}, {sum(equal)}/{len(equal)} tensors equal")
        fields.update({
            f"stage{stage}_bitwise": True,
            f"stage{stage}_resident_gib": round(resident / 2 ** 30, 3),
            f"stage{stage}_load_peak_gib": round(load_peak / 2 ** 30, 3),
            f"stage{stage}_load_extra_gib": round(
                (load_peak - resident) / 2 ** 30, 3),
            f"stage{stage}_load_seconds": round(load.seconds, 3),
            f"stage{stage}_load_host_gib": round(load.gib, 3),
            f"stage{stage}_load_host_bound_gib": round(bound, 3)})
        free(engine)
    phase("ckpt zero resume", model="GPT2_125M", saved_stage=3,
          steps=ZERO_CKPT_STEPS, saved_after=save_at,
          losses=json.dumps(a_losses), save_seconds=round(save.seconds, 3),
          **fields)
    shutil.rmtree(tag_root, ignore_errors=True)
    return launches


def zero_phases(torch):
    """The ZeRO phases on an NCCL process group of one rank (the card);
    the group is destroyed at the end. Returns each phase's launches."""
    import os
    from deepspeed_tpu_torch import comm
    os.makedirs(os.path.dirname(ZERO_STORE), exist_ok=True)
    if os.path.exists(ZERO_STORE):
        os.remove(ZERO_STORE)
    comm.init_distributed("nccl", init_method=f"file://{os.path.abspath(ZERO_STORE)}",
                          rank=0, world_size=1)
    try:
        check(comm.get_backend() == "nccl" and comm.get_world_size() == 1,
              f"process group {comm.get_backend()} of "
              f"{comm.get_world_size()} ranks, want nccl of 1")
        return (zero_train(torch), zero_train_llama(torch),
                ckpt_zero_resume(torch))
    finally:
        comm.destroy_process_group()


# ---------------------------------------------------------------- slice 10
# Tensor parallelism on the one card: TP_SIZE ranks of a gloo group over
# CUDA tensors (NCCL refuses two ranks on one device), spawned once after
# the parent has freed its models. Each rank holds its half of every
# sharded leaf and launches the attention kernels on its own heads (K3 at
# 16 of LLaMA-7B's 32 heads, K1/K2 at 6 of GPT-2's 12; the kernel checks
# hold both at those shapes too). Two ranks share one H100 and every tp
# collective is staged through host memory by gloo, so the times say
# nothing of tensor-parallel speed across cards. Each phase is held
# against tp 1 on the same seed's weights (the same draws at every tp),
# rank 0 running the tp-1 side alone first: tp forward holds the logits
# to LLAMA_LOGITS_TOL's bf16 bounds; tp serve teacher-forces the tp-1
# streams (the first TP_SERVE_REQUESTS of the serve phase's traffic, new
# tokens capped at TP_SERVE_NEW) and its own through the tp-2 forward,
# every token either the tp-2 choice or a near-tie; tp train and tp train
# llama hold the loss and the gathered gradients of one micro batch to
# TRAIN_GRAD_TOL and LLAMA_GRAD_TOL, then a repeated LLaMA batch must
# converge as in llama train. Timed: the median of TP_TIMED calls or
# steps after one untimed warm-up. The serve requests stop at
# TP_SERVE_NEW tokens: a tp-2 decode tick takes 200-300 ms through host
# memory (an H100 80GB HBM3 at 700 W, PERF.md), and the mix's whole
# streams (2,314 tokens) took 100 s.
TP_SIZE = 2
TP_STORE, TP_OUT = "build/tp_store", "build/tp_out"
TP_TIMEOUT = 600                 # seconds the parent waits for the ranks
TP_FWD_SHAPE, TP_TIMED = (4, 2048), 2
TP_SERVE_REQUESTS, TP_SERVE_NEW = 8, 32
# the tp-2 LLaMA run falls below 0.8 x its first loss by its second step
# (PERF.md): 4 steps of llama train's 10 check it
TP_CONVERGE_STEPS = 4


def tp_axis_stats():
    """The ``model`` axis's collectives since the last reset: ops, wire
    bytes, and ops by kind."""
    from deepspeed_tpu_torch import comm
    st = comm.comm_axis_stats("model")
    return json.dumps({"ops": st["ops"], "bytes": st["bytes"],
                       "per_op": st["per_op"]})


def tp_reset(torch):
    """Counts and statistics to 0 before a phase's main path."""
    from deepspeed_tpu_torch import comm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    comm.reset_comm_stats()
    reset_counts()


def tp_vs_tp1(torch, rank, name, build, mb, tol, kwargs=None):
    """The loss and the gradients of one micro batch ``mb`` at tp 2,
    gathered whole, against tp 1's on the same weights (``build(tp)``
    makes the model: ``tp=1`` whole, ``tp=None`` the rank's part): each
    leaf's rel. L2 and the loss difference within ``tol``, checked and
    printed on rank 0."""
    from deepspeed_tpu_torch import comm

    def grads(tp):
        m = build(tp)
        loss = m.apply(mb, **(kwargs or {}))
        loss.backward()
        out = {}
        for (n, p), split in zip(m.named_parameters(), m.tp_splits()):
            g = torch.zeros_like(p) if p.grad is None else p.grad  # dropped
            g = g if split is None else split.gather(g, m.tp.group)
            out[n] = g.float().cpu() if rank == 0 else None
        del m
        torch.cuda.empty_cache()
        return loss.item(), out

    ref = grads(1) if rank == 0 else None
    comm.barrier()
    loss2, got = grads(None)
    if rank == 0:
        loss1, want = ref
        rel = {n: ((got[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
               for n, g in want.items()}
        worst = max(rel, key=rel.get)
        check(rel[worst] <= tol["rel_l2_per_leaf"] and
              abs(loss2 - loss1) <= tol["loss_abs"],
              f"{name} vs tp 1: worst leaf {worst} rel L2 {rel[worst]}, "
              f"losses {loss2} vs {loss1} (tol {tol})")
        phase(f"{name} vs tp 1", leaves=len(rel), loss_tp2=loss2,
              loss_tp1=loss1, loss_abs_diff=abs(loss2 - loss1),
              max_rel_l2=rel[worst], worst_leaf=worst,
              median_rel_l2=statistics.median(rel.values()),
              tol=json.dumps(tol))


def tp_forward(torch, rank):
    """LLaMA-7B's width at SERVE_LAYERS layers scoring ``[4, 2048]`` at tp 2
    (K3 a layer a call a rank, on 16 heads), against the tp-1 engine's
    logits."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.llama import LLAMA_7B
    cfg = dataclasses.replace(LLAMA_7B, n_layer=SERVE_LAYERS)
    b, t = TP_FWD_SHAPE
    ids = torch.randint(0, cfg.vocab_size, (b, t),
                        generator=torch.Generator().manual_seed(SEED + 11))
    ref = None
    if rank == 0:
        one = deepspeed_tpu_torch.init_inference(
            llama_model(torch, cfg, SEED + 10, torch.bfloat16, tp=1),
            {"dtype": "bf16"})
        ref = one(ids)
        del one
        torch.cuda.empty_cache()
    comm.barrier()
    engine = deepspeed_tpu_torch.init_inference(
        llama_model(torch, cfg, SEED + 10, torch.bfloat16),
        {"dtype": "bf16", "tensor_parallel": {"tp_size": TP_SIZE}})
    tp_reset(torch)
    fwd_s, per_call = [], []
    for _ in range(1 + TP_TIMED):             # the first call warms
        before = counts()["K3"]
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        logits = engine(ids)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - s0)
        per_call.append(counts()["K3"] - before)
    launches = counts()
    check(per_call == [cfg.n_layer] * len(fwd_s) and launches["K1"] == 0,
          f"tp forward rank {rank}: K3 launched {per_call} times per call, "
          f"want {cfg.n_layer}; K1 {launches['K1']}, want 0")
    check(tuple(logits.shape) == (b, t, cfg.padded_vocab) and
          torch.isfinite(logits.float()).all().item(),
          f"tp forward rank {rank}: logits {tuple(logits.shape)} or not "
          f"finite")
    med = statistics.median(fwd_s[1:])
    phase("tp forward", rank=rank, model="LLAMA_7B", tp=TP_SIZE,
          heads_per_rank=cfg.n_head // TP_SIZE,
          params_per_rank=engine.module.num_params(), shape=list(logits.shape),
          calls=len(fwd_s), timed=TP_TIMED,
          seconds=json.dumps([round(x, 4) for x in fwd_s]),
          median_s=round(med, 4), tokens_per_s=round(b * t / med, 1),
          k3_launches_per_call=json.dumps(per_call),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2),
          model_axis=tp_axis_stats())
    if rank == 0:
        compare_logits(torch, "tp forward vs tp 1", logits, ref,
                       LLAMA_LOGITS_TOL)
    del engine, logits, ref
    torch.cuda.empty_cache()
    return launches


def forced_choices(torch, engine, prompt, kw, streams):
    """Teacher forcing: ``engine``'s plain full forward (the model's
    attention on the plain path) over ``prompt`` and each of ``streams``
    (token lists of one length), in one batch. Returns the f32 logits at
    each stream position ``[S, n, vocab]`` and the token the engine's own
    sampler takes there ``[S, n]``: the argmax, or, sampled, the draw of
    the request's key at the column the token is fed at."""
    import numpy as np
    from deepspeed_tpu_torch.inference.speculative import (row_keys,
                                                           sample_rows)
    model = engine.module
    cfg = model.config
    p, n = len(prompt), len(streams[0])
    ids = torch.as_tensor(np.stack([np.concatenate([prompt, s[:-1]])
                                    for s in streams]).astype("int64"))
    model.config = dataclasses.replace(cfg, attn_backend="xla")
    try:
        logits = engine(ids)[:, p - 1:, :cfg.vocab_size].float()
    finally:
        model.config = cfg
    rows = logits.reshape(-1, logits.shape[-1])
    m = rows.shape[0]
    keys = row_keys(torch.full((m,), kw.get("seed", 0)),
                    torch.arange(p, p + n).repeat(len(streams)))
    choice = sample_rows(rows, torch.full((m,), kw.get("temperature", 0.0)),
                         torch.full((m,), kw.get("top_k", 0)),
                         torch.full((m,), kw.get("top_p", 1.0)), keys,
                         rows.shape[-1])
    return logits, choice.reshape(len(streams), n)


def forced_parts(torch, name, engine, traffic, runs, margin):
    """Each stream of each run in ``runs`` (``{label: streams}``, streams
    in traffic order) teacher-forced through ``engine``: wherever the
    engine's choice is not the stream's token, the two must be within
    ``margin`` of a tie (``tie_gap``). Returns, by label, the positions
    compared and ``{request: [[position, gap], ...]}`` of those that
    differ."""
    out = {label: [0, {}] for label in runs}
    for i, (prompt, kw) in enumerate(traffic):
        streams = [runs[label][i] for label in runs]
        logits, choice = forced_choices(torch, engine, prompt, kw, streams)
        for s, label in enumerate(runs):
            tokens = torch.as_tensor(streams[s], device=choice.device)
            out[label][0] += len(streams[s])
            for j in torch.nonzero(choice[s] != tokens).flatten().tolist():
                gap = tie_gap(torch, logits[s, j], kw, len(prompt) + j,
                              int(tokens[j]), int(choice[s, j]))
                out[label][1].setdefault(i, []).append([j, round(gap, 4)])
    bad = {label: {i: [x for x in v if x[1] > margin]
                   for i, v in parts.items()
                   if any(x[1] > margin for x in v)}
           for label, (_, parts) in out.items()}
    check(not any(bad.values()), f"{name}: teacher-forced streams hold "
          f"tokens that are not the forward's choice nor a near-tie "
          f"(request: [[position, gap]]): {bad}, margin {margin}")
    return out


def tp_serve(torch, rank):
    """LLaMA-7B served at tp 2 (16 slots x 2048, the rank's kv heads in
    its pool): the first TP_SERVE_REQUESTS requests of the serve phase's
    traffic. The tp-1 engine's streams and the tp-2 ones, each fed whole
    through the tp-2 forward, must hold its choice or a near-tie at every
    position."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.llama import LLAMA_7B
    from deepspeed_tpu_torch.serving.kv_slots import tree_nbytes
    cfg = dataclasses.replace(LLAMA_7B, n_layer=SERVE_LAYERS)
    scfg = SERVE_LLAMA["cfg"]
    traffic = [(p, dict(kw, max_new_tokens=min(kw["max_new_tokens"],
                                               TP_SERVE_NEW)))
               for p, kw in serve_traffic(np, SERVE_LLAMA, cfg.vocab_size,
                                          SEED + 71)[:TP_SERVE_REQUESTS]]
    base = None
    if rank == 0:
        one = deepspeed_tpu_torch.init_inference(
            llama_model(torch, cfg, SEED + 70, torch.bfloat16, tp=1),
            {"dtype": "bf16"})
        base, *_rest, srv = serve_run(torch, one, scfg, traffic)
        srv.shutdown()
        del one, srv, _rest
        torch.cuda.empty_cache()
    base = comm.broadcast_object(base, src=0)
    engine = deepspeed_tpu_torch.init_inference(
        llama_model(torch, cfg, SEED + 70, torch.bfloat16),
        {"dtype": "bf16", "tensor_parallel": {"tp_size": TP_SIZE}})
    tp_reset(torch)
    streams, reqs, util, ticks, wall, srv = serve_run(torch, engine, scfg,
                                                      traffic)
    launches = counts()
    axis = tp_axis_stats()
    check({r.state.value for r in reqs} == {"finished"} and
          all(len(r.tokens) == kw["max_new_tokens"]
              for (_, kw), r in zip(traffic, reqs)),
          f"tp serve rank {rank}: a request did not finish in full")
    check(srv.decode_executables() == 1, f"tp serve rank {rank}: "
          f"{srv.decode_executables()} decode shapes ran")
    pool = srv.scheduler.pool.cache
    check(all(c.device.type == "cuda" and
              c.shape[2] == cfg.kv_head_count // TP_SIZE
              for c in pool.values()),
          f"tp serve rank {rank}: the pool is not the rank's heads on the "
          f"card")
    pool_gib = tree_nbytes(pool) / 2 ** 30
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    pct = srv.metrics.percentiles()
    _, tpot = request_latency(reqs)
    tokens = sum(len(x) for x in streams)
    srv.shutdown()
    del srv, pool
    torch.cuda.empty_cache()
    for i, (got, want) in enumerate(zip(streams, base)):
        check(len(got) == len(want), f"tp serve: request {i} gave "
              f"{len(got)} tokens, tp 1 {len(want)}")
    parted = {i: j for i, (got, want) in enumerate(zip(streams, base))
              if (j := parted_at(got, want)) is not None}
    # every rank runs the same forwards (each is a tp-2 forward)
    s0 = time.perf_counter()
    forced = forced_parts(torch, "tp serve", engine, traffic,
                          {"tp1": base, "tp2": streams},
                          LLAMA_ARGMAX_MARGIN)
    forced_s = time.perf_counter() - s0

    def ties(label):
        return sum(len(v) for v in forced[label][1].values())

    phase("tp serve", rank=rank, model="LLAMA_7B", tp=TP_SIZE,
          requests=len(traffic), slots=scfg["num_slots"],
          max_model_len=scfg["max_model_len"], ticks=ticks,
          seconds=round(wall, 3), output_tokens=tokens,
          output_tokens_per_s=round(tokens / wall, 1),
          ttft_ms_p50=pct["ttft_ms"]["p50"], ttft_ms_p99=pct["ttft_ms"]["p99"],
          tpot_ms_p50=round(quantile(tpot, 0.5), 3),
          tpot_ms_p99=round(quantile(tpot, 0.99), 3),
          decode_tick_ms_p50=pct["tpot_ms"]["p50"],
          mean_slot_utilization=round(util, 4), pool_gib=round(pool_gib, 3),
          peak_mem_gib=round(peak_gib, 2),
          streams_equal_tp1=len(traffic) - len(parted),
          parted_at=json.dumps(parted), margin=LLAMA_ARGMAX_MARGIN,
          forced_positions_tp1=forced["tp1"][0],
          forced_ties_tp1=ties("tp1"),
          forced_positions_tp2=forced["tp2"][0],
          forced_ties_tp2=ties("tp2"), forced_seconds=round(forced_s, 2),
          forced_tp1=json.dumps(forced["tp1"][1]),
          forced_tp2=json.dumps(forced["tp2"][1]), model_axis=axis)
    del engine
    torch.cuda.empty_cache()
    return launches


def tp_steps(torch, engine, batches, name, rank, per_step_want):
    """``train_batch`` over ``batches``: seconds, losses and the kernels'
    launches a step, each step's checked against ``per_step_want``."""
    import numpy as np
    tp_reset(torch)
    step_s, losses, per_step = [], [], []
    for batch in batches:
        before = counts()
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        loss = engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - s0)
        losses.append(loss.item())
        per_step.append({k: v for k, v in counts_since(before).items() if v})
    check(all(n == per_step_want for n in per_step) and
          all(np.isfinite(losses)),
          f"{name} rank {rank}: launches a step {per_step}, want "
          f"{per_step_want}; losses {losses}")
    return step_s, losses, counts()


def tp_train(torch, rank):
    """GPT-2-125M at the main train cell (micro 8, T 1024, gas 4) at tp 2:
    the loss and the gathered gradients of one bf16 micro batch against
    tp 1's, then the cell's train_batch (K1/K2 48 a step a rank, on 6
    heads)."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, GPT2_125M
    cfg, t = GPT2_125M, ZERO_T
    rng = np.random.default_rng(SEED + 5)
    batches = [{"input_ids": rng.integers(
        0, cfg.vocab_size, (TRAIN_GAS, TRAIN_MICRO, t), dtype=np.int64)}
        for _ in range(1 + TP_TIMED)]
    mb = {"input_ids": torch.as_tensor(batches[0]["input_ids"][0]).cuda()}
    tp_vs_tp1(torch, rank, "tp train", lambda tp: GPT2Model(
        cfg, generator=torch.Generator().manual_seed(SEED), device="cuda",
        dtype=torch.bfloat16, tp=tp), mb, TRAIN_GRAD_TOL)

    model = GPT2Model(cfg, generator=torch.Generator().manual_seed(SEED))
    engine = deepspeed_tpu_torch.initialize(model=model, config=dict(
        train_config(1e-4, TRAIN_GAS), tensor_parallel_size=TP_SIZE))[0]
    want = cfg.n_layer * TRAIN_GAS
    step_s, losses, launches = tp_steps(torch, engine, batches, "tp train",
                                        rank, {"K1": want, "K2": want})
    med = statistics.median(step_s[1:])        # the first step warms
    tokens = TRAIN_GAS * TRAIN_MICRO * t
    phase("tp train", rank=rank, model="GPT2_125M", tp=TP_SIZE,
          heads_per_rank=cfg.n_head // TP_SIZE, micro=TRAIN_MICRO,
          gas=TRAIN_GAS, seq=t, steps=len(step_s), timed=TP_TIMED,
          seconds=json.dumps([round(x, 4) for x in step_s]),
          median_s=round(med, 4), tokens_per_s=round(tokens / med, 1),
          losses=json.dumps([round(x, 4) for x in losses]),
          launches=json.dumps(launches),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2),
          model_axis=tp_axis_stats())
    del engine, model
    torch.cuda.empty_cache()
    return launches


def tp_train_llama(torch, rank):
    """LLaMA-7B's width at 4 layers (micro 4, T 2048, gas 2) at tp 2: the
    loss and the gathered gradients of one bf16 micro batch against tp 1's,
    the cell's train_batch (K3 and K3b/K5 8 a step a rank, on 16 heads),
    a repeated batch that must converge."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LLAMA_7B
    cfg = dataclasses.replace(LLAMA_7B, n_layer=LLAMA_TRAIN_LAYERS)
    t, gas, micro = LLAMA_T, LLAMA_GAS, LLAMA_MICRO
    rng = np.random.default_rng(SEED + 14)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size,
                                          (gas, micro, t), dtype=np.int64)}
               for _ in range(1 + TP_TIMED)]
    mb = {"input_ids": torch.as_tensor(batches[0]["input_ids"][0]).cuda()}
    tp_vs_tp1(torch, rank, "tp train llama", lambda tp: llama_model(
        torch, cfg, SEED + 13, torch.bfloat16, tp=tp), mb, LLAMA_GRAD_TOL)

    conf = dict(llama_train_config(1e-4, gas), tensor_parallel_size=TP_SIZE)
    engine = deepspeed_tpu_torch.initialize(
        model=llama_model(torch, cfg, SEED + 13, torch.float32),
        config=conf)[0]
    want = cfg.n_layer * gas
    step_s, losses, launches = tp_steps(torch, engine, batches,
                                        "tp train llama", rank,
                                        {"K3": want, "K3b/K5": want})
    med = statistics.median(step_s[1:])        # the first step warms
    phase("tp train llama", rank=rank,
          model=f"LLAMA_7B width, {cfg.n_layer} layers", tp=TP_SIZE,
          heads_per_rank=cfg.n_head // TP_SIZE, micro=micro, gas=gas, seq=t,
          params_per_rank=engine.module.num_params(), steps=len(step_s),
          timed=TP_TIMED, seconds=json.dumps([round(x, 4) for x in step_s]),
          median_s=round(med, 4), tokens_per_s=round(gas * micro * t / med, 1),
          losses=json.dumps([round(x, 4) for x in losses]),
          launches=json.dumps(launches),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2),
          model_axis=tp_axis_stats())
    del engine
    torch.cuda.empty_cache()

    engine = deepspeed_tpu_torch.initialize(
        model=llama_model(torch, cfg, SEED + 13, torch.float32),
        config=dict(llama_train_config(LLAMA_CONVERGE_LR, 1),
                    tensor_parallel_size=TP_SIZE))[0]
    batch = {"input_ids": rng.integers(0, 256, (1, micro, t))}
    losses = [engine.train_batch(batch=batch).item()
              for _ in range(TP_CONVERGE_STEPS)]
    check(losses[-1] < CONVERGE_FRACTION * losses[0],
          f"tp train llama: loss on a repeated batch went {losses[0]} -> "
          f"{losses[-1]}, want below {CONVERGE_FRACTION} x the first")
    if rank == 0:
        phase("tp train llama converges", steps=TP_CONVERGE_STEPS,
              lr=LLAMA_CONVERGE_LR,
              losses=json.dumps([round(x, 4) for x in losses]),
              threshold=f"last < {CONVERGE_FRACTION} x first")
    del engine
    torch.cuda.empty_cache()
    return launches


# Slice 11 (row A8b2): the tensor-parallel cases A8b left, on the same 2
# ranks. tp bert forward: BERT-large + Fixed at BERT_SERVE_LAYERS on [4,
# 4096] (K6 once a layer a call a rank on its 8 heads' rows of the
# layout), a warm-up and
# TP_BERT_TIMED calls, against tp 1; tp bert train loop: 4 layers, the
# user loop with dropout 0.1 (its masks, the loss and the gathered
# gradients of one micro batch against tp 1 on the same keys), then
# TP_LOOP_STEPS steps; tp gpt2 train loop: the gpt2 train loop's model
# and config (dropout on the rank's heads of the probabilities: the
# dropout kernel under its head map), the same checks, TP_LOOP_STEPS
# steps; tp serve handoff: lanes of tp serve's engine extracted whole and
# put back, then GPT-2-125M prefill (4 slots) -> decode (8 x 1024) at tp
# 2 on TP_GPT2_SERVE; tp serve spec model: a 2-layer mode "model" draft
# at k 4; tp serve deadlines: rank 1's clock 10 s ahead of rank 0's, one
# request's timeout_s expiring mid-run; tp ckpt megatron: ckpt
# megatron's tp 2 x pp 2 directory at tp 2 against the merged one at tp
# 1; tp llama kv replicated: LLaMA-2-70B's width, 1 layer, one kv head
# (a synthetic MQA variant: no LLaMA configuration has fewer kv heads
# than two ranks, and one card runs two ranks) against tp 1.
TP_BERT_TIMED, TP_LOOP_STEPS = 2, 2
TP_GPT2_SERVE = dict(SERVE_GPT2, requests=8, new=(24, 16, 32))
TP_DEADLINE_TICK, TP_CLOCK_SKEW = 6, 10.0
TP_KV_SHAPE = (2, 1024)


def tp_bert_forward(torch, rank):
    """BERT-large with the Fixed surgery scoring ``[4, 4096]`` at
    BERT_SERVE_LAYERS layers at tp 2, against the tp-1 engine's logits."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.bert import BERT_LARGE
    cfg = dataclasses.replace(BERT_LARGE, n_layer=BERT_SERVE_LAYERS)
    ids = torch.randint(1000, cfg.vocab_size, (BERT_MICRO, BERT_T),
                        generator=torch.Generator().manual_seed(SEED + 31))
    ref = None
    if rank == 0:
        one = deepspeed_tpu_torch.init_inference(
            bert_model(torch, torch.bfloat16, SEED + 30, BERT_SERVE_LAYERS,
                       tp=1)[0], {"dtype": "bf16"})
        ref = one(ids)
        del one
        torch.cuda.empty_cache()
    comm.barrier()
    engine = deepspeed_tpu_torch.init_inference(
        bert_model(torch, torch.bfloat16, SEED + 30, BERT_SERVE_LAYERS)[0],
        {"dtype": "bf16", "tensor_parallel": {"tp_size": TP_SIZE}})
    tp_reset(torch)
    fwd_s, per_call = [], []
    for _ in range(1 + TP_BERT_TIMED):          # the first call warms
        before = counts()["K6"]
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        logits = engine(ids)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - s0)
        per_call.append(counts()["K6"] - before)
    launches = counts()
    check(per_call == [cfg.n_layer] * len(fwd_s) and launches["K3"] == 0,
          f"tp bert forward rank {rank}: K6 launched {per_call} times a "
          f"call, want {cfg.n_layer}; K3 {launches['K3']}")
    med = statistics.median(fwd_s[1:])
    phase("tp bert forward", rank=rank, model=f"BERT_LARGE + Fixed sparse, "
          f"{cfg.n_layer} layers",
          tp=TP_SIZE, heads_per_rank=cfg.n_head // TP_SIZE,
          shape=list(logits.shape), calls=len(fwd_s), timed=TP_BERT_TIMED,
          seconds=json.dumps([round(x, 4) for x in fwd_s]),
          median_s=round(med, 4),
          tokens_per_s=round(ids.numel() / med, 1),
          k6_launches_per_call=json.dumps(per_call),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2),
          model_axis=tp_axis_stats())
    if rank == 0:
        compare_logits(torch, "tp bert forward vs tp 1", logits, ref,
                       BERT_LOGITS_TOL)
    del engine, logits, ref
    torch.cuda.empty_cache()
    return launches


class DropoutMasks:
    """Inside the block, a digest of every forward dropout's mask (the
    kernel on ones under the call's key and map): the tensor's shape, its
    counter map, the count and index sum of the elements it zeroes, and,
    for probabilities ``[B, H, T, T]`` drawn whole (tp 1), the same digest
    of each tp rank's heads of that mask (``None`` otherwise). Comparable
    between runs: the order of the calls and their bits."""

    def __enter__(self):
        import torch
        from deepspeed_tpu_torch.ops import dropout as drop
        self.fn, self.seen = drop._TokenDropout, []
        real = self.fn.apply

        def digest(zeroed):
            zeroed = zeroed.flatten()
            idx = torch.arange(zeroed.numel(), device=zeroed.device)
            return int(zeroed.sum()), int((idx * zeroed).sum())

        def recorded(x, k0, k1, rate, where):
            from deepspeed_tpu_torch.ops.kernels import threefry_dropout
            with torch.no_grad():       # the mask alone: dropout of ones
                zeroed = (threefry_dropout.threefry_dropout(
                    torch.ones_like(x), (k0, k1), rate, *where) == 0)
                heads = None
                if x.dim() == 4 and where[1] == where[2]:
                    heads = tuple(digest(part) for part in
                                  zeroed.chunk(TP_SIZE, dim=1))
                self.seen.append((tuple(x.shape), tuple(where)) +
                                 digest(zeroed) + (heads,))
            return real(x, k0, k1, rate, where)
        self.fn.apply = recorded
        return self

    def __exit__(self, *exc):
        del self.fn.apply


def tp_loop_vs_tp1(torch, rank, name, build, mb, tol, kwargs):
    """``tp_vs_tp1`` with a training key and modifiers (``kwargs`` of
    ``apply``), each forward dropout's mask digested (``DropoutMasks``):
    where the tensor is whole on every rank (the embeddings and the
    sublayer outputs, the contiguous map) the digests must be tp 1's, in
    order; the rest take the head map (the probabilities), and each must
    be the digest of the rank's heads of tp 1's whole mask of the same
    call, in order. Returns the counts of each."""
    from deepspeed_tpu_torch import comm
    with DropoutMasks() as seen:
        tp_vs_tp1(torch, rank, name, build, mb, tol, kwargs)
    ref = None
    if rank == 0:            # tp 1's run came first, then tp 2's
        n = len(seen.seen) // 2
        ref = seen.seen[:n]
    ref = comm.broadcast_object(ref, src=0)
    mine = seen.seen[len(seen.seen) - len([d for d in ref]):] \
        if rank == 0 else seen.seen
    whole = [d[:4] for d in mine if d[1][1] == d[1][2]]
    heads = [d[2:4] for d in mine if d[1][1] != d[1][2]]
    want = [d[:4] for d in ref if len(d[0]) == 3]
    want_heads = [d[4][rank] for d in ref if d[4] is not None]
    check(whole == want,
          f"{name} rank {rank}: the whole tensors' dropout masks differ "
          f"from tp 1's ({len(whole)} calls, tp 1 {len(want)}; "
          f"{sum(a != b for a, b in zip(whole, want))} differ)")
    check(heads == want_heads,
          f"{name} rank {rank}: the head-mapped dropout masks differ from "
          f"the rank's heads of tp 1's masks ({len(heads)} calls, tp 1 "
          f"{len(want_heads)}; {sum(a != b for a, b in zip(heads, want_heads))}"
          f" differ)")
    return len(whole), len(heads)


def tp_bert_train_loop(torch, rank):
    """BERT-large + Fixed at 4 layers with dropout 0.1 at tp 2: one micro
    batch's masks, loss and gathered gradients against tp 1's on the same
    key, then the user loop (micro 4, T 4096, gas 2) for TP_LOOP_STEPS
    steps (K6 and K7 4 a micro step a rank, the dropout kernel on every
    dropout)."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.bert import BERT_LARGE
    layers, micro, gas, t = BERT_SMALL_LAYERS, BERT_MICRO, BERT_GAS, BERT_T
    rng = np.random.default_rng(SEED + 32)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in bert_batch(
        np, rng, gas, micro, t, 1000, BERT_LARGE.vocab_size).items()}
        for _ in range(TP_LOOP_STEPS)]
    mb = {k: v[0] for k, v in batches[0].items()}
    key = (SEED, 0x5BD1E995)

    def build(tp):
        return with_dropout(bert_model(torch, torch.bfloat16, SEED + 33,
                                       layers, tp=tp)[0], DROPOUT_RATE)

    whole, heads = tp_loop_vs_tp1(torch, rank, "tp bert train loop", build,
                                  mb, BERT_GRAD_TOL,
                                  {"rng": key, "train": True})
    model = with_dropout(bert_model(torch, torch.float32, SEED + 33,
                                    layers, tp=1)[0], DROPOUT_RATE)
    engine = deepspeed_tpu_torch.initialize(model=model, config=dict(
        bert_train_config(1e-4, gas, micro), tensor_parallel_size=TP_SIZE))[0]
    tp_reset(torch)
    step_s, per_step, losses = run_steps(
        torch, lambda b: user_loop_step(engine, b)["loss"], batches)
    want = layers * gas
    check(all(n["K6"] == want and n["K7"] == want and n["dropout"] > 0
              for n in per_step),
          f"tp bert train loop rank {rank}: launches a step {per_step}")
    med = statistics.median(step_s)
    phase("tp bert train loop", rank=rank,
          model=f"BERT_LARGE + Fixed, {layers} layers, dropout "
          f"{DROPOUT_RATE}", tp=TP_SIZE, micro=micro, gas=gas, seq=t,
          steps=len(step_s), seconds=json.dumps([round(x, 4)
                                                 for x in step_s]),
          median_s=round(med, 4), tokens_per_s=round(gas * micro * t / med, 1),
          losses=json.dumps([round(x, 4) for x in losses]),
          launches=json.dumps(counts()), masks_whole_bitwise=whole,
          masks_heads=heads,
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2),
          model_axis=tp_axis_stats())
    launches = counts()
    del engine, model
    torch.cuda.empty_cache()
    return launches


def tp_gpt2_train_loop(torch, rank):
    """GPT-2-125M with dropout 0.1, progressive layer drop and random-LTD
    (``gpt2 train loop``'s config) at tp 2: one micro batch's masks, loss
    and gathered gradients against tp 1's on the same key and modifiers
    (the probabilities dropped on the rank's heads, under the kernel's
    head map), then the user loop for TP_LOOP_STEPS steps."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, GPT2_125M
    cfg = dataclasses.replace(GPT2_125M, dropout=DROPOUT_RATE)
    t, gas, micro = ZERO_T, TRAIN_GAS, TRAIN_MICRO
    rng = np.random.default_rng(SEED + 34)
    batches = [{"input_ids": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (gas, micro, t), dtype=np.int64)).cuda()}
        for _ in range(TP_LOOP_STEPS)]
    mb = {"input_ids": batches[0]["input_ids"][0]}
    kwargs = {"rng": (SEED, 0x27D4EB2F), "train": True,
              "pld_theta": np.float32(0.75), "ltd_keep": 512}
    whole, heads = tp_loop_vs_tp1(torch, rank, "tp gpt2 train loop",
                                  lambda tp: GPT2Model(
                                      cfg, generator=torch.Generator()
                                      .manual_seed(SEED), device="cuda",
                                      dtype=torch.bfloat16, tp=tp),
                                  mb, TRAIN_GRAD_TOL, kwargs)
    check(heads > 0, f"tp gpt2 train loop rank {rank}: no dropout took "
          f"the head map")
    config = dict(train_config(1e-4, gas), progressive_layer_drop=GPT2_PLD,
                  data_efficiency=GPT2_LTD, tensor_parallel_size=TP_SIZE)
    model = GPT2Model(cfg, generator=torch.Generator().manual_seed(SEED))
    engine = deepspeed_tpu_torch.initialize(model=model, config=config)[0]
    tp_reset(torch)
    step_s, per_step, losses = run_steps(
        torch, lambda b: user_loop_step(engine, b)["loss"], batches)
    check(all(n["dropout heads"] > 0 for n in per_step) and
          all(np.isfinite(losses)),
          f"tp gpt2 train loop rank {rank}: launches a step {per_step}, "
          f"losses {losses}")
    med = statistics.median(step_s)
    phase("tp gpt2 train loop", rank=rank,
          model=f"GPT2_125M, dropout {DROPOUT_RATE}, PLD, random-LTD",
          tp=TP_SIZE, micro=micro, gas=gas, seq=t, steps=len(step_s),
          seconds=json.dumps([round(x, 4) for x in step_s]),
          median_s=round(med, 4), tokens_per_s=round(gas * micro * t / med, 1),
          losses=json.dumps([round(x, 4) for x in losses]),
          modifiers=json.dumps([float(engine._last_modifiers[0]),
                                engine._last_modifiers[1]]),
          launches=json.dumps(counts()), masks_whole_bitwise=whole,
          masks_heads=heads,
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2),
          model_axis=tp_axis_stats())
    launches = counts()
    del engine, model
    torch.cuda.empty_cache()
    return launches


_TP_GPT2 = {}


def tp_gpt2_served(torch):
    """GPT-2-125M (``serve gpt2``'s seed) served bf16 at tp 2, its traffic
    (TP_GPT2_SERVE's requests) and the unified tp-2 streams: made once for
    the GPT-2 serving phases (handoff, spec model, deadlines; the last
    frees them)."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, GPT2_125M
    if not _TP_GPT2:
        model = GPT2Model(GPT2_125M, generator=torch.Generator().manual_seed(
            SEED + 72))
        engine = deepspeed_tpu_torch.init_inference(
            model, {"dtype": "bf16", "tensor_parallel": {"tp_size": TP_SIZE}})
        traffic = serve_traffic(np, TP_GPT2_SERVE, GPT2_125M.vocab_size,
                                SEED + 73)
        base, *_rest, srv = serve_run(torch, engine, TP_GPT2_SERVE["cfg"],
                                      traffic)
        srv.shutdown()
        _TP_GPT2.update(engine=engine, traffic=traffic, base=base)
    return _TP_GPT2["engine"], _TP_GPT2["traffic"], _TP_GPT2["base"]


def tp_serve_handoff(torch, rank):
    """At tp 2: lanes of a LLaMA-7B engine extracted whole (its ranks'
    kv heads gathered: the frame tp 1 writes) and inserted back, each rank
    keeping its heads; then GPT-2-125M's prefill role feeding its decode
    role (``disagg_phase``) against the unified tp-2 streams."""
    from deepspeed_tpu_torch.models.llama import LLAMA_7B
    from deepspeed_tpu_torch.serving import KVHandoff
    import numpy as np
    import deepspeed_tpu_torch
    cfg = dataclasses.replace(LLAMA_7B, n_layer=SERVE_LAYERS)
    engine = deepspeed_tpu_torch.init_inference(
        llama_model(torch, cfg, SEED + 70, torch.bfloat16),
        {"dtype": "bf16", "tensor_parallel": {"tp_size": TP_SIZE}})
    max_len = SERVE_LLAMA["cfg"]["max_model_len"]
    prompt = np.random.default_rng(SEED + 76).integers(0, cfg.vocab_size,
                                                       max_len // 4)
    tp_reset(torch)
    pool = engine.init_slot_pool(2, max_len)
    pool, first = engine.slot_prefill(pool, 0, prompt)
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    lane = engine.slot_extract_lane(pool, 0)
    out_ms = (time.perf_counter() - s0) * 1e3
    frame = KVHandoff(prompt=prompt.astype(np.int32), first_token=int(first),
                      kv_len=len(prompt), lane=lane).to_bytes()
    whole = 2 * cfg.n_layer * cfg.kv_head_count * max_len * cfg.head_dim * 2
    back = KVHandoff.from_bytes(frame)
    s0 = time.perf_counter()
    pool = engine.slot_insert_lane(pool, 1, back.lane)
    torch.cuda.synchronize()
    in_ms = (time.perf_counter() - s0) * 1e3
    n = len(prompt)
    equal = all(torch.equal(c[:, 1, :, :n], c[:, 0, :, :n])
                for c in pool.values())
    heads = {int(c.shape[2]) for c in pool.values()}
    header = 10 + int.from_bytes(frame[6:10], "little")
    check(equal and len(frame) - header == whole and
          tuple(lane["k"].shape[2:3]) == (cfg.kv_head_count,) and
          heads == {cfg.kv_head_count // TP_SIZE},
          f"tp serve handoff rank {rank}: lane equal {equal}, frame "
          f"{len(frame)} bytes for {whole} of lanes, heads {heads}")
    phase("tp serve handoff llama", rank=rank, model="LLAMA_7B", tp=TP_SIZE,
          kv_len=n, frame_bytes=len(frame), lane_bytes_tp1=whole,
          frame_mib=round(len(frame) / 2 ** 20, 1), lanes_equal=equal,
          pool_heads=json.dumps(sorted(heads)), out_ms=round(out_ms, 2),
          in_ms=round(in_ms, 2), model_axis=tp_axis_stats())
    del engine, pool, lane, back
    torch.cuda.empty_cache()

    engine, traffic, base = tp_gpt2_served(torch)
    disagg_phase(torch, "tp serve handoff gpt2", engine, traffic, base,
                 ARGMAX_MARGIN, cfg=TP_GPT2_SERVE["cfg"])
    return counts()


def tp_serve_spec_model(torch, rank):
    """GPT-2-125M at tp 2 with a ``mode: "model"`` draft of 2 layers
    (built at tp 2, its 6 heads a rank) at k 4: each stream equals the
    speculation-off stream or parts at a near-tie; acceptance reported."""
    engine, traffic, off = tp_gpt2_served(torch)
    spec = dict(TP_GPT2_SERVE["cfg"], speculative={"enabled": True, "k": 4, "draft": {
        "mode": "model", "n_layer": 2, "seed": SEED + 77}})
    tp_reset(torch)
    on, reqs, _, ticks, wall, srv = serve_run(torch, engine, spec, traffic)
    summary = srv.metrics.summary().get("speculative", {})
    draft = engine.init_draft(srv.config.speculative.draft)
    dheads = draft.model._heads
    srv.shutdown()
    del srv
    check({r.state.value for r in reqs} == {"finished"} and
          dheads == engine.module.config.n_head // TP_SIZE,
          f"tp serve spec model rank {rank}: states or draft heads "
          f"{dheads}")
    parted = stream_parts(torch, "tp serve spec model", engine, traffic,
                          on, off, ARGMAX_MARGIN)
    tokens = sum(len(x) for x in on)
    phase("tp serve spec model", rank=rank, model="GPT2_125M", tp=TP_SIZE,
          draft="model, 2 layers", draft_heads_per_rank=dheads, k=4,
          requests=len(traffic), ticks=ticks, seconds=round(wall, 3),
          output_tokens_per_s=round(tokens / wall, 1),
          acceptance=json.dumps(summary), streams_equal_off=len(traffic) -
          len(parted), parted=json.dumps(parted), margin=ARGMAX_MARGIN,
          model_axis=tp_axis_stats())
    return counts()


def tp_serve_deadlines(torch, rank):
    """GPT-2-125M at tp 2 under clocks that disagree (rank 1's
    TP_CLOCK_SKEW s ahead, each a tick counter in seconds), one request's
    ``timeout_s`` set to expire at tick TP_DEADLINE_TICK: both ranks
    expire it at the same tick and serve identical streams."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.serving import SamplingParams, ServingEngine
    engine, traffic, _ = tp_gpt2_served(torch)
    ticks = [0]
    srv = ServingEngine(engine, TP_GPT2_SERVE["cfg"],
                        clock=lambda: ticks[0] + TP_CLOCK_SKEW * rank)
    late = len(traffic) - 1              # the longest: still running
    rids = [srv.submit(p, SamplingParams(**dict(
        kw, timeout_s=float(TP_DEADLINE_TICK) if i == late else None)))
        for i, (p, kw) in enumerate(traffic)]
    expired = {}
    s0 = time.perf_counter()
    while srv.step():
        ticks[0] += 1
        for i, r in enumerate(rids):
            if srv.result(r).state.value == "timeout":
                expired.setdefault(i, ticks[0])
    wall = time.perf_counter() - s0
    streams = [list(srv.result(r).tokens) for r in rids]
    states = [srv.result(r).state.value for r in rids]
    timeouts = srv.metrics.timeouts
    srv.shutdown()
    mine = (expired, streams, states)
    rank0 = comm.broadcast_object(mine, src=0)
    check(mine == rank0 and list(expired) == [late] and timeouts == 1,
          f"tp serve deadlines rank {rank}: expired {expired} (rank 0 "
          f"{rank0[0]}), streams equal {streams == rank0[1]}")
    phase("tp serve deadlines", rank=rank, model="GPT2_125M", tp=TP_SIZE,
          clock_skew_s=TP_CLOCK_SKEW * rank, requests=len(traffic),
          ticks=ticks[0], seconds=round(wall, 3),
          expired=json.dumps(expired), streams_equal_rank0=True,
          states=json.dumps(states), model_axis=tp_axis_stats())
    launches = counts()
    del engine
    _TP_GPT2.clear()
    torch.cuda.empty_cache()
    return launches


def tp_ckpt_megatron(torch, rank):
    """``ckpt megatron``'s tp 2 x pp 2 directory served at tp 2 (merged on
    each rank, which keeps its part): its logits against the merged
    directory served at tp 1; each rank's host peak while loading."""
    import shutil
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.gpt2 import GPT2_125M
    cfg = GPT2_125M
    root = f"{CKPT_DIR}/megatron_tp"
    ids = torch.randint(0, cfg.vocab_size, (8, cfg.n_positions),
                        generator=torch.Generator().manual_seed(SEED + 96))
    ref = None
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
        full = megatron_tensors(np, cfg, CKPT_MEGATRON_VOCAB, SEED + 95)
        write_megatron(torch, f"{root}/grid", full, CKPT_MEGATRON_TP,
                       CKPT_MEGATRON_PP, 0, cfg.n_head, cfg.n_layer)
        del full
        one = deepspeed_tpu_torch.init_inference(f"{root}/grid",
                                                 {"dtype": "bfloat16"})
        ref = one(ids)
        del one
        torch.cuda.empty_cache()
    comm.barrier()
    tp_reset(torch)
    with RssPeak() as peak:
        engine = deepspeed_tpu_torch.init_inference(
            f"{root}/grid", {"dtype": "bfloat16",
                             "tensor_parallel": {"tp_size": TP_SIZE}})
    logits = engine(ids)
    launches = counts()
    check(engine.tp.size == TP_SIZE and launches["K1"] == cfg.n_layer,
          f"tp ckpt megatron rank {rank}: tp {engine.tp.size}, K1 "
          f"{launches['K1']}")
    phase("tp ckpt megatron", rank=rank,
          model=f"GPT2_125M (vocab {CKPT_MEGATRON_VOCAB})",
          layout=f"tp{CKPT_MEGATRON_TP} x pp{CKPT_MEGATRON_PP} v0 at tp "
          f"{TP_SIZE}", load_s=round(peak.seconds, 2),
          host_peak_gib=round(peak.gib, 3), k1_launches=launches["K1"],
          params_per_rank=engine.module.num_params())
    if rank == 0:
        compare_logits(torch, "tp ckpt megatron vs tp 1", logits, ref,
                       LLAMA_LOGITS_TOL)
    comm.barrier()
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    del engine, logits, ref
    torch.cuda.empty_cache()
    return launches


def tp_llama_kv_replicated(torch, rank):
    """LLaMA-2-70B's width (8192, 64 heads), 1 layer, n_kv_head 1 (a
    synthetic MQA variant) at tp 2: each rank holds 32 query heads and the
    one kv head; logits against tp 1; each rank's pool one kv head."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.llama import LLAMA2_70B
    cfg = dataclasses.replace(LLAMA2_70B, n_layer=1, n_kv_head=1)
    ids = torch.randint(0, cfg.vocab_size, TP_KV_SHAPE,
                        generator=torch.Generator().manual_seed(SEED + 81))
    ref = None
    if rank == 0:
        one = deepspeed_tpu_torch.init_inference(
            llama_model(torch, cfg, SEED + 80, torch.bfloat16, tp=1),
            {"dtype": "bf16"})
        ref = one(ids)
        del one
        torch.cuda.empty_cache()
    comm.barrier()
    engine = deepspeed_tpu_torch.init_inference(
        llama_model(torch, cfg, SEED + 80, torch.bfloat16),
        {"dtype": "bf16", "tensor_parallel": {"tp_size": TP_SIZE}})
    tp_reset(torch)
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    logits = engine(ids)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - s0
    launches = counts()
    pool = engine.init_slot_pool(2, 256)
    heads = {int(c.shape[2]) for c in pool.values()}
    check(heads == {1} and engine.module.kv_heads == 1 and
          launches["K3"] == cfg.n_layer,
          f"tp llama kv replicated rank {rank}: pool heads {heads}, K3 "
          f"{launches['K3']}")
    phase("tp llama kv replicated", rank=rank,
          model="LLAMA2_70B width, 1 layer, n_kv_head 1 (synthetic MQA "
          "variant)", tp=TP_SIZE, q_heads_per_rank=engine.module._heads,
          kv_heads_per_rank=1, shape=list(logits.shape),
          seconds=round(fwd_s, 4), pool_heads=1,
          params_per_rank=engine.module.num_params(),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2),
          model_axis=tp_axis_stats())
    if rank == 0:
        compare_logits(torch, "tp llama kv replicated vs tp 1", logits, ref,
                       LLAMA_LOGITS_TOL)
    del engine, logits, ref, pool
    torch.cuda.empty_cache()
    return launches


TP_PHASES = (("tp forward", tp_forward), ("tp serve", tp_serve),
             ("tp train", tp_train), ("tp train llama", tp_train_llama),
             ("tp bert forward", tp_bert_forward),
             ("tp bert train loop", tp_bert_train_loop),
             ("tp gpt2 train loop", tp_gpt2_train_loop),
             ("tp serve handoff", tp_serve_handoff),
             ("tp serve spec model", tp_serve_spec_model),
             ("tp serve deadlines", tp_serve_deadlines),
             ("tp ckpt megatron", tp_ckpt_megatron),
             ("tp llama kv replicated", tp_llama_kv_replicated))


def tp_rank(rank, store, out_dir, names):
    """One rank of the tensor-parallel phases: a gloo group over CUDA
    tensors on the card, the rank mesh at tp TP_SIZE, the phases ``names``
    in turn; their launch counts to ``out_dir/rank<r>.json``."""
    import os
    import torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.topology import initialize_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    comm.init_distributed("gloo", init_method=f"file://{store}", rank=rank,
                          world_size=TP_SIZE, device="cuda", timeout=600,
                          verbose=False)
    try:
        initialize_mesh(tp=TP_SIZE)
        out = {name: fn(torch, rank) for name, fn in TP_PHASES
               if name in names}
    finally:
        comm.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def tp_phases(torch, names=tuple(name for name, _ in TP_PHASES)):
    """The tensor-parallel phases on TP_SIZE ranks of the one card, spawned
    once; a rank that fails fails the script, and every rank is stopped
    before this returns. Returns each kernel's launches, summed over the
    phases and the ranks."""
    import os
    import shutil
    import torch.multiprocessing as mp
    torch.cuda.empty_cache()
    store = os.path.abspath(TP_STORE)
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    shutil.rmtree(TP_OUT, ignore_errors=True)
    os.makedirs(TP_OUT)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=tp_rank, args=(r, store, TP_OUT, names))
             for r in range(TP_SIZE)]
    s0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or \
                    time.perf_counter() - s0 > TP_TIMEOUT:
                break
            time.sleep(1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    check(codes == [0] * TP_SIZE, f"tensor-parallel ranks exited {codes} "
          f"after {time.perf_counter() - s0:.1f} s (limit {TP_TIMEOUT})")
    launches = {}
    for r in range(TP_SIZE):
        with open(os.path.join(TP_OUT, f"rank{r}.json")) as f:
            for counted in json.load(f).values():
                for k, v in counted.items():
                    launches[k] = launches.get(k, 0) + v
    phase("tp ranks", ranks=TP_SIZE, group="gloo over CUDA tensors, one card",
          phases=json.dumps(list(names)),
          seconds=round(time.perf_counter() - s0, 2),
          launches=json.dumps(launches))
    return launches


# ---------------------------------------------------------------- slice 12
# The quantization core and its three users. ZeRO under comm_compression:
# GPT-2-125M on ZQ ranks of a gloo group over CUDA tensors on the one card
# (gloo stages every collective through host memory: the times show that
# the paths run, not what they cost across cards), the JAX package's
# explicit exchange (runtime/zero/compressed_step.py): zero compressed at
# stage 3 with int8 on the all-gather, reduce-scatter and all-reduce, then
# fp8_block on the same batch, each micro step's gradients and loss held
# to the fp32 policy's on the same weights (TRAIN_GRAD_TOL), each micro
# step's accounted wire bytes to the models of comm/quantized.py, a
# repeated batch converging within ZQ_CONVERGE_STEPS, K1/K2 12 a step a
# rank; zero overlap: the bucketed schedule at ZQ_BUCKET bytes against the
# per-leaf exchange, bitwise under fp32, the bucket count and issue order,
# a step's time with overlap on and off; zero hierarchical: 4 ranks as 2
# hosts of 2 (devices_per_host), stage 2, the intra- and inter-host bytes
# against the models, the gradients as above. Int8 serving (LLaMA-7B's
# width at SERVE_LAYERS layers, bf16 compute): serve int8, weight-only
# int8 (inference/quantization.py), resident bytes beside bf16, scoring
# [4, 2048] (K3 a layer a call) held to llama vs plain path's bounds
# against the same int8 weights on the plain attention path and an f32
# copy of them, ZQ_SERVE_REQUESTS of the serve traffic (new tokens capped
# at ZQ_SERVE_NEW) teacher-forced through the plain forward as in tp
# serve; serve kv int8, the int8 slot pool (inference/kv_quant.py) at the
# serve config's 16 x 2048: pool bytes beside bf16, one decode tick's
# logits against an f32 decode from the same pool, each written column's
# payload and scales bitwise quantize_kv of the K/V a bf16 pool from the
# same pool computes, and an int8 lane through the KVHandoff frame into
# another slot, the same bytes.
ZQ_STORE, ZQ_OUT = "build/zq_store", "build/zq_out"
ZQ_MICRO, ZQ_T, ZQ_LR = 2, 1024, 3e-3
ZQ_CONVERGE_STEPS, ZQ_TIMED, ZQ_BUCKET = 4, 2, 4 << 20
ZQ_SERVE_REQUESTS, ZQ_SERVE_NEW = 8, 64
ZQ_KV_PROMPTS = (300, 700, 1200, 150)
# against the fp32 policy: int8 within the train cell's bounds; fp8 e4m3
# keeps 3 mantissa bits, a relative rounding error up to 2^-4 an element
# each time a value is quantized, and a replicated leaf's gradient is
# quantized three times on its way (the gathered weights it is taken at,
# the all-reduce's two legs): 3 x 2^-4 ~ 0.19 a leaf (0.115 measured at
# blocks.0.ln1_scale on an H100 80GB HBM3 at 700 W, PERF.md)
ZQ_GRAD_TOL = {"int8": TRAIN_GRAD_TOL,
               "fp8_block": {"rel_l2_per_leaf": 0.2, "loss_abs": 2e-2}}


def zq_config(world, stage, cc=None, sched=None):
    cfg = {"train_batch_size": ZQ_MICRO * world,
           "train_micro_batch_size_per_gpu": ZQ_MICRO,
           "gradient_accumulation_steps": 1,
           "optimizer": {"type": "adamw", "params": {"lr": ZQ_LR}},
           "bf16": {"enabled": True},
           "zero_optimization": {"stage": stage}, "steps_per_print": 0}
    if cc is not None:
        cfg["comm_compression"] = cc
    if sched is not None:
        cfg["overlap_schedule"] = dict(sched, enabled=True)
    return cfg


def zq_policy(policy, **extra):
    return dict({"enabled": True, "all_gather": policy,
                 "reduce_scatter": policy, "all_reduce": policy}, **extra)


def zq_engine(torch, world, stage, cc=None, sched=None):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, GPT2_125M
    model = GPT2Model(GPT2_125M, generator=torch.Generator().manual_seed(SEED))
    return deepspeed_tpu_torch.initialize(
        model=model, config=zq_config(world, stage, cc, sched))[0]


def zq_batch(world, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 256, (1, ZQ_MICRO * world, ZQ_T),
                                      dtype=np.int64)}


def zq_wire_model(engine):
    """``(wire, inter)`` bytes one micro step of the explicit exchange puts
    on a member's links under the engine's policy: the models of
    comm/quantized.py (and the plain ring's where the dispatch keeps full
    precision), leaf by leaf as the dispatch decides, and the loss's
    all-reduce."""
    from deepspeed_tpu_torch.comm import compression, quantized as qz
    cc = compression.get_comm_compression()
    n = engine.dp_world_size
    itemsize = torch_itemsize(engine._compute_dtype)
    local = cc.local_members(n) if cc.hierarchical else 0
    wire = inter = 0

    def flat(w):
        return w * (n // local) // n if local else 0

    for leaf in engine._compressed_micro_grad(None).leaves:
        size = math.prod(leaf.shape)
        if leaf.gdim >= 0:
            shard = size // n
            pol = cc.policy_for("all_gather", "data", shard * itemsize)
            w = qz.quantized_all_gather_wire_bytes(shard, n, cc.block_size) \
                if pol in ("int8", "fp8_block") else \
                (n - 1) * shard * itemsize
            wire, inter = wire + w, inter + flat(w)
        nbytes = size * itemsize
        if leaf.sdim >= 0:
            pol = cc.policy_for("reduce_scatter", "data", nbytes)
            if pol in ("int8", "fp8_block") and local:
                i, e = qz.hierarchical_reduce_scatter_wire_bytes(
                    size, n, local, cc.block_size, itemsize)
                wire, inter = wire + i + e, inter + e
                continue
            w = qz.quantized_reduce_scatter_wire_bytes(
                size, n, cc.block_size) if pol in ("int8", "fp8_block") \
                else (n - 1) * nbytes // n
        else:
            pol = cc.policy_for("all_reduce", "data", nbytes)
            w = qz.quantized_all_reduce_wire_bytes(size, n, cc.block_size) \
                if pol in ("int8", "fp8_block") and size % n == 0 else \
                2 * (n - 1) * nbytes // n
        wire, inter = wire + w, inter + flat(w)
    w = 2 * (n - 1) * 4 // n                  # the loss, f32, below min_bytes
    return wire + w, inter + flat(w)


def torch_itemsize(dtype):
    import torch
    return torch.empty((), dtype=dtype).element_size()


def zq_micro(torch, engine, batch):
    """One micro step (forward + backward) of ``batch``'s first micro
    batch: the averaged loss, the whole f32 gradients (on rank 0, else
    None; gathered at full precision) and the step's wire bytes, inter-host
    bytes and ops."""
    from deepspeed_tpu_torch import comm
    mb = {k: torch.as_tensor(v[0]) for k, v in batch.items()}
    torch.cuda.synchronize()
    comm.reset_comm_stats()
    engine.backward(engine(mb))
    torch.cuda.synchronize()
    st = comm.comm_stats()
    loss = float(engine._loss_acc) / engine.cur_scale
    grads = {}
    for i, (name, g) in enumerate(zip(engine._names, engine._grad_acc)):
        ps = engine._pshards[i]
        whole = engine.whole(i, g) if ps.partitioned and \
            engine._stage >= 2 else g
        grads[name] = whole.float().cpu()
    engine._drop_step_state()
    return loss, grads, st


def zq_rel(got, want):
    rel = {n: ((got[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
           for n, g in want.items()}
    worst = max(rel, key=rel.get)
    return rel, worst


def zq_check_grads(name, rank, loss, grads, ref_loss, ref_grads,
                   tol=TRAIN_GRAD_TOL):
    rel, worst = zq_rel(grads, ref_grads)
    check(rel[worst] <= tol["rel_l2_per_leaf"] and
          abs(loss - ref_loss) <= tol["loss_abs"],
          f"{name} rank {rank}: worst leaf {worst} rel L2 {rel[worst]}, "
          f"loss {loss} vs the fp32 policy's {ref_loss} (tol {tol})")
    return {"loss": loss, "loss_fp32_policy": ref_loss,
            "loss_abs_diff": abs(loss - ref_loss),
            "max_rel_l2": rel[worst], "worst_leaf": worst,
            "median_rel_l2": statistics.median(rel.values())}


def zq_check_wire(name, rank, engine, st):
    want, want_inter = zq_wire_model(engine)
    check(st["bytes"] == want and st["inter_host_bytes"] == want_inter,
          f"{name} rank {rank}: a micro step accounted {st['bytes']} wire "
          f"bytes ({st['inter_host_bytes']} inter-host), the models "
          f"{want} ({want_inter})")
    return {"wire_bytes": st["bytes"], "inter_host_bytes":
            st["inter_host_bytes"], "ops": st["ops"], "model_bytes": want}


def zero_compressed(torch, rank, world):
    """GPT-2-125M at stage 3 on ``world`` ranks: the fp32 policy's micro
    step, int8's and fp8_block's on the same weights and batch (gradients
    and wire bytes checked), then int8 train_batch on a repeated batch
    (K1/K2 12 a step a rank, the loss falling)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm import compression
    batch = zq_batch(world, SEED + 90)
    out, launches = {}, {"K1": 0, "K2": 0}
    ref = None
    for policy in ("fp32", "int8", "fp8_block"):
        engine = zq_engine(torch, world, 3, zq_policy(policy))
        check(engine._explicit and engine._stage == 3,
              f"zero compressed: the {policy} engine is not on the explicit "
              f"stage-3 exchange")
        tp_reset(torch)
        s0 = time.perf_counter()
        loss, grads, st = zq_micro(torch, engine, batch)
        secs = time.perf_counter() - s0
        wire = zq_check_wire("zero compressed", rank, engine, st)
        out[policy] = dict(wire, seconds=round(secs, 3), loss=loss)
        if policy == "fp32":
            ref = (loss, grads)
        elif rank == 0:
            out[policy].update(zq_check_grads(
                f"zero compressed {policy}", rank, loss, grads, *ref,
                tol=ZQ_GRAD_TOL[policy]))
        if policy == "int8":
            # a repeated batch: the loss falls, K1/K2 a layer a step
            losses, per_step, step_s = [], [], []
            for _ in range(ZQ_CONVERGE_STEPS):
                before = counts()
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                losses.append(float(engine.train_batch(batch=batch)))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - s0)
                per_step.append(counts_since(before))
            n_layer = engine.module.config.n_layer
            check(all(p["K1"] == n_layer and p["K2"] == n_layer
                      for p in per_step),
                  f"zero compressed rank {rank}: K1/K2 launches a step "
                  f"{[(p['K1'], p['K2']) for p in per_step]}, want "
                  f"{n_layer} each")
            check(min(losses[1:]) < CONVERGE_FRACTION * losses[0],
                  f"zero compressed rank {rank}: int8 losses on a repeated "
                  f"batch {losses}, want below {CONVERGE_FRACTION} x the "
                  f"first within {ZQ_CONVERGE_STEPS} steps")
            for p in per_step:
                launches["K1"] += p["K1"]
                launches["K2"] += p["K2"]
            out["converge"] = {"losses": [round(x, 4) for x in losses],
                               "step_s": [round(x, 3) for x in step_s]}
        del engine
        torch.cuda.empty_cache()
        compression.reset_comm_compression()
    ratio = {p: round(out[p]["wire_bytes"] / out["fp32"]["wire_bytes"], 6)
             for p in ("int8", "fp8_block")}
    phase("zero compressed", rank=rank, ranks=world, model="GPT2_125M",
          stage=3, micro=ZQ_MICRO, seq=ZQ_T,
          group="gloo over CUDA tensors, one card",
          wire_ratio_vs_fp32=json.dumps(ratio), runs=json.dumps(out),
          launches=json.dumps(launches), tol=json.dumps(ZQ_GRAD_TOL))
    comm.barrier()
    return launches


def zero_overlap(torch, rank, world):
    """The bucketed schedule (ZQ_BUCKET bytes) against the per-leaf
    explicit exchange at stage 3 under the fp32 policy: one micro step's
    gradients and loss bitwise; the plan, the issue order, and a step's
    time with overlap on and off."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm import compression
    batch = zq_batch(world, SEED + 91)
    cc = zq_policy("fp32")
    res, times, launches = {}, {}, {"K1": 0, "K2": 0}
    for label, sched in (("per_leaf", None),
                         ("bucketed", {"bucket_bytes": ZQ_BUCKET}),
                         ("fused", {"overlap": False})):
        engine = zq_engine(torch, world, 3, cc, sched)
        before = counts()
        loss, grads, st = zq_micro(torch, engine, batch)
        xfn = engine._compressed_micro_grad(None)
        res[label] = (loss, grads, list(getattr(xfn, "issue_log", [])),
                      engine._sched_info, st)
        step_s = []
        for _ in range(1 + ZQ_TIMED):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            engine.train_batch(batch=batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - s0)
        got = counts_since(before)
        launches["K1"] += got["K1"]
        launches["K2"] += got["K2"]
        times[label] = statistics.median(step_s[1:])
        del engine
        torch.cuda.empty_cache()
    compression.reset_comm_compression()
    base_loss, base = res["per_leaf"][:2]
    for label in ("bucketed", "fused"):
        loss, grads, issue, info, st = res[label]
        same = loss == base_loss and all(
            torch.equal(grads[n], g) for n, g in base.items())
        check(same, f"zero overlap rank {rank}: the {label} exchange's "
              f"gradients are not bitwise the per-leaf exchange's")
        gathers = [k for kind, k in issue if kind == "gather"]
        scatters = [k for kind, k in issue if kind == "reduce_scatter"]
        check(gathers == list(range(info["gather_buckets"])) and
              scatters == list(range(info["rs_buckets"]))[::-1],
              f"zero overlap rank {rank}: {label} issue order {issue}")
    info = res["bucketed"][3]
    phase("zero overlap", rank=rank, ranks=world, model="GPT2_125M",
          stage=3, policy="fp32", bucket_bytes=ZQ_BUCKET,
          gather_buckets=info["gather_buckets"],
          rs_buckets=info["rs_buckets"],
          layer_chunks=len(info["layer_chunks"]),
          issue_order=json.dumps(res["bucketed"][2]),
          fused_buckets=json.dumps([res["fused"][3]["gather_buckets"],
                                    res["fused"][3]["rs_buckets"]]),
          grads_bitwise_per_leaf=True,
          ops_per_micro=json.dumps({k: v[4]["ops"] for k, v in res.items()}),
          wire_bytes_per_micro=json.dumps(
              {k: v[4]["bytes"] for k, v in res.items()}),
          step_s=json.dumps({k: round(v, 4) for k, v in times.items()}),
          launches=json.dumps(launches))
    comm.barrier()
    return launches


def zero_hierarchical(torch, rank, world):
    """Stage 2 on ``world`` ranks as hosts of 2 (devices_per_host 2): the
    int8 two-level reduce-scatter's micro step against the fp32 policy's
    (gradients), and its intra- and inter-host bytes against the
    models."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm import compression
    batch = zq_batch(world, SEED + 92)
    out, ref = {}, None
    for policy in ("fp32", "int8"):
        engine = zq_engine(torch, world, 2, zq_policy(
            policy, devices_per_host=2))
        tp_reset(torch)
        loss, grads, st = zq_micro(torch, engine, batch)
        out[policy] = zq_check_wire("zero hierarchical", rank, engine, st)
        out[policy]["intra_host_bytes"] = st["intra_host_bytes"]
        if policy == "fp32":
            ref = (loss, grads)
        elif rank == 0:
            out[policy].update(zq_check_grads(
                "zero hierarchical", rank, loss, grads, *ref))
        del engine
        torch.cuda.empty_cache()
        compression.reset_comm_compression()
    check(0 < out["int8"]["inter_host_bytes"] <
          out["fp32"]["inter_host_bytes"],
          f"zero hierarchical rank {rank}: inter-host bytes "
          f"{out['int8']['inter_host_bytes']} under int8, "
          f"{out['fp32']['inter_host_bytes']} under fp32")
    phase("zero hierarchical", rank=rank, ranks=world, hosts=world // 2,
          devices_per_host=2, model="GPT2_125M", stage=2, policy="int8",
          runs=json.dumps(out), tol=json.dumps(TRAIN_GRAD_TOL))
    comm.barrier()
    return {"K1": 0, "K2": 0}


ZQ_PHASES = (("zero compressed", zero_compressed),
             ("zero overlap", zero_overlap),
             ("zero hierarchical", zero_hierarchical))


def zq_rank(rank, world, store, out_dir, names):
    """One rank of the quantized ZeRO phases: a gloo group of ``world``
    ranks over CUDA tensors on the card, the rank mesh at dp ``world``;
    its launch counts to ``out_dir/rank<r>.json``."""
    import os
    import torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.topology import initialize_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    comm.init_distributed("gloo", init_method=f"file://{store}", rank=rank,
                          world_size=world, device="cuda", timeout=600,
                          verbose=False)
    try:
        initialize_mesh(dp=world)
        out = {name: fn(torch, rank, world) for name, fn in ZQ_PHASES
               if name in names}
    finally:
        comm.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def zq_phases(torch, world, names):
    """The quantized ZeRO phases ``names`` on ``world`` ranks of the one
    card, spawned once; a rank that fails fails the script, and every rank
    is stopped before this returns. Returns K1/K2's launches summed over
    the phases and the ranks."""
    import os
    import shutil
    import torch.multiprocessing as mp
    torch.cuda.empty_cache()
    store = os.path.abspath(f"{ZQ_STORE}{world}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    shutil.rmtree(ZQ_OUT, ignore_errors=True)
    os.makedirs(ZQ_OUT)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=zq_rank, args=(r, world, store, ZQ_OUT,
                                               names))
             for r in range(world)]
    s0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or \
                    time.perf_counter() - s0 > TP_TIMEOUT:
                break
            time.sleep(1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    check(codes == [0] * world, f"quantized ZeRO ranks exited {codes} "
          f"after {time.perf_counter() - s0:.1f} s (limit {TP_TIMEOUT})")
    launches = {"K1": 0, "K2": 0}
    for r in range(world):
        with open(os.path.join(ZQ_OUT, f"rank{r}.json")) as f:
            for counted in json.load(f).values():
                for k, v in counted.items():
                    launches[k] = launches.get(k, 0) + v
    phase("zero quantized ranks", ranks=world,
          group="gloo over CUDA tensors, one card",
          phases=json.dumps(list(names)),
          seconds=round(time.perf_counter() - s0, 2),
          launches=json.dumps(launches))
    return launches


def serve_int8(torch):
    """LLaMA-7B's width at SERVE_LAYERS layers with int8 weights (``dtype:
    int8``: bf16 compute): resident bytes beside bf16, scoring ``[4,
    2048]`` against the plain path and an f32 copy of the same int8
    weights, then ZQ_SERVE_REQUESTS requests of the serve traffic
    teacher-forced through the plain forward. Returns K3's launches in
    the scoring calls."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import quantization as tq
    from deepspeed_tpu_torch.models.llama import LLAMA_7B, LlamaModel
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    cfg = dataclasses.replace(LLAMA_7B, n_layer=SERVE_LAYERS)
    model = llama_model(torch, cfg, SEED + 80, torch.bfloat16)
    bf16_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    s0 = time.perf_counter()
    engine = deepspeed_tpu_torch.init_inference(model, {"dtype": "int8"})
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - s0
    resident = tq.tree_nbytes(engine.module)
    qw = [p for p in engine.module.parameters() if tq.is_quantized(p)]
    q_bytes = sum(p.nbytes for p in qw)
    q_bf16 = sum(p.numel() * 2 for p in qw)
    check(engine.dtype == torch.bfloat16 and qw and
          all(p.q.device.type == "cuda" for p in qw),
          "serve int8: no int8 weights on the card")
    b, t = 4, 2048
    ids = torch.randint(0, cfg.vocab_size, (b, t),
                        generator=torch.Generator().manual_seed(SEED + 81))
    fa.flash_attention_fwd.launches = 0
    per_call, fwd_s = [], []
    for _ in range(2):
        before = fa.flash_attention_fwd.launches
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        logits = engine(ids)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - s0)
        per_call.append(fa.flash_attention_fwd.launches - before)
    launches = fa.flash_attention_fwd.launches
    check(per_call == [cfg.n_layer] * 2, f"serve int8: K3 launched "
          f"{per_call} times a scoring call, want {cfg.n_layer}")
    check(torch.isfinite(logits.float()).all().item(),
          "serve int8: logits not finite")
    # the same int8 weights on the plain attention path, and in f32
    mcfg = engine.module.config
    engine.module.config = dataclasses.replace(mcfg, attn_backend="xla")
    try:
        logits_x = engine(ids)
    finally:
        engine.module.config = mcfg
    ref = LlamaModel(dataclasses.replace(cfg, attn_backend="xla"),
                     generator=torch.Generator("cuda").manual_seed(0),
                     device="cuda", dtype=torch.float32)
    with torch.no_grad():
        for r, p in zip(ref.parameters(), engine.module.parameters()):
            r.copy_(p.dequantize(torch.float32) if tq.is_quantized(p)
                    else p.float())
        logits_f32 = ref.logits(ids.cuda())
    del ref
    torch.cuda.empty_cache()
    compare_logits(torch, "serve int8 vs plain path", logits, logits_x,
                   LLAMA_LOGITS_TOL, logits_f32)
    del logits, logits_x, logits_f32
    torch.cuda.empty_cache()
    traffic = [(p, dict(kw, max_new_tokens=min(kw["max_new_tokens"],
                                               ZQ_SERVE_NEW)))
               for p, kw in serve_traffic(np, SERVE_LLAMA, cfg.vocab_size,
                                          SEED + 82)[:ZQ_SERVE_REQUESTS]]
    torch.cuda.reset_peak_memory_stats()
    streams, reqs, util, ticks, wall, srv = serve_run(
        torch, engine, SERVE_LLAMA["cfg"], traffic)
    check({r.state.value for r in reqs} == {"finished"} and
          all(len(r.tokens) == kw["max_new_tokens"]
              for (_, kw), r in zip(traffic, reqs)),
          "serve int8: a request did not finish in full")
    pct = srv.metrics.percentiles()
    ttft, tpot = request_latency(reqs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = sum(len(x) for x in streams)
    srv.shutdown()
    del srv
    torch.cuda.empty_cache()
    forced = forced_parts(torch, "serve int8", engine, traffic,
                          {"int8": streams}, LLAMA_ARGMAX_MARGIN)
    phase("serve int8", model=f"LLAMA_7B width, {cfg.n_layer} layers",
          dtype="int8 weights, bf16 compute", group_size=64,
          quantize_seconds=round(quant_s, 2),
          resident_gib=round(resident / 2 ** 30, 4),
          bf16_gib=round(bf16_bytes / 2 ** 30, 4),
          quantized_leaves_gib=round(q_bytes / 2 ** 30, 4),
          quantized_leaves_bf16_gib=round(q_bf16 / 2 ** 30, 4),
          quantized_ratio=round(q_bytes / q_bf16, 6),
          score_seconds=json.dumps([round(x, 4) for x in fwd_s]),
          score_tokens_per_s=round(b * t / min(fwd_s), 1),
          k3_launches_per_call=per_call, requests=len(traffic),
          ticks=ticks, seconds=round(wall, 3), output_tokens=tokens,
          output_tokens_per_s=round(tokens / wall, 1),
          ttft_ms_p50=round(quantile(ttft, 0.5), 3),
          ttft_ms_p99=round(quantile(ttft, 0.99), 3),
          tpot_ms_p50=round(quantile(tpot, 0.5), 3),
          tpot_ms_p99=round(quantile(tpot, 0.99), 3),
          decode_tick_ms_p50=pct["tpot_ms"]["p50"],
          peak_mem_gib=round(peak, 2),
          forced_positions=forced["int8"][0],
          forced_ties=sum(len(v) for v in forced["int8"][1].values()),
          forced=json.dumps(forced["int8"][1]), margin=LLAMA_ARGMAX_MARGIN)
    del engine, model
    torch.cuda.empty_cache()
    return launches


def serve_kv_int8(torch):
    """LLaMA-7B's width at SERVE_LAYERS layers (bf16) on an int8 slot pool
    of the serve config (16 x 2048): pool bytes beside bf16; prefills of
    ZQ_KV_PROMPTS; one decode tick's logits against an f32 decode from the
    same pool; each written column's bytes against ``quantize_kv`` of the
    K/V a bf16 pool from the same pool computes; an int8 lane through the
    KVHandoff frame into another slot."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.kv_quant import (dequantize_pool,
                                                         pool_nbytes,
                                                         quantize_kv)
    from deepspeed_tpu_torch.models.llama import LLAMA_7B, LlamaModel
    from deepspeed_tpu_torch.serving.fleet import KVHandoff
    cfg = dataclasses.replace(LLAMA_7B, n_layer=SERVE_LAYERS)
    engine = deepspeed_tpu_torch.init_inference(
        llama_model(torch, cfg, SEED + 84, torch.bfloat16), {"dtype": "bf16"})
    model = engine.module
    scfg = SERVE_LLAMA["cfg"]
    slots, max_len = scfg["num_slots"], scfg["max_model_len"]
    torch.cuda.reset_peak_memory_stats()
    pool = engine.init_slot_pool(slots, max_len, quantize=True)
    pool_gib = pool_nbytes(pool) / 2 ** 30
    bf16_gib = 2 * cfg.n_layer * slots * model.kv_heads * max_len * \
        cfg.head_dim * 2 / 2 ** 30
    rng = np.random.default_rng(SEED + 85)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in ZQ_KV_PROMPTS]
    s0 = time.perf_counter()
    firsts = []
    for s, p in enumerate(prompts):
        pool, tok = engine.slot_prefill(pool, s, p)
        firsts.append(tok)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - s0
    pos = np.zeros((slots,), np.int64)
    toks = np.zeros((slots,), np.int64)
    for s, p in enumerate(prompts):
        pos[s], toks[s] = len(p), firsts[s]
    before = {n: (pool.q[n].clone(), pool.scales[n].clone()) for n in pool.q}
    ids = torch.as_tensor(toks, device="cuda")[:, None]
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    with torch.inference_mode():
        logits, _ = model.decode_with_slots(ids, pool, torch.as_tensor(pos))
    torch.cuda.synchronize()
    tick_s = time.perf_counter() - s0
    # the plain path in bf16 and in f32 from the same (pre-tick) pool
    from deepspeed_tpu_torch.inference.kv_quant import QuantizedSlotPool
    old = QuantizedSlotPool({n: v[0] for n, v in before.items()},
                            {n: v[1] for n, v in before.items()},
                            torch.bfloat16)
    fp = dequantize_pool(old, torch.bfloat16)
    with torch.inference_mode():
        model.decode_with_slots(ids, fp, torch.as_tensor(pos))
    bad = []
    for n in ("k", "v"):
        for s in range(slots):
            col = fp[n][:, s, :, int(pos[s])]
            q, sc = quantize_kv(col)
            if not (torch.equal(pool.q[n][:, s, :, int(pos[s])], q) and
                    torch.equal(pool.scales[n][:, s, :, int(pos[s])], sc)):
                bad.append((n, s))
    check(not bad, f"serve kv int8: written columns (name, slot) {bad} are "
          f"not quantize_kv of the plain path's K/V")
    del fp
    torch.cuda.empty_cache()
    ref = LlamaModel(cfg, generator=torch.Generator("cuda").manual_seed(0),
                     device="cuda", dtype=torch.float32)
    with torch.no_grad():
        for r, p in zip(ref.parameters(), model.parameters()):
            r.copy_(p.float())
    fp32 = dequantize_pool(old, torch.float32)
    with torch.inference_mode():
        logits_f32, _ = ref.decode_with_slots(ids, fp32, torch.as_tensor(pos))
    del ref, fp32, old, before
    torch.cuda.empty_cache()
    live = slice(0, len(prompts))
    diff = (logits[live].float() - logits_f32[live]).abs()
    agree = (logits[live].argmax(-1) == logits_f32[live].argmax(-1)) \
        .float().mean().item()
    check(diff.mean().item() <= LLAMA_LOGITS_TOL["mean_abs"] and
          diff.max().item() <= LLAMA_LOGITS_TOL["max_abs"],
          f"serve kv int8: the tick's logits vs the f32 decode from the same "
          f"pool: mean {diff.mean().item()} max {diff.max().item()}")
    # an int8 lane through the frame into another slot
    meta = dict(prompt=prompts[0], first_token=firsts[0],
                kv_len=len(prompts[0]), temperature=0.0, seed=0,
                max_new_tokens=4)
    s0 = time.perf_counter()
    lane = engine.slot_extract_lane(pool, 0)
    blob = KVHandoff(lane=lane, **meta).to_bytes()
    got = KVHandoff.from_bytes(blob)
    pool = engine.slot_insert_lane(pool, slots - 1, got.lane)
    torch.cuda.synchronize()
    hand_s = time.perf_counter() - s0
    same = all(torch.equal(pool.q[n][:, slots - 1], pool.q[n][:, 0]) and
               torch.equal(pool.scales[n][:, slots - 1], pool.scales[n][:, 0])
               for n in pool.q)
    check(same and b'"quantized": true' in blob,
          "serve kv int8: the lane inserted from its frame is not the "
          "extracted one")
    phase("serve kv int8", model=f"LLAMA_7B width, {cfg.n_layer} layers",
          slots=slots, max_model_len=max_len, pool_gib=round(pool_gib, 4),
          bf16_pool_gib=round(bf16_gib, 4),
          pool_ratio=round(pool_gib / bf16_gib, 6),
          prompts=json.dumps(list(ZQ_KV_PROMPTS)),
          prefill_seconds=round(prefill_s, 3),
          tick_ms=round(tick_s * 1e3, 3),
          vs_f32_mean_abs=diff.mean().item(),
          vs_f32_max_abs=diff.max().item(), argmax_agree=agree,
          written_columns_bitwise=2 * slots,
          lane_mib=round(got.nbytes() / 2 ** 20, 3),
          frame_bytes=len(blob), handoff_seconds=round(hand_s, 3),
          lane_equal=True, peak_mem_gib=round(
              torch.cuda.max_memory_allocated() / 2 ** 30, 2),
          tol=json.dumps({k: LLAMA_LOGITS_TOL[k]
                          for k in ("mean_abs", "max_abs")}))
    del engine, model, pool, logits, logits_f32
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- slice 13
# The decoder families of ROADMAP.md row A10 on their published widths,
# random bf16 weights drawn on the card from seeds. gptj forward: GPT-J-6B
# (EleutherAI/gpt-j-6b config.json: 4096 wide, 16 heads of 256, rotary 64
# interleaved, vocab 50400 with the LM-head bias) at GPTJ_LAYERS of its 28
# layers, scoring [4, 2048]: K3 on the warpgroup tensor cores (the wgmma
# kernel of the 256 ceiling) once a layer a call; logits against the plain
# path and an f32 copy with LLaMA's bounds. gptj serve: a ServingEngine
# over the same engine, 16 slots x 2048, GPTJ_SERVE_REQUESTS requests of
# the serve traffic at <= GPTJ_SERVE_NEW new tokens, greedy tokens held to
# the plain full forward's argmax where its top-2 gap exceeds the margin.
# families:
# OPT-1.3B (K1 packed), BLOOM-560M (ALiBi: the plain attention), GPT-Neo-
# 1.3B (window 256: the plain attention) and GPT-NeoX-20B (K3 at head dim
# 96, the tensor cores' masked instance) at FAMILY_LAYERS layers of their
# published widths: scoring FAMILY_SHAPE against the plain path and f32,
# generate 4 x 128 + FAMILY_NEW greedy and sampled, checked as
# check_streams does, and each family's kernel launches a scoring call
GPTJ_LAYERS, GPTJ_SHAPE = 28, (4, 2048)
GPTJ_SERVE_REQUESTS, GPTJ_SERVE_NEW = 8, 64
FAMILY_LAYERS, FAMILY_SHAPE, FAMILY_NEW = 2, (4, 1024), 32
# kernel-check K3 d256: GPT-J's attention at GPTJ_SHAPE, T * D * 2 bytes
# = 1 MiB a head, still the resident regime; kernel-check K3 d192: the
# wgmma kernel's masked instance (a head dim under the 256 ceiling) with a
# window, at a shape that costs a second or two
GPTJ_K3_SHAPE = (4, 16, 2048, 256)
MASKED_D256_CASE = ((2, 8, 1024, 192), 256)
# the attention kernel a family's scoring call launches a layer
# (K1: packed_flash_attention_fwd, K3: flash_attention_fwd)
FAMILY_KERNEL = {"opt": "K1", "bloom": None, "neo": None, "neox": "K3"}
# the families' bf16 logits through their 2 layers, the kernel path
# against the plain path (each path's error against f32 as in
# LLAMA_LOGITS_TOL) or, for a family without a kernel, against f32: GPT-2's
# 12-layer max bound and 3x its mean
FAMILY_LOGITS_TOL = {"vs_f32_ratio": 1.25, "mean_abs": 0.03, "max_abs": 0.25}
# the families' kernel shapes: OPT-1.3B's packed [B, T, 32 x 64] (K1) and
# GPT-NeoX-20B's [B, 64, T, 96] (K3, the masked DMAX-128 instance) at
# FAMILY_SHAPE
OPT_K1_SHAPE = (4, 1024, 32, 64)
NEOX_K3_SHAPE = (4, 64, 1024, 96)


def family_configs():
    """``{name: (model class, config)}`` of the families phase, at
    FAMILY_LAYERS layers."""
    from deepspeed_tpu_torch.models import bloom, gpt_neo, gpt_neox, opt
    neo = gpt_neo.GPTNeoConfig(vocab_size=50257, n_positions=2048,
                               n_embd=2048, n_layer=24, n_head=16,
                               local_window=256)
    return {name: (cls, dataclasses.replace(cfg, n_layer=FAMILY_LAYERS))
            for name, cls, cfg in (
                ("opt", opt.OPTModel, opt.OPT_1_3B),
                ("bloom", bloom.BloomModel, bloom.BLOOM_560M),
                ("neo", gpt_neo.GPTNeoModel, neo),
                ("neox", gpt_neox.GPTNeoXModel, gpt_neox.NEOX_20B))}


def family_model(torch, cls, cfg, seed):
    """``cls(cfg)`` built on the card in bf16, its weights drawn there
    from ``seed``."""
    return cls(cfg, generator=torch.Generator("cuda").manual_seed(seed),
               device="cuda", dtype=torch.bfloat16)


def plain_path(torch, engine):
    """``engine``'s scoring call with the model's attention on the plain
    path (the same weights; the config restored after each call)."""
    def call(ids):
        model = engine.module
        cfg = model.config
        model.config = dataclasses.replace(cfg, attn_backend="xla")
        try:
            return engine(ids)
        finally:
            model.config = cfg
    return call


def decoder_flops(cfg, b, t):
    """Matmul FLOPs of a scoring call (qkv, proj, fc, proj a layer; the LM
    head) plus the causal attention's two products."""
    d, h = cfg.n_embd, cfg.n_head
    per_token = cfg.n_layer * (4 + 2 * cfg.mlp_ratio) * d * d + \
        cfg.padded_vocab * d
    return 2 * b * t * per_token + \
        cfg.n_layer * 4 * b * h * cfg.head_dim * kept_pairs(t, True, None)


def scoring_calls(torch, engine, ids, n, counter):
    """``n`` scoring calls: ``(logits of the last, seconds each, launches
    of ``counter`` each)``."""
    secs, per_call = [], []
    for _ in range(n):
        before = counter.launches
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        logits = engine(ids)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - s0)
        per_call.append(counter.launches - before)
    return logits, secs, per_call


def gptj_forward(torch):
    """GPT-J-6B at GPTJ_LAYERS layers through ``init_inference``: three
    scoring calls on GPTJ_SHAPE (K3 on the wgmma kernel, once a layer a
    call; K1 never), against the plain path and an f32 copy, a profile.
    Returns the engine and K3's launches in the scoring calls."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt_neox import GPTJ_6B, GPTNeoXModel
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as k1
    cfg = dataclasses.replace(GPTJ_6B, n_layer=GPTJ_LAYERS)
    b, t = GPTJ_SHAPE
    check(fa.tensor_core_path(torch.bfloat16, cfg.head_dim),
          f"gptj: head dim {cfg.head_dim} does not take the tensor cores")
    torch.cuda.reset_peak_memory_stats()
    s0 = time.perf_counter()
    engine = deepspeed_tpu_torch.init_inference(
        family_model(torch, GPTNeoXModel, cfg, SEED + 90),
        {"dtype": "bf16"})
    torch.cuda.synchronize()
    init_s = time.perf_counter() - s0
    ids = torch.randint(0, cfg.vocab_size, (b, t),
                        generator=torch.Generator().manual_seed(SEED + 91))
    fa.flash_attention_fwd.launches = k1.packed_flash_attention_fwd.launches = 0
    logits, secs, per_call = scoring_calls(torch, engine, ids, 3,
                                           fa.flash_attention_fwd)
    launches = fa.flash_attention_fwd.launches
    check(per_call == [cfg.n_layer] * 3 and
          k1.packed_flash_attention_fwd.launches == 0 and
          fa.flash_attention_fwd.streamed_launches == 0,
          f"gptj: K3 launched {per_call} times a scoring call, want "
          f"{cfg.n_layer}; K1 {k1.packed_flash_attention_fwd.launches}, "
          f"streamed {fa.flash_attention_fwd.streamed_launches}, want 0")
    check(tuple(logits.shape) == (b, t, cfg.padded_vocab) and
          torch.isfinite(logits.float()).all().item(),
          f"gptj logits {tuple(logits.shape)} not finite or misshapen")
    flops = decoder_flops(cfg, b, t)
    best = min(secs[1:])
    phase("gptj forward", model=f"GPTJ_6B, {cfg.n_layer} of 28 layers",
          params=engine.module.num_params(), init_seconds=round(init_s, 2),
          shape=list(logits.shape), k3_launches_per_call=per_call,
          k3_route="wgmma_fwd_kernel (D 256)", calls=3,
          seconds=json.dumps([round(x, 4) for x in secs]),
          tokens_per_s=round(b * t / best, 1), model_tflop=flops / 1e12,
          tflop_per_s=round(flops / best / 1e12, 2),
          share_of_bf16_peak=round(flops / best / PEAK_FLOPS["bfloat16"], 4),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
    compare_logits(torch, "gptj vs plain path", logits,
                   plain_path(torch, engine)(ids), LLAMA_LOGITS_TOL,
                   f32_logits(torch, engine.module, ids))
    del logits
    torch.cuda.empty_cache()
    # after the launch counts were read: this call's launches are not counted
    profile_forward(torch, engine, ids, name="profile gptj forward")
    return engine, launches


def gptj_serve(torch, engine):
    """GPT-J's engine behind a ServingEngine of 16 slots x 2048:
    GPTJ_SERVE_REQUESTS requests of the serve traffic at <= GPTJ_SERVE_NEW
    new tokens; every request finishes in full, one decode shape, the
    pool on the card, greedy tokens against the plain full forward."""
    import numpy as np
    from deepspeed_tpu_torch.serving.kv_slots import tree_nbytes
    cfg = SERVE_LLAMA["cfg"]
    vocab = engine.module.config.vocab_size
    traffic = [(p, dict(kw, max_new_tokens=min(kw["max_new_tokens"],
                                               GPTJ_SERVE_NEW)))
               for p, kw in serve_traffic(np, dict(
                   SERVE_LLAMA, requests=GPTJ_SERVE_REQUESTS), vocab,
                   SEED + 92)]
    torch.cuda.reset_peak_memory_stats()
    streams, reqs, util, ticks, wall, srv = serve_run(torch, engine, cfg,
                                                      traffic)
    check({r.state.value for r in reqs} == {"finished"} and
          all(len(r.tokens) == kw["max_new_tokens"]
              for (_, kw), r in zip(traffic, reqs)),
          "gptj serve: a request did not finish in full")
    check(srv.decode_executables() == 1,
          f"gptj serve: {srv.decode_executables()} decode shapes ran")
    pool = srv.scheduler.pool.cache
    check(all(x.device.type == "cuda" for x in pool.values()),
          "gptj serve: the KV pool is not on the card")
    pool_gib = tree_nbytes(pool) / 2 ** 30
    pct = srv.metrics.percentiles()
    ttft, tpot = request_latency(reqs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = sum(len(x) for x in streams)
    srv.shutdown()
    del srv, pool
    torch.cuda.empty_cache()
    checked, _ = greedy_vs_forward(torch, engine, traffic, reqs, vocab,
                                   LLAMA_ARGMAX_MARGIN)
    phase("gptj serve", model=f"GPTJ_6B, {engine.module.config.n_layer} "
          f"layers", requests=len(traffic),
          sampled=sum(1 for _, kw in traffic if kw.get("temperature")),
          slots=cfg["num_slots"], max_model_len=cfg["max_model_len"],
          ticks=ticks, seconds=round(wall, 3), output_tokens=tokens,
          output_tokens_per_s=round(tokens / wall, 1),
          ttft_ms_p50=round(quantile(ttft, 0.5), 3),
          ttft_ms_p99=round(quantile(ttft, 0.99), 3),
          tpot_ms_p50=round(quantile(tpot, 0.5), 3),
          tpot_ms_p99=round(quantile(tpot, 0.99), 3),
          decode_tick_ms_p50=pct["tpot_ms"]["p50"],
          mean_slot_utilization=round(util, 4),
          pool_gib=round(pool_gib, 3), peak_mem_gib=round(peak, 2),
          greedy_vs_forward_checked=checked, margin=LLAMA_ARGMAX_MARGIN,
          decode_executables=1, pool_device="cuda")


def families(torch):
    """Each family of ``family_configs()`` through ``init_inference`` in
    bf16: two scoring calls on FAMILY_SHAPE with its kernel's launches a
    layer a call (FAMILY_KERNEL; none in generate), logits against the
    plain path and f32 (without a kernel, against f32 alone), generate
    checked as check_streams does. Returns ``{"K1": n, "K3": n}`` launched
    in the scoring calls."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as k1
    counters = {"K1": k1.packed_flash_attention_fwd,
                "K3": fa.flash_attention_fwd}
    totals = {"K1": 0, "K3": 0}
    b, t = FAMILY_SHAPE
    for i, (name, (cls, cfg)) in enumerate(family_configs().items()):
        s0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        engine = deepspeed_tpu_torch.init_inference(
            family_model(torch, cls, cfg, SEED + 100 + i),
            {"dtype": "bf16"})
        ids = torch.randint(0, cfg.vocab_size, (b, t),
                            generator=torch.Generator().manual_seed(
                                SEED + 110 + i))
        for c in counters.values():
            c.launches = 0
        kernel = FAMILY_KERNEL[name]
        counter = counters[kernel or "K3"]
        logits, secs, per_call = scoring_calls(torch, engine, ids, 2,
                                               counter)
        want = cfg.n_layer if kernel else 0
        others = {k: c.launches for k, c in counters.items() if k != kernel}
        check(per_call == [want] * 2 and not any(others.values()),
              f"{name}: {kernel} launched {per_call} times a scoring call, "
              f"want {want}; the others {others}, want 0")
        scored = {k: c.launches for k, c in counters.items()}
        check(torch.isfinite(logits.float()).all().item(),
              f"{name}: logits not finite")
        flops = decoder_flops(cfg, b, t)
        ref = f32_logits(torch, engine.module, ids)
        if kernel:
            compare_logits(torch, f"{name} vs plain path", logits,
                           plain_path(torch, engine)(ids), FAMILY_LOGITS_TOL,
                           ref)
        else:
            # the plain attention is this family's only path: its bf16
            # logits are held to the f32 copy directly
            compare_logits(torch, f"{name} vs f32", logits, ref,
                           FAMILY_LOGITS_TOL)
        del logits, ref
        torch.cuda.empty_cache()
        prompts = torch.randint(0, cfg.vocab_size, (4, 128),
                                generator=torch.Generator().manual_seed(
                                    SEED + 120 + i))
        outs, greedy_s = run_generate(torch, engine, prompts, FAMILY_NEW)
        check({k: c.launches for k, c in counters.items()} == scored,
              f"{name}: generate launched an attention kernel")
        checked = check_streams(torch, f"{name} generate",
                                plain_path(torch, engine), prompts, outs,
                                cfg.vocab_size, LLAMA_ARGMAX_MARGIN)
        for k, c in scored.items():
            totals[k] += c
        phase(f"family {name}", config=type(cfg).__name__,
              width=cfg.n_embd, heads=f"{cfg.n_head}x{cfg.head_dim}",
              vocab=cfg.vocab_size, layers=cfg.n_layer,
              kernel=kernel or "none (plain attention)",
              launches_per_call=per_call,
              score_seconds=json.dumps([round(x, 4) for x in secs]),
              tokens_per_s=round(b * t / min(secs), 1),
              share_of_bf16_peak=round(flops / min(secs) /
                                       PEAK_FLOPS["bfloat16"], 4),
              generate_tokens_per_s=round(4 * FAMILY_NEW / greedy_s, 1),
              greedy_vs_forward_checked=checked,
              peak_mem_gib=round(torch.cuda.max_memory_allocated() /
                                 2 ** 30, 2),
              seconds=round(time.perf_counter() - s0, 2))
        del engine
        torch.cuda.empty_cache()
    return totals


def slice13_phases(torch):
    """The phases of slice 13, in order; returns K3's launches at GPT-J's
    head dim 256 and the families' ``{"K1": n, "K3": n}``."""
    engine, gptj_launches = gptj_forward(torch)
    gptj_serve(torch, engine)
    del engine
    torch.cuda.empty_cache()
    return gptj_launches, families(torch)


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
    usage = {k: v for name in kernel_build.sources()
             for k, v in kernel_build.resource_usage(name).items()}
    phase("build", sources=",".join(kernel_build.sources()),
          compiled=json.dumps({k: round(v, 2) for k, v in built.items()}),
          seconds=round(time.perf_counter() - t0, 2), kernels=len(usage),
          spill_bytes=sum(st + ld for _, st, ld in usage.values()),
          registers_bf16=json.dumps({k: v[0] for k, v in usage.items()
                                     if "<bf16," in k}),
          spills=json.dumps({k: v[1:] for k, v in usage.items()
                             if v[1] or v[2]}))
    check(any(k.startswith("wgmma_fwd_kernel") for k in usage) and
          any(k.startswith("mma_") for k in usage),
          "no tensor-core kernel instance in the build report")
    mma_spills = {k: v[1:] for k, v in usage.items()
                  if k.startswith(TENSOR_CORE_KERNELS) and (v[1] or v[2])}
    check(not mma_spills, f"tensor-core kernels spill: {mma_spills}")

    check_mma_sums(torch)
    check_mma_sums(torch, wgmma=True)
    check_fragments(torch, 64)
    check_fragments(torch, 128)
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
    # a tp-2 rank's heads (tp train): 6 of 12, q, k and v column thirds of
    # a row of 3 * 6 * 64
    check_k1(torch, b, t, h // TP_SIZE, d, torch.bfloat16, True, None)
    check_k2(torch, b, t, h // TP_SIZE, d, torch.bfloat16, True, None)
    bf16 = torch.bfloat16
    k3_cases = [(K3_SHAPE, bf16, True, None, None),
                (K3_SHAPE, bf16, True, 512, None),
                (K3_SHAPE, bf16, False, None, None),
                (K3_SHAPE, torch.float16, True, None, None),
                (K3_SHAPE, torch.float32, True, None, None),
                (K3_SHAPE, bf16, True, None, 0.05),
                (K3_SMALL + (80,), bf16, True, None, None),
                (K3_SMALL + (256,), bf16, True, None, None),
                (K3_SHAPE[:3] + (64,), bf16, True, None, None),
                # a tp-2 rank's heads (tp forward, tp train llama)
                ((K3_SHAPE[0], K3_SHAPE[1] // TP_SIZE) + K3_SHAPE[2:], bf16,
                 True, None, None)]
    main_k3 = [check_k3(torch, *case) for case in k3_cases][0]
    main_k3b = [check_k3_bwd(torch, *case) for case in k3_cases][0]
    # GPT-J's attention (gptj forward): K3 on wgmma at D 256; the wgmma
    # kernel's masked instance under the ceiling, with a window
    gptj_k3 = check_k3(torch, GPTJ_K3_SHAPE, bf16, True, None,
                       name="K3 d256")
    check_k3(torch, MASKED_D256_CASE[0], bf16, True, MASKED_D256_CASE[1],
             name="K3 d192")
    # the families' shapes (family opt, family neox)
    check_k1(torch, *OPT_K1_SHAPE, bf16, True, None)
    check_k3(torch, NEOX_K3_SHAPE, bf16, True, None, name="K3 neox d96")
    planted_faults(torch, K3_SHAPE, bf16, True, None)
    k4_cases = [(shape, getattr(torch, dt), causal, window)
                for shape, dt, causal, window in K4_CASES]
    main_k4 = [check_k3(torch, *case, name="K4", timing=K4_TIMING)
               for case in k4_cases][0]
    main_k4b = [check_k3_bwd(torch, *case, name="K4-bwd", timing=K4_TIMING)
                for case in k4_cases][0]
    main_k6 = [check_k6(torch, kind, K6_SHAPE, getattr(torch, dt))
               for kind, dt in K6_CASES][0]
    main_k7 = [check_k7(torch, kind, K6_SHAPE, getattr(torch, dt))
               for kind, dt in K6_CASES][0]
    # one sequence of the check's four: the plain versions take ~10 s a
    # sequence (a cut, PERF.md section 4)
    sparse_planted_faults(torch, "fixed", (1,) + K6_SHAPE[1:], bf16)
    main_drop = check_dropout(torch)
    check_dropout_offset(torch)
    # a tp-2 rank's heads: the dropout map; K6/K7 on rank 1's rows 8-15
    # of the Fixed layout (tp bert forward, tp bert train loop)
    main_drop_heads = check_dropout_heads(torch)
    heads = K6_SHAPE[1] // TP_SIZE
    for fn, name in ((check_k6, "K6"), (check_k7, "K7")):
        res = fn(torch, "fixed", (K6_SHAPE[0], heads) + K6_SHAPE[2:], bf16,
                 (heads, K6_SHAPE[1]), f"kernel-check {name} heads")
        check(res["computed_pairs"] == res["live_pairs"],
              f"{name} at heads {res['heads']}: computed pairs "
              f"{res['computed_pairs']}, live {res['live_pairs']}")

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
    outs, greedy_s = run_generate(torch, engine, prompts, new)
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
    compare_logits(torch, "main vs plain path", logits, engine_x(ids),
                   LOGITS_TOL)
    del logits

    checked = check_streams(torch, "main generate", engine_x, prompts, outs,
                            cfg.vocab_size, ARGMAX_MARGIN)
    phase("main generate", requests=prompts.shape[0], prompt=128,
          new_tokens=new, greedy_seconds=round(greedy_s, 4),
          tokens_per_s=round(prompts.shape[0] * new / greedy_s, 1),
          greedy_repeat_equal=True, sampled_same_seed_equal=True,
          greedy_vs_forward_checked=checked,
          sampled_differs_from_greedy=not torch.equal(outs[2], outs[0]))
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
    # ---- the user loop with dropout, layer drop and random-LTD
    gpt2_loop_launches = gpt2_train_loop(torch)

    # ---- LLaMA: serving at full depth, training at 4 layers, GQA; remat
    llama_fwd_launches = llama_serve(torch)
    llama_train_launches = llama_train(torch)
    llama_gqa(torch)
    llama_remat_launches = llama_train_remat(torch)

    # ---- Code Llama 7B at T 16384 (K4, K4b); BERT-large sparse (K6, K7)
    codellama_fwd_launches = codellama_serve(torch)
    codellama_train_launches = codellama_train(torch)
    bert_fwd_launches = bert_serve(torch)
    bert_train_launches = bert_train(torch)
    bert_loop_launches = bert_train_loop(torch)

    # ---- continuous-batching serving: LLaMA-7B, then GPT-2-125M
    serve_llama(torch)
    serve_gpt2(torch)

    # ---- checkpoints: resume, fallback, serving from a tag and from a
    #      Megatron directory
    resume_launches = ckpt_train_resume(torch)
    fallback_launches = ckpt_fallback(torch)
    ckpt_serve_launches = ckpt_serve(torch)
    megatron_launches = ckpt_megatron(torch)

    # ---- ZeRO stages 0-3 on an NCCL group of one rank
    reset_counts()
    zero_gpt2, zero_llama, zero_ckpt = zero_phases(torch)

    # ---- tensor parallelism: 2 ranks of a gloo group on the one card
    tp = tp_phases(torch)

    # ---- slice 12: ZeRO under comm_compression on 2 and 4 gloo ranks of
    #      the one card; int8 weights and the int8 slot pool
    zq2 = zq_phases(torch, 2, ("zero compressed", "zero overlap"))
    zq4 = zq_phases(torch, 4, ("zero hierarchical",))
    int8_k3 = serve_int8(torch)
    serve_kv_int8(torch)

    # ---- slice 13: GPT-J-6B scored and served (K3 on wgmma at D 256),
    #      OPT, BLOOM, GPT-Neo and GPT-NeoX at their widths
    gptj_launches, family_launches = slice13_phases(torch)

    def entry(name, source, replaces, launches, res, err):
        return {"name": name, "route": "cuda",
                "source": f"deepspeed_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": res["kernel_ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"],
                "library_ms": res["library_ms"]}

    def bwd_err(res):
        return max(res[k] for k in ("err_dq", "err_dk", "err_dv"))

    pallas = "deepspeed_tpu/ops/pallas"
    tp_drop = {k: tp.get(k, 0) for k in ("dropout", "dropout heads")}
    kernels = [
        entry("flash_attention_packed_fwd", "flash_attention_fwd.cu",
              f"{pallas}/flash_attention_packed.py:65",
              launches + train_launches["K1"] + fallback_launches["K1"] +
              megatron_launches + zero_gpt2["K1"] + zero_ckpt["K1"] +
              tp.get("K1", 0) + zq2["K1"] + zq4["K1"] +
              family_launches["K1"],
              main_case, main_case["err_out"]),
        entry("flash_attention_packed_bwd", "flash_attention_bwd.cu",
              f"{pallas}/flash_attention_packed.py:148",
              train_launches["K2"] + fallback_launches["K2"] +
              zero_gpt2["K2"] + zero_ckpt["K2"] + tp.get("K2", 0) +
              zq2["K2"] + zq4["K2"], main_k2,
              bwd_err(main_k2)),
        entry("flash_attention_fwd", "flash_attention_fwd.cu",
              f"{pallas}/flash_attention.py:141",
              llama_fwd_launches + llama_train_launches["K3"] +
              llama_remat_launches["K3"] + resume_launches["K3"] +
              ckpt_serve_launches + zero_llama["K3"] + tp.get("K3", 0) +
              int8_k3 + family_launches["K3"],
              main_k3,
              main_k3["err_out"]),
        # the same kernel source and Pallas kernel at GPT-J's head dim 256,
        # where the route is wgmma_fwd_kernel: its own entry
        entry("flash_attention_fwd_d256", "flash_attention_fwd.cu",
              f"{pallas}/flash_attention.py:141 (head dim 256)",
              gptj_launches, gptj_k3, gptj_k3["err_out"]),
        entry("flash_attention_bwd", "flash_attention_bwd.cu",
              f"{pallas}/flash_attention.py:222 (K3b); "
              f"{pallas}/flash_attention.py:329,358 (K5)",
              llama_train_launches["K3b/K5"] +
              llama_remat_launches["K3b/K5"] + resume_launches["K3b/K5"] +
              zero_llama["K3b/K5"] + tp.get("K3b/K5", 0), main_k3b,
              bwd_err(main_k3b)),
        entry("flash_attention_streamed_fwd", "flash_attention_fwd.cu",
              f"{pallas}/flash_attention.py:483",
              codellama_fwd_launches + codellama_train_launches["K4"],
              main_k4, main_k4["err_out"]),
        entry("flash_attention_streamed_bwd", "flash_attention_bwd.cu",
              f"{pallas}/flash_attention.py:572,618",
              codellama_train_launches["K4b"], main_k4b, bwd_err(main_k4b)),
        entry("block_sparse_attention_fwd", "block_sparse_attention_fwd.cu",
              f"{pallas}/block_sparse_attention.py:114",
              bert_fwd_launches + bert_train_launches["K6"] +
              bert_loop_launches["K6"] + tp.get("K6", 0), main_k6,
              main_k6["err_out"]),
        entry("block_sparse_attention_bwd", "block_sparse_attention_bwd.cu",
              f"{pallas}/block_sparse_attention.py:205,239",
              bert_train_launches["K7"] + bert_loop_launches["K7"] +
              tp.get("K7", 0), main_k7, bwd_err(main_k7)),
        # no Pallas kernel: the counterpart of the JAX package's dropout;
        # its launches under the head map are the next entry's
        entry("threefry_dropout", "threefry_dropout.cu",
              "deepspeed_tpu/models/gpt2.py:97 (_token_dropout); "
              "deepspeed_tpu/ops/flash_attention.py:45 (probability "
              "dropout); no Pallas kernel",
              sum(n["dropout"] - n["dropout heads"]
                  for n in (bert_loop_launches, gpt2_loop_launches, tp_drop)),
              main_drop, main_drop["err"]),
        # threefry_dropout_mapped_kernel: a tp rank's heads
        entry("threefry_dropout_mapped", "threefry_dropout.cu",
              "deepspeed_tpu/ops/flash_attention.py:45 (probability "
              "dropout, on a tensor-parallel rank's heads); no Pallas "
              "kernel",
              sum(n["dropout heads"]
                  for n in (bert_loop_launches, gpt2_loop_launches, tp_drop)),
              main_drop_heads, main_drop_heads["err"])]
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    check(not idle, f"kernels the main paths never launched: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
