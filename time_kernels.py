#!/usr/bin/env python3
"""Device times of the port's attention kernels for one or more checkouts
of this repository, taken in turns on one GPU so that they compare.

    python3 time_kernels.py ROOT [ROOT ...] [--rounds 3]

Each round runs the roots in order and then in reverse (A B B A for two
roots). Each turn is a process of its own that imports
``deepspeed_tpu_torch`` from its root, builds that root's kernels into the
root's ``build/kernels`` (before any timing) and times every case below:
the median of ``reps`` timings, between CUDA events, of ``inner``
back-to-back calls, after ``warmup`` calls (``chip_smoke.py``'s timing).
The inputs are drawn from one seed, so every root sees the same tensors.
The last line is one JSON object: the card, and for each case each root's
ms a call in turn order, their mean, and each root's mean over the first
root's. Needs one NVIDIA Hopper GPU and nvcc.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

SEED = 1234
# name: (kernel, shape [B, H, T, D] (K1/K2: [B, T, H, D]), dtype,
# (reps, inner, warmup)); the dense cases are causal with no window
CASES = {
    "K1 bf16": ("packed_fwd", (8, 1024, 12, 64), "bfloat16", (10, 5, 3)),
    "K2 bf16": ("packed_bwd", (8, 1024, 12, 64), "bfloat16", (10, 5, 3)),
    "K3 bf16": ("fwd", (4, 32, 2048, 128), "bfloat16", (10, 5, 3)),
    "K3b/K5 bf16": ("bwd", (4, 32, 2048, 128), "bfloat16", (10, 5, 3)),
    "K3 bf16 d256": ("fwd", (4, 8, 512, 256), "bfloat16", (10, 5, 3)),
    "K3b/K5 bf16 d256": ("bwd", (4, 8, 512, 256), "bfloat16", (10, 5, 3)),
    "K3 f32": ("fwd", (4, 32, 2048, 128), "float32", (10, 5, 3)),
    "K3b/K5 f32": ("bwd", (4, 32, 2048, 128), "float32", (10, 5, 3)),
    "K4 bf16": ("fwd", (1, 32, 16384, 128), "bfloat16", (5, 2, 1)),
    "K4b bf16": ("bwd", (1, 32, 16384, 128), "bfloat16", (5, 2, 1)),
    "K4 f32": ("fwd", (1, 8, 8192, 64), "float32", (5, 2, 1)),
    "K4b f32": ("bwd", (1, 8, 8192, 64), "float32", (5, 2, 1)),
    "K6 Fixed bf16": ("sparse_fwd", (4, 16, 4096, 64), "bfloat16",
                      (10, 5, 3)),
    "K7 Fixed bf16": ("sparse_bwd", (4, 16, 4096, 64), "bfloat16",
                      (10, 5, 3)),
}


def median_ms(torch, fn, reps, inner, warmup):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def case_fn(torch, kernel, shape, dtype):
    """A call of one kernel on inputs drawn from SEED: q, k, v (and dO) as
    views of [B, T, H, D] buffers, as the models hand them over."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as pk
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*size):
        return torch.randn(size, generator=gen, device="cuda").to(dtype)

    if kernel.startswith("packed"):
        b, t, h, d = shape
        qkv = randn(b, t, 3 * h * d)
        q, k, v = qkv.split(h * d, dim=-1)
        if kernel == "packed_fwd":
            return lambda: pk.packed_flash_attention_fwd(q, k, v, h)
        out, lse = pk.packed_flash_attention_fwd(q, k, v, h)
        dout = randn(b, t, h * d)
        return lambda: pk.packed_flash_attention_bwd(qkv, out, lse, dout, h)
    b, h, t, d = shape
    q, k, v, dout = (randn(b, t, h, d).transpose(1, 2) for _ in range(4))
    if kernel.startswith("sparse"):
        from deepspeed_tpu_torch.ops import sparse_attention_ops as ops
        from deepspeed_tpu_torch.ops.kernels import block_sparse_attention \
            as bsa
        layout = ops.FixedSparsityConfig(
            num_heads=h, block=16, num_local_blocks=4, num_global_blocks=1,
            different_layout_per_head=True,
            num_different_global_patterns=4).make_layout(t)
        plan = bsa.get_plan(layout, 16, bsa.default_tile(t, 16), "cuda")
        scale = d ** -0.5
        if kernel == "sparse_fwd":
            return lambda: bsa.block_sparse_attention_fwd(q, k, v, plan,
                                                          scale)
        out, lse = bsa.block_sparse_attention_fwd(q, k, v, plan, scale)
        return lambda: bsa.block_sparse_attention_bwd(q, k, v, out, lse,
                                                      dout, plan, scale)
    if kernel == "fwd":
        return lambda: fa.flash_attention_fwd(q, k, v)
    out, lse = fa.flash_attention_fwd(q, k, v)
    return lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout)


def worker(root):
    """One turn: this process imports the package from ``root``."""
    sys.path[0] = root
    import torch
    from deepspeed_tpu_torch.ops import kernel_build
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel_build.build()
    times = {}
    for name, (kernel, shape, dtype, timing) in CASES.items():
        fn = case_fn(torch, kernel, shape, getattr(torch, dtype))
        times[name] = median_ms(torch, fn, *timing)
        del fn
        torch.cuda.empty_cache()
    print(json.dumps(times))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("roots", nargs="+")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--worker", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        worker(os.path.abspath(args.roots[0]))
        return 0
    roots = [os.path.abspath(r) for r in args.roots]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    samples = {r: [] for r in roots}
    for n in range(args.rounds):
        for root in roots + roots[::-1]:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", root],
                cwd=root, capture_output=True, text=True, timeout=1800)
            if proc.returncode != 0:
                print(proc.stdout[-2000:], proc.stderr[-4000:],
                      file=sys.stderr)
                return proc.returncode
            times = json.loads(proc.stdout.strip().splitlines()[-1])
            samples[root].append(times)
            print(f"round {n} {root}: {json.dumps(times)}", flush=True)
    report = {"card": card, "roots": roots, "cases": {}}
    for name in CASES:
        per_root = {r: [s[name] for s in samples[r]] for r in roots}
        means = {r: statistics.mean(v) for r, v in per_root.items()}
        report["cases"][name] = {
            "ms": per_root, "mean_ms": means,
            "over_first": {r: means[r] / means[roots[0]] for r in roots}}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
