"""Record outputs of ``mma.sync.m16n8k16`` on the card for
``tests/test_torch_tensor_core_sums.py``: tiles drawn by
``chip_smoke.mma_samples`` (its five families) go through
``flash_attention.mma_on_card``; the file holds, per input type, A and B as
16-bit patterns and C and D = A B^T + C as float32.

    python3 tests/data/record_mma_m16n8k16.py --seed 2027 --tiles 100 \\
        --out tests/data/mma_m16n8k16_h100_check.npz

Run from the repository root on a machine with one NVIDIA Hopper GPU and
nvcc.
"""

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import chip_smoke  # noqa: E402
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--tiles", type=int, default=100)
    parser.add_argument("--out", required=True)
    args = parser.parse_args()
    arrays = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        a, b, c = (x.cuda() for x in chip_smoke.mma_samples(
            torch, dtype, args.tiles, args.seed))
        d = fa.mma_on_card(a, b, c)
        for key, x in zip("abcd", (a, b, c, d)):
            x = x.cpu()
            arrays[f"{name}_{key}"] = (x.view(torch.int16).numpy()
                                       .view(np.uint16)
                                       if x.dtype != torch.float32
                                       else x.numpy())
    np.savez_compressed(args.out, **arrays)
    print({k: v.shape for k, v in arrays.items()})


if __name__ == "__main__":
    main()
