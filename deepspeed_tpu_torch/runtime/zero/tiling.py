"""Tiled linear layers: the JAX package's ``runtime/zero/tiling.py``
(reference ``zero.TiledLinear``, ``zero.Linear``), in plain PyTorch.

``tiled_linear`` computes one linear from a stack of weight tiles, a tile
at a time, so only one tile's product is alive at once: out-tiled (``[K,
in, out/K]``, the tiles' outputs concatenated) or in-tiled (``[K, in/K,
out]``, the partial products summed in tile order, as the JAX scan sums
them). ``TiledLinear`` splits its weight at construction;
``zero_linear`` is the plain linear.
"""

from typing import Optional

import torch


def tiled_linear(x, w_tiles, b_tiles=None, out_axis: bool = True):
    """``x [..., in]`` through the tiles; the same result as one matmul by
    the concatenated weight."""
    if out_axis:
        ys = []
        for k in range(w_tiles.shape[0]):
            y = x @ w_tiles[k].to(x.dtype)
            if b_tiles is not None:
                y = y + b_tiles[k].to(x.dtype)
            ys.append(y)
        return torch.cat(ys, dim=-1)
    k, in_tile, _ = w_tiles.shape
    x_tiles = x.reshape(x.shape[:-1] + (k, in_tile))
    acc = torch.zeros(x.shape[:-1] + (w_tiles.shape[-1],), dtype=x.dtype,
                      device=x.device)
    for i in range(k):
        acc = acc + x_tiles[..., i, :] @ w_tiles[i].to(x.dtype)
    if b_tiles is not None:
        acc = acc + b_tiles.sum(0).to(x.dtype)
    return acc


class TiledLinear(torch.nn.Module):
    """A linear of ``in_features -> out_features`` held as ``splits``
    output tiles (the JAX ``TiledLinear``: N(0, init_scale) weights, zero
    biases)."""

    def __init__(self, in_features: int, out_features: int, splits: int = 2,
                 use_bias: bool = True, init_scale: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if out_features % splits:
            raise ValueError(f"out_features {out_features} not divisible "
                             f"by splits {splits}")
        self.in_features, self.out_features = in_features, out_features
        self.splits = splits
        self.w_tiles = torch.nn.Parameter(torch.randn(
            splits, in_features, out_features // splits,
            generator=generator) * init_scale)
        self.b_tiles = torch.nn.Parameter(torch.zeros(
            splits, out_features // splits)) if use_bias else None

    def forward(self, x):
        return tiled_linear(x, self.w_tiles, self.b_tiles)


def zero_linear(x, w, b=None):
    """The plain linear ``x @ w + b`` (the reference's ZeRO-aware
    ``zero.Linear``; the stage-3 hook has gathered ``w`` already)."""
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y
