"""Block-sparse attention: the sparsity layouts and the sparse attention op,
as the JAX package's ``ops/sparse_attention_ops.py``.

The layouts (``SparsityConfig``, ``FixedSparsityConfig``,
``BigBirdSparsityConfig``, ``BSLongformerSparsityConfig``,
``VariableSparsityConfig``) and ``layout_to_mask`` are the JAX package's
numpy code, copied so that every layout matches it bitwise (BigBird's and
Variable's ``default_rng(seed)`` draws included). A layout is
``[H, T/block, T/block]`` bool: entry ``[h, i, j]`` says whether query
block i may attend to key block j.

``sparse_attention`` dispatches as the JAX package does. ``impl="auto"``
takes the block-sparse Hopper kernels (K6 forward, K7 backward,
``kernels/block_sparse_attention.py``) for CUDA tensors whose shapes they
support, and the dense-masked plain path elsewhere; ``impl="pallas"``
takes the kernels, or their plain versions for CPU tensors, and raises on
an unsupported shape; ``impl="dense"`` takes the dense-masked plain path.
Unlike the JAX package, no ``try`` turns a failing kernel into the dense
path: a kernel that fails raises.
"""

from types import SimpleNamespace

import numpy as np
import torch

from .flash_attention import reference_attention
from .kernels import block_sparse_attention as bsa


class SparsityConfig:
    """Base: every block visible (dense)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(f"seq_len {seq_len} not divisible by block "
                             f"{self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), dtype=bool)

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = True
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Local blocks within a window + periodic global blocks
    (reference FixedSparsityConfig semantics: local + 'different heads may
    attend different global blocks')."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = (
            num_different_global_patterns if different_layout_per_head else 1)

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        L = self.num_local_blocks
        for i in range(n):
            w0 = (i // L) * L
            for j in range(w0, min(w0 + L, n)):
                layout[:, i, j] = True
        # global: last num_global_blocks of each local window attend/are
        # attended everywhere; pattern may rotate across heads
        for h in range(self.num_heads):
            pat = h % self.num_different_global_patterns
            for w0 in range(0, n, L):
                g0 = w0 + L - self.num_global_blocks * (1 + pat)
                g0 = max(w0, g0)
                for j in range(g0, min(w0 + L, n)):
                    layout[h, :, j] = True          # vertical (everyone → g)
                    if self.horizontal_global_attention:
                        layout[h, j, :] = True      # horizontal (g → everyone)
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding-window + global blocks (BigBird)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional", seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        rng = np.random.default_rng(self.seed)
        for i in range(n):
            layout[:, i, max(0, i - w):min(n, i + w + 1)] = True
        g = self.num_global_blocks
        layout[:, :g, :] = True
        layout[:, :, :g] = True
        causal = self.attention == "unidirectional"
        for h in range(self.num_heads if self.different_layout_per_head
                       else 1):
            for i in range(n):
                hi = i + 1 if causal else n
                if hi <= 0:
                    continue
                picks = rng.integers(0, hi, size=self.num_random_blocks)
                layout[h if self.different_layout_per_head else slice(None),
                       i, picks] = True
        if causal:
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + selected global block indices (Longformer)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=(0,),
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = list(global_block_indices)
        self.global_block_end_indices = (
            list(global_block_end_indices) if global_block_end_indices
            else None)
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for i in range(n):
            layout[:, i, max(0, i - w):min(n, i + w + 1)] = True
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for s, e in spans:
            layout[:, s:e, :] = True
            layout[:, :, s:e] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return layout


class VariableSparsityConfig(SparsityConfig):
    """Variable local window sizes + global blocks (reference
    VariableSparsityConfig: a list of local window block counts cycled over
    consecutive windows)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=(4,),
                 global_block_indices=(0,), global_block_end_indices=None,
                 attention="bidirectional", horizontal_global_attention=False,
                 seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = list(local_window_blocks)
        self.global_block_indices = list(global_block_indices)
        self.global_block_end_indices = (
            list(global_block_end_indices) if global_block_end_indices
            else None)
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        # tile variable windows: last size repeats to cover the sequence
        start = 0
        k = 0
        while start < n:
            size = self.local_window_blocks[
                min(k, len(self.local_window_blocks) - 1)]
            end = min(start + size, n)
            layout[:, start:end, start:end] = True
            start = end
            k += 1
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for s, e in spans:
            layout[:, :, s:e] = True
            if self.horizontal_global_attention:
                layout[:, s:e, :] = True
        if self.num_random_blocks:
            rng = np.random.default_rng(self.seed)
            for i in range(n):
                picks = rng.integers(0, n, size=self.num_random_blocks)
                layout[:, i, picks] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return layout


def layout_to_mask(layout, block):
    """[H, nb, nb] bool blocks → [H, T, T] bool token mask."""
    layout = np.asarray(layout)
    return np.repeat(np.repeat(layout, block, axis=1), block, axis=2)


def layout_to_mask(layout, block):
    """[H, nb, nb] bool blocks → [H, T, T] bool token mask."""
    layout = np.asarray(layout)
    return np.repeat(np.repeat(layout, block, axis=1), block, axis=2)


def _dense_masked(q, k, v, layout, block, softmax_scale,
                  key_padding_mask=None):
    """The dense-masked plain path: attention over every (q, k) pair with
    the layout expanded to a token mask (and a key padding mask)."""
    mask = torch.from_numpy(layout_to_mask(layout, block)).to(q.device)[None]
    if key_padding_mask is not None:
        mask = mask & key_padding_mask.to(torch.bool)
    return reference_attention(q, k, v, causal=False, mask=mask,
                               softmax_scale=softmax_scale)


def sparse_attention(q, k, v, layout, block, softmax_scale=None,
                     impl="auto"):
    """Block-sparse attention. q/k/v: [B, H, T, D]; layout [H, nb, nb].

    impl: 'auto' (the Hopper block-sparse kernels for CUDA tensors when the
    shapes fit, dense-masked plain attention otherwise), 'pallas' (the
    kernels, their plain versions for CPU tensors; raises on unsupported
    shapes) or 'dense'."""
    if impl in ("auto", "pallas"):
        ok = bsa.supported(q, layout, block)
        if impl == "pallas":
            if not ok:
                raise ValueError(
                    f"impl='pallas' requested but shapes are unsupported "
                    f"(T={q.shape[-2]}, D={q.shape[-1]}, "
                    f"fine_block={block}) — use impl='auto' for the "
                    f"dense-masked fallback")
            return bsa.sparse_attention_kernel(q, k, v, layout, block,
                                               softmax_scale=softmax_scale)
        if ok and q.device.type == "cuda":
            return bsa.sparse_attention_kernel(q, k, v, layout, block,
                                               softmax_scale=softmax_scale)
    elif impl != "dense":
        raise ValueError(f"unknown sparse attention impl {impl!r}")
    return _dense_masked(q, k, v, layout, block, softmax_scale)


class SparseSelfAttention:
    """Module-style wrapper (reference sparse_self_attention.py surface).

    ``key_padding_mask`` ([B,1,1,T] or [B,T] bool/int, 1 = keep) merges
    with the block layout on the dense-masked path: the block-sparse kernel
    takes no per-batch mask, so padded batches pay the dense path, as in the
    JAX package.

    ``heads = (h0, H)``: ``q`` holds heads ``[h0, h0 + h)`` of ``H`` (a
    tensor-parallel rank's). The layout is always made for the config's
    ``num_heads`` (the whole ``H``) and the rank takes its rows: Fixed's
    global patterns and BigBird's random blocks are drawn a head at a time,
    so a layout made for ``h`` heads would be another one."""

    def __init__(self, sparsity_config, softmax_scale=None):
        self.config = sparsity_config
        self.softmax_scale = softmax_scale
        self._layouts = {}

    def layout(self, seq_len, heads=None):
        """The ``[H, nb, nb]`` layout at ``seq_len``, or its rows ``h0:h0 +
        h`` for ``heads = (h0, h, H)`` (cached either way)."""
        if seq_len % self.config.block:
            raise ValueError(
                f"seq {seq_len} not a multiple of block "
                f"{self.config.block}; use "
                f"SparseAttentionUtils.pad_to_block_size")
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.config.make_layout(seq_len)
        whole = self._layouts[seq_len]
        if heads is None:
            return whole
        h0, h, total = heads
        if whole.shape[0] != total or not 0 <= h0 < h0 + h <= total:
            raise ValueError(
                f"heads [{h0}, {h0 + h}) of {total}: the sparsity config "
                f"makes a layout of {whole.shape[0]} heads")
        key = (seq_len, h0, h)
        if key not in self._layouts:
            self._layouts[key] = np.ascontiguousarray(whole[h0:h0 + h])
        return self._layouts[key]

    def __call__(self, q, k, v, key_padding_mask=None, heads=None):
        lay = self.layout(q.shape[-2], None if heads is None else
                          (heads[0], q.shape[1], heads[1]))
        if key_padding_mask is None:
            return sparse_attention(q, k, v, lay, self.config.block,
                                    self.softmax_scale)
        if key_padding_mask.dim() == 2:
            key_padding_mask = key_padding_mask[:, None, None, :]
        return _dense_masked(q, k, v, lay, self.config.block,
                             self.softmax_scale, key_padding_mask)


def get_ops(backend: str = "cuda"):
    return SimpleNamespace(
        sparse_attention=sparse_attention, layout_to_mask=layout_to_mask,
        SparsityConfig=SparsityConfig,
        FixedSparsityConfig=FixedSparsityConfig,
        BigBirdSparsityConfig=BigBirdSparsityConfig,
        BSLongformerSparsityConfig=BSLongformerSparsityConfig,
        VariableSparsityConfig=VariableSparsityConfig,
        SparseSelfAttention=SparseSelfAttention)
