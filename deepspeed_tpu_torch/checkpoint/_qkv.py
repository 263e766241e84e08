"""Fused-qkv row layouts of imported checkpoints: the port's copy of the
JAX package's ``module_inject/policy.py`` ``deinterleave_qkv_rows`` /
``deinterleave_qkv_bias`` (the rest of ``module_inject/`` is ROADMAP.md
row A10)."""

import numpy as np


def deinterleave_qkv_rows(w, n_head, head_dim):
    """[3D, D] fused qkv whose rows are per-head [q|k|v] blocks (BLOOM,
    GPT-NeoX, Megatron-LM layout) → [D, 3D] head-major q|k|v (this repo's
    convention)."""
    d = w.shape[1]
    w = w.reshape(n_head, 3, head_dim, d)
    return np.concatenate([w[:, i].reshape(n_head * head_dim, d)
                           for i in range(3)], axis=0).T


def deinterleave_qkv_bias(b, n_head, head_dim):
    b = b.reshape(n_head, 3, head_dim)
    return np.concatenate([b[:, i].reshape(n_head * head_dim)
                           for i in range(3)])
