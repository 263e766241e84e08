"""Model specification base.

The JAX package's ``ModelSpec`` is a functional spec whose parameters are a
separate pytree: ``init(rng) -> params`` and ``apply(params, batch, rng,
train) -> loss``. Here a model is an ``nn.Module`` that carries its own
weights: ``init_weights(generator)`` draws them, the inference engine
serves them, and the training engine calls ``apply(batch, rng, train) ->
loss`` with its compute-dtype copies of the weights swapped in through
``torch.func.functional_call``. ``apply`` overrides ``nn.Module.apply(fn)``
on purpose: on a model of this port it is the loss, as in the JAX package.
A family names its JAX parameter leaves in ``top_leaves`` and
``block_leaves`` (one layer's leaves, held by each module of
``self.blocks``), and ``load_jax_params`` / ``jax_params`` move a JAX tree
in and out through them.
"""

from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..runtime.activation_checkpointing import checkpointing


class ModelSpec(nn.Module):
    """Base class for deepspeed_tpu_torch models."""

    top_leaves = ()      # JAX leaf names of the top level
    block_leaves = ()    # those of one layer (the [L, ...] params["blocks"])

    @torch.no_grad()
    def load_jax_params(self, tree):
        """Copy a JAX parameter tree of this family (numpy arrays in the JAX
        layout: the ``top_leaves``, e.g. GPT-2's ``wte [Vp, D]``,
        ``wpe [P, D]``, ``ln_f_*``, and the stacked
        ``blocks/<leaf> [L, ...]`` of ``block_leaves``) into this module,
        casting to each parameter's dtype."""
        def put(p, value, name):
            value = np.asarray(value)
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX leaf has shape {value.shape}, "
                                 f"the module wants {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(value)))

        missing = [n for n in self.top_leaves if n not in tree] + \
            [f"blocks/{n}" for n in self.block_leaves
             if n not in tree.get("blocks", {})]
        if missing:
            raise KeyError(f"JAX parameter tree lacks {missing}")
        for name in self.top_leaves:
            put(getattr(self, name), tree[name], name)
        for name in self.block_leaves:
            stacked = np.asarray(tree["blocks"][name])
            if stacked.shape[0] != len(self.blocks):
                raise ValueError(f"blocks/{name}: {stacked.shape[0]} layers, "
                                 f"the module has {len(self.blocks)}")
            for i, blk in enumerate(self.blocks):
                put(getattr(blk, name), stacked[i], f"blocks/{name}[{i}]")
        return self

    def jax_params(self):
        """This module's weights as a JAX parameter tree of float32 numpy
        arrays (the inverse of :meth:`load_jax_params`)."""
        def arr(p):
            return p.detach().to("cpu", torch.float32).numpy()
        tree = {name: arr(getattr(self, name)) for name in self.top_leaves}
        tree["blocks"] = {
            name: np.stack([arr(getattr(blk, name)) for blk in self.blocks])
            for name in self.block_leaves}
        return tree

    def init_weights(self, generator) -> None:
        raise NotImplementedError

    def _remat_policy(self):
        """The layers' remat policy (``config.remat`` / ``remat_policy``)
        while gradients are taken, else None."""
        cfg = self.config
        if not cfg.remat or not torch.is_grad_enabled():
            return None
        return checkpointing.get_policy(cfg.remat_policy)

    def _layer_leaves(self, p):
        """A layer's leaves as they are now (the engine's compute-dtype
        copies inside ``functional_call``), held for a later recompute."""
        return SimpleNamespace(**{n: getattr(p, n) for n in self.block_leaves})

    def apply(self, batch, rng=None, train=True):
        """The training loss of one micro batch (a float32 scalar)."""
        raise NotImplementedError

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len: Optional[int] = None) -> Optional[float]:
        """Approximate training FLOPs per token (None when unknown)."""
        return None
