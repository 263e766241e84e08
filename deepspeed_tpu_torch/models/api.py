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
``self.blocks``); ``jax_tree`` / ``from_jax_tree`` map any list of tensors
aligned with ``named_parameters()`` (weights, optimizer moments) to the
JAX tree and back, and ``load_jax_params`` / ``jax_params`` move the
weights in and out through them. Under tensor parallelism (``tp > 1``) a
model holds its rank's part of each sharded leaf (``tp_splits``, one
``parallel/tensor_parallel.TPSplit`` a parameter, None for a replicated
one): ``load_jax_params`` takes the whole tree and keeps the rank's part,
``jax_params`` gathers it back whole (every rank calls it). A layer loop
takes each layer's leaves from ``_layer_leaves`` and runs the layer
inside ``open_leaves``: under ZeRO stage 3 the engine's hook hands out a
handle there that gathers the layer's partitioned leaves for that block
(``runtime/zero/stage3.py``).
"""

import contextlib
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..parallel.tensor_parallel import TPInfo
from ..runtime.activation_checkpointing import checkpointing


class ModelSpec(nn.Module):
    """Base class for deepspeed_tpu_torch models."""

    top_leaves = ()      # JAX leaf names of the top level
    block_leaves = ()    # those of one layer (the [L, ...] params["blocks"])
    # set by a ZeRO stage-3 engine for its micro steps: hands out the
    # gather handle of a layer's leaves (runtime/zero/stage3.py)
    _zero_hook = None
    # the model's place on the 'model' axis; families that shard set their
    # own (models/gpt2.py), the others run at tp 1 only
    tp = TPInfo()
    tensor_parallel = False

    def tp_splits(self):
        """A list aligned with ``named_parameters()``: each parameter's
        ``TPSplit`` (of the per-layer tensor for a stacked leaf), or None
        where the rank holds it whole."""
        return [None] * len(list(self.parameters()))

    def whole_shapes(self):
        """The whole (tp 1) shape of every parameter, aligned with
        ``named_parameters()``."""
        return [tuple(p.shape) if sp is None else sp.whole_shape
                for p, sp in zip(self.parameters(), self.tp_splits())]

    def jax_layout(self):
        """Where each tensor of ``named_parameters()`` lives in the JAX
        tree: a list, aligned with it, of ``(leaf name, layer)``, where a
        top-level leaf has layer None and ``blocks/<leaf>`` is the stacked
        ``[L, ...]`` leaf whose row ``layer`` the tensor is."""
        tops, blocks = set(self.top_leaves), set(self.block_leaves)
        out = []
        for name, _ in self.named_parameters():
            parts = name.split(".")
            if len(parts) == 1 and name in tops:
                out.append((name, None))
            elif len(parts) == 3 and parts[0] == "blocks" and \
                    parts[2] in blocks:
                out.append((f"blocks/{parts[2]}", int(parts[1])))
            else:
                raise ValueError(f"parameter {name!r} has no leaf in the "
                                 f"JAX tree of {type(self).__name__}")
        return out

    def jax_tree(self, tensors, stack=None):
        """The JAX tree of ``tensors``, any list aligned with
        ``named_parameters()`` (the weights, or an optimizer's moments of
        them): each top-level leaf as given, each ``blocks/<leaf>`` the
        result of ``stack`` on its per-layer tensors in layer order
        (default: ``torch.stack``)."""
        stack = torch.stack if stack is None else stack
        layout = self.jax_layout()
        if len(tensors) != len(layout):
            raise ValueError(f"{len(tensors)} tensors for "
                             f"{len(layout)} parameters")
        tree, layers = {}, {}
        for (leaf, layer), t in zip(layout, tensors):
            if layer is None:
                tree[leaf] = t
            else:
                layers.setdefault(leaf.split("/")[1], {})[layer] = t
        tree["blocks"] = {name: stack([rows[i] for i in range(len(rows))])
                          for name, rows in layers.items()}
        return tree

    def from_jax_tree(self, tree):
        """The inverse of :meth:`jax_tree`: a list aligned with
        ``named_parameters()``, each entry the JAX leaf or its row
        ``layer``, as given (numpy arrays or tensors). Raises ``KeyError``
        naming the leaves the tree lacks and ``ValueError`` on a stacked
        leaf with another layer count."""
        layout = self.jax_layout()
        blocks = tree.get("blocks", {}) if isinstance(tree, dict) else {}
        missing = sorted({leaf for leaf, layer in layout
                          if (tree.get(leaf) if layer is None else
                              blocks.get(leaf.split("/")[1])) is None})
        if missing:
            raise KeyError(f"JAX parameter tree lacks {missing}")
        out = []
        for leaf, layer in layout:
            if layer is None:
                out.append(tree[leaf])
                continue
            stacked = blocks[leaf.split("/")[1]]
            if stacked.shape[0] != len(self.blocks):
                raise ValueError(f"{leaf}: {stacked.shape[0]} layers, the "
                                 f"module has {len(self.blocks)}")
            out.append(stacked[layer])
        return out

    @torch.no_grad()
    def load_jax_params(self, tree):
        """Copy a JAX parameter tree of this family (numpy arrays or
        tensors in the JAX layout: the ``top_leaves``, e.g. GPT-2's ``wte
        [Vp, D]``, ``wpe [P, D]``, ``ln_f_*``, and the stacked
        ``blocks/<leaf> [L, ...]`` of ``block_leaves``) into this module,
        casting to each parameter's dtype."""
        values = self.from_jax_tree(tree)
        for (name, p), value, split in zip(self.named_parameters(), values,
                                           self.tp_splits()):
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.ascontiguousarray(value))
            if split is not None:
                if tuple(value.shape) != split.whole_shape:
                    raise ValueError(
                        f"{name}: JAX leaf has shape {tuple(value.shape)}, "
                        f"the model's whole leaf is {split.whole_shape}")
                value = split.take(value)
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX leaf has shape "
                                 f"{tuple(value.shape)}, the module wants "
                                 f"{tuple(p.shape)}")
            p.copy_(value)
        return self

    def jax_params(self):
        """This module's weights as a JAX parameter tree of float32 numpy
        arrays (the inverse of :meth:`load_jax_params`); at tp > 1 each
        sharded leaf is gathered whole (every rank calls it)."""
        def arr(p, split):
            if split is not None:
                p = split.gather(p.detach(), self.tp.group)
            return p.detach().to("cpu", torch.float32).numpy()
        return self.jax_tree([arr(p, sp) for p, sp in
                              zip(self.parameters(), self.tp_splits())],
                             stack=np.stack)

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
        copies inside ``functional_call``), held for a later recompute; under
        a stage-3 engine, the handle that gathers them (open it with
        :func:`open_leaves`)."""
        leaves = {n: getattr(p, n) for n in self.block_leaves}
        if self._zero_hook is not None:
            return self._zero_hook(p, leaves)
        return SimpleNamespace(**leaves)

    def apply(self, batch, rng=None, train=True):
        """The training loss of one micro batch (a float32 scalar)."""
        raise NotImplementedError

    def loss_count(self, batch):
        """The count of targets ``apply``'s loss is the mean over (a 0-d
        tensor), or None when the loss is not such a mean."""
        return None

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len: Optional[int] = None) -> Optional[float]:
        """Approximate training FLOPs per token (None when unknown)."""
        return None


@contextlib.contextmanager
def open_leaves(leaves, recomputed: bool = False):
    """A layer's leaves as a namespace for the ``with`` block: a stage-3
    handle gathered for it (``recomputed``: the layer runs under a
    recomputing checkpoint), anything else as it is."""
    gathered = getattr(leaves, "gathered", None)
    if gathered is None:
        yield leaves
        return
    with gathered(recomputed) as full:
        yield full
