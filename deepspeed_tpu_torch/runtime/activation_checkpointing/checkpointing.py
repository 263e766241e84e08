"""Activation checkpointing, as the JAX package's
``runtime/activation_checkpointing/checkpointing.py``.

The JAX package wraps its layer-scan body in ``jax.checkpoint`` under a
named policy; here each layer runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, and a policy
name maps to what that call saves:

- ``dots_with_no_batch_dims_saveable`` (the default): a selective
  checkpoint (``create_selective_checkpoint_contexts``) that saves the
  outputs of ``aten.mm`` / ``aten.addmm`` (the weight products, dot
  products without batch dimensions) and recomputes the rest: the
  elementwise work, the batched attention products and the attention
  kernels, which launch again in the recompute;
- ``dots_saveable``: saves ``bmm`` / ``baddbmm`` outputs as well;
- ``nothing_saveable`` (``partition_activations``): saves only the layer's
  input and recomputes everything;
- ``everything_saveable``: no recompute (the layer runs as it is);
- ``offload_dots`` (``cpu_checkpointing``): host-offloaded remat. The JAX
  package runs it only on a TPU and elsewhere warns and takes the default
  policy (``deepspeed_tpu/runtime/engine.py:363-374``); the port does the
  same on every device.

``configure()`` records the module-level policy from the
``activation_checkpointing`` block; the engine passes its name to the
model (``config.remat`` / ``remat_policy``), and ``get_policy(name)``
resolves a name, never the configured global.
"""

import functools
from typing import Optional

import torch
from torch.utils import checkpoint as _tc

from ...utils.logging import log_dist, logger

_aten = torch.ops.aten
_NO_BATCH_DOTS = (_aten.mm.default, _aten.addmm.default)
_DOTS = _NO_BATCH_DOTS + (_aten.bmm.default, _aten.baddbmm.default)


class RematPolicy:
    """What a policy name asks of one layer's ``checkpoint`` call:
    ``recompute`` False runs the layer as it is; ``saved`` names the ops
    whose outputs a selective checkpoint keeps (None: keep only the
    inputs)."""

    def __init__(self, name, recompute=True, saved=None):
        self.name, self.recompute, self.saved = name, recompute, saved

    def __repr__(self):
        return f"RematPolicy({self.name!r})"

    def context_fn(self):
        if self.saved is None:
            return _tc.noop_context_fn()
        return _tc.create_selective_checkpoint_contexts(list(self.saved))


POLICIES = {
    "everything_saveable": RematPolicy("everything_saveable",
                                       recompute=False),
    "nothing_saveable": RematPolicy("nothing_saveable"),
    "dots_saveable": RematPolicy("dots_saveable", saved=_DOTS),
    "dots_with_no_batch_dims_saveable": RematPolicy(
        "dots_with_no_batch_dims_saveable", saved=_NO_BATCH_DOTS),
    # host-offloaded remat: resolved to the default with a warning, as the
    # JAX package resolves it off a TPU
    "offload_dots": RematPolicy("offload_dots", saved=_NO_BATCH_DOTS),
}

DEFAULT_POLICY = "dots_with_no_batch_dims_saveable"

_config = None
_policy_name = DEFAULT_POLICY


def policy_name_from_config(accfg) -> str:
    if accfg is None:
        return DEFAULT_POLICY
    if accfg.cpu_checkpointing:
        return "offload_dots"
    if accfg.partition_activations:
        return "nothing_saveable"
    return DEFAULT_POLICY


def get_policy(name: Optional[str] = None) -> RematPolicy:
    """Resolve a policy by name (``None``: the static default, never the
    ``configure()``d global)."""
    name = name or DEFAULT_POLICY
    policy = POLICIES.get(name)
    if policy is None:
        raise ValueError(f"unknown remat policy {name!r}; choose from "
                         f"{sorted(POLICIES)}")
    if name == "offload_dots":
        logger.warning("offload_dots: host-offloaded remat is not ported to "
                       "the card; taking dots_with_no_batch_dims_saveable")
        return POLICIES[DEFAULT_POLICY]
    return policy


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    """The JAX ``configure()``: flags given directly override the JSON
    block. Returns the policy name."""
    global _config, _policy_name
    accfg = getattr(deepspeed_config, "activation_checkpointing", None) \
        if deepspeed_config is not None else None
    if accfg is not None:
        _config = accfg
    if _config is not None:
        if partition_activations is not None:
            _config.partition_activations = partition_activations
        if checkpoint_in_cpu is not None:
            _config.cpu_checkpointing = checkpoint_in_cpu
        if num_checkpoints is not None:
            _config.number_checkpoints = num_checkpoints
    _policy_name = policy_name_from_config(_config)
    log_dist(f"activation checkpointing configured: policy={_policy_name}",
             ranks=[0])
    return _policy_name


def current_policy_name() -> str:
    return _policy_name


def run(policy: RematPolicy, function, *args):
    """``function(*args)`` under ``policy``: one non-reentrant checkpoint
    (no RNG state kept: the port's randomness is keyed, not stateful)."""
    if not policy.recompute:
        return function(*args)
    return _tc.checkpoint(function, *args, use_reentrant=False,
                          context_fn=policy.context_fn,
                          preserve_rng_state=False)


def checkpoint(function, *args, policy: Optional[str] = None):
    """Megatron-compatible: ``function(*args)`` under remat, with the
    ``configure()``d policy when none is given."""
    return run(get_policy(policy or _policy_name), function, *args)


def checkpoint_wrapper(function, policy: Optional[str] = None):
    """``function`` wrapped for later calls under remat."""
    resolved = get_policy(policy or _policy_name)
    return functools.wraps(function)(
        lambda *args: run(resolved, function, *args))
