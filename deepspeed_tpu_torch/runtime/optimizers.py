"""Optimizers: the Adam family of the JAX package's
``runtime/optimizers.py``, on lists of tensors with ``torch._foreach_*``.

``get_optimizer`` builds ``adam``, ``adamw``, ``fusedadam`` and
``cpu_adam`` (all four decoupled-decay Adam, as in the JAX package, with or
without ``bias_correction``). The order of operations is the JAX package's
(optax ``scale_by_adam`` followed by ``_chain_update``), which is why
``torch.optim`` is not used:

    mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu
    u  = mu_hat / (sqrt(nu_hat) + eps)    (hats: / (1 - b^t); none without
                                           bias correction)
    u  = u + wd p                         (every leaf, no mask)
    p  = p - lr u

The update runs in place on the f32 master tensors and the moment buffers,
a group of leaves at a time (``_GROUP_BYTES``): the foreach temporaries
(the corrected moments, the denominators, the updates) then hold at most
about a gigabyte each, not a copy of every leaf, which would be three more
f32 copies of the model at the step's peak. The foreach ops are the same
on every group, so the values do not depend on the grouping. The other
optimizer types raise naming ROADMAP.md row A11.
"""

from typing import Callable, List, NamedTuple

import torch

ADAM_FAMILY = ("adam", "adamw", "fusedadam", "cpu_adam")
_GROUP_BYTES = 1 << 30


class AdamState(NamedTuple):
    count: int                   # steps taken
    mu: List[torch.Tensor]       # first moments, f32
    nu: List[torch.Tensor]       # second moments, f32


class Optimizer(NamedTuple):
    init: Callable               # init(params) -> state
    # update(grads, state, params, lr) -> (params, state), params in place
    update: Callable
    name: str = "custom"
    defaults: dict = {}


class _ScaleByAdam:
    """optax ``scale_by_adam`` (bias-corrected) or the JAX package's
    ``_scale_by_adam_no_bias_correction``: grads -> updates, moments
    updated in place."""

    def __init__(self, b1, b2, eps, bias_correction=True):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.bias_correction = bias_correction

    def init(self, params):
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return AdamState(count=0, mu=zeros, nu=[z.clone() for z in zeros])

    def update(self, grads, state):
        count = state.count + 1
        return self.group_update(grads, state.mu, state.nu, count), \
            AdamState(count, state.mu, state.nu)

    def group_update(self, grads, mu, nu, count):
        """Step ``count`` on one group of leaves: their moments in place,
        their updates returned."""
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        if self.bias_correction:
            mu_hat = torch._foreach_div(mu, 1 - b1 ** count)
            den = torch._foreach_div(nu, 1 - b2 ** count)
        else:
            mu_hat, den = mu, [v.clone() for v in nu]
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        return torch._foreach_div(mu_hat, den)


def _groups(tensors):
    """Index lists of consecutive leaves of at most ``_GROUP_BYTES`` in
    f32 (a larger leaf alone)."""
    group, size = [], 0
    for i, t in enumerate(tensors):
        nbytes = 4 * t.numel()
        if group and size + nbytes > _GROUP_BYTES:
            yield group
            group, size = [], 0
        group.append(i)
        size += nbytes
    if group:
        yield group


def _chain_update(core, params, grads, state, lr, weight_decay):
    """Adam updates plus decoupled decay, then ``p - lr u``, in place on
    ``params``, a group of leaves at a time. (The JAX package's
    L2-into-grads branch serves only the optimizers of row A11.)"""
    count = state.count + 1
    for idx in _groups(params):
        ps = [params[i] for i in idx]
        updates = core.group_update([grads[i] for i in idx],
                                    [state.mu[i] for i in idx],
                                    [state.nu[i] for i in idx], count)
        if weight_decay:
            torch._foreach_add_(updates, ps, alpha=weight_decay)
        with torch.no_grad():
            torch._foreach_add_(ps, updates, alpha=-lr)
    return params, AdamState(count, state.mu, state.nu)


def get_optimizer(name: str, params_config: dict = None) -> Optimizer:
    cfg = dict(params_config or {})
    name = name.lower()
    lr0 = cfg.pop("lr", 1e-3)
    betas = cfg.pop("betas", (0.9, 0.999))
    eps = cfg.pop("eps", 1e-8)
    weight_decay = cfg.pop("weight_decay", 0.0)
    bias_correction = cfg.pop("bias_correction", True)
    defaults = {"lr": lr0, "betas": betas, "eps": eps,
                "weight_decay": weight_decay,
                "bias_correction": bias_correction}
    if name not in ADAM_FAMILY:
        raise NotImplementedError(
            f"optimizer type {name!r} is not ported yet (this port has "
            f"{', '.join(ADAM_FAMILY)}): ROADMAP.md row A11")
    core = _ScaleByAdam(betas[0], betas[1], eps, bias_correction)

    def update(grads, state, params, lr):
        # DeepSpeed's "adam" is AdamW-mode by default: decoupled for all four
        return _chain_update(core, params, grads, state, lr, weight_decay)

    return Optimizer(core.init, update, name, defaults)
