"""Loss scaling for fp16 training: the JAX package's
``runtime/fp16/loss_scaler.py`` with the same hysteresis and window
semantics.

The JAX package keeps the scaler state inside its compiled step and takes
the skip branch with ``lax.cond``. Here the engine runs eagerly: the state
is three Python numbers, ``grads_finite`` is one device bool, and
``update_loss_scale`` is plain Python on the host.
"""

from typing import NamedTuple

import torch


class LossScaleState(NamedTuple):
    scale: float        # the loss scale
    good_steps: int     # consecutive overflow-free steps
    hysteresis: int     # remaining tolerance of overflows before backing off


def init_loss_scale_state(fp16_config=None, static_scale=None) -> LossScaleState:
    if static_scale is not None:
        scale = float(static_scale)
    elif fp16_config is not None and not fp16_config.dynamic_loss_scale:
        scale = float(fp16_config.loss_scale)
    elif fp16_config is not None:
        scale = float(2 ** fp16_config.initial_scale_power)
    else:
        scale = 1.0
    hysteresis = fp16_config.hysteresis if fp16_config else 2
    return LossScaleState(scale=scale, good_steps=0, hysteresis=int(hysteresis))


def grads_finite(grads) -> torch.Tensor:
    """One bool tensor: every element of every gradient is finite."""
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def update_loss_scale(state: LossScaleState, finite: bool, dynamic: bool,
                      scale_window: int = 1000, scale_factor: float = 2.0,
                      min_scale: float = 1.0,
                      max_hysteresis: int = 2) -> LossScaleState:
    """Back off on overflow once the hysteresis is used up; grow after
    ``scale_window`` clean steps (DynamicLossScaler.update_scale)."""
    if not dynamic:
        return state
    if not finite:
        new_hyst = state.hysteresis - 1
        if new_hyst <= 0:
            return LossScaleState(scale=max(state.scale / scale_factor, min_scale),
                                  good_steps=0, hysteresis=int(max_hysteresis))
        return LossScaleState(scale=state.scale, good_steps=0, hysteresis=new_hyst)
    grow = (state.good_steps + 1) % scale_window == 0
    return LossScaleState(scale=state.scale * scale_factor if grow else state.scale,
                          good_steps=state.good_steps + 1,
                          hysteresis=state.hysteresis)
