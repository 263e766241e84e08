"""Progressive layer drop, as the JAX package's
``runtime/progressive_layer_drop.py``.

``ProgressiveLayerDrop`` anneals the keep probability ``theta(t) = (1 -
theta) exp(-gamma t) + theta`` from 1 toward ``theta``; the engine hands it
to the model each step (``pld_theta``), taken to float32 as the JAX engine
takes it. ``keep_prob_for_layer`` is what the JAX layer scan computes from its
int32 counter, in float32: ``1 - f32(i + 1) / f32(L) * (1 - theta)``, as
XLA compiles it (``L`` is static, so the division becomes a product with
the float32 reciprocal ``1 / L``, and ``1 - a * b`` one fused
multiply-add, rounded once).
The model draws layer ``i``'s coin on the host, ``bernoulli(fold_in(
layer_key, 1002), keep_p)``, and a dropped layer is the identity, with no
``1 / p`` rescale (``deepspeed_tpu/models/gpt2.py:371-380``).
"""

import math
from fractions import Fraction

import numpy as np


class ProgressiveLayerDrop:

    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def get_theta(self, global_step: int = None) -> float:
        if global_step is not None:
            self.update_state(global_step)
        return self.current_theta

    def update_state(self, global_step: int):
        self.current_theta = (1.0 - self.theta) * math.exp(
            -self.gamma * global_step) + self.theta
        return self.current_theta

    def get_state(self):
        return {"progressive_layer_drop": True,
                "pld_theta": self.get_theta()}


def _round_f32(exact: Fraction) -> np.float32:
    """``exact`` rounded to the nearest float32 (ties to even)."""
    guess = np.float32(float(exact))
    near = (np.nextafter(guess, np.float32(-np.inf)), guess,
            np.nextafter(guess, np.float32(np.inf)))
    return min(near, key=lambda c: (abs(Fraction(float(c)) - exact),
                                    int(c.view(np.uint32)) & 1))


def keep_prob_for_layer(theta, layer_idx: int, n_layers: int):
    """Layer ``layer_idx``'s keep probability in float32: deeper layers
    drop more, ``1 - (i + 1) / L * (1 - theta)``, evaluated as the JAX
    program compiles it: ``fma(-(f32(i + 1) * f32(1 / L)), 1 - theta,
    1)``."""
    one = np.float32(1.0)
    frac = np.float32(layer_idx + 1) * (one / np.float32(max(1, n_layers)))
    rest = one - np.float32(theta)
    return _round_f32(1 - Fraction(float(frac)) * Fraction(float(rest)))
