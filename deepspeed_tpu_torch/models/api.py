"""Model specification base.

The JAX package's ``ModelSpec`` is a functional spec whose parameters are a
separate pytree. Here a model is an ``nn.Module`` that carries its own
weights: ``init_weights(generator)`` draws them, and the inference engine
serves them.
"""

from torch import nn


class ModelSpec(nn.Module):
    """Base class for deepspeed_tpu_torch models."""

    def init_weights(self, generator) -> None:
        raise NotImplementedError

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
