"""Model specification base.

The JAX package's ``ModelSpec`` is a functional spec whose parameters are a
separate pytree: ``init(rng) -> params`` and ``apply(params, batch, rng,
train) -> loss``. Here a model is an ``nn.Module`` that carries its own
weights: ``init_weights(generator)`` draws them, the inference engine
serves them, and the training engine calls ``apply(batch, rng, train) ->
loss`` with its compute-dtype copies of the weights swapped in through
``torch.func.functional_call``. ``apply`` overrides ``nn.Module.apply(fn)``
on purpose: on a model of this port it is the loss, as in the JAX package.
"""

from typing import Optional

from torch import nn


class ModelSpec(nn.Module):
    """Base class for deepspeed_tpu_torch models."""

    def init_weights(self, generator) -> None:
        raise NotImplementedError

    def apply(self, batch, rng=None, train=True):
        """The training loss of one micro batch (a float32 scalar)."""
        raise NotImplementedError

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len: Optional[int] = None) -> Optional[float]:
        """Approximate training FLOPs per token (None when unknown)."""
        return None
