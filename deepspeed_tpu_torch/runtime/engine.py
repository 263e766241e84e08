"""DeepSpeedEngine: the training engine of the JAX package's
``runtime/engine.py``, for the single-device ZeRO-0 path.

The JAX engine compiles one program per global step: the gas micro steps
scanned, then the optimizer update. This engine runs the same steps
eagerly and keeps the JAX engine's mixed-precision contract:

- the model's ``Parameter``s are the float32 masters;
- once per global step each master is cast to the compute dtype (bf16 or
  f16, or kept f32) as a fresh leaf tensor with ``requires_grad``;
- each micro batch runs ``model.apply`` on those copies through
  ``torch.func.functional_call``, so its gradients come out in the compute
  dtype, as ``jax.grad`` of the cast tree gives them;
- they accumulate into buffers of ``gradient_accumulation_dtype`` (f32 by
  default);
- then the update: ``grads * 1/(gas * scale)``, clipping by
  ``min(1, clip / (norm + 1e-6))``, a skipped step on non-finite gradients
  under fp16, the optimizer on the masters, and the loss-scale update.

It runs on ``cuda`` unless it is given ``device=`` (the CPU tests pass
``"cpu"``), and raises without a GPU. ZeRO stages above 0, offload,
model/pipeline parallelism, client optimizers, the ``forward`` /
``backward`` / ``step`` user loop and checkpoints raise naming their
ROADMAP.md rows.
"""

from typing import Optional

import numpy as np
import torch

from ..models.api import ModelSpec
from ..utils.logging import log_dist
from .config import DeepSpeedConfig
from .config_utils import ConfigError
from .dataloader import DeepSpeedDataLoader
from .fp16.loss_scaler import (grads_finite, init_loss_scale_state,
                               update_loss_scale)
from .lr_schedules import get_lr_scheduler
from .optimizers import get_optimizer


class _ApplyCall(torch.nn.Module):
    """``functional_call`` calls a module's ``forward``; this one forwards
    to the model's ``apply`` (the loss), the model as its only child."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch, **kwargs):
        return self.model.apply(batch, **kwargs)


def _global_norm(grads):
    """sqrt of the sum over leaves of sum(g^2), in float32."""
    norms = torch._foreach_norm([g.to(torch.float32) for g in grads])
    return torch.stack(norms).square().sum().sqrt()


def _stack(micros):
    """Stack micro batches (dicts, tuples or arrays) into [gas, ...]."""
    first = micros[0]
    if isinstance(first, dict):
        return {k: _stack([m[k] for m in micros]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([m[i] for m in micros])
                           for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(micros)
    return np.stack(micros)


def _not_ported(what, row):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md row "
                               f"{row}")


class DeepSpeedEngine:

    def __init__(self, args=None, model: ModelSpec = None, optimizer=None,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, mpu=None, collate_fn=None, config=None,
                 mesh_manager=None, dont_change_device=False, device=None):
        if model is None:
            raise ValueError("deepspeed_tpu_torch.initialize requires a model")
        if not isinstance(model, ModelSpec):
            raise NotImplementedError(
                f"training a {type(model).__name__} is not ported yet: "
                f"ROADMAP.md row A10; pass a deepspeed_tpu_torch model")
        if mesh_manager is not None or mpu is not None:
            raise _not_ported("a device mesh or model-parallel unit (mpu)",
                              "A8")
        import torch.distributed as tdist
        if tdist.is_available() and tdist.is_initialized() and \
                tdist.get_world_size() > 1:
            raise _not_ported("data-parallel training over "
                              f"{tdist.get_world_size()} ranks", "A8")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DeepSpeedEngine: no CUDA device is available; pass "
                "device='cpu' to train on the CPU with the kernels' plain "
                "PyTorch versions")
        self._config = DeepSpeedConfig(config)
        cfg = self._config
        if cfg.sparse_gradients_enabled:
            raise ConfigError(
                "sparse_gradients is not supported on TPU; remove the key "
                "(gradients of embedding gathers are dense under XLA)")

        self.module = model.to(device=self.device, dtype=torch.float32)
        self._apply_call = _ApplyCall(self.module)
        self.training_dataloader = None
        self.collate_fn = collate_fn
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._last_grad_norm = None

        # ---- precision (the JAX engine's dtype wiring) ----
        if cfg.fp16.enabled:
            self._compute_dtype = torch.float16
        elif cfg.bf16.enabled:
            self._compute_dtype = torch.bfloat16
        else:
            self._compute_dtype = torch.float32
        self._dynamic_scale = cfg.fp16.enabled and cfg.fp16.dynamic_loss_scale
        gad = str(cfg.gradient_accumulation_dtype)
        self._grad_acc_dtype = torch.bfloat16 if gad in ("bf16", "bfloat16") \
            else torch.float32

        # ---- optimizer and schedule ----
        self.optimizer = None
        self.lr_scheduler = None
        if optimizer is not None:
            raise _not_ported("a client optimizer object (pass the config's "
                              "'optimizer' block)", "A11")
        if cfg.optimizer is not None:
            self.optimizer = get_optimizer(cfg.optimizer.type,
                                           cfg.optimizer.params)
            self._base_lr = self.optimizer.defaults.get("lr", 1e-3)
        if lr_scheduler is not None:
            self.lr_scheduler = lr_scheduler
        elif cfg.scheduler is not None and cfg.scheduler.type:
            self.lr_scheduler = get_lr_scheduler(cfg.scheduler.type,
                                                 cfg.scheduler.params)
        self.zero_stage = int(cfg.zero_config.stage)

        self._names = [n for n, _ in self.module.named_parameters()]
        self._masters = [p for _, p in self.module.named_parameters()]
        self.opt_state = (self.optimizer.init(self._masters)
                          if self.optimizer is not None else None)
        self.scaler_state = init_loss_scale_state(
            cfg.fp16 if cfg.fp16.enabled else None)

        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data)
        n_params = sum(p.numel() for p in self._masters)
        log_dist(
            f"DeepSpeedEngine initialized: params={n_params / 1e6:.1f}M "
            f"zero_stage={self.zero_stage} device={self.device} "
            f"dtype={str(self._compute_dtype).replace('torch.', '')} "
            f"batch={cfg.train_batch_size} "
            f"(micro={cfg.train_micro_batch_size_per_gpu} "
            f"gas={cfg.gradient_accumulation_steps})", ranks=[0])

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------
    def deepspeed_io(self, dataset, batch_size=None, route=None,
                     data_sampler=None, collate_fn=None,
                     num_local_io_workers=None):
        cfg = self._config
        if batch_size is None:
            batch_size = cfg.train_micro_batch_size_per_gpu * self.dp_world_size
        return DeepSpeedDataLoader(dataset, batch_size=batch_size,
                                   collate_fn=collate_fn or self.collate_fn,
                                   drop_last=cfg.dataloader_drop_last,
                                   data_sampler=data_sampler, seed=cfg.seed)

    def _next_gas_batch(self, data_iter):
        """Stack gas micro batches from an iterator into [gas, ...] leaves."""
        gas = self._config.gradient_accumulation_steps
        return _stack([next(data_iter) for _ in range(gas)])

    def _to_device_batch(self, batch):
        if isinstance(batch, dict):
            return {k: self._to_device_batch(v) for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._to_device_batch(v) for v in batch)
        if not isinstance(batch, torch.Tensor):
            batch = torch.as_tensor(np.asarray(batch))
        if not batch.is_floating_point():
            batch = batch.long()
        return batch.to(self.device, non_blocking=True)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _cast_params(self):
        """The compute-dtype copy of every master: fresh leaves with
        ``requires_grad``, made once per global step."""
        return {n: p.detach().to(self._compute_dtype).requires_grad_()
                for n, p in zip(self._names, self._masters)}

    def _micro_loss(self, pc, mb, train=True):
        """Loss of one micro batch on the compute-dtype copies ``pc``."""
        out = torch.func.functional_call(
            self._apply_call, {"model." + n: t for n, t in pc.items()},
            (mb,), {"train": train})
        loss = out[0] if isinstance(out, tuple) else out
        return loss.to(torch.float32)

    def _accum_grads(self, batch):
        """Sum over the gas micro batches of loss * scale and of its
        gradients (compute dtype) into ``gradient_accumulation_dtype``
        buffers. Returns ``(lsum, gsum, gas)``."""
        leaves = [batch] if isinstance(batch, torch.Tensor) else \
            list(batch.values()) if isinstance(batch, dict) else list(batch)
        gas = leaves[0].shape[0]
        scale = self.scaler_state.scale
        pc = self._cast_params()
        params = list(pc.values())
        lsum, gsum = None, None
        for i in range(gas):
            mb = batch[i] if isinstance(batch, torch.Tensor) else \
                {k: v[i] for k, v in batch.items()} \
                if isinstance(batch, dict) else type(batch)(v[i] for v in batch)
            loss = self._micro_loss(pc, mb) * scale
            grads = torch.autograd.grad(loss, params)
            loss = loss.detach()
            if gsum is None and gas == 1:
                gsum = [g.to(torch.float32) for g in grads]
            elif gsum is None:
                gsum = [g.to(self._grad_acc_dtype) for g in grads]
            else:
                for acc, g in zip(gsum, grads):
                    acc.add_(g)
            lsum = loss if lsum is None else lsum + loss
            self.micro_steps += 1
        return lsum, gsum, gas

    def _clip_grads(self, grads):
        clip = self._config.gradient_clipping
        norm = _global_norm(grads)
        if not clip or clip <= 0:
            return grads, norm
        factor = torch.clamp(clip / (norm + 1e-6), max=1.0)
        torch._foreach_mul_(grads, factor)
        return grads, norm

    def _apply_update(self, grads, lr, denom):
        """Unscale/average, clip, update unless fp16 overflowed, then the
        loss-scale update. Returns ``(finite, grad_norm)``."""
        cfg = self._config
        grads = [g.to(torch.float32) for g in grads]
        torch._foreach_mul_(grads, 1.0 / (denom * self.scaler_state.scale))
        grads, grad_norm = self._clip_grads(grads)
        finite = bool(grads_finite(grads)) if cfg.fp16.enabled else True
        if finite:
            _, self.opt_state = self.optimizer.update(
                grads, self.opt_state, self._masters, lr)
        self.scaler_state = update_loss_scale(
            self.scaler_state, finite, dynamic=self._dynamic_scale,
            scale_window=cfg.fp16.loss_scale_window,
            min_scale=cfg.fp16.min_loss_scale,
            max_hysteresis=cfg.fp16.hysteresis)
        return finite, grad_norm

    def train_batch(self, data_iter=None, batch=None):
        """One global step: the gas micro batches of ``batch`` (leaves
        ``[gas, micro, ...]``), or gas batches drawn from ``data_iter``,
        then the update. Returns the mean loss (a float32 tensor on the
        engine's device)."""
        if self.optimizer is None:
            raise ConfigError("train_batch needs an optimizer: add an "
                              "'optimizer' block to the config")
        if batch is None:
            batch = self._next_gas_batch(data_iter)
        batch = self._to_device_batch(batch)
        scale = self.scaler_state.scale
        lr = self.get_lr()[0]
        lsum, gsum, gas = self._accum_grads(batch)
        finite, grad_norm = self._apply_update(gsum, lr, denom=float(gas))
        metrics = {"loss": lsum / (gas * scale), "grad_norm": grad_norm,
                   "loss_scale": scale, "overflow": not finite}
        self._last_grad_norm = grad_norm
        self._post_step(metrics)
        return metrics["loss"]

    @torch.no_grad()
    def eval_batch(self, batch):
        """Loss of one ``[micro, ...]`` batch, no gradients."""
        pc = {n: p.to(self._compute_dtype)
              for n, p in zip(self._names, self._masters)}
        return self._micro_loss(pc, self._to_device_batch(batch),
                                train=False)

    def _post_step(self, metrics):
        self.global_steps += 1
        self.global_samples += self._config.train_batch_size
        if metrics["overflow"]:
            self.skipped_steps += 1
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step()
        spp = self._config.steps_per_print
        if spp and self.global_steps % spp == 0:
            log_dist(f"step={self.global_steps} "
                     f"loss={float(metrics['loss']):.4f} "
                     f"lr={self.get_lr()[0]:.3e} "
                     f"skipped={self.skipped_steps}", ranks=[0])

    # ------------------------------------------------------------------
    # what this slice does not run
    # ------------------------------------------------------------------
    def forward(self, *args, **kwargs):
        raise _not_ported("the forward/backward/step user loop (use "
                          "train_batch)", "A2b")

    __call__ = backward = step = forward

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, exclude_frozen_parameters=False):
        raise _not_ported("save_checkpoint", "A7")

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False):
        raise _not_ported("load_checkpoint", "A7")

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------
    def get_lr(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler.get_last_lr()
        return [self._base_lr]

    def get_global_grad_norm(self) -> Optional[torch.Tensor]:
        """The gradient norm of the last step (before clipping)."""
        return self._last_grad_norm

    @property
    def cur_scale(self):
        return float(self.scaler_state.scale)

    @property
    def loss_scale(self):
        return self.cur_scale

    @property
    def dp_world_size(self):
        return 1

    @property
    def mp_world_size(self):
        return 1

    @property
    def train_batch_size(self):
        return self._config.train_batch_size

    @property
    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    @property
    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def zero_optimization(self):
        return self.zero_stage > 0

    def zero_optimization_stage(self):
        return self.zero_stage

    def fp16_enabled(self):
        return self._config.fp16.enabled

    def bfloat16_enabled(self):
        return self._config.bf16.enabled
