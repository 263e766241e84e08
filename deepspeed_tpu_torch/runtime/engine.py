"""DeepSpeedEngine: the training engine of the JAX package's
``runtime/engine.py``, over ``torch.distributed`` ranks with ZeRO stages
0-3.

The JAX engine compiles one program per global step: the gas micro steps
scanned, then the optimizer update. This engine runs the same steps
eagerly, through ``train_batch`` or DeepSpeed's user loop (``loss =
engine(batch); engine.backward(loss); engine.step()``), which share one
accumulation and one update, and keeps the JAX engine's mixed-precision
contract:

- the float32 masters; once per global step each is cast to the compute
  dtype (bf16 or f16, or kept f32) as a fresh leaf tensor with
  ``requires_grad``;
- each micro batch runs ``model.apply`` on those copies through
  ``torch.func.functional_call``, so its gradients come out in the compute
  dtype, as ``jax.grad`` of the cast tree gives them;
- they accumulate into buffers of ``gradient_accumulation_dtype`` (f32 by
  default);
- then the update: ``grads * 1/(gas * scale * dp)``, clipping by
  ``min(1, clip / (norm + 1e-6))``, a skipped step on non-finite gradients
  under fp16, the optimizer on the masters, and the loss-scale update.

Data parallelism (the rank topology of ``parallel/topology.py``; the
JAX engine's dp mesh): rank ``r`` trains on rows ``[r micro, (r + 1)
micro)`` of the JAX engine's global micro batch (``train_batch`` and
``forward`` take the global batch and keep those rows, or the rank's rows
alone). Its loss is its mean times ``dp n_r / n`` (``n_r`` its valid
targets, ``n`` the ranks' sum), and the gradients are summed over the
ranks and divided by ``dp``: those of the global batch's mean, as the
JAX engine takes it. ZeRO (``runtime/zero/partition.py``: the JAX
planner's per-leaf rule):

- stage 0: the model's ``Parameter``s are the masters; the accumulated
  gradients (``gradient_accumulation_dtype``) are all-reduced at the step;
- stage 1: each rank holds its shard of the masters and of ``mu`` /
  ``nu``; the full gradients are all-reduced at the step, the rank updates
  its shard, and the shards are all-gathered into the model's parameters;
- stage 2: + each micro step's gradients are reduce-scattered, in the
  compute dtype, into the rank's shard accumulator;
- stage 3: + the parameters: the model keeps none, each layer's leaves are
  gathered by the layer loop's hook and freed after the layer, and
  gathered again in the backward, which reduce-scatters their gradients
  (``runtime/zero/stage3.py``). Leaves under
  ``stage3_param_persistence_threshold`` stay replicated.

The gradient norm sums the shards' squares over the ranks and counts a
replicated leaf once; the fp16 skip decision and the returned loss are
all-reduced, so every rank takes the same step.

Tensor parallelism (the rank mesh's ``model`` axis: ``tensor_parallel_size``
in the config, or the mesh handed in; ``parallel/tensor_parallel.py``):
the model holds its rank's part of each sharded leaf (a whole model is
sharded in place), and its layers run the tp collectives, so a rank's
gradients are its part's. They are reduced over the dp group only; the
tp ranks of one dp index read the same rows. The gradient norm sums a
tp-sharded leaf's squares over the tp group and counts a replicated leaf
once; ZeRO shards the rank's tp part over the dp ranks. An ``mpu`` is
accepted and kept on the config, as the JAX package keeps it.

Where the planner partitions nothing (one rank: the JAX planner shards
nothing at dp 1) the engine runs stage 0 whatever the configured stage.

Randomness is the JAX engine's, key for key (``inference/prng.py``): the
base key is ``PRNGKey(seed + 1)``; ``train_batch`` keys micro step ``i``
``fold_in(fold_in(base, global_steps), i)``, ``forward`` keys
``fold_in(base, micro_steps)``. A rank draws its rows of the global
batch's masks (``ops/dropout.batch_rows``). Each step hands the model its
modifiers: progressive layer drop's ``pld_theta`` and random-LTD's
``ltd_keep``. An ``activation_checkpointing`` block turns the model's
``remat`` on under the configured policy (``runtime/activation_checkpointing``).

One deliberate difference from the JAX engine: its ``backward`` ignores
its argument (the gradients were taken in ``forward``); this one
differentiates the loss it is given, ``forward``'s unless another is
passed. The two agree when the loss is ``forward``'s.

Checkpoints are the JAX package's (``runtime/checkpointing.py``): a tag
either package writes loads in the other, at any stage and rank count, and
a resumed run continues the same stream (keys, layer-drop theta, LTD
schedule, LR step, Adam count).

It runs on ``cuda`` unless it is given ``device=`` (the CPU tests pass
``"cpu"``), and raises without a GPU. ZeRO offload, pipeline, sequence and
expert parallelism and client optimizers raise naming their ROADMAP.md
rows.
"""

import contextlib
import dataclasses
import functools
import inspect
import math
from collections import deque
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..comm import comm
from ..comm.logging import configure_comms_logger
from ..inference import prng
from ..models.api import ModelSpec
from ..ops import dropout
from ..parallel import tensor_parallel
from ..parallel.topology import DP_AXES, current_mesh, mesh_for_tp
from ..telemetry.trace import get_tracer
from ..utils.logging import log_dist, logger
from . import constants as C
from .activation_checkpointing import checkpointing
from .config import DeepSpeedConfig
from .config_utils import ConfigError
from .data_pipeline.random_ltd import RandomLTDScheduler
from .dataloader import DeepSpeedDataLoader
from .fp16.loss_scaler import (grads_finite, init_loss_scale_state,
                               update_loss_scale)
from .lr_schedules import get_lr_scheduler
from .optimizers import get_optimizer
from .progressive_layer_drop import ProgressiveLayerDrop
from .zero import stage3
from .zero.partition import ZeroShardingPlanner, param_shards


def _exact(fn):
    """The engine's own collectives (the update, the gradient norm,
    checkpoints, whole tensors, the stage path) run at full precision
    whatever the ``comm_compression`` policy: in the JAX package XLA
    inserts them, and no policy reaches them there."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with comm.full_precision():
            return fn(*args, **kwargs)
    return wrapper


class _ApplyCall(torch.nn.Module):
    """``functional_call`` calls a module's ``forward``; this one forwards
    to the model's ``apply`` (the loss), the model as its only child."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch, **kwargs):
        return self.model.apply(batch, **kwargs)


def _leaf_squares(grads):
    """Each leaf's sum(g^2) in float32 (as the squares of the leaves'
    norms, a ``[n_leaves]`` tensor)."""
    norms = torch._foreach_norm([g.to(torch.float32) for g in grads])
    return torch.stack(norms).square()


def _micro(batch, i):
    """Micro batch ``i`` of a ``[gas, ...]`` batch (a tensor, a dict or a
    tuple of them)."""
    if isinstance(batch, torch.Tensor):
        return batch[i]
    if isinstance(batch, dict):
        return {k: v[i] for k, v in batch.items()}
    return type(batch)(v[i] for v in batch)


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


def _rows(batch):
    """The leading (batch) size of a micro batch's leaves."""
    if isinstance(batch, dict):
        batch = next(iter(batch.values()))
    elif isinstance(batch, (tuple, list)):
        batch = batch[0]
    return int(batch.shape[0])


def _slice_rows(batch, axis, start, n):
    """Rows ``[start, start + n)`` along ``axis`` of every leaf."""
    if isinstance(batch, dict):
        return {k: _slice_rows(v, axis, start, n) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_slice_rows(v, axis, start, n) for v in batch)
    if isinstance(batch, torch.Tensor):
        return batch.narrow(axis, start, n)
    return np.take(np.asarray(batch), range(start, start + n), axis=axis)


class DeepSpeedEngine:

    def __init__(self, args=None, model: ModelSpec = None, optimizer=None,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, mpu=None, collate_fn=None, config=None,
                 mesh_manager=None, dont_change_device=False, device=None):
        if model is None:
            raise ValueError("deepspeed_tpu_torch.initialize requires a model")
        if not isinstance(model, ModelSpec):
            # the JAX engine injects HF modules for serving only
            raise TypeError(
                f"initialize takes a deepspeed_tpu_torch model, not a "
                f"{type(model).__name__}; HF modules are served through "
                f"init_inference (module injection), as in the JAX package")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DeepSpeedEngine: no CUDA device is available; pass "
                "device='cpu' to train on the CPU with the kernels' plain "
                "PyTorch versions")
        # a launcher's world of several ranks makes its process group here
        # (nccl on the card, gloo on the CPU), as the JAX engine's
        # init_distributed() does; one rank needs none
        if not comm.is_initialized() and comm.env_world_size() > 1:
            comm.init_distributed(device=self.device)
        # nccl carries CUDA tensors only; gloo carries both (several ranks
        # on one card run a gloo group over CUDA tensors)
        backend = comm.get_backend()
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError(
                f"DeepSpeedEngine: the process group's backend is nccl but "
                f"the engine's device is {self.device}; use gloo with the "
                f"CPU")
        from .. import _config_dict
        pd = _config_dict(config)
        self.mesh_manager = mm = self._mesh(pd) if mesh_manager is None \
            else mesh_manager
        # the mesh's tp is the config's: a config without the key takes it
        if int(pd.get(C.TENSOR_PARALLEL_SIZE, mm.tp)) != mm.tp:
            raise ConfigError(
                f"tensor_parallel_size={pd[C.TENSOR_PARALLEL_SIZE]} but the "
                f"rank mesh handed in has tp={mm.tp}")
        if mm.tp > 1 and C.TENSOR_PARALLEL_SIZE not in pd:
            config = dict(pd, **{C.TENSOR_PARALLEL_SIZE: mm.tp})
        self._config = DeepSpeedConfig(config, world_size=mm.world_size,
                                       mpu=mpu)
        cfg = self._config
        self._tp = tensor_parallel.from_mesh(mm)
        configure_comms_logger(cfg.comms_logger)
        self._dp_world = mm.dp_world_size
        self._dp_rank = mm.dp_rank
        self._dp_group = DP_AXES
        if cfg.sparse_gradients_enabled:
            raise ConfigError(
                "sparse_gradients is not supported on TPU; remove the key "
                "(gradients of embedding gathers are dense under XLA)")

        if self._tp.active:
            if not model.tensor_parallel:
                raise ValueError(f"{type(model).__name__} has no "
                                 f"tensor-parallel layers: it trains at tp "
                                 f"1 only (the mesh has tp={mm.tp})")
            model.shard_tp(self._tp)      # in place, for a whole model
        elif model.tp.active:
            raise ValueError(f"the model was built at {model.tp}; the rank "
                             f"mesh has tp=1")
        self.module = model.to(device=self.device, dtype=torch.float32)
        self.module._zero_hook = None
        self._apply_call = _ApplyCall(self.module)
        # the process tracer: checkpoint spans, retry and rollback counters
        self.tracer = get_tracer()
        self._last_save_dir = None   # updated by save_checkpoint
        # recent checkpoint activity: kind, tag, step, seconds, bytes and
        # the seconds spent hashing (runtime/checkpointing.py)
        self._ckpt_history = deque(maxlen=32)
        self.training_dataloader = None
        self.collate_fn = collate_fn
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._last_grad_norm = None
        self._base_rng = tuple(prng.prng_key(cfg.seed + 1).tolist())
        # the accumulation buffers train_batch and the user loop share
        self._grad_acc = None
        self._grad_acc_count = 0
        self._loss_acc = None
        self._pending = None
        self._row0 = 0           # global batch row of this rank's first row

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
        self._setup_zero(cfg.zero_config)
        self.opt_state = (self.optimizer.init(self._masters)
                          if self.optimizer is not None else None)
        self.scaler_state = init_loss_scale_state(
            cfg.fp16 if cfg.fp16.enabled else None)

        # ---- progressive layer drop, random-LTD, activation checkpointing
        self.progressive_layer_drop = None
        pld = dict(cfg.progressive_layer_drop)
        if pld.get("enabled"):
            self._require_fwd_kwarg("pld_theta", "progressive_layer_drop")
            self.progressive_layer_drop = ProgressiveLayerDrop(
                theta=float(pld.get("theta", 0.5)),
                gamma=float(pld.get("gamma", 0.001)))
        self.random_ltd_scheduler = None
        de = dict(cfg.data_efficiency)
        routing = dict(de.get("data_routing") or {})
        rl = dict(routing.get("random_ltd") or {})
        if de.get("enabled") and routing.get("enabled") and rl.get("enabled"):
            self._require_fwd_kwarg("ltd_keep", "random_ltd")
            self.random_ltd_scheduler = RandomLTDScheduler(rl)
        self._last_modifiers = (None, None)
        if cfg._param_dict.get("activation_checkpointing") is not None:
            self._configure_remat()
        self._setup_explicit_exchange(cfg)

        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data)
        if cfg.load_universal_checkpoint:
            log_dist("load_universal_checkpoint: checkpoints here are "
                     "universal by construction (whole arrays, any layout "
                     "loads them); the flag is honored trivially", ranks=[0])
        n_params = sum(math.prod(s) for s in self._shapes)
        log_dist(
            f"DeepSpeedEngine initialized: params={n_params / 1e6:.1f}M "
            f"zero_stage={self.zero_stage} dp={self._dp_world} tp={mm.tp} "
            f"device={self.device} "
            f"dtype={str(self._compute_dtype).replace('torch.', '')} "
            f"batch={cfg.train_batch_size} "
            f"(micro={cfg.train_micro_batch_size_per_gpu} "
            f"gas={cfg.gradient_accumulation_steps})", ranks=[0])

    @staticmethod
    def _mesh(pd):
        """The global rank mesh at the tp of the config ``pd`` (at the
        global mesh's when the config names none)."""
        mm = current_mesh()
        key = pd.get(C.TENSOR_PARALLEL_SIZE)
        return mesh_for_tp(int(key) if key is not None else
                           (mm.tp if mm else 1))

    def _require_fwd_kwarg(self, name: str, feature: str):
        """A feature that needs the model's cooperation raises when the
        model's ``apply`` cannot take its keyword, as in the JAX engine."""
        params = inspect.signature(self.module.apply).parameters
        if name not in params and not any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values()):
            raise ConfigError(
                f"config enables {feature} but "
                f"{type(self.module).__name__}.apply() does not accept "
                f"'{name}' — this model cannot honor the setting")

    def _setup_zero(self, zcfg):
        """The ZeRO layout: the planner (the JAX engine's, on the JAX
        tree's shapes), each parameter's ``ParamShard``, and the masters:
        the model's ``Parameter``s at stage 0, else this rank's shards
        (copies); at stage 3 the model's own tensors are freed."""
        module = self.module
        rules = module.partition_rules() \
            if hasattr(module, "partition_rules") else None
        self.planner = ZeroShardingPlanner(
            self.mesh_manager, self.zero_stage, rules=rules,
            persistence_threshold=zcfg.stage3_param_persistence_threshold
            if self.zero_stage >= 3 else 0)
        self._layout = module.jax_layout()
        self._names = [n for n, _ in module.named_parameters()]
        self._params = [p for _, p in module.named_parameters()]
        self._pshards = param_shards(module, self.planner, self._dp_rank,
                                     self._dp_world)
        # the whole (JAX) shapes: what checkpoints and the tensor-fragment
        # API see at any tp
        self._shapes = [ps.whole_shape for ps in self._pshards]
        # a leaf the tp ranks hold whole enters the gradient norm once:
        # from tp rank 0
        self._tp_norm_weights = torch.tensor(
            [1.0 if ps.tp is not None or self._tp.rank == 0 else 0.0
             for ps in self._pshards], device=self.device)
        # a block shared by several tp ranks (kv heads below tp) enters
        # it once too: {leaf index: the mask of the rank's own elements}
        self._tp_owned = {i: self._owned_mask(ps)
                          for i, ps in enumerate(self._pshards)
                          if ps.tp is not None and ps.tp.shared}
        self._layer_of = {id(blk): i for i, blk in
                          enumerate(getattr(module, "blocks", []))}
        self.zero_gather_stats = stage3.GatherStats()
        # the stage the engine runs: the configured one, or stage 0's when
        # the planner partitions nothing (one rank, where the JAX planner
        # shards nothing), the masters then being the parameters themselves
        self._stage = self.zero_stage if any(
            ps.partitioned for ps in self._pshards) else 0
        if self._stage == 0:
            self._masters = self._params
            return
        with torch.no_grad():
            self._masters = [ps.take(p.detach()).clone()
                             for p, ps in zip(self._params, self._pshards)]
            if self._stage >= 3:
                for p in self._params:
                    p.data = p.data.new_empty((0,))
        # a replicated leaf's square enters the gradient norm once: from
        # dp rank 0
        self._norm_weights = torch.tensor(
            [1.0 if ps.partitioned or self._dp_rank == 0 else 0.0
             for ps in self._pshards], device=self.device)

    def _setup_explicit_exchange(self, cfg):
        """``comm_compression`` and ``overlap_schedule``: the policy is
        installed for every collective; at dp > 1, when a policy a ZeRO
        step uses is not off (``fp32`` counts) or the overlap schedule is
        on, the micro gradient takes the JAX package's explicit exchange
        (``runtime/zero/compressed_step.py``, bucketed by
        ``runtime/zero/overlap_schedule.py``) in place of the stage
        engine's. Its scope is refused at init, as in the JAX package."""
        from ..comm.compression import configure_comm_compression
        cc = configure_comm_compression(cfg.comm_compression)
        dp = self.mesh_manager.dp_world_size
        self._cc_zero_active = cc.zero_path_active and dp > 1
        self._sched_active = cfg.overlap_schedule.enabled and dp > 1
        self._compressed_grad_fns = {}
        self._sched_info = None
        self._xstate = None
        if not (self._cc_zero_active or self._sched_active):
            return
        from .zero.compressed_step import explicit_scope_error
        feature = "overlap_schedule" if self._sched_active else \
            "comm_compression"
        err = explicit_scope_error(self, feature)
        if err:
            raise ConfigError(err)
        local = cc.local_members(dp) if cc.hierarchical else 0
        if local:       # every rank makes the (host, local) groups, once
            from ..parallel.topology import DATA_AXIS
            self.mesh_manager.host_process_groups(DATA_AXIS, local)
        if self._sched_active:
            from .zero.overlap_schedule import build_schedule
            _, _, _, info = build_schedule(self, cfg.overlap_schedule)
            self._sched_info = info
            log_dist(
                "overlap_schedule: bucketed ZeRO exchange active "
                f"(overlap={cfg.overlap_schedule.overlap} "
                f"bucket_bytes={cfg.overlap_schedule.bucket_bytes} "
                f"gather_buckets={info['gather_buckets']} "
                f"rs_buckets={info['rs_buckets']} "
                f"layer_chunks={len(info['layer_chunks'])})", ranks=[0])
        if self._cc_zero_active:
            log_dist(
                "comm_compression: explicit ZeRO exchange active "
                f"(all_gather={cc.all_gather} "
                f"reduce_scatter={cc.reduce_scatter} "
                f"all_reduce={cc.all_reduce} "
                f"block={cc.block_size} "
                f"hierarchical={cc.hierarchical})", ranks=[0])

    @property
    def _explicit(self) -> bool:
        return self._cc_zero_active or self._sched_active

    def _compressed_micro_grad(self, ltd_keep):
        """The explicit exchange: bucketed when ``overlap_schedule`` is on,
        else per leaf; cached per random-LTD token budget, as the JAX
        engine caches its step functions."""
        if ltd_keep not in self._compressed_grad_fns:
            if self._sched_active:
                from .zero.overlap_schedule import make_bucketed_micro_grad
                fn = make_bucketed_micro_grad(self)
            else:
                from .zero.compressed_step import make_compressed_micro_grad
                fn = make_compressed_micro_grad(self)
            self._compressed_grad_fns[ltd_keep] = fn
        return self._compressed_grad_fns[ltd_keep]

    def _configure_remat(self):
        """The ``activation_checkpointing`` block -> the model's ``remat``
        and ``remat_policy`` (the JAX engine's ``configure()`` call).
        Host-offloaded remat warns and takes the default policy, as the
        JAX engine does off a TPU."""
        pol = checkpointing.configure(deepspeed_config=self._config)
        if pol == "offload_dots":
            logger.warning(
                "cpu_checkpointing: host-offload remat is not ported to the "
                "card; falling back to dots_with_no_batch_dims_saveable for "
                "this run")
            pol = checkpointing.DEFAULT_POLICY
        mcfg = getattr(self.module, "config", None)
        if mcfg is not None and hasattr(mcfg, "remat"):
            updates = {"remat": True}
            if hasattr(mcfg, "remat_policy"):
                updates["remat_policy"] = pol
            self.module.config = dataclasses.replace(mcfg, **updates)

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
                                   data_sampler=data_sampler, seed=cfg.seed,
                                   dp_rank=self._dp_rank,
                                   dp_world=self._dp_world)

    def _local(self, batch, axis):
        """This rank's rows of a batch (along ``axis``): a global batch of
        ``micro * dp`` rows gives rows ``[r micro, (r + 1) micro)``, a
        batch of the rank's own rows is taken as it is."""
        micro = self._config.train_micro_batch_size_per_gpu
        if self._dp_world == 1:
            return batch
        leaf = next(iter(batch.values())) if isinstance(batch, dict) else \
            batch[0] if isinstance(batch, (tuple, list)) else batch
        if leaf.shape[axis] == micro * self._dp_world:
            return _slice_rows(batch, axis, self._dp_rank * micro, micro)
        return batch

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
    def _compute_sources(self):
        """What the compute-dtype copies are made from: the model's
        (whole) parameters, or under stage 3 the master shards."""
        return self._masters if self._stage >= 3 else self._params

    def _cast_params(self):
        """The compute-dtype copy of every master (of its shard, under
        stage 3): fresh leaves with ``requires_grad``, made once per global
        step."""
        return {n: p.detach().to(self._compute_dtype).requires_grad_()
                for n, p in zip(self._names, self._compute_sources())}

    def _stage3_inputs(self, pc):
        """Stage 3's ``functional_call`` name map and layer hook for one
        micro step: replicated leaves by name; top-level partitioned
        leaves gathered (on the graph of their shards) and passed by name;
        each layer's partitioned leaves left to the hook, which hands the
        layer loop a ``LayerLeaves`` handle."""
        stats, group = self.zero_gather_stats, self._dp_group
        names_map, top, layers = {}, [], {}
        for i, (name, (leaf, layer)) in enumerate(zip(self._names,
                                                      self._layout)):
            if not self._pshards[i].partitioned:
                names_map[name] = pc[name]
            elif layer is None:
                top.append(i)
            else:
                layers.setdefault(layer, []).append(i)
        if top:
            lg = stage3.LeafGroup([self._names[i] for i in top],
                                  [pc[self._names[i]] for i in top],
                                  [self._pshards[i] for i in top], group,
                                  stats, layer=False)
            names_map.update(zip(lg.names, stage3.gather_leaves(lg)))
        groups = {}
        for layer, idx in layers.items():
            short = [self._layout[i][0].split("/", 1)[1] for i in idx]
            groups[layer] = (short, [pc[self._names[i]] for i in idx],
                             [self._pshards[i] for i in idx])

        def hook(block, leaves):
            layer = self._layer_of[id(block)]
            if layer not in groups:
                return SimpleNamespace(**leaves)
            short, shards, pshards = groups[layer]
            lg = stage3.LeafGroup(short, shards, pshards, group, stats,
                                  layer=True)
            kept = {n: v for n, v in leaves.items() if n not in short}
            return stage3.LayerLeaves(kept, lg)

        return names_map, hook

    def _micro_loss(self, pc, mb, rng=None, train=True, pld_theta=None,
                    ltd_keep=None):
        """Loss of one micro batch on the compute-dtype copies ``pc``, with
        the step's key and modifiers (passed only when set, as the JAX
        engine passes them), drawing as this rank's rows of the global
        batch."""
        explicit = self._explicit and train
        with contextlib.nullcontext() if explicit else comm.full_precision():
            return self._micro_loss_in(pc, mb, rng, train, pld_theta,
                                       ltd_keep, explicit)

    def _micro_loss_in(self, pc, mb, rng, train, pld_theta, ltd_keep,
                       explicit):
        if explicit:
            # the JAX explicit exchange: the rank's own mean, its key folded
            # with its dp index, drawn from row 0 of its rows
            xfn = self._compressed_micro_grad(ltd_keep)
            rng = xfn.rng(rng)
        kwargs = {"rng": rng, "train": train}
        if pld_theta is not None:
            kwargs["pld_theta"] = pld_theta
        if ltd_keep is not None:
            kwargs["ltd_keep"] = ltd_keep
        self._row0 = 0 if explicit else self._dp_rank * _rows(mb)
        hook = None
        if explicit:
            pc, hook, state = xfn.inputs(pc)
            self._xstate = (xfn, state)
        elif self._stage >= 3:
            pc, hook = self._stage3_inputs(pc)
        self.module._zero_hook = hook
        try:
            with dropout.batch_rows(self._row0):
                out = torch.func.functional_call(
                    self._apply_call, {"model." + n: t for n, t in pc.items()},
                    (mb,), kwargs)
        finally:
            self.module._zero_hook = None
        loss = out[0] if isinstance(out, tuple) else out
        loss = loss.to(torch.float32)
        if explicit:
            return loss
        share = self._global_share(mb)
        return loss if share is None else loss * share

    def _global_share(self, mb):
        """Over several ranks, ``dp * n_r / n``: what turns this rank's
        mean loss into dp times its share of the global micro batch's mean
        (``n_r`` this rank's valid targets, ``n`` the ranks' sum), so that
        the gradients summed over the ranks and divided by dp are those of
        the JAX engine's global mean also when the ranks hold different
        counts of ``-100`` labels. None on one rank, or for a model whose
        loss is not a mean over targets."""
        if self._dp_world == 1:
            return None
        n_r = self.module.loss_count(mb)
        if n_r is None:
            return None
        n_r = n_r.to(torch.float32).reshape(1)
        n = n_r.clone()
        comm.all_reduce(n, axis_name=self._dp_group)
        return (self._dp_world * n_r.clamp_min(1) / n.clamp_min(1))[0]

    def _accumulate(self, scaled_loss, pc, dtype):
        """Gradients of ``scaled_loss`` (loss * scale) with respect to the
        compute-dtype copies ``pc``, added into the shared accumulation
        buffers (made in ``dtype`` by the first micro step); the loss too,
        detached."""
        if self._xstate is not None:
            # the explicit exchange: every gradient averaged over the ranks
            # now, in the compute dtype, and the loss with them
            xfn, state = self._xstate
            self._xstate = None
            with dropout.batch_rows(self._row0):
                grads, loss = xfn.backward(scaled_loss, state)
        else:
            params = list(pc.values())
            # a layer progressive layer drop skipped has zero gradients, as
            # under jax.grad; a recompute draws this micro batch's rows
            # again
            with dropout.batch_rows(self._row0), comm.full_precision():
                grads = torch.autograd.grad(scaled_loss, params,
                                            allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            if self._stage >= 2:
                with comm.full_precision():
                    grads = self._reduce_micro_grads(grads)
            loss = scaled_loss.detach()
        if self._grad_acc is None:
            self._grad_acc = [g.to(dtype) for g in grads]
            self._loss_acc = loss
        else:
            for acc, g in zip(self._grad_acc, grads):
                acc.add_(g)
            self._loss_acc = self._loss_acc + loss
        self._grad_acc_count += 1
        self.micro_steps += 1

    def _reduce_micro_grads(self, grads):
        """Stages 2-3: one micro step's gradients summed over the ranks
        into this rank's shards (under stage 3 the partitioned leaves'
        were reduce-scattered by the layers' backward already); replicated
        leaves all-reduced whole."""
        out = []
        for g, ps in zip(grads, self._pshards):
            if not ps.partitioned:
                comm.all_reduce(g, axis_name=self._dp_group)
            elif self._stage == 2:
                g = ps.reduce(g, self._dp_group)
            out.append(g)
        return out

    def _step_modifiers(self):
        """This step's forward modifiers: ``(pld_theta, ltd_keep)``, each
        None when its feature is off; theta in float32, as the JAX engine
        hands it to the model."""
        theta = keep = None
        if self.progressive_layer_drop is not None:
            theta = np.float32(self.progressive_layer_drop.update_state(
                self.global_steps))
        if self.random_ltd_scheduler is not None:
            keep = int(self.random_ltd_scheduler.get_current_seq(
                self.global_steps))
        self._last_modifiers = (theta, keep)
        return theta, keep

    def _owned_mask(self, ps):
        """``ps.tp.owned_mask()`` shaped to broadcast over this rank's part
        of the leaf (its dp part too, when that splits the same dim)."""
        mask = ps.tp.owned_mask().to(self.device, torch.float32)
        if ps.kind == "dim" and ps.dim == ps.tp.dim:
            n = mask.shape[0] // ps.world
            mask = mask[ps.rank * n:(ps.rank + 1) * n]
        return mask.reshape((-1,) + (1,) * (len(ps.shape) - 1 - ps.tp.dim))

    def _grad_norm(self, grads):
        """The global gradient norm in float32. Under stages 2-3 each rank
        holds shards: the leaves' squares are summed over the ranks, a
        replicated leaf's taken from rank 0 only."""
        sq = _leaf_squares(grads)
        for i, mask in self._tp_owned.items():
            if grads[i].numel():
                sq[i] = (grads[i].to(torch.float32).square() * mask).sum()
        if self._stage >= 2:
            sq = sq * self._norm_weights
            comm.all_reduce(sq, axis_name=self._dp_group)
        if self._tp.active:
            sq = sq * self._tp_norm_weights
            comm.all_reduce(sq, axis_name=self._tp.group)
        return sq.sum().sqrt()

    def _clip_grads(self, grads):
        clip = self._config.gradient_clipping
        norm = self._grad_norm(grads)
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
        # the explicit exchange averaged over the ranks already
        dp = 1 if self._explicit else self._dp_world
        torch._foreach_mul_(grads, 1.0 / (denom * self.scaler_state.scale *
                                          dp))
        grads, grad_norm = self._clip_grads(grads)
        finite = self._all_finite(grads) if cfg.fp16.enabled else True
        if finite:
            if self._stage == 1:
                grads = [ps.take(g) for g, ps in zip(grads, self._pshards)]
            _, self.opt_state = self.optimizer.update(
                grads, self.opt_state, self._masters, lr)
            if self._stage in (1, 2):
                self._refresh_params()
        self.scaler_state = update_loss_scale(
            self.scaler_state, finite, dynamic=self._dynamic_scale,
            scale_window=cfg.fp16.loss_scale_window,
            min_scale=cfg.fp16.min_loss_scale,
            max_hysteresis=cfg.fp16.hysteresis)
        return finite, grad_norm

    def _all_finite(self, grads) -> bool:
        """Whether every rank's gradients are finite (one decision for all
        ranks, so their loss scales and shards stay together)."""
        bad = (~grads_finite(grads)).to(torch.float32).reshape(1)
        comm.all_reduce(bad, op=comm.ReduceOp.MAX, axis_name=self._dp_group)
        if self._tp.active:
            comm.all_reduce(bad, op=comm.ReduceOp.MAX,
                            axis_name=self._tp.group)
        return not bool(bad.item())

    @torch.no_grad()
    def _refresh_params(self):
        """Stages 1-2: the updated master shards all-gathered into the
        model's whole parameters."""
        for p, m, ps in zip(self._params, self._masters, self._pshards):
            p.copy_(ps.gather(m, self._dp_group) if ps.partitioned else m)

    def _allreduce_grads(self):
        """Stages 0-1: the accumulated whole gradients summed over the
        ranks, at the step."""
        for g in self._grad_acc:
            comm.all_reduce(g, axis_name=self._dp_group)

    def train_batch(self, data_iter=None, batch=None):
        """One global step: the gas micro batches of ``batch`` (leaves
        ``[gas, micro, ...]``), or gas batches drawn from ``data_iter``,
        then the update. Returns the mean loss (a float32 tensor on the
        engine's device)."""
        if self.optimizer is None:
            raise ConfigError("train_batch needs an optimizer: add an "
                              "'optimizer' block to the config")
        if self._grad_acc is not None:
            raise RuntimeError("train_batch() while the user loop has "
                               "gradients accumulated: call step() first")
        if batch is None:
            batch = self._next_gas_batch(data_iter)
        batch = self._to_device_batch(self._local(batch, 1))
        leaves = [batch] if isinstance(batch, torch.Tensor) else \
            list(batch.values()) if isinstance(batch, dict) else list(batch)
        gas = leaves[0].shape[0]
        scale = self.scaler_state.scale
        rng = prng.fold_in_words(self._base_rng, self.global_steps)
        theta, keep = self._step_modifiers()
        pc = self._cast_params()
        # the accumulation dtype: f32 at gas 1 (no buffer round trip in the
        # JAX step), else gradient_accumulation_dtype
        dtype = torch.float32 if gas == 1 else self._grad_acc_dtype
        for i in range(gas):
            loss = self._micro_loss(pc, _micro(batch, i),
                                    prng.fold_in_words(rng, i), True, theta,
                                    keep)
            self._accumulate(loss * scale, pc, dtype)
        del pc, loss          # the compute-dtype copies: not held in the update
        return self._step()["loss"]

    # ------------------------------------------------------------------
    # DeepSpeed's user loop: forward / backward / step
    # ------------------------------------------------------------------
    def forward(self, batch, train=True):
        """The loss of one micro batch (float32, unscaled, on the autograd
        graph of this step's compute-dtype copies), keyed
        ``fold_in(base, micro_steps)``; ``train`` gates the step's
        modifiers, as in the JAX engine. Over several ranks it is this
        rank's share of the global mean times dp (``_global_share``): its
        mean over the ranks is the JAX engine's loss."""
        mb = self._to_device_batch(self._local(batch, 0))
        rng = prng.fold_in_words(self._base_rng, self.micro_steps)
        theta, keep = self._step_modifiers() if train else (None, None)
        pc = self._cast_params()
        loss = self._micro_loss(pc, mb, rng, True, theta, keep)
        self._pending = (pc, loss, self._row0)
        return loss

    __call__ = forward

    def backward(self, loss=None, allreduce_gradients=True):
        """Differentiate ``loss * scale`` (``forward``'s loss when None)
        into the accumulation buffers ``train_batch`` uses (float32, as the
        JAX engine's user loop accumulates)."""
        if self._pending is None:
            raise RuntimeError("backward() without forward()")
        pc, pending, self._row0 = self._pending
        loss = pending if loss is None else loss
        self._accumulate(loss * self.scaler_state.scale, pc, torch.float32)
        self._pending = None

    def is_gradient_accumulation_boundary(self):
        return self._grad_acc_count >= \
            self._config.gradient_accumulation_steps

    def step(self):
        """The update over the gradients accumulated since the last one
        (``denom`` = their count), as ``train_batch`` applies it."""
        if self.optimizer is None:
            raise ConfigError("step() needs an optimizer: add an "
                              "'optimizer' block to the config")
        if self._grad_acc is None:
            raise RuntimeError("step() without backward()")
        return self._step()

    @_exact
    def _step(self):
        """Unscale, clip and apply the accumulated gradients; clear the
        buffers; the step's bookkeeping. Returns the step's metrics (the
        mean loss among them)."""
        scale = self.scaler_state.scale
        count = self._grad_acc_count
        if self._stage <= 1 and not self._explicit:
            self._allreduce_grads()
        finite, grad_norm = self._apply_update(self._grad_acc, self.get_lr()[0],
                                               denom=float(count))
        # the global mean: the ranks' sums over the ranks (the explicit
        # exchange averaged each micro step's loss already)
        dp = 1
        if not self._explicit:
            comm.all_reduce(self._loss_acc, axis_name=self._dp_group)
            dp = self._dp_world
        metrics = {"loss": self._loss_acc / (count * scale * dp),
                   "grad_norm": grad_norm, "loss_scale": scale,
                   "overflow": not finite}
        self._grad_acc, self._loss_acc, self._grad_acc_count = None, None, 0
        self._last_grad_norm = grad_norm
        self._post_step(metrics)
        return metrics

    @_exact
    @torch.no_grad()
    def eval_batch(self, batch):
        """Loss of one ``[micro, ...]`` batch, no gradients; over several
        ranks the mean over the global micro batch, as in the JAX engine."""
        pc = {n: p.to(self._compute_dtype)
              for n, p in zip(self._names, self._compute_sources())}
        loss = self._micro_loss(pc, self._to_device_batch(
            self._local(batch, 0)), train=False)
        if self._dp_world > 1:
            comm.all_reduce(loss, axis_name=self._dp_group)
            loss = loss / self._dp_world
        return loss

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
    # checkpointing: runtime/checkpointing.py, bound here
    # ------------------------------------------------------------------
    @_exact
    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, exclude_frozen_parameters=False):
        from .checkpointing import save_checkpoint
        return save_checkpoint(self, save_dir, tag=tag,
                               client_state=client_state,
                               save_latest=save_latest)

    @_exact
    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False):
        """Restore a tag (either package's); returns ``(tag dir,
        client_state)``. The masters and moments are copied in place on
        the engine's device, so the optimizer's references stay valid."""
        from .checkpointing import load_checkpoint
        out = load_checkpoint(self, load_dir, tag=tag,
                              load_optimizer_states=load_optimizer_states,
                              load_lr_scheduler_states=load_lr_scheduler_states,
                              load_module_only=load_module_only)
        sampler = getattr(self.training_dataloader, "data_sampler", None) \
            if self.training_dataloader is not None else None
        if sampler is not None and hasattr(sampler, "set_step"):
            sampler.set_step(self.global_steps)
        return out

    @_exact
    def save_16bit_model(self, save_dir, save_filename="pytorch_model.msgpack"):
        from .checkpointing import save_16bit_model
        return save_16bit_model(self, save_dir, save_filename)

    @_exact
    def get_fp32_params(self):
        """The f32 masters as a JAX-layout tree (whole copies, on the
        engine's device, at any stage; every rank calls it): the
        zero_to_fp32 path as a live call."""
        return self.module.jax_tree([self.whole_master(i).detach().clone()
                                     for i in range(len(self._names))])

    # ------------------------------------------------------------------
    # whole tensors across the ranks (checkpoints, GatheredParameters,
    # tensor_fragment); collectives: every rank calls them in one order
    # ------------------------------------------------------------------
    @_exact
    def whole_master(self, i):
        """Parameter ``i``'s whole f32 master."""
        if self._stage < 3:
            return self.tp_whole(i, self._params[i])
        return self.whole(i, self._masters[i])

    @_exact
    def whole(self, i, part):
        """Parameter ``i``'s whole tensor from this rank's ``part`` of it
        (a master or moment shard; as it is for a replicated one)."""
        return self._pshards[i].gather_whole(part, self._dp_group,
                                             self._tp.group)

    @_exact
    def tp_whole(self, i, part):
        """Parameter ``i``'s whole tensor from this rank's tensor-parallel
        part of it (the model's tensor)."""
        ps = self._pshards[i]
        return part if ps.tp is None else ps.tp.gather(part, self._tp.group)

    @_exact
    @torch.no_grad()
    def set_whole_master(self, i, value):
        """Set parameter ``i``'s master from its whole value (a tensor on
        any device; every rank passes the same value): this rank's part of
        it is what is copied to the engine's device."""
        ps = self._pshards[i]
        if self._stage < 3:
            self._params[i].copy_(ps.take_tp(value))
        if self._stage >= 1:
            self._masters[i].copy_(ps.take_whole(value))

    @_exact
    @torch.no_grad()
    def set_master_parts(self, parts):
        """Set every master from this rank's part of it (a list aligned
        with the parameters, as ``ParamShard.take`` cuts them; tensors on
        any device); under stages 1-2 the model's whole parameters are
        then all-gathered from the masters."""
        for master, part in zip(self._masters, parts):
            master.copy_(part)
        if self._stage in (1, 2):
            self._refresh_params()

    @property
    def param_shapes(self):
        """The masters' JAX tree of ``ShapeDtype`` (shape, dtype)."""
        from .checkpointing import param_shapes
        return param_shapes(self)

    @property
    def opt_state_shapes(self):
        """The optimizer state's JAX tree of ``ShapeDtype`` (``count``,
        ``mu``, ``nu``), or None without an optimizer."""
        from .checkpointing import opt_state_shapes
        return opt_state_shapes(self)

    def _drop_step_state(self):
        """Forget gradients accumulated and a pending micro step (stale
        once the masters are replaced)."""
        self._grad_acc = self._loss_acc = self._pending = None
        self._xstate = None
        self._grad_acc_count = 0

    def summary(self) -> dict:
        """The engine's state at a glance (the JAX engine's status
        section): steps, samples, lr, ZeRO stage, mesh and, when on, the
        overlap schedule's plan."""
        mm = self.mesh_manager
        out = {"global_steps": self.global_steps,
               "skipped_steps": self.skipped_steps,
               "global_samples": self.global_samples,
               "lr": self.get_lr()[0], "zero_stage": self.zero_stage,
               "mesh": f"pp{mm.pp}/dp{mm.dp}/ep{mm.ep}/sp{mm.sp}/tp{mm.tp}"}
        if self._sched_info is not None:
            out["overlap_schedule"] = self._sched_info
        return out

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
        return self._dp_world

    @property
    def dp_rank(self):
        return self._dp_rank

    @property
    def mp_world_size(self):
        return self.mesh_manager.tp

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
