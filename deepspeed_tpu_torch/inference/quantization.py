"""Int8 weight-only serving: the JAX package's ``inference/quantization.py``.

A quantized weight is an int8 payload + one f32 scale per group of
``group_size`` values along the LAST axis (per-row groups; a last axis the
group size does not divide is one group). Here it is a ``QuantizedWeight``:
an int8 ``Parameter`` of the weight's shape (the module keeps its parameter
table, so the weight layout, shapes and tp splits stay as they were) whose
``to(float dtype)`` IS the dequantize, ``q * scale`` in f32 then cast. The
models touch every matmul weight through ``w.to(compute dtype)`` (where the
JAX models call ``.astype``), so the dequantize happens at each use and no
bf16 copy is kept between calls; the weights stay resident at about half
their bf16 bytes.

``quantize_leaf`` is the JAX package's rule: ``max(absmax, 1e-8) / 127``
(compiled, as the JAX engine runs it: a multiply by the f32 reciprocal of
127) and round half to even (not ``symmetric_scale``). ``_default_predicate``
runs on the JAX path and the stacked ``[L, ...]`` shape: matmul-shaped
floating block weights, no norms, biases or embeddings.

At tp > 1 the weight is quantized whole (the JAX leaf) and each rank keeps
its part of ``q`` and the scales the JAX spec gives it
(``quantized_shardings``: the scales keep the weight's sharding on the
leading axes and are replicated on the group axis). A weight split on its
last axis therefore holds every group's scale and, per local column, the
index of its group (``cols``).
"""

import torch

from ..ops.quant_core import _per


class QuantizedWeight(torch.nn.Parameter):
    """int8 weight + per-group f32 scales; ``to(float dtype)``
    dequantizes.

    The tensor itself is ``q`` (int8, the weight's shape); ``scale`` is f32
    ``q.shape[:-1] + (groups,)``; ``cols`` (None for the standard
    contiguous groups) maps each of the last axis's columns to its group.
    """

    def __new__(cls, q, scale, cols=None):
        self = torch.Tensor._make_subclass(cls, q, False)
        self.scale = scale
        self.cols = cols
        return self

    def __init__(self, q, scale, cols=None):
        pass

    @property
    def q(self):
        return torch.Tensor.as_subclass(self, torch.Tensor)

    @property
    def nbytes(self):
        q = self.q
        return q.numel() * q.element_size() + \
            self.scale.numel() * self.scale.element_size()

    def dequantize(self, dtype=torch.float32):
        """``q * scale`` in f32, cast to ``dtype`` (the JAX ``astype``)."""
        q = self.q
        if self.cols is None:
            groups = self.scale.shape[-1]
            w = q.reshape(q.shape[:-1] + (groups, -1)).to(torch.float32) \
                * self.scale[..., None]
            w = w.reshape(q.shape)
        else:
            w = q.to(torch.float32) * self.scale.index_select(-1, self.cols)
        return w.to(dtype)

    def to(self, *args, **kwargs):
        device, dtype, non_blocking, _ = torch._C._nn._parse_to(*args,
                                                                **kwargs)
        if dtype is not None and dtype.is_floating_point:
            w = self.dequantize(dtype)
            return w if device is None else w.to(device)
        if device is not None:       # a move: the payload and its scales
            self.scale = self.scale.to(device, non_blocking=non_blocking)
            if self.cols is not None:
                self.cols = self.cols.to(device)
        return self.q.to(*args, **kwargs)

    def __reduce_ex__(self, proto):
        return (QuantizedWeight, (self.q.clone(), self.scale, self.cols))

    def __repr__(self):
        return (f"QuantizedWeight(shape={tuple(self.shape)}, "
                f"groups={self.scale.shape[-1]})")


def is_quantized(x) -> bool:
    return isinstance(x, QuantizedWeight)


def quantize_leaf(w, group_size: int = 64, bits: int = 8):
    """``(q int8, scale f32)`` of ``w``: symmetric per-group quantization
    along the last axis."""
    assert bits == 8, "weight-only serving supports 8-bit payloads"
    last = w.shape[-1]
    gs = group_size if last % group_size == 0 else last
    groups = last // gs
    wg = w.to(torch.float32).reshape(tuple(w.shape[:-1]) + (groups, gs))
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp_min(wg.abs().amax(dim=-1), 1e-8) * _per(qmax)
    q = torch.clamp(torch.round(wg / scale[..., None]), -qmax, qmax)
    return q.reshape(w.shape).to(torch.int8), scale


def _default_predicate(path, shape, dtype) -> bool:
    """Matmul-shaped floating weights of the transformer blocks (the
    reference GroupQuantizer scope): on the JAX ``path`` (a sequence of
    keys) and the stacked shape, a real matrix (both trailing dims at
    least 16) not named as a norm or bias, outside the embeddings and the
    LM head."""
    if len(shape) < 2:
        return False
    if not dtype.is_floating_point:
        return False
    if min(shape[-1], shape[-2]) < 16:
        return False
    names = [str(k) for k in path]
    last = names[-1] if names else ""
    if last.endswith(("_b", "bias", "scale", "norm", "gamma", "beta")):
        return False
    skip = ("wpe", "wte", "embed", "position", "lm_head")
    return not any(s in n for n in names for s in skip)


def _selected(module, predicate):
    """``[(parameter index, JAX leaf name)]`` of the leaves ``predicate``
    selects, on their JAX path and stacked shape."""
    from ..runtime.zero.partition import leaf_shapes
    shapes = leaf_shapes(module)
    out = []
    for i, ((leaf, _), p) in enumerate(zip(module.jax_layout(),
                                           module.parameters())):
        if is_quantized(p):
            continue
        if predicate(leaf.split("/"), shapes[leaf], p.dtype):
            out.append((i, leaf))
    return out


@torch.no_grad()
def quantize_tree(module, group_size: int = 64, bits: int = 8,
                  predicate=_default_predicate, tp=None):
    """Quantize the selected weights of ``module`` in place: each becomes a
    ``QuantizedWeight`` of its rank's part. At tp > 1 (``tp`` active) each
    weight is gathered whole over the ``model`` axis (a collective, in one
    order on every rank) and quantized whole, as the JAX package
    quantizes the whole leaf. Idempotent: quantized weights are left as
    they are. Returns the module."""
    names = [n for n, _ in module.named_parameters()]
    splits = module.tp_splits()
    for i, _ in _selected(module, predicate):
        name = names[i]
        owner, _, attr = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        p = getattr(mod, attr)
        split = splits[i]
        sharded = split is not None and tp is not None and tp.active
        whole = split.gather(p.detach(), tp.group) if sharded \
            else p.detach()
        q, scale = quantize_leaf(whole, group_size, bits)
        cols = None
        if sharded:
            last = q.dim() - 1
            if split.dim == last:
                gs = q.shape[-1] // scale.shape[-1]
                idx = torch.arange(q.shape[-1], device=q.device)
                cols = split.take(idx.reshape((1,) * last + (-1,))) \
                    .reshape(-1) // gs
            else:
                scale = split.take(scale)
            q = split.take(q)
        # in place in the table: the parameter order stays the layout's
        mod._parameters[attr] = QuantizedWeight(q.contiguous(),
                                                scale.contiguous(), cols)
    return module


def tree_nbytes(module) -> int:
    """Resident bytes of the module's weights (a quantized weight's
    payload and scales)."""
    return sum(p.nbytes if is_quantized(p) else p.numel() * p.element_size()
               for p in module.parameters())


def describe(module) -> str:
    n_q = len({leaf for (leaf, _), p in zip(module.jax_layout(),
                                            module.parameters())
               if is_quantized(p)})
    return (f"int8 weight-only serving: {n_q} quantized weights, "
            f"{tree_nbytes(module) / 2**20:.1f} MiB resident")
