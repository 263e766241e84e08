"""InferenceEngine: scoring (``engine(input_ids)``), KV-cache generation,
beam search and the slot-serving protocol.

The JAX package's engine compiles a prefill + ``lax.scan`` decode program
per shape bucket; this one runs the same steps eagerly: prefill through
``apply_with_cache``, then one ``apply_with_cache`` call per new token, with
the same sampling (greedy, or temperature then top-k then top-p in HF's
order), the same keys (``PRNGKey(seed)`` for the first sampled token, then
one ``split`` a step, threefry2x32 as in ``jax.random``: ``prng.py``), the
same EOS freezing and the same left-padding rules. ``num_beams > 1`` runs the
JAX package's beam search. CUDA graphs, the counterpart of the compiled
program, come in a later PR.

The slot protocol serves ``deepspeed_tpu_torch/serving/``: a pool of decode
slots, the rows of one KV cache ``[L, num_slots, H_kv, max_len, hd]``
allocated once (``init_slot_pool``), prompts prefilled into a slot's lane
(``slot_prefill``, ``slot_suffix_prefill``, ``slot_chunk_prefill``), lanes
copied, extracted and inserted, and one fused decode step over all slots
(``slot_decode_step``). The methods update the pool in place (the JAX
package donates it) and return it, so callers rebind it as they do there.
Every sampled token's key derives only from ``(request seed, cache
column)`` (``speculative.row_keys``), so a replayed request regenerates its
stream bit for bit.

Tensor parallelism (``tensor_parallel.tp_size``, or its alias
``mp_size``): the engine runs on the rank mesh's ``model`` axis (the
global mesh when it has that tp, else a new one over the process group,
as the JAX package's engine builds its mesh), the model holds its rank's
part of each sharded leaf (a whole model is sharded in place; a tag or a
JAX tree loads whole and each rank keeps its part), the slot pool holds
the rank's kv heads, and the logits every call returns are gathered whole
over the vocab. Every tp rank samples the same token from the same keys,
so the ranks never disagree; every rank makes every call, in one order.
BERT (dense or after the sparse surgery) scores at any tp; a lane is
extracted whole (the ranks' kv heads gathered: the ``KVHandoff`` frame is
the one tp 1 writes) and inserted whole, each rank keeping its heads, so
engines at different tp hand lanes to each other; ``mode: "model"`` drafts
are built at the target's tp.

Int8 serving (``quant`` or ``dtype: int8``): the block weights become
``QuantizedWeight``s (``inference/quantization.py``) at init, after a
checkpoint load (loaded in the serving dtype, then quantized) and in a
``with_params`` view. ``init_slot_pool(quantize=True)`` makes an int8
pool (``inference/kv_quant.py``) that every slot entry point takes: the
cache loops dequantize a layer's K/V, write the step's columns and
quantize the layer again, as the JAX package's slot programs do; a
verify keeps the old bytes of every column it does not keep; lanes copy,
extract and insert their payload and scales (a float lane is quantized
into an int8 pool, an int8 lane dequantized into a float one).
"""

from typing import Optional

import numpy as np
import torch

from ..models.api import ModelSpec
from ..parallel import tensor_parallel
from ..utils.logging import log_dist, logger
from . import prng
from .config import DeepSpeedInferenceConfig
from .kv_quant import QuantizedSlotPool, dequantize_pool, quantize_pool
from .speculative import _softmax, row_keys, sample_rows


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _sample(logits, temperature, top_k, top_p, vocab, key):
    """One token per row from ``logits [B, V_padded]``, over the real vocab
    only, with one key for the whole batch (``generate``'s schedule)."""
    logits = logits[:, :vocab].to(torch.float32)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k or top_p < 1.0:       # one descending sort serves both
        desc = torch.sort(logits, dim=-1, descending=True).values
    if top_k:
        k = min(top_k, vocab)
        logits = torch.where(logits < desc[:, k - 1:k], -torch.inf, logits)
        # the top-k survivors are exactly the first k sorted entries
        col = torch.arange(desc.shape[-1], device=desc.device)
        desc = torch.where(col[None] < k, desc, -torch.inf)
    if top_p < 1.0:
        # nucleus on the top-k-renormalised distribution: the smallest
        # prefix of descending-probability tokens whose mass reaches top_p
        probs = _softmax(desc)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        thresh = torch.where(keep, desc, torch.inf).amin(-1, keepdim=True)
        logits = torch.where(logits >= thresh, logits, -torch.inf)
    return prng.categorical(key, logits)


def _sample_one(logits_row, temp, top_k, top_p, seed, col, vocab):
    """One row's token, keyed at cache column ``col`` (the column the
    sampled token will be fed at): the key derives only from ``(seed,
    col)``, so a replay regenerates the same token."""
    keys = row_keys(torch.tensor([seed]), torch.tensor([col]))   # host
    return int(sample_rows(logits_row[None], [temp], [top_k], [top_p], keys,
                           vocab)[0])


def _clone_structure(module):
    """A copy of ``module`` and its submodules that shares their tensors
    but owns its parameter and module tables, so setting a parameter on
    the copy leaves the original as it was."""
    import copy
    clone = copy.copy(module)
    clone._parameters = dict(module._parameters)
    clone._buffers = dict(module._buffers)
    clone._modules = {k: _clone_structure(v) if v is not None else None
                      for k, v in module._modules.items()}
    return clone


def _log_softmax(x):
    """``jax.nn.log_softmax`` over the last axis."""
    shifted = x - x.amax(-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(-1, keepdim=True))


class InferenceEngine:
    """Callable engine: ``engine(input_ids)`` -> logits;
    ``engine.generate(...)`` -> token ids.

    ``model`` is cast in place to the config dtype (floating parameters
    only) and moved to ``device`` (default ``cuda``). ``params``, a JAX
    parameter tree of the model's family (numpy arrays), replaces the
    module's weights through the model's own ``load_jax_params``. A
    ``model`` that is not a port model (an HF module) is injected
    (``module_inject``): the port's model of its policy, built on
    ``device``, serves the module's weights."""

    def __init__(self, model, config: DeepSpeedInferenceConfig = None,
                 params=None, device=None):
        if config is None:
            config = DeepSpeedInferenceConfig()
        self._config = config
        self.dtype = config.dtype
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceEngine: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        if not isinstance(model, ModelSpec):
            # an HF module (the reference's input): its policy reads the
            # architecture and weights once; the port's model is built on
            # the engine's device, the HF module stays where it is
            from ..module_inject import replace_transformer_layer
            model, params = replace_transformer_layer(model, config,
                                                      device=self.device)
        self.tp = self._tensor_parallel(model, config.tensor_parallel.tp_size)
        if params is not None:
            model.load_jax_params(params)
        self.module = model.to(device=self.device, dtype=self.dtype).eval()
        # int8 weight-only serving (inference/quantization.py): the block
        # weights become QuantizedWeights, after every load (fp first)
        self._quant = config.quant if config.quant is not None and \
            config.quant.enabled else None
        log_dist(f"InferenceEngine initialized: "
                 f"params={model.num_params() / 1e6:.1f}M "
                 f"dtype={str(self.dtype).replace('torch.', '')} "
                 f"max_tokens={config.max_tokens} tp={self.tp.size} "
                 f"device={self.device}", ranks=[0])
        # the decode, chunk-prefill, draft and verify shapes that ran: the
        # counterpart of the JAX package's compiled slot programs, whose
        # counts its serving tests read
        self._slot_shapes = set()
        #: the checkpoint weights_version these weights came from (0 =
        #: unversioned: the module's own weights); a decode-role serving
        #: engine refuses a KV handoff produced under another version
        self.weights_version = 0
        self._drafts = {}
        if config.checkpoint:
            self.load_checkpoint(config.checkpoint)
        else:
            self._finalize(self.module)

    def _finalize(self, module):
        """Quantize ``module``'s block weights when int8 serving is on (at
        tp > 1 each from its whole leaf: a collective)."""
        if self._quant is None:
            return module
        from .quantization import describe, quantize_tree
        quantize_tree(module, self._quant.group_size, self._quant.bits,
                      tp=self.tp)
        log_dist(describe(module), ranks=[0])
        return module

    def _unquantize(self, module):
        """Float parameters (of the serving dtype) in place of the
        quantized ones, for a load to copy into."""
        from .quantization import is_quantized
        for name, p in list(module.named_parameters()):
            if is_quantized(p):
                owner, _, attr = name.rpartition(".")
                mod = module.get_submodule(owner) if owner else module
                mod._parameters[attr] = torch.nn.Parameter(
                    torch.empty(p.shape, dtype=self.dtype,
                                device=self.device), requires_grad=False)

    @staticmethod
    def _tensor_parallel(model, tp_size):
        """The engine's ``TPInfo``: the model's own when it was built at
        tp > 1 (on the mesh it was built under) and the config asks for
        no tp; else the mesh's ``model`` axis at ``tp_size``, the model
        sharded in place onto it."""
        from ..comm import comm
        from ..parallel.topology import mesh_for_tp
        if tp_size == 1:
            return model.tp
        if not model.tensor_parallel:
            raise ValueError(f"{type(model).__name__} has no tensor-parallel "
                             f"layers: it serves at tp 1 only")
        world = comm.get_world_size()
        if world % tp_size:
            raise ValueError(
                f"tp_size={tp_size} needs a process group whose size "
                f"divides by it (the world is {world} rank(s)); call "
                f"deepspeed_tpu_torch.init_distributed first")
        tp = tensor_parallel.from_mesh(mesh_for_tp(tp_size))
        model.shard_tp(tp)
        return tp

    # ------------------------------------------------------------ checkpoints
    def load_checkpoint(self, load_dir, tag=None):
        """Load a training checkpoint tag of either package (``latest``
        unless ``tag``) into this engine's weights, cast to the serving
        dtype; ``weights_version`` becomes the tag's."""
        from ..runtime.checkpointing import read_weights_version
        params = self._load_params(load_dir, tag)
        self._unquantize(self.module)
        self.module.load_jax_params(params)
        del params
        self._finalize(self.module)
        self.weights_version = read_weights_version(load_dir, tag=tag)
        return load_dir

    def _load_params(self, load_dir, tag=None):
        """A tag's params as a JAX tree on this engine's device in the
        serving dtype, each leaf moved and cast as it is read; structure
        gated: a drifted leaf set raises with the per-leaf diff before
        anything is copied."""
        from ..runtime.checkpointing import (ShapeDtype,
                                             load_params_for_inference,
                                             shapes_tree)
        like = shapes_tree(self.module, [
            ShapeDtype(s, self.dtype if not p.is_floating_point() and
                       self._quant is not None else p.dtype)
            for s, p in zip(self.module.whole_shapes(),
                            self.module.parameters())])

        def cast(t):
            return t.to(self.dtype) if t.is_floating_point() else t
        # at tp > 1 the whole leaves stay on the host, each rank keeping
        # its part: no rank holds the whole model on the card
        return load_params_for_inference(
            load_dir, tag=tag, like=like,
            device=None if self.tp.active else self.device, cast=cast)

    def with_params(self, params, weights_version=None):
        """A shallow engine view serving ``params`` (a JAX tree of tensors
        in the serving dtype, on this engine's device) beside this one: its
        module shares this module's structure and config but holds its own
        Parameters (views of ``params``' leaves, no copy); this engine is
        unchanged. Drafts are rebuilt for the view."""
        import copy
        view = copy.copy(self)
        view.module = _clone_structure(self.module)
        with torch.no_grad():
            for (name, _), value, split in zip(
                    self.module.named_parameters(),
                    self.module.from_jax_tree(params),
                    self.module.tp_splits()):
                if split is not None:
                    value = split.take(value)
                owner, _, leaf = name.rpartition(".")
                mod = view.module.get_submodule(owner) if owner else \
                    view.module
                setattr(mod, leaf, torch.nn.Parameter(
                    value.to(self.device, self.dtype), requires_grad=False))
        view._drafts = {}
        view._slot_shapes = set()
        self._finalize(view.module)
        if weights_version is not None:
            view.weights_version = int(weights_version)
        return view

    def load_version(self, load_dir, tag=None):
        """Load a checkpoint WITHOUT changing this engine: a view
        (``with_params``) serving the tag's weights at its
        ``weights_version``. The manifest and the structure gate run
        before the view exists, so a bad tag aborts here."""
        from ..runtime.checkpointing import read_weights_version
        return self.with_params(self._load_params(load_dir, tag),
                                read_weights_version(load_dir, tag=tag))

    def _ids(self, input_ids):
        if not isinstance(input_ids, torch.Tensor):
            input_ids = torch.as_tensor(np.asarray(input_ids))
        return input_ids.to(device=self.device, dtype=torch.long)

    # ---------------------------------------------------------------- forward
    @torch.inference_mode()
    def forward(self, input_ids, **kwargs):
        """Full-sequence logits over the padded vocab (scoring path, no
        cache)."""
        return self.module.logits(self._ids(input_ids))

    __call__ = forward

    # --------------------------------------------------------------- generate
    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 64,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 max_length: Optional[int] = None, top_p: float = 1.0,
                 num_beams: int = 1, attention_mask=None,
                 length_penalty: float = 1.0):
        """Autoregressive generation. Returns ``[B, T + max_new_tokens]``
        (prompt + generated; positions after EOS hold ``eos_token_id``).
        ``num_beams > 1`` runs deterministic beam search (temperature,
        top-k and top-p must be off). ``attention_mask`` [B, T] (1 = real
        token) serves LEFT-padded batches: pad columns never act as keys
        and logical positions shift per row. Sampled draws are keyed as the
        JAX package keys them: ``PRNGKey(seed)`` for the first token, then
        the second half of a ``split`` of the running key for each next."""
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if temperature <= 0.0 and (top_k or top_p < 1.0):
            raise ValueError(
                "top_k/top_p require temperature > 0 (temperature<=0 means "
                "greedy decoding, which would silently ignore them); pass "
                "temperature=1.0 for plain top-k/top-p sampling")
        if num_beams < 1:
            raise ValueError(f"num_beams must be >= 1, got {num_beams}")
        if num_beams == 1 and length_penalty != 1.0:
            raise ValueError(
                "length_penalty only applies to beam search "
                f"(got length_penalty={length_penalty} with num_beams=1)")
        if num_beams > 1 and (temperature > 0 or top_k or top_p < 1.0):
            raise ValueError(
                "beam search is deterministic: temperature/top_k/top_p "
                "cannot be combined with num_beams > 1")
        if not hasattr(self.module, "apply_with_cache"):
            raise TypeError(
                f"generate needs a decoder with a KV-cache path; "
                f"{type(self.module).__name__} has none (score it with "
                f"engine(input_ids))")
        ids = self._ids(input_ids)
        if ids.dim() == 1:
            ids = ids[None]
        b, t = ids.shape
        pad_counts = None
        if attention_mask is not None:
            mask = self._ids(attention_mask)
            if tuple(mask.shape) != (b, t):
                raise ValueError(f"attention_mask shape {tuple(mask.shape)} "
                                 f"!= input_ids shape {(b, t)}")
            if num_beams > 1:
                raise NotImplementedError(
                    "attention_mask (padded prompts) + beam search is not "
                    "supported yet")
            # HF left padding: each row must read 0..0 1..1
            pad_counts = t - mask.sum(-1)
            expect = torch.arange(t, device=self.device)[None, :] >= \
                pad_counts[:, None]
            if not torch.equal(mask.bool(), expect):
                raise ValueError(
                    "attention_mask must be contiguous LEFT padding "
                    "(rows of 0..0 1..1); right-padded or interior-zero "
                    "masks are not supported")
        if max_length is not None:
            max_new_tokens = max(0, max_length - t)
        if max_new_tokens <= 0:
            return ids
        model = self.module
        n_pos = model.config.n_positions
        if t + max_new_tokens > n_pos:
            raise ValueError(
                f"generate: prompt {t} + max_new_tokens {max_new_tokens} "
                f"exceeds the model's context length n_positions={n_pos}")
        cache_len = min(_next_pow2(t + max_new_tokens),
                        max(self._config.max_tokens, t + max_new_tokens))
        if t + max_new_tokens > self._config.max_tokens:
            logger.warning(
                f"generate: {t}+{max_new_tokens} tokens exceeds config "
                f"max_tokens={self._config.max_tokens}; growing cache")
        if num_beams > 1:
            return self._beam_generate(ids, cache_len, max_new_tokens,
                                       num_beams, eos_token_id,
                                       length_penalty)

        vocab = model.config.vocab_size
        key = prng.prng_key(seed, device=self.device)

        def sample(logits, key):
            return _sample(logits[:, -1], temperature, top_k, top_p, vocab,
                           key)

        cache = model.init_kv_cache(b, cache_len, dtype=self.dtype,
                                    device=self.device)
        logits, cache = model.apply_with_cache(ids, cache, 0, pad_counts)
        tok = sample(logits, key)
        finished = (torch.zeros(b, dtype=torch.bool, device=self.device)
                    if eos_token_id is None else tok == eos_token_id)
        toks = [tok]
        for i in range(1, max_new_tokens):
            if temperature > 0.0:
                key, sub = prng.split(key)
            else:
                sub = None           # greedy: the key is never read
            # tok was sampled for position t+i-1; its K/V go there
            logits, cache = model.apply_with_cache(tok[:, None], cache,
                                                   t + i - 1, pad_counts)
            tok = sample(logits, sub)
            if eos_token_id is not None:
                tok = torch.where(finished, eos_token_id, tok)
                finished = finished | (tok == eos_token_id)
            toks.append(tok)
        return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)

    def _beam_generate(self, ids, cache_len, max_new_tokens, k,
                       eos_token_id, length_penalty):
        """Deterministic beam search, step for step the JAX package's
        ``_build_beam_generate``: prefill once at batch B and repeat the
        cache to B*K beams; only beam 0 proposes the first tokens; each
        step takes the top K of ``score + log_softmax`` over K*V
        candidates, reorders the beams' caches by parent, and freezes
        finished beams (score kept, only EOS may follow); the answer is
        the beam with the best ``score / length**length_penalty``."""
        model = self.module
        vocab = model.config.vocab_size
        dev = self.device
        b, t = ids.shape
        neg = -1e30
        small = model.init_kv_cache(b, cache_len, dtype=self.dtype,
                                    device=dev)
        logits, small = model.apply_with_cache(ids, small, 0)
        cache = {n: torch.repeat_interleave(c, k, dim=1)
                 for n, c in small.items()}
        del small
        logp = _log_softmax(logits[:, -1, :vocab].to(torch.float32))
        logp = torch.repeat_interleave(logp, k, dim=0).reshape(b, k, vocab)
        beam = torch.arange(k, device=dev)[None, :, None]
        first = torch.where(beam == 0, logp[:, :1], neg)
        scores, flat = torch.topk(first.reshape(b, k * vocab), k)
        tok = flat % vocab                                   # [B, K]
        finished = (tok == eos_token_id) if eos_token_id is not None \
            else torch.zeros((b, k), dtype=torch.bool, device=dev)
        lengths = torch.ones((b, k), dtype=torch.float32, device=dev)
        seqs = torch.zeros((b, k, max_new_tokens), dtype=torch.long,
                           device=dev)
        seqs[:, :, 0] = tok
        if eos_token_id is not None:
            only_eos = torch.where(
                torch.arange(vocab, device=dev)[None, None] == eos_token_id,
                0.0, neg)
        rows = torch.arange(b, device=dev)[:, None] * k
        for i in range(1, max_new_tokens):
            logits, cache = model.apply_with_cache(tok.reshape(b * k, 1),
                                                   cache, t + i - 1)
            logp = _log_softmax(logits[:, -1, :vocab].to(torch.float32))
            logp = logp.reshape(b, k, vocab)
            if eos_token_id is not None:
                # finished beams: frozen score, only-EOS continuation
                logp = torch.where(finished[..., None], only_eos, logp)
            total = scores[..., None] + logp                 # [B, K, V]
            scores, flat = torch.topk(total.reshape(b, k * vocab), k)
            parent = flat // vocab                           # [B, K]
            tok = flat % vocab
            seqs = torch.gather(seqs, 1, parent[..., None].expand_as(seqs))
            seqs[:, :, i] = tok
            finished = torch.gather(finished, 1, parent)
            lengths = torch.gather(lengths, 1, parent)
            # unfinished beams grew by one token (a fresh EOS included);
            # an already-finished beam's appended EOS is padding
            lengths = lengths + (~finished).to(torch.float32)
            if eos_token_id is not None:
                finished = finished | (tok == eos_token_id)
            flat_parent = (rows + parent).reshape(b * k)
            cache = {n: c.index_select(1, flat_parent)
                     for n, c in cache.items()}
        norm = scores / torch.pow(torch.clamp_min(lengths, 1.0),
                                  torch.tensor(length_penalty,
                                               dtype=torch.float32))
        best = torch.argmax(norm, dim=-1)                    # [B]
        out = seqs[torch.arange(b, device=dev), best]        # [B, max_new]
        if eos_token_id is not None:
            # positions after EOS hold eos_token_id (the sampled path's rule)
            hit = torch.cumsum((out == eos_token_id).to(torch.int64), dim=-1)
            out = torch.where(hit > 1, eos_token_id, out)
        return torch.cat([ids, out], dim=1)

    # ------------------------------------------------- slot-serving protocol
    def _slot_model(self, what):
        if not hasattr(self.module, "decode_with_slots"):
            raise TypeError(
                f"{what} needs a decoder with a KV-cache path; "
                f"{type(self.module).__name__} has none")
        return self.module

    @staticmethod
    def _pool_dims(pool):
        """``(num_slots, max_len)`` of a pool ``{"k", "v": [L, S, H_kv,
        max_len, hd]}``."""
        leaf = pool["k"]
        return int(leaf.shape[1]), int(leaf.shape[-2])

    def _bucket_ids(self, tokens, bucket):
        """``[1, bucket]`` ids on the engine's device: ``tokens`` right-padded
        with 0."""
        tokens = np.asarray(tokens, dtype=np.int64).reshape(-1)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :tokens.shape[0]] = tokens
        return torch.from_numpy(ids).to(self.device)

    @staticmethod
    def _lane(pool, slot):
        """Slot ``slot``'s lane as a one-row cache: views of the pool."""
        if isinstance(pool, QuantizedSlotPool):
            return pool.lane(slot)
        return {n: c[:, slot:slot + 1] for n, c in pool.items()}

    @staticmethod
    def _quantized(pool) -> bool:
        return isinstance(pool, QuantizedSlotPool)

    @staticmethod
    def _tensors(pool):
        """``{name: tensor}`` of every tensor a pool holds (an int8 pool's
        payloads and scales)."""
        if isinstance(pool, QuantizedSlotPool):
            return {**{f"q/{n}": c for n, c in pool.q.items()},
                    **{f"scales/{n}": c for n, c in pool.scales.items()}}
        return dict(pool)

    @staticmethod
    def _sample_args(n, top_ks, top_ps, seeds):
        """The per-slot sampling registers, neutral where not given."""
        return (np.zeros((n,), np.int32) if top_ks is None else top_ks,
                np.ones((n,), np.float32) if top_ps is None else top_ps,
                np.zeros((n,), np.int32) if seeds is None else seeds)

    @torch.inference_mode()
    def init_slot_pool(self, num_slots: int, max_len: int,
                       quantize: bool = False):
        """Allocate the slot-pool KV cache ``[L, num_slots, H_kv, max_len,
        hd]`` in the serving dtype on the engine's device, once; with
        ``quantize`` an int8 pool with per-column f32 scales
        (``inference/kv_quant.py``), made as the JAX package's
        ``quantize_pool`` of a zero pool leaves it (q 0, scales 1)."""
        model = self._slot_model("init_slot_pool")
        if not quantize:
            return model.init_kv_cache(num_slots, max_len, dtype=self.dtype,
                                       device=self.device)
        shape = model.init_kv_cache(1, 1, dtype=self.dtype,
                                    device="meta")["k"].shape
        shape = (shape[0], num_slots, shape[2], max_len, shape[4])
        return QuantizedSlotPool(
            {n: torch.zeros(shape, dtype=torch.int8, device=self.device)
             for n in ("k", "v")},
            {n: torch.ones(shape[:-1], dtype=torch.float32,
                           device=self.device) for n in ("k", "v")},
            self.dtype)

    @torch.inference_mode()
    def slot_prefill(self, pool, slot: int, prompt, temperature: float = 0.0,
                     top_k: int = 0, top_p: float = 1.0, seed: int = 0):
        """Prefill ``prompt`` (1-D ints) into slot ``slot`` and sample the
        first generated token. The prompt is right-padded to a pow2 bucket;
        the lane's columns past the bucket are zeroed, as the JAX package's
        fresh lane is (the pad columns inside the bucket are masked until
        decode overwrites them). The first token is keyed at column ``t``,
        where it will be fed. Returns ``(pool, first_token: int)``."""
        model = self._slot_model("slot_prefill")
        ids, lane, t = self._fresh_lane(pool, slot, prompt)
        logits, _ = model.apply_with_cache(ids, lane, 0)
        tok = _sample_one(logits[0, t - 1], temperature, top_k, top_p, seed,
                          t, model.config.vocab_size)
        return pool, tok

    def _fresh_lane(self, pool, slot, prompt):
        """``(ids, lane, t)`` for a prefill of ``prompt`` into ``slot``: the
        prompt right-padded to its pow2 bucket, the slot's lane with its
        columns past the bucket zeroed (a fresh JAX lane), the length."""
        prompt = np.asarray(prompt).reshape(-1)
        t = prompt.shape[0]
        num_slots, max_len = self._pool_dims(pool)
        if not 0 < t <= max_len:
            raise ValueError(f"prompt length {t} not in [1, {max_len}]")
        bucket = min(_next_pow2(t), max_len)
        lane = self._lane(pool, slot)
        if isinstance(lane, QuantizedSlotPool):
            lane.fill((slice(None), slice(None), slice(None),
                       slice(bucket, None)))
        else:
            for c in lane.values():
                c[:, :, :, bucket:].zero_()
        return self._bucket_ids(prompt, bucket), lane, t

    @torch.inference_mode()
    def slot_suffix_prefill(self, pool, slot: int, tokens, start_pos: int,
                            temperature: float = 0.0, top_k: int = 0,
                            top_p: float = 1.0, seed: int = 0):
        """Prefill only the suffix ``tokens`` of a prompt into slot ``slot``,
        whose lane already holds the K/V of columns ``[0, start_pos)``
        (the final chunk of a chunked admission). The suffix is right-padded
        to a pow2 bucket that must fit: ``start_pos + bucket <= max_len``.
        The next token is keyed at column ``start_pos + len(tokens)``.
        Returns ``(pool, next_token: int)``."""
        model = self._slot_model("slot_suffix_prefill")
        tokens = np.asarray(tokens).reshape(-1)
        t = tokens.shape[0]
        num_slots, max_len = self._pool_dims(pool)
        if t < 1:
            raise ValueError("suffix must carry at least one token (the "
                             "sampled next token needs a query position)")
        bucket = min(_next_pow2(t), max_len)
        if start_pos < 0 or start_pos + bucket > max_len:
            raise ValueError(
                f"suffix bucket [{start_pos}, {start_pos + bucket}) exceeds "
                f"max_len={max_len}")
        logits, _ = model.apply_with_cache(self._bucket_ids(tokens, bucket),
                                           self._lane(pool, slot), start_pos)
        tok = _sample_one(logits[0, t - 1], temperature, top_k, top_p, seed,
                          start_pos + t, model.config.vocab_size)
        return pool, tok

    @torch.inference_mode()
    def slot_chunk_prefill(self, pool, slot: int, tokens, start_pos: int):
        """Write one chunk of a prompt's K/V into slot ``slot`` at cache
        columns ``[start_pos, start_pos + len(tokens))`` without sampling:
        the building block of chunked prefill. The chunk is right-padded
        to a pow2 bucket; the pad columns hold garbage K/V until the next
        chunk or a decode write overwrites them. Returns the pool."""
        model = self._slot_model("slot_chunk_prefill")
        tokens = np.asarray(tokens).reshape(-1)
        t = tokens.shape[0]
        num_slots, max_len = self._pool_dims(pool)
        if t < 1:
            raise ValueError("chunk must carry at least one token")
        bucket = min(_next_pow2(t), max_len)
        if start_pos < 0 or start_pos + bucket > max_len:
            raise ValueError(
                f"chunk bucket [{start_pos}, {start_pos + bucket}) exceeds "
                f"max_len={max_len}; size chunks so every bucket fits")
        self._slot_shapes.add(("slot_chunk", num_slots, bucket, max_len) +
                              self._flavor(pool))
        model.chunk_prefill_with_cache(self._bucket_ids(tokens, bucket),
                                       self._lane(pool, slot), start_pos)
        return pool

    def slot_chunk_executables(self, num_slots: int, max_len: int,
                               bucket: int, quantized=None) -> int:
        """How many chunk-prefill shapes of one pow2 bucket ran on this
        pool shape (the JAX package's compiled-executable count) for the
        float pool, the int8 one (``quantized``) or both (None)."""
        return self._ran(("slot_chunk", num_slots, bucket, max_len),
                         quantized)

    def _flavor(self, pool):
        return ("q8",) if self._quantized(pool) else ()

    def _ran(self, key, quantized):
        keys = {None: (key, key + ("q8",)), False: (key,),
                True: (key + ("q8",),)}[quantized]
        return sum(int(k in self._slot_shapes) for k in keys)

    @torch.inference_mode()
    def slot_copy_lane(self, pool, src: int, dst: int):
        """Copy slot ``src``'s whole lane over slot ``dst``'s, on the
        device (an int8 lane's payload and scales verbatim). Returns the
        pool."""
        for c in self._tensors(pool).values():
            c[:, dst] = c[:, src]
        return pool

    def slot_extract_lane(self, pool, slot: int):
        """Slot ``slot``'s lane, ``{"k", "v": [L, 1, H_kv, max_len, hd]}``,
        copied to the host (never a view of the pool; ordinary tensors the
        caller may change). At tp > 1 every kv head of it: the ranks'
        heads gathered (a collective), a shared head taken once. An int8
        pool hands its lane's payload and scales, a ``QuantizedSlotPool``
        on the host."""
        out = {}
        for n, c in self._tensors(pool).items():
            lane = c[:, slot:slot + 1]
            split = self.module.kv_split(lane.shape) if self.tp.active \
                else None
            if split is not None:
                lane = split.gather(lane.contiguous(), self.tp.group)
            out[n] = lane.to("cpu", copy=True)
        if isinstance(pool, QuantizedSlotPool):
            return QuantizedSlotPool(
                {n: out[f"q/{n}"] for n in pool.q},
                {n: out[f"scales/{n}"] for n in pool.scales}, pool.dtype)
        return out

    @torch.inference_mode()
    def slot_insert_lane(self, pool, slot: int, lane):
        """Write a lane (``slot_extract_lane``'s, tensors or numpy arrays,
        possibly another pool's) into slot ``slot``. At tp > 1 the lane is
        whole and each rank keeps its kv heads. Every pairing of float and
        int8 lanes and pools: a float lane is quantized into an int8 pool,
        an int8 lane dequantized into a float one. Returns the pool."""
        pool_q = isinstance(pool, QuantizedSlotPool)
        lane_q = isinstance(lane, QuantizedSlotPool)
        if not lane_q:
            lane = {n: v if isinstance(v, torch.Tensor) else
                    torch.from_numpy(np.asarray(v)) for n, v in lane.items()}
        if pool_q and not lane_q:
            lane = quantize_pool(lane, self.dtype)
        elif lane_q and not pool_q:
            lane = dequantize_pool(lane, self.dtype)
        dst = self._tensors(pool)
        for n, c in dst.items():
            src = self._tensors(lane)[n]
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.asarray(src))
            if self.tp.active:
                src = self.module.kv_split(src.shape).take(src)
            c[:, slot:slot + 1] = src.to(device=c.device, dtype=c.dtype)
        return pool

    @torch.inference_mode()
    def slot_decode_step(self, pool, toks, positions, temps, top_ks=None,
                         top_ps=None, seeds=None):
        """One fused decode step over all slots: feed ``toks[s]`` at cache
        column ``positions[s]`` and sample the next token per slot (greedy
        where ``temps[s] <= 0``; else per-row top-k / top-p with the key of
        ``(seeds[s], positions[s] + 1)``, the column the token will be fed
        at). Free slots pass dummy inputs and the caller drops their
        tokens. Returns ``(pool, next_tokens: np.ndarray [S])``."""
        model = self._slot_model("slot_decode_step")
        num_slots, max_len = self._pool_dims(pool)
        self._slot_shapes.add(("slot_decode", num_slots, max_len) +
                              self._flavor(pool))
        top_ks, top_ps, seeds = self._sample_args(
            len(np.asarray(toks).reshape(-1)), top_ks, top_ps, seeds)
        toks = torch.as_tensor(np.asarray(toks, np.int64), device=self.device)
        # positions and keys stay on the host: the step waits on no device
        positions = torch.as_tensor(np.asarray(positions, np.int64))
        logits, _ = model.decode_with_slots(toks[:, None], pool, positions)
        keys = row_keys(torch.as_tensor(np.asarray(seeds, np.int64)),
                        positions + 1)
        nxt = sample_rows(logits[:, -1], np.asarray(temps, np.float32),
                          np.asarray(top_ks, np.int64),
                          np.asarray(top_ps, np.float32), keys,
                          model.config.vocab_size)
        return pool, nxt.cpu().numpy()

    def slot_decode_executables(self, num_slots: int, max_len: int,
                                quantized=None) -> int:
        """How many decode-step shapes ran on this pool shape (the JAX
        package's compiled-executable count, which its serving tests hold
        at 1), for one pool flavor (``quantized``) or both (None)."""
        return self._ran(("slot_decode", num_slots, max_len), quantized)

    # -------------------------------------------- speculative decode protocol
    # A draft proposes k tokens a slot (k + 1 draft decode steps), the
    # target verifies all of them in one batched ``verify_with_slots``
    # forward, and the rejected K/V columns are rolled back inside the
    # step (inference/speculative.py).

    def init_draft(self, draft_cfg):
        """Build (or fetch the cached) ``DraftRuntime`` for ``draft_cfg``:
        serving engines sharing this engine share draft weights."""
        from .speculative import build_draft, draft_key
        key = draft_key(draft_cfg)
        draft = self._drafts.get(key)
        if draft is None:
            draft = self._drafts[key] = build_draft(self, draft_cfg)
            log_dist(f"InferenceEngine: draft runtime ready "
                     f"({draft.describe})", ranks=[0])
        return draft

    @torch.inference_mode()
    def init_draft_pool(self, draft, num_slots: int, max_len: int):
        """Allocate the draft model's slot-pool KV cache in the serving
        dtype on the engine's device, once."""
        return draft.model.init_kv_cache(num_slots, max_len, dtype=self.dtype,
                                         device=self.device)

    @torch.inference_mode()
    def draft_prefill(self, draft, dpool, slot: int, prompt):
        """Prefill ``prompt`` into the draft pool's lane ``slot`` (pow2
        bucket as ``slot_prefill``, columns past it zeroed; the draft's
        logits are not needed, so its head is not run). Returns the draft
        pool."""
        ids, lane, _ = self._fresh_lane(dpool, slot, prompt)
        draft.model.chunk_prefill_with_cache(ids, lane, 0)
        return dpool

    @torch.inference_mode()
    def slot_draft_propose(self, draft, dpool, toks, positions, temps,
                           top_ks, top_ps, seeds, k: int):
        """Propose ``k`` draft tokens a slot: ``k + 1`` draft decode steps
        (the last writes the last proposal's K/V, so a fully accepted
        block leaves no gap in the draft lane), each sampling with the
        target's keys ``(seed, column + 1)``. Writes past the lane are
        dropped (a request that fills ``max_len`` proposes past it).
        Returns ``(draft pool, draft tokens [S, k] on the host)``."""
        model = draft.model
        num_slots, max_len = self._pool_dims(dpool)
        self._slot_shapes.add(("slot_draft", num_slots, max_len, int(k),
                               draft.key))
        top_ks, top_ps, seeds = self._sample_args(num_slots, top_ks, top_ps,
                                                  seeds)
        temps = np.asarray(temps, np.float32)
        top_ks = np.asarray(top_ks, np.int64)
        top_ps = np.asarray(top_ps, np.float32)
        seeds = torch.as_tensor(np.asarray(seeds, np.int64))
        pos = torch.as_tensor(np.asarray(positions, np.int64))
        tok = torch.as_tensor(np.asarray(toks, np.int64), device=self.device)
        drafts = []
        for _ in range(k + 1):
            logits, _ = model.verify_with_slots(tok[:, None], dpool, pos)
            pos = pos + 1
            tok = sample_rows(logits[:, -1], temps, top_ks, top_ps,
                              row_keys(seeds, pos), model.config.vocab_size)
            drafts.append(tok)
        return dpool, torch.stack(drafts[:k], dim=1).cpu().numpy()

    @torch.inference_mode()
    def slot_verify_step(self, pool, toks, draft_toks, positions, temps,
                         top_ks=None, top_ps=None, seeds=None):
        """Verify ``k`` draft tokens a slot in one batched forward and
        advance every slot by its accepted prefix plus one target token.
        Acceptance is exact match against the target's own sample at
        each column (keys ``(seed, positions + 1 + j)``), so the emitted
        stream is the plain decode's. The ``k + 1`` columns this verify
        writes are saved first; every written column past
        ``positions[s] + accepts[s]`` is restored from them, so the pool
        ends bitwise as the JAX package's whole-lane select leaves it.
        Returns ``(pool, target tokens [S, k + 1], accepts [S])`` on the
        host: slot ``s`` emits ``target[s, :accepts[s] + 1]``."""
        model = self._slot_model("slot_verify_step")
        num_slots, max_len = self._pool_dims(pool)
        draft_toks = np.asarray(draft_toks, np.int64)
        k = int(draft_toks.shape[1])
        self._slot_shapes.add(("slot_verify", num_slots, max_len, k) +
                              self._flavor(pool))
        top_ks, top_ps, seeds = self._sample_args(num_slots, top_ks, top_ps,
                                                  seeds)
        positions = np.asarray(positions, np.int64)
        cols = positions[:, None] + np.arange(k + 1)[None, :]   # [S, k+1]
        rows, offs = np.nonzero(cols < max_len)
        idx = torch.as_tensor(np.stack([rows, cols[rows, offs]])).to(
            self.device)
        saved = {n: c[:, idx[0], :, idx[1]]
                 for n, c in self._tensors(pool).items()}
        block = np.concatenate([np.asarray(toks, np.int64)[:, None],
                                draft_toks], axis=1)
        if self._quantized(pool):      # the other columns keep their bytes
            pool.rewrite = "written"
        try:
            logits, _ = model.verify_with_slots(
                torch.as_tensor(block, device=self.device), pool, positions)
        finally:
            if self._quantized(pool):
                pool.rewrite = "all"
        # the target's candidate at offset j is fed at column
        # positions + 1 + j: one sampling call over the [S * (k+1)] rows
        rep = lambda a: np.repeat(np.asarray(a), k + 1)   # noqa: E731
        keys = row_keys(torch.as_tensor(rep(np.asarray(seeds, np.int64))),
                        torch.as_tensor((cols + 1).reshape(-1)))
        tgt = sample_rows(logits.reshape(num_slots * (k + 1), -1),
                          rep(np.asarray(temps, np.float32)),
                          rep(np.asarray(top_ks, np.int64)),
                          rep(np.asarray(top_ps, np.float32)), keys,
                          model.config.vocab_size)
        tgt = tgt.reshape(num_slots, k + 1).cpu().numpy()
        match = (draft_toks == tgt[:, :k]).astype(np.int64)
        accepts = np.cumprod(match, axis=1).sum(axis=1)
        # roll back: every written column past positions + accepts
        back = np.nonzero(offs > accepts[rows])[0]
        if back.size:
            sel = torch.as_tensor(back).to(self.device)
            for n, c in self._tensors(pool).items():
                c[:, idx[0, sel], :, idx[1, sel]] = saved[n][sel]
        return pool, tgt, accepts

    def slot_verify_executables(self, num_slots: int, max_len: int,
                                k: int, quantized=None) -> int:
        """How many verify shapes of one ``k`` ran on this pool shape (the
        JAX package's compiled-executable count), by pool flavor."""
        return self._ran(("slot_verify", num_slots, max_len, int(k)),
                         quantized)

    def slot_draft_executables(self, draft, num_slots: int, max_len: int,
                               k: int) -> int:
        """How many draft-propose shapes of one ``k`` ran for ``draft`` on
        this pool shape: 0 or 1."""
        return int(("slot_draft", num_slots, max_len, int(k), draft.key)
                   in self._slot_shapes)

    # ------------------------------------------------------------- properties
    @property
    def config(self):
        return self._config
