"""InferenceEngine: scoring (``engine(input_ids)``) and KV-cache generation.

The JAX package's engine compiles a prefill + ``lax.scan`` decode program
per shape bucket; this one runs the same steps eagerly: prefill through
``apply_with_cache``, then one ``apply_with_cache`` call per new token, with
the same sampling (greedy, or temperature then top-k then top-p in HF's
order), the same EOS freezing and the same left-padding rules. CUDA graphs,
the counterpart of the compiled program, come in a later PR.
"""

from typing import Optional

import numpy as np
import torch

from ..models.api import ModelSpec
from ..utils.logging import log_dist, logger
from .config import DeepSpeedInferenceConfig


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _sample(logits, temperature, top_k, top_p, vocab, generator):
    """One token per row from ``logits [B, V_padded]``, over the real vocab
    only."""
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
        probs = torch.softmax(desc, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        thresh = torch.where(keep, desc, torch.inf).amin(-1, keepdim=True)
        logits = torch.where(logits >= thresh, logits, -torch.inf)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator).squeeze(-1)


class InferenceEngine:
    """Callable engine: ``engine(input_ids)`` -> logits;
    ``engine.generate(...)`` -> token ids.

    ``model`` is cast in place to the config dtype (floating parameters
    only) and moved to ``device`` (default ``cuda``). ``params``, a JAX
    parameter tree of the model's family (numpy arrays), replaces the
    module's weights through the model's own ``load_jax_params``."""

    def __init__(self, model, config: DeepSpeedInferenceConfig = None,
                 params=None, device=None):
        if config is None:
            config = DeepSpeedInferenceConfig()
        if not isinstance(model, ModelSpec):
            raise NotImplementedError(
                f"serving a {type(model).__name__} (HF module injection) is "
                f"not ported yet: ROADMAP.md row A10; pass a "
                f"deepspeed_tpu_torch model")
        self._config = config
        self.dtype = config.dtype
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceEngine: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        if params is not None:
            model.load_jax_params(params)
        self.module = model.to(device=self.device, dtype=self.dtype).eval()
        log_dist(f"InferenceEngine initialized: "
                 f"params={model.num_params() / 1e6:.1f}M "
                 f"dtype={str(self.dtype).replace('torch.', '')} "
                 f"max_tokens={config.max_tokens} device={self.device}",
                 ranks=[0])

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
        ``attention_mask`` [B, T] (1 = real token) serves LEFT-padded
        batches: pad columns never act as keys and logical positions shift
        per row. Sampled draws come from a generator seeded with ``seed``."""
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
        if num_beams > 1:
            raise NotImplementedError(
                "beam search is not ported yet: ROADMAP.md row A6")
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

        vocab = model.config.vocab_size
        generator = torch.Generator(device=self.device).manual_seed(seed)

        def sample(logits):
            return _sample(logits[:, -1], temperature, top_k, top_p, vocab,
                           generator)

        cache = model.init_kv_cache(b, cache_len, dtype=self.dtype,
                                    device=self.device)
        logits, cache = model.apply_with_cache(ids, cache, 0, pad_counts)
        tok = sample(logits)
        finished = (torch.zeros(b, dtype=torch.bool, device=self.device)
                    if eos_token_id is None else tok == eos_token_id)
        toks = [tok]
        for i in range(1, max_new_tokens):
            # tok was sampled for position t+i-1; its K/V go there
            logits, cache = model.apply_with_cache(tok[:, None], cache,
                                                   t + i - 1, pad_counts)
            tok = sample(logits)
            if eos_token_id is not None:
                tok = torch.where(finished, eos_token_id, tok)
                finished = finished | (tok == eos_token_id)
            toks.append(tok)
        return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)
