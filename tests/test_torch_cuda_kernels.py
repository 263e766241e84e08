"""The port's CUDA kernels on the card, each held against its plain PyTorch
version, and the model's kernel path counted. Every test here needs an
NVIDIA Hopper GPU and nvcc and skips elsewhere. This file imports neither
JAX nor the JAX package, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as tfa

B, T, H, D = 2, 256, 4, 64
CASES = [(True, None), (True, 96), (False, None)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (sm_90a)")
    return torch.device("cuda")


def _qkv(device, dtype, seed=2, h=H, d=D):
    """q, k, v as the column thirds of one [B, T, 3*H*D] projection."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * h * d)) * 0.3)
    return qkv.to(device, dtype).split(h * d, dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol_out,tol_lse",
                         [(torch.float32, 5e-5, 1e-4),
                          (torch.bfloat16, 2e-2, 1e-2),
                          (torch.float16, 2e-2, 1e-2)])
@pytest.mark.parametrize("causal,window", CASES)
def test_flash_attention_packed_matches_plain(cuda_device, dtype, tol_out,
                                              tol_lse, causal, window):
    q, k, v = _qkv(cuda_device, dtype)
    before = tfa.packed_flash_attention_fwd.launches
    out, lse = tfa.packed_flash_attention_fwd(q, k, v, H, causal=causal,
                                              window=window)
    want_out, want_lse = tfa.packed_flash_attention_plain(
        q, k, v, H, causal, None, window)
    torch.cuda.synchronize()
    assert tfa.packed_flash_attention_fwd.launches == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (out.float() - want_out.float()).abs().max().item() <= tol_out
    assert (lse - want_lse).abs().max().item() <= tol_lse


@pytest.mark.cuda
@pytest.mark.parametrize("h,d", [(8, 16), (4, 32), (2, 128)])
def test_flash_attention_packed_head_dims(cuda_device, h, d):
    """The other head-dim instantiations of the kernel, bf16 causal."""
    q, k, v = _qkv(cuda_device, torch.bfloat16, h=h, d=d)
    out, lse = tfa.packed_flash_attention_fwd(q, k, v, h)
    want_out, want_lse = tfa.packed_flash_attention_plain(q, k, v, h)
    torch.cuda.synchronize()
    assert (out.float() - want_out.float()).abs().max().item() <= 2e-2
    assert (lse - want_lse).abs().max().item() <= 1e-2


@pytest.mark.cuda
def test_flash_attention_packed_refuses_on_the_card(cuda_device):
    q, k, v = _qkv(cuda_device, torch.bfloat16)
    with pytest.raises(ValueError, match="does not support"):
        tfa.packed_flash_attention_fwd(q[:, :96], k[:, :96], v[:, :96], H)
    with pytest.raises(ValueError, match="strides"):
        tfa.packed_flash_attention_fwd(q, k.contiguous(), v, H)


@pytest.mark.cuda
def test_gpt2_forward_launches_k1_once_per_layer(cuda_device):
    cfg = GPT2Config(vocab_size=250, n_positions=256, n_embd=128, n_layer=2,
                     n_head=2)
    model = GPT2Model(cfg, device=cuda_device).to(torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda_device)
    before = tfa.packed_flash_attention_fwd.launches
    with torch.inference_mode():
        logits = model.logits(ids)
    torch.cuda.synchronize()
    assert tfa.packed_flash_attention_fwd.launches == before + cfg.n_layer
    assert torch.isfinite(logits.float()).all()
