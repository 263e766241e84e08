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
    return _packed(device, dtype, seed, h, d).split(h * d, dim=-1)


def _packed(device, dtype, seed=2, h=H, d=D):
    """One [B, T, 3*H*D] qkv projection."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * h * d)) * 0.3)
    return qkv.to(device, dtype)


def _k2_case(device, dtype, h, d, causal, window, seed=5):
    """K2 and its plain version on the same qkv, K1 output, lse and dO."""
    qkv = _packed(device, dtype, seed, h, d)
    out, lse = tfa.packed_flash_attention_fwd(*qkv.split(h * d, -1), h,
                                              causal=causal, window=window)
    gen = torch.Generator(device=device).manual_seed(seed)
    dout = torch.randn(out.shape, generator=gen, device=device).to(dtype)
    before = tfa.packed_flash_attention_bwd.launches
    got = tfa.packed_flash_attention_bwd(qkv, out, lse, dout, h,
                                         causal=causal, window=window)
    delta = tfa.attention_delta(out, dout, h)
    want = tfa.packed_flash_attention_bwd_plain(
        *qkv.split(h * d, -1), dout, lse, delta, h, causal, None, window)
    torch.cuda.synchronize()
    assert tfa.packed_flash_attention_bwd.launches == before + 1
    assert got.dtype == dtype and got.shape == qkv.shape
    return [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got.split(h * d, -1), want)]


# K2 vs plain (max abs error of dq, dk, dv; values of std ~0.1-0.5): f32
# differs only by summation order; bf16/f16 round p and ds before the
# products and the outputs, and one rounding step of p or ds the other way
# moves a sum by ~1e-2 of its terms
K2_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2, torch.float16: 1e-2}


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal,window", CASES)
def test_flash_attention_packed_bwd_matches_plain(cuda_device, dtype, causal,
                                                  window):
    errs = _k2_case(cuda_device, dtype, H, D, causal, window)
    assert max(errs) <= K2_TOL[dtype], errs


@pytest.mark.cuda
@pytest.mark.parametrize("h,d", [(8, 32), (4, 64), (2, 128)])
def test_flash_attention_packed_bwd_head_dims(cuda_device, h, d):
    """Head dims 32/64/128 of K2, bf16 causal."""
    errs = _k2_case(cuda_device, torch.bfloat16, h, d, True, None)
    assert max(errs) <= K2_TOL[torch.bfloat16], errs


@pytest.mark.cuda
def test_packed_function_requires_grad_on_the_card(cuda_device):
    """On the card the Function's output carries its backward node, and
    the backward launches K2 (the slice-1 fault: a ctypes-filled output
    with no autograd node)."""
    qkv = _packed(cuda_device, torch.bfloat16)
    assert not tfa.packed_flash_attention_qkv(qkv, H).requires_grad
    qkv.requires_grad_()
    out = tfa.packed_flash_attention_qkv(qkv, H)
    assert out.requires_grad
    before = tfa.packed_flash_attention_bwd.launches
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert tfa.packed_flash_attention_bwd.launches == before + 1
    assert qkv.grad is not None and torch.isfinite(qkv.grad.float()).all()


@pytest.mark.cuda
def test_train_batch_launches_k1_and_k2_per_layer_and_micro(cuda_device):
    """One bf16 train_batch of a 2-layer model with gas 2: K1 and K2 each
    launch n_layer x gas times, and the step's loss and grad norm are
    finite."""
    import deepspeed_tpu_torch
    cfg = GPT2Config(vocab_size=250, n_positions=256, n_embd=128, n_layer=2,
                     n_head=2)
    gas, micro = 2, 2
    engine = deepspeed_tpu_torch.initialize(
        model=GPT2Model(cfg), config={
            "train_batch_size": gas * micro,
            "train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "bf16": {"enabled": True}, "steps_per_print": 0})[0]
    assert engine.device.type == "cuda"
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (gas, micro, 128))
    before = (tfa.packed_flash_attention_fwd.launches,
              tfa.packed_flash_attention_bwd.launches)
    loss = engine.train_batch(batch={"input_ids": ids})
    torch.cuda.synchronize()
    assert tfa.packed_flash_attention_fwd.launches - before[0] == 2 * gas
    assert tfa.packed_flash_attention_bwd.launches - before[1] == 2 * gas
    assert np.isfinite(loss.item())
    assert np.isfinite(float(engine.get_global_grad_norm()))
