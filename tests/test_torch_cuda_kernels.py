"""The port's CUDA kernels on the card, each held against its plain PyTorch
version, and the model's kernel path counted. Every test here needs an
NVIDIA Hopper GPU and nvcc and skips elsewhere. This file imports neither
JAX nor the JAX package, so it runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_kernels.py
"""

import re

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.bert import BertConfig, BertModel
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.ops import flash_attention as dispatch
from deepspeed_tpu_torch.ops import sparse_attention_ops as sops
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops.kernels import flash_attention as tfk
from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as tfa

B, T, H, D = 2, 256, 4, 64
CASES = [(True, None), (True, 96), (False, None)]
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
# each kernel against its plain version, elementwise: |kernel - plain| <=
# atol + rtol |plain| (out; dq, dk, dv), lse (f32 in both) to LSE_TOL. Both
# compute in f32 with the same tiles and rounding points, so rounded to
# bf16/f16 they differ by at most one rounding step (2^-7 |x| in bf16,
# 2^-10 |x| in f16); rtol allows two, atol values near 0 (chip_smoke.py's
# TOL)
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-4, 2 ** -6),
       torch.float16: (1e-4, 2 ** -9)}
LSE_TOL = 1e-4


def _ratio(got, want):
    """max |got - want| / (atol + rtol |want|), TOL by want's dtype."""
    atol, rtol = TOL[want.dtype]
    diff = (got.float() - want.float()).abs()
    return (diff / (atol + rtol * want.float().abs())).max().item()


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
        *qkv.split(h * d, -1), dout, lse, delta, h, causal, None, window,
        tfk.tensor_core_path(dtype, d, backward=True))
    torch.cuda.synchronize()
    assert tfa.packed_flash_attention_bwd.launches == before + 1
    assert got.dtype == dtype and got.shape == qkv.shape
    return [_ratio(g, w) for g, w in zip(got.split(h * d, -1), want)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window", CASES)
def test_flash_attention_packed_matches_plain(cuda_device, dtype, causal,
                                              window):
    q, k, v = _qkv(cuda_device, dtype)
    before = tfa.packed_flash_attention_fwd.launches
    out, lse = tfa.packed_flash_attention_fwd(q, k, v, H, causal=causal,
                                              window=window)
    want_out, want_lse = tfa.packed_flash_attention_plain(
        q, k, v, H, causal, None, window, tfk.tensor_core_path(dtype, D))
    torch.cuda.synchronize()
    assert tfa.packed_flash_attention_fwd.launches == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert _ratio(out, want_out) <= 1
    assert (lse - want_lse).abs().max().item() <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("h,d", [(8, 16), (4, 32), (2, 128)])
def test_flash_attention_packed_head_dims(cuda_device, h, d):
    """The other head-dim instantiations of the kernel, bf16 causal."""
    q, k, v = _qkv(cuda_device, torch.bfloat16, h=h, d=d)
    out, lse = tfa.packed_flash_attention_fwd(q, k, v, h)
    want_out, want_lse = tfa.packed_flash_attention_plain(
        q, k, v, h, tensor_core=tfk.tensor_core_path(torch.bfloat16, d))
    torch.cuda.synchronize()
    assert _ratio(out, want_out) <= 1
    assert (lse - want_lse).abs().max().item() <= LSE_TOL


@pytest.mark.cuda
def test_flash_attention_packed_refuses_on_the_card(cuda_device):
    q, k, v = _qkv(cuda_device, torch.bfloat16)
    with pytest.raises(ValueError, match="does not support"):
        tfa.packed_flash_attention_fwd(q[:, :96], k[:, :96], v[:, :96], H)
    # a head dim that is not the innermost (unit stride) one
    k_cols = k.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="unit last stride"):
        tfa.packed_flash_attention_fwd(q, k_cols, v, H)


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
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window", CASES)
def test_flash_attention_packed_bwd_matches_plain(cuda_device, dtype, causal,
                                                  window):
    ratios = _k2_case(cuda_device, dtype, H, D, causal, window)
    assert max(ratios) <= 1, ratios


@pytest.mark.cuda
@pytest.mark.parametrize("h,d", [(8, 32), (4, 64), (2, 128)])
def test_flash_attention_packed_bwd_head_dims(cuda_device, h, d):
    """Head dims 32/64/128 of K2, bf16 causal."""
    ratios = _k2_case(cuda_device, torch.bfloat16, h, d, True, None)
    assert max(ratios) <= 1, ratios


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


# ------------------------------------------------- K3 and the K3b/K5 backward

def _bhtd(device, dtype, shape, seed, layout="bhtd"):
    """q, k, v [B, H, T, D]: contiguous ("bhtd"), views of [B, T, H, D]
    buffers ("bthd", the layout the LLaMA block hands the kernels), or
    views one column into [B, T, H, D + 1] buffers ("unaligned": rows do
    not start on 16 bytes, so the kernels read them column by column
    instead of in 16-byte chunks)."""
    rng = np.random.default_rng(seed)
    b, h, t, d = shape
    skip = int(layout == "unaligned")
    out = []
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal((b, t, h, d + skip)) * 0.5)
        x = x.to(device, dtype)[..., skip:].transpose(1, 2)
        out.append(x.contiguous() if layout == "bhtd" else x)
    return out


K3_CASES = [(True, None, None), (True, 96, None), (False, None, None),
            (True, None, 0.05)]


def _k3_case(device, dtype, shape, causal, window, scale, layout="bhtd",
             seed=7):
    """The forward and backward kernels against their plain versions; one
    launch each, counted in q's regime (K3, or the streamed K4/K4b)."""
    q, k, v = _bhtd(device, dtype, shape, seed, layout)
    counter = "streamed_launches" if tfk.streamed(q) else "launches"
    before = (getattr(tfk.flash_attention_fwd, counter),
              getattr(tfk.flash_attention_bwd, counter))
    out, lse = tfk.flash_attention_fwd(q, k, v, causal, scale, window)
    want_out, want_lse = tfk.flash_attention_plain(
        q, k, v, causal, scale, window,
        tfk.tensor_core_path(dtype, shape[-1]))
    gen = torch.Generator(device=device).manual_seed(seed)
    dout = torch.randn(out.shape, generator=gen, device=device).to(dtype)
    got = tfk.flash_attention_bwd(q, k, v, out, lse, dout, causal, scale,
                                  window)
    delta = tfk.attention_delta(out, dout)
    want = tfk.flash_attention_bwd_plain(
        q, k, v, dout, lse, delta, causal, scale, window,
        tfk.tensor_core_path(dtype, shape[-1], backward=True))
    torch.cuda.synchronize()
    assert (getattr(tfk.flash_attention_fwd, counter),
            getattr(tfk.flash_attention_bwd, counter)) == \
        (before[0] + 1, before[1] + 1)
    assert out.shape == q.shape and out.dtype == dtype
    fwd_err = (_ratio(out, want_out), (lse - want_lse).abs().max().item())
    return fwd_err, [_ratio(g, w) for g, w in zip(got, want)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window,scale", K3_CASES)
def test_flash_attention_matches_plain(cuda_device, dtype, causal, window,
                                       scale):
    (r_out, e_lse), bwd = _k3_case(cuda_device, dtype, (2, 4, 256, 64),
                                   causal, window, scale)
    assert r_out <= 1 and e_lse <= LSE_TOL, (r_out, e_lse)
    assert max(bwd) <= 1, bwd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [8, 16, 80, 128, 200, 256])
@pytest.mark.parametrize("layout", ["bhtd", "bthd", "unaligned"])
def test_flash_attention_head_dims_and_layouts(cuda_device, dtype, d,
                                               layout):
    """Every head-dim ceiling (64, 128, 256), exact and with a masked
    runtime d, on contiguous, [B, T, H, D]-strided and unaligned inputs;
    window 100. In bf16 the forward at 200 and 256 is the wgmma kernel
    (its register-staged copy for unaligned inputs), its backward the
    scalar pair."""
    (r_out, e_lse), bwd = _k3_case(cuda_device, dtype, (2, 2, 256, d), True,
                                   100, None, layout)
    assert r_out <= 1 and e_lse <= LSE_TOL, (r_out, e_lse)
    assert max(bwd) <= 1, bwd


@pytest.mark.cuda
def test_dispatch_streamed_regime_takes_the_kernel_on_the_card(cuda_device):
    """The streamed regime (T * D * itemsize > 1 MiB, the JAX package's
    K4/K4b) dispatches to the kernels on the card, counted as streamed
    launches and not as K3's."""
    q, k, v = _bhtd(cuda_device, torch.bfloat16, (1, 1, 8192, 128), 3)
    before = (tfk.flash_attention_fwd.launches,
              tfk.flash_attention_fwd.streamed_launches)
    out = dispatch.flash_attention(q, k, v, backend="pallas")
    torch.cuda.synchronize()
    assert (tfk.flash_attention_fwd.launches,
            tfk.flash_attention_fwd.streamed_launches) == \
        (before[0], before[1] + 1)
    assert out.shape == q.shape and torch.isfinite(out.float()).all()


# ---------------------------------- the tensor-core (bf16/f16) instances

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("t,d,window", [
    (64, 64, None), (64, 128, None), (192, 64, None), (192, 128, None),
    (512, 64, 100), (512, 128, 100), (64, 256, None), (192, 256, None),
    (512, 256, 100)])
def test_tensor_core_tiles_match_plain(cuda_device, dtype, t, d, window):
    """The tensor-core kernels at one 64-row tile, at an odd count of
    tiles, and with a window of 100 at T 512, whose first visited k tile is
    fully masked for the late rows of a q tile (their sum of exp2(0) is
    wiped at the first live tile), at every head-dim ceiling: at 256 the
    wgmma forward's 128-row q tiles, whose second warpgroup has no rows at
    T 64 and 192."""
    (r_out, e_lse), bwd = _k3_case(cuda_device, dtype, (1, 2, t, d), True,
                                   window, None, "bthd")
    assert r_out <= 1 and e_lse <= LSE_TOL, (r_out, e_lse)
    assert max(bwd) <= 1, bwd


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 80])
@pytest.mark.parametrize("layout", ["bthd", "unaligned"])
def test_tensor_core_masked_head_dims_f16(cuda_device, d, layout):
    """Head dims under a tensor-core ceiling in f16 (bf16 is in
    test_flash_attention_head_dims_and_layouts): Q and K zero-padded to the
    16-deep step, V and dO to the output width; unaligned views take the
    register-staged copy instead of cp.async."""
    (r_out, e_lse), bwd = _k3_case(cuda_device, torch.float16,
                                   (2, 2, 256, d), True, 100, None, layout)
    assert r_out <= 1 and e_lse <= LSE_TOL, (r_out, e_lse)
    assert max(bwd) <= 1, bwd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_packed_h8_d16(cuda_device, dtype):
    """K1 and K2 on the packed layout at h 8, d 16: one 16-deep step."""
    q, k, v = _qkv(cuda_device, dtype, h=8, d=16)
    out, lse = tfa.packed_flash_attention_fwd(q, k, v, 8)
    want_out, want_lse = tfa.packed_flash_attention_plain(
        q, k, v, 8, tensor_core=tfk.tensor_core_path(dtype, 16))
    torch.cuda.synchronize()
    assert _ratio(out, want_out) <= 1
    assert (lse - want_lse).abs().max().item() <= LSE_TOL
    ratios = _k2_case(cuda_device, dtype, 8, 16, True, None)
    assert max(ratios) <= 1, ratios


FLASH_INSTANCE = re.compile(r"\b(mma_|wgmma_)?(fwd|dkdv|dq)_kernel<")


def _instances_that_run(q, k, v):
    """``[(kernel, prefix)]`` of the flash kernels one forward and one
    backward launch under the profiler, sorted: prefix ``mma_`` or
    ``wgmma_`` for a tensor-core instance, None for a scalar one."""
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        out, lse = tfk.flash_attention_fwd(q, k, v)
        tfk.flash_attention_bwd(q, k, v, out, lse, out)
        torch.cuda.synchronize()
    found = [FLASH_INSTANCE.search(e.key) for e in prof.key_averages()]
    return sorted(((m.group(2), m.group(1)) for m in found if m),
                  key=lambda x: x[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [16, 64, 80, 128, 200, 256])
def test_tensor_core_path_is_the_instance_that_runs(cuda_device, dtype, d):
    """tensor_core_path, which the checks pass to the plain versions, names
    each direction's route of the kernels that really run: one forward and
    one backward under the profiler launch a tensor-core forward
    (mma_fwd_kernel, or wgmma_fwd_kernel at the 256 ceiling) where the
    forward route says so, mma_dkdv_kernel and mma_dq_kernel where the
    backward route says so, and fwd_kernel, dkdv_kernel and dq_kernel
    elsewhere."""
    q, k, v = _bhtd(cuda_device, dtype, (1, 2, 128, d), 3)
    found = [(name, prefix is not None)
             for name, prefix in _instances_that_run(q, k, v)]
    fwd = tfk.tensor_core_path(dtype, d)
    bwd = tfk.tensor_core_path(dtype, d, backward=True)
    assert found == [("dkdv", bwd), ("dq", bwd), ("fwd", fwd)], found


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_d256_forward_takes_wgmma_and_its_backward_stays_scalar(cuda_device,
                                                                dtype):
    """At GPT-J's head dim 256 the split route reports a tensor-core
    forward and a scalar backward, and those are the instances that run:
    wgmma_fwd_kernel, then the scalar dkdv_kernel and dq_kernel."""
    assert tfk.tensor_core_path(dtype, 256)
    assert not tfk.tensor_core_path(dtype, 256, backward=True)
    q, k, v = _bhtd(cuda_device, dtype, (1, 2, 128, 256), 3)
    assert _instances_that_run(q, k, v) == [
        ("dkdv", None), ("dq", None), ("fwd", "wgmma_")]


TINY_LLAMA = LlamaConfig(vocab_size=256, n_positions=256, n_embd=128,
                         n_layer=2, n_head=4, n_kv_head=2, mlp_hidden=192,
                         pad_vocab_to_multiple=8, sliding_window=100)


@pytest.mark.cuda
def test_llama_forward_launches_k3_per_layer_and_never_k1(cuda_device):
    model = LlamaModel(TINY_LLAMA, device=cuda_device).to(torch.bfloat16)
    ids = torch.randint(0, 256, (2, 128), device=cuda_device)
    before = (tfk.flash_attention_fwd.launches,
              tfa.packed_flash_attention_fwd.launches)
    with torch.inference_mode():
        logits = model.logits(ids)
    torch.cuda.synchronize()
    assert tfk.flash_attention_fwd.launches - before[0] == TINY_LLAMA.n_layer
    assert tfa.packed_flash_attention_fwd.launches == before[1]
    assert torch.isfinite(logits.float()).all()


@pytest.mark.cuda
def test_llama_train_batch_launches_k3_forward_and_backward(cuda_device):
    import deepspeed_tpu_torch
    gas, micro = 2, 2
    engine = deepspeed_tpu_torch.initialize(
        model=LlamaModel(TINY_LLAMA), config={
            "train_batch_size": gas * micro,
            "train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "bf16": {"enabled": True}, "steps_per_print": 0})[0]
    ids = np.random.default_rng(0).integers(0, 256, (gas, micro, 128))
    before = (tfk.flash_attention_fwd.launches,
              tfk.flash_attention_bwd.launches)
    loss = engine.train_batch(batch={"input_ids": ids})
    torch.cuda.synchronize()
    want = TINY_LLAMA.n_layer * gas
    assert tfk.flash_attention_fwd.launches - before[0] == want
    assert tfk.flash_attention_bwd.launches - before[1] == want
    assert np.isfinite(loss.item())


# ------------------------------------------- streamed regime (K4 and K4b)

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (1, 2, 8192, 128)), (torch.float16, (1, 2, 8192, 128)),
    (torch.float32, (1, 2, 4096, 128))], ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 1000),
                                           (False, None)])
def test_streamed_flash_attention_matches_plain(cuda_device, dtype, shape,
                                                causal, window):
    """T * D * itemsize = 2 MiB: the JAX package's K4/K4b regime, counted
    as streamed launches and not as K3's."""
    q, _, _ = _bhtd(cuda_device, dtype, shape, 11, "bthd")
    assert tfk.streamed(q)
    before = tfk.flash_attention_fwd.launches
    (r_out, e_lse), bwd = _k3_case(cuda_device, dtype, shape, causal, window,
                                   None, "bthd", 11)
    assert r_out <= 1 and e_lse <= LSE_TOL, (r_out, e_lse)
    assert max(bwd) <= 1, bwd
    assert tfk.flash_attention_fwd.launches == before


CODELLAMA_SHAPED = LlamaConfig(vocab_size=256, n_positions=8192, n_embd=256,
                               n_layer=2, n_head=2, mlp_hidden=384,
                               pad_vocab_to_multiple=8, rope_theta=1e6)


@pytest.mark.cuda
def test_codellama_shaped_takes_k4_and_k4b_never_k3(cuda_device):
    """Head dim 128 at T 8192 in bf16 (2 MiB of K/V a head): the forward
    launches K4 once per layer and K3 never; a train_batch launches K4 and
    K4b n_layer x gas times."""
    import deepspeed_tpu_torch
    model = LlamaModel(CODELLAMA_SHAPED, device=cuda_device).to(
        torch.bfloat16)
    ids = torch.randint(0, 256, (1, 8192), device=cuda_device)
    fwd, bwd = tfk.flash_attention_fwd, tfk.flash_attention_bwd
    before = (fwd.launches, fwd.streamed_launches)
    with torch.inference_mode():
        logits = model.logits(ids)
    torch.cuda.synchronize()
    assert (fwd.launches, fwd.streamed_launches) == \
        (before[0], before[1] + CODELLAMA_SHAPED.n_layer)
    assert torch.isfinite(logits.float()).all()
    gas = 2
    engine = deepspeed_tpu_torch.initialize(
        model=LlamaModel(CODELLAMA_SHAPED), config={
            "train_batch_size": gas, "train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "bf16": {"enabled": True}, "steps_per_print": 0})[0]
    batch = np.random.default_rng(1).integers(0, 256, (gas, 1, 8192))
    before = (fwd.launches, fwd.streamed_launches, bwd.launches,
              bwd.streamed_launches)
    loss = engine.train_batch(batch={"input_ids": batch})
    torch.cuda.synchronize()
    want = CODELLAMA_SHAPED.n_layer * gas
    assert (fwd.launches, fwd.streamed_launches, bwd.launches,
            bwd.streamed_launches) == \
        (before[0], before[1] + want, before[2], before[3] + want)
    assert np.isfinite(loss.item())


# ------------------------------------------------- block-sparse (K6, K7)

def _sparse_layout(kind, h, t, fb):
    if kind == "edge":     # an empty fine row, a coarse row with nnz = 0
        nb = t // fb
        layout = np.zeros((h, nb, nb), bool)
        for i in range(nb):
            layout[:, i, i] = True
        layout[0, 5, :] = False
        layout[-1, 8:16, :] = False
        return layout
    cls, kw = {
        "fixed": (sops.FixedSparsityConfig,
                  dict(num_local_blocks=4, num_global_blocks=1,
                       different_layout_per_head=True,
                       num_different_global_patterns=4)),
        "bslongformer": (sops.BSLongformerSparsityConfig,
                         dict(num_sliding_window_blocks=3,
                              global_block_indices=(0,))),
        "bigbird": (sops.BigBirdSparsityConfig,
                    dict(num_random_blocks=1, num_sliding_window_blocks=3,
                         num_global_blocks=1, seed=0)),
    }[kind]
    return cls(num_heads=h, block=fb, **kw).make_layout(t)


def _sparse_case(device, dtype, shape, kind, fb=16, layout_kind="bthd",
                 tile=None, heads=None):
    """K6 and K7 against their plain versions on the same inputs (summing
    as the kernels' route does, ``bsa.tensor_core_path``): the forward's
    out and lse ratios, and dq, dk, dv ratios."""
    b, h, t, d = shape
    if heads is None:
        layout = _sparse_layout(kind, h, t, fb)
    else:           # a tensor-parallel rank's rows of the whole layout
        layout = np.ascontiguousarray(
            _sparse_layout(kind, heads[1], t, fb)[heads[0]:heads[0] + h])
    tile = tile or bsa.default_tile(t, fb)
    plan = bsa.get_plan(layout, fb, tile, device)
    q, k, v = _bhtd(device, dtype, shape, 13, layout_kind)
    scale = d ** -0.5
    tc = bsa.tensor_core_path(dtype, d)
    before = (bsa.block_sparse_attention_fwd.launches,
              bsa.block_sparse_attention_bwd.launches)
    out, lse = bsa.block_sparse_attention_fwd(q, k, v, plan, scale)
    want_out, want_lse = bsa.block_sparse_attention_plain(q, k, v, plan,
                                                          scale, tc)
    gen = torch.Generator(device=device).manual_seed(13)
    dout = torch.randn(out.shape, generator=gen, device=device).to(dtype)
    got = bsa.block_sparse_attention_bwd(q, k, v, out, lse, dout, plan,
                                         scale)
    want = bsa.block_sparse_attention_bwd_plain(
        q, k, v, dout, lse, tfk.attention_delta(out, dout), plan, scale, tc)
    torch.cuda.synchronize()
    assert (bsa.block_sparse_attention_fwd.launches,
            bsa.block_sparse_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and out.shape == q.shape
    finite = torch.isfinite(want_lse)
    return ((_ratio(out, want_out),
             (lse - want_lse)[finite].abs().max().item()),
            [_ratio(g, w) for g, w in zip(got, want)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["fixed", "bslongformer", "bigbird",
                                  "edge"])
def test_block_sparse_matches_plain(cuda_device, dtype, kind):
    (r_out, e_lse), bwd = _sparse_case(cuda_device, dtype, (2, 4, 1024, 64),
                                       kind)
    assert r_out <= 1 and e_lse <= LSE_TOL, (r_out, e_lse)
    assert max(bwd) <= 1, bwd


@pytest.mark.cuda
@pytest.mark.parametrize("d,fb,layout_kind", [
    (32, 16, "bhtd"), (64, 64, "bthd"), (80, 32, "unaligned"),
    (128, 16, "bthd"), (256, 16, "bhtd"), (128, 128, "bhtd")])
def test_block_sparse_head_dims_blocks_and_layouts(cuda_device, d, fb,
                                                   layout_kind):
    """Every head-dim ceiling (64, 128, 256; the 32-row own tiles of the
    backward at 256), fine blocks 16 to 128 (tiles 128 and 256), contiguous,
    [B, T, H, D]-strided and unaligned inputs; bf16, BigBird."""
    (r_out, e_lse), bwd = _sparse_case(cuda_device, torch.bfloat16,
                                       (1, 2, 1024, d), "bigbird", fb,
                                       layout_kind)
    assert r_out <= 1 and e_lse <= LSE_TOL, (r_out, e_lse)
    assert max(bwd) <= 1, bwd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 80])
@pytest.mark.parametrize("fb", [16, 32, 64])
def test_block_sparse_tensor_cores_match_plain(cuda_device, dtype, d, fb):
    """The tensor-core K6/K7 (with their skips: fine blocks 16, 32 and 64
    are multiples of the 16-row steps) against the plain versions that sum
    as the tensor cores do, under every layout, at the exact head dims 64
    and 128 and a d of 80 masked under the 128 ceiling. The route is the
    kernels' own dispatch (``tensor_core_route``), the same for the flash
    and the block-sparse libraries; the BERT profiles of ``chip_smoke.py``
    name the instances that ran (a run of short profiles loses kernel
    events, so this file does not)."""
    assert bsa.tensor_core_path(dtype, d)
    assert tfk.tensor_core_path(dtype, d)
    for kind in ("fixed", "bslongformer", "bigbird", "edge"):
        (r_out, e_lse), bwd = _sparse_case(cuda_device, dtype,
                                           (1, 2, 1024, d), kind, fb)
        assert r_out <= 1 and e_lse <= LSE_TOL, (kind, r_out, e_lse)
        assert max(bwd) <= 1, (kind, bwd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_block_sparse_tensor_cores_fine_block_24(cuda_device, dtype):
    """A fine block that is not a multiple of the 16-row steps (24, with an
    explicit tile of 192): the tensor-core kernels mask element by element
    and skip only dead 64 x 64 sub-tiles."""
    for kind in ("bigbird", "edge"):
        (r_out, e_lse), bwd = _sparse_case(cuda_device, dtype,
                                           (1, 2, 1536, 64), kind, 24,
                                           tile=192)
        assert r_out <= 1 and e_lse <= LSE_TOL, (kind, r_out, e_lse)
        assert max(bwd) <= 1, (kind, bwd)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fixed", "bigbird"])
@pytest.mark.parametrize("h0", [0, 2])
def test_block_sparse_on_a_rank_rows_of_the_layout(cuda_device, kind, h0):
    """K6/K7 at a tp-2 rank's 2 of 4 heads, on its rows of the layout made
    for all 4 (each head its own pattern), against the plain versions."""
    (r_out, e_lse), bwd = _sparse_case(cuda_device, torch.bfloat16,
                                       (2, 2, 1024, 64), kind,
                                       heads=(h0, 4))
    assert r_out <= 1 and e_lse <= LSE_TOL, (r_out, e_lse)
    assert max(bwd) <= 1, bwd


TINY_BERT = BertConfig(vocab_size=256, n_positions=128, n_embd=128,
                       n_layer=2, n_head=2, pad_vocab_to_multiple=8)


@pytest.mark.cuda
def test_bert_with_surgery_takes_k6_and_k7_never_k3(cuda_device):
    """TINY BERT after the Fixed-layout surgery (positions 128 -> 1024):
    the forward launches K6 once per layer and K3 never; a train_batch
    with masked positions launches K6 and K7 n_layer x gas times."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.sparse_attention_utils import \
        SparseAttentionUtils

    def surgered():
        return SparseAttentionUtils.\
            replace_model_self_attention_with_sparse_self_attention(
                BertModel(TINY_BERT), max_position=1024,
                sparsity_config=sops.FixedSparsityConfig(num_heads=2,
                                                         block=16))

    model = surgered().to(cuda_device, torch.bfloat16)
    ids = torch.randint(0, 256, (2, 1024), device=cuda_device)
    fwd, bwd = bsa.block_sparse_attention_fwd, bsa.block_sparse_attention_bwd
    before = (fwd.launches, tfk.flash_attention_fwd.launches)
    with torch.inference_mode():
        logits = model.logits(ids)
    torch.cuda.synchronize()
    assert (fwd.launches, tfk.flash_attention_fwd.launches) == \
        (before[0] + TINY_BERT.n_layer, before[1])
    assert torch.isfinite(logits.float()).all()
    gas, micro = 2, 2
    engine = deepspeed_tpu_torch.initialize(model=surgered(), config={
        "train_batch_size": gas * micro,
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": gas,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
        "bf16": {"enabled": True}, "steps_per_print": 0})[0]
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 256, (gas, micro, 1024))
    pos = np.sort(rng.choice(1024, (gas, micro, 150)), axis=-1)
    batch = {"input_ids": ids, "masked_positions": pos,
             "masked_labels": np.take_along_axis(ids, pos, -1)}
    before = (fwd.launches, bwd.launches, tfk.flash_attention_fwd.launches)
    loss = engine.train_batch(batch=batch)
    torch.cuda.synchronize()
    want = TINY_BERT.n_layer * gas
    assert (fwd.launches, bwd.launches, tfk.flash_attention_fwd.launches) \
        == (before[0] + want, before[1] + want, before[2])
    assert np.isfinite(loss.item())


# ------------------------------------------------- threefry dropout kernel

def _drop_input(device, dtype, shape, seed=3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 1000, 77), (5, 13), (2, 4, 64, 64)])
def test_threefry_dropout_bitwise_its_plain_version(cuda_device, dtype,
                                                    shape):
    """Forward and backward (the same kernel on the gradient) equal the
    plain version bit for bit, on a ragged shape (a scalar tail), a tiny
    one and an aligned one, and on an unaligned view (no vector loads)."""
    from deepspeed_tpu_torch.ops import dropout as drop
    from deepspeed_tpu_torch.ops.kernels import threefry_dropout as tfd
    key = (123456789, 987654321)
    x = _drop_input(cuda_device, dtype, shape)
    before = tfd.threefry_dropout.launches
    got = tfd.threefry_dropout(x, key, 0.1)
    want = tfd.threefry_dropout_plain(x, key, 0.1)
    torch.cuda.synchronize()
    assert tfd.threefry_dropout.launches == before + 1
    assert torch.equal(got, want)
    kept = (want != 0).float().mean().item()
    assert abs(kept - 0.9) < 5 * (0.9 * 0.1 / want.numel()) ** 0.5 + 1e-3
    flat = x.reshape(-1)
    view = flat[1:]                                 # 16-byte misaligned
    assert torch.equal(tfd.threefry_dropout(view, key, 0.25),
                       tfd.threefry_dropout_plain(view, key, 0.25))
    xg = x.clone().requires_grad_()
    out = drop.token_dropout(xg, key, 0.1)
    g = _drop_input(cuda_device, dtype, shape, seed=4)
    out.backward(g)
    assert torch.equal(out.detach(), want)
    assert torch.equal(xg.grad, tfd.threefry_dropout_plain(g, key, 0.1))
    # one flipped key bit gives another mask
    assert not torch.equal(tfd.threefry_dropout(x, (key[0] ^ 1, key[1]),
                                                0.1), want)


@pytest.mark.cuda
def test_checkpoint_codec_round_trips_a_cuda_bf16_tensor(cuda_device):
    """A bf16 tensor on the card is written from the device (whole and a
    row at a time, chunked at a small chunk size) and read back on the
    card bit for bit."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine import \
        msgpack_codec as codec
    x = torch.randn(6, 70, device=cuda_device).to(torch.bfloat16)
    data = codec.dumps({"w": x, "n": np.asarray(3, np.int32)})
    back = codec.loads(data, on_leaf=lambda p, a: torch.as_tensor(a).to(
        cuda_device))
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], x)
    rows = codec.ArrayLeaf(x.shape, x.dtype, lambda: list(x))
    assert codec.dumps({"w": rows, "n": np.asarray(3, np.int32)}) == data
    chunk, codec.MAX_CHUNK_SIZE = codec.MAX_CHUNK_SIZE, 256
    try:
        chunked = codec.dumps({"w": rows})
        assert b"__msgpack_chunked_array__" in chunked
        assert torch.equal(codec.loads(chunked)["w"].to(cuda_device), x)
    finally:
        codec.MAX_CHUNK_SIZE = chunk


@pytest.mark.cuda
def test_checkpoint_save_load_on_the_card_is_bitwise(cuda_device, tmp_path):
    """A LLaMA engine on the card trains, saves, and a fresh engine (other
    initial weights) loads the tag and continues bitwise; the masters and
    moments stay on the card and keep their storage."""
    import deepspeed_tpu_torch
    cfg = LlamaConfig(vocab_size=256, n_positions=256, n_embd=128,
                      n_layer=2, n_head=2, mlp_hidden=256)
    config = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
              "bf16": {"enabled": True}, "steps_per_print": 0}

    def engine(seed):
        model = LlamaModel(cfg, generator=torch.Generator().manual_seed(seed))
        return deepspeed_tpu_torch.initialize(model=model, config=config)[0]
    ids = torch.randint(0, 256, (4, 2, 2, 128),
                        generator=torch.Generator().manual_seed(0))
    whole, first = engine(0), engine(0)
    for b in ids:
        whole.train_batch(batch={"input_ids": b})
    for b in ids[:2]:
        first.train_batch(batch={"input_ids": b})
    first.save_checkpoint(tmp_path)
    resumed = engine(1)
    ptrs = [m.data_ptr() for m in resumed._masters]
    resumed.load_checkpoint(tmp_path)
    assert [m.data_ptr() for m in resumed._masters] == ptrs
    for b in ids[2:]:
        resumed.train_batch(batch={"input_ids": b})
    for a, b in zip(resumed._masters + resumed.opt_state.mu,
                    whole._masters + whole.opt_state.mu):
        assert a.device.type == "cuda" and torch.equal(a, b)


# ------------------------------------------------- ZeRO on the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_threefry_dropout_at_an_offset_bitwise_its_plain_version(
        cuda_device, dtype):
    """The kernel at a non-zero element offset (a data-parallel rank's rows
    of the global mask, past 2**32 elements too) equals its plain version
    at that offset bit for bit, and the tail of the draw without one."""
    from deepspeed_tpu_torch.ops.kernels import threefry_dropout as tfd
    key = (2024, 77)
    x = _drop_input(cuda_device, dtype, (4, 96, 130))
    rows = x[2:].contiguous()
    off = 2 * 96 * 130
    for offset in (off, (1 << 32) + 5):
        assert torch.equal(tfd.threefry_dropout(rows, key, 0.1, offset),
                           tfd.threefry_dropout_plain(rows, key, 0.1,
                                                      offset))
    assert torch.equal(tfd.threefry_dropout(rows, key, 0.1, off),
                       tfd.threefry_dropout(x, key, 0.1)[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,h0,total", [
    ((2, 3, 7, 11), 3, 6),          # inner 231: not a multiple of a vector
    ((2, 4, 64, 64), 4, 8)])        # inner a multiple of every vector
def test_threefry_dropout_head_map_bitwise_its_plain_version(
        cuda_device, dtype, shape, h0, total):
    """Under the head-strided map (a tp rank's heads ``[h0, h0 + h)`` of
    ``total``, rows from 1 of the global batch): the kernel equals its
    plain version bit for bit and the heads' slice of the contiguous draw
    over the whole tensor; ``inner == stride`` is the contiguous launch."""
    from deepspeed_tpu_torch.ops.dropout import counter_map
    from deepspeed_tpu_torch.ops.kernels import threefry_dropout as tfd
    key = (2024, 78)
    h = shape[1]
    whole = _drop_input(cuda_device, dtype, (shape[0] + 1, total) +
                        shape[2:])
    x = whole[1:, h0:h0 + h].contiguous()
    where = counter_map(tuple(x.shape), 1, (h0, total))
    got = tfd.threefry_dropout(x, key, 0.1, *where)
    assert torch.equal(got, tfd.threefry_dropout_plain(x, key, 0.1, *where))
    assert torch.equal(got, tfd.threefry_dropout(whole, key, 0.1)[
        1:, h0:h0 + h])
    row = x[0].numel()
    assert torch.equal(tfd.threefry_dropout(x, key, 0.1, 5, row, row),
                       tfd.threefry_dropout(x, key, 0.1, 5))


@pytest.mark.cuda
def test_nccl_world1_zero_stages_bitwise_stage0(cuda_device, tmp_path):
    """On an NCCL process group of one rank, stages 1-3 partitioned over
    that rank (the test planner ``OneRankPlanner``: the real one shards
    nothing there) take every gather and reduce-scatter, each an identity,
    and AdamW is elementwise, so they give stage 0's losses, masters and
    moments bit for bit (bf16 on fp32 masters, gas 2, clipping on)."""
    import torch.distributed as dist
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from torch_dist_worker import one_rank_planner
    comm.init_distributed("nccl", init_method=f"file://{tmp_path}/store",
                          rank=0, world_size=1)
    try:
        cfg = GPT2Config(vocab_size=250, n_positions=256, n_embd=128,
                         n_layer=2, n_head=2)
        ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (3, 2, 2, 128))
        runs = {}
        for stage in (0, 1, 2, 3):
            with one_rank_planner():
                engine = deepspeed_tpu_torch.initialize(
                    model=GPT2Model(cfg), config={
                        "train_batch_size": 4,
                        "train_micro_batch_size_per_gpu": 2,
                        "gradient_accumulation_steps": 2,
                        "optimizer": {"type": "adamw",
                                      "params": {"lr": 1e-3}},
                        "gradient_clipping": 1.0, "bf16": {"enabled": True},
                        "zero_optimization": {
                            "stage": stage,
                            "stage3_param_persistence_threshold": 1000},
                        "steps_per_print": 0})[0]
            assert engine._stage == stage
            losses = [engine.train_batch(batch={"input_ids": b}).item()
                      for b in ids]
            n = len(engine._names)
            runs[stage] = (losses,
                           [engine.whole_master(i).clone() for i in range(n)],
                           [engine.whole(i, m).clone() for i, m in
                            enumerate(engine.opt_state.mu)],
                           [engine.whole(i, v).clone() for i, v in
                            enumerate(engine.opt_state.nu)])
            del engine
        for stage in (1, 2, 3):
            assert runs[stage][0] == runs[0][0]
            for part in (1, 2, 3):
                assert all(torch.equal(a, b) for a, b in
                           zip(runs[stage][part], runs[0][part]))
    finally:
        dist.destroy_process_group()
