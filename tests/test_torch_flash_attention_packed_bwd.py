"""K2, the port's packed flash attention backward, held against the JAX
package's custom VJP of ``packed_flash_attention`` (its Pallas backward run
in interpret mode on the CPU, as tests/unit/test_pallas_flash_packed.py
runs it).

On the CPU the port's wrapper takes the kernel's plain PyTorch version;
tests/test_torch_cuda_kernels.py holds the CUDA kernel itself against that
plain version on a GPU."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.pallas import flash_attention_packed as jfa
from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as tfa

B, T, H, D = 2, 256, 4, 64
CASES = [(True, None), (True, 96), (False, None)]
# f32: the kernel's sums run in another order than the TPU kernel's
# (64-row tiles against 256-row blocks), nothing else differs
F32_TOL = 5e-5


def _inputs(seed=0):
    """q, k, v (std 0.3) and the output gradient g (std 1), [B, T, H*D]."""
    rng = np.random.default_rng(seed)
    q, k, v = [(rng.standard_normal((B, T, H * D)) * 0.3).astype(np.float32)
               for _ in range(3)]
    g = rng.standard_normal((B, T, H * D)).astype(np.float32)
    return q, k, v, g


def _unpack_lse(lse):
    """The TPU kernel's lane-packed lse [B, T, ng*128] as [B, H, T]."""
    gh = 128 // D
    lse = np.asarray(lse).reshape(B, T, H // gh, 128)[..., :gh]
    return lse.reshape(B, T, H).transpose(0, 2, 1)


def _jax_grads(q, k, v, g, causal, window, dtype=jnp.float32):
    jq, jk, jv, jg = (jnp.asarray(x, dtype) for x in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: jfa.packed_flash_attention(
        a, b, c, H, causal=causal, window=window, interpret=True),
        jq, jk, jv)
    return [np.asarray(x, np.float32) for x in vjp(jg)]


@pytest.mark.parametrize("causal,window", CASES)
def test_plain_bwd_matches_jax_kernel_f32(causal, window):
    """The same q, k, v, O, lse and dO into the JAX kernel's backward
    (``_pf_bwd``) and into K2's wrapper, which takes the plain version."""
    q, k, v, g = _inputs()
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, res = jfa._pf_fwd(jq, jk, jv, H, causal, None, window, True,
                           (512, 512))
    want = jfa._pf_bwd(H, causal, None, window, True, (512, 512), res, jg)
    qkv = torch.from_numpy(np.concatenate([q, k, v], axis=-1))
    before = tfa.packed_flash_attention_bwd.launches
    dqkv = tfa.packed_flash_attention_bwd(
        qkv, torch.from_numpy(np.array(out)),
        torch.from_numpy(_unpack_lse(res[4]).copy()), torch.from_numpy(g), H,
        causal=causal, window=window)
    assert tfa.packed_flash_attention_bwd.launches == before  # CPU: plain
    assert dqkv.shape == (B, T, 3 * H * D) and dqkv.dtype == torch.float32
    for got, w in zip(dqkv.split(H * D, dim=-1), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("causal,window", CASES)
def test_function_grad_is_one_dqkv_equal_to_jax(causal, window):
    """Autograd through ``PackedFlashAttention`` (K1 then K2, plain on the
    CPU) gives one [B, T, 3HD] gradient equal to the JAX grads of q, k, v."""
    q, k, v, g = _inputs(seed=1)
    want = _jax_grads(q, k, v, g, causal, window)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).requires_grad_()
    out = tfa.packed_flash_attention_qkv(qkv, H, causal=causal,
                                         window=window)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(qkv.grad.numpy(), np.concatenate(want, -1),
                               atol=F32_TOL, rtol=F32_TOL)


def test_function_grad_bf16_matches_jax():
    """The rounding points in the working type (p and ds rounded to bf16
    before their products, bf16 outputs). Tolerance 2e-2 absolute on
    gradients of std ~0.3: bf16 keeps 8 bits, and the forward's bf16 output
    enters delta, so one rounding step either way moves a gradient by a
    few 1e-3."""
    q, k, v, g = _inputs(seed=3)
    want = _jax_grads(q, k, v, g, True, None, jnp.bfloat16)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).to(torch.bfloat16)
    qkv.requires_grad_()
    out = tfa.packed_flash_attention_qkv(qkv, H)
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert qkv.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(qkv.grad.float().numpy(),
                               np.concatenate(want, -1), atol=2e-2)


def test_requires_grad_follows_input_and_backward_takes_plain(monkeypatch):
    """``out.requires_grad`` follows ``qkv.requires_grad``; on the CPU the
    backward runs K2's plain version, once per backward."""
    calls = []
    plain = tfa.packed_flash_attention_bwd_plain

    def counting(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(tfa, "packed_flash_attention_bwd_plain", counting)
    q, k, v, _ = _inputs(seed=2)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1))
    assert not tfa.packed_flash_attention_qkv(qkv, H).requires_grad
    out = tfa.packed_flash_attention_qkv(qkv.requires_grad_(), H)
    assert out.requires_grad
    assert type(out.grad_fn).__name__ == "PackedFlashAttentionBackward"
    out.sum().backward()
    assert len(calls) == 1 and qkv.grad.shape == qkv.shape
    with torch.no_grad():
        assert not tfa.packed_flash_attention_qkv(qkv, H).requires_grad


def test_bwd_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v, g = _inputs()
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1))
    out, lse = tfa.packed_flash_attention_fwd(*qkv.split(H * D, -1), H)
    with pytest.raises(ValueError, match=r"\[B, T, 3\*H\*D\]"):
        tfa.packed_flash_attention_bwd(qkv[..., :-1], out, lse,
                                       torch.from_numpy(g), H)
    with pytest.raises(ValueError, match="do not match"):
        tfa.packed_flash_attention_bwd(qkv, out, lse[:, :2],
                                       torch.from_numpy(g), H)
    with pytest.raises(TypeError, match="dout"):
        tfa.packed_flash_attention_bwd(qkv, out, lse,
                                       torch.from_numpy(g).double(), H)
    with pytest.raises(ValueError, match="does not support"):
        tfa.packed_flash_attention_bwd(qkv, out, lse, torch.from_numpy(g),
                                       H, causal=False, window=8)
    with pytest.raises(ValueError, match="one device"):
        tfa.packed_flash_attention_bwd(qkv, out, lse.to("meta"),
                                       torch.from_numpy(g), H)
