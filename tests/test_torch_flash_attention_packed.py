"""K1, the port's packed flash attention forward, held against the JAX
package's packed Pallas kernel (run in interpret mode on the CPU, as
tests/unit/test_pallas_flash_packed.py runs it).

On the CPU the port's wrapper takes the kernel's plain PyTorch version;
tests/test_torch_cuda_kernels.py holds the CUDA kernel itself against that
plain version on a GPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.pallas import flash_attention_packed as jfa
from deepspeed_tpu_torch.ops import kernel_build
from deepspeed_tpu_torch.ops.kernels import flash_attention_packed as tfa

B, T, H, D = 2, 256, 4, 64
CASES = [(True, None), (True, 96), (False, None)]


def _inputs(seed=0, b=B, t=T, h=H, d=D):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, t, h * d)) * 0.3).astype(np.float32)
            for _ in range(3)]


def _unpack_lse(lse, b=B, t=T, h=H, d=D):
    """The TPU kernel's lane-packed lse [B, T, ng*128] as [B, H, T]."""
    gh = 128 // d
    lse = np.asarray(lse).reshape(b, t, h // gh, 128)[..., :gh]
    return lse.reshape(b, t, h).transpose(0, 2, 1)


@pytest.mark.parametrize("causal,window", CASES)
def test_plain_matches_jax_kernel_f32(causal, window):
    q, k, v = _inputs()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jfa.packed_flash_attention(jq, jk, jv, H, causal=causal,
                                      window=window, interpret=True)
    _, res = jfa._pf_fwd(jq, jk, jv, H, causal, None, window, True,
                         (512, 512))
    before = tfa.packed_flash_attention_fwd.launches
    out, lse = tfa.packed_flash_attention_fwd(
        *map(torch.from_numpy, (q, k, v)), H, causal=causal, window=window)
    assert tfa.packed_flash_attention_fwd.launches == before  # CPU: plain
    assert out.shape == (B, T, H * D) and lse.shape == (B, H, T)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), _unpack_lse(res[4]),
                               atol=2e-5, rtol=2e-5)


def test_plain_matches_jax_kernel_bf16():
    """The rounding points in the working type: P rounded to bf16 before
    P.V and a bf16 output, within the card check's bf16 tolerance."""
    q, k, v = _inputs(seed=3)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jfa.packed_flash_attention(jq, jk, jv, H, causal=True,
                                      interpret=True)
    got = tfa.packed_flash_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


def test_strided_qkv_views_match_contiguous():
    """The model hands the kernel the column thirds of one [B, T, 3HD]
    projection; the result must not depend on the strides."""
    q, k, v = _inputs(seed=1)
    qkv = torch.from_numpy(np.concatenate([q, k, v], axis=-1))
    views = qkv.split(H * D, dim=-1)
    assert views[0].stride() == (T * 3 * H * D, 3 * H * D, 1)
    got = tfa.packed_flash_attention_fwd(*views, H, window=96)
    want = tfa.packed_flash_attention_fwd(
        *map(torch.from_numpy, (q, k, v)), H, window=96)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_supported_agrees_with_jax():
    for t in (64, 128, 200, 256, 4096, 4224):
        for d in (1, 8, 16, 48, 64, 128, 256):
            for h in (1, 2, 3, 4, 12, 16):
                for causal in (True, False):
                    for window in (None, 0, 96):
                        assert tfa.supported(t, d, h, causal, window) == \
                            jfa.supported(t, d, h, causal, window), \
                            (t, d, h, causal, window)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = map(torch.from_numpy, _inputs(t=96))
    with pytest.raises(ValueError, match="does not support"):
        tfa.packed_flash_attention_fwd(q, k, v, H)
    q, k, v = map(torch.from_numpy, _inputs())
    with pytest.raises(ValueError, match="does not support"):
        tfa.packed_flash_attention_fwd(q, k, v, H, causal=False, window=8)
    with pytest.raises(TypeError):
        tfa.packed_flash_attention_fwd(q.double(), k.double(), v.double(), H)
    with pytest.raises(ValueError, match="one shape"):
        tfa.packed_flash_attention_fwd(q, k[:, :128], v, H)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp_ext
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernel_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    assert {"flash_attention_fwd", "flash_attention_bwd"} <= \
        set(kernel_build.sources())
    path = kernel_build.library_path("flash_attention_fwd")
    assert path.parent == tmp_path and path.suffix == ".so"
    with pytest.raises(kernel_build.KernelBuildError, match="nvcc"):
        kernel_build.build()


def test_resource_usage_reads_the_ptxas_report(monkeypatch):
    """Registers and spills per kernel instance, from nvcc's -Xptxas -v
    report (its log as the build keeps it)."""
    entry = "_ZN55_GLOBAL__N__7deaa8f6_22_flash_attention_fwd_cu_6cce14ff10"
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{entry}fwd_kernelI13"
        "__nv_bfloat16Li64ELb1EEEvNS_7FwdArgsE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{entry}dkdv_kernelIfLi256"
        "ELb0EEEvNS_7BwdArgsE' for 'sm_90a'",
        "    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers"])
    monkeypatch.setitem(kernel_build._logs, "flash_attention_fwd", log)
    assert kernel_build.resource_usage("flash_attention_fwd") == {
        "fwd_kernel<bf16,64,exact>": (96, 0, 0),
        "dkdv_kernel<f32,256,masked>": (255, 8, 12)}
    assert kernel_build.resource_usage("flash_attention_bwd") == {}


def test_resource_usage_reads_the_report_kept_beside_the_library(
        monkeypatch, tmp_path):
    """A library built by an earlier run: its ptxas report is read from the
    ``.log`` that the build keeps beside it."""
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path)
    monkeypatch.delitem(kernel_build._logs, "flash_attention_bwd",
                        raising=False)
    assert kernel_build.resource_usage("flash_attention_bwd") == {}
    entry = "_ZN55_GLOBAL__N__7deaa8f6_22_flash_attention_bwd_cu_6cce14ff10"
    kept = kernel_build.library_path("flash_attention_bwd").with_suffix(".log")
    kept.write_text("\n".join([
        f"ptxas info    : Compiling entry function '{entry}mma_dq_kernelI6"
        "__halfLi128ELb1EEEvNS_7BwdArgsE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 166 registers, used 1 barriers"]))
    assert kernel_build.resource_usage("flash_attention_bwd") == {
        "mma_dq_kernel<f16,128,exact>": (166, 0, 0)}
