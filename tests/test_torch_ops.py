"""Port ops vs the JAX package: the packed attention kernel's plain version and
its CPU route, attention_reference with weights, multi_head_attention,
layer_norm, and the implementation policy.

The same numpy inputs (seeded) go through both packages. The JAX packed
kernel runs in Pallas interpret mode, as tests/test_ops.py runs it.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vitef_tpu.ops import attention as jax_attention
from vitef_tpu.ops.layernorm import layer_norm_xla
from vitef_tpu_torch.ops import attention as A
from vitef_tpu_torch.ops.common import resolve_impl
from vitef_tpu_torch.ops.layernorm import layer_norm

# fp32 parity: both sides compute the same float32 algorithm; only the order
# of summation differs.
ATOL, RTOL = 2e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _packed_inputs(n, h, l, d, seed=7):
    rng = np.random.default_rng(seed)
    e = h * d
    qkv = (rng.normal(size=(n, l, 3 * e)) * 0.5).astype(np.float32)
    bias = (rng.normal(size=(3 * e,)) * 0.1).astype(np.float32)
    return qkv, bias


@pytest.mark.parametrize("n,h,l,d,causal", [
    (2, 3, 13, 8, False),
    (2, 3, 13, 8, True),
    (2, 12, 197, 64, False),   # the ViT-B/16 attention shape
])
def test_packed_mha_matches_jax_kernel(n, h, l, d, causal):
    qkv, bias = _packed_inputs(n, h, l, d)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_attention.fused_mha_packed(
            jnp.asarray(qkv), h, causal, bias=jnp.asarray(bias)))
    plain = A.packed_mha_reference(_t(qkv), h, causal=causal, bias=_t(bias))
    np.testing.assert_allclose(plain.numpy(), ref, atol=ATOL, rtol=RTOL)

    launches = A.fused_mha_packed.launches
    routed = A.fused_mha_packed(_t(qkv), h, causal=causal, bias=_t(bias))
    np.testing.assert_allclose(routed.numpy(), ref, atol=ATOL, rtol=RTOL)
    assert A.fused_mha_packed.launches == launches, "the CPU route counted a launch"


@pytest.mark.parametrize("causal,kv_len", [(False, None), (True, None), (False, 9)])
def test_attention_reference_with_weights(causal, kv_len):
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 3, 11, 8)).astype(np.float32) for _ in range(3))
    ref_out, ref_w = jax_attention.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, kv_len=kv_len,
        return_weights=True)
    out, w = A.attention_reference(_t(q), _t(k), _t(v), causal=causal, kv_len=kv_len,
                                   return_weights=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("verbose", [False, True])
def test_multi_head_attention_matches_jax(verbose):
    rng = np.random.default_rng(5)
    n, l, e, h = 2, 17, 32, 4
    x = rng.normal(size=(n, l, e)).astype(np.float32)
    wq = (rng.normal(size=(e, 3 * e)) / np.sqrt(e)).astype(np.float32)   # JAX (in, out)
    bq = (rng.normal(size=(3 * e,)) * 0.1).astype(np.float32)
    wo = (rng.normal(size=(e, e)) / np.sqrt(e)).astype(np.float32)
    bo = (rng.normal(size=(e,)) * 0.1).astype(np.float32)
    ref = jax_attention.multi_head_attention(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(bq), jnp.asarray(wo), jnp.asarray(bo),
        n_heads=h, verbose=verbose)
    out = A.multi_head_attention(_t(x), _t(wq.T), _t(bq), _t(wo.T), _t(bo),
                                 n_heads=h, verbose=verbose)
    if verbose:
        (ref, ref_w), (out, w) = ref, out
        np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 7, 96)).astype(np.float32)
    w = rng.normal(size=(96,)).astype(np.float32)
    b = rng.normal(size=(96,)).astype(np.float32)
    ref = layer_norm_xla(jnp.asarray(x, dtype), jnp.asarray(w), jnp.asarray(b), 1e-12)
    out = layer_norm(_t(x).to(getattr(torch, dtype)), _t(w), _t(b), 1e-12)
    # bf16: both round the same float32 result once to bfloat16.
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=1e-5 if dtype == "float32" else 1e-2, rtol=RTOL)


@pytest.mark.parametrize("device,impl,seq_len,dtype,want", [
    ("cpu", "auto", 197, torch.bfloat16, "plain"),
    ("cpu", "kernel", 197, torch.bfloat16, "kernel"),
    ("cuda", "auto", 197, torch.bfloat16, "kernel"),
    ("cuda", "auto", 197, torch.float32, "plain"),
    ("cuda", "auto", 512, torch.float32, "kernel"),
    ("cuda", "auto", None, torch.bfloat16, "plain"),
    ("cuda", "xla", 197, torch.bfloat16, "plain"),
    ("cuda", "pallas", 197, torch.float32, "kernel"),
])
def test_resolve_impl_policy(device, impl, seq_len, dtype, want):
    assert resolve_impl(impl, torch.device(device), seq_len=seq_len, dtype=dtype) == want


def test_packed_mha_supported_gate():
    assert A.packed_mha_supported(197, 768, 12)      # ViT-B/16
    assert A.packed_mha_supported(577, 1024, 16)     # ViT-L at 384
    assert A.packed_mha_supported(257, 1280, 16)      # ViT-H/14: head width 80
    # K1 at head width 128 (Llama-3.1-8B's serving prefill) is inside the gate
    assert A.packed_mha_supported(257, 2048, 16)      # head width 128
    assert A.packed_mha_supported(578, 4096, 32)      # Llama-3.1-8B: the budget's last L
    assert not A.packed_mha_supported(579, 4096, 32)
    # a width K1 is not instantiated for stays outside the gate
    assert not A.packed_mha_supported(257, 1536, 16)  # head width 96
    # K1, K2 and K3 tile over keys: GPT-2's lengths and widths at d = 64 pass
    assert A.packed_mha_supported(1024, 768, 12)      # GPT-2 base
    assert A.packed_mha_supported(1, 768, 12)
    assert A.packed_mha_supported(1024, 1280, 20)     # GPT-2 large: 33.6 MB
    # past the JAX package's 40 MiB budget attention takes the flash kernels
    assert not A.packed_mha_supported(2048, 1280, 20)  # GPT-2 large, 2x its L: 92 MB
    assert not A.packed_mha_supported(1024, 2048, 32)  # Llama-1B: 46.1 MB


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No fallback: a build without a CUDA compiler raises instead of returning."""
    from vitef_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("packed_mha_fwd")
