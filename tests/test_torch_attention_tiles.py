"""The attention forwards' plain versions vs the JAX kernels at the tensor-core
tiles' edges, on the CPU.

K1 and K4 compute on the card in 64-row query tiles of four 16-row warp
fragments and 64-key tiles, so lengths of 16, 17, 64, 65 and 129 put a row or
a key just inside or just past a tile. Their plain versions are what
``chip_smoke.py`` holds the kernels to on the card; here they are held, in
float32 on seeded numpy inputs, to the JAX package's kernels in Pallas
interpret mode at exactly those lengths: ``packed_mha_reference`` to
``fused_mha_packed`` (head width 64, non-causal, causal and key-masked) and
``attention_reference`` to ``flash_attention``. Also: a library is rebuilt
when a shared ``csrc/*.cuh`` header is newer than it.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vitef_tpu.ops import attention as jax_attention
from vitef_tpu_torch.ops import _build
from vitef_tpu_torch.ops import attention as A

# fp32 parity: both sides compute the same float32 algorithm; only the order
# of summation differs (as tests/test_torch_ops.py).
ATOL, RTOL = 2e-5, 1e-4
N, H, D = 2, 2, 64
TILE_EDGES = (16, 17, 64, 65, 129)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _packed(l, seed, n=N):
    rng = np.random.default_rng(seed)
    qkv = (rng.normal(size=(n, l, 3 * H * D)) * 0.5).astype(np.float32)
    bias = (rng.normal(size=(3 * H * D,)) * 0.1).astype(np.float32)
    return qkv, bias


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("l", TILE_EDGES)
def test_packed_mha_reference_at_tile_edges(l, causal):
    qkv, bias = _packed(l, seed=100 + l)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_attention.fused_mha_packed(
            jnp.asarray(qkv), H, causal, bias=jnp.asarray(bias)))
    plain = A.packed_mha_reference(_t(qkv), H, causal=causal, bias=_t(bias))
    np.testing.assert_allclose(plain.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("l,causal", [(17, True), (129, False)])
def test_masked_packed_mha_reference_at_tile_edges(l, causal):
    """Left padding: a full sequence, a ragged one and an empty one; compared
    on the rows that see a valid key (the others are finite but undefined)."""
    lengths = (l, l - 16, 0)
    qkv, bias = _packed(l, seed=200 + l, n=len(lengths))
    mask = np.zeros((len(lengths), l), bool)
    for i, length in enumerate(lengths):
        mask[i, l - length:] = True
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_attention.fused_mha_packed(
            jnp.asarray(qkv), H, causal=causal, bias=jnp.asarray(bias),
            key_mask=jnp.asarray(mask)))
    plain = A.packed_mha_reference(_t(qkv), H, causal=causal, bias=_t(bias),
                                   key_mask=_t(mask)).numpy()
    rows = np.cumsum(mask, axis=1) > 0 if causal else \
        np.broadcast_to(mask.any(axis=1, keepdims=True), mask.shape)
    assert (~rows).any() and rows.any()
    np.testing.assert_allclose(plain[rows], ref[rows], atol=ATOL, rtol=RTOL)
    assert np.isfinite(plain).all()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("l", (16, 65, 129))
def test_attention_reference_at_tile_edges(l, causal):
    """K4's plain version; the JAX kernel pads L to its 128-row blocks."""
    rng = np.random.default_rng(300 + l)
    q, k, v = ((rng.normal(size=(N, H, l, D)) * 0.5).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_attention.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, impl="pallas"))
    plain = A.attention_reference(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(plain.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_build_is_stale_when_a_header_is_newer(monkeypatch, tmp_path):
    """K1 and K4 share attn_fwd_mma.cuh and mma_sync.cuh: a library is stale
    when any csrc/*.cuh, not only its own .cu, is newer than it."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    for name in ("k.cu", "shared.cuh", "other.cuh"):
        (csrc / name).write_text("")
    lib = build / "libk.so"
    assert _build._stale("k")                     # never built
    lib.write_text("")
    for name in ("k.cu", "shared.cuh", "other.cuh"):
        os.utime(csrc / name, (1_000_000, 1_000_000))
    os.utime(lib, (2_000_000, 2_000_000))
    assert not _build._stale("k")
    for name in ("shared.cuh", "other.cuh", "k.cu"):
        os.utime(csrc / name, (3_000_000, 3_000_000))
        assert _build._stale("k"), f"a newer {name} did not make the library stale"
        os.utime(csrc / name, (1_000_000, 1_000_000))
    assert not _build._stale("k")
