"""The flash attention kernels' plain versions vs the JAX package at the
tensor-core tiles' edges, on the CPU, causal and not.

K5 computes on the card in 64-row query tiles and 64-key tiles of 16-row
warp fragments (its bfloat16 path on the backward core of
``attn_bwd_mma.cuh``), so lengths of 17, 65 and 129 put a row or a key just
past a tile. Its plain version, ``flash_bwd_reference``, is what
``chip_smoke.py`` holds it to on the card; here it is held, in float32 on
seeded numpy inputs at head width 64, to ``jax.vjp`` of the JAX package's
``flash_attention`` in Pallas interpret mode, through both of the JAX
backward's branches: its fused kernel, and (with ``_BWD_VMEM_BUDGET`` set
to 0) the XLA recompute it takes past its VMEM budget.

The float32 kernels also run at head widths 8 (PatchTST's float32 default)
and 128. There the plain versions (``attention_reference``,
``flash_bwd_reference``) and the kernels' tile algebra written out in
PyTorch (64-row query and key tiles, the online softmax in exp2 units with
each row's log2-sum-exp, the backward's dQ pass over query tiles and its
dK/dV pass over key tiles, at d = 128 in two 64-column parts, each
recomputing S^T and dP^T whole) are held to the JAX ``_flash_kernel`` and,
through ``jax.vjp``, ``_flash_bwd_kernel`` (interpret mode) at L 1, 63 and
200.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vitef_tpu.ops import attention as jax_attention
from vitef_tpu_torch.ops import attention as A

N, H, D = 1, 2, 64
# Both sides run the same float32 algebra; sums are taken in another order
# (the tolerance of tests/test_torch_attention_bwd_tiles.py).
TOL = dict(atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("branch", ["kernel", "xla"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("l", [17, 65, 129])
def test_flash_bwd_reference_matches_jax_vjp(l, causal, branch, monkeypatch):
    if branch == "xla":
        monkeypatch.setattr(jax_attention, "_BWD_VMEM_BUDGET", 0)
    rng = np.random.default_rng(500 + l)
    q, k, v = ((rng.normal(size=(N, H, l, D)) * 0.5).astype(np.float32) for _ in range(3))
    g = rng.normal(size=(N, H, l, D)).astype(np.float32)

    def f(q, k, v):
        return jax_attention.flash_attention(q, k, v, causal=causal, impl="pallas")

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v)))
        refs = vjp(jnp.asarray(g))
    launches = A.flash_bwd.launches
    grads = A.flash_bwd(*(torch.from_numpy(t) for t in (q, k, v, g)), None, None,
                        causal=causal)
    assert A.flash_bwd.launches == launches  # the CPU takes the plain version
    for name, ours, ref in zip("qkv", grads, refs):
        assert ours.shape == (N, H, l, D) and ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL, err_msg=f"d{name}")


# float32 at d = 8 and 128: both sides float32, sums in another order.
F32_TOL = dict(atol=2e-5, rtol=1e-4)
TILE = 64                               # K4's and K5's query and key tiles
LOG2E = 1.4426950408889634


def _f32_inputs(l: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    q, k, v = ((rng.normal(size=(N, H, l, d)) * 0.5).astype(np.float32) for _ in range(3))
    return q, k, v, rng.normal(size=(N, H, l, d)).astype(np.float32)


def tiled_flash_fwd(q, k, v, causal: bool):
    """K4's float32 algebra tile by tile: per 64-row query tile, the key
    tiles it may see, scores scaled by log2(e)/sqrt(d), the running max and
    sum in exp2 units, O rescaled and accumulated. Returns (out, each row's
    log2-sum-exp)."""
    l, d = q.shape[2], q.shape[3]
    scale = np.float32(LOG2E / math.sqrt(d))
    out, lse = torch.empty_like(q), torch.empty(q.shape[:3])
    for q0 in range(0, l, TILE):
        q1 = min(q0 + TILE, l)
        rows = torch.arange(q0, q1)[:, None]
        m = torch.full(q.shape[:2] + (q1 - q0,), -math.inf)
        s = torch.zeros_like(m)
        o = torch.zeros(q.shape[:2] + (q1 - q0, d))
        for k0 in range(0, q1 if causal else l, TILE):
            k1 = min(k0 + TILE, l)
            sc = q[:, :, q0:q1] @ k[:, :, k0:k1].transpose(-1, -2) * scale
            if causal:
                sc = sc.masked_fill(torch.arange(k0, k1)[None, :] > rows, -math.inf)
            mx = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(sc - mx[..., None])
            s = s * alpha + p.sum(-1)
            o = o * alpha[..., None] + p @ v[:, :, k0:k1]
            m = mx
        out[:, :, q0:q1] = o / s[..., None]
        lse[:, :, q0:q1] = m + torch.log2(s)
    return out, lse


def tiled_flash_bwd(q, k, v, g, out, lse, causal: bool):
    """K5's float32 algebra tile by tile: delta = rowsum(G O); the dQ pass
    over query tiles (each key tile's dS K added to the running sum); the
    dK/dV pass over key tiles and, at d = 128, two 64-column parts of dK and
    dV, each recomputing S^T and dP^T whole from the rows' (lse, delta)."""
    l, d = q.shape[2], q.shape[3]
    scale, ds_scale = np.float32(LOG2E / math.sqrt(d)), np.float32(1 / math.sqrt(d))
    delta = (g * out).sum(-1)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    def ds_of(i0, i1, k0, k1):
        s = q[:, :, i0:i1] @ k[:, :, k0:k1].transpose(-1, -2)
        dp = g[:, :, i0:i1] @ v[:, :, k0:k1].transpose(-1, -2)
        p = torch.exp2(s * scale - lse[:, :, i0:i1, None])
        if causal:
            p = p.masked_fill(torch.arange(k0, k1)[None, :] > torch.arange(i0, i1)[:, None], 0)
        return p, p * (dp - delta[:, :, i0:i1, None]) * ds_scale

    for q0 in range(0, l, TILE):
        q1 = min(q0 + TILE, l)
        for k0 in range(0, q1 if causal else l, TILE):
            k1 = min(k0 + TILE, l)
            dq[:, :, q0:q1] += ds_of(q0, q1, k0, k1)[1] @ k[:, :, k0:k1]
    cols = min(d, 64)
    for k0 in range(0, l, TILE):
        k1 = min(k0 + TILE, l)
        for c0 in range(0, d, cols):
            c = slice(c0, c0 + cols)
            for i0 in range(k0 if causal else 0, l, TILE):
                i1 = min(i0 + TILE, l)
                p, ds = ds_of(i0, i1, k0, k1)
                dv[:, :, k0:k1, c] += p.transpose(-1, -2) @ g[:, :, i0:i1, c]
                dk[:, :, k0:k1, c] += ds.transpose(-1, -2) @ q[:, :, i0:i1, c]
    return dq, dk, dv


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("l", [1, 63, 200])
@pytest.mark.parametrize("d", [8, 128])
def test_flash_fwd_f32_matches_jax_kernel(d, l, causal):
    q, k, v, _ = _f32_inputs(l, d, 600 + d + l)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_attention.flash_attention(
            *(jnp.asarray(t) for t in (q, k, v)), causal=causal, impl="pallas"))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    launches = A.flash_attention.launches
    plain = A.flash_attention(tq, tk, tv, causal=causal, impl="kernel")
    assert A.flash_attention.launches == launches  # the CPU takes the plain version
    tiled, lse = tiled_flash_fwd(tq, tk, tv, causal)
    for name, ours in (("plain", plain), ("tiles", tiled)):
        assert ours.shape == (N, H, l, d) and ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), ref, **F32_TOL, err_msg=name)
    scores = (tq @ tk.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        scores = scores.masked_fill(torch.ones(l, l, dtype=torch.bool).triu(1), -math.inf)
    np.testing.assert_allclose(lse.numpy(), (torch.logsumexp(scores, -1) / math.log(2)).numpy(),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("l", [1, 63, 200])
@pytest.mark.parametrize("d", [8, 128])
def test_flash_bwd_f32_matches_jax_kernel(d, l, causal):
    q, k, v, g = _f32_inputs(l, d, 700 + d + l)

    def f(q, k, v):
        return jax_attention.flash_attention(q, k, v, causal=causal, impl="pallas")

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v)))
        refs = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    launches = A.flash_bwd.launches
    plain = A.flash_bwd(tq, tk, tv, tg, None, None, causal=causal)
    assert A.flash_bwd.launches == launches
    out, lse = tiled_flash_fwd(tq, tk, tv, causal)
    tiled = tiled_flash_bwd(tq, tk, tv, tg, out, lse, causal)
    for route, grads in (("plain", plain), ("tiles", tiled)):
        for name, ours, ref in zip("qkv", grads, refs):
            assert ours.shape == (N, H, l, d) and ours.dtype == torch.float32
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **F32_TOL,
                                       err_msg=f"{route} d{name}")
