"""The flash attention backward's plain version vs the JAX package at the
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
"""

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
