"""The packed attention backward's plain version vs the JAX kernels at the
tensor-core tiles' edges, on the CPU, causal and not.

K2 and K3 compute on the card in 64-row query tiles and 64-key tiles of
16-row warp fragments, so lengths of 17, 65 and 129 put a row or a key just
past a tile. Their plain version, ``packed_mha_bwd_reference``, is what
``chip_smoke.py`` holds them to on the card; here it is held, in float32 on
seeded numpy inputs, to ``jax.grad`` of the JAX package's
``fused_mha_packed`` in Pallas interpret mode: causal at 17, 65 and 129
(the JAX package's full-L kernel in its causal mode), causal at 512 (its
block-triangular causal kernel, taken when L % 256 == 0 and L >= 512) and
non-causal at 17 and 129. At head width 80 (ViT-H/14, whose K2 and K3 tiles
hold 80 columns): causal at 17, non-causal at 129 and at ViT-H/14's 257. At
head width 128 (Llama-3.1-8B, whose K2 and K3 tiles hold 128 columns and
read K and V from shared memory at each use): causal at 17, causal at 512
(the block-triangular kernel, as the 8B packed training route at 8 x 512
takes it) and non-causal at 129.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vitef_tpu.ops import attention as jax_attention
from vitef_tpu_torch.ops import attention as A

N, H, D = 2, 2, 64
# Both sides run the same float32 algebra; sums are taken in another order
# (the tolerance of test_packed_mha_bwd_matches_jax_kernel).
TOL = dict(atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("l,causal,d", [(17, True, D), (65, True, D), (129, True, D),
                                        (512, True, D), (17, False, D), (129, False, D),
                                        (17, True, 80), (129, False, 80), (257, False, 80),
                                        (17, True, 128), (512, True, 128), (129, False, 128)],
                         ids=["causal17", "causal65", "causal129", "causal512_blocked",
                              "full17", "full129", "d80_causal17", "d80_full129",
                              "d80_full257", "d128_causal17", "d128_causal512_blocked",
                              "d128_full129"])
def test_packed_mha_bwd_reference_matches_jax_kernels(l, causal, d):
    rng = np.random.default_rng(400 + l + (d - D))  # d = 64 keeps its seeds
    e = H * d
    qkv = (rng.normal(size=(N, l, 3 * e)) * 0.5).astype(np.float32)
    bias = (rng.normal(size=(3 * e,)) * 0.3).astype(np.float32)
    g = rng.normal(size=(N, l, e)).astype(np.float32)
    assert (jax_attention._causal_q_block(l, causal) is not None) == (l == 512)

    def loss(qkv, bias):
        return (jax_attention.fused_mha_packed(qkv, H, causal, bias=bias) * g).sum()

    with pltpu.force_tpu_interpret_mode():
        ref_dqkv, ref_db = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(bias))
    dqkv, db = A.packed_mha_bwd_reference(torch.from_numpy(qkv), torch.from_numpy(bias),
                                          torch.from_numpy(g), H, causal=causal)
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(ref_dqkv), **TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(ref_db), **TOL)
