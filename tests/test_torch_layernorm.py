"""The port's LayerNorm (K6's plain versions and the ``norm_impl`` routing) vs
the JAX package, on the CPU at small sizes.

The JAX side runs its Pallas kernel (``layer_norm(impl="pallas")``) in
interpret mode and differentiates it with ``jax.vjp`` (its custom VJP: the dx
kernel plus the XLA dscale/dbias sums). The port's wrappers take the plain
versions on a CPU tensor; K6 itself runs only on the card, in
``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vitef_tpu.ops.layernorm import layer_norm as jax_layer_norm
from vitef_tpu_torch.models import build_model
from vitef_tpu_torch.models.norms import LayerNorm, RMSNorm, build_norm
from vitef_tpu_torch.ops import layer_norm, layer_norm_bwd_dx
from vitef_tpu_torch.ops.layernorm import (layer_norm_bwd_dx_reference, layer_norm_reference,
                                           layer_norm_stats_reference)

# (rows as a leading shape, E, bias, dtype): rows not a multiple of the JAX
# wrapper's 256-row block, so its padding is exercised.
CASES = [((3, 37), 64, True, "float32"), ((2, 45), 32, False, "float32"),
         ((3, 37), 64, True, "bfloat16")]
# float32: only the order of summation differs. bfloat16: both round one
# float32 result to bfloat16 (2^-8 relative), which moves a value of |x| < 4
# by at most one step of 2^-6.
TOL = {"float32": dict(atol=2e-5, rtol=1e-4), "bfloat16": dict(atol=3e-2, rtol=1e-2)}


def _inputs(lead, e, bias, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(*lead, e)) * 2 + 0.5).astype(np.float32)
    w = rng.normal(size=(e,)).astype(np.float32)
    b = rng.normal(size=(e,)).astype(np.float32) if bias else None
    g = rng.normal(size=(*lead, e)).astype(np.float32)
    return x, w, b, g


def _close(out, ref, dtype):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **TOL[dtype])


@pytest.mark.parametrize("lead,e,bias,dtype", CASES, ids=["f32_bias", "f32_nobias", "bf16"])
def test_forward_and_gradients_match_jax_kernel(lead, e, bias, dtype):
    x, w, b, g = _inputs(lead, e, bias, seed=e + len(lead))
    jdt = jnp.dtype(dtype)

    def f(x, w, b):
        return jax_layer_norm(x, w, b, eps=1e-12, impl="pallas")

    args = [jnp.asarray(x, jdt), jnp.asarray(w), None if b is None else jnp.asarray(b)]
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(f, *args)
        ref_dx, ref_dw, ref_db = vjp(jnp.asarray(g, jdt))

    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = None if b is None else torch.from_numpy(b).requires_grad_()
    out = layer_norm(xt, wt, bt, 1e-12, impl="kernel")  # the plain version on the CPU
    assert out.dtype == tdt and out.shape == xt.shape
    gt = torch.from_numpy(g).to(tdt)
    grads = torch.autograd.grad(out, [t for t in (xt, wt, bt) if t is not None], gt)
    _close(out.detach(), ref, dtype)
    _close(grads[0], ref_dx, dtype)
    _close(grads[1], ref_dw, dtype)
    assert grads[1].dtype == torch.float32
    if b is not None:
        _close(grads[2], ref_db, dtype)

    # K6's dx entry point from the saved statistics, the kernel's own algebra.
    mean, rstd = layer_norm_stats_reference(xt.detach(), 1e-12)
    assert mean.shape == tuple(lead) and mean.dtype == torch.float32
    dx = layer_norm_bwd_dx(gt, xt.detach(), wt.detach(), mean, rstd)
    assert dx.dtype == tdt
    _close(dx, ref_dx, dtype)


def test_dx_reference_equals_autograd_of_plain_version():
    """Both in float32 (the plain versions compute in float32 whatever the
    input), so they differ by rounding only."""
    x, w, b, g = map(torch.from_numpy, _inputs((5, 9), 48, True, seed=1))
    xt = x.requires_grad_()
    (want,) = torch.autograd.grad(layer_norm_reference(xt, w, b, 1e-6), xt, g)
    mean, rstd = layer_norm_stats_reference(x.detach(), 1e-6)
    got = layer_norm_bwd_dx_reference(g, x.detach(), w, mean, rstd)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6, rtol=1e-5)


def test_constant_rows_stay_finite_at_eps_1e_12():
    """Two-pass float32 statistics: a constant bfloat16 row normalises to 0."""
    x = torch.full((4, 64), 3.0, dtype=torch.bfloat16)
    out = layer_norm(x, torch.ones(64), torch.zeros(64), 1e-12, impl="kernel")
    assert torch.equal(out, torch.zeros_like(out))


VIT = {"implementation": "vit", "model_name": "tiny", "patch_size": 8,
       "image_dim": (3, 32, 32), "finetuning": True, "n_classes": 10}
LLAMA = {"implementation": "llama", "model_name": "tiny", "seq_len": 16}


def test_unknown_norm_impl_raises_when_built():
    with pytest.raises(ValueError, match="bogus"):
        build_model({**VIT, "norm_impl": "bogus"}, device="cpu")
    with pytest.raises(ValueError, match="bogus"):
        build_norm(8, True, "rms", 1e-6, device="cpu", impl="bogus")


@pytest.mark.parametrize("impl", ["pallas", "kernel", "xla"])
def test_norm_impl_on_cpu_gives_the_plain_result(impl):
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 3, 32, 32)).astype(np.float32))
    want = build_model({**VIT, "norm_impl": "plain"}, device="cpu")
    got = build_model({**VIT, "norm_impl": impl}, device="cpu")
    assert all(m.impl == {"pallas": "kernel", "xla": "plain"}.get(impl, impl)
               for m in got.module.modules() if isinstance(m, LayerNorm))
    with torch.inference_mode():
        assert torch.equal(got.apply(x), want.apply(x))


def test_rms_norm_ignores_norm_impl():
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 100, size=(2, 16)))
    plain = build_model({**LLAMA, "norm_impl": "plain"}, device="cpu")
    kernel = build_model({**LLAMA, "norm_impl": "kernel"}, device="cpu")
    assert isinstance(kernel.module.blocks[0].attn_norm, RMSNorm)
    with torch.inference_mode():
        assert torch.equal(kernel.apply(tokens), plain.apply(tokens))
