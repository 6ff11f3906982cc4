"""The port's two computations of the paper's figures against the JAX
package, on the CPU in float32 at a small size: the loss-landscape surfaces
(``apps/plots/loss_landscape.py``) and the theoretical bounds with the token
radius (``apps/plots/theory.py``).

One tiny ViT is built in JAX (``attn_impl="xla"``, ``norm_impl="xla"``), its
LayerNorm weights and biases drawn from a seed, and carried into the port
with ``from_jax_params``; the same numpy batch goes through both packages.
The feature plane's random signs are JAX's, passed into the port's
``signs=``. (At the init's unit weights and zero biases ‖LN(x)‖ does not
depend on x but through eps, so the gradient that spans ln1's feature plane
is rounding noise in either package; a pretrained model's norms are not the
identity.)
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import apps.plots.loss_landscape as jax_ll
import apps.plots.theory as jax_theory
from vitef_tpu.models import build_model as jax_build_model
from vitef_tpu_torch.apps.plots import loss_landscape as ll
from vitef_tpu_torch.apps.plots import theory
from vitef_tpu_torch.models import build_model, from_jax_params

TINY = {"implementation": "vit", "model_name": "tiny", "patch_size": 16,
        "image_dim": (3, 32, 32), "pretrained": False, "finetuning": True, "n_classes": 10}
SEED = 42
# A 4 x 4 grid is one batch of the JAX package's lax.map(batch_size=16), so
# it compiles the vmapped surface once; the grid's centre, where the rate is
# 0/0, is checked on a 3 x 3 grid below.
RESOLUTION, GRID_RANGE, N_STEPS, LR = 4, 0.5, 4, 0.05
# Both packages compute the same float32 functions; the JAX side vmaps the
# grid (``lax.map(batch_size=16)``) and takes its PCA plane from sklearn's
# randomized solver, so the surfaces agree to float32 rounding, not bit for bit.
SURFACE_RTOL = 1e-5
TRAJ_RTOL = 1e-4


def _pair(config, seed=0):
    """(JAX model, port model) holding the same float32 parameters, the
    norms' weights in [0.5, 1.5) and their biases in [-0.1, 0.1)."""
    jm = jax_build_model({**config, "attn_impl": "xla", "norm_impl": "xla"},
                         key=jax.random.key(seed))
    rng = np.random.default_rng(seed)
    for block in jm.params["blocks"]:
        for norm in ("attn_norm", "ffn_norm"):
            e = block[norm]["weight"].shape
            block[norm] = {"weight": jnp.asarray(rng.uniform(0.5, 1.5, e), jnp.float32),
                           "bias": jnp.asarray(rng.uniform(-0.1, 0.1, e), jnp.float32)}
    tm = build_model(config, device="cpu")
    tm.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jm.params)))
    return jm, tm


@pytest.fixture(scope="module")
def tiny():
    jm, tm = _pair(TINY)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, size=(8,))
    return jm, tm, x, y


@pytest.mark.parametrize("comp", ["mha", "ln1", "fc1", "fc2"])
def test_rates_of_change_match_jax(tiny, comp):
    jm, tm, x, y = tiny
    args = dict(dataset_name="cifar10", batch_size=8, trainable_component=comp, block=0,
                n_steps=N_STEPS, lr=LR, resolution=RESOLUTION, grid_range=GRID_RANGE,
                seed=SEED)
    want = jax_ll.get_rates_of_change(**args, model=jm, batch=(jnp.asarray(x), jnp.asarray(y)))
    n_tokens = 1 + (32 // 16) ** 2
    signs = np.array(jnp.sign(jax.random.normal(jax.random.key(SEED), (1, n_tokens, 32))))
    got = ll.get_rates_of_change(**args, model=tm, batch=(x, y), device="cpu",
                                 signs=torch.from_numpy(signs))
    (wl, wf, wu, wv, wt), (gl, gf, gu, gv, gt) = want, got
    np.testing.assert_array_equal(gu, wu)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gl, np.asarray(wl), rtol=SURFACE_RTOL)
    np.testing.assert_allclose(gf, np.asarray(wf), rtol=SURFACE_RTOL)
    assert (gf > 0).all() and len(gt) == N_STEPS
    wt, gt = np.asarray(wt), np.asarray(gt)
    np.testing.assert_allclose(gt, wt, rtol=TRAJ_RTOL, atol=TRAJ_RTOL * np.abs(wt).max())


def test_default_signs_are_seeded(tiny):
    """Without ``signs=`` the feature plane's signs come from a torch
    Generator seeded with ``seed``: the same seed gives the same surfaces.
    At the grid's centre δ = 0 and the rate is 0/0: f(x + 0) - f(x) is
    exactly 0, so the port gives the floor 1e-8. (The JAX package's jitted
    f(x) and vmapped f(x + 0) round differently, and it gives that rounding
    over 1e-8 there: 105 on this ViT's fc1.)"""
    _, tm, x, y = tiny
    args = dict(dataset_name="cifar10", batch_size=8, trainable_component="fc1", block=1,
                n_steps=3, lr=LR, resolution=3, grid_range=GRID_RANGE, model=tm,
                batch=(x, y), device="cpu")
    first = ll.get_rates_of_change(**args, seed=1)
    again = ll.get_rates_of_change(**args, seed=1)
    signs = ll.draw_signs((1, 5, 32), 1)
    given = ll.get_rates_of_change(**args, seed=1, signs=signs)
    assert set(np.unique(signs.numpy())) == {-1.0, 1.0}
    for a, b, c in zip(first[:2], again[:2], given[:2]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert first[1][1, 1] == np.float32(1e-8) and (np.delete(first[1], 4) > 1e-3).all()


@pytest.mark.parametrize("comp", ["mha", "fc2", "ln1"])
def test_pca_plane_matches_sklearn_full(tiny, comp):
    """The port's exact PCA against sklearn's ``PCA(svd_solver="full")`` on
    the same trajectory: the same two unit components, sign rule included.
    On the trajectory in float64 they agree to 1e-7. sklearn on the float32
    trajectory itself (as the JAX package hands it over) is off by float32
    rounding over the gap between the singular values: within 5e-5 for mha
    and fc2, whose second one is 1e-2 of the first; ln1's is 2e-4 of it, and
    float32 does not resolve that component."""
    from sklearn.decomposition import PCA

    _, tm, x, y = tiny
    component = ll.Component(tm, 1, comp)
    params, _ = ll.sgd_trajectory(component, torch.from_numpy(x), torch.from_numpy(y),
                                  n_steps=6, lr=LR)
    dx, dy = ll.pca_plane(params)
    got = torch.stack([dx, dy]).numpy()
    exact = PCA(n_components=2, svd_solver="full").fit(params.double().numpy())
    np.testing.assert_allclose(got, exact.components_, atol=1e-7)
    if comp != "ln1":
        in_float32 = PCA(n_components=2, svd_solver="full").fit(params.numpy())
        np.testing.assert_allclose(got, in_float32.components_, atol=5e-5)
    assert abs(float(dx @ dy)) < 1e-6
    for d in (dx, dy):
        assert abs(float(d.norm()) - 1) < 1e-6
        assert float(d[d.abs().argmax()]) > 0


@pytest.fixture
def tiny_heads(monkeypatch):
    """The tiny preset's heads and width in both theory modules."""
    for module in (jax_theory, theory):
        monkeypatch.setitem(module.N_HEADS, "tiny", 2)
        monkeypatch.setitem(module.EMB_DIM, "tiny", 32)


def test_theory_bounds_match_jax(tiny, tiny_heads):
    jm, tm, _, _ = tiny
    want = [*jax_theory.norm_ub("tiny", 16, model=jm), *jax_theory.linear_ub("tiny", 16, model=jm),
            jax_theory.attention_ub("tiny", 16, r=2.0, model=jm)]
    got = [*theory.norm_ub("tiny", 16, model=tm), *theory.linear_ub("tiny", 16, model=tm),
           theory.attention_ub("tiny", 16, r=2.0, model=tm)]
    for name, g, w in zip(["ln1", "ln2", "fc1", "fc2", "mha"], got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=name)


def test_theoretical_bounds_build_the_in21k_vit(tiny, tiny_heads, monkeypatch):
    """``get_theoretical_bounds`` builds the in21k ViT on the device it is
    given (random from seed 0 without the published weights) and returns
    (LN1, MHA, LN2, FC1, FC2), as the JAX package does."""
    jm, tm, _, _ = tiny
    built = []

    def build(model_name, patch_size, device):
        built.append((model_name, patch_size, device))
        return tm

    monkeypatch.setattr(theory, "_build_vit", build)
    monkeypatch.setattr(jax_theory, "_build_vit", lambda *args: jm)
    got = theory.get_theoretical_bounds("tiny", 16, r=3.0, device="cpu")
    want = jax_theory.get_theoretical_bounds("tiny", 16, r=3.0)
    assert built == [("tiny", 16, torch.device("cpu"))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5)


def test_radius_matches_jax(monkeypatch):
    """The mean token-embedding norm over a synthetic test set of 20 images
    in batches of 8 (the last of 4; the loader cycles over 5 steps)."""
    config = {**TINY, "image_dim": (3, 224, 224)}
    jm, tm = _pair(config, seed=3)
    monkeypatch.setattr(jax_theory, "_build_vit", lambda *args: jm)
    monkeypatch.setattr(theory, "_build_vit", lambda *args: tm)
    args = dict(model_name="tiny", patch_size=16, dataset_name="synthetic-20",
                batch_size=8, max_steps=5)
    want = jax_theory.get_radius(**args)
    got = theory.get_radius(**args, device="cpu")
    assert got == pytest.approx(want, rel=1e-6)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        theory.get_radius("base", 16, "synthetic-8", 8, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        theory.get_theoretical_bounds("base", 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ll.get_rates_of_change("cifar10", 4, "mha", 0, 2, 1e-3, 2, 0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ll.save_results()
