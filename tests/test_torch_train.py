"""The port's training slice vs the JAX package, on the CPU at a small size.

The same seeded numpy inputs go through both packages: the plain version of
the packed attention backward (K2) and its CPU routes against ``jax.grad``
through the Pallas kernel (interpret mode, as tests/test_ops.py runs it); the
plain train augment (K10) against the Pallas kernel and the XLA path; crop
sampling, schedules, freeze masks and optimizers against ``vitef_tpu.optim``;
the train step against ``vitef_tpu.parallel.make_train_step``; the train
loader and the train/val split against ``vitef_tpu``'s.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vitef_tpu import optim as jax_optim
from vitef_tpu.data.images import datasets as jax_datasets
from vitef_tpu.data.images import loader as jax_loader
from vitef_tpu.data.images import transforms as jax_transforms
from vitef_tpu.models import build_model as jax_build_model
from vitef_tpu.ops import attention as jax_attention
from vitef_tpu.parallel import build_mesh as jax_build_mesh
from vitef_tpu.parallel import init_train_state as jax_init_train_state
from vitef_tpu.parallel import make_train_step as jax_make_train_step
from vitef_tpu.utils.tree import keystr_dotted
from vitef_tpu_torch import optim
from vitef_tpu_torch.data.images import datasets, loader, transforms
from vitef_tpu_torch.models import build_model, from_jax_params
from vitef_tpu_torch.ops import attention as A
from vitef_tpu_torch.parallel import (auto_grad_acc, init_train_state,
                                      make_train_step)

# The small ViT of tests/test_torch_vit.py: 2 layers, emb 64, 4 heads.
TRANSFORMER = {"implementation": "transformer", "image_dim": (3, 32, 32),
               "patch_type": "computer_vision", "patch_size": 8, "emb_type": "linear",
               "emb_dim": 64, "n_heads": 4, "n_layers": 2, "attn_bias": True,
               "ffn_bias": True, "norm": "layer", "norm_bias": True, "norm_eps": 1e-12,
               "pre_norm": True, "cls_token": True, "output_type": "classification",
               "n_classes": 10}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(config, dtype="float32", seed=0):
    """(JAX model, port model) of one config holding the same parameters."""
    config = {**config, "compute_dtype": dtype}
    jm = jax_build_model(config, key=jax.random.key(seed))
    tm = build_model(config, device="cpu")
    tm.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jm.params)))
    return jm, tm


# ---------------------------------------------------------------------------
# K2: the packed attention backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,h,l,d", [(3, 2, 9, 8), (2, 12, 197, 64), (2, 16, 257, 80)],
                         ids=["small", "vit_b16", "vit_h14"])
def test_packed_mha_bwd_matches_jax_kernel(n, h, l, d):
    rng = np.random.default_rng(11)
    e = h * d
    qkv = (rng.normal(size=(n, l, 3 * e)) * 0.5).astype(np.float32)
    bias = (rng.normal(size=(3 * e,)) * 0.3).astype(np.float32)
    g = rng.normal(size=(n, l, e)).astype(np.float32)

    def loss(qkv, bias):
        return (jax_attention.fused_mha_packed(qkv, h, bias=bias) * g).sum()

    with pltpu.force_tpu_interpret_mode():
        ref_dqkv, ref_db = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(bias))
    ref_dqkv, ref_db = np.asarray(ref_dqkv), np.asarray(ref_db)
    # Both sides run the same float32 algebra; sums are taken in another order
    # (tolerance of tests/test_ops.py:204).
    tol = dict(atol=5e-5, rtol=1e-3)

    dqkv, db = A.packed_mha_bwd_reference(_t(qkv), _t(bias), _t(g), h)
    np.testing.assert_allclose(dqkv.numpy(), ref_dqkv, **tol)
    np.testing.assert_allclose(db.numpy(), ref_db, **tol)

    launches = A.packed_mha_bwd.launches
    dqkv, db = A.packed_mha_bwd(_t(qkv), _t(bias), _t(g), None, None, h)
    np.testing.assert_allclose(dqkv.numpy(), ref_dqkv, **tol)
    np.testing.assert_allclose(db.numpy(), ref_db, **tol)
    assert A.packed_mha_bwd.launches == launches, "the CPU route counted a launch"

    qkv_t, bias_t = _t(qkv).requires_grad_(), _t(bias).requires_grad_()
    (A.fused_mha_packed(qkv_t, h, bias=bias_t) * _t(g)).sum().backward()
    np.testing.assert_allclose(qkv_t.grad.numpy(), ref_dqkv, **tol)
    np.testing.assert_allclose(bias_t.grad.numpy(), ref_db, **tol)


def test_packed_mha_bwd_reference_causal_matches_autograd():
    rng = np.random.default_rng(4)
    qkv = _t((rng.normal(size=(2, 7, 24)) * 0.5).astype(np.float32))
    bias = _t((rng.normal(size=(24,)) * 0.3).astype(np.float32))
    g = _t(rng.normal(size=(2, 7, 8)).astype(np.float32))
    q, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    (A.packed_mha_reference(q, 2, causal=True, bias=b) * g).sum().backward()
    dqkv, db = A.packed_mha_bwd_reference(qkv, bias, g, 2, causal=True)
    np.testing.assert_allclose(dqkv.numpy(), q.grad.numpy(), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(db.numpy(), b.grad.numpy(), atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# K10: the train augment, and crop sampling
# ---------------------------------------------------------------------------


def test_sample_crop_batch_matches_jax():
    ours = transforms.sample_crop_batch(np.random.default_rng(5), 64, 32, 32)
    ref = jax_transforms.sample_crop_batch(np.random.default_rng(5), 64, 32, 32)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the center-crop fallback of a very elongated image
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    assert transforms.sample_resized_crop_params(rng_a, 4, 64) == \
        jax_transforms.sample_resized_crop_params(rng_b, 4, 64)


def test_augment_train_matches_jax():
    rng = np.random.default_rng(11)
    batch = rng.integers(0, 256, size=(4, 32, 32, 3), dtype=np.uint8)
    boxes, flips = jax_transforms.sample_crop_batch(rng, 4, 32, 32)
    flips[:2] = [True, False]
    args = (jnp.asarray(batch), jnp.asarray(boxes), jnp.asarray(flips))
    xla = np.asarray(jax_transforms.augment_train_device(
        *args, size=224, compute_dtype=jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax_transforms._augment_pallas(
            *args, size=224, compute_dtype=jnp.float32))

    targs = (_t(batch), _t(boxes), _t(flips))
    plain = transforms.augment_train_reference(*targs, 224)
    launches = transforms.augment_train_device.launches
    routed = transforms.augment_train_device(*targs, size=224)
    assert transforms.augment_train_device.launches == launches
    assert plain.shape == (4, 3, 224, 224) and plain.dtype == torch.float32
    # All exact float32 bilinear maps, summed in another order.
    for ours in (plain, routed):
        np.testing.assert_allclose(ours.numpy(), pallas, atol=1e-4, rtol=0)
        np.testing.assert_allclose(ours.numpy(), xla, atol=1e-4, rtol=0)
    half = transforms.augment_train_reference(*targs, 224, torch.bfloat16)
    assert half.dtype == torch.bfloat16
    np.testing.assert_allclose(half.float().numpy(), plain.numpy(), atol=2e-2, rtol=0)


def _crop_inputs(seed: int, h: int, w: int, n: int = 4):
    """A seeded uint8 batch with crops drawn as the loader draws them, the
    first box the whole image (a crop of a source over ``size`` then
    downscales), flips on and off."""
    rng = np.random.default_rng(seed)
    batch = rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)
    boxes, flips = jax_transforms.sample_crop_batch(rng, n, h, w)
    boxes[0] = (0, 0, h, w)
    flips[:2] = [True, False]
    return batch, boxes, flips


# Against what the JAX package runs for the shape: the Pallas kernel for a
# square source (every square size; here past the first CUDA design's 48 KB
# cap, with downscaling crops, and at a size that is not a multiple of 8),
# XLA's scale_and_translate for a non-square one whose sides are within
# ``size`` (every crop upscales, where both are the two-tap map). With the
# coordinate rounded as XLA rounds it, the two differ only in the products'
# order: worst of 4 seeds 2.4e-7 at 96 -> 64 and 97 -> 50, 9.5e-7 at
# 160 -> 224 and 32 -> 224.
@pytest.mark.parametrize("h,w,size,atol", [
    (96, 96, 64, 5e-6), (97, 97, 50, 5e-6), (160, 160, 224, 5e-6), (17, 31, 224, 1e-4),
], ids=["96-to-64", "97-to-50", "160-to-224", "17x31-to-224"])
def test_augment_train_matches_jax_route(h, w, size, atol):
    batch, boxes, flips = _crop_inputs(h * w + size, h, w)
    args = (jnp.asarray(batch), jnp.asarray(boxes), jnp.asarray(flips))
    if h == w:
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jax_transforms._augment_pallas(
                *args, size=size, compute_dtype=jnp.float32))
    else:
        ref = np.asarray(jax_transforms.augment_train_device(
            *args, size=size, compute_dtype=jnp.float32))
    targs = (_t(batch), _t(boxes), _t(flips))
    for ours in (transforms.augment_train_reference(*targs, size),
                 transforms.augment_train_device(*targs, size=size)):
        assert ours.shape == (4, 3, size, size)
        np.testing.assert_allclose(ours.numpy(), ref, atol=atol, rtol=0)


def _jax_bilinear_weights(start: int, length: int, size: int, src: int, flip: bool):
    """The JAX kernel's ``_bilinear_weights`` as the Pallas kernel computes it
    (interpret mode), the box and flip read from a ref as there."""
    def kernel(box_ref, o_ref):
        o_ref[...] = jax_transforms._bilinear_weights(
            box_ref[0, 0], box_ref[0, 1], size, src, box_ref[0, 2] != 0)
    box = jnp.asarray([[start, length, float(flip)]], jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((size, src), jnp.float32))(box))


# The crop coordinate u = (o + 0.5) * (length / size) + start - 0.5 rounds
# differently by how ``length / size`` and the sum are computed. XLA turns
# the division into a product with the float32 reciprocal and contracts the
# sum into a fused multiply-add; the port's weights (those of its plain
# version and of K10) must be the JAX kernel's bit for bit, at lengths where
# dividing and multiplying by the reciprocal round apart.
@pytest.mark.parametrize("src,size", [(97, 50), (160, 224), (1024, 224)],
                         ids=["97-to-50", "160-to-224", "1024-to-224"])
def test_bilinear_weights_round_as_jax(src, size):
    f = np.float32
    lengths = [n for n in range(1, src + 1) if f(n) / f(size) != f(n) * (f(1) / f(size))][:4]
    cases = [(start, n, flip) for n in lengths for start, flip in ((0, True), (src - n, False))]
    start, length, flip = (torch.tensor(c) for c in zip(*cases))
    ours = transforms._bilinear_weights(start, length, size, src, flip).numpy()
    for i, (s, n, flipped) in enumerate(cases):
        np.testing.assert_array_equal(ours[i], _jax_bilinear_weights(s, n, size, src, flipped))


@pytest.mark.parametrize("h,w,size", [(120, 160, 64), (160, 120, 64), (300, 200, 224)],
                         ids=["120x160-to-64", "160x120-to-64", "300x200-to-224"])
def test_augment_train_refuses_non_square_downscale(h, w, size):
    """A non-square source with a side over ``size`` (named from when the
    port refused it): the JAX package resizes it with XLA's antialiased
    scale_and_translate, whose kernel widens on a downscaling crop, so the
    two-tap map differs from it by whole units there; the port's
    ``augment_train_device`` takes the same antialiased map and equals the
    JAX XLA path within 1e-4 in normalised units, in float32 (the two
    compute the same float32 weights, then sum in another order)."""
    batch, boxes, flips = _crop_inputs(12, h, w)
    targs = (_t(batch), _t(boxes), _t(flips))
    xla = np.asarray(jax_transforms.augment_train_device(
        jnp.asarray(batch), jnp.asarray(boxes), jnp.asarray(flips), size=size,
        compute_dtype=jnp.float32))
    launches = transforms.augment_train_device.launches
    ours = transforms.augment_train_device(*targs, size=size)
    assert transforms.augment_train_device.launches == launches
    assert ours.shape == (4, 3, size, size) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), xla, atol=1e-4, rtol=0)
    two_tap = transforms.augment_train_reference(*targs, size).numpy()
    assert np.abs(xla - two_tap).max() > 1.0


def _source_rows_read(top, h, size, src, rows):
    """The most source rows that ``rows`` consecutive output rows read, by
    the plain version's float32 coordinate (taps floor(u), floor(u) + 1
    clamped into [0, src))."""
    f = np.float32
    inv_s = f(h) * (f(1) / f(size))
    u = ((np.arange(size, dtype=f) + f(0.5)).astype(np.float64) * np.float64(inv_s)
         + top).astype(f) - f(0.5)
    lo = np.clip(np.floor(u), 0, src - 1).astype(np.int64)
    hi = np.clip(np.floor(u) + 1, 0, src - 1).astype(np.int64)
    return max(hi[min(r + rows, size) - 1] - lo[r] + 1 for r in range(0, size, rows))


# K10's plan: R output rows a block, as few bands as keep a block's shared
# memory within 64 KB (else R = 1) and R within 64, evened out, and within
# the 227 KB a block may have; every band of R rows reads at most
# floor((R - 1) H / size) + 3 source rows, one fewer than it holds.
@pytest.mark.parametrize("src,size,rows", [
    (32, 224, 56), (512, 224, 6), (1024, 224, 3), (127, 50, 17), (32, 7, 7), (20000, 224, 1),
    (32, 2640, 1),
], ids=["32-to-224", "512-to-224", "1024-to-224", "127-to-50", "32-to-7", "20000-to-224",
        "32-to-2640"])
def test_augment_band_rows(src, size, rows):
    assert transforms.augment_band_rows(src, src, size) == rows
    smem = transforms.augment_smem_bytes(rows, src, size)
    assert smem <= 227 * 1024 and (rows == 1 or smem <= 64 * 1024)
    bands = -(-size // rows)
    assert rows * bands - size < bands  # bands within one row of each other
    if bands > 1:  # one band fewer would not fit
        wider = -(-size // (bands - 1))
        assert wider > 64 or transforms.augment_smem_bytes(wider, src, size) > 64 * 1024
    boxes, _ = transforms.sample_crop_batch(np.random.default_rng(src + size), 64, src, src)
    most = max(_source_rows_read(top, h, size, src, rows)
               for top, _, h, _ in [(0, 0, src, src), *boxes])
    assert most <= (rows - 1) * src // size + 3


def test_augment_band_rows_refuses_past_limit():
    with pytest.raises(NotImplementedError, match="limit of 2640"):
        transforms.augment_band_rows(32, 32, 2641)
    with pytest.raises(NotImplementedError, match="limit of 2640"):
        transforms.augment_band_rows(1, 1, 4096)


# ---------------------------------------------------------------------------
# Optimizers, schedules and freeze masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", [
    {"scheduler": "constant"},
    {"scheduler": "linear", "warmup": 3, "min_factor": 0.1},
    {"scheduler": "cosine", "warmup": 3, "min_factor": 0.0},
    {"scheduler": "cosine", "warmup": 0, "min_factor": 0.2},
    {"scheduler": "wsd", "warmup": 2, "min_factor": 0.1, "decay_fraction": 0.3,
     "cycle_length": 0.5},
    {"scheduler": "wsd", "warmup": 2, "min_factor": 0.05, "decay_fraction": 0.2},
], ids=["constant", "linear", "cosine", "cosine_nowarmup", "wsd_cycles", "wsd"])
def test_schedules_match_jax(config):
    n_steps = 12
    ours = optim.build_scheduler(config, n_steps)
    ref = jax_optim.build_scheduler(config, n_steps)
    for step in range(n_steps + 4):
        np.testing.assert_allclose(ours(step), float(ref(step)), atol=1e-6, rtol=1e-5,
                                   err_msg=f"step {step}")
    if config["scheduler"] == "cosine" and config["warmup"]:
        assert ours(0) == 0.0  # the warmup starts at lr 0


@pytest.mark.parametrize("components", [[c] for c in optim.FREEZE_MAP] + [["mha", "ffn_fc1"]],
                         ids=list(optim.FREEZE_MAP) + ["mha+ffn_fc1"])
def test_trainable_mask_matches_jax(components):
    jm, tm = _pair(TRANSFORMER)
    ref = jax_optim.trainable_mask(jm.params, components)
    ref = {keystr_dotted(p): bool(m) for p, m in jax.tree_util.tree_flatten_with_path(ref)[0]}
    ours = optim.trainable_mask(tm.module, components)
    assert ours == ref
    assert not all(ours.values())
    mask = optim.freeze_components(tm.module, components)
    assert mask == ours
    assert {n: p.requires_grad for n, p in tm.module.named_parameters()} == ours


@pytest.mark.parametrize("name,extra", [
    ("sgd", {"momentum": 0.9, "weight_decay": 0.05}),
    ("adamw", {"weight_decay": 0.05, "betas": (0.8, 0.95)}),
])
def test_optimizer_updates_match_optax(name, extra):
    config = {"optimizer": name, "lr": 0.05, **extra}
    components = ["mha"]
    schedule = optim.build_scheduler({"scheduler": "cosine", "warmup": 1}, 10)
    jm, tm = _pair(TRANSFORMER)
    params = jax.tree.map(jnp.asarray, jm.params)
    tx, _ = jax_optim.build_optimizer(
        config, schedule=jax_optim.build_scheduler({"scheduler": "cosine", "warmup": 1}, 10),
        params=params, components=components)
    opt_state = tx.init(params)
    opt, sched = optim.build_optimizer(config, tm.module, schedule=schedule,
                                       components=components)
    before = {n: p.detach().clone() for n, p in tm.module.named_parameters()}
    rng = np.random.default_rng(2)
    for _ in range(3):
        grads_np = {n: rng.normal(size=tuple(p.shape)).astype(np.float32)
                    for n, p in tm.module.named_parameters()}
        jgrads = jax.tree_util.tree_map_with_path(
            lambda path, p: jnp.asarray(grads_np[keystr_dotted(path)].T
                                        if keystr_dotted(path).endswith("weight") and p.ndim == 2
                                        else grads_np[keystr_dotted(path)]), params)
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        for n, p in tm.module.named_parameters():
            p.grad = _t(grads_np[n]) if p.requires_grad else None
        opt.step()
        sched.step()
    ref = from_jax_params(jax.tree.map(np.asarray, params))
    mask = optim.trainable_mask(tm.module, components)
    for n, p in tm.module.named_parameters():
        if mask[n]:
            np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), atol=1e-6,
                                       rtol=1e-5, err_msg=n)
            assert not torch.equal(p.detach(), before[n])
        else:
            assert torch.equal(p.detach(), before[n]), f"frozen {n} changed"


def test_clip_by_global_norm_is_optax_rule():
    import optax

    rng = np.random.default_rng(0)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    for max_norm in (0.5, 100.0):
        ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads],
                                                            optax.EmptyState())
        ours = [_t(g.copy()) for g in grads]
        norm = optim.clip_by_global_norm_(ours, max_norm)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            [jnp.asarray(g) for g in grads])), rtol=1e-6)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=1e-6)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def _train_both(components, dtype, steps=3):
    """Run ``steps`` train steps of the JAX package and of the port on the same
    weights and batches; returns both per-step metrics, the JAX package's
    final parameters, the port model and its initial parameters."""
    opt_cfg = {"optimizer": "sgd", "lr": 0.1, "momentum": 0.9}
    sched_cfg = {"scheduler": "cosine", "warmup": 2}
    jm, tm = _pair(TRANSFORMER, dtype=dtype)

    jschedule = jax_optim.build_scheduler(sched_cfg, n_steps=10)
    tx, _ = jax_optim.build_optimizer(opt_cfg, schedule=jschedule, params=jm.params,
                                      components=components, grad_clip=1.0)
    jstep = jax_make_train_step(jm.apply, tx, grad_acc_steps=2, schedule=jschedule,
                                base_lr=0.1, donate=False,
                                trainable=jax_optim.trainable_mask(jm.params, components))
    jstate = jax_init_train_state(jm.params, tx)

    schedule = optim.build_scheduler(sched_cfg, n_steps=10)
    opt, sched = optim.build_optimizer(opt_cfg, tm.module, schedule=schedule,
                                       components=components)
    step = make_train_step(grad_acc_steps=2, schedule=schedule, base_lr=0.1, grad_clip=1.0,
                           block_grad_norms=True)
    state = init_train_state(tm, opt, sched)
    start = {n: p.detach().clone() for n, p in tm.module.named_parameters()}

    rng = np.random.default_rng(3)
    jmetrics, metrics = [], []
    for _ in range(steps):
        x = rng.normal(size=(8, 3, 32, 32)).astype(np.float32)
        y = rng.integers(0, 10, size=8)
        jstate, m = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        jmetrics.append({k: float(v) for k, v in m.items()})
        metrics.append({k: float(v) for k, v in step(state, (_t(x), _t(y))).items()})
    assert state.step == steps and state.acc_step == 0
    ref = from_jax_params(jax.tree.map(np.asarray, jstate.params))
    return jmetrics, metrics, ref, tm, start


@pytest.mark.parametrize("components", [[], ["mha", "ffn_fc1"]], ids=["all", "frozen"])
def test_train_step_matches_jax(components):
    jmetrics, metrics, ref, tm, start = _train_both(components, "float32")
    assert max(m["grad_norm"] for m in metrics) > 1.0, "the clip never bound"
    for m, r in zip(metrics, jmetrics):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[key], r[key], rtol=1e-4, atol=1e-7, err_msg=key)
        assert {k for k in m if k.startswith("grad_norm_block_")} == \
            {"grad_norm_block_0", "grad_norm_block_1"}
    mask = optim.trainable_mask(tm.module, components)
    for n, p in tm.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=n)
        assert torch.equal(p.detach(), start[n]) != mask[n], n


def test_train_step_bf16_matches_jax():
    jmetrics, metrics, ref, tm, _ = _train_both([], "bfloat16")
    # bfloat16 activations round at other places in the two frameworks (XLA
    # fuses and keeps some intermediates in float32); each rounding is
    # ~2^-9 relative, and the small ViT's logits already differ by up to
    # 5e-2 (tests/test_torch_vit.py). Loss and norms are held at 2e-2
    # relative, and the float32 parameters after 3 clipped lr-0.1 steps at
    # 2e-3 absolute.
    for m, r in zip(metrics, jmetrics):
        np.testing.assert_allclose(m["loss"], r["loss"], rtol=2e-2)
        np.testing.assert_allclose(m["grad_norm"], r["grad_norm"], rtol=2e-2)
        assert m["lr"] == pytest.approx(r["lr"], rel=1e-6)
    for n, p in tm.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), atol=2e-3, rtol=0,
                                   err_msg=n)


class _TpMesh:
    """A mesh's shape with tp = 2 (no ranks needed for the refusal)."""

    shape = {"dp": 1, "tp": 2}


@pytest.mark.parametrize("kwargs", [{"update_stats": True}, {"mesh": _TpMesh()},
                                    {"moe_aux_coefs": (0.1, 0.1)}],
                         ids=["update_stats", "mesh", "moe_aux_coefs"])
def test_unported_train_step_options_raise(kwargs):
    """The data-parallel mesh step (ported, tests/test_torch_mesh.py) refuses
    a mesh with tp > 1 with an AssertionError, as the JAX step asserts
    (:222-226). ``update_stats`` (ported with PatchTST,
    tests/test_torch_patchtst.py) and ``moe_aux_coefs`` (with the MoE family,
    tests/test_torch_moe.py) build, and the pairs the JAX step refuses
    (:102-107) raise its ValueError."""
    if "mesh" in kwargs:
        with pytest.raises(AssertionError, match="data-parallel only"):
            make_train_step(**kwargs)
        with pytest.raises(AssertionError):
            jax_make_train_step(None, None, mesh=jax_build_mesh(dp=1, tp=2,
                                                               devices=jax.devices()[:2]))
        return
    make_train_step(**kwargs)
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_train_step(**{"update_stats": True, "moe_aux_coefs": (0.1, 0.1), **kwargs})
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_train_step(update_stats=True, hidden_loss=lambda *a: None)
    for pair in ({"moe_aux_coefs": (0.1, 0.1)}, {"hidden_loss": lambda *a: None}):
        with pytest.raises(ValueError, match="mutually exclusive"):
            jax_make_train_step(None, None, update_stats=True, **pair)


@pytest.mark.parametrize("components", [["mha"], ["ffn_fc2", "attn_norm"]],
                         ids=["mha", "ffn_fc2+attn_norm"])
def test_block_grad_norms_include_frozen_like_jax(components):
    """``grad_norm_block_{i}`` is the norm of the block's whole gradient,
    frozen parameters included, as the JAX step computes it; ``grad_norm``
    and the update see only the trainable gradients."""
    opt_cfg = {"optimizer": "sgd", "lr": 0.1, "momentum": 0.9}
    jm, tm = _pair(TRANSFORMER)
    tx, _ = jax_optim.build_optimizer(opt_cfg, params=jm.params, components=components,
                                      grad_clip=1.0)
    jstep = jax_make_train_step(jm.apply, tx, donate=False, block_grad_norms=True,
                                trainable=jax_optim.trainable_mask(jm.params, components))
    opt, sched = optim.build_optimizer(opt_cfg, tm.module, components=components)
    state = init_train_state(tm, opt, sched)
    step = make_train_step(grad_clip=1.0, block_grad_norms=True)
    frozen = [p for p in tm.module.parameters() if not p.requires_grad]

    rng = np.random.default_rng(8)
    x = rng.normal(size=(4, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, size=4)
    _, ref = jax.jit(jstep)(jax_init_train_state(jm.params, tx), (jnp.asarray(x), jnp.asarray(y)))
    metrics = step(state, (_t(x), _t(y)))
    keys = ["grad_norm"] + [f"grad_norm_block_{i}" for i in range(2)]
    for key in keys:
        np.testing.assert_allclose(float(metrics[key]), float(ref[key]), rtol=1e-5, err_msg=key)
    # the frozen parameters stay frozen, with no gradient left behind
    assert frozen and all(not p.requires_grad and p.grad is None for p in frozen)


def test_auto_grad_acc_matches_app():
    from apps.vit.train import _auto_grad_acc

    for per_dev in (1, 96, 255, 256, 257, 384, 512, 700, 1024, 4096):
        for cap in (-1, 0, 100, 256, 512):
            assert auto_grad_acc(per_dev, cap) == _auto_grad_acc(per_dev, cap)
    assert auto_grad_acc(512, 256) == 2


# ---------------------------------------------------------------------------
# Dropout guard and the eval step after training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", ["dropout", "attn_dropout", "ffn_dropout"])
def test_train_mode_with_dropout_raises(rate):
    """Train mode with a dropout rate > 0 raises without a generator, as the
    JAX forward does without an rng; with one it runs (dropout is ported:
    tests/test_torch_patchtst.py holds each site), one seed repeating its
    output and the train step's, another seed not; eval mode ignores it."""
    tm = build_model({**TRANSFORMER, rate: 0.1}, device="cpu")
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    tm.module.train()
    with pytest.raises(ValueError, match="generator"):
        tm.apply(x)
    outs = [tm.apply(x, generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    tm.module.eval()
    assert tm.apply(x).shape == (2, 10)
    assert not torch.equal(tm.apply(x), outs[0])

    state_dict = {k: v.clone() for k, v in tm.module.state_dict().items()}
    y = torch.tensor([1, 7])
    losses = []
    for seed in (5, 5, 6):
        tm.module.load_state_dict(state_dict)
        opt, sched = optim.build_optimizer({"optimizer": "sgd", "lr": 0.1}, tm.module)
        step = make_train_step(grad_acc_steps=2)
        metrics = step(init_train_state(tm, opt, sched), (x, y),
                       generator=torch.Generator().manual_seed(seed))
        losses.append(float(metrics["loss"]))
    assert losses[0] == losses[1] != losses[2]


def test_eval_step_after_train_step():
    tm = build_model(TRANSFORMER, device="cpu")
    opt, sched = optim.build_optimizer({"optimizer": "sgd", "lr": 0.1}, tm.module)
    state = init_train_state(tm, opt, sched)
    rng = np.random.default_rng(0)
    x = _t(rng.normal(size=(4, 3, 32, 32)).astype(np.float32))
    y = _t(rng.integers(0, 10, size=4))
    make_train_step()(state, (x, y))
    assert tm.module.training
    acc, loss = tm.eval_step((x, y))
    assert not tm.module.training
    with torch.inference_mode():
        ref = torch.nn.functional.cross_entropy(tm.module(x), y)
    assert float(loss) == pytest.approx(float(ref), rel=1e-6)
    assert 0.0 <= float(acc) <= 1.0


# ---------------------------------------------------------------------------
# Train loader and the train/val split
# ---------------------------------------------------------------------------


def test_train_loader_matches_jax():
    cfg = {"n_samples": 40, "image_size": 32, "seed": 2}
    ref_ds = jax_datasets.SyntheticDataset(jax_datasets.SyntheticDatasetConfig(**cfg))
    ds = datasets.SyntheticDataset(datasets.SyntheticDatasetConfig(**cfg))
    ref = jax_loader.Loader(ref_ds, batch_size=8, size=48, mode="train", seed=3,
                            prefetch=0, num_workers=0)
    ours = loader.Loader(ds, device="cpu", batch_size=8, size=48, mode="train", seed=3)
    n = 2 * len(ours)  # two epochs
    ref_it, it = jax_loader.make_iterable(ref), loader.make_iterable(ours)
    for _ in range(n):
        (x, y), (rx, ry) = next(it), next(ref_it)
        np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
        assert x.shape == (8, 3, 48, 48) and x.dtype == torch.float32
        # the JAX loader takes the XLA augment on the CPU; both exact float32
        np.testing.assert_allclose(x.numpy(), np.asarray(rx), atol=1e-4, rtol=0)


def test_build_train_val_loader_matches_jax():
    config = {"dataset_name": "synthetic-50", "batch_size": 8, "val_batch_size": 16,
              "size": 32, "seed": 1}
    np.random.seed(7)
    ref_train, ref_val, ref_classes = jax_loader.build_train_val_loader(
        {**config, "prefetch": 0, "num_workers": 0}, return_n_classes=True)
    np.random.seed(7)
    train, val, n_classes = loader.build_train_val_loader(config, device="cpu",
                                                          return_n_classes=True)
    assert n_classes == ref_classes == 10
    np.testing.assert_array_equal(train.indices, ref_train.indices)
    np.testing.assert_array_equal(val.indices, ref_val.indices)
    assert len(train) == len(ref_train) == 5 and len(val) == len(ref_val) == 1
    (x, y), (rx, ry) = next(iter(val)), next(iter(ref_val))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), atol=1e-6, rtol=0)
    (x, y), (rx, ry) = next(iter(train)), next(iter(ref_train))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), atol=1e-4, rtol=0)
