"""PatchTST on the port against the JAX package, on the CPU.

On seeded numpy inputs, at the tiny PatchTST of ``tests/test_model_families.py``
(length 64, patch 16, stride 8, E 32 over 4 heads, so head width 8 as in the
preset, 2 layers, FFN 64, horizon 24), each piece of the slice is held to the
JAX package:

- ``patch_timeseries`` and ``patch_images_raw``, bit for bit;
- batch norm in train and eval mode, its batch statistics and their EMA, at
  1e-6;
- the whole forward in float32 at 1e-4 / 1e-4, in eval mode on running
  statistics and in train mode with ``return_stats``;
- 3 AdamW steps of ``make_train_step(update_stats=True, grad_acc_steps=2)``
  with an MSE loss: the losses, the parameters and the running statistics;
- the float32 forward and gradients under ``attn_impl="pallas"``, where
  the JAX package takes its flash kernel at d = 8 (interpret mode) and the
  port K4 and K5 (their plain versions on the CPU);
- K1's and K2's plain versions at head width 8 against the JAX
  ``fused_mha_packed`` (Pallas interpret mode) and ``jax.vjp`` of it at
  2e-5 / 1e-4, and the bf16 route: both packages take the packed kernels at
  d = 8;
- PatchTST base's parameter names and shapes, and its local pretrained load
  from a ``.npz`` or ``.pt`` state dict in the reference's BatchNorm-wrapper
  names, which the test writes;
- ``from_jax_params``/``to_jax_params`` on a linear token embedding, the
  running statistics and the forecasting head;
- ``remat``: the float32 forward and gradients equal to those without it
  (with dropout too) and to the JAX package's with ``remat=True``;
- dropout: the formula against the JAX one on the same mask, each of the
  four sites alone, eval mode, and a seed's masks repeated bit for bit.

The sequence-parallel ranks' dropout streams are tested with the other sp
cases, on gloo ranks (``tests/test_torch_sequence.py``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vitef_tpu import optim as jax_optim
from vitef_tpu.models import build_model as jax_build_model
from vitef_tpu.models import norms as jax_norms
from vitef_tpu.models import patching as jax_patching
from vitef_tpu.models.transformer import apply_transformer
from vitef_tpu.ops import attention as jax_attention
from vitef_tpu.ops import common as jax_common
from vitef_tpu.parallel import init_train_state as jax_init_train_state
from vitef_tpu.parallel import make_train_step as jax_make_train_step
from vitef_tpu.utils.tree import keystr_dotted
from vitef_tpu_torch import optim
from vitef_tpu_torch.models import build_model, from_jax_params, norms, patching, to_jax_params
from vitef_tpu_torch.models.convert import _transposed
from vitef_tpu_torch.ops import attention as A
from vitef_tpu_torch.ops.common import dropout
from vitef_tpu_torch.parallel import init_train_state, make_train_step

TINY = {"implementation": "transformer", "length": 64, "patch_type": "time_series",
        "patch_size": 16, "stride": 8, "emb_type": "linear", "emb_dim": 32, "n_heads": 4,
        "n_layers": 2, "ffn_dim": 64, "pos_emb": True, "attn_bias": True, "causal": False,
        "activation": "gelu", "ffn_bias": True, "norm": "batch", "norm_bias": True,
        "pre_norm": False, "cls_token": False, "output_type": "forecasting",
        "weight_tying": False, "forecasting_horizon": 24, "compute_dtype": "float32"}
HORIZON = TINY["forecasting_horizon"]
# float32 on both sides, sums in another order (ROADMAP's whole-model and
# kernel tolerances).
ATOL, RTOL = 1e-4, 1e-4
K_ATOL, K_RTOL = 2e-5, 1e-4
BN_TOL = dict(atol=1e-6, rtol=1e-6)
SITES = ("emb_dropout", "attn_dropout", "ffn_dropout", "output_dropout")


@pytest.fixture
def one_thread():
    """Many tiny ops: on a shared CPU, torch's thread pool costs more than
    the arithmetic."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _flat(params) -> dict:
    return {keystr_dotted(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}


def _series(n: int, seed: int, length: int = 64, horizon: int = HORIZON):
    """(x (n, length), y (n, horizon)): noisy sines of random phase and scale."""
    rng = np.random.default_rng(seed)
    t = np.arange(length + horizon) / 6.0
    s = (rng.normal(size=(n, 1)) * np.sin(t + rng.uniform(0, 6, size=(n, 1)))
         + 0.1 * rng.normal(size=(n, length + horizon)) + rng.normal(size=(n, 1)))
    s = s.astype(np.float32)
    return s[:, :length], s[:, length:]


def _with_running_stats(params, seed: int):
    """A copy of a JAX PatchTST tree whose batch norms hold random running
    statistics (variances in [0.5, 2]), so that eval mode reads them."""
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict):
            node = {k: fill(v) for k, v in node.items()}
            if "running_mean" in node:
                e = node["running_mean"].shape[0]
                node["running_mean"] = jnp.asarray(rng.normal(size=e).astype(np.float32))
                node["running_var"] = jnp.asarray(rng.uniform(0.5, 2, size=e).astype(np.float32))
            return node
        if isinstance(node, list):
            return [fill(v) for v in node]
        return node

    return fill(params)


def _pair(config=TINY, seed=0, stats_seed=None):
    """(JAX model, its params, port model) holding the same parameters and
    running statistics."""
    jm = jax_build_model(config, key=jax.random.key(seed))
    params = jm.params if stats_seed is None else _with_running_stats(jm.params, stats_seed)
    tm = build_model(config, device="cpu")
    tm.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    return jm, params, tm


# ---------------------------------------------------------------------------
# Patching and batch norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length,patch,stride", [(64, 16, 8), (10, 4, 3), (17, 5, 5),
                                                 (16, 16, 8), (512, 16, 8)])
def test_patch_timeseries_bit_equal(length, patch, stride):
    x = np.random.default_rng(length).normal(size=(3, length)).astype(np.float32)
    want = np.asarray(jax_patching.patch_timeseries(jnp.asarray(x), patch, stride))
    got = patching.patch_timeseries(_t(x), patch, stride)
    assert patching.timeseries_patch_dims(length, patch, stride) == \
        jax_patching.timeseries_patch_dims(length, patch, stride) == tuple(want.shape[1:])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c,size,patch", [(3, 8, 4), (1, 12, 4), (3, 32, 16)])
def test_patch_images_raw_bit_equal(c, size, patch):
    x = np.random.default_rng(size).normal(size=(2, c, size, size)).astype(np.float32)
    want = np.asarray(jax_patching.patch_images_raw(jnp.asarray(x), patch))
    np.testing.assert_array_equal(patching.patch_images_raw(_t(x), patch).numpy(), want)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_matches_jax(train):
    """Output, batch statistics (mean and unbiased variance) and one EMA step,
    against ``apply_norm(kind="batch")`` and ``ema_update_stats``."""
    rng = np.random.default_rng(3)
    e = 32
    x = (rng.normal(size=(4, 9, e)) * 2 + rng.normal(size=e)).astype(np.float32)
    p = {"weight": rng.normal(size=e), "bias": rng.normal(size=e),
         "running_mean": rng.normal(size=e), "running_var": rng.uniform(0.5, 2, size=e)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    bn = norms.BatchNorm(e, True, 1e-5, device=torch.device("cpu"))
    bn.load_state_dict({k: _t(v) for k, v in p.items()})
    bn.train(train)
    out, stats = bn(_t(x), return_stats=True)
    want, want_stats = jax_norms.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                            jnp.asarray(x), kind="batch", eps=1e-5,
                                            deterministic=not train, return_stats=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **BN_TOL)
    torch.testing.assert_close(bn(_t(x)), out)
    if not train:
        assert stats is None and want_stats is None
        return
    for key in ("running_mean", "running_var"):
        np.testing.assert_allclose(stats[key].numpy(), np.asarray(want_stats[key]), **BN_TOL)
    running = {"site": {k: _t(p[k]) for k in ("running_mean", "running_var")}}
    got = norms.ema_update_stats(running, {"site": stats}, 0.1)
    ref = jax_norms.ema_update_stats({"site": {k: jnp.asarray(p[k]) for k in running["site"]}},
                                     {"site": want_stats}, 0.1)
    for key in ("running_mean", "running_var"):
        np.testing.assert_allclose(got["site"][key].numpy(), np.asarray(ref["site"][key]),
                                   **BN_TOL)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_float32_matches_jax(train):
    """Forecasts (N, 24) in eval mode on random running statistics, and in
    train mode with every site's batch statistics (``return_stats``)."""
    jm, params, tm = _pair(stats_seed=1)
    x, _ = _series(8, seed=2)
    if train:
        want, want_stats = jm.apply(params, jnp.asarray(x), deterministic=False,
                                    return_stats=True)
        tm.module.train()
        got, stats = tm.module(_t(x), return_stats=True)
        assert sorted(stats) == sorted(want_stats) == [
            f"blocks.{i}.{n}" for i in range(2) for n in ("attn_norm", "ffn_norm")]
        for site, value in want_stats.items():
            for key in ("running_mean", "running_var"):
                np.testing.assert_allclose(stats[site][key].numpy(), np.asarray(value[key]),
                                           atol=ATOL, rtol=RTOL, err_msg=f"{site} {key}")
    else:
        want = jm.apply(params, jnp.asarray(x))
        got = tm.apply_eval(_t(x))
        assert tm.module(_t(x), return_stats=True)[1] == {}
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, HORIZON)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def _mse(pred, target):
    return ((pred - target) ** 2).mean()


def _zero_gradient_slices(name: str, e: int):
    """The slice of parameter ``name`` whose gradient is exactly 0, or None:
    the key part of the qkv bias (each query row's scores shift alike, which
    the softmax ignores) and the biases whose sum reaches a batch norm as a
    per-channel constant, which the norm's mean removes: the value part of
    the qkv bias (each output row gets the same shift, through the output
    projection), the output projection's and fc2's. Adam turns the two
    packages' rounding noise there into updates of up to ~lr."""
    if name.endswith("attn.qkv_mat.bias"):
        return slice(e, 3 * e)
    if name.endswith(("attn.output.bias", "ffn.fc2.bias")):
        return slice(0, e)
    return None


def test_train_steps_update_stats_match_jax(one_thread):
    """Three AdamW steps of 2 x 4 microbatches with the running-stat update:
    each step's loss and grad norm, then every parameter and running
    statistic, against the JAX step. The slices of zero gradient move by
    Adam's reading of rounding noise, up to lr a step in each package: they
    are held to 2 lr after each step and then set to the JAX package's, so
    that the noise does not reach the batch statistics of the next step (a
    bias before a batch norm shifts its input's mean, which the running mean
    records)."""
    lr = 1e-3
    opt_cfg = {"optimizer": "adamw", "lr": lr}
    jm, params, tm = _pair()
    tx, _ = jax_optim.build_optimizer(opt_cfg, params=params)
    jstep = jax_make_train_step(jm.apply, tx, grad_acc_steps=2, loss_fn=lambda p, y: jnp.mean(
        jnp.square(p - y)), update_stats=True, donate=False)
    jstate = jax_init_train_state(params, tx)
    opt, sched = optim.build_optimizer(opt_cfg, tm.module)
    state = init_train_state(tm, opt, sched)
    step = make_train_step(grad_acc_steps=2, loss_fn=_mse, update_stats=True)
    e = TINY["emb_dim"]
    for i in range(3):
        x, y = _series(8, seed=10 + i)
        jstate, ref = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        metrics = step(state, (_t(x), _t(y)))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]), float(ref[key]), rtol=RTOL,
                                       err_msg=f"step {i} {key}")
        ref = from_jax_params(jax.tree.map(np.asarray, jstate.params))
        got = {name: value.clone() for name, value in tm.module.state_dict().items()}
        with torch.no_grad():
            for name, p in tm.module.named_parameters():
                zero = _zero_gradient_slices(name, e)
                if zero is not None:
                    p[zero] = ref[name][zero]
    assert sorted(got) == sorted(ref)
    for name, value in got.items():
        ours, theirs = value.numpy(), ref[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            assert not np.allclose(ours, 0.0 if name.endswith("mean") else 1.0), name
        zero = _zero_gradient_slices(name, e)
        if zero is not None:
            np.testing.assert_allclose(ours[zero], theirs[zero], atol=2 * lr, rtol=0,
                                       err_msg=name)
            ours, theirs = np.delete(ours, np.s_[zero]), np.delete(theirs, np.s_[zero])
        np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=RTOL, err_msg=name)


def test_eval_step_reads_the_running_stats():
    """``make_eval_step`` on the forecasting model runs it in eval mode: the
    forecast reads the running statistics, not the batch's."""
    jm, params, tm = _pair(stats_seed=4)
    x, _ = _series(8, seed=5)
    tm.module.train()
    train_out = tm.apply(_t(x))
    with torch.inference_mode():
        acc, loss = tm.eval_step((_t(x), torch.zeros(8, dtype=torch.long)))
    assert not tm.module.training
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(tm.apply(_t(x)).detach().numpy(), want, atol=ATOL, rtol=RTOL)
    assert not np.allclose(train_out.detach().numpy(), want, atol=1e-2)
    assert np.isfinite(float(loss)) and 0.0 <= float(acc) <= 1.0


# ---------------------------------------------------------------------------
# The attention kernels at head width 8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l,causal", [(9, False), (64, False), (17, True), (65, True)],
                         ids=["full9", "full64", "causal17", "causal65"])
def test_packed_plain_versions_d8_match_jax_kernel(l, causal):
    """K1's and K2's plain versions at d = 8 (2 heads over E = 16) against
    the JAX ``fused_mha_packed`` in Pallas interpret mode and its ``jax.vjp``:
    the output, dqkv and db."""
    h, d = 2, 8
    e = h * d
    rng = np.random.default_rng(500 + l)
    qkv = (rng.normal(size=(2, l, 3 * e)) * 0.5).astype(np.float32)
    bias = (rng.normal(size=(3 * e,)) * 0.3).astype(np.float32)
    g = rng.normal(size=(2, l, e)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda q, b: jax_attention.fused_mha_packed(q, h, causal, bias=b),
                           jnp.asarray(qkv), jnp.asarray(bias))
        ref_dqkv, ref_db = vjp(jnp.asarray(g))
    got = A.packed_mha_reference(_t(qkv), h, causal=causal, bias=_t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=K_ATOL, rtol=K_RTOL)
    dqkv, db = A.packed_mha_bwd_reference(_t(qkv), _t(bias), _t(g), h, causal=causal)
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(ref_dqkv), atol=K_ATOL, rtol=K_RTOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(ref_db), atol=K_ATOL, rtol=K_RTOL)


def test_bf16_route_is_packed_at_d8(monkeypatch):
    """PatchTST base in bfloat16 (E = 128 over 16 heads, L = 64): the JAX
    package takes Pallas (``resolve_impl``) and its packed kernels
    (``packed_mha_supported``), so the port takes K1 and K2."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    assert jax_common.resolve_impl("auto", seq_len=64, dtype=jnp.bfloat16) == "pallas"
    assert jax_attention.packed_mha_supported(64, 128, 16)
    assert A.packed_mha_supported(64, 128, 16)
    assert A.attention_route("auto", "cuda", seq_len=64, emb_dim=128, n_heads=16,
                             dtype=torch.bfloat16) == "packed"
    # the float32 default stays on the plain path in both (below 512)
    assert jax_common.resolve_impl("auto", seq_len=64, dtype=jnp.float32) == "xla"
    assert A.attention_route("auto", "cuda", seq_len=64, emb_dim=128, n_heads=16,
                             dtype=torch.float32) == "plain"


def test_float32_pallas_route_matches_jax(one_thread, monkeypatch):
    """PatchTST at its float32 default under ``attn_impl="pallas"``: the JAX
    package sends float32 at d = 8 to its flash kernel (``_flash_kernel``,
    ``_flash_bwd_kernel``; interpret mode here), the port to K4 and K5 on the
    card (``attention_route`` "flash", PatchTST base's geometry) and to their
    plain versions on the CPU. Train-mode forecasts and every gradient of an
    MSE loss at 1e-4 / 1e-4."""
    config = {**TINY, "attn_impl": "pallas"}
    jm, params, tm = _pair(config, seed=13)
    assert A.attention_route("pallas", "cuda", seq_len=64, emb_dim=128, n_heads=16,
                             dtype=torch.float32) == "flash"
    calls = []
    real = jax_attention._flash_forward

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(jax_attention, "_flash_forward", counted)
    x, y = _series(8, seed=14)

    def loss(p):
        out = jm.apply(p, jnp.asarray(x), deterministic=False)
        return jnp.mean(jnp.square(out - jnp.asarray(y))), out

    with pltpu.force_tpu_interpret_mode():
        (_, want_out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    assert calls and all(shape[-1] == 8 for shape in calls)  # the flash kernel at d = 8
    want = from_jax_params(jax.tree.map(np.asarray, grads))
    launches = (A.flash_attention.launches, A.flash_bwd.launches)
    tm.module.train()
    out, _, got = _loss_and_grads(tm.module, _t(x), _t(y))
    assert (A.flash_attention.launches, A.flash_bwd.launches) == launches
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL, rtol=RTOL)
    e = TINY["emb_dim"]
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=name)
        if _zero_gradient_slices(name, e) is None:
            assert np.abs(g.numpy()).max() > 0, name


# ---------------------------------------------------------------------------
# The preset, its pretrained load and the converters
# ---------------------------------------------------------------------------


def test_patchtst_base_names_and_shapes():
    """``build_model({"implementation": "patchtst"})`` (the meta device: no
    allocation) against the JAX ``build_patchtst``: every parameter and
    running statistic, linear weights transposed."""
    jm = jax_build_model({"implementation": "patchtst"}, key=jax.random.key(0))
    want = {name: tuple(a.shape) for name, a in _flat(jm.params).items()}
    with torch.device("meta"):
        tm = build_model({"implementation": "patchtst"}, device="meta")
    got = {name: tuple(t.shape) for name, t in tm.module.state_dict().items()}
    assert sorted(got) == sorted(want)
    for name, shape in got.items():
        expect = want[name][::-1] if _transposed(name, len(shape), got) else want[name]
        assert shape == expect, name
    assert tm.name == "patchtst-base-patch16-512"
    cfg = tm.config
    assert (cfg.n_patches, cfg.seq_len, cfg.head_dim) == (64, 64, 8)
    assert got["embedding.token_emb.weight"] == (128, 16)
    assert got["output.output_layer.head.weight"] == (96, 64 * 128)


def _vitef_state_dict(params) -> dict:
    """A JAX PatchTST tree as the reference's torch state dict: linear weights
    (out, in), batch norms inside their ``BatchNorm1d`` wrapper (with
    ``num_batches_tracked``), the forecasting head as ``output``."""
    sd = {}
    for name, t in from_jax_params(jax.tree.map(np.asarray, params)).items():
        name = name.replace("output.output_layer.head.", "output.output_layer.output.")
        for norm in ("attn_norm", "ffn_norm"):
            if f".{norm}." in name:
                prefix, _, leaf = name.rpartition(".")
                name = f"{prefix}.batchnorm.{leaf}"
                sd[f"{prefix}.batchnorm.num_batches_tracked"] = np.array(7, np.int64)
        sd[name] = t.numpy()
    return sd


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_local_pretrained_load(tmp_path, fmt):
    """``pretrained=True`` reads ``<save_dir>/<name>.npz`` (else ``.pt``) in
    the reference's names in both packages; the loaded models forecast alike
    in eval mode (running statistics from the file)."""
    config = {"implementation": "patchtst", "pretrained": True, "save_dir": str(tmp_path),
              "seed": 3}
    _, params, _ = _pair({"implementation": "patchtst"}, seed=5, stats_seed=6)
    sd = _vitef_state_dict(params)
    path = tmp_path / f"patchtst-base-patch16-512.{fmt}"
    if fmt == "npz":
        np.savez(path, **sd)
    else:
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    jm = jax_build_model(config, key=jax.random.key(0))
    tm = build_model(config, device="cpu")
    state = tm.module.state_dict()
    for name, value in from_jax_params(jax.tree.map(np.asarray, params)).items():
        torch.testing.assert_close(state[name], value, rtol=0, atol=0, msg=name)
    x, _ = _series(4, seed=7, length=512, horizon=96)
    np.testing.assert_allclose(tm.apply_eval(_t(x)).detach().numpy(),
                               np.asarray(jm.apply(jm.params, jnp.asarray(x))),
                               atol=ATOL, rtol=RTOL)


def test_linear_token_emb_and_stats_round_trip():
    """``from_jax_params`` transposes the linear token embedding (with its
    bias) like any linear weight, keeps the running statistics, transposes
    the forecasting head, and ``to_jax_params`` undoes it all."""
    _, params, tm = _pair(stats_seed=8)
    flat = _flat(params)
    state = from_jax_params(jax.tree.map(np.asarray, params))
    np.testing.assert_array_equal(state["embedding.token_emb.weight"].numpy(),
                                  flat["embedding.token_emb.weight"].T)
    assert tuple(state["embedding.token_emb.weight"].shape) == (32, 16)
    assert tuple(state["output.output_layer.head.weight"].shape) == (HORIZON, 8 * 32)
    np.testing.assert_array_equal(state["blocks.1.ffn_norm.running_var"].numpy(),
                                  flat["blocks.1.ffn_norm.running_var"])
    back = to_jax_params(tm.module.state_dict())
    assert sorted(back) == sorted(flat)
    for name, value in flat.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)


# ---------------------------------------------------------------------------
# remat and dropout
# ---------------------------------------------------------------------------


def _loss_and_grads(module, x, y, generator=None):
    module.zero_grad(set_to_none=True)
    out, stats = module(x, return_stats=True, generator=generator)
    loss = _mse(out, y)
    loss.backward()
    return out.detach(), stats, {n: p.grad.clone() for n, p in module.named_parameters()}


@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["no_dropout", "dropout"])
def test_remat_matches_no_remat_and_jax(one_thread, rate):
    """Train mode in float32: the forecasts, batch statistics and gradients
    with ``remat`` equal those without it (with dropout, from the same
    generator seed: a recomputed block draws its masks again); without
    dropout they match the JAX package's with ``remat=True``."""
    config = {**TINY, "dropout": rate}
    jm, params, plain = _pair(config, seed=9)
    remat = build_model({**config, "remat": True}, device="cpu")
    remat.module.load_state_dict(plain.module.state_dict())
    x, y = _series(8, seed=11)
    plain.module.train()
    remat.module.train()
    runs = [_loss_and_grads(m.module, _t(x), _t(y),
                            torch.Generator().manual_seed(5) if rate else None)
            for m in (plain, remat)]
    (out, stats, grads), (r_out, r_stats, r_grads) = runs
    assert torch.equal(out, r_out)
    for site in stats:
        for key in stats[site]:
            assert torch.equal(stats[site][key], r_stats[site][key])
    for name in grads:
        assert torch.equal(grads[name], r_grads[name]), name
    if rate:
        return
    jcfg = jax_build_model({**config, "remat": True}, key=jax.random.key(9)).config
    assert jcfg.remat

    def forward(p):
        return apply_transformer(p, jcfg, jnp.asarray(x), deterministic=False)

    np.testing.assert_allclose(r_out.numpy(), np.asarray(forward(params)), atol=ATOL,
                               rtol=RTOL)
    want = from_jax_params(jax.tree.map(np.asarray, jax.grad(
        lambda p: jnp.mean(jnp.square(forward(p) - jnp.asarray(y))))(params)))
    e = TINY["emb_dim"]
    for name, g in r_grads.items():
        ours, theirs = g.numpy(), want[name].numpy()
        np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=RTOL, err_msg=name)
        if _zero_gradient_slices(name, e) is None:
            assert np.abs(ours).max() > 0, name


def test_dropout_matches_jax_formula(monkeypatch):
    """keep = 1 − rate, a Bernoulli mask (uniform < keep), ``where(mask, x /
    keep, 0)``: on the port's mask, the JAX ``dropout`` gives the same values
    bit for bit; rate 0 and eval mode are the identity; a rate without a
    generator (an rng) raises in both."""
    x = np.random.default_rng(0).normal(size=(4, 9, 32)).astype(np.float32)
    rate = 0.3
    got = dropout(_t(x), rate, torch.Generator().manual_seed(1), deterministic=False)
    mask = torch.rand(x.shape, generator=torch.Generator().manual_seed(1)) < 1 - rate
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda rng, p, shape: jnp.asarray(mask.numpy()))
    want = jax_common.dropout(jnp.asarray(x), rate, jax.random.key(0), deterministic=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.6 < float(mask.float().mean()) < 0.8
    for args in ((0.0, torch.Generator(), False), (rate, None, True)):
        assert dropout(_t(x), *args) is not None
        np.testing.assert_array_equal(dropout(_t(x), *args).numpy(), x)
    with pytest.raises(ValueError, match="generator"):
        dropout(_t(x), rate, None, deterministic=False)
    with pytest.raises(ValueError, match="rng"):
        jax_common.dropout(jnp.asarray(x), rate, None, deterministic=False)


def _site_values(module, site: str, x, generator=None):
    """The values at a dropout site, after its dropout: the embedding's
    output, block 0's attention or FFN output, the forecasting head's input."""
    seen = []
    if site == "output_dropout":
        hook = module.output.output_layer["head"].register_forward_pre_hook(
            lambda m, args: seen.append(args[0].detach()))
    else:
        target = {"emb_dropout": module.embedding, "attn_dropout": module.blocks[0].attn,
                  "ffn_dropout": module.blocks[0].ffn}[site]
        hook = target.register_forward_hook(lambda m, args, out: seen.append(out.detach()))
    try:
        module(x, generator=generator)
    finally:
        hook.remove()
    return seen[0]


@pytest.mark.parametrize("site", SITES)
def test_dropout_each_site_alone(one_thread, site):
    """One site's rate at 0.5, the others 0, in train mode: the site's values
    are those of the same model at rate 0, each zeroed (a share within 5σ of
    0.5) or divided by 0.5, bit for bit; the same seed repeats the masks, and
    another seed does not."""
    rate = 0.5
    _, _, base = _pair()
    drop = build_model({**TINY, site: rate}, device="cpu")
    drop.module.load_state_dict(base.module.state_dict())
    base.module.train()
    drop.module.train()
    x = _t(_series(8, seed=12)[0])
    want = _site_values(base.module, site, x)
    got = _site_values(drop.module, site, x, torch.Generator().manual_seed(3))
    kept = got != 0
    share = 1 - float(kept.float().mean())
    assert abs(share - rate) < 5 * np.sqrt(rate * (1 - rate) / got.numel()), share
    assert torch.equal(got[kept], want[kept] / (1 - rate))
    again = _site_values(drop.module, site, x, torch.Generator().manual_seed(3))
    other = _site_values(drop.module, site, x, torch.Generator().manual_seed(4))
    assert torch.equal(got, again) and not torch.equal(got, other)
    with pytest.raises(ValueError, match="generator"):
        drop.module(x)


def test_dropout_eval_mode_is_rate_zero():
    """In eval mode every rate is inactive: the model at rate 0.3 on all four
    sites forecasts what it does at rate 0, with a generator or without."""
    _, _, base = _pair(stats_seed=13)
    drop = build_model({**TINY, "dropout": 0.3}, device="cpu")
    drop.module.load_state_dict(base.module.state_dict())
    assert all(getattr(drop.config, s) == 0.3 for s in SITES)
    x = _t(_series(8, seed=14)[0])
    want = base.apply_eval(x)
    assert torch.equal(drop.apply_eval(x), want)
    assert torch.equal(drop.apply_eval(x, generator=torch.Generator().manual_seed(0)), want)
