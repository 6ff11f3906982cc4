"""The port's MoE slice vs the JAX package, on the CPU, in float32.

The same seeded numpy inputs go through both packages: the plain versions of
the grouped-product kernels K8 (``gmm``, ``tgmm``) and K7 (the four
swiglu-fused passes) against the JAX package's per-group formula (the
reference its own test holds the fused segment to,
tests/test_moe_sparse.py:205-213), with uneven group sizes and an empty
group, and ``gmm``'s, ``gmm_swiglu``'s, ``gmm_dy_swiglu``'s and
``gmm_dual``'s at the edges of their kernel's tiles (groups ending one row
either side of a 128-row boundary, empty first and last groups, fewer rows
than a tile, a depth not a multiple of 64, so that K7's gate/up and a/b seams
fall inside a stage, and a width not a multiple of the column tile),
``tgmm``'s and ``tgmm_swiglu``'s at the edges of their 64-row boxes (and f
of 72 and 136); the port's sparse and dense MoE FFN
against the JAX dense oracle
``apply_moe_ffn``, forward and gradients; the router's tie order and aux
losses; the sparse/dense branch rule; the counting sort; a tiny MoE model's
logits and three AdamW steps with the aux losses; the 8x124m preset's names
and shapes; and the weight converter on expert stacks. The JAX package's
sparse path (Pallas interpret mode) is not run here: its own tests hold it
equal to the dense oracle.
"""

from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vitef_tpu import optim as jax_optim
from vitef_tpu import ops as jax_ops
from vitef_tpu.models import build_model as jax_build_model
from vitef_tpu.models import moe as jax_moe_models
from vitef_tpu.models.transformer import init_transformer
from vitef_tpu.parallel import init_train_state as jax_init_train_state
from vitef_tpu.parallel import make_train_step as jax_make_train_step
from vitef_tpu.parallel import moe as jax_moe
from vitef_tpu.utils.tree import keystr_dotted
from vitef_tpu_torch import ops, optim
from vitef_tpu_torch.models import build_model, from_jax_params
from vitef_tpu_torch.models import moe as moe_models
from vitef_tpu_torch.ops import gmm as G
from vitef_tpu_torch.ops import gmm_fused as GF
from vitef_tpu_torch.parallel import init_train_state, make_train_step
from vitef_tpu_torch.parallel import moe as M

# float32 parity: the same algorithm on both sides, summed in another order.
ATOL, RTOL = 2e-5, 1e-4
SIZES = [5, 0, 11, 1, 15]          # uneven, one empty group, G = 32


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _jax_per_group(lhs, rhs, sizes):
    """The JAX package's per-group reference: lhs[rows of e] @ rhs[e]."""
    outs, start = [], 0
    for e, n in enumerate(sizes):
        outs.append(jnp.asarray(lhs[start:start + n]) @ jnp.asarray(rhs[e]))
        start += n
    return np.asarray(jnp.concatenate(outs, 0))


def _jax_swiglu_y(h):
    f = h.shape[1] // 2
    h = jnp.asarray(h)
    return np.asarray(jax.nn.silu(h[:, :f]) * h[:, f:])


# ---------------------------------------------------------------------------
# K8 and K7: the plain versions
# ---------------------------------------------------------------------------


def _case(name, rng):
    """(port call, JAX per-group reference) of one grouped product."""
    e, k, n, f = len(SIZES), 24, 16, 8
    g_rows = sum(SIZES)
    sizes = _t(np.asarray(SIZES, np.int64))
    if name == "gmm":
        lhs, rhs = _normal(rng, g_rows, k), _normal(rng, e, k, n)
        return (lambda: G.gmm(_t(lhs), _t(rhs), sizes)), _jax_per_group(lhs, rhs, SIZES)
    if name == "tgmm":
        lhs, rhs = _normal(rng, g_rows, k), _normal(rng, g_rows, n)
        ref, start = [], 0
        for size in SIZES:
            ref.append(np.asarray(jnp.asarray(lhs[start:start + size]).T
                                  @ jnp.asarray(rhs[start:start + size])))
            start += size
        return (lambda: G.tgmm(_t(lhs).t(), _t(rhs), sizes, e)), np.stack(ref)
    if name == "gmm_swiglu":
        h, w2 = _normal(rng, g_rows, 2 * f), _normal(rng, e, f, n)
        return (lambda: GF.gmm_swiglu(_t(h), _t(w2), sizes),
                _jax_per_group(_jax_swiglu_y(h), w2, SIZES))
    if name == "gmm_dy_swiglu":
        g, w2t, h = _normal(rng, g_rows, n), _normal(rng, e, n, f), _normal(rng, g_rows, 2 * f)
        dy = jnp.asarray(_jax_per_group(g, w2t, SIZES))
        _, vjp = jax.vjp(lambda hh: jax.nn.silu(hh[:, :f]) * hh[:, f:], jnp.asarray(h))
        (dh,) = vjp(dy)
        return (lambda: GF.gmm_dy_swiglu(_t(g), _t(w2t), _t(h), sizes),
                (np.asarray(dh[:, :f]), np.asarray(dh[:, f:])))
    if name == "tgmm_swiglu":
        h, g = _normal(rng, g_rows, 2 * f), _normal(rng, g_rows, n)
        y, ref, start = _jax_swiglu_y(h), [], 0
        for size in SIZES:
            ref.append(np.asarray(jnp.asarray(y[start:start + size]).T
                                  @ jnp.asarray(g[start:start + size])))
            start += size
        return (lambda: GF.tgmm_swiglu(_t(h), _t(g), sizes)), np.stack(ref)
    assert name == "gmm_dual"
    a, b, rt = _normal(rng, g_rows, f), _normal(rng, g_rows, f), _normal(rng, e, 2 * f, n)
    return (lambda: GF.gmm_dual(_t(a), _t(b), _t(rt), sizes),
            _jax_per_group(a, rt[:, :f], SIZES) + _jax_per_group(b, rt[:, f:], SIZES))


@pytest.mark.parametrize("name", ["gmm", "tgmm", "gmm_swiglu", "gmm_dy_swiglu",
                                  "tgmm_swiglu", "gmm_dual"])
def test_grouped_plain_versions_match_jax_formula(name):
    call, ref = _case(name, np.random.default_rng(50))
    wrapper = getattr(GF, name, None) or getattr(G, name)
    launches = wrapper.launches
    out = call()
    assert wrapper.launches == launches  # a CPU tensor takes the plain version
    for got, want in zip(out if isinstance(out, tuple) else (out,),
                         ref if isinstance(ref, tuple) else (ref,)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    if name.startswith("tgmm"):
        assert not out[1].any()  # the empty group


# Layouts at the edges of csrc/gmm.cu's kPlain tiles (128 rows, column tiles
# of 128 or 256, 64 deep per stage): (group sizes, k, n).
GMM_TILE_EDGES = {
    "groups_end_one_row_before_and_after_128": ([127, 2, 127], 64, 64),
    "empty_first_and_last_group": ([0, 100, 60, 0], 64, 64),
    "rows_below_one_tile": ([20, 0, 30], 64, 64),
    "k_not_a_stage_multiple": ([64, 70], 72, 64),
    "n_not_a_column_tile_multiple": ([40, 90], 64, 136),
}


@pytest.mark.parametrize("case", list(GMM_TILE_EDGES))
def test_gmm_plain_version_at_tile_edges(case):
    sizes, k, n = GMM_TILE_EDGES[case]
    rng = np.random.default_rng(53)
    lhs, rhs = _normal(rng, sum(sizes), k), _normal(rng, len(sizes), k, n)
    want = _jax_per_group(lhs, rhs, sizes)
    group_sizes = _t(np.asarray(sizes, np.int64))
    launches = G.gmm.launches
    for got in (G.gmm_reference(_t(lhs), _t(rhs), group_sizes),
                G.gmm(_t(lhs), _t(rhs), group_sizes)):
        assert got.shape == (sum(sizes), n) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert G.gmm.launches == launches  # a CPU tensor takes the plain version


# Layouts at the edges of csrc/gmm.cu's TMA pipeline in K7's two modes
# (128-row tiles, column tiles of 128 or 256, 64-deep stages; gmm_swiglu's
# gate/up seam and gmm_dual's a/b seam fall inside a stage when f is not a
# multiple of 64): (group sizes, f, n).
K7_TILE_EDGES = {
    "f_72_seam_inside_a_stage": ([64, 70], 72, 64),
    "f_136_seam_inside_a_stage": ([40, 90], 136, 64),
    "groups_end_one_row_before_and_after_128": ([127, 2, 127], 64, 64),
    "empty_first_and_last_group": ([0, 100, 60, 0], 64, 64),
    "rows_below_one_tile": ([20, 0, 30], 64, 64),
    "n_not_a_column_tile_multiple": ([40, 90], 64, 136),
}


@pytest.mark.parametrize("case", list(K7_TILE_EDGES))
@pytest.mark.parametrize("name", ["gmm_swiglu", "gmm_dy_swiglu", "gmm_dual"])
def test_k7_plain_versions_at_tile_edges(name, case):
    sizes, f, n = K7_TILE_EDGES[case]
    rng = np.random.default_rng(55)
    g_rows, e = sum(sizes), len(sizes)
    group_sizes = _t(np.asarray(sizes, np.int64))
    if name == "gmm_swiglu":
        h, w2 = _normal(rng, g_rows, 2 * f), _normal(rng, e, f, n)
        want = _jax_per_group(_jax_swiglu_y(h), w2, sizes)
        calls = (lambda: GF.gmm_swiglu_reference(_t(h), _t(w2), group_sizes),
                 lambda: GF.gmm_swiglu(_t(h), _t(w2), group_sizes))
    elif name == "gmm_dy_swiglu":
        # The ping-pong's column halves and h's gate/up boxes meet these
        # edges: dy = g @ w2t[e] (width n in, f out), the swiglu backward
        # on it against h, as jax.vjp of silu(hg) hu gives it.
        g, w2t, h = _normal(rng, g_rows, n), _normal(rng, e, n, f), _normal(rng, g_rows, 2 * f)
        dy = jnp.asarray(_jax_per_group(g, w2t, sizes))
        _, vjp = jax.vjp(lambda hh: jax.nn.silu(hh[:, :f]) * hh[:, f:], jnp.asarray(h))
        (dh,) = vjp(dy)
        want = (np.asarray(dh[:, :f]), np.asarray(dh[:, f:]))
        calls = (lambda: GF.gmm_dy_swiglu_reference(_t(g), _t(w2t), _t(h), group_sizes),
                 lambda: GF.gmm_dy_swiglu(_t(g), _t(w2t), _t(h), group_sizes))
    else:
        a, b, rt = _normal(rng, g_rows, f), _normal(rng, g_rows, f), _normal(rng, e, 2 * f, n)
        want = _jax_per_group(a, rt[:, :f], sizes) + _jax_per_group(b, rt[:, f:], sizes)
        calls = (lambda: GF.gmm_dual_reference(_t(a), _t(b), _t(rt), group_sizes),
                 lambda: GF.gmm_dual(_t(a), _t(b), _t(rt), group_sizes))
    wrapper = getattr(GF, name)
    launches = wrapper.launches
    for call in calls:
        got = call()
        for out, ref in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
            assert out.shape == ref.shape and out.dtype == torch.float32
            np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    assert wrapper.launches == launches  # a CPU tensor takes the plain version


# Layouts at the edges of csrc/tgmm.cu's kPlain pipeline (stages 64 rows of
# G deep, whose boxes start at a group's first row and reach into the next
# group; output tiles 128 x 128 or 128 x 256): (group sizes, k, n).
TGMM_TILE_EDGES = {
    "groups_start_and_end_inside_a_64_row_box": ([63, 2, 65], 64, 64),
    "empty_first_and_last_group": ([0, 70, 0, 60, 0], 64, 64),
    "one_row_group": ([30, 1, 40], 64, 64),
    "k_not_a_box_multiple": ([64, 70], 72, 64),
    "n_not_a_column_tile_multiple": ([40, 90], 64, 136),
}


@pytest.mark.parametrize("case", list(TGMM_TILE_EDGES))
def test_tgmm_plain_version_at_tile_edges(case):
    sizes, k, n = TGMM_TILE_EDGES[case]
    rng = np.random.default_rng(54)
    lhs, rhs = _normal(rng, sum(sizes), k), _normal(rng, sum(sizes), n)
    bounds = np.cumsum([0] + sizes)
    want = np.stack([np.asarray(jnp.asarray(lhs[a:b]).T @ jnp.asarray(rhs[a:b]))
                     for a, b in zip(bounds[:-1], bounds[1:])])
    group_sizes = _t(np.asarray(sizes, np.int64))
    launches = G.tgmm.launches
    for got in (G.tgmm_reference(_t(lhs).t(), _t(rhs), group_sizes, len(sizes)),
                G.tgmm(_t(lhs).t(), _t(rhs), group_sizes, len(sizes))):
        assert got.shape == (len(sizes), k, n) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
        assert all(not got[e].any() for e, size in enumerate(sizes) if size == 0)
    assert G.tgmm.launches == launches  # a CPU tensor takes the plain version


# tgmm_swiglu on csrc/tgmm.cu's pipeline: its gate and up boxes are 64 rows
# of G by 64 columns of f, so besides tgmm's edges, f = 72 and 136 put the
# end of f inside a box: (group sizes, f, n).
TGMM_SWIGLU_EDGES = {**TGMM_TILE_EDGES,
                     "f_72_inside_a_box": ([63, 2, 65], 72, 64),
                     "f_136_inside_a_box": ([127, 2, 129], 136, 72)}


@pytest.mark.parametrize("case", list(TGMM_SWIGLU_EDGES))
def test_tgmm_swiglu_plain_version_at_tile_edges(case):
    sizes, f, n = TGMM_SWIGLU_EDGES[case]
    rng = np.random.default_rng(56)
    h, g = _normal(rng, sum(sizes), 2 * f), _normal(rng, sum(sizes), n)
    y, bounds = _jax_swiglu_y(h), np.cumsum([0] + sizes)
    want = np.stack([np.asarray(jnp.asarray(y[a:b]).T @ jnp.asarray(g[a:b]))
                     for a, b in zip(bounds[:-1], bounds[1:])])
    group_sizes = _t(np.asarray(sizes, np.int64))
    launches = GF.tgmm_swiglu.launches
    for got in (GF.tgmm_swiglu_reference(_t(h), _t(g), group_sizes),
                GF.tgmm_swiglu(_t(h), _t(g), group_sizes)):
        assert got.shape == (len(sizes), f, n) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
        assert all(not got[e].any() for e, size in enumerate(sizes) if size == 0)
    assert GF.tgmm_swiglu.launches == launches  # a CPU tensor takes the plain version


def test_grouped_plain_versions_check_sizes():
    with pytest.raises(ValueError, match="sum to"):
        G.gmm(torch.zeros(4, 8), torch.zeros(2, 8, 8), torch.tensor([1, 2]))


# ---------------------------------------------------------------------------
# The MoE FFN: sparse and dense against the JAX dense oracle
# ---------------------------------------------------------------------------


def _ffn_pair(geometry, top_k, seed):
    """(JAX cfg, JAX params, port cfg, port params) of one MoE FFN."""
    jcfg = jax_moe_models.moe_transformer_config(jax_moe_models.MoeConfig(model_name="tiny"))
    tcfg = moe_models.moe_transformer_config(moe_models.MoeConfig(model_name="tiny"))
    if geometry == "fused":    # d and f multiples of 128 (tests/test_moe_sparse.py:242)
        jcfg = replace(jcfg, emb_dim=128, ffn_dim=128, n_heads=4)
        tcfg = replace(tcfg, emb_dim=128, ffn_dim=128, n_heads=4)
    jparams = jax_moe.init_moe_ffn(jax.random.PRNGKey(seed), jcfg, jcfg.n_experts)
    module = M.init_moe_ffn(tcfg, tcfg.n_experts, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, tcfg, module


@pytest.mark.parametrize("impl", ["sparse", "dense"])
@pytest.mark.parametrize("geometry,top_k", [("tiny", 2), ("fused", 2), ("tiny", 1),
                                            ("tiny", 4)],
                         ids=["tiny_unfused", "fused", "top1", "topE"])
def test_moe_ffn_matches_jax_dense(geometry, top_k, impl, monkeypatch):
    jcfg, jparams, tcfg, module = _ffn_pair(geometry, top_k, seed=51 + top_k)
    rng = np.random.default_rng(52)
    x = _normal(rng, 2, 21, tcfg.emb_dim)
    cot = _normal(rng, 2, 21, tcfg.emb_dim)

    def jloss(p, xx):
        out = jax_moe.apply_moe_ffn(p, jcfg, xx, top_k=top_k)
        return jnp.sum(out * cot), out

    (_, ref), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(x))

    segments = []
    monkeypatch.setattr(M._FfnSegmentSwiglu, "apply",
                        lambda *a, _f=M._FfnSegmentSwiglu.apply: segments.append(1) or _f(*a))
    fn = M.apply_moe_ffn_sparse if impl == "sparse" else M.apply_moe_ffn
    xt = _t(x).requires_grad_()
    out = fn(module.params(), tcfg, xt, top_k=top_k)
    (out * _t(cot)).sum().backward()
    assert len(segments) == (impl == "sparse" and geometry == "fused")

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=ATOL, rtol=RTOL)
    want = from_jax_params(jax.tree.map(np.asarray, gp))
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_gather_only_row_functions_match_jax():
    """Dispatch, combine and permute, forward and backward (their gathers
    written out as custom VJPs in both packages), on a k-major claim sort."""
    rng = np.random.default_rng(60)
    t_tokens, d, top_k = 9, 8, 2
    ids = rng.integers(0, 3, size=t_tokens * top_k).astype(np.int32)
    perm, inv, _ = (np.asarray(a) for a in jax_moe._counting_sort(jnp.asarray(ids), 3))
    src = perm % t_tokens
    x, ys, gate = (_normal(rng, t_tokens, d), _normal(rng, t_tokens * top_k, d),
                   _normal(rng, t_tokens, top_k))
    g_claims, g_tokens = _normal(rng, t_tokens * top_k, d), _normal(rng, t_tokens, d)
    ti = {name: _t(a.astype(np.int64)) for name, a in (("perm", perm), ("inv", inv),
                                                       ("src", src))}

    def check(jax_fn, jax_args, torch_fn, torch_args, cot):
        ref, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in jax_args))
        leaves = [_t(a).requires_grad_() for a in torch_args]
        out = torch_fn(*leaves)
        out.backward(_t(cot))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
        for leaf, want in zip(leaves, vjp(jnp.asarray(cot))):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)

    check(lambda a: jax_moe._dispatch_rows(a, jnp.asarray(src), jnp.asarray(inv), top_k), [x],
          lambda a: M._DispatchRows.apply(a, ti["src"], ti["inv"], top_k), [x], g_claims)
    check(lambda a, b: jax_moe._combine_rows(a, b, jnp.asarray(inv), jnp.asarray(src),
                                             jnp.asarray(perm), top_k), [ys, gate],
          lambda a, b: M._CombineRows.apply(a, b, ti["inv"], ti["perm"], top_k), [ys, gate],
          g_tokens)
    check(lambda a: jax_moe._permute_rows(a, jnp.asarray(perm), jnp.asarray(inv)), [ys],
          lambda a: M._PermuteRows.apply(a, ti["perm"], ti["inv"]), [ys], g_claims)


def test_counting_sort_matches_jax():
    ids = np.random.default_rng(53).integers(0, 5, size=40).astype(np.int32)
    ids[ids == 3] = 2  # an empty expert
    ref = jax_moe._counting_sort(jnp.asarray(ids), 5)
    ours = M._counting_sort(_t(ids.astype(np.int64)), 5)
    for got, want in zip(ours, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Routing: tie order, aux losses, the branch rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top_k", [1, 2, 3, 6])
def test_router_topk_tie_order_matches_jax(top_k):
    scores = np.array([[1.0, 3.0, 3.0, -2.0, 3.0, 0.5],
                       [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                       [-1e4, 2.0, -1e4, 2.0, 1.0, 2.0],
                       [5.0, 4.0, 5.0, 4.0, 5.0, 4.0]], np.float32)
    ref_v, ref_i = jax_moe._router_topk(jnp.asarray(scores), top_k)
    lax_v, lax_i = jax.lax.top_k(jnp.asarray(scores), top_k)
    values, idx = M._router_topk(_t(scores), top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(lax_i))
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_v))


def test_router_aux_matches_jax():
    jcfg, jparams, tcfg, module = _ffn_pair("tiny", 2, seed=54)
    x = _normal(np.random.default_rng(55), 3, 17, tcfg.emb_dim)
    ref = jax_moe.router_aux(jparams, jcfg, jnp.asarray(x), 2)
    ours = M.router_aux(module.params(), tcfg, _t(x), 2)
    for key in ("lb", "z"):
        np.testing.assert_allclose(float(ours[key].detach()), float(ref[key]), rtol=1e-5,
                                   err_msg=key)
    # the aux a forward collects comes from its own routing, in both branches
    for fn in (M.apply_moe_ffn, M.apply_moe_ffn_sparse):
        aux = {}
        with torch.no_grad():
            fn(module.params(), tcfg, _t(x), top_k=2, aux=aux)
        np.testing.assert_allclose(float(aux["lb"]), float(ref["lb"]), rtol=1e-5)
        np.testing.assert_allclose(float(aux["z"]), float(ref["z"]), rtol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "dense", "sparse", "ep_sparse"])
def test_resolve_moe_impl_matches_jax(impl, monkeypatch):
    """The same branch as the JAX package on a single TPU (its backend
    patched to read "tpu"), the port given a CUDA device."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    e, d, f1 = 8, 16, 32
    for n_tokens in (None, 1, 2, 3, 8, 100, 2047, 2048, 8192):
        for int8 in (False, True):
            for bias in (False, True):
                jcfg = replace(jax_moe_models.moe_transformer_config(
                    jax_moe_models.MoeConfig(model_name="tiny")), moe_impl=impl, moe_top_k=2)
                tcfg = replace(moe_models.moe_transformer_config(
                    moe_models.MoeConfig(model_name="tiny")), moe_impl=impl, moe_top_k=2)
                jfc1 = {"weight": jnp.zeros((e, d, f1), jnp.int8 if int8 else jnp.float32)}
                tfc1 = {"weight": torch.zeros((e, d, f1),
                                              dtype=torch.int8 if int8 else torch.float32)}
                if bias:
                    jfc1["bias"], tfc1["bias"] = jnp.zeros((e, f1)), torch.zeros(e, f1)
                try:
                    want = jax_moe.resolve_moe_impl(jcfg, {"fc1": jfc1}, n_tokens, n_devices=1)
                except ValueError:
                    with pytest.raises(ValueError):
                        M.resolve_moe_impl(tcfg, {"fc1": tfc1}, n_tokens, device="cuda")
                    continue
                got = M.resolve_moe_impl(tcfg, {"fc1": tfc1}, n_tokens, device="cuda")
                assert got == want, (n_tokens, int8, bias)
                # off CUDA, auto takes the dense oracle
                if impl == "auto":
                    assert M.resolve_moe_impl(tcfg, {"fc1": tfc1}, n_tokens,
                                              device="cpu") == "dense"


# ---------------------------------------------------------------------------
# The tiny MoE model
# ---------------------------------------------------------------------------


def _moe(size="tiny", **kw):
    return {"implementation": "moe", "model_name": size, **kw}


TINY = _moe(moe_impl="dense", attn_impl="xla", norm_impl="xla")
AUX_COEFS = (0.01, 0.001)
OPT_CFG = {"optimizer": "adamw", "lr": 1e-3, "weight_decay": 0.1}
SCHED_CFG = {"scheduler": "cosine", "warmup": 1}


def _train_batches():
    rng = np.random.default_rng(57)
    return [rng.integers(0, 256, size=(4, 16)).astype(np.int32) for _ in range(3)]


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX tiny MoE (dense, XLA attention): its logits and aux on one
    batch, and its metrics and parameters over three train steps — computed
    once for both of the port's branches."""
    jm = jax_build_model(TINY, key=jax.random.key(0))
    toks = np.random.default_rng(56).integers(0, 256, size=(2, 24)).astype(np.int32)
    logits, aux = jm.apply(jm.params, jnp.asarray(toks), return_moe_aux=True)
    schedule = jax_optim.build_scheduler(SCHED_CFG, n_steps=10)
    tx, _ = jax_optim.build_optimizer(OPT_CFG, schedule=schedule, grad_clip=1.0)
    step = jax_make_train_step(jm.apply, tx, grad_acc_steps=2, schedule=schedule,
                               base_lr=1e-3, donate=False, moe_aux_coefs=AUX_COEFS,
                               hidden_loss=jax_ops.make_fused_head_loss(jm.config, chunk=48))
    state, metrics = jax_init_train_state(jm.params, tx), []
    for toks_i in _train_batches():
        state, m = step(state, (jnp.asarray(toks_i), jnp.asarray(toks_i)))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"params": jax.tree.map(np.asarray, jm.params), "toks": toks,
            "logits": np.asarray(logits), "aux": {k: float(v) for k, v in aux.items()},
            "metrics": metrics, "trained": from_jax_params(jax.tree.map(np.asarray, state.params))}


def _port_tiny(jax_tiny, impl):
    tm = build_model(TINY, device="cpu")
    tm.module.load_state_dict(from_jax_params(jax_tiny["params"]))
    tm.config.moe_impl = impl
    return tm


@pytest.mark.parametrize("impl", ["dense", "sparse"])
def test_moe_tiny_logits_match_jax(impl, jax_tiny):
    tm = _port_tiny(jax_tiny, impl)
    with torch.inference_mode():
        logits, aux = tm.apply(_t(jax_tiny["toks"]), return_moe_aux=True)
    assert tm.name == "moe-tiny" and logits.shape == (2, 24, 256)
    np.testing.assert_allclose(logits.numpy(), jax_tiny["logits"], atol=1e-4, rtol=1e-4)
    for key in ("lb", "z"):
        np.testing.assert_allclose(float(aux[key]), jax_tiny["aux"][key], rtol=1e-5)


@pytest.mark.parametrize("impl", ["dense", "sparse"])
def test_moe_train_steps_match_jax(impl, jax_tiny):
    """Three AdamW steps of 2 microbatches with the router aux losses
    (``moe_aux_coefs=(0.01, 0.001)``), cosine schedule, clip 1.0 and the
    fused head loss."""
    tm = _port_tiny(jax_tiny, impl)
    schedule = optim.build_scheduler(SCHED_CFG, n_steps=10)
    opt, sched = optim.build_optimizer(OPT_CFG, tm.module, schedule=schedule)
    step = make_train_step(grad_acc_steps=2, schedule=schedule, base_lr=1e-3, grad_clip=1.0,
                           moe_aux_coefs=AUX_COEFS,
                           hidden_loss=ops.make_fused_head_loss(tm.config, chunk=48))
    state = init_train_state(tm, opt, sched)
    for toks, ref in zip(_train_batches(), jax_tiny["metrics"]):
        metrics = step(state, (_t(toks), _t(toks)))
        for key in ("loss", "grad_norm", "lr", "moe_lb", "moe_z"):
            np.testing.assert_allclose(float(metrics[key]), ref[key], rtol=1e-5, err_msg=key)
    for name, p in tm.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jax_tiny["trained"][name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# The 8x124m preset and the weight converter
# ---------------------------------------------------------------------------


def test_moe_8x124m_names_and_shapes_match_jax():
    """Built on the meta device: no allocation of the 0.52B parameters."""
    config = _moe("8x124m", seq_len=1024, compute_dtype="bfloat16")
    with torch.device("meta"):
        tm = build_model(config, device="meta")
    cfg = tm.config
    assert tm.name == "moe-8x124m" and cfg.seq_len == 1024 and cfg.moe_impl == "auto"
    assert (cfg.emb_dim, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim, cfg.n_experts,
            cfg.moe_top_k) == (768, 12, 4, 2048, 8, 2)
    shapes = jax.eval_shape(lambda k: init_transformer(k, jax_moe_models.moe_transformer_config(
        jax_moe_models.MoeConfig(model_name="8x124m", seq_len=1024))), jax.random.key(0))
    ref = {keystr_dotted(path): tuple(leaf.shape)
           for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    # 2-D weights are (in, out) in the JAX package, (out, in) here
    ref = {name: s[::-1] if name.endswith("weight") and len(s) == 2
           and name != "embedding.token_emb.weight" else s for name, s in ref.items()}
    ours = {name: tuple(p.shape) for name, p in tm.module.state_dict().items()}
    assert ours == ref
    assert ours["blocks.0.ffn.fc1.weight"] == (8, 768, 4096)
    assert ours["blocks.0.ffn.router.weight"] == (8, 768)
    assert sum(np.prod(s) for s in ours.values()) == 521_104_128


def test_from_jax_params_keeps_expert_stacks():
    """The router (d, E) transposes; the 3-D expert stacks and the (E, ·)
    expert biases keep their layout."""
    jcfg = replace(jax_moe_models.moe_transformer_config(
        jax_moe_models.MoeConfig(model_name="tiny")), ffn_bias=True)
    jparams = jax.tree.map(np.asarray, jax_moe.init_moe_ffn(jax.random.PRNGKey(58), jcfg, 4))
    state = from_jax_params(jparams)
    np.testing.assert_array_equal(state["router.weight"].numpy(), jparams["router"]["weight"].T)
    for name in ("fc1.weight", "fc2.weight", "fc1.bias", "fc2.bias"):
        layer, leaf = name.split(".")
        np.testing.assert_array_equal(state[name].numpy(), jparams[layer][leaf])
    tcfg = replace(moe_models.moe_transformer_config(moe_models.MoeConfig(model_name="tiny")),
                   ffn_bias=True)
    module = M.init_moe_ffn(tcfg, 4, device="cpu", generator=torch.Generator().manual_seed(0))
    module.load_state_dict(state)  # the names and shapes fit the port's module
    x = _normal(np.random.default_rng(59), 2, 9, 64)
    ref = jax_moe.apply_moe_ffn(jax.tree.map(jnp.asarray, jparams), jcfg, jnp.asarray(x),
                                top_k=2)
    with torch.no_grad():
        out = M.apply_moe_ffn(module.params(), tcfg, _t(x), top_k=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="bias-free"):
        M.resolve_moe_impl(replace(tcfg, moe_impl="sparse"), module.params(), 18, device="cpu")
