"""Mixture-of-experts FFN on one device. Counterpart of ``vitef_tpu/parallel/moe.py``.

The single-device part of the JAX module, with its names:

- :func:`init_moe_ffn` (:41-64) — the router (a bias-free (E, d) weight) and
  the expert stacks, kept in the JAX layout (E, in, out) that the grouped
  kernels read: fc1 (E, d, f1), fc2 (E, f, d), swiglu packing [gate | up] in
  fc1; optional (E, ·) biases. Init U(±1/√fan_in);
- routing: :func:`_router_topk` (:67-98), :func:`_route` (:101-129),
  :func:`router_aux_from_route` and :func:`router_aux` (:147-177);
- the dense oracle :func:`apply_moe_ffn` (:199-233): every expert on every
  token, the gate mask zeroing the unselected ones;
- the dropless sparse dispatch :func:`apply_moe_ffn_sparse` (:666-755):
  k-major claims, a stable counting sort, gather-only dispatch and combine
  (:class:`_DispatchRows`, :class:`_CombineRows`, :class:`_PermuteRows`,
  :236-359) and the grouped expert products: the swiglu-fused segment
  :class:`_FfnSegmentSwiglu` (:574-638; kernels K8 ``gmm``/``tgmm`` and the
  four K7 passes) where :func:`_fused_swiglu_ok` allows it, else the unfused
  :func:`~vitef_tpu_torch.ops.gmm.gmm_autograd` and :class:`_SwigluPlain`;
- :func:`resolve_moe_impl` (:362-417) and the tiling rules it shares with the
  JAX package (:465-571), kept only so that both packages take the same
  fused or unfused branch for a geometry: the CUDA kernels pick their own
  tiles.

Int8 expert stacks (``models/quantize.py``: one float32 scale per (expert,
out column)) take the dense oracle, as in the JAX package; the sparse
dispatch refuses them. Not ported: the expert-parallel paths
(``apply_moe_ffn_ep`` :758, ``apply_moe_ffn_ep_sparse`` :822,
``make_moe_ep_train_step`` :1026), which raise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..models.transformer import _uniform, get_activation
from ..ops.common import bmm_f32
from ..ops.gmm import gmm, gmm_autograd, tgmm
from ..ops.gmm_fused import gmm_dual, gmm_dy_swiglu, gmm_swiglu, tgmm_swiglu


class MoEFeedForward(nn.Module):
    """The MoE FFN of one block: ``router``, ``fc1`` and ``fc2`` parameter
    dicts with the JAX package's names and layouts (see :func:`init_moe_ffn`).
    ``forward(x, aux=None)`` takes the branch :func:`resolve_moe_impl` picks
    for ``x``'s token count and device; ``aux`` (a dict) receives the router
    auxiliary losses of this call's own routing."""

    def __init__(self, cfg, n_experts: int, *, device, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        e, f = cfg.emb_dim, cfg.ffn_dim
        f1 = 2 * f if cfg.ffn_type.lower() == "swiglu" else f

        def param(shape, fan_in):
            return nn.Parameter(_uniform(shape, 1.0 / math.sqrt(fan_in), generator).to(device))

        self.router = nn.ParameterDict({"weight": param((n_experts, e), e)})
        self.fc1 = nn.ParameterDict({"weight": param((n_experts, e, f1), e)})
        self.fc2 = nn.ParameterDict({"weight": param((n_experts, f, e), f)})
        if cfg.ffn_bias:
            self.fc1["bias"] = param((n_experts, f1), e)
            self.fc2["bias"] = param((n_experts, e), f)

    def params(self) -> dict:
        return {"router": self.router, "fc1": self.fc1, "fc2": self.fc2}

    def forward(self, x: torch.Tensor, aux: dict | None = None) -> torch.Tensor:
        cfg, params = self.cfg, self.params()
        n_tokens = x.numel() // x.shape[-1]
        impl = resolve_moe_impl(cfg, params, n_tokens, device=x.device)
        fn = apply_moe_ffn_sparse if impl == "sparse" else apply_moe_ffn
        return fn(params, cfg, x, top_k=cfg.moe_top_k, aux=aux)


def init_moe_ffn(cfg, n_experts: int, *, device, generator: torch.Generator) -> MoEFeedForward:
    """Router + per-expert fc1/fc2 stacks (:41-64), drawn on the CPU from
    ``generator`` and moved to ``device``."""
    return MoEFeedForward(cfg, n_experts, device=device, generator=generator)


# ---------------------------------------------------------------------------
# Routing and the auxiliary losses
# ---------------------------------------------------------------------------


def _router_topk(scores, top_k: int):
    """``(values, indices)`` of each row's ``top_k`` largest scores, in
    ``lax.top_k``'s order: descending, ties to the lower index first.

    k passes of ``torch.argmax``, each masking its pick with a large finite
    negative: ``argmax`` returns the first maximal index on every device, so
    repeated ties come out in ascending index order, as the JAX version's
    argmax passes (and ``lax.top_k``) give them. ``torch.topk`` is not used:
    its tie order on CUDA is unspecified. The values are gathered from
    ``scores``, so their gradient lands on the picked entries.
    """
    idxs = []
    p = scores
    for _ in range(top_k):
        i = torch.argmax(p, dim=-1)
        idxs.append(i)
        p = p.scatter(-1, i[..., None], -1e30)
    sel = torch.stack(idxs, dim=-1)
    return scores.gather(-1, sel), sel


def _route(params, cfg, x, top_k: int, need_probs: bool = True):
    """float32 router forward shared by the dispatch and the aux losses:
    ``(logits, probs, sel, top_p)`` for (T, d) tokens — raw logits, the
    softmax (only when ``need_probs``), the (T, k) picks and their gates, the
    softmax over the picked logits. The router product is float32 whatever
    the compute dtype."""
    logits = x.float() @ params["router"]["weight"].float().t()
    top_l, sel = _router_topk(logits, top_k)
    top_p = torch.softmax(top_l, dim=-1)
    probs = torch.softmax(logits, dim=-1) if need_probs else None
    return logits, probs, sel, top_p


def router_aux_from_route(logits, probs, sel) -> dict:
    """The router's auxiliary losses from a shared router forward (:147-167):
    ``lb = E · Σ_e frac_e · mean_t probs_e`` (Switch load balance; the pick
    fractions carry no gradient) and ``z = mean_t logsumexp(logits_t)²``."""
    n_experts = logits.shape[-1]
    counts = (sel[..., None] == torch.arange(n_experts, device=sel.device)).float().sum(dim=(0, 1))
    frac = counts / (sel.shape[0] * sel.shape[1])
    lb = n_experts * torch.sum(frac * probs.mean(dim=0))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return {"lb": lb, "z": z}


def router_aux(params, cfg, x, top_k: int) -> dict:
    """Standalone aux losses: one router forward through :func:`_route`."""
    xt = x.reshape(-1, x.shape[-1])
    logits, probs, sel, _ = _route(params, cfg, xt, top_k)
    return router_aux_from_route(logits, probs, sel)


# ---------------------------------------------------------------------------
# The dense oracle
# ---------------------------------------------------------------------------


def _expert_matmul(p, x, cd, spec: str):
    """Stacked expert linear (E, C, in) x (E, in, out) in the compute dtype
    (:180-196). An int8 stack is the JAX package's int8 path: its values
    cast to the compute dtype, the product accumulated and returned in
    float32, times the (E, out) scale, then cast."""
    if p["weight"].dtype == torch.int8:
        out = (bmm_f32(x, p["weight"].to(cd)) * p["scale"][:, None, :]).to(cd)
    else:
        out = torch.einsum(spec, x, p["weight"].to(cd))
    if "bias" in p:
        out = out + p["bias"][:, None, :].to(cd)
    return out


def _expert_ffn(fc1, fc2, cfg, x):
    """Per-expert FFN on (E, C, d) inputs (:199-208)."""
    cd = cfg.cdtype()
    h = _expert_matmul(fc1, x.to(cd), cd, "ecd,edf->ecf")
    if cfg.ffn_type.lower() == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        h = F.silu(gate) * up
    else:
        h = get_activation(cfg.activation)(h)
    return _expert_matmul(fc2, h, cd, "ecf,efd->ecd")


def apply_moe_ffn(params, cfg, x, *, top_k: int = 1, aux: dict | None = None):
    """Dense MoE FFN on (..., d) inputs (:211-233): every expert evaluates
    every token and the gate mask zeroes the unselected ones. The numerics
    oracle; ``aux`` receives this call's router aux losses."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    logits, probs, sel, top_p = _route(params, cfg, xt, top_k, need_probs=aux is not None)
    n_experts = params["router"]["weight"].shape[0]
    gate = torch.zeros((xt.shape[0], n_experts), dtype=top_p.dtype,
                       device=x.device).scatter(1, sel, top_p)
    if aux is not None:
        aux.update(router_aux_from_route(logits, probs, sel))
    outs = _expert_ffn(params["fc1"], params["fc2"], cfg, xt.expand(n_experts, *xt.shape))
    out = torch.einsum("te,etd->td", gate.to(outs.dtype), outs)
    return out.reshape(shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Gather-only dispatch and combine
# ---------------------------------------------------------------------------


class _DispatchRows(torch.autograd.Function):
    """``x[src]``: each sorted claim row reads its token (:236-270). The
    backward stays a gather: the cotangent is un-sorted with ``inv`` and
    each token's k claim rows are summed — no scatter-add, so it is
    deterministic (PyTorch's own backward of ``x[idx]`` is an atomic
    ``index_add``)."""

    @staticmethod
    def forward(ctx, x, src, inv, top_k: int):
        ctx.save_for_backward(inv)
        ctx.top_k = top_k
        return x.index_select(0, src)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        out = None
        for invj in inv.reshape(ctx.top_k, -1):
            c = g.index_select(0, invj)
            out = c if out is None else out + c
        return out, None, None, None


class _CombineRows(torch.autograd.Function):
    """Un-sort, gate-scale and k-claim sum in one gather-reduce (:273-336):
    ``out[t] = Σ_j gate[t, j] · ys[inv[j·T + t]]``. Backward, gathers only:
    ``d ys[r] = (gate ⊙ g claims)[perm[r]]`` and ``d gate[t, j] =
    <ys[inv[j·T + t]], g[t]>`` in float32."""

    @staticmethod
    def forward(ctx, ys, gate, inv, perm, top_k: int):
        ctx.save_for_backward(ys, gate, inv, perm)
        ctx.top_k = top_k
        out = None
        for j, invj in enumerate(inv.reshape(top_k, -1)):
            c = ys.index_select(0, invj) * gate[:, j, None].to(ys.dtype)
            out = c if out is None else out + c
        return out

    @staticmethod
    def backward(ctx, g):
        ys, gate, inv, perm = ctx.saved_tensors
        top_k = ctx.top_k
        gd = torch.cat([g * gate[:, j, None].to(g.dtype) for j in range(top_k)], dim=0)
        d_ys = gd.index_select(0, perm).to(ys.dtype)
        gf = g.float()
        d_gate = torch.stack([(ys.index_select(0, invj).float() * gf).sum(dim=-1)
                              for invj in inv.reshape(top_k, -1)], dim=-1).to(gate.dtype)
        return d_ys, d_gate, None, None, None


class _PermuteRows(torch.autograd.Function):
    """``x[perm]`` for a permutation, with the gather ``g[inv]`` as its
    backward (:339-359). In the JAX package only the expert-parallel sparse
    path (:942, :954), not ported yet, calls it."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return g.index_select(0, inv), None, None


# ---------------------------------------------------------------------------
# Which branch: the JAX package's rules
# ---------------------------------------------------------------------------


def resolve_moe_impl(cfg, params, n_tokens: int | None = None, *, device) -> str:
    """The MoE FFN branch for one single-device evaluation (:362-417):
    ``"sparse"`` (sorted dropless dispatch through the grouped kernels) or
    ``"dense"`` (the gate-masked all-experts oracle).

    ``"auto"`` takes sparse only on a CUDA ``device`` (the tokens' device),
    where the JAX package takes it on one TPU. Int8 or biased expert
    stacks take dense. The claims window is the JAX package's, measured on a
    v5e: claims (tokens × top_k) above ``max(2, E // 2)`` and below 4096 take
    dense; it is kept so that both packages take the same branch. An explicit
    ``"sparse"`` raises for int8 or biased stacks; ``"ep_sparse"`` (expert
    parallel) is not ported and raises.
    """
    impl = getattr(cfg, "moe_impl", "auto")
    if impl not in ("auto", "dense", "sparse", "ep_sparse"):
        raise ValueError(f"unknown moe_impl {impl!r}; choose auto/dense/sparse/ep_sparse")
    if impl == "ep_sparse":
        raise NotImplementedError("moe_impl='ep_sparse' (expert parallel) is not ported yet")
    fc1 = params["fc1"]
    unsupported = fc1["weight"].dtype == torch.int8 or "bias" in fc1
    if impl == "sparse":
        if unsupported:
            raise ValueError(f"moe_impl={impl!r} supports bf16/f32 bias-free experts only "
                             "(int8-quantized or biased expert stacks use 'dense')")
        return impl
    if impl == "auto":
        if unsupported or torch.device(device).type != "cuda":
            return "dense"
        if n_tokens is not None:
            n_experts = fc1["weight"].shape[0]
            claims = n_tokens * cfg.moe_top_k
            if max(2, n_experts // 2) < claims < 4096:
                return "dense"
        return "sparse"
    return "dense"


def _sparse_tilings(g_rows: int, k: int, n: int, dtype=torch.bfloat16):
    """The JAX package's per-pass (t_fwd, t_dx, t_dw) tilings for one expert
    product (G, k) @ (E, k, n) (:465-493): only :func:`_fused_swiglu_ok`
    reads them here."""
    wide = dtype.itemsize >= 4
    if g_rows < 4096:
        t = (128, min(k, 512), min(n, 512))
        return t, (128, min(n, 512), min(k, 512)), (128, min(k, 512), min(n, 512))

    def fwd_rule(k_, n_):
        tm = 1024 if n_ >= 1024 else 512
        return (tm // 2 if wide else tm, min(k_, 1024), min(n_, 1024))

    t_fwd = fwd_rule(k, n)
    t_dx = fwd_rule(n, k)
    tg = 256 if n >= 1024 else 1024
    t_dw = (tg // 2 if wide and tg > 256 else tg,
            min(k, 1024) if k <= 1024 else 512, min(n, 1024))
    return t_fwd, t_dx, t_dw


def _fit_tile(t: int, dim: int) -> int:
    """Largest multiple of 128 that divides ``dim`` and is <= ``t``; ``t``
    when ``dim`` has none (:525-539)."""
    if dim % 128 != 0:
        return t
    best = t
    for cand in range(min(t, dim), 127, -128):
        if dim % cand == 0:
            best = cand
            break
    return best


def _clamp_tiling(t, k: int, n: int):
    return (t[0], _fit_tile(t[1], k), _fit_tile(t[2], n))


def _fused_tilings(t1, t2, f: int, d: int):
    """(fc1-fwd, swiglu-fwd, dy, dual-dx, dw2) tilings (:549-558)."""
    return (t1[0], _clamp_tiling(t2[0], f, d), _clamp_tiling(t2[1], d, f),
            _clamp_tiling(t1[1], f, d), _clamp_tiling(t2[2], f, d))


def _fused_swiglu_ok(t1, t2, f: int, d: int) -> bool:
    """Whether the JAX package takes the fused segment for this geometry
    (:561-571): d and f multiples of 128 that its clamped tilings divide."""
    if f % 128 != 0 or d % 128 != 0:
        return False
    _, ts, tdy, tdx, tdw = _fused_tilings(t1, t2, f, d)
    return (f % ts[1] == 0 and d % ts[2] == 0
            and d % tdy[1] == 0 and f % tdy[2] == 0
            and f % tdx[1] == 0 and d % tdx[2] == 0
            and f % tdw[1] == 0 and d % tdw[2] == 0)


# ---------------------------------------------------------------------------
# The grouped expert FFN
# ---------------------------------------------------------------------------


class _SwigluPlain(torch.autograd.Function):
    """``silu(h[:, :f]) · h[:, f:]`` with the float32 backward written out and
    concatenated (:496-522): the unfused branch's activation."""

    @staticmethod
    def forward(ctx, h):
        ctx.save_for_backward(h)
        f = h.shape[-1] // 2
        return F.silu(h[..., :f]) * h[..., f:]

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors
        f = h.shape[-1] // 2
        gate, up = h[..., :f].float(), h[..., f:].float()
        s = torch.sigmoid(gate)
        gf = g.float()
        dgate = gf * up * (s * (1.0 + gate * (1.0 - s)))
        dup = gf * gate * s
        return torch.cat([dgate, dup], dim=-1).to(h.dtype)


class _FfnSegmentSwiglu(torch.autograd.Function):
    """The grouped expert FFN fc1 → swiglu → fc2 as one segment (:574-638).

    Forward: ``h = gmm(xs, w1)`` (K8; packed [gate | up]), ``ys =
    gmm_swiglu(h, w2)`` (K7): y never exists outside the kernel's tiles.
    Backward: ``dw2 = tgmm_swiglu(h, g)``, ``(dhg, dhu) = gmm_dy_swiglu(g,
    w2ᵀ, h)``, ``dxs = gmm_dual(dhg, dhu, w1ᵀ)`` (K7), and the dw1 halves
    ``tgmm(xsᵀ, dhg)``, ``tgmm(xsᵀ, dhu)`` (K8) joined in one concatenate.
    The residuals are (xs, w1, w2, h, group_sizes); y is not saved.
    """

    @staticmethod
    def forward(ctx, xs, w1, w2, group_sizes):
        h = gmm(xs, w1, group_sizes, xs.dtype)
        ys = gmm_swiglu(h, w2, group_sizes, xs.dtype)
        ctx.save_for_backward(xs, w1, w2, h, group_sizes)
        return ys

    @staticmethod
    def backward(ctx, g):
        xs, w1, w2, h, group_sizes = ctx.saved_tensors
        g = g.contiguous()
        n_experts = w1.shape[0]
        dw2 = tgmm_swiglu(h, g, group_sizes, w2.dtype)
        dhg, dhu = gmm_dy_swiglu(g, w2.transpose(1, 2).contiguous(), h, group_sizes, xs.dtype)
        dxs = gmm_dual(dhg, dhu, w1.transpose(1, 2).contiguous(), group_sizes, xs.dtype)
        dwg = tgmm(xs.t(), dhg, group_sizes, n_experts, w1.dtype)
        dwu = tgmm(xs.t(), dhu, group_sizes, n_experts, w1.dtype)
        return dxs, torch.cat([dwg, dwu], dim=2), dw2, None


def _counting_sort(flat_ids, n_experts: int):
    """``(perm, inv, group_sizes)`` of the (G,) expert ids (:641-663): a
    stable sort puts each expert's claims in one contiguous group in claim
    order, ``inv`` is its inverse permutation and ``group_sizes`` the count
    per expert. The counts come from a (G, E) comparison, not ``bincount``,
    which reads the largest id on the host on CUDA."""
    perm = torch.sort(flat_ids, stable=True).indices
    inv = torch.empty_like(perm).scatter_(
        0, perm, torch.arange(perm.shape[0], device=perm.device))
    group_sizes = (flat_ids[:, None] == torch.arange(n_experts, device=flat_ids.device)).sum(0)
    return perm, inv, group_sizes


def apply_moe_ffn_sparse(params, cfg, x, *, top_k: int = 1, aux: dict | None = None):
    """Dropless sparse MoE FFN (:666-755): the same function as
    :func:`apply_moe_ffn` at the activated FLOP count.

    Claims are k-major (claim ``j·T + t`` is token t's j-th expert); a stable
    counting sort makes each expert's claims one contiguous row group;
    :class:`_DispatchRows` gathers each sorted row's token; the grouped
    expert FFN runs as :class:`_FfnSegmentSwiglu` where the JAX package's
    :func:`_fused_swiglu_ok` allows it (the 8x124m preset at L=1024), else as
    :func:`~vitef_tpu_torch.ops.gmm.gmm_autograd`, the activation, and
    :func:`~vitef_tpu_torch.ops.gmm.gmm_autograd` again; :class:`_CombineRows`
    un-sorts, scales by the gates and sums each token's k claims.

    The JAX package pads the rows to its TPU row tile and adds the pad to the
    last group (:724-736); those rows are inert. The CUDA kernels mask rows by
    index, so the port does not pad. ``aux`` receives this call's router aux
    losses.
    """
    shape = x.shape
    cd = cfg.cdtype()
    xt = x.reshape(-1, shape[-1])
    t_tokens, d = xt.shape
    n_experts, _, f1 = params["fc1"]["weight"].shape
    f = params["fc2"]["weight"].shape[1]
    logits, probs, sel, top_p = _route(params, cfg, xt, top_k, need_probs=aux is not None)
    if aux is not None:
        aux.update(router_aux_from_route(logits, probs, sel))

    flat_ids = sel.t().reshape(-1)
    g_rows = t_tokens * top_k
    perm, inv, group_sizes = _counting_sort(flat_ids, n_experts)
    t1 = _sparse_tilings(g_rows, d, f1, cd)
    t2 = _sparse_tilings(g_rows, f, d, cd)
    src = perm % t_tokens
    xs = _DispatchRows.apply(xt.to(cd), src, inv, top_k)

    w1 = params["fc1"]["weight"].to(cd)  # (E, d, f1)
    w2 = params["fc2"]["weight"].to(cd)  # (E, f, d)
    swiglu = cfg.ffn_type.lower() == "swiglu"
    if swiglu and _fused_swiglu_ok(t1, t2, f, d):
        ys = _FfnSegmentSwiglu.apply(xs, w1, w2, group_sizes)
    else:
        h = gmm_autograd(xs, w1, group_sizes, cd)
        h = _SwigluPlain.apply(h) if swiglu else get_activation(cfg.activation)(h)
        ys = gmm_autograd(h, w2, group_sizes, cd)
    out = _CombineRows.apply(ys, top_p.to(cd), inv, perm, top_k)
    return out.reshape(shape).to(x.dtype)
