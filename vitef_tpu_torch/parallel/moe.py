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
dispatch refuses them.

Expert parallelism (:758-1144) over the ``('dp', 'ep')`` mesh of
:func:`~vitef_tpu_torch.parallel.mesh.build_ep_mesh`, one process a card:

- :func:`shard_experts` (the placement of :func:`moe_param_shardings` and
  :func:`moe_ep_state_shardings`, :969-1023): rank j keeps experts
  [j·E/ep, (j+1)·E/ep) of every block, and its optimizer state follows them;
  the router and every other parameter stay whole;
- :func:`apply_moe_ffn_ep` (:758-819): the GShard one-hot dispatch with a
  capacity per device per expert;
- :func:`apply_moe_ffn_ep_sparse` (:822-966): claims counting-sorted by
  owner into fixed send buckets, the owner's grouped products through the
  same route as :func:`apply_moe_ffn_sparse` (K8 and K7 on CUDA), the
  reverse exchange and the gate-combine. The JAX package rounds the bucket up
  to its TPU row tiles (inert slots); the CUDA kernels mask rows by index, so
  the port's bucket is the drop bound ``cap_req`` itself;
- :func:`make_moe_ep_train_step` (:1026-1144).

The exchanges are ``all_to_all_single`` inside :class:`_AllToAll`, whose
backward is the reverse exchange; with one rank along 'ep' they are the
identity. Under tensor parallelism (``parallel.mesh.shard_params``) an MoE
FFN keeps its rank's block of experts and computes :func:`apply_moe_ffn_tp`.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.tensor_parallel import tp_enter, tp_reduce
from ..models.transformer import _uniform, get_activation
from ..ops.common import bmm_f32, draw_seed
from ..ops.gmm import gmm, gmm_autograd, tgmm
from ..ops.gmm_fused import gmm_dual, gmm_dy_swiglu, gmm_swiglu, tgmm_swiglu


class MoEFeedForward(nn.Module):
    """The MoE FFN of one block: ``router``, ``fc1`` and ``fc2`` parameter
    dicts with the JAX package's names and layouts (see :func:`init_moe_ffn`).
    ``forward(x, aux=None)`` takes the branch :func:`resolve_moe_impl` picks
    for ``x``'s token count and device; ``aux`` (a dict) receives the router
    auxiliary losses of this call's own routing. ``ep`` is the
    ``('dp', 'ep')`` mesh of experts placed by :func:`shard_experts`: while
    it is set, every call takes :func:`apply_moe_ffn_ep_sparse` over it at
    ``capacity_factor`` (the config's, or the one
    :func:`make_moe_ep_train_step` was built with). ``tp`` is the
    ``('dp', 'tp')`` mesh of experts split by ``shard_params``
    (:func:`apply_moe_ffn_tp`)."""

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
        self.ep = self.tp = None
        self.capacity_factor = cfg.moe_capacity_factor

    def params(self) -> dict:
        return {"router": self.router, "fc1": self.fc1, "fc2": self.fc2}

    def forward(self, x: torch.Tensor, aux: dict | None = None) -> torch.Tensor:
        cfg, params = self.cfg, self.params()
        if self.ep is not None:
            out = apply_moe_ffn_ep_sparse(params, cfg, x.reshape(-1, x.shape[-1]),
                                          top_k=cfg.moe_top_k,
                                          capacity_factor=self.capacity_factor,
                                          mesh=self.ep, aux=aux)
            return out.reshape(x.shape)
        n_tokens = x.numel() // x.shape[-1]
        impl = resolve_moe_impl(cfg, params, n_tokens, device=x.device)
        if impl == "ep_sparse":
            raise RuntimeError(
                "moe_impl='ep_sparse' exchanges tokens over an 'ep' mesh: place the "
                "experts with shard_experts and train with make_moe_ep_train_step")
        if self.tp is not None:
            return apply_moe_ffn_tp(params, cfg, x, top_k=cfg.moe_top_k, mesh=self.tp, aux=aux)
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
    backward (:339-359): the owner's sort of its received rows in
    :func:`apply_moe_ffn_ep_sparse` (:942, :954)."""

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
    ``"sparse"`` or ``"ep_sparse"`` (the expert-parallel dispatch, inside
    :func:`make_moe_ep_train_step`) raises for int8 or biased stacks.
    """
    impl = getattr(cfg, "moe_impl", "auto")
    if impl not in ("auto", "dense", "sparse", "ep_sparse"):
        raise ValueError(f"unknown moe_impl {impl!r}; choose auto/dense/sparse/ep_sparse")
    fc1 = params["fc1"]
    unsupported = fc1["weight"].dtype == torch.int8 or "bias" in fc1
    if impl in ("sparse", "ep_sparse"):
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


# ---------------------------------------------------------------------------
# MoE under tensor parallelism
# ---------------------------------------------------------------------------


def apply_moe_ffn_tp(params, cfg, x, *, top_k: int = 1, mesh, aux: dict | None = None):
    """The dense oracle with the experts split over 'tp': what GSPMD computes
    for the JAX package's :func:`apply_moe_ffn` under ``param_shardings``'
    expert-axis spec (``vitef_tpu/parallel/mesh.py`` :180-187).

    ``params`` holds this rank's block of experts (fc1, fc2 and fc1's bias)
    beside the whole router (and fc2's whole bias, replicated by the JAX
    rule). Every rank routes every token; each evaluates its own experts on
    every token and gate-masks them, and one all-reduce over the mesh's tp
    group sums the partial combines. The gate, the tokens the experts read
    and fc2's bias enter through ``tp_enter``, so that their gradients are
    summed over the group and every replicated gradient is whole on every
    rank."""
    shape = x.shape
    group = mesh.tp_group
    xt = x.reshape(-1, shape[-1])
    logits, probs, sel, top_p = _route(params, cfg, xt, top_k, need_probs=aux is not None)
    if aux is not None:
        aux.update(router_aux_from_route(logits, probs, sel))
    n_experts = params["router"]["weight"].shape[0]
    e_loc = params["fc1"]["weight"].shape[0]
    lo = mesh.tp_rank * e_loc
    gate = torch.zeros((xt.shape[0], n_experts), dtype=top_p.dtype,
                       device=x.device).scatter(1, sel, top_p)
    gate = tp_enter(gate, group)[:, lo:lo + e_loc]
    fc2 = dict(params["fc2"])
    if "bias" in fc2:
        fc2["bias"] = tp_enter(fc2["bias"], group)[lo:lo + e_loc]
    xe = tp_enter(xt, group)
    outs = _expert_ffn(params["fc1"], fc2, cfg, xe.expand(e_loc, *xe.shape))
    out = tp_reduce(torch.einsum("te,etd->td", gate.to(outs.dtype), outs), group)
    return out.reshape(shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Expert parallelism: the exchange and the placement
# ---------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal row blocks over ``group``: block j of
    the input goes to rank j, the block from rank s lands at position s.
    The exchange is its own adjoint, so the backward is the same exchange
    of the cotangent (the reverse all_to_all, as the transpose of
    ``lax.all_to_all`` is)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def _exchange(x: torch.Tensor, mesh) -> torch.Tensor:
    """The 'ep' exchange of ``x``'s equal leading blocks (identity at ep = 1)."""
    if mesh is None or mesh.ep == 1:
        return x
    return _AllToAll.apply(x, mesh.ep_group)


def _ep_size(mesh) -> int:
    return 1 if mesh is None else mesh.ep


def _ep_leaf(name: str, ndim: int) -> bool:
    """An expert stack (:1002-1007): an (n_experts, ·, ·) weight under a block
    FFN's fc1 or fc2; the router and every other leaf stay whole."""
    dotted = f".{name}."
    return (".fc1." in dotted or ".fc2." in dotted) and ".ffn." in dotted and ndim == 3


def moe_param_shardings(shapes: dict[str, tuple]):
    """``{name: Placement}`` over one MoE FFN's parameters (``router.weight``,
    ``fc1.weight``, ...; :969-979): the expert stacks and their biases split
    their expert axis over 'ep', the router whole."""
    from .mesh import Placement

    return {name: Placement(ep=0) if name.split(".")[0] in ("fc1", "fc2") else Placement()
            for name in shapes}


def moe_ep_state_shardings(shapes: dict[str, tuple]):
    """``{name: Placement}`` over a whole model's parameters (names to shapes,
    the port's layout) under expert parallelism (:1010-1023): every block's
    expert stacks split their expert axis over 'ep' (their optimizer
    moments follow them), everything else whole."""
    from .mesh import Placement

    return {name: Placement(ep=0) if _ep_leaf(name, len(shape)) else Placement()
            for name, shape in shapes.items()}


def shard_experts(model, mesh):
    """Place an MoE model (a ``Model`` or its module) on the ``('dp', 'ep')``
    ``mesh`` in place, per :func:`moe_ep_state_shardings`, and return it:
    each rank keeps its block of experts [j·E/ep, (j+1)·E/ep) of every block
    (``module.mesh_layout`` records it, for the checkpoint), and every MoE
    FFN's ``ep`` is the mesh, so that from then on each call dispatches
    through :func:`apply_moe_ffn_ep_sparse`. Build the optimizer after, so that its state
    follows the local stacks. Raises ValueError for a model without
    experts, or n_experts not divisible by ep."""
    from .mesh import MeshLayout

    module = getattr(model, "module", model)
    if getattr(module, "mesh_layout", None) is not None:
        raise ValueError("the module is already sharded")
    cfg = module.cfg
    if not cfg.n_experts or cfg.n_experts % mesh.ep:
        raise ValueError(f"expert parallelism needs n_experts divisible by ep = {mesh.ep}, "
                         f"got n_experts = {cfg.n_experts}")
    names = {name: tuple(p.shape) for name, p in module.named_parameters()}
    layout = MeshLayout(mesh=mesh, placements=moe_ep_state_shardings(names), full_shapes=names)
    with torch.no_grad():
        for name, p in module.named_parameters():
            local = layout.local(name, p.data)
            if local.shape != p.shape:
                p.data = local.clone()
    for block in module.blocks:
        block.ffn.ep = mesh
    module.mesh_layout = layout
    return model


# ---------------------------------------------------------------------------
# Expert parallelism: the two dispatches
# ---------------------------------------------------------------------------


def apply_moe_ffn_ep(params, cfg, x, *, top_k: int = 1, capacity: int | None = None,
                     mesh=None):
    """Expert-parallel MoE FFN, the GShard one-hot dispatch (:758-819).

    ``x``: this rank's (T_loc, d) tokens; ``params``: its shard, the router
    whole, fc1/fc2 its ``E_loc`` experts (n_experts = ep · E_loc). The
    dispatch one-hot (T_loc, n_experts, capacity) marks token t as occupant c
    of expert e's buffer (claims ranked k-major, then by token); overflow
    past ``capacity`` (per device per expert, default T_loc) is dropped.
    One exchange gives each owner its experts' buffers from every rank,
    source-major along the capacity axis; the owner applies its experts;
    the reverse exchange and the gate-weighted combine restore token
    order."""
    ep = _ep_size(mesh)
    t_loc, d = x.shape
    e_loc = params["fc1"]["weight"].shape[0]
    n_experts = ep * e_loc
    if capacity is None:
        capacity = t_loc
    _, _, sel, top_p = _route(params, cfg, x, top_k, need_probs=False)
    gate = torch.zeros((t_loc, n_experts), dtype=top_p.dtype,
                       device=x.device).scatter(1, sel, top_p)
    # rank of each (token, k) claim among its expert's claims, k-major
    flat = F.one_hot(sel.t().reshape(-1), n_experts).to(torch.int32)     # (k*T, E)
    pos = torch.cumsum(flat, dim=0) - flat
    keep = (pos < capacity) & (flat > 0)
    expert_idx = sel.t().reshape(-1)
    token_idx = torch.arange(t_loc, device=x.device).repeat(top_k)
    slot_idx = pos.clamp(0, capacity - 1).gather(1, expert_idx[:, None]).squeeze(1)
    val = keep.gather(1, expert_idx[:, None]).squeeze(1).float()
    disp = torch.zeros((t_loc, n_experts, capacity), dtype=torch.float32, device=x.device)
    disp = disp.index_put((token_idx, expert_idx, slot_idx), val, accumulate=True)

    ex_in = torch.einsum("tec,td->ecd", disp, x.float())                  # (E, C, d)
    # owner j receives expert rows [j·E_loc, (j+1)·E_loc) of every source
    ex_in = _exchange(ex_in, mesh)                                        # (ep·E_loc, C, d)
    ex_in = ex_in.reshape(ep, e_loc, capacity, d).transpose(0, 1).reshape(
        e_loc, ep * capacity, d)
    ex_out = _expert_ffn(params["fc1"], params["fc2"], cfg, ex_in).float()
    ex_out = ex_out.reshape(e_loc, ep, capacity, d).transpose(0, 1).reshape(
        n_experts, capacity, d)
    ex_out = _exchange(ex_out, mesh)
    out = torch.einsum("tec,ecd->td", disp * gate[:, :, None], ex_out)
    return out.to(x.dtype)


def _jax_send_rows(cap_req: int, ep: int, d: int, f1: int, f: int, cd) -> int:
    """The JAX package's bucket rows ``ep · bucket`` after its round-up to
    the TPU row tiles (:904-911): read only to take the same fused or
    unfused branch (:func:`_fused_swiglu_ok`) as the JAX package."""
    bucket = cap_req
    t1 = _sparse_tilings(ep * bucket, d, f1, cd)
    t2 = _sparse_tilings(ep * bucket, f, d, cd)
    tm = max(t1[0][0], t2[0][0], t1[1][0], t2[1][0], t1[2][0], t2[2][0])
    while (ep * bucket) % tm:
        bucket += 1
    return ep * bucket


class _SendRows(torch.autograd.Function):
    """``x[slot_tok]``: each send slot reads its claim's token. The backward
    stays a gather: token t's gradient is the sum, in claim order, of the
    slots its k claims were given (``dest``; a dropped claim reads an
    appended zero row), never a scatter-add."""

    @staticmethod
    def forward(ctx, x, slot_tok, dest, top_k: int):
        ctx.save_for_backward(dest)
        ctx.top_k = top_k
        return x.index_select(0, slot_tok)

    @staticmethod
    def backward(ctx, g):
        (dest,) = ctx.saved_tensors
        g = torch.cat([g, g.new_zeros(1, g.shape[1])])
        out = None
        for dj in dest.reshape(-1, ctx.top_k).t():
            c = g.index_select(0, dj)
            out = c if out is None else out + c
        return out, None, None, None


class _CombineSlots(torch.autograd.Function):
    """The gate-combine at the source: ``out[t] = Σ_j gate[t, j] ·
    back[dest[t·k + j]]``, a dropped claim's gate being zero and its
    ``dest`` the appended zero row. Backward, gathers only: ``d back[s] =
    gate[claim(s)] · g[token(s)]`` for a live slot (zero for an unfilled
    one) and ``d gate[t, j] = <back[dest[t·k + j]], g[t]>`` in float32."""

    @staticmethod
    def forward(ctx, back, gate, dest, slot_claim, top_k: int):
        back_z = torch.cat([back, back.new_zeros(1, back.shape[1])])
        ctx.save_for_backward(back_z, gate, dest, slot_claim)
        ctx.top_k = top_k
        out = None
        for j, dj in enumerate(dest.reshape(-1, top_k).t()):
            c = back_z.index_select(0, dj) * gate[:, j, None]
            out = c if out is None else out + c
        return out

    @staticmethod
    def backward(ctx, g):
        back_z, gate, dest, slot_claim = ctx.saved_tensors
        top_k = ctx.top_k
        gate_z = torch.cat([gate.reshape(-1), gate.new_zeros(1)])
        tok = torch.where(slot_claim < gate.numel(), slot_claim // top_k, 0)
        d_back = g.index_select(0, tok) * gate_z.index_select(0, slot_claim)[:, None]
        gf = g.float()
        d_gate = torch.stack([(back_z.index_select(0, dj).float() * gf).sum(dim=-1)
                              for dj in dest.reshape(-1, top_k).t()], dim=-1).to(gate.dtype)
        return d_back.to(back_z.dtype), d_gate, None, None, None


def apply_moe_ffn_ep_sparse(params, cfg, x, *, top_k: int = 1, capacity: int | None = None,
                            capacity_factor: float | None = None, mesh=None,
                            aux: dict | None = None):
    """Expert-parallel sparse MoE FFN (:822-966): the multi-card composition
    of :func:`apply_moe_ffn_sparse`, rows moved instead of one-hot buffers.

    1. route this rank's (T_loc, d) tokens; claim g = t·k + j (token-major)
       belongs to owner ``expert // E_loc``; rank each claim among its
       owner's in claim order and give it slot ``owner · B + rank`` of the
       send buckets;
    2. one exchange of the slot rows and one of their local expert ids;
    3. the owner counting-sorts what it received by local expert and runs
       the grouped expert FFN as :func:`apply_moe_ffn_sparse` does
       (:class:`_FfnSegmentSwiglu`, K8 and K7, or ``gmm`` + the activation),
       then un-sorts;
    4. the reverse exchange puts each result back in its send slot, and the
       gate-combine sums each token's claims, a dropped claim's as zero.

    The drop bound ``cap_req`` is ``capacity``, or ``ceil(T_loc·k/ep ·
    capacity_factor)``, or (neither) ``T_loc·k``, dropless; a claim whose
    rank reaches it is dropped. The bucket B is ``cap_req`` rows: unfilled
    slots read token 0 into local expert 0's group and are inert (their
    results are never combined). ``aux`` receives this rank's router losses.
    Raises ValueError for biased or int8 expert stacks (:874-878)."""
    if "bias" in params["fc1"] or params["fc1"]["weight"].dtype == torch.int8:
        raise ValueError(
            "apply_moe_ffn_ep_sparse supports bf16/f32 bias-free experts only (the grouped "
            "products of apply_moe_ffn_sparse); biased or int8 expert stacks use "
            "apply_moe_ffn_ep")
    ep = _ep_size(mesh)
    cd = cfg.cdtype()
    t_loc, d = x.shape
    e_loc, _, f1 = params["fc1"]["weight"].shape
    f = params["fc2"]["weight"].shape[1]
    logits, probs, sel, top_p = _route(params, cfg, x, top_k, need_probs=aux is not None)
    if aux is not None:
        aux.update(router_aux_from_route(logits, probs, sel))

    flat_ids = sel.reshape(-1)                     # (G,) global expert ids, token-major
    g_rows = t_loc * top_k
    owner = flat_ids // e_loc
    if capacity is not None:
        cap_req = capacity
    elif capacity_factor is not None:
        cap_req = max(1, math.ceil(g_rows * capacity_factor / ep))
    else:
        cap_req = g_rows
    bucket = cap_req
    g_send = ep * bucket

    occ = (owner[:, None] == torch.arange(ep, device=x.device)).to(torch.int32)
    rank = ((torch.cumsum(occ, dim=0) - occ) * occ).sum(dim=1)
    valid = rank < cap_req
    # a dropped claim's slot is g_send: the zero row appended by the combine
    dest = torch.where(valid, owner * bucket + rank, g_send)
    slot_claim = torch.full((g_send + 1,), g_rows, dtype=torch.long, device=x.device)
    slot_claim = slot_claim.scatter(0, dest, torch.arange(g_rows, device=x.device))[:g_send]
    live = slot_claim < g_rows
    claim = slot_claim.clamp(max=g_rows - 1)
    slot_tok = torch.where(live, claim // top_k, 0)
    slot_le = torch.where(live, flat_ids.index_select(0, claim) % e_loc, 0)

    xs_send = _SendRows.apply(x.to(cd), slot_tok, dest, top_k)        # (ep·B, d)
    xr = _exchange(xs_send, mesh)                                      # owner's, source-major
    le_recv = _exchange(slot_le, mesh)

    perm, inv, group_sizes = _counting_sort(le_recv, e_loc)
    xg = _PermuteRows.apply(xr, perm, inv)
    w1 = params["fc1"]["weight"].to(cd)
    w2 = params["fc2"]["weight"].to(cd)
    rows = _jax_send_rows(cap_req, ep, d, f1, f, cd)
    t1, t2 = _sparse_tilings(rows, d, f1, cd), _sparse_tilings(rows, f, d, cd)
    swiglu = cfg.ffn_type.lower() == "swiglu"
    if swiglu and _fused_swiglu_ok(t1, t2, f, d):
        ys = _FfnSegmentSwiglu.apply(xg, w1, w2, group_sizes)
    else:
        h = gmm_autograd(xg, w1, group_sizes, cd)
        h = _SwigluPlain.apply(h) if swiglu else get_activation(cfg.activation)(h)
        ys = gmm_autograd(h, w2, group_sizes, cd)
    ys = _PermuteRows.apply(ys, inv, perm)
    back = _exchange(ys, mesh)                    # each result back in its send slot

    gate = (top_p * valid.reshape(t_loc, top_k)).to(cd)
    out = _CombineSlots.apply(back, gate, dest, slot_claim, top_k)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# The expert-parallel train step (moe_impl="ep_sparse" end to end)
# ---------------------------------------------------------------------------


def make_moe_ep_train_step(mesh, *, loss_fn=None, grad_clip: float | None = None,
                           capacity_factor: float | None = 2.0, hidden_loss=None,
                           schedule=None, base_lr: float = 0.0):
    """Build the expert-parallel MoE train step ``(state, (x, y),
    generator=None) -> metrics`` (:1026-1144) on the ``('dp', 'ep')``
    ``mesh`` (:func:`~vitef_tpu_torch.parallel.mesh.build_ep_mesh`).

    ``state.model`` is placed by :func:`shard_experts`, its optimizer built
    after. Each rank passes its own rows of the global batch (``shard_batch``
    splits it over every rank of the mesh) and runs the whole model on them;
    every block's FFN dispatches its claims to their owners through
    :func:`apply_moe_ffn_ep_sparse` at ``capacity_factor`` (None: dropless
    buckets). The objective (the loss plus ``moe_lb_coef · lb + moe_z_coef
    · z``) is divided by the number of ranks; the exchange's backward has
    then summed each expert stack's gradient over its 'ep' group, so it is
    summed over 'dp' only, and every replicated gradient over every rank
    (one flat all-reduce each). ``loss``, ``moe_lb`` and ``moe_z`` are means
    over the ranks; ``grad_norm`` is the whole model's (the expert squares
    summed over 'ep'), taken before the clip at ``grad_clip``, which the
    step applies; then the optimizer and the scheduler step.
    ``hidden_loss`` (as in ``make_train_step``) fuses the vocabulary head
    into the loss; ``generator`` feeds dropout, a stream of each rank's
    own."""
    from ..optim import global_grad_norm
    from .train_step import cross_entropy_loss, finish_step, reduce_flat_, trainable_grads

    if "ep" not in mesh.axis_names:
        raise AssertionError(f"mesh {mesh.axis_names} has no 'ep' axis")
    loss_fn = loss_fn or cross_entropy_loss
    n_dev = mesh.size

    def train_step(state, batch, generator: torch.Generator | None = None) -> dict:
        x, y = batch
        module = state.model.module
        cfg = module.cfg
        layout = getattr(module, "mesh_layout", None)
        if not cfg.n_experts or layout is None or layout.mesh is not mesh:
            raise AssertionError("make_moe_ep_train_step needs an MoE model placed on its "
                                 "mesh by shard_experts")
        coefs = (cfg.moe_lb_coef, cfg.moe_z_coef)
        need_aux = any(c != 0.0 for c in coefs)
        for block in module.blocks:
            block.ffn.capacity_factor = capacity_factor
        module.train()
        if generator is not None:
            generator = torch.Generator(device=generator.device).manual_seed(
                draw_seed(generator, mesh.rank))
        state.optimizer.zero_grad(set_to_none=True)
        out = module(x, return_hidden=hidden_loss is not None, return_moe_aux=need_aux,
                     generator=generator)
        if need_aux:
            out, aux = out
        else:
            aux = {"lb": torch.zeros((), device=x.device), "z": torch.zeros((), device=x.device)}
        loss = hidden_loss(module, out, y) if hidden_loss is not None else loss_fn(out, y)
        obj = loss + coefs[0] * aux["lb"] + coefs[1] * aux["z"]
        (obj / n_dev).backward()

        names = {p: name for name, p in module.named_parameters()}
        params = trainable_grads(module)
        expert = [p for p in params if layout.placement(names[p]).ep is not None]
        replicated = [p for p in params if layout.placement(names[p]).ep is None]
        metrics = {key: value.detach().float() / n_dev
                   for key, value in (("loss", loss), ("moe_lb", aux["lb"]), ("moe_z", aux["z"]))}
        # the metrics' means and the replicated gradients, summed over every rank
        reduce_flat_(list(metrics.values()) + [p.grad for p in replicated], mesh.world_group)
        # expert gradients, already summed over 'ep' by the exchange's backward
        if mesh.dp > 1:
            reduce_flat_([p.grad for p in expert], mesh.dp_group)
        exp_sq = global_grad_norm([p.grad for p in expert]).square().reshape(1)
        if mesh.ep > 1 and mesh.ep_group is not None:
            dist.all_reduce(exp_sq, group=mesh.ep_group)
        rep_sq = global_grad_norm([p.grad for p in replicated]).square()
        metrics["grad_norm"] = torch.sqrt(rep_sq + exp_sq[0])
        return finish_step(state, [p.grad for p in params], metrics, grad_clip=grad_clip,
                           schedule=schedule, base_lr=base_lr)

    return train_step
