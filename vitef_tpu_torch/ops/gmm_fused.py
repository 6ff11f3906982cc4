"""SwiGLU-fused grouped products for the sparse-MoE expert FFN: kernel K7.

Counterpart of ``vitef_tpu/ops/gmm_fused.py``. Four TPU kernels, each a
grouped product (rows sorted by group, as :mod:`.gmm`) with the swiglu
algebra fused in; here they are modes of the same two CUDA kernels as K8
(``csrc/gmm.cu``, ``csrc/tgmm.cu``):

- :func:`gmm_swiglu` (:94) — ``out = (silu(hg) · hu) @ w2[e]``, hg and hu the
  two halves of the packed (G, 2f) fc1 output; the gated activation is made
  tile by tile from h and never stored;
- :func:`gmm_dy_swiglu` (:177) — ``dy = g @ w2t[e]`` with the swiglu backward
  applied to the float32 accumulator, writing ``dhg`` and ``dhu`` apart;
- :func:`tgmm_swiglu` (:268) — ``dw2[e] = yᵀ[rows of e] @ g[rows of e]``,
  y recomputed from h;
- :func:`gmm_dual` (:370) — ``out = a @ rt[e, :f] + b @ rt[e, f:]`` in one
  accumulator.

Numerics, as the JAX kernels: products take operands in the input dtype and
accumulate in float32; ``y = silu_f32(hg) · hu_f32`` is rounded to the input
dtype before it is multiplied (:120-121, :311-317); ``gmm_dy_swiglu`` applies
the swiglu backward to the unrounded float32 accumulator (:214). Each
function has its plain version beside it (``*_reference``), a per-group loop
of float32 products, which a CPU tensor runs; a CUDA tensor launches the
kernel or raises (see :mod:`.gmm` for what the kernels take). Each wrapper
counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from .gmm import (DUAL, SWIGLU_BWD_OUT, SWIGLU_IN, _check_sizes, check_widths, group_bounds,
                  kernel_operands, launch_gmm, launch_tgmm)


def _silu_f32(x):
    x = x.float()
    return x * torch.sigmoid(x)


def _swiglu_bwd_f32(dy, g, u):
    """d(silu(g)·u) in float32: ``(dg, du)`` given the upstream ``dy``."""
    g, u, dy = g.float(), u.float(), dy.float()
    s = torch.sigmoid(g)
    dg = dy * u * (s * (1.0 + g * (1.0 - s)))
    du = dy * (g * s)
    return dg, du


def _swiglu_y(h):
    """``y = silu_f32(h[:, :f]) · h[:, f:]``, rounded to h's dtype."""
    f = h.shape[1] // 2
    return (_silu_f32(h[:, :f]) * h[:, f:].float()).to(h.dtype)


def _per_group(lhs, rhs, group_sizes):
    """float32 ``lhs[rows of e] @ rhs[e]`` for every group, (G, n)."""
    _check_sizes(group_sizes, lhs.shape[0])
    out = torch.empty((lhs.shape[0], rhs.shape[2]), dtype=torch.float32, device=lhs.device)
    for e, (start, end) in enumerate(group_bounds(group_sizes)):
        out[start:end] = lhs[start:end].float() @ rhs[e].float()
    return out


def gmm_swiglu_reference(h, w2, group_sizes, out_dtype=None):
    """Plain version of :func:`gmm_swiglu`."""
    return _per_group(_swiglu_y(h), w2, group_sizes).to(out_dtype or h.dtype)


def gmm_dy_swiglu_reference(g, w2t, h, group_sizes, out_dtype=None):
    """Plain version of :func:`gmm_dy_swiglu`."""
    f = w2t.shape[2]
    dg, du = _swiglu_bwd_f32(_per_group(g, w2t, group_sizes), h[:, :f], h[:, f:])
    out_dtype = out_dtype or g.dtype
    return dg.to(out_dtype), du.to(out_dtype)


def tgmm_swiglu_reference(h, g, group_sizes, out_dtype=None):
    """Plain version of :func:`tgmm_swiglu`: (E, f, n), an empty group zeros."""
    _check_sizes(group_sizes, h.shape[0])
    y = _swiglu_y(h)
    out = torch.zeros((group_sizes.shape[0], y.shape[1], g.shape[1]), dtype=torch.float32,
                      device=h.device)
    for e, (start, end) in enumerate(group_bounds(group_sizes)):
        out[e] = y[start:end].float().t() @ g[start:end].float()
    return out.to(out_dtype or h.dtype)


def gmm_dual_reference(a, b, rt, group_sizes, out_dtype=None):
    """Plain version of :func:`gmm_dual`."""
    f = a.shape[1]
    acc = _per_group(a, rt[:, :f], group_sizes) + _per_group(b, rt[:, f:], group_sizes)
    return acc.to(out_dtype or a.dtype)


def gmm_swiglu(h, w2, group_sizes, out_dtype=None):
    """``out[rows of e] = (silu(h[:, :f]) · h[:, f:])[rows of e] @ w2[e]``:
    h (G, 2f) the packed [gate | up] fc1 output, w2 (E, f, n) -> (G, n).
    The CUDA kernel (``csrc/gmm.cu``, mode ``SWIGLU_IN``; in bfloat16 the
    TMA + ``wgmma`` pipeline of :func:`.gmm.gmm`) makes each slice of y in
    registers from h's gate and up tiles and multiplies it from there."""
    if h.device.type == "cpu":
        return gmm_swiglu_reference(h, w2, group_sizes, out_dtype)
    ops, sizes = kernel_operands("gmm_swiglu", {"h": h, "w2": w2}, group_sizes, out_dtype)
    h, w2 = ops["h"], ops["w2"]
    if w2.dim() != 3 or h.shape[1] != 2 * w2.shape[1] or sizes.shape[0] != w2.shape[0]:
        raise ValueError(f"gmm_swiglu: h {tuple(h.shape)}, w2 {tuple(w2.shape)} and "
                         f"group_sizes {tuple(sizes.shape)} do not fit")
    f, n = w2.shape[1], w2.shape[2]
    check_widths("gmm_swiglu", f=f, n=n)
    out = torch.empty((h.shape[0], n), dtype=h.dtype, device=h.device)
    if launch_gmm(SWIGLU_IN, h, None, w2, None, sizes, out, None, f, n):
        gmm_swiglu.launches += 1
    return out


gmm_swiglu.launches = 0


def gmm_dy_swiglu(g, w2t, h, group_sizes, out_dtype=None):
    """``dy[rows of e] = g[rows of e] @ w2t[e]``, then ``dhg = dy · hu ·
    silu'(hg)`` and ``dhu = dy · silu(hg)`` on the float32 accumulator: g
    (G, n), w2t (E, n, f) the explicitly transposed fc2 weight, h (G, 2f) ->
    (dhg, dhu), (G, f) each. The CUDA kernel is ``csrc/gmm.cu`` in mode
    ``SWIGLU_BWD_OUT`` (in bfloat16 the TMA + ``wgmma`` pipeline of
    :func:`.gmm.gmm` as a ping-pong: each consumer warpgroup multiplies one
    column half of a tile while the other applies the swiglu backward to
    its accumulators against h's gate and up, loaded by TMA, and stores dhg
    and dhu by TMA)."""
    if g.device.type == "cpu":
        return gmm_dy_swiglu_reference(g, w2t, h, group_sizes, out_dtype)
    ops, sizes = kernel_operands("gmm_dy_swiglu", {"g": g, "w2t": w2t, "h": h}, group_sizes,
                                 out_dtype)
    g, w2t, h = ops["g"], ops["w2t"], ops["h"]
    if (w2t.dim() != 3 or w2t.shape[1] != g.shape[1] or sizes.shape[0] != w2t.shape[0]
            or tuple(h.shape) != (g.shape[0], 2 * w2t.shape[2])):
        raise ValueError(f"gmm_dy_swiglu: g {tuple(g.shape)}, w2t {tuple(w2t.shape)}, "
                         f"h {tuple(h.shape)} and group_sizes {tuple(sizes.shape)} do not fit")
    n, f = w2t.shape[1], w2t.shape[2]
    check_widths("gmm_dy_swiglu", n=n, f=f)
    dhg, dhu = (torch.empty((g.shape[0], f), dtype=g.dtype, device=g.device) for _ in range(2))
    if launch_gmm(SWIGLU_BWD_OUT, g, None, w2t, h, sizes, dhg, dhu, n, f):
        gmm_dy_swiglu.launches += 1
    return dhg, dhu


gmm_dy_swiglu.launches = 0


def tgmm_swiglu(h, g, group_sizes, out_dtype=None):
    """``dw2[e] = yᵀ[rows of e] @ g[rows of e]`` with ``y = silu(h[:, :f]) ·
    h[:, f:]`` recomputed (and rounded to h's dtype): h (G, 2f), g (G, n) ->
    (E, f, n), an empty group zeros. The CUDA kernel is ``csrc/tgmm.cu`` in
    mode ``SWIGLU_IN`` (in bfloat16 the TMA + ``wgmma`` pipeline of
    :func:`.gmm.tgmm`, y written over h's gate tile in shared memory before
    each product, as ``gmm_swiglu`` makes it, bit for bit; fixed row order,
    no atomics: two launches give the same bits)."""
    if h.device.type == "cpu":
        return tgmm_swiglu_reference(h, g, group_sizes, out_dtype)
    ops, sizes = kernel_operands("tgmm_swiglu", {"h": h, "g": g}, group_sizes, out_dtype)
    h, g = ops["h"], ops["g"]
    if h.shape[0] != g.shape[0] or h.shape[1] % 2:
        raise ValueError(f"tgmm_swiglu: h {tuple(h.shape)} and g {tuple(g.shape)} do not fit")
    f, n = h.shape[1] // 2, g.shape[1]
    check_widths("tgmm_swiglu", f=f, n=n)
    out = torch.empty((sizes.shape[0], f, n), dtype=h.dtype, device=h.device)
    launch_tgmm(SWIGLU_IN, h, g, sizes, out, f, n)
    tgmm_swiglu.launches += 1
    return out


tgmm_swiglu.launches = 0


def gmm_dual(a, b, rt, group_sizes, out_dtype=None):
    """``out[rows of e] = a[rows of e] @ rt[e, :f] + b[rows of e] @ rt[e, f:]``:
    a, b (G, f) the two cotangent halves, rt (E, 2f, n) the explicitly
    transposed packed fc1 weight -> (G, n), one float32 accumulator. The CUDA
    kernel is ``csrc/gmm.cu`` in mode ``DUAL`` (in bfloat16 the TMA +
    ``wgmma`` pipeline of :func:`.gmm.gmm`, reading a, then b, with the
    matching half of rt)."""
    if a.device.type == "cpu":
        return gmm_dual_reference(a, b, rt, group_sizes, out_dtype)
    ops, sizes = kernel_operands("gmm_dual", {"a": a, "b": b, "rt": rt}, group_sizes,
                                 out_dtype)
    a, b, rt = ops["a"], ops["b"], ops["rt"]
    if (b.shape != a.shape or rt.dim() != 3 or rt.shape[1] != 2 * a.shape[1]
            or sizes.shape[0] != rt.shape[0]):
        raise ValueError(f"gmm_dual: a {tuple(a.shape)}, b {tuple(b.shape)}, rt "
                         f"{tuple(rt.shape)} and group_sizes {tuple(sizes.shape)} do not fit")
    f, n = a.shape[1], rt.shape[2]
    check_widths("gmm_dual", f=f, n=n)
    out = torch.empty((a.shape[0], n), dtype=a.dtype, device=a.device)
    if launch_gmm(DUAL, a, b, rt, None, sizes, out, None, 2 * f, n):
        gmm_dual.launches += 1
    return out


gmm_dual.launches = 0
