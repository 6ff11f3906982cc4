"""LayerNorm with float32 statistics: the plain version and kernel K6.

Counterpart of ``vitef_tpu/ops/layernorm.py``: the plain version is
``layer_norm_xla`` (:36-46), the kernel replaces the Pallas forward
(``_ln_fwd_kernel`` :54) and input-gradient (``_ln_bwd_dx_kernel`` :69)
kernels with ``csrc/layernorm.cu``, and :class:`_LayerNorm` is the custom
VJP (:134-156). Statistics are always float32 and two-pass, which is what
makes ViT's eps=1e-12 meaningful in a bfloat16 pipeline.

Routing (:func:`layer_norm`): ``impl`` resolves as the JAX package's does
(``resolve_impl`` without a sequence length), so ``"auto"`` is the plain
version; ``"kernel"`` (or ``"pallas"``) runs the plain version on a CPU tensor
and K6 on a CUDA tensor, or raises there for what K6 does not take (a dtype
other than bfloat16/float32, a width that is not a multiple of 8 in
[8, 2048]). Nothing falls back.
"""

from __future__ import annotations

import torch

from ._build import kernel_function
from .common import resolve_impl

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_WIDTH = 2048


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None,
                         eps: float) -> torch.Tensor:
    """Plain version: LayerNorm over the last axis with float32 mean and variance."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def layer_norm_stats_reference(x: torch.Tensor, eps: float):
    """The float32 ``(mean, rstd)`` of each row of ``x`` over its last axis,
    shaped like ``x`` without it: what K6's forward saves for the backward."""
    xf = x.float()
    mean = xf.mean(dim=-1)
    var = (xf - mean[..., None]).square().mean(dim=-1)
    return mean, torch.rsqrt(var + eps)


def layer_norm_bwd_dx_reference(g, x, scale, mean, rstd) -> torch.Tensor:
    """Plain version of K6's dx: ``rstd·(gw - mean(gw) - x̂·mean(gw·x̂))`` with
    ``gw = g·scale`` and ``x̂ = (x - mean)·rstd`` in float32 (``_ln_bwd_dx_kernel``
    :69-77), returned in x's dtype. ``mean`` and ``rstd`` are x's shape
    without the last axis."""
    gw = g.float() * scale.float()
    xhat = (x.float() - mean[..., None]) * rstd[..., None]
    mg = gw.mean(dim=-1, keepdim=True)
    mgx = (gw * xhat).mean(dim=-1, keepdim=True)
    return (rstd[..., None] * (gw - mg - xhat * mgx)).to(x.dtype)


def _rows(name: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous, 16-byte aligned (rows, E) matrix K6 takes, or raise."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype must be bfloat16 or float32, got {x.dtype}")
    e = x.shape[-1] if x.dim() else 0
    if not (8 <= e <= _MAX_WIDTH and e % 8 == 0):
        raise NotImplementedError(
            f"{name} takes widths that are multiples of 8 in [8, {_MAX_WIDTH}], got {e}")
    if x.numel() // e >= 2**31 - 8:
        raise NotImplementedError(f"{name}: {x.numel() // e} rows is too many")
    x = x.reshape(-1, e).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _param(t: torch.Tensor, e: int, device) -> torch.Tensor:
    """A (E,) parameter as the contiguous, aligned float32 vector K6 reads."""
    if tuple(t.shape) != (e,) or t.device != device:
        raise ValueError(f"parameter must be ({e},) on {device}, got {tuple(t.shape)} "
                         f"on {t.device}")
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_fwd(x2d, scale, bias, eps: float, want_stats: bool):
    """K6's forward on checked operands: ``(out, mean, rstd)``, the float32
    statistics (rows,) or None unless wanted."""
    rows, e = x2d.shape
    out = torch.empty_like(x2d)
    mean, rstd = ((torch.empty(rows, dtype=torch.float32, device=x2d.device) for _ in range(2))
                  if want_stats else (None, None))
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = kernel_function("layernorm_fwd", 6, 3, 1, source="layernorm")(
            x2d.data_ptr(), scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), None if mean is None else mean.data_ptr(),
            None if rstd is None else rstd.data_ptr(), rows, e,
            int(x2d.dtype == torch.bfloat16), eps, stream)
    if err != 0:
        raise RuntimeError(f"layernorm_fwd launch failed: cudaError {err} "
                           f"(rows={rows}, E={e}, {x2d.dtype})")
    layer_norm.launches += 1
    return out, mean, rstd


class _LayerNorm(torch.autograd.Function):
    """K6 forward; its backward runs K6's dx kernel (when x needs a
    gradient) and the parameter gradients as float32 column sums from the
    saved statistics, ``dscale = Σ g·x̂`` and ``dbias = Σ g`` (the XLA
    reductions of ``_ln_pallas_bwd``, :145-153). The statistics are 8 bytes
    per row."""

    @staticmethod
    def forward(ctx, x2d, scale, bias, eps: float):
        out, mean, rstd = _launch_fwd(x2d, scale, bias, eps, want_stats=True)
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x2d, scale, mean, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        x2d, scale, mean, rstd = ctx.saved_tensors
        dx = dscale = dbias = None
        if ctx.needs_input_grad[0]:
            dx = layer_norm_bwd_dx(g, x2d, scale, mean, rstd)
        if ctx.needs_input_grad[1]:
            xhat = (x2d.float() - mean[:, None]) * rstd[:, None]
            dscale = (g.float() * xhat).sum(dim=0)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            dbias = g.float().sum(dim=0)
        return dx, dscale, dbias, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None,
               eps: float = 1e-6, impl: str = "auto") -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics; ``bias=None``
    means no bias (norm_bias=False).

    ``impl`` resolves as in the JAX package: ``"auto"`` and ``"plain"``
    (``"xla"``) run :func:`layer_norm_reference`, as does ``"kernel"``
    (``"pallas"``) on a CPU tensor. ``"kernel"`` on a CUDA tensor launches K6,
    or raises if it does not take the input; when x, scale or bias requires a
    gradient the call runs under :class:`_LayerNorm`, whose backward launches
    K6's dx kernel (:func:`layer_norm_bwd_dx`). The parameters' gradients
    come back in their own dtype. ``layer_norm.launches`` counts the forward
    kernel's launches.
    """
    if resolve_impl(impl, x.device) == "plain" or x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps)
    x2d = _rows("layernorm_fwd", x)
    e = x2d.shape[1]
    scale = _param(scale, e, x.device)
    bias = None if bias is None else _param(bias, e, x.device)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x2d, scale, bias)):
        out = _LayerNorm.apply(x2d, scale, bias, eps)
    else:
        out = _launch_fwd(x2d, scale, bias, eps, want_stats=False)[0]
    return out.reshape(x.shape)


layer_norm.launches = 0


def layer_norm_bwd_dx(g, x, scale, mean, rstd) -> torch.Tensor:
    """The input gradient of :func:`layer_norm` for the cotangent ``g``, given
    the forward's float32 ``mean`` and ``rstd`` (x's shape without the last
    axis); in x's dtype.

    A CPU tensor goes through :func:`layer_norm_bwd_dx_reference`. A CUDA
    tensor launches K6's dx kernel (fixed-order warp reductions: two launches
    on the same inputs give identical bits), or raises if it does not take
    the input: g and x of one shape and dtype, bfloat16 or float32, and a
    width K6 takes. ``layer_norm_bwd_dx.launches`` counts its launches.
    """
    if x.device.type == "cpu":
        return layer_norm_bwd_dx_reference(g, x, scale, mean, rstd)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"layernorm_bwd_dx: g {g.dtype} {tuple(g.shape)} on {g.device} must "
                         f"match x {x.dtype} {tuple(x.shape)} on {x.device}")
    x2d, g2d = _rows("layernorm_bwd_dx", x), _rows("layernorm_bwd_dx", g)
    rows, e = x2d.shape
    scale = _param(scale, e, x.device)
    stats = []
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.numel() != rows or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be float32 with {rows} rows on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        stats.append(t.reshape(rows).contiguous())
    dx = torch.empty_like(x2d)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = kernel_function("layernorm_bwd_dx", 6, 3, source="layernorm")(
            g2d.data_ptr(), x2d.data_ptr(), scale.data_ptr(), stats[0].data_ptr(),
            stats[1].data_ptr(), dx.data_ptr(), rows, e, int(x.dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"layernorm_bwd_dx launch failed: cudaError {err} "
                           f"(rows={rows}, E={e}, {x.dtype})")
    layer_norm_bwd_dx.launches += 1
    return dx.reshape(x.shape)


layer_norm_bwd_dx.launches = 0
