"""Normalization layers. Counterpart of ``vitef_tpu/models/norms.py``.

Layer, rms and batch norm (:30-80). Batch norm keeps its running statistics
as buffers; :func:`batch_norm_sites` and :func:`ema_update_stats` carry the
JAX package's running-stat update (:91-155) for the train step.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.common import canonical_impl
from ..ops.layernorm import layer_norm


class LayerNorm(nn.Module):
    """LayerNorm with float32 statistics; params ``weight`` (ones) and ``bias``
    (zeros). ``impl`` (the config's ``norm_impl``) picks the plain version or
    kernel K6, as :func:`~vitef_tpu_torch.ops.layernorm.layer_norm` resolves it."""

    def __init__(self, dim: int, bias: bool, eps: float, *, device: torch.device,
                 impl: str = "auto"):
        super().__init__()
        self.eps = eps
        self.impl = canonical_impl(impl)
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, impl=self.impl)


class RMSNorm(LayerNorm):
    """RMSNorm (:57-63): ``x * rsqrt(mean(x²) + eps) * weight [+ bias]``, all
    in float32, cast back to the input's dtype. It has no kernel in either
    package, so ``impl`` is checked but ignored, as the JAX package's rms
    branch ignores it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        out = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        out = out * self.weight.float()
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(x.dtype)


class BatchNorm(LayerNorm):
    """``nn.BatchNorm1d`` over the channels of (N, L, E) (:64-80): in float32,
    each channel normalised over (N, L), then cast back to the input's dtype.
    Train mode takes the batch's mean and biased variance; eval mode reads
    the buffers ``running_mean`` (zeros) and ``running_var`` (ones). With
    ``return_stats`` train mode also returns the batch's mean and *unbiased*
    variance (count/(count − 1)) under those names, detached, which the
    train step folds into the buffers; eval mode returns None there. It has
    no kernel in either package: ``impl`` is checked but ignored."""

    def __init__(self, dim: int, bias: bool, eps: float, *, device: torch.device,
                 impl: str = "auto"):
        super().__init__(dim, bias, eps, device=device, impl=impl)
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor, return_stats: bool = False):
        xf = x.float()
        stats = None
        if self.training:
            var, mean = torch.var_mean(xf, dim=(0, 1), correction=0)
            if return_stats:
                count = x.shape[0] * x.shape[1]
                stats = {"running_mean": mean.detach(),
                         "running_var": var.detach() * (count / max(count - 1, 1))}
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        out = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight.float()
        if self.bias is not None:
            out = out + self.bias.float()
        out = out.to(x.dtype)
        return (out, stats) if return_stats else out


def batch_norm_sites(module: nn.Module) -> dict[str, BatchNorm]:
    """Every batch norm of ``module`` by its dotted path, the JAX package's
    ``return_stats`` keys (``blocks.{i}.attn_norm``, ``blocks.{i}.ffn_norm``,
    ``output.output_layer.norm``; ``extract_running_stats`` :110-129)."""
    return {name: m for name, m in module.named_modules() if isinstance(m, BatchNorm)}


def ema_update_stats(running: dict, batch: dict, momentum: float = 0.1) -> dict:
    """One ``nn.BatchNorm1d`` running-stat step per site, (1 − m)·running +
    m·batch in float32 (:91-107). Both are ``{path: {"running_mean",
    "running_var"}}``; sites absent from ``batch`` pass through."""
    out = {}
    for path, old in running.items():
        new = batch.get(path)
        out[path] = old if new is None else {
            k: (1.0 - momentum) * old[k].float() + momentum * new[k]
            for k in ("running_mean", "running_var")}
    return out


def build_norm(dim: int, bias: bool, kind: str, eps: float, *,
               device: torch.device, impl: str = "auto") -> nn.Module:
    """The ``kind`` norm over ``dim``; an unknown ``impl`` raises ``ValueError``."""
    kind = kind.lower()
    if kind == "layer":
        return LayerNorm(dim, bias, eps, device=device, impl=impl)
    if kind == "rms":
        return RMSNorm(dim, bias, eps, device=device, impl=impl)
    if kind == "batch":
        return BatchNorm(dim, bias, eps, device=device, impl=impl)
    raise ValueError(f"Unknown normalization layer {kind!r}. Choose batch/layer/rms.")
