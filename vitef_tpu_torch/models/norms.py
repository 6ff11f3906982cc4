"""Normalization layers. Counterpart of ``vitef_tpu/models/norms.py`` (:30-63).

The layer and rms kinds are ported; the batch kind raises.
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


def build_norm(dim: int, bias: bool, kind: str, eps: float, *,
               device: torch.device, impl: str = "auto") -> nn.Module:
    """The ``kind`` norm over ``dim``; an unknown ``impl`` raises ``ValueError``."""
    kind = kind.lower()
    if kind == "layer":
        return LayerNorm(dim, bias, eps, device=device, impl=impl)
    if kind == "rms":
        return RMSNorm(dim, bias, eps, device=device, impl=impl)
    if kind == "batch":
        raise NotImplementedError("batch norm is not ported yet")
    raise ValueError(f"Unknown normalization layer {kind!r}. Choose batch/layer/rms.")
