"""Normalization layers. Counterpart of ``vitef_tpu/models/norms.py`` (:30-56).

Only LayerNorm is ported; the rms and batch kinds raise.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.layernorm import layer_norm


class LayerNorm(nn.Module):
    """LayerNorm with float32 statistics; params ``weight`` (ones) and ``bias`` (zeros)."""

    def __init__(self, dim: int, bias: bool, eps: float, *, device: torch.device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def build_norm(dim: int, bias: bool, kind: str, eps: float, *,
               device: torch.device) -> nn.Module:
    kind = kind.lower()
    if kind == "layer":
        return LayerNorm(dim, bias, eps, device=device)
    if kind in ("rms", "batch"):
        raise NotImplementedError(f"{kind} norm is not ported yet")
    raise ValueError(f"Unknown normalization layer {kind!r}. Choose batch/layer/rms.")
