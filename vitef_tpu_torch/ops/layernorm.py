"""LayerNorm with float32 statistics.

Counterpart of ``layer_norm_xla`` in ``vitef_tpu/ops/layernorm.py`` (:36-46).
The JAX main path never takes its Pallas LayerNorm kernel (``resolve_impl`` is
called without ``seq_len`` and returns the plain path), so this is the plain
version only. Statistics are always float32, which is what makes ViT's
eps=1e-12 meaningful in a bfloat16 pipeline.
"""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with float32 mean and variance."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
