"""Rotary position embeddings. Counterpart of ``vitef_tpu/models/rope.py`` (:25-49).

The llama/HF "rotate_half" pairing: the head dim splits into halves (x1, x2)
and pair i rotates by ``pos * theta^(-2i/d)``:

    out = [x1*cos - x2*sin, x2*cos + x1*sin]

Angles and the rotation are float32, and the result is cast back to the
input's dtype.
"""

from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """``(cos, sin)`` for integer ``positions`` (any shape), each
    ``positions.shape + (head_dim // 2,)`` in float32."""
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head dim, got {head_dim}")
    inv_freq = theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=positions.device) / head_dim)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the last axis of ``x`` (..., d) by per-position angles; ``cos``
    and ``sin`` (..., d/2) broadcast against ``x``'s leading axes (e.g.
    (L, d/2) against (N, h, L, d))."""
    d = x.shape[-1]
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
