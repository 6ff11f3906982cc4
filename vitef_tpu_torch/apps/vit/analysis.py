"""Plasticity analysis: per-component rate of change under distribution shift.

Counterpart of ``apps/vit/analysis.py`` (``distance`` :40-63,
``make_decomposition_distance_fn`` :66-75). The decomposition quirks the
statistic depends on (every block decomposed on the same embedding output;
fc2 on the zero-padded input) live in
:meth:`~vitef_tpu_torch.models.transformer.Transformer.get_decomposition`.
Both batches are decomposed on the model's device and only the (N,)
distance vectors are returned, as in the JAX app. ``AnalysisConfig`` and the
``analysis()`` driver, which read ImageNet and the downstream datasets, are
not ported yet.
"""

from __future__ import annotations

import torch

from ...utils.tree import get_valid_tensor


def distance(x, y, reduction: str = "none") -> torch.Tensor:
    """Per-sample Frobenius distance between token clouds x, y (N, n, d) (a
    missing batch dimension is added), in float32: (N,) for
    ``reduction="none"``, a scalar for ``"mean"`` or ``"sum"``."""
    x, y = get_valid_tensor(x), get_valid_tensor(y)
    d2 = (x.float() - y.float()).square()
    dist = d2.reshape(d2.shape[0], -1).sum(dim=-1).sqrt()
    match reduction.lower():
        case "none":
            return dist
        case "mean":
            return dist.mean()
        case "sum":
            return dist.sum()
        case _:
            raise ValueError(f"Unknown reduction'{reduction}'. Choose between 'none', "
                             "'mean' or 'sum'.")


def make_decomposition_distance_fn(model):
    """``(x1, x2) -> {key: (N,) per-sample Frobenius distances}`` between the
    decompositions (``model.get_decomposition``) of two batches."""

    def decomp_dist(x1: torch.Tensor, x2: torch.Tensor) -> dict:
        outputs1 = model.get_decomposition(x1)
        outputs2 = model.get_decomposition(x2)
        with torch.inference_mode():
            return {k: distance(outputs1[k], outputs2[k], "none") for k in outputs1}

    return decomp_dist
