"""Tensor and dict helpers. Counterpart of ``vitef_tpu/utils/tree.py``
(:16-107): ``get_valid_tensor``, ``get_numpy``, ``json_serializable``,
``update_dict`` and ``deterministic_split``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def get_valid_tensor(x) -> torch.Tensor:
    """``x`` as a tensor with a batch dimension added if it is 2-D."""
    x = torch.as_tensor(x)
    return x[None] if x.dim() == 2 else x


def get_numpy(x) -> np.ndarray:
    """A tensor (on any device), array or scalar as a host numpy array of at
    least one dimension."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    out = np.asarray(x)
    return out[None] if not out.ndim else out


def json_serializable(d: dict) -> dict:
    """A flat config dict made json-safe: Paths become strings."""
    out = {}
    for k, v in d.items():
        if isinstance(v, Path):
            out[k] = str(v)
        elif isinstance(v, dict):
            out[k] = json_serializable(v)
        elif isinstance(v, (list, tuple)):
            out[k] = [str(x) if isinstance(x, Path) else x for x in v]
        else:
            out[k] = v
    return out


def update_dict(acc: dict, new: dict) -> dict:
    """Accumulate a dict of arrays into ``acc`` by concatenation on axis 0."""
    for k, v in new.items():
        v = get_numpy(v)
        acc[k] = np.concatenate([acc[k], v], axis=0) if k in acc else v
    return acc


def deterministic_split(n: int, split: float = 0.8) -> tuple[np.ndarray, np.ndarray]:
    """The first ``int(split * n)`` indices of a permutation of ``n`` drawn from
    numpy's global RNG seeded with 42, and the rest; the global RNG's state is
    saved before and restored after, so that the caller's draws are not
    moved. The JAX package draws the same permutation, so both packages put
    the same images in each split."""
    state = np.random.get_state()
    np.random.seed(42)
    perm = np.random.permutation(n)
    np.random.set_state(state)
    n_train = int(split * n)
    return perm[:n_train], perm[n_train:]
