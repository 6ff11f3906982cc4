"""Global configuration: repo-relative path constants and seeding.

Counterpart of ``vitef_tpu/config.py``: the same path constants under the same
environment variables, and :func:`set_seed`, which returns a
``torch.Generator`` where the JAX package returns a ``jax.random`` key.
"""

from __future__ import annotations

import os
import random
from pathlib import Path

import numpy as np
import torch

ROOT_DIR = Path(os.environ.get("VITEF_ROOT_DIR", Path(__file__).resolve().parents[1]))
DATASET_DIR = Path(os.environ.get("VITEF_DATASET_DIR", ROOT_DIR / "datasets"))
FIGURE_DIR = Path(os.environ.get("VITEF_FIGURE_DIR", ROOT_DIR / "figures"))
MODEL_DIR = Path(os.environ.get("VITEF_MODEL_DIR", ROOT_DIR / "checkpoints"))
RESULT_DIR = Path(os.environ.get("VITEF_RESULT_DIR", ROOT_DIR / "results"))
SAVING_DIR = Path(os.environ.get("VITEF_SAVING_DIR", ROOT_DIR / "savings"))


def set_seed(seed: int) -> tuple[np.random.Generator, torch.Generator]:
    """Seed python's, numpy's and torch's global RNGs and return
    ``(np.random.default_rng(seed), torch.Generator seeded with seed)``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed), torch.Generator().manual_seed(seed)
