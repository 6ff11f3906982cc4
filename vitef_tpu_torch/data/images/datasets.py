"""Image datasets. Counterpart of ``vitef_tpu/data/images/datasets.py``
(``SyntheticDatasetConfig`` :43-59, ``SyntheticDataset`` :123-135).

Only the synthetic dataset is ported; its numpy generation is the JAX
package's, so both packages see the same images from the same seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticDatasetConfig:
    """Synthetic random-image dataset for offline runs."""

    mode: str = "train"
    n_samples: int = 256
    image_size: int = 32
    n_classes: int = 10
    seed: int = 0
    save_dir: str | None = None  # accepted and ignored (loader contract)

    def __post_init__(self):
        if self.mode not in ("train", "val", "test"):
            raise ValueError(f"Invalid mode {self.mode}.")


class SyntheticDataset:
    """Class-separable random uint8 images (N, H, W, 3); labels encoded into channel 0."""

    fixed_size = True

    def __init__(self, config: SyntheticDatasetConfig):
        mode_seed = {"train": 0, "val": 1, "test": 2}[config.mode]
        rng = np.random.default_rng(config.seed + mode_seed)
        s = config.image_size
        self.targets = rng.integers(0, config.n_classes, size=config.n_samples)
        data = rng.integers(0, 64, size=(config.n_samples, s, s, 3), dtype=np.uint8)
        bump = (self.targets * (191 // max(config.n_classes - 1, 1))).astype(np.uint8)
        data[..., 0] += bump[:, None, None]
        self.data = data
        self.n_classes = config.n_classes

    def __len__(self):
        return len(self.data)
