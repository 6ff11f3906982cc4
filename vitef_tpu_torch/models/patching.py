"""Image patching. Counterpart of ``vitef_tpu/models/patching.py`` (:16-32).

The 'hybrid' Conv2d(k=P, s=P) is patch extraction plus one matmul: stride
equals kernel, so the windows do not overlap.
"""

from __future__ import annotations

import torch


def image_patch_dims(image_dim: tuple, patch_size: int) -> tuple[int, int]:
    """(n_patches, patch_dim) for (C, H, W) images."""
    c, h, w = image_dim
    if h % patch_size != 0 or w % patch_size != 0:
        raise AssertionError("Image dimensions must be divisible by the patch size.")
    return h * w // patch_size**2, patch_size**2 * c


def extract_patches_chw(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, n_patches, C·P·P) with (c, p1, p2) flattening order.

    This is the order of a flattened Conv2d weight (E, C, P, P), so
    ``extract_patches_chw(x) @ w.reshape(E, -1).T`` equals Conv2d(k=P, s=P)
    followed by Flatten.
    """
    n, c, h, w = x.shape
    p = patch_size
    x = x.reshape(n, c, h // p, p, w // p, p)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(n, (h // p) * (w // p), c * p * p)
