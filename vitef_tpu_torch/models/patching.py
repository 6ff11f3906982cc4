"""Image and time-series patching. Counterpart of ``vitef_tpu/models/patching.py``.

The 'hybrid' Conv2d(k=P, s=P) is patch extraction plus one matmul: stride
equals kernel, so the windows do not overlap. 'raw' image patching flattens
each patch in (p1, p2, c) order; a time series is padded at its end with its
last value and unfolded into overlapping windows.
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


def patch_images_raw(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, n_patches, P·P·C) with (p1, p2, c) flattening
    order, the raw patching of NHWC images (:35-41)."""
    n, c, h, w = x.shape
    p = patch_size
    x = x.reshape(n, c, h // p, p, w // p, p)
    return x.permute(0, 2, 4, 3, 5, 1).reshape(n, (h // p) * (w // p), p * p * c)


def timeseries_patch_dims(length: int, patch_size: int, stride: int) -> tuple[int, int]:
    """(n_patches, patch_dim) of a series of ``length`` steps: ⌊(T−P)/S⌋ + 2
    windows of P steps (:44-46)."""
    return (length - patch_size) // stride + 2, patch_size


def patch_timeseries(x: torch.Tensor, patch_size: int, stride: int) -> torch.Tensor:
    """(N, T) -> (N, n_patches, P): the series padded at its end with its last
    value repeated ``stride`` times, then window i is steps i·S .. i·S + P − 1
    (:49-61)."""
    xp = torch.cat([x, x[..., -1:].expand(*x.shape[:-1], stride)], dim=-1)
    n_patches, _ = timeseries_patch_dims(x.shape[-1], patch_size, stride)
    return xp.unfold(-1, patch_size, stride)[..., :n_patches, :]
