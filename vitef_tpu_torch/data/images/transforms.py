"""Eval-path image normalization. Counterpart of ``vitef_tpu/data/images/transforms.py``
(IMAGENET_MEAN/STD :33-34, ``normalize_device`` and ``normalize_host`` :259-271).

Resize + CenterCrop run on the host (``vitef_tpu.native``, PIL-parity); the
/255 + ImageNet normalize and the NHWC -> NCHW transpose run on the device.
The train augment comes with the training port.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_device(batch_u8: torch.Tensor, *,
                     compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, S, S, C) uint8 -> (N, C, S, S) ToTensor + Normalize, on the batch's device."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(batch_u8.device)
    std = torch.from_numpy(IMAGENET_STD).to(batch_u8.device)
    out = batch_u8.float() / 255.0
    out = (out - mean) / std
    return out.permute(0, 3, 1, 2).contiguous().to(compute_dtype)


def normalize_host(batch_u8: np.ndarray) -> np.ndarray:
    """Host-numpy version of :func:`normalize_device`."""
    out = batch_u8.astype(np.float32) / 255.0
    out = (out - IMAGENET_MEAN) / IMAGENET_STD
    return np.transpose(out, (0, 3, 1, 2))
