"""Image transforms: the eval-path normalize and the train augment.

Counterpart of ``vitef_tpu/data/images/transforms.py``: IMAGENET_MEAN/STD
(:33-34), ``sample_resized_crop_params`` and ``sample_crop_batch`` (:89-130),
the train augment ``augment_train_device`` (:237-255) with its kernel K10
(``_augment_kernel`` :187-201, weights ``_bilinear_weights`` :173-184), and
``normalize_device`` / ``normalize_host`` (:258-271).

Eval path: Resize + CenterCrop run on the host (``vitef_tpu_torch.native``,
PIL-parity); the /255 + ImageNet normalize and the NHWC -> NCHW transpose run
on the device. Train path: crop boxes and flip flags are drawn on the host
with torchvision's RandomResizedCrop algorithm, with the JAX package's draws
in the same order (the same ``np.random.Generator`` gives both packages the
same boxes and flips); the crop-resize, flip and normalize run on the device
in one kernel (``ops/csrc/train_augment.cu``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...ops._build import kernel_function

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def sample_resized_crop_params(
    rng: np.random.Generator,
    height: int,
    width: int,
    scale: tuple = (0.08, 1.0),
    ratio: tuple = (3.0 / 4.0, 4.0 / 3.0),
) -> tuple[int, int, int, int]:
    """(top, left, h, w) with torchvision RandomResizedCrop.get_params semantics."""
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = int(rng.integers(0, height - h + 1))
            left = int(rng.integers(0, width - w + 1))
            return top, left, h, w
    # Fallback: center crop clamped by ratio
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    top = (height - h) // 2
    left = (width - w) // 2
    return top, left, h, w


def sample_crop_batch(rng: np.random.Generator, n: int, height: int, width: int,
                      flip_p: float = 0.5) -> tuple[np.ndarray, np.ndarray]:
    """Batch of (top, left, h, w) int32 boxes + bool flip flags."""
    boxes = np.empty((n, 4), np.int32)
    for i in range(n):
        boxes[i] = sample_resized_crop_params(rng, height, width)
    flips = rng.random(n) < flip_p
    return boxes, flips


def _normalize_constants() -> tuple[list[float], list[float]]:
    """Per channel 1 / (255 std) and -mean / std, from the float32 statistics
    in double, as the JAX kernel (:199-200) and the CUDA kernel compute them."""
    scale = [1.0 / (255.0 * float(IMAGENET_STD[c])) for c in range(3)]
    shift = [-float(IMAGENET_MEAN[c]) / float(IMAGENET_STD[c]) for c in range(3)]
    return scale, shift


def _bilinear_weights(start, length, size: int, src: int, flip):
    """(N, size, src) bilinear row weights resizing [start, start + length) of
    each image to ``size`` (``_bilinear_weights`` :173-184): at most two
    non-zero taps per row, renormalised; ``flip`` reverses the output
    coordinate."""
    o = torch.arange(size, dtype=torch.float32, device=start.device)[None, :, None]
    o = torch.where(flip[:, None, None], (size - 1.0) - o, o)
    x = torch.arange(src, dtype=torch.float32, device=start.device)[None, None, :]
    inv_s = length.float()[:, None, None] / size
    u = (o + 0.5) * inv_s + start.float()[:, None, None] - 0.5
    w = torch.clamp(1.0 - torch.abs(u - x), min=0.0)
    return w / w.sum(dim=2, keepdim=True)


def augment_train_reference(batch_u8: torch.Tensor, boxes: torch.Tensor,
                            flips: torch.Tensor, size: int,
                            compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of K10: (N, H, W, 3) uint8 + boxes (N, 4) (top, left, h, w)
    + flips (N,) -> (N, 3, size, size) normalized, in ``compute_dtype``.

    Per image, ``ah @ img_c @ awᵀ`` in float32 with the bilinear weight
    matrices of the crop (the flip folded into the width weights), then
    ``* 1/(255 std) - mean/std``.
    """
    _, h, w, _ = batch_u8.shape
    boxes = boxes.long()
    ah = _bilinear_weights(boxes[:, 0], boxes[:, 2], size, h,
                           torch.zeros_like(flips, dtype=torch.bool))
    aw = _bilinear_weights(boxes[:, 1], boxes[:, 3], size, w, flips.bool())
    img = batch_u8.float().permute(0, 3, 1, 2)                     # (N, 3, H, W)
    out = torch.matmul(torch.matmul(ah[:, None], img), aw[:, None].transpose(-1, -2))
    scale, shift = _normalize_constants()
    scale = torch.tensor(scale, dtype=torch.float32, device=out.device)[None, :, None, None]
    shift = torch.tensor(shift, dtype=torch.float32, device=out.device)[None, :, None, None]
    return (out * scale + shift).to(compute_dtype)


_MAX_IMAGE_BYTES = 48 * 1024   # kMaxImageBytes in csrc/train_augment.cu


def augment_train_device(batch_u8: torch.Tensor, boxes: torch.Tensor, flips: torch.Tensor,
                         *, size: int, compute_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """(N, H, W, 3) uint8 + crop boxes (N, 4) + flip flags (N,) -> (N, 3, size, size)
    normalized: crop-resize (bilinear), horizontal flip, /255, ImageNet
    normalize, HWC -> CHW.

    A CPU tensor goes through :func:`augment_train_reference`. A CUDA tensor
    launches K10 (``csrc/train_augment.cu``), or raises if the kernel does not
    take it: uint8 images of 3 channels (at most 48 KB each), boxes and flips
    on the same device, a float32 or bfloat16 output.
    ``augment_train_device.launches`` counts its launches.
    """
    if batch_u8.device.type == "cpu":
        return augment_train_reference(batch_u8, boxes, flips, size, compute_dtype)
    if batch_u8.device.type != "cuda":
        raise ValueError(f"augment_train_device: unsupported device {batch_u8.device}")
    if batch_u8.dtype != torch.uint8 or batch_u8.dim() != 4 or batch_u8.shape[-1] != 3:
        raise ValueError("augment_train_device takes (N, H, W, 3) uint8, got "
                         f"{tuple(batch_u8.shape)} {batch_u8.dtype}")
    n, h, w, _ = batch_u8.shape
    if h * w * 3 > _MAX_IMAGE_BYTES:
        raise NotImplementedError(f"train_augment stages a whole image in shared "
                                  f"memory: {h}x{w}x3 is over {_MAX_IMAGE_BYTES} bytes")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"train_augment writes float32 or bfloat16, not {compute_dtype}")
    if tuple(boxes.shape) != (n, 4) or tuple(flips.shape) != (n,) \
            or boxes.device != batch_u8.device or flips.device != batch_u8.device:
        raise ValueError(f"boxes (N, 4) and flips (N,) must lie on {batch_u8.device}")
    images = batch_u8.contiguous()
    boxes = boxes.to(torch.int32).contiguous()
    flips = flips.to(torch.uint8).contiguous()
    out = torch.empty((n, 3, size, size), dtype=compute_dtype, device=batch_u8.device)
    with torch.cuda.device(batch_u8.device):
        stream = torch.cuda.current_stream(batch_u8.device).cuda_stream
        err = kernel_function("train_augment", 4, 5)(
            images.data_ptr(), boxes.data_ptr(), flips.data_ptr(), out.data_ptr(),
            n, h, w, size, int(compute_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"train_augment launch failed: cudaError {err} "
                           f"(N={n}, {h}x{w} -> {size})")
    augment_train_device.launches += 1
    return out


augment_train_device.launches = 0


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
