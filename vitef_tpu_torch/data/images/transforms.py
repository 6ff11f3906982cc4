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
    # u rounded as the JAX kernel computes it: XLA turns ``length / size``
    # into a product with the float32 reciprocal of ``size`` and contracts
    # ``(o + 0.5) * inv_s + start`` into one fused multiply-add. That sum is
    # exact in float64 for sources under 2^16 rows, so one rounding to
    # float32 gives the fused multiply-add's value on any device.
    inv_s = length.float()[:, None, None] * float(np.float32(1) / np.float32(size))
    u = ((o + 0.5).double() * inv_s.double() + start.double()[:, None, None]).float() - 0.5
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


# K10's shared-memory plan, computed alike by csrc/train_augment.cu
# (kBandRows, kStageBytes, kMaxSmemBytes and plan_of there; chip_smoke.py
# holds the two equal through its train_augment_plan). A block takes R
# output rows of one image and holds, as 16-byte records: the x taps of
# every output column (8 per group of 8 columns), the y taps of its R rows,
# and the source rows those R rows read, each resized along x to the output
# width (9 float4 slots per group of 8 columns: one of padding, so that
# neighbouring threads read other banks).
_BAND_ROWS = 64                 # output rows a block takes at most
_STAGE_BYTES = 64 * 1024        # a block's aim, so that several share an SM
_MAX_SMEM_BYTES = 227 * 1024    # the most a block may opt in to on Hopper


def augment_smem_bytes(rows: int, h: int, size: int) -> int:
    """Shared memory of a K10 block that takes ``rows`` output rows of an
    ``h``-row source resized to ``size``. R consecutive output rows read at
    most floor((R - 1) h / size) + 3 source rows (two taps a row, one more
    where float32 rounding of the coordinate crosses a row); one row more is
    kept as a margin."""
    groups = -(-size // 8)
    src_rows = (rows - 1) * h // size + 4
    return 16 * (8 * groups + rows + 9 * groups * src_rows)


def augment_band_rows(h: int, w: int, size: int) -> int:
    """Output rows R that one K10 block takes for (h, w) sources resized to
    ``size``: the largest R <= 64 whose shared memory stays within 64 KB
    (else 1), then evened out over the bands it makes (224 rows: 4 bands of
    56). Larger bands spend a block's fixed work (its taps, two
    synchronisations) on more values: on an H100, bands of up to 64 rows ran
    6% faster than bands of 32, and bands of 16 31% slower
    (``tools/profile_train_augment.py``). The source's width costs no shared
    memory and a band of one row holds four source rows whatever the height,
    so every source is taken; the limit is the output width: ``size`` up to
    2640, where one row's band fills the 227 KB a block may have. Raises
    NotImplementedError past it."""
    if h <= 0 or w <= 0 or size <= 0:
        raise ValueError(f"train_augment: empty shape {h}x{w} -> {size}")
    if augment_smem_bytes(1, h, size) > _MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"train_augment: size {size} is past the limit of 2640; one output row's band "
            f"needs {augment_smem_bytes(1, h, size)} bytes of shared memory, over the "
            f"{_MAX_SMEM_BYTES} a block may have")
    rows = min(_BAND_ROWS, size)
    while rows > 1 and augment_smem_bytes(rows, h, size) > _STAGE_BYTES:
        rows -= 1
    bands = -(-size // rows)
    return -(-size // bands)


def _refuse_downscaled_non_square(h: int, w: int, size: int) -> None:
    """The JAX package runs the two-tap map only on square sources; it resizes
    any other through XLA's antialiased ``scale_and_translate``
    (``_crop_resize_one`` :138-156), whose kernel widens on a crop that
    downscales. Where a side is over ``size`` a crop can downscale, and that
    resize is not ported."""
    if h != w and max(h, w) > size:
        raise NotImplementedError(
            f"augment_train_device: a non-square {h}x{w} source with a side over size={size} "
            "can downscale, and there the JAX package takes XLA's antialiased "
            "scale_and_translate, which the port has not ported")


def augment_train_device(batch_u8: torch.Tensor, boxes: torch.Tensor, flips: torch.Tensor,
                         *, size: int, compute_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """(N, H, W, 3) uint8 + crop boxes (N, 4) + flip flags (N,) -> (N, 3, size, size)
    normalized: crop-resize (bilinear), horizontal flip, /255, ImageNet
    normalize, HWC -> CHW.

    A CPU tensor goes through :func:`augment_train_reference`. A CUDA tensor
    launches K10 (``csrc/train_augment.cu``), or raises if the kernel does not
    take it: uint8 images of 3 channels, ``size`` up to 2640
    (:func:`augment_band_rows`), boxes and flips on the same device, a float32
    or bfloat16 output. On both, a non-square source with a side over
    ``size`` raises NotImplementedError (the JAX package resizes it otherwise).
    Each box lies within its image, as :func:`sample_crop_batch` draws them;
    they are not read on the host, and past that K10 stays inside its own
    memory but its values are undefined. ``augment_train_device.launches``
    counts its launches.
    """
    if batch_u8.dim() == 4:
        _refuse_downscaled_non_square(batch_u8.shape[1], batch_u8.shape[2], size)
    if batch_u8.device.type == "cpu":
        return augment_train_reference(batch_u8, boxes, flips, size, compute_dtype)
    if batch_u8.device.type != "cuda":
        raise ValueError(f"augment_train_device: unsupported device {batch_u8.device}")
    if batch_u8.dtype != torch.uint8 or batch_u8.dim() != 4 or batch_u8.shape[-1] != 3:
        raise ValueError("augment_train_device takes (N, H, W, 3) uint8, got "
                         f"{tuple(batch_u8.shape)} {batch_u8.dtype}")
    n, h, w, _ = batch_u8.shape
    augment_band_rows(h, w, size)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"train_augment writes float32 or bfloat16, not {compute_dtype}")
    if tuple(boxes.shape) != (n, 4) or tuple(flips.shape) != (n,) \
            or boxes.device != batch_u8.device or flips.device != batch_u8.device:
        raise ValueError(f"boxes (N, 4) and flips (N,) must lie on {batch_u8.device}")
    images = batch_u8.contiguous()
    boxes = boxes.to(torch.int32).contiguous()
    # a bool tensor is read as its bytes, 0 or 1, without a conversion launch
    flips = (flips.view(torch.uint8) if flips.dtype == torch.bool
             else flips.to(torch.uint8)).contiguous()
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
