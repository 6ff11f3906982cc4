"""Host -> device image loader for evaluation. Counterpart of the val/test path of
``vitef_tpu/data/images/loader.py`` (``Loader`` :129-299: host part :243-269,
device part :272-286; ``build_loader`` :375-395).

Per batch, the host gathers the raw uint8 images and runs Resize + CenterCrop
through the C++ ``vitef_tpu.native.eval_transform_batch`` (PIL-parity, OpenMP
across images) in a worker thread, pinning the result when the target is a
CUDA device; the device copies it without blocking and normalizes it. A
failed native build raises: there is no PIL path here.

The train mode (device augment) comes with the training port.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from vitef_tpu import native

from . import datasets as D
from .transforms import normalize_device


class Loader:
    """Iterable of device-ready ``(x, y)`` batches: x (N, C, size, size) normalized
    in ``compute_dtype`` (NCHW), y (N,) int64, both on ``device``."""

    def __init__(self, dataset, *, device, batch_size: int = 128, size: int = 224,
                 mode: str = "test", drop_last: bool = True, prefetch: int = 2,
                 compute_dtype: str = "float32"):
        self.mode = mode.lower()
        if self.mode not in ("val", "test"):
            raise NotImplementedError(f"{mode!r} loading is not ported yet (val/test only)")
        if not getattr(dataset, "fixed_size", False):
            raise NotImplementedError("file-backed datasets are not ported yet")
        self.dataset = dataset
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.size = size
        self.drop_last = drop_last
        self.prefetch = max(1, prefetch)
        self.compute_dtype = getattr(torch, compute_dtype)
        if len(self) == 0:
            raise ValueError(
                f"Loader yields 0 batches/epoch: {len(dataset)} sample(s) with "
                f"batch_size={batch_size}, drop_last={drop_last}.")

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> list[np.ndarray]:
        """Index arrays of the epoch's batches, in dataset order (val/test never shuffle)."""
        n, bs = len(self.dataset), self.batch_size
        batches = [np.arange(start, min(start + bs, n)) for start in range(0, n, bs)]
        if self.drop_last and n % bs:
            batches.pop()
        return batches

    def _assemble(self, idx: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Host part of one batch: resized, center-cropped uint8 (N, S, S, C) and labels."""
        if not native.available():
            raise RuntimeError("vitef_tpu.native (C++ eval transform) could not be "
                               "built; the loader has no other resize path")
        x = torch.from_numpy(native.eval_transform_batch(self.dataset.data[idx], self.size))
        y = torch.from_numpy(np.asarray(self.dataset.targets)[idx].astype(np.int64))
        if self.device.type == "cuda":
            x, y = x.pin_memory(), y.pin_memory()
        return x, y

    def _to_device(self, host: tuple[torch.Tensor, torch.Tensor]):
        x, y = host
        x = x.to(self.device, non_blocking=True)
        y = y.to(self.device, non_blocking=True)
        return normalize_device(x, compute_dtype=self.compute_dtype), y

    def __iter__(self):
        batches = self._batches()
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = deque(pool.submit(self._assemble, idx)
                            for idx in batches[:self.prefetch])
            for idx in batches[self.prefetch:] + [None] * len(pending):
                host = pending.popleft().result()
                if idx is not None:
                    pending.append(pool.submit(self._assemble, idx))
                yield self._to_device(host)


def build_dataset(config: dict[str, Any]):
    """``synthetic`` or ``synthetic-<n_samples>``; other datasets are not ported yet."""
    config = dict(config)
    config.pop("transform", None)
    name = config.pop("dataset_name", "synthetic").lower()
    if not name.startswith("synthetic"):
        raise NotImplementedError(f"dataset {name!r} is not ported yet (synthetic only)")
    if name != "synthetic":
        config["n_samples"] = int(name.split("synthetic-", 1)[-1])
    return D.SyntheticDataset(D.SyntheticDatasetConfig(**config))


_LOADER_KEYS = ("prefetch", "compute_dtype")


def build_loader(config: dict[str, Any], *, device, drop_last: bool = True) -> Loader:
    """Pops batch_size/size/mode and the loader keys, builds the dataset from
    the rest."""
    config = dict(config)
    batch_size = config.pop("batch_size", 128)
    size = config.pop("size", 224)
    mode = config["mode"]
    extra = {k: config.pop(k) for k in _LOADER_KEYS if k in config}
    dataset = build_dataset(config)
    return Loader(dataset, device=device, batch_size=batch_size, size=size, mode=mode,
                  drop_last=drop_last, **extra)
