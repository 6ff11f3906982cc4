"""Host -> device image loader. Counterpart of ``vitef_tpu/data/images/loader.py``
(``make_iterable`` :48-51, ``Loader`` :129-360 for fixed-size datasets,
``build_loader`` :375-395, ``build_train_val_loader`` :398-452).

A worker thread assembles each batch on the host and pins it when the target
is a CUDA device; the device copies it without blocking and finishes it:

- train: the uint8 images are gathered as they are, and a crop box and a
  flip flag are drawn per image (``sample_crop_batch``); on the device the
  train augment (kernel K10 on CUDA) crops, resizes, flips and normalizes.
  The epoch permutation and the boxes come from one
  ``np.random.default_rng(seed)`` in the JAX package's order (the
  permutation when an epoch starts, then each batch's boxes in batch order),
  so both packages see the same batches;
- val/test: Resize + CenterCrop through the port's C++
  ``vitef_tpu_torch.native.eval_transform_batch`` (PIL-parity, OpenMP across
  images); the device normalizes. A failed native build raises: there is no
  PIL path here.

File-backed datasets are not ported.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import repeat
from typing import Any

import numpy as np
import torch

from ... import native
from . import datasets as D
from .transforms import augment_train_device, normalize_device, sample_crop_batch


def make_iterable(dataloader):
    """Infinite generator cycling a loader."""
    for loader in repeat(dataloader):
        yield from loader


class Loader:
    """Iterable of device-ready ``(x, y)`` batches: x (N, C, size, size) normalized
    in ``compute_dtype`` (NCHW), y (N,) int64, both on ``device``.

    ``indices`` restricts the loader to a subset of the dataset (a train/val
    split); train mode shuffles it every epoch, val/test keep its order.
    """

    def __init__(self, dataset, *, device, batch_size: int = 128, size: int = 224,
                 mode: str = "test", drop_last: bool = True,
                 seed: int = 0, prefetch: int = 2, compute_dtype: str = "float32",
                 indices: np.ndarray | None = None):
        self.mode = mode.lower()
        if self.mode not in ("train", "val", "test"):
            raise ValueError(f"Mode {mode} not found. Options are 'train', 'val' and 'test'.")
        if not getattr(dataset, "fixed_size", False):
            raise NotImplementedError("file-backed datasets are not ported yet")
        self.dataset = dataset
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.size = size
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.prefetch = max(1, prefetch)
        self.compute_dtype = getattr(torch, compute_dtype)
        self.indices = np.arange(len(dataset)) if indices is None else np.asarray(indices)
        self.n_classes = dataset.n_classes
        if len(self) == 0:
            raise ValueError(
                f"Loader yields 0 batches/epoch: {len(self.indices)} sample(s) with "
                f"batch_size={batch_size}, drop_last={drop_last}.")

    def __len__(self):
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> list[np.ndarray]:
        """Index arrays of the epoch's batches; train mode draws a permutation."""
        order = self.rng.permutation(self.indices) if self.mode == "train" else self.indices
        n, bs = len(order), self.batch_size
        batches = [order[end - bs:end] for end in range(bs, n + 1, bs)]
        if not self.drop_last and n % bs:
            batches.append(order[n - n % bs:])
        return batches

    def _assemble(self, idx: np.ndarray) -> tuple[torch.Tensor, ...]:
        """Host part of one batch: uint8 (N, S, S, C) images and labels, and in
        train mode the crop boxes and flip flags."""
        y = torch.from_numpy(np.asarray(self.dataset.targets)[idx].astype(np.int64))
        if self.mode == "train":
            x = self.dataset.data[idx]
            boxes, flips = sample_crop_batch(self.rng, len(idx), x.shape[1], x.shape[2])
            host = (torch.from_numpy(x), y, torch.from_numpy(boxes), torch.from_numpy(flips))
        else:
            x = native.eval_transform_batch(self.dataset.data[idx], self.size)
            host = (torch.from_numpy(x), y)
        if self.device.type == "cuda":
            host = tuple(t.pin_memory() for t in host)
        return host

    def _to_device(self, host: tuple[torch.Tensor, ...]):
        x, y, *crop = (t.to(self.device, non_blocking=True) for t in host)
        if crop:
            boxes, flips = crop
            return augment_train_device(x, boxes, flips, size=self.size,
                                        compute_dtype=self.compute_dtype), y
        return normalize_device(x, compute_dtype=self.compute_dtype), y

    def __iter__(self):
        batches = self._batches()
        # One worker, so batches (and their crop draws) are assembled in order.
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


_LOADER_KEYS = ("seed", "prefetch", "compute_dtype")


def _pop_loader_kwargs(config: dict) -> dict:
    return {k: config.pop(k) for k in _LOADER_KEYS if k in config}


def build_loader(config: dict[str, Any], *, device, drop_last: bool = True) -> Loader:
    """Pops batch_size/size/mode and the loader keys, builds the dataset from
    the rest; shuffles iff train."""
    config = dict(config)
    batch_size = config.pop("batch_size", 128)
    size = config.pop("size", 224)
    mode = config["mode"]
    extra = _pop_loader_kwargs(config)
    dataset = build_dataset(config)
    return Loader(dataset, device=device, batch_size=batch_size, size=size, mode=mode,
                  drop_last=drop_last, **extra)


def build_train_val_loader(config: dict[str, Any], *, device, train_size: float = 0.8,
                           return_n_classes: bool = False):
    """A random ``train_size`` split of the train set into a shuffled train
    loader and a val loader. The split is drawn from numpy's global RNG, as
    the JAX package draws it (seed it with ``np.random.seed``)."""
    config = dict(config)
    batch_size = config.pop("batch_size", 128)
    val_batch_size = config.pop("val_batch_size", 128)
    size = config.pop("size", 224)
    extra = _pop_loader_kwargs(config)
    config["mode"] = "train"
    dataset = build_dataset(config)
    n = len(dataset)
    perm = np.random.permutation(n)
    train_idx, val_idx = perm[:int(train_size * n)], perm[int(train_size * n):]
    train_loader = Loader(dataset, device=device, batch_size=batch_size, size=size,
                          mode="train", drop_last=True, indices=train_idx,
                          **extra)
    val_loader = Loader(dataset, device=device, batch_size=val_batch_size, size=size,
                        mode="val", drop_last=False, indices=val_idx,
                        **extra)
    if return_n_classes:
        return train_loader, val_loader, dataset.n_classes
    return train_loader, val_loader
