"""Host -> device image loader. Counterpart of ``vitef_tpu/data/images/loader.py``
(``PREDEFINED_VAL_DATASETS`` :45, ``make_iterable`` :48-51,
``build_dataset`` :59-106, ``Loader`` :129-360, ``build_loader`` :375-395,
``build_train_val_loader`` :398-452).

A worker thread assembles each batch on the host, in batch order, and pins
it when the target is a CUDA device; the device copies it without blocking
and finishes it:

- train, fixed-size sets (synthetic, CIFAR*, *-C): the uint8 images are
  gathered as they are, and a crop box and a flip flag are drawn per image
  (``sample_crop_batch``); on the device the train augment (kernel K10 on
  CUDA) crops, resizes, flips and normalizes;
- train, file-backed sets: each image is decoded with PIL, a
  RandomResizedCrop box is drawn for it and PIL's bilinear
  ``resize(box=...)`` takes it to ``size`` on the host; the device
  normalizes and flips;
- val/test: Resize + CenterCrop on the host, through the port's C++
  ``vitef_tpu_torch.native.eval_transform_batch`` (PIL-parity, OpenMP
  across images) for fixed-size sets and through PIL for file-backed ones;
  the device normalizes. A failed native build raises.

The epoch permutation, the crop boxes and the flips come from one
``np.random.default_rng(seed)`` in the JAX package's order (the permutation
when an epoch starts, then each batch's boxes in batch order, then its
flips), so both packages see the same batches. File-backed images are
decoded and resized by ``num_workers`` threads, but their boxes are drawn
in batch order on the assembling thread: the JAX package draws them inside
its worker threads, so the two agree at ``num_workers=0`` and, past it, the
JAX package's order depends on the threads' timing.
"""

from __future__ import annotations

import logging
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from itertools import repeat
from typing import Any

import numpy as np
import torch

from ... import native
from ...utils.typed import build_with_type_check
from . import datasets as D
from .transforms import (augment_train_device, eval_transform_host, normalize_device,
                         resized_crop_pil, sample_crop_batch, sample_resized_crop_params)

logger = logging.getLogger("vitef")

# Datasets whose validation split is their own (not carved from train).
PREDEFINED_VAL_DATASETS = ["flowers102"]


def make_iterable(dataloader):
    """Infinite generator cycling a loader."""
    for loader in repeat(dataloader):
        yield from loader


def build_dataset(config: dict[str, Any]) -> D.ImageDataset:
    """The dataset ``dataset_name`` names, with the JAX package's encoded
    names: ``synthetic-<n_samples>``,
    ``cifar10_c-corruption-<type>-severity-<n>`` (and ``cifar100_c``,
    ``imagenet_c``), ``domainnet-<domain>``. The other keys go to its config."""
    config = dict(config)
    config.pop("transform", None)
    dataset_name = config.pop("dataset_name", "cifar10")
    name = dataset_name.lower()

    def parse_corruption(prefix: str):
        substring = dataset_name.split(prefix, 1)[-1]
        substring = substring.split("-corruption-", 1)[-1]
        ctype, severity = substring.split("-severity-", 1)
        config["corruption_type"] = ctype
        config["corruption_severity"] = int(severity)

    if name.startswith("synthetic"):
        if name != "synthetic":
            config["n_samples"] = int(name.split("synthetic-", 1)[-1])
        cls, cfg_cls = D.SyntheticDataset, D.SyntheticDatasetConfig
    elif name == "cifar10":
        cls, cfg_cls = D.Cifar10Dataset, D.Cifar10DatasetConfig
    elif "cifar10_c" in name:
        parse_corruption("cifar10_c")
        cls, cfg_cls = D.Cifar10CDataset, D.Cifar10CDatasetConfig
    elif name == "cifar100":
        cls, cfg_cls = D.Cifar100Dataset, D.Cifar100DatasetConfig
    elif "cifar100_c" in name:
        parse_corruption("cifar100_c")
        cls, cfg_cls = D.Cifar100CDataset, D.Cifar100CDatasetConfig
    elif "domainnet" in name:
        config["domain"] = dataset_name.split("domainnet-", 1)[-1]
        cls, cfg_cls = D.DomainNetDataset, D.DomainNetDatasetConfig
    elif name == "flowers102":
        cls, cfg_cls = D.Flowers102Dataset, D.Flowers102DatasetConfig
    elif name == "imagenet":
        cls, cfg_cls = D.ImageNetDataset, D.ImageNetDatasetConfig
    elif "imagenet_c" in name:
        parse_corruption("imagenet_c")
        cls, cfg_cls = D.ImageNetCDataset, D.ImageNetCDatasetConfig
    elif name == "pet":
        cls, cfg_cls = D.OxfordIIITPetDataset, D.OxfordIIITPetDatasetConfig
    else:
        raise ValueError(f"Dataset name {dataset_name} not found.")
    return cls(build_with_type_check(cfg_cls, config))


class Loader:
    """Iterable of device-ready ``(x, y)`` batches: x (N, C, size, size) normalized
    in ``compute_dtype`` (NCHW), y (N,) int64, both on ``device``.

    ``indices`` restricts the loader to a subset of the dataset (a train/val
    split). ``shuffle`` (default: in train mode) draws a new order of it
    every epoch; ``num_workers`` threads decode file-backed images.

    ``shard_index``/``shard_count`` (data parallelism over several
    processes, :150-205): every process draws the same epoch order (same
    seed), trims it to a multiple of ``shard_count`` so that every process
    runs the same number of batches, and takes the disjoint stride
    ``order[shard_index::shard_count]``; each batch is ``batch_size`` rows
    of that stride.
    """

    def __init__(self, dataset, *, device, batch_size: int = 128, size: int = 224,
                 mode: str = "test", shuffle: bool | None = None, drop_last: bool = True,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 2,
                 compute_dtype: str = "float32", indices: np.ndarray | None = None,
                 shard_index: int = 0, shard_count: int = 1):
        self.mode = mode.lower()
        if self.mode not in ("train", "val", "test"):
            raise ValueError(f"Mode {mode} not found. Options are 'train', 'val' and 'test'.")
        self.dataset = dataset
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.size = size
        self.shuffle = self.mode == "train" if shuffle is None else shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.compute_dtype = getattr(torch, compute_dtype)
        self.indices = np.arange(len(dataset)) if indices is None else np.asarray(indices)
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index {shard_index} is not in [0, {shard_count})")
        self.shard_index, self.shard_count = shard_index, shard_count
        self.n_classes = dataset.n_classes
        if len(self) == 0:
            raise ValueError(
                f"Loader yields 0 batches/epoch: {len(self.indices)} sample(s) (shard "
                f"{shard_index}/{shard_count}) with batch_size={batch_size}, "
                f"drop_last={drop_last}.")

    def __len__(self):
        n = len(self.indices) // self.shard_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_order(self) -> np.ndarray:
        """This shard's sample order for one epoch (a shuffling loader draws
        a permutation of the whole epoch first)."""
        order = self.rng.permutation(self.indices) if self.shuffle else self.indices
        if self.shard_count > 1:
            order = order[:len(order) - len(order) % self.shard_count]
            order = order[self.shard_index::self.shard_count]
        return order

    def _batches(self) -> list[np.ndarray]:
        """Index arrays of the epoch's batches."""
        order = self._epoch_order()
        n, bs = len(order), self.batch_size
        batches = [order[end - bs:end] for end in range(bs, n + 1, bs)]
        if not self.drop_last and n % bs:
            batches.append(order[n - n % bs:])
        return batches

    def _assemble(self, idx: np.ndarray, pool) -> tuple[str, tuple[torch.Tensor, ...]]:
        """Host part of one batch: its kind ("augment", "flip" or "normalize")
        and its tensors, uint8 (N, H, W, C) images and labels first, then the
        crop boxes and flip flags or the flip flags."""
        ds = self.dataset
        if ds.fixed_size:
            y = np.asarray(ds.targets)[idx].astype(np.int64)
            if self.mode == "train":
                x = ds.data[idx]
                boxes, flips = sample_crop_batch(self.rng, len(idx), x.shape[1], x.shape[2])
                kind, arrays = "augment", (x, y, boxes, flips)
            else:
                kind, arrays = "normalize", (native.eval_transform_batch(ds.data[idx],
                                                                         self.size), y)
        else:
            mapped = pool.map if pool is not None else map
            images, labels = zip(*mapped(ds.load_image, (int(i) for i in idx)))
            y = np.asarray(labels, np.int64)
            if self.mode == "train":
                boxes = [sample_resized_crop_params(self.rng, img.size[1], img.size[0])
                         for img in images]
                x = np.stack(list(mapped(resized_crop_pil, images, boxes,
                                         repeat(self.size))))
                kind, arrays = "flip", (x, y, self.rng.random(len(idx)) < 0.5)
            else:
                x = np.stack(list(mapped(eval_transform_host, images, repeat(self.size))))
                kind, arrays = "normalize", (x, y)
        host = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
        if self.device.type == "cuda":
            host = tuple(t.pin_memory() for t in host)
        return kind, host

    def _to_device(self, kind: str, host: tuple[torch.Tensor, ...]):
        x, y, *rest = (t.to(self.device, non_blocking=True) for t in host)
        if kind == "augment":
            boxes, flips = rest
            return augment_train_device(x, boxes, flips, size=self.size,
                                        compute_dtype=self.compute_dtype), y
        x = normalize_device(x, compute_dtype=self.compute_dtype)
        if kind == "flip":
            x = torch.where(rest[0][:, None, None, None], x.flip(-1), x)
        return x, y

    def __iter__(self):
        batches = self._batches()
        decoding = (ThreadPoolExecutor(max_workers=self.num_workers)
                    if self.num_workers > 0 and not self.dataset.fixed_size else nullcontext())
        # One assembling worker, so batches (and their draws) come in order.
        with decoding as decode_pool, ThreadPoolExecutor(max_workers=1) as pool:
            pending = deque(pool.submit(self._assemble, idx, decode_pool)
                            for idx in batches[:self.prefetch])
            for idx in batches[self.prefetch:] + [None] * len(pending):
                kind, host = pending.popleft().result()
                if idx is not None:
                    pending.append(pool.submit(self._assemble, idx, decode_pool))
                yield self._to_device(kind, host)


_LOADER_KEYS = ("num_workers", "seed", "prefetch", "compute_dtype", "shard_index",
                "shard_count")


def _pop_loader_kwargs(config: dict) -> dict:
    return {k: config.pop(k) for k in _LOADER_KEYS if k in config}


def build_loader(config: dict[str, Any], *, device, drop_last: bool = True,
                 force_shuffle: bool = False, return_n_classes: bool = False):
    """Pops batch_size/size/mode and the loader keys, builds the dataset from
    the rest; shuffles in train mode or when ``force_shuffle``. With
    ``return_n_classes``, returns ``(loader, n_classes)``."""
    config = dict(config)
    batch_size = config.pop("batch_size", 128)
    size = config.pop("size", 224)
    mode = config["mode"]
    extra = _pop_loader_kwargs(config)
    dataset = build_dataset(config)
    loader = Loader(dataset, device=device, batch_size=batch_size, size=size, mode=mode,
                    shuffle=force_shuffle or mode == "train", drop_last=drop_last, **extra)
    if return_n_classes:
        return loader, dataset.n_classes
    return loader


def build_train_val_loader(config: dict[str, Any], *, device, train_size: float = 0.8,
                           return_n_classes: bool = False):
    """A shuffled train loader and a val loader: the dataset's own val split
    for ``PREDEFINED_VAL_DATASETS``, else a random ``train_size`` split of
    the train set, drawn from numpy's global RNG as the JAX package draws it
    (seed it with ``np.random.seed``, as the Utility's ``set_seed`` does)."""
    config = dict(config)
    batch_size = config.pop("batch_size", 128)
    val_batch_size = config.pop("val_batch_size", 128)
    size = config.pop("size", 224)
    extra = _pop_loader_kwargs(config)
    val_extra = {k: v for k, v in extra.items() if k not in ("shard_index", "shard_count")}
    if config["dataset_name"] in PREDEFINED_VAL_DATASETS:
        logger.info("Validation set is pre-defined and used directly without splitting the "
                    "training set.")
        train_set = build_dataset({**config, "mode": "train"})
        val_set = build_dataset({**config, "mode": "val"})
        n_classes = train_set.n_classes
        train_idx = val_idx = None
    else:
        logger.info("Validation set is not pre-defined, thus training set is split into "
                    "training and validation sets.")
        train_set = val_set = build_dataset({**config, "mode": "train"})
        n_classes = train_set.n_classes
        n = len(train_set)
        perm = np.random.permutation(n)
        train_idx, val_idx = perm[:int(train_size * n)], perm[int(train_size * n):]
    train_loader = Loader(train_set, device=device, batch_size=batch_size, size=size,
                          mode="train", shuffle=True, drop_last=True, indices=train_idx,
                          **extra)
    val_loader = Loader(val_set, device=device, batch_size=val_batch_size, size=size,
                        mode="val", shuffle=False, drop_last=False, indices=val_idx,
                        **val_extra)
    if return_n_classes:
        return train_loader, val_loader, n_classes
    return train_loader, val_loader
