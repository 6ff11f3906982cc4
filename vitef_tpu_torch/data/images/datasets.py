"""Image datasets. Counterpart of ``vitef_tpu/data/images/datasets.py``
(:62-471): the synthetic set and the paper's nine families, read from their
on-disk formats with no torchvision (pickled CIFAR batches, CIFAR-C ``.npy``
dumps, ImageFolder trees, Flowers102's ``.mat`` and Pet's ``.txt`` split
files). Sample order is torchvision's, so the deterministic 80/20 splits
(numpy seed 42, :func:`~vitef_tpu_torch.utils.tree.deterministic_split`)
pick the same images as the JAX package's.

- Fixed-size sets (synthetic, CIFAR*, *-C): ``.data`` (N, H, W, C) uint8
  and ``.targets``; the loader gathers a batch and augments it on the device.
- File-backed sets (ImageNet, ImageNet-C, DomainNet, Flowers102, Pet):
  ``.samples`` [(path, label)], decoded one by one by :meth:`load_image`,
  which imports PIL (the machine with the card has no PIL, so there only the
  fixed-size sets run).

Nothing is downloaded: a missing file raises and names where the set comes
from.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np

from ...config import DATASET_DIR
from ...utils.tree import deterministic_split

CORRUPTION_TYPES = [
    "brightness", "contrast", "defocus_blur", "elastic_transform", "fog",
    "frost", "gaussian_blur", "gaussian_noise", "glass_blur", "impulse_noise",
    "jpeg_compression", "motion_blur", "pixelate", "saturate", "shot_noise",
    "snow", "spatter", "speckle_noise", "zoom_blur",
]

DOMAINS = ["clipart", "infograph", "painting", "quickdraw", "real", "sketch"]


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
        if self.mode not in ["train", "val", "test"]:
            raise ValueError(f"Invalid mode {self.mode}.")


class ImageDataset:
    """Base: either in-memory ``data``/``targets`` or file-backed ``samples``."""

    data: np.ndarray | None = None  # (N, H, W, C) uint8
    targets: Any = None
    samples: list | None = None  # [(path, label)]
    n_classes: int = 0

    def __len__(self):
        return len(self.data) if self.data is not None else len(self.samples)

    @property
    def fixed_size(self) -> bool:
        return self.data is not None

    def load_image(self, idx: int):
        """PIL image (RGB) + label of sample ``idx`` of a file-backed set."""
        from PIL import Image

        path, label = self.samples[idx]
        return Image.open(path).convert("RGB"), int(label)

    def __repr__(self):
        return f"Dataset with {len(self)} images."


def _imagefolder_samples(root: Path) -> tuple[list, list[str]]:
    """torchvision.datasets.ImageFolder ordering: classes sorted; within each
    class dir, ``sorted(os.walk)`` roots and sorted file names."""
    import os

    root = Path(root)
    if not root.exists():
        raise FileNotFoundError(f"ImageFolder root {root} does not exist")
    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    class_to_idx = {c: i for i, c in enumerate(classes)}
    exts = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp")
    samples = []
    for c in classes:
        d = root / c
        for sub_root, _, fnames in sorted(os.walk(d, followlinks=True)):
            for fname in sorted(fnames):
                if fname.lower().endswith(exts):
                    samples.append((str(Path(sub_root) / fname), class_to_idx[c]))
    return samples, classes


def _apply_deterministic_split(n: int, train: bool) -> np.ndarray:
    """The sorted indices of the train (or test) part of the seed-42 80/20
    split of ``n`` samples."""
    train_idx, test_idx = deterministic_split(n, 0.8)
    return np.sort(train_idx if train else test_idx)


class SyntheticDataset(ImageDataset):
    """Class-separable random uint8 images; labels encoded into channel 0."""

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


# ------------------------------------------------------------------------------
# CIFAR-10 / CIFAR-100 (pickled batch files)
# ------------------------------------------------------------------------------


@dataclass
class Cifar10DatasetConfig:
    """CIFAR-10 under ``<save_dir>/cifar-10-batches-py``."""

    save_dir: str | None = None
    mode: str = "train"

    def __post_init__(self):
        if self.mode not in ["train", "test"]:
            raise ValueError(f"Invalid mode {self.mode}. Options are 'train' and 'test.")
        if self.save_dir is None:
            self.save_dir = str(DATASET_DIR / "cifar10")


def _load_cifar_batches(base: Path, files: list[str], labels_key: bytes):
    xs, ys = [], []
    for fname in files:
        path = base / fname
        if not path.exists():
            raise FileNotFoundError(
                f"CIFAR batch {path} not found. Download from "
                "https://www.cs.toronto.edu/~kriz/cifar.html and extract under "
                f"{base.parent}."
            )
        with open(path, "rb") as f:
            entry = pickle.load(f, encoding="bytes")
        xs.append(entry[b"data"])
        ys.extend(entry[labels_key])
    data = np.vstack(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(data), np.asarray(ys, np.int64)


class Cifar10Dataset(ImageDataset):
    """CIFAR-10: 50k train / 10k test, 32×32, 10 classes."""

    def __init__(self, config: Cifar10DatasetConfig):
        base = Path(config.save_dir) / "cifar-10-batches-py"
        if config.mode == "train":
            files = [f"data_batch_{i}" for i in range(1, 6)]
        else:
            files = ["test_batch"]
        self.data, self.targets = _load_cifar_batches(base, files, b"labels")
        self.n_classes = 10


@dataclass
class Cifar100DatasetConfig:
    """CIFAR-100 under ``<save_dir>/cifar-100-python``."""

    save_dir: str | None = None
    mode: str = "train"

    def __post_init__(self):
        if self.mode not in ["train", "test"]:
            raise ValueError(f"Invalid mode {self.mode}. Options are 'train' and 'test.")
        if self.save_dir is None:
            self.save_dir = str(DATASET_DIR / "cifar100")


class Cifar100Dataset(ImageDataset):
    """CIFAR-100: fine labels, 100 classes."""

    def __init__(self, config: Cifar100DatasetConfig):
        base = Path(config.save_dir) / "cifar-100-python"
        fname = "train" if config.mode == "train" else "test"
        self.data, self.targets = _load_cifar_batches(base, [fname], b"fine_labels")
        self.n_classes = 100


# ------------------------------------------------------------------------------
# CIFAR-10-C / CIFAR-100-C (.npy zenodo dumps, severity slices, 80/20 split)
# ------------------------------------------------------------------------------


@dataclass
class Cifar10CDatasetConfig:
    """CIFAR-10-C: ``<save_dir>/<corruption>.npy`` and ``labels.npy``."""

    save_dir: str | None = None
    corruption_type: str = "brightness"
    corruption_severity: int = 1
    mode: str = "train"

    def __post_init__(self):
        if self.corruption_type not in CORRUPTION_TYPES:
            raise ValueError(f"Invalid corruption type {self.corruption_type}. "
            "See documentation for options.")
        if self.corruption_severity not in [1, 2, 3, 4, 5]:
            raise ValueError(f"Invalid severity {self.corruption_severity}. "
                             "Options are from 1 to 5.")
        if self.mode not in ["train", "test"]:
            raise ValueError(f"Invalid mode {self.mode}. Options are 'train' and 'test.")
        if self.save_dir is None:
            self.save_dir = str(DATASET_DIR / "cifar10_c")


class _CifarCDataset(ImageDataset):
    n_per_severity = 10_000

    def __init__(self, config, n_classes: int):
        save_dir = Path(config.save_dir)
        path_images = save_dir / f"{config.corruption_type}.npy"
        path_labels = save_dir / "labels.npy"
        if not path_images.exists():
            raise FileNotFoundError(
                f"{path_images} not found. Download CIFAR-C from "
                "https://zenodo.org/record/2535967."
            )
        start = (config.corruption_severity - 1) * self.n_per_severity
        end = start + self.n_per_severity
        data = np.load(path_images)[start:end]
        targets = np.asarray(
            [int(l) for l in np.load(path_labels)[start:end]], np.int64
        )
        indices = _apply_deterministic_split(len(data), config.mode == "train")
        self.data = np.ascontiguousarray(data[indices])
        self.targets = targets[indices]
        self.n_classes = n_classes


class Cifar10CDataset(_CifarCDataset):
    """CIFAR-10-C: one severity's 10,000 images, split 80/20."""

    def __init__(self, config: Cifar10CDatasetConfig):
        super().__init__(config, n_classes=10)


@dataclass
class Cifar100CDatasetConfig(Cifar10CDatasetConfig):
    """CIFAR-100-C, laid out as CIFAR-10-C."""

    def __post_init__(self):
        if self.save_dir is None:
            self.save_dir = str(DATASET_DIR / "cifar100_c")
        super().__post_init__()


class Cifar100CDataset(_CifarCDataset):
    """CIFAR-100-C: one severity's 10,000 images, split 80/20."""

    def __init__(self, config: Cifar100CDatasetConfig):
        super().__init__(config, n_classes=100)


# ------------------------------------------------------------------------------
# ImageNet / ImageNet-C / DomainNet (ImageFolder trees)
# ------------------------------------------------------------------------------


@dataclass
class ImageNetDatasetConfig:
    """ImageNet under ``<save_dir>/{train,val}``."""

    save_dir: str | None = None
    mode: str = "train"

    def __post_init__(self):
        if self.mode not in ["train", "val"]:
            raise ValueError(f"Invalid mode {self.mode}. Options are 'train' and 'val'.")
        if self.save_dir is None:
            self.save_dir = str(DATASET_DIR / "imagenet")


class ImageNetDataset(ImageDataset):
    """ImageNet: an ImageFolder over ``<save_dir>/{train,val}``, 1000 classes."""

    def __init__(self, config: ImageNetDatasetConfig):
        split = "train" if config.mode == "train" else "val"
        self.samples, _ = _imagefolder_samples(Path(config.save_dir) / split)
        self.n_classes = 1000


@dataclass
class ImageNetCDatasetConfig:
    """ImageNet-C under ``<save_dir>/<corruption>/<severity>``."""

    save_dir: str | None = None
    corruption_type: str = "brightness"
    corruption_severity: int = 1
    mode: str = "train"

    def __post_init__(self):
        if self.corruption_type not in CORRUPTION_TYPES:
            raise ValueError(f"Invalid corruption type {self.corruption_type}.")
        if self.corruption_severity not in [1, 2, 3, 4, 5]:
            raise ValueError(f"Invalid severity {self.corruption_severity}.")
        if self.mode not in ["train", "val", "test"]:
            raise ValueError(f"Invalid mode {self.mode}. Options are 'train', 'val' "
                             "and 'test'.")
        if self.save_dir is None:
            self.save_dir = str(DATASET_DIR / "imagenet_c")


class ImageNetCDataset(ImageDataset):
    """ImageNet-C: an ImageFolder over
    ``<corruption>/<severity>``; mode 'val' = full set, train/test = 80/20."""

    def __init__(self, config: ImageNetCDatasetConfig):
        root = (Path(config.save_dir) / config.corruption_type
                / str(config.corruption_severity))
        samples, _ = _imagefolder_samples(root)
        if config.mode == "val":
            self.samples = samples
        else:
            indices = _apply_deterministic_split(len(samples), config.mode == "train")
            self.samples = [samples[i] for i in indices]
        self.n_classes = 1000


@dataclass
class DomainNetDatasetConfig:
    """DomainNet under ``<save_dir>/<domain>``."""

    save_dir: str | None = None
    domain: str = "clipart"
    mode: str = "train"

    def __post_init__(self):
        if self.domain not in DOMAINS:
            raise ValueError(f"Invalid domain {self.domain}. Options are {DOMAINS}.")
        if self.mode not in ["train", "test"]:
            raise ValueError(f"Invalid mode {self.mode}. Options are 'train' and 'test.")
        if self.save_dir is None:
            self.save_dir = str(DATASET_DIR / "domainnet")


class DomainNetDataset(ImageDataset):
    """DomainNet: one domain's ImageFolder, split 80/20, 345 classes."""

    def __init__(self, config: DomainNetDatasetConfig):
        samples, _ = _imagefolder_samples(Path(config.save_dir) / config.domain)
        indices = _apply_deterministic_split(len(samples), config.mode == "train")
        self.samples = [samples[i] for i in indices]
        self.n_classes = 345


# ------------------------------------------------------------------------------
# Flowers102 (.mat splits) / Oxford-IIIT Pet (annotation txt splits)
# ------------------------------------------------------------------------------


@dataclass
class Flowers102DatasetConfig:
    """Flowers102 under ``<save_dir>[/flowers-102]``."""

    save_dir: str | None = None
    mode: str = "train"

    def __post_init__(self):
        if self.mode not in ["train", "val", "test"]:
            raise ValueError(f"Invalid mode {self.mode}. Options are 'train', 'val' and 'test.")
        if self.save_dir is None:
            self.save_dir = str(DATASET_DIR / "flowers102")


class Flowers102Dataset(ImageDataset):
    """Flowers102 in torchvision's layout:
    ``<root>/flowers-102/{jpg/, imagelabels.mat, setid.mat}``; real splits."""

    _split_key = {"train": "trnid", "val": "valid", "test": "tstid"}

    def __init__(self, config: Flowers102DatasetConfig):
        from scipy.io import loadmat

        base = Path(config.save_dir)
        if (base / "flowers-102").exists():
            base = base / "flowers-102"
        set_ids = loadmat(base / "setid.mat", squeeze_me=True)
        image_ids = set_ids[self._split_key[config.mode]].tolist()
        labels = loadmat(base / "imagelabels.mat", squeeze_me=True)["labels"].tolist()
        image_id_to_label = {i + 1: l - 1 for i, l in enumerate(labels)}
        self.samples = [
            (str(base / "jpg" / f"image_{i:05d}.jpg"), image_id_to_label[i])
            for i in image_ids
        ]
        self.n_classes = 102


@dataclass
class OxfordIIITPetDatasetConfig:
    """Oxford-IIIT Pet under ``<save_dir>[/oxford-iiit-pet]``."""

    save_dir: str | None = None
    mode: str = "train"

    def __post_init__(self):
        if self.mode not in ["train", "test"]:
            raise ValueError(f"Invalid mode {self.mode}. Options are 'train' and 'test.")
        if self.save_dir is None:
            self.save_dir = str(DATASET_DIR / "pet")


class OxfordIIITPetDataset(ImageDataset):
    """Oxford-IIIT Pet in torchvision's layout:
    ``<root>/oxford-iiit-pet/{images/, annotations/{trainval,test}.txt}``."""

    def __init__(self, config: OxfordIIITPetDatasetConfig):
        base = Path(config.save_dir)
        if (base / "oxford-iiit-pet").exists():
            base = base / "oxford-iiit-pet"
        split = "trainval" if config.mode == "train" else "test"
        ann = base / "annotations" / f"{split}.txt"
        if not ann.exists():
            raise FileNotFoundError(
                f"{ann} not found. Download from "
                "https://www.robots.ox.ac.uk/~vgg/data/pets/."
            )
        self.samples = []
        with open(ann) as f:
            for line in f:
                parts = line.strip().split()
                if not parts or parts[0].startswith("#"):
                    continue
                name, class_id = parts[0], int(parts[1])
                self.samples.append(
                    (str(base / "images" / f"{name}.jpg"), class_id - 1)
                )
        self.n_classes = 37
