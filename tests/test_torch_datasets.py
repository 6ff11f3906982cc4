"""The port's datasets and file-backed loader branches against the JAX package's.

Each of the paper's dataset families is written to disk in its own format by
the test (CIFAR pickles, CIFAR-C ``.npy`` dumps, PNG image folders, the
Flowers102 ``.mat`` and Pet ``.txt`` split files beside JPEG images), read
by both packages' ``build_dataset`` through the encoded names, and compared
sample for sample. The file-backed train loader (PIL decode, RandomResizedCrop
on the host, normalize and flip on the device) and the val loaders give the
JAX loader's batches at ``num_workers=0``.
"""

import pickle

import numpy as np
import pytest
import scipy.io
import torch
from PIL import Image

import vitef_tpu.data.images.datasets as jax_D
from vitef_tpu.data.images import loader as jax_loader
from vitef_tpu_torch.data.images import datasets as D
from vitef_tpu_torch.data.images import loader

N_PER_SEVERITY = 20   # CIFAR-C severities cut from 10,000 images to 20


def _image(rng, h, w):
    return Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Every dataset family on disk, small."""
    root = tmp_path_factory.mktemp("datasets")
    rng = np.random.default_rng(0)

    base = root / "cifar10" / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for fname in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / fname, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, size=(8, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, size=8).tolist()}, f)
    base = root / "cifar100" / "cifar-100-python"
    base.mkdir(parents=True)
    for fname, n in (("train", 20), ("test", 10)):
        with open(base / fname, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, size=(n, 3072), dtype=np.uint8),
                         b"fine_labels": rng.integers(0, 100, size=n).tolist()}, f)
    for name in ("cifar10_c", "cifar100_c"):
        (root / name).mkdir()
        n = 5 * N_PER_SEVERITY
        np.save(root / name / "snow.npy",
                rng.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8))
        np.save(root / name / "labels.npy", rng.integers(0, 10, size=n))

    def folder(path, classes, per_class):
        for c in classes:
            (path / c).mkdir(parents=True)
            for i in range(per_class):
                _image(rng, int(rng.integers(20, 48)), int(rng.integers(20, 48))).save(
                    path / c / f"img_{i:03d}.png")

    folder(root / "imagenet" / "train", ["n01", "n02"], 3)
    folder(root / "imagenet" / "val", ["n01", "n02"], 3)
    folder(root / "imagenet_c" / "snow" / "2", ["n01", "n02"], 5)
    folder(root / "domainnet" / "sketch", ["apple", "banana", "cat"], 4)

    flowers = root / "flowers102" / "flowers-102"
    (flowers / "jpg").mkdir(parents=True)
    for i in range(1, 13):
        _image(rng, 30 + i, 40).save(flowers / "jpg" / f"image_{i:05d}.jpg")
    scipy.io.savemat(flowers / "imagelabels.mat", {"labels": rng.integers(1, 103, size=12)})
    scipy.io.savemat(flowers / "setid.mat", {"trnid": np.array([1, 4, 5, 8, 9, 12]),
                                             "valid": np.array([2, 6, 10]),
                                             "tstid": np.array([3, 7, 11])})
    pet = root / "pet" / "oxford-iiit-pet"
    (pet / "images").mkdir(parents=True)
    (pet / "annotations").mkdir()
    for split, names in (("trainval", ["Abyssinian_1", "beagle_2", "Bengal_3"]),
                         ("test", ["boxer_4", "pug_5"])):
        lines = ["#Image CLASS-ID SPECIES BREED ID"]
        for j, name in enumerate(names):
            _image(rng, 28, 36 + j).save(pet / "images" / f"{name}.jpg")
            lines.append(f"{name} {j * 5 + 1} 1 {j + 1}")
        (pet / "annotations" / f"{split}.txt").write_text("\n".join(lines) + "\n")
    return root


CASES = [("cifar10", "cifar10", m) for m in ("train", "test")] + \
    [("cifar100", "cifar100", m) for m in ("train", "test")] + \
    [("cifar10_c", "cifar10_c-corruption-snow-severity-3", m) for m in ("train", "test")] + \
    [("cifar100_c", "cifar100_c-corruption-snow-severity-5", m) for m in ("train", "test")] + \
    [("imagenet", "imagenet", m) for m in ("train", "val")] + \
    [("imagenet_c", "imagenet_c-corruption-snow-severity-2", m)
     for m in ("train", "val", "test")] + \
    [("domainnet", "domainnet-sketch", m) for m in ("train", "test")] + \
    [("flowers102", "flowers102", m) for m in ("train", "val", "test")] + \
    [("pet", "pet", m) for m in ("train", "test")]


@pytest.fixture()
def short_severities(monkeypatch):
    monkeypatch.setattr(jax_D._CifarCDataset, "n_per_severity", N_PER_SEVERITY)
    monkeypatch.setattr(D._CifarCDataset, "n_per_severity", N_PER_SEVERITY)


@pytest.mark.parametrize("root_name, name, mode", CASES,
                         ids=[f"{c[1]}-{c[2]}" for c in CASES])
def test_dataset_matches_jax(roots, short_severities, root_name, name, mode):
    config = {"dataset_name": name, "save_dir": str(roots / root_name), "mode": mode}
    want = jax_loader.build_dataset(dict(config))
    got = loader.build_dataset(dict(config))
    assert got.n_classes == want.n_classes and len(got) == len(want) > 0
    assert got.fixed_size == want.fixed_size
    if want.fixed_size:
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(np.asarray(got.targets), np.asarray(want.targets))
    else:
        assert got.samples == want.samples
        img, label = got.load_image(len(got) - 1)
        want_img, want_label = want.load_image(len(want) - 1)
        assert label == want_label and img.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(img), np.asarray(want_img))


def _assert_batches(got_loader, want_loader, n: int, atol: float = 1e-5):
    got_it, want_it = loader.make_iterable(got_loader), jax_loader.make_iterable(want_loader)
    for _ in range(n):
        (x, y), (wx, wy) = next(got_it), next(want_it)
        np.testing.assert_array_equal(y.numpy(), np.asarray(wy))
        assert x.dtype == torch.float32 and x.shape == tuple(np.shape(wx))
        np.testing.assert_allclose(x.numpy(), np.asarray(wx), atol=atol, rtol=0)


def test_file_backed_train_loader_matches_jax(roots):
    """Two epochs of the host-crop branch at num_workers=0: same images, same
    boxes and flips from one generator, PIL's resize, normalize and flip."""
    config = {"dataset_name": "domainnet-sketch", "save_dir": str(roots / "domainnet"),
              "mode": "train", "batch_size": 4, "size": 24, "seed": 3, "num_workers": 0}
    want = jax_loader.build_loader({**config, "prefetch": 0})
    got = loader.build_loader(config, device="cpu")
    assert len(got) == len(want) == 2
    _assert_batches(got, want, 2 * len(got))


def test_file_backed_train_loader_workers_keep_the_draws(roots):
    """Decoding on 3 threads gives the batches of num_workers=0: the boxes are
    drawn in batch order on the assembling thread."""
    config = {"dataset_name": "imagenet", "save_dir": str(roots / "imagenet"),
              "mode": "train", "batch_size": 3, "size": 20, "seed": 5}
    serial = loader.build_loader({**config, "num_workers": 0}, device="cpu")
    threaded = loader.build_loader({**config, "num_workers": 3}, device="cpu")
    for (x, y), (sx, sy) in zip(threaded, serial):
        torch.testing.assert_close(x, sx, rtol=0, atol=0)
        torch.testing.assert_close(y, sy, rtol=0, atol=0)


def test_val_loaders_match_jax(roots):
    """The PIL eval transform of an image folder (last batch partial) and the
    native one of CIFAR, with build_loader's ``return_n_classes``."""
    config = {"dataset_name": "imagenet", "save_dir": str(roots / "imagenet"),
              "mode": "val", "batch_size": 4, "size": 24, "num_workers": 0}
    want, want_classes = jax_loader.build_loader({**config, "prefetch": 0}, drop_last=False,
                                                 return_n_classes=True)
    got, n_classes = loader.build_loader(config, device="cpu", drop_last=False,
                                         return_n_classes=True)
    assert n_classes == want_classes == 1000 and len(got) == len(want) == 2
    _assert_batches(got, want, 2, atol=1e-6)
    config = {"dataset_name": "cifar10", "save_dir": str(roots / "cifar10"),
              "mode": "test", "batch_size": 3, "size": 40, "num_workers": 0}
    want = jax_loader.build_loader({**config, "prefetch": 0}, drop_last=False)
    got = loader.build_loader(config, device="cpu", drop_last=False)
    _assert_batches(got, want, len(got), atol=1e-6)


def test_predefined_val_split_matches_jax(roots):
    """Flowers102 keeps its own val split in build_train_val_loader."""
    config = {"dataset_name": "flowers102", "save_dir": str(roots / "flowers102"),
              "batch_size": 2, "val_batch_size": 2, "size": 16, "seed": 1, "num_workers": 0}
    want_train, want_val, want_classes = jax_loader.build_train_val_loader(
        {**config, "prefetch": 0}, return_n_classes=True)
    got_train, got_val, n_classes = loader.build_train_val_loader(
        config, device="cpu", return_n_classes=True)
    assert n_classes == want_classes == 102
    assert len(got_train) == len(want_train) == 3 and len(got_val) == len(want_val) == 2
    assert got_val.dataset.samples == want_val.dataset.samples
    _assert_batches(got_train, want_train, 3)
    _assert_batches(got_val, want_val, 2, atol=1e-6)
