"""Plasticity analysis: per-component rate of change under distribution shift.

Counterpart of ``apps/vit/analysis.py`` (``distance`` :40-63,
``make_decomposition_distance_fn`` :66-75, ``AnalysisConfig`` :78-108,
``analysis`` :111-184, ``run_analysis`` :187-210, ``main`` :213-223).

    python -m vitef_tpu_torch.apps.vit.analysis run --dataset_name cifar10 --imagenet_dir <dir>

``analysis()`` decomposes ``n_steps`` pairs of batches, one of ImageNet val
(the pretraining data) and one of the downstream test split, with the in21k
ViT, and writes ``config.json`` and ``distances.pkl`` (per key, the
concatenated per-sample Frobenius distances) under
``<SAVING_DIR>/analysis/analysis_<model>_pretrained_<bool>_<dataset>``.
The decomposition quirks the statistic depends on (every block decomposed
on the same embedding output; fc2 on the zero-padded input) live in
:meth:`~vitef_tpu_torch.models.transformer.Transformer.get_decomposition`.
Both batches are decomposed on the model's device and only the (N,)
distance vectors come back to the host, as in the JAX app. ImageNet val is
an image folder, decoded with PIL, which the machine with the card lacks.
On the card unless ``device=cpu``; without one it raises.
"""

from __future__ import annotations

import json
import logging
import pickle
from dataclasses import asdict, dataclass

import torch

from ...config import SAVING_DIR, set_seed
from ...data.images import build_loader, make_iterable
from ...models import build_model
from ...utils.cli import make_cli
from ...utils.tree import get_numpy, get_valid_tensor, json_serializable, update_dict
from .utils import resolve_device

logger = logging.getLogger("vitef")

SAVE_DIR = SAVING_DIR / "analysis"


def distance(x, y, reduction: str = "none") -> torch.Tensor:
    """Per-sample Frobenius distance between token clouds x, y (N, n, d) (a
    missing batch dimension is added), in float32: (N,) for
    ``reduction="none"``, a scalar for ``"mean"`` or ``"sum"``."""
    x, y = get_valid_tensor(x), get_valid_tensor(y)
    d2 = (x.float() - y.float()).square()
    dist = d2.reshape(d2.shape[0], -1).sum(dim=-1).sqrt()
    match reduction.lower():
        case "none":
            return dist
        case "mean":
            return dist.mean()
        case "sum":
            return dist.sum()
        case _:
            raise ValueError(f"Unknown reduction'{reduction}'. Choose between 'none', "
                             "'mean' or 'sum'.")


def make_decomposition_distance_fn(model):
    """``(x1, x2) -> {key: (N,) per-sample Frobenius distances}`` between the
    decompositions (``model.get_decomposition``) of two batches."""

    def decomp_dist(x1: torch.Tensor, x2: torch.Tensor) -> dict:
        outputs1 = model.get_decomposition(x1)
        outputs2 = model.get_decomposition(x2)
        with torch.inference_mode():
            return {k: distance(outputs1[k], outputs2[k], "none") for k in outputs1}

    return decomp_dist


@dataclass
class AnalysisConfig:
    """The JAX package's AnalysisConfig, field for field, and ``device``."""

    # Model
    model_name: str = "base"
    pretrained: bool = True
    patch_size: int = 16
    image_dim: tuple = (3, 224, 224)

    # Data
    dataset_name: str = "cifar10"
    batch_size: int = 128
    n_steps: int = 100
    data_dir: str | None = None
    imagenet_dir: str | None = None

    # Randomness
    seed: int = 42

    compute_dtype: str = "float32"
    num_workers: int = 8

    device: str = "cuda"

    def __post_init__(self):
        if self.n_steps is None:
            self.n_steps = 1
        if self.seed is None:
            self.seed = 42
        if isinstance(self.image_dim, list):
            self.image_dim = tuple(self.image_dim)


def analysis(config: AnalysisConfig) -> dict:
    """The distances of ``n_steps`` (ImageNet val, downstream test) batch pairs."""
    device = resolve_device(config.device)
    set_seed(config.seed)

    logger.info("Building model.")
    model = build_model(
        {"implementation": "vit", "model_name": config.model_name,
         "pretrained": config.pretrained, "in21k": True, "patch_size": config.patch_size,
         "image_dim": config.image_dim, "compute_dtype": config.compute_dtype},
        device=device, generator=torch.Generator().manual_seed(config.seed))
    logger.info("Done building model.")

    logger.info("Building dataloaders.")
    common = {"batch_size": config.batch_size, "size": config.image_dim[-1],
              "num_workers": config.num_workers, "compute_dtype": config.compute_dtype}
    loader1_config = {"dataset_name": "imagenet", "mode": "val", **common}
    if config.imagenet_dir:
        loader1_config["save_dir"] = config.imagenet_dir
    loader1 = build_loader(loader1_config, device=device)
    loader2_config = {"dataset_name": config.dataset_name, "mode": "test", **common}
    if config.data_dir:
        loader2_config["save_dir"] = config.data_dir
    loader2 = build_loader(loader2_config, device=device)
    logger.info("Done building dataloaders.")

    config_name = f"analysis_{model.name}_pretrained_{config.pretrained}"
    config_name += f"_{config.dataset_name}"
    save_dir = SAVE_DIR / config_name
    save_dir.mkdir(exist_ok=True, parents=True)
    with open(save_dir / "config.json", "w") as f:
        json.dump(json_serializable(asdict(config)), f, indent=4)

    decomp_dist = make_decomposition_distance_fn(model)
    distances: dict = {}
    iterator1 = iter(make_iterable(loader1))
    iterator2 = iter(make_iterable(loader2))
    for step in range(config.n_steps):
        x_batch1, _ = next(iterator1)
        x_batch2, _ = next(iterator2)
        for key, value in decomp_dist(x_batch1, x_batch2).items():
            update_dict(distances, {key: get_numpy(value)})
        if step % 10 == 0:
            print(f"Iteration {step}")

    logger.info(f"Saving results in {save_dir}.")
    with open(save_dir / "distances.pkl", "wb") as f:
        pickle.dump(distances, f)
    return distances


def run_analysis(model_name: str = "base", pretrained: bool = True, patch_size: int = 16,
                 image_dim: tuple = (3, 224, 224), dataset_name: str = "cifar10",
                 batch_size: int = 128, n_steps: int = 100, **kwargs) -> None:
    config = AnalysisConfig(model_name=model_name, pretrained=pretrained,
                            patch_size=patch_size, image_dim=image_dim,
                            dataset_name=dataset_name, batch_size=batch_size,
                            n_steps=n_steps, **kwargs)
    logger.info(f"Running experiments with {config=}.")
    analysis(config=config)


def main(argv: list[str] | None = None) -> None:
    """``python -m vitef_tpu_torch.apps.vit.analysis run --dataset_name cifar10``
    (fire-style flags)."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(levelname)s] %(filename)s:%(lineno)d - %(message)s",
        handlers=[logging.StreamHandler()])
    make_cli({"run": run_analysis}, argv)


if __name__ == "__main__":
    main()
