"""Linear probing of hidden representations after every ViT sub-component.

Counterpart of ``apps/vit/linear_probing.py`` (``make_probe_embed_fn``
:43-55, ``get_embeddings`` :58-73, ``run_linear_probing`` :76-115,
``LinearProbingConfig`` :118-144, ``linear_probing`` :147-232, ``main``
:235-242).

    python -m vitef_tpu_torch.apps.vit.linear_probing config=apps/vit/configs/linear_probing.yaml \
        log_dir=vit_cifar10 finetuned=true

It probes a run's checkpoint (``finetuned``) or the pretrained in21k
backbone, and writes ``config.json`` and ``linear_probing.json`` (a test
accuracy per probe key: 8 stages x n_layers) under
``<SAVING_DIR>/probes/<name>``, named as the JAX package names it.
``get_probes``, the pooling and the float32 cast run on the model's device,
so only the pooled (N, E) embeddings cross to the host, where they are
L2-normalised. The probe is sklearn's ``StandardScaler`` +
``LogisticRegression(max_iter=5000)`` (``probe_impl="sklearn"``, the
default), or the same objective by L-BFGS on the model's device
(``probe_impl="torch"``, or the JAX app's name ``"jax"``;
:mod:`vitef_tpu_torch.probe`). On the card unless ``device=cpu``; without
one it raises.
"""

from __future__ import annotations

import json
import logging
from contextlib import ExitStack
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ...config import SAVING_DIR
from ...data.images import build_loader, build_train_val_loader
from ...models import build_model
from ...monitor import Utility, build_eval_orchestrator, load_checkpoint_params
from ...utils.cli import load_config_from_cli
from ...utils.tree import get_numpy, json_serializable
from .utils import resolve_device

logger = logging.getLogger("vitef")

PROBE_DIR = SAVING_DIR / "probes"


def make_probe_embed_fn(model, cls_pooling: bool):
    """``x -> {key: pooled float32 (N, E) embedding}`` of every probe key:
    the CLS token, or the mean over tokens."""

    def probe_embed(x: torch.Tensor) -> dict:
        probes = model.get_probes(x)
        with torch.inference_mode():
            return {key: (val[:, 0, :] if cls_pooling else val.mean(dim=1)).float()
                    for key, val in probes.items()}

    return probe_embed


def get_embeddings(model, loader, cls_pooling: bool) -> tuple[dict, np.ndarray]:
    """L2-normalised pooled embeddings per probe key over ``loader``'s
    ``(x, y)`` batches, and the labels, as host numpy arrays."""
    probe_embed = make_probe_embed_fn(model, cls_pooling)
    embeddings: dict[str, list] = {}
    labels = []
    for x_batch, y_batch in loader:
        for key, emb in probe_embed(x_batch).items():
            embeddings.setdefault(key, []).append(get_numpy(emb))
        labels.append(get_numpy(y_batch))
    out = {}
    for key, value in embeddings.items():
        value = np.concatenate(value)
        out[key] = value / np.linalg.norm(value, axis=-1, keepdims=True)
    return out, np.concatenate(labels)


def run_linear_probing(model, train_loader, test_loader, cls_pooling: bool, seed: int,
                       probe_impl: str = "sklearn") -> dict[str, Any]:
    """Test accuracy of a linear probe fitted on each key's train embeddings.

    ``probe_impl="sklearn"`` is the reference's host probe; a missing sklearn
    raises ``ImportError``. ``"torch"`` (or ``"jax"``) fits the same
    objective on the model's device."""
    # "jax", the JAX app's name for its on-device probe, so that one config
    # drives both packages
    impl = "torch" if probe_impl == "jax" else probe_impl
    if impl not in ("sklearn", "torch"):
        raise ValueError(f"unknown probe_impl {probe_impl!r}; choose sklearn/torch/jax")
    train_embeddings, train_labels = get_embeddings(model, train_loader, cls_pooling)
    test_embeddings, test_labels = get_embeddings(model, test_loader, cls_pooling)
    train_labels, test_labels = train_labels.ravel(), test_labels.ravel()

    metrics = {}
    if impl == "torch":
        from ...probe import probe_accuracy_torch

        device = next(model.module.parameters()).device
        for key in train_embeddings:
            metrics[key] = probe_accuracy_torch(train_embeddings[key], train_labels,
                                                test_embeddings[key], test_labels,
                                                device=device)
        return metrics

    from sklearn.linear_model import LogisticRegression
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler

    clf = make_pipeline(StandardScaler(), LogisticRegression(max_iter=5000, random_state=seed))
    for key in train_embeddings:
        clf.fit(train_embeddings[key], train_labels)
        metrics[key] = clf.score(test_embeddings[key], test_labels)
    return metrics


@dataclass
class LinearProbingConfig:
    """The JAX package's LinearProbingConfig, field for field, and ``device``."""

    log_dir: str = ""
    checkpoint_step: str | None = None
    finetuned: bool = True
    cls_pooling: bool = False

    dataset_name: str = "cifar10"
    train_size: float = 0.8
    batch_size: int = 512
    val_batch_size: int = 512
    test_batch_size: int = 512
    data_dir: str | None = None

    seed: int = 42
    logging_level: str = "INFO"

    compute_dtype: str = "float32"
    num_workers: int = 8
    probe_impl: str = "sklearn"  # sklearn | torch (or jax): the on-device L-BFGS

    device: str = "cuda"

    def __post_init__(self):
        if self.seed is None:
            self.seed = 42


def probe_save_dir(config: LinearProbingConfig, exp_seed) -> Path:
    """``<PROBE_DIR>/<log_dir>[_cls_pooling]`` for a finetuned run, else
    ``<PROBE_DIR>/vit_<dataset>_seed_<run seed>_pretrained[_cls_pooling]``."""
    name = (config.log_dir if config.finetuned
            else f"vit_{config.dataset_name}_seed_{exp_seed}_pretrained")
    return PROBE_DIR / (f"{name}_cls_pooling" if config.cls_pooling else name)


def linear_probing(config: LinearProbingConfig) -> dict[str, Any]:
    """Probe every key of a run's model on ``dataset_name``'s embeddings and
    write the accuracies."""
    device = resolve_device(config.device)
    with ExitStack() as context_stack:
        orchestrator = build_eval_orchestrator({
            "log_dir": config.log_dir,
            "checkpoint_step": config.checkpoint_step,
            "logging_level": config.logging_level,
            "seed": config.seed,
        })
        context_stack.enter_context(Utility(config=orchestrator["utility"]))

        exp_config = orchestrator["exp_config"]
        checkpoint_dir = Path(orchestrator["checkpoint_dir"])
        with open(checkpoint_dir / "params.json") as f:
            model_config = json.load(f)

        # the backbone pretrained on ImageNet-21k alone
        if not config.finetuned:
            model_config["pretrained"] = True
            model_config["in21k"] = True

        logger.info("Building model.")
        model = build_model(model_config, device=device,
                            generator=torch.Generator().manual_seed(config.seed))
        if config.finetuned:
            load_checkpoint_params(checkpoint_dir, model.module)
        logger.info("Done building model.")

        logger.info("Building dataloaders.")
        loader_config = {
            "dataset_name": config.dataset_name,
            "batch_size": config.batch_size,
            "val_batch_size": config.val_batch_size,
            "size": exp_config["image_dim"][-1],
            "num_workers": config.num_workers,
            "compute_dtype": config.compute_dtype,
        }
        if config.data_dir:
            loader_config["save_dir"] = config.data_dir
        train_loader, _ = build_train_val_loader(loader_config, device=device,
                                                 train_size=config.train_size)
        test_config = {key: value for key, value in loader_config.items()
                       if key != "val_batch_size"}
        test_loader = build_loader({**test_config, "batch_size": config.test_batch_size,
                                    "mode": "test"}, device=device, drop_last=False)
        logger.info("Done building dataloaders.")

        save_dir = probe_save_dir(config, exp_config["seed"])
        save_dir.mkdir(exist_ok=True, parents=True)
        with open(save_dir / "config.json", "w") as f:
            json.dump(json_serializable(asdict(config)), f, indent=4)

        metrics = run_linear_probing(model, train_loader, test_loader,
                                     cls_pooling=config.cls_pooling, seed=config.seed,
                                     probe_impl=config.probe_impl)
        with open(save_dir / "linear_probing.json", "w") as f:
            json.dump(metrics, f, indent=4)

    logger.info("Linear probing done.")
    return metrics


def main(argv: list[str] | None = None) -> None:
    """``python -m vitef_tpu_torch.apps.vit.linear_probing config=<yaml> [k=v ...]``."""
    linear_probing(load_config_from_cli(LinearProbingConfig, argv))


if __name__ == "__main__":
    main()
