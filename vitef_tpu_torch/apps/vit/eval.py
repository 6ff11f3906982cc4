"""Evaluate a finetuned ViT checkpoint: top-1 accuracy on the test split.
Counterpart of ``apps/vit/eval.py`` (``EvaluationConfig`` :69-88, ``eval``
:91-142, ``main`` :145-151).

    python -m vitef_tpu_torch.apps.vit.eval config=apps/vit/configs/eval.yaml log_dir=vit_cifar10

It reads the run's ``config.json`` and a checkpoint (the newest unless
``checkpoint_step`` names one), rebuilds the model from the checkpoint's
``params.json``, loads only its ``model`` entry, runs the whole test split
(the last batch partial) and writes ``test_acc`` (the mean of the batches'
accuracies) to ``metrics/eval.jsonl``. A run dir of either package will do.
On the card unless ``device=cpu``; without one it raises.
"""

from __future__ import annotations

import json
import logging
from contextlib import ExitStack
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import torch

from ...data.images import build_loader
from ...eval import run_evaluation
from ...models import build_model
from ...monitor import Logger, Utility, build_eval_orchestrator, load_checkpoint_params
from ...utils.cli import load_config_from_cli
from .utils import resolve_device

logger = logging.getLogger("vitef")


@dataclass
class EvaluationConfig:
    """The JAX package's EvaluationConfig, field for field, and ``device``."""

    log_dir: str = ""
    checkpoint_step: str | None = None

    dataset_name: str | None = None
    batch_size: int = 512
    data_dir: str | None = None

    seed: int = 42
    logging_level: str = "INFO"

    compute_dtype: str = "float32"
    num_workers: int = 8

    device: str = "cuda"

    def __post_init__(self):
        if self.seed is None:
            self.seed = 42


def eval(config: EvaluationConfig) -> dict[str, Any]:
    device = resolve_device(config.device)
    with ExitStack() as context_stack:
        orchestrator = build_eval_orchestrator({
            "log_dir": config.log_dir,
            "checkpoint_step": config.checkpoint_step,
            "logging_level": config.logging_level,
            "seed": config.seed,
        })
        metric_logger = Logger(config=orchestrator["logger"], eval=True)
        context_stack.enter_context(metric_logger)
        context_stack.enter_context(Utility(config=orchestrator["utility"]))

        exp_config = orchestrator["exp_config"]
        checkpoint_dir = Path(orchestrator["checkpoint_dir"])
        with open(checkpoint_dir / "params.json") as f:
            model_config = json.load(f)

        if config.dataset_name is None:
            config.dataset_name = exp_config["dataset_name"]

        logger.info("Building dataloader.")
        loader_config = {
            "dataset_name": config.dataset_name,
            "batch_size": config.batch_size,
            "mode": "test",
            "size": exp_config["image_dim"][-1],
            "num_workers": config.num_workers,
            "compute_dtype": config.compute_dtype,
        }
        if config.data_dir:
            loader_config["save_dir"] = config.data_dir
        test_loader = build_loader(loader_config, device=device, drop_last=False)
        logger.info(f"Done building dataloader: {len(test_loader.indices)} images in "
                    f"{len(test_loader)} batches of up to {config.batch_size}.")

        logger.info("Building model.")
        model = build_model(model_config, device=device,
                            generator=torch.Generator().manual_seed(config.seed))
        load_checkpoint_params(checkpoint_dir, model.module)
        logger.info("Done building model.")

        metrics = run_evaluation(model, test_loader)
        metric_logger({"test_acc": metrics["eval_acc"]})
        logger.info(f"Test accuracy: {metrics['eval_acc'] * 100:.2f}%")

    logger.info("Evaluation done.")
    return metrics


def main(argv: list[str] | None = None) -> None:
    """``python -m vitef_tpu_torch.apps.vit.eval config=<yaml> [k=v ...]``."""
    eval(load_config_from_cli(EvaluationConfig, argv))


if __name__ == "__main__":
    main()
