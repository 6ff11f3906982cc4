"""Logging manager: per-rank jsonl metric streams and stdout logs.
Counterpart of ``vitef_tpu/monitor/logger.py`` (``LoggerConfig`` :25-38,
``Logger`` :41-112).

The file names and record fields are a public contract that ``apps/plots``
reads: ``metrics/raw_<rank>.jsonl`` (train), ``metrics/eval.jsonl``
(emptied when an eval logger starts), ``logs/device_<rank>.log``,
``metrics/info_model.jsonl``, and the wall-clock ``ts`` added to every
record.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from pathlib import Path
from traceback import format_exception
from typing import Any, Literal

from torch import nn

from ..parallel.mesh import get_hostname, get_rank, is_master_process

logger = logging.getLogger("vitef")


@dataclass
class LoggerConfig:
    period: int = 0
    level: Literal["DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"] = "INFO"
    stdout_path: str = ""
    metric_path: str = ""

    def __post_init__(self):
        if self.period > 0:
            if not self.stdout_path:
                raise ValueError("stdout_path was not set.")
            if not self.metric_path:
                raise ValueError("metric_path was not set.")
            self.level = self.level.upper()


class Logger:
    """Writes metric records to the run's jsonl file and log lines to
    ``logs/device_<rank>.log`` (and, on the master, to stderr)."""

    def __init__(self, config: LoggerConfig, eval: bool = False) -> None:
        rank = get_rank()
        self.path = Path(config.metric_path)
        self.path.mkdir(parents=True, exist_ok=True)
        if not is_master_process():  # the master alone records: every rank's values agree
            self.metric = os.devnull
        elif eval:
            self.metric = str(self.path / "eval.jsonl")
            with open(self.metric, "w"):
                pass
        else:
            self.metric = str(self.path / f"raw_{rank}.jsonl")

        stdout_dir = Path(config.stdout_path)
        stdout_dir.mkdir(parents=True, exist_ok=True)
        stdout_file = stdout_dir / f"device_{rank}.log"

        logger.handlers.clear()
        log_format = logging.Formatter(
            "%(asctime)s [%(levelname)s] %(filename)s:%(lineno)d - %(message)s")
        logger.setLevel(getattr(logging, (config.level or "INFO").upper()))
        handler = logging.FileHandler(stdout_file, "a")
        handler.setFormatter(log_format)
        logger.addHandler(handler)

        if is_master_process():
            handler = logging.StreamHandler()
            handler.setFormatter(log_format)
            logger.addHandler(handler)
            logger.info(f"Logging to {stdout_dir}")

        logger.info(f"Running on machine {get_hostname()}")
        self.start_time = time.time()

    def __enter__(self) -> "Logger":
        self.metric = open(self.metric, "a")
        return self

    def __call__(self, metrics: dict[str, Any]) -> None:
        """Append ``metrics`` with the seconds since the logger started as ``ts``
        (a ``ts`` in ``metrics`` is replaced)."""
        metrics = {**metrics, "ts": time.time() - self.start_time}
        print(json.dumps(metrics), file=self.metric, flush=True)
        logger.info({k: round(v, 5) if isinstance(v, float) else v
                     for k, v in metrics.items()})

    def report_model_size(self, module, trainable: dict[str, bool] | None = None) -> None:
        """The number of trainable parameters to ``info_model.jsonl``:
        ``module`` is an ``nn.Module`` or a dict of named tensors, and
        ``trainable`` (default: all) maps each name to whether it trains."""
        if not is_master_process():
            return
        named = module.named_parameters() if isinstance(module, nn.Module) else module.items()
        n_params = sum(p.numel() for name, p in named
                       if trainable is None or trainable[name])
        with open(self.path / "info_model.jsonl", "a") as f:
            print(json.dumps({"model_params": int(n_params)}), file=f, flush=True)
        logger.info(f"The model has {n_params} trainable parameters.")

    def __exit__(self, exc, value, tb):
        self.metric.close()
        if exc is not None:
            logger.error(f"Exception: {value}")
            logger.info("".join(format_exception(exc, value, tb)))
