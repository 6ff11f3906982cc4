"""Orchestrator: the run directory and the monitor configs fanned out from
one flat dict. Counterpart of ``vitef_tpu/monitor/orchestrator.py``
(``OrchestratorConfig`` :37-68, ``build_orchestrator`` :71-103,
``EvalOrchestratorConfig`` :106-123, ``build_eval_orchestrator`` :126-160).

The run layout is a public contract, the JAX package's:
``<SAVING_DIR>/runs/<log_dir>/{config.json, checkpoints/, logs/, metrics/}``.
On ``overwrite`` an existing run dir is deleted, after a confirmation only
when stdin is a terminal. In a run of several processes the master alone
deletes the dir and writes ``config.json``; the others wait for it.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import torch.distributed as dist

from ..config import SAVING_DIR
from ..parallel.mesh import get_world_size, is_master_process
from ..utils.tree import json_serializable
from ..utils.typed import build_with_type_check
from .checkpoint import Checkpointer, CheckpointerConfig
from .logger import LoggerConfig
from .utility import UtilityConfig

logger = logging.getLogger("vitef")

RUN_DIR = SAVING_DIR / "runs"


@dataclass
class OrchestratorConfig:
    log_dir: str = ""
    overwrite: bool = False
    config_file: dict[str, Any] | None = None

    checkpoint_period: int = 0
    checkpoint_n_kept: int = 0

    logging_period: int = 0
    logging_level: str = "INFO"

    seed: int = 42
    utility_period: int = 1000

    def __post_init__(self) -> None:
        if not self.log_dir:
            raise ValueError("log_dir should be specified.")
        self.log_dir = Path(os.path.expandvars(str(RUN_DIR / self.log_dir)))
        if self.log_dir.exists() and self.overwrite and is_master_process():
            if sys.stdin.isatty():
                confirm = input(f"Do you want to permanently delete the directory "
                                f"'{self.log_dir}' (Yes/No)? ")
                if not confirm.upper().startswith("Y"):
                    logger.info("Operation cancelled.")
                    sys.exit(0)
            shutil.rmtree(self.log_dir)
            logger.info(f"Directory '{self.log_dir}' has been deleted.")
        self.log_dir.mkdir(parents=True, exist_ok=True)


def build_orchestrator(config: dict[str, Any]) -> dict[str, Any]:
    """Create the run dir, write ``config.json`` and return the checkpointer,
    logger and utility configs."""
    config_obj = build_with_type_check(OrchestratorConfig, config)

    if is_master_process():
        with open(config_obj.log_dir / "config.json", "w") as f:
            json.dump(json_serializable(config_obj.config_file or {}), f, indent=4)
    if get_world_size() > 1:  # the other ranks write into the dir the master made
        dist.barrier()

    checkpointer_config = build_with_type_check(CheckpointerConfig, {
        "period": config_obj.checkpoint_period,
        "n_kept": config_obj.checkpoint_n_kept,
        "path": str(config_obj.log_dir / "checkpoints"),
    })
    logger_config = build_with_type_check(LoggerConfig, {
        "period": config_obj.logging_period,
        "level": config_obj.logging_level,
        "stdout_path": str(config_obj.log_dir / "logs"),
        "metric_path": str(config_obj.log_dir / "metrics"),
    })
    utility_config = build_with_type_check(UtilityConfig, {
        "seed": config_obj.seed,
        "period": config_obj.utility_period,
    })
    return {"checkpointer": checkpointer_config, "logger": logger_config,
            "utility": utility_config}


@dataclass
class EvalOrchestratorConfig:
    log_dir: str = ""
    checkpoint_step: str | None = ""
    logging_level: str = "INFO"
    seed: int = 42

    def __post_init__(self) -> None:
        if not self.log_dir:
            raise ValueError("log_dir should be specified.")
        self.log_dir = Path(os.path.expandvars(str(RUN_DIR / self.log_dir)))
        if not self.log_dir.exists():
            logger.info(f"Directory {self.log_dir} does not exist yet. Creating it from "
                        "scratch.")
        self.log_dir.mkdir(parents=True, exist_ok=True)


def build_eval_orchestrator(config: dict[str, Any]) -> dict[str, Any]:
    """The run's ``config.json`` and checkpoint dir (the newest complete one
    unless ``checkpoint_step`` names one: ``512`` and ``0000000512`` both
    name step 512), and the logger and utility configs."""
    config_obj = build_with_type_check(EvalOrchestratorConfig, config)

    with open(config_obj.log_dir / "config.json") as f:
        exp_config = json.load(f)

    checkpoint_dir = Path(config_obj.log_dir / "checkpoints")
    step = config_obj.checkpoint_step
    if not step:
        last = Checkpointer.get_last_checkpoint_path(checkpoint_dir)
        if not last:
            raise FileNotFoundError(f"no complete checkpoints in {checkpoint_dir}")
        step = Path(last).name
    elif str(step).isdigit():
        step = f"{int(step):010d}"
    checkpoint_dir = checkpoint_dir / step

    logger_config = build_with_type_check(LoggerConfig, {
        "level": config_obj.logging_level,
        "stdout_path": str(config_obj.log_dir / "logs"),
        "metric_path": str(config_obj.log_dir / "metrics"),
    })
    utility_config = build_with_type_check(UtilityConfig, {"seed": config_obj.seed})
    return {"exp_config": exp_config, "checkpoint_dir": checkpoint_dir,
            "logger": logger_config, "utility": utility_config}
