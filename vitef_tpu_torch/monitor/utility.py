"""Utility manager: seeding and garbage-collection control around the train
loop. Counterpart of ``vitef_tpu/monitor/utility.py`` (:1-51).

Entering seeds python's, numpy's and torch's global RNGs (numpy's draws the
train/val split, as in the JAX package) and turns the collector off; a
collection runs every ``period`` steps, and leaving turns it on again. A
collector pause on the host stalls the launches that keep the card busy.
"""

from __future__ import annotations

import gc
import logging
from dataclasses import dataclass

from ..config import set_seed

logger = logging.getLogger("vitef")


@dataclass
class UtilityConfig:
    seed: int = 42
    period: int = 1000


class Utility:
    def __init__(self, config: UtilityConfig):
        self.seed = config.seed
        self.period = config.period
        self.step = 0

    def __enter__(self) -> "Utility":
        set_seed(self.seed)
        gc.disable()
        gc.collect()
        return self

    def __call__(self) -> None:
        self.step += 1
        if self.period <= 0:
            return
        if self.step % self.period == 0:
            logger.info("garbage collection")
            gc.collect()

    def __exit__(self, exc, value, tb) -> None:
        gc.enable()
