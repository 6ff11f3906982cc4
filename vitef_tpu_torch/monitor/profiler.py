"""Profiling helpers. Counterpart of ``vitef_tpu/monitor/profiler.py``
(:1-83): :func:`trace` captures a ``torch.profiler`` trace of the enclosed
region (CPU, and CUDA when there is a card) and writes it as a Chrome trace
(``<log_dir>/trace.json``, readable in Perfetto); :class:`StepTimer` turns
per-step host times into step-time statistics and image rates.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("vitef")


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the enclosed region and yield the profiler (None when not
    ``enabled``). Synchronise the card inside the region so that its work
    falls in the trace."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / "trace.json"))
    logger.info("Profiler trace written to %s", path / "trace.json")


@dataclass
class StepTimer:
    """Steady-state step timing with the first ``warmup`` steps left out.

    Call :meth:`tick` once a step; host times between ticks measure the
    device only where the loop synchronises with it. ``images_per_step``
    scales the rates; ``_per_chip`` divides by the process's visible cards.
    """

    warmup: int = 3
    images_per_step: int = 0
    _times: list = field(default_factory=list)
    _last: float | None = None
    _count: int = 0

    def tick(self) -> None:
        now = time.perf_counter()
        self._count += 1
        if self._last is not None and self._count > self.warmup:
            self._times.append(now - self._last)
        self._last = now

    def summary(self) -> dict:
        if not self._times:
            return {}
        times = np.asarray(self._times)
        out = {
            "step_time_mean_s": float(times.mean()),
            "step_time_p50_s": float(np.percentile(times, 50)),
            "step_time_p95_s": float(np.percentile(times, 95)),
            "steps_per_sec": float(1.0 / times.mean()),
        }
        if self.images_per_step:
            out["images_per_sec"] = self.images_per_step / times.mean()
            out["images_per_sec_per_chip"] = (out["images_per_sec"]
                                              / max(torch.cuda.device_count(), 1))
        return out
