"""Cooperative preemption handling for long training runs. Counterpart of
``vitef_tpu/monitor/preemption.py`` (:1-64), copied: plain Python.

A signal handler only sets a flag (async-signal-safe, no device work in the
handler); the train loop polls :attr:`PreemptionGuard.requested` once a
step, saves one last checkpoint at the current step and exits cleanly, and
the next launch resumes from it (the Checkpointer's ``__enter__``).
``request()`` takes the same path in software, for tests and for
notifications that arrive out of band.
"""

from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger(__name__)


class PreemptionGuard:
    """Context manager installing flag-setting handlers for ``signals``.

    Default is SIGTERM only: SIGINT keeps raising KeyboardInterrupt so
    interactive runs still stop immediately. Previous handlers are restored
    on exit; entering from a non-main thread is a no-op (signal handlers can
    only be installed from the main thread — ``request()`` still works).
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._previous: dict[int, object] = {}
        self._requested = threading.Event()

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    def request(self) -> None:
        """Software preemption trigger (tests, out-of-band notifications)."""
        self._requested.set()

    def _handler(self, signum, frame) -> None:
        logger.warning(
            "Received signal %s: requesting a preemption checkpoint.",
            signal.Signals(signum).name,
        )
        self._requested.set()

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for s in self._signals:
                self._previous[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, exc, value, tb) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
