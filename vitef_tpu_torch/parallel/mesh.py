"""Rank and host helpers. Counterpart of the rank helpers of
``vitef_tpu/parallel/mesh.py`` (``get_rank``, ``is_master_process``,
``get_hostname``, :52-75).

The rank is the ``torch.distributed`` rank once a process group is set up,
else 0: one process on one card is rank 0 and the master. The device mesh
(data, tensor and fully sharded parallelism) is not ported.
"""

from __future__ import annotations

import functools
import socket

import torch.distributed as dist


def get_rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_master_process() -> bool:
    return get_rank() == 0


@functools.cache
def get_hostname() -> str:
    return socket.gethostname()
