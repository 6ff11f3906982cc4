"""The port never imports JAX: importing every ``vitef_tpu_torch`` module (and
``chip_smoke.py``, which drives the port on the card) in a fresh interpreter
leaves ``jax`` out of ``sys.modules``."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_CHILD = """
import importlib, pkgutil, sys
import vitef_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vitef_tpu_torch.__path__, "vitef_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print(len(names), "modules;", "leaked:", leaked)
sys.exit(1 if leaked or len(names) < 15 else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "VITEF_PLATFORM"}
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
