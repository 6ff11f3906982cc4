"""The port stands alone: importing every ``vitef_tpu_torch`` module (and
``chip_smoke.py``, which drives the port on the card) in a fresh interpreter
leaves ``jax``, every ``vitef_tpu`` module, ``yaml`` (the machine with the
card has no PyYAML), ``PIL`` (imported only inside the functions that
decode images; the machine has no Pillow) and the plots' rendering and
frame libraries, ``pandas``, ``matplotlib``, ``seaborn``, ``sklearn`` and
``imageio`` (imported only inside the functions that draw or build frames;
the machine has none of them), out of ``sys.modules``; and the port's own
copy of the native image ops gives the JAX package's bits."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

_CHILD = """
import importlib, pkgutil, sys
import vitef_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vitef_tpu_torch.__path__, "vitef_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
absent = ("jax", "vitef_tpu", "yaml", "PIL", "pandas", "matplotlib", "seaborn", "sklearn",
          "imageio")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in absent)
print(len(names), "modules;", "leaked:", leaked)
sys.exit(1 if leaked or len(names) < 67 else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "VITEF_PLATFORM"}
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("shape", [(5, 32, 32, 3), (3, 40, 24, 3), (2, 17, 29, 1)],
                         ids=["square", "tall", "odd_gray"])
def test_native_imageops_match_jax_package(shape):
    from vitef_tpu import native as jax_native
    from vitef_tpu_torch import native

    batch = np.random.default_rng(sum(shape)).integers(0, 256, size=shape, dtype=np.uint8)
    np.testing.assert_array_equal(native.eval_transform_batch(batch, 48),
                                  jax_native.eval_transform_batch(batch, 48))
    np.testing.assert_array_equal(native.eval_transform_batch(batch, 16),
                                  jax_native.eval_transform_batch(batch, 16))
    np.testing.assert_array_equal(native.resize_bilinear_batch(batch, 21, 37),
                                  jax_native.resize_bilinear_batch(batch, 21, 37))
