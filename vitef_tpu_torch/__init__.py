"""vitef_tpu_torch — the PyTorch/CUDA port of ``vitef_tpu`` for NVIDIA Hopper.

The JAX package ``vitef_tpu`` stays the reference; this package mirrors its
module names so each counterpart is easy to find. It imports ``torch`` and
never ``jax``. Every Pallas kernel of ``vitef_tpu`` on a ported path becomes a
CUDA kernel written by hand for ``sm_90a`` (``ops/csrc/``), built with ``nvcc``
at first use and bound with ``ctypes`` (``ops/_build.py``).

Ported so far: ViT inference (``models.build_model`` → ``eval.run_evaluation``)
through the packed multi-head attention forward kernel.
"""

__version__ = "0.1.0"
