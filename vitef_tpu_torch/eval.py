"""Evaluation loop. Counterpart of ``run_evaluation`` in ``apps/vit/eval.py``
(:36-66); the ``eval`` command line that reads a run's checkpoint is
:mod:`vitef_tpu_torch.apps.vit.eval`.
"""

from __future__ import annotations

from typing import Any


def run_evaluation(model, loader) -> dict[str, Any]:
    """Mean-of-batch-means accuracy and loss of ``model`` over ``loader``.

    Reads each batch's accuracy and loss back to the host, as the JAX
    package does (one host sync per batch). Under a mesh every rank passes
    the whole, unsharded validation loader (:42-47), so that their
    best-checkpoint decisions agree: a tensor-parallel model's blocks run
    their collectives on every batch, and an FSDP-sharded model's forward
    gathers its shards unit by unit (``parallel.fsdp``).
    """
    acc_sum = loss_sum = 0.0
    steps = 0
    for x, y in loader:
        acc, loss = model.eval_step((x, y))
        acc_sum += float(acc)
        loss_sum += float(loss)
        steps += 1
    return {"eval_acc": acc_sum / max(steps, 1), "eval_loss": loss_sum / max(steps, 1)}
