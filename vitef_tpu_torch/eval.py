"""Evaluation loop. Counterpart of ``run_evaluation`` in ``apps/vit/eval.py`` (:36-66).

The checkpoint-backed ``eval`` command line comes with the monitor and
checkpointer port.
"""

from __future__ import annotations

from typing import Any


def run_evaluation(model, loader) -> dict[str, Any]:
    """Mean-of-batch-means accuracy and loss of ``model`` over ``loader``.

    Reads each batch's accuracy and loss back to the host, as the JAX
    package does (one host sync per batch).
    """
    acc_sum = loss_sum = 0.0
    steps = 0
    for x, y in loader:
        acc, loss = model.eval_step((x, y))
        acc_sum += float(acc)
        loss_sum += float(loss)
        steps += 1
    return {"eval_acc": acc_sum / max(steps, 1), "eval_loss": loss_sum / max(steps, 1)}
