"""Loss and eval step. Counterpart of ``vitef_tpu/parallel/train_step.py``
(``cross_entropy_loss`` :39-43, ``make_eval_step`` :261-275).

The train step comes with the training port.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels, in float32."""
    return F.cross_entropy(logits.float(), labels.long())


def make_eval_step(apply_fn: Callable, loss_fn: Callable = cross_entropy_loss):
    """Eval step ``(x, y) -> (batch_acc, batch_loss)``: batch-mean accuracy and
    loss as 0-d tensors on the batch's device, under ``torch.inference_mode``.
    The caller averages over batches (mean of batch means)."""

    def eval_step(batch):
        x, y = batch
        with torch.inference_mode():
            logits = apply_fn(x)
            acc = (logits.argmax(dim=-1) == y).float().mean()
            return acc, loss_fn(logits, y)

    return eval_step
