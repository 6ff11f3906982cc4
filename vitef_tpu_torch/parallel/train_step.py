"""Train step, loss and eval step. Counterpart of ``vitef_tpu/parallel/train_step.py``
(``TrainState`` :27-36, ``cross_entropy_loss`` :39-43, ``init_train_state``
:46-52, ``make_train_step`` :55-205, ``make_eval_step`` :261-275) and of
``_auto_grad_acc`` in ``apps/vit/train.py`` (:129-141).

The JAX step is one jitted function that scans over microbatches. Here the
step is eager: each microbatch's forward and backward run in turn (the
backward of attention is the K2 kernel on CUDA, or K3 when causal), and
autograd accumulates their gradients into the float32 ``.grad`` of the
trainable parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..optim import clip_by_global_norm_, global_grad_norm


@dataclass
class TrainState:
    """The model, its optimizer and LR scheduler, and the step counters of
    the JAX TrainState. ``acc_step`` is 0 at step boundaries (accumulation
    happens inside the step); it is kept for checkpoint-layout parity."""

    model: Any
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None
    step: int = 0
    acc_step: int = 0


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels, in float32."""
    return F.cross_entropy(logits.float(), labels.long())


def init_train_state(model, optimizer, scheduler=None) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler)


def auto_grad_acc(per_dev: int, cap: int) -> int:
    """Smallest microbatch split (1..8) bringing the per-device rows under
    ``cap``; 1 if already under, not evenly splittable, or cap <= 0. Exact:
    equal microbatches make the mean of mean-gradients the full-batch one."""
    if cap <= 0 or per_dev <= cap:
        return 1
    for acc in range(2, 9):
        if per_dev % acc == 0 and per_dev // acc <= cap:
            return acc
    return 1


def make_train_step(
    *,
    grad_acc_steps: int = 1,
    loss_fn: Callable = cross_entropy_loss,
    schedule: Callable[[int], float] | None = None,
    base_lr: float = 0.0,
    grad_clip: float | None = None,
    block_grad_norms: bool = False,
    update_stats: bool = False,
    mesh: Any = None,
    moe_aux_coefs: tuple | None = None,
    hidden_loss: Callable | None = None,
):
    """Build the train step ``(state, (x, y)) -> metrics``.

    The batch's leading axis splits into ``grad_acc_steps`` equal
    microbatches; their float32 gradients are summed and then scaled by
    ``1 / grad_acc_steps``, as the JAX step's scan does. Then: ``grad_norm``
    over the trainable gradients, the global-norm clip at ``grad_clip``
    (optax's rule), the optimizer step, the scheduler step. Metrics are 0-d
    tensors on the batch's device (no host synchronisation): ``loss`` (mean
    of the microbatch losses), ``grad_norm`` (before the clip), ``lr``
    (``base_lr * schedule(step)`` of the step just taken, a float) when
    ``schedule`` is given, and ``grad_norm_block_{i}`` when
    ``block_grad_norms`` is set: the norm of block i's whole gradient, frozen
    parameters included, as the JAX step takes it (:188-193). For those norms
    the step has autograd compute the frozen block parameters' gradients too,
    and drops them after; ``grad_norm``, the clip and the optimizer see only
    the trainable ones. The module is put in train mode.

    ``hidden_loss`` (``ops.losses.make_fused_head_loss``, seq2seq models):
    the forward stops at the post-norm hidden (``module(x,
    return_hidden=True)``) and the loss is ``hidden_loss(module, hidden, y)``,
    which fuses the vocabulary head into the cross entropy (:105-133).

    ``moe_aux_coefs=(lb_coef, z_coef)`` (MoE families): the forward also
    returns the router's aux losses (``module(x, return_moe_aux=True)``),
    ``lb_coef · lb + z_coef · z`` joins each microbatch's loss (so ``loss``
    includes them, as in the JAX step, :119-127), and their raw values are
    reported as ``moe_lb`` and ``moe_z``, averaged over the microbatches.
    """
    unported = {"update_stats": update_stats, "mesh": mesh is not None}
    missing = [name for name, hit in unported.items() if hit]
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))
    if grad_acc_steps < 1:
        raise ValueError(f"grad_acc_steps must be >= 1, got {grad_acc_steps}")

    def train_step(state: TrainState, batch) -> dict[str, Any]:
        x, y = batch
        if x.shape[0] % grad_acc_steps:
            raise ValueError(f"batch of {x.shape[0]} does not split into "
                             f"{grad_acc_steps} equal microbatches")
        module = state.model.module
        module.train()
        params = [p for p in module.parameters() if p.requires_grad]
        frozen = ([p for p in module.blocks.parameters() if not p.requires_grad]
                  if block_grad_norms else [])
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=x.device)
        aux_sum = ({"moe_lb": torch.zeros((), device=x.device),
                    "moe_z": torch.zeros((), device=x.device)}
                   if moe_aux_coefs is not None else {})
        fwd_kw = {"return_hidden": True} if hidden_loss is not None else {}
        try:
            for p in frozen:
                p.requires_grad_(True)
            for xi, yi in zip(x.chunk(grad_acc_steps), y.chunk(grad_acc_steps)):
                if moe_aux_coefs is not None:
                    out, aux = module(xi, return_moe_aux=True, **fwd_kw)
                else:
                    out = module(xi, **fwd_kw)
                loss = hidden_loss(module, out, yi) if hidden_loss is not None \
                    else loss_fn(out, yi)
                if moe_aux_coefs is not None:
                    loss = loss + moe_aux_coefs[0] * aux["lb"] + moe_aux_coefs[1] * aux["z"]
                    aux_sum["moe_lb"] += aux["lb"].detach()
                    aux_sum["moe_z"] += aux["z"].detach()
                loss.backward()
                loss_sum += loss.detach()
        finally:
            for p in frozen:
                p.requires_grad_(False)
        grads = [p.grad for p in params if p.grad is not None]
        if grad_acc_steps > 1:
            torch._foreach_mul_(grads + [p.grad for p in frozen if p.grad is not None],
                                1.0 / grad_acc_steps)

        metrics = {"loss": loss_sum / grad_acc_steps, "grad_norm": global_grad_norm(grads)}
        metrics.update({key: value / grad_acc_steps for key, value in aux_sum.items()})
        if block_grad_norms:
            for i, block in enumerate(module.blocks):
                metrics[f"grad_norm_block_{i}"] = global_grad_norm(
                    p.grad for p in block.parameters())
        for p in frozen:
            p.grad = None
        if grad_clip:
            clip_by_global_norm_(grads, grad_clip, metrics["grad_norm"])
        state.optimizer.step()
        if schedule is not None:
            metrics["lr"] = base_lr * schedule(state.step)
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        state.acc_step = 0
        return metrics

    return train_step


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
