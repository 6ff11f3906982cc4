"""Train step, loss and eval step. Counterpart of ``vitef_tpu/parallel/train_step.py``
(``TrainState`` :27-36, ``cross_entropy_loss`` :39-43, ``init_train_state``
:46-52, ``make_train_step`` :55-258, ``make_eval_step`` :261-275) and of
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
import torch.distributed as dist
import torch.nn.functional as F

from ..models.norms import batch_norm_sites, ema_update_stats
from ..ops.common import draw_seed
from ..optim import clip_by_global_norm_, global_grad_norm
from .mesh import MeshLayout


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
    """Mean softmax cross entropy with integer labels over the last axis of
    ``logits`` (classes), in float32: (N, C) with (N,), or (N, L, V) with (N, L)."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


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
    stats_momentum: float = 0.1,
    mesh: Any = None,
    moe_aux_coefs: tuple | None = None,
    hidden_loss: Callable | None = None,
):
    """Build the train step ``(state, (x, y), generator=None) -> metrics``.

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
    the loss is ``hidden_loss(module, hidden, y)`` of the post-norm hidden,
    which fuses the vocabulary head into the cross entropy (:105-133); it
    runs inside the output's forward (``module(x, head_loss=...)``), where
    the head's parameters are in place.

    ``moe_aux_coefs=(lb_coef, z_coef)`` (MoE families): the forward also
    returns the router's aux losses (``module(x, return_moe_aux=True)``),
    ``lb_coef · lb + z_coef · z`` joins each microbatch's loss (so ``loss``
    includes them, as in the JAX step, :119-127), and their raw values are
    reported as ``moe_lb`` and ``moe_z``, averaged over the microbatches.

    ``update_stats`` (batch-norm models: PatchTST) updates the running
    statistics as ``nn.BatchNorm1d`` does (:85-90, :128-183): each
    microbatch's train-mode forward returns its batch statistics
    (``module(x, return_stats=True)``), the EMA at ``stats_momentum`` chains
    over the microbatches in order, in float32, and the result is copied
    into the buffers at the end of the step. The buffers are not
    parameters, so neither autograd nor the optimizer sees them. It excludes
    ``moe_aux_coefs`` and ``hidden_loss`` (``ValueError``, as in JAX).

    ``generator`` (a ``torch.Generator`` on the batch's device) feeds
    dropout; the microbatches draw from it in turn (the JAX step splits its
    ``rng`` per microbatch). A model with a dropout rate > 0 needs one.

    ``mesh`` (a dp-only :class:`~vitef_tpu_torch.parallel.mesh.Mesh`, the
    JAX ``shard_map`` step :207-258): each rank passes its own rows (for
    example ``shard_batch``'s) and runs the microbatch loop on them, so the
    attention kernels run per rank at the local batch; then the float32
    gradients, the loss, the MoE aux metrics and the running statistics are
    averaged over 'dp' in one flat all-reduce, and dropout draws a stream of
    each rank's own (one draw of ``generator`` mixed with the dp rank). A
    mesh with tp > 1 raises AssertionError, as the JAX step asserts.

    A module placed by ``shard_params`` (``module.mesh_layout``) takes the
    same step with ``mesh=None``, as the JAX package's jitted step does on
    sharded parameters: the FSDP shards are gathered over 'dp' unit by unit
    (the embedding, each block, the output) for each unit's forward and
    again for its backward, and each unit's gradients are reduce-scattered
    over 'dp' in float32 as soon as they are complete, each rank adding its
    shard of the mean into the shard's ``.grad`` over the microbatches
    (:mod:`~vitef_tpu_torch.parallel.fsdp`: one unit's whole weights and
    gradients at a time); the other gradients are averaged over 'dp' after
    the last microbatch, the tp collectives run inside the blocks,
    ``grad_norm`` and the clip are taken over the whole gradient (each slice
    once, each replicated tensor once) and the optimizer updates each
    rank's shards and their state.
    """
    if mesh is not None and mesh.shape.get("tp", 1) != 1:
        raise AssertionError("the mesh train step is data-parallel only; shard the model "
                             "with shard_params for tp/fsdp and pass mesh=None")
    if moe_aux_coefs is not None and update_stats:
        raise ValueError("moe_aux_coefs and update_stats are mutually exclusive "
                         "(no batch-norm MoE family)")
    if hidden_loss is not None and update_stats:
        raise ValueError("hidden_loss and update_stats are mutually exclusive "
                         "(no batch-norm causal-LM family)")
    if grad_acc_steps < 1:
        raise ValueError(f"grad_acc_steps must be >= 1, got {grad_acc_steps}")

    def train_step(state: TrainState, batch, generator: torch.Generator | None = None
                   ) -> dict[str, Any]:
        x, y = batch
        if x.shape[0] % grad_acc_steps:
            raise ValueError(f"batch of {x.shape[0]} does not split into "
                             f"{grad_acc_steps} equal microbatches")
        module = state.model.module
        module.train()
        layout = getattr(module, "mesh_layout", None)
        if layout is None and mesh is not None:
            layout = MeshLayout(mesh=mesh)
        named = dict(module.named_parameters())
        names = {p: name for name, p in named.items()}
        params = [p for p in module.parameters() if p.requires_grad]
        frozen = ([p for p in module.blocks.parameters() if not p.requires_grad]
                  if block_grad_norms else [])
        if layout is not None and layout.mesh.dp > 1 and generator is not None:
            generator = torch.Generator(device=generator.device).manual_seed(
                draw_seed(generator, layout.mesh.dp_rank))
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=x.device)
        aux_sum = ({"moe_lb": torch.zeros((), device=x.device),
                    "moe_z": torch.zeros((), device=x.device)}
                   if moe_aux_coefs is not None else {})
        fwd_kw = {"generator": generator}
        sites = batch_norm_sites(module) if update_stats else {}
        running = {path: {"running_mean": norm.running_mean.float(),
                          "running_var": norm.running_var.float()}
                   for path, norm in sites.items()}
        try:
            for p in frozen:
                p.requires_grad_(True)
            for xi, yi in zip(x.chunk(grad_acc_steps), y.chunk(grad_acc_steps)):
                if hidden_loss is not None:
                    fwd_kw["head_loss"] = lambda h, yi=yi: hidden_loss(module, h, yi)
                if moe_aux_coefs is not None:
                    out, aux = module(xi, return_moe_aux=True, **fwd_kw)
                elif update_stats:
                    out, stats = module(xi, return_stats=True, **fwd_kw)
                    running = ema_update_stats(running, stats, stats_momentum)
                else:
                    out = module(xi, **fwd_kw)
                loss = out if hidden_loss is not None else loss_fn(out, yi)
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
        loss = loss_sum / grad_acc_steps
        aux = {key: value / grad_acc_steps for key, value in aux_sum.items()}
        if layout is not None:
            _average_over_dp(
                layout, names, [p for p in params + frozen if p.grad is not None],
                [loss, *aux.values()] + [t for r in running.values() for t in r.values()])

        metrics = {"loss": loss}
        metrics.update(aux)
        block_sets = ([[(names[p], p.grad) for p in block.parameters()]
                       for block in module.blocks] if block_grad_norms else [])
        if layout is not None and any(pl.tp is not None or pl.dp is not None
                                      for pl in layout.placements.values()):
            norms = layout.global_norms([[(names[p], p.grad) for p in params]] + block_sets)
        else:
            norms = [global_grad_norm(grads)] + [global_grad_norm(g for _, g in b)
                                                 for b in block_sets]
        metrics["grad_norm"] = norms[0]
        for i, norm in enumerate(norms[1:]):
            metrics[f"grad_norm_block_{i}"] = norm
        for p in frozen:
            p.grad = None
        with torch.no_grad():
            for path, norm in sites.items():
                norm.running_mean.copy_(running[path]["running_mean"])
                norm.running_var.copy_(running[path]["running_var"])
        return finish_step(state, grads, metrics, grad_clip=grad_clip, schedule=schedule,
                           base_lr=base_lr)

    return train_step


def finish_step(state: TrainState, grads: list, metrics: dict, *, grad_clip: float | None,
                schedule: Callable[[int], float] | None, base_lr: float) -> dict:
    """The end every train step shares: the global-norm clip of ``grads`` at
    ``grad_clip`` on ``metrics["grad_norm"]`` (taken before it), the
    optimizer step, ``metrics["lr"]`` of the step just taken when
    ``schedule`` is given, the scheduler step and the step counters.
    Returns ``metrics``."""
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


def trainable_grads(module) -> list[torch.Tensor]:
    """The trainable parameters of ``module``, each given a zero gradient
    where the backward left none (a frozen path, another stage's work), so
    that a collective over the gradients has the same layout on every
    rank."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return params


def reduce_flat_(tensors: list[torch.Tensor], group, divisor: int = 1) -> None:
    """Sum ``tensors`` over ``group`` in one flat float32 all-reduce (none
    without a group), divide by ``divisor``, and write each result back
    into the tensor's own storage: a view into the flat buffer is not
    16-byte aligned, which changes a later norm's reduction order."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if group is not None:
        dist.all_reduce(flat, group=group)
    if divisor != 1:
        flat /= divisor
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def _average_over_dp(layout, names: dict, params: list, scalars: list) -> None:
    """Average the gradients of ``params`` and the tensors ``scalars`` over
    the mesh's 'dp' axis (the JAX step's ``pmean``s :234-241), in place: the
    scalars and the gradients of the parameters not split over 'dp' in one
    flat float32 all-reduce. A FSDP-sharded parameter's ``grad`` is already
    this rank's shard of the averaged gradient (its unit's reduce-scatter,
    :mod:`~vitef_tpu_torch.parallel.fsdp`)."""
    mesh = layout.mesh
    whole = [p for p in params if layout.placement(names[p]).dp is None]
    reduce_flat_(scalars + [p.grad for p in whole], mesh.dp_group, mesh.dp)


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
