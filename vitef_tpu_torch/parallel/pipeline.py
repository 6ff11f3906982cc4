"""Pipeline parallelism over a ``('dp', 'pp')`` mesh. Counterpart of
``vitef_tpu/parallel/pipeline.py`` (``build_pipeline_mesh`` :102-112, the
stage-stacked parameters :120-168, ``make_pipeline_train_step`` :176-550).

One process a card. The transformer's blocks are split into ``pp``
contiguous stages: rank d · pp + s (:func:`~.mesh.build_pipeline_mesh`)
holds blocks [s·n/pp, (s+1)·n/pp) of data-parallel row d and their
optimizer state (:func:`place_stages`, the memory contract of the JAX
package's stage-sharded stack); the embedding and the head stay whole on
every rank. Each microbatch's activations go from stage to stage by
point-to-point sends, and its cotangents come back the same way.

The JAX package runs one SPMD scan over ticks and differentiates it (GPipe)
or hand-writes the per-stage VJPs (1F1B). Here each rank runs its stage of
the same tick schedule eagerly, one ``dist.batch_isend_irecv`` of every
send and receive at the end of each tick, so that a forward send to s + 1
and a backward send to s − 1 are posted together and cannot deadlock:

- **GPipe** (:242-309): ``n_micro + pp − 1`` forward ticks, stage s running
  microbatch t − s at tick t, each microbatch's autograd graph kept; then
  the same number of backward ticks in reverse microbatch order. Its memory
  grows with ``n_micro``.
- **1F1B** (:339-471, PipeDream-flush): ``n_micro + 2(pp − 1)`` ticks; at
  tick t stage s runs the forward of microbatch t − s without a graph,
  keeps only its stage *input* in a ring of ``2·pp − 1`` slots, and runs
  the backward of microbatch t − 2(pp − 1) + s, recomputing the stage's
  forward from the saved input. The last stage turns a microbatch around in
  one tick: its forward and backward of a microbatch fall in the same tick,
  so it skips the forward phase's stage pass, whose output the JAX scan
  computes and nobody reads (the port launches each block's attention
  forward once per microbatch there, not twice). Stage 0's backward tick
  recomputes the embedding and pulls the stage input's cotangent through
  it, unless the embedding is frozen.

Only stage 0 embeds, only the last stage runs the head and the loss; the
loss is the mean over microbatches. Block gradients stay on their stage;
the embedding's and the head's are summed over 'pp' (under weight tying
this adds stage 0's embedding gradient to the last stage's head gradient);
every gradient is averaged over 'dp'; frozen parameters
(``requires_grad`` off) take no part; the norm is √(Σ_pp block squares +
the replicated squares) and the clip is applied in the step, so the
optimizer itself must not clip.

Dropout draws from ``torch.Generator`` streams keyed by (microbatch, stage)
on both schedules, so that 1F1B's recompute replays the forward's masks;
the JAX package keys GPipe by (tick, stage) and 1F1B by (microbatch, stage,
layer), so the masks differ from its masks, not their rates.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.common import draw_seed
from ..optim import global_grad_norm
from .mesh import MeshLayout, Placement
from .train_step import cross_entropy_loss, finish_step, reduce_flat_, trainable_grads

SCHEDULES = ("gpipe", "1f1b")


# ---------------------------------------------------------------------------
# Stage-stacked parameters (flat dicts in the JAX layout)
# ---------------------------------------------------------------------------


def _block_key(name: str) -> tuple[int, str] | None:
    parts = name.split(".")
    if len(parts) > 2 and parts[0] == "blocks" and parts[1].isdigit():
        return int(parts[1]), ".".join(parts[2:])
    return None


def stack_block_params(flat: dict) -> dict:
    """The per-block entries ``blocks.<i>.<rest>`` of a flat dict of arrays
    (the JAX layout, as ``model.npz`` or ``to_jax_params`` holds it) stacked
    into ``blocks.<rest>`` of shape (n_layers, ...) (:120-132); every other
    entry is kept as it is."""
    out, per_block = {}, {}
    for name, value in flat.items():
        key = _block_key(name)
        if key is None:
            out[name] = value
        else:
            per_block.setdefault(key[1], {})[key[0]] = np.asarray(value)
    for rest, by_layer in per_block.items():
        out[f"blocks.{rest}"] = np.stack([by_layer[i] for i in range(len(by_layer))])
    return out


def unstack_block_params(stacked: dict) -> dict:
    """The inverse of :func:`stack_block_params` (:135-141): each
    ``blocks.<rest>`` entry split into ``blocks.<i>.<rest>``."""
    out = {}
    for name, value in stacked.items():
        if name.startswith("blocks.") and not _block_key(name):
            rest = name[len("blocks."):]
            for i, layer in enumerate(np.asarray(value)):
                out[f"blocks.{i}.{rest}"] = layer
        else:
            out[name] = value
    return out


# ---------------------------------------------------------------------------
# Stage placement
# ---------------------------------------------------------------------------


class OtherStage(nn.Module):
    """Stands in ``module.blocks`` for a block that another pipeline stage
    holds: no parameters, and a forward that raises."""

    def __init__(self, index: int, stage: int):
        super().__init__()
        self.index, self.stage = index, stage

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"block {self.index} lives on pipeline stage {self.stage}; run a "
                           "stage-placed model through make_pipeline_train_step")


def stage_blocks(module) -> range:
    """The indices of the blocks this rank's stage holds (every block when the
    module is not placed on a pipeline)."""
    return getattr(module, "pipeline_blocks", range(len(module.blocks)))


def place_stages(model, mesh):
    """Place ``model`` (a ``Model`` or its module) on the ``('dp', 'pp')``
    ``mesh`` in place and return it: this rank keeps blocks [s·n/pp,
    (s+1)·n/pp) of its stage s, the others are replaced by
    :class:`OtherStage` (their parameters freed), so that ``state_dict``
    and the optimizer built after hold this stage's blocks under their
    global names; the embedding and the head stay whole.
    ``module.mesh_layout`` records the placement, so that the checkpoint
    (``model_pieces``, ``load_model_state``) writes and reads the whole
    model in the JAX layout, each block by its stage. This is what the JAX
    package's ``pipeline_state_shardings`` (:144-160) places. Raises
    AssertionError unless pp divides n_layers."""
    module = getattr(model, "module", model)
    if getattr(module, "mesh_layout", None) is not None:
        raise ValueError("the module is already sharded")
    n_layers, pp = len(module.blocks), mesh.pp
    if n_layers % pp:
        raise AssertionError(f"n_layers={n_layers} not divisible by pp={pp}")
    per_stage = n_layers // pp
    lo = mesh.pp_rank * per_stage
    for i in range(n_layers):
        if not lo <= i < lo + per_stage:
            module.blocks[i] = OtherStage(i, i // per_stage)
    shapes = {name: tuple(p.shape) for name, p in module.named_parameters()}
    placements = {name: Placement(pp=_block_key(name) is not None) for name in shapes}
    module.pipeline_blocks = range(lo, lo + per_stage)
    module.mesh_layout = MeshLayout(mesh=mesh, placements=placements, full_shapes=shapes)
    return model


# ---------------------------------------------------------------------------
# The pipelined train step
# ---------------------------------------------------------------------------


def _fold(seed: int, *salts: int) -> int:
    for salt in salts:
        seed = (seed * 0x100000001B3 + salt + 1) % 2**62
    return seed


def make_pipeline_train_step(cfg, mesh, *, n_micro: int, loss_fn: Callable = cross_entropy_loss,
                             grad_clip: float | None = None,
                             schedule: Callable[[int], float] | None = None,
                             base_lr: float = 0.0, remat: bool = False,
                             pp_schedule: str = "gpipe"):
    """Build the pipelined train step ``(state, (x, y), generator=None) ->
    metrics`` for a model of config ``cfg`` placed by :func:`place_stages`
    on ``mesh`` (:176-550).

    Each rank passes its data-parallel row's batch (``shard_batch(batch,
    mesh)``; the stages of a row pass the same rows), split into ``n_micro``
    equal microbatches. ``pp_schedule`` is ``"gpipe"`` or ``"1f1b"`` (see
    the module's docstring); ``remat`` runs each block under
    ``torch.utils.checkpoint``; ``grad_clip`` clips at the global norm in
    the step (the optimizer must not clip); ``schedule`` and ``base_lr``
    report ``lr`` as ``make_train_step`` does. Metrics, 0-d tensors on every
    rank: ``loss`` (mean over microbatches and dp), ``grad_norm`` (before
    the clip), ``lr``. Raises AssertionError, as the JAX package asserts, for
    a mesh without 'pp', an unknown schedule, pp not dividing n_layers, or
    batch norm. ``step.pp_schedule``, ``step.n_ticks`` and ``step.n_slots``
    are the schedule's (:546-549); ``step.saved_inputs`` is the most stage
    inputs 1F1B held at once in the last step."""
    if "pp" not in mesh.axis_names:
        raise AssertionError(f"mesh {mesh.axis_names} has no 'pp' axis")
    if pp_schedule not in SCHEDULES:
        raise AssertionError(f"unknown pipeline schedule {pp_schedule!r}; choose 'gpipe' or "
                             "'1f1b'")
    pp = mesh.pp
    if cfg.n_layers % pp:
        raise AssertionError(f"n_layers={cfg.n_layers} not divisible by pp={pp}")
    if cfg.norm.lower() == "batch":
        raise AssertionError("pipeline step supports layer/rms norm only (batch-norm running "
                             "stats don't commute with the microbatch schedule)")
    stage = mesh.pp_rank
    first, last = stage == 0, stage == pp - 1
    n_slots = 2 * pp - 1
    joined = []

    def exchange(send_next=None, send_prev=None, recv_prev=None, recv_next=None):
        """Post this tick's sends and receives together; ``recv_*`` are the
        (shape, dtype, device) of the buffers to receive into."""
        ops, got = [], {}
        for tensor, peer in ((send_next, mesh.rank + 1), (send_prev, mesh.rank - 1)):
            if tensor is not None:
                ops.append(dist.P2POp(dist.isend, tensor.contiguous(), peer, mesh.pp_group))
        for key, spec, peer in (("prev", recv_prev, mesh.rank - 1),
                                ("next", recv_next, mesh.rank + 1)):
            if spec is not None:
                got[key] = torch.empty(spec[0], dtype=spec[1], device=spec[2])
                ops.append(dist.P2POp(dist.irecv, got[key], peer, mesh.pp_group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return got.get("prev"), got.get("next")

    def train_step(state, batch, generator: torch.Generator | None = None) -> dict:
        x, y = batch
        if x.shape[0] % n_micro:
            raise ValueError(f"batch of {x.shape[0]} does not split into {n_micro} equal "
                             "microbatches")
        module = state.model.module
        module.train()
        if mesh.pp_group is not None and not joined:
            # the group's first collective has every rank in it: under NCCL a
            # first batch_isend_irecv that some ranks skip is undefined
            dist.all_reduce(torch.zeros(1, device=x.device), group=mesh.pp_group)
            joined.append(True)
        blocks = [module.blocks[i] for i in stage_blocks(module)]
        embed_trains = any(p.requires_grad for p in module.embedding.parameters())
        xs, ys = x.chunk(n_micro), y.chunk(n_micro)
        base = None if generator is None else draw_seed(generator, mesh.dp_rank)

        def gen(m: int, *salts: int):
            if base is None:
                return None
            return torch.Generator(device=generator.device).manual_seed(
                _fold(base, m, *salts))

        def embed(m: int):
            return module.embedding(xs[m], gen(m, 0))

        def run_stage(h, m: int):
            g = gen(m, 1, stage)
            for block in blocks:
                seed = None if g is None else draw_seed(g)

                def run(z, block=block, seed=seed):
                    bg = (None if seed is None
                          else torch.Generator(device=g.device).manual_seed(seed))
                    return block(z, generator=bg)

                h = checkpoint(run, h, use_reentrant=False) if remat else run(h)
            return h

        def head_loss(h, m: int):
            logits = module.output(h, module.embedding, False, None, gen(m, 2))
            return loss_fn(logits, ys[m]) / n_micro

        act = None
        if pp > 1:  # the shape of what goes between stages
            was = module.embedding.training
            module.embedding.eval()
            with torch.no_grad():
                probe = module.embedding(xs[0][:1])
            module.embedding.train(was)
            act = ((xs[0].shape[0], *probe.shape[1:]), probe.dtype, x.device)

        def valid(m: int) -> bool:
            return 0 <= m < n_micro

        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=x.device)
        saved_most = 0
        if pp_schedule == "gpipe":
            kept, recv = {}, None
            for t in range(n_micro + pp - 1):
                m, out = t - stage, None
                if valid(m):
                    h = embed(m) if first else recv.requires_grad_()
                    out = run_stage(h, m)
                    if last:
                        out = head_loss(out, m)
                        loss_sum += out.detach()
                    kept[m] = (h, out)
                recv, _ = exchange(
                    send_next=None if out is None or last else out.detach(),
                    recv_prev=act if not first and valid(t + 1 - stage) else None)
            grad = None
            for t in range(n_micro + pp - 1):
                m, dx = n_micro - 1 - t + (pp - 1 - stage), None
                if valid(m):
                    h, out = kept.pop(m)
                    if out.requires_grad:  # not when all of stage 0 is frozen
                        out.backward(None if last else grad)
                    dx = None if first else h.grad
                _, grad = exchange(
                    send_prev=dx,
                    recv_next=act if not last and valid(m - 1) else None)
        else:
            ring: list = [None] * n_slots
            recv_f = recv_b = None
            for t in range(n_micro + 2 * (pp - 1)):
                # forward phase: microbatch t - s, no graph; keep its input
                mf, y_out = t - stage, None
                if valid(mf):
                    with torch.no_grad():
                        h = embed(mf) if first else recv_f
                        if not last:  # the last stage's output is recomputed below
                            y_out = run_stage(h, mf)
                    assert ring[mf % n_slots] is None, "1F1B ring slot still occupied"
                    ring[mf % n_slots] = h
                    saved_most = max(saved_most, sum(r is not None for r in ring))
                # backward phase: microbatch t - 2(pp-1) + s, recomputed
                mb, dx = t - 2 * (pp - 1) + stage, None
                if valid(mb):
                    h = ring[mb % n_slots].detach().requires_grad_()
                    ring[mb % n_slots] = None
                    out = run_stage(h, mb)
                    if last:
                        loss_m = head_loss(out, mb)
                        loss_m.backward()
                        loss_sum += loss_m.detach()
                    else:
                        out.backward(recv_b)
                    dx = h.grad
                    if first:
                        if embed_trains:
                            embed(mb).backward(dx)
                        dx = None
                recv_f, recv_b = exchange(
                    send_next=y_out, send_prev=dx,
                    recv_prev=act if not first and valid(t + 1 - stage) else None,
                    recv_next=act if not last and valid(mb + 1) else None)
        step.saved_inputs = saved_most

        # gradients: embedding and head summed over 'pp', all averaged over 'dp'
        names = {p: name for name, p in module.named_parameters()}
        params = trainable_grads(module)
        in_blocks = [p for p in params if names[p].startswith("blocks.")]
        replicated = [p for p in params if not names[p].startswith("blocks.")]
        if pp > 1:
            reduce_flat_([loss_sum] + [p.grad for p in replicated], mesh.pp_group)
        if mesh.dp > 1:
            reduce_flat_([loss_sum] + [p.grad for p in params], mesh.dp_group, mesh.dp)
        blk_sq = global_grad_norm([p.grad for p in in_blocks]).square().reshape(1).to(x.device)
        if pp > 1 and mesh.pp_group is not None:
            dist.all_reduce(blk_sq, group=mesh.pp_group)
        grad_norm = torch.sqrt(blk_sq[0] + global_grad_norm([p.grad for p in replicated])
                               .square().to(x.device))
        return finish_step(state, [p.grad for p in params],
                           {"loss": loss_sum, "grad_norm": grad_norm}, grad_clip=grad_clip,
                           schedule=schedule, base_lr=base_lr)

    step = train_step
    step.pp_schedule = pp_schedule
    step.n_ticks = n_micro + (2 * (pp - 1) if pp_schedule == "1f1b" else pp - 1)
    step.n_slots = n_slots if pp_schedule == "1f1b" else None
    step.saved_inputs = 0
    return step

