"""Fully sharded data parallelism by unit: each unit's FSDP shards are gathered
over 'dp' for its forward and again for its backward, and its gradients are
reduce-scattered as soon as they are complete.

The JAX package leaves the gathers to GSPMD, which places them per use
(``apps/vit/train.py`` :225, ``vitef_tpu/parallel/mesh.py`` :166-199). Here
the schedule is explicit, on the placement ``shard_params`` records
(``MeshLayout``): a unit is the token embedding, one block, or the output
(the final norm and the head; with a tied head also the token table, which
then belongs to two units). :func:`install_units` hooks each unit's module:

- before its forward, one flat all-gather over 'dp' (:class:`_Gather`)
  makes the whole tensors of the unit's FSDP-sharded parameters, which
  stand in the module's parameter slots while the forward runs; after it,
  the slots hold the shards again and the whole tensors are dropped;
- a tensor that autograd saves for the backward and that is a whole tensor
  or its cast to another dtype (or a view of either) is saved as a recipe
  (``torch.autograd.graph.saved_tensors_hooks``): the backward's first
  unpack gathers the unit again, and every recipe is rebuilt from that copy,
  with the forward's values; the copy is freed with the unit's last recipe.
  (A frozen parameter's cast has no autograd history to recognise it by,
  so it is saved as it is: memory, not values.)
  A block under ``remat`` saves nothing of its own (``ops.common.checkpointed``):
  its recompute gathers again, inside the backward;
- the backward of :class:`_Gather` receives the unit's whole gradients once
  autograd has summed every use, reduce-scatters them in float32 in one
  flat collective, divides by dp, and returns each parameter's shard of
  the mean, which autograd adds into the shard's ``.grad`` (the float32
  accumulator that carries over the microbatches).

Parameters not split over 'dp' are left alone. ``MeshLayout.held`` counts
the elements held gathered (whole weights and whole gradients) and
``peak_held`` its high-water mark.
"""

from __future__ import annotations

import weakref

import torch
import torch.distributed as dist
from torch import nn

from ..ops.common import is_checkpointed


class _Gather(torch.autograd.Function):
    """``(unit, *shards) -> wholes``: the unit's all-gather forward, its
    reduce-scatter backward. Outputs of frozen shards carry no gradient."""

    @staticmethod
    def forward(ctx, unit, *shards):
        ctx.unit = unit
        ctx.set_materialize_grads(False)
        wholes = unit.gather(shards)
        ctx.mark_non_differentiable(
            *[w for w, need in zip(wholes, ctx.needs_input_grad[1:]) if not need])
        return tuple(wholes)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.unit.reduce_scatter(grads))


class _Saved:
    """A saved tensor kept as a recipe: the view ``(size, stride, offset)``
    of whole tensor ``index`` or (``dtype``) of its cast."""

    __slots__ = ("gathering", "index", "dtype", "size", "stride", "offset")

    def __init__(self, gathering, index, dtype, t):
        self.gathering, self.index, self.dtype = gathering, index, dtype
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()

    def restore(self) -> torch.Tensor:
        whole = self.gathering.regathered()[self.index]
        if self.dtype is not None:
            whole = whole.to(self.dtype)
        return whole.as_strided(self.size, self.stride, self.offset)


class _Gathering:
    """One forward of a unit: its shards, its whole tensors while the
    forward runs, and the copy its recipes are rebuilt from."""

    def __init__(self, unit, shards, wholes):
        self.unit, self.shards, self.wholes, self.cache = unit, shards, wholes, None
        self.ptrs = {w.untyped_storage().data_ptr(): i for i, w in enumerate(wholes)
                     if w.numel()}
        self.node = next((w.grad_fn for w in wholes if w.grad_fn is not None), None)
        self.hooks = None

    def pack(self, t: torch.Tensor):
        if self.wholes is None or not t.numel():
            return t
        i = self.ptrs.get(t.untyped_storage().data_ptr())
        if i is not None:
            return _Saved(self, i, None, t)
        # a cast of a whole tensor, or a view of one (F.linear saves Wᵀ)
        base = t if t._base is None else t._base
        fn = base.grad_fn
        if (self.node is not None and type(fn).__name__ == "ToCopyBackward0"
                and base.is_contiguous()):
            src, i = fn.next_functions[0]
            if src is self.node and base.shape == self.wholes[i].shape:
                return _Saved(self, i, base.dtype, t)
        return t

    @staticmethod
    def unpack(saved):
        return saved.restore() if isinstance(saved, _Saved) else saved

    def regathered(self) -> list[torch.Tensor]:
        if self.cache is None:
            with torch.no_grad():
                self.cache = self.unit.gather(self.shards)
        return self.cache


class Unit:
    """The FSDP-sharded parameters one module's forward reads, as ``(owner
    module, key, name)`` slots, with the layout they are placed by."""

    def __init__(self, layout, slots: list[tuple[nn.Module, str, str]]):
        self.layout, self.slots = layout, slots
        mesh = layout.mesh
        self.group, self.dp, self.dp_rank = mesh.dp_group, mesh.dp, mesh.dp_rank
        self.axes = [layout.placement(name).dp for _, _, name in slots]
        self.current = None
        # the elements of the unit's whole tensors (this rank's tp slices)
        self.size = self.dp * sum(owner._parameters[key].numel()
                                  for owner, key, _ in slots)

    # -- the collectives ----------------------------------------------------

    def gather(self, shards) -> list[torch.Tensor]:
        """The whole tensors of ``shards`` from every dp rank's, in one flat
        all-gather: rank r's block of the output holds its shards in slot
        order, and each whole tensor is its pieces joined along its FSDP axis."""
        flat = torch.cat([s.detach().reshape(-1) for s in shards])
        out = flat.new_empty(self.dp * flat.numel())
        dist.all_gather_into_tensor(out, flat, group=self.group)
        blocks = out.view(self.dp, -1)
        wholes, start = [], 0
        for s, axis in zip(shards, self.axes):
            pieces = blocks[:, start:start + s.numel()].reshape(self.dp, *s.shape)
            whole = pieces.movedim(0, axis).reshape(
                *s.shape[:axis], self.dp * s.shape[axis], *s.shape[axis + 1:])
            wholes.append(whole.clone() if whole._is_view() else whole)
            start += s.numel()
        del out, blocks
        hold(self.layout, wholes)
        return wholes

    def reduce_scatter(self, grads) -> list[torch.Tensor | None]:
        """Each whole gradient's shard of the dp mean, in float32, from one
        flat reduce-scatter (rank r's block of the input holds the r-th chunk
        of every gradient along its FSDP axis); None where none came."""
        live = sum(g.numel() for g in grads if g is not None)
        self.layout.held += live
        self.layout.peak_held = max(self.layout.peak_held, self.layout.held)
        try:
            fronts = [(self._zeros(i) if g is None else g.float()).movedim(axis, 0)
                      for i, (g, axis) in enumerate(zip(grads, self.axes))]
            send = torch.cat([torch.cat([g.chunk(self.dp)[r].reshape(-1) for g in fronts])
                              for r in range(self.dp)])
            mine = send.new_empty(send.numel() // self.dp)
            dist.reduce_scatter_tensor(mine, send, group=self.group)
            del send
            mine /= self.dp
            out, start = [], 0
            for g, front, axis in zip(grads, fronts, self.axes):
                chunk = front.chunk(self.dp)[self.dp_rank]
                part = mine[start:start + chunk.numel()].view(chunk.shape)
                start += chunk.numel()
                # a copy of its own: a view into the flat buffer is not 16-byte
                # aligned, which changes a later norm's reduction order
                out.append(None if g is None else part.movedim(0, axis).clone(
                    memory_format=torch.contiguous_format))
            return out
        finally:
            self.layout.held -= live

    def _zeros(self, i: int) -> torch.Tensor:
        """A float32 zero gradient of slot ``i``'s whole tensor."""
        owner, key, _ = self.slots[i]
        shard, axis = owner._parameters[key], self.axes[i]
        shape = list(shard.shape)
        shape[axis] *= self.dp
        return torch.zeros(shape, dtype=torch.float32, device=shard.device)

    # -- the forward scope --------------------------------------------------

    def enter(self) -> None:
        """Gather the unit's shards into its slots (under
        :func:`~vitef_tpu_torch.parallel.mesh.gathered` they are whole
        already, and are left)."""
        if self.layout.whole:
            return
        shards = [owner._parameters[key] for owner, key, _ in self.slots]
        wholes = _Gather.apply(self, *shards)
        for (owner, key, _), whole in zip(self.slots, wholes):
            owner._parameters[key] = whole
        g = self.current = _Gathering(self, shards, list(wholes))
        if torch.is_grad_enabled() and not is_checkpointed():
            g.hooks = torch.autograd.graph.saved_tensors_hooks(g.pack, g.unpack)
            g.hooks.__enter__()

    def exit(self) -> None:
        """Put the shards back into the slots and drop the whole tensors."""
        g = self.current
        if g is None:
            return
        if g.hooks is not None:
            g.hooks.__exit__(None, None, None)
            g.hooks = None  # it holds g's bound methods: no cycle keeps g alive
        for (owner, key, _), shard in zip(self.slots, g.shards):
            owner._parameters[key] = shard
        g.wholes = g.ptrs = None
        self.current = None


def _slots(module: nn.Module, prefix: str, layout) -> list[tuple[nn.Module, str, str]]:
    return [(owner, key, f"{prefix}{path}{'.' if path else ''}{key}")
            for path, owner in module.named_modules()
            for key, p in owner._parameters.items()
            if p is not None and layout.placement(
                f"{prefix}{path}{'.' if path else ''}{key}").dp is not None]


def install_units(module: nn.Module, layout) -> list[Unit]:
    """Hook the units of a sharded ``Transformer`` (the embedding, each
    block, the output; a tied head's output unit also holds the token
    table) and return them; every FSDP-sharded parameter lies in a unit
    (ValueError otherwise)."""
    from ..models.transformer import SequenceOutput

    parts = [("embedding.", module.embedding)]
    parts += [(f"blocks.{i}.", block) for i, block in enumerate(module.blocks)]
    parts.append(("output.", module.output))
    units, covered = [], set()
    for prefix, part in parts:
        slots = _slots(part, prefix, layout)
        tied = isinstance(part, SequenceOutput) and module.cfg.weight_tying
        if part is module.output and tied:
            slots += _slots(module.embedding.token_emb, "embedding.token_emb.", layout)
        covered.update(name for _, _, name in slots)
        if not slots:
            continue
        unit = Unit(layout, slots)
        part.register_forward_pre_hook(lambda *_, unit=unit: unit.enter())
        part.register_forward_hook(lambda *_, unit=unit: unit.exit(), always_call=True)
        units.append(unit)
    missing = sorted(set(layout.fsdp_names()) - covered)
    if missing:
        raise ValueError(f"FSDP-sharded parameters outside every unit: {missing}")
    return units


def _release(layout_ref, n: int) -> None:
    layout = layout_ref()
    if layout is not None:
        layout.held -= n


def hold(layout, tensors) -> None:
    """Count ``tensors`` as held gathered until each is freed."""
    ref = weakref.ref(layout)
    for t in tensors:
        layout.held += t.numel()
        weakref.finalize(t, _release, ref, t.numel())
    layout.peak_held = max(layout.peak_held, layout.held)
