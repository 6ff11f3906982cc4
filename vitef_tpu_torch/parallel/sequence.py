"""Sequence parallelism: ring attention over a ``torch.distributed`` "sp" group.

Counterpart of ``vitef_tpu/parallel/sequence.py``. Every activation is
sharded on L across the ranks of the group: embedding, norms, FFN and the
qkv and output projections are local (position-wise), and attention runs as
ring attention. Each rank keeps its (N, h, L/sp, d) query block and starts
with its own K/V block; the K/V blocks travel around the ring (rank r sends
to r + 1 and receives from r - 1, ``dist.batch_isend_irecv`` for the JAX
``ppermute`` :334, :388) while an online softmax folds each visiting block
into float32 state ``(m, s, acc)`` (the hop: :mod:`vitef_tpu_torch.ops.ring_hop`,
kernel K9 on CUDA). After sp hops every query has seen every key.

- **Positions without a device sync.** Every rank knows the global
  positions of every block: on the host (:func:`shard_positions`), where it
  decides whether a (query segment, key segment) pair is fully in the
  future and is skipped (:372-384), and on the card
  (:func:`device_positions`, made by arange), where the hops read them. The
  block visiting rank r at hop j is the one rank ``(r - j) mod sp`` started
  with.
- **Zigzag layout** (:func:`zigzag_permutation`): rank s holds the
  half-blocks {s, 2sp - 1 - s}, which balances the causal work across ranks.
  The segments are slices along L, which K9 reads in place.
- **The backward** (:class:`_RingAttention`): ``torch.distributed``'s sends
  and receives have no autograd formula, so the whole ring is one
  ``torch.autograd.Function``. Its forward keeps the visiting K/V blocks and
  each hop's input state, O(sp · Lloc · d) per rank (the residuals of the
  JAX hop, :266). Its backward replays the hops in reverse order through the
  plain hop under autograd (as the JAX custom VJP and ``jax.checkpoint`` do)
  and passes each block's float32 dK/dV accumulator to rank - 1 after each
  hop, the transpose of the forward's exchange, so that it has visited
  every rank and is home at its owner after the last hop.
- **The train step** (:func:`make_sp_train_step`): every rank gets the
  global batch, permutes it to the zigzag layout if asked, takes its L/sp
  slice, accumulates exact microbatches and all-reduces the loss and the
  float32 gradients to their mean over the group (``pmean`` :588-589)
  before the clip and the optimizer.

At sp = 1 the exchange is the identity and is skipped.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.transformer import split_qkv
from ..ops.common import canonical_impl, draw_seed, dropout
from ..ops.ring_hop import attend_block, hop_kernel_ok, hop_state, hop_vjp
from ..optim import global_grad_norm
from .train_step import (TrainState, cross_entropy_loss, finish_step, reduce_flat_,
                         trainable_grads)


def zigzag_permutation(length: int, sp: int) -> np.ndarray:
    """Row permutation for the zigzag layout (:78-92): ``x[:, perm]`` lays the
    sequence out so that an even split into sp slices gives rank s the global
    half-blocks {s, 2sp - 1 - s}. Apply the same permutation to tokens and
    labels."""
    if length % (2 * sp):
        raise ValueError(f"zigzag needs a length divisible by 2·sp, got {length} at sp={sp}")
    lh = length // (2 * sp)
    idx = []
    for s in range(sp):
        a, b = s, 2 * sp - 1 - s
        idx.extend(range(a * lh, (a + 1) * lh))
        idx.extend(range(b * lh, (b + 1) * lh))
    return np.asarray(idx, dtype=np.int32)


def shard_positions(rank: int, lloc: int, sp: int, zigzag: bool) -> np.ndarray:
    """Global positions of the ``lloc`` rows that ``rank`` holds (``_shard_positions``
    :95-103), as an int32 array on the host."""
    if not zigzag:
        return rank * lloc + np.arange(lloc, dtype=np.int32)
    lh = lloc // 2
    iota = np.arange(lh, dtype=np.int32)
    return np.concatenate([rank * lh + iota, (2 * sp - 1 - rank) * lh + iota]).astype(np.int32)


def device_positions(lloc: int, sp: int, zigzag: bool, device) -> torch.Tensor:
    """Every rank's :func:`shard_positions`, (sp, lloc) int32, made on
    ``device`` by arange and slicing: a copy from host memory would make the
    host wait for the device. Flattened, it is the zigzag permutation (or the
    identity)."""
    if not zigzag:
        return torch.arange(sp * lloc, dtype=torch.int32, device=device).view(sp, lloc)
    halves = torch.arange(sp * lloc, dtype=torch.int32, device=device).view(2 * sp, lloc // 2)
    return torch.cat([halves[:sp], halves[sp:].flip(0)], dim=1)


def build_sp_group(sp: int, group=None, backend: str = "nccl"):
    """The process group of the 'sp' ring (``build_sp_mesh`` :618-623):
    ``group``, or the default group; raises unless it holds ``sp`` ranks.

    With no default group yet and ``sp == 1``, a one-rank default group is
    initialised with ``backend`` ("nccl" for the card, "gloo" for the CPU)
    on a free localhost port. Groups of several ranks are made by their
    processes, which each pass their address, rank and world size to
    ``dist.init_process_group``.
    """
    if not dist.is_initialized():
        if sp != 1:
            raise RuntimeError(f"sp={sp}: initialise the default process group first")
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)
    group = dist.group.WORLD if group is None else group
    if dist.get_world_size(group) != sp:
        raise ValueError(f"sp={sp} must equal the group's size, {dist.get_world_size(group)}")
    return group


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------


@dataclass
class _Ring:
    """What every hop of one ring attention call needs."""

    group: object
    rank: int
    sp: int
    causal: bool
    chunk: int | None
    scale: float
    kernel: bool                          # K9 (raw queries) or the plain hop (scaled float32)
    n_seg: int
    lseg: int
    positions: np.ndarray                 # (sp, Lloc): the rows of the block each rank started with
    device_positions: torch.Tensor        # the same, int32 on the queries' device

    def segment(self, i: int) -> slice:
        return slice(i * self.lseg, (i + 1) * self.lseg)


def _fully_future(kpos: np.ndarray, qpos: np.ndarray) -> bool:
    """Whether no key of a segment is visible to any query of another: the
    pair is skipped (:383)."""
    return kpos.min() > qpos.max()


def _shift(tensors, ring: _Ring, step: int) -> list:
    """Send each tensor to rank + step of the ring and receive its
    counterpart from rank - step."""
    send_to = dist.get_global_rank(ring.group, (ring.rank + step) % ring.sp)
    recv_from = dist.get_global_rank(ring.group, (ring.rank - step) % ring.sp)
    tensors = [t.contiguous() for t in tensors]
    received = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, send_to, ring.group) for t in tensors]
           + [dist.P2POp(dist.irecv, t, recv_from, ring.group) for t in received])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


def _ring_forward(q, k, v, ring: _Ring, keep: bool):
    """The ring's hops: returns the output (N, h, Lloc, d) in q's dtype, the
    final state of each query segment, and (when ``keep``) the hops taken as
    ``(hop, q segment, k segment, input state)`` and the block visiting at
    each hop."""
    n, h, lq, d = q.shape
    qin = q if ring.kernel else q.float() * ring.scale
    qpos, qpos_dev = ring.positions[ring.rank], ring.device_positions[ring.rank]
    states = [(torch.full((n, h, ring.lseg, 1), -1e30, dtype=torch.float32, device=q.device),
               torch.zeros((n, h, ring.lseg, 1), dtype=torch.float32, device=q.device),
               torch.zeros((n, h, ring.lseg, d), dtype=torch.float32, device=q.device))
              for _ in range(ring.n_seg)]
    trace, blocks = [], []
    kt, vt = k, v
    for j in range(ring.sp):
        owner = (ring.rank - j) % ring.sp
        kpos, kpos_dev = ring.positions[owner], ring.device_positions[owner]
        for qi in range(ring.n_seg):
            qs = ring.segment(qi)
            for ki in range(ring.n_seg):
                ks = ring.segment(ki)
                if ring.causal and _fully_future(kpos[ks], qpos[qs]):
                    continue
                if keep:
                    trace.append((j, qi, ki, states[qi]))
                args = (qin[:, :, qs], qpos_dev[qs], kt[:, :, ks], vt[:, :, ks], kpos_dev[ks])
                if ring.kernel:
                    states[qi] = hop_state(*args, *states[qi], causal=ring.causal,
                                           chunk=ring.chunk, scale=ring.scale, impl="kernel")
                else:
                    states[qi] = attend_block(*args, states[qi], causal=ring.causal,
                                              chunk=ring.chunk)
        if keep:
            blocks.append((kt, vt))
        if j < ring.sp - 1:
            kt, vt = _shift((kt, vt), ring, 1)
    # causal: every query sees at least its own position, so s > 0
    out = torch.cat([acc / s.clamp_min(1e-30) for _, s, acc in states], dim=2).to(q.dtype)
    return out, states, trace, blocks


class _RingAttention(torch.autograd.Function):
    """The ring, forward and backward; see the module docstring."""

    @staticmethod
    def forward(ctx, q, k, v, ring):
        out, states, trace, blocks = _ring_forward(q, k, v, ring, keep=True)
        ctx.ring = ring
        ctx.hops = [(j, qi, ki) for j, qi, ki, _ in trace]
        ctx.save_for_backward(q, *(t for kv in blocks for t in kv),
                              *(t for *_, st in trace for t in st),
                              *(t for _, s, acc in states for t in (s, acc)))
        return out

    @staticmethod
    def backward(ctx, dout):
        ring = ctx.ring
        saved = list(ctx.saved_tensors)
        q, saved = saved[0], saved[1:]
        blocks = [saved[2 * j:2 * j + 2] for j in range(ring.sp)]
        saved = saved[2 * ring.sp:]
        inputs = [saved[3 * i:3 * i + 3] for i in range(len(ctx.hops))]
        final = saved[3 * len(ctx.hops):]
        qpos_dev = ring.device_positions[ring.rank]

        # Cotangents of each segment's final state through acc / max(s, 1e-30).
        cot = []
        for qi in range(ring.n_seg):
            with torch.enable_grad():
                s, acc = (t.detach().requires_grad_() for t in final[2 * qi:2 * qi + 2])
                out = acc / s.clamp_min(1e-30)
                ds, dacc = torch.autograd.grad(out, (s, acc),
                                               dout[:, :, ring.segment(qi)].float())
            cot.append([torch.zeros_like(ds), ds, dacc])

        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = None
        for j in reversed(range(ring.sp)):
            # the transpose of the exchange after hop j: rank r's accumulator
            # came from rank r + 1 and now holds the block visiting at hop j
            dkv = ([torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                    for t in blocks[j]] if dkv is None else _shift(dkv, ring, -1))
            kpos_dev = ring.device_positions[(ring.rank - j) % ring.sp]
            for (hop, qi, ki), state in reversed(list(zip(ctx.hops, inputs))):
                if hop != j:
                    continue
                qs, ks = ring.segment(qi), ring.segment(ki)
                g = hop_vjp(q[:, :, qs], qpos_dev[qs], blocks[j][0][:, :, ks],
                            blocks[j][1][:, :, ks], kpos_dev[ks], state, cot[qi],
                            causal=ring.causal, chunk=ring.chunk, scale=ring.scale)
                dq[:, :, qs] += g[0]
                dkv[0][:, :, ks] += g[1]
                dkv[1][:, :, ks] += g[2]
                cot[qi] = g[3:]
        return dq.to(q.dtype), dkv[0].to(blocks[0][0].dtype), dkv[1].to(blocks[0][1].dtype), None


def ring_attention(q, k, v, *, group=None, causal: bool = False, zigzag: bool = False,
                   chunk: int | None = 512, impl: str = "auto"):
    """Blockwise-softmax attention over the sequence-sharded ring (:301-402).

    ``q``, ``k``, ``v``: this rank's (N, h, Lloc, d) shards of (N, h, L, d)
    tensors with L = sp · Lloc split over the ranks of ``group`` (default:
    the default process group) contiguously, or in the zigzag layout
    (``zigzag=True``: rows permuted with :func:`zigzag_permutation`; the
    output comes back in the same layout). Returns this rank's (N, h, Lloc,
    d) shard of full-sequence softmax attention. Differentiable; every rank
    of the group must call it, and run its backward, together.

    ``chunk`` bounds the plain hop's live float32 scores to (N, h, Lseg,
    chunk) (``None``: 512). ``impl``: ``"plain"`` (or ``"xla"``) folds with
    :func:`~vitef_tpu_torch.ops.ring_hop.attend_block` on pre-scaled float32
    queries; ``"kernel"`` (or ``"pallas"``) with
    :func:`~vitef_tpu_torch.ops.ring_hop.hop_state`, K9 on a CUDA tensor, the
    scale folded into it (its plain version on a CPU tensor); ``"auto"``
    takes the kernel when ``hop_kernel_ok`` holds for the segment.
    """
    impl = canonical_impl(impl)
    group = dist.group.WORLD if group is None else group
    sp, rank = dist.get_world_size(group), dist.get_rank(group)
    n, h, lq, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if zigzag and lq % 2:
        raise ValueError("zigzag shards hold two half-blocks: Lloc must be even")
    n_seg = 2 if zigzag else 1
    lseg = lq // n_seg
    positions = np.stack([shard_positions(r, lq, sp, zigzag) for r in range(sp)])
    ring = _Ring(group=group, rank=rank, sp=sp, causal=causal, chunk=chunk,
                 scale=d ** -0.5,
                 kernel=impl == "kernel" or (impl == "auto" and hop_kernel_ok(q, lseg, d)),
                 n_seg=n_seg, lseg=lseg, positions=positions,
                 device_positions=device_positions(lq, sp, zigzag, q.device))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _RingAttention.apply(q, k, v, ring)
    return _ring_forward(q, k, v, ring, keep=False)[0]


# ---------------------------------------------------------------------------
# Sequence-parallel causal-LM forward and train step
# ---------------------------------------------------------------------------


def _check_sp_config(cfg) -> None:
    """Raise where the JAX forward asserts (:427-436), and where it would
    compute something else than the model: it never rotates q and k, and it
    splits qkv into three equal parts."""
    if not (cfg.causal and cfg.pre_norm and not cfg.cls_token):
        raise ValueError("apply_transformer_sp supports the pre-norm causal LM configuration")
    if cfg.emb_type.lower() != "dict" or cfg.patch_type:
        raise ValueError("sequence parallelism shards the token axis (dict embedding)")
    if cfg.output_type.lower() != "sequence_to_sequence":
        raise ValueError("the sp head must be position-wise (sequence_to_sequence)")
    if cfg.norm.lower() == "batch":
        raise ValueError("the sp forward has no batch norm")
    if cfg.uses_rope:
        raise NotImplementedError("sequence parallelism with rotary positions is not ported")
    if cfg.uses_gqa:
        raise NotImplementedError("sequence parallelism with grouped-query heads is not ported")


_DROPOUTS = ("emb_dropout", "attn_dropout", "ffn_dropout", "output_dropout")


def apply_transformer_sp(module, tokens, *, group=None, zigzag: bool = False,
                         chunk: int | None = 512, generator: torch.Generator | None = None):
    """Pre-norm causal-LM forward of the port's ``Transformer`` on this
    rank's (N, Lloc) token shard (:410-494): float32 logits (N, Lloc, V).

    Each block applies its own ``attn_norm``, ``attn.qkv_mat``,
    :func:`ring_attention`, ``attn.output``, ``ffn_norm`` and FFN; the token
    and position embeddings are read at the shard's global positions, so the
    zigzag layout is right too; the output norm and the tied or untied head
    are the module's. The ring's hop follows ``cfg.attn_impl`` (``"plain"``
    forces the plain hop, as for the other attention paths).

    Dropout (train mode, ``generator`` needed for a rate > 0) runs at the
    model's four sites, all position-wise, on a stream of this rank's own:
    a generator seeded from one draw of ``generator`` mixed with the rank, as
    the JAX forward folds the shard index into its key (:443-447). Each
    block then draws from a generator split off that stream, as the
    ordinary forward's blocks do.
    """
    cfg = module.cfg
    _check_sp_config(cfg)
    train = module.training
    if train and generator is None and any(getattr(cfg, r) > 0 for r in _DROPOUTS):
        raise ValueError("dropout with rate>0 in train mode requires a generator")
    group = dist.group.WORLD if group is None else group
    sp, rank = dist.get_world_size(group), dist.get_rank(group)
    gen = None if generator is None else torch.Generator(device=generator.device).manual_seed(
        draw_seed(generator, rank))
    n, lloc = tokens.shape
    cd = cfg.cdtype()
    embedding = module.embedding
    out = F.embedding(tokens, embedding.token_emb["weight"].to(cd))
    if embedding.pos_emb is not None:
        pos = device_positions(lloc, sp, zigzag, tokens.device)[rank]
        out = out + embedding.pos_emb[:, pos.long()].to(cd)
    out = dropout(out, cfg.emb_dropout, gen, not train)
    e, h = cfg.emb_dim, cfg.n_heads
    impl = cfg.attn_impl if cfg.flash else "plain"
    for block in module.blocks:
        block_gen = None if gen is None else torch.Generator(device=gen.device).manual_seed(
            draw_seed(gen))
        q, k, v = split_qkv(cfg, block.attn.qkv_mat(block.attn_norm(out), cd))
        q, k, v = (t.reshape(n, lloc, h, e // h).transpose(1, 2) for t in (q, k, v))
        z = ring_attention(q, k, v, group=group, causal=True, zigzag=zigzag, chunk=chunk,
                           impl=impl)
        z = block.attn.output(z.transpose(1, 2).reshape(n, lloc, e), cd)
        out = out + dropout(z, cfg.attn_dropout, block_gen, not train)
        out = out + block._ffn(block.ffn_norm(out), None, block_gen)
    return module.output(out, embedding, generator=gen)


def make_sp_train_step(*, group=None, zigzag: bool = False, chunk: int | None = 512,
                       grad_acc_steps: int = 1, grad_clip: float | None = None,
                       loss_fn: Callable = cross_entropy_loss,
                       schedule: Callable[[int], float] | None = None, base_lr: float = 0.0):
    """Train step ``(state, (tokens, labels)) -> metrics`` with the sequence
    axis split over the ranks of ``group`` (:502-615).

    Every rank passes the global (N, L) batch (labels already shifted, e.g.
    ``roll(tokens, -1)``). With ``zigzag`` the step permutes tokens and labels
    into the zigzag layout (the loss is a position-wise mean, so this leaves
    it unchanged), then each rank takes its L/sp slice. The batch splits into
    ``grad_acc_steps`` equal microbatches whose gradients sum; the loss and
    the float32 gradients are then all-reduced to their mean over the group
    and the microbatches in one flat buffer. Then ``grad_norm``, the global
    clip at ``grad_clip``, the optimizer and the scheduler, as
    :func:`~vitef_tpu_torch.parallel.train_step.make_train_step`. Metrics:
    ``loss``, ``grad_norm`` and, with ``schedule``, ``lr``. ``generator``
    (the same seed on every rank) feeds dropout, each rank on its own
    stream (:func:`apply_transformer_sp`).
    """
    if grad_acc_steps < 1:
        raise ValueError(f"grad_acc_steps must be >= 1, got {grad_acc_steps}")

    def train_step(state: TrainState, batch, generator: torch.Generator | None = None) -> dict:
        tokens, labels = batch
        grp = dist.group.WORLD if group is None else group
        sp, rank = dist.get_world_size(grp), dist.get_rank(grp)
        n, length = tokens.shape
        if n % grad_acc_steps:
            raise ValueError(f"batch of {n} does not split into {grad_acc_steps} equal "
                             "microbatches")
        if length % sp:
            raise ValueError(f"length {length} does not split over sp={sp}")
        if zigzag:
            perm = device_positions(length // sp, sp, True, tokens.device).view(-1).long()
            tokens, labels = tokens[:, perm], labels[:, perm]
        lloc = length // sp
        tokens = tokens[:, rank * lloc:(rank + 1) * lloc]
        labels = labels[:, rank * lloc:(rank + 1) * lloc]
        module = state.model.module
        module.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=tokens.device)
        for tok, lab in zip(tokens.chunk(grad_acc_steps), labels.chunk(grad_acc_steps)):
            logits = apply_transformer_sp(module, tok, group=grp, zigzag=zigzag, chunk=chunk,
                                          generator=generator)
            loss = loss_fn(logits, lab)
            loss.backward()
            loss_sum += loss.detach()
        grads = [p.grad for p in trainable_grads(module)]
        reduce_flat_([loss_sum] + grads, grp, sp * grad_acc_steps)
        metrics = {"loss": loss_sum, "grad_norm": global_grad_norm(grads)}
        return finish_step(state, grads, metrics, grad_clip=grad_clip, schedule=schedule,
                           base_lr=base_lr)

    return train_step
