"""One ring-attention hop: the online-softmax state update, kernel K9 and its plain version.

Counterpart of the hop of ``vitef_tpu/parallel/sequence.py``:

- :func:`attend_block` (``_attend_block`` :114-153) — the plain hop in
  float32: it folds one K/V block, key chunk by key chunk, into the state
  ``(m, s, acc)`` of pre-scaled float32 queries;
- :func:`hop_state_reference` — the plain version of K9: the same hop on
  raw queries, scaled here;
- :func:`hop_state` (``_attend_state_pallas`` :249-283) — the K9 wrapper:
  on a CUDA tensor it launches ``csrc/ring_hop.cu`` (bfloat16 or float16,
  d = 64 or 128, on the tensor cores; any segment length; operands whose
  strides are multiples of 8 elements read in place), and
  when a gradient is wanted it runs under :class:`_HopState`, whose backward
  replays :func:`attend_block` under autograd from the saved hop inputs, as
  the JAX custom VJP does (:262-280). The JAX package has no backward kernel
  for this hop, so neither has the port. On a CPU tensor it runs
  :func:`hop_state_reference`;
- :func:`hop_kernel_ok` (``_hop_pallas_ok`` :286-298) — whether ``"auto"``
  takes K9: a CUDA device, a sub-float32 dtype, a segment that is a multiple
  of 128, d a multiple of 64, and K/V within 48 MiB. The last rule sizes the
  TPU kernel's VMEM residency; it is kept so that both packages branch
  alike.

Masking is causal by global position: a key j is visible to a query i when
``kpos[j] <= qpos[i]``. A masked score is the finite -1e30 and a masked
probability is zeroed, so a block that no key of a row may see leaves the
row's state as it was, whatever the order in which blocks arrive.
"""

from __future__ import annotations

import math

import torch

from ._build import kernel_function
from .common import canonical_impl

_NEG_INF = -1e30
_KERNEL_DTYPES = (torch.bfloat16, torch.float16)
_KERNEL_HEAD_DIMS = (64, 128)              # the widths csrc/ring_hop.cu instantiates
_SEGMENT_MULTIPLE = 128
_KV_BUDGET = 48 * 1024 * 1024              # the TPU kernel's K/V residency (bytes)


def pick_chunk(lk: int, chunk: int | None) -> int:
    """Largest divisor of ``lk`` that is at most the requested chunk
    (``_pick_chunk`` :106-111; ``None`` asks for 512)."""
    c = min(lk, chunk or 512)
    while lk % c:
        c -= 1
    return c


def attend_block(qf, qpos, k, v, kpos, state, *, causal: bool, chunk: int | None):
    """Fold one K/V block into the online-softmax state, key chunk by key chunk.

    ``qf`` (N, h, lq, d) float32 queries, already scaled; ``k``, ``v``
    (N, h, lk, d) in any float dtype (widened to float32); ``qpos`` (lq) and
    ``kpos`` (lk) integer global positions; ``state = (m, s, acc)`` float32
    of (N, h, lq, 1), (N, h, lq, 1) and (N, h, lq, d). Returns the new
    state. The largest float32 tensor alive is (N, h, lq, chunk).
    """
    m, s, acc = state
    lk = k.shape[2]
    c = pick_chunk(lk, chunk)
    for j0 in range(0, lk, c):
        kc = k[:, :, j0:j0 + c].float()
        vc = v[:, :, j0:j0 + c].float()
        scores = torch.matmul(qf, kc.transpose(-1, -2))
        if causal:
            mask = kpos[j0:j0 + c][None, :] <= qpos[:, None]
            scores = torch.where(mask, scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        if causal:
            # A fully masked chunk leaves m_new at the -1e30 start, where
            # exp(score - m_new) = exp(0) = 1 for every masked score: zero the
            # masked probabilities, so that no visit order changes the result.
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        s = s * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vc)
        m = m_new
    return m, s, acc


def _scale(q, scale: float | None) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def hop_state_reference(q, qpos, k, v, kpos, m, s, acc, *, causal: bool,
                        chunk: int | None = 512, scale: float | None = None):
    """Plain version of K9: :func:`attend_block` on ``q`` widened to float32
    and scaled (default 1/√d). Returns the new ``(m, s, acc)``."""
    qf = q.float() * _scale(q, scale)
    return attend_block(qf, qpos, k, v, kpos, (m, s, acc), causal=causal, chunk=chunk)


def hop_vjp(q, qpos, k, v, kpos, state, cotangents, *, causal: bool, chunk: int | None,
            scale: float):
    """The gradients ``(dq, dk, dv, dm, ds, dacc)`` of one hop of the raw
    queries ``q`` (scaled here by ``scale``) for the cotangents of its new
    state: :func:`attend_block` replayed under autograd from the hop's
    inputs, in float32. The gradients are float32."""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_() for t in (q, k, v, *state)]
        new = attend_block(leaves[0] * scale, qpos, leaves[1], leaves[2], kpos, leaves[3:],
                           causal=causal, chunk=chunk)
        grads = torch.autograd.grad(new, leaves, cotangents, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]


class _HopState(torch.autograd.Function):
    """K9 forward; the backward replays the plain hop (:func:`hop_vjp`)."""

    @staticmethod
    def forward(ctx, q, qpos, k, v, kpos, m, s, acc, causal, chunk, scale):
        ctx.causal, ctx.chunk, ctx.scale = causal, chunk, scale
        ctx.save_for_backward(q, qpos, k, v, kpos, m, s, acc)
        return _launch(q, qpos, k, v, kpos, m, s, acc, causal, scale)

    @staticmethod
    def backward(ctx, dm, ds, dacc):
        q, qpos, k, v, kpos, m, s, acc = ctx.saved_tensors
        cot = [torch.zeros_like(t) if g is None else g for t, g in zip((m, s, acc), (dm, ds, dacc))]
        dq, dk, dv, dm0, ds0, dacc0 = hop_vjp(q, qpos, k, v, kpos, (m, s, acc), cot,
                                              causal=ctx.causal, chunk=ctx.chunk, scale=ctx.scale)
        return (dq.to(q.dtype), None, dk.to(k.dtype), dv.to(v.dtype), None, dm0, ds0, dacc0,
                None, None, None)


def hop_kernel_ok(q, lseg: int, d: int, *, device=None) -> bool:
    """Whether ``impl="auto"`` takes K9 for queries like ``q`` (only its
    dtype and head count are read) on ``device`` (default ``q``'s):
    ``_hop_pallas_ok``'s rule with CUDA for the TPU."""
    if torch.device(device if device is not None else q.device).type != "cuda":
        return False
    if q.dtype.itemsize >= 4:
        return False
    if lseg % _SEGMENT_MULTIPLE or d % 64:
        return False
    return 2 * q.shape[1] * lseg * d * q.dtype.itemsize <= _KV_BUDGET


def _check_operand(name: str, t, shape: tuple, dtype, device):
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
        raise ValueError(f"ring_hop: {name} must be {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _rows_operand(name: str, t):
    """``t`` (N, h, L, d) as K9 reads it: rows contiguous, every stride a
    multiple of 8 elements and under 2**31, 16-byte aligned (K9 copies rows
    in 16-byte pieces with ``cp.async``); else a contiguous copy."""
    strides = t.stride()
    if (strides[3] == 1 and all(x % 8 == 0 and x < 2**31 for x in strides[:3])
            and t.data_ptr() % 16 == 0):
        return t
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    if t.numel() >= 2**31:
        raise ValueError(f"ring_hop: {name} has {t.numel()} elements, more than int32 strides hold")
    return t


def _launch(q, qpos, k, v, kpos, m, s, acc, causal: bool, scale: float):
    """K9 on CUDA tensors: checks what the kernel takes, launches it and
    returns the new ``(m, s, acc)``."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"ring_hop: unsupported device {device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("ring_hop: q, k, v must be (N, h, L, d)")
    n, h, lq, d = q.shape
    lk = k.shape[2]
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"ring_hop: dtype must be bfloat16 or float16, got {q.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"ring_hop is instantiated for head widths "
                                  f"{_KERNEL_HEAD_DIMS}, got {d}")
    if lq % _SEGMENT_MULTIPLE or lk % _SEGMENT_MULTIPLE:
        raise ValueError(f"ring_hop takes segments that are a multiple of {_SEGMENT_MULTIPLE}, "
                         f"got lq={lq}, lk={lk}")
    for name, t in (("k", k), ("v", v)):
        _check_operand(name, t, (n, h, lk, d), q.dtype, device)
    _check_operand("qpos", qpos, (lq,), torch.int32, device)
    _check_operand("kpos", kpos, (lk,), torch.int32, device)
    _check_operand("m", m, (n, h, lq, 1), torch.float32, device)
    _check_operand("s", s, (n, h, lq, 1), torch.float32, device)
    _check_operand("acc", acc, (n, h, lq, d), torch.float32, device)
    q, k, v = (_rows_operand(name, t) for name, t in (("q", q), ("k", k), ("v", v)))
    qpos, kpos, m, s, acc = (t.contiguous() for t in (qpos, kpos, m, s, acc))
    m_out, s_out, acc_out = torch.empty_like(m), torch.empty_like(s), torch.empty_like(acc)
    pointers = [q, k, v, qpos, kpos, m, s, acc, m_out, s_out, acc_out]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = kernel_function("ring_hop", len(pointers), 16, 1)(
            *(t.data_ptr() for t in pointers), n, h, lq, lk, d,
            int(q.dtype == torch.float16), int(causal), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], scale, stream)
    if err != 0:
        raise RuntimeError(f"ring_hop launch failed: cudaError {err} "
                           f"(N={n}, h={h}, lq={lq}, lk={lk}, d={d}, {q.dtype}, causal={causal})")
    hop_state.launches += 1
    return m_out, s_out, acc_out


def hop_state(q, qpos, k, v, kpos, m, s, acc, *, causal: bool, chunk: int | None = 512,
              scale: float | None = None, impl: str = "auto"):
    """One ring hop: fold the K/V block ``k``, ``v`` (N, h, lk, d) with key
    positions ``kpos`` (lk) into the float32 state ``(m, s, acc)`` of the
    queries ``q`` (N, h, lq, d) at positions ``qpos`` (lq). ``scale``
    (default 1/√d) multiplies the scores. Returns the new ``(m, s, acc)``.

    ``impl``: ``"plain"`` (or ``"xla"``) runs :func:`hop_state_reference`;
    ``"kernel"`` (or ``"pallas"``) launches K9 on a CUDA tensor, or raises
    there for what K9 does not take (a dtype other than bfloat16/float16, d
    other than 64/128, a segment that is not a multiple of 128), and runs
    the plain version on a CPU tensor; ``"auto"`` takes the kernel when
    :func:`hop_kernel_ok` holds. ``chunk`` bounds the plain version's live
    scores (and the backward's replay); the kernel's key tile is its own.

    When a gradient is wanted the kernel runs under :class:`_HopState`.
    ``hop_state.launches`` counts K9's launches.
    """
    impl = canonical_impl(impl)
    scale = _scale(q, scale)
    if impl == "auto":
        impl = ("kernel" if hop_kernel_ok(q, q.shape[2], q.shape[3])
                and k.shape[2] % _SEGMENT_MULTIPLE == 0 else "plain")
    if impl == "plain" or q.device.type == "cpu":
        return hop_state_reference(q, qpos, k, v, kpos, m, s, acc, causal=causal, chunk=chunk,
                                   scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, m, s, acc)):
        return _HopState.apply(q, qpos, k, v, kpos, m, s, acc, causal, chunk, scale)
    return _launch(q, qpos, k, v, kpos, m, s, acc, causal, scale)


hop_state.launches = 0
