"""Multi-head attention: the packed-qkv CUDA kernels and their plain PyTorch versions.

Counterpart of ``vitef_tpu/ops/attention.py``:

- :func:`attention_reference` (:55-82) — softmax attention on (N, h, L, d)
  with float32 scores, optionally returning the (N, h, L, L) weights;
- :func:`packed_mha_reference` — the plain version of the packed kernel K1;
- :func:`packed_mha_bwd_reference` — the plain version of its backward, K2
  (``_packed_mha_bwd_kernel`` :270-342) and, causal, K3
  (``_packed_mha_bwd_causal_blocked_kernel`` :181-267), in float32;
- :func:`fused_mha_packed` (:459-482) — the K1 wrapper: on a CUDA tensor it
  launches ``csrc/packed_mha_fwd.cu`` (non-causal or causal, any L), and when
  a gradient is wanted it runs under a ``torch.autograd.Function`` whose
  backward is :func:`packed_mha_bwd` (``csrc/packed_mha_bwd.cu``: K2, or K3
  when causal, any L), as ``_packed_mha``'s custom VJP (:390-441) does; on a
  CPU tensor it runs :func:`packed_mha_reference`, and autograd
  differentiates that;
- :func:`multi_head_attention` (:701-758) — qkv projection, attention, output
  projection; it takes the kernel at :731-736 of the JAX module, under the
  :func:`packed_mha_supported` gate.

The key-masked mode of K1 (serving) and the blocked flash kernels (K4, K5)
are not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ._build import kernel_function
from .common import resolve_impl

_NEG_INF = -1e30
_HEAD_DIM = 64                 # the head width the csrc/packed_mha_*.cu kernels instantiate


def attention_reference(q, k, v, *, causal: bool = False, kv_len: int | None = None,
                        return_weights: bool = False):
    """Softmax attention on (N, h, L, d) tensors with float32 scores and softmax.

    ``kv_len`` masks out padded key positions (keys with index >= kv_len).
    Products of bfloat16 inputs are exact in float32, so the float32 matmuls
    here give the JAX package's bf16-in, f32-accumulate einsums.
    """
    lq, lk, d = q.shape[2], k.shape[2], q.shape[3]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if kv_len is not None and kv_len < lk:
        kmask = torch.arange(lk, device=q.device) < kv_len
        scores = scores.masked_fill(~kmask, _NEG_INF)
    if causal:
        qi = torch.arange(lq, device=q.device)[:, None]
        ki = torch.arange(lk, device=q.device)[None, :]
        scores = scores.masked_fill(ki > qi, _NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    wts = weights.to(v.dtype)
    out = torch.matmul(wts.float(), v.float()).to(q.dtype)
    if return_weights:
        return out, weights
    return out


def _split_heads(t, n_heads: int):
    n, l, e = t.shape
    return t.reshape(n, l, n_heads, e // n_heads).transpose(1, 2)


def _merge_heads(t):
    n, h, l, d = t.shape
    return t.transpose(1, 2).reshape(n, l, h * d)


def packed_mha_reference(qkv, n_heads: int, causal: bool = False, bias=None):
    """Plain version of K1: softmax attention on packed qkv (N, L, 3E) -> (N, L, E).

    Columns are [q | k | v], head-major within each. ``bias`` (3E,) is added
    in the input dtype first, as the TPU kernel does.
    """
    if bias is not None:
        qkv = qkv + bias.to(qkv.dtype)
    q, k, v = (_split_heads(t, n_heads) for t in qkv.chunk(3, dim=-1))
    return _merge_heads(attention_reference(q, k, v, causal=causal))


def packed_mha_bwd_reference(qkv, bias, g, n_heads: int, causal: bool = False):
    """Plain version of K2: the gradients of K1 for the cotangent ``g`` (N, L, E).

    The algebra of ``_packed_mha_bwd_kernel`` written out in float32: the
    softmax recomputed from ``qkv + bias`` (added in the input dtype, as the
    forward does), ``dv = pᵀg``, ``dp = g vᵀ``, ``ds = p (dp - rowsum(p dp)) / √d``,
    ``dq = ds k``, ``dk = dsᵀ q``, packed back into [q | k | v] head-major
    columns. Returns ``(dqkv, db)``: dqkv in qkv's dtype, and db the float32
    column sums of that dqkv over all N·L rows, in the bias's dtype (None
    without a bias).
    """
    n, l, f = qkv.shape
    d = f // 3 // n_heads
    x = qkv if bias is None else qkv + bias.to(qkv.dtype)
    q, k, v = (_split_heads(t, n_heads).float() for t in x.chunk(3, dim=-1))
    gh = _split_heads(g, n_heads).float()
    scale = 1.0 / math.sqrt(d)
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        scores = scores.masked_fill(torch.ones(l, l, dtype=torch.bool, device=qkv.device)
                                    .triu(1), _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gh)
    dp = torch.matmul(gh, v.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True)) * scale
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dqkv = torch.cat([_merge_heads(t) for t in (dq, dk, dv)], dim=-1).to(qkv.dtype)
    db = None if bias is None else dqkv.float().sum(dim=(0, 1)).to(bias.dtype)
    return dqkv, db


# Row segments of the backward's bias-gradient reduction (its float32
# scratch is _DB_SEGMENTS x 3E).
_DB_SEGMENTS = 128


def packed_mha_supported(l: int, e: int, n_heads: int) -> bool:
    """Whether the packed kernels take this geometry: head width 64. The
    forward (K1) and the backward (K2, K3) tile over keys and take every L,
    causal or not."""
    return l > 0 and e % n_heads == 0 and e // n_heads == _HEAD_DIM


def _check_cuda(name: str, qkv, n_heads: int):
    """Raise unless the packed kernel ``name`` takes qkv (N, L, 3E) on CUDA."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"{name}: qkv must be (N, L, 3E), got {tuple(qkv.shape)}")
    e = qkv.shape[2] // 3
    if e % n_heads:
        raise ValueError(f"{name}: E={e} is not a multiple of n_heads={n_heads}")
    if e // n_heads != _HEAD_DIM:
        raise NotImplementedError(
            f"{name} is instantiated for head width {_HEAD_DIM} only, got {e // n_heads}")


def _kernel_operand(t, name: str, shape: tuple, device):
    """``t`` as a contiguous, 16-byte aligned bfloat16 tensor of ``shape`` on ``device``."""
    if tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name} must be {shape} on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_fwd(qkv, bias, n_heads: int, causal: bool, want_lse: bool = False):
    """K1 on checked operands: ``(out, lse)``, lse (N, n_heads, L) float32 —
    each row's log2-sum-exp of the scaled scores — or None unless wanted."""
    n, l, f = qkv.shape
    out = torch.empty((n, l, f // 3), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((n, n_heads, l), dtype=torch.float32, device=qkv.device)
           if want_lse else None)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = kernel_function("packed_mha_fwd", 4, 5)(
            qkv.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), n, l, n_heads, _HEAD_DIM,
            int(causal), stream)
    if err != 0:
        raise RuntimeError(f"packed_mha_fwd launch failed: cudaError {err} "
                           f"(N={n}, L={l}, n_heads={n_heads}, causal={causal})")
    fused_mha_packed.launches += 1
    return out, lse


class _PackedMHA(torch.autograd.Function):
    """K1 forward; K2 backward, or K3 when causal (``_packed_mha``'s custom
    VJP, :390-441). The forward also keeps its output and each row's
    log2-sum-exp for the backward: the output is the tensor the
    out-projection saves anyway, and the statistics are 4 bytes per row and
    head."""

    @staticmethod
    def forward(ctx, qkv, bias, n_heads: int, causal: bool):
        ctx.n_heads, ctx.causal = n_heads, causal
        out, lse = _launch_fwd(qkv, bias, n_heads, causal, want_lse=True)
        ctx.save_for_backward(qkv, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, bias, out, lse = ctx.saved_tensors
        dqkv, db = packed_mha_bwd(qkv, bias, g, out, lse, ctx.n_heads, causal=ctx.causal)
        return dqkv, db, None, None


def fused_mha_packed(qkv, n_heads: int, causal: bool = False, bias=None):
    """Fused softmax attention on packed qkv (N, L, 3E) -> (N, L, E).

    Head layout matches the torch fused-qkv Linear: columns [q | k | v],
    head-major within each. ``bias`` is the qkv Linear's bias, added inside
    the kernel.

    A CPU tensor goes through :func:`packed_mha_reference` (and autograd
    differentiates it). A CUDA tensor launches the forward kernel, or raises
    if the kernel does not take it: bfloat16, head width 64. When qkv or bias
    requires a gradient the call is differentiable, and its backward launches
    K2 or, causal, K3 (:func:`packed_mha_bwd`).
    ``fused_mha_packed.launches`` counts the forward kernel's launches.
    """
    if qkv.device.type == "cpu":
        return packed_mha_reference(qkv, n_heads, causal=causal, bias=bias)
    _check_cuda("packed_mha_fwd", qkv, n_heads)
    n, l, f = qkv.shape
    if bias is None:
        bias = torch.zeros(f, dtype=qkv.dtype, device=qkv.device)
    qkv = _kernel_operand(qkv, "qkv", (n, l, f), qkv.device)
    bias = _kernel_operand(bias.to(torch.bfloat16), "bias", (f,), qkv.device)
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return _PackedMHA.apply(qkv, bias, n_heads, causal)
    return _launch_fwd(qkv, bias, n_heads, causal)[0]


fused_mha_packed.launches = 0


def packed_mha_bwd(qkv, bias, g, out, lse, n_heads: int, causal: bool = False):
    """Gradients of :func:`fused_mha_packed` for the cotangent ``g`` (N, L, E),
    given the forward's output ``out`` (N, L, E) and its per-row log2-sum-exp
    ``lse`` (N, n_heads, L) float32: ``(dqkv, db)`` with dqkv (N, L, 3E) in
    qkv's dtype and db (3E,) in the bias's dtype (None without a bias).

    A CPU tensor goes through :func:`packed_mha_bwd_reference` (``out`` and
    ``lse`` unused). A CUDA tensor launches ``csrc/packed_mha_bwd.cu`` (K2,
    or K3 when causal: dq pass and dk/dv pass, causal over the lower triangle
    only, then a fixed-order column sum for db, so two launches on the same
    inputs give bit-identical results), or raises if the kernel does not
    take it: bfloat16 qkv, g and out, head width 64; every L.
    ``packed_mha_bwd.launches`` counts its launches.
    """
    if qkv.device.type == "cpu":
        return packed_mha_bwd_reference(qkv, bias, g, n_heads, causal=causal)
    _check_cuda("packed_mha_bwd", qkv, n_heads)
    n, l, f = qkv.shape
    if tuple(lse.shape) != (n, n_heads, l) or lse.dtype != torch.float32 \
            or lse.device != qkv.device:
        raise ValueError(f"lse must be float32 {(n, n_heads, l)} on {qkv.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    bias_k = torch.zeros(f, dtype=qkv.dtype, device=qkv.device) if bias is None else bias
    qkv = _kernel_operand(qkv, "qkv", (n, l, f), qkv.device)
    bias_k = _kernel_operand(bias_k.to(torch.bfloat16), "bias", (f,), qkv.device)
    g = _kernel_operand(g, "g", (n, l, f // 3), qkv.device)
    out = _kernel_operand(out, "out", (n, l, f // 3), qkv.device)
    dqkv = torch.empty_like(qkv)
    db = torch.empty(f, dtype=torch.float32, device=qkv.device)
    stats = torch.empty((n, n_heads, l, 2), dtype=torch.float32, device=qkv.device)
    partial = torch.empty((_DB_SEGMENTS, f), dtype=torch.float32, device=qkv.device)
    pointers = [qkv, bias_k, g, out, lse.contiguous(), dqkv, db, stats, partial]
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = kernel_function("packed_mha_bwd", len(pointers), 6)(
            *(t.data_ptr() for t in pointers), n, l, n_heads, _HEAD_DIM, _DB_SEGMENTS,
            int(causal), stream)
    if err != 0:
        raise RuntimeError(f"packed_mha_bwd launch failed: cudaError {err} "
                           f"(N={n}, L={l}, n_heads={n_heads}, causal={causal})")
    packed_mha_bwd.launches += 1
    return dqkv, None if bias is None else db.to(bias.dtype)


packed_mha_bwd.launches = 0


def multi_head_attention(x, qkv_w, qkv_b, out_w, out_b, *, n_heads: int,
                         causal: bool = False, impl: str = "auto",
                         verbose: bool = False, compute_dtype=None):
    """Full MHA: fused qkv matmul -> attention -> output projection.

    Weights are in the torch layout (out, in). Matmuls take and emit the
    compute dtype (float32 accumulation inside), biases are added in the
    compute dtype. ``verbose=True`` takes the plain path and also returns the
    (N, h, L, L) attention weights.
    """
    n, l, e = x.shape
    cd = x.dtype if compute_dtype is None else compute_dtype
    qkv = F.linear(x.to(cd), qkv_w.to(cd))

    weights = None
    resolved = "plain" if verbose else resolve_impl(impl, x.device, seq_len=l, dtype=cd)
    if resolved == "kernel":
        if cd != torch.bfloat16 or not packed_mha_supported(l, e, n_heads):
            raise NotImplementedError(
                f"attention kernel for dtype={cd}, L={l}, E={e}, n_heads={n_heads}: "
                "only the packed bfloat16 kernels at head width 64 are ported (the "
                "blocked flash kernel is not yet)")
        z = fused_mha_packed(qkv, n_heads, causal=causal,
                             bias=qkv_b.to(cd) if qkv_b is not None else None)
    else:
        if qkv_b is not None:
            qkv = qkv + qkv_b.to(cd)
        q, k, v = (_split_heads(t, n_heads) for t in qkv.chunk(3, dim=-1))
        if verbose:
            z, weights = attention_reference(q, k, v, causal=causal, return_weights=True)
        else:
            z = attention_reference(q, k, v, causal=causal)
        z = _merge_heads(z)
    out = F.linear(z, out_w.to(cd))
    if out_b is not None:
        out = out + out_b.to(cd)
    out = out.to(x.dtype)
    if verbose:
        return out, weights
    return out
