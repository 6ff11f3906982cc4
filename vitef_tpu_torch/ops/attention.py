"""Multi-head attention: the packed-qkv and flash CUDA kernels and their plain PyTorch versions.

Counterpart of ``vitef_tpu/ops/attention.py``:

- :func:`attention_reference` (:55-82) — softmax attention on (N, h, L, d)
  with float32 scores, optionally returning the (N, h, L, L) weights; it is
  also the plain version of the flash kernel K4;
- :func:`packed_mha_reference` — the plain version of the packed kernel K1,
  with the key mask of its serving mode;
- :func:`packed_mha_bwd_reference` — the plain version of its backward, K2
  (``_packed_mha_bwd_kernel`` :270-342) and, causal, K3
  (``_packed_mha_bwd_causal_blocked_kernel`` :181-267), in float32;
- :func:`fused_mha_packed` (:459-482) — the K1 wrapper: on a CUDA tensor it
  launches ``csrc/packed_mha_fwd.cu`` (non-causal or causal, any L), and when
  a gradient is wanted it runs under a ``torch.autograd.Function`` whose
  backward is :func:`packed_mha_bwd` (``csrc/packed_mha_bwd.cu``: K2, or K3
  when causal, any L), as ``_packed_mha``'s custom VJP (:390-441) does; on a
  CPU tensor it runs :func:`packed_mha_reference`, and autograd
  differentiates that. With ``key_mask`` (the ragged serving prefill,
  :459-479) it launches the kernel's key-masked mode, forward only;
- :func:`packed_mha_supported` (:443-456) — the packed kernels' gate: a head
  width K1, K2 and K3 are instantiated for (8, 64, 80, 128) and the JAX
  package's byte budget;
- :func:`flash_attention` (:680-698) — the K4 wrapper on (N, h, L, d): on a
  CUDA tensor it launches ``csrc/flash_fwd.cu`` (bfloat16 or float32, causal
  or not, any L: it masks by index where the JAX version pads L to its
  blocks and masks with ``kv_len``), and when a gradient is wanted it runs
  under :class:`_Flash`, whose backward is :func:`flash_bwd`
  (``csrc/flash_bwd.cu``, K5), as ``_flash``'s custom VJP (:578-677) does
  (head width 64 or 128 in bfloat16, 8, 64 or 128 in float32); on
  a CPU tensor it runs :func:`attention_reference`. The JAX backward takes
  its kernel only while two (h, L, L) float32 tensors fit a 10 MiB budget,
  and above it differentiates an XLA recompute of ``attention_reference``
  (:668-674; Llama-1B at L=1024 needs 256 MiB). Both compute the same
  gradient, and K5 serves every L, so no plain version sits on the path;
- :func:`flash_bwd_reference` — the plain version of K5, in float32;
- :func:`attention_route` — which of the three the JAX package's
  ``multi_head_attention`` (:726-748) and ``_attention_modern``
  (``models/transformer.py:493-538``) take for a geometry;
- :func:`multi_head_attention` (:701-758) — qkv projection, attention, output
  projection.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ._build import kernel_function
from .common import resolve_impl

_NEG_INF = -1e30
_PACKED_FWD_HEAD_DIMS = (8, 64, 80, 128)  # the head widths csrc/packed_mha_fwd.cu instantiates
_PACKED_BWD_HEAD_DIMS = (8, 64, 80, 128)  # and csrc/packed_mha_bwd.cu, every mode of each
# The head widths csrc/flash_*.cu instantiate, by dtype: bfloat16 on the
# bf16 tensor-core tiles, float32 in split TF32 (kAttnF32WidthOk).
_FLASH_HEAD_DIMS = {torch.bfloat16: (64, 128), torch.float32: (8, 64, 128)}


def attention_reference(q, k, v, *, causal: bool = False, kv_len: int | None = None,
                        key_mask=None, return_weights: bool = False):
    """Softmax attention on (N, h, L, d) tensors with float32 scores and softmax.

    ``kv_len`` masks out padded key positions (keys with index >= kv_len);
    ``key_mask`` (N, L) bool masks each sequence's invalid keys. A masked
    score is the finite -1e30.
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
    if key_mask is not None:
        scores = scores.masked_fill(~key_mask.bool()[:, None, None, :], _NEG_INF)
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


def packed_mha_reference(qkv, n_heads: int, causal: bool = False, bias=None,
                         key_mask=None):
    """Plain version of K1: softmax attention on packed qkv (N, L, 3E) -> (N, L, E).

    Columns are [q | k | v], head-major within each. ``bias`` (3E,) is added
    in the input dtype first, as the TPU kernel does. ``key_mask`` (N, L)
    bool marks each sequence's valid keys; a masked key's float32 score is
    set to the finite -1e30, so a query row that sees no valid key reads a
    finite average of values, which the kernel defines otherwise (see
    :func:`fused_mha_packed`).
    """
    if bias is not None:
        qkv = qkv + bias.to(qkv.dtype)
    q, k, v = (_split_heads(t, n_heads) for t in qkv.chunk(3, dim=-1))
    return _merge_heads(attention_reference(q, k, v, causal=causal, key_mask=key_mask))


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


# The JAX package's budget for the packed kernels (``_PACKED_VMEM_BUDGET``,
# vitef_tpu/ops/attention.py:443-456): the (L, 3E) qkv slab and its gradient
# copy, and three (L, L) float32 score matrices, per program.
_PACKED_BUDGET = 40 * 1024 * 1024


def packed_mha_supported(l: int, e: int, n_heads: int) -> bool:
    """Whether bfloat16 attention takes the packed kernels for this geometry:
    a head width K1, K2 and K3 are instantiated for, 8 (PatchTST), 64, 80
    (ViT-H/14) or 128 (Llama-3.1-8B), each in every mode (they tile over keys and take
    every L, causal or not), and the JAX package's budget
    ``2·(4·E·L·2) + 3·L²·4 <= 40 MiB``, so that both packages take the same
    branch. Past the budget (Llama-1B, E=2048 at L=1024: 46.1 MB;
    Llama-3.1-8B, E=4096, from L=579) attention takes the flash kernels K4
    and K5, and the serving prefill the grouped einsum. The JAX gate checks
    the budget only; at another head width (96) the port takes the flash
    route, whose kernels raise for any width but 64 and 128."""
    return (l > 0 and e % n_heads == 0 and e // n_heads in _PACKED_FWD_HEAD_DIMS
            and 2 * (4 * e * l * 2) + 3 * l * l * 4 <= _PACKED_BUDGET)


def _check_cuda(name: str, qkv, n_heads: int, head_dims: tuple):
    """Raise unless the packed kernel ``name``, instantiated at ``head_dims``,
    takes qkv (N, L, 3E) on CUDA: the shape and the width first, then the
    device."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"{name}: qkv must be (N, L, 3E), got {tuple(qkv.shape)}")
    e = qkv.shape[2] // 3
    if e % n_heads:
        raise ValueError(f"{name}: E={e} is not a multiple of n_heads={n_heads}")
    if e // n_heads not in head_dims:
        raise NotImplementedError(
            f"{name} is instantiated for head widths {head_dims}, got {e // n_heads}")
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qkv.device}")


def _kernel_operand(t, name: str, shape: tuple, device):
    """``t`` as a contiguous, 16-byte aligned bfloat16 tensor of ``shape`` on ``device``."""
    if tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name} must be {shape} on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_fwd(qkv, bias, n_heads: int, causal: bool, want_lse: bool = False,
                key_mask=None):
    """K1 on checked operands: ``(out, lse)``, lse (N, n_heads, L) float32 —
    each row's log2-sum-exp of the scaled scores — or None unless wanted.
    ``key_mask``, a contiguous (N, L) uint8 tensor, launches the masked mode."""
    n, l, f = qkv.shape
    out = torch.empty((n, l, f // 3), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((n, n_heads, l), dtype=torch.float32, device=qkv.device)
           if want_lse else None)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = kernel_function("packed_mha_fwd", 5, 5)(
            qkv.data_ptr(), bias.data_ptr(), None if key_mask is None else key_mask.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), n, l, n_heads,
            f // 3 // n_heads, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"packed_mha_fwd launch failed: cudaError {err} "
                           f"(N={n}, L={l}, n_heads={n_heads}, causal={causal}, "
                           f"masked={key_mask is not None})")
    if key_mask is None:
        fused_mha_packed.launches += 1
    else:
        fused_mha_packed.masked_launches += 1
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


def fused_mha_packed(qkv, n_heads: int, causal: bool = False, bias=None, key_mask=None):
    """Fused softmax attention on packed qkv (N, L, 3E) -> (N, L, E).

    Head layout matches the torch fused-qkv Linear: columns [q | k | v],
    head-major within each. ``bias`` is the qkv Linear's bias, added inside
    the kernel.

    A CPU tensor goes through :func:`packed_mha_reference` (and autograd
    differentiates it). A CUDA tensor launches the forward kernel, or raises
    if the kernel does not take it: bfloat16, head width 8, 64, 80 or 128. When
    qkv or bias requires a gradient the call is differentiable, and its
    backward launches K2 or, causal, K3 (:func:`packed_mha_bwd`), at the
    same widths.

    ``key_mask`` (N, L) bool marks each sequence's valid keys (False: the
    left padding of a ragged serving batch). It is forward only, as in the
    JAX package: the call raises when a gradient is wanted, and for a mask of
    another shape. A masked key's scaled score is the finite -1e30, never
    -inf, so a query row that sees no valid key stays finite: it reads an
    average of the values of the keys it may see. Which average is not
    defined (the kernel, its plain version and the TPU kernel's two branches
    each take their own); no real row of a left-padded batch reads such a
    row, and comparisons hold only rows with a valid visible key.

    ``fused_mha_packed.launches`` counts the unmasked forward kernel's
    launches, ``fused_mha_packed.masked_launches`` the masked mode's.
    """
    wants_grad = torch.is_grad_enabled() and (qkv.requires_grad
                                              or (bias is not None and bias.requires_grad))
    if key_mask is not None:
        if tuple(key_mask.shape) != tuple(qkv.shape[:2]) or key_mask.device != qkv.device:
            raise ValueError(f"key_mask must be {tuple(qkv.shape[:2])} on {qkv.device}, got "
                             f"{tuple(key_mask.shape)} on {key_mask.device}")
        if wants_grad:
            raise NotImplementedError("the key-masked packed attention is forward only")
    if qkv.device.type == "cpu":
        return packed_mha_reference(qkv, n_heads, causal=causal, bias=bias, key_mask=key_mask)
    _check_cuda("packed_mha_fwd", qkv, n_heads, _PACKED_FWD_HEAD_DIMS)
    n, l, f = qkv.shape
    if bias is None:
        bias = torch.zeros(f, dtype=qkv.dtype, device=qkv.device)
    qkv = _kernel_operand(qkv, "qkv", (n, l, f), qkv.device)
    bias = _kernel_operand(bias.to(torch.bfloat16), "bias", (f,), qkv.device)
    if key_mask is not None:
        mask = key_mask.to(torch.bool).contiguous().view(torch.uint8)
        return _launch_fwd(qkv, bias, n_heads, causal, key_mask=mask)[0]
    if wants_grad:
        return _PackedMHA.apply(qkv, bias, n_heads, causal)
    return _launch_fwd(qkv, bias, n_heads, causal)[0]


fused_mha_packed.launches = 0
fused_mha_packed.masked_launches = 0


def packed_mha_bwd(qkv, bias, g, out, lse, n_heads: int, causal: bool = False):
    """Gradients of :func:`fused_mha_packed` for the cotangent ``g`` (N, L, E),
    given the forward's output ``out`` (N, L, E) and its per-row log2-sum-exp
    ``lse`` (N, n_heads, L) float32: ``(dqkv, db)`` with dqkv (N, L, 3E) in
    qkv's dtype and db (3E,) in the bias's dtype (None without a bias).

    A CPU tensor goes through :func:`packed_mha_bwd_reference` (``out`` and
    ``lse`` unused). A CUDA tensor launches ``csrc/packed_mha_bwd.cu`` (K2,
    or K3 when causal: a dq pass and a dk/dv pass whose five products run on
    the tensor cores, causal over the lower triangle only, then a
    fixed-order column sum for db, so two launches on the same inputs give
    bit-identical results), or raises if the kernel does not take it:
    bfloat16 qkv, g and out, head width 8, 64, 80 or 128; every L. The kernel rounds P and
    dS to bfloat16 before their products, as the TPU kernel rounds them; the
    plain version keeps them in float32.
    ``packed_mha_bwd.launches`` counts its launches.
    """
    if qkv.device.type == "cpu":
        return packed_mha_bwd_reference(qkv, bias, g, n_heads, causal=causal)
    _check_cuda("packed_mha_bwd", qkv, n_heads, _PACKED_BWD_HEAD_DIMS)
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
            *(t.data_ptr() for t in pointers), n, l, n_heads, f // 3 // n_heads,
            _DB_SEGMENTS, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"packed_mha_bwd launch failed: cudaError {err} "
                           f"(N={n}, L={l}, n_heads={n_heads}, causal={causal})")
    packed_mha_bwd.launches += 1
    return dqkv, None if bias is None else db.to(bias.dtype)


packed_mha_bwd.launches = 0


def flash_bwd_reference(q, k, v, g, causal: bool = False):
    """Plain version of K5: the gradients ``(dq, dk, dv)`` of
    :func:`attention_reference` on (N, h, L, d) for the cotangent ``g``.

    The algebra of ``_flash_bwd_kernel`` (:604-638) written out in float32:
    the softmax recomputed from q and k, ``dv = pᵀg``, ``dp = g vᵀ``,
    ``ds = p (dp - rowsum(p dp)) / √d``, ``dq = ds k``, ``dk = dsᵀ q``; each
    gradient is returned in its input's dtype.
    """
    l, d = q.shape[2], q.shape[3]
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    scale = 1.0 / math.sqrt(d)
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        scores = scores.masked_fill(torch.ones(l, l, dtype=torch.bool, device=q.device)
                                    .triu(1), _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True)) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_FLASH_DTYPES = (torch.bfloat16, torch.float32)


def _flash_operands(name: str, *tensors):
    """Check that the flash kernel ``name`` takes ``tensors``: one shape
    (N, h, L, d) and one dtype, bfloat16 at d = 64 or 128 or float32 at
    d = 8, 64 or 128, then CUDA; return them contiguous and 16-byte
    aligned."""
    first = tensors[0]
    if first.dim() != 4:
        raise ValueError(f"{name}: tensors must be (N, h, L, d), got {tuple(first.shape)}")
    if first.dtype not in _FLASH_DTYPES:
        raise TypeError(f"{name}: dtype must be bfloat16 or float32, got {first.dtype}")
    for t in tensors:
        if t.shape != first.shape or t.dtype != first.dtype or t.device != first.device:
            raise ValueError(f"{name}: operands must share shape, dtype and device, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device} beside "
                             f"{tuple(first.shape)} {first.dtype} {first.device}")
    widths = _FLASH_HEAD_DIMS[first.dtype]
    if first.shape[3] not in widths:
        raise NotImplementedError(f"{name} is instantiated for head widths {widths} in "
                                  f"{first.dtype}, got {first.shape[3]}")
    if first.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {first.device}")
    out = []
    for t in tensors:
        t = t.contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return out


def _launch_flash_fwd(q, k, v, causal: bool, want_lse: bool = False):
    """K4 on checked operands: ``(out, lse)``, lse (N, h, L) float32 — each
    row's log2-sum-exp of the scaled scores — or None unless wanted."""
    n, h, l, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((n, h, l), dtype=torch.float32, device=q.device) if want_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = kernel_function("flash_fwd", 5, 6)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), n, h, l, d,
            int(q.dtype == torch.float32), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err} "
                           f"(N={n}, h={h}, L={l}, {q.dtype}, causal={causal})")
    flash_attention.launches += 1
    return out, lse


class _Flash(torch.autograd.Function):
    """K4 forward, K5 backward (``_flash``'s custom VJP, :578-677). The
    forward keeps its output and each row's log2-sum-exp (4 bytes per row and
    head) for the backward, which rebuilds P from them tile by tile."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.causal = causal
        out, lse = _launch_flash_fwd(q, k, v, causal, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, g, out, lse, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = False, impl: str = "auto"):
    """Flash attention on (N, h, L, d) -> (N, h, L, d), at any L.

    ``impl`` resolves as the JAX version's does (``resolve_impl`` with the
    sequence length only); ``"plain"`` runs :func:`attention_reference`. The
    kernel route on a CPU tensor runs :func:`attention_reference` too (and
    autograd differentiates it). A CUDA tensor launches K4, or raises if the
    kernel does not take it: q, k and v of one shape and dtype, bfloat16 at
    head width 64 or 128, or float32 at 8, 64 or 128. Both types multiply on the
    tensor cores, float32 in split TF32 (three TF32 products per float32
    product), which keeps float32's accuracy. When a gradient is wanted the call runs under
    :class:`_Flash`, whose backward launches K5 (:func:`flash_bwd`).
    ``flash_attention.launches`` counts K4's launches.
    """
    resolved = resolve_impl(impl, q.device, seq_len=q.shape[2])
    if resolved == "plain" or q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal)
    q, k, v = _flash_operands("flash_fwd", q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Flash.apply(q, k, v, causal)
    return _launch_flash_fwd(q, k, v, causal)[0]


flash_attention.launches = 0


def flash_bwd(q, k, v, g, out, lse, causal: bool = False):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention` for the cotangent
    ``g``, given the forward's output ``out`` and its per-row log2-sum-exp
    ``lse`` (N, h, L) float32; all others are (N, h, L, d).

    A CPU tensor goes through :func:`flash_bwd_reference` (``out`` and
    ``lse`` unused). A CUDA tensor launches ``csrc/flash_bwd.cu`` (a dq pass
    over query tiles and a dK/dV pass over key tiles, causal over the lower
    triangle only, no atomics: two launches on the same inputs give
    bit-identical results), or raises if the kernel does not take it: every
    operand of one shape and dtype, bfloat16 at head width 64 or 128, or
    float32 at 8, 64 or 128; every L. Both types run on the tensor cores: bfloat16
    rounds P and dS to bfloat16 before their products, as the TPU kernel
    rounds them; float32
    runs every product in split TF32 (three TF32 products per float32
    product, P and dS kept in float32), each tile's products summed in
    registers and added to the running sums in float32.
    ``flash_bwd.launches`` counts its launches.
    """
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, g, causal=causal)
    q, k, v, g, out = _flash_operands("flash_bwd", q, k, v, g, out)
    n, h, l, d = q.shape
    if tuple(lse.shape) != (n, h, l) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be float32 {(n, h, l)} on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty((n, h, l, 2), dtype=torch.float32, device=q.device)
    pointers = [q, k, v, g, out, lse.contiguous(), dq, dk, dv, stats]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = kernel_function("flash_bwd", len(pointers), 6)(
            *(t.data_ptr() for t in pointers), n, h, l, d,
            int(q.dtype == torch.float32), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd launch failed: cudaError {err} "
                           f"(N={n}, h={h}, L={l}, {q.dtype}, causal={causal})")
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0


def attention_route(impl: str, device, *, seq_len: int, emb_dim: int, n_heads: int,
                    dtype: torch.dtype, grouped: bool = False) -> str:
    """The attention path for one geometry: ``"packed"`` (K1, with K2 or K3
    as its backward), ``"flash"`` (K4, with K5) or ``"plain"``.

    The JAX package's branches: ``impl`` resolves with :func:`resolve_impl`;
    the kernel route takes the packed kernels for bfloat16 inside
    :func:`packed_mha_supported`, and otherwise the flash kernels — in
    ``multi_head_attention`` (:726-748) for any dtype (float32 at L >= 512,
    bfloat16 past the gate), in the GQA/RoPE ``_attention_modern``
    (``grouped=True``, ``models/transformer.py:493-538``) for bfloat16 only,
    its float32 taking the plain grouped einsum.
    """
    if resolve_impl(impl, device, seq_len=seq_len, dtype=dtype) != "kernel":
        return "plain"
    if dtype == torch.bfloat16 and packed_mha_supported(seq_len, emb_dim, n_heads):
        return "packed"
    if grouped and dtype != torch.bfloat16:
        return "plain"
    return "flash"


def multi_head_attention(x, qkv_w, qkv_b, out_w, out_b, *, n_heads: int,
                         causal: bool = False, impl: str = "auto",
                         verbose: bool = False, compute_dtype=None):
    """Full MHA: fused qkv matmul -> attention -> output projection.

    Weights are in the torch layout (out, in). Matmuls take and emit the
    compute dtype (float32 accumulation inside), biases are added in the
    compute dtype. The attention is the one :func:`attention_route` picks:
    K1 for bfloat16 inside the packed gate, else K4 (float32 at L >= 512,
    bfloat16 past the gate), else the plain version. ``verbose=True`` takes
    the plain path and also returns the (N, h, L, L) attention weights.
    """
    n, l = x.shape[:2]
    e = qkv_w.shape[0] // 3  # the attention width (a rank's heads under tensor parallelism)
    cd = x.dtype if compute_dtype is None else compute_dtype
    qkv = F.linear(x.to(cd), qkv_w.to(cd))

    weights = None
    route = "plain" if verbose else attention_route(impl, x.device, seq_len=l, emb_dim=e,
                                                    n_heads=n_heads, dtype=cd)
    if route == "packed":
        z = fused_mha_packed(qkv, n_heads, causal=causal,
                             bias=qkv_b.to(cd) if qkv_b is not None else None)
    else:
        if qkv_b is not None:
            qkv = qkv + qkv_b.to(cd)
        q, k, v = (_split_heads(t, n_heads) for t in qkv.chunk(3, dim=-1))
        if verbose:
            z, weights = attention_reference(q, k, v, causal=causal, return_weights=True)
        elif route == "flash":
            z = flash_attention(q, k, v, causal=causal, impl="kernel")
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
