"""Multi-head attention: the packed-qkv CUDA kernel and its plain PyTorch versions.

Counterpart of ``vitef_tpu/ops/attention.py``:

- :func:`attention_reference` (:55-82) — softmax attention on (N, h, L, d)
  with float32 scores, optionally returning the (N, h, L, L) weights;
- :func:`packed_mha_reference` — the plain version of the packed kernel K1;
- :func:`fused_mha_packed` (:459-482) — the K1 wrapper: on a CUDA tensor it
  launches ``csrc/packed_mha_fwd.cu``, on a CPU tensor it runs
  :func:`packed_mha_reference`;
- :func:`multi_head_attention` (:701-758) — qkv projection, attention, output
  projection; it takes the kernel at :731-736 of the JAX module, under the
  :func:`packed_mha_supported` gate.

Only the forward exists so far. The kernel's causal and key-masked modes, its
backward (K2) and the blocked flash kernels (K4, K5) are not ported yet: on
CUDA those requests raise.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from .common import resolve_impl

_NEG_INF = -1e30
_HEAD_DIM = 64                 # the head width csrc/packed_mha_fwd.cu instantiates
_SMEM_OPTIN = 232_448          # bytes of shared memory a Hopper block can opt into


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


def _smem_bytes(l: int) -> int:
    # Mirrors smem_bytes() in csrc/packed_mha_fwd.cu: padded K rows, V rows,
    # and one float probability row for each of the 4 warps.
    return l * ((_HEAD_DIM + 2) * 2 + _HEAD_DIM * 2 + 4 * 4)


def packed_mha_supported(l: int, e: int, n_heads: int) -> bool:
    """Whether the packed kernel takes this geometry: head width 64 and the
    block's K, V and probability rows within Hopper's shared memory
    (L <= 842)."""
    return e % n_heads == 0 and e // n_heads == _HEAD_DIM \
        and _smem_bytes(l) <= _SMEM_OPTIN


@functools.cache
def _kernel():
    from ._build import load_library

    fn = load_library("packed_mha_fwd").packed_mha_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build_kernel() -> None:
    """Build (if needed) and load the kernel library now rather than at first use."""
    _kernel()


def fused_mha_packed(qkv, n_heads: int, causal: bool = False, bias=None):
    """Fused softmax attention on packed qkv (N, L, 3E) -> (N, L, E).

    Head layout matches the torch fused-qkv Linear: columns [q | k | v],
    head-major within each. ``bias`` is the qkv Linear's bias, added inside
    the kernel.

    A CPU tensor goes through :func:`packed_mha_reference`. A CUDA tensor
    launches the kernel, or raises if the kernel does not take it: bfloat16,
    contiguous, head width 64, L within the shared-memory budget,
    non-causal, and no gradient wanted (the backward kernel is not ported
    yet). ``fused_mha_packed.launches`` counts the kernel's launches.
    """
    if qkv.device.type == "cpu":
        return packed_mha_reference(qkv, n_heads, causal=causal, bias=bias)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_mha_packed: unsupported device {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"fused_mha_packed: qkv must be (N, L, 3E), got {tuple(qkv.shape)}")
    n, l, f = qkv.shape
    e = f // 3
    if e % n_heads:
        raise ValueError(f"fused_mha_packed: E={e} is not a multiple of n_heads={n_heads}")
    if e // n_heads != _HEAD_DIM:
        raise NotImplementedError(
            f"packed_mha_fwd is instantiated for head width {_HEAD_DIM} only, "
            f"got {e // n_heads}")
    if _smem_bytes(l) > _SMEM_OPTIN:
        raise NotImplementedError(
            f"packed_mha_fwd: L={l} needs {_smem_bytes(l)} bytes of shared "
            f"memory, over the {_SMEM_OPTIN} a block can hold")
    if causal:
        raise NotImplementedError("packed_mha_fwd: the causal mode is not ported yet")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"packed_mha_fwd takes bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("packed_mha_fwd: qkv must be contiguous")
    if torch.is_grad_enabled() and (qkv.requires_grad
                                    or (bias is not None and bias.requires_grad)):
        raise NotImplementedError("packed_mha_fwd has no backward kernel yet: "
                                  "call it under torch.no_grad or inference_mode")
    if bias is None:
        bias = torch.zeros(f, dtype=qkv.dtype, device=qkv.device)
    if bias.shape != (f,) or bias.device != qkv.device:
        raise ValueError(f"fused_mha_packed: bias must be ({f},) on {qkv.device}")
    bias = bias.to(torch.bfloat16).contiguous()
    out = torch.empty((n, l, e), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = _kernel()(qkv.data_ptr(), bias.data_ptr(), out.data_ptr(),
                        n, l, n_heads, _HEAD_DIM, stream)
    if err != 0:
        raise RuntimeError(f"packed_mha_fwd launch failed: cudaError {err} "
                           f"(N={n}, L={l}, n_heads={n_heads})")
    fused_mha_packed.launches += 1
    return out


fused_mha_packed.launches = 0


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
                "only the packed bfloat16 kernel is ported (the blocked flash "
                "kernel is not yet)")
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
