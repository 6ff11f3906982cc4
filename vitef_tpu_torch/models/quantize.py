"""Weight-only int8 quantization for decoding. Counterpart of ``vitef_tpu/models/quantize.py``.

Symmetric per-out-channel int8 (:1-30): a linear's weight is stored as int8
values and a float32 scale per output channel, ``w ≈ weight * scale``; the
product runs on the int8 values cast to the compute dtype (exact: |values|
≤ 127), accumulates in float32, and the scale multiplies its output before
the cast to the compute dtype (``Linear`` in
:mod:`~vitef_tpu_torch.models.transformer`; the MoE expert stacks in
:func:`~vitef_tpu_torch.parallel.moe._expert_matmul`). Scales are rounded up
to powers of two by default, so the scale multiply is an exponent shift that
commutes exactly with the product's sums: an int8 model computes what a
model holding the dequantized weights computes, up to where the compute
dtype rounds.

- :func:`quantize_weight_int8` (:46-68) and :func:`dequantize_weight`
  (:71-76), on any layout: ``channel_axis`` names the kept axes;
- :func:`quantize_decode_params` (:86-136) on a module's state dict, with
  the JAX package's choice of tensors: every block's qkv and output
  projections and fc1/fc2 (MoE stacks one scale per (expert, out column)),
  the token table (one scale per vocabulary row, so the tied head reads it
  too) and an untied head; norms, biases, routers and positional tables stay;
- :func:`quantize_module`, the decoding copy of a module that
  ``Model.quantize_int8`` returns: what ``generate``, ``DecodeServer`` and
  the serve command line run on;
- :func:`embed_rows` (:139-151), the token gather of both table kinds, and
  :func:`quantized_nbytes` (:154-157).

The port's linear weights are (out, in) where the JAX package's are (in,
out): the same int8 values transposed, the same scales. Inference only.
"""

from __future__ import annotations

import copy

import torch
from torch import nn


def _scale_shape(w: torch.Tensor, channel_axis) -> tuple[tuple[int, ...], tuple[int, ...]]:
    axes = (channel_axis,) if isinstance(channel_axis, int) else tuple(channel_axis)
    axes = tuple(a % w.dim() for a in axes)
    return axes, tuple(w.shape[a] if a in axes else 1 for a in range(w.dim()))


def _pow2_ceil(s: torch.Tensor) -> torch.Tensor:
    """The least power of two >= each normal positive float32 ``s``, made
    from its bits, so every device gives the same: s itself when its
    mantissa bits are 0, else its exponent raised by one and the mantissa
    cleared. The JAX package computes ``exp2(ceil(log2(s)))``, the same
    value wherever float32 log2 is exact at a power of two."""
    bits = s.view(torch.int32)
    exponent = bits & 0x7F800000
    return torch.where(bits & 0x007FFFFF == 0, exponent, exponent + (1 << 23)).view(torch.float32)


def quantize_weight_int8(w: torch.Tensor, *, channel_axis=0,
                         power_of_two_scales: bool = True) -> dict:
    """Symmetric int8 quantization of ``w``: ``{"weight": int8 like w,
    "scale": float32 shaped as the kept axes}``, ``w ≈ weight * scale``
    broadcast over the others.

    ``channel_axis`` indexes the out-feature axes that keep a scale each: 0
    for the port's (out, in) linear weights and for a (vocab, emb) token
    table, ``(0, 2)`` for the MoE (E, in, out) stacks. The scale is each
    channel's max |w| / 127 (at least 1e-12), rounded up to a power of two
    when ``power_of_two_scales``; values are rounded half to even and
    clipped to ±127.
    """
    wf = w.float()
    axes, shape = _scale_shape(wf, channel_axis)
    reduce = tuple(a for a in range(wf.dim()) if a not in axes)
    amax = wf.abs().amax(dim=reduce) if reduce else wf.abs()
    scale = (amax / 127.0).clamp_min(1e-12)
    if power_of_two_scales:
        scale = _pow2_ceil(scale)
    q = torch.round(wf / scale.reshape(shape)).clamp(-127, 127).to(torch.int8)
    return {"weight": q, "scale": scale}


def dequantize_weight(qp: dict, dtype=torch.float32, *, channel_axis=0) -> torch.Tensor:
    """``weight * scale`` materialised in ``dtype`` (checks and tests)."""
    w = qp["weight"].float()
    _, shape = _scale_shape(w, channel_axis)
    return (w * qp["scale"].reshape(shape)).to(dtype)


def decode_matrices(state: dict) -> dict[str, object]:
    """The weight matrices that decoding reads through a product or a
    gather, by state-dict name, each with its channel axes: every block's
    linears (or MoE expert stacks), the token table and an untied head, the
    tensors :func:`quantize_decode_params` quantizes."""
    names = {}
    for name, t in state.items():
        parts = name.split(".")
        if parts[0] == "blocks" and parts[-1] == "weight" and parts[-2] in (
                "qkv_mat", "output", "fc1", "fc2"):
            names[name] = (0, 2) if t.dim() == 3 else 0   # MoE stacks (E, in, out)
    for name in ("embedding.token_emb.weight", "output.output_layer.head.weight"):
        if name in state:
            names[name] = 0
    return names


def quantize_decode_params(state: dict, *, power_of_two_scales: bool = True) -> dict:
    """The state dict of a decoder for serving (:86-136): each quantized
    ``<path>.weight`` becomes int8 beside a float32 ``<path>.scale``; every
    other entry is kept as it is (the same tensor)."""
    out = dict(state)
    for name, axes in decode_matrices(state).items():
        q = quantize_weight_int8(state[name], channel_axis=axes,
                                 power_of_two_scales=power_of_two_scales)
        out[name] = q["weight"]
        out[name[:-len("weight")] + "scale"] = q["scale"]
    return out


def module_with(module: nn.Module, tensors: dict) -> nn.Module:
    """A copy of ``module`` whose state entries named in ``tensors`` are
    those tensors, as frozen parameters (a name that is new to its owner, a
    ``<path>.scale``, is added). Every other tensor, and the config object,
    is shared with ``module``, which is unchanged."""
    shared = {id(t): t for t in (*module.parameters(), *module.buffers())}
    shared.update({id(m.cfg): m.cfg for m in module.modules() if hasattr(m, "cfg")})
    out = copy.deepcopy(module, shared)
    for name, value in tensors.items():
        path, key = name.rsplit(".", 1)
        owner = out.get_submodule(path)  # a Linear, or a ParameterDict (table, expert stack)
        param = nn.Parameter(value, requires_grad=False)
        if isinstance(owner, nn.ParameterDict):
            owner[key] = param
        else:
            setattr(owner, key, param)
    return out


def quantize_module(module: nn.Module, *, power_of_two_scales: bool = True) -> nn.Module:
    """The decoding copy of ``module`` with :func:`quantize_decode_params`'
    int8 weights and scales, on the module's device; its norms, routers,
    positional tables and config are ``module``'s own (:func:`module_with`)."""
    state = module.state_dict()
    quantized = quantize_decode_params(state, power_of_two_scales=power_of_two_scales)
    return module_with(module, {name: t for name, t in quantized.items()
                                if name not in state or t is not state[name]})


def embed_rows(tok_emb, token: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Gather token-embedding rows, dequantizing int8 tables on the fly.

    ``tok_emb`` maps ``"weight"`` to the (V, E) table (full precision) or to
    an int8 (V, E) table beside a float32 ``"scale"`` (V,). The gather reads
    only the selected rows; an int8 row times its scale is formed in float32
    (exact for power-of-two scales), then cast to the compute dtype.
    """
    w = tok_emb["weight"]
    if w.dtype == torch.int8:
        rows = w[token].float() * tok_emb["scale"][token][..., None]
        return rows.to(compute_dtype)
    return w[token].to(compute_dtype)


def quantized_nbytes(module_or_state) -> int:
    """The bytes of every parameter and buffer of a module, or of every
    tensor of a state dict: what its weights take on the device."""
    tensors = (module_or_state.values() if isinstance(module_or_state, dict)
               else (*module_or_state.parameters(), *module_or_state.buffers()))
    return sum(t.numel() * t.element_size() for t in tensors)
