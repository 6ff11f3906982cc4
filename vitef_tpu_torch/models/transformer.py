"""Encoder transformer as ``nn.Module``s. Counterpart of ``vitef_tpu/models/transformer.py``.

:class:`TransformerConfig` has the JAX package's field names and
``__post_init__`` derivations (:58-236), so one config dict builds both
packages. The modules (:426-843) keep the JAX package's parameter names, so
``blocks.0.attn.qkv_mat.weight`` names the same tensor in both, and its
numerics:

- linear weights are stored in the torch layout (out, in) and in float32;
  each matmul casts them to the compute dtype, and its output and bias add
  are in the compute dtype. A decoding copy may hold them as int8 with a
  float32 scale per output channel (``models/quantize.py``), whose product
  is the JAX ``_linear``'s int8 branch (:408-413);
- the residual stream is in the compute dtype (bfloat16 on the card);
- hybrid image patching replaces the token embedding by the identity, the
  cls token is prepended, then ``pos_emb[:, :l]`` is added;
- without patching, tokens are gathered from the ``dict`` embedding table
  cast to the compute dtype (:442-447);
- 'gelu' is the exact erf in float32 and the tanh approximation in bfloat16;
- classification reads the CLS token and returns float32 logits;
  sequence-to-sequence applies the final norm, then the tied head (the token
  embedding, float32 logits, :747-760) or the untied one.

Ported: the ViT geometry (computer-vision hybrid patching, learned absolute
positions, multi-head attention, mlp FFN, layer norm, classification head),
the GPT-2 geometry (``dict`` token embedding, causal attention,
sequence-to-sequence head, ``forward(x, return_hidden=True)`` for the fused
head loss), the Llama geometry (grouped-query attention, rotary
positions, swiglu FFN, rms norm, untied head) and the MoE family's FFN
(``n_experts`` > 0: every block's FFN is
:class:`~vitef_tpu_torch.parallel.moe.MoEFeedForward`, ``apply_ffn``
:610-641, and ``forward(x, return_moe_aux=True)`` also returns the per-block
mean of the router's aux losses, :782-840), forward, and backward through
autograd; and the paper's read-outs, ``get_decomposition`` and ``get_probes``
(:851-938). ``norm_impl`` reaches every LayerNorm, which takes kernel K6 for
``"kernel"`` on CUDA. The other options of the config raise
``NotImplementedError``.
Dropout is not ported: a module in train mode with any dropout rate above 0
raises ``NotImplementedError`` rather than train without it (ViT's, GPT-2's
and Llama's rates are all 0, ``vitef_tpu/models/vit.py:96-111``,
``gpt2.py:52-82``, ``llama.py:75-99``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (attention_route, flash_attention, fused_mha_packed,
                             multi_head_attention)
from ..ops.common import mm_f32
from .norms import build_norm
from .patching import extract_patches_chw, image_patch_dims
from .rope import apply_rope, rope_angles

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class TransformerConfig:
    """The JAX package's TransformerConfig: same fields, same derivations."""

    # Data parameters
    image_dim: tuple = (3, 224, 224)
    length: int = 512

    # Patching parameters
    patch_type: str | None = None  # None | computer_vision | time_series
    image_patch: str = "hybrid"  # raw | hybrid
    patch_size: int = 16
    stride: int = 8

    # Embedding parameters
    vocab_size: int = -1
    emb_type: str = "dict"  # dict | linear
    emb_dim: int = -1
    pos_emb: bool = True
    freeze_pos: bool = False
    seq_len: int = -1
    emb_dropout: float | None = None

    # Attention parameters
    n_heads: int = -1
    attn_bias: bool = False
    attn_dropout: float | None = None
    flash: bool = True  # use the fused kernel path (verbose takes the plain one)
    causal: bool = False
    n_kv_heads: int = -1
    pos_emb_type: str = "learned"
    rope_theta: float = 10000.0

    # Feed-forward parameters
    activation: str = "gelu"
    ffn_dim: int | None = None
    ffn_bias: bool = False
    ffn_dropout: float | None = None
    ffn_type: str = "mlp"
    n_experts: int = 0
    moe_top_k: int = 2
    moe_lb_coef: float = 0.0
    moe_z_coef: float = 0.0

    # Transformer block parameters
    norm: str = "layer"  # batch | layer | rms
    norm_bias: bool = False
    norm_eps: float = 1e-5
    pre_norm: bool = True

    # Transformer parameters
    n_layers: int = -1
    dropout: float = 0.0

    # Task-specific parameters
    cls_token: bool = False
    output_type: str = "sequence_to_sequence"
    weight_tying: bool = True
    output_dropout: float | None = None
    n_classes: int = -1
    forecasting_horizon: int = -1

    # Execution knobs
    compute_dtype: str = "float32"  # activation dtype: float32 | bfloat16
    attn_impl: str = "auto"  # auto | kernel | plain (or the JAX names pallas | xla)
    norm_impl: str = "auto"
    moe_impl: str = "auto"
    moe_capacity_factor: float | None = None
    remat: bool = False

    # Derived (filled in __post_init__)
    n_patches: int = field(default=-1)
    patch_dim: int = field(default=-1)

    def __post_init__(self):
        if self.ffn_dim is None:
            self.ffn_dim = 4 * self.emb_dim
        for name in ("emb_dropout", "attn_dropout", "ffn_dropout", "output_dropout"):
            if getattr(self, name) is None:
                setattr(self, name, self.dropout)
        if isinstance(self.image_dim, list):
            self.image_dim = tuple(self.image_dim)
        if self.patch_type:
            pt = self.patch_type.lower()
            if pt == "computer_vision":
                self.n_patches, self.patch_dim = image_patch_dims(
                    self.image_dim, self.patch_size)
            elif pt == "time_series":
                self.n_patches = (self.length - self.patch_size) // self.stride + 2
                self.patch_dim = self.patch_size
            else:
                raise ValueError(f"Unknown patch_type {self.patch_type!r}")
            self.seq_len = self.n_patches
            self.vocab_size = self.patch_dim
        if self.cls_token:
            self.seq_len = self.seq_len + 1
        if self.emb_dim > 0 and self.n_heads > 0:
            assert self.emb_dim % self.n_heads == 0, (
                "Embedding dimension must be divisible by number of heads.")
        if self.n_kv_heads < 0:
            self.n_kv_heads = self.n_heads
        if self.n_heads > 0:
            assert self.n_heads % self.n_kv_heads == 0, (
                "n_heads must be a multiple of n_kv_heads (GQA groups)")
        pe = self.pos_emb_type.lower()
        if pe not in ("learned", "rope"):
            raise ValueError(f"Unknown pos_emb_type {self.pos_emb_type!r}")
        if pe == "rope":
            self.pos_emb = False
        if self.ffn_type.lower() not in ("mlp", "swiglu"):
            raise ValueError(f"Unknown ffn_type {self.ffn_type!r}")
        if self.n_experts:
            if self.n_experts < 0:
                raise ValueError("n_experts must be >= 0")
            if not 0 < self.moe_top_k <= self.n_experts:
                raise ValueError("moe_top_k must be in [1, n_experts]")

    @property
    def uses_rope(self) -> bool:
        return self.pos_emb_type.lower() == "rope"

    @property
    def uses_gqa(self) -> bool:
        return self.n_kv_heads not in (-1, self.n_heads)

    @property
    def head_dim(self) -> int:
        return self.emb_dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        """Total K (== V) projection width: n_kv_heads * head_dim."""
        return self.n_kv_heads * self.head_dim

    @property
    def hybrid_identity_emb(self) -> bool:
        """Hybrid CV patching replaces token_emb by identity."""
        return bool(self.patch_type
                    and self.patch_type.lower() == "computer_vision"
                    and self.image_patch.lower() == "hybrid")

    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


def _check_ported(cfg: TransformerConfig) -> None:
    """Raise for the options whose modules are not ported yet."""
    unported = {
        "patching other than computer_vision hybrid":
            bool(cfg.patch_type) and not cfg.hybrid_identity_emb,
        f"emb_type={cfg.emb_type!r} token embedding":
            not cfg.patch_type and cfg.emb_type.lower() != "dict",
        f"output_type={cfg.output_type!r}":
            cfg.output_type.lower() not in ("classification", "sequence_to_sequence"),
        "remat": cfg.remat,
    }
    missing = [name for name, hit in unported.items() if hit]
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")


_DROPOUTS = ("emb_dropout", "attn_dropout", "ffn_dropout", "output_dropout")


def _check_no_dropout(cfg: TransformerConfig) -> None:
    """Raise in train mode for any dropout rate > 0: dropout is not ported."""
    rates = {name: getattr(cfg, name) for name in _DROPOUTS if getattr(cfg, name) > 0}
    if rates:
        raise NotImplementedError(f"dropout is not ported yet; train mode with {rates}")


# ---------------------------------------------------------------------------
# Layers. Init follows torch defaults: Linear U(±1/√fan_in), cls/pos N(0, 1),
# norms ones/zeros; every draw comes from the generator passed in, on the CPU,
# so a seed gives the same weights on every device.
# ---------------------------------------------------------------------------


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class Linear(nn.Module):
    """Linear layer: float32 ``weight`` (out, in) and ``bias`` (out,), applied in
    the compute dtype: the product's output is in the compute dtype (float32
    accumulation inside), as the JAX einsum with
    ``preferred_element_type=compute_dtype``.

    An int8 ``weight`` beside a float32 ``scale`` (out,) (the decoding copy
    of :func:`~vitef_tpu_torch.models.quantize.quantize_module`) is the JAX
    package's int8 linear: the int8 values cast to the compute dtype (exact),
    the product accumulated and returned in float32, times the scale, then
    cast to the compute dtype."""

    def __init__(self, fan_in: int, fan_out: int, bias: bool, *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = nn.Parameter(_uniform((fan_out, fan_in), bound, generator).to(device))
        self.bias = (nn.Parameter(_uniform((fan_out,), bound, generator).to(device))
                     if bias else None)

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
        if self.weight.dtype == torch.int8:
            flat = x.to(compute_dtype).reshape(-1, x.shape[-1])
            out = mm_f32(flat, self.weight.to(compute_dtype).t()) * self.scale
            out = out.to(compute_dtype).reshape(*x.shape[:-1], -1)
        else:
            out = F.linear(x.to(compute_dtype), self.weight.to(compute_dtype))
        if self.bias is not None:
            out = out + self.bias.to(compute_dtype)
        return out


def _gelu_dtype_aware(x):
    """Exact erf gelu in float32 (parity paths), tanh approximation in bfloat16."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


_ACTIVATIONS = {
    "gelu": _gelu_dtype_aware,
    "gelu_exact": lambda x: F.gelu(x, approximate="none"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "leaky_relu": F.leaky_relu,
    "elu": F.elu,
    "softplus": F.softplus,
}


def get_activation(name: str):
    fn = _ACTIVATIONS.get(name.lower())
    if fn is None:
        raise ValueError(f"Unknown activation function {name!r}")
    return fn


class Embedding(nn.Module):
    """Patch (or token table) -> cls prepend -> + pos_emb.

    Hybrid image patching replaces the token embedding by the identity;
    without patching, ``token_emb["weight"]`` (V, E) is the ``dict`` table,
    drawn from N(0, 1) as ``nn.Embedding`` is."""

    def __init__(self, cfg: TransformerConfig, *, device, generator):
        super().__init__()
        self.cfg = cfg
        e = cfg.emb_dim
        self.patching = self.token_emb = None
        if cfg.hybrid_identity_emb:
            fan_in = cfg.image_dim[0] * cfg.patch_size**2
            self.patching = nn.ModuleDict(
                {"conv": Linear(fan_in, e, True, device=device, generator=generator)})
        else:
            self.token_emb = nn.ParameterDict({"weight": nn.Parameter(
                torch.randn((cfg.vocab_size, e), generator=generator).to(device))})
        self.cls_token = (nn.Parameter(torch.randn((1, 1, e), generator=generator).to(device))
                          if cfg.cls_token else None)
        self.pos_emb = (nn.Parameter(
            torch.randn((1, cfg.seq_len, e), generator=generator).to(device))
            if cfg.pos_emb else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.cfg.cdtype()
        if self.patching is not None:
            out = self.patching["conv"](extract_patches_chw(x.to(cd), self.cfg.patch_size), cd)
        else:
            out = F.embedding(x, self.token_emb["weight"].to(cd))
        if self.cls_token is not None:
            cls = self.cls_token.to(cd).expand(out.shape[0], 1, -1)
            out = torch.cat([cls, out], dim=1)
        if self.pos_emb is not None:
            out = out + self.pos_emb[:, :out.shape[1]].to(cd)
        return out


def split_qkv(cfg: TransformerConfig, qkv: torch.Tensor):
    """Split the packed projection (..., E + 2*kv_dim) into (q, k, v) (:462-465)."""
    e, kvd = cfg.emb_dim, cfg.kv_dim
    return qkv[..., :e], qkv[..., e:e + kvd], qkv[..., e + kvd:]


class Attention(nn.Module):
    """Fused-qkv attention + output projection: multi-head attention
    (:func:`~vitef_tpu_torch.ops.attention.multi_head_attention`), or, with
    grouped-query heads or rotary positions, :meth:`_modern`. qkv packs
    [q (E) | k (kv_dim) | v (kv_dim)]."""

    def __init__(self, cfg: TransformerConfig, *, device, generator):
        super().__init__()
        self.cfg = cfg
        e = cfg.emb_dim
        self.qkv_mat = Linear(e, e + 2 * cfg.kv_dim, cfg.attn_bias, device=device,
                              generator=generator)
        self.output = Linear(e, e, cfg.attn_bias, device=device, generator=generator)

    def forward(self, x: torch.Tensor, verbose: bool = False):
        cfg = self.cfg
        impl = cfg.attn_impl if cfg.flash else "plain"
        if cfg.uses_gqa or cfg.uses_rope:
            return self._modern(x, impl, verbose)
        return multi_head_attention(
            x, self.qkv_mat.weight, self.qkv_mat.bias,
            self.output.weight, self.output.bias,
            n_heads=cfg.n_heads, causal=cfg.causal, impl=impl,
            verbose=verbose, compute_dtype=cfg.cdtype())

    def _modern(self, x: torch.Tensor, impl: str, verbose: bool):
        """GQA / RoPE attention: ``_attention_modern`` (:468-562), its three
        branches chosen by :func:`~vitef_tpu_torch.ops.attention.attention_route`:

        - ``"packed"`` (bfloat16 inside the packed gate): q and k rotated in
          the packed layout, each k/v head repeated over its query group,
          then K1 on the re-packed [q | k | v];
        - ``"flash"`` (bfloat16 past the gate, Llama-1B at L=1024): heads
          split to (N, h, L, d), q and k rotated, k/v repeated over the
          groups, then K4;
        - ``"plain"``: the grouped einsum, each k/v head serving its query
          group without a repeat, float32 scores.

        A repeat is a broadcast, so autograd sums each group's dk and dv back
        onto the shared head.
        """
        cfg = self.cfg
        cd = cfg.cdtype()
        n, l, e = x.shape
        h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q, k, v = split_qkv(cfg, self.qkv_mat(x, cd))
        cos = sin = None
        if cfg.uses_rope:
            cos, sin = rope_angles(torch.arange(l, device=x.device), d, cfg.rope_theta)
        route = "plain" if verbose else attention_route(impl, x.device, seq_len=l, emb_dim=e,
                                                        n_heads=h, dtype=cd, grouped=True)

        if route == "packed":
            if cfg.uses_rope:  # rotate in the packed head-major layout
                cs = (cos[:, None], sin[:, None])  # (L, 1, d/2) over (N, L, heads, d)
                q = apply_rope(q.reshape(n, l, h, d), *cs).reshape(n, l, e)
                k = apply_rope(k.reshape(n, l, kv, d), *cs).reshape(n, l, -1)
            if kv < h:
                def rep(t):
                    return t.reshape(n, l, kv, 1, d).expand(n, l, kv, h // kv, d).reshape(n, l, e)
                k, v = rep(k), rep(v)
            z = fused_mha_packed(torch.cat([q, k, v], dim=-1), h, causal=cfg.causal)
            return self.output(z, cd)

        qh = q.reshape(n, l, h, d).transpose(1, 2)
        kh = k.reshape(n, l, kv, d).transpose(1, 2)
        vh = v.reshape(n, l, kv, d).transpose(1, 2)
        if cfg.uses_rope:
            qh, kh = apply_rope(qh, cos, sin), apply_rope(kh, cos, sin)

        if route == "flash":
            if kv < h:
                def rep(t):
                    return t[:, :, None].expand(n, kv, h // kv, l, d).reshape(n, h, l, d)
                kh, vh = rep(kh), rep(vh)
            z = flash_attention(qh, kh, vh, causal=cfg.causal, impl="kernel")
            return self.output(z.transpose(1, 2).reshape(n, l, e), cd)

        qg = qh.reshape(n, kv, h // kv, l, d)
        scores = torch.matmul(qg.float(), kh.float()[:, :, None].transpose(-1, -2))
        scores = scores * (1.0 / math.sqrt(d))
        if cfg.causal:
            above = torch.ones(l, l, dtype=torch.bool, device=x.device).triu(1)
            scores = scores.masked_fill(above, -1e30)
        weights = torch.softmax(scores, dim=-1)
        z = torch.matmul(weights.to(vh.dtype).float(), vh.float()[:, :, None]).to(cd)
        out = self.output(z.reshape(n, h, l, d).transpose(1, 2).reshape(n, l, e), cd)
        if verbose:
            return out, weights.reshape(n, h, l, l)
        return out


class FeedForward(nn.Module):
    """fc1 -> activation -> fc2; swiglu's fc1 packs [gate | up] (2F wide) and
    the activation is ``silu(gate) * up`` (:643-649)."""

    def __init__(self, cfg: TransformerConfig, *, device, generator):
        super().__init__()
        self.cfg = cfg
        self.swiglu = cfg.ffn_type.lower() == "swiglu"
        self.activation = get_activation(cfg.activation)
        self.fc1 = Linear(cfg.emb_dim, 2 * cfg.ffn_dim if self.swiglu else cfg.ffn_dim,
                          cfg.ffn_bias, device=device, generator=generator)
        self.fc2 = Linear(cfg.ffn_dim, cfg.emb_dim, cfg.ffn_bias,
                          device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.cfg.cdtype()
        out = self.fc1(x, cd)
        if self.swiglu:
            gate, up = out.chunk(2, dim=-1)
            out = F.silu(gate) * up
        else:
            out = self.activation(out)
        return self.fc2(out, cd)


class Block(nn.Module):
    """Pre- or post-norm transformer block. With ``n_experts`` > 0 its FFN is
    the MoE FFN, whose router aux losses ``forward`` appends to ``moe_aux``
    (a list) when one is given."""

    def __init__(self, cfg: TransformerConfig, *, device, generator):
        super().__init__()
        self.cfg = cfg
        e = cfg.emb_dim
        self.attn_norm = build_norm(e, cfg.norm_bias, cfg.norm, cfg.norm_eps, device=device,
                                    impl=cfg.norm_impl)
        self.attn = Attention(cfg, device=device, generator=generator)
        self.ffn_norm = build_norm(e, cfg.norm_bias, cfg.norm, cfg.norm_eps, device=device,
                                   impl=cfg.norm_impl)
        if cfg.n_experts:
            from ..parallel.moe import init_moe_ffn

            self.ffn = init_moe_ffn(cfg, cfg.n_experts, device=device, generator=generator)
        else:
            self.ffn = FeedForward(cfg, device=device, generator=generator)

    def _ffn(self, x: torch.Tensor, moe_aux: list | None) -> torch.Tensor:
        if not self.cfg.n_experts:
            return self.ffn(x)
        aux = {} if moe_aux is not None else None
        out = self.ffn(x, aux=aux)
        if moe_aux is not None:
            moe_aux.append(aux)
        return out

    def forward(self, x: torch.Tensor, verbose: bool = False, moe_aux: list | None = None):
        att = None
        if self.cfg.pre_norm:
            out = self.attn(self.attn_norm(x), verbose=verbose)
            if verbose:
                out, att = out
            out = x + out
            out = out + self._ffn(self.ffn_norm(out), moe_aux)
        else:
            out = self.attn(x, verbose=verbose)
            if verbose:
                out, att = out
            out = self.attn_norm(x + out)
            out = self.ffn_norm(out + self._ffn(out, moe_aux))
        return (out, att) if verbose else out

    def decompose(self, x: torch.Tensor) -> dict:
        """Each component applied to the same ``x`` (``block_decompose``
        :851-869): the two norms, attention without its norm, fc1, and fc2 on
        ``x`` zero-padded to ``ffn_dim``, a quirk of the paper's plasticity
        statistic that is reproduced, not fixed."""
        cd = self.cfg.cdtype()
        out = {"attn_norm": self.attn_norm(x), "attn": self.attn(x),
               "ffn_norm": self.ffn_norm(x), "ffn_fc1": self.ffn.fc1(x, cd)}
        pad = x.new_zeros(*x.shape[:-1], self.cfg.ffn_dim - self.cfg.emb_dim)
        out["ffn_fc2"] = self.ffn.fc2(torch.cat([x, pad], dim=-1), cd)
        return out

    def probes(self, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """``(output, hidden state after each of the 8 stages)``, in the
        pre-norm or the post-norm order (``block_probes`` :872-911)."""
        cd = self.cfg.cdtype()
        fc1, fc2, act = self.ffn.fc1, self.ffn.fc2, self.ffn.activation
        p = {}
        if self.cfg.pre_norm:
            p["attn_norm"] = self.attn_norm(x)
            p["attn"] = self.attn(p["attn_norm"])
            p["attn_res"] = res = x + p["attn"]
            p["ffn_norm"] = self.ffn_norm(res)
            p["ffn_fc1"] = fc1(p["ffn_norm"], cd)
            p["ffn_activation"] = act(p["ffn_fc1"])
            p["ffn_fc2"] = fc2(p["ffn_activation"], cd)
            p["ffn_res"] = out = res + p["ffn_fc2"]
        else:
            p["attn"] = self.attn(x)
            p["attn_res"] = x + p["attn"]
            p["attn_norm"] = res = self.attn_norm(p["attn_res"])
            p["ffn_fc1"] = fc1(res, cd)
            p["ffn_activation"] = act(p["ffn_fc1"])
            p["ffn_fc2"] = fc2(p["ffn_activation"], cd)
            p["ffn_res"] = res + p["ffn_fc2"]
            p["ffn_norm"] = out = self.ffn_norm(p["ffn_res"])
        return out, p


class ClassificationOutput(nn.Module):
    """Final norm, CLS token, head; float32 logits."""

    def __init__(self, cfg: TransformerConfig, *, device, generator):
        super().__init__()
        self.cfg = cfg
        self.output_layer = nn.ModuleDict({
            "norm": build_norm(cfg.emb_dim, cfg.norm_bias, cfg.norm, cfg.norm_eps,
                               device=device, impl=cfg.norm_impl),
            "head": Linear(cfg.emb_dim, cfg.n_classes, True, device=device,
                           generator=generator),
        })

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.output_layer["norm"](x)[:, 0, :]
        return self.output_layer["head"](out, self.cfg.cdtype()).float()


class SequenceOutput(nn.Module):
    """Final norm, then the vocabulary head: the token embedding when tied
    (float32 logits from compute-dtype operands), else an untied (V, E)
    ``head`` without bias whose compute-dtype logits are returned as float32."""

    def __init__(self, cfg: TransformerConfig, *, device, generator):
        super().__init__()
        self.cfg = cfg
        self.output_layer = nn.ModuleDict({
            "norm": build_norm(cfg.emb_dim, cfg.norm_bias, cfg.norm, cfg.norm_eps,
                               device=device, impl=cfg.norm_impl)})
        if not cfg.weight_tying:
            self.output_layer["head"] = Linear(cfg.emb_dim, cfg.vocab_size, False,
                                               device=device, generator=generator)

    def forward(self, x: torch.Tensor, embedding: Embedding,
                return_hidden: bool = False) -> torch.Tensor:
        out = self.output_layer["norm"](x)
        if return_hidden:
            return out
        cd = self.cfg.cdtype()
        if self.cfg.weight_tying:
            n, l, e = out.shape
            w = embedding.token_emb["weight"].to(cd)
            return mm_f32(out.reshape(n * l, e).to(cd), w.t()).reshape(n, l, -1)
        return self.output_layer["head"](out, cd).float()


class Transformer(nn.Module):
    """Embedding -> blocks -> classification or sequence-to-sequence head.

    ``forward(x, verbose=True)`` also returns the stacked
    (n_layers, N, h, L, L) attention weights, computed on the plain path.
    ``forward(x, return_hidden=True)`` (seq2seq only) returns the post-norm
    hidden (N, L, E) in place of the logits, for a loss that fuses the head
    (``ops.losses.make_fused_head_loss``). ``forward(x, return_moe_aux=True)``
    returns ``(out, {"lb": ..., "z": ...})``: the per-block mean of the MoE
    router's aux losses (0-d float32 zeros without experts).
    """

    def __init__(self, cfg: TransformerConfig, *, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.embedding = Embedding(cfg, device=device, generator=generator)
        self.blocks = nn.ModuleList(
            [Block(cfg, device=device, generator=generator) for _ in range(cfg.n_layers)])
        seq2seq = cfg.output_type.lower() == "sequence_to_sequence"
        self.output = (SequenceOutput if seq2seq else ClassificationOutput)(
            cfg, device=device, generator=generator)

    def forward(self, x: torch.Tensor, verbose: bool = False, return_hidden: bool = False,
                return_moe_aux: bool = False):
        if self.training:
            _check_no_dropout(self.cfg)
        seq2seq = isinstance(self.output, SequenceOutput)
        if return_hidden and not seq2seq:
            raise ValueError("return_hidden requires a seq2seq output head")
        if return_moe_aux and verbose:
            raise ValueError("return_moe_aux and verbose are mutually exclusive")
        block_aux = [] if return_moe_aux and self.cfg.n_experts else None
        out = self.embedding(x)
        attentions = []
        for block in self.blocks:
            out = block(out, verbose=verbose, moe_aux=block_aux)
            if verbose:
                out, att = out
                attentions.append(att)
        logits = (self.output(out, self.embedding, return_hidden) if seq2seq
                  else self.output(out))
        if verbose:
            return logits, torch.stack(attentions)
        if return_moe_aux:
            # the per-block mean, the Switch/ST-MoE convention (:832-840)
            return logits, {key: (torch.stack([a[key] for a in block_aux]).mean() if block_aux
                                  else torch.zeros((), device=logits.device))
                            for key in ("lb", "z")}
        return logits

    def get_decomposition(self, x: torch.Tensor) -> dict:
        """Per-block component outputs (``get_decomposition`` :914-926): keys
        ``embedding`` and ``block{i}_{attn_norm,attn,ffn_norm,ffn_fc1,ffn_fc2}``;
        every block decomposes the same embedding output."""
        out = self.embedding(x)
        outputs = {"embedding": out}
        for i, block in enumerate(self.blocks):
            for key, val in block.decompose(out).items():
                outputs[f"block{i}_{key}"] = val
        return outputs

    def get_probes(self, x: torch.Tensor) -> dict:
        """Per-block stage-wise hidden states (``get_probes`` :929-938): keys
        ``block{i}_{stage}`` for the 8 stages; the state advances through
        the blocks."""
        out = self.embedding(x)
        probes = {}
        for i, block in enumerate(self.blocks):
            out, block_probes = block.probes(out)
            for key, val in block_probes.items():
                probes[f"block{i}_{key}"] = val
        return probes
