"""Mixture-of-experts family: the Llama backbone with a sparse MoE FFN.

Counterpart of ``vitef_tpu/models/moe.py`` (:28-102): ``MOE_SIZES``,
:class:`MoeConfig`, :func:`moe_transformer_config` and :func:`build_moe`
keep the JAX package's names and fixed arguments — the Llama family's
backbone (causal, rms norm, RoPE, GQA, no biases, untied head) with every
block's FFN replaced by ``n_experts`` swiglu experts behind a softmax top-k
router (``parallel/moe.py`` holds the math). ``moe_impl`` picks the MoE
FFN's branch (:func:`~vitef_tpu_torch.parallel.moe.resolve_moe_impl`):
``"auto"``, ``"dense"`` or ``"sparse"``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .transformer import Transformer, TransformerConfig

MOE_SIZES = {
    # test/debug size (llama-tiny backbone, 4 experts)
    "tiny": dict(emb_dim=64, n_heads=4, n_kv_heads=2, n_layers=2,
                 ffn_dim=128, vocab_size=256, seq_len=512,
                 rope_theta=10000.0, n_experts=4, moe_top_k=2),
    # llama-124m backbone, 8 experts, top-2 (Mixtral-style)
    "8x124m": dict(emb_dim=768, n_heads=12, n_kv_heads=4, n_layers=12,
                   ffn_dim=2048, vocab_size=32000, seq_len=2048,
                   rope_theta=10000.0, n_experts=8, moe_top_k=2),
}


@dataclass
class MoeConfig:
    """The JAX package's MoeConfig fields."""

    model_name: str = "8x124m"
    seq_len: int | None = None  # cap the preset's length
    n_experts: int | None = None  # override the preset's expert count
    moe_top_k: int | None = None
    # router aux-loss coefficients (0 = off): Switch load balance + z-loss
    moe_lb_coef: float = 0.0
    moe_z_coef: float = 0.0

    compute_dtype: str = "float32"
    attn_impl: str = "auto"
    norm_impl: str = "auto"
    moe_impl: str = "auto"  # auto | dense | sparse
    remat: bool = False


def moe_transformer_config(cfg: MoeConfig) -> TransformerConfig:
    """The fixed Transformer arguments of the MoE family."""
    args = dict(MOE_SIZES[cfg.model_name])
    if cfg.seq_len is not None:
        args["seq_len"] = cfg.seq_len
    if cfg.n_experts is not None:
        args["n_experts"] = cfg.n_experts
    if cfg.moe_top_k is not None:
        args["moe_top_k"] = cfg.moe_top_k
    args.update(
        patch_type=None,
        emb_type="dict",
        pos_emb_type="rope",
        emb_dropout=0.0,
        attn_bias=False,
        attn_dropout=0.0,
        flash=True,
        causal=True,
        ffn_type="swiglu",
        ffn_bias=False,
        ffn_dropout=0.0,
        norm="rms",
        norm_bias=False,
        norm_eps=1e-5,
        pre_norm=True,
        cls_token=False,
        output_type="sequence_to_sequence",
        weight_tying=False,
        output_dropout=0.0,
        compute_dtype=cfg.compute_dtype,
        attn_impl=cfg.attn_impl,
        norm_impl=cfg.norm_impl,
        moe_impl=cfg.moe_impl,
        moe_lb_coef=cfg.moe_lb_coef,
        moe_z_coef=cfg.moe_z_coef,
        remat=cfg.remat,
    )
    return TransformerConfig(**args)


def build_moe(cfg: MoeConfig, *, device: torch.device, generator: torch.Generator):
    """Build (module, transformer_config, model_name) with random weights
    from ``generator``."""
    tcfg = moe_transformer_config(cfg)
    return Transformer(tcfg, device=device, generator=generator), tcfg, f"moe-{cfg.model_name}"
