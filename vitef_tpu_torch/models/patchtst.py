"""PatchTST preset. Counterpart of ``vitef_tpu/models/patchtst.py``.

Time-series patching, the linear embedding, post-norm blocks with batch norm
and a forecasting head: a series (N, length) is cut into overlapping patches
and forecast ``forecasting_horizon`` steps ahead (Nie et al., ICLR 2023).
Pretrained weights load only from an existing ``<save_dir>/<name>.npz``, else
``<name>.pt``, in the torch (vitef-named) layout, batch norms in the
reference's ``BatchNorm1d`` wrapper names; with neither the random init
stays. There is no download.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch

from ..config import MODEL_DIR
from .convert import from_vitef_state_dict, load_weight_cache
from .transformer import Transformer, TransformerConfig

logger = logging.getLogger(__name__)

PATCHTST_SIZES = {
    "base": dict(emb_dim=128, n_heads=16, n_layers=3, ffn_dim=256),  # 1M params
}


@dataclass
class PatchTSTConfig:
    """The JAX package's PatchTSTConfig fields."""

    model_name: str = "base"
    pretrained: bool = False
    save_dir: str | None = None
    length: int = 512
    patch_size: int = 16
    stride: int = 8
    forecasting_horizon: int = 96

    compute_dtype: str = "float32"
    attn_impl: str = "auto"
    norm_impl: str = "auto"

    def __post_init__(self):
        if self.save_dir is None:
            self.save_dir = str(MODEL_DIR / "patchtst")


def patchtst_model_name(cfg: PatchTSTConfig) -> str:
    return f"patchtst-{cfg.model_name.lower()}-patch{cfg.patch_size}-{cfg.length}"


def patchtst_transformer_config(cfg: PatchTSTConfig) -> TransformerConfig:
    """The fixed Transformer arguments of PatchTST."""
    args = dict(PATCHTST_SIZES[cfg.model_name])
    args.update(
        length=cfg.length,
        patch_type="time_series",
        patch_size=cfg.patch_size,
        stride=cfg.stride,
        emb_type="linear",
        pos_emb=True,
        freeze_pos=False,
        emb_dropout=0.0,
        attn_bias=True,
        attn_dropout=0.0,
        flash=True,
        causal=False,
        activation="gelu",
        ffn_bias=True,
        ffn_dropout=0.0,
        norm="batch",
        norm_bias=True,
        norm_eps=1e-5,
        pre_norm=False,
        cls_token=False,
        output_type="forecasting",
        weight_tying=False,
        output_dropout=0.0,
        forecasting_horizon=cfg.forecasting_horizon,
        compute_dtype=cfg.compute_dtype,
        attn_impl=cfg.attn_impl,
        norm_impl=cfg.norm_impl,
    )
    return TransformerConfig(**args)


def build_patchtst(cfg: PatchTSTConfig, *, device: torch.device,
                   generator: torch.Generator):
    """Build (module, transformer_config, model_name): random init, then the
    local-only pretrained load when ``cfg.pretrained`` (:84-105)."""
    tcfg = patchtst_transformer_config(cfg)
    module = Transformer(tcfg, device=device, generator=generator)
    model_name = patchtst_model_name(cfg)
    if cfg.pretrained:
        sd = load_weight_cache(model_name, cfg.save_dir)
        if sd is not None:
            module.load_state_dict(from_vitef_state_dict(sd, tcfg.n_layers))
            logger.info("Pretrained weights successfully loaded for %s.", model_name)
    return module, tcfg, model_name
