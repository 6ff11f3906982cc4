"""ViT preset. Counterpart of ``vitef_tpu/models/vit.py`` (:28-35, :53-118, :121-151, :163-194).

Pretrained weights load from an existing ``<save_dir>/<name>.npz`` cache, else
``<name>.pt``, in the torch (vitef-named) layout; with neither, the loader
warns and the random init stays, as in the JAX package. There is no
download.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch

from ..config import MODEL_DIR
from .convert import from_vitef_state_dict, load_weight_cache
from .transformer import Linear, Transformer, TransformerConfig

logger = logging.getLogger(__name__)

VIT_SIZES = {
    # 'tiny' is not a published size; it exists for fast tests.
    "tiny": dict(emb_dim=32, n_heads=2, n_layers=2, ffn_dim=64),
    "base": dict(emb_dim=768, n_heads=12, n_layers=12, ffn_dim=3072),
    "large": dict(emb_dim=1024, n_heads=16, n_layers=24, ffn_dim=4096),
    "huge": dict(emb_dim=1280, n_heads=16, n_layers=32, ffn_dim=5120),
}

AVAILABLE_PRETRAINED = [
    "vit-base-patch16-224",
    "vit-base-patch16-384",
    "vit-base-patch32-384",
    "vit-base-patch16-224-in21k",
    "vit-base-patch32-224-in21k",
    "vit-large-patch16-224",
    "vit-large-patch16-384",
    "vit-large-patch32-384",
    "vit-large-patch16-224-in21k",
    "vit-large-patch32-224-in21k",
    "vit-huge-patch14-224-in21k",
]


@dataclass
class ViTConfig:
    """The JAX package's ViTConfig fields."""

    model_name: str = "base"
    pretrained: bool = False
    in21k: bool = False
    save_dir: str | None = None
    patch_size: int = 16
    image_dim: tuple = (3, 224, 224)
    finetuning: bool = False
    n_classes: int = 1000

    compute_dtype: str = "float32"
    attn_impl: str = "auto"
    norm_impl: str = "auto"
    remat: bool = False

    def __post_init__(self):
        if self.save_dir is None:
            self.save_dir = str(MODEL_DIR / "vit")
        if isinstance(self.image_dim, list):
            self.image_dim = tuple(self.image_dim)


def vit_model_name(cfg: ViTConfig) -> str:
    name = f"vit-{cfg.model_name.lower()}-patch{cfg.patch_size}-{cfg.image_dim[-1]}"
    if cfg.in21k:
        name += "-in21k"
    return name


def vit_transformer_config(cfg: ViTConfig) -> TransformerConfig:
    """The fixed Transformer arguments of the ViT."""
    args = dict(VIT_SIZES[cfg.model_name])
    args.update(
        image_dim=cfg.image_dim,
        patch_type="computer_vision",
        image_patch="hybrid",
        patch_size=cfg.patch_size,
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
        norm="layer",
        norm_bias=True,
        norm_eps=1e-12,
        pre_norm=True,
        cls_token=True,
        output_type="classification",
        weight_tying=False,
        output_dropout=0.0,
        n_classes=1000 if not cfg.in21k else 2,
        compute_dtype=cfg.compute_dtype,
        attn_impl=cfg.attn_impl,
        norm_impl=cfg.norm_impl,
        remat=cfg.remat,
    )
    return TransformerConfig(**args)


def build_vit(cfg: ViTConfig, *, device: torch.device, generator: torch.Generator):
    """Build (module, transformer_config, model_name): random init, optional
    pretrained load, optional fresh classification head for finetuning."""
    tcfg = vit_transformer_config(cfg)
    module = Transformer(tcfg, device=device, generator=generator)
    model_name = vit_model_name(cfg)

    if cfg.pretrained:
        if model_name in AVAILABLE_PRETRAINED:
            sd = load_weight_cache(model_name, cfg.save_dir)
            if sd is not None:
                module.load_state_dict(from_vitef_state_dict(sd, tcfg.n_layers))
                logger.info("Pretrained weights successfully loaded for %s.", model_name)
        else:
            logger.info("Pretrained weights for %s not found. Using random "
                        "initialization.", model_name)

    if cfg.finetuning:
        tcfg.n_classes = cfg.n_classes
        module.output.output_layer["head"] = Linear(
            tcfg.emb_dim, cfg.n_classes, True, device=device, generator=generator)
        logger.info("Initialize new classification head with %d classes for "
                    "finetuning.", cfg.n_classes)
    return module, tcfg, model_name
