"""GPT-2 preset. Counterpart of ``vitef_tpu/models/gpt2.py`` (:23-118).

``GPT2_SIZES``, :class:`GPT2Config`, :func:`gpt2_model_name`,
:func:`gpt2_transformer_config` and :func:`build_gpt2` keep the JAX
package's names and fixed arguments: a causal, pre-norm transformer with a
``dict`` token embedding, learned positions, 'gelu' (the exact erf in
float32, the tanh approximation in bfloat16), biases everywhere, LayerNorm
eps 1e-5 and a head tied to the token embedding, at ``seq_len`` 1024 and
vocabulary 50257.

Pretrained weights load only from local files, in the JAX package's order
(``_load_pretrained_state_dict`` :107-118): ``<save_dir>/<model_name>.npz``,
then ``<save_dir>/<model_name>.pt``, both with the reference vitef names in
the torch layout (:func:`~.convert.hf_gpt2_to_vitef` makes them from a
HuggingFace state dict). Where neither exists the model keeps its random
weights with the JAX package's warning: the port never reaches for the
network and imports neither ``transformers`` nor ``tiktoken``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch

from ..config import MODEL_DIR
from .convert import from_vitef_state_dict, load_weight_cache
from .transformer import Transformer, TransformerConfig

logger = logging.getLogger(__name__)

GPT2_SIZES = {
    "base": dict(emb_dim=768, n_heads=12, n_layers=12),  # 124M params
    "medium": dict(emb_dim=1024, n_heads=16, n_layers=24),  # 350M params
    "large": dict(emb_dim=1280, n_heads=20, n_layers=36),  # 774M params
    "xl": dict(emb_dim=1600, n_heads=25, n_layers=48),  # 1558M params
}


@dataclass
class GPT2Config:
    """The JAX package's GPT2Config fields."""

    model_name: str = "base"
    pretrained: bool = False
    save_dir: str | None = None

    compute_dtype: str = "float32"
    attn_impl: str = "auto"
    norm_impl: str = "auto"
    remat: bool = False

    def __post_init__(self):
        if self.save_dir is None:
            self.save_dir = str(MODEL_DIR / "gpt2")


def gpt2_model_name(cfg: GPT2Config) -> str:
    return "gpt2" if cfg.model_name == "base" else f"gpt2-{cfg.model_name}"


def gpt2_transformer_config(cfg: GPT2Config) -> TransformerConfig:
    """The fixed Transformer arguments of GPT-2."""
    args = dict(GPT2_SIZES[cfg.model_name])
    args.update(
        patch_type=None,
        vocab_size=50_257,
        emb_type="dict",
        pos_emb=True,
        freeze_pos=False,
        seq_len=1024,
        emb_dropout=0.0,
        attn_bias=True,
        attn_dropout=0.0,
        flash=True,
        causal=True,
        activation="gelu",
        ffn_bias=True,
        ffn_dropout=0.0,
        norm="layer",
        norm_bias=True,
        norm_eps=1e-5,
        pre_norm=True,
        cls_token=False,
        output_type="sequence_to_sequence",
        weight_tying=True,
        output_dropout=0.0,
        compute_dtype=cfg.compute_dtype,
        attn_impl=cfg.attn_impl,
        norm_impl=cfg.norm_impl,
        remat=cfg.remat,
    )
    return TransformerConfig(**args)


def build_gpt2(cfg: GPT2Config, *, device: torch.device, generator: torch.Generator):
    """Build (module, transformer_config, model_name): random init from
    ``generator``, then the local pretrained weights when asked for and found."""
    tcfg = gpt2_transformer_config(cfg)
    module = Transformer(tcfg, device=device, generator=generator)
    model_name = gpt2_model_name(cfg)
    if cfg.pretrained:
        sd = load_weight_cache(model_name, cfg.save_dir)
        if sd is not None:
            module.load_state_dict(from_vitef_state_dict(
                sd, tcfg.n_layers, weight_tying=tcfg.weight_tying))
            logger.info("Pretrained weights successfully loaded for %s.", model_name)
    return module, tcfg, model_name
