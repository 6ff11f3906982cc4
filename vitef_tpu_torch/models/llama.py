"""Llama-family preset. Counterpart of ``vitef_tpu/models/llama.py`` (:33-138).

``LLAMA_SIZES``, :class:`LlamaConfig`, :func:`llama_transformer_config` and
:func:`build_llama` keep the JAX package's names and fixed arguments: a
causal, pre-norm decoder with a ``dict`` token embedding, rms norm (eps
1e-5), no biases, rotary positions, grouped-query attention
(``n_kv_heads < n_heads``), a swiglu FFN (fc1 packs [gate | up]) and an
untied head. ``seq_len`` caps the preset's length (the "1b" preset's is
8192; its training workload runs at 1024).

Pretrained weights load only from ``<save_dir>/llama-<model_name>.npz``,
with the reference vitef names in the torch layout
(:func:`~.convert.hf_llama_to_vitef` makes them from a HuggingFace state
dict). Where it does not exist the model keeps its random weights with the
JAX package's warning: the port never reaches for the network and does not
import ``transformers``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..config import MODEL_DIR
from .convert import from_vitef_state_dict
from .transformer import Transformer, TransformerConfig

logger = logging.getLogger(__name__)

LLAMA_SIZES = {
    # test/debug size
    "tiny": dict(emb_dim=64, n_heads=4, n_kv_heads=2, n_layers=2,
                 ffn_dim=128, vocab_size=256, seq_len=512,
                 rope_theta=10000.0),
    # GPT2-small-comparable debug size
    "124m": dict(emb_dim=768, n_heads=12, n_kv_heads=4, n_layers=12,
                 ffn_dim=2048, vocab_size=32000, seq_len=2048,
                 rope_theta=10000.0),
    # Llama-3.2-1B geometry
    "1b": dict(emb_dim=2048, n_heads=32, n_kv_heads=8, n_layers=16,
               ffn_dim=8192, vocab_size=128256, seq_len=8192,
               rope_theta=500000.0),
    # Llama-3.1-8B geometry
    "8b": dict(emb_dim=4096, n_heads=32, n_kv_heads=8, n_layers=32,
               ffn_dim=14336, vocab_size=128256, seq_len=8192,
               rope_theta=500000.0),
}


@dataclass
class LlamaConfig:
    """The JAX package's LlamaConfig fields."""

    model_name: str = "1b"
    pretrained: bool = False
    save_dir: str | None = None
    seq_len: int | None = None  # cap the preset's length

    compute_dtype: str = "float32"
    attn_impl: str = "auto"
    norm_impl: str = "auto"
    remat: bool = False

    def __post_init__(self):
        if self.save_dir is None:
            self.save_dir = str(MODEL_DIR / "llama")


def llama_transformer_config(cfg: LlamaConfig) -> TransformerConfig:
    """The fixed Transformer arguments of the Llama family."""
    args = dict(LLAMA_SIZES[cfg.model_name])
    if cfg.seq_len is not None:
        args["seq_len"] = cfg.seq_len
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
        remat=cfg.remat,
    )
    return TransformerConfig(**args)


def _load_pretrained_state_dict(model_name: str, save_dir: str) -> dict[str, np.ndarray] | None:
    npz_path = Path(save_dir) / f"{model_name}.npz"
    if npz_path.exists():
        with np.load(npz_path) as z:
            return {k: z[k] for k in z.files}
    logger.warning("Could not load pretrained weights for %s: %s does not exist",
                   model_name, npz_path)
    return None


def build_llama(cfg: LlamaConfig, *, device: torch.device, generator: torch.Generator):
    """Build (module, transformer_config, model_name): random init from
    ``generator``, then the local pretrained weights when asked for and found."""
    tcfg = llama_transformer_config(cfg)
    module = Transformer(tcfg, device=device, generator=generator)
    model_name = f"llama-{cfg.model_name}"
    if cfg.pretrained:
        sd = _load_pretrained_state_dict(model_name, cfg.save_dir)
        if sd is not None:
            module.load_state_dict(from_vitef_state_dict(sd, tcfg.n_layers))
            logger.info("Pretrained weights successfully loaded for %s.", model_name)
    return module, tcfg, model_name
