"""Model factory. Counterpart of ``vitef_tpu/models/registry.py`` (:31-66, :144-187).

:func:`build_model` takes the JAX package's flat config dicts. Ported
implementations: ``"vit"``, ``"gpt2"``, ``"llama"``, ``"moe"`` and
``"transformer"``; the others raise.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from dataclasses import dataclass
from typing import Any

import torch

from ..ops.common import use_true_fp32
from .transformer import Transformer, TransformerConfig

logger = logging.getLogger(__name__)

_UNPORTED = ("patchtst",)


def _build_config(cls, config: dict[str, Any]):
    """Instantiate dataclass ``cls`` from ``config``; unknown keys warn and are
    dropped, as the JAX package's ``build_with_type_check`` does."""
    names = {f.name for f in dataclasses.fields(cls)}
    for key in config.keys() - names:
        logger.warning("unknown field %r for %s (ignored)", key, cls.__name__)
    return cls(**{k: v for k, v in config.items() if k in names})


@dataclass
class Model:
    """Model bundle: the module (which holds the parameters), its config and name."""

    module: Transformer
    config: TransformerConfig
    name: str

    def apply(self, x: torch.Tensor, **kw):
        return self.module(x, **kw)

    def apply_eval(self, x: torch.Tensor, **kw):
        """``apply`` with the module put in eval mode first."""
        self.module.eval()
        return self.module(x, **kw)

    @functools.cached_property
    def eval_step(self):
        """``(x, y) -> (batch_acc, batch_loss)`` in eval mode, under
        ``torch.inference_mode``."""
        from ..parallel.train_step import make_eval_step

        return make_eval_step(self.apply_eval)

    def generate(self, prompt: torch.Tensor, max_new_tokens: int, *,
                 temperature: float = 1.0, top_k: int | None = None,
                 top_p: float | None = None, prompt_mask: torch.Tensor | None = None,
                 kv_cache_dtype: str | None = None, eos_token_id: int | None = None,
                 generator: torch.Generator | None = None):
        """KV-cache autoregressive decoding of ``prompt`` (N, P) on the
        module's device (:func:`~vitef_tpu_torch.models.generation.generate`),
        with the JAX package's defaults (:68-91)."""
        from .generation import generate

        return generate(self.module, self.config, prompt, max_new_tokens,
                        temperature=temperature, top_k=top_k, generator=generator,
                        prompt_mask=prompt_mask, kv_cache_dtype=kv_cache_dtype, top_p=top_p,
                        eos_token_id=eos_token_id)

    def quantize_int8(self):
        """The decoding copy of this model's module with weight-only int8
        weights (:121-132): every block's linears, the token table and the
        untied head as int8 with a power-of-two float32 scale per output
        channel, the rest shared
        (:func:`~vitef_tpu_torch.models.quantize.quantize_module`). Pass it
        to ``generate`` or ``DecodeServer`` where the JAX package passes the
        quantized params; inference only."""
        from .quantize import quantize_module

        return quantize_module(self.module)

    def get_decomposition(self, x: torch.Tensor) -> dict:
        """The per-block component outputs on the embedding output
        (:meth:`Transformer.get_decomposition`), in eval mode under
        ``torch.inference_mode``."""
        self.module.eval()
        with torch.inference_mode():
            return self.module.get_decomposition(x)

    def get_probes(self, x: torch.Tensor) -> dict:
        """The per-block stage-wise hidden states (:meth:`Transformer.get_probes`),
        in eval mode under ``torch.inference_mode``."""
        self.module.eval()
        with torch.inference_mode():
            return self.module.get_probes(x)


def build_model(config: dict[str, Any], *, device,
                generator: torch.Generator | None = None, return_config: bool = False):
    """Build a model on ``device`` from a flat dict config; with
    ``return_config``, also the family config's fields as a json-ready dict
    (what a checkpoint's ``params.json`` holds, as in the JAX package).

    Parameters are drawn on the CPU from ``generator`` (default: seeded with
    ``config["seed"]``, else 0) and then moved to ``device``. The module is
    put in eval mode. On CUDA, float32 matmuls are set to full float32
    (:func:`~vitef_tpu_torch.ops.common.use_true_fp32`).
    """
    config = dict(config)
    implementation = config.pop("implementation", "vit")
    seed = config.pop("seed", 0)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    device = torch.device(device)
    if device.type == "cuda":
        use_true_fp32()

    impl = implementation.lower()
    if impl == "vit":
        from .vit import ViTConfig, build_vit

        cfg = _build_config(ViTConfig, config)
        module, tcfg, name = build_vit(cfg, device=device, generator=generator)
    elif impl == "gpt2":
        from .gpt2 import GPT2Config, build_gpt2

        cfg = _build_config(GPT2Config, config)
        module, tcfg, name = build_gpt2(cfg, device=device, generator=generator)
    elif impl == "llama":
        from .llama import LlamaConfig, build_llama

        cfg = _build_config(LlamaConfig, config)
        module, tcfg, name = build_llama(cfg, device=device, generator=generator)
    elif impl == "moe":
        from .moe import MoeConfig, build_moe

        cfg = _build_config(MoeConfig, config)
        module, tcfg, name = build_moe(cfg, device=device, generator=generator)
    elif impl == "transformer":
        cfg = tcfg = _build_config(TransformerConfig, config)
        module, name = Transformer(cfg, device=device, generator=generator), "transformer"
    elif impl in _UNPORTED:
        raise NotImplementedError(f"implementation {implementation!r} is not ported yet")
    else:
        raise ValueError(f"Implementation {implementation} not found.")

    model = Model(module=module.eval(), config=tcfg, name=name)
    if return_config:
        from ..utils.typed import asdict_filtered

        return model, asdict_filtered(cfg)
    return model
