"""Optimizers, LR schedules, component freezing and the global-norm clip.

Counterpart of ``vitef_tpu/optim.py`` (configs :41-58, schedules and
``build_scheduler`` :66-143, ``FREEZE_MAP`` and ``trainable_mask`` :154-205,
``build_optimizer`` :223-288, ``global_grad_norm`` :291-298) and of
``freeze_components`` in ``apps/vit/utils.py`` (:35-42).

- Schedules are float functions of the step; ``build_optimizer`` hands the
  one it is given to ``torch.optim.lr_scheduler.LambdaLR``, so the update of
  step k uses ``lr * schedule(k)``, as the JAX package's optax count does.
- Freezing is ``requires_grad = False`` on the frozen parameters, chosen by
  the JAX package's path-segment rule over ``named_parameters()`` names
  (which are the JAX tree paths, dotted). The optimizer only holds the
  trainable parameters, so a frozen one never changes.
- ``sgd`` is ``torch.optim.SGD`` (L2 decay added to the gradient before the
  momentum buffer, no dampening, no Nesterov: ``_sgd_torch`` :223-233);
  ``adamw`` is ``torch.optim.AdamW`` with eps 1e-8 (optax.adamw).
- :func:`clip_by_global_norm_` is optax's rule, not
  ``torch.nn.utils.clip_grad_norm_`` (which adds 1e-6 to the norm).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Iterable

import torch
from torch import nn

from .models.registry import _build_config


@dataclass
class OptimizerConfig:
    lr: float = 1e-3
    weight_decay: float = 0.0
    betas: tuple = (0.9, 0.999)
    momentum: float = 0.0


@dataclass
class SchedulerConfig:
    warmup: int = 2000
    min_factor: float = 0
    cycle_length: float = 1.0
    decay_fraction: float = 0.1


# ------------------------------------------------------------------------------
# LR schedules: step -> factor
# ------------------------------------------------------------------------------


def lr_constant(step: int) -> float:
    return 1.0


def lr_linear(step: int, warmup: int, min_factor: float, n_steps: int) -> float:
    """Warmup then linear decay to min_factor."""
    if step < warmup:
        return step / warmup
    if step <= n_steps:
        s = (step - warmup) / (n_steps - warmup)
        return s * min_factor + (1.0 - s)
    return min_factor


def lr_cosine(step: int, warmup: int, min_factor: float, n_steps: int) -> float:
    """Warmup then cosine to min_factor."""
    if warmup == n_steps:
        raise ValueError("Warmup and steps should not be equal")
    if step < warmup:
        return step / warmup
    if step <= n_steps:
        s = (step - warmup) / (n_steps - warmup)
        return min_factor + 0.5 * (1.0 - min_factor) * (math.cos(math.pi * s) + 1.0)
    return min_factor


def lr_wsd(step: int, warmup: int, min_factor: float, decay_fraction: float,
           cycle_length: float, n_steps: int) -> float:
    """Warmup-stable-decay with cycles and 1/x decay."""
    if step < warmup:
        return step / warmup
    cycle_steps = int(n_steps * cycle_length)
    curr_n_steps = n_steps if step == n_steps else cycle_steps * (step // cycle_steps + 1)
    decay_length = math.floor(curr_n_steps * decay_fraction)
    decay_start = curr_n_steps - decay_length
    if step <= decay_start:
        return 1.0
    if step > curr_n_steps:
        return min_factor
    progress = (step - decay_start) / max(decay_length, 1)
    inv_min = 1.0 / min_factor if min_factor else math.inf
    return 1.0 / (progress * inv_min + (1.0 - progress))


def build_scheduler(config: dict[str, Any], n_steps: int) -> Callable[[int], float]:
    """A ``step -> factor`` schedule: ``constant``, ``linear``, ``cosine`` or ``wsd``."""
    config = dict(config)
    name = config.pop("scheduler", "constant")
    config.pop("lr", None)  # shared config dicts may carry optimizer keys
    cfg = _build_config(SchedulerConfig, config)
    match name.lower():
        case "constant":
            return lr_constant
        case "linear":
            return partial(lr_linear, warmup=cfg.warmup, min_factor=cfg.min_factor,
                           n_steps=n_steps)
        case "cosine":
            return partial(lr_cosine, warmup=cfg.warmup, min_factor=cfg.min_factor,
                           n_steps=n_steps)
        case "wsd":
            return partial(lr_wsd, warmup=cfg.warmup, min_factor=cfg.min_factor,
                           decay_fraction=cfg.decay_fraction,
                           cycle_length=cfg.cycle_length, n_steps=n_steps)
        case _:
            raise ValueError(
                f"Unknown scheduler '{name}'. Choose between 'constant', 'linear', "
                "'cosine' and 'wsd'.")


# ------------------------------------------------------------------------------
# Freezing
# ------------------------------------------------------------------------------

# Component -> parameter-path prefixes (the JAX package's vocabulary).
FREEZE_MAP = {
    "emb": ["embedding"],
    "pos_emb": ["embedding.pos_emb"],
    "attn_norm": ["attn_norm"],
    "mha": ["attn.qkv_mat", "attn.output"],
    "ffn_norm": ["ffn_norm"],
    "ffn_fc1": ["ffn.fc1"],
    "ffn_fc2": ["ffn.fc2"],
}


def _names(params) -> list[str]:
    if isinstance(params, nn.Module):
        return [name for name, _ in params.named_parameters()]
    return list(params)


def trainable_mask(params: nn.Module | Iterable[str], components: list[str]) -> dict[str, bool]:
    """``{name: trainable}`` over a module's ``named_parameters()`` (or over
    dotted names): 'emb' freezes the whole embedding; the other components
    freeze parameters whose path within a block starts with the target as
    whole dotted segments; the output head always trains."""
    targets: list[str] = []
    for comp in components:
        if comp not in FREEZE_MAP:
            raise ValueError(f"Unknown component {comp!r}; choose {list(FREEZE_MAP)}")
        targets.extend(FREEZE_MAP[comp])
    freeze_embedding = "embedding" in targets
    emb_targets = [t for t in targets if t.startswith("embedding.")]
    block_targets = [t for t in targets if t != "embedding"
                     and not t.startswith("embedding.")]

    def trainable(name: str) -> bool:
        if name.rpartition(".")[2].startswith("running_"):
            return False
        if freeze_embedding and name.startswith("embedding."):
            return False
        if any(name == t or name.startswith(t + ".") for t in emb_targets):
            return False
        if name.startswith("blocks."):
            parts = name.split(".")
            skip = 2 if len(parts) > 1 and parts[1].isdigit() else 1
            rest = ".".join(parts[skip:])
            if any(rest == t or rest.startswith(t + ".") for t in block_targets):
                return False
        return True

    return {name: trainable(name) for name in _names(params)}


def freeze_components(module: nn.Module, components: list[str] | None) -> dict[str, bool]:
    """Set ``requires_grad`` from :func:`trainable_mask` (None/empty: everything
    trains) and return the mask."""
    mask = trainable_mask(module, components or [])
    for name, param in module.named_parameters():
        param.requires_grad_(mask[name])
    return mask


# ------------------------------------------------------------------------------
# Optimizers and the clip
# ------------------------------------------------------------------------------


def build_optimizer(config: dict[str, Any], module: nn.Module, *,
                    schedule: Callable[[int], float] | None = None,
                    components: list[str] | None = None):
    """``(optimizer, scheduler)`` over the trainable parameters of ``module``.

    ``components`` (if given) are frozen first (:func:`freeze_components`).
    The scheduler is a ``LambdaLR`` over ``schedule`` (default constant).
    """
    config = dict(config)
    name = config.pop("optimizer", "adamw")
    config.pop("scheduler", None)
    cfg = _build_config(OptimizerConfig, config)
    if components is not None:
        freeze_components(module, components)
    params = [p for p in module.parameters() if p.requires_grad]
    match name.lower():
        case "adamw":
            optimizer = torch.optim.AdamW(params, lr=cfg.lr, betas=tuple(cfg.betas),
                                          eps=1e-8, weight_decay=cfg.weight_decay)
        case "sgd":
            optimizer = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                                        weight_decay=cfg.weight_decay, dampening=0.0,
                                        nesterov=False)
        case _:
            raise ValueError(
                f"Unknown optimizer '{name}'. Choose between 'adamw' and 'sgd'.")
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, schedule or lr_constant)
    return optimizer, scheduler


def global_grad_norm(grads: Iterable[torch.Tensor | None]) -> torch.Tensor:
    """Global L2 norm (float32, 0-d) over the gradients given; None entries skip."""
    grads = [g.float() for g in grads if g is not None]
    if not grads:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm: torch.Tensor | None = None) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` when ``norm >= max_norm``
    (optax.clip_by_global_norm; no epsilon). ``norm`` defaults to their global
    norm. Runs on the device, with no host synchronisation. Returns ``norm``."""
    if norm is None:
        norm = global_grad_norm(grads)
    if grads:
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        torch._foreach_mul_(grads, scale)
    return norm
