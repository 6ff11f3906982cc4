"""Shared ViT-app state and helpers. Counterpart of ``apps/vit/utils.py``
(``EvalState`` :18-32, ``freeze_components`` :35-42), and the device rule
the port's command lines share.

Freezing is ``requires_grad = False`` on the frozen parameters
(:func:`vitef_tpu_torch.optim.freeze_components`), chosen with the JAX
package's component vocabulary: emb / pos_emb / attn_norm / mha / ffn_norm
/ ffn_fc1 / ffn_fc2.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...optim import FREEZE_MAP, freeze_components, trainable_mask  # noqa: F401 (re-export)


@dataclass
class EvalState:
    """Batch-mean accumulators of an evaluation."""

    accuracy: float = 0.0
    loss: float = 0.0
    step: int = 0

    def state_dict(self) -> dict:
        return {"eval_acc": self.accuracy, "eval_loss": self.loss, "step": self.step}

    def load_state_dict(self, state_dict: dict) -> None:
        self.accuracy = state_dict["eval_acc"]
        self.loss = state_dict["eval_loss"]
        self.step = state_dict["step"]


def resolve_device(name: str) -> torch.device:
    """The command lines' ``device``: "cuda" (the default) needs a card and
    raises without one; the CPU runs only when asked for (``device=cpu``)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={name!r} but no CUDA device is available; pass "
                           "device=cpu to run on the CPU")
    return device

