"""Weight converters into the port's state dicts.

Counterpart of ``vitef_tpu/models/torch_import.py``. The port's parameter
names are the JAX package's tree paths, dotted (``blocks.0.attn.qkv_mat.weight``).

- :func:`from_jax_params` carries a ``vitef_tpu`` parameter tree (numpy
  leaves) across, name for name. The JAX package stores linear weights
  (in, out); the port stores (out, in). That transpose is made here and
  nowhere else.
- :func:`from_vitef_state_dict` loads a torch-layout state dict with the
  reference vitef names (the ``checkpoints/vit/<name>.npz`` cache; the
  inverse direction of ``torch_import.from_vitef_state_dict``).
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flatten(value, f"{prefix}.{key}" if prefix else str(key))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _flatten(value, f"{prefix}.{i}" if prefix else str(i))
    else:
        yield prefix, tree


def from_jax_params(params) -> dict[str, torch.Tensor]:
    """``vitef_tpu`` parameter tree (nested dicts/lists of arrays) -> port state dict.

    Every 2-D ``weight`` is a linear weight stored (in, out) and is
    transposed to (out, in); every other leaf keeps its shape.
    """
    state = {}
    for name, value in _flatten(params):
        array = np.asarray(value, dtype=np.float32)
        if name.endswith("weight") and array.ndim == 2:
            array = array.T
        state[name] = torch.tensor(array)
    return state


# Reference vitef names that differ from the port's; all others are equal.
_RENAMES = {
    "embedding.patching.patching.0.weight": "embedding.patching.conv.weight",
    "embedding.patching.patching.0.bias": "embedding.patching.conv.bias",
    "output.output_layer.output_norm.weight": "output.output_layer.norm.weight",
    "output.output_layer.output_norm.bias": "output.output_layer.norm.bias",
    "output.output_layer.output.weight": "output.output_layer.head.weight",
    "output.output_layer.output.bias": "output.output_layer.head.bias",
}


def from_vitef_state_dict(sd: dict[str, np.ndarray], n_layers: int) -> dict[str, torch.Tensor]:
    """Reference vitef-named, torch-layout state dict -> port state dict.

    Linear weights are (out, in) on both sides; the Conv2d patch weight
    (E, C, P, P) flattens to (E, C·P·P) in (c, p1, p2) order.
    """
    state = {}
    for name, value in sd.items():
        array = np.asarray(value, dtype=np.float32)
        if name == "embedding.patching.patching.0.weight":
            array = array.reshape(array.shape[0], -1)
        state[_RENAMES.get(name, name)] = torch.tensor(array)
    n_found = len({k.split(".")[1] for k in state if k.startswith("blocks.")})
    if n_found != n_layers:
        raise ValueError(f"state dict has {n_found} blocks, the model {n_layers}")
    return state
