"""Weight converters into the port's state dicts.

Counterpart of ``vitef_tpu/models/torch_import.py``. The port's parameter
names are the JAX package's tree paths, dotted (``blocks.0.attn.qkv_mat.weight``).

- :func:`from_jax_params` carries a ``vitef_tpu`` parameter tree (numpy
  leaves) across, name for name. The JAX package stores linear weights
  (in, out); the port stores (out, in). That transpose is made here and
  nowhere else. The ``dict`` token embedding (V, E) is a table, not a
  linear weight, and keeps its layout; the ``linear`` one (PatchTST's, with
  a bias) is a linear weight. Batch norms' running statistics and the
  forecasting head carry across under their names. Llama trees take the same rule: the
  packed qkv (E, E + 2·kv_dim) and swiglu fc1 (E, 2F) transpose whole, so
  their [q | k | v] and [gate | up] column blocks become row blocks, and
  the untied head (E, V) becomes (V, E). MoE trees take it too: the
  router (E_model, n_experts) is a 2-D weight and becomes (n_experts,
  E_model), while the 3-D expert stacks (n_experts, in, out) and the
  (n_experts, ·) expert biases keep their layout, which the port's grouped
  kernels read as they are.
- :func:`to_jax_params` is its inverse: a port state dict as host arrays
  under the same dotted names in the JAX layout, which is how
  ``model.npz`` checkpoints hold parameters, so that either package loads
  the other's.
- :func:`from_vitef_state_dict` loads a torch-layout state dict with the
  reference vitef names (the ``checkpoints/{vit,gpt2}/<name>.npz`` caches;
  the inverse direction of ``torch_import.from_vitef_state_dict``), which
  :func:`load_weight_cache` reads; batch norms come in the reference's
  ``BatchNorm1d`` wrapper names.
- :func:`cache_from_jax` carries a ``vitef_tpu`` KV cache across (the
  serving path's per-layer K/V buffers), so that a decode step can be held
  against the JAX package's from one cache.
- :func:`hf_gpt2_to_vitef` renames a HuggingFace ``GPT2LMHeadModel`` state
  dict to those reference names (``torch_import.hf_gpt2_to_vitef`` :169-198),
  :func:`hf_llama_to_vitef` a ``LlamaForCausalLM`` one (:201-229) and
  :func:`hf_vit_to_vitef` a ``ViTForImageClassification`` one (:129-166).
  Each converts a state dict already on disk; nothing is downloaded.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)


def load_weight_cache(model_name: str, save_dir) -> dict[str, np.ndarray] | None:
    """The vitef-named torch-layout state dict cached as
    ``<save_dir>/<model_name>.npz``, else ``.pt``; None, with a warning, when
    neither exists (the JAX loaders' order, ``vitef_tpu/models/vit.py:121-151``,
    without their download)."""
    save_dir = Path(save_dir)
    npz_path = save_dir / f"{model_name}.npz"
    if npz_path.exists():
        logger.info("Loading %s from %s", model_name, npz_path)
        with np.load(npz_path) as z:
            return {k: z[k] for k in z.files}
    pt_path = save_dir / f"{model_name}.pt"
    if pt_path.exists():
        logger.info("Loading %s from %s", model_name, pt_path)
        sd = torch.load(pt_path, map_location="cpu", weights_only=True)
        return {k: v.numpy() for k, v in sd.items()}
    logger.warning("Could not load pretrained weights for %s: neither %s nor %s exists",
                   model_name, npz_path, pt_path)
    return None


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flatten(value, f"{prefix}.{key}" if prefix else str(key))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _flatten(value, f"{prefix}.{i}" if prefix else str(i))
    else:
        yield prefix, tree


# The token embedding: the emb_type='dict' table, (V, E) in both packages,
# unless the tree also holds its bias: then it is the 'linear' embedding.
_TABLE, _TABLE_BIAS = "embedding.token_emb.weight", "embedding.token_emb.bias"


def _transposed(name: str, ndim: int, names) -> bool:
    """Whether the leaf ``name`` is a linear weight, (in, out) in the JAX
    layout and (out, in) in the port's: a 2-D ``weight`` other than the
    ``dict`` token table."""
    return (name.endswith("weight") and ndim == 2
            and (name != _TABLE or _TABLE_BIAS in names))


def from_jax_params(params) -> dict[str, torch.Tensor]:
    """``vitef_tpu`` parameter tree (nested dicts/lists of arrays) -> port state dict.

    Every 2-D ``weight`` but the ``dict`` token table is a linear weight
    stored (in, out) and is transposed to (out, in), the ``linear`` token
    embedding's among them; every other leaf keeps its shape (the MoE expert
    stacks and their biases, and batch norms' running statistics, among
    them).
    """
    flat = dict(_flatten(params))
    state = {}
    for name, value in flat.items():
        array = np.asarray(value, dtype=np.float32)
        if _transposed(name, array.ndim, flat):
            array = array.T
        state[name] = torch.tensor(array)
    return state


def to_jax_params(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Port state dict -> ``{dotted name: host array}`` in the JAX layout, the
    inverse of :func:`from_jax_params`: every 2-D ``weight`` but the ``dict``
    token table is transposed to (in, out), every other tensor keeps its
    shape and dtype. The arrays are copies (off the card, synchronously)."""
    out = {}
    for name, value in state.items():
        value = value.detach()
        if _transposed(name, value.dim(), state):
            value = value.t().contiguous()
        out[name] = value.to("cpu", copy=True).numpy()
    return out


def _array_to_tensor(array) -> torch.Tensor:
    """A numpy array (bfloat16 ones from ``ml_dtypes`` included) as a tensor
    of the same dtype and values."""
    array = np.asarray(array)
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(array.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(array))


def cache_from_jax(cache) -> list[dict[str, torch.Tensor]]:
    """A ``vitef_tpu`` KV cache (``init_kv_cache``/``prefill``: a list of
    per-layer dicts of arrays) -> the port's, as CPU tensors (move them with
    ``.to``, as ``from_jax_params``'s). The layouts are
    the same: ``k`` and ``v`` (N, n_kv_heads, max_len, head_dim) in the
    compute dtype or int8, and an int8 cache's ``k_scale`` and ``v_scale``
    (N, n_kv_heads, max_len) float32; every value keeps its dtype."""
    return [{name: _array_to_tensor(value) for name, value in layer.items()}
            for layer in cache]


# Reference vitef names that differ from the port's; all others are equal.
_RENAMES = {
    "embedding.patching.patching.0.weight": "embedding.patching.conv.weight",
    "embedding.patching.patching.0.bias": "embedding.patching.conv.bias",
    "output.output_layer.output_norm.weight": "output.output_layer.norm.weight",
    "output.output_layer.output_norm.bias": "output.output_layer.norm.bias",
    "output.output_layer.output_norm.running_mean": "output.output_layer.norm.running_mean",
    "output.output_layer.output_norm.running_var": "output.output_layer.norm.running_var",
    "output.output_layer.output.weight": "output.output_layer.head.weight",
    "output.output_layer.output.bias": "output.output_layer.head.bias",
}


def from_vitef_state_dict(sd: dict[str, np.ndarray], n_layers: int, *,
                          weight_tying: bool = False) -> dict[str, torch.Tensor]:
    """Reference vitef-named, torch-layout state dict -> port state dict.

    Linear weights are (out, in) on both sides; the Conv2d patch weight
    (E, C, P, P) flattens to (E, C·P·P) in (c, p1, p2) order. A batch norm
    in the reference's wrapper, ``<prefix>.batchnorm.{weight, bias,
    running_mean, running_var}``, loses the ``batchnorm`` level, and its
    ``num_batches_tracked`` is dropped (``torch_import.py:65-82``). With
    ``weight_tying`` the seq2seq head reads the token embedding, so the
    dict's head copy (``output.output_layer.output.weight``) is dropped, as
    the JAX package drops it (``gpt2.py:100-102``).
    """
    state = {}
    for name, value in sd.items():
        if weight_tying and name == "output.output_layer.output.weight":
            continue
        if name.endswith(".batchnorm.num_batches_tracked"):
            continue
        name = name.replace(".batchnorm.", ".")
        array = np.asarray(value, dtype=np.float32)
        if name == "embedding.patching.patching.0.weight":
            array = array.reshape(array.shape[0], -1)
        state[_RENAMES.get(name, name)] = torch.tensor(array)
    n_found = len({k.split(".")[1] for k in state if k.startswith("blocks.")})
    if n_found != n_layers:
        raise ValueError(f"state dict has {n_found} blocks, the model {n_layers}")
    return state


def hf_gpt2_to_vitef(hf: dict[str, np.ndarray], n_layers: int) -> dict[str, np.ndarray]:
    """HuggingFace ``GPT2LMHeadModel`` state dict -> reference vitef names,
    torch layout (numpy arrays). HF's Conv1D weights are (in, out) and are
    transposed to the Linear layout (out, in); ``wpe`` gets a leading batch
    axis."""
    def t(x):
        return np.ascontiguousarray(np.asarray(x).T)

    out = {
        "embedding.token_emb.weight": hf["transformer.wte.weight"],
        "embedding.pos_emb": hf["transformer.wpe.weight"][None],
        "output.output_layer.output_norm.weight": hf["transformer.ln_f.weight"],
        "output.output_layer.output_norm.bias": hf["transformer.ln_f.bias"],
        "output.output_layer.output.weight": hf["lm_head.weight"],
    }
    for i in range(n_layers):
        h, v = f"transformer.h.{i}.", f"blocks.{i}."
        out[v + "attn_norm.weight"] = hf[h + "ln_1.weight"]
        out[v + "attn_norm.bias"] = hf[h + "ln_1.bias"]
        out[v + "attn.qkv_mat.weight"] = t(hf[h + "attn.c_attn.weight"])
        out[v + "attn.qkv_mat.bias"] = hf[h + "attn.c_attn.bias"]
        out[v + "attn.output.weight"] = t(hf[h + "attn.c_proj.weight"])
        out[v + "attn.output.bias"] = hf[h + "attn.c_proj.bias"]
        out[v + "ffn_norm.weight"] = hf[h + "ln_2.weight"]
        out[v + "ffn_norm.bias"] = hf[h + "ln_2.bias"]
        out[v + "ffn.fc1.weight"] = t(hf[h + "mlp.c_fc.weight"])
        out[v + "ffn.fc1.bias"] = hf[h + "mlp.c_fc.bias"]
        out[v + "ffn.fc2.weight"] = t(hf[h + "mlp.c_proj.weight"])
        out[v + "ffn.fc2.bias"] = hf[h + "mlp.c_proj.bias"]
    return out


def hf_llama_to_vitef(hf: dict[str, np.ndarray], n_layers: int) -> dict[str, np.ndarray]:
    """HuggingFace ``LlamaForCausalLM`` state dict -> reference vitef names,
    torch layout (numpy arrays). q/k/v concatenate into the packed qkv (k and
    v are n_kv_heads wide), gate_proj/up_proj into the packed swiglu fc1
    ([gate | up]); the rms norms have no bias and the head is untied. HF
    stores q and k in the rotate_half RoPE convention that ``rope.py``
    implements, so the weights carry over unchanged."""
    out = {
        "embedding.token_emb.weight": hf["model.embed_tokens.weight"],
        "output.output_layer.output_norm.weight": hf["model.norm.weight"],
        "output.output_layer.output.weight": hf["lm_head.weight"],
    }
    for i in range(n_layers):
        h, v = f"model.layers.{i}.", f"blocks.{i}."
        out[v + "attn_norm.weight"] = hf[h + "input_layernorm.weight"]
        out[v + "ffn_norm.weight"] = hf[h + "post_attention_layernorm.weight"]
        out[v + "attn.qkv_mat.weight"] = np.concatenate(
            [hf[h + f"self_attn.{m}_proj.weight"] for m in ("q", "k", "v")], axis=0)
        out[v + "attn.output.weight"] = hf[h + "self_attn.o_proj.weight"]
        out[v + "ffn.fc1.weight"] = np.concatenate(
            [hf[h + "mlp.gate_proj.weight"], hf[h + "mlp.up_proj.weight"]], axis=0)
        out[v + "ffn.fc2.weight"] = hf[h + "mlp.down_proj.weight"]
    return out


def hf_vit_to_vitef(hf: dict[str, np.ndarray], n_layers: int) -> dict[str, np.ndarray]:
    """HuggingFace ``ViTForImageClassification`` state dict -> reference vitef
    names, torch layout (numpy arrays), as :func:`load_weight_cache` reads
    them. q/k/v (weights and biases) concatenate into the packed qkv; the
    patch projection keeps its Conv2d shape."""
    out = {
        "embedding.cls_token": hf["vit.embeddings.cls_token"],
        "embedding.patching.patching.0.weight":
            hf["vit.embeddings.patch_embeddings.projection.weight"],
        "embedding.patching.patching.0.bias": hf["vit.embeddings.patch_embeddings.projection.bias"],
        "embedding.pos_emb": hf["vit.embeddings.position_embeddings"],
        "output.output_layer.output_norm.weight": hf["vit.layernorm.weight"],
        "output.output_layer.output_norm.bias": hf["vit.layernorm.bias"],
        "output.output_layer.output.weight": hf["classifier.weight"],
        "output.output_layer.output.bias": hf["classifier.bias"],
    }
    for i in range(n_layers):
        h, v = f"vit.encoder.layer.{i}.", f"blocks.{i}."
        out[v + "attn_norm.weight"] = hf[h + "layernorm_before.weight"]
        out[v + "attn_norm.bias"] = hf[h + "layernorm_before.bias"]
        out[v + "attn.output.weight"] = hf[h + "attention.output.dense.weight"]
        out[v + "attn.output.bias"] = hf[h + "attention.output.dense.bias"]
        out[v + "ffn_norm.weight"] = hf[h + "layernorm_after.weight"]
        out[v + "ffn_norm.bias"] = hf[h + "layernorm_after.bias"]
        out[v + "ffn.fc1.weight"] = hf[h + "intermediate.dense.weight"]
        out[v + "ffn.fc1.bias"] = hf[h + "intermediate.dense.bias"]
        out[v + "ffn.fc2.weight"] = hf[h + "output.dense.weight"]
        out[v + "ffn.fc2.bias"] = hf[h + "output.dense.bias"]
        for kind in ("weight", "bias"):
            out[v + f"attn.qkv_mat.{kind}"] = np.concatenate(
                [hf[h + f"attention.attention.{m}.{kind}"] for m in ("query", "key", "value")],
                axis=0)
    return out
