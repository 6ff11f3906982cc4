"""Theoretical plasticity upper bounds of a ViT's components, and the token
radius r they depend on. Counterpart of ``apps/plots/theory.py``.

    python -m vitef_tpu_torch.apps.plots.theory radius|save|plot [--device cpu]

- :func:`get_radius`: the mean float32 norm of the ViT's token embeddings
  (patch embedding, cls token, positions) over a dataset's test split,
  computed on the model's device; r = 19.4 for CIFAR-10 with the published
  in21k ViT-B/16.
- :func:`norm_ub`: the largest LayerNorm weight of each block;
  :func:`linear_ub`: the top singular value of fc1 and fc2;
  :func:`attention_ub`: Σ_h σ(O_h)·σ(V_h)·√(3L + (12L+3)·r⁴·σ(QK_h)²).
  The singular values are ``torch.linalg.svdvals`` in float32 on the
  model's device (cuSOLVER's ``gesvd`` on CUDA).

The port's weights are stored (out, in), as the original torch ones are, and
each head's sub-matrix is sliced by its input columns as the original does:
the same matrix the JAX package takes from its (in, out) weights, so the
bounds are the same. Without the published weights
(``checkpoints/vit/vit-<size>-patch<p>-224-in21k.npz``) the model keeps its
random init from seed 0, with a warning, as the JAX package's does. The entry
points run on the card unless ``device="cpu"``; without one they raise.
``save`` pickles a model's bounds to ``<SAVING_DIR>/theory/``, and
``plot --saved`` draws them from there, on a machine with matplotlib.
"""

from __future__ import annotations

import logging
import math
import pickle
from pathlib import Path

import numpy as np
import torch

from ...config import SAVING_DIR
from ...data.images import build_loader, make_iterable
from ...models import build_model
from ...utils.cli import make_cli
from ..vit.utils import resolve_device
from .common import ALPHA_GRID, COLORS, FONTSIZE, save_plot, set_style

logger = logging.getLogger("vitef")

VIT_COMPONENTS = ["LN1", "MHA", "LN2", "FC1", "FC2"]
N_LAYERS = {"base": 12, "large": 24, "huge": 32}
N_HEADS = {"base": 12, "large": 16, "huge": 16}
EMB_DIM = {"base": 768, "large": 1024, "huge": 1280}
SEQ_LEN = {14: 257, 16: 197}
LINEWIDTH = 5

SAVE_DIR = SAVING_DIR / "theory"


def _build_vit(model_name: str, patch_size: int, device: torch.device):
    return build_model(
        {"implementation": "vit", "model_name": model_name, "pretrained": True,
         "in21k": True, "patch_size": patch_size, "image_dim": (3, 224, 224)},
        device=device, generator=torch.Generator().manual_seed(0))


def get_radius(model_name: str, patch_size: int, dataset_name: str, batch_size: int,
               max_steps: int, data_dir: str | None = None, device: str = "cuda") -> float:
    """The mean token-embedding norm over ``max_steps`` test batches (the
    loader cycles), each batch's mean taken on the device and all of them
    copied to the host once."""
    device = resolve_device(device)
    loader_config = {"dataset_name": dataset_name, "batch_size": batch_size,
                     "mode": "test", "size": 224}
    if data_dir:
        loader_config["save_dir"] = data_dir
    loader = build_loader(loader_config, device=device, drop_last=False)
    model = _build_vit(model_name, patch_size, device)

    means = torch.empty(max_steps, device=device)
    iterator = iter(make_iterable(loader))
    with torch.inference_mode():
        for step in range(max_steps):
            x_batch, _ = next(iterator)
            emb = model.module.embedding(x_batch).float()
            means[step] = emb.square().sum(dim=-1).sqrt().mean()
    r = float(np.mean(means.cpu().numpy().astype(np.float64)))
    print("The radius of the token embedding space is: r =", np.round(r, 2))
    return r


def _top_sv(w: torch.Tensor) -> float | list[float]:
    """The largest singular value of ``w`` (m, n), or of each matrix of a
    batch (..., m, n), in float32 on ``w``'s device. On CUDA through
    cuSOLVER's QR-based ``gesvd``: the default Jacobi solver is off by up to
    1.1e-4 relative on these matrices, ``gesvd`` by 1.2e-7
    (``tools/profile_svd_drivers.py``)."""
    w = w.float()
    return torch.linalg.svdvals(w, driver="gesvd" if w.is_cuda else None)[..., 0].tolist()


def norm_ub(model_name: str, patch_size: int, model=None,
            device: str = "cuda") -> tuple[list, list]:
    """The largest attn_norm and ffn_norm weight of each block."""
    model = model or _build_vit(model_name, patch_size, resolve_device(device))
    attn_norm_ub, ffn_norm_ub = [], []
    with torch.no_grad():
        for block in model.module.blocks:
            attn_norm_ub.append(float(block.attn_norm.weight.max()))
            ffn_norm_ub.append(float(block.ffn_norm.weight.max()))
    return attn_norm_ub, ffn_norm_ub


def linear_ub(model_name: str, patch_size: int, model=None,
              device: str = "cuda") -> tuple[list, list]:
    """The top singular value of fc1 and fc2 in each block."""
    model = model or _build_vit(model_name, patch_size, resolve_device(device))
    fc1_ub, fc2_ub = [], []
    with torch.no_grad():
        for block in model.module.blocks:
            fc1_ub.append(_top_sv(block.ffn.fc1.weight))
            fc2_ub.append(_top_sv(block.ffn.fc2.weight))
    return fc1_ub, fc2_ub


def head_columns(w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(out, n_heads * d) -> (n_heads, out, d): head h's columns of ``w``."""
    out, width = w.shape
    return w.reshape(out, n_heads, width // n_heads).permute(1, 0, 2)


def attention_ub(model_name: str, patch_size: int, r: float, model=None,
                 device: str = "cuda") -> list:
    """The MHA bound of each block, Σ_h σ(O_h)·σ(V_h)·√(3L + (12L+3)·r⁴·σ(QK_h)²),
    with head h's columns (input dims) of the (out, in) output, value, query
    and key matrices and QK_h = Q_h K_hᵀ / √d. A block's heads go to
    ``torch.linalg.svdvals`` as one batch of each kind. QK_h (E x E, rank d)
    is not formed: with thin QR factors Q_h = U_Q R_Q and K_h = U_K R_K,
    Q_h K_hᵀ = U_Q (R_Q R_Kᵀ) U_Kᵀ has the singular values of the d x d
    R_Q R_Kᵀ: 40-58 ms a block's batch on the card against 0.66-1.54 s for the
    E x E products (``tools/profile_svd_drivers.py``)."""
    model = model or _build_vit(model_name, patch_size, resolve_device(device))
    n_heads = N_HEADS[model_name]
    emb_dim = EMB_DIM[model_name]
    seq_len = SEQ_LEN[patch_size]
    d = emb_dim // n_heads
    mha_ub = []
    with torch.no_grad():
        for block in model.module.blocks:
            w_qkv = block.attn.qkv_mat.weight.float()  # (3E, E): [q | k | v] rows
            q, k, v = (head_columns(w, n_heads) for w in w_qkv.split(emb_dim))
            o_h = _top_sv(head_columns(block.attn.output.weight, n_heads))
            v_h = _top_sv(v)
            r_q, r_k = torch.linalg.qr(q, mode="r").R, torch.linalg.qr(k, mode="r").R
            s_qk = _top_sv(r_q @ r_k.transpose(1, 2) / math.sqrt(d))
            comp = 0.0
            for i in range(n_heads):
                comp += o_h[i] * v_h[i] * math.sqrt(
                    3 * seq_len + (12 * seq_len + 3) * r**4 * s_qk[i]**2)
            mha_ub.append(comp)
    return mha_ub


def get_theoretical_bounds(model_name: str, patch_size: int, r: float = 19.4,
                           device: str = "cuda") -> tuple:
    """(LN1, MHA, LN2, FC1, FC2), each a list of per-block bounds."""
    model = _build_vit(model_name, patch_size, resolve_device(device))
    LN1, LN2 = norm_ub(model_name, patch_size, model=model)
    FC1, FC2 = linear_ub(model_name, patch_size, model=model)
    MHA = attention_ub(model_name, patch_size, r, model=model)
    return LN1, MHA, LN2, FC1, FC2


def bounds_path(model_name: str, patch_size: int) -> Path:
    return SAVE_DIR / f"bounds_{model_name}_patch{patch_size}.pkl"


def save_bounds(model_name: str = "base", patch_size: int = 16, r: float = 19.4,
                device: str = "cuda") -> Path:
    """Compute one model's bounds and pickle them, for a machine that draws
    them (``plot --saved``)."""
    bounds = get_theoretical_bounds(model_name, patch_size, r=r, device=device)
    path = bounds_path(model_name, patch_size)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(bounds, f)
    logger.info("Wrote %s", path)
    return path


def plot_theoretical_bounds(model_name: str, patch_size: int, r: float = 19.4,
                            save: bool = False, ncol: int = 6, device: str = "cuda",
                            bounds: tuple | None = None) -> None:
    """Log-scale per-depth bound curves. ``bounds`` (as
    :func:`get_theoretical_bounds` returns them, e.g. computed on the card and
    pickled) skips the computation."""
    set_style()
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 4))
    n_layers = N_LAYERS[model_name]
    x_range = np.arange(n_layers) / (n_layers - 1) * 100
    if bounds is None:
        bounds = get_theoretical_bounds(model_name, patch_size, r=r, device=device)
    for j, comp in enumerate(VIT_COMPONENTS):
        plt.plot(x_range, bounds[j], label=comp, color=COLORS[comp], linewidth=LINEWIDTH)
    ax = fig.axes[0]
    ax.set_yscale("log")
    ax.grid(alpha=ALPHA_GRID, lw=1.3)
    ax.set_xticks([0, 50, 100])
    ax.set_xlabel("Layer Depth (%)", fontsize=FONTSIZE)
    ax.set_ylabel("Plasticity Upper Bound", fontsize=FONTSIZE)
    fig.legend(loc="upper center", bbox_to_anchor=(0.5, 1.08), ncol=ncol,
               fontsize=FONTSIZE, frameon=True)
    plt.tight_layout()
    if save:
        save_plot("theoretical_bounds", subdir="theory")
    plt.close(fig)


def print_radius(device: str = "cuda") -> None:
    get_radius(model_name="base", patch_size=16, dataset_name="cifar10", batch_size=16,
               max_steps=1000, device=device)


def plot_figures(device: str = "cuda", saved: bool = False) -> None:
    bounds = None
    if saved:
        with open(bounds_path("base", 16), "rb") as f:
            bounds = pickle.load(f)
    plot_theoretical_bounds(model_name="base", patch_size=16, save=True, device=device,
                            bounds=bounds)


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(levelname)s] %(filename)s:%(lineno)d - %(message)s",
        handlers=[logging.StreamHandler()])
    make_cli({"radius": print_radius, "save": save_bounds, "plot": plot_figures}, argv)


if __name__ == "__main__":
    main()
