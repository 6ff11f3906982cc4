"""Plasticity figures: the boxplot against the theoretical rank and the
per-depth curves. Counterpart of ``apps/plots/analysis.py``.

    python -m vitef_tpu_torch.apps.plots.analysis plot

It reads the ``distances.pkl`` that ``vitef_tpu_torch.apps.vit.analysis``
writes under ``<SAVING_DIR>/analysis/analysis_<model>_pretrained_<bool>_<dataset>``.
The plasticity statistic is dist(component) / dist(embedding), the
components ordered [LN1, MHA, LN2, FC1, FC2] with theoretical ranks
(5, 1, 4, 2, 3). matplotlib and seaborn are imported inside the functions
that draw.
"""

from __future__ import annotations

import logging
import pickle
from pathlib import Path

import numpy as np

from ...utils.cli import make_cli

from .common import ALPHA_GRID, ANALYSIS_DIR, COLORS, FONTSIZE, save_plot, set_style

logger = logging.getLogger("vitef")

SAVE_DIR = ANALYSIS_DIR

# Decomposition key order: attn_norm, attn, ffn_norm, ffn_fc1, ffn_fc2
VIT_COMPONENTS = ["LN1", "MHA", "LN2", "FC1", "FC2"]
PLASTICITY_RANK = [5, 1, 4, 2, 3]  # theoretical ranks per component above
N_LAYERS = {"base": 12, "large": 24, "huge": 32}
MODEL_NAMES = {"base": "ViT-Base", "large": "ViT-Large", "huge": "ViT-Huge"}
LINEWIDTH = 5
ALPHA_CI = 0.8


def get_plasticity(path) -> dict:
    """Per-component list of per-block plasticity ratios (reference :74-108)."""
    with open(Path(path) / "distances.pkl", "rb") as f:
        distances = pickle.load(f)
    inputs = np.asarray(distances.pop("embedding")).flatten()
    dict_df: dict = {}
    for key, values in distances.items():
        _, component = key.split("_", 1)
        dict_df.setdefault(component, []).append(
            np.asarray(values).flatten() / inputs
        )
    return dict_df


def get_config(dataset_name: str, model_name: str, pretrained: bool = True) -> str:
    """Analysis artifact dir name (reference :113-127)."""
    patch = 14 if model_name == "huge" else 16
    return (f"analysis_vit-{model_name}-patch{patch}-224-in21k"
            f"_pretrained_{pretrained}_{dataset_name}")


def _plot_rank_boxplot(ax, dict_df):
    import seaborn as sns

    ranks, values = [], []
    for j, key in enumerate(dict_df):
        per_block_means = np.mean(np.asarray(dict_df[key]), axis=-1)
        ranks.extend([PLASTICITY_RANK[j]] * len(per_block_means))
        values.extend(per_block_means.tolist())
    colors = [COLORS[k] for k in ["MHA", "FC1", "FC2", "LN2", "LN1"]]
    sns.boxplot(x=ranks, y=values, hue=ranks, palette=colors, legend=False,
                showfliers=False, ax=ax)
    ax.grid(axis="y", alpha=ALPHA_GRID, lw=1.3)
    ax.set_xlabel(r"Theoretical Plasticity Rank ($\downarrow$)", fontsize=FONTSIZE)
    ax.set_ylabel(r"Plasticity $\mathscr{P}(f)$", fontsize=FONTSIZE)


def _plot_depth_curves(ax, dict_df, n_layers: int):
    x_range = np.arange(n_layers) / (n_layers - 1) * 100
    for j, key in enumerate(dict_df):
        ratio = np.asarray(dict_df[key])
        mean = np.mean(ratio, axis=-1)
        std = np.std(ratio, axis=-1)
        ci = 1.96 * std / np.sqrt(ratio.shape[-1])
        comp = VIT_COMPONENTS[j]
        ax.plot(x_range[: len(mean)], mean, linewidth=LINEWIDTH,
                color=COLORS[comp], label=comp)
        ax.fill_between(x_range[: len(mean)], mean - ci, mean + ci,
                        color=COLORS[comp], alpha=ALPHA_CI)
    ax.grid(alpha=ALPHA_GRID, lw=1.3)
    ax.set_xticks([0, 50, 100])
    ax.set_xlabel("Layer Depth (%)", fontsize=FONTSIZE)
    ax.set_ylabel(r"Plasticity $\mathscr{P}(f)$", fontsize=FONTSIZE)


def get_all_plasticity(dataset_name: str, pretrained: bool, save: bool = False,
                       ncol: int = 6, model_names: tuple = ("base", "huge")) -> None:
    """Rank boxplot (base) + per-depth curves (base, huge) (reference :127-295).

    ``model_names`` lets callers restrict to the artifacts that exist (the
    reference hardcodes base + huge).
    """
    set_style()
    import matplotlib.pyplot as plt

    ncols = 1 + len(model_names)
    fig, axes = plt.subplots(ncols=ncols, figsize=(4 * ncols, 4), squeeze=False)
    axes = axes[0]

    base_cfg = get_config(dataset_name, "base", pretrained=True)
    _plot_rank_boxplot(axes[0], get_plasticity(SAVE_DIR / base_cfg))
    axes[0].set_title(MODEL_NAMES["base"])

    for i, model_name in enumerate(model_names):
        cfg = get_config(dataset_name, model_name, pretrained=True)
        _plot_depth_curves(axes[1 + i], get_plasticity(SAVE_DIR / cfg),
                           N_LAYERS[model_name])
        axes[1 + i].set_title(MODEL_NAMES[model_name])
    axes[-1].legend(fontsize=10, ncol=2)

    plt.tight_layout()
    if save:
        save_plot(f"plasticity_{dataset_name}", subdir="analysis")
    plt.close(fig)


def plot_figures() -> None:
    dataset_names = [
        "cifar10", "cifar100",
        "cifar10_c-corruption-contrast-severity-5",
        "cifar10_c-corruption-gaussian_noise-severity-5",
        "cifar10_c-corruption-motion_blur-severity-5",
        "cifar10_c-corruption-snow-severity-5",
        "cifar10_c-corruption-speckle_noise-severity-5",
        "domainnet-clipart", "domainnet-sketch", "flowers102", "pet",
    ]
    for dataset_name in dataset_names:
        get_all_plasticity(dataset_name, pretrained=True, save=True)


def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(levelname)s] %(filename)s:%(lineno)d - %(message)s",
        handlers=[logging.StreamHandler()],
    )
    make_cli({"plot": plot_figures})


if __name__ == "__main__":
    main()
