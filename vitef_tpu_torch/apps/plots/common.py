"""Shared constants, naming maps and plotting style of the plots layer.
Counterpart of ``apps/plots/common.py``, its constants copied verbatim: they
are the data contract between the run names and the figure code.

The artifact dirs come from :mod:`vitef_tpu_torch.config`. ``set_style`` and
``save_plot`` import matplotlib and seaborn inside the function.
"""

from __future__ import annotations

from pathlib import Path

from ...config import FIGURE_DIR, RESULT_DIR, SAVING_DIR

RUNS_DIR = SAVING_DIR / "runs"
PROBES_DIR = SAVING_DIR / "probes"
ANALYSIS_DIR = SAVING_DIR / "analysis"

# Trainable components in the ViT (reference finetuning.py:36-46)
VIT_COMPONENTS = ["LN1", "MHA", "LN2", "FC1", "FC2"]
VIT_COMPONENTS_MAP = {
    "all": "All",
    "attn_norm": "LN1",
    "mha": "MHA",
    "ffn_norm": "LN2",
    "ffn_fc1": "FC1",
    "ffn_fc2": "FC2",
}

# Learning-rate sweeps per dataset (reference finetuning.py:49-61)
LR_VALUES = {
    "cifar10": ["1e-3", "3e-3", "1e-2", "3e-2"],
    "cifar100": ["1e-3", "3e-3", "1e-2", "3e-2"],
    "cifar10_c_contrast_5": ["1e-3", "3e-3", "1e-2", "3e-2"],
    "cifar10_c_gaussian_noise_5": ["1e-3", "3e-3", "1e-2", "3e-2"],
    "cifar10_c_motion_blur_5": ["1e-3", "3e-3", "1e-2", "3e-2"],
    "cifar10_c_snow_5": ["1e-3", "3e-3", "1e-2", "3e-2"],
    "cifar10_c_speckle_noise_5": ["1e-3", "3e-3", "1e-2", "3e-2"],
    "domainnet_clipart": ["3e-3", "1e-2", "3e-2", "6e-2"],
    "domainnet_sketch": ["3e-3", "1e-2", "3e-2", "6e-2"],
    "flowers102": ["1e-3", "3e-3", "1e-2", "3e-2"],
    "pet": ["1e-3", "3e-3", "1e-2", "3e-2"],
}

# Pretty dataset names (reference finetuning.py:64-76)
DATASET_MAP = {
    "cifar10": "Cifar10",
    "cifar100": "Cifar100",
    "cifar10_c_contrast_5": "Contrast",
    "cifar10_c_gaussian_noise_5": "Gaussian Noise",
    "cifar10_c_motion_blur_5": "Motion Blur",
    "cifar10_c_snow_5": "Snow",
    "cifar10_c_speckle_noise_5": "Speckle Noise",
    "domainnet_clipart": "Clipart",
    "domainnet_sketch": "Sketch",
    "pet": "Pet",
    "flowers102": "Flowers102",
}

# Encoded dataset names used by probes/analysis artifacts
# (reference finetuning.py:258-268, 375-385)
CORRUPTION_DATASET_MAP = {
    "cifar10_c_contrast_5": "cifar10_c-corruption-contrast-severity-5",
    "cifar10_c_gaussian_noise_5": "cifar10_c-corruption-gaussian_noise-severity-5",
    "cifar10_c_motion_blur_5": "cifar10_c-corruption-motion_blur-severity-5",
    "cifar10_c_snow_5": "cifar10_c-corruption-snow-severity-5",
    "cifar10_c_speckle_noise_5": "cifar10_c-corruption-speckle_noise-severity-5",
}
DOMAINNET_DATASET_MAP = {
    "domainnet_clipart": "domainnet-clipart",
    "domainnet_sketch": "domainnet-sketch",
}


def encoded_dataset_name(dataset_name: str) -> str:
    """Map a plot-layer dataset key to the loader's encoded name."""
    if "cifar10_c" in dataset_name:
        return CORRUPTION_DATASET_MAP[dataset_name]
    if "domainnet" in dataset_name:
        return DOMAINNET_DATASET_MAP[dataset_name]
    return dataset_name


# Figure style (reference finetuning.py:79-108)
WIDTH = 6
HEIGHT = 5
FONTSIZE = 15
FONTSIZE_LEGEND = 15
LINEWIDTH = 5
ALPHA_GRID = 0.8
COLORS = {
    "LN1": "#daa4ac",
    "MHA": "#37abb5",
    "LN2": "#b153a1",
    "FC1": "#a291e1",
    "FC2": "#858ec2",
}

_STYLE_SET = False


def set_style() -> None:
    """Apply the paper's seaborn/matplotlib style (idempotent)."""
    global _STYLE_SET
    if _STYLE_SET:
        return
    import matplotlib

    matplotlib.use("Agg")  # headless
    import matplotlib.pyplot as plt
    import seaborn as sns

    sns.set_theme(style="ticks", palette=sns.cubehelix_palette(),
                  rc={"axes.grid": False})
    sns.set_context("talk")
    plt.rcParams.update({"figure.autolayout": True})
    plt.rcParams["mathtext.fontset"] = "stix"
    _STYLE_SET = True


def save_plot(figname: str, subdir: str, format: str = "pdf", dpi: int = 100) -> Path:
    """Save current figure under figures/<subdir>/ (reference finetuning.py:413-418)."""
    import matplotlib.pyplot as plt

    figure_path = FIGURE_DIR / subdir
    figure_path.mkdir(parents=True, exist_ok=True)
    out = figure_path / f"{figname}.{format}"
    plt.savefig(out, format=format, bbox_inches="tight", dpi=dpi)
    return out


def results_dir(folder: str) -> Path:
    path = RESULT_DIR / folder
    path.mkdir(parents=True, exist_ok=True)
    return path
