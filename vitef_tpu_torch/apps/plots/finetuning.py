"""Results and figures of the finetuning runs: the csv / table / stat / plot
command lines. Counterpart of ``apps/plots/finetuning.py``, on the port's run
dirs (either package's will do: the contract is the same).

    python -m vitef_tpu_torch.apps.plots.finetuning csv|table|stat|plot

It reads ``<SAVING_DIR>/runs/vit_<dataset>_seed_<s>_lr_<lr>_comp_<c>/``,
``<SAVING_DIR>/probes/`` and ``<SAVING_DIR>/analysis/``, and writes
``results/{finetuning,linear_probing}/<dataset>.csv`` and
``figures/finetuning/*.pdf``. The run-dir readers (``get_single_exp``,
``get_runs``, ``get_single_exp_linear_probing``, ``get_sensitivity``) use
numpy only; the functions that build frames import pandas, and the figures
matplotlib and seaborn, inside the function, so that the module imports on a
machine without them.
"""

from __future__ import annotations

import json
import logging
import pickle
import re
from pathlib import Path

import numpy as np

from ...utils.cli import make_cli
from ...utils.jsonl import load_jsonl_to_numpy, read_jsonl

from .common import (
    ALPHA_GRID,
    ANALYSIS_DIR,
    COLORS,
    DATASET_MAP,
    FONTSIZE,
    HEIGHT,
    LR_VALUES,
    PROBES_DIR,
    RUNS_DIR,
    VIT_COMPONENTS_MAP,
    WIDTH,
    encoded_dataset_name,
    results_dir,
    save_plot,
    set_style,
)

logger = logging.getLogger("vitef")

ALL_COMPONENTS = ["emb", "attn_norm", "mha", "ffn_norm", "ffn_fc1", "ffn_fc2"]
PROBE_STAGES = ["attn_norm", "attn", "attn_res", "ffn_norm", "ffn_fc1",
                "ffn_activation", "ffn_fc2", "ffn_res"]
# Components ordered by theoretical plasticity rank 1..5 (MHA best)
RANK_ORDERED = ["mha", "ffn_fc1", "ffn_fc2", "ffn_norm", "attn_norm"]

ALL_DATASETS = [
    "cifar10", "cifar100", "cifar10_c_gaussian_noise_5",
    "cifar10_c_motion_blur_5", "cifar10_c_contrast_5", "cifar10_c_snow_5",
    "cifar10_c_speckle_noise_5", "domainnet_clipart", "domainnet_sketch",
    "flowers102", "pet",
]
DEFAULT_SEEDS = [0, 42, 3407]

# The paper's published accuracy table — the de-facto regression oracle
# (reference finetuning.py:1496-1506). Columns: MHA FC1 FC2 LN2 LN1 All LP.
PUBLISHED_RESULTS = """
Cifar10 98.91±0.07 99.09±0.05 98.91±0.06 98.72±0.05 98.67±0.03 99.02±0.02 91.95
Cifar100 92.65±0.07 92.85±0.07 92.31±0.11 91.93±0.11 91.43±0.07 92.74±0.05 65.43
Contrast 97.09±0.11 97.06±0.08 96.28±0.11 96.67±0.20 96.89±0.19 97.23±0.18 73.25
Gaussian Noise 89.41±0.53 89.49±0.16 88.49±0.51 89.55±0.04 88.99±0.24 87.14±1.16 49.20
Motion Blur 94.72±0.21 94.53±0.06 94.04±0.16 93.95±0.34 93.25±0.29 94.67±0.14 59.70
Snow 95.47±0.13 95.52±0.20 95.27±0.29 95.51±0.11 95.15±0.10 95.42±0.13 59.25
Speckle Noise 90.07±0.32 89.85±0.34 89.22±0.31 89.71±0.17 89.74±0.31 89.58±0.43 51.15
Clipart 77.31±0.41 76.47±0.24 76.54±0.17 74.37±0.08 74.65±0.16 78.50±0.49 42.76
Sketch 69.23±0.05 69.31±0.18 69.49±0.20 65.27±0.15 65.76±0.10 71.30±0.26 29.08
Flowers102 99.03±0.08 99.05±0.06 98.86±0.06 99.21±0.07 98.99±0.20 99.15±0.05 96.34
Pet 94.37±0.13 94.26±0.26 93.98±0.20 94.39±0.13 94.46±0.11 94.57±0.29 88.33
"""


# ----------------------------------------------------------------------------
# Aggregation (run dirs → arrays/CSVs)
# ----------------------------------------------------------------------------


def get_single_exp(dataset_name: str, seed: int, lr: str, comp: int,
                   prefix: str = "vit") -> tuple:
    """Training/validation curves + eval metadata for one run (reference :116-178)."""
    log_dir = RUNS_DIR / f"{prefix}_{dataset_name}_seed_{seed}_lr_{lr}_comp_{comp}"

    with open(log_dir / "config.json") as f:
        exp_config = json.load(f)
    info_model = read_jsonl(log_dir / "metrics" / "info_model.jsonl")[0]
    eval_file = read_jsonl(log_dir / "metrics" / "eval.jsonl")[0]

    checkpoint_step = sorted(
        p.name for p in (log_dir / "checkpoints").iterdir() if p.is_dir()
    )[-1]

    trainable = [c for c in ALL_COMPONENTS if c not in exp_config["components"]]
    if trainable == ALL_COMPONENTS:
        trainable = ["all"]
    eval_data = {
        "dataset_name": dataset_name,
        "seed": int(seed),
        "max_n_steps": exp_config["n_steps"],
        "lr": float(lr),
        "trainable_components": trainable[0],
        "model_size": info_model["model_params"],
        "n_step": checkpoint_step,
        "test_acc": eval_file["test_acc"],
    }

    data = load_jsonl_to_numpy(
        log_dir / "metrics" / "raw_0.jsonl",
        keys=["loss", "step", "grad_norm", "eval_loss", "eval_acc"],
    )
    is_train = ~np.isnan(data["loss"].astype(float))
    is_eval = ~np.isnan(data["eval_loss"].astype(float))
    training_runs = [data["step"][is_train], data["loss"][is_train],
                     data["grad_norm"][is_train]]
    validation_runs = [data["step"][is_eval], data["eval_loss"][is_eval],
                       data["eval_acc"][is_eval]]
    return training_runs, validation_runs, eval_data


def get_evals_csv(dataset_name: str, seeds: list, lrs: list) -> None:
    """Aggregate test accuracies over the 7 freeze configs → csv (reference :181-212)."""
    import pandas as pd

    rows = []
    for seed in seeds:
        for lr in lrs:
            for comp in range(7):
                _, _, eval_data = get_single_exp(dataset_name, seed, lr, comp)
                rows.append(eval_data)
    path = results_dir("finetuning") / f"{dataset_name}.csv"
    pd.DataFrame(rows).to_csv(path)
    logger.info("Wrote %s", path)


def get_runs(dataset_name: str, seeds: list, lrs: list) -> dict:
    """Per-(lr, component, seed) training/validation curves (reference :215-250)."""
    index_map = {0: "all", 2: "attn_norm", 3: "mha", 4: "ffn_norm",
                 5: "ffn_fc1", 6: "ffn_fc2"}
    all_runs: dict = {}
    for lr in lrs:
        all_runs[lr] = {}
        for comp, name in index_map.items():
            all_runs[lr][name] = {}
            for seed in seeds:
                training, validation, eval_data = get_single_exp(
                    dataset_name, seed, lr, comp
                )
                all_runs[lr][name][seed] = {
                    "model_size": eval_data["model_size"],
                    "trainable_components": eval_data["trainable_components"],
                    "train_steps": training[0], "train_loss": training[1],
                    "grad_norm": training[2],
                    "val_steps": validation[0], "val_loss": validation[1],
                    "val_acc": validation[2],
                }
    return all_runs


def get_single_exp_linear_probing(dataset_name: str, seed: int, lr: str,
                                  comp: int, prefix: str = "vit",
                                  finetuned: bool = False) -> list:
    """Probe accuracies → per-(block, component) rows (reference :253-311)."""
    if finetuned:
        log_dir = f"{prefix}_{dataset_name}_seed_{seed}_lr_{lr}_comp_{comp}"
    else:
        log_dir = f"{prefix}_{encoded_dataset_name(dataset_name)}_seed_0_pretrained"
    with open(PROBES_DIR / log_dir / "linear_probing.json") as f:
        results_file = json.load(f)

    if finetuned:
        trainable = "all" if comp == 0 else PROBE_STAGES[comp - 1]
    else:
        trainable = "none"
    meta = {"dataset_name": dataset_name, "trainable_components": trainable}
    if finetuned:
        meta |= {"seed": int(seed), "lr": float(lr)}

    rows = []
    for key, acc in results_file.items():
        block, component = key.split("_", 1)
        rows.append(meta | {
            "block": int(block.split("block", 1)[-1]),
            "component": component,
            "test_acc": acc,
        })
    return rows


def get_linear_probing_csv(dataset_name: str, lrs: list | None = None) -> None:
    """Pretrained-probe accuracies → csv (reference :313-325)."""
    import pandas as pd

    rows = get_single_exp_linear_probing(dataset_name, None, None, None,
                                         finetuned=False)
    path = results_dir("linear_probing") / f"{dataset_name}.csv"
    pd.DataFrame(rows).to_csv(path)
    logger.info("Wrote %s", path)


def get_data(dataset_name: str, folder: str) -> pd.DataFrame:
    """Load an aggregated results csv (reference :330-334)."""
    import pandas as pd

    return pd.read_csv(results_dir(folder) / f"{dataset_name}.csv")


def get_sensitivity(path) -> dict:
    """Plasticity ratios per component: dist(component)/dist(embedding)
    (reference :335-369; the statistic of apps/plots/analysis.py:88-107)."""
    with open(Path(path) / "distances.pkl", "rb") as f:
        distances = pickle.load(f)
    inputs = np.asarray(distances.pop("embedding")).flatten()
    dict_df: dict = {}
    for key, values in distances.items():
        _, component = key.split("_", 1)
        ratio = np.asarray(values).flatten() / inputs
        dict_df.setdefault(component, []).append(ratio)
    return dict_df


def get_config_sensitivity(dataset_name: str, model_name: str,
                           pretrained: bool = True) -> str:
    """Analysis artifact dir name for a dataset/model (reference :372-404)."""
    encoded = encoded_dataset_name(dataset_name)
    patch = 14 if model_name == "huge" else 16
    vit_model_name = f"vit-{model_name}-patch{patch}-224-in21k"
    return f"analysis_{vit_model_name}_pretrained_{pretrained}_{encoded}"


# ----------------------------------------------------------------------------
# Tables & statistics
# ----------------------------------------------------------------------------


def _best_over_lr(data: pd.DataFrame, dataset_name: str, component: str,
                  seeds: list) -> tuple[float, float]:
    """Best mean-over-seeds accuracy across the LR sweep + that lr's seed-std."""
    best_acc, best_std = 0.0, 0.0
    for lr in LR_VALUES[dataset_name]:
        sel = data[(data["lr"] == float(lr))
                   & (data["seed"].isin([int(s) for s in seeds]))
                   & (data["trainable_components"] == component)]
        values = np.asarray(sel["test_acc"])
        if values.size and values.mean() > best_acc:
            best_acc, best_std = values.mean(), values.std()
    return best_acc, best_std


def _zero_shot_lp(dataset_name: str, block: int = 11,
                  component: str = "ffn_res") -> float:
    """Zero-shot linear-probe point: block 11, ffn_res (reference :434)."""
    lp = get_data(dataset_name, folder="linear_probing")
    sel = lp[(lp["block"] == block) & (lp["component"] == component)]
    return float(sel["test_acc"].iloc[0])


def table_results(dataset_names: list, seeds: list, lp_block: int = 11) -> dict:
    """Best-acc-over-lr per component + relative gain vs zero-shot LP
    (reference :420-536). Returns the aggregates it prints."""
    acc_mean: dict = {}
    acc_std: dict = {}
    relative_gain: dict = {}
    lp_accs = []

    print("Linear probing")
    for dataset_name in dataset_names:
        lp_acc = _zero_shot_lp(dataset_name, block=lp_block)
        lp_accs.append(lp_acc)
        print(f"{dataset_name}: {np.round(lp_acc * 100, 2)}")

        data = get_data(dataset_name, folder="finetuning")
        acc_mean[dataset_name] = {}
        acc_std[dataset_name] = {}
        relative_gain[dataset_name] = {}
        for comp in VIT_COMPONENTS_MAP:
            best, std = _best_over_lr(data, dataset_name, comp, seeds)
            acc_mean[dataset_name][comp] = best
            acc_std[dataset_name][comp] = std
            relative_gain[dataset_name][comp] = (best - lp_acc) / lp_acc
    print(f"Average: {np.round(np.mean(lp_accs) * 100, 2)}\n")

    print("Finetuning")
    ordered = ["all", "attn_norm", "mha", "ffn_fc1", "ffn_norm", "ffn_fc2"]
    for dataset_name in dataset_names:
        print(dataset_name)
        for comp in ordered:
            print(comp, f"{np.round(acc_mean[dataset_name][comp] * 100, 2)}",
                  f"{np.round(acc_std[dataset_name][comp] * 100, 2)}")
        print("\n")

    print("Average accuracy")
    avg_acc = {c: np.mean([acc_mean[d][c] for d in dataset_names])
               for c in VIT_COMPONENTS_MAP}
    for comp, v in avg_acc.items():
        print(comp, np.round(v * 100, 2))
    print("\n")

    print("Average relative gain")
    avg_gain = {c: np.mean([relative_gain[d][c] for d in dataset_names])
                for c in VIT_COMPONENTS_MAP}
    for comp, v in avg_gain.items():
        print(comp, np.round(v * 100, 2))
    print("\n")

    print("Finetuning performance gap")
    avg_gap = {}
    for comp in VIT_COMPONENTS_MAP:
        gaps = []
        for dataset_name in dataset_names:
            data = get_data(dataset_name, folder="finetuning")
            per_lr = []
            for lr in LR_VALUES[dataset_name]:
                sel = data[(data["lr"] == float(lr))
                           & (data["seed"].isin([int(s) for s in seeds]))
                           & (data["trainable_components"] == comp)]
                per_lr.append(np.asarray(sel["test_acc"]).mean())
            per_lr = np.asarray(per_lr)
            gaps.append(per_lr.max() - per_lr.min())
        avg_gap[comp] = np.mean(gaps)
        print(comp, np.round(avg_gap[comp] * 100, 2))

    return {"acc_mean": acc_mean, "acc_std": acc_std,
            "relative_gain": relative_gain, "avg_acc": avg_acc,
            "avg_gain": avg_gain, "avg_gap": avg_gap}


def stat_results(data: str) -> dict:
    """Paired t-test + one-sided Wilcoxon, MHA vs others (reference :539-594)."""
    import pandas as pd

    from scipy import stats

    val_pattern = re.compile(r"(\d+\.\d+)(?:±(\d+\.\d+))?")
    rows = []
    for line in data.strip().split("\n"):
        first = val_pattern.search(line)
        matches = val_pattern.findall(line)
        rows.append({"Dataset": line[: first.start()].strip(),
                     **{f"Method_{i + 1}": float(m) for i, (m, _) in enumerate(matches)}})
    df = pd.DataFrame(rows)

    # Column identities: MHA FC1 FC2 LN2 LN1 (reference :566-573)
    mapping = {"MHA": "Method_1", "FC1": "Method_2", "FC2": "Method_3",
               "LN2": "Method_4", "LN1": "Method_5"}
    comparisons = [("MHA", "FC1"), ("MHA", "FC2"), ("MHA", "LN2"), ("MHA", "LN1")]

    print("--- Statistical Test Results (MHA vs Others) ---")
    print(f"{'Comparison':<15} | {'Mean Diff':<10} | {'T-Test p':<10} | {'Wilcoxon p':<10}")
    print("-" * 55)
    out = {}
    for ref, comp in comparisons:
        g1, g2 = df[mapping[ref]], df[mapping[comp]]
        _, t_p = stats.ttest_rel(g1, g2)
        _, w_p = stats.wilcoxon(g1, g2, alternative="greater")
        mean_diff = g1.mean() - g2.mean()
        out[f"{ref}_vs_{comp}"] = {"mean_diff": mean_diff, "t_p": t_p, "w_p": w_p}
        print(f"{ref} vs {comp:<11} | {mean_diff:>9.4f}% | {t_p:>10.4f} | {w_p:>10.4f}")
    print("\nNote: p < 0.05 is typically considered statistically significant.")
    return out


# ----------------------------------------------------------------------------
# Figures
# ----------------------------------------------------------------------------


def _rank_palette():
    comps = [VIT_COMPONENTS_MAP[c] for c in RANK_ORDERED]
    return comps, [COLORS[c] for c in comps]


def _style_rank_axis(ax):
    ax.yaxis.grid(alpha=ALPHA_GRID, lw=1.3)
    ax.tick_params(axis="both", direction="out", length=5, width=1)
    ax.set_xticks(range(5))
    ax.set_xticklabels(range(1, 6))
    ax.set_xlabel(r"Plasticity Rank ($\downarrow$)", fontsize=FONTSIZE)


def get_intro(dataset_names: list, seeds: list, save: bool = False,
              ncol: int = 5) -> None:
    """Plasticity distribution + relative-gain bars (reference :597-757)."""
    set_style()
    import matplotlib.pyplot as plt
    import seaborn as sns

    fig, axes = plt.subplots(ncols=2, figsize=(8, 3.5))

    # Left: plasticity ratio distribution per theoretical rank
    plasticity_rank = {"attn_norm": 5, "attn": 1, "ffn_norm": 4,
                       "ffn_fc1": 2, "ffn_fc2": 3}
    ranks, values = [], []
    for dataset_name in dataset_names:
        config = get_config_sensitivity(dataset_name, "base", pretrained=True)
        for comp, ratios in get_sensitivity(ANALYSIS_DIR / config).items():
            per_block_means = np.mean(np.asarray(ratios), axis=-1)
            ranks.extend([plasticity_rank[comp]] * len(per_block_means))
            values.extend(per_block_means.tolist())
    comps, palette = _rank_palette()
    sns.boxplot(x=ranks, y=values, hue=ranks, palette=palette, legend=False,
                showfliers=False, ax=axes[0])
    axes[0].set_xlabel(r"Theoretical Plasticity Rank ($\downarrow$)", fontsize=FONTSIZE)
    axes[0].set_ylabel(r"Plasticity $\mathscr{P}(f)$", fontsize=FONTSIZE)

    # Right: mean relative gain over datasets, per component in rank order
    gains = {c: [] for c in RANK_ORDERED}
    for dataset_name in dataset_names:
        lp_acc = _zero_shot_lp(dataset_name)
        data = get_data(dataset_name, folder="finetuning")
        for comp in RANK_ORDERED:
            best, _ = _best_over_lr(data, dataset_name, comp, seeds)
            gains[comp].append((best - lp_acc) / lp_acc * 100)
    sns.barplot(x=comps, y=[np.mean(gains[c]) for c in RANK_ORDERED],
                hue=comps, palette=palette, legend=False, ax=axes[1])
    axes[1].set_ylabel("Relative Gain (%)", fontsize=FONTSIZE)
    plt.tight_layout()
    if save:
        save_plot("intro", subdir="finetuning")
    plt.close(fig)


def get_best_performance(dataset_names: list, seeds: list, save: bool = False,
                         ncol: int = 5) -> None:
    """Mean best accuracy per component, rank-ordered bars + pooled SE
    (reference :760-896)."""
    set_style()
    import matplotlib.pyplot as plt
    import seaborn as sns

    fig = plt.figure(figsize=(WIDTH, HEIGHT))
    means = {c: [] for c in RANK_ORDERED}
    stds = {c: [] for c in RANK_ORDERED}
    for dataset_name in dataset_names:
        data = get_data(dataset_name, folder="finetuning")
        for comp in RANK_ORDERED:
            best, std = _best_over_lr(data, dataset_name, comp, seeds)
            means[comp].append(best * 100)
            stds[comp].append(std * 100)
    comps, palette = _rank_palette()
    heights = [np.mean(means[c]) for c in RANK_ORDERED]
    ax = sns.barplot(x=comps, y=heights, hue=comps, palette=palette, legend=False)
    pooled_se = [np.sqrt(np.mean(np.square(stds[c]))) / np.sqrt(len(seeds))
                 for c in RANK_ORDERED]
    ax.errorbar(x=range(5), y=heights, yerr=pooled_se, fmt="none",
                color="#333333", linewidth=2)
    _style_rank_axis(ax)
    ax.set_ylabel(r"Accuracy ($\%$)", fontsize=FONTSIZE)
    lo = min(heights) - max(pooled_se) * 3
    hi = max(heights) + max(pooled_se) * 3
    ax.set_ylim(lo, hi)
    plt.tight_layout()
    if save:
        save_plot("finetuning_all", subdir="finetuning")
    plt.close(fig)


def get_robustness_all(dataset_names: list, seeds: list, save: bool = False,
                       ncol: int = 6) -> None:
    """Per-dataset accuracy boxplots over (lr × seed) per component, with a red
    full-finetune line (reference :896-1055)."""
    set_style()
    import matplotlib.pyplot as plt
    import seaborn as sns

    n = len(dataset_names)
    ncols = 3
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(5 * ncols, 4 * nrows),
                             squeeze=False)
    comps, palette = _rank_palette()
    for i, dataset_name in enumerate(dataset_names):
        ax = axes[i // ncols][i % ncols]
        data = get_data(dataset_name, folder="finetuning")
        per_comp = {}
        for comp in list(VIT_COMPONENTS_MAP):
            sel = data[(data["seed"].isin([int(s) for s in seeds]))
                       & (data["trainable_components"] == comp)
                       & (data["lr"].isin([float(lr) for lr in LR_VALUES[dataset_name]]))]
            per_comp[comp] = (np.asarray(sel["test_acc"]) * 100).tolist()
        full = np.mean(per_comp.pop("all"))
        per_comp.pop("emb", None)
        xs, ys = [], []
        for rank, comp in enumerate(RANK_ORDERED):
            xs.extend([rank] * len(per_comp[comp]))
            ys.extend(per_comp[comp])
        sns.boxplot(x=xs, y=ys, hue=xs, palette=palette, legend=False,
                    showfliers=False, ax=ax)
        ax.hlines(full, xmin=-0.41, xmax=4.41, color="tab:red", linestyle="--",
                  label="full finetuning", lw=2.5)
        _style_rank_axis(ax)
        ax.set_title(f"{DATASET_MAP[dataset_name]}\n")
        ax.set_ylabel(r"Accuracy ($\%$)", fontsize=FONTSIZE)
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    plt.tight_layout()
    if save:
        save_plot("robustness_all", subdir="finetuning")
    plt.close(fig)


def get_training_evolution(dataset_name: str, seed: int, save: bool = False,
                           ncol: int = 6) -> None:
    """Gradient-norm and val-accuracy evolution per lr per component
    (reference :1058-1221)."""
    set_style()
    import matplotlib.pyplot as plt

    lrs = LR_VALUES[dataset_name]
    runs = get_runs(dataset_name, [seed], lrs)
    fig, axes = plt.subplots(2, len(lrs), figsize=(4 * len(lrs), 8),
                             squeeze=False)
    for j, lr in enumerate(lrs):
        ax_g, ax_a = axes[0][j], axes[1][j]
        for comp_key, comp_runs in runs[lr].items():
            if comp_key == "all":
                color, label = "tab:red", "All"
            else:
                label = VIT_COMPONENTS_MAP[comp_key]
                color = COLORS[label]
            r = comp_runs[seed]
            ax_g.plot(r["train_steps"], r["grad_norm"], color=color,
                      label=label, lw=1.5)
            ax_a.plot(r["val_steps"], np.asarray(r["val_acc"]) * 100,
                      color=color, label=label, lw=1.5)
        ax_g.set_yscale("log")
        ax_g.set_title(f"lr = {lr}")
        ax_g.set_ylabel("Gradient Norm", fontsize=FONTSIZE)
        ax_a.set_xlabel("Step", fontsize=FONTSIZE)
        ax_a.set_ylabel(r"Val. Accuracy ($\%$)", fontsize=FONTSIZE)
    axes[0][0].legend(fontsize=10, ncol=2)
    plt.tight_layout()
    if save:
        save_plot(f"training_evolution_{dataset_name}_seed_{seed}",
                  subdir="finetuning")
    plt.close(fig)


def get_robustness_training_domainnet_sketch(save: bool = False,
                                             seed: int = 42,
                                             lr: str = "1e-2",
                                             dataset_name: str = "domainnet_sketch",
                                             ) -> None:
    """The paper's DomainNet-Sketch highlight: a 3-panel figure — accuracy
    boxplot over (lr x seed) per component ordered by plasticity rank,
    grad-norm evolution, and validation-loss evolution for the best run
    (seed 42, lr 1e-2) — saved as robustness_training_domainnet_sketch.pdf
    (reference :1224-1452)."""
    set_style()
    import matplotlib.pyplot as plt
    import seaborn as sns

    fig, axes = plt.subplots(ncols=3, figsize=(12, 10 / 3))
    comps, palette = _rank_palette()

    # Panel 1: robustness boxplot over all seeds and learning rates
    data = get_data(dataset_name, folder="finetuning")
    xs, ys = [], []
    for comp in RANK_ORDERED:
        sel = data[data["trainable_components"] == comp]
        for acc in sel["test_acc"]:
            xs.append(VIT_COMPONENTS_MAP[comp])
            ys.append(acc * 100)
    sns.boxplot(x=xs, y=ys, hue=xs, palette=palette, legend=False,
                showfliers=False, ax=axes[0])
    _style_rank_axis(axes[0])
    axes[0].set_ylabel(r"Accuracy ($\%$)", fontsize=FONTSIZE)

    # Panels 2-3: grad-norm + validation loss of the highlighted run
    all_runs = get_runs(dataset_name, seeds=[seed], lrs=[lr])
    for ax, (ykey, xkey, ylabel) in zip(axes[1:], [
        ("grad_norm", "train_steps", "Gradient Norm"),
        ("val_loss", "val_steps", "Validation Loss"),
    ]):
        for comp in RANK_ORDERED:
            run = all_runs[lr][comp][seed]
            ax.plot(run[xkey], run[ykey], color=COLORS[VIT_COMPONENTS_MAP[comp]],
                    lw=1.0, label=VIT_COMPONENTS_MAP[comp])
        ax.grid(alpha=ALPHA_GRID, lw=1.3)
        ax.set_xlabel("Training Steps", fontsize=FONTSIZE)
        ax.set_ylabel(ylabel, fontsize=FONTSIZE)

    lines, labels = axes[1].get_legend_handles_labels()
    fig.legend(lines, labels, loc="upper center", bbox_to_anchor=(0.5, 1.1),
               ncol=6, frameon=True, handlelength=1.9, fontsize=FONTSIZE)
    plt.tight_layout()
    if save:
        save_plot(f"robustness_training_{dataset_name}", subdir="finetuning")
    plt.close(fig)


# ----------------------------------------------------------------------------
# CLI (reference :1453-1593)
# ----------------------------------------------------------------------------


def get_csv_results(dataset_names: list | None = None) -> None:
    dataset_names = dataset_names or ALL_DATASETS
    for dataset_name in dataset_names:
        get_evals_csv(dataset_name, DEFAULT_SEEDS, LR_VALUES[dataset_name])
        get_linear_probing_csv(dataset_name)


def get_table_results(dataset_names: list | None = None) -> None:
    table_results(dataset_names or ALL_DATASETS, DEFAULT_SEEDS)


def get_statistical_test() -> None:
    stat_results(data=PUBLISHED_RESULTS)


def plot_figures() -> None:
    get_intro(ALL_DATASETS, DEFAULT_SEEDS, save=True)
    get_best_performance(ALL_DATASETS, DEFAULT_SEEDS, save=True)
    get_robustness_all(ALL_DATASETS, DEFAULT_SEEDS, save=True)
    for seed in DEFAULT_SEEDS:
        for dataset_name in ALL_DATASETS:
            get_training_evolution(dataset_name, seed, save=True)
    get_robustness_training_domainnet_sketch(save=True)


def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(levelname)s] %(filename)s:%(lineno)d - %(message)s",
        handlers=[logging.StreamHandler()],
    )
    make_cli({"csv": get_csv_results, "table": get_table_results,
              "stat": get_statistical_test, "plot": plot_figures})


if __name__ == "__main__":
    main()
