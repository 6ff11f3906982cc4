"""Results and figures of the AdamW ablation: the csv / table / plot command
lines. Counterpart of ``apps/plots/ablation.py``, on the port's run dirs.

    python -m vitef_tpu_torch.apps.plots.ablation csv|table|plot

Its runs are ``vit_<dataset>_adamw_seed_<s>_lr_<lr>_comp_<c>`` with the SGD
learning rates over 100 (``ADAM_LR_VALUES``) and the configs {0, 2..6} (no
``emb`` config). The table is the mean over the whole lr x seed sweep, not the
best over lr. It writes ``results/ablation/finetuning/<dataset>.csv`` and
``figures/ablation/finetuning/*.pdf``. The run reader uses numpy only; pandas,
matplotlib and seaborn are imported inside the functions that need them.
"""

from __future__ import annotations

import json
import logging

import numpy as np

from ...utils.cli import make_cli
from ...utils.jsonl import load_jsonl_to_numpy, read_jsonl

from .common import COLORS, FONTSIZE, LR_VALUES, RUNS_DIR, VIT_COMPONENTS_MAP, \
    results_dir, save_plot, set_style
from .finetuning import ALL_COMPONENTS

logger = logging.getLogger("vitef")

# AdamW sweeps: the SGD lrs rescaled by 1/100 (reference ablation.py:59,
# matching apps/vit/scripts/ablation/adam.sh:48)
ADAM_LR_VALUES = {key: [f"{float(val) / 100:.2e}" for val in values]
                  for key, values in LR_VALUES.items()}

ABLATION_DATASETS = ["cifar100", "cifar10_c_motion_blur_5",
                     "domainnet_clipart", "domainnet_sketch"]
ABLATION_SEEDS = [0]
COMP_INDICES = [0, 2, 3, 4, 5, 6]  # all + 5 single components ('emb' excluded)


def get_adamw_single_exp(dataset_name: str, seed: int, lr: str, comp: int,
                         prefix: str = "vit") -> tuple:
    """Per-run curves + eval metadata for an AdamW run (reference :108-170)."""
    log_dir = RUNS_DIR / f"{prefix}_{dataset_name}_adamw_seed_{seed}_lr_{lr}_comp_{comp}"
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
    """Aggregate over the {all + 5 components} configs (reference :173-204)."""
    import pandas as pd

    rows = []
    for seed in seeds:
        for lr in lrs:
            for comp in COMP_INDICES:
                _, _, eval_data = get_adamw_single_exp(dataset_name, seed, lr, comp)
                rows.append(eval_data)
    path = results_dir("ablation/finetuning") / f"{dataset_name}.csv"
    pd.DataFrame(rows).to_csv(path)
    logger.info("Wrote %s", path)


def get_runs(dataset_name: str, seeds: list, lrs: list) -> dict:
    """AdamW training/validation curves (reference :207-242)."""
    index_map = {0: "all", 2: "attn_norm", 3: "mha", 4: "ffn_norm",
                 5: "ffn_fc1", 6: "ffn_fc2"}
    all_runs: dict = {}
    for lr in lrs:
        all_runs[lr] = {}
        for comp, name in index_map.items():
            all_runs[lr][name] = {}
            for seed in seeds:
                training, validation, eval_data = get_adamw_single_exp(
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


def get_data(dataset_name: str, folder: str = "ablation/finetuning") -> pd.DataFrame:
    import pandas as pd

    return pd.read_csv(results_dir(folder) / f"{dataset_name}.csv")


def table_results(dataset_names: list, seeds: list) -> dict:
    """Mean±std over the whole lr×seed sweep per component (reference :266-392
    — unlike the finetuning table, NOT best-over-lr)."""
    acc_mean: dict = {}
    acc_std: dict = {}
    print("Optimization with AdamW")
    for dataset_name in dataset_names:
        data = get_data(dataset_name)
        acc_mean[dataset_name] = {}
        acc_std[dataset_name] = {}
        for comp in VIT_COMPONENTS_MAP:
            sel = data[(data["seed"].isin([int(s) for s in seeds]))
                       & (data["lr"].isin(
                           [float(lr) for lr in ADAM_LR_VALUES[dataset_name]]))
                       & (data["trainable_components"] == comp)]
            values = np.asarray(sel["test_acc"])
            if values.size == 0:
                continue
            acc_mean[dataset_name][comp] = values.mean()
            acc_std[dataset_name][comp] = values.std()

    print("Finetuning")
    for dataset_name in dataset_names:
        print(dataset_name)
        for comp, mean in acc_mean[dataset_name].items():
            print(comp, f"{np.round(mean * 100, 2)}",
                  f"{np.round(acc_std[dataset_name][comp] * 100, 2)}")
        print("\n")
    return {"acc_mean": acc_mean, "acc_std": acc_std}


RANK_ORDERED = ["mha", "ffn_fc1", "ffn_fc2", "ffn_norm", "attn_norm"]


def get_adamw_robustness_training_domainnet_sketch(
        save: bool = False, seed: int = 0,
        dataset_name: str = "domainnet_sketch") -> None:
    """DomainNet-Sketch AdamW highlight, the reference's 3-panel template
    (ablation.py:395-674): AdamW-vs-SGD accuracy boxplot per component
    (plasticity-rank order), then grad-norm and validation-loss evolution of
    the lr=1e-4 AdamW run. Saved as adamw_sgd_robustness_domainnet_sketch.pdf
    (reference :667-668)."""
    import pandas as pd

    set_style()
    import matplotlib.pyplot as plt
    import seaborn as sns

    fig, axes = plt.subplots(ncols=3, figsize=(12, 10 / 3))

    # Panel 1: AdamW vs SGD boxplot over the lr sweeps (seed 0)
    rows = []
    for opt, data, lrs in (
        ("Adam", get_data(dataset_name, "ablation/finetuning"),
         ADAM_LR_VALUES[dataset_name]),
        ("SGD", get_data(dataset_name, "finetuning"), LR_VALUES[dataset_name]),
    ):
        for comp in RANK_ORDERED:
            sel = data[(data["seed"] == seed)
                       & (data["trainable_components"] == comp)
                       & (data["lr"].isin([float(lr) for lr in lrs]))]
            for acc in sel["test_acc"]:
                rows.append({"": VIT_COMPONENTS_MAP[comp],
                             "Accuracy (%)": acc * 100, "opt": opt})
    df = pd.DataFrame(rows)
    sns.boxplot(data=df, x="", y="Accuracy (%)", hue="opt", ax=axes[0],
                showfliers=False)
    axes[0].set_xticks(range(5))
    axes[0].set_xticklabels(range(1, 6))
    axes[0].set_xlabel(r"Plasticity Rank ($\downarrow$)", fontsize=FONTSIZE)
    axes[0].set_ylabel(r"Accuracy ($\%$)", fontsize=FONTSIZE)

    # Panels 2-3: grad-norm + validation loss of the lr = 1e-2/100 AdamW run
    lr = f"{float('1e-2') / 100:.2e}"
    runs = get_runs(dataset_name, [seed], [lr])
    for ax, (ykey, xkey, ylabel) in zip(axes[1:], [
        ("grad_norm", "train_steps", "Gradient Norm"),
        ("val_loss", "val_steps", "Validation Loss"),
    ]):
        for comp in RANK_ORDERED:
            r = runs[lr][comp][seed]
            label = VIT_COMPONENTS_MAP[comp]
            ax.plot(r[xkey], r[ykey], color=COLORS[label], lw=1.0, label=label)
        ax.set_xlabel("Training Steps", fontsize=FONTSIZE)
        ax.set_ylabel(ylabel, fontsize=FONTSIZE)

    lines, labels = axes[1].get_legend_handles_labels()
    fig.legend(lines, labels, loc="upper center", bbox_to_anchor=(0.5, 1.1),
               ncol=6, frameon=True, handlelength=1.9, fontsize=FONTSIZE)
    plt.tight_layout()
    if save:
        save_plot(f"adamw_sgd_robustness_{dataset_name}",
                  subdir="ablation/finetuning")
    plt.close(fig)


def get_csv_results() -> None:
    for dataset_name in ABLATION_DATASETS:
        get_evals_csv(dataset_name, ABLATION_SEEDS, ADAM_LR_VALUES[dataset_name])


def get_table_results() -> None:
    table_results(ABLATION_DATASETS, ABLATION_SEEDS)


def plot_figures() -> None:
    get_adamw_robustness_training_domainnet_sketch(save=True)


def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(levelname)s] %(filename)s:%(lineno)d - %(message)s",
        handlers=[logging.StreamHandler()],
    )
    make_cli({"csv": get_csv_results, "table": get_table_results,
              "plot": plot_figures})


if __name__ == "__main__":
    main()
