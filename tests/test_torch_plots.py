"""The port's tables, figures and sweep launchers against the JAX package's,
on the CPU.

One synthetic tree of run, probe and analysis dirs (the pattern of
``tests/test_plots.py``) is read by both packages' ``apps/plots`` readers:
the CSVs they write are byte for byte the same and the dicts they return
equal. Each figure function of the port renders once. The port's plot
command lines offer the JAX package's commands, and each of the port's sweep
launchers queues exactly the JAX launcher's commands with the port's modules
(a stub ``tmux`` on PATH records them).
"""

import json
import os
import pickle
import subprocess
from pathlib import Path

import numpy as np
import pytest

import apps.plots.ablation as jax_ab
import apps.plots.analysis as jax_pa
import apps.plots.common as jax_common
import apps.plots.finetuning as jax_ft
import apps.plots.loss_landscape as jax_ll
import apps.plots.theory as jax_theory
from vitef_tpu_torch.apps.plots import ablation as ab
from vitef_tpu_torch.apps.plots import analysis as pa
from vitef_tpu_torch.apps.plots import common
from vitef_tpu_torch.apps.plots import finetuning as ft
from vitef_tpu_torch.apps.plots import loss_landscape as ll
from vitef_tpu_torch.apps.plots import theory

REPO = Path(__file__).resolve().parents[1]
DATASETS = ["cifar10", "cifar100"]
SEEDS = [0, 42, 3407]
COMPS_BY_INDEX = ["all", "emb", "attn_norm", "mha", "ffn_norm", "ffn_fc1", "ffn_fc2"]


def _run_dir(run: Path, comp: int, acc: float, n_steps: int, lr: str, evals: bool):
    (run / "metrics").mkdir(parents=True)
    (run / "checkpoints" / f"{n_steps:010d}").mkdir(parents=True)
    frozen = [] if comp == 0 else [c for c in COMPS_BY_INDEX[1:] if c != COMPS_BY_INDEX[comp]]
    (run / "config.json").write_text(json.dumps({"components": frozen, "n_steps": n_steps}))
    (run / "metrics" / "info_model.jsonl").write_text(
        json.dumps({"model_params": 86_000_000}) + "\n")
    (run / "metrics" / "eval.jsonl").write_text(json.dumps({"test_acc": acc, "ts": 1.0}) + "\n")
    records = []
    for step in range(10, n_steps + 1, 10):
        records.append({"loss": 1.0 / step, "step": step, "lr": float(lr),
                        "grad_norm": 0.5 + 0.01 * step, "elapsed_steps": 10, "ts": 0.1})
        if evals:
            records.append({"eval_acc": acc - 0.01, "eval_loss": 0.2, "step": step,
                            "ts": 0.1})
    (run / "metrics" / "raw_0.jsonl").write_text("".join(json.dumps(r) + "\n" for r in records))


def _write_tree(saving: Path) -> None:
    """2 datasets x 3 seeds x the lr sweep x 7 freeze configs of SGD runs, the
    AdamW runs of cifar100, each dataset's pretrained probes and one
    finetuned run's, and base and huge analysis distances."""
    rng = np.random.default_rng(0)
    for ds in DATASETS:
        for seed in SEEDS:
            for lr in common.LR_VALUES[ds]:
                for comp in range(7):
                    name = COMPS_BY_INDEX[comp]
                    acc = 0.90 + 0.02 * (name == "mha") + 0.01 * (name == "all") \
                        + rng.normal(0, 0.002)
                    _run_dir(saving / "runs" / f"vit_{ds}_seed_{seed}_lr_{lr}_comp_{comp}",
                             comp, acc, 100, lr, evals=True)
        for probe_dir in (f"vit_{ds}_seed_0_pretrained", f"vit_{ds}_seed_0_lr_1e-3_comp_2"):
            probe = saving / "probes" / probe_dir
            probe.mkdir(parents=True)
            (probe / "linear_probing.json").write_text(json.dumps(
                {f"block{b}_{s}": 0.80 + 0.001 * b + 0.0001 * i + rng.normal(0, 0.001)
                 for b in range(12) for i, s in enumerate(ft.PROBE_STAGES)}))
        for model, n_layers in [("base", 12), ("huge", 32)]:
            patch = 14 if model == "huge" else 16
            adir = (saving / "analysis"
                    / f"analysis_vit-{model}-patch{patch}-224-in21k_pretrained_True_{ds}")
            adir.mkdir(parents=True)
            dists = {"embedding": rng.uniform(1, 2, size=100)}
            for b in range(n_layers):
                for c, scale in [("attn_norm", 1.0), ("attn", 8.0), ("ffn_norm", 2.0),
                                 ("ffn_fc1", 6.0), ("ffn_fc2", 4.0)]:
                    dists[f"block{b}_{c}"] = rng.uniform(1, 2, size=100) * scale
            with open(adir / "distances.pkl", "wb") as f:
                pickle.dump(dists, f)
    for lr in ab.ADAM_LR_VALUES["cifar100"]:
        for comp in ab.COMP_INDICES:
            _run_dir(saving / "runs" / f"vit_cifar100_adamw_seed_0_lr_{lr}_comp_{comp}", comp,
                     0.8 + rng.normal(0, 0.01), 50, lr, evals=True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The synthetic tree, read by both packages: each writes its results and
    figures under its own dir (``jax/`` and ``port/``)."""
    root = tmp_path_factory.mktemp("plots")
    saving = root / "savings"
    _write_tree(saving)
    with pytest.MonkeyPatch.context() as mp:
        for package, comm, fin, abl, ana, land, th in [
                ("jax", jax_common, jax_ft, jax_ab, jax_pa, jax_ll, jax_theory),
                ("port", common, ft, ab, pa, ll, theory)]:
            out = root / package

            def results_dir(folder, out=out):
                path = out / "results" / folder
                path.mkdir(parents=True, exist_ok=True)
                return path

            def save_plot(figname, subdir, format="pdf", dpi=100, out=out):
                import matplotlib.pyplot as plt

                path = out / "figures" / subdir
                path.mkdir(parents=True, exist_ok=True)
                plt.savefig(path / f"{figname}.{format}", format=format)
                return path / f"{figname}.{format}"

            for module in (comm, fin, abl, ana, th):
                mp.setattr(module, "save_plot", save_plot, raising=False)
            for module in (comm, fin, abl):
                mp.setattr(module, "results_dir", results_dir, raising=False)
            for module in (comm, fin, abl):
                mp.setattr(module, "RUNS_DIR", saving / "runs", raising=False)
            for module in (comm, fin):
                mp.setattr(module, "PROBES_DIR", saving / "probes")
                mp.setattr(module, "ANALYSIS_DIR", saving / "analysis")
            mp.setattr(ana, "SAVE_DIR", saving / "analysis")
            mp.setattr(land, "SAVE_DIR", saving / "loss_landscape")
            mp.setattr(land, "FIGURE_DIR", out / "figures")
        mp.setattr(theory, "SAVE_DIR", saving / "theory")
        yield root


def _csvs(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.csv"))}


def _assert_equal(got, want, path="") -> None:
    """Nested dicts/lists/tuples of numbers and arrays, equal."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for key in want:
            _assert_equal(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want or (got != got and want != want), path


@pytest.fixture(scope="module")
def csvs(tree):
    """Both packages' csv commands over the tree, once: the finetuning and
    linear-probing CSVs of both datasets and the AdamW CSV of cifar100."""
    for fin, abl in ((jax_ft, jax_ab), (ft, ab)):
        fin.get_csv_results(DATASETS)
        abl.get_evals_csv("cifar100", [0], abl.ADAM_LR_VALUES["cifar100"])
    return tree


def test_csvs_and_tables_equal(csvs, capsys):
    got, want = _csvs(csvs / "port"), _csvs(csvs / "jax")
    assert sorted(got) == sorted(want) == [
        "results/ablation/finetuning/cifar100.csv", "results/finetuning/cifar10.csv",
        "results/finetuning/cifar100.csv", "results/linear_probing/cifar10.csv",
        "results/linear_probing/cifar100.csv"]
    assert got == want

    capsys.readouterr()
    table = ft.table_results(DATASETS, SEEDS)
    port_out = capsys.readouterr().out
    _assert_equal(table, jax_ft.table_results(DATASETS, SEEDS))
    assert port_out == capsys.readouterr().out
    assert table["avg_acc"]["mha"] > table["avg_acc"]["ffn_fc1"]
    _assert_equal(ab.table_results(["cifar100"], [0]), jax_ab.table_results(["cifar100"], [0]))
    _assert_equal(ft.stat_results(ft.PUBLISHED_RESULTS),
                  jax_ft.stat_results(jax_ft.PUBLISHED_RESULTS))


def test_run_readers_equal(tree):
    _assert_equal(ft.get_single_exp("cifar10", 42, "1e-2", 3),
                  jax_ft.get_single_exp("cifar10", 42, "1e-2", 3))
    _assert_equal(ft.get_runs("cifar100", [0, 3407], ["1e-3", "3e-2"]),
                  jax_ft.get_runs("cifar100", [0, 3407], ["1e-3", "3e-2"]))
    _assert_equal(ab.get_runs("cifar100", [0], ab.ADAM_LR_VALUES["cifar100"][:2]),
                  jax_ab.get_runs("cifar100", [0], jax_ab.ADAM_LR_VALUES["cifar100"][:2]))
    for finetuned in (False, True):
        _assert_equal(ft.get_single_exp_linear_probing("cifar10", 0, "1e-3", 2,
                                                       finetuned=finetuned),
                      jax_ft.get_single_exp_linear_probing("cifar10", 0, "1e-3", 2,
                                                           finetuned=finetuned))
    config = ft.get_config_sensitivity("cifar100", "huge")
    assert config == jax_ft.get_config_sensitivity("cifar100", "huge") == pa.get_config(
        "cifar100", "huge")
    _assert_equal(ft.get_sensitivity(ft.ANALYSIS_DIR / config),
                  jax_ft.get_sensitivity(jax_ft.ANALYSIS_DIR / config))
    _assert_equal(pa.get_plasticity(pa.SAVE_DIR / config),
                  jax_pa.get_plasticity(jax_pa.SAVE_DIR / config))


def _render(name):
    """Each figure of the port, from the tree's CSVs (and, for the loss
    landscape and the bounds, from pickles as the card writes them)."""
    if name == "intro":
        ft.get_intro(DATASETS, SEEDS, save=True)
    elif name == "finetuning_all":
        ft.get_best_performance(DATASETS, SEEDS, save=True)
    elif name == "robustness_all":
        ft.get_robustness_all(DATASETS, SEEDS, save=True)
    elif name == "training_evolution_cifar10_seed_0":
        ft.get_training_evolution("cifar10", 0, save=True)
    elif name == "robustness_training_cifar10":
        ft.get_robustness_training_domainnet_sketch(save=True, seed=42, lr="1e-2",
                                                    dataset_name="cifar10")
    elif name == "adamw_sgd_robustness_cifar100":
        ab.get_adamw_robustness_training_domainnet_sketch(save=True, seed=0,
                                                          dataset_name="cifar100")
    elif name == "plasticity_cifar10":
        pa.get_all_plasticity("cifar10", pretrained=True, save=True)
    elif name == "theoretical_bounds":
        rng = np.random.default_rng(1)
        bounds = tuple(list(rng.uniform(1, 10, 12)) for _ in range(5))
        theory.bounds_path("base", 16).parent.mkdir(parents=True, exist_ok=True)
        with open(theory.bounds_path("base", 16), "wb") as f:
            pickle.dump(bounds, f)
        theory.plot_figures(saved=True)
    else:  # the loss landscape's four commands
        rng = np.random.default_rng(2)
        for comp in ("ln1", "mha"):
            d = ll.SAVE_DIR / f"{comp}_block_0"
            d.mkdir(parents=True, exist_ok=True)
            for key, obj in [("loss", rng.uniform(0, 1, (6, 6))),
                             ("func", rng.uniform(0, 2, (6, 6))),
                             ("u_coords", np.linspace(-0.5, 0.5, 6)),
                             ("v_coords", np.linspace(-0.5, 0.5, 6)),
                             ("traj", [(0.0, 0.0), (0.1, 0.05), (0.15, 0.1)])]:
                with open(d / f"{key}.pkl", "wb") as f:
                    pickle.dump(obj, f)
        ll.plot_figures(save=True)
        ll.get_results("ln1", 0, save=True)
        ll.get_latex_frames("mha", 0, n_frames=1)
        ll.plot_gif("mha", 0, n_frames=2)


FIGURES = {
    "intro": "finetuning", "finetuning_all": "finetuning", "robustness_all": "finetuning",
    "training_evolution_cifar10_seed_0": "finetuning",
    "robustness_training_cifar10": "finetuning",
    "adamw_sgd_robustness_cifar100": "ablation/finetuning", "plasticity_cifar10": "analysis",
    "theoretical_bounds": "theory", "loss_landscape": "loss_landscape"}


@pytest.mark.parametrize("name", list(FIGURES))
def test_figure_renders(csvs, name):
    _render(name)
    figures = csvs / "port" / "figures" / FIGURES[name]
    assert (figures / f"{name}.pdf").stat().st_size > 0
    if name == "loss_landscape":
        assert (figures / "ln1_block_0.pdf").exists()
        assert (figures / "mha_block_0" / "frame_000.png").exists()
        assert (figures / "mha_block_0.gif").stat().st_size > 0


def _commands(module) -> dict:
    """The commands that ``module.main`` hands to its ``make_cli``."""
    seen = {}
    real = module.make_cli
    module.make_cli = lambda commands, *args: seen.update(commands)
    try:
        module.main()
    finally:
        module.make_cli = real
    return seen


@pytest.mark.parametrize("name", ["finetuning", "ablation", "analysis", "theory",
                                  "loss_landscape"])
def test_cli_commands_match_jax(name):
    """Each port module offers the JAX module's commands under its names
    (``tests/test_cli_dispatch.py``), each a function of the port; theory
    adds ``save``, which pickles the bounds the card computes."""
    import importlib

    want = _commands(importlib.import_module(f"apps.plots.{name}"))
    got = _commands(importlib.import_module(f"vitef_tpu_torch.apps.plots.{name}"))
    extra = {"save"} if name == "theory" else set()
    assert set(got) == set(want) | extra
    for command, fn in got.items():
        assert fn.__module__ == f"vitef_tpu_torch.apps.plots.{name}", command
        if command in want:
            assert fn.__name__ == want[command].__name__, command


LAUNCHERS = ["finetuning.sh", "eval.sh", "linear_probing.sh", "analysis.sh",
             "ablation/adam.sh", "ablation/eval_adam.sh", "ablation/model_size.sh"]
STUB_TMUX = """#!/bin/sh
case "$1" in
  has-session) exit 0 ;;
  send-keys) printf '%s\\t%s\\n' "$3" "$4" >> "$TMUX_LOG" ;;
esac
"""


@pytest.mark.parametrize("launcher", LAUNCHERS)
def test_launcher_queues_the_jax_commands(tmp_path, launcher):
    """The port's launcher queues the JAX launcher's commands, session for
    session, with ``python -m apps.vit.`` made ``python -m vitef_tpu_torch.apps.vit.``."""
    stub = tmp_path / "bin" / "tmux"
    stub.parent.mkdir()
    stub.write_text(STUB_TMUX)
    stub.chmod(0o755)
    procs = {}
    for package, root in [("jax", REPO / "apps/vit/scripts"),
                          ("port", REPO / "vitef_tpu_torch/apps/vit/scripts")]:
        env = {**os.environ, "PATH": f"{stub.parent}:{os.environ['PATH']}",
               "TMUX_LOG": str(tmp_path / f"{package}.log")}
        procs[package] = subprocess.Popen(["bash", str(root / launcher)], cwd=REPO, env=env,
                                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    for package, proc in procs.items():
        _, err = proc.communicate(timeout=120)
        assert proc.returncode == 0 and not err, (package, err)
    want = (tmp_path / "jax.log").read_text().splitlines()
    got = (tmp_path / "port.log").read_text().splitlines()
    assert want and all("python -m apps.vit." in line for line in want)
    assert got == [line.replace("python -m apps.vit.", "python -m vitef_tpu_torch.apps.vit.")
                   for line in want]
