"""The port's config reader and monitor against the JAX package's, on the CPU.

Config parity: each ``apps/vit/configs/*.yaml`` read by both packages'
``load_config_from_cli`` (the port parses the YAML subset itself; the JAX
package uses PyYAML). The run dir, the checkpointer's step dirs, garbage
collection, eval flags and incomplete dirs, the logger's files and the
checkpoint interop: a ``model.npz`` either package wrote loads into the
other with the same arrays; an optax ``optim.npz`` raises in the port.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import apps.vit.eval as jax_eval_app
import apps.vit.linear_probing as jax_probe_app
import apps.vit.train as jax_train_app
import vitef_tpu.monitor as jax_monitor
import vitef_tpu.monitor.checkpoint as jax_checkpoint
import vitef_tpu.monitor.orchestrator as jax_orch
from vitef_tpu.models import build_model as jax_build_model
from vitef_tpu.utils import cli as jax_cli
from vitef_tpu.utils.tree import keystr_dotted
from vitef_tpu_torch import monitor
from vitef_tpu_torch.apps.vit import eval as eval_app
from vitef_tpu_torch.apps.vit import linear_probing as probe_app
from vitef_tpu_torch.apps.vit import train as train_app
from vitef_tpu_torch.models import build_model, from_jax_params, to_jax_params
from vitef_tpu_torch.monitor import checkpoint as CK
from vitef_tpu_torch.monitor import orchestrator as orch
from vitef_tpu_torch.parallel import mesh
from vitef_tpu_torch.utils import cli

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "apps" / "vit" / "configs").glob("*.yaml"))
CONFIG_CLASSES = {"eval": (jax_eval_app.EvaluationConfig, eval_app.EvaluationConfig),
                  "linear_probing": (jax_probe_app.LinearProbingConfig,
                                     probe_app.LinearProbingConfig)}
TINY_VIT = {"implementation": "vit", "model_name": "tiny", "patch_size": 16,
            "image_dim": (3, 32, 32), "finetuning": True, "n_classes": 10}


def _flat_jax(params) -> dict:
    return {keystr_dotted(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}


# ------------------------------------------------------------------------------
# Config reading
# ------------------------------------------------------------------------------


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_config_file_matches_jax(path):
    jax_cls, port_cls = CONFIG_CLASSES.get(
        path.stem, (jax_train_app.TrainingConfig, train_app.TrainingConfig))
    argv = [f"config={path}"]
    want = dataclasses.asdict(jax_cli.load_config_from_cli(jax_cls, argv))
    got = dataclasses.asdict(cli.load_config_from_cli(port_cls, argv))
    # the port's one extra field: the card unless the CPU is asked for
    assert got.pop("device") == "cuda"
    assert got == want
    assert cli.parse_yaml_mapping(path.read_text()) == yaml.safe_load(path.read_text())


def test_cli_values_match_jax():
    argv = ["lr=1e-2", "n_steps=10_000", "checkpoint_step=0000001000", "warmup=0x10",
            "components=[mha, 'ffn_fc1', \"ffn_fc2\"]", "pretrained=False", "in21k=yes",
            "grad_clip=null", "image_dim=[3, 32, 32]", "momentum=.5", "min_factor=1.5e+1",
            "log_dir=vit_cifar10 # a comment", "data_dir=/tmp/a:b", "seed=~",
            "model.size=tiny", "components2=[]", "scale=1_000.5"]
    assert cli.from_cli(argv) == jax_cli.from_cli(argv)
    cfg = cli.load_config_from_cli(eval_app.EvaluationConfig,
                                   ["checkpoint_step=0000001000", "seed=7"])
    assert cfg.checkpoint_step == "0000001000" and cfg.seed == 7
    cfg = cli.load_config_from_cli(train_app.TrainingConfig, ["lr=1e-2", "n_steps=10_000"])
    assert cfg.lr == 0.01 and cfg.n_steps == 10_000


def test_yaml_subset_matches_pyyaml():
    text = """# header
a: 10_000
b: 1e-2          # a string under YAML 1.1
c: 1.0e-2
d: [3, 224, 224]
e: []
f: "cosine"
g: 'it''s'
h: True
i: off
j: NULL
k:
l: [[1, 2], [a, "b c"], ]
m: 0755
n: -.inf
o: http://host/x
p: a b c
b: overridden
"""
    assert cli.parse_yaml_mapping(text) == yaml.safe_load(text)
    assert cli.parse_yaml_mapping("") == {}


@pytest.mark.parametrize("text", [
    "a:\n  b: 1", "- a\n- b", "a: {b: 1}", "a: &x 1", "a: *x", "a: !!str 1", "a: 1:30",
    "a: 2001-12-14", "a: [1, 2", "a: 'open", "a: b: c", "a: [b: 1]", "a: |", "---\na: 1",
    "just a scalar", "a: [,]"])
def test_yaml_outside_subset_raises(text):
    with pytest.raises(ValueError):
        cli.parse_yaml_mapping(text)


# ------------------------------------------------------------------------------
# Run dir, logger, utility, rank helpers
# ------------------------------------------------------------------------------


def _tree(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def test_orchestrator_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_orch, "RUN_DIR", tmp_path / "jax" / "runs")
    monkeypatch.setattr(orch, "RUN_DIR", tmp_path / "port" / "runs")
    config = {"log_dir": "exp1", "config_file": {"model": {"name": "vit"}, "lr": 0.1,
                                                  "path": tmp_path},
              "checkpoint_period": 5, "checkpoint_n_kept": 2, "logging_period": 10,
              "seed": 7}
    want = jax_monitor.build_orchestrator(config)
    got = monitor.build_orchestrator(config)
    for key in ("checkpointer", "logger", "utility"):
        w, g = dataclasses.asdict(want[key]), dataclasses.asdict(got[key])
        assert {k: str(v).replace("/jax/", "/") for k, v in w.items()} == \
            {k: str(v).replace("/port/", "/") for k, v in g.items()}, key
    run_w, run_g = tmp_path / "jax" / "runs" / "exp1", tmp_path / "port" / "runs" / "exp1"
    assert _tree(run_w) == _tree(run_g) == ["config.json"]
    assert (run_w / "config.json").read_text() == (run_g / "config.json").read_text()

    for step in (3, 10):
        for run in (run_w, run_g):
            d = run / "checkpoints" / f"{step:010d}"
            d.mkdir(parents=True)
            np.savez(d / "model.npz", w=np.zeros(1))
            (d / "training.json").write_text(json.dumps({"step": step}))
    for step in ("", "3", "0000000003"):
        want = jax_monitor.build_eval_orchestrator({"log_dir": "exp1",
                                                    "checkpoint_step": step})
        got = monitor.build_eval_orchestrator({"log_dir": "exp1", "checkpoint_step": step})
        assert got["checkpoint_dir"].name == Path(want["checkpoint_dir"]).name
        assert got["exp_config"] == want["exp_config"]


def test_logger_and_utility(tmp_path):
    import gc

    cfg = monitor.LoggerConfig(period=1, stdout_path=str(tmp_path / "logs"),
                               metric_path=str(tmp_path / "metrics"))
    model = build_model(TINY_VIT, device="cpu")
    trainable = train_app.freeze_components(model.module, ["mha"])
    with monitor.Logger(cfg) as log:
        log({"loss": 1.5, "step": 1})
        log.report_model_size(model.module, trainable)
    rec = json.loads((tmp_path / "metrics" / "raw_0.jsonl").read_text())
    assert rec["loss"] == 1.5 and rec["step"] == 1 and "ts" in rec
    assert (tmp_path / "logs" / "device_0.log").exists()
    info = json.loads((tmp_path / "metrics" / "info_model.jsonl").read_text())
    assert info["model_params"] == sum(p.numel() for p in model.module.parameters()
                                       if p.requires_grad)
    with monitor.Logger(cfg, eval=True) as log:
        log({"test_acc": 0.9})
    with monitor.Logger(cfg, eval=True) as log:  # an eval logger empties eval.jsonl
        log({"test_acc": 0.8})
    assert [json.loads(line)["test_acc"] for line in
            (tmp_path / "metrics" / "eval.jsonl").read_text().splitlines()] == [0.8]

    with monitor.Utility(monitor.UtilityConfig(seed=3, period=2)) as utility:
        assert not gc.isenabled()
        first = np.random.random()
        utility()
        utility()
    assert gc.isenabled()
    np.random.seed(3)
    assert first == np.random.random()
    assert mesh.get_rank() == 0 and mesh.is_master_process() and mesh.get_hostname()


def test_preemption_guard_and_profiler(tmp_path):
    with monitor.PreemptionGuard() as guard:
        assert not guard.requested
        guard.request()
        assert guard.requested
    with monitor.trace(str(tmp_path / "trace")) as prof:
        torch.ones(4).sum()
    assert prof is not None and (tmp_path / "trace" / "trace.json").exists()
    timer = monitor.StepTimer(warmup=1, images_per_step=8)
    for _ in range(4):
        timer.tick()
    summary = timer.summary()
    assert summary["images_per_sec"] > 0 and summary["steps_per_sec"] > 0


# ------------------------------------------------------------------------------
# Checkpointer
# ------------------------------------------------------------------------------


def _lifecycle(package, ckpt_dir: Path):
    """test_monitor.py's lifecycle: period 2, keep 2, an eval flag on step 7,
    then a resume. Returns the dir names and the resumed training dict."""
    state = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "step": 0}
    loaded = {}

    def get_state():
        return {"model": {"w": state["w"]}, "optim": None,
                "training": {"step": state["step"], "acc_step": 0}}

    def set_state(model_flat, optim_flat, training):
        loaded.update(model=model_flat, training=training)

    cfg = package.CheckpointerConfig(period=2, n_kept=2, path=str(ckpt_dir))
    with package.Checkpointer(cfg, get_state, set_state, model_config={"emb_dim": 4}) as ck:
        for i in range(1, 8):
            state["step"] = i
            state["w"] = state["w"] + 1.0
            ck()
        ck.update(eval_flag="best")
    names = sorted(p.name for p in ckpt_dir.iterdir())
    with package.Checkpointer(cfg, get_state, set_state) as ck:
        ck.sync_step(ck.step)
    return names, loaded


def test_checkpointer_lifecycle_matches_jax(tmp_path):
    want, want_loaded = _lifecycle(jax_monitor, tmp_path / "jax")
    got, got_loaded = _lifecycle(monitor, tmp_path / "port")
    assert got == want == ["0000000006", "0000000007"]
    step7 = tmp_path / "port" / "0000000007"
    assert sorted(p.name for p in step7.iterdir()) == sorted(
        p.name for p in (tmp_path / "jax" / "0000000007").iterdir())
    assert json.loads((step7 / "params.json").read_text()) == {"emb_dim": 4}
    assert got_loaded["training"] == want_loaded["training"] == {"step": 7, "acc_step": 0}
    np.testing.assert_array_equal(got_loaded["model"]["w"], want_loaded["model"]["w"])


def test_checkpointer_writes_one_process_pieces_whole(tmp_path):
    """In a run of one process, the pieces the train command line hands the
    checkpointer are written as ``model.npz`` and ``optim.npz``, equal to
    the whole-state helpers' arrays, and load back as they were saved."""
    torch.manual_seed(0)
    module = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.LayerNorm(4))
    optimizer = torch.optim.AdamW(module.parameters(), lr=1e-2)
    module(torch.randn(2, 3)).square().sum().backward()
    optimizer.step()
    ck = monitor.Checkpointer(
        monitor.CheckpointerConfig(path=str(tmp_path)),
        lambda: {"model": CK.model_pieces(module),
                 "optim": CK.optimizer_pieces(optimizer, module), "training": {"step": 1}})
    ck.step = 1
    ck.update()
    ck._wait()
    step = tmp_path / "0000000001"
    assert sorted(p.name for p in step.iterdir()) == ["model.npz", "optim.npz", "training.json"]
    for name, want in (("model", CK.model_state(module)),
                       ("optim", CK.optimizer_state(optimizer, module))):
        with np.load(step / f"{name}.npz") as z:
            assert sorted(z.files) == sorted(want)
            for key in want:
                np.testing.assert_array_equal(z[key], want[key])
    loaded = {}
    monitor.Checkpointer(monitor.CheckpointerConfig(path=str(tmp_path)), None,
                         lambda m, o, t: loaded.update(model=m, optim=o, training=t)).load(step)
    assert loaded["training"] == {"step": 1}
    for key, value in CK.model_state(module).items():
        np.testing.assert_array_equal(loaded["model"][key], value)


def test_checkpointer_eval_flag_and_incomplete_dirs(tmp_path):
    ck = monitor.Checkpointer(monitor.CheckpointerConfig(period=1, n_kept=1,
                                                         path=str(tmp_path / "c")),
                              lambda: {"model": {"v": np.ones(2)}, "optim": None,
                                       "training": {}})
    with ck:
        ck()
        ck.update(eval_flag="best")  # flags step 1: kept past the window
        for _ in range(3):
            ck()
    names = sorted(p.name for p in (tmp_path / "c").iterdir())
    assert names == ["0000000001", "0000000004"]
    assert not list((tmp_path / "c").glob(".tmp_*"))  # written through tmp dirs

    root = tmp_path / "c"
    junk_new, junk_old, partial = root / "0000000009", root / "0000000002", root / "0000000007"
    for junk in (junk_new, junk_old, partial):
        junk.mkdir()
        (junk / "model.shard0.npz").touch()
    (partial / "training.json").write_text("{}")
    (partial / "index.json").write_text('{"n_processes": 2, "model": {}}')
    assert Path(monitor.Checkpointer.get_last_checkpoint_path(root)).name == "0000000004"
    ck._cleaning()
    assert not junk_old.exists() and junk_new.exists() and (root / "0000000001").exists()
    # the sharded layout is read (tests/test_torch_mesh.py), and a dir
    # without its index raises as the JAX reader does
    with pytest.raises(FileNotFoundError):
        CK._load_flat(junk_new, "model")
    with pytest.raises(FileNotFoundError):
        jax_checkpoint._load_flat(junk_new, "model")
    with pytest.raises(FileNotFoundError, match="missing model.shard1.npz"):
        CK._load_flat(partial, "model")


def test_to_jax_params_inverts_from_jax_params():
    jm = jax_build_model(TINY_VIT, key=jax.random.key(0))
    flat = _flat_jax(jm.params)
    back = to_jax_params(from_jax_params(jax.tree.map(np.asarray, jm.params)))
    assert sorted(back) == sorted(flat)
    for key, value in flat.items():
        assert back[key].dtype == value.dtype and back[key].shape == value.shape, key
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_model_npz_interop(tmp_path):
    """A port-written model.npz loads through the JAX load_checkpoint_params
    and a JAX-written one into the port, with the same arrays."""
    jm = jax_build_model(TINY_VIT, key=jax.random.key(1))
    port = build_model(TINY_VIT, device="cpu", generator=torch.Generator().manual_seed(5))
    ck = monitor.Checkpointer(monitor.CheckpointerConfig(path=str(tmp_path / "port")),
                              lambda: {"model": CK.model_state(port.module), "optim": None,
                                       "training": {"step": 1}})
    with ck:
        ck.step = 1
        ck.update()
    loaded = jax_monitor.load_checkpoint_params(tmp_path / "port" / "0000000001", jm.params)
    for key, value in _flat_jax(loaded).items():
        np.testing.assert_array_equal(value, to_jax_params(port.module.state_dict())[key],
                                      err_msg=key)

    jck = jax_monitor.Checkpointer(jax_monitor.CheckpointerConfig(path=str(tmp_path / "jax")),
                                   lambda: {"model": jm.params, "optim": None,
                                            "training": {"step": 2}})
    with jck:
        jck.step = 2
        jck.update()
    monitor.load_checkpoint_params(tmp_path / "jax" / "0000000002", port.module)
    want = from_jax_params(jax.tree.map(np.asarray, jm.params))
    for key, value in port.module.state_dict().items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_optimizer_state_round_trip(name, tmp_path):
    from vitef_tpu_torch.optim import build_optimizer

    def make():
        model = build_model(TINY_VIT, device="cpu")
        opt, _ = build_optimizer({"optimizer": name, "lr": 0.1, "momentum": 0.9},
                                 model.module, components=["mha"])
        return model, opt

    model, opt = make()
    model.apply(torch.ones(2, 3, 32, 32)).sum().backward()
    opt.step()
    flat = CK.optimizer_state(opt, model.module)
    np.savez(tmp_path / "optim.npz", **flat)
    with np.load(tmp_path / "optim.npz") as z:
        flat = {k: z[k] for k in z.files}
    model2, opt2 = make()
    CK.load_optimizer_state(opt2, model2.module, flat)
    params2 = dict(model2.module.named_parameters())
    for pname, p in model.module.named_parameters():
        if p.requires_grad:
            for key, value in opt.state[p].items():
                torch.testing.assert_close(opt2.state[params2[pname]][key], value,
                                           rtol=0, atol=0)
        else:
            assert params2[pname] not in opt2.state
    other, _ = make()
    with pytest.raises(ValueError):
        CK.load_optimizer_state(
            torch.optim.SGD(other.module.parameters(), lr=0.1) if name == "adamw"
            else torch.optim.AdamW(other.module.parameters()), other.module, flat)


def test_optax_optim_npz_raises(tmp_path):
    """The JAX package's optim.npz (optax state) is refused by name, never
    replaced by a fresh optimizer."""
    import optax

    jm = jax_build_model(TINY_VIT, key=jax.random.key(0))
    opt_state = optax.sgd(0.1, momentum=0.9).init(jm.params)
    jck = jax_monitor.Checkpointer(jax_monitor.CheckpointerConfig(path=str(tmp_path)),
                                   lambda: {"model": jm.params, "optim": opt_state,
                                            "training": {"step": 3}})
    with jck:
        jck.step = 3
        jck.update()
    model = build_model(TINY_VIT, device="cpu")
    opt = torch.optim.SGD(model.module.parameters(), lr=0.1, momentum=0.9)

    def set_state(model_flat, optim_flat, training):
        CK.load_model_state(model.module, model_flat)
        CK.load_optimizer_state(opt, model.module, optim_flat)

    with pytest.raises(NotImplementedError, match="optax"):
        with monitor.Checkpointer(monitor.CheckpointerConfig(path=str(tmp_path)),
                                  lambda: {}, set_state):
            pass
