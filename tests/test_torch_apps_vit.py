"""The port's ViT command lines against the JAX package's, on the CPU.

One JAX-initialised tiny ViT is written as a step-0 checkpoint and copied into
a run dir for each package; both train command lines resume from it and run
4 steps of batch 16 on the same CIFAR pickles with the same seed, in float32
(``dp=-1``: the port on one device as 2 x 8 microbatches, the JAX package
data-parallel over the conftest's 8 CPU devices; both take the full batch's
mean gradient). Their logged loss, grad_norm and lr, their evaluations, the tensors
``components`` freezes and the trained weights agree. Then each package's
eval and linear probing read the other's run dir, and the plasticity
analysis runs over a PNG ImageNet-val folder and the CIFAR test split with
the same weights in both.
"""

import dataclasses
import json
import pickle
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import apps.vit.analysis as jax_analysis_app
import apps.vit.eval as jax_eval_app
import apps.vit.linear_probing as jax_probe_app
import apps.vit.train as jax_train_app
import vitef_tpu.config as jax_config
import vitef_tpu.monitor.orchestrator as jax_orch
from vitef_tpu.models import build_model as jax_build_model
from vitef_tpu.models.torch_import import hf_vit_to_vitef as jax_hf_vit_to_vitef
from vitef_tpu.optim import trainable_mask as jax_trainable_mask
from vitef_tpu.utils.tree import keystr_dotted
from vitef_tpu_torch.apps.vit import analysis as analysis_app
from vitef_tpu_torch.apps.vit import eval as eval_app
from vitef_tpu_torch.apps.vit import linear_probing as probe_app
from vitef_tpu_torch.apps.vit import train as train_app
from vitef_tpu_torch.models import build_model, from_jax_params, hf_vit_to_vitef
from vitef_tpu_torch.monitor import orchestrator as orch

TINY = {"model_name": "tiny", "patch_size": 16, "image_dim": (3, 32, 32)}
COMPONENTS = ["mha", "ffn_fc1"]
TRAIN = dict(**TINY, components=COMPONENTS, pretrained=False, in21k=False,
             dataset_name="cifar10", batch_size=16, val_batch_size=16, num_workers=0,
             n_steps=4, grad_clip=1.0, eval_period=2, optimizer="sgd", lr=0.05,
             momentum=0.9, scheduler="cosine", warmup=1, log_dir="parity", overwrite=False,
             logging_period=1, seed=42, auto_microbatch=8, dp=-1, tp=1,
             compute_dtype="float32")
REL = 1e-4


def _flat(params) -> dict:
    return {keystr_dotted(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}


def _records(run) -> list[dict]:
    return [json.loads(line) for line in
            (run / "metrics" / "raw_0.jsonl").read_text().splitlines()]


def _checkpoint(run):
    """The run's one surviving checkpoint dir."""
    (ckpt,) = (run / "checkpoints").iterdir()
    return ckpt


def _model_npz(ckpt) -> dict:
    with np.load(ckpt / "model.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' 4-step runs from one step-0 checkpoint, their paths
    patched into a tmp dir, and the CIFAR and ImageNet-val files."""
    root = tmp_path_factory.mktemp("apps")
    rng = np.random.default_rng(0)
    base = root / "cifar10" / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for fname in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        labels = rng.integers(0, 10, size=60)
        data = rng.integers(0, 64, size=(60, 3072), dtype=np.uint8)
        data[:, :1024] += (labels[:, None] * 19).astype(np.uint8)  # channel-0 cue
        with open(base / fname, "wb") as f:
            pickle.dump({b"data": data, b"labels": labels.tolist()}, f)
    # The probing set has a stronger class cue. sklearn's probe (lbfgs to
    # tol 1e-4 after a StandardScaler) moves a test image across a decision
    # boundary when its input moves by one float32 ulp wherever some image
    # lies near one: on the set above, the JAX package's own accuracy for a
    # key moved by 1/60 under such a change of its own embeddings. Here the
    # margins are wide enough for accuracies to be compared at 1e-6; the
    # embeddings themselves are compared too.
    base = root / "cifar10_probe" / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for fname in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        labels = rng.integers(0, 10, size=60)
        data = rng.integers(0, 8, size=(60, 3072), dtype=np.uint8)
        data[:, :1024] += (labels[:, None] * 24).astype(np.uint8)
        with open(base / fname, "wb") as f:
            pickle.dump({b"data": data, b"labels": labels.tolist()}, f)
    for c in range(2):
        folder = root / "imagenet" / "val" / f"n{c:02d}"
        folder.mkdir(parents=True)
        for i in range(6):
            size = (int(rng.integers(24, 48)), int(rng.integers(24, 48)), 3)
            Image.fromarray(rng.integers(0, 256, size=size, dtype=np.uint8)).save(
                folder / f"im_{i}.png")

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_config, "SAVING_DIR", root / "jax")
    mp.setattr(jax_orch, "RUN_DIR", root / "jax" / "runs")
    mp.setattr(orch, "RUN_DIR", root / "port" / "runs")
    for module, name in ((jax_probe_app, "PROBE_DIR"), (probe_app, "PROBE_DIR"),
                         (jax_analysis_app, "SAVE_DIR"), (analysis_app, "SAVE_DIR")):
        side = "jax" if module.__name__.startswith("apps.") else "port"
        mp.setattr(module, name, root / side / name.lower())

    jm = jax_build_model({"implementation": "vit", **TINY, "finetuning": True,
                          "n_classes": 10, "compute_dtype": "float32"},
                         key=jax.random.key(0))
    init = _flat(jm.params)
    step0 = root / "step0"
    step0.mkdir()
    np.savez(step0 / "model.npz", **init)
    (step0 / "training.json").write_text(json.dumps({"step": 0, "acc_step": 0}))
    for side in ("jax", "port"):
        shutil.copytree(step0, root / side / "runs" / "parity" / "checkpoints" / f"{0:010d}")

    jax_train_app.train(jax_train_app.TrainingConfig(**TRAIN, data_dir=str(root / "cifar10")))
    train_app.train(train_app.TrainingConfig(**TRAIN, data_dir=str(root / "cifar10"),
                                             device="cpu"))
    yield {"root": root, "init": init, "jax_run": root / "jax" / "runs" / "parity",
           "port_run": root / "port" / "runs" / "parity"}
    mp.undo()


def test_train_matches_jax(runs):
    want, got = _records(runs["jax_run"]), _records(runs["port_run"])
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    train = [(w, g) for w, g in zip(want, got) if "loss" in w]
    assert [g["step"] for _, g in train] == [1, 2, 3, 4]
    for w, g in train:
        assert g["elapsed_steps"] == w["elapsed_steps"] == 1
        for key in ("loss", "grad_norm", "lr"):
            assert g[key] == pytest.approx(w[key], rel=REL), (g["step"], key)
    evals = [(w, g) for w, g in zip(want, got) if "eval_acc" in w]
    assert [g["step"] for _, g in evals] == [2, 4]
    for w, g in evals:
        assert g["eval_acc"] == w["eval_acc"]
        assert g["eval_loss"] == pytest.approx(w["eval_loss"], rel=REL)
    for run in (runs["jax_run"], runs["port_run"]):
        assert sorted(p.name for p in run.iterdir()) == [
            "checkpoints", "config.json", "logs", "metrics"]
    assert sorted(p.name for p in (runs["port_run"] / "metrics").iterdir()) == sorted(
        p.name for p in (runs["jax_run"] / "metrics").iterdir())
    want_cfg = json.loads((runs["jax_run"] / "config.json").read_text())
    got_cfg = json.loads((runs["port_run"] / "config.json").read_text())
    assert got_cfg.pop("device") == "cpu"
    assert got_cfg.keys() == want_cfg.keys()


def test_checkpoint_freeze_and_weights_match_jax(runs):
    """The best checkpoint survives in both; ``components`` froze the same
    tensors (bit-equal to step 0) and the trained ones agree."""
    want_ckpt, got_ckpt = _checkpoint(runs["jax_run"]), _checkpoint(runs["port_run"])
    assert got_ckpt.name == want_ckpt.name
    assert sorted(p.name for p in got_ckpt.iterdir()) == sorted(
        p.name for p in want_ckpt.iterdir())
    assert json.loads((got_ckpt / "params.json").read_text()).keys() == json.loads(
        (want_ckpt / "params.json").read_text()).keys()
    want, got, init = _model_npz(want_ckpt), _model_npz(got_ckpt), runs["init"]
    assert sorted(got) == sorted(want) == sorted(init)
    frozen = {k for k in init if np.array_equal(want[k], init[k])}
    assert frozen == {k for k in init if np.array_equal(got[k], init[k])}
    jax_params = jax_build_model({"implementation": "vit", **TINY, "finetuning": True,
                                  "n_classes": 10}, key=jax.random.key(0)).params
    jax_frozen = {k for k, v in _flat(jax_trainable_mask(jax_params, COMPONENTS)).items()
                  if not v}
    model = build_model({"implementation": "vit", **TINY, "finetuning": True,
                         "n_classes": 10}, device="cpu")
    mask = train_app.freeze_components(model.module, COMPONENTS)
    assert frozen == jax_frozen == {k for k, v in mask.items() if not v}
    for key in init:
        np.testing.assert_allclose(got[key], want[key], rtol=REL, atol=1e-5, err_msg=key)


def test_eval_on_each_others_run_dirs(runs, monkeypatch):
    data_dir = str(runs["root"] / "cifar10")

    def both(run_root):
        monkeypatch.setattr(jax_orch, "RUN_DIR", run_root)
        monkeypatch.setattr(orch, "RUN_DIR", run_root)
        want = jax_eval_app.eval(jax_eval_app.EvaluationConfig(
            log_dir="parity", batch_size=16, data_dir=data_dir, num_workers=0))
        got = eval_app.eval(eval_app.EvaluationConfig(
            log_dir="parity", batch_size=16, data_dir=data_dir, num_workers=0, device="cpu"))
        record = json.loads((run_root / "parity" / "metrics" / "eval.jsonl").read_text())
        assert record["test_acc"] == got["eval_acc"]
        return got["eval_acc"], want["eval_acc"]

    for side in ("jax", "port"):
        got, want = both(runs["root"] / side / "runs")
        assert got == pytest.approx(want, abs=1e-6)


@pytest.fixture
def one_thread():
    """torch, and the BLAS under sklearn's probes, on one thread each: 64
    ``LogisticRegression`` fits of small problems, whose thread pools beside
    the other test workers of a shared CPU cost far more than their
    arithmetic (this test took 389 s under five workers and the mesh tests'
    ranks, 18 s alone)."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def test_linear_probing_on_each_others_run_dirs(runs, monkeypatch, one_thread):
    """Each package probes each run dir: the same keys and accuracies, and
    the embeddings the probes are fitted on (L2-normalised) within 1e-5."""
    config = dict(log_dir="parity", batch_size=16, val_batch_size=16, test_batch_size=16,
                  data_dir=str(runs["root"] / "cifar10_probe"), num_workers=0)
    embeddings = {"jax": [], "port": []}

    def recording(module, side):
        real = module.get_embeddings

        def get_embeddings(*args, **kwargs):
            out = real(*args, **kwargs)
            embeddings[side].append(out)
            return out
        monkeypatch.setattr(module, "get_embeddings", get_embeddings)

    recording(jax_probe_app, "jax")
    recording(probe_app, "port")
    for side in ("jax", "port"):
        monkeypatch.setattr(jax_orch, "RUN_DIR", runs["root"] / side / "runs")
        monkeypatch.setattr(orch, "RUN_DIR", runs["root"] / side / "runs")
        want = jax_probe_app.linear_probing(jax_probe_app.LinearProbingConfig(**config))
        got = probe_app.linear_probing(probe_app.LinearProbingConfig(**config, device="cpu"))
        assert sorted(got) == sorted(want) and len(got) == 8 * 2
        for key in want:
            assert got[key] == pytest.approx(want[key], abs=1e-6), (side, key)
        saved = runs["root"] / "port" / "probe_dir" / "parity"
        assert json.loads((saved / "linear_probing.json").read_text()) == got
        assert json.loads((saved / "config.json").read_text())["device"] == "cpu"
    assert len(embeddings["port"]) == len(embeddings["jax"]) == 4  # train, test per run dir
    for (want, want_labels), (got, got_labels) in zip(embeddings["jax"], embeddings["port"]):
        np.testing.assert_array_equal(got_labels, want_labels)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5, err_msg=key)


def test_analysis_matches_jax(runs, monkeypatch):
    """The same in21k tiny ViT (the JAX package's init, carried across) over
    ImageNet val and the CIFAR test split: the same keys and distances."""
    config = dict(**TINY, dataset_name="cifar10", batch_size=4, n_steps=3,
                  data_dir=str(runs["root"] / "cifar10"),
                  imagenet_dir=str(runs["root"] / "imagenet"), num_workers=0)
    jax_analysis_app.analysis(jax_analysis_app.AnalysisConfig(**config))
    real_build = analysis_app.build_model

    def build_with_jax_weights(model_config, **kw):
        model = real_build(model_config, **kw)
        jax_model = jax_build_model(model_config, key=jax.random.key(config_seed))
        model.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                                  jax_model.params)))
        return model

    config_seed = analysis_app.AnalysisConfig().seed
    monkeypatch.setattr(analysis_app, "build_model", build_with_jax_weights)
    analysis_app.run_analysis(**config, device="cpu")
    name = "analysis_vit-tiny-patch16-32-in21k_pretrained_True_cifar10"
    with open(runs["root"] / "jax" / "save_dir" / name / "distances.pkl", "rb") as f:
        want = pickle.load(f)
    with open(runs["root"] / "port" / "save_dir" / name / "distances.pkl", "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == sorted(want) and len(got) == 1 + 5 * 2
    for key in want:
        assert got[key].shape == want[key].shape == (3 * 4,)
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-4 * np.abs(want[key]).max(), err_msg=key)
    saved = json.loads((runs["root"] / "port" / "save_dir" / name / "config.json").read_text())
    assert saved["n_steps"] == 3 and saved["device"] == "cpu"


def test_preemption_saves_the_latest_step_and_resumes(runs, monkeypatch):
    polls = []

    class PreemptAfterStep3(train_app.PreemptionGuard):
        @property
        def requested(self):
            polls.append(1)
            return len(polls) == 3

    config = {**TRAIN, "data_dir": str(runs["root"] / "cifar10"), "device": "cpu",
              "log_dir": "preempt", "n_steps": 5, "eval_period": 2}
    monkeypatch.setattr(train_app, "PreemptionGuard", PreemptAfterStep3)
    train_app.train(train_app.TrainingConfig(**config))
    run = runs["root"] / "port" / "runs" / "preempt"
    assert _checkpoint(run).name == f"{3:010d}"  # the latest, not the best (step 2)
    assert json.loads((_checkpoint(run) / "training.json").read_text())["step"] == 3
    monkeypatch.setattr(train_app, "PreemptionGuard", train_app.PreemptionGuard)
    train_app.train(train_app.TrainingConfig(**config))
    # the first run stopped after step 3, before logging it; the second
    # resumed there
    logged = [(r["step"], r["elapsed_steps"]) for r in _records(run) if "loss" in r]
    assert logged == [(1, 1), (2, 1), (4, 1), (5, 1)]


@pytest.mark.parametrize("knobs", [{"dp": 2}, {"dp": 8}, {"tp": 2}, {"fsdp": True},
                                   {"remat": True}], ids=str)
def test_train_refuses_more_than_one_card(runs, knobs):
    """One process is a mesh of one rank: ``dp`` 2 or 8, or ``tp`` 2, need
    more ranks and raise the JAX package's AssertionError (dp · tp must be
    the world size) before a run dir is made (the mesh's ranks are
    tests/test_torch_mesh.py's). ``fsdp`` (on one rank nothing is split, and
    the step takes the sharded model's path) and ``remat`` run: from the same
    step-0 checkpoint each logs what the JAX package's run without them logs
    (neither changes a value)."""
    if "remat" in knobs or "fsdp" in knobs:
        (name,) = knobs
        log_dir = runs["root"] / "port" / "runs" / name
        shutil.copytree(runs["root"] / "step0", log_dir / "checkpoints" / f"{0:010d}")
        train_app.train(train_app.TrainingConfig(**{**TRAIN, **knobs, "device": "cpu",
                                                    "log_dir": name,
                                                    "data_dir": str(runs["root"] / "cifar10")}))
        assert json.loads((log_dir / "config.json").read_text())[name] is True
        want = [r for r in _records(runs["jax_run"]) if "loss" in r]
        got = [r for r in _records(log_dir) if "loss" in r]
        assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 4]
        for w, g in zip(want, got):
            for key in ("loss", "grad_norm"):
                assert g[key] == pytest.approx(w[key], rel=REL), (g["step"], key)
        return
    with pytest.raises(AssertionError, match="must equal the number of devices"):
        train_app.train(train_app.TrainingConfig(**{**TRAIN, **knobs, "device": "cpu",
                                                    "log_dir": "refused"}))
    assert not (runs["root"] / "port" / "runs" / "refused").exists()


def test_command_lines_need_a_card_unless_cpu(runs, monkeypatch):
    """``device`` defaults to the card, and the command lines raise without
    one; ``main()`` reads ``sys.argv``."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    configs = Path(__file__).resolve().parents[1] / "apps" / "vit" / "configs"
    monkeypatch.setattr(sys, "argv", ["train", f"config={configs / 'cifar10.yaml'}",
                                      "log_dir=nocard"])
    with pytest.raises(RuntimeError, match="device=cpu"):
        train_app.main()
    assert not (runs["root"] / "port" / "runs" / "nocard").exists()
    with pytest.raises(RuntimeError, match="device=cpu"):
        eval_app.main([f"config={configs / 'eval.yaml'}", "log_dir=parity"])
    with pytest.raises(RuntimeError, match="device=cpu"):
        probe_app.main([f"config={configs / 'linear_probing.yaml'}"])
    with pytest.raises(RuntimeError, match="device=cpu"):
        analysis_app.main(["run", "--model_name", "tiny"])


def test_hf_vit_to_vitef_matches_jax():
    rng = np.random.default_rng(0)
    e, f, layers = 8, 16, 2
    shapes = {"vit.embeddings.cls_token": (1, 1, e),
              "vit.embeddings.patch_embeddings.projection.weight": (e, 3, 4, 4),
              "vit.embeddings.patch_embeddings.projection.bias": (e,),
              "vit.embeddings.position_embeddings": (1, 5, e),
              "vit.layernorm.weight": (e,), "vit.layernorm.bias": (e,),
              "classifier.weight": (3, e), "classifier.bias": (3,)}
    for i in range(layers):
        h = f"vit.encoder.layer.{i}."
        for name in ("layernorm_before", "layernorm_after"):
            shapes.update({h + f"{name}.weight": (e,), h + f"{name}.bias": (e,)})
        for m in ("query", "key", "value"):
            shapes.update({h + f"attention.attention.{m}.weight": (e, e),
                           h + f"attention.attention.{m}.bias": (e,)})
        shapes.update({h + "attention.output.dense.weight": (e, e),
                       h + "attention.output.dense.bias": (e,),
                       h + "intermediate.dense.weight": (f, e),
                       h + "intermediate.dense.bias": (f,),
                       h + "output.dense.weight": (e, f), h + "output.dense.bias": (e,)})
    hf = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    want, got = jax_hf_vit_to_vitef(dict(hf), layers), hf_vit_to_vitef(dict(hf), layers)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_configs_are_the_jax_fields_and_device():
    pairs = [(jax_train_app.TrainingConfig, train_app.TrainingConfig),
             (jax_eval_app.EvaluationConfig, eval_app.EvaluationConfig),
             (jax_probe_app.LinearProbingConfig, probe_app.LinearProbingConfig),
             (jax_analysis_app.AnalysisConfig, analysis_app.AnalysisConfig)]
    for jax_cls, port_cls in pairs:
        want = {f.name: f.default for f in dataclasses.fields(jax_cls)}
        got = {f.name: f.default for f in dataclasses.fields(port_cls)}
        assert got.pop("device") == "cuda"
        assert got == want, port_cls.__name__
