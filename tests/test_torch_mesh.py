"""The port's ('dp', 'tp') mesh vs the JAX package's, on the CPU.

``build_mesh`` and ``param_shardings`` (no ranks); the loader's process
shards against the JAX loader's ``_epoch_order``; and, on gloo ranks, two
steps of a tiny ViT through ``make_train_step(mesh=)`` at dp = 2 and through
``shard_params`` at (dp, tp, fsdp) = (2, 1, fsdp), (1, 2, -) and (2, 2, fsdp),
with two microbatches a step and, under FSDP, the paper's component freeze,
against the JAX steps on meshes of the same shape over the test suite's
8-device CPU mesh (``tests/conftest.py``); PatchTST's running statistics
averaged over dp = 2; the sharded checkpoint both ways and a resume from it;
a two-rank run of the ViT train command line against the JAX data-parallel
step on the same two loader shards; and ``DecodeServer(mesh=)`` at (2, 1),
(1, 2) and (2, 2), with and without a prefix, against the one-rank server
and the JAX mesh server. float32 throughout, at 1e-4 / 1e-4.

The ranks are this file run as ``python tests/test_torch_mesh.py worker
<world> <rank> <port> <dir>``: one launch per world size (2 and 4), started
with the module's first test, each rank running every case of its world and
writing its results as ``.npz``; a rank exits before the file's JAX imports.
"""

import functools
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from vitef_tpu_torch.models import build_model
from vitef_tpu_torch.monitor.checkpoint import (Checkpointer, CheckpointerConfig, _assemble,
                                                _load_flat, load_model_state,
                                                load_optimizer_state, model_pieces,
                                                optimizer_pieces)
from vitef_tpu_torch.optim import build_optimizer
from vitef_tpu_torch.parallel import (build_mesh, init_train_state, make_train_step,
                                      param_shardings, shard_batch, shard_params)

REPO = Path(__file__).resolve().parents[1]

# The small ViT of tests/test_torch_train.py: 2 layers, emb 64, 4 heads, L = 17.
VIT = {"implementation": "transformer", "image_dim": (3, 32, 32),
       "patch_type": "computer_vision", "patch_size": 8, "emb_type": "linear",
       "emb_dim": 64, "n_heads": 4, "n_layers": 2, "attn_bias": True,
       "ffn_bias": True, "norm": "layer", "norm_bias": True, "norm_eps": 1e-12,
       "pre_norm": True, "cls_token": True, "output_type": "classification",
       "n_classes": 10, "compute_dtype": "float32"}
# The tiny PatchTST of tests/test_torch_patchtst.py.
PATCHTST = {"implementation": "transformer", "length": 64, "patch_type": "time_series",
            "patch_size": 16, "stride": 8, "emb_type": "linear", "emb_dim": 32, "n_heads": 4,
            "n_layers": 2, "ffn_dim": 64, "pos_emb": True, "attn_bias": True,
            "causal": False, "activation": "gelu", "ffn_bias": True, "norm": "batch",
            "norm_bias": True, "pre_norm": False, "cls_token": False,
            "output_type": "forecasting", "weight_tying": False, "forecasting_horizon": 24,
            "compute_dtype": "float32"}
# The decoder of tests/test_torch_serving.py, with 4 heads over 2 KV heads
# so that tp = 2 splits both.
DECODER = {"implementation": "transformer", "vocab_size": 48, "emb_type": "dict",
           "emb_dim": 16, "n_heads": 4, "n_kv_heads": 2, "n_layers": 2, "seq_len": 48,
           "causal": True, "pre_norm": True, "weight_tying": True,
           "output_type": "sequence_to_sequence", "attn_bias": True, "ffn_bias": True,
           "norm_bias": True, "cls_token": False, "pos_emb": True, "compute_dtype": "float32",
           "attn_impl": "xla", "norm_impl": "xla"}
ADAMW = {"optimizer": "adamw", "lr": 1e-3, "weight_decay": 0.01}
SGD = {"optimizer": "sgd", "lr": 0.01}
FREEZE = ["mha", "ffn_fc1"]           # the paper's component freeze, under FSDP
CLIP = 0.5
BATCH, ACC = 8, 2                     # global rows a step, microbatches a step
# (case name, dp, tp, fsdp, route) of the ViT steps, per world size; route
# "mesh" is make_train_step(mesh=), "shard" is shard_params + mesh=None.
STEP_CASES = {2: [("dp", 2, 1, False, "mesh"), ("fsdp", 2, 1, True, "shard"),
                  ("tp", 1, 2, False, "shard")],
              4: [("fsdp-tp", 2, 2, True, "shard")]}
SERVE_MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
N_SLOTS, BUCKET = 4, 8
# The two-rank train command line (the fixture of tests/test_torch_apps_vit.py).
TINY_VIT = {"model_name": "tiny", "patch_size": 16, "image_dim": (3, 32, 32)}
TRAIN = dict(**TINY_VIT, components=FREEZE, pretrained=False, in21k=False,
             dataset_name="cifar10", batch_size=4, val_batch_size=16, num_workers=0,
             n_steps=3, grad_clip=1.0, eval_period=3, optimizer="sgd", lr=0.05,
             momentum=0.9, scheduler="cosine", warmup=1, log_dir="mesh", overwrite=False,
             logging_period=1, seed=42, auto_microbatch=2, tp=1, compute_dtype="float32")
WORKER_TIMEOUT = 300
ATOL, RTOL = 1e-4, 1e-4


# ---------------------------------------------------------------------------
# The ranks: this file run as a worker
# ---------------------------------------------------------------------------


def _whole(module, world: int) -> dict:
    """Every rank's pieces of the module's state, assembled into the whole
    arrays in the JAX layout (on every rank)."""
    import torch.distributed as dist

    mine = model_pieces(module)
    every = [None] * world
    dist.all_gather_object(every, mine.pieces)
    return _assemble(mine.meta, every)


def _vit_steps(data, mesh, world, fsdp, route, res, name, ckpt_dir=None):
    m = build_model(VIT, device="cpu")
    m.module.load_state_dict({k[4:]: torch.from_numpy(v) for k, v in data.items()
                              if k.startswith("vit/")})
    if route == "shard":
        shard_params(m, mesh, fsdp=fsdp)
    opt, sched = build_optimizer(ADAMW, m.module, components=FREEZE if fsdp else None)
    state = init_train_state(m, opt, sched)
    step = make_train_step(grad_acc_steps=ACC, grad_clip=CLIP,
                           mesh=mesh if route == "mesh" else None)
    for i in range(2):
        batch = (torch.from_numpy(data[f"x{i}"]), torch.from_numpy(data[f"y{i}"]))
        metrics = step(state, shard_batch(batch, mesh))
        for key in ("loss", "grad_norm"):
            res[f"{name}/{key}{i}"] = metrics[key].numpy()
    for key, value in _whole(m.module, world).items():
        res[f"{name}/param/{key}"] = value
    if ckpt_dir is None:
        return
    # The sharded checkpoint: save, load into a fresh sharded model and take
    # one more step from each; the two must agree bit for bit.
    config = CheckpointerConfig(path=str(ckpt_dir))
    ckpt = Checkpointer(config, lambda: {"model": model_pieces(m.module),
                                         "optim": optimizer_pieces(opt, m.module),
                                         "training": {"step": 2, "acc_step": 0}})
    ckpt.step = 2
    ckpt.update()
    ckpt.__exit__(None, None, None)
    torch.distributed.barrier()  # every rank's shards are written
    m2 = build_model(VIT, device="cpu")
    shard_params(m2, mesh, fsdp=fsdp)
    opt2, sched2 = build_optimizer(ADAMW, m2.module, components=FREEZE if fsdp else None)
    state2 = init_train_state(m2, opt2, sched2)

    def set_state(model_flat, optim_flat, training):
        load_model_state(m2.module, model_flat)
        load_optimizer_state(opt2, m2.module, optim_flat)

    Checkpointer(config, None, set_state).__enter__()
    batch = shard_batch((torch.from_numpy(data["x0"]), torch.from_numpy(data["y0"])), mesh)
    for tag, (model, st) in {"saved": (m, state), "resumed": (m2, state2)}.items():
        metrics = step(st, batch)
        res[f"{name}/{tag}/loss"] = metrics["loss"].numpy()
        res[f"{name}/{tag}/grad_norm"] = metrics["grad_norm"].numpy()
        res[f"{name}/{tag}/param"] = np.concatenate(
            [v.reshape(-1) for _, v in sorted(_whole(model.module, world).items())])


def _stats_steps(data, mesh, res):
    m = build_model(PATCHTST, device="cpu")
    m.module.load_state_dict({k[4:]: torch.from_numpy(v) for k, v in data.items()
                              if k.startswith("pts/")})
    opt, sched = build_optimizer(SGD, m.module)
    state = init_train_state(m, opt, sched)
    step = make_train_step(grad_acc_steps=ACC, update_stats=True, mesh=mesh,
                           loss_fn=lambda p, y: torch.mean(torch.square(p - y)))
    for i in range(2):
        batch = (torch.from_numpy(data[f"series{i}"]), torch.from_numpy(data[f"target{i}"]))
        metrics = step(state, shard_batch(batch, mesh))
        for key in ("loss", "grad_norm"):
            res[f"stats/{key}{i}"] = metrics[key].numpy()
    for key, value in m.module.state_dict().items():
        res[f"stats/state/{key}"] = value.numpy()


def _serve(data, mesh, res, name):
    from vitef_tpu_torch.models import serving as S

    m = build_model(DECODER, device="cpu")
    m.module.load_state_dict({k[4:]: torch.from_numpy(v) for k, v in data.items()
                              if k.startswith("dec/")})
    reqs = json.loads(str(data["requests"]))
    srv = S.DecodeServer(m.module, m.config, n_slots=N_SLOTS, bucket=BUCKET, mesh=mesh)
    out = srv.serve([S.Request(prompt=p, max_new_tokens=n) for p, n in reqs])
    handle = srv.register_prefix(json.loads(str(data["prefix"])))
    (with_prefix,) = srv.serve([S.Request(prompt=reqs[0][0], prefix=handle,
                                          max_new_tokens=6)])
    res[f"{name}/tokens"] = np.array(json.dumps([r.tokens for r in out + [with_prefix]]))


def _train_cli(data_root: Path, res):
    from vitef_tpu_torch.apps.vit import train as train_app
    from vitef_tpu_torch.monitor import orchestrator as orch

    orch.RUN_DIR = data_root / "port" / "runs"
    train_app.train(train_app.TrainingConfig(**TRAIN, dp=2, device="cpu",
                                             data_dir=str(data_root / "cifar10")))
    run = orch.RUN_DIR / TRAIN["log_dir"]
    res["cli/records"] = np.array((run / "metrics" / "raw_0.jsonl").read_text())


def _worker(world: int, rank: int, port: int, out_dir: Path) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=timedelta(seconds=120))
    data = dict(np.load(out_dir / "inputs.npz"))
    res = {}
    for name, dp, tp, fsdp, route in STEP_CASES[world]:
        ckpt_dir = out_dir / f"ckpt-{name}" if name == "fsdp" else None
        _vit_steps(data, build_mesh(dp, tp), world, fsdp, route, res, name, ckpt_dir)
    for dp, tp in SERVE_MESHES[world]:
        _serve(data, build_mesh(dp, tp), res, f"serve{dp}x{tp}")
    if world == 2:
        _stats_steps(data, build_mesh(2, 1), res)
        # the JAX package's sharded checkpoint, read into an FSDP model
        m = build_model(VIT, device="cpu")
        shard_params(m, build_mesh(2, 1), fsdp=True)
        load_model_state(m.module, _load_flat(out_dir / "jax-ckpt", "model"))
        for key, value in _whole(m.module, world).items():
            res[f"from-jax/{key}"] = value
        _train_cli(out_dir, res)
    np.savez(out_dir / f"w{world}_rank{rank}.npz", **res)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


class _Launch:
    """The ranks of one world size, started at once; :meth:`results` waits
    for them (each within WORKER_TIMEOUT) and returns each rank's arrays."""

    def __init__(self, world: int, out_dir: Path):
        self.world, self.out_dir, self._results = world, out_dir, None
        port = str(_free_port())
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, "worker", str(world), str(rank), port, str(out_dir)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(world)]

    def results(self) -> list:
        if self._results is None:
            outs = []
            try:
                for proc in self.procs:
                    outs.append(proc.communicate(timeout=WORKER_TIMEOUT)[0])
            finally:
                self.close()
            for rank, (proc, out) in enumerate(zip(self.procs, outs)):
                assert proc.returncode == 0, f"world={self.world} rank {rank}:\n{out[-6000:]}"
            self._results = [dict(np.load(self.out_dir / f"w{self.world}_rank{r}.npz"))
                             for r in range(self.world)]
        return self._results

    def close(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), Path(sys.argv[5]))
    sys.exit(0)

# The tests' side imports the JAX package too; a rank exits above without it.
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vitef_tpu.data.images import build_train_val_loader as jax_build_train_val_loader  # noqa: E402
from vitef_tpu.data.images.datasets import SyntheticDataset, SyntheticDatasetConfig  # noqa: E402
from vitef_tpu.data.images.loader import Loader as JaxLoader  # noqa: E402
from vitef_tpu.models import build_model as jax_build_model  # noqa: E402
from vitef_tpu.models import serving as jax_serving  # noqa: E402
from vitef_tpu.monitor.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from vitef_tpu.monitor.checkpoint import CheckpointerConfig as JaxCheckpointerConfig  # noqa: E402
from vitef_tpu.monitor.checkpoint import _assemble_from_shards  # noqa: E402
from vitef_tpu.optim import build_optimizer as jax_build_optimizer  # noqa: E402
from vitef_tpu.optim import build_scheduler as jax_build_scheduler  # noqa: E402
from vitef_tpu.optim import trainable_mask as jax_trainable_mask  # noqa: E402
from vitef_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
from vitef_tpu.parallel import init_train_state as jax_init_train_state  # noqa: E402
from vitef_tpu.parallel import make_train_step as jax_make_train_step  # noqa: E402
from vitef_tpu.parallel import mesh as jax_mesh  # noqa: E402
from vitef_tpu.utils.tree import keystr_dotted  # noqa: E402
from vitef_tpu_torch.data.images import loader as port_loader  # noqa: E402
from vitef_tpu_torch.models import from_jax_params  # noqa: E402
from vitef_tpu_torch.models import serving as S  # noqa: E402


def _flat(params) -> dict:
    return {keystr_dotted(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}


def _jax_mesh(dp: int, tp: int):
    return jax_build_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])


def _requests(seed: int):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, DECODER["vocab_size"], size=(int(rng.integers(3, 12)),)).tolist(),
             int(rng.integers(2, 8))) for _ in range(6)]


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one intra-op thread in this process: the plain server is
    hundreds of tiny ops, whose thread-pool hand-offs beside the other test
    workers and this module's ranks cost more than their arithmetic."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """The JAX models the port's ranks and the JAX side share, built once."""
    return {"vit": jax_build_model(VIT, key=jax.random.key(0)),
            "pts": jax_build_model(PATCHTST, key=jax.random.key(1)),
            "dec": jax_build_model(DECODER, key=jax.random.key(2))}


def _write_cifar(root: Path) -> None:
    rng = np.random.default_rng(0)
    base = root / "cifar10" / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for fname in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        labels = rng.integers(0, 10, size=12)
        data = rng.integers(0, 64, size=(12, 3072), dtype=np.uint8)
        data[:, :1024] += (labels[:, None] * 19).astype(np.uint8)
        with open(base / fname, "wb") as f:
            pickle.dump({b"data": data, b"labels": labels.tolist()}, f)


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, models):
    """Every world size's ranks, started together with the module's first
    test, so that they run while the tests in this process do; the inputs,
    the JAX package's sharded checkpoint, the CIFAR pickles and the train
    command line's step-0 checkpoint are written first."""
    out_dir = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    arrays = {}
    for i in range(2):
        arrays[f"x{i}"] = rng.normal(size=(BATCH, 3, 32, 32)).astype(np.float32)
        arrays[f"y{i}"] = rng.integers(0, 10, size=BATCH).astype(np.int64)
        arrays[f"series{i}"] = rng.normal(size=(BATCH, 64)).astype(np.float32)
        arrays[f"target{i}"] = rng.normal(size=(BATCH, 24)).astype(np.float32)
    for tag, jm in models.items():
        for name, t in from_jax_params(jax.tree.map(np.asarray, jm.params)).items():
            arrays[f"{tag}/{name}"] = t.numpy()
    arrays["requests"] = np.array(json.dumps(_requests(8)))
    arrays["prefix"] = np.array(json.dumps(
        rng.integers(0, DECODER["vocab_size"], size=7).tolist()))
    np.savez(out_dir / "inputs.npz", **arrays)

    # The JAX package's sharded layout, from parameters placed by FSDP on a
    # (2, 1) mesh (one process writes every piece).
    params = jax_mesh.shard_params(models["vit"].params, _jax_mesh(2, 1), fsdp=True)
    ckpt = JaxCheckpointer(JaxCheckpointerConfig(path=str(out_dir / "jax-ckpts")),
                           lambda: {"model": params, "optim": None,
                                    "training": {"step": 0}}, sharded=True)
    ckpt._save_sharded(out_dir / "jax-ckpt")
    ckpt.process.result()

    _write_cifar(out_dir)
    jm = jax_build_model({"implementation": "vit", **TINY_VIT, "finetuning": True,
                          "n_classes": 10, "compute_dtype": "float32"},
                         key=jax.random.key(3))
    step0 = out_dir / "port" / "runs" / TRAIN["log_dir"] / "checkpoints" / f"{0:010d}"
    step0.mkdir(parents=True)
    np.savez(step0 / "model.npz", **_flat(jm.params))
    (step0 / "training.json").write_text(json.dumps({"step": 0, "acc_step": 0}))
    shutil.copytree(step0, out_dir / "step0")

    launches = {world: _Launch(world, out_dir) for world in (2, 4)}
    yield launches, arrays, out_dir
    for launch in launches.values():
        launch.close()


# ---------------------------------------------------------------------------
# The mesh and the placement, in this process
# ---------------------------------------------------------------------------


def test_build_mesh_shapes_and_its_assert():
    """One process: dp = -1 is world // tp; a dp · tp that is not the world
    size raises AssertionError, as the JAX package's assert does."""
    mesh = build_mesh()
    assert (mesh.shape, mesh.size, mesh.dp_rank, mesh.tp_rank) == ({"dp": 1, "tp": 1}, 1, 0, 0)
    for dp, tp in ((2, 1), (1, 2), (-1, 2)):
        with pytest.raises(AssertionError):
            build_mesh(dp, tp)
        with pytest.raises(AssertionError):
            jax_build_mesh(dp, tp, devices=jax.devices()[:1])


@pytest.mark.parametrize("n_processes", [1, 4])
def test_rank_helpers_and_config_from_the_launch_environment(monkeypatch, n_processes):
    """``is_distributed_job`` and ``get_local_rank`` read the launch's
    environment as the JAX package's helpers do; ``computing_config_from_env``
    takes the process fields from it only in a multi-process launch, and
    ``ComputingConfig`` has the JAX package's fields and defaults."""
    from vitef_tpu_torch.parallel import ComputingConfig, computing_config_from_env
    from vitef_tpu_torch.parallel.mesh import get_local_rank, is_distributed_job

    for key, value in (("VITEF_NUM_PROCESSES", n_processes), ("VITEF_LOCAL_RANK", 3),
                       ("VITEF_PROCESS_ID", 2), ("VITEF_COORDINATOR_ADDRESS", "localhost:1")):
        monkeypatch.setenv(key, str(value))
    # the JAX helpers are cached per process: their unwrapped bodies read it now
    assert is_distributed_job() == jax_mesh.is_distributed_job.__wrapped__() == (
        n_processes > 1)
    assert get_local_rank() == jax_mesh.get_local_rank.__wrapped__() == 3
    config = computing_config_from_env(dp=2, tp=2, fsdp=True)
    launch = ("localhost:1", 4, 2) if n_processes > 1 else (None, 1, 0)
    assert (config.coordinator_address, config.num_processes, config.process_id) == launch
    assert (config.dp, config.tp, config.fsdp) == (2, 2, True)
    import dataclasses

    assert ({f.name: f.default for f in dataclasses.fields(ComputingConfig)}
            == {f.name: f.default for f in dataclasses.fields(jax_mesh.ComputingConfig)})


LLAMA_GQA = {"implementation": "llama", "model_name": "tiny", "pretrained": False,
             "seq_len": 32}
# a small MoE decoder with biased experts, so that fc1's (E, f1) bias takes
# the expert-axis rule too
MOE = {"implementation": "transformer", "vocab_size": 32, "emb_type": "dict", "emb_dim": 16,
       "n_heads": 2, "n_layers": 2, "seq_len": 8, "ffn_dim": 16, "ffn_bias": True,
       "causal": True, "output_type": "sequence_to_sequence", "cls_token": False,
       "n_experts": 8, "moe_top_k": 2}


@functools.cache
def _jax_model(name: str):
    return jax_build_model({"vit": VIT, "llama-gqa": LLAMA_GQA, "moe": MOE}[name],
                           key=jax.random.key(0))


@pytest.mark.parametrize("dp,tp,fsdp", [(8, 1, False), (4, 2, False), (4, 2, True),
                                        (2, 1, True)])
@pytest.mark.parametrize("model", ["vit", "llama-gqa", "moe"])
def test_param_shardings_are_jax_specs(model, dp, tp, fsdp):
    """Every parameter's placement, mapped to the JAX layout, is the spec of
    the JAX package's ``param_shardings`` on a mesh of the same shape (the
    JAX models built once); an MoE model's expert stacks (and fc1's bias)
    split their expert axis over 'tp'."""
    jm = _jax_model(model)
    want = {keystr_dotted(p): tuple(s.spec) for p, s in jax.tree_util.tree_leaves_with_path(
        jax_mesh.param_shardings(jm.params, _jax_mesh(dp, tp), fsdp))}
    shapes = {name: t.shape for name, t in
              from_jax_params(jax.tree.map(np.asarray, jm.params)).items()}
    got = param_shardings(shapes, {"dp": dp, "tp": tp}, fsdp)
    assert sorted(got) == sorted(want)
    from vitef_tpu_torch.models.convert import _transposed

    for name, placement in got.items():
        spec = tuple("tp" if i == placement.tp else "dp" if i == placement.dp else None
                     for i in range(len(shapes[name])))
        if _transposed(name, len(shapes[name]), shapes):
            spec = spec[::-1]
        assert spec == want[name] + (None,) * (len(spec) - len(want[name])), name


def test_mesh_train_step_refuses_a_tp_mesh():
    """The data-parallel step raises for tp > 1 at build, as the JAX step
    asserts (:222-226)."""
    tp_mesh = type("Shape", (), {"shape": {"dp": 1, "tp": 2}})()
    with pytest.raises(AssertionError):
        make_train_step(mesh=tp_mesh)
    with pytest.raises(AssertionError):
        jax_make_train_step(lambda *a, **k: None, None, mesh=_jax_mesh(1, 2))


@pytest.mark.parametrize("count", [2, 3])
def test_loader_shards_are_jax_epoch_orders(count):
    """Each shard's order is the JAX loader's ``_epoch_order`` for the same
    seed, over two epochs; the shards are disjoint and of equal length, and
    an epoch of no batch raises."""
    ds = SyntheticDataset(SyntheticDatasetConfig(n_samples=23, image_size=8))
    orders = []
    for index in range(count):
        port = port_loader.Loader(ds, device="cpu", batch_size=2, size=8, mode="train",
                                  seed=5, shard_index=index, shard_count=count)
        ref = JaxLoader(ds, batch_size=2, size=8, mode="train", seed=5, shard_index=index,
                        shard_count=count)
        assert len(port) == len(ref) == (23 // count) // 2
        for _ in range(2):
            mine = port._epoch_order()
            np.testing.assert_array_equal(mine, ref._epoch_order())
        orders.append(mine)
    assert len({len(o) for o in orders}) == 1
    assert len(np.unique(np.concatenate(orders))) == sum(len(o) for o in orders)
    with pytest.raises(ValueError, match="0 batches"):
        port_loader.Loader(ds, device="cpu", batch_size=12, size=8, mode="train",
                           shard_index=0, shard_count=count)


# ---------------------------------------------------------------------------
# Against the ranks
# ---------------------------------------------------------------------------


def _jax_vit_steps(models, arrays, dp, tp, fsdp, route):
    jm = models["vit"]
    mesh = _jax_mesh(dp, tp)
    comps = FREEZE if fsdp else None
    tx, _ = jax_build_optimizer(ADAMW, params=jm.params, components=comps, grad_clip=CLIP)
    trainable = jax_trainable_mask(jm.params, comps or [])
    if route == "mesh":
        params = jm.params
        step = jax_make_train_step(jm.apply, tx, grad_acc_steps=ACC, trainable=trainable,
                                   mesh=mesh, donate=False)
    else:
        params = jax_mesh.shard_params(jm.params, mesh, fsdp=fsdp)
        step = jax_make_train_step(jm.apply, tx, grad_acc_steps=ACC, trainable=trainable,
                                   donate=False)
    state = jax_init_train_state(params, tx)
    metrics = []
    for i in range(2):
        batch = jax_mesh.shard_batch((jnp.asarray(arrays[f"x{i}"]),
                                      jnp.asarray(arrays[f"y{i}"], jnp.int32)), mesh)
        state, m = step(state, batch, jax.random.key(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _flat(state.params)


@pytest.mark.parametrize("world,case", [(w, c) for w, cases in STEP_CASES.items()
                                        for c in cases], ids=lambda v: str(v))
def test_train_steps_match_jax(ranks, models, world, case):
    """Two steps of the tiny ViT (2 microbatches a step, AdamW, the global
    clip): each step's loss and grad_norm on every rank, and every parameter
    after them, against the JAX step on a mesh of the same shape."""
    launches, arrays, _ = ranks
    name, dp, tp, fsdp, route = case
    want, want_params = _jax_vit_steps(models, arrays, dp, tp, fsdp, route)
    for res in launches[world].results():
        for i in range(2):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(res[f"{name}/{key}{i}"], want[i][key], rtol=RTOL,
                                           err_msg=f"{name} step {i} {key}")
        for key, value in want_params.items():
            np.testing.assert_allclose(res[f"{name}/param/{key}"], value, atol=ATOL,
                                       rtol=RTOL, err_msg=f"{name} {key}")


def test_running_stats_averaged_over_dp(ranks, models):
    """PatchTST at dp = 2 (``update_stats``, 2 microbatches, SGD): the loss,
    the grad norm and the running statistics, averaged over dp as the JAX
    shard_map step does (:240-241), on both ranks."""
    launches, arrays, _ = ranks
    jm = models["pts"]
    tx, _ = jax_build_optimizer(SGD, params=jm.params)
    step = jax_make_train_step(jm.apply, tx, grad_acc_steps=ACC, update_stats=True,
                               loss_fn=lambda p, y: jnp.mean(jnp.square(p - y)),
                               mesh=_jax_mesh(2, 1), donate=False)
    state = jax_init_train_state(jm.params, tx)
    want = []
    for i in range(2):
        state, m = step(state, (jnp.asarray(arrays[f"series{i}"]),
                                jnp.asarray(arrays[f"target{i}"])), jax.random.key(i))
        want.append({k: float(v) for k, v in m.items()})
    ref = from_jax_params(jax.tree.map(np.asarray, state.params))
    for res in launches[2].results():
        for i in range(2):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(res[f"stats/{key}{i}"], want[i][key], rtol=RTOL)
        stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
        assert len(stats) == 8
        for key in stats:
            np.testing.assert_allclose(res[f"stats/state/{key}"], ref[key].numpy(),
                                       atol=ATOL, rtol=RTOL, err_msg=key)


def test_sharded_checkpoint_both_ways_and_resume(ranks, models):
    """The FSDP ranks' sharded checkpoint: ``model.shard<rank>.npz`` from both
    ranks and ``index.json``, which the JAX package's reader assembles into
    the ranks' parameters; a fresh FSDP model resumed from it takes the next
    step bit for bit as the saved one. And the JAX package's sharded
    checkpoint, read by the port into an FSDP model, is the JAX parameters."""
    launches, _, out_dir = ranks
    results = launches[2].results()
    ckpt = out_dir / "ckpt-fsdp" / f"{2:010d}"
    index = json.loads((ckpt / "index.json").read_text())
    assert index["n_processes"] == 2
    assert sorted(p.name for p in ckpt.glob("*.shard*.npz")) == [
        "model.shard0.npz", "model.shard1.npz", "optim.shard0.npz", "optim.shard1.npz"]
    for shard in ckpt.glob("model.shard*.npz"):
        with np.load(shard) as z:
            assert z.files and all("@" in k for k in z.files)
    read = _assemble_from_shards(ckpt, "model")
    for res in results:
        for key, value in read.items():
            np.testing.assert_array_equal(value, res[f"fsdp/param/{key}"], err_msg=key)
        for key in ("loss", "grad_norm", "param"):
            np.testing.assert_array_equal(res[f"fsdp/resumed/{key}"], res[f"fsdp/saved/{key}"])
    want = _flat(models["vit"].params)
    for res in results:
        for key, value in want.items():
            np.testing.assert_array_equal(res[f"from-jax/{key}"], value, err_msg=key)


def _jax_cli_steps(out_dir: Path):
    """The JAX data-parallel step (``make_train_step(mesh=)`` over 2 devices)
    on the two loader shards the ranks take, from the same step-0 weights,
    optimizer and schedule as the train command line."""
    from vitef_tpu.config import set_seed

    set_seed(TRAIN["seed"])  # the train/val split, as the apps' Utility draws it
    loaders = []
    for index in range(2):
        np.random.seed(TRAIN["seed"])
        loader, _, n_classes = jax_build_train_val_loader(
            {"dataset_name": "cifar10", "batch_size": TRAIN["batch_size"],
             "val_batch_size": 16, "size": 32, "num_workers": 0, "compute_dtype": "float32",
             "seed": TRAIN["seed"], "save_dir": str(out_dir / "cifar10"),
             "shard_index": index, "shard_count": 2},
            train_size=0.8, return_n_classes=True)
        loaders.append(iter(loader))
    jm = jax_build_model({"implementation": "vit", **TINY_VIT, "finetuning": True,
                          "n_classes": 10, "compute_dtype": "float32"}, key=jax.random.key(3))
    with np.load(out_dir / "step0" / "model.npz") as z:
        init = {k: z[k] for k in z.files}
    from vitef_tpu.monitor.checkpoint import _unflatten_like

    params = jax.tree.map(jnp.asarray, _unflatten_like(jm.params, init))
    schedule = jax_build_scheduler({"scheduler": "cosine", "warmup": 1, "min_factor": 0},
                                   n_steps=TRAIN["n_steps"])
    tx, _ = jax_build_optimizer({"optimizer": "sgd", "lr": TRAIN["lr"], "momentum": 0.9,
                                 "weight_decay": 0.0}, schedule=schedule, params=params,
                                components=FREEZE, grad_clip=TRAIN["grad_clip"])
    step = jax_make_train_step(jm.apply, tx, grad_acc_steps=2, schedule=schedule,
                               base_lr=TRAIN["lr"],
                               trainable=jax_trainable_mask(params, FREEZE),
                               mesh=_jax_mesh(2, 1), donate=False)
    state = jax_init_train_state(params, tx)
    out = []
    for i in range(TRAIN["n_steps"]):
        x0, y0 = next(loaders[0])
        x1, y1 = next(loaders[1])
        state, m = step(state, (jnp.concatenate([x0, x1]), jnp.concatenate([y0, y1])),
                        jax.random.key(i))
        out.append({k: float(v) for k, v in m.items()})
    return out


def test_two_rank_train_command_line_matches_jax_dp(ranks):
    """``train`` on two gloo ranks at dp = 2 (each rank's loader shard of 4
    rows a step, 2 x 2 microbatches): the master's logged loss, grad_norm
    and lr equal the JAX data-parallel step's on the same two shards; the
    run dir is the JAX package's, with the master's records only."""
    launches, _, out_dir = ranks
    (res, *_) = launches[2].results()
    records = [json.loads(line) for line in str(res["cli/records"]).splitlines()]
    logged = [r for r in records if "loss" in r]
    assert [r["step"] for r in logged] == [1, 2, 3]
    want = _jax_cli_steps(out_dir)
    for got, ref in zip(logged, want):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=RTOL)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=RTOL)
        assert got["lr"] == pytest.approx(ref["lr"], rel=1e-6)
    assert any("eval_acc" in r for r in records)
    run = out_dir / "port" / "runs" / TRAIN["log_dir"]
    assert sorted(p.name for p in (run / "metrics").iterdir()) == ["info_model.jsonl",
                                                                   "raw_0.jsonl"]
    assert json.loads((run / "config.json").read_text())["dp"] == 2
    ckpt = run / "checkpoints" / f"{3:010d}"  # the best (only) evaluation's
    assert (ckpt / "index.json").exists() and (ckpt / "model.shard1.npz").exists()


@pytest.mark.parametrize("dp,tp", [m for ms in SERVE_MESHES.values() for m in ms],
                         ids=lambda v: str(v))
def test_mesh_server_matches_one_rank_and_jax(ranks, models, dp, tp):
    """``DecodeServer(mesh=)``: six requests through 4 slots (slots reused),
    then one under a registered prefix; every rank's greedy tokens equal the
    one-rank server's and the JAX server's on a mesh of the same shape."""
    launches, arrays, _ = ranks
    reqs = json.loads(str(arrays["requests"]))
    prefix = json.loads(str(arrays["prefix"]))
    m = build_model(DECODER, device="cpu")
    m.module.load_state_dict({k[4:]: torch.from_numpy(v) for k, v in arrays.items()
                              if k.startswith("dec/")})
    plain = S.DecodeServer(m.module, m.config, n_slots=N_SLOTS, bucket=BUCKET)
    want = [r.tokens for r in plain.serve([S.Request(prompt=p, max_new_tokens=n)
                                           for p, n in reqs])]
    handle = plain.register_prefix(prefix)
    (req,) = plain.serve([S.Request(prompt=reqs[0][0], prefix=handle, max_new_tokens=6)])
    want.append(req.tokens)
    jm = models["dec"]
    srv = jax_serving.DecodeServer(jm.params, jm.config, n_slots=N_SLOTS, bucket=BUCKET,
                                   mesh=_jax_mesh(dp, tp))
    jax_tokens = [r.tokens for r in srv.serve([jax_serving.Request(prompt=p, max_new_tokens=n)
                                               for p, n in reqs])]
    handle = srv.register_prefix(prefix)
    (req,) = srv.serve([jax_serving.Request(prompt=reqs[0][0], prefix=handle,
                                            max_new_tokens=6)])
    jax_tokens.append(req.tokens)
    assert [list(map(int, t)) for t in jax_tokens] == want
    world = dp * tp
    for res in launches[world].results():
        assert json.loads(str(res[f"serve{dp}x{tp}/tokens"])) == want
