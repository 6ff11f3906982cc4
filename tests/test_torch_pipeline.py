"""The port's pipeline parallelism vs the JAX package's, on the CPU.

``make_pipeline_train_step`` on gloo ranks against the JAX
``make_pipeline_train_step`` over the test suite's 8-device CPU mesh
(``tests/conftest.py``), two SGD steps with the global clip in the step:
(dp, pp, n_micro, schedule) = (1, 2, 4, gpipe), (1, 2, 4, 1f1b),
(2, 2, 2, 1f1b) and (1, 4, 4, gpipe) on ``tests/test_pipeline.py``'s tiny
ViT (4 layers); the tied-head causal decoder at pp = 2 under both
schedules; the component freeze (the embedding and attention) at pp = 2
under both schedules; remat (equal losses); the
schedules' metadata; 1F1B's saved stage inputs at n_micro 4 and 16; stage
locality (each rank's parameters and optimizer state); and a pipelined run
written by the port's ``Checkpointer``, read by the JAX
``load_checkpoint_params``. float32 throughout, at 1e-4 / 1e-4.

The ranks are this file run as ``python tests/test_torch_pipeline.py worker
<world> <rank> <port> <dir>``: one launch per world size (2 and 4), started
with the module's first test, each rank running every case of its world and
writing its results as ``.npz``; a rank exits before the file's JAX imports.
"""

import json
import os
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

from vitef_tpu_torch.models import build_model
from vitef_tpu_torch.models.convert import to_jax_params
from vitef_tpu_torch.monitor.checkpoint import (Checkpointer, CheckpointerConfig, model_pieces,
                                                optimizer_pieces)
from vitef_tpu_torch.optim import build_optimizer
from vitef_tpu_torch.parallel import (build_pipeline_mesh, init_train_state,
                                      make_pipeline_train_step, place_stages, shard_batch,
                                      stack_block_params, unstack_block_params)

REPO = Path(__file__).resolve().parents[1]

# tests/test_pipeline.py's tiny_cfg, 4 layers.
VIT = {"implementation": "transformer", "patch_type": "computer_vision",
       "image_dim": (3, 16, 16), "image_patch": "hybrid", "patch_size": 8,
       "emb_type": "linear", "emb_dim": 16, "n_heads": 2, "n_layers": 4, "attn_bias": True,
       "ffn_bias": True, "ffn_dim": 32, "norm": "layer", "norm_bias": True,
       "norm_eps": 1e-12, "pre_norm": True, "cls_token": True,
       "output_type": "classification", "n_classes": 3, "weight_tying": False,
       "attn_impl": "xla", "norm_impl": "xla", "compute_dtype": "float32"}
# tests/test_pipeline.py's GPT-2-style decoder with the tied head.
DECODER = {"implementation": "transformer", "vocab_size": 32, "emb_type": "dict",
           "emb_dim": 16, "n_heads": 2, "n_layers": 4, "seq_len": 8, "causal": True,
           "pre_norm": True, "weight_tying": True, "output_type": "sequence_to_sequence",
           "attn_bias": True, "ffn_bias": True, "norm_bias": True, "cls_token": False,
           "pos_emb": True, "attn_impl": "xla", "norm_impl": "xla",
           "compute_dtype": "float32"}
SGD = {"optimizer": "sgd", "lr": 0.05, "momentum": 0.9}
CLIP = 1.0
# a frozen embedding leaves stage 0's output without a gradient
FREEZE = ("emb", "mha", "attn_norm")
STEPS = 2
# (case, model, dp, pp, n_micro, schedule, rows, options) per world size;
# options: "freeze", "remat", "ckpt".
CASES = {2: [("vit-gpipe", "vit", 1, 2, 4, "gpipe", 8, ("ckpt",)),
             ("vit-1f1b", "vit", 1, 2, 4, "1f1b", 8, ()),
             ("vit-gpipe-remat", "vit", 1, 2, 4, "gpipe", 8, ("remat",)),
             ("vit-1f1b-remat", "vit", 1, 2, 4, "1f1b", 8, ("remat",)),
             ("dec-gpipe", "dec", 1, 2, 2, "gpipe", 8, ()),
             ("dec-1f1b", "dec", 1, 2, 2, "1f1b", 8, ()),
             ("freeze", "vit", 1, 2, 2, "1f1b", 8, ("freeze",)),
             ("freeze-gpipe", "vit", 1, 2, 2, "gpipe", 8, ("freeze",))],
         4: [("vit-gpipe-pp4", "vit", 1, 4, 4, "gpipe", 8, ()),
             ("vit-1f1b-dp2", "vit", 2, 2, 2, "1f1b", 8, ()),
             ("vit-1f1b-pp4", "vit", 1, 4, 4, "1f1b", 8, ()),
             ("vit-1f1b-pp4-16", "vit", 1, 4, 16, "1f1b", 32, ())]}
# the cases held to the JAX pipelined step, by the JAX step they share
# (model, dp, pp, n_micro, schedule, rows, frozen components)
JAX_STEPS = {"vit-gpipe": ("vit", 1, 2, 4, "gpipe", 8, ()),
             "vit-1f1b": ("vit", 1, 2, 4, "1f1b", 8, ()),
             "vit-1f1b-dp2": ("vit", 2, 2, 2, "1f1b", 8, ()),
             "vit-gpipe-pp4": ("vit", 1, 4, 4, "gpipe", 8, ()),
             "dec-gpipe": ("dec", 1, 2, 2, "gpipe", 8, ()),
             "dec-1f1b": ("dec", 1, 2, 2, "gpipe", 8, ()),
             "freeze": ("vit", 1, 2, 2, "1f1b", 8, FREEZE),
             "freeze-gpipe": ("vit", 1, 2, 2, "1f1b", 8, FREEZE)}
WORKER_TIMEOUT = 300
ATOL, RTOL = 1e-4, 1e-4


# ---------------------------------------------------------------------------
# The ranks: this file run as a worker
# ---------------------------------------------------------------------------


def _batch(data, model: str, rows: int):
    return (torch.from_numpy(data[f"{model}/x"][:rows]),
            torch.from_numpy(data[f"{model}/y"][:rows]))


def _run_case(data, case, res, out_dir: Path) -> None:
    name, model, dp, pp, n_micro, schedule, rows, options = case
    config = VIT if model == "vit" else DECODER
    m = build_model(config, device="cpu")
    prefix = f"{model}/param/"
    m.module.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in data.items()
                              if k.startswith(prefix)})
    mesh = build_pipeline_mesh(pp, dp)
    place_stages(m, mesh)
    opt, sched = build_optimizer(SGD, m.module,
                                 components=list(FREEZE) if "freeze" in options else None)
    state = init_train_state(m, opt, sched)
    step = make_pipeline_train_step(m.config, mesh, n_micro=n_micro, grad_clip=CLIP, pp_schedule=schedule,
                                    remat="remat" in options)
    batch = shard_batch(_batch(data, model, rows), mesh)
    for i in range(STEPS):
        metrics = step(state, batch)
        for key in ("loss", "grad_norm"):
            res[f"{name}/{key}{i}"] = metrics[key].detach().numpy()
    res[f"{name}/meta"] = np.array(json.dumps(
        {"n_ticks": step.n_ticks, "n_slots": step.n_slots, "saved": step.saved_inputs,
         "params": sorted(n for n, _ in m.module.named_parameters()),
         "optim": sorted(f"{n}:{tuple(v.shape)}" for n, p in m.module.named_parameters()
                         for v in opt.state.get(p, {}).values() if v.dim())}))
    for key, value in to_jax_params(m.module.state_dict()).items():
        res[f"{name}/param/{key}"] = value
    if "ckpt" in options:
        config = CheckpointerConfig(path=str(out_dir / "ckpt"))
        ckpt = Checkpointer(config, lambda: {"model": model_pieces(m.module),
                                             "optim": optimizer_pieces(opt, m.module),
                                             "training": {"step": STEPS, "acc_step": 0}})
        ckpt.step = STEPS
        ckpt.update()
        ckpt.__exit__(None, None, None)
        torch.distributed.barrier()


def _worker(world: int, rank: int, port: int, out_dir: Path) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=timedelta(seconds=120))
    data = dict(np.load(out_dir / "inputs.npz"))
    res = {}
    for case in CASES[world]:
        _run_case(data, case, res, out_dir)
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
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from vitef_tpu.models import build_model as jax_build_model  # noqa: E402
from vitef_tpu.models.transformer import apply_transformer  # noqa: E402
from vitef_tpu.monitor.checkpoint import load_checkpoint_params  # noqa: E402
from vitef_tpu.optim import build_optimizer as jax_build_optimizer  # noqa: E402
from vitef_tpu.optim import trainable_mask as jax_trainable_mask  # noqa: E402
from vitef_tpu.parallel import build_pipeline_mesh as jax_build_pipeline_mesh  # noqa: E402
from vitef_tpu.parallel import init_train_state as jax_init_train_state  # noqa: E402
from vitef_tpu.parallel import make_pipeline_train_step as jax_make_pipeline_step  # noqa: E402
from vitef_tpu.parallel import pipeline as jax_pipeline  # noqa: E402
from vitef_tpu.utils.tree import keystr_dotted  # noqa: E402
from vitef_tpu_torch.models import from_jax_params  # noqa: E402


def _flat(params) -> dict:
    return {keystr_dotted(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}


@pytest.fixture(scope="module")
def models():
    """The JAX models the port's ranks and the JAX side share, built once."""
    return {"vit": jax_build_model(VIT, key=jax.random.key(1)),
            "dec": jax_build_model(DECODER, key=jax.random.key(4))}


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, models):
    """Every world size's ranks, started together with the module's first
    test, so that they run while the JAX steps in this process do."""
    out_dir = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(3)
    arrays = {"vit/x": rng.normal(size=(32, 3, 16, 16)).astype(np.float32),
              "vit/y": rng.integers(0, 3, size=32).astype(np.int64)}
    tokens = rng.integers(0, DECODER["vocab_size"], size=(8, 8)).astype(np.int64)
    arrays["dec/x"], arrays["dec/y"] = tokens, np.roll(tokens, -1, axis=1)
    for tag, jm in models.items():
        for name, t in from_jax_params(jax.tree.map(np.asarray, jm.params)).items():
            arrays[f"{tag}/param/{name}"] = t.numpy()
    np.savez(out_dir / "inputs.npz", **arrays)
    launches = {world: _Launch(world, out_dir) for world in (2, 4)}
    yield launches, arrays, out_dir
    for launch in launches.values():
        launch.close()


def _lm_loss(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(
        logits.astype(jnp.float32), labels).mean()


@pytest.fixture(scope="module")
def jax_steps(models, ranks):
    """Two steps of the JAX pipelined step, by (model, dp, pp, n_micro,
    schedule, rows, frozen components), each run once: each step's metrics and the
    parameters after them (flat, per block)."""
    arrays = ranks[1]

    @functools.cache
    def run(key):
        model, dp, pp, n_micro, schedule, rows, freeze = key
        jm = models[model]
        mesh = jax_build_pipeline_mesh(pp=pp, dp=dp, devices=jax.devices()[:dp * pp])
        stacked = jax_pipeline.stack_block_params(jm.params)
        comps = list(freeze) if freeze else None
        tx, _ = jax_build_optimizer(SGD, params=stacked if freeze else None, components=comps)
        step = jax_make_pipeline_step(
            jm.config, tx, mesh, n_micro=n_micro, grad_clip=CLIP, donate=False,
            pp_schedule=schedule,
            loss_fn=_lm_loss if model == "dec" else jax_pipeline.cross_entropy_loss,
            trainable=jax_trainable_mask(stacked, comps) if freeze else None)
        state = jax_init_train_state(stacked, tx)
        state = jax.device_put(state, jax_pipeline.pipeline_state_shardings(state, mesh))
        batch = (jnp.asarray(arrays[f"{model}/x"][:rows]),
                 jnp.asarray(arrays[f"{model}/y"][:rows], jnp.int32))
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, _flat(jax_pipeline.unstack_block_params(jax.device_get(state.params)))

    return run


def _case(name: str):
    for world, cases in CASES.items():
        for case in cases:
            if case[0] == name:
                return world, case
    raise KeyError(name)


def _check_against(results, name: str, want, want_params, frozen=()):
    covered = set()
    for res in results:
        for i in range(STEPS):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(res[f"{name}/{key}{i}"], want[i][key], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{name} step {i} {key}")
        prefix = f"{name}/param/"
        for key in (k for k in res if k.startswith(prefix)):
            pname = key[len(prefix):]
            np.testing.assert_allclose(res[key], want_params[pname], atol=ATOL, rtol=RTOL,
                                       err_msg=f"{name} {pname}")
            covered.add(pname)
    assert covered == set(want_params), sorted(set(want_params) - covered)


@pytest.mark.parametrize("name", list(JAX_STEPS))
def test_pipeline_step_matches_jax(ranks, jax_steps, name):
    """Two steps through the port's pipelined step on the ranks: each step's
    loss and grad norm on every rank, and every parameter after them (each
    rank's stage and the whole embedding and head), against the JAX
    pipelined step on a mesh of the same shape. The tied decoder's 1F1B run
    is held to the JAX GPipe step (the same function), and the freeze's
    GPipe run to the JAX 1F1B step."""
    launches = ranks[0]
    world, _ = _case(name)
    want, want_params = jax_steps(JAX_STEPS[name])
    _check_against(launches[world].results(), name, want, want_params)


def _check_frozen_at_init(ranks, name: str) -> None:
    launches, arrays, _ = ranks
    init = to_jax_params({k[len("vit/param/"):]: torch.from_numpy(v)
                          for k, v in arrays.items() if k.startswith("vit/param/")})
    frozen = [k for k in init if k.startswith("embedding.") or ".attn." in k
              or ".attn_norm." in k]
    seen = set()
    for res in launches[2].results():
        for key in frozen:
            if f"{name}/param/{key}" in res:
                np.testing.assert_array_equal(res[f"{name}/param/{key}"], init[key])
                seen.add(key)
    assert frozen and seen == set(frozen)


def test_freeze_leaves_frozen_parameters_at_init(ranks):
    """The component freeze under 1F1B: the frozen parameters are the
    initial ones, bit for bit, on every rank that holds them."""
    _check_frozen_at_init(ranks, "freeze")


def test_freeze_under_gpipe_leaves_frozen_parameters_at_init(ranks):
    """The same freeze under GPipe, whose stage 0 runs its blocks on an
    embedding output that needs no gradient."""
    _check_frozen_at_init(ranks, "freeze-gpipe")


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_remat_gives_equal_losses(ranks, schedule):
    """remat recomputes the same forward: the losses and grad norms of both
    steps equal those without it, and so do the parameters."""
    for res in ranks[0][2].results():
        for i in range(STEPS):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(res[f"vit-{schedule}-remat/{key}{i}"],
                                           res[f"vit-{schedule}/{key}{i}"], rtol=1e-6)


@pytest.mark.parametrize("name", ["vit-gpipe", "vit-1f1b", "vit-gpipe-pp4",
                                  "vit-1f1b-dp2", "vit-1f1b-pp4", "vit-1f1b-pp4-16"])
def test_schedule_metadata_and_saved_inputs(ranks, models, name):
    """``n_ticks`` and ``n_slots`` equal the JAX step's; 1F1B holds at most
    2·pp − 1 saved stage inputs at once on every rank, at n_micro 4 and 16
    alike (stage s holds 2(pp − s) − 1 of them at the peak)."""
    world, (_, _, dp, pp, n_micro, schedule, _, _) = _case(name)
    jax_step = jax_make_pipeline_step(
        models["vit"].config, optax.sgd(0.1),
        jax_build_pipeline_mesh(pp=pp, dp=dp, devices=jax.devices()[:dp * pp]),
        n_micro=n_micro, pp_schedule=schedule)
    results = ranks[0][world].results()
    for rank, res in enumerate(results):
        meta = json.loads(str(res[f"{name}/meta"]))
        assert (meta["n_ticks"], meta["n_slots"]) == (jax_step.n_ticks, jax_step.n_slots)
        if schedule == "1f1b":
            stage = rank % pp
            assert meta["saved"] <= 2 * pp - 1
            assert meta["saved"] == min(2 * (pp - stage) - 1, n_micro)
        else:
            assert meta["saved"] == 0


@pytest.mark.parametrize("world,name", [(2, "vit-gpipe"), (4, "vit-gpipe-pp4"),
                                        (4, "vit-1f1b-dp2")])
def test_stage_locality(ranks, world, name):
    """Each rank holds its stage's blocks, the whole embedding and the whole
    head, and optimizer state for exactly those parameters."""
    _, (_, _, dp, pp, _, _, _, _) = _case(name)
    n_layers = VIT["n_layers"]
    for rank, res in enumerate(ranks[0][world].results()):
        meta = json.loads(str(res[f"{name}/meta"]))
        stage = rank % pp
        blocks = {int(p.split(".")[1]) for p in meta["params"] if p.startswith("blocks.")}
        per = n_layers // pp
        assert blocks == set(range(stage * per, (stage + 1) * per))
        assert any(p.startswith("embedding.") for p in meta["params"])
        assert any(p.startswith("output.") for p in meta["params"])
        assert {s.split(":")[0] for s in meta["optim"]} == set(meta["params"])


def test_pipelined_checkpoint_loads_in_jax(ranks, models):
    """The ranks' pipelined model after two GPipe steps, written through the
    port's Checkpointer (a shard a rank, each block by its stage): the JAX
    ``load_checkpoint_params`` reads it into the JAX model, whose forward
    equals the JAX forward of the ranks' parameters."""
    launches, arrays, out_dir = ranks
    results = launches[2].results()
    ckpt = out_dir / "ckpt" / f"{STEPS:010d}"
    assert sorted(p.name for p in ckpt.glob("model.shard*.npz")) == ["model.shard0.npz",
                                                                     "model.shard1.npz"]
    jm = models["vit"]
    restored = load_checkpoint_params(ckpt, jm.params)
    got = _flat(restored)
    trained = {}
    for res in results:
        trained.update({k[len("vit-gpipe/param/"):]: v for k, v in res.items()
                        if k.startswith("vit-gpipe/param/")})
    assert sorted(got) == sorted(trained)
    for key, value in trained.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    x = jnp.asarray(arrays["vit/x"][:4])
    params = jax.tree.map(jnp.asarray, restored)
    want = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jm.params),
                                        [jnp.asarray(trained[keystr_dotted(p)]) for p, _ in
                                         jax.tree_util.tree_leaves_with_path(jm.params)])
    np.testing.assert_allclose(np.asarray(apply_transformer(params, jm.config, x)),
                               np.asarray(apply_transformer(want, jm.config, x)),
                               atol=1e-6, rtol=1e-6)


def test_stack_unstack_match_jax(models):
    """``stack_block_params``/``unstack_block_params`` on flat dicts in the
    JAX layout: the JAX stacked leaves, and a round trip bit for bit."""
    flat = _flat(models["vit"].params)
    stacked = stack_block_params(flat)
    want = _flat(jax_pipeline.stack_block_params(models["vit"].params))
    assert sorted(stacked) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(stacked[key], value, err_msg=key)
    back = unstack_block_params(stacked)
    assert sorted(back) == sorted(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_pipeline_asserts_as_jax():
    """One process: the mesh's size, a mesh without 'pp', an unknown
    schedule, pp not dividing n_layers and batch norm raise AssertionError,
    as the JAX package asserts."""
    from vitef_tpu_torch.models.transformer import TransformerConfig
    from vitef_tpu_torch.parallel import build_mesh

    with pytest.raises(AssertionError):
        build_pipeline_mesh(2)
    mesh = build_pipeline_mesh(1)
    cfg = build_model(VIT, device="meta").config
    with pytest.raises(AssertionError, match="'pp'"):
        make_pipeline_train_step(cfg, build_mesh(), n_micro=2)
    with pytest.raises(AssertionError, match="schedule"):
        make_pipeline_train_step(cfg, mesh, n_micro=2, pp_schedule="interleaved")
    three = type(mesh)(dp=1, pp=3)
    with pytest.raises(AssertionError, match="divisible"):
        make_pipeline_train_step(cfg, three, n_micro=2)
    bn = TransformerConfig(**{**{k: v for k, v in VIT.items() if k != "implementation"},
                              "norm": "batch"})
    with pytest.raises(AssertionError, match="batch"):
        make_pipeline_train_step(bn, mesh, n_micro=2)
    m = build_model(VIT, device="cpu")
    place_stages(m, mesh)
    assert type(m.module.blocks[0]).__name__ == "Block"
