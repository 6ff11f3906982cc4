"""FSDP by unit (``vitef_tpu_torch.parallel.fsdp``) against the JAX package's
FSDP step, on the CPU.

On gloo ranks, two AdamW steps (clip 0.5, two microbatches a step) through
``make_train_step`` of a module placed by ``shard_params(fsdp=True)`` at
(dp, tp) = (2, 1) and (2, 2): a tiny Llama (grouped-query attention, RoPE,
swiglu, rms norm) with the untied fused head and ``remat``, a tiny GPT-2
with the tied head (whose token table belongs to two units), and the ViT
with the paper's component freeze and ``block_grad_norms``; each against
the JAX step on parameters placed by the JAX ``shard_params(fsdp=True)`` on
a mesh of the same shape over the test suite's 8-device CPU mesh. Also,
at dp = 2 with one microbatch (the Llama also in bfloat16, whose saved
weight casts the backward rebuilds): the gradients, shard for shard, and
the grad norm bit-equal to the whole-model gather the step took before
(every parameter gathered for the step, one flat reduce-scatter after the
backward), and the high-water mark of the elements held gathered (weights
and whole gradients) at most twice the largest unit's, and a forward-only
run gathering by unit the logits of the whole model. float32 against
JAX, at 1e-4 / 1e-4, on one torch thread.

The ranks are this file run as ``python tests/test_torch_fsdp.py worker
<world> <rank> <port> <dir>``, one launch per world size (2 and 4), started
with the module's first test; a rank exits before the file's JAX imports.
"""

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
from vitef_tpu_torch.monitor.checkpoint import _assemble, model_pieces
from vitef_tpu_torch.ops.losses import make_fused_head_loss
from vitef_tpu_torch.optim import build_optimizer
from vitef_tpu_torch.parallel import (build_mesh, gathered, init_train_state,
                                      make_train_step, shard_batch, shard_params)

REPO = Path(__file__).resolve().parents[1]

LLAMA = {"implementation": "llama", "model_name": "tiny", "pretrained": False,
         "seq_len": 16, "remat": True}
GPT2 = {"implementation": "transformer", "vocab_size": 48, "emb_type": "dict",
        "emb_dim": 16, "n_heads": 4, "n_layers": 2, "seq_len": 16, "causal": True,
        "pre_norm": True, "weight_tying": True, "output_type": "sequence_to_sequence",
        "attn_bias": True, "ffn_bias": True, "norm_bias": True, "cls_token": False,
        "pos_emb": True, "compute_dtype": "float32", "attn_impl": "xla",
        "norm_impl": "xla"}
VIT = {"implementation": "transformer", "image_dim": (3, 32, 32),
       "patch_type": "computer_vision", "patch_size": 8, "emb_type": "linear",
       "emb_dim": 64, "n_heads": 4, "n_layers": 2, "attn_bias": True,
       "ffn_bias": True, "norm": "layer", "norm_bias": True, "norm_eps": 1e-12,
       "pre_norm": True, "cls_token": True, "output_type": "classification",
       "n_classes": 10, "compute_dtype": "float32"}
MODELS = {"llama": LLAMA, "gpt2": GPT2, "vit": VIT}
# the bit-equality cases: (model, compute dtype)
BIT_CASES = {"llama": ("llama", "float32"), "vit": ("vit", "float32"),
             "llama-bf16": ("llama", "bfloat16")}
FREEZE = ["mha", "ffn_fc1"]  # the ViT's frozen components
ADAMW = {"optimizer": "adamw", "lr": 1e-3, "weight_decay": 0.01}
CLIP, BATCH, ACC = 0.5, 8, 2
MESHES = {2: (2, 1), 4: (2, 2)}
WORKER_TIMEOUT = 240
ATOL, RTOL = 1e-4, 1e-4


def _batch(arrays, name: str, i: int):
    if name == "vit":
        return torch.from_numpy(arrays[f"img{i}"]), torch.from_numpy(arrays[f"label{i}"])
    tokens = torch.from_numpy(arrays[f"{name}/tok{i}"])
    return tokens, tokens


# ---------------------------------------------------------------------------
# The ranks: this file run as a worker
# ---------------------------------------------------------------------------


def _build(arrays, name: str, compute_dtype: str = "float32"):
    m = build_model({**MODELS[name], "compute_dtype": compute_dtype}, device="cpu")
    prefix = f"{name}/p/"
    m.module.load_state_dict({k[len(prefix):]: torch.from_numpy(v)
                              for k, v in arrays.items() if k.startswith(prefix)})
    return m


def _step_fn(m, name: str, grad_acc_steps: int = 1, grad_clip: float | None = None):
    return make_train_step(
        grad_acc_steps=grad_acc_steps, grad_clip=grad_clip,
        block_grad_norms=name == "vit",
        hidden_loss=make_fused_head_loss(m.config) if name != "vit" else None)


def _steps(arrays, name: str, mesh, world: int, res: dict) -> None:
    """Two steps at ACC microbatches; every metric, the whole parameters
    after them, and the high-water mark of each step."""
    import torch.distributed as dist

    m = _build(arrays, name)
    shard_params(m, mesh, fsdp=True)
    layout = m.module.mesh_layout
    opt, sched = build_optimizer(ADAMW, m.module,
                                 components=FREEZE if name == "vit" else None)
    state = init_train_state(m, opt, sched)
    step = _step_fn(m, name, grad_acc_steps=ACC, grad_clip=CLIP)
    tag = f"{name}{world}"
    for i in range(2):
        layout.peak_held = 0
        for key, value in step(state, shard_batch(_batch(arrays, name, i), mesh)).items():
            res[f"{tag}/{key}{i}"] = np.asarray(float(value))
        res[f"{tag}/peak{i}"] = np.asarray(layout.peak_held)
    res[f"{tag}/largest_unit"] = np.asarray(max(u.size for u in layout.units))
    res[f"{tag}/held_after"] = np.asarray(layout.held)
    # a forward-only run (eval mode, inference mode) gathers unit by unit too
    m.module.eval()
    x = shard_batch(_batch(arrays, name, 0), mesh)[0]
    layout.peak_held = 0
    with torch.inference_mode():
        res[f"{tag}/eval"] = m.module(x).numpy()
        res[f"{tag}/eval_peak"] = np.asarray(layout.peak_held)
        with gathered(m):
            res[f"{tag}/eval_whole"] = m.module(x).numpy()
    mine = model_pieces(m.module)
    every = [None] * world
    dist.all_gather_object(every, mine.pieces)
    for key, value in _assemble(mine.meta, every).items():
        res[f"{tag}/param/{key}"] = value


def _whole_gather_grads(m, name: str, batch, mesh) -> dict:
    """The step's gradients as it took them before units: every FSDP shard
    gathered whole for one forward and backward, then the whole float32
    gradients reduce-scattered in one flat buffer, each rank keeping its
    shard of the dp mean."""
    import torch.distributed as dist

    module, layout = m.module, m.module.mesh_layout
    module.train()
    x, y = batch
    with gathered(m):
        if name == "vit":
            loss = torch.nn.functional.cross_entropy(module(x), y)
        else:
            hidden = module(x, return_hidden=True)
            loss = make_fused_head_loss(m.config)(module, hidden, y)
        loss.backward()
        named = {n: p for n, p in module.named_parameters() if p.grad is not None}
    out = {n: p.grad.clone() for n, p in named.items() if layout.placement(n).dp is None}
    for n in out:
        dist.all_reduce(out[n], group=mesh.dp_group)
        out[n] /= mesh.dp
    sharded = [n for n in named if layout.placement(n).dp is not None]
    fronts = [named[n].grad.float().movedim(layout.placement(n).dp, 0) for n in sharded]
    send = torch.cat([torch.cat([g.chunk(mesh.dp)[r].reshape(-1) for g in fronts])
                      for r in range(mesh.dp)])
    mine = send.new_empty(send.numel() // mesh.dp)
    dist.reduce_scatter_tensor(mine, send, group=mesh.dp_group)
    mine /= mesh.dp
    chunks = [g.chunk(mesh.dp)[mesh.dp_rank] for g in fronts]
    for n, chunk, part in zip(sharded, chunks, mine.split([c.numel() for c in chunks])):
        out[n] = part.view(chunk.shape).movedim(0, layout.placement(n).dp).contiguous()
    return out


def _bit_equal_case(arrays, case: str, mesh, res: dict) -> None:
    """One step at dp = 2 with one microbatch, per unit (SGD at lr 0 and no
    clip, so that the gradients stay as they came), against
    :func:`_whole_gather_grads` on the same weights and rows."""
    name, compute_dtype = BIT_CASES[case]
    batch = shard_batch(_batch(arrays, name, 0), mesh)
    m = _build(arrays, name, compute_dtype)
    shard_params(m, mesh, fsdp=True)
    opt, sched = build_optimizer({"optimizer": "sgd", "lr": 0.0}, m.module)
    metrics = _step_fn(m, name)(init_train_state(m, opt, sched), batch)
    grads = {n: p.grad for n, p in m.module.named_parameters()}
    for p in m.module.parameters():
        p.grad = None
    want = _whole_gather_grads(m, name, batch, mesh)
    # the squared norms summed in the step's order: the trainable parameters'
    norm = m.module.mesh_layout.global_norms(
        [[(n, want[n]) for n, p in m.module.named_parameters() if p.requires_grad]])[0]
    assert sorted(want) == sorted(grads)
    res[f"bits/{case}/grad_norm"] = (metrics["grad_norm"] - norm).abs().numpy()
    for n, g in want.items():
        res[f"bits/{case}/{n}"] = (grads[n] - g).abs().max().numpy()


def _worker(world: int, rank: int, port: int, out_dir: Path) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=timedelta(seconds=120))
    arrays = dict(np.load(out_dir / "inputs.npz"))
    mesh = build_mesh(*MESHES[world])
    res = {}
    for name in MODELS:
        _steps(arrays, name, mesh, world, res)
    if world == 2:
        for case in BIT_CASES:
            _bit_equal_case(arrays, case, mesh, res)
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
            [sys.executable, __file__, "worker", str(world), str(rank), port,
             str(out_dir)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for rank in range(world)]

    def results(self) -> list:
        if self._results is None:
            try:
                outs = [proc.communicate(timeout=WORKER_TIMEOUT)[0]
                        for proc in self.procs]
            finally:
                self.close()
            for rank, (proc, out) in enumerate(zip(self.procs, outs)):
                assert proc.returncode == 0, (
                    f"world={self.world} rank {rank}:\n{out[-6000:]}")
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
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from vitef_tpu.models import build_model as jax_build_model  # noqa: E402
from vitef_tpu.ops.losses import make_fused_head_loss as jax_fused_head_loss  # noqa: E402
from vitef_tpu.optim import build_optimizer as jax_build_optimizer  # noqa: E402
from vitef_tpu.optim import trainable_mask as jax_trainable_mask  # noqa: E402
from vitef_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
from vitef_tpu.parallel import init_train_state as jax_init_train_state  # noqa: E402
from vitef_tpu.parallel import make_train_step as jax_make_train_step  # noqa: E402
from vitef_tpu.parallel import mesh as jax_mesh  # noqa: E402
from vitef_tpu.utils.tree import keystr_dotted  # noqa: E402
from vitef_tpu_torch.models import from_jax_params  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one intra-op thread in this process, beside the ranks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    return {name: jax_build_model(cfg, key=jax.random.key(i))
            for i, (name, cfg) in enumerate(MODELS.items())}


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, models):
    """The inputs (the JAX models' weights, the batches), then every world
    size's ranks, started together with the module's first test."""
    out_dir = tmp_path_factory.mktemp("fsdp")
    rng = np.random.default_rng(0)
    arrays = {}
    for i in range(2):
        arrays[f"img{i}"] = rng.normal(size=(BATCH, 3, 32, 32)).astype(np.float32)
        arrays[f"label{i}"] = rng.integers(0, 10, size=BATCH).astype(np.int64)
        for name in ("llama", "gpt2"):
            arrays[f"{name}/tok{i}"] = rng.integers(
                0, models[name].config.vocab_size, size=(BATCH, 16)).astype(np.int64)
    for name, jm in models.items():
        for key, t in from_jax_params(jax.tree.map(np.asarray, jm.params)).items():
            arrays[f"{name}/p/{key}"] = t.numpy()
    np.savez(out_dir / "inputs.npz", **arrays)
    launches = {world: _Launch(world, out_dir) for world in MESHES}
    yield launches, arrays
    for launch in launches.values():
        launch.close()


def _jax_steps(jm, name: str, arrays, dp: int, tp: int):
    mesh = jax_build_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    comps = FREEZE if name == "vit" else None
    tx, _ = jax_build_optimizer(ADAMW, params=jm.params, components=comps, grad_clip=CLIP)
    kw = ({"trainable": jax_trainable_mask(jm.params, FREEZE), "block_grad_norms": True}
          if name == "vit" else {"hidden_loss": jax_fused_head_loss(jm.config)})
    step = jax_make_train_step(jm.apply, tx, grad_acc_steps=ACC, donate=False, **kw)
    state = jax_init_train_state(jax_mesh.shard_params(jm.params, mesh, fsdp=True), tx)
    # every leaf on the mesh (the optimizer's counts replicated), and the
    # same placement before each step, so that the step compiles once
    repl = NamedSharding(mesh, PartitionSpec())
    state = jax.tree.map(lambda a: a if len(a.sharding.device_set) > 1
                         else jax.device_put(a, repl), state)
    placed = jax.tree.map(lambda a: a.sharding, state)
    metrics = []
    for i in range(2):
        x, y = (t.numpy() for t in _batch(arrays, name, i))
        y = y.astype(np.int32)
        batch = jax_mesh.shard_batch((jnp.asarray(x), jnp.asarray(y)), mesh)
        state, m = step(state, batch, jax.random.key(i))
        state = jax.device_put(state, placed)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {keystr_dotted(path): np.asarray(leaf) for path, leaf in
                     jax.tree_util.tree_leaves_with_path(state.params)}


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("name", list(MODELS))
def test_unit_fsdp_steps_match_jax(ranks, models, name, world):
    """Every rank's losses and grad norms (the ViT's per-block norms too) of
    both steps, and every parameter after them, against the JAX FSDP step
    on a mesh of the same shape."""
    launches, arrays = ranks
    want, want_params = _jax_steps(models[name], name, arrays, *MESHES[world])
    tag = f"{name}{world}"
    for res in launches[world].results():
        for i, ref in enumerate(want):
            keys = [k for k in ref if k.startswith(("loss", "grad_norm"))]
            assert len(keys) == (4 if name == "vit" else 2)
            for key in keys:
                np.testing.assert_allclose(res[f"{tag}/{key}{i}"], ref[key], rtol=RTOL,
                                           err_msg=f"{tag} step {i} {key}")
        for key, value in want_params.items():
            np.testing.assert_allclose(res[f"{tag}/param/{key}"], value, atol=ATOL,
                                       rtol=RTOL, err_msg=f"{tag} {key}")


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("name", list(MODELS))
def test_units_hold_at_most_two_units_gathered(ranks, name, world):
    """The high-water mark of the elements held gathered over each step
    (whole weights and whole gradients, this rank's tp slices) is at most
    twice the largest unit's, and nothing stays gathered after a step."""
    launches, _ = ranks
    tag = f"{name}{world}"
    for res in launches[world].results():
        for i in range(2):
            assert 0 < res[f"{tag}/peak{i}"] <= 2 * res[f"{tag}/largest_unit"], tag
        assert res[f"{tag}/held_after"] == 0, tag


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_only_runs_gather_by_unit(ranks, name, world):
    """An eval-mode forward under inference mode (``run_evaluation``'s)
    gathers unit by unit, holding at most the largest unit, and gives the
    logits of the forward with every parameter gathered whole."""
    launches, _ = ranks
    tag = f"{name}{world}"
    for res in launches[world].results():
        np.testing.assert_array_equal(res[f"{tag}/eval"], res[f"{tag}/eval_whole"])
        assert 0 < res[f"{tag}/eval_peak"] <= res[f"{tag}/largest_unit"], tag


@pytest.mark.parametrize("case", list(BIT_CASES))
def test_one_microbatch_bit_equal_to_the_whole_gather(ranks, case):
    """dp = 2, one microbatch: every gradient shard and the grad norm equal
    the whole-model gather's bit for bit (a sum of two ranks' values is the
    same in either order, and the unit's reduce-scatter adds what the flat
    one added); in bfloat16 too, where the backward rebuilds the saved
    casts of the whole weights (and their transposes) from a new gather."""
    launches, _ = ranks
    for res in launches[2].results():
        diffs = {k: float(v) for k, v in res.items() if k.startswith(f"bits/{case}/")}
        assert len(diffs) > 1 and not any(diffs.values()), diffs
