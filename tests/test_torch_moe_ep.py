"""The port's expert parallelism and MoE under tensor parallelism vs the JAX
package's, on the CPU.

On gloo ranks, against the JAX package on the test suite's 8-device CPU
mesh (``tests/conftest.py``), in float32 at 1e-4 / 1e-4:

- ``apply_moe_ffn_ep`` (the GShard one-hot dispatch) against the JAX
  ``apply_moe_ffn_ep`` under ``shard_map`` at ep = 2 and 4, top-1 and
  top-2, and with a capacity that drops;
- ``apply_moe_ffn_ep_sparse``, its output and the gradients of its input,
  router and expert stacks, against the JAX dense oracle ``apply_moe_ffn``
  when dropless (gelu top-1, swiglu top-2, and the fused swiglu geometry
  d = f = 128 that takes ``_FfnSegmentSwiglu``); its drop bound at a
  capacity factor below 1 against a numpy recount of the JAX rule; its
  ``aux`` against ``router_aux`` on the rank's tokens;
- two steps of ``make_moe_ep_train_step`` at ep = 2 and (dp, ep) = (2, 2)
  against the JAX single-device dense step on the same global batch (the
  comparison of ``tests/test_moe_ep_sparse.py`` :309-360, without the JAX
  ``ep_sparse`` path and its Pallas interpret mode);
- two SGD steps of an MoE model placed by ``shard_params`` at (dp, tp) =
  (1, 2) and (2, 2) against the JAX jitted step under ``param_shardings``
  (SGD: the attention's key bias has a gradient of exactly zero, whose
  rounding noise AdamW's normalisation would turn into whole steps).

The ranks are this file run as ``python tests/test_torch_moe_ep.py worker
<world> <rank> <port> <dir>``, one launch per world size (2 and 4), as in
``tests/test_torch_mesh.py``; a rank exits before the file's JAX imports.
"""

import math
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
from vitef_tpu_torch.models.transformer import TransformerConfig
from vitef_tpu_torch.monitor.checkpoint import _assemble, model_pieces
from vitef_tpu_torch.optim import build_optimizer
from vitef_tpu_torch.parallel import (apply_moe_ffn_ep, apply_moe_ffn_ep_sparse, build_ep_mesh,
                                      build_mesh, init_train_state, make_moe_ep_train_step,
                                      make_train_step, shard_batch, shard_experts, shard_params)

REPO = Path(__file__).resolve().parents[1]

# tests/test_moe_ep_sparse.py's FFN config (d = 8, f = 16), and a d = f = 128
# one whose swiglu takes the fused segment.
FFN = {"vocab_size": 16, "emb_type": "dict", "emb_dim": 8, "n_heads": 2, "n_layers": 1,
       "seq_len": 8, "ffn_dim": 16, "ffn_bias": False, "activation": "gelu",
       "output_type": "sequence_to_sequence", "cls_token": False, "attn_bias": True,
       "norm_bias": True, "attn_impl": "xla", "norm_impl": "xla"}
FFN_CONFIGS = {"gelu": dict(FFN), "swiglu": dict(FFN, ffn_type="swiglu"),
               "fused": dict(FFN, ffn_type="swiglu", emb_dim=128, ffn_dim=128)}
N_EXPERTS, TOKENS = 8, 32   # every world size splits the same 32 tokens
# (case, ffn config, top_k, capacity) of the GShard dispatch
GSHARD = [("top1", "gelu", 1, None), ("top2", "gelu", 2, None), ("drop", "gelu", 2, 2)]
# (case, ffn config, top_k) of the dropless sparse dispatch
SPARSE = [("gelu1", "gelu", 1), ("swiglu2", "swiglu", 2), ("fused2", "fused", 2)]
DROP_FACTOR = 0.5   # the sparse dispatch's capacity factor that drops
# tests/test_moe_ep_sparse.py's MoE decoder (8 experts, top-2, tied head)
MOE = {"implementation": "transformer", "vocab_size": 32, "emb_type": "dict", "emb_dim": 16,
       "n_heads": 2, "n_layers": 2, "seq_len": 8, "ffn_dim": 16, "ffn_bias": False,
       "causal": True, "pre_norm": True, "weight_tying": True,
       "output_type": "sequence_to_sequence", "cls_token": False, "pos_emb": True,
       "attn_bias": True, "norm_bias": True, "attn_impl": "xla", "norm_impl": "xla",
       "n_experts": 8, "moe_top_k": 2, "moe_impl": "dense", "compute_dtype": "float32"}
SGD = {"optimizer": "sgd", "lr": 0.05, "momentum": 0.9}
CLIP = 1.0
ROWS, ACC, STEPS = 8, 2, 2
# (case, dp, ep or tp) per world size
EP_STEPS = {2: [("ep2", 1, 2)], 4: [("dp2ep2", 2, 2)]}
TP_STEPS = {2: [("tp2", 1, 2)], 4: [("dp2tp2", 2, 2)]}
WORKER_TIMEOUT = 300
ATOL, RTOL = 1e-4, 1e-4


# ---------------------------------------------------------------------------
# The ranks: this file run as a worker
# ---------------------------------------------------------------------------


def _ffn_params(data, name: str, mesh) -> dict:
    """This rank's shard of FFN ``name``: the router whole, its experts."""
    e_loc = N_EXPERTS // mesh.ep
    lo = mesh.ep_rank * e_loc
    out = {}
    for part in ("router", "fc1", "fc2"):
        w = torch.from_numpy(data[f"ffn/{name}/{part}"])
        out[part] = {"weight": w if part == "router" else w[lo:lo + e_loc].clone()}
    return out


def _whole(module, world: int) -> dict:
    import torch.distributed as dist

    mine = model_pieces(module)
    every = [None] * world
    dist.all_gather_object(every, mine.pieces)
    return _assemble(mine.meta, every)


def _ffn_cases(data, world: int, res) -> None:
    mesh = build_ep_mesh(world)
    t_loc = TOKENS // world
    rows = slice(mesh.ep_rank * t_loc, (mesh.ep_rank + 1) * t_loc)
    for case, name, top_k, capacity in GSHARD:
        cfg = TransformerConfig(**FFN_CONFIGS[name])
        x = torch.from_numpy(data[f"ffn/{name}/x"][rows])
        out = apply_moe_ffn_ep(_ffn_params(data, name, mesh), cfg, x, top_k=top_k,
                               capacity=capacity, mesh=mesh)
        res[f"gshard/{case}"] = out.numpy()
    for case, name, top_k in SPARSE + [("drop", "gelu", 2)]:
        cfg = TransformerConfig(**FFN_CONFIGS[name])
        params = _ffn_params(data, name, mesh)
        leaves = [params[p]["weight"].requires_grad_() for p in ("router", "fc1", "fc2")]
        x = torch.from_numpy(data[f"ffn/{name}/x"][rows]).requires_grad_()
        aux = {}
        out = apply_moe_ffn_ep_sparse(params, cfg, x, top_k=top_k, mesh=mesh, aux=aux,
                                      capacity_factor=DROP_FACTOR if case == "drop" else None)
        (out * torch.from_numpy(data[f"ffn/{name}/g"][rows])).sum().backward()
        res[f"sparse/{case}/out"] = out.detach().numpy()
        res[f"sparse/{case}/dx"] = x.grad.numpy()
        for part, leaf in zip(("router", "fc1", "fc2"), leaves):
            res[f"sparse/{case}/d{part}"] = leaf.grad.numpy()
        res[f"sparse/{case}/lb"] = aux["lb"].detach().numpy()
        res[f"sparse/{case}/z"] = aux["z"].detach().numpy()


def _load_moe(data):
    m = build_model(MOE, device="cpu")
    m.module.load_state_dict({k[len("moe/"):]: torch.from_numpy(v) for k, v in data.items()
                              if k.startswith("moe/")})
    return m


def _model_steps(data, world: int, res) -> None:
    batch = (torch.from_numpy(data["tokens"]), torch.from_numpy(data["labels"]))
    for name, dp, ep in EP_STEPS[world]:
        m = _load_moe(data)
        mesh = build_ep_mesh(ep, dp)
        shard_experts(m, mesh)
        opt, sched = build_optimizer(SGD, m.module)
        state = init_train_state(m, opt, sched)
        step = make_moe_ep_train_step(mesh, grad_clip=CLIP, capacity_factor=None)
        for i in range(STEPS):
            metrics = step(state, shard_batch(batch, mesh))
            for key in ("loss", "grad_norm", "moe_lb", "moe_z"):
                res[f"{name}/{key}{i}"] = metrics[key].detach().numpy()
        for key, value in _whole(m.module, world).items():
            res[f"{name}/param/{key}"] = value
    for name, dp, tp in TP_STEPS[world]:
        m = _load_moe(data)
        mesh = build_mesh(dp, tp)
        shard_params(m, mesh)
        opt, sched = build_optimizer(SGD, m.module)
        state = init_train_state(m, opt, sched)
        step = make_train_step(grad_acc_steps=ACC, grad_clip=CLIP)
        for i in range(STEPS):
            metrics = step(state, shard_batch(batch, mesh))
            for key in ("loss", "grad_norm"):
                res[f"{name}/{key}{i}"] = metrics[key].detach().numpy()
        for key, value in _whole(m.module, world).items():
            res[f"{name}/param/{key}"] = value


def _worker(world: int, rank: int, port: int, out_dir: Path) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=timedelta(seconds=120))
    data = dict(np.load(out_dir / "inputs.npz"))
    res = {}
    _ffn_cases(data, world, res)
    _model_steps(data, world, res)
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
from jax.sharding import Mesh as JaxMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from vitef_tpu.models import TransformerConfig as JaxTransformerConfig  # noqa: E402
from vitef_tpu.models import build_model as jax_build_model  # noqa: E402
from vitef_tpu.optim import build_optimizer as jax_build_optimizer  # noqa: E402
from vitef_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
from vitef_tpu.parallel import init_train_state as jax_init_train_state  # noqa: E402
from vitef_tpu.parallel import make_train_step as jax_make_train_step  # noqa: E402
from vitef_tpu.parallel import mesh as jax_mesh  # noqa: E402
from vitef_tpu.parallel import moe as jax_moe  # noqa: E402
from vitef_tpu.utils.tree import keystr_dotted  # noqa: E402
from vitef_tpu_torch.models import from_jax_params  # noqa: E402


def _flat(params) -> dict:
    return {keystr_dotted(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}


def _jax_cfg(name: str):
    return JaxTransformerConfig(**FFN_CONFIGS[name])


@pytest.fixture(scope="module")
def inputs():
    """The FFN parameters (JAX ``init_moe_ffn``) and global tokens of every
    FFN config, the MoE decoder and its batch."""
    rng = np.random.default_rng(11)
    arrays, ffn = {}, {}
    for i, name in enumerate(FFN_CONFIGS):
        params = jax_moe.init_moe_ffn(jax.random.key(20 + i), _jax_cfg(name), N_EXPERTS)
        ffn[name] = params
        d = FFN_CONFIGS[name]["emb_dim"]
        arrays[f"ffn/{name}/router"] = np.asarray(params["router"]["weight"]).T.copy()
        arrays[f"ffn/{name}/fc1"] = np.asarray(params["fc1"]["weight"])
        arrays[f"ffn/{name}/fc2"] = np.asarray(params["fc2"]["weight"])
        arrays[f"ffn/{name}/x"] = rng.normal(size=(TOKENS, d)).astype(np.float32)
        arrays[f"ffn/{name}/g"] = rng.normal(size=(TOKENS, d)).astype(np.float32)
    jm = jax_build_model(MOE, key=jax.random.key(9))
    for name, t in from_jax_params(jax.tree.map(np.asarray, jm.params)).items():
        arrays[f"moe/{name}"] = t.numpy()
    tokens = rng.integers(0, MOE["vocab_size"], size=(ROWS, MOE["seq_len"])).astype(np.int64)
    arrays["tokens"], arrays["labels"] = tokens, np.roll(tokens, -1, axis=1)
    return arrays, ffn, jm


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, inputs):
    out_dir = tmp_path_factory.mktemp("moe_ep")
    np.savez(out_dir / "inputs.npz", **inputs[0])
    launches = {world: _Launch(world, out_dir) for world in (2, 4)}
    yield launches
    for launch in launches.values():
        launch.close()


def _ep_mesh(ep: int):
    return JaxMesh(np.asarray(jax.devices()[:ep]), axis_names=("ep",))


def _check(results, name, want, want_params, keys=("loss", "grad_norm")):
    for res in results:
        for i in range(STEPS):
            for key in keys:
                np.testing.assert_allclose(res[f"{name}/{key}{i}"], want[i][key], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{name} step {i} {key}")
        for key, value in want_params.items():
            np.testing.assert_allclose(res[f"{name}/param/{key}"], value, atol=ATOL,
                                       rtol=RTOL, err_msg=f"{name} {key}")


@pytest.mark.parametrize("world,name,dp,tp", [(w, *c) for w, cs in TP_STEPS.items()
                                              for c in cs])
def test_moe_under_tensor_parallelism_matches_jax(ranks, inputs, world, name, dp, tp):
    """``shard_params`` on the MoE decoder at tp > 1 (each rank's heads and
    block of experts, one all-reduce at the combine): two SGD steps of two
    microbatches with the global clip, each step's loss and grad norm on
    every rank and the whole model after them, against the JAX jitted step
    on parameters placed by ``param_shardings`` on a mesh of the same
    shape."""
    arrays, _, jm = inputs
    mesh = jax_build_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    params = jax_mesh.shard_params(jm.params, mesh)
    tx, _ = jax_build_optimizer(SGD, params=params, grad_clip=CLIP)
    step = jax_make_train_step(jm.apply, tx, grad_acc_steps=ACC, donate=False)
    state = jax_init_train_state(params, tx)
    batch = jax_mesh.shard_batch((jnp.asarray(arrays["tokens"], jnp.int32),
                                  jnp.asarray(arrays["labels"], jnp.int32)), mesh)
    want = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        want.append({k: float(v) for k, v in m.items()})
    _check(ranks[world].results(), name, want, _flat(state.params))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case,name,top_k,capacity", GSHARD, ids=[c[0] for c in GSHARD])
def test_gshard_dispatch_matches_jax(ranks, inputs, world, case, name, top_k, capacity):
    """Each rank's output of the one-hot dispatch equals the JAX
    ``apply_moe_ffn_ep`` under ``shard_map`` on an ('ep',) mesh of the same
    size, its rows of the global tokens; the capacity of 2 drops claims."""
    arrays, ffn, _ = inputs
    params = ffn[name]
    mesh = _ep_mesh(world)
    specs = jax.tree.map(lambda s: s.spec, jax_moe.moe_param_shardings(params, mesh))
    fn = jax.jit(jax.shard_map(
        lambda p, xx: jax_moe.apply_moe_ffn_ep(p, _jax_cfg(name), xx, top_k=top_k,
                                               capacity=capacity),
        mesh=mesh, in_specs=(specs, P("ep")), out_specs=P("ep"), check_vma=False))
    x = jnp.asarray(arrays[f"ffn/{name}/x"])
    want = np.asarray(fn(jax.device_put(params, jax_moe.moe_param_shardings(params, mesh)), x))
    t_loc = TOKENS // world
    for rank, res in enumerate(ranks[world].results()):
        np.testing.assert_allclose(res[f"gshard/{case}"], want[rank * t_loc:(rank + 1) * t_loc],
                                   atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def oracle(inputs):
    """The JAX dense oracle's output on the global tokens and its gradients
    under their cotangent, by FFN config and top_k, each computed once."""
    arrays, ffn, _ = inputs

    @functools.cache
    def run(name: str, top_k: int):
        cfg = _jax_cfg(name)
        out, vjp = jax.vjp(lambda p, xx: jax_moe.apply_moe_ffn(p, cfg, xx, top_k=top_k),
                           ffn[name], jnp.asarray(arrays[f"ffn/{name}/x"]))
        dp, dx = vjp(jnp.asarray(arrays[f"ffn/{name}/g"]))
        return np.asarray(out), np.asarray(dx), dp

    return run


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case,name,top_k", SPARSE, ids=[c[0] for c in SPARSE])
def test_sparse_dispatch_matches_dense_oracle(ranks, oracle, world, case, name, top_k):
    """Dropless: each rank's output and input gradient are the JAX dense
    oracle's rows; its expert stacks' gradients (summed over 'ep' by the
    exchange's backward) are the oracle's for its experts; the router's
    gradients of the ranks sum to the oracle's."""
    out, dx, dparams = oracle(name, top_k)
    results = ranks[world].results()
    e_loc, t_loc = N_EXPERTS // world, TOKENS // world
    for rank, res in enumerate(results):
        rows = slice(rank * t_loc, (rank + 1) * t_loc)
        np.testing.assert_allclose(res[f"sparse/{case}/out"], out[rows], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(res[f"sparse/{case}/dx"], dx[rows], atol=ATOL, rtol=RTOL)
        experts = slice(rank * e_loc, (rank + 1) * e_loc)
        for part in ("fc1", "fc2"):
            np.testing.assert_allclose(res[f"sparse/{case}/d{part}"],
                                       np.asarray(dparams[part]["weight"])[experts],
                                       atol=ATOL, rtol=RTOL, err_msg=part)
    router = sum(res[f"sparse/{case}/drouter"] for res in results)
    np.testing.assert_allclose(router, np.asarray(dparams["router"]["weight"]).T,
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("world", [2, 4])
def test_sparse_drop_bound_and_aux(ranks, inputs, world):
    """At capacity factor 0.5 (top-2): the drop bound is ``ceil(T_loc·k/ep ·
    c)`` claims per owner, counted in token-major claim order, as a numpy
    recount of the JAX rule says; each rank's output is the oracle with the
    dropped claims' gates zeroed (some claims are dropped, some kept). Its
    ``aux`` is the JAX ``router_aux`` of the rank's tokens."""
    arrays, ffn, _ = inputs
    name, top_k = "gelu", 2
    cfg, params = _jax_cfg(name), ffn[name]
    t_loc = TOKENS // world
    cap = math.ceil(t_loc * top_k / world * DROP_FACTOR)
    e_loc = N_EXPERTS // world
    everyone = np.asarray(jax_moe._expert_ffn(
        params["fc1"], params["fc2"], cfg,
        jnp.broadcast_to(jnp.asarray(arrays[f"ffn/{name}/x"]),
                         (N_EXPERTS, TOKENS, cfg.emb_dim))))

    @jax.jit
    def route_and_aux(x):
        _, _, sel, top_p = jax_moe._route(params, cfg, x, top_k, need_probs=False)
        return sel, top_p, jax_moe.router_aux(params, cfg, x, top_k)

    dropped = kept = 0
    for rank, res in enumerate(ranks[world].results()):
        rows = slice(rank * t_loc, (rank + 1) * t_loc)
        sel, top_p, aux = route_and_aux(jnp.asarray(arrays[f"ffn/{name}/x"][rows]))
        sel, top_p = np.asarray(sel), np.asarray(top_p)
        owner = sel.reshape(-1) // e_loc
        seen = np.zeros(world, int)
        valid = np.zeros(owner.shape, bool)
        for g, o in enumerate(owner):
            valid[g] = seen[o] < cap
            seen[o] += 1
        dropped += int((~valid).sum())
        kept += int(valid.sum())
        gates = top_p * valid.reshape(t_loc, top_k)
        want = np.stack([sum(gates[t, j] * everyone[sel[t, j], rank * t_loc + t]
                             for j in range(top_k)) for t in range(t_loc)])
        np.testing.assert_allclose(res["sparse/drop/out"], want, atol=ATOL, rtol=RTOL)
        for key in ("lb", "z"):
            np.testing.assert_allclose(res[f"sparse/drop/{key}"], float(aux[key]), rtol=RTOL)
    assert dropped and kept


@pytest.fixture(scope="module")
def jax_dense_steps(inputs):
    """Two steps of the JAX single-device dense step on the global batch:
    each step's metrics and the parameters after them."""
    arrays, _, jm = inputs
    tx, _ = jax_build_optimizer(SGD, params=jm.params, components=[], grad_clip=CLIP)
    step = jax_make_train_step(jm.apply, tx, donate=False)
    state = jax_init_train_state(jm.params, tx)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, (jnp.asarray(arrays["tokens"], jnp.int32),
                                jnp.asarray(arrays["labels"], jnp.int32)))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _flat(state.params)


@pytest.mark.parametrize("world,name", [(w, c[0]) for w, cs in EP_STEPS.items() for c in cs])
def test_ep_train_step_matches_single_device(ranks, jax_dense_steps, world, name):
    """Two steps of ``make_moe_ep_train_step`` (dropless, SGD, the clip in
    the step) on the ranks' shards of the global batch: each step's loss and
    grad norm on every rank and the whole model after them (the expert
    stacks assembled from their owners) equal the JAX single-device dense
    step's on the same batch; the router losses are reported as zeros when
    their coefficients are."""
    want, want_params = jax_dense_steps
    results = ranks[world].results()
    _check(results, name, want, want_params)
    for res in results:
        assert float(res[f"{name}/moe_lb0"]) == float(res[f"{name}/moe_z0"]) == 0.0


def test_ep_placements_are_jax_specs(inputs):
    """``moe_param_shardings`` over one FFN and ``moe_ep_state_shardings``
    over the whole MoE decoder split exactly the tensors the JAX package's
    split over 'ep', along their expert axis."""
    from vitef_tpu_torch.parallel import moe_ep_state_shardings, moe_param_shardings

    _, ffn, jm = inputs
    mesh = _ep_mesh(2)
    for got_fn, want_tree, params in (
            (moe_param_shardings, jax_moe.moe_param_shardings(ffn["gelu"], mesh), ffn["gelu"]),
            (moe_ep_state_shardings, jax_moe.moe_ep_state_shardings(jm.params, mesh),
             jm.params)):
        want = {keystr_dotted(p): tuple(s.spec)
                for p, s in jax.tree_util.tree_leaves_with_path(want_tree)}
        shapes = {name: tuple(t.shape) for name, t in
                  from_jax_params(jax.tree.map(np.asarray, params)).items()}
        got = got_fn(shapes)
        assert sorted(got) == sorted(want)
        for name, placement in got.items():
            spec = ("ep",) + (None,) * (len(shapes[name]) - 1) if placement.ep == 0 else ()
            assert spec == tuple(want[name]), name
        assert any(p.ep == 0 for p in got.values())


def test_one_process_refusals():
    """One process: ``ep_sparse`` outside an expert placement raises; the
    sparse dispatch refuses biased expert stacks as the JAX package does; a
    placement needs n_experts divisible by ep, and points every block's FFN
    at the mesh; the EP step needs an 'ep' axis; the mesh server builds an MoE model at
    tp > 1, each rank holding its block of experts, and serves (one process:
    rank 0's half of every sum, so only the streams' lengths are held here;
    tests/test_torch_serving_mesh.py holds the tokens on gloo ranks)."""
    m = build_model(dict(MOE, moe_impl="ep_sparse"), device="cpu")
    tokens = torch.zeros((1, MOE["seq_len"]), dtype=torch.long)
    with pytest.raises(RuntimeError, match="shard_experts"):
        m.module(tokens)
    cfg = TransformerConfig(**FFN)
    biased = {"router": {"weight": torch.zeros(4, 8)},
              "fc1": {"weight": torch.zeros(4, 8, 16), "bias": torch.zeros(4, 16)},
              "fc2": {"weight": torch.zeros(4, 16, 8)}}
    with pytest.raises(ValueError, match="bias-free"):
        apply_moe_ffn_ep_sparse(biased, cfg, torch.zeros(2, 8))
    jcfg = JaxTransformerConfig(**FFN)
    jbiased = jax.tree.map(jnp.asarray, {"router": {"weight": np.zeros((8, 4))},
                                         "fc1": {"weight": np.zeros((4, 8, 16)),
                                                 "bias": np.zeros((4, 16))},
                                         "fc2": {"weight": np.zeros((4, 16, 8))}})
    with pytest.raises(ValueError, match="bias-free"):
        jax_moe.apply_moe_ffn_ep_sparse(jbiased, jcfg, jnp.zeros((2, 8)))
    three = type(build_ep_mesh(1))(dp=1, ep=3)
    with pytest.raises(ValueError, match="divisible"):
        shard_experts(build_model(MOE, device="cpu"), three)
    two = type(three)(dp=1, ep=2)
    placed = shard_experts(build_model(MOE, device="cpu"), two)
    assert placed.module.blocks[0].ffn.fc1["weight"].shape[0] == MOE["n_experts"] // 2
    assert all(block.ffn.ep is two for block in placed.module.blocks)
    with pytest.raises(AssertionError, match="'ep'"):
        make_moe_ep_train_step(build_mesh())
    from vitef_tpu_torch.models.serving import DecodeServer, Request

    moe = build_model(MOE, device="cpu")
    srv = DecodeServer(moe.module, moe.config, n_slots=2,
                       mesh=type(build_mesh())(dp=1, tp=2))
    assert all(block.ffn.tp is not None and block.ffn.fc1["weight"].shape[0]
               == MOE["n_experts"] // 2 for block in srv.module.blocks)
    assert moe.module.blocks[0].ffn.fc1["weight"].shape[0] == MOE["n_experts"]  # a copy
    out = srv.serve([Request(prompt=[1, 2, 3], max_new_tokens=3),
                     Request(prompt=[4], max_new_tokens=2)])
    assert [len(r.tokens) for r in out] == [3, 2]
