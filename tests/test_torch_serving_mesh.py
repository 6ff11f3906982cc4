"""``DecodeServer(mesh=)`` with an MoE model and with int8 weights under
tensor parallelism, against the one-rank server and the JAX mesh server, on
the CPU.

On gloo ranks at (dp, tp) = (1, 2) and (2, 2): a tiny MoE decoder (8
experts, top-2, biased stacks, the dense oracle), whose experts split over
'tp' (``apply_moe_ffn_tp``); the tiny GPT-2-style decoder of
``tests/test_torch_mesh.py`` with int8 weights (``Model.quantize_int8``),
each column-split weight with its columns' scales; and the MoE with int8
expert stacks, whose scales split along the expert axis. Six requests
through 4 slots; every rank's greedy tokens must equal the one-rank
server's and the JAX ``DecodeServer(mesh=)``'s on a mesh of the same shape
(its parameters placed by the JAX ``shard_params``). float32, on one torch
thread.

The ranks are this file run as ``python tests/test_torch_serving_mesh.py
worker <world> <rank> <port> <dir>``, one launch per world size (2 and 4),
started with the module's first test; a rank exits before the JAX imports.
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
from vitef_tpu_torch.models import serving as S
from vitef_tpu_torch.parallel import build_mesh

REPO = Path(__file__).resolve().parents[1]

DECODER = {"implementation": "transformer", "vocab_size": 48, "emb_type": "dict",
           "emb_dim": 16, "n_heads": 4, "n_kv_heads": 2, "n_layers": 2, "seq_len": 48,
           "causal": True, "pre_norm": True, "weight_tying": True,
           "output_type": "sequence_to_sequence", "attn_bias": True, "ffn_bias": True,
           "norm_bias": True, "cls_token": False, "pos_emb": True,
           "compute_dtype": "float32", "attn_impl": "xla", "norm_impl": "xla"}
MOE = {**DECODER, "ffn_dim": 16, "n_experts": 8, "moe_top_k": 2, "moe_impl": "dense"}
# (case, config, int8)
CASES = [("moe", MOE, False), ("int8", DECODER, True), ("moe-int8", MOE, True)]
MESHES = {2: (1, 2), 4: (2, 2)}
N_SLOTS, BUCKET = 4, 8
WORKER_TIMEOUT = 240


def _module(arrays, name: str, config: dict, int8: bool):
    m = build_model(config, device="cpu")
    prefix = f"{name}/p/"
    m.module.load_state_dict({k[len(prefix):]: torch.from_numpy(v)
                              for k, v in arrays.items() if k.startswith(prefix)})
    return (m.quantize_int8() if int8 else m.module), m.config


def _serve(module, cfg, reqs, mesh=None) -> list:
    srv = S.DecodeServer(module, cfg, n_slots=N_SLOTS, bucket=BUCKET, mesh=mesh)
    return [r.tokens for r in srv.serve([S.Request(prompt=p, max_new_tokens=n)
                                         for p, n in reqs])]


# ---------------------------------------------------------------------------
# The ranks: this file run as a worker
# ---------------------------------------------------------------------------


def _worker(world: int, rank: int, port: int, out_dir: Path) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=timedelta(seconds=120))
    arrays = dict(np.load(out_dir / "inputs.npz"))
    reqs = json.loads(str(arrays["requests"]))
    mesh = build_mesh(*MESHES[world])
    res = {}
    for name, config, int8 in CASES:
        module, cfg = _module(arrays, name, config, int8)
        res[name] = np.array(json.dumps(_serve(module, cfg, reqs, mesh)))
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

from vitef_tpu.models import build_model as jax_build_model  # noqa: E402
from vitef_tpu.models import serving as jax_serving  # noqa: E402
from vitef_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
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
    return {name: jax_build_model(config, key=jax.random.key(i))
            for i, (name, config, _) in enumerate(CASES)}


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, models):
    """The inputs (the JAX models' weights, the requests), then every world
    size's ranks, started together with the module's first test."""
    out_dir = tmp_path_factory.mktemp("serving_mesh")
    rng = np.random.default_rng(8)
    vocab = DECODER["vocab_size"]
    reqs = [(rng.integers(0, vocab, size=(int(rng.integers(3, 12)),)).tolist(),
             int(rng.integers(2, 8))) for _ in range(6)]
    arrays = {"requests": np.array(json.dumps(reqs))}
    for name, jm in models.items():
        for key, t in from_jax_params(jax.tree.map(np.asarray, jm.params)).items():
            arrays[f"{name}/p/{key}"] = t.numpy()
    np.savez(out_dir / "inputs.npz", **arrays)
    launches = {world: _Launch(world, out_dir) for world in MESHES}
    yield launches, arrays
    for launch in launches.values():
        launch.close()


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("name,config,int8", CASES, ids=[c[0] for c in CASES])
def test_mesh_server_takes_moe_and_int8_under_tp(ranks, models, name, config, int8,
                                                  world):
    """Every rank's greedy tokens equal the one-rank server's and the JAX
    mesh server's (parameters placed by the JAX ``shard_params``)."""
    launches, arrays = ranks
    reqs = json.loads(str(arrays["requests"]))
    want = _serve(*_module(arrays, name, config, int8), reqs)
    assert [len(t) for t in want] == [n for _, n in reqs]
    jm = models[name]
    dp, tp = MESHES[world]
    srv = jax_serving.DecodeServer(jm.quantize_int8() if int8 else jm.params, jm.config,
                                   n_slots=N_SLOTS, bucket=BUCKET,
                                   mesh=jax_build_mesh(dp=dp, tp=tp,
                                                       devices=jax.devices()[:dp * tp]))
    jax_tokens = [list(map(int, r.tokens)) for r in srv.serve(
        [jax_serving.Request(prompt=p, max_new_tokens=n) for p, n in reqs])]
    assert jax_tokens == want
    for res in launches[world].results():
        assert json.loads(str(res[name])) == want
