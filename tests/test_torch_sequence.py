"""The port's sequence parallelism vs the JAX package, on the CPU.

The hop: ``zigzag_permutation`` and the shard positions, the plain hop
``attend_block`` (a fully masked block first, lengths 384 and 640), K9's
plain version against the JAX Pallas hop in interpret mode and
``hop_kernel_ok`` against ``_hop_pallas_ok``. The ring: ``ring_attention``
values and gradients, the sp logits and two steps of ``make_sp_train_step``
against the JAX ring on the test suite's 8-device CPU mesh
(``tests/conftest.py``), at sp 2 and 4, and sp = 1 in a one-rank group.

The port's ranks run in gloo process groups: the module launches this file
as ``python tests/test_torch_sequence.py worker <sp> <rank> <port> <dir>``,
one process per rank and one launch per sp, each running every case of its
sp and writing its results as ``.npz`` files; the tests compute the JAX side
while the ranks run.
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

from vitef_tpu_torch.models import build_model, from_jax_params
from vitef_tpu_torch.models import transformer as TR
from vitef_tpu_torch.models.transformer import Transformer, TransformerConfig
from vitef_tpu_torch.ops import ring_hop as RH
from vitef_tpu_torch.optim import build_optimizer
from vitef_tpu_torch.parallel import sequence as SEQ
from vitef_tpu_torch.parallel import (apply_transformer_sp, build_sp_group, init_train_state,
                                      make_sp_train_step, make_train_step, ring_attention,
                                      shard_positions, zigzag_permutation)

REPO = Path(__file__).resolve().parents[1]

# The JAX test's causal LM (tests/test_sequence_parallel.py:26-36) in the
# registry's flat form, two layers.
LM = {"implementation": "transformer", "patch_type": None, "vocab_size": 32,
      "emb_type": "dict", "emb_dim": 16, "n_heads": 2, "n_layers": 2, "pos_emb": True,
      "seq_len": 32, "attn_bias": True, "flash": True, "causal": True, "activation": "gelu",
      "ffn_bias": True, "norm": "layer", "norm_bias": True, "norm_eps": 1e-5,
      "pre_norm": True, "cls_token": False, "output_type": "sequence_to_sequence",
      "weight_tying": True, "dropout": 0.0, "attn_impl": "xla", "norm_impl": "xla"}
SGD = {"optimizer": "sgd", "lr": 0.05, "momentum": 0.9}
RING_SHAPE = (1, 2, 128, 8)                # (N, h, L, d) of the ring cases
# (zigzag, causal, chunk, impl) per sp: each value of each option at sp 2
# and 4, both layouts causal; impl "kernel" on the CPU is the kernel route
# (raw queries, scale in the hop, the hop's plain version), "auto" the plain
# route.
RING_CASES = {
    1: [(False, True, None, "auto"), (True, True, 16, "kernel")],
    2: [(False, True, None, "auto"), (True, True, 16, "kernel"), (True, False, None, "auto")],
    4: [(False, True, 16, "kernel"), (True, True, None, "auto"), (False, False, 16, "auto")],
}
# (grad_acc_steps, zigzag) of the train-step cases at sp 4, and of sp = 1.
STEP_CASES = {1: [(1, True)], 2: [], 4: [(1, False), (2, True)]}
LOGIT_CASES = {1: [False], 2: [], 4: [False, True]}  # zigzag or not
WORKER_TIMEOUT = 240                       # seconds a launch may take
ATOL, RTOL = 2e-5, 1e-4                    # the hop and the ring output
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-4          # gradients, logits, parameters


def ring_name(zigzag, causal, chunk, impl) -> str:
    return (f"{'zigzag' if zigzag else 'contiguous'}-{'causal' if causal else 'full'}-"
            f"chunk{chunk}-{impl}")


def _layout(length: int, sp: int, zigzag: bool) -> np.ndarray:
    return zigzag_permutation(length, sp) if zigzag else np.arange(length)


# ---------------------------------------------------------------------------
# The ranks: this file run as a worker
# ---------------------------------------------------------------------------


def _worker(sp: int, rank: int, port: int, out_dir: Path) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    if sp > 1:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=sp, rank=rank, timeout=timedelta(seconds=60))
    group = build_sp_group(sp, backend="gloo")  # at sp = 1 it makes the one-rank group
    data = np.load(out_dir / "inputs.npz")
    res = {}

    length = RING_SHAPE[2]
    lloc = length // sp
    mine = slice(rank * lloc, (rank + 1) * lloc)
    for zigzag, causal, chunk, impl in RING_CASES[sp]:
        perm = _layout(length, sp, zigzag)
        q, k, v, g = (torch.from_numpy(data[x][:, :, perm][:, :, mine].copy())
                      for x in ("q", "k", "v", "g"))
        leaves = [t.requires_grad_() for t in (q, k, v)]
        out = ring_attention(*leaves, group=group, causal=causal, zigzag=zigzag, chunk=chunk,
                             impl=impl)
        grads = torch.autograd.grad((out * g).sum(), leaves)
        name = ring_name(zigzag, causal, chunk, impl)
        for key, t in zip(("out", "dq", "dk", "dv"), (out, *grads)):
            res[f"{name}/{key}"] = t.detach().numpy()

    weights = {k.removeprefix("param/"): torch.from_numpy(data[k])
               for k in data.files if k.startswith("param/")}

    def model():
        m = build_model(LM, device="cpu")
        m.module.load_state_dict(weights)
        return m

    tokens, labels = torch.from_numpy(data["tokens"]), torch.from_numpy(data["labels"])
    tloc = tokens.shape[1] // sp
    for zigzag in LOGIT_CASES[sp]:
        perm = torch.from_numpy(_layout(tokens.shape[1], sp, zigzag)).long()
        with torch.no_grad():
            logits = apply_transformer_sp(model().module,
                                          tokens[:, perm][:, rank * tloc:(rank + 1) * tloc],
                                          group=group, zigzag=zigzag, chunk=8)
        res[f"logits-{zigzag}"] = logits.numpy()

    for acc, zigzag in STEP_CASES[sp]:
        m = model()
        optimizer, scheduler = build_optimizer(SGD, m.module)
        state = init_train_state(m, optimizer, scheduler)
        step = make_sp_train_step(group=group, zigzag=zigzag, chunk=8, grad_acc_steps=acc,
                                  grad_clip=1.0)
        name = f"step-acc{acc}-{zigzag}"
        for i in range(2):
            metrics = step(state, (tokens, labels))
            for key in ("loss", "grad_norm"):
                res[f"{name}/{key}{i}"] = metrics[key].numpy()
        for pname, p in m.module.named_parameters():
            res[f"{name}/param/{pname}"] = p.detach().numpy()
    if sp == 2:
        # Dropout at rate 0.5 on every site, the same seed on both ranks: the
        # masks each site draws (its values zeroed), recorded per call.
        drop = build_model({**LM, "dropout": 0.5}, device="cpu")
        drop.module.load_state_dict(weights)
        drop.module.train()
        masks, original = [], SEQ.dropout

        def recording(x, rate, generator, deterministic):
            out = original(x, rate, generator, deterministic)
            masks.append(((out != 0) | (x == 0)).reshape(-1))
            return out

        # the sp forward's own sites and the blocks' FFN and the head's
        SEQ.dropout = TR.dropout = recording
        try:
            for seed in (3, 3, 4):
                apply_transformer_sp(drop.module, tokens[:, rank * tloc:(rank + 1) * tloc],
                                     group=group, chunk=8,
                                     generator=torch.Generator().manual_seed(seed))
        finally:
            SEQ.dropout = TR.dropout = original
        calls = len(masks) // 3
        for run in range(3):
            res[f"dropout/seed{run}"] = torch.stack(masks[run * calls:(run + 1) * calls]).numpy()
    if sp == 1:
        # The same two steps through the port's ordinary train step.
        m = model()
        optimizer, scheduler = build_optimizer(SGD, m.module)
        state = init_train_state(m, optimizer, scheduler)
        step = make_train_step(grad_clip=1.0)
        for i in range(2):
            metrics = step(state, (tokens, labels))
            for key in ("loss", "grad_norm"):
                res[f"ordinary/{key}{i}"] = metrics[key].numpy()
        for pname, p in m.module.named_parameters():
            res[f"ordinary/param/{pname}"] = p.detach().numpy()

    np.savez(out_dir / f"sp{sp}_rank{rank}.npz", **res)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


class _Launch:
    """The ranks of one sp, started at once; :meth:`results` waits for them
    (each within WORKER_TIMEOUT) and returns each rank's arrays."""

    def __init__(self, sp: int, out_dir: Path):
        self.sp, self.out_dir, self._results = sp, out_dir, None
        port = str(_free_port())
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, "worker", str(sp), str(rank), port, str(out_dir)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(sp)]

    def results(self) -> list:
        if self._results is None:
            outs = []
            try:
                for proc in self.procs:
                    outs.append(proc.communicate(timeout=WORKER_TIMEOUT)[0])
            finally:
                self.close()
            for rank, (proc, out) in enumerate(zip(self.procs, outs)):
                assert proc.returncode == 0, f"sp={self.sp} rank {rank}:\n{out[-6000:]}"
            self._results = [dict(np.load(self.out_dir / f"sp{self.sp}_rank{r}.npz"))
                             for r in range(self.sp)]
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
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from vitef_tpu.models import build_model as jax_build_model  # noqa: E402
from vitef_tpu.optim import build_optimizer as jax_build_optimizer  # noqa: E402
from vitef_tpu.parallel import init_train_state as jax_init_train_state  # noqa: E402
from vitef_tpu.parallel import sequence as jax_seq  # noqa: E402


@pytest.fixture(scope="module")
def jax_model():
    return jax_build_model(LM, key=jax.random.key(1))


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, jax_model):
    """Every sp's ranks, started together with the module's first test, so
    that they run while the tests in this process do; the inputs are written
    first."""
    out_dir = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(0)
    arrays = {x: rng.normal(size=RING_SHAPE).astype(np.float32) for x in ("q", "k", "v", "g")}
    tokens = rng.integers(0, LM["vocab_size"], size=(4, LM["seq_len"])).astype(np.int64)
    arrays.update(tokens=tokens, labels=np.roll(tokens, -1, axis=1))
    for name, t in from_jax_params(jax.tree.map(np.asarray, jax_model.params)).items():
        arrays[f"param/{name}"] = t.numpy()
    np.savez(out_dir / "inputs.npz", **arrays)
    launches = {sp: _Launch(sp, out_dir) for sp in (1, 2, 4)}
    yield launches, arrays
    for launch in launches.values():
        launch.close()


# ---------------------------------------------------------------------------
# The layout and the hop, in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sp", [1, 2, 4, 8])
def test_zigzag_permutation_and_positions_match_jax(sp):
    length = 64
    np.testing.assert_array_equal(zigzag_permutation(length, sp),
                                  jax_seq.zigzag_permutation(length, sp))
    lloc = length // sp
    for zigzag in (False, True):
        for rank in range(sp):
            got = shard_positions(rank, lloc, sp, zigzag)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(
                got, np.asarray(jax_seq._shard_positions(rank, lloc, sp, zigzag)))
        # made on the device without a host copy: the same rows, and
        # flattened the permutation
        on_device = SEQ.device_positions(lloc, sp, zigzag, "cpu")
        np.testing.assert_array_equal(on_device.numpy(),
                                      np.stack([shard_positions(r, lloc, sp, zigzag)
                                                for r in range(sp)]))
    np.testing.assert_array_equal(SEQ.device_positions(lloc, sp, True, "cpu").view(-1).numpy(),
                                  zigzag_permutation(length, sp))
    with pytest.raises(ValueError):
        zigzag_permutation(length + 1, sp)


def _hop_inputs(seed, n, h, lq, lk, d, initial=True, dtype=np.float32):
    """q, k, v and a state (the -1e30 start, or a random non-initial one)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(n, h, l, d)).astype(dtype) for l in (lq, lk, lk))
    if initial:
        state = (np.full((n, h, lq, 1), -1e30, np.float32), np.zeros((n, h, lq, 1), np.float32),
                 np.zeros((n, h, lq, d), np.float32))
    else:
        state = (rng.normal(size=(n, h, lq, 1)).astype(np.float32),
                 rng.uniform(0.5, 3.0, size=(n, h, lq, 1)).astype(np.float32),
                 rng.normal(size=(n, h, lq, d)).astype(np.float32))
    return q, k, v, state


def _jax_hops(qf, qpos, blocks, state, causal, chunk):
    st = tuple(jnp.asarray(x) for x in state)
    for k, v, kpos in blocks:
        st = jax_seq._attend_block(jnp.asarray(qf), jnp.asarray(qpos), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(kpos), st, causal=causal,
                                   chunk=chunk)
    return [np.asarray(x) for x in st]


def _port_hops(qf, qpos, blocks, state, causal, chunk):
    st = tuple(torch.from_numpy(x) for x in state)
    for k, v, kpos in blocks:
        st = RH.attend_block(torch.from_numpy(qf), torch.from_numpy(qpos), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(kpos), st, causal=causal,
                             chunk=chunk)
    return [x.numpy() for x in st]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("lq,lk,chunk", [(32, 48, None), (32, 48, 16), (32, 48, 512),
                                         (384, 384, None), (384, 384, 128), (256, 640, None),
                                         (256, 640, 128)])
def test_attend_block_matches_jax(causal, lq, lk, chunk):
    """Two blocks folded in turn from the -1e30 start: the first is fully in
    the future of every query (a fully masked block first, when causal), the
    second half visible."""
    q, k, v, state = _hop_inputs(0, 1, 2, lq, lk, 16)
    qf = q * 0.25
    qpos = np.arange(lq, dtype=np.int32) + lk // 2
    future = (k[:, :, ::-1].copy(), v[:, :, ::-1].copy(),
              np.arange(lk, dtype=np.int32) + lq + lk)
    visible = (k, v, np.arange(lk, dtype=np.int32))
    blocks = [future, visible]
    got = _port_hops(qf, qpos, blocks, state, causal, chunk)
    want = _jax_hops(qf, qpos, blocks, state, causal, chunk)
    for g, w, name in zip(got, want, ("m", "s", "acc")):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=name)
    if causal:  # the fully masked block left the start untouched
        first = _port_hops(qf, qpos, blocks[:1], state, causal, chunk)
        for g, w in zip(first, state):
            np.testing.assert_array_equal(g, w)


def test_hop_reference_matches_the_pallas_hop():
    """K9's plain version against the JAX Pallas hop in interpret mode, on
    bf16 inputs from a non-initial state, at a block that kernel covers
    (lq <= 256, lk <= 512), within the JAX test's 3e-2 on acc / s
    (tests/test_sequence_parallel.py:401-403): the kernel rounds p to bf16
    before P.V, the plain version does not."""
    n, h, lq, lk, d = 1, 2, 128, 256, 64
    q, k, v, state = _hop_inputs(1, n, h, lq, lk, d, initial=False)
    q, k, v = (x.astype(jnp.bfloat16) for x in (q, k, v))
    qpos = np.arange(lq, dtype=np.int32) + 192     # rows see 193-256 keys
    kpos = np.arange(lk, dtype=np.int32)
    scale = 1 / np.sqrt(d)
    with pltpu.force_tpu_interpret_mode():
        want = jax_seq._hop_pallas_call(
            jnp.asarray(q), jnp.asarray(qpos), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(kpos), *(jnp.asarray(x) for x in state), causal=True, block_kv=256,
            sm_scale=scale)
    want = [np.asarray(x) for x in want]
    t = [torch.from_numpy(np.asarray(x, np.float32)).bfloat16() for x in (q, k, v)]
    got = RH.hop_state_reference(t[0], torch.from_numpy(qpos), t[1], t[2],
                                 torch.from_numpy(kpos), *(torch.from_numpy(x) for x in state),
                                 causal=True, chunk=512)
    got = [x.numpy() for x in got]
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5, err_msg="m")
    np.testing.assert_allclose(got[1], want[1], atol=0, rtol=1e-4, err_msg="s")
    np.testing.assert_allclose(got[2] / got[1], want[2] / want[1], atol=3e-2, err_msg="acc/s")


@pytest.mark.parametrize("lq,lk", [(384, 384), (256, 640)])
def test_hop_reference_at_lengths_the_pallas_hop_does_not_cover(lq, lk):
    """The JAX Pallas hop covers its block only for lq <= 256 or a multiple
    of 256, and lk <= 512 or a multiple of 512 (``_hop_pallas_call`` rounds its
    grid and key loop down, vitef_tpu/parallel/sequence.py:202-215), though
    ``_hop_pallas_ok`` admits every multiple of 128: at these lengths it
    leaves query rows unwritten or keys unread. So K9's plain version is held
    here against the einsum hop ``_attend_block``, what the hop means."""
    n, h, d = 1, 2, 64
    q, k, v, state = _hop_inputs(2, n, h, lq, lk, d, initial=False)
    qpos = np.arange(lq, dtype=np.int32) + lk - lq // 2
    kpos = np.arange(lk, dtype=np.int32)
    got = RH.hop_state_reference(*(torch.from_numpy(x) for x in (q, qpos, k, v, kpos)),
                                 *(torch.from_numpy(x) for x in state), causal=True, chunk=512)
    want = _jax_hops(q / 8, qpos, [(k, v, kpos)], state, True, 512)
    for g, w, name in zip(got, want, ("m", "s", "acc")):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL, err_msg=name)


def test_hop_state_runs_its_plain_version_on_the_cpu():
    q, k, v, state = _hop_inputs(3, 1, 2, 128, 128, 64)
    args = [torch.from_numpy(x) for x in (q, np.arange(128, dtype=np.int32), k, v,
                                          np.arange(128, dtype=np.int32), *state)]
    want = RH.hop_state_reference(*args, causal=True)
    launches = RH.hop_state.launches
    for impl in ("kernel", "pallas", "auto", "plain"):
        got = RH.hop_state(*args, causal=True, impl=impl)
        for g, w in zip(got, want):
            assert torch.equal(g, w), impl
    assert RH.hop_state.launches == launches
    with pytest.raises(ValueError):
        RH.hop_state(*args, causal=True, impl="bogus")


def test_rows_operand_reads_strided_views_in_place():
    """K9's operand rule (strides multiples of 8 elements, 16-byte aligned):
    the second half of a zigzag shard and heads viewed out of a packed
    (N, L, 3E) qkv (row stride 3E = 2304) come back as the same storage; a
    view whose row stride is not a multiple of 8, or whose start is not
    16-byte aligned, comes back as a contiguous copy. The hop on each view
    equals the plain hop on its contiguous copy."""
    n, h, l, d = 1, 12, 128, 64
    rng = np.random.default_rng(7)

    def bf16(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()

    shard, packed = bf16(n, h, 2 * l, d), bf16(n, 2 * l, 3 * h * d)
    heads = [t.reshape(n, 2 * l, h, d).transpose(1, 2)[:, :, l:] for t in packed.chunk(3, -1)]
    in_place = [shard[:, :, l:], *heads]
    wide = bf16(n, h, l, d + 4)[..., :d]                     # row stride 68
    shifted = bf16(n * h * l * d + 1)[1:].view(n, h, l, d)   # 2 bytes past an aligned start
    for view in in_place:
        got = RH._rows_operand("q", view)
        assert got.data_ptr() == view.data_ptr() and got.stride() == view.stride()
    for view in (wide, shifted):
        got = RH._rows_operand("q", view)
        assert got.is_contiguous() and got.data_ptr() != view.data_ptr()
        assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    pos = torch.arange(l, dtype=torch.int32)
    _, _, _, state = _hop_inputs(8, n, h, l, l, d, initial=False)
    state = [torch.from_numpy(x) for x in state]
    for q in (*in_place, wide, shifted):
        got = RH.hop_state(q, pos + l, in_place[1], in_place[2], pos, *state, causal=True)
        want = RH.hop_state_reference(q.contiguous(), pos + l, in_place[1].contiguous(),
                                      in_place[2].contiguous(), pos, *state, causal=True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_hop_kernel_ok_routes_as_jax(monkeypatch):
    """The same branch as ``_hop_pallas_ok`` with the JAX backend read as
    "tpu", the port given a CUDA device; off CUDA the port takes the plain hop."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    pairs = [(jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16),
             (jnp.float32, torch.float32)]
    for jdt, tdt in pairs:
        for h in (1, 12, 96):
            for lseg in (64, 128, 200, 384, 1024, 4096):
                for d in (32, 64, 96, 128):
                    want = jax_seq._hop_pallas_ok(jax.ShapeDtypeStruct((1, h, lseg, d), jdt),
                                                  lseg, d)
                    q = torch.empty((1, h, 1, 1), dtype=tdt, device="meta")
                    assert RH.hop_kernel_ok(q, lseg, d, device="cuda") == want, \
                        (tdt, h, lseg, d)
                    assert not RH.hop_kernel_ok(q, lseg, d, device="cpu")


@pytest.mark.parametrize("kind", ["rope", "gqa", "dropout"])
def test_sp_forward_raises_for_what_it_does_not_compute(kind):
    """The JAX sp forward never rotates q and k and splits qkv into three
    equal parts, so rotary positions and grouped-query heads raise. Dropout
    is ported (each rank on its own stream: test_sp_dropout_streams_per_rank);
    in train mode without a generator it raises, as the JAX forward cannot
    drop without an rng."""
    fields = {k: v for k, v in LM.items() if k != "implementation"}
    fields.update({"rope": {"pos_emb_type": "rope", "pos_emb": False},
                   "gqa": {"n_kv_heads": 1},
                   "dropout": {"dropout": 0.1}}[kind])
    module = Transformer(TransformerConfig(**fields), device=torch.device("cpu"),
                         generator=torch.Generator().manual_seed(0))
    module.train(kind == "dropout")
    with pytest.raises(ValueError if kind == "dropout" else NotImplementedError):
        apply_transformer_sp(module, torch.zeros((1, 8), dtype=torch.long))


@pytest.mark.parametrize("field,value", [("pre_norm", False), ("causal", False),
                                         ("output_type", "classification")])
def test_sp_forward_raises_where_jax_asserts(field, value):
    fields = {k: v for k, v in LM.items() if k != "implementation"}
    fields[field] = value
    if value == "classification":
        fields["n_classes"] = 4
    module = Transformer(TransformerConfig(**fields), device=torch.device("cpu"),
                         generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        apply_transformer_sp(module, torch.zeros((1, 8), dtype=torch.long))


# ---------------------------------------------------------------------------
# The ring, in gloo process groups, against the JAX ring on the CPU mesh
# ---------------------------------------------------------------------------


def _mesh(sp):
    return jax_seq.build_sp_mesh(sp, devices=jax.devices()[:sp])


def _jax_ring(arrays, sp, zigzag, causal, chunk):
    """The JAX ring's output and gradients (of each shard's sum(out * g)) in
    the layout's row order."""
    perm = _layout(RING_SHAPE[2], sp, zigzag)
    q, k, v, g = (jnp.asarray(arrays[x][:, :, perm]) for x in ("q", "k", "v", "g"))

    def per_shard(q, k, v, g):
        def loss(q, k, v):
            return jnp.sum(jax_seq.ring_attention(q, k, v, causal=causal, zigzag=zigzag,
                                                  chunk=chunk) * g)
        out = jax_seq.ring_attention(q, k, v, causal=causal, zigzag=zigzag, chunk=chunk)
        return out, jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    spec = P(None, None, "sp")
    fn = jax.jit(jax.shard_map(per_shard, mesh=_mesh(sp), in_specs=(spec,) * 4,
                               out_specs=(spec, (spec,) * 3), check_vma=False))
    out, grads = fn(q, k, v, g)
    return [np.asarray(x) for x in (out, *grads)]


def _gathered(results, key):
    return np.concatenate([r[key] for r in results], axis=2 if key.count("/") else 1)


@pytest.mark.parametrize("sp,case", [(sp, case) for sp in (1, 2, 4) for case in RING_CASES[sp]],
                         ids=[f"sp{sp}-{ring_name(*case)}" for sp in (1, 2, 4)
                              for case in RING_CASES[sp]])
def test_ring_attention_matches_jax(ranks, sp, case):
    """Values (2e-5 / 1e-4) and gradients (1e-4 / 1e-4) of each rank's shard,
    gathered in the layout's row order, against the JAX ring."""
    launches, arrays = ranks
    zigzag, causal, chunk, impl = case
    want = _jax_ring(arrays, sp, zigzag, causal, chunk)
    results = launches[sp].results()
    name = ring_name(*case)
    for key, w in zip(("out", "dq", "dk", "dv"), want):
        got = np.concatenate([r[f"{name}/{key}"] for r in results], axis=2)
        atol, rtol = (ATOL, RTOL) if key == "out" else (GRAD_ATOL, GRAD_RTOL)
        np.testing.assert_allclose(got, w, atol=atol, rtol=rtol, err_msg=key)


@pytest.mark.parametrize("sp,zigzag", [(4, False), (4, True)], ids=["contiguous", "zigzag"])
def test_sp_logits_match_jax(ranks, jax_model, sp, zigzag):
    launches, arrays = ranks
    cfg = jax_model.config
    perm = _layout(arrays["tokens"].shape[1], sp, zigzag)
    fwd = jax.jit(jax.shard_map(
        lambda p, t: jax_seq.apply_transformer_sp(p, cfg, t, zigzag=zigzag, chunk=8),
        mesh=_mesh(sp), in_specs=(P(), P(None, "sp")), out_specs=P(None, "sp"),
        check_vma=False))
    want = np.asarray(fwd(jax_model.params, jnp.asarray(arrays["tokens"][:, perm])))
    got = np.concatenate([r[f"logits-{zigzag}"] for r in launches[sp].results()], axis=1)
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def _jax_sp_steps(jax_model, arrays, sp, acc, zigzag):
    tx, _ = jax_build_optimizer(SGD)
    step = jax_seq.make_sp_train_step(jax_model.config, tx, _mesh(sp), grad_clip=1.0,
                                      donate=False, zigzag=zigzag, chunk=8,
                                      grad_acc_steps=acc)
    state = jax_init_train_state(jax_model.params, tx)
    metrics = []
    for _ in range(2):
        state, m = step(state, (jnp.asarray(arrays["tokens"]), jnp.asarray(arrays["labels"])))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, from_jax_params(jax.tree.map(np.asarray, state.params))


def test_sp_dropout_streams_per_rank(ranks):
    """Two gloo ranks at sp = 2, dropout 0.5 at every site, both ranks handed
    a generator of one seed: each site's mask keeps a share within 5σ of
    0.5, one seed repeats every mask on its rank, another seed does not, and
    the two ranks draw different masks (their own streams, as the JAX
    forward folds the rank into its key)."""
    launches, _ = ranks
    results = launches[2].results()
    for rank, res in enumerate(results):
        first, again, other = (res[f"dropout/seed{i}"] for i in range(3))
        assert first.shape[0] == 2 * LM["n_layers"] + 2, first.shape  # emb, 2 a block, head
        kept = first.mean(axis=1)
        assert np.all(np.abs(kept - 0.5) < 5 * np.sqrt(0.25 / first.shape[1])), kept
        np.testing.assert_array_equal(first, again, err_msg=f"rank {rank}")
        assert not np.array_equal(first, other), rank
    assert not np.array_equal(results[0]["dropout/seed0"], results[1]["dropout/seed0"])


@pytest.mark.parametrize("acc,zigzag", STEP_CASES[4], ids=["acc1-contiguous", "acc2-zigzag"])
def test_sp_train_step_matches_jax(ranks, jax_model, acc, zigzag):
    """Two SGD (momentum 0.9) steps, clip 1.0, at sp = 4: the loss and
    grad_norm of each step and every parameter after them, on every rank."""
    launches, arrays = ranks
    metrics, params = _jax_sp_steps(jax_model, arrays, 4, acc, zigzag)
    name = f"step-acc{acc}-{zigzag}"
    for rank, res in enumerate(launches[4].results()):
        for i, m in enumerate(metrics):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(res[f"{name}/{key}{i}"], m[key], rtol=1e-4,
                                           err_msg=f"rank {rank} step {i} {key}")
        assert metrics[0]["grad_norm"] > 1.0, "the clip never bound"
        for pname, want in params.items():
            np.testing.assert_allclose(res[f"{name}/param/{pname}"], want.numpy(),
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=f"rank {rank} {pname}")


def test_sp1_in_a_one_rank_group(ranks, jax_model):
    """sp = 1 in a one-rank gloo group (``build_sp_group`` makes it): the
    logits against the JAX forward and two zigzag train steps against the
    port's ordinary train step on the same weights (the ring cases at sp = 1
    are in ``test_ring_attention_matches_jax``)."""
    launches, arrays = ranks
    (res,) = launches[1].results()
    want = np.asarray(jax.jit(jax_model.apply)(jax_model.params, jnp.asarray(arrays["tokens"])))
    np.testing.assert_allclose(res["logits-False"], want, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    for i in range(2):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(res[f"step-acc1-True/{key}{i}"], res[f"ordinary/{key}{i}"],
                                       rtol=1e-5, err_msg=f"step {i} {key}")
    for key in res:
        if key.startswith("ordinary/param/"):
            np.testing.assert_allclose(res[key.replace("ordinary", "step-acc1-True")], res[key],
                                       atol=1e-5, rtol=1e-5, err_msg=key)
