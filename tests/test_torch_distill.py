"""The port's speculative-pair tools against the JAX package's, on the CPU.

``vitef_tpu_torch.tools.distill_spec_pair`` against ``tools/distill_spec_pair.py``
(loaded by path): the Markov draws bit for bit at the tool's own sizes;
one ``train_target`` step and one ``distill_draft`` step of a small decoder
(2 layers, E = 64, 4 heads, float32) from the same weights against the JAX
tool's own steps (``optax.adamw``), at sizes patched small in both modules;
a pair saved by the port read back by the JAX ``load_trained_pair``
(``tools/profile_speculative.py``, through ``_unflatten_like``) and by the
port's, with equal logits; the tools importing no ``jax``; and the port's
``profile_rows`` on a tiny pair.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import vitef_tpu.config as jax_config
from vitef_tpu.models import build_model as jax_build_model
from vitef_tpu_torch.models import build_model, from_jax_params
from vitef_tpu_torch.tools import distill_spec_pair as D
from vitef_tpu_torch.tools import profile_speculative as P

ROOT = Path(__file__).resolve().parents[1]
DECODER = {"implementation": "transformer", "vocab_size": 96, "emb_type": "dict",
           "emb_dim": 64, "n_heads": 4, "n_layers": 2, "seq_len": 64, "causal": True,
           "pre_norm": True, "weight_tying": True, "output_type": "sequence_to_sequence",
           "attn_bias": True, "ffn_bias": True, "norm_bias": True,
           "compute_dtype": "float32"}
SMALL = {"BATCH": 4, "SEQ": 32, "EFF_VOCAB": 64}   # the Markov sizes of the step tests


def _load(name: str):
    """The JAX package's tool ``tools/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_distill():
    return _load("distill_spec_pair")


@pytest.fixture
def small(jax_distill, monkeypatch):
    """Both tools' Markov sizes patched to SMALL."""
    for module in (jax_distill, D):
        for name, value in SMALL.items():
            monkeypatch.setattr(module, name, value)
    return jax_distill


def _pair(seed: int):
    """(JAX model, port model) of DECODER holding the same parameters."""
    jm = jax_build_model(DECODER, key=jax.random.key(seed))
    tm = build_model(DECODER, device="cpu")
    tm.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jm.params)))
    return jm, tm


# Adam's first step moves each parameter by lr g / (|g| + 1e-8): where the
# gradient is rounding noise, both packages hand it noise of their own
# (their float32 sums run in other orders), which the normalised step turns
# into moves of up to lr. An element whose gradient lies below NOISE of its
# tensor's largest (the key bias's, exactly 0 in real arithmetic, since it
# shifts every score of a query row alike; ~1e-9 entries of the weights at
# these sizes) is held to the 2 lr that can separate the two steps.
NOISE = 1e-5


def _assert_params(module, params, grads, lr: float):
    """Every parameter of ``module`` against the JAX tree ``params`` at
    1e-5 / 1e-4, but where the JAX gradient ``grads`` is noise (NOISE):
    there within 2 lr."""
    ref = from_jax_params(jax.tree.map(np.asarray, params))
    grad = from_jax_params(jax.tree.map(np.asarray, grads))
    for name, p in module.named_parameters():
        ours, theirs, g = p.detach().numpy(), ref[name].numpy(), np.abs(grad[name].numpy())
        noise = g < NOISE * g.max()
        np.testing.assert_allclose(ours[noise], theirs[noise], atol=2 * lr, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(ours[~noise], theirs[~noise], atol=1e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_markov_batches_match_jax_bit_for_bit(jax_distill, seed):
    ours = list(D.markov_batches(3, seed=seed))
    theirs = list(jax_distill.markov_batches(3, seed=seed))
    assert len(ours) == len(theirs) == 3
    for (x, y), (jx, jy) in zip(ours, theirs):
        assert x.shape == y.shape == (D.BATCH, D.SEQ) and x.dtype == torch.int64
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        assert int(x.max()) < D.EFF_VOCAB


def test_train_target_step_matches_optax(small):
    jm, tm = _pair(0)
    x, y = next(small.markov_batches(1, seed=1))

    def loss(params):
        return optax.softmax_cross_entropy_with_integer_labels(jm.apply(params, x), y).mean()

    want_loss, grads = jax.value_and_grad(loss)(jm.params)
    want = small.train_target(jm, n_steps=1, lr=3e-4)
    losses = D.train_target(tm, n_steps=1, lr=3e-4)
    assert len(losses) == 1
    np.testing.assert_allclose(losses[0], float(want_loss), rtol=1e-5)
    _assert_params(tm.module, want, grads, 3e-4)


def test_distill_draft_step_matches_optax(small):
    jt, tt = _pair(0)
    jd, td = _pair(7)
    x, _ = next(small.markov_batches(1, seed=2))
    t_logp = jax.nn.log_softmax(jt.apply(jt.params, x).astype(jnp.float32))

    def kl(params):
        d_logp = jax.nn.log_softmax(jd.apply(params, x).astype(jnp.float32))
        return jnp.mean(jnp.sum(jnp.exp(t_logp) * (t_logp - d_logp), axis=-1))

    want_kl, grads = jax.value_and_grad(kl)(jd.params)
    want = small.distill_draft(jd, jt, jt.params, n_steps=1, lr=6e-4)
    start = {n: p.detach().clone() for n, p in tt.module.named_parameters()}
    kls = D.distill_draft(td, tt, n_steps=1, lr=6e-4)
    assert len(kls) == 1 and kls[0] > 0
    np.testing.assert_allclose(kls[0], float(want_kl), rtol=1e-5)
    _assert_params(td.module, want, grads, 6e-4)
    for name, p in tt.module.named_parameters():  # the target is not trained
        assert torch.equal(p.detach(), start[name]), name


def test_saved_pair_loads_in_both_packages(tmp_path, monkeypatch):
    _, tt = _pair(3)
    _, td = _pair(4)
    with torch.no_grad():  # weights of their own, not the JAX draws'
        for p in [*tt.module.parameters(), *td.module.parameters()]:
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    D.save_pair(tt, td, tmp_path / "spec_pair")
    assert sorted(f.name for f in (tmp_path / "spec_pair").iterdir()) == ["draft.npz",
                                                                         "target.npz"]
    monkeypatch.setattr(jax_config, "MODEL_DIR", tmp_path)
    jax_profile = _load("profile_speculative")
    jt, jd = jax_profile.load_trained_pair(jax_build_model(DECODER, key=jax.random.key(0)),
                                           jax_build_model(DECODER, key=jax.random.key(1)))
    rt, rd = P.load_trained_pair(build_model(DECODER, device="cpu"),
                                 build_model(DECODER, device="cpu"), tmp_path / "spec_pair")
    toks = np.random.default_rng(5).integers(0, DECODER["vocab_size"], size=(2, 24))
    for ours, back, theirs in ((tt, rt, jt), (td, rd, jd)):
        with torch.no_grad():
            logits = ours.apply(torch.from_numpy(toks)).numpy()
            again = back.apply(torch.from_numpy(toks)).numpy()
        np.testing.assert_array_equal(again, logits)
        np.testing.assert_allclose(logits, np.asarray(theirs.apply(theirs.params, toks)),
                                   atol=1e-4, rtol=1e-4)


def test_tools_import_no_jax():
    code = ("import sys; import vitef_tpu_torch.tools.distill_spec_pair, "
            "vitef_tpu_torch.tools.profile_speculative; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'vitef_tpu', "
            "'optax')); assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_profile_rows_on_a_tiny_pair():
    """Every row of the JAX tool's, in its order; greedy speculative rows
    equal plain greedy decoding (float32), the self-draft accepts every
    proposal."""
    torch.set_num_threads(1)
    _, tt = _pair(0)
    _, td = _pair(7)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, 96, size=(1, 8)))
    rows = P.profile_rows(tt, td, prompt, 12)
    assert [r["name"] for r in rows] == [
        "plain greedy", "plain T=0.8", "draft-2L g=4", "self-draft g=4",
        "draft-2L T=0.8 g=2", "draft-2L T=0.8 g=3", "draft-2L T=0.8 g=4",
        "draft-2L T=0.8 g=6"]
    for row in rows:
        assert len(row["tokens"]) == 12 and row["ms"] > 0
    by_name = {r["name"]: r for r in rows}
    assert by_name["draft-2L g=4"]["greedy_equal"] and by_name["self-draft g=4"]["greedy_equal"]
    assert by_name["self-draft g=4"]["alpha"] == 1.0
    for row in rows[2:]:
        assert 0 <= row["accepted"] <= row["drafted"] and row["rounds"] > 0


def test_mains_train_save_and_profile_on_cpu(tmp_path, monkeypatch):
    """``distill_spec_pair.main`` and ``profile_speculative.main`` as a user
    runs them with ``--device cpu`` (``--trained``, then ``--int8``), on the
    tiny decoder for a few steps: the pair lands under MODEL_DIR/spec_pair
    and the profile reads it back."""
    torch.set_num_threads(1)

    def tiny(layers, seed, device):
        return build_model({**DECODER, "n_layers": layers, "seed": seed, "seq_len": 128},
                           device=device)

    train, distill, rows = D.train_target, D.distill_draft, P.profile_rows
    for module in (D, P):
        monkeypatch.setattr(module, "gpt2ish", tiny)
        monkeypatch.setattr(module, "MODEL_DIR", tmp_path)
    for name, value in SMALL.items():
        monkeypatch.setattr(D, name, value)
    monkeypatch.setattr(D, "train_target", lambda model: train(model, n_steps=2))
    monkeypatch.setattr(D, "distill_draft", lambda draft, target: distill(draft, target,
                                                                          n_steps=2))
    monkeypatch.setattr(P, "EFF_VOCAB", SMALL["EFF_VOCAB"])
    monkeypatch.setattr(P, "profile_rows", lambda *a, **k: rows(*a, 6, **k))
    D.main(["--device", "cpu"])
    assert sorted(f.name for f in (tmp_path / "spec_pair").iterdir()) == ["draft.npz",
                                                                        "target.npz"]
    for argv in (["--trained"], ["--trained", "--int8"]):
        got = P.main(["--device", "cpu", *argv])
        assert len(got) == 8 and all(len(r["tokens"]) == 6 for r in got)
        assert got[3]["name"] == "self-draft g=4" and got[3]["alpha"] == 1.0
