"""The port's continuous-batching server and the GPT-2 serving apps, on the CPU.

``DecodeServer`` (greedy, float32, the tiny decoder of tests/test_serving.py
and a tiny GQA/RoPE Llama) against the port's own ``generate()`` and against
the JAX ``DecodeServer`` for the same requests; a window of decode ticks
against the JAX window from one shared cache; the apps' ``run`` on GPT-2
base (built once, random weights) on ``device="cpu"``; ``make_cli`` against
the JAX package's.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vitef_tpu.models import build_model as jax_build_model
from vitef_tpu.models import serving as JS
from vitef_tpu.utils.cli import make_cli as jax_make_cli
from vitef_tpu_torch.apps.gpt2 import sample as sample_app
from vitef_tpu_torch.apps.gpt2 import serve as serve_app
from vitef_tpu_torch.models import build_model, cache_from_jax, from_jax_params
from vitef_tpu_torch.models import serving as S
from vitef_tpu_torch.utils.cli import make_cli

DECODER = {"implementation": "transformer", "vocab_size": 48, "emb_type": "dict",
           "emb_dim": 16, "n_heads": 2, "n_layers": 2, "seq_len": 48, "causal": True,
           "pre_norm": True, "weight_tying": True, "output_type": "sequence_to_sequence",
           "attn_bias": True, "ffn_bias": True, "norm_bias": True, "cls_token": False,
           "pos_emb": True, "attn_impl": "xla", "norm_impl": "xla"}
TINY_LLAMA = {"implementation": "llama", "model_name": "tiny", "pretrained": False,
              "seq_len": 48}


@pytest.fixture(autouse=True)
def one_thread():
    """Decoding is hundreds of tiny torch ops: on a CPU that the test workers
    share, torch's intra-op thread pool costs more than their arithmetic."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pair(config, seed=0):
    """(JAX model, port model) of one config holding the same parameters."""
    jm = jax_build_model(config, key=jax.random.key(seed))
    tm = build_model(config, device="cpu")
    tm.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jm.params)))
    return jm, tm


@pytest.fixture(scope="module")
def decoder():
    return pair(DECODER)


def requests(seed, n, vocab, plen=(3, 14), new=(2, 9)):
    rng = np.random.default_rng(seed)
    return [S.Request(prompt=rng.integers(0, vocab, size=(int(rng.integers(*plen)),)).tolist(),
                      max_new_tokens=int(rng.integers(*new))) for _ in range(n)]


def alone(tm, prompt, max_new, **kw):
    """The port's standalone greedy generate() of one prompt."""
    out = tm.generate(torch.tensor([prompt]), max_new, temperature=0.0, **kw)
    return out[0].tolist()


def test_single_request_matches_generate(decoder):
    _, tm = decoder
    prompt = np.random.default_rng(0).integers(0, 48, size=(7,)).tolist()
    srv = S.DecodeServer(tm.module, tm.config, n_slots=4, bucket=8)
    (req,) = srv.serve([S.Request(prompt=prompt, max_new_tokens=6)])
    assert req.done and req.tokens == alone(tm, prompt, 6)


def test_more_requests_than_slots_recycle(decoder):
    _, tm = decoder
    reqs = requests(1, 8, 48)
    srv = S.DecodeServer(tm.module, tm.config, n_slots=3, bucket=8)
    srv.serve(reqs)
    assert sorted({r.slot for r in reqs}) == [0, 1, 2]
    for req in reqs:
        assert req.done and req.tokens == alone(tm, req.prompt, req.max_new_tokens)
    # the pool shares ticks: fewer than one request after another would take
    assert srv.steps < sum(r.max_new_tokens for r in reqs)


def test_eos_frees_a_slot_early(decoder):
    _, tm = decoder
    reqs = requests(2, 5, 48, new=(8, 9))
    eos = alone(tm, reqs[0].prompt, 8)[2]  # request 0 emits it as its third token
    srv = S.DecodeServer(tm.module, tm.config, n_slots=2, bucket=8, eos_token_id=eos)
    srv.serve(reqs)
    assert reqs[0].tokens[-1] == eos and len(reqs[0].tokens) <= 3
    for req in reqs:
        want = alone(tm, req.prompt, 8, eos_token_id=eos)
        if eos in want:
            want = want[:want.index(eos) + 1]
        assert req.done and req.tokens == want


@pytest.mark.parametrize("config", [DECODER, TINY_LLAMA], ids=["gpt2_like", "llama_gqa_rope"])
def test_outputs_equal_jax_server(config):
    jm, tm = pair(config)
    reqs = requests(3, 6, jm.config.vocab_size)
    jreqs = [JS.Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs]
    JS.DecodeServer(jm.params, jm.config, n_slots=3, bucket=8).serve(jreqs)
    srv = S.DecodeServer(tm.module, tm.config, n_slots=3, bucket=8)
    srv.serve(reqs)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]


def test_window_matches_jax_from_shared_cache(decoder):
    """One window of 4 ticks over 3 slots at different positions (one
    inactive, one reaching its budget mid-window), from one cache."""
    jm, tm = decoder
    cfg = jm.config
    rng = np.random.default_rng(4)
    shape = (3, cfg.n_kv_heads, 20, cfg.head_dim)
    jcache = [{"k": jnp.asarray(rng.normal(size=shape), jnp.float32),
               "v": jnp.asarray(rng.normal(size=shape), jnp.float32)}
              for _ in range(cfg.n_layers)]
    cache = cache_from_jax(jax.tree.map(np.asarray, jcache))
    token, pos = np.array([5, 9, 11]), np.array([6, 2, 10])
    active, limit = np.array([True, False, True]), np.array([15, 15, 12])
    window = JS._make_window_fn(cfg, 0.0, None, None, None, 4)
    jcache, jtoken, jpos, jtoks = window(jm.params, jcache, jnp.asarray(token, jnp.int32),
                                         jnp.asarray(pos, jnp.int32), jnp.asarray(active),
                                         jnp.asarray(limit, jnp.int32), jax.random.key(0))
    with torch.inference_mode():
        token_t, pos_t, toks = S._run_window(
            tm.module, tm.config, cache, torch.tensor(token), torch.tensor(pos),
            torch.tensor(active), torch.tensor(limit), None, window=4, temperature=0.0,
            top_k=None, top_p=None, eos_id=None)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(pos_t.numpy(), [10, 2, 12])
    for got, want in zip(cache, jcache):
        np.testing.assert_allclose(got["k"].numpy(), np.asarray(want["k"]), atol=1e-5,
                                   rtol=1e-4)


def test_unported_options_and_oversized_requests_raise(decoder):
    """The multi-device server (mesh=) is the one option still unported; the
    prefix cache and speculative windows run (tests/test_torch_serving_spec.py
    holds them against the JAX server); oversized requests raise."""
    _, tm = decoder
    srv = S.DecodeServer(tm.module, tm.config, n_slots=2, bucket=8)
    handle = srv.register_prefix([1, 2, 3])
    (req,) = srv.serve([S.Request(prompt=[4, 5], max_new_tokens=3, prefix=handle)])
    assert req.done and req.tokens == alone(tm, [1, 2, 3, 4, 5], 3)
    spec = S.DecodeServer(tm.module, tm.config, n_slots=2, bucket=8, draft_params=tm)
    (req,) = spec.serve([S.Request(prompt=[4, 5], max_new_tokens=3)])
    assert req.done and req.tokens == alone(tm, [4, 5], 3) and spec.spec_rounds > 0
    with pytest.raises(NotImplementedError):
        S.DecodeServer(tm.module, tm.config, n_slots=2, mesh=object())
    for prompt, max_new in (([1] * 40, 9), ([], 3), ([1, 2], 0)):  # max_len is 48
        with pytest.raises(ValueError, match="does not fit"):
            srv.admit(S.Request(prompt=prompt, max_new_tokens=max_new), 0)


# ---------------------------------------------------------------------------
# The apps, on GPT-2 base
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gpt2_once():
    """build_model for the apps, building each config once for the module."""
    built = {}

    def build(config, device):
        key = (repr(sorted(config.items())), str(device))
        if key not in built:
            built[key] = build_model(config, device=device)
        return built[key]

    return build


@pytest.fixture
def apps(monkeypatch, gpt2_once):
    monkeypatch.setattr(sample_app, "build_model", gpt2_once)
    monkeypatch.setattr(serve_app, "build_model", gpt2_once)


def test_sample_run(apps, capsys):
    kw = dict(token_ids=[464, 3280, 318], max_new_tokens=4, pretrained=False,
              compute_dtype="float32", device="cpu")
    greedy = sample_app.run(temperature=0.0, eos=False, **kw)
    assert len(greedy) == 4 and all(0 <= t < 50257 for t in greedy)
    assert f"'new_ids': {greedy}" in capsys.readouterr().out
    sampled = sample_app.run(top_k=40, temperature=0.8, **kw)
    assert sampled == sample_app.run(top_k=40, temperature=0.8, **kw)  # one seed
    with pytest.raises(SystemExit, match="token_ids"):
        sample_app.run(prompt="The meaning of life", device="cpu")
    with pytest.raises(SystemExit, match="top_k"):  # the speculative mode's refusal
        sample_app.run(draft_model_name="base", top_k=40, **kw)


def test_serve_run_modes_agree(apps, capsys):
    kw = dict(demo=4, n_slots=4, max_new_tokens=8, max_len=128, pretrained=False,
              compute_dtype="float32", device="cpu")
    outs = {}
    for mode in ("wave", "continuous", "auto"):
        capsys.readouterr()
        reqs = serve_app.run(mode=mode, **kw)
        lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
        assert [line["tokens"] for line in lines] == [r.tokens for r in reqs]
        outs[mode] = [r.tokens for r in reqs]
        for req in reqs:
            assert req.done and 1 <= len(req.tokens) <= req.max_new_tokens
    assert outs["wave"] == outs["continuous"] == outs["auto"]
    reqs = serve_app.run(prefix="3,1,4", **kw)  # auto takes the slot server's prefix store
    assert all(r.done and r.prefix == 0 and 1 <= len(r.tokens) <= r.max_new_tokens
               for r in reqs)
    with pytest.raises(SystemExit, match="prefix"):
        serve_app.run(prefix="3,1,4", mode="wave", **kw)


@pytest.mark.parametrize("argv", [
    ["run", "--token_ids", "[464, 3280, 318]", "--top_k", "40", "--temperature", "0.8"],
    ["run", "--demo", "16", "--n_slots", "4", "--mode", "wave", "--eos", "False"],
    ["run", "--kv_cache_dtype=int8", "--top_p", "null", "--prefix", "3,1,4", "--pretrained"],
    ["run", "--eos", "off", "--x", "Yes", "--y", "~", "--z", "hello"],
])
def test_make_cli_parses_as_jax(argv):
    def echo(**kw):
        return kw

    assert make_cli({"run": echo}, argv) == jax_make_cli({"run": echo}, argv)
