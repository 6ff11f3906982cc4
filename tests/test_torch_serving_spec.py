"""The port's speculative server and prefix cache against the JAX package's, on the CPU.

``DecodeServer(draft_params=...)`` against the JAX speculative server (each
request's tokens, ``spec_rounds`` and ``spec_committed``, co-tenants and
recycled slots), an EOS inside an accepted run, the port's plain server and
its refusals; ``register_prefix`` against the JAX server under the same
prefixes (tokens and ``prefill_tokens_saved``, prefix and plain requests
co-tenant) and against ``generate()`` on [prefix ++ prompt], post-norm and
GQA/RoPE, and on int8 weights; ``sample --draft_model_name`` and ``serve
--prefix`` on tiny models. Greedy, float32, token streams compared exactly.
"""

import json
import logging

import numpy as np
import pytest

import jax
import torch

from vitef_tpu.models import build_model as jax_build_model
from vitef_tpu.models import serving as JS
from vitef_tpu_torch.apps.gpt2 import sample as sample_app
from vitef_tpu_torch.apps.gpt2 import serve as serve_app
from vitef_tpu_torch.models import build_model, from_jax_params
from vitef_tpu_torch.models import serving as S

DECODER = {"implementation": "transformer", "vocab_size": 48, "emb_type": "dict",
           "emb_dim": 16, "n_heads": 2, "n_layers": 2, "seq_len": 64, "causal": True,
           "pre_norm": True, "weight_tying": True, "output_type": "sequence_to_sequence",
           "attn_bias": True, "ffn_bias": True, "norm_bias": True, "cls_token": False,
           "pos_emb": True, "attn_impl": "xla", "norm_impl": "xla"}
DRAFT = {**DECODER, "n_layers": 1, "emb_dim": 8, "n_heads": 1}
POST_NORM = {**DECODER, "pre_norm": False}
TINY_LLAMA = {"implementation": "llama", "model_name": "tiny", "pretrained": False,
              "seq_len": 64}


def pair(config, seed):
    """(JAX model, port model) of one config holding the same parameters."""
    jm = jax_build_model(config, key=jax.random.key(seed))
    tm = build_model(config, device="cpu")
    tm.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jm.params)))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return {"target": pair(DECODER, 0), "draft": pair(DRAFT, 7),
            "post_norm": pair(POST_NORM, 2), "llama": pair(TINY_LLAMA, 0)}


@pytest.fixture(autouse=True)
def one_thread():
    """Serving is thousands of tiny torch ops: on a shared CPU, the thread
    pool's hand-offs cost more than their arithmetic."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def requests(seed, n, vocab, plen=(3, 14), new=(2, 11), module=S):
    rng = np.random.default_rng(seed)
    return [module.Request(prompt=rng.integers(0, vocab, size=(int(rng.integers(*plen)),))
                           .tolist(), max_new_tokens=int(rng.integers(*new)))
            for _ in range(n)]


def alone(tm, prompt, max_new, module=None, **kw):
    """The port's standalone greedy generate() of one prompt."""
    from vitef_tpu_torch.models.generation import generate

    out = generate(module or tm.module, tm.config, torch.tensor([prompt]), max_new,
                   temperature=0.0, **kw)
    return out[0].tolist()


def spec_server(models, **kw):
    _, tm = models["target"]
    args = dict(n_slots=3, bucket=8, draft_params=models["draft"][1], gamma=3, max_len=48)
    args.update(kw)
    return S.DecodeServer(tm.module, tm.config, **args)


def test_spec_server_equals_jax_and_generate(models):
    """9 mixed requests through 3 slots (co-tenant windows, recycled slots):
    each stream, spec_rounds and spec_committed equal the JAX server's, and
    each stream equals generate() alone."""
    jm, tm = models["target"]
    jd, _ = models["draft"]
    reqs = requests(1, 9, 48)
    jreqs = [JS.Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in reqs]
    jsrv = JS.DecodeServer(jm.params, jm.config, n_slots=3, bucket=8, max_len=48,
                           draft_params=jd.params, draft_cfg=jd.config, gamma=3)
    jsrv.serve(jreqs)
    srv = spec_server(models)
    srv.serve(reqs)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert (srv.spec_rounds, srv.spec_committed, srv.steps) == (
        jsrv.spec_rounds, jsrv.spec_committed, jsrv.steps)
    assert sorted({r.slot for r in reqs}) == [0, 1, 2]
    for req in reqs:
        assert req.done and req.tokens == alone(tm, req.prompt, req.max_new_tokens)


def test_spec_server_eos_inside_a_window(models):
    """An EOS inside an accepted run cuts the commit on the device: the
    stream stops at its first EOS and the freed slot serves the queue."""
    _, tm = models["target"]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 48, size=(6,)).tolist() for _ in range(3)]
    first = alone(tm, prompts[0], 10)
    eos = first[4]
    reqs = [S.Request(prompt=p, max_new_tokens=10) for p in prompts]
    spec_server(models, n_slots=1, eos_token_id=eos).serve(reqs)
    assert reqs[0].tokens == first[:first.index(eos) + 1]
    for req, p in zip(reqs, prompts):
        full = alone(tm, p, 10)
        assert req.done and req.tokens == (full[:full.index(eos) + 1] if eos in full else full)


def test_spec_server_equals_plain_server(models):
    """Speculation changes the cost, never the tokens: the plain server and
    the speculative one, its draft given as a Model or as module + config,
    serve one workload alike; a self-draft commits gamma + 1 tokens a round."""
    _, tm = models["target"]
    _, td = models["draft"]
    plain = requests(4, 6, 48, plen=(3, 12), new=(2, 9))
    S.DecodeServer(tm.module, tm.config, n_slots=2, bucket=8, max_len=48).serve(plain)
    for draft in ({"draft_params": td}, {"draft_params": td.module, "draft_cfg": td.config}):
        reqs = requests(4, 6, 48, plen=(3, 12), new=(2, 9))
        spec_server(models, n_slots=2, **draft).serve(reqs)
        assert [r.tokens for r in reqs] == [r.tokens for r in plain]
    (req,) = reqs = [S.Request(prompt=[5, 1, 7, 2], max_new_tokens=13)]
    srv = spec_server(models, n_slots=1, draft_params=tm, harvest_every=2)
    srv.serve(reqs)
    assert req.tokens == alone(tm, req.prompt, 13)
    assert (srv.spec_committed, srv.spec_rounds) == (12, 4)  # 3 rounds of 4, one idle


def test_spec_server_refusals(models):
    _, tm = models["target"]
    _, td = models["draft"]
    srv = spec_server(models)
    srv.register_prefix([1, 2, 3])
    with pytest.raises(ValueError, match="does not compose"):
        srv.admit(S.Request(prompt=[1, 2, 3], max_new_tokens=2, prefix=0), 0)
    with pytest.raises(ValueError, match="does not fit"):  # 40 + 6 + gamma 3 > 48
        srv.admit(S.Request(prompt=[1] * 40, max_new_tokens=6), 0)
    assert not any(srv.active)
    small_vocab = build_model({**DRAFT, "vocab_size": 40}, device="cpu")
    for kw, match in (({"draft_params": td, "temperature": 0.8}, "greedy"),
                      ({"draft_params": small_vocab}, "vocabulary"),
                      ({"draft_params": td.module}, "draft_cfg"),
                      ({"draft_params": td, "gamma": 0}, "gamma")):
        with pytest.raises(ValueError, match=match):
            S.DecodeServer(tm.module, tm.config, n_slots=2, **kw)


@pytest.mark.parametrize("name", ["post_norm", "llama"], ids=["post_norm", "llama_gqa_rope"])
def test_prefix_cache_equals_jax_and_generate(models, name):
    """Two registered prefixes and plain requests share 2 slots: each stream
    and prefill_tokens_saved equal the JAX server's under the same prefixes,
    and each stream equals generate() on [prefix ++ prompt]."""
    jm, tm = models[name]
    vocab = tm.config.vocab_size
    rng = np.random.default_rng(6)
    prefixes = [rng.integers(0, vocab, size=(n,)).tolist() for n in (6, 12)]
    prompts = [rng.integers(0, vocab, size=(int(rng.integers(2, 9)),)).tolist()
               for _ in range(6)]
    picks = [None, 0, 1] * 2
    servers = (JS.DecodeServer(jm.params, jm.config, n_slots=2, bucket=8),
               S.DecodeServer(tm.module, tm.config, n_slots=2, bucket=8))
    served = []
    for srv, mod in zip(servers, (JS, S)):
        handles = [srv.register_prefix(p) for p in prefixes]
        reqs = [mod.Request(prompt=p, max_new_tokens=5,
                            prefix=None if pick is None else handles[pick])
                for p, pick in zip(prompts, picks)]
        srv.serve(reqs)
        served.append(reqs)
    assert [r.tokens for r in served[1]] == [r.tokens for r in served[0]]
    assert servers[1].prefill_tokens_saved == servers[0].prefill_tokens_saved == 2 * (6 + 12)
    for req, pick in zip(served[1], picks):
        full = req.prompt if pick is None else prefixes[pick] + req.prompt
        assert req.done and req.tokens == alone(tm, full, 5)


def test_prefix_cache_int8(models):
    """On int8 weights (Model.quantize_int8), prefix-cached admissions give
    the int8 generate() of [prefix ++ prompt]."""
    _, tm = models["llama"]
    qmodule = tm.quantize_int8()
    prefix = list(range(40, 49))
    srv = S.DecodeServer(qmodule, tm.config, n_slots=2, bucket=8)
    handle = srv.register_prefix(prefix)
    reqs = requests(7, 4, tm.config.vocab_size, plen=(2, 9), new=(3, 7))
    for req in reqs:
        req.prefix = handle
    srv.serve(reqs)
    for req in reqs:
        assert req.tokens == alone(tm, prefix + req.prompt, req.max_new_tokens, module=qmodule)


def test_sample_app_draft_mode(models, monkeypatch, caplog):
    """``sample run --draft_model_name``: the draft built from seed + 1, the
    target's greedy tokens, the stats logged; the flags it would ignore
    refused. The apps' GPT-2 presets are swapped for the tiny decoders."""
    built = []

    def tiny(config, device):
        built.append((config["model_name"], config["seed"]))
        return {"medium": models["target"][1], "base": models["draft"][1]}[config["model_name"]]

    monkeypatch.setattr(sample_app, "build_model", tiny)
    kw = dict(token_ids=[4, 9, 2, 30], model_name="medium", draft_model_name="base",
              max_new_tokens=8, eos=False, seed=3, device="cpu")
    with caplog.at_level(logging.INFO, logger=sample_app.__name__):
        greedy = sample_app.run(temperature=0.0, **kw)
    assert built == [("medium", 3), ("base", 4)]
    assert greedy == alone(models["target"][1], [4, 9, 2, 30], 8)
    assert "speculative:" in caplog.text and "drafted" in caplog.text
    sampled = sample_app.run(temperature=0.8, **kw)
    assert len(sampled) == 8 and sampled == sample_app.run(temperature=0.8, **kw)
    for flag in ({"top_k": 40}, {"top_p": 0.9}, {"kv_cache_dtype": "int8"}):
        with pytest.raises(SystemExit, match=next(iter(flag))):
            sample_app.run(**flag, **kw)


def test_serve_app_prefix(models, capsys):
    """``serve run --prefix`` on the tiny Llama preset: ``auto`` serves
    continuously, every stream is generate() on [prefix ++ prompt]; wave
    mode refuses the flag."""
    kw = dict(implementation="llama", model_name="tiny", demo=4, n_slots=2, max_len=96,
              max_new_tokens=8, pretrained=False, compute_dtype="float32", device="cpu",
              prefix="3,1,4,1,5")
    reqs = serve_app.run(**kw)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["tokens"] for line in lines] == [r.tokens for r in reqs]
    model = build_model({**TINY_LLAMA, "seq_len": 96, "compute_dtype": "float32"}, device="cpu")
    for req in reqs:
        assert req.prefix == 0
        assert req.tokens == alone(model, [3, 1, 4, 1, 5] + req.prompt, req.max_new_tokens)
    with pytest.raises(SystemExit, match="wave"):
        serve_app.run(**{**kw, "mode": "wave"})
