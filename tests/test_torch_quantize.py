"""The port's weight-only int8 serving weights vs the JAX package, on the CPU.

The same weights (the JAX model's, carried into the port with
``from_jax_params``) go through both packages' ``quantize_decode_params``:
the int8 tables and float32 scales must be bit-equal, transposed where the
layouts differ (dense linears, the tied and the untied head, the MoE expert
stacks). Then greedy ``generate`` with int8 weights token for token against
the JAX ``quantize_int8`` model (float32 compute: only the order of float32
sums differs, and the tokens are argmaxes), the port's ``DecodeServer`` on
int8 weights against its own ``generate``, the serve command line's
``run(quantize="int8")`` on the CPU against the JAX app's output on the same
weights, and the refusal of int8 expert stacks by the sparse MoE path.
"""

import copy
import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apps.gpt2 import serve as jax_serve_app
from vitef_tpu.models import build_model as jax_build_model
from vitef_tpu.models import quantize as JQ
from vitef_tpu.parallel import moe as jax_moe
from vitef_tpu_torch.apps.gpt2 import serve as serve_app
from vitef_tpu_torch.models import build_model, from_jax_params
from vitef_tpu_torch.models import generation as G
from vitef_tpu_torch.models import quantize as Q
from vitef_tpu_torch.models import serving as S
from vitef_tpu_torch.models.convert import _flatten, to_jax_params
from vitef_tpu_torch.parallel import moe as M

DECODER = {"implementation": "transformer", "vocab_size": 48, "emb_type": "dict",
           "emb_dim": 16, "n_heads": 2, "n_layers": 2, "seq_len": 48, "causal": True,
           "pre_norm": True, "weight_tying": True, "output_type": "sequence_to_sequence",
           "attn_bias": True, "ffn_bias": True, "norm_bias": True, "cls_token": False,
           "pos_emb": True, "attn_impl": "xla", "norm_impl": "xla"}
# Head width 128 with Llama's options: GQA 2:1, RoPE, rms norm, swiglu, untied.
LLAMA_D128 = {"implementation": "transformer", "vocab_size": 512, "emb_type": "dict",
              "emb_dim": 256, "n_heads": 2, "n_kv_heads": 1, "n_layers": 2, "seq_len": 96,
              "causal": True, "pre_norm": True, "weight_tying": False,
              "output_type": "sequence_to_sequence", "attn_bias": False, "ffn_bias": False,
              "ffn_type": "swiglu", "ffn_dim": 512, "norm": "rms", "norm_bias": False,
              "norm_eps": 1e-5, "pos_emb_type": "rope", "rope_theta": 500000.0,
              "cls_token": False, "attn_impl": "xla", "norm_impl": "xla"}
TINY_MOE = {"implementation": "moe", "model_name": "tiny", "seq_len": 48}
CONFIGS = {"tied": DECODER, "untied": {**DECODER, "weight_tying": False},
           "llama_d128": LLAMA_D128, "moe": TINY_MOE}


def pair(config, seed=0):
    """(JAX model, port model) of one config holding the same parameters."""
    jm = jax_build_model(config, key=jax.random.key(seed))
    tm = build_model(config, device="cpu")
    tm.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jm.params)))
    return jm, tm


@pytest.mark.parametrize("name", list(CONFIGS))
def test_quantize_decode_params_bit_equal_to_jax(name):
    """Every tensor of the quantized state: int8 tables and float32 scales
    equal bit for bit (in the JAX layout), the kept tensors untouched; the
    dequantized weights and the total bytes equal too."""
    jm, tm = pair(CONFIGS[name])
    want = {k: np.asarray(v) for k, v in _flatten(JQ.quantize_decode_params(jm.params))}
    state = tm.module.state_dict()
    quantized = Q.quantize_decode_params(state)
    got = to_jax_params(quantized)
    assert got.keys() == want.keys()
    n_int8 = 0
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
        n_int8 += value.dtype == np.int8
    assert n_int8 == len(Q.decode_matrices(state)) > 0
    for key, t in state.items():
        if key not in Q.decode_matrices(state):
            assert quantized[key] is t
    assert Q.quantized_nbytes(quantized) == JQ.quantized_nbytes(
        JQ.quantize_decode_params(jm.params))
    table = "embedding.token_emb"
    np.testing.assert_array_equal(
        Q.dequantize_weight({"weight": quantized[f"{table}.weight"],
                             "scale": quantized[f"{table}.scale"]}).numpy(),
        np.asarray(JQ.dequantize_weight(
            {"weight": want[f"{table}.weight"], "scale": want[f"{table}.scale"]},
            channel_axis=0)))


def test_quantize_weight_int8_edges_match_jax():
    """A zero row (the 1e-12 floor), values at a power of two, channels
    whose max|w| / 127 lies one to three float32 ulps above a power of two
    (max|w| = 127 · 2^k · (1 + n·2⁻²³), k in -4, -7, -10, -14, n in 1-3:
    the JAX scale is 2^k where float32's log(s) / log(2) rounds to k, else
    2^(k+1)), both scale kinds, and the (0, 2) axes of an expert stack:
    equal to the JAX function's output bit for bit, but for the zero row's
    power-of-two scale. There the port gives 2^-39 exactly and the JAX
    package ``exp2(-39)`` as XLA's CPU exp2 computes it, within 1e-6 of it
    (that exp2 misses 2^k by a few ulp at some k, -39 among them); its int8
    values are 0 in both."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(6, 40)).astype(np.float32)
    w[1] = 0.0
    w[2, :3] = (127 * 2.0**-5, -127 * 2.0**-5, 3.0 * 2.0**-5)
    w[2, 3:] = 0.0
    near = []
    for k in (-4, -7, -10, -14):
        for n in (1, 2, 3):
            row = rng.uniform(-1.0, 1.0, size=40) * 2.0**k
            row[n] = (-1) ** n * 127 * 2.0**k * (1 + n * 2.0**-23)
            near.append(row)
    near = np.asarray(near, np.float32)
    stack = rng.normal(size=(3, 8, 5)).astype(np.float32)
    for array, axes, zero in ((w, 0, 1), (w.T.copy(), 1, 1), (near, 0, None),
                              (near.T.copy(), 1, None), (stack, (0, 2), None)):
        for pow2 in (True, False):
            want = JQ.quantize_weight_int8(jnp.asarray(array), channel_axis=axes,
                                           power_of_two_scales=pow2)
            got = Q.quantize_weight_int8(torch.from_numpy(array), channel_axis=axes,
                                         power_of_two_scales=pow2)
            np.testing.assert_array_equal(got["weight"].numpy(), np.asarray(want["weight"]))
            scale, want_scale = got["scale"].numpy(), np.asarray(want["scale"])
            if zero is not None:
                assert scale[zero] == (np.float32(2.0**-39) if pow2 else np.float32(1e-12))
                np.testing.assert_allclose(want_scale[zero], scale[zero], rtol=1e-6)
                scale, want_scale = np.delete(scale, zero), np.delete(want_scale, zero)
            np.testing.assert_array_equal(scale, want_scale)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_int8_greedy_generate_matches_jax(name):
    """float32 compute: int8 weights, ragged prompts, token for token."""
    jm, tm = pair(CONFIGS[name])
    vocab = jm.config.vocab_size
    rng = np.random.default_rng(8)
    prompt = np.zeros((3, 7), np.int32)
    mask = np.zeros((3, 7), bool)
    for i, n in enumerate((7, 4, 1)):
        prompt[i, 7 - n:] = rng.integers(0, vocab, size=n)
        mask[i, 7 - n:] = True
    want = np.asarray(jm.generate(jm.quantize_int8(), jnp.asarray(prompt), 6, temperature=0.0,
                                  prompt_mask=jnp.asarray(mask)))
    qmodule = tm.quantize_int8()
    assert qmodule.blocks[0].attn.qkv_mat.weight.dtype == torch.int8
    assert tm.module.blocks[0].attn.qkv_mat.weight.dtype == torch.float32  # unchanged
    got = G.generate(qmodule, tm.config, torch.from_numpy(prompt).long(), 6, temperature=0.0,
                     prompt_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_server_equals_int8_generate():
    """The server's greedy outputs on int8 weights equal a standalone
    ``generate`` of each prompt on the same int8 module."""
    _, tm = pair(LLAMA_D128)
    qmodule = tm.quantize_int8()
    rng = np.random.default_rng(11)
    reqs = [S.Request(prompt=rng.integers(0, 512, size=(n,)).tolist(), max_new_tokens=m)
            for n, m in ((4, 5), (9, 3), (2, 6), (6, 4))]
    S.DecodeServer(qmodule, tm.config, n_slots=2, bucket=8).serve(reqs)
    for r in reqs:
        alone = G.generate(qmodule, tm.config, torch.tensor([r.prompt]), r.max_new_tokens,
                           temperature=0.0)
        assert r.tokens == alone[0].tolist()


def test_serve_run_quantize_int8_matches_jax_app(monkeypatch, capsys):
    """``serve run --quantize int8 --device cpu --demo 4`` (continuous
    batching) prints the JAX app's tokens, both apps building the same
    weights."""
    jm, tm = pair(LLAMA_D128)
    monkeypatch.setattr(jax_serve_app, "build_model", lambda *a, **k: copy.copy(jm))
    monkeypatch.setattr(serve_app, "build_model", lambda *a, **k: dataclasses.replace(tm))
    kw = dict(demo=4, n_slots=2, max_len=96, max_new_tokens=8, implementation="llama",
              quantize="int8", mode="continuous")
    capsys.readouterr()
    jax_serve_app.run(**kw)
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    reqs = serve_app.run(device="cpu", **kw)
    got = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(got) == len(want) == 4 and all(r.done for r in reqs)
    assert got == want
    assert tm.module.blocks[0].attn.qkv_mat.weight.dtype == torch.float32
    with pytest.raises(SystemExit, match="int8"):
        serve_app.run(device="cpu", **{**kw, "quantize": "int4"})


def test_int8_expert_stacks_refused_by_the_sparse_path():
    """Both packages send int8 expert stacks to the dense oracle under
    "auto" and refuse an explicit "sparse"."""
    jm, tm = pair(TINY_MOE)
    qblock = JQ.quantize_decode_params(jm.params)["blocks"][0]["ffn"]
    ffn = tm.quantize_int8().blocks[0].ffn
    assert ffn.fc1["weight"].dtype == torch.int8 and ffn.fc1["scale"].shape == (4, 256)
    with pytest.raises(ValueError, match="int8"):
        jax_moe.resolve_moe_impl(dataclasses.replace(jm.config, moe_impl="sparse"), qblock)
    with pytest.raises(ValueError, match="int8"):
        M.resolve_moe_impl(dataclasses.replace(tm.config, moe_impl="sparse"), ffn.params(),
                           device="cuda")
    assert M.resolve_moe_impl(tm.config, ffn.params(), 4, device="cuda") == "dense"
