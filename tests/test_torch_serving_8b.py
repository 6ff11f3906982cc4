"""The port's serving path at head width 128 (Llama-3.1-8B's) vs the JAX package, on the CPU.

The same seeded numpy inputs and the same weights go through both packages:
K1's plain version at d = 128 against the JAX packed kernel (Pallas
interpret mode) in its three modes; a decoder at head width 128 with the
Llama options (GQA 2 : 1, RoPE, rms norm, swiglu, untied head; E = 256, two
layers, V = 512) through ``prefill``, ragged greedy ``generate`` and the
``DecodeServer`` in float32, and through the bfloat16 prefill on the kernel
route, where both packages take K1 (the JAX kernel in interpret mode, the
port's wrapper with its plain version on the CPU) in every layer; and a
d = 128 forward that wants a gradient: refused in the key-masked mode,
differentiable otherwise (K2 and K3 are instantiated at d = 128).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vitef_tpu.models import build_model as jax_build_model
from vitef_tpu.models import generation as JG
from vitef_tpu.models import serving as JS
from vitef_tpu.ops import attention as jax_attention
from vitef_tpu_torch.models import build_model, from_jax_params
from vitef_tpu_torch.models import generation as G
from vitef_tpu_torch.models import serving as S
from vitef_tpu_torch.ops import attention as A

# float32 parity: both sides compute the same float32 algorithm; only the
# order of summation differs.
ATOL, RTOL = 2e-5, 1e-4
PREFILL_TOL = 1e-4
# bfloat16 prefill logits on the kernel route: both packages round to bf16
# at different places (the JAX kernel rounds P before P·V and divides last,
# the port's plain version rounds the normalised weights; the linears'
# outputs), through two blocks: relative L2 of the last logits. The greedy
# tokens are not compared in bf16: an argmax near a tie may flip.
BF16_REL_L2 = 2e-2
H, D = 2, 128

LLAMA_D128 = {"implementation": "transformer", "vocab_size": 512, "emb_type": "dict",
              "emb_dim": H * D, "n_heads": H, "n_kv_heads": 1, "n_layers": 2, "seq_len": 64,
              "causal": True, "pre_norm": True, "weight_tying": False,
              "output_type": "sequence_to_sequence", "attn_bias": False, "ffn_bias": False,
              "ffn_type": "swiglu", "ffn_dim": 512, "norm": "rms", "norm_bias": False,
              "norm_eps": 1e-5, "pos_emb_type": "rope", "rope_theta": 500000.0,
              "cls_token": False, "attn_impl": "xla", "norm_impl": "xla"}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def pair(config, seed=0):
    """(JAX model, port model) of one config holding the same parameters."""
    jm = jax_build_model(config, key=jax.random.key(seed))
    tm = build_model(config, device="cpu")
    tm.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jm.params)))
    return jm, tm


@pytest.fixture(scope="module")
def d128():
    return pair(LLAMA_D128)


def left_padded(rng, vocab, lengths, p):
    """(prompt (N, P) int32, mask (N, P) bool): each row's tokens right-aligned."""
    prompt = np.zeros((len(lengths), p), np.int32)
    mask = np.zeros((len(lengths), p), bool)
    for i, n in enumerate(lengths):
        prompt[i, p - n:] = rng.integers(0, vocab, size=n)
        mask[i, p - n:] = True
    return prompt, mask


# ---------------------------------------------------------------------------
# K1 at head width 128
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l", [17, 129])
@pytest.mark.parametrize("mode", ["full", "causal", "masked"])
def test_k1_plain_version_at_d128_matches_jax_kernel(mode, l):
    """The plain version of K1 at d = 128 against the JAX packed kernel,
    N = 2, two heads, with the qkv bias; the key-masked mode causal with a
    full and a left-padded row, compared on the rows that see a valid key."""
    rng = np.random.default_rng(200 + l)
    qkv = (rng.normal(size=(2, l, 3 * H * D)) * 0.5).astype(np.float32)
    bias = (rng.normal(size=(3 * H * D,)) * 0.1).astype(np.float32)
    causal = mode != "full"
    mask = None
    if mode == "masked":
        mask = np.zeros((2, l), bool)
        mask[0] = True
        mask[1, 16:] = True
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_attention.fused_mha_packed(
            jnp.asarray(qkv), H, causal=causal, bias=jnp.asarray(bias),
            key_mask=None if mask is None else jnp.asarray(mask)))
    got = A.fused_mha_packed(_t(qkv), H, causal=causal, bias=_t(bias),
                             key_mask=None if mask is None else _t(mask)).numpy()
    rows = np.ones((2, l), bool) if mask is None else np.cumsum(mask, axis=1) > 0
    np.testing.assert_allclose(got[rows], ref[rows], atol=ATOL, rtol=RTOL)
    assert np.isfinite(got).all()


def test_d128_gradient_refused_before_any_work():
    """The key-masked mode refuses a gradient at every width, d = 128
    included, before any work. Since K2 and K3 are instantiated at d = 128,
    an unmasked forward that wants a gradient is differentiable there, as at
    64: its gradient is K2/K3's plain version's, and the bf16 model on the
    kernel route trains as well as it evaluates."""
    qkv = torch.randn(1, 9, 3 * H * D)
    with pytest.raises(NotImplementedError, match="forward only"):
        A.fused_mha_packed(qkv.clone().requires_grad_(), H, causal=True,
                           key_mask=torch.ones(1, 9, dtype=torch.bool))
    assert A.fused_mha_packed(qkv, H, causal=True).shape == (1, 9, H * D)
    leaf = qkv.clone().requires_grad_()
    out = A.fused_mha_packed(leaf, H, causal=True)
    g = torch.randn_like(out)
    out.backward(g)
    want, _ = A.packed_mha_bwd_reference(qkv, None, g, H, causal=True)
    np.testing.assert_allclose(leaf.grad.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)

    # the bf16 model on the kernel route: the train forward and its backward run
    tm = build_model({**LLAMA_D128, "compute_dtype": "bfloat16", "attn_impl": "kernel"},
                     device="cpu")
    tokens = torch.randint(0, 512, (1, 9))
    tm.module(tokens).float().square().mean().backward()
    grad = tm.module.blocks[0].attn.qkv_mat.weight.grad
    assert grad is not None and torch.isfinite(grad).all() and grad.abs().max() > 0
    with torch.no_grad():
        assert tm.module(tokens).shape == (1, 9, 512)


# ---------------------------------------------------------------------------
# The decoder at head width 128
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_d128_prefill_matches_jax(d128, ragged):
    jm, tm = d128
    rng = np.random.default_rng(21)
    if ragged:
        prompt, mask = left_padded(rng, 512, (11, 6, 1), 11)
    else:
        prompt, mask = rng.integers(0, 512, size=(2, 11)).astype(np.int32), None
    jmask = None if mask is None else jnp.asarray(mask)
    ref_logits, ref_cache = jax.jit(functools.partial(JG.prefill, cfg=jm.config, max_len=16))(
        jm.params, prompt=jnp.asarray(prompt), prompt_mask=jmask)
    logits, cache = G.prefill(tm.module, tm.config, _t(prompt).long(), 16,
                              None if mask is None else _t(mask))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=PREFILL_TOL,
                               rtol=PREFILL_TOL)
    for got, want in zip(cache, ref_cache):
        for name in ("k", "v"):
            assert got[name].shape == want[name].shape == (len(prompt), 1, 16, D)
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                       atol=PREFILL_TOL, rtol=PREFILL_TOL)


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_d128_bf16_prefill_through_k1_matches_jax(monkeypatch, ragged):
    """bfloat16 on the kernel route: both packages' prefill take K1 at
    d = 128 in every layer (the JAX Pallas kernel in interpret mode; the
    port's wrapper, masked for a ragged batch, on the (N, L, 3E) packed
    layout with each kv head repeated over its group), and their last
    logits agree within BF16_REL_L2."""
    config = {**LLAMA_D128, "compute_dtype": "bfloat16", "attn_impl": "pallas"}
    jm, tm = pair(config)
    rng = np.random.default_rng(22)
    lengths = (13, 7, 2) if ragged else (13, 13, 13)
    prompt, mask = left_padded(rng, 512, lengths, 13)
    calls = []
    wrapped = A.fused_mha_packed

    def recording(qkv, n_heads, causal=False, bias=None, key_mask=None):
        calls.append((tuple(qkv.shape), n_heads, causal, key_mask is not None))
        return wrapped(qkv, n_heads, causal=causal, bias=bias, key_mask=key_mask)

    monkeypatch.setattr(G, "fused_mha_packed", recording)
    with pltpu.force_tpu_interpret_mode():
        ref_logits, _ = jax.jit(functools.partial(JG.prefill, cfg=jm.config, max_len=16))(
            jm.params, prompt=jnp.asarray(prompt),
            prompt_mask=jnp.asarray(mask) if ragged else None)
    logits, cache = G.prefill(tm.module, tm.config, _t(prompt).long(), 16,
                              _t(mask) if ragged else None)
    assert calls == [((3, 13, 3 * H * D), H, True, ragged)] * 2
    assert cache[0]["k"].dtype == torch.bfloat16
    ref = torch.from_numpy(np.array(ref_logits, np.float32))
    rel = ((logits - ref).norm() / ref.norm()).item()
    assert np.isfinite(rel) and rel <= BF16_REL_L2, rel


def test_d128_ragged_greedy_generate_matches_jax_and_unpadded(d128):
    jm, tm = d128
    prompt, mask = left_padded(np.random.default_rng(23), 512, (9, 4, 1, 6), 9)
    out = tm.generate(_t(prompt).long(), 7, temperature=0.0, prompt_mask=_t(mask)).numpy()
    want = np.asarray(jm.generate(jm.params, jnp.asarray(prompt), 7, temperature=0.0,
                                  prompt_mask=jnp.asarray(mask)))
    np.testing.assert_array_equal(out, want)
    for i, row in enumerate(prompt):
        alone = tm.generate(_t(row[mask[i]][None]).long(), 7, temperature=0.0)
        np.testing.assert_array_equal(out[i], alone.numpy()[0])


def test_d128_server_matches_jax_server(d128):
    jm, tm = d128
    rng = np.random.default_rng(24)
    lens = [(int(rng.integers(3, 20)), int(rng.integers(2, 9))) for _ in range(6)]
    prompts = [rng.integers(0, 512, size=(n,)).tolist() for n, _ in lens]
    jreqs = [JS.Request(prompt=p, max_new_tokens=m) for p, (_, m) in zip(prompts, lens)]
    reqs = [S.Request(prompt=p, max_new_tokens=m) for p, (_, m) in zip(prompts, lens)]
    JS.DecodeServer(jm.params, jm.config, n_slots=3, bucket=8).serve(jreqs)
    S.DecodeServer(tm.module, tm.config, n_slots=3, bucket=8).serve(reqs)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert all(len(r.tokens) == r.max_new_tokens for r in reqs)
