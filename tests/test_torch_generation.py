"""The port's decoding path vs the JAX package, on the CPU.

The same seeded numpy inputs go through both packages, in float32: K1's
key-masked mode (its plain version against the JAX kernel in Pallas
interpret mode, in both of the JAX kernel's causal branches); ``prefill``'s
last logits and cache, ragged and not, on a tiny decoder (pre- and
post-norm) and a tiny GQA/RoPE Llama; greedy ``generate`` token for token
(tied and untied heads, ragged batches, EOS, the int8 cache, GQA/RoPE, MoE);
one decode step from a cache carried across with ``cache_from_jax``; the
semantics of ``sample_token`` that can match (greedy, candidate and nucleus
sets, seeds, ``lax.top_k``'s tie order); and that a bfloat16 ragged prefill
reaches K1's wrapper with the mask in every layer.
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
from vitef_tpu.ops import attention as jax_attention
from vitef_tpu_torch.models import build_model, cache_from_jax, from_jax_params
from vitef_tpu_torch.models import generation as G
from vitef_tpu_torch.models.quantize import embed_rows
from vitef_tpu_torch.ops import attention as A

# fp32 parity: both sides compute the same float32 algorithm; only the order
# of summation differs.
ATOL, RTOL = 2e-5, 1e-4
PREFILL_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """Decoding is hundreds of tiny torch ops: on a CPU that the test workers
    share, torch's intra-op thread pool costs more than their arithmetic."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def decoder(**kw):
    """The tiny decoder of tests/test_serving.py (vocab 48, E 16, 2 heads, 2 layers)."""
    return {"implementation": "transformer", "vocab_size": 48, "emb_type": "dict",
            "emb_dim": 16, "n_heads": 2, "n_layers": 2, "seq_len": 48, "causal": True,
            "pre_norm": True, "weight_tying": True, "output_type": "sequence_to_sequence",
            "attn_bias": True, "ffn_bias": True, "norm_bias": True, "cls_token": False,
            "pos_emb": True, "attn_impl": "xla", "norm_impl": "xla", **kw}


TINY_LLAMA = {"implementation": "llama", "model_name": "tiny", "pretrained": False,
              "seq_len": 64}
TINY_MOE = {"implementation": "moe", "model_name": "tiny", "seq_len": 64}


def pair(config, seed=0):
    """(JAX model, port model) of one config holding the same parameters."""
    jm = jax_build_model(config, key=jax.random.key(seed))
    tm = build_model(config, device="cpu")
    tm.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jm.params)))
    return jm, tm


def left_padded(rng, vocab, lengths, p):
    """(prompt (N, P) int32, mask (N, P) bool): each row's tokens right-aligned."""
    prompt = np.zeros((len(lengths), p), np.int32)
    mask = np.zeros((len(lengths), p), bool)
    for i, n in enumerate(lengths):
        prompt[i, p - n:] = rng.integers(0, vocab, size=n)
        mask[i, p - n:] = True
    return prompt, mask


# ---------------------------------------------------------------------------
# K1's key-masked mode
# ---------------------------------------------------------------------------


def _visible_rows(mask, causal):
    """(N, L) bool: query rows that see at least one valid key."""
    if causal:
        return np.cumsum(mask, axis=1) > 0
    return np.broadcast_to(mask.any(axis=1, keepdims=True), mask.shape)


@pytest.mark.parametrize("l,causal,blocked", [(65, True, False), (65, False, False),
                                              (512, True, True), (512, False, False)],
                         ids=["full_L65_causal", "full_L65", "blocked_L512_causal",
                              "full_L512"])
def test_masked_packed_mha_matches_jax_kernel(l, causal, blocked):
    assert (jax_attention._causal_q_block(l, causal) == 256) == blocked
    n, h, d = 4, 2, 8
    e = h * d
    rng = np.random.default_rng(40 + l)
    qkv = (rng.normal(size=(n, l, 3 * e)) * 0.5).astype(np.float32)
    bias = (rng.normal(size=(3 * e,)) * 0.1).astype(np.float32)
    # left padding: a full row, a ragged one, one of length 1, an empty one
    mask = np.zeros((n, l), bool)
    for i, length in enumerate((l, l - 23, 1, 0)):
        mask[i, l - length:] = True
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_attention.fused_mha_packed(
            jnp.asarray(qkv), h, causal=causal, bias=jnp.asarray(bias),
            key_mask=jnp.asarray(mask)))

    launches = (A.fused_mha_packed.launches, A.fused_mha_packed.masked_launches)
    out = _np(A.fused_mha_packed(_t(qkv), h, causal=causal, bias=_t(bias),
                                 key_mask=_t(mask)))
    assert (A.fused_mha_packed.launches, A.fused_mha_packed.masked_launches) == launches
    rows = _visible_rows(mask, causal)
    assert (~rows).any() and rows.any()
    np.testing.assert_allclose(out[rows], ref[rows], atol=ATOL, rtol=RTOL)
    assert np.isfinite(out).all() and np.isfinite(ref).all()


def test_masked_packed_mha_all_true_and_refusals():
    n, l, h, d = 2, 33, 2, 8
    rng = np.random.default_rng(3)
    qkv = _t((rng.normal(size=(n, l, 3 * h * d)) * 0.5).astype(np.float32))
    bias = _t((rng.normal(size=(3 * h * d,)) * 0.1).astype(np.float32))
    everything = torch.ones((n, l), dtype=torch.bool)
    for causal in (False, True):
        masked = A.fused_mha_packed(qkv, h, causal=causal, bias=bias, key_mask=everything)
        assert torch.equal(masked, A.fused_mha_packed(qkv, h, causal=causal, bias=bias))
    with pytest.raises(NotImplementedError, match="forward only"):
        A.fused_mha_packed(qkv.clone().requires_grad_(), h, causal=True, key_mask=everything)
    with pytest.raises(ValueError, match="key_mask"):
        A.fused_mha_packed(qkv, h, causal=True, key_mask=everything[:, 1:])
    with torch.inference_mode():  # no gradient is wanted here: the call runs
        A.fused_mha_packed(qkv.clone().requires_grad_(), h, key_mask=everything)


# ---------------------------------------------------------------------------
# prefill, generate, one decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", [decoder(), decoder(pre_norm=False), TINY_LLAMA],
                         ids=["pre_norm", "post_norm", "llama_gqa_rope"])
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_prefill_matches_jax(config, ragged):
    jm, tm = pair(config)
    cfg = jm.config
    rng = np.random.default_rng(5)
    if ragged:
        prompt, mask = left_padded(rng, cfg.vocab_size, (9, 4, 1), 9)
    else:
        prompt, mask = rng.integers(0, cfg.vocab_size, size=(2, 9)).astype(np.int32), None
    jmask = None if mask is None else jnp.asarray(mask)
    ref_logits, ref_cache = jax.jit(functools.partial(JG.prefill, cfg=cfg, max_len=14))(
        jm.params, prompt=jnp.asarray(prompt), prompt_mask=jmask)
    logits, cache = G.prefill(tm.module, tm.config, _t(prompt).long(), 14,
                              None if mask is None else _t(mask))
    np.testing.assert_allclose(_np(logits), np.asarray(ref_logits),
                               atol=PREFILL_TOL, rtol=PREFILL_TOL)
    for got, want in zip(cache, ref_cache):
        for name in ("k", "v"):
            assert got[name].shape == want[name].shape
            np.testing.assert_allclose(_np(got[name]), np.asarray(want[name]),
                                       atol=PREFILL_TOL, rtol=PREFILL_TOL)


def _jax_greedy(jm, prompt, max_new, **kw):
    mask = kw.pop("prompt_mask", None)
    if mask is not None:
        kw["prompt_mask"] = jnp.asarray(mask)
    return np.asarray(jm.generate(jm.params, jnp.asarray(prompt), max_new, temperature=0.0,
                                  **kw))


@pytest.mark.parametrize("config", [decoder(), decoder(weight_tying=False),
                                    decoder(pre_norm=False), TINY_LLAMA, TINY_MOE],
                         ids=["tied", "untied", "post_norm", "llama_gqa_rope", "moe"])
def test_greedy_generate_matches_jax(config):
    jm, tm = pair(config)
    prompt = np.random.default_rng(6).integers(0, jm.config.vocab_size, size=(3, 5))
    prompt = prompt.astype(np.int32)
    out = tm.generate(_t(prompt).long(), 7, temperature=0.0)
    assert out.shape == (3, 7) and out.dtype == torch.long
    np.testing.assert_array_equal(_np(out), _jax_greedy(jm, prompt, 7))


@pytest.mark.parametrize("config", [decoder(), TINY_LLAMA], ids=["gpt2_like", "llama_gqa_rope"])
def test_ragged_generate_matches_jax_and_unpadded(config):
    jm, tm = pair(config)
    prompt, mask = left_padded(np.random.default_rng(7), jm.config.vocab_size, (8, 3, 1, 6), 8)
    out = _np(tm.generate(_t(prompt).long(), 6, temperature=0.0, prompt_mask=_t(mask)))
    np.testing.assert_array_equal(out, _jax_greedy(jm, prompt, 6, prompt_mask=mask))
    for i, row in enumerate(prompt):
        alone = tm.generate(_t(row[mask[i]][None]).long(), 6, temperature=0.0)
        np.testing.assert_array_equal(out[i], _np(alone)[0])


def test_eos_pads_after_first_eos_as_jax():
    jm, tm = pair(decoder())
    prompt = np.random.default_rng(8).integers(0, 48, size=(4, 4)).astype(np.int32)
    free = _jax_greedy(jm, prompt, 8)
    eos = int(free[0, 2])  # a token row 0 emits mid-stream
    out = _np(tm.generate(_t(prompt).long(), 8, temperature=0.0, eos_token_id=eos))
    np.testing.assert_array_equal(out, _jax_greedy(jm, prompt, 8, eos_token_id=eos))
    first = int(np.argmax(out[0] == eos))
    assert first <= 2 and (out[0, first:] == eos).all()


def test_int8_cache_generate_matches_jax():
    jm, tm = pair(decoder())
    prompt, mask = left_padded(np.random.default_rng(9), 48, (6, 2), 6)
    out = tm.generate(_t(prompt).long(), 6, temperature=0.0, prompt_mask=_t(mask),
                      kv_cache_dtype="int8")
    np.testing.assert_array_equal(
        _np(out), _jax_greedy(jm, prompt, 6, prompt_mask=mask, kv_cache_dtype="int8"))


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"], ids=["float32", "int8"])
@pytest.mark.parametrize("config", [decoder(), TINY_LLAMA], ids=["gpt2_like", "llama_gqa_rope"])
def test_decode_step_from_shared_cache(config, kv_cache_dtype):
    """One decode step (every block, then the head) on a cache that JAX's
    prefill wrote, carried across with cache_from_jax: the logits and each
    layer's written cache position match."""
    jm, tm = pair(config)
    cfg = jm.config
    prompt, mask = left_padded(np.random.default_rng(10), cfg.vocab_size, (5, 2), 5)
    _, jcache = jax.jit(functools.partial(JG.prefill, cfg=cfg, max_len=9,
                                          kv_cache_dtype=kv_cache_dtype))(
        jm.params, prompt=jnp.asarray(prompt), prompt_mask=jnp.asarray(mask))
    cache = cache_from_jax(jax.tree.map(np.asarray, jcache))
    assert cache[0]["k"].dtype == (torch.int8 if kv_cache_dtype else torch.float32)
    key_mask = np.concatenate([mask, np.ones((2, 4), bool)], axis=1)
    token = np.array([3, 7], np.int32)
    pos, logical = 5, mask.sum(axis=1).astype(np.int32)

    @jax.jit
    def jax_step(params, cache, token, key_mask, logical):
        x = JG._embed_token(params, cfg, token, logical)
        new_cache = []
        for bp, lc in zip(params["blocks"], cache):
            x, lc = JG._block_decode(bp, cfg, x, lc, pos, key_mask, positions=logical)
            new_cache.append(lc)
        return JG._logits(params, cfg, x), new_cache

    ref, jcache = jax_step(jm.params, jcache, jnp.asarray(token), jnp.asarray(key_mask),
                           jnp.asarray(logical))

    with torch.inference_mode():
        y = G._embed_token(tm.module, tm.config, _t(token).long(), _t(logical).long())
        for block, lc in zip(tm.module.blocks, cache):
            y, _ = G._block_decode(block, tm.config, y, lc, pos, _t(key_mask),
                                   positions=_t(logical).long())
        logits = G._logits(tm.module, tm.config, y)
    np.testing.assert_allclose(_np(logits), np.asarray(ref), atol=PREFILL_TOL,
                               rtol=PREFILL_TOL)
    for got, want in zip(cache, jcache):
        for name, value in got.items():
            written, expect = _np(value)[:, :, pos], np.asarray(want[name])[:, :, pos]
            if value.dtype == torch.int8:  # a rounding boundary may move one step
                assert np.abs(written.astype(int) - expect.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(written, expect, atol=PREFILL_TOL, rtol=PREFILL_TOL)


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"], ids=["float32", "int8"])
@pytest.mark.parametrize("config", [decoder(), TINY_LLAMA], ids=["gpt2_like", "llama_gqa_rope"])
def test_decode_step_per_row_positions_equals_each_row_alone(config, kv_cache_dtype):
    """_block_decode with a (N,) tensor of cache positions (the server's
    slots) writes and reads each row at its own position: every row's
    output and written cache cell equal the same row stepped alone at that
    int position."""
    tm = build_model(config, device="cpu")
    cfg = tm.config
    prompt = _t(np.random.default_rng(11).integers(0, cfg.vocab_size, size=(3, 6))).long()
    pos = [2, 5, 3]
    x = _t(np.random.default_rng(12).standard_normal((3, cfg.emb_dim)).astype(np.float32))
    with torch.inference_mode():
        _, cache = G.prefill(tm.module, cfg, prompt, 8, kv_cache_dtype=kv_cache_dtype)
        block = tm.module.blocks[1]
        rows = [G._block_decode(block, cfg, x[i:i + 1], {k: v[i:i + 1].clone()
                                                           for k, v in cache[1].items()}, p)
                for i, p in enumerate(pos)]
        out, lc = G._block_decode(block, cfg, x, cache[1], torch.tensor(pos))
    for i, (want, want_lc) in enumerate(rows):
        np.testing.assert_allclose(_np(out[i:i + 1]), _np(want), atol=1e-6, rtol=1e-6)
        for name, value in lc.items():  # a batch of 3 rounds the linears apart from 1
            got, expect = _np(value[i:i + 1]), _np(want_lc[name])
            if value.dtype == torch.int8:
                assert np.abs(got.astype(int) - expect.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(got, expect, atol=1e-6, rtol=1e-6)


def test_cache_from_jax_keeps_layout_and_dtypes():
    config = decoder(compute_dtype="bfloat16")
    cfg = jax_build_model(config, key=jax.random.key(0)).config
    tcfg = build_model(config, device="cpu").config
    for dtype, want in ((None, {"k": torch.bfloat16, "v": torch.bfloat16}),
                        ("int8", {"k": torch.int8, "v": torch.int8, "k_scale": torch.float32,
                                  "v_scale": torch.float32})):
        jcache = JG.init_kv_cache(cfg, 3, 11, dtype)
        jcache[1]["k"] = jcache[1]["k"].at[2, 1, 4].set(5)
        cache = cache_from_jax(jax.tree.map(np.asarray, jcache))
        assert len(cache) == cfg.n_layers
        assert {k: v.dtype for k, v in cache[1].items()} == want
        assert cache[1]["k"].shape == (3, 2, 11, 8) and cache[1]["k"][2, 1, 4].eq(5).all()
        port = G.init_kv_cache(tcfg, 3, 11, dtype, device="cpu")
        assert {k: (v.shape, v.dtype) for k, v in port[0].items()} == \
            {k: (v.shape, v.dtype) for k, v in cache[0].items()}


def test_embed_rows_int8_table_matches_jax():
    from vitef_tpu.models.quantize import embed_rows as jax_embed_rows

    rng = np.random.default_rng(11)
    w = rng.integers(-127, 128, size=(20, 8)).astype(np.int8)
    scale = (2.0 ** rng.integers(-8, -2, size=(20,))).astype(np.float32)
    table = rng.normal(size=(20, 8)).astype(np.float32)
    tok = rng.integers(0, 20, size=(3, 4))
    for tree in ({"weight": w, "scale": scale}, {"weight": table}):
        ref = jax_embed_rows({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(tok),
                             jnp.float32)
        got = embed_rows({k: _t(v) for k, v in tree.items()}, _t(tok), torch.float32)
        np.testing.assert_array_equal(_np(got), np.asarray(ref))


# ---------------------------------------------------------------------------
# sample_token
# ---------------------------------------------------------------------------


def test_greedy_is_argmax_with_first_index_on_ties():
    logits = np.random.default_rng(12).normal(size=(5, 30)).astype(np.float32)
    logits[0, [3, 17]] = 9.0
    logits[1, [0, 29]] = 9.0
    want = np.asarray(JG.sample_token(jnp.asarray(logits), jax.random.key(0), 0.0))
    np.testing.assert_array_equal(want[:2], [3, 0])
    for kw in ({"temperature": 0.0}, {"temperature": 0.7, "top_k": 1}):
        np.testing.assert_array_equal(_np(G.sample_token(_t(logits), None, **kw)), want)


def test_top_k_order_matches_lax_top_k():
    rng = np.random.default_rng(1)
    ties = rng.integers(0, 50, size=(3, 4096)).astype(np.float32)
    smooth = rng.standard_normal((2, 50257)).astype(np.float32)
    for x, ks in ((ties, (1, 17, 40)), (smooth, (5, 40))):
        for k in ks:
            vals, idx = G._top_k(_t(x), k)
            rv, ri = jax.lax.top_k(jnp.asarray(x), k)
            np.testing.assert_array_equal(_np(vals), np.asarray(rv))
            np.testing.assert_array_equal(_np(idx), np.asarray(ri))


def _nucleus(logits, temperature, top_p, k):
    """JAX's nucleus set of each row: the top-k candidates whose probability
    mass before them (normalised over the whole vocabulary) is <= top_p."""
    vals, idx = jax.lax.top_k(jnp.asarray(logits), k)
    lse = jax.nn.logsumexp(jnp.asarray(logits) / temperature, axis=-1, keepdims=True)
    probs = jnp.exp(vals / temperature - lse)
    keep = (jnp.cumsum(probs, axis=-1) - probs) <= top_p
    return [set(np.asarray(i)[np.asarray(m)].tolist()) for i, m in zip(idx, keep)]


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.8), (12, 0.6)],
                         ids=["top_k", "top_p", "top_k_top_p"])
def test_sampling_draws_only_from_jax_sets(top_k, top_p):
    base = np.random.default_rng(13).normal(size=(2, 64)).astype(np.float32) * 2
    draws, temperature = 2000, 0.9
    logits = np.repeat(base, draws, axis=0)  # one draw per row
    gen = torch.Generator().manual_seed(0)
    got = _np(G.sample_token(_t(logits), gen, temperature, top_k, top_p=top_p))
    got = got.reshape(2, draws)
    if top_p is None:
        allowed = [set(np.asarray(jax.lax.top_k(jnp.asarray(base), top_k)[1][r]).tolist())
                   for r in range(2)]
    else:
        allowed = _nucleus(base, temperature, top_p, min(top_k or 256, 64))
    for r in range(2):
        assert set(got[r].tolist()) == allowed[r]  # all of it is reached in 2000 draws


def test_same_generator_seed_same_tokens():
    logits = _t(np.random.default_rng(14).normal(size=(6, 100)).astype(np.float32))
    for kw in ({}, {"top_k": 10}, {"top_p": 0.9}):
        a = G.sample_token(logits, torch.Generator().manual_seed(7), 1.0, **kw)
        b = G.sample_token(logits, torch.Generator().manual_seed(7), 1.0, **kw)
        assert torch.equal(a, b)
    jm, tm = pair(decoder())
    prompt = _t(np.random.default_rng(15).integers(0, 48, size=(2, 4))).long()
    a = tm.generate(prompt, 5, temperature=0.8, top_k=8,
                    generator=torch.Generator().manual_seed(3))
    b = tm.generate(prompt, 5, temperature=0.8, top_k=8,
                    generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# bfloat16 routing to K1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [{}, {"n_kv_heads": 1, "pos_emb_type": "rope"}],
                         ids=["mha", "gqa_rope"])
def test_bf16_ragged_prefill_calls_masked_k1_every_layer(monkeypatch, extra):
    """A bfloat16 prefill with attn_impl "kernel" (on the CPU: the kernel's
    plain version) passes the prompt mask to K1's wrapper in every layer, on
    the packed (N, L, 3E) geometry; unpadded, it passes no mask."""
    config = decoder(emb_dim=128, compute_dtype="bfloat16", attn_impl="kernel", **extra)
    tm = build_model(config, device="cpu")
    calls = []
    wrapped = A.fused_mha_packed

    def recording(qkv, n_heads, causal=False, bias=None, key_mask=None):
        calls.append((tuple(qkv.shape), n_heads, causal, key_mask is not None))
        return wrapped(qkv, n_heads, causal=causal, bias=bias, key_mask=key_mask)

    monkeypatch.setattr(G, "fused_mha_packed", recording)
    prompt, mask = left_padded(np.random.default_rng(16), 48, (7, 3, 1), 7)
    logits, cache = G.prefill(tm.module, tm.config, _t(prompt).long(), 10, _t(mask))
    assert calls == [((3, 7, 3 * 128), 2, True, True)] * 2
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert cache[0]["k"].dtype == torch.bfloat16
    calls.clear()
    G.prefill(tm.module, tm.config, _t(prompt).long(), 10)
    assert calls == [((3, 7, 3 * 128), 2, True, False)] * 2
