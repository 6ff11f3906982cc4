"""The port's speculative decoding against the JAX package's, on the CPU.

``vitef_tpu_torch.models.speculative.generate_speculative`` and
``Model.generate_speculative`` against the JAX ``generate_speculative``
(greedy tokens and the {"rounds", "drafted", "accepted"} stats, gamma 1, 3
and 5, a GPT-2-like decoder with a tied head and a tiny GQA/RoPE Llama, each
drafted by a model of other weights) and against the port's own greedy
``generate``; the self-draft's acceptance; the stats' budget; the guards;
bf16 and int8 weights; and the sampling rule's distribution under a fixed
``torch.Generator`` (its draws cannot match ``jax.random``'s). Greedy token
streams are compared exactly, in float32.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vitef_tpu.models import build_model as jax_build_model
from vitef_tpu.models import generate_speculative as jax_speculative
from vitef_tpu_torch.models import build_model, from_jax_params, generate_speculative
from vitef_tpu_torch.models import speculative as SPEC

DECODER = {"implementation": "transformer", "vocab_size": 48, "emb_type": "dict",
           "emb_dim": 32, "n_heads": 4, "n_layers": 2, "seq_len": 64, "causal": True,
           "pre_norm": True, "weight_tying": True, "output_type": "sequence_to_sequence",
           "attn_bias": True, "ffn_bias": True, "norm_bias": True, "cls_token": False,
           "pos_emb": True, "attn_impl": "xla", "norm_impl": "xla"}
TINY_LLAMA = {"implementation": "llama", "model_name": "tiny", "pretrained": False,
              "seq_len": 64}
FAMILIES = {"gpt2_like": DECODER, "llama_gqa_rope": TINY_LLAMA}


def pair(config, seed):
    """(JAX model, port model) of one config holding the same parameters."""
    jm = jax_build_model(config, key=jax.random.key(seed))
    tm = build_model(config, device="cpu")
    tm.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jm.params)))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    """Per family: the target (seed 0) and its draft (seed 7), in both packages."""
    return {name: (pair(config, 0), pair(config, 7)) for name, config in FAMILIES.items()}


@pytest.fixture(autouse=True)
def one_thread():
    """A decode is hundreds of tiny torch ops: on a shared CPU, the thread
    pool's hand-offs cost more than their arithmetic."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def prompt_of(seed, length, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(1, length))


def plain_greedy(tm, prompt, max_new):
    return tm.generate(torch.from_numpy(prompt), max_new, temperature=0.0)


@pytest.mark.parametrize("gamma", [1, 3, 5])
@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_tokens_and_stats_equal_jax(models, family, gamma):
    (jt, tt), (jd, td) = models[family]
    prompt = prompt_of(gamma, 6, jt.config.vocab_size)
    want, jstats = jax_speculative(jt.params, jt.config, jnp.asarray(prompt, jnp.int32), 13,
                                   draft_params=jd.params, draft_cfg=jd.config, gamma=gamma,
                                   return_stats=True)
    got, stats = tt.generate_speculative(torch.from_numpy(prompt), 13, draft=td, gamma=gamma,
                                         return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == {k: int(v) for k, v in jstats.items()}
    np.testing.assert_array_equal(got.numpy(), plain_greedy(tt, prompt, 13).numpy())


def test_self_draft_accepts_everything_and_stats_stop_at_the_budget(models):
    """A self-draft accepts every proposal: ceil(12 / 4) rounds. At 11 new
    tokens the last round needs 2 more: 3 + 3 + 2 proposals count, not 9."""
    _, tt = models["gpt2_like"][0]
    prompt = np.array([[4, 9, 2]])
    for max_new, rounds, counted in ((12, 3, 9), (11, 3, 8)):
        got, stats = tt.generate_speculative(torch.from_numpy(prompt), max_new, draft=tt,
                                             gamma=3, return_stats=True)
        assert stats == {"rounds": rounds, "drafted": counted, "accepted": counted}
        np.testing.assert_array_equal(got.numpy(), plain_greedy(tt, prompt, max_new).numpy())


def test_guards_raise(models):
    (_, tt), (_, td) = models["gpt2_like"]
    cases = [(torch.zeros(2, 4, dtype=torch.long), 4, 4, "batch-1"),
             (torch.zeros(1, 4, dtype=torch.long), 4, 0, "gamma"),
             (torch.zeros(1, 56, dtype=torch.long), 4, 4, "exceeds")]  # 56 + 4 + 5 > 64
    for prompt, max_new, gamma, match in cases:
        with pytest.raises(ValueError, match=match):
            generate_speculative(tt.module, tt.config, prompt, max_new, draft_params=td.module,
                                 draft_cfg=td.config, gamma=gamma)
    fits = torch.zeros(1, 55, dtype=torch.long)  # 55 + 4 + 4 + 1 = 64
    assert tt.generate_speculative(fits, 4, draft=td, gamma=4).shape == (1, 4)


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_and_int8_greedy_equal_generate(models, family):
    """The verify window and generate()'s one-token steps give the same
    greedy tokens in bfloat16 and on int8 weights (Model.quantize_int8 on
    both sides, as the JAX method takes int8 params)."""
    (_, tt), (_, td) = models[family]
    prompt = prompt_of(4, 6, tt.config.vocab_size)
    target = build_model({**FAMILIES[family], "compute_dtype": "bfloat16"}, device="cpu")
    draft = build_model({**FAMILIES[family], "compute_dtype": "bfloat16"}, device="cpu")
    target.module.load_state_dict(tt.module.state_dict())
    draft.module.load_state_dict(td.module.state_dict())
    want = plain_greedy(target, prompt, 13)
    for gamma in (1, 4):
        got = target.generate_speculative(torch.from_numpy(prompt), 13, draft=draft,
                                          gamma=gamma)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    target.module, draft_int8 = tt.quantize_int8(), td.quantize_int8()
    want = plain_greedy(target, prompt, 13)
    got = target.generate_speculative(torch.from_numpy(prompt), 13, draft=td,
                                      draft_params=draft_int8, gamma=3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_sampling_self_draft_accepts_everything(models):
    """With draft == target the Leviathan ratio p/q is 1 at every
    position, so every proposal is accepted, round after round: a draft
    cache missing its (gamma + 1)-th K/V write would show here."""
    _, tt = models["llama_gqa_rope"][0]
    prompt = torch.from_numpy(prompt_of(1, 5, tt.config.vocab_size))
    accepted = drafted = 0
    for seed in range(4):
        _, stats = tt.generate_speculative(
            prompt, 12, draft=tt, gamma=3, temperature=1.0, return_stats=True,
            generator=torch.Generator().manual_seed(seed))
        accepted, drafted = accepted + stats["accepted"], drafted + stats["drafted"]
    assert accepted == drafted == 4 * 9


def test_sampling_follows_the_target(models):
    """The rule's output is the target's distribution whatever the draft:
    the empirical marginal of the second token (after a round with another
    model as the draft) against plain sampled generate(), in total variation
    over 600 draws each (two samples of one 48-way distribution: TV ~0.1);
    a draw is the same for the same generator seed."""
    (_, tt), (_, td) = models["gpt2_like"]
    prompt = torch.tensor([[3, 8, 1, 4]])
    n, v = 600, tt.config.vocab_size
    spec = [tt.generate_speculative(prompt, 2, draft=td, gamma=2, temperature=1.0,
                                    generator=torch.Generator().manual_seed(i))[0, 1].item()
            for i in range(n)]
    plain = tt.generate(prompt.expand(n, -1), 2, temperature=1.0,
                        generator=torch.Generator().manual_seed(n))[:, 1]
    counts = np.bincount(spec, minlength=v) / n, np.bincount(plain.numpy(), minlength=v) / n
    tv = 0.5 * np.abs(counts[0] - counts[1]).sum()
    assert tv < 0.2, f"total variation {tv:.3f}: the distributions differ"
    again = tt.generate_speculative(prompt, 2, draft=td, gamma=2, temperature=1.0,
                                    generator=torch.Generator().manual_seed(5))
    assert again[0, 1].item() == spec[5]


def test_window_equals_one_token_steps(models):
    """One verify window of W = 4 tokens at cache position 5 against four
    one-token steps from the same cache: logits and the cache cells written,
    float32 at 1e-5; the cells past the window stay untouched."""
    _, tt = models["llama_gqa_rope"][0]
    cfg = tt.config
    tokens = torch.from_numpy(prompt_of(2, 9, cfg.vocab_size))
    with torch.inference_mode():
        _, cache = SPEC.prefill(tt.module, cfg, tokens[:, :5], 12)
        stepped = [{k: t.clone() for k, t in lc.items()} for lc in cache]
        window = SPEC._forward_window(tt.module, cfg, tokens[:, 5:], cache, 5)
        steps = torch.stack([SPEC._draft_step(tt.module, cfg, stepped, tokens[:, i], i,
                                              torch.tensor([i]), logits=True)
                             for i in range(5, 9)], dim=1)
    torch.testing.assert_close(window, steps, atol=1e-5, rtol=1e-5)
    for lc, ls in zip(cache, stepped):
        torch.testing.assert_close(lc["k"], ls["k"], atol=1e-5, rtol=1e-5)
        assert not lc["k"][:, :, 9:].any()
