"""The port's Llama slice vs the JAX package, on the CPU.

The same seeded numpy inputs go through both packages: the flash attention
kernel K4's plain version against the JAX package's ``flash_attention``
(Pallas kernel in interpret mode, as tests/test_ops.py runs it), with L not a
multiple of its 128-row blocks; K5's plain version against ``jax.vjp`` of it
in both of the JAX backward's branches (its kernel, and the XLA recompute past
its VMEM budget); rope and the rms norm; a tiny Llama's logits and three
AdamW train steps with the fused untied head loss in float32; the tiny Llama
in bfloat16 through the flash route; the attention routing of both packages
for the repo's geometries; the "1b" preset's names and shapes; and the
HuggingFace weight map.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vitef_tpu import ops as jax_ops
from vitef_tpu import optim as jax_optim
from vitef_tpu.models import build_model as jax_build_model
from vitef_tpu.models import llama as jax_llama
from vitef_tpu.models import norms as jax_norms
from vitef_tpu.models import rope as jax_rope
from vitef_tpu.models import torch_import as jax_torch_import
from vitef_tpu.models.transformer import apply_transformer, init_transformer
from vitef_tpu.ops import attention as jax_attention
from vitef_tpu.parallel import init_train_state as jax_init_train_state
from vitef_tpu.parallel import make_train_step as jax_make_train_step
from vitef_tpu.utils.tree import keystr_dotted
from vitef_tpu_torch import ops, optim
from vitef_tpu_torch.models import (build_model, from_jax_params, from_vitef_state_dict,
                                    hf_llama_to_vitef, rope)
from vitef_tpu_torch.models import transformer as T
from vitef_tpu_torch.models.norms import RMSNorm
from vitef_tpu_torch.ops import attention as A
from vitef_tpu_torch.parallel import init_train_state, make_train_step

# fp32 parity: both sides compute the same float32 algorithm; only the order
# of summation differs.
ATOL, RTOL = 2e-5, 1e-4
# bfloat16 outputs: both round one float32 result to bfloat16, at different
# points (the kernel rounds the unnormalised probabilities before P·V, the
# plain version the normalised ones), so they may differ by a bf16 step
# (2^-8 relative) of values up to ~2.
BF16_ATOL, BF16_RTOL = 2e-2, 1e-2


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _llama(size="tiny", **kw):
    return {"implementation": "llama", "model_name": size, "pretrained": False, **kw}


def _pair(config, seed=0):
    """(JAX model, port model) of one config holding the same parameters."""
    jm = jax_build_model(config, key=jax.random.key(seed))
    tm = build_model(config, device="cpu")
    tm.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jm.params)))
    return jm, tm


def _qkv(n, h, l, d, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, h, l, d)) * s).astype(np.float32) for s in (0.5, 0.5, 0.5, 1.0)]


# ---------------------------------------------------------------------------
# K4 and K5: the flash kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_matches_jax_kernel(causal, dtype):
    """L=130 pads to 256 in the JAX version (two 128-row blocks, keys past
    kv_len masked); the port masks by index."""
    q, k, v, _ = _qkv(2, 2, 130, 16, seed=31)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_attention.flash_attention(*(jnp.asarray(t, dtype) for t in (q, k, v)),
                                            causal=causal, impl="pallas")
    ref = np.asarray(ref, np.float32)
    launches = A.flash_attention.launches
    out = A.flash_attention(*(_t(t).to(getattr(torch, dtype)) for t in (q, k, v)),
                            causal=causal, impl="kernel")
    assert out.dtype == getattr(torch, dtype) and A.flash_attention.launches == launches
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == "float32" else \
        dict(atol=BF16_ATOL, rtol=BF16_RTOL)
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)


@pytest.mark.parametrize("branch", ["kernel", "xla"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_bwd_matches_jax_vjp(causal, branch, monkeypatch):
    """K5's plain version against jax.vjp of flash_attention, through the
    JAX backward's kernel (2·h·L_pad²·4 = 1 MiB, inside its 10 MiB budget)
    and, with the budget set to 0, its XLA recompute."""
    if branch == "xla":
        monkeypatch.setattr(jax_attention, "_BWD_VMEM_BUDGET", 0)
    q, k, v, g = _qkv(2, 2, 130, 16, seed=32)

    def f(q, k, v):
        return jax_attention.flash_attention(q, k, v, causal=causal, impl="pallas")

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v)))
        refs = vjp(jnp.asarray(g))
    launches = A.flash_bwd.launches
    grads = A.flash_bwd(_t(q), _t(k), _t(v), _t(g), None, None, causal=causal)
    assert A.flash_bwd.launches == launches
    for name, ours, ref in zip("qkv", grads, refs):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-3,
                                   err_msg=f"d{name}")

    # the CPU route of flash_attention differentiates its plain forward to the same
    leaves = [_t(t).requires_grad_() for t in (q, k, v)]
    A.flash_attention(*leaves, causal=causal, impl="kernel").backward(_t(g))
    for name, leaf, ours in zip("qkv", leaves, grads):
        np.testing.assert_allclose(leaf.grad.numpy(), ours.numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# RoPE and the rms norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    rng = np.random.default_rng(33)
    x = rng.normal(size=(2, 3, 40, 16)).astype(np.float32)
    cos, sin = jax_rope.rope_angles(jnp.arange(40), 16, 500000.0)
    ref = jax_rope.apply_rope(jnp.asarray(x, dtype), cos, sin)
    tcos, tsin = rope.rope_angles(torch.arange(40), 16, 500000.0)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(cos), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(sin), atol=1e-6, rtol=0)
    out = rope.apply_rope(_t(x).to(getattr(torch, dtype)), tcos, tsin)
    assert out.dtype == getattr(torch, dtype)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(34)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32)
    w = rng.normal(size=(48,)).astype(np.float32)
    ref = jax_norms.apply_norm({"weight": jnp.asarray(w)}, jnp.asarray(x, dtype), kind="rms",
                               eps=1e-5)
    norm = RMSNorm(48, False, 1e-5, device=torch.device("cpu"))
    with torch.no_grad():
        norm.weight.copy_(_t(w))
        out = norm(_t(x).to(getattr(torch, dtype)))
    # bf16: both round the same float32 result once to bfloat16.
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=1e-5 if dtype == "float32" else 1e-2, rtol=RTOL)


# ---------------------------------------------------------------------------
# The tiny Llama
# ---------------------------------------------------------------------------


def test_llama_tiny_matches_jax():
    jm, tm = _pair(_llama())
    cfg = tm.config
    assert cfg.uses_rope and cfg.uses_gqa and cfg.kv_dim == 32 and not cfg.weight_tying
    toks = np.random.default_rng(35).integers(0, 256, size=(2, 24)).astype(np.int32)
    ref = np.asarray(jm.apply(jm.params, jnp.asarray(toks)))
    ref_hidden = np.asarray(jm.apply(jm.params, jnp.asarray(toks), return_hidden=True))
    _, ref_att = apply_transformer(jm.params, jm.config, jnp.asarray(toks), verbose=True)
    with torch.inference_mode():
        logits = tm.apply(_t(toks))
        hidden = tm.apply(_t(toks), return_hidden=True)
        _, att = tm.apply(_t(toks), verbose=True)
    assert logits.dtype == torch.float32 and logits.shape == (2, 24, 256)
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(hidden.numpy(), ref_hidden, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(att.numpy(), np.asarray(ref_att), atol=ATOL, rtol=RTOL)


def test_llama_train_steps_match_jax():
    """Three AdamW steps (weight decay on every parameter), cosine schedule,
    clip 1.0 and the fused loss through the untied head."""
    opt_cfg = {"optimizer": "adamw", "lr": 1e-3, "weight_decay": 0.1}
    sched_cfg = {"scheduler": "cosine", "warmup": 1}
    jm, tm = _pair(_llama())
    jschedule = jax_optim.build_scheduler(sched_cfg, n_steps=10)
    tx, _ = jax_optim.build_optimizer(opt_cfg, schedule=jschedule, grad_clip=1.0)
    jstep = jax_make_train_step(jm.apply, tx, schedule=jschedule, base_lr=1e-3, donate=False,
                                hidden_loss=jax_ops.make_fused_head_loss(jm.config, chunk=48))
    jstate = jax_init_train_state(jm.params, tx)

    schedule = optim.build_scheduler(sched_cfg, n_steps=10)
    opt, sched = optim.build_optimizer(opt_cfg, tm.module, schedule=schedule)
    step = make_train_step(schedule=schedule, base_lr=1e-3, grad_clip=1.0,
                           hidden_loss=ops.make_fused_head_loss(tm.config, chunk=48))
    state = init_train_state(tm, opt, sched)
    start = {n: p.detach().clone() for n, p in tm.module.named_parameters()}

    rng = np.random.default_rng(36)
    for _ in range(3):
        toks = rng.integers(0, 256, size=(4, 32)).astype(np.int32)
        jstate, ref = jstep(jstate, (jnp.asarray(toks), jnp.asarray(toks)))
        metrics = step(state, (_t(toks), _t(toks)))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[key]), float(ref[key]), rtol=1e-5,
                                       err_msg=key)
    ref = from_jax_params(jax.tree.map(np.asarray, jstate.params))
    for name, p in tm.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
        assert not torch.equal(p.detach(), start[name]), name


def test_llama_bf16_flash_route_matches_jax(monkeypatch):
    """bfloat16 with the packed gate forced shut in both packages: the JAX
    package takes flash_attention (Pallas, interpret mode), the port its
    flash route (on the CPU, K4's plain version), rope rotated and kv heads
    repeated in both (tests/test_llama.py:161-193)."""
    config = _llama(compute_dtype="bfloat16", attn_impl="pallas", norm_impl="xla")
    jm, tm = _pair(config)
    monkeypatch.setattr(jax_attention, "packed_mha_supported", lambda *a, **k: False)
    monkeypatch.setattr(A, "packed_mha_supported", lambda *a, **k: False)
    calls = []
    monkeypatch.setattr(T, "flash_attention",
                        lambda *a, **k: calls.append(k) or A.flash_attention(*a, **k))
    toks = np.random.default_rng(37).integers(0, 256, size=(2, 16)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(apply_transformer(jm.params, jm.config, jnp.asarray(toks)), np.float32)
    with torch.inference_mode():
        got = tm.apply(_t(toks)).float().numpy()
    assert len(calls) == tm.config.n_layers and all(c["causal"] for c in calls)
    np.testing.assert_allclose(got, ref, atol=0.15, rtol=0.05)
    assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.9


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("l,e,h,packed", [
    (197, 768, 12, True),      # ViT-B/16
    (197, 1024, 16, True),     # ViT-L/16
    (257, 1280, 16, True),     # ViT-H/14: head width 80
    (1024, 768, 12, True),     # GPT-2 base
    (1024, 1600, 25, True),    # GPT-2 xl
    (512, 768, 12, True),      # Llama 124m
    (1024, 768, 12, True),     # Llama 124m
    (512, 2048, 32, True),     # Llama 1b
    (1024, 2048, 32, False),   # Llama 1b: past the budget (46.1 MB)
    (512, 4096, 32, True),     # Llama 8b: head width 128
    (578, 4096, 32, True),     # Llama 8b: the budget's last L (41.9 MB)
    (579, 4096, 32, False),    # Llama 8b: past the budget
    (1024, 4096, 32, False),   # Llama 8b
], ids=["vit_b_197", "vit_l_197", "vit_h_257", "gpt2_base_1024", "gpt2_xl_1024",
        "llama_124m_512", "llama_124m_1024", "llama_1b_512", "llama_1b_1024", "llama_8b_512",
        "llama_8b_578", "llama_8b_579", "llama_8b_1024"])
def test_packed_gate_matches_jax(l, e, h, packed):
    want = jax_attention.packed_mha_supported(l, e, 2)
    assert A.packed_mha_supported(l, e, h) == want
    for grouped in (False, True):
        route = A.attention_route("auto", "cuda", seq_len=l, emb_dim=e, n_heads=h,
                                  dtype=torch.bfloat16, grouped=grouped)
        assert route == ("packed" if want else "flash")
    assert want == packed


def test_float32_long_attention_routes_to_flash(monkeypatch):
    """On CUDA, float32 attention at L >= 512 resolves to the kernel route,
    which is K4 (it raised before K4 was ported), as the JAX package's
    multi_head_attention takes flash_attention there; below 512, and in the
    GQA/RoPE attention, float32 stays plain."""
    def route(l, dtype=torch.float32, grouped=False):
        return A.attention_route("auto", "cuda", seq_len=l, emb_dim=768, n_heads=12,
                                 dtype=dtype, grouped=grouped)

    assert route(512) == route(1024) == "flash"
    assert route(511) == route(197) == "plain"
    assert route(1024, grouped=True) == "plain"
    assert route(1024, torch.bfloat16) == "packed"
    assert A.attention_route("auto", "cpu", seq_len=1024, emb_dim=768, n_heads=12,
                             dtype=torch.float32) == "plain"

    # the kernel route runs through flash_attention, on the CPU its plain version
    calls, flash = [], A.flash_attention
    monkeypatch.setattr(A, "flash_attention", lambda *a, **k: calls.append(k) or flash(*a, **k))
    rng = np.random.default_rng(38)
    n, l, e, h = 1, 512, 32, 2
    x = rng.normal(size=(n, l, e)).astype(np.float32)
    wq = (rng.normal(size=(e, 3 * e)) / np.sqrt(e)).astype(np.float32)   # JAX (in, out)
    wo = (rng.normal(size=(e, e)) / np.sqrt(e)).astype(np.float32)
    ref = jax_attention.multi_head_attention(jnp.asarray(x), jnp.asarray(wq), None,
                                             jnp.asarray(wo), None, n_heads=h, causal=True,
                                             impl="xla")
    out = A.multi_head_attention(_t(x), _t(wq.T), None, _t(wo.T), None, n_heads=h,
                                 causal=True, impl="kernel")
    assert calls == [{"causal": True, "impl": "kernel"}]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# The 1b preset and the weight map
# ---------------------------------------------------------------------------


def test_llama_1b_names_and_shapes_match_jax():
    """Built on the meta device: no 1.5B allocation on either side."""
    with torch.device("meta"):
        tm = build_model(_llama("1b", seq_len=1024, compute_dtype="bfloat16"), device="meta")
    cfg = tm.config
    assert tm.name == "llama-1b" and cfg.seq_len == 1024 and cfg.causal
    assert (cfg.emb_dim, cfg.n_heads, cfg.n_kv_heads, cfg.rope_theta) == (2048, 32, 8, 500000.0)
    shapes = jax.eval_shape(lambda k: init_transformer(k, jax_llama.llama_transformer_config(
        jax_llama.LlamaConfig(model_name="1b", seq_len=1024))), jax.random.key(0))
    ref = {keystr_dotted(path): tuple(leaf.shape)
           for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    # linear weights are (in, out) in the JAX package, (out, in) here
    ref = {name: s[::-1] if name.endswith("weight") and len(s) == 2
           and name != "embedding.token_emb.weight" else s for name, s in ref.items()}
    ours = {name: tuple(p.shape) for name, p in tm.module.state_dict().items()}
    assert ours == ref
    assert sum(np.prod(s) for s in ours.values()) == 1_498_482_688


def test_llama_pretrained_without_local_file_keeps_random(tmp_path, caplog):
    with caplog.at_level("WARNING"):
        tm = build_model(_llama(pretrained=True, save_dir=str(tmp_path)), device="cpu")
    assert "Could not load pretrained weights for llama-tiny" in caplog.text
    assert tm.name == "llama-tiny"


def test_hf_llama_weight_map_matches_jax():
    """A random state dict under HuggingFace's LlamaForCausalLM names (tiny
    geometry) maps to the same arrays in both packages, and loads into the
    port's model, whose logits then equal the JAX model's on the same dict."""
    rng = np.random.default_rng(39)
    e, kvd, f, v, layers = 64, 32, 128, 256, 2
    hf = {"model.embed_tokens.weight": (v, e), "model.norm.weight": (e,),
          "lm_head.weight": (v, e)}
    for i in range(layers):
        p = f"model.layers.{i}."
        hf.update({p + "input_layernorm.weight": (e,),
                   p + "post_attention_layernorm.weight": (e,),
                   p + "self_attn.q_proj.weight": (e, e), p + "self_attn.k_proj.weight": (kvd, e),
                   p + "self_attn.v_proj.weight": (kvd, e), p + "self_attn.o_proj.weight": (e, e),
                   p + "mlp.gate_proj.weight": (f, e), p + "mlp.up_proj.weight": (f, e),
                   p + "mlp.down_proj.weight": (e, f)})
    hf = {name: (rng.normal(size=shape) * 0.1).astype(np.float32) for name, shape in hf.items()}

    ours = hf_llama_to_vitef(dict(hf), layers)
    ref = jax_torch_import.hf_llama_to_vitef(dict(hf), layers)
    assert ours.keys() == ref.keys()
    for name in ref:
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)

    jm = jax_build_model(_llama(), key=jax.random.key(0))
    params = jax_torch_import.from_vitef_state_dict(dict(ref), layers)
    tm = build_model(_llama(), device="cpu")
    tm.module.load_state_dict(from_vitef_state_dict(ours, layers))
    toks = rng.integers(0, v, size=(2, 12)).astype(np.int32)
    with torch.inference_mode():
        np.testing.assert_allclose(tm.apply(_t(toks)).numpy(),
                                   np.asarray(jm.apply(params, jnp.asarray(toks))),
                                   atol=1e-4, rtol=1e-4)
