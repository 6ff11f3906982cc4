"""The port's GPT-2 causal-LM training slice vs the JAX package, on the CPU.

The same seeded numpy inputs go through both packages: causal packed
attention and its gradients against the JAX package's Pallas kernels in
interpret mode (as tests/test_ops.py runs them), in both of its branches (the
full-L causal kernel at L=65 and the block-triangular one with K3 at L=512);
the next-token and fused head+CE losses and their gradients; a GPT-2-shaped
model's logits and hidden; GPT-2 base's parameter names and shapes; the
HuggingFace weight map; and three AdamW train steps with the fused loss.
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
from vitef_tpu.models import gpt2 as jax_gpt2
from vitef_tpu.models import torch_import as jax_torch_import
from vitef_tpu.models.transformer import init_transformer
from vitef_tpu.ops import attention as jax_attention
from vitef_tpu.parallel import init_train_state as jax_init_train_state
from vitef_tpu.parallel import make_train_step as jax_make_train_step
from vitef_tpu.utils.tree import keystr_dotted
from vitef_tpu_torch import ops, optim
from vitef_tpu_torch.models import (GPT2Config, build_model, from_jax_params,
                                    from_vitef_state_dict, gpt2_transformer_config,
                                    hf_gpt2_to_vitef)
from vitef_tpu_torch.ops import attention as A
from vitef_tpu_torch.parallel import init_train_state, make_train_step

# GPT-2's fixed arguments (vitef_tpu/models/gpt2.py:52-82) at a small width.
GPT2_SMALL = {
    "implementation": "transformer", "patch_type": None, "vocab_size": 97,
    "emb_type": "dict", "emb_dim": 32, "n_heads": 2, "n_layers": 2, "pos_emb": True,
    "seq_len": 64, "attn_bias": True, "flash": True, "causal": True, "activation": "gelu",
    "ffn_bias": True, "norm": "layer", "norm_bias": True, "norm_eps": 1e-5,
    "pre_norm": True, "cls_token": False, "output_type": "sequence_to_sequence",
    "weight_tying": True, "dropout": 0.0,
}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(config, seed=0):
    """(JAX model, port model) of one config holding the same parameters."""
    jm = jax_build_model(config, key=jax.random.key(seed))
    tm = build_model(config, device="cpu")
    tm.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jm.params)))
    return jm, tm


# ---------------------------------------------------------------------------
# Causal packed attention: K1's causal modes and K3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,h,l,d,blocked", [(2, 2, 65, 16, False), (1, 2, 512, 16, True)],
                         ids=["full_L65", "blocked_L512"])
def test_causal_packed_mha_matches_jax_kernels(n, h, l, d, blocked):
    assert (jax_attention._causal_q_block(l, True) == 256) == blocked
    e = h * d
    rng = np.random.default_rng(21)
    qkv = (rng.normal(size=(n, l, 3 * e)) * 0.5).astype(np.float32)
    bias = (rng.normal(size=(3 * e,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(n, l, e)).astype(np.float32)

    def loss(qkv, bias):
        return (jax_attention.fused_mha_packed(qkv, h, causal=True, bias=bias) * g).sum()

    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_attention.fused_mha_packed(jnp.asarray(qkv), h, causal=True,
                                                        bias=jnp.asarray(bias)))
        ref_dqkv, ref_db = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(bias))

    launches = (A.fused_mha_packed.launches, A.packed_mha_bwd.launches)
    qkv_t, bias_t = _t(qkv).requires_grad_(), _t(bias).requires_grad_()
    out = A.fused_mha_packed(qkv_t, h, causal=True, bias=bias_t)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=2e-5, rtol=1e-4)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(qkv_t.grad.numpy(), np.asarray(ref_dqkv), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(bias_t.grad.numpy(), np.asarray(ref_db), atol=1e-3, rtol=1e-3)

    # K3's wrapper on the CPU is its plain version (the residuals are unused)
    dqkv, db = A.packed_mha_bwd(_t(qkv), _t(bias), _t(g), None, None, h, causal=True)
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(ref_dqkv), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(db.numpy(), np.asarray(ref_db), atol=1e-3, rtol=1e-3)
    assert (A.fused_mha_packed.launches, A.packed_mha_bwd.launches) == launches


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def test_next_token_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 9, 31)).astype(np.float32)
    toks = rng.integers(1, 31, size=(2, 9)).astype(np.int32)
    toks[0, 5:] = 0
    for ignore in (None, 0):
        ref, ref_g = jax.value_and_grad(
            lambda lg: jax_ops.next_token_cross_entropy(lg, jnp.asarray(toks),
                                                        ignore_index=ignore))(jnp.asarray(logits))
        lg = _t(logits).requires_grad_()
        ours = ops.next_token_cross_entropy(lg, _t(toks), ignore_index=ignore)
        ours.backward()
        np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-6)
        np.testing.assert_allclose(lg.grad.numpy(), np.asarray(ref_g), atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("layout", ["tied", "untied_bias"])
@pytest.mark.parametrize("ignore_index", [None, 5], ids=["all", "ignore5"])
def test_fused_next_token_ce_matches_jax(layout, ignore_index):
    n, l, d, v = 2, 33, 32, 97
    rng = np.random.default_rng(3)
    hidden = rng.normal(size=(n, l, d)).astype(np.float32)
    toks = rng.integers(0, v, size=(n, l)).astype(np.int32)
    toks[1, 20:] = 5
    tied = layout == "tied"
    w = (rng.normal(size=(v, d) if tied else (d, v)) * 0.2).astype(np.float32)
    b = None if tied else (rng.normal(size=(v,)) * 0.1).astype(np.float32)
    w_layout = "vd" if tied else "dv"
    kw = dict(w_layout=w_layout, ignore_index=ignore_index, chunk=16)  # 64 rows: 4 chunks

    def jax_loss(h, w, b):
        return jax_ops.fused_next_token_ce(h, w, jnp.asarray(toks), bias=b, **kw)

    args = [jnp.asarray(hidden), jnp.asarray(w)] + ([] if tied else [jnp.asarray(b)])
    if tied:
        ref, ref_grads = jax.value_and_grad(lambda h, w: jax_loss(h, w, None),
                                            argnums=(0, 1))(*args)
    else:
        ref, ref_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(*args)

    leaves = [_t(a).requires_grad_() for a in (hidden, w) + (() if tied else (b,))]
    ours = ops.fused_next_token_ce(leaves[0], leaves[1], _t(toks),
                                   bias=None if tied else leaves[2], **kw)
    ours.backward()
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours.item(), float(ref), **tol)
    for leaf, r in zip(leaves, ref_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), **tol)
    # the unfused loss over the materialised logits gives the same value
    logits = np.einsum("nld,vd->nlv", hidden, w) if tied else hidden @ w + b
    np.testing.assert_allclose(
        float(ops.next_token_cross_entropy(_t(logits), _t(toks), ignore_index=ignore_index)),
        float(ours), rtol=1e-5)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied_bias"])
def test_make_fused_head_loss_matches_jax(tied):
    config = {**GPT2_SMALL, "weight_tying": tied}
    jm, tm = _pair(config)
    rng = np.random.default_rng(4)
    params = jax.tree.map(jnp.asarray, jm.params)
    if not tied:  # give the untied head a bias in both packages
        b = (rng.normal(size=(97,)) * 0.1).astype(np.float32)
        params["output"]["output_layer"]["head"]["bias"] = jnp.asarray(b)
        tm.module.output.output_layer["head"].bias = torch.nn.Parameter(_t(b))
    hidden = rng.normal(size=(3, 21, 32)).astype(np.float32)
    toks = rng.integers(0, 97, size=(3, 21)).astype(np.int32)
    jloss = jax_ops.make_fused_head_loss(jm.config, ignore_index=7, chunk=16)
    ref, (ref_p, ref_h) = jax.value_and_grad(
        lambda p, h: jloss(p, h, jnp.asarray(toks)), argnums=(0, 1))(params, jnp.asarray(hidden))

    loss = ops.make_fused_head_loss(tm.config, ignore_index=7, chunk=16)
    h = _t(hidden).requires_grad_()
    ours = loss(tm.module, h, _t(toks))
    ours.backward()
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours.item(), float(ref), **tol)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(ref_h), **tol)
    ref_grads = from_jax_params(jax.tree.map(np.asarray, ref_p))
    names = ["embedding.token_emb.weight"] if tied else \
        ["output.output_layer.head.weight", "output.output_layer.head.bias"]
    grads = dict(tm.module.named_parameters())
    for name in names:
        np.testing.assert_allclose(grads[name].grad.numpy(), ref_grads[name].numpy(), **tol,
                                   err_msg=name)
    with pytest.raises(ValueError, match="seq2seq"):
        ops.make_fused_head_loss(build_model({**GPT2_SMALL, "output_type": "classification",
                                              "n_classes": 3}, device="cpu").config)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def test_gpt2_shaped_model_matches_jax():
    jm, tm = _pair(GPT2_SMALL)
    toks = np.random.default_rng(5).integers(0, 97, size=(2, 64)).astype(np.int32)
    ref = np.asarray(jm.apply(jm.params, jnp.asarray(toks)))
    ref_hidden = np.asarray(jm.apply(jm.params, jnp.asarray(toks), return_hidden=True))
    with torch.inference_mode():
        logits = tm.apply(_t(toks))
        hidden = tm.apply(_t(toks), return_hidden=True)
    assert logits.dtype == torch.float32 and logits.shape == (2, 64, 97)
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(hidden.numpy(), ref_hidden, atol=1e-4, rtol=1e-4)
    # causal: a later token does not change an earlier logit
    changed = toks.copy()
    changed[:, 40:] = (changed[:, 40:] + 1) % 97
    with torch.inference_mode():
        np.testing.assert_array_equal(tm.apply(_t(changed))[:, :40].numpy(),
                                      logits[:, :40].numpy())
    with pytest.raises(ValueError, match="seq2seq"):
        build_model({**GPT2_SMALL, "output_type": "classification", "n_classes": 3},
                    device="cpu").apply(_t(toks), return_hidden=True)


def test_gpt2_base_names_and_shapes_match_jax():
    tm = build_model({"implementation": "gpt2", "model_name": "base"}, device="meta")
    assert tm.name == "gpt2" and tm.config.causal and tm.config.seq_len == 1024
    shapes = jax.eval_shape(lambda k: init_transformer(k, jax_gpt2.gpt2_transformer_config(
        jax_gpt2.GPT2Config())), jax.random.key(0))
    ref = {keystr_dotted(path): tuple(leaf.shape)
           for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    # linear weights are (in, out) in the JAX package, (out, in) here
    ref = {name: s[::-1] if name.endswith("weight") and len(s) == 2
           and name != "embedding.token_emb.weight" else s for name, s in ref.items()}
    ours = {name: tuple(p.shape) for name, p in tm.module.state_dict().items()}
    assert ours == ref
    assert sum(np.prod(s) for s in ours.values()) == 124_439_808


def test_gpt2_pretrained_without_local_file_keeps_random(tmp_path, caplog):
    config = {"implementation": "gpt2", "model_name": "base", "pretrained": True,
              "save_dir": str(tmp_path)}
    with caplog.at_level("WARNING"):
        tm = build_model(config, device="meta")
    assert "Could not load pretrained weights for gpt2" in caplog.text
    assert tm.name == "gpt2"
    assert gpt2_transformer_config(GPT2Config()).weight_tying


def test_hf_gpt2_weight_map_matches_hf_logits():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_config = transformers.GPT2Config(n_layer=2, n_embd=64, n_head=2, vocab_size=97,
                                        n_positions=64, activation_function="gelu",
                                        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    hf_model = transformers.GPT2LMHeadModel(hf_config).eval()
    hf = {k: v.detach().numpy().copy() for k, v in hf_model.state_dict().items()}

    ours = hf_gpt2_to_vitef(dict(hf), 2)
    ref = jax_torch_import.hf_gpt2_to_vitef(dict(hf), 2)
    assert ours.keys() == ref.keys()
    for name in ref:
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)

    tm = build_model({**GPT2_SMALL, "emb_dim": 64}, device="cpu")
    tm.module.load_state_dict(from_vitef_state_dict(ours, 2, weight_tying=True))
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 97, size=(2, 64)))
    with torch.inference_mode():
        np.testing.assert_allclose(tm.apply(toks).numpy(), hf_model(toks).logits.numpy(),
                                   atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# Training with the fused head loss
# ---------------------------------------------------------------------------


def test_gpt2_train_steps_match_jax():
    """Three AdamW steps (weight decay on every parameter, as optax.adamw
    decays them), cosine schedule, clip 1.0 and the fused head+CE loss."""
    opt_cfg = {"optimizer": "adamw", "lr": 1e-3, "weight_decay": 0.1}
    sched_cfg = {"scheduler": "cosine", "warmup": 1}
    jm, tm = _pair(GPT2_SMALL)
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

    rng = np.random.default_rng(7)
    for _ in range(3):
        toks = rng.integers(0, 97, size=(4, 64)).astype(np.int32)
        jstate, ref = jstep(jstate, (jnp.asarray(toks), jnp.asarray(toks)))
        metrics = step(state, (_t(toks), _t(toks)))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[key]), float(ref[key]), rtol=1e-5,
                                       err_msg=key)
    ref = from_jax_params(jax.tree.map(np.asarray, jstate.params))
    e = GPT2_SMALL["emb_dim"]
    for name, p in tm.module.named_parameters():
        ours, theirs = p.detach().numpy(), ref[name].numpy()
        if name.endswith("attn.qkv_mat.bias"):
            # The key bias shifts every score of a query row by the same
            # amount, which the softmax ignores: its gradient is exactly 0,
            # and both packages hand Adam only rounding noise (~1e-9), which
            # Adam's normalised step turns into updates of up to ~lr. So the
            # key slice is held to the 2 steps of lr that can move it.
            key = slice(e, 2 * e)
            np.testing.assert_allclose(ours[key], theirs[key], atol=2e-3, rtol=0, err_msg=name)
            ours, theirs = np.delete(ours, np.s_[key]), np.delete(theirs, np.s_[key])
        np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=1e-4, err_msg=name)
        assert not torch.equal(p.detach(), start[name]), name
