"""The paper's model-size ablation on the port: ViT-L/16 and ViT-H/14, on the CPU.

ViT-H/14 is the one ViT preset whose head width is 80 (1280 / 16 heads), and
its patch of 14 gives L = 257 at 224 px. On seeded numpy inputs, against the
JAX package:

- the port's ``VIT_SIZES`` for ``large`` and ``huge``;
- both presets' parameter names and shapes (built on the meta device, no
  allocation);
- a ViT-H-shaped small model (head width 80, patch 14, 56 px so L = 17;
  emb 160, 2 heads, 2 layers, ffn 320) whose weights come over through
  ``from_jax_params``: its float32 logits at 1e-4 / 1e-4;
- one float32 train step of that model (SGD momentum 0.9 at lr 0.01, the
  cosine schedule, clip 1.0, 2 x 4 accumulation): loss, grad norm and the
  updated parameters.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vitef_tpu import optim as jax_optim
from vitef_tpu.models import build_model as jax_build_model
from vitef_tpu.models import vit as jax_vit
from vitef_tpu.models.transformer import init_transformer
from vitef_tpu.parallel import init_train_state as jax_init_train_state
from vitef_tpu.parallel import make_train_step as jax_make_train_step
from vitef_tpu.utils.tree import keystr_dotted
from vitef_tpu_torch import optim
from vitef_tpu_torch.models import build_model, from_jax_params
from vitef_tpu_torch.models import vit as port_vit
from vitef_tpu_torch.parallel import init_train_state, make_train_step

# ViT-H/14's head width and patch at a small size: the preset's fixed ViT
# arguments (vit_transformer_config) with emb 160 over 2 heads.
VIT_H_SMALL = {"implementation": "transformer", "image_dim": (3, 56, 56),
               "patch_type": "computer_vision", "image_patch": "hybrid", "patch_size": 14,
               "emb_type": "linear", "pos_emb": True, "emb_dim": 160, "n_heads": 2,
               "n_layers": 2, "ffn_dim": 320, "attn_bias": True, "activation": "gelu",
               "ffn_bias": True, "norm": "layer", "norm_bias": True, "norm_eps": 1e-12,
               "pre_norm": True, "cls_token": True, "output_type": "classification",
               "n_classes": 10, "compute_dtype": "float32"}
# float32 on both sides; only the order of summation differs (ROADMAP's
# whole-model tolerance).
ATOL, RTOL = 1e-4, 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(seed=0):
    """(JAX model, port model) of the small ViT-H holding the same parameters."""
    jm = jax_build_model(VIT_H_SMALL, key=jax.random.key(seed))
    tm = build_model(VIT_H_SMALL, device="cpu")
    tm.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jm.params)))
    return jm, tm


@pytest.mark.parametrize("size", ["large", "huge"])
def test_vit_sizes_match_jax(size):
    assert port_vit.VIT_SIZES[size] == jax_vit.VIT_SIZES[size]


@pytest.mark.parametrize("size,patch,n_params", [("large", 16, 304_326_632),
                                                 ("huge", 14, 632_045_800)],
                         ids=["vit_l16", "vit_h14"])
def test_preset_names_and_shapes_match_jax(size, patch, n_params):
    """Built on the meta device: no 632M allocation on either side."""
    config = {"implementation": "vit", "model_name": size, "patch_size": patch,
              "image_dim": (3, 224, 224), "compute_dtype": "bfloat16"}
    with torch.device("meta"):
        tm = build_model(config, device="meta")
    cfg = tm.config
    assert tm.name == f"vit-{size}-patch{patch}-224"
    assert cfg.emb_dim // cfg.n_heads == (80 if size == "huge" else 64)
    shapes = jax.eval_shape(lambda k: init_transformer(k, jax_vit.vit_transformer_config(
        jax_vit.ViTConfig(model_name=size, patch_size=patch))), jax.random.key(0))
    ref = {keystr_dotted(path): tuple(leaf.shape)
           for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    # linear weights are (in, out) in the JAX package, (out, in) here
    ref = {name: s[::-1] if name.endswith("weight") and len(s) == 2 else s
           for name, s in ref.items()}
    ours = {name: tuple(p.shape) for name, p in tm.module.state_dict().items()}
    assert ours == ref
    assert ours["embedding.pos_emb"][-2] == (224 // patch) ** 2 + 1   # 197 or 257 tokens
    assert sum(np.prod(s) for s in ours.values()) == n_params


def test_vit_h_small_logits_match_jax():
    jm, tm = _pair()
    x = np.random.default_rng(1).normal(size=(4, 3, 56, 56)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(jm.params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.apply(_t(x)).numpy()
    assert got.shape == (4, 10) and tm.config.seq_len == 17
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_vit_h_small_train_step_matches_jax():
    opt_cfg = {"optimizer": "sgd", "lr": 0.01, "momentum": 0.9}
    sched_cfg = {"scheduler": "cosine", "warmup": 0}   # lr 0.01 at the first step
    jm, tm = _pair(seed=2)
    jschedule = jax_optim.build_scheduler(sched_cfg, n_steps=10)
    tx, _ = jax_optim.build_optimizer(opt_cfg, schedule=jschedule, params=jm.params,
                                      grad_clip=1.0)
    jstep = jax_make_train_step(jm.apply, tx, grad_acc_steps=2, schedule=jschedule,
                                base_lr=0.01, donate=False)
    jstate = jax_init_train_state(jm.params, tx)
    schedule = optim.build_scheduler(sched_cfg, n_steps=10)
    opt, sched = optim.build_optimizer(opt_cfg, tm.module, schedule=schedule)
    step = make_train_step(grad_acc_steps=2, schedule=schedule, base_lr=0.01, grad_clip=1.0)
    state = init_train_state(tm, opt, sched)
    start = {n: p.detach().clone() for n, p in tm.module.named_parameters()}

    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 3, 56, 56)).astype(np.float32)
    y = rng.integers(0, 10, size=8)
    jstate, jm_metrics = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
    metrics = step(state, (_t(x), _t(y)))
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[key]), float(jm_metrics[key]), rtol=1e-4,
                                   atol=1e-7, err_msg=key)
    ref = from_jax_params(jax.tree.map(np.asarray, jstate.params))
    moved = 0
    for n, p in tm.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=n)
        moved += not torch.equal(p.detach(), start[n])
    assert moved == len(start)
