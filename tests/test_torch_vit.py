"""The port's ViT slice vs the JAX package, on the CPU at a small size.

Same parameters (carried across by ``from_jax_params``) and the same numpy
inputs go through ``vitef_tpu``'s ``Model.apply`` (the XLA path on the CPU)
and the port's module; eval steps, the synthetic test-mode loader and the
evaluation loop are compared too.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vitef_tpu.data.images import build_loader as jax_build_loader
from vitef_tpu.models import build_model as jax_build_model
from vitef_tpu.models.torch_import import from_vitef_state_dict as jax_from_vitef
from vitef_tpu_torch.data.images import build_loader
from vitef_tpu_torch.eval import run_evaluation
from vitef_tpu_torch.models import build_model, from_jax_params, from_vitef_state_dict

VIT = {"implementation": "vit", "model_name": "tiny", "patch_size": 8,
       "image_dim": (3, 32, 32), "finetuning": True, "n_classes": 10}
TRANSFORMER = {"implementation": "transformer", "image_dim": (3, 32, 32),
               "patch_type": "computer_vision", "patch_size": 8, "emb_type": "linear",
               "emb_dim": 64, "n_heads": 4, "n_layers": 2, "attn_bias": True,
               "ffn_bias": True, "norm": "layer", "norm_bias": True, "norm_eps": 1e-12,
               "pre_norm": True, "cls_token": True, "output_type": "classification",
               "n_classes": 10}


def _pair(config, dtype="float32", seed=0):
    """(JAX model, port model) of one config holding the same parameters."""
    config = {**config, "compute_dtype": dtype}
    jm = jax_build_model(config, key=jax.random.key(seed))
    tm = build_model(config, device="cpu")
    tm.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jm.params)))
    return jm, tm


def _images(n=6, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 3, 32, 32)).astype(np.float32)


def test_from_jax_params_carries_every_parameter():
    jm = jax_build_model(VIT, key=jax.random.key(1))
    tree = jax.tree.map(np.asarray, jm.params)
    state = from_jax_params(tree)
    tm = build_model(VIT, device="cpu")
    tm.module.load_state_dict(state)  # strict: same names, same shapes
    ported = tm.module.state_dict()
    qkv = tree["blocks"][1]["attn"]["qkv_mat"]["weight"]
    np.testing.assert_array_equal(ported["blocks.1.attn.qkv_mat.weight"].numpy(), qkv.T)
    np.testing.assert_array_equal(ported["embedding.pos_emb"].numpy(),
                                  tree["embedding"]["pos_emb"])
    assert len(ported) == len(jax.tree.leaves(tree))


def test_from_vitef_state_dict_agrees_with_jax_import():
    """A torch-layout cache loads to the same state either way round."""
    jm = jax_build_model(VIT, key=jax.random.key(2))
    port_state = from_jax_params(jax.tree.map(np.asarray, jm.params))
    rng = np.random.default_rng(0)
    sd = {}
    for name, value in port_state.items():
        value = rng.normal(size=tuple(value.shape)).astype(np.float32)
        if name == "embedding.patching.conv.weight":
            value = value.reshape(32, 3, 8, 8)  # the Conv2d layout (E, C, P, P)
        name = name.replace("embedding.patching.conv", "embedding.patching.patching.0")
        name = name.replace("output_layer.norm", "output_layer.output_norm")
        name = name.replace("output_layer.head", "output_layer.output")
        sd[name] = value
    direct = from_vitef_state_dict(dict(sd), n_layers=2)
    via_jax = from_jax_params(jax.tree.map(np.asarray, jax_from_vitef(dict(sd), 2)))
    assert sorted(direct) == sorted(via_jax)
    for name in direct:
        np.testing.assert_array_equal(direct[name].numpy(), via_jax[name].numpy(), name)


@pytest.mark.parametrize("config", [VIT, TRANSFORMER], ids=["vit", "transformer"])
def test_fp32_logits_match_jax(config):
    jm, tm = _pair(config)
    x = _images()
    ref = np.asarray(jm.apply(jm.params, jnp.asarray(x)))
    with torch.inference_mode():
        out = tm.apply(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_bf16_logits_match_jax():
    jm, tm = _pair(VIT, dtype="bfloat16")
    x = _images()
    ref = np.asarray(jm.apply(jm.params, jnp.asarray(x)))
    with torch.inference_mode():
        out = tm.apply(torch.from_numpy(x)).numpy()
    # Both run bfloat16 activations, but round at different places (XLA fuses
    # and keeps some intermediates in float32; the tanh-gelu is evaluated
    # differently) — each bf16 rounding is ~2^-9 relative, and two blocks plus
    # the head compound them. Logits here are O(1).
    np.testing.assert_allclose(out, ref, atol=5e-2, rtol=5e-2)
    assert np.abs(out - ref).mean() < 1e-2


def test_verbose_attention_weights_match_jax():
    jm, tm = _pair(VIT)
    x = _images(4)
    ref_logits, ref_att = jm.apply(jm.params, jnp.asarray(x), verbose=True)
    with torch.inference_mode():
        logits, att = tm.apply(torch.from_numpy(x), verbose=True)
    assert tuple(att.shape) == (2, 4, 2, 17, 17)
    np.testing.assert_allclose(att.numpy(), np.asarray(ref_att), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4, rtol=1e-4)


def test_eval_step_matches_jax():
    jm, tm = _pair(VIT)
    x = _images(8, seed=3)
    y = np.arange(8) % 10
    ref_acc, ref_loss = jm.eval_step(jm.params, (jnp.asarray(x), jnp.asarray(y)))
    acc, loss = tm.eval_step((torch.from_numpy(x), torch.from_numpy(y)))
    assert float(acc) == float(ref_acc)
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-5, rtol=1e-5)


LOADER = {"dataset_name": "synthetic-48", "mode": "test", "batch_size": 16, "size": 32,
          "prefetch": 0}


def test_synthetic_loader_matches_jax():
    ref = list(jax_build_loader(LOADER))
    ours = list(build_loader(LOADER, device="cpu"))
    assert len(ours) == len(ref) == 3
    for (x, y), (rx, ry) in zip(ours, ref):
        assert x.dtype == torch.float32 and tuple(x.shape) == (16, 3, 32, 32)
        np.testing.assert_allclose(x.numpy(), np.asarray(rx), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(y.numpy(), np.asarray(ry))


def test_run_evaluation_matches_jax():
    jm, tm = _pair(VIT)
    config = {**LOADER, "size": 32}
    steps = [jm.eval_step(jm.params, batch) for batch in jax_build_loader(config)]
    ref_acc = np.mean([float(a) for a, _ in steps])
    ref_loss = np.mean([float(l) for _, l in steps])
    got = run_evaluation(tm, build_loader(config, device="cpu"))
    np.testing.assert_allclose(got["eval_acc"], ref_acc, atol=1e-6)
    np.testing.assert_allclose(got["eval_loss"], ref_loss, atol=1e-5, rtol=1e-5)


def _vitef_state_dict(state: dict, patch: int) -> dict:
    """The port's state dict renamed to the vitef (torch-layout) names that a
    weight cache holds."""
    sd = {}
    for name, value in state.items():
        if name == "embedding.patching.conv.weight":
            value = value.reshape(value.shape[0], 3, patch, patch)  # Conv2d (E, C, P, P)
        name = name.replace("embedding.patching.conv", "embedding.patching.patching.0")
        name = name.replace("output_layer.norm", "output_layer.output_norm")
        name = name.replace("output_layer.head", "output_layer.output")
        sd[name] = value.clone()
    return sd


def test_pretrained_reads_pt_when_npz_is_missing(tmp_path, monkeypatch):
    from vitef_tpu_torch.models import vit as vit_module

    config = {**VIT, "finetuning": False, "seed": 1}
    source = build_model(config, device="cpu")
    name = vit_module.vit_model_name(vit_module.ViTConfig(model_name="tiny", patch_size=8,
                                                          image_dim=(3, 32, 32)))
    torch.save(_vitef_state_dict(source.module.state_dict(), 8), tmp_path / f"{name}.pt")
    monkeypatch.setattr(vit_module, "AVAILABLE_PRETRAINED", [name])
    loaded = build_model({**config, "seed": 2, "pretrained": True, "save_dir": str(tmp_path)},
                         device="cpu")
    for key, value in source.module.state_dict().items():
        assert torch.equal(loaded.module.state_dict()[key], value), key


def test_pretrained_without_cache_warns_and_keeps_random_init(tmp_path, monkeypatch, caplog):
    from vitef_tpu_torch.models import vit as vit_module

    monkeypatch.setattr(vit_module, "AVAILABLE_PRETRAINED", ["vit-tiny-patch8-32"])
    config = {**VIT, "finetuning": False, "seed": 3}
    with caplog.at_level("WARNING"):
        tm = build_model({**config, "pretrained": True, "save_dir": str(tmp_path)},
                         device="cpu")
    assert "Could not load pretrained weights for vit-tiny-patch8-32" in caplog.text
    random_init = build_model(config, device="cpu").module.state_dict()
    for key, value in tm.module.state_dict().items():
        assert torch.equal(value, random_init[key]), key
