"""The port's read-outs (the plasticity decomposition, the probes and the two
apps built on them) vs the JAX package, on the CPU in float32 at a small size.

The same parameters (carried across by ``from_jax_params``) and the same
numpy inputs go through ``vitef_tpu``'s ``get_decomposition``/``get_probes``
and ``apps/vit`` functions and their counterparts in ``vitef_tpu_torch``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apps.vit import analysis as jax_analysis
from apps.vit import linear_probing as jax_probing
from vitef_tpu.models import build_model as jax_build_model
from vitef_tpu_torch.apps.vit import analysis, linear_probing
from vitef_tpu_torch.models import build_model, from_jax_params

VIT = {"implementation": "vit", "model_name": "tiny", "patch_size": 8,
       "image_dim": (3, 32, 32), "finetuning": True, "n_classes": 10}
TRANSFORMER = {"implementation": "transformer", "image_dim": (3, 32, 32),
               "patch_type": "computer_vision", "patch_size": 8, "emb_type": "linear",
               "emb_dim": 64, "n_heads": 4, "n_layers": 2, "attn_bias": True,
               "ffn_bias": True, "norm": "layer", "norm_bias": True, "norm_eps": 1e-12,
               "cls_token": True, "output_type": "classification", "n_classes": 10}
CONFIGS = {"vit_pre_norm": VIT, "transformer_post_norm": {**TRANSFORMER, "pre_norm": False}}
TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(config, seed=0):
    """(JAX model, port model) of one float32 config holding the same parameters."""
    config = {**config, "compute_dtype": "float32"}
    jm = jax_build_model(config, key=jax.random.key(seed))
    tm = build_model({**config, "norm_impl": "kernel"}, device="cpu")
    tm.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jm.params)))
    return jm, tm


def _images(n=4, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 3, 32, 32)).astype(np.float32)


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)  # a jitted JAX function returns its keys sorted
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decomposition_matches_jax(name):
    jm, tm = _pair(CONFIGS[name])
    x = _images()
    want = jm.get_decomposition(jm.params, jnp.asarray(x))
    got = tm.get_decomposition(torch.from_numpy(x))
    assert len(got) == 1 + 5 * 2 and "block1_ffn_fc2" in got
    _assert_same(got, want)
    # No advance: every block decomposes the embedding output; fc2 reads it
    # zero-padded to ffn_dim.
    emb = got["embedding"]
    block = tm.module.blocks[1]
    with torch.inference_mode():
        np.testing.assert_allclose(got["block1_attn_norm"].numpy(),
                                   block.attn_norm(emb).numpy(), atol=1e-6)
        fc2 = block.ffn.fc2
        want_fc2 = emb @ fc2.weight[:, :emb.shape[-1]].T + fc2.bias
    np.testing.assert_allclose(got["block1_ffn_fc2"].numpy(), want_fc2.numpy(), atol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_probes_match_jax(name):
    jm, tm = _pair(CONFIGS[name])
    x = _images(seed=1)
    want = jm.get_probes(jm.params, jnp.asarray(x))
    got = tm.get_probes(torch.from_numpy(x))
    assert len(got) == 8 * 2
    _assert_same(got, want)
    # The state advances: block 1 starts from block 0's last stage.
    last = "block0_ffn_res" if CONFIGS[name].get("pre_norm", True) else "block0_ffn_norm"
    with torch.inference_mode():
        _, block1 = tm.module.blocks[1].probes(got[last])
    np.testing.assert_allclose(block1["attn"].numpy(), got["block1_attn"].numpy(), atol=1e-6)


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_distance_matches_jax(reduction):
    rng = np.random.default_rng(4)
    x, y = (rng.normal(size=(3, 5, 7)).astype(np.float32) for _ in range(2))
    want = jax_analysis.distance(jnp.asarray(x), jnp.asarray(y), reduction)
    got = analysis.distance(torch.from_numpy(x), torch.from_numpy(y), reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    # a 2-D cloud gains a batch dimension
    two_d = analysis.distance(torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    assert two_d.shape == (1,)
    with pytest.raises(ValueError):
        analysis.distance(torch.from_numpy(x), torch.from_numpy(y), "max")


def test_decomposition_distance_fn_matches_jax():
    jm, tm = _pair(VIT)
    x1, x2 = _images(seed=5), _images(seed=6)
    want = jax_analysis.make_decomposition_distance_fn(jm)(jm.params, jnp.asarray(x1),
                                                            jnp.asarray(x2))
    got = analysis.make_decomposition_distance_fn(tm)(torch.from_numpy(x1),
                                                      torch.from_numpy(x2))
    assert all(v.shape == (4,) for v in got.values())
    _assert_same(got, want)


@pytest.mark.parametrize("cls_pooling", [False, True], ids=["mean", "cls"])
def test_probe_embeddings_match_jax(cls_pooling):
    jm, tm = _pair(VIT)
    batches = [(_images(seed=7 + i), np.arange(4) % 3) for i in range(2)]
    want, want_labels = jax_probing.get_embeddings(
        jm, jm.params, [(jnp.asarray(x), y) for x, y in batches], cls_pooling)
    got, labels = linear_probing.get_embeddings(
        tm, [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches], cls_pooling)
    assert sorted(got) == sorted(want) and len(got) == 16
    for key in want:
        assert got[key].shape == (8, np.asarray(want[key]).shape[1])
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
    np.testing.assert_array_equal(labels, want_labels)


def test_linear_probing_torch_and_sklearn_probes():
    """Both probe impls run over every key (``"jax"`` is the on-device
    probe's alias); an unknown impl raises."""
    _, tm = _pair(VIT)
    rng = np.random.default_rng(8)
    train = [(torch.from_numpy(_images(seed=9 + i)), torch.from_numpy(rng.integers(0, 2, 4)))
             for i in range(2)]
    test = [(torch.from_numpy(_images(seed=11)), torch.from_numpy(rng.integers(0, 2, 4)))]
    for impl in ("jax", "sklearn"):
        metrics = linear_probing.run_linear_probing(tm, train, test, cls_pooling=False, seed=0,
                                                    probe_impl=impl)
        assert len(metrics) == 16 and all(0.0 <= v <= 1.0 for v in metrics.values())
    with pytest.raises(ValueError):
        linear_probing.run_linear_probing(tm, train, test, False, 0, probe_impl="bogus")


def test_tree_helpers_and_seed_match_jax(tmp_path):
    from vitef_tpu import config as jax_config
    from vitef_tpu.utils import tree as jax_tree
    from vitef_tpu_torch import config
    from vitef_tpu_torch.utils import tree

    rng = np.random.default_rng(12)
    batches = [{"a": rng.normal(size=(2, 3)), "b": rng.normal(size=(2,))} for _ in range(3)]
    want, got = {}, {}
    for batch in batches:
        jax_tree.update_dict(want, batch)
        tree.update_dict(got, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    cfg = {"dir": tmp_path, "dims": (tmp_path, 3), "nested": {"p": tmp_path}, "n": 1}
    assert tree.json_serializable(cfg) == jax_tree.json_serializable(cfg)
    assert tree.get_numpy(torch.tensor(2.0)).shape == jax_tree.get_numpy(2.0).shape == (1,)
    assert tree.get_valid_tensor(np.zeros((4, 5))).shape == (1, 4, 5)
    assert config.MODEL_DIR == jax_config.MODEL_DIR and config.SAVING_DIR == jax_config.SAVING_DIR
    gen, tgen = config.set_seed(5)
    first = (np.random.rand(), gen.random(), torch.rand(1, generator=tgen).item())
    gen, tgen = config.set_seed(5)
    assert first == (np.random.rand(), gen.random(), torch.rand(1, generator=tgen).item())
