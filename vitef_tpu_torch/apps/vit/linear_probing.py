"""Linear probing of hidden representations after every ViT sub-component.

Counterpart of ``apps/vit/linear_probing.py`` (``make_probe_embed_fn``
:43-55, ``get_embeddings`` :58-73, ``run_linear_probing`` :76-115):
``get_probes``, the pooling and the float32 cast run on the model's device,
so only the pooled (N, E) embeddings cross to the host, where they are
L2-normalised. The probe is sklearn's ``StandardScaler`` +
``LogisticRegression(max_iter=5000)`` (``probe_impl="sklearn"``, the
default), or the same objective by L-BFGS on the model's device
(``probe_impl="torch"``, or the JAX app's name ``"jax"``;
:mod:`vitef_tpu_torch.probe`). ``LinearProbingConfig`` and the
``linear_probing()`` driver, which read checkpoints and datasets, are not
ported yet.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...utils.tree import get_numpy

def make_probe_embed_fn(model, cls_pooling: bool):
    """``x -> {key: pooled float32 (N, E) embedding}`` of every probe key:
    the CLS token, or the mean over tokens."""

    def probe_embed(x: torch.Tensor) -> dict:
        probes = model.get_probes(x)
        with torch.inference_mode():
            return {key: (val[:, 0, :] if cls_pooling else val.mean(dim=1)).float()
                    for key, val in probes.items()}

    return probe_embed


def get_embeddings(model, loader, cls_pooling: bool) -> tuple[dict, np.ndarray]:
    """L2-normalised pooled embeddings per probe key over ``loader``'s
    ``(x, y)`` batches, and the labels, as host numpy arrays."""
    probe_embed = make_probe_embed_fn(model, cls_pooling)
    embeddings: dict[str, list] = {}
    labels = []
    for x_batch, y_batch in loader:
        for key, emb in probe_embed(x_batch).items():
            embeddings.setdefault(key, []).append(get_numpy(emb))
        labels.append(get_numpy(y_batch))
    out = {}
    for key, value in embeddings.items():
        value = np.concatenate(value)
        out[key] = value / np.linalg.norm(value, axis=-1, keepdims=True)
    return out, np.concatenate(labels)


def run_linear_probing(model, train_loader, test_loader, cls_pooling: bool, seed: int,
                       probe_impl: str = "sklearn") -> dict[str, Any]:
    """Test accuracy of a linear probe fitted on each key's train embeddings.

    ``probe_impl="sklearn"`` is the reference's host probe; a missing sklearn
    raises ``ImportError``. ``"torch"`` (or ``"jax"``) fits the same
    objective on the model's device."""
    # "jax", the JAX app's name for its on-device probe, so that one config
    # drives both packages
    impl = "torch" if probe_impl == "jax" else probe_impl
    if impl not in ("sklearn", "torch"):
        raise ValueError(f"unknown probe_impl {probe_impl!r}; choose sklearn/torch/jax")
    train_embeddings, train_labels = get_embeddings(model, train_loader, cls_pooling)
    test_embeddings, test_labels = get_embeddings(model, test_loader, cls_pooling)
    train_labels, test_labels = train_labels.ravel(), test_labels.ravel()

    metrics = {}
    if impl == "torch":
        from ...probe import probe_accuracy_torch

        device = next(model.module.parameters()).device
        for key in train_embeddings:
            metrics[key] = probe_accuracy_torch(train_embeddings[key], train_labels,
                                                test_embeddings[key], test_labels,
                                                device=device)
        return metrics

    from sklearn.linear_model import LogisticRegression
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler

    clf = make_pipeline(StandardScaler(), LogisticRegression(max_iter=5000, random_state=seed))
    for key in train_embeddings:
        clf.fit(train_embeddings[key], train_labels)
        metrics[key] = clf.score(test_embeddings[key], test_labels)
    return metrics
