"""Multinomial logistic-regression probe on the model's device (L-BFGS),
sklearn-compatible. Counterpart of ``vitef_tpu/probe.py`` (:23-85).

sklearn's ``LogisticRegression(C=c)`` minimises ``Σ CE_i + 0.5/c·‖W‖²`` with
the bias unregularised; this minimises the same objective in float32 with
``torch.optim.LBFGS`` (strong-Wolfe line search, a history of 10 as optax's
``lbfgs``) after standardising the features, so its accuracies match
sklearn's to within the optimiser's tolerance. The linear-probing app selects
it with ``probe_impl="torch"``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _standardize(train: torch.Tensor, test: torch.Tensor):
    """Both sets scaled by the train set's per-feature mean and (biased) std;
    a feature of zero std is only centred."""
    mean = train.mean(dim=0, keepdim=True)
    std = train.std(dim=0, correction=0, keepdim=True)
    std = torch.where(std == 0, torch.ones_like(std), std)
    return (train - mean) / std, (test - mean) / std


def logreg_objective(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     c: float = 1.0) -> torch.Tensor:
    """sklearn's ``LogisticRegression(C=c)`` objective at ``(w, b)``: the summed
    cross-entropy of ``x @ w + b`` plus ``0.5/c·‖w‖²``."""
    return F.cross_entropy(x @ w + b, y, reduction="sum") + 0.5 / c * w.square().sum()


def fit_logreg_lbfgs(x: torch.Tensor, y: torch.Tensor, n_classes: int, c: float = 1.0,
                     max_iter: int = 200, tol: float = 1e-6):
    """L2-regularised multinomial logistic regression by L-BFGS from zeros,
    on x's device in float32: ``(W (d, K), b (K,))``.

    It stops as the JAX version's loop does: after ``max_iter`` updates, or
    after the update that starts where the gradient's global norm is at most
    ``tol``.
    """
    x = x.float()
    w = torch.zeros((x.shape[1], n_classes), device=x.device, requires_grad=True)
    b = torch.zeros((n_classes,), device=x.device, requires_grad=True)
    opt = torch.optim.LBFGS([w, b], lr=1.0, max_iter=1, max_eval=25, tolerance_grad=0.0,
                            tolerance_change=0.0, history_size=10,
                            line_search_fn="strong_wolfe")
    start = {}

    def closure():
        opt.zero_grad()
        loss = logreg_objective(x, y, w, b, c)
        loss.backward()
        if "gnorm" not in start:  # the first evaluation of a step is at its start
            start["gnorm"] = torch.sqrt(w.grad.square().sum() + b.grad.square().sum())
        return loss

    for _ in range(max_iter):
        start.clear()
        opt.step(closure)
        if not start["gnorm"].item() > tol:
            break
    return w.detach(), b.detach()


def probe_accuracy_torch(train_x: np.ndarray, train_y: np.ndarray, test_x: np.ndarray,
                         test_y: np.ndarray, n_classes: int | None = None, c: float = 1.0,
                         max_iter: int = 200, device="cuda") -> float:
    """Standardise, fit on ``device`` (the card unless the caller passes
    ``"cpu"``), and return the test accuracy (one probe key)."""
    if n_classes is None:
        n_classes = int(max(train_y.max(), test_y.max())) + 1
    xtr = torch.as_tensor(train_x, dtype=torch.float32, device=device)
    xte = torch.as_tensor(test_x, dtype=torch.float32, device=device)
    xtr, xte = _standardize(xtr, xte)
    ytr = torch.as_tensor(train_y, dtype=torch.long, device=device)
    w, b = fit_logreg_lbfgs(xtr, ytr, n_classes, c=c, max_iter=max_iter)
    pred = (xte @ w + b).argmax(dim=-1).cpu().numpy()
    return float(np.mean(pred == np.asarray(test_y)))

