"""The port's L-BFGS probe (``vitef_tpu_torch.probe``) against sklearn's
``LogisticRegression(C=1)`` and the JAX package's ``probe_accuracy_jax``, on a
seeded 3-class problem on the CPU."""

import numpy as np
import pytest
import torch

from vitef_tpu.probe import probe_accuracy_jax
from vitef_tpu_torch.probe import (_standardize, fit_logreg_lbfgs, logreg_objective,
                                   probe_accuracy_torch)


@pytest.fixture(autouse=True)
def one_thread():
    """The probe is hundreds of tiny steps; on a shared CPU, torch's thread
    pool costs more than the arithmetic."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _separable(n=150, d=8, k=3, seed=0, sep=4.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * sep
    y = np.arange(n) % k
    x = centers[y] + rng.normal(size=(n, d))
    return x.astype(np.float32), y


def test_objective_matches_sklearn():
    from sklearn.linear_model import LogisticRegression

    x, y = _separable()
    xs, _ = _standardize(torch.from_numpy(x), torch.from_numpy(x))
    yt = torch.from_numpy(y)
    w, b = fit_logreg_lbfgs(xs, yt, 3, max_iter=300)
    sk = LogisticRegression(C=1.0, tol=1e-10, max_iter=10000).fit(xs.double().numpy(), y)
    x64, y64 = xs.double(), yt

    def objective(w, b):
        return logreg_objective(x64, y64, torch.as_tensor(w).double(),
                                torch.as_tensor(b).double()).item()

    ours, theirs = objective(w, b), objective(sk.coef_.T, sk.intercept_)
    assert abs(ours - theirs) <= 1e-5 * theirs, (ours, theirs)


def test_accuracy_matches_jax_probe():
    xtr, ytr = _separable(seed=1)
    xte, yte = _separable(n=90, seed=1)
    xte = xte + np.random.default_rng(2).normal(size=xte.shape).astype(np.float32)
    ours = probe_accuracy_torch(xtr, ytr, xte, yte, device="cpu")
    assert ours == probe_accuracy_jax(xtr, ytr, xte, yte)
    assert 0.5 < ours <= 1.0
