"""Time and accuracy of the top singular values the theoretical bounds take
(``vitef_tpu_torch/apps/plots/theory.py``), on the card, per cuSOLVER driver.

Run from the repository root on a machine with a CUDA card:

    python tools/profile_svd_drivers.py

For block 0 of the in21k ViT-B/16 and ViT-H/14 (random weights from seed 0
without the published ones, as ``theory._build_vit`` builds them) it takes
fc1's weight, the heads' columns of the output projection, each head's
E x E product Q_h K_hᵀ / √d and the d x d product R_Q R_Kᵀ / √d of their
thin QR factors, and prints, for each ``torch.linalg.svdvals`` driver, the
seconds of one float32 call on the batch and the largest relative error of
the top singular values against scipy's float64 SVD of the same float32
matrices on the host.
"""

import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
from scipy.linalg import svdvals

from vitef_tpu_torch.apps.plots import theory

DRIVERS = (None, "gesvd", "gesvdj", "gesvda")


def matrices(model, n_heads: int) -> dict:
    block = model.module.blocks[0]
    e = block.attn.output.weight.shape[0]
    d = e // n_heads
    with torch.no_grad():
        q, k, _ = (theory.head_columns(w, n_heads) for w in block.attn.qkv_mat.weight.split(e))
        r_q, r_k = torch.linalg.qr(q, mode="r").R, torch.linalg.qr(k, mode="r").R
        return {"fc1": block.ffn.fc1.weight.detach().clone(),
                "output heads": theory.head_columns(block.attn.output.weight, n_heads).clone(),
                "QK (E x E)": q @ k.transpose(1, 2) / math.sqrt(d),
                "R_Q R_K (d x d)": r_q @ r_k.transpose(1, 2) / math.sqrt(d)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_svd_drivers: no CUDA device")
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), torch.__version__)
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, patch in (("base", 16), ("huge", 14)):
        model = theory._build_vit(name, patch, device)
        cases = matrices(model, theory.N_HEADS[name])
        # the reference: the E x E products' float64 SVD (the JAX package's matrix)
        qk_host = cases["QK (E x E)"].cpu().double().numpy()
        want_qk = np.array([svdvals(m)[0] for m in qk_host])
        for label, w in cases.items():
            if label == "QK (E x E)" or label == "R_Q R_K (d x d)":
                want = want_qk
            else:
                host = w.cpu().double().numpy().reshape(-1, *w.shape[-2:])
                want = np.array([svdvals(m)[0] for m in host])
            for driver in DRIVERS:
                try:
                    torch.linalg.svdvals(w, driver=driver)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = torch.linalg.svdvals(w, driver=driver)[..., 0]
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                    err = np.max(np.abs(got.reshape(-1).cpu().double().numpy() - want) / want)
                    print(f"ViT-{name}/{patch} {label} {tuple(w.shape)} driver={driver}: "
                          f"{seconds * 1e3:.2f} ms, max rel err {err:.2e}", flush=True)
                except RuntimeError as exc:
                    print(f"ViT-{name}/{patch} {label} driver={driver}: "
                          f"{type(exc).__name__}: {str(exc)[:90]}", flush=True)
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
