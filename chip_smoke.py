#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vitef_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (each raises on failure, so the run exits non-zero):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the inference path from ``vitef_tpu_torch/ops/csrc``;
3. kernel phase: the packed-MHA kernel against its plain PyTorch version
   (float32, same bf16 inputs) at the ViT-B/16 shape and at edge lengths,
   and both timed at the ViT-B/16 shape;
4. slice phase: ViT-B/16 in bfloat16 (random weights from a seed) classifies
   a synthetic test set through the port's loader and ``run_evaluation``;
   every attention call must launch the kernel, none may take the plain path;
5. cross-check: the same model's logits through the plain attention path.

The second-to-last line is a JSON object describing each kernel; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import time

import torch

from vitef_tpu_torch.data.images import build_loader
from vitef_tpu_torch.eval import run_evaluation
from vitef_tpu_torch.models import build_model
from vitef_tpu_torch.ops import _build
from vitef_tpu_torch.ops import attention as A

VIT_B16 = {"implementation": "vit", "model_name": "base", "patch_size": 16,
           "image_dim": (3, 224, 224), "finetuning": True, "n_classes": 10,
           "compute_dtype": "bfloat16", "seed": 0}
EVAL_DATA = {"dataset_name": "synthetic-1024", "mode": "test", "batch_size": 256,
             "size": 224, "compute_dtype": "bfloat16"}
N_HEADS, EMB = 12, 768
VIT_SHAPE = (256, 197)                       # (N, L) of ViT-B/16 at batch 256
EDGE_SHAPES = [(8, 1), (8, 17), (8, 64), (8, 65), (8, 577)]

# The kernel's bf16 output against the float32 plain version on the same bf16
# inputs: bf16 rounding of the output alone is ~2^-8 of |value|.
KERNEL_MAX_ABS, KERNEL_MEAN_ABS = 2e-2, 2e-3
# Whole-model logits, kernel path vs plain attention path, both bf16: the two
# attention paths round to bf16 at different places (the kernel keeps q + bias
# and the probabilities in float32), and 12 residual blocks compound each
# ~2^-9 relative difference. Logits of this model are O(1).
LOGITS_MAX_ABS, LOGITS_MEAN_ABS = 1e-1, 2e-2


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(device) -> dict:
    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    for n, l in [VIT_SHAPE, *EDGE_SHAPES]:
        qkv = (torch.randn(n, l, 3 * EMB, generator=gen) * 0.5).to(device, torch.bfloat16)
        bias = (torch.randn(3 * EMB, generator=gen) * 0.1).to(device, torch.bfloat16)
        with torch.inference_mode():
            out = A.fused_mha_packed(qkv, N_HEADS, bias=bias)
            ref = A.packed_mha_reference(qkv.float(), N_HEADS, bias=bias.float())
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        max_abs, mean_abs = diff.max().item(), diff.mean().item()
        print(f"K1 packed_mha_fwd N={n} L={l}: max|d|={max_abs:.3e} "
              f"mean|d|={mean_abs:.3e}")
        if not (tuple(out.shape) == (n, l, EMB) and math.isfinite(max_abs)
                and max_abs <= KERNEL_MAX_ABS and mean_abs <= KERNEL_MEAN_ABS):
            raise AssertionError(f"K1 disagrees with its plain version at N={n} L={l}")
        worst = max(worst, max_abs)
        if (n, l) == VIT_SHAPE:
            vit_inputs = (qkv, bias)

    qkv, bias = vit_inputs
    with torch.inference_mode():
        kernel = lambda: A.fused_mha_packed(qkv, N_HEADS, bias=bias)  # noqa: E731
        plain = lambda: A.packed_mha_reference(qkv, N_HEADS, bias=bias)  # noqa: E731
        # in turns: plain, kernel, kernel, plain
        times = [cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)]
    ms, plain_ms = min(times[1:3]), min(times[0], times[3])
    print(f"K1 at N={VIT_SHAPE[0]} L={VIT_SHAPE[1]} E={EMB} h={N_HEADS}: kernel "
          f"{times[1]:.4f}/{times[2]:.4f} ms, plain {times[0]:.4f}/{times[3]:.4f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def slice_phase(device):
    model = build_model(VIT_B16, device=device)
    loader = build_loader(EVAL_DATA, device=device)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(EVAL_DATA["batch_size"], 3, 224, 224, generator=gen).to(
        device, torch.bfloat16)
    model.eval_step((x, torch.zeros(len(x), dtype=torch.long, device=device)))  # warm-up
    torch.cuda.synchronize()

    plain_calls = []
    attention_reference = A.attention_reference

    def counted_reference(*args, **kwargs):
        plain_calls.append(1)
        return attention_reference(*args, **kwargs)

    A.attention_reference = counted_reference
    try:
        A.fused_mha_packed.launches = 0
        t0 = time.perf_counter()
        metrics = run_evaluation(model, loader)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = A.fused_mha_packed.launches
    finally:
        A.attention_reference = attention_reference

    n_images = len(loader) * EVAL_DATA["batch_size"]
    print(f"eval: {metrics} over {len(loader)} batches of {EVAL_DATA['batch_size']}; "
          f"K1 launches {launches}, plain attention calls {len(plain_calls)}")
    if launches != model.config.n_layers * len(loader):
        raise AssertionError(f"K1 launched {launches} times, want "
                             f"{model.config.n_layers} x {len(loader)}")
    if plain_calls:
        raise AssertionError("the plain attention path ran on CUDA")
    acc, loss = metrics["eval_acc"], metrics["eval_loss"]
    if not (0.0 <= acc <= 1.0 and math.isfinite(loss) and loss > 0):
        raise AssertionError(f"eval metrics out of range: {metrics}")
    print(f"ViT-B/16 bf16 eval loop: {n_images / seconds:.2f} img/s "
          f"({n_images} images in {seconds:.3f} s, loader included)")

    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model.apply(x), iters=10)
    print(f"ViT-B/16 bf16 device-only forward: {len(x) / fwd_ms * 1e3:.2f} img/s "
          f"({fwd_ms:.3f} ms per batch of {len(x)})")
    return model, x, launches


def cross_check(model, x):
    """Logits of 64 images through both attention paths; then the forward's
    time on the plain path, and again on the kernel path, at the full batch."""
    impl = model.config.attn_impl
    with torch.inference_mode():
        kernel_logits = model.apply(x[:64])
        model.config.attn_impl = "plain"  # every module reads the shared config
        try:
            plain_logits = model.apply(x[:64])
            plain_ms = cuda_ms(lambda: model.apply(x), iters=10)
        finally:
            model.config.attn_impl = impl
        kernel_ms = cuda_ms(lambda: model.apply(x), iters=10)
    print(f"ViT-B/16 bf16 device-only forward, plain attention path: "
          f"{len(x) / plain_ms * 1e3:.2f} img/s ({plain_ms:.3f} ms); kernel path "
          f"again: {len(x) / kernel_ms * 1e3:.2f} img/s ({kernel_ms:.3f} ms)")
    x = x[:64]
    diff = (kernel_logits - plain_logits).abs()
    max_abs, mean_abs = diff.max().item(), diff.mean().item()
    print(f"logits kernel vs plain attention ({len(x)} images): max|d|={max_abs:.3e} "
          f"mean|d|={mean_abs:.3e} (|logits| max {plain_logits.abs().max().item():.3f})")
    if not (tuple(kernel_logits.shape) == (len(x), VIT_B16["n_classes"])
            and torch.isfinite(kernel_logits).all()
            and max_abs <= LOGITS_MAX_ABS and mean_abs <= LOGITS_MEAN_ABS):
        raise AssertionError("kernel-path logits disagree with the plain path")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    device = torch.device("cuda", 0)
    card_line = card()
    print(card_line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    A.build_kernel()
    print(f"built packed_mha_fwd in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log("packed_mha_fwd").splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())

    timing = kernel_phase(device)
    model, x, launches = slice_phase(device)
    cross_check(model, x)

    print(card_line)
    print(json.dumps({"kernels": [{
        "name": "packed_mha_fwd", "route": "cuda",
        "source": "vitef_tpu_torch/ops/csrc/packed_mha_fwd.cu",
        "replaces": "vitef_tpu/ops/attention.py:99",
        "launches": launches, **timing}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
