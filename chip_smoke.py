#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vitef_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (each raises on failure, so the run exits non-zero):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ``vitef_tpu_torch/ops/csrc`` (one ``nvcc`` per
   source, all at once), printing the seconds and each kernel's ptxas
   registers and spills, and the HMMA (tensor-core) instructions that
   ``cuobjdump -sass`` finds in the libraries of K1, K2/K3, K4 and K5 (none
   fails the run), the TF32 HMMA instructions in each instantiation of K4's
   float32 kernel and of K5's two float32 passes, the HGMMA (wgmma)
   instructions in both column tiles of the TMA kernels (K8 gmm's and K8
   tgmm's kPlain and all four K7 passes), and
   the HMMA instructions in each of K9's four instantiations (bf16 and
   float16 at d = 64 and 128) and in each head-width-80 instantiation of K1
   (four modes) and K2/K3 (both passes, both modes; none fails the run),
   with any ptxas warning that it serialises wgmma;
3. K1 phase: the packed-MHA forward kernel against its plain PyTorch version
   (float32, same bf16 inputs) at the ViT-B/16 shape and at edge lengths up
   to 1024 (the tensor-core tiles' edges 16, 17, 33, 64, 65, 129 among
   them), each row's log2-sum-exp against the plain scores' within 1e-3 and
   bit-identical over two launches; both timed at the ViT-B/16 shape (with
   TFLOP/s), with ``scaled_dot_product_attention`` timed beside them as a
   yardstick;
4. K2 phase: the packed-MHA backward kernel likewise, through the autograd
   path that the train step takes, plus bit-identical outputs over two
   launches and a wrapper that raises for what the kernel does not take;
5. K10 phase: the train augment kernel in bf16 and float32 against its
   float32 plain version at batch 512 (32x32 -> 224) and at sizes 1 to 2640
   and sources 1 to 1024 px (a non-square one within size), boxes touching
   every edge, flips on and off; bit-identical over two launches; the
   wrapper's refusals (a non-square source over size, a size past the limit,
   int8 input, a float16 output); timed in turns with the plain version
   beside its bound at batch 512 and at 512 px (N = 64);
6. K1-causal phase: K1's causal mode against its plain version at the GPT-2
   train shape (N=64, L=1024) and at 14 lengths from 1 to 1024 (N=8), with
   the K1 phase's lse and determinism checks, timed with the plain version
   and SDPA (``is_causal=True``) at the train shape;
7. K3 phase: the backward's causal mode likewise, as in the K2 phase;
8. eval slice: ViT-B/16 in bfloat16 (random weights from a seed) classifies a
   synthetic test set through the port's loader and ``run_evaluation``;
   every attention call must launch K1, none may take the plain path;
9. eval cross-check: the same model's logits through the plain attention path;
10. train slice: ViT-B/16 finetunes with ``bench.py``'s protocol (batch 512 as
    2 x 256 accumulation, SGD momentum 0.9, lr 0.01, cosine schedule with
    warmup 100, clip 1.0) from the port's train loader; K1, K2 and K10 must
    carry every step and no plain version may run; then the device-only rate
    on a device-resident raw batch, and a torch.profiler split of one step;
11. train cross-check: one microbatch's gradients through the kernel path and
    the plain path, and a loss that falls over 20 steps on one fixed batch;
12. GPT-2 train slice: GPT-2 base (124M, random weights from a seed) trains
    with ``tools/bench_models.py``'s ``bench_gpt2`` protocol (bf16, batch
    64 x 1024 tokens of ``np.random.default_rng(0)``, fused head + CE,
    AdamW 3e-4, cosine warmup 100 of 1000, clip 1.0): 3 warm-up and 10
    timed steps, K1 and K3 12 launches per step and no plain version, then a
    torch.profiler split of one step;
13. GPT-2 cross-check: the gradients of 4 sequences through the kernel path
    and the plain path, and a loss that falls over 20 steps on a fixed batch
    of 8 at constant lr 3e-4;
14. K4 and K5 phases: the flash attention forward and backward kernels
    against their float32 plain versions, in bfloat16 at the Llama-1B train
    shape (N=4, h=32, L=1024, causal; timed with the plain version and SDPA)
    and at edge lengths (1, 16, 63, 64, 65, 127, 129, 1000, causal and not),
    and in float32 at a GPT-2 shape (N=8, h=12, L=1024, causal; timed) and
    at edge lengths (1, 16, 17, 65, 129, 1000, causal and not; N=2, h=12);
    K4's lse within 1e-3 of the plain scores', K4 and K5 bit-identical over
    two launches, and both wrappers raise for what the kernels do not take;
    TFLOP/s beside each time, and K4's and K5's float32 bounds both on the
    CUDA cores and over the split-TF32 products they issue (these run with
    the other kernel phases, after 7);
15. GPT-2 float32: GPT-2 base at its default compute dtype, whose attention
    at L=1024 takes K4 and K5 in float32: the logits and the gradients of 4
    sequences against the plain path, K4 and K5 launched every layer;
16. Llama-1B train slice: the JAX package's "1b" preset at L=1024 (random
    weights from a seed) trains with ``tools/bench_models.py``'s
    ``bench_llama(batch=4, size="1b")`` protocol (bf16, 4 x 1024 tokens of
    ``np.random.default_rng(0)``, fused untied head + CE, AdamW 3e-4, cosine
    warmup 100 of 1000, clip 1.0): 2 warm-up and 10 timed steps, K4 and K5 16
    launches per step, K1 and K3 none, no plain version, a loss that falls;
    then a torch.profiler split of one step;
17. Llama-1B cross-check: the gradients of one sequence through the kernel
    path and the plain path (the grouped einsum), overall and per block, and
    the fused loss against the unfused one at V = 128256;
18. K8 and K7 phases: the six grouped-product entry points (K8 ``gmm`` and
    ``tgmm``; K7 ``gmm_swiglu``, ``gmm_dy_swiglu``, ``gmm_dual`` and
    ``tgmm_swiglu``) in bfloat16 against their float32 plain versions at the
    8x124m step's shapes (E=8, d=768, f=2048, G=16384 rows in uneven groups
    from a seeded router draw) and at edge cases (empty and one-row experts,
    every row in one expert, G=1000, the tiny preset's d=64/f=128, groups of
    63, 2, 65 rows at d=72/f=136, either side of a 64-row box and no tile
    multiple, and groups of 127, 2, 129 at d=136/f=72, whose f puts K7's
    gate/up and a/b seams inside a 64-deep stage), in float32 at a small
    shape; each bit-identical over two launches, ``tgmm``'s and
    ``tgmm_swiglu``'s empty groups exactly zero; ``gmm_dy_swiglu``'s
    reciprocal (``recip_fast``) equal to ``1.f / d`` at every float of
    [1, 2^126); the wrappers raise for float16 and for a width not a
    multiple of 8, and the ``gmm.cu`` ones count no launch for zero rows;
    each timed with its plain version, its bound and ``torch._grouped_mm``,
    and each also at both its kernel's column tiles (128 x 128 and 128 x
    256; tgmm's and tgmm_swiglu's each with their tiles walked largest
    group first and in group order), each within
    the gate and timed in turns; then the y = bf16(silu(g)·u) that K7
    gmm_swiglu and tgmm_swiglu multiply, read out through an identity
    operand, against silu(g)·u in float64 within one bf16 rounding plus
    2^-12 of |y|, gate values from -16 to 4, and the two kernels' y bit for
    bit the same (these run with the other kernel phases, after 14);
19. MoE train slice: the JAX package's "8x124m" preset at L=1024 (random
    weights from a seed) trains with ``bench_llama(batch=8, size="8x124m",
    implementation="moe")``'s protocol (bf16, 8 x 1024 tokens of
    ``np.random.default_rng(0)``, fused untied head + CE, AdamW 3e-4, cosine
    warmup 100 of 1000, clip 1.0): 2 warm-up and 10 timed steps through the
    sparse dispatch, per step K8 gmm 12 and tgmm 24, each K7 pass 12, K1 and
    K3 12, K4 and K5 none, no plain version; then a torch.profiler split of
    one step, in which each K8 and K7 kernel must appear under its own kind;
20. MoE cross-check: the gradients of one sequence through the kernels and
    through the dense oracle with plain attention, overall; per block, on the
    kernel route's recorded inputs, each block's MoE FFN (sparse vs dense, at
    one routing) and its GQA/RoPE attention (K1 causal + K3 vs the plain
    grouped einsum); and a loss that falls over 20 steps on a fixed batch of
    8;
21. K6 phase: the LayerNorm kernels (forward and dx) in bfloat16 against
    their float32 plain versions at the ViT-B/16 finetune's rows (50,432 x
    768, eps 1e-12), in float32 at the analysis's (25,216 x 768), and at
    rows 1, 7, 255, 257, 1000 x widths 64, 768, 1024, 1280 x bias or not x
    eps 1e-12 or 1e-6 in both types; bit-identical over two launches; the
    wrappers raise for float16 and for widths 100 and 4096; each entry point
    timed with its plain version, its bound and ``F.layer_norm`` (this runs
    with the other kernel phases, after 18);
22. K6 finetune: the train slice's protocol (10) on a ViT-B/16 built with
    ``norm_impl="kernel"``: K6's forward and dx 50 launches per step each,
    beside K1, K2 and K10 as in 10, no plain version; the rates and peak
    memory; a torch.profiler split with K6 as its own kind; one
    microbatch's gradients against the plain LayerNorm (after 11);
23. analysis: ViT-B/16 in float32 with K6 (the in21k model of
    ``apps/vit/analysis.py``, random weights from a seed) decomposes two
    synthetic batches of 128 from different seeds and returns the 61 keys'
    per-sample distances (``make_decomposition_distance_fn``): 48 K6
    launches per call, against the plain LayerNorm within 1e-4, timed;
24. probing: ViT-B/16 in bfloat16 with K6 and K1 pools and normalises the
    96 probe keys' features over a synthetic train loader at batch 512
    (``get_embeddings``: 24 K6 and 12 K1 launches per batch, against the
    plain path); the probe's fit runs in 34;
25. K1 masked phase: K1's key-masked mode (the ragged serving prefill) in
    bfloat16 against its float32 plain version at the serving prefill's
    shape (N=256, L=128, causal, left-pad lengths 16-128 from
    ``np.random.default_rng(0)``, one row of length 1) and at L = 1, 63, 65,
    127, 197, 512, 1024 (causal and not, with fully masked rows), gated on
    the rows with a valid visible key (output and lse), every other row
    finite; an all-true mask bit-equal to unmasked K1; bit-identical over two
    launches; the wrapper raises for a gradient, float16, d=32 and a mask of
    another shape; timed with its plain version, its bound and SDPA with a
    boolean mask; unmasked K1 re-read at the ViT shape (this runs with the
    other kernel phases, after 21);
26. generate: GPT-2 base in bf16 (random weights from a seed) generates 128
    tokens for 256 prompts of 32-128 tokens left-padded to 128
    (``Model.generate``, ``tools/profile_decode.py``'s "topk" and "greedy"
    modes): 12 masked K1 launches per call and no plain version; prefill ms,
    decode ms per step, tokens/s, peak memory; a torch.profiler split of one
    decode step; the top-k sampler's order on CUDA (ties) against the CPU's
    and its time beside ``torch.topk``'s;
27. serving cross-check: the last prefill logits, kernel route against the
    plain route; 4 ragged rows against the same prompts prefilled alone; one
    teacher-forced decode step; the greedy tokens' agreement (printed: at
    random weights the tied head echoes its input, so it tells nothing).
    The server's logits against ``generate()``'s: 4 requests' admissions
    against their prompts prefilled alone, and one window tick against the
    first decode step. Each of these limits is also read with a fault
    planted (K1's mask dropped; a slot's position off by one; a slot
    reading another slot's cache rows; the admission reading the wrong
    token's logits), and the phase fails if a planted fault passes;
28. server: ``DecodeServer`` (64 slots, 256 positions, bucket 64) serves
    ``tools/profile_server.py``'s 256 requests greedily (every request gets
    its max_new_tokens; requests/s, tokens/s, ticks); then the same requests
    in waves of 64 through the serve app's ragged ``generate()`` (12 masked
    K1 launches per wave); then the ``sample`` and ``serve`` apps' ``run`` on
    the card;
29. K9 phase: the ring hop in bfloat16 against its float32 plain version at
    the GPT-2 sp step's hop (N=8, h=12, segments of 512, d=64), at
    ``tools/profile_ring_hop.py``'s (N=1, h=12, segments of 512 and 1024),
    at segments of 128, 384 and 640 and at d=128, each mid-ring (every key
    visible), diagonal and fully future (the state comes back bit-equal),
    from a non-initial state and from the -1e30 start; two chains of three
    hops; a zigzag segment and heads of a packed qkv read in place; float16
    at d=64 and d=128;
    bit-identical over two launches; the wrapper raises for float32, a
    segment of 200 and d=96; the masked probabilities' zeroing planted out
    of the plain version must fail the checks; timed as chained hops with
    the plain version, its bound and SDPA on the same block as a yardstick
    (this runs with the other kernel phases, after 25);
30. sequence parallelism: a one-rank NCCL group on a free localhost port;
    GPT-2 base (random weights from a seed) trains through
    ``make_sp_train_step`` in bf16 at 8 x 1024 tokens of
    ``np.random.default_rng(0)`` (labels rolled by -1), AdamW 3e-4 with
    ``bench_gpt2``'s schedule, clip 1.0: zigzag, then contiguous, each 2
    warm-up and 10 timed steps, K9 36 (zigzag) or 12 (contiguous) launches
    per step, K1, K3, K4 and K5 none, no plain hop forward; a torch.profiler
    split of one zigzag step; the cross-check on 4 sequences (loss and
    gradients, overall and per block, against the ordinary GPT-2 step
    through K1 and K3 and against the sp step on the plain hop; each limit
    read again with the key positions off by one segment and with the skip
    of fully future pairs inverted, which must fail it); a loss that falls
    over 20 steps on a fixed batch of 8;
31. head width 80 (ViT-H/14: 16 heads over E = 1280, L = 257): K1 and K2
    against their float32 plain versions under the bf16 gates at the
    ViT-H/14 microbatch (N=128, L=257; timed with the plain version, the
    bound and SDPA, with TFLOP/s) and at lengths 16, 17, 33, 64, 65, 129,
    257 (N=8), K1's lse within 1e-3, bit-identical over two launches, the
    K2 wrapper raising for head width 128; K1's causal mode and K3 likewise
    at 17, 65, 129, 257 (N=8, timed at 257), K3 also at the main shape
    against its algebra emulated in float32 (P and dS rounded to bf16), each
    output within half a bf16 ulp plus 1e-2; K1's key-masked mode at those
    lengths, causal and not, as in 25 (these run with the other kernel
    phases, after 29);
32. the model-size ablation: ViT-L/16 (2 x 256) and ViT-H/14 (patch 14,
    4 x 128) finetune with the train slice's protocol (10) at full width and
    depth from random weights: 3 warm-up and 5 timed steps through the
    loader (K1 and K2 24 or 32 launches per microbatch, K10 one per step, no
    plain version) and then device-only, peak memory, a torch.profiler split
    of one step (after 22);
33. ViT-H/14 cross-check at full width and 4 blocks: logits kernel vs plain
    attention path under the ViT gates, one microbatch's (128) gradients
    within 5e-2 relative L2 overall and in every block, and a loss that
    falls over 20 steps on one fixed batch;
34. ViT apps (after 24): the paper's experiment through the port's command
    lines. CIFAR-10 files at CIFAR-10's size (50,000 + 10,000 class-separable
    images from ``np.random.default_rng(0)``) in a temporary directory, which
    is also ``VITEF_SAVING_DIR``; the train command line in this process
    (``vitef_tpu_torch.apps.vit.train.main``: ``apps/vit/configs/cifar10.yaml``,
    ViT-B/16 from random weights, batch 512 as 2 x 256, 60 steps with warmup
    10 and an evaluation every 30, the blocks frozen as one of
    ``sweep_lib.sh``'s configs): K10 one launch a step, K1 and K2 24 a step,
    K1 12 an evaluation batch, no plain version; the run dir against the JAX
    package's contract (files, jsonl fields, one checkpoint at the best
    evaluated step with the JAX dotted keys and layout, the frozen tensors
    bit-equal to their initial values), a loss that falls and an eval_acc
    above chance; img/s per logged period, each evaluation's and each
    checkpoint's staging and writing seconds, the peak memory; a resume to
    step 70 (the first logged step after the best one, the optimizer buffers
    loaded as saved); the eval command line as a subprocess (exit 0;
    ``test_acc`` that of all 10,000 test images, the last batch of 272,
    recomputed in this process); ``linear_probing(probe_impl="torch")`` on a
    second set of 5,000 + 1,000 images (a test accuracy for each of the 96
    keys); then ``train_phase``'s protocol with the same freeze at 1 x 512
    and 2 x 256 (2 warm-up and 10 timed steps each), with the peak memory of
    each and what the command line adds per step;
35. the paper's figures (after 34, on its CIFAR-10 files, then removed):
    the loss-landscape ``save`` command (``apps/plots/loss_landscape.py``'s
    ``save_results``: ln1, fc1 and mha at block 0 of ViT-B/16 in float32
    from random weights, batch 4, 20 SGD steps at lr 1e-3, a 20 x 20 grid
    over +-0.5; no kernel: float32 at L = 197 takes the plain attention),
    each surface recomputed on the host CPU at its four corners and one
    interior point from the card's weights, batch and directions within
    1e-4 relative (TF32 off), each PCA plane orthonormal and equal to
    numpy's SVD of the same trajectory under the sign rule; the token radius
    at ``print_radius``'s settings (batch 16, 1,000 steps), its first 20
    steps equal on the card and the host; the bounds' ``save`` at base/16,
    large/16 and huge/14, a few blocks of each against scipy's float64 SVDs
    of the same weights within 1e-5; phase 34's run read back by
    ``get_single_exp`` under its sweep name; seconds per SGD step, per
    surface, for the radius and for each model's bounds;
36. head width 128 (Llama-3.1-8B: 32 heads over E = 4096): K1 in its four
    modes against its float32 plain version under the bf16 gates, lse
    within 1e-3, bit-identical over two launches: causal at an admission
    (N=1, L=512; timed with the plain version, the bound and SDPA) and at
    L = 1, 16, 17, 64, 65, 129, 257, 512, 577, 578 (N=8), non-causal at
    N=32, L=512 and those lengths, key-masked at the 8B generate prefill
    (N=32, L=512, causal, left-pad lengths 64-512 from default_rng(0);
    timed with SDPA under a boolean mask) and at those lengths, causal and
    not, with empty rows; the wrappers raise NotImplementedError for a
    gradient at d = 128 (K2 and K3 are not instantiated there), masked or
    not, for d = 96 and for the backward at d = 128, before any launch
    (this runs with the other kernel phases, after 31);
37. Llama-3.1-8B serving (last; every earlier model freed): the "8b"
    preset at full width and depth (8.03 B parameters, random weights from
    seed 0, bf16, seq_len 1024), drawn on the host and moved (seconds
    printed). One decode step of the generate batch timed on the float32
    weights (each linear casting its weight) and on ``generate``'s bf16
    copy of the weight matrices. ``Model.generate`` for 32 prompts of
    64-512 tokens left-padded to 512, 64 new tokens, greedy and top-k 40 at
    T 0.8: 32 masked K1 launches per call at d = 128, none unmasked, no
    plain version; prefill ms, decode ms per step, tokens/s, peak memory,
    a profile of one decode step (the idle share). The serving cross-check
    (27) on that batch and the server cross-check on 4 of the server's
    requests, each with its planted faults. ``DecodeServer`` (16 slots of
    1,024, bucket 64) serves 64 requests (prompts 32-480, 16-128 new
    tokens) greedily: 32 unmasked K1 launches per admission, every request
    its max_new_tokens, requests/s and tokens/s;
38. int8 weights on the 8B model: ``quantize_decode_params`` on the card
    bit-equal to the host's on block 0's weights; ``Model.quantize_int8``
    (seconds, ``quantized_nbytes``); the int8 model's prefill logits
    against a bf16 model holding the dequantized weights within relative
    L2 2e-2 (max |d| printed); int8 greedy generate (32 masked K1
    launches; decode ms per step and tokens/s beside bf16's) and the server
    on int8 weights. ``python -m vitef_tpu_torch.apps.gpt2.serve run
    --implementation llama --model_name 8b --quantize int8 --demo 16`` runs
    as a process of its own, started before 37's build so that the two
    processes' host draws overlap, and waited for before 37 times anything:
    exit 0, 16 results. The phases' peak memory must stay under 79 GiB.

Each kernel's time comes with its bound: the larger of its operations over
the card's peak rate for their type and its bytes (each input read once, each
output written once) over the memory rate, at the published H100 SXM peaks.
The second-to-last line is a JSON object describing each kernel; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import gc
import json
import logging
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# The ViT apps phase writes its run dirs, probes and datasets under a fresh
# temporary directory; the port reads VITEF_SAVING_DIR when it is imported.
APPS_ROOT = Path(tempfile.gettempdir()) / f"vitef_chip_smoke_{os.getpid()}"
os.environ["VITEF_SAVING_DIR"] = str(APPS_ROOT / "savings")

from vitef_tpu_torch.apps.gpt2 import sample as SAMPLE_APP
from vitef_tpu_torch.apps.plots import finetuning as PLOT_FT
from vitef_tpu_torch.apps.plots import loss_landscape as LL
from vitef_tpu_torch.apps.plots import theory as TH
from vitef_tpu_torch.apps.gpt2 import serve as SERVE_APP
from vitef_tpu_torch.apps.vit import analysis as AN
from vitef_tpu_torch.apps.vit import linear_probing as LP
from vitef_tpu_torch.apps.vit import train as TRAIN_APP
from vitef_tpu_torch.monitor import checkpoint as CK
from vitef_tpu_torch.optim import freeze_components
from vitef_tpu_torch.data.images import build_loader, build_train_val_loader, make_iterable
from vitef_tpu_torch.data.images import transforms as T
from vitef_tpu_torch.eval import run_evaluation
from vitef_tpu_torch import native
from vitef_tpu_torch.models import build_model
from vitef_tpu_torch.models.registry import Model
from vitef_tpu_torch.models.transformer import Transformer
from vitef_tpu_torch.models.vit import ViTConfig, vit_transformer_config
from vitef_tpu_torch.models import generation as GEN
from vitef_tpu_torch.models import quantize as Q
from vitef_tpu_torch.models import serving as SRV
from vitef_tpu_torch.models.norms import LayerNorm
from vitef_tpu_torch.ops import _build
from vitef_tpu_torch.ops import attention as A
from vitef_tpu_torch.ops import layernorm as LN
from vitef_tpu_torch.ops import gmm as G
from vitef_tpu_torch.ops import gmm_fused as GF
from vitef_tpu_torch.ops import make_fused_head_loss, next_token_cross_entropy
from vitef_tpu_torch.optim import build_optimizer, build_scheduler
from vitef_tpu_torch.ops import ring_hop as RH
from vitef_tpu_torch.parallel import auto_grad_acc, init_train_state, make_train_step
from vitef_tpu_torch.parallel import cross_entropy_loss
from vitef_tpu_torch.parallel import moe as M
from vitef_tpu_torch.parallel import sequence as SEQ

VIT_B16 = {"implementation": "vit", "model_name": "base", "patch_size": 16,
           "image_dim": (3, 224, 224), "finetuning": True, "n_classes": 10,
           "compute_dtype": "bfloat16", "seed": 0}
EVAL_DATA = {"dataset_name": "synthetic-1024", "mode": "test", "batch_size": 256,
             "size": 224, "compute_dtype": "bfloat16"}
N_HEADS, EMB = 12, 768
VIT_SHAPE = (256, 197)                       # (N, L) of ViT-B/16 at batch 256
# Edge lengths: 1, the tensor-core tiles' edges (16-row fragments, 64-row and
# 64-key tiles: 16, 17, 33, 64, 65, 129) and ViT's 197, 577, 1024.
EDGE_SHAPES = [(8, l) for l in (1, 16, 17, 33, 64, 65, 129, 197, 577, 1024)]

KERNELS = ("packed_mha_fwd", "packed_mha_bwd", "train_augment", "flash_fwd", "flash_bwd",
           "gmm", "tgmm", "layernorm", "ring_hop")
N_CLASSES = VIT_B16["n_classes"]

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16 tensor
# cores, float32 on the CUDA cores, TF32 tensor cores, HBM3.
PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES = 989e12, 67e12, 495e12, 3.35e12
# K4's float32 path multiplies in split TF32: three TF32 products (hi.hi,
# hi.lo, lo.hi) for each float32 product.
TF32_PRODUCTS = 3

# cuda_ms's spin before a timed run: cycles per ms at the H100's top clock
# (1.98 GHz; a lower clock only spins longer), and its cap.
SPIN_CYCLES_PER_MS, SPIN_MAX_MS = 1.98e6, 200.0

# The forwards' per-row log2-sum-exp (K1, K4) against the float32 one of the
# plain scores: float32 summation order and exp2's few ulp give ~1e-6 at
# these scores, a natural-log or unscaled lse is off by 30% or more, so
# 1e-3 (log2 units) sits far from both.
LSE_MAX_ABS = 1e-3
# The libraries whose bf16 bodies multiply on the tensor cores (mma.sync):
# their SASS must hold HMMA instructions; then, per kernel, (library, a
# piece of the kernel's name with its template arguments, opcode, wanted
# text, instantiations): K1's four modes and K2/K3's two passes in both
# modes at head width 80 (ViT-H/14), the float32 kernels whose products are
# TF32 HMMA instructions (K4's and K5's, each in both instantiations), the TMA +
# wgmma kernels, whose products are HGMMA: csrc/gmm.cu's in kPlain (K8
# gmm), kSwigluIn (K7 gmm_swiglu), kSwigluBwdOut (K7 gmm_dy_swiglu) and
# kDual (K7 gmm_dual) and csrc/tgmm.cu's in kPlain (K8 tgmm) and kSwigluIn
# (K7 tgmm_swiglu), each at both column tiles, and K9 in each (type, d) of
# bf16, float16 x 64, 128.
TENSOR_CORE_LIBS = ("packed_mha_fwd", "packed_mha_bwd", "flash_fwd", "flash_bwd", "ring_hop")
SASS_KERNELS = [("packed_mha_fwd", "packed_mha_fwd_kernel<80,", "HMMA", "HMMA", 4),
                ("packed_mha_fwd", "packed_mha_fwd_kernel<128,", "HMMA", "HMMA", 4),
                ("packed_mha_bwd", "packed_bwd_dq_kernel<80,", "HMMA", "HMMA", 2),
                ("packed_mha_bwd", "packed_bwd_dkv_kernel<80,", "HMMA", "HMMA", 2),
                ("flash_fwd", "flash_fwd_tf32_kernel", "HMMA", "TF32", 2),
                ("flash_bwd", "flash_bwd_dq_tf32_kernel", "HMMA", "TF32", 2),
                ("flash_bwd", "flash_bwd_dkv_tf32_kernel", "HMMA", "TF32", 2),
                ("gmm", "gmm_wgmma_kernel<0,", "HGMMA", "HGMMA", 2),
                ("gmm", "gmm_wgmma_kernel<1,", "HGMMA", "HGMMA", 2),
                ("gmm", "gmm_wgmma_kernel<2,", "HGMMA", "HGMMA", 2),
                ("gmm", "gmm_wgmma_kernel<3,", "HGMMA", "HGMMA", 2),
                ("tgmm", "tgmm_wgmma_kernel<0,", "HGMMA", "HGMMA", 2),
                ("tgmm", "tgmm_wgmma_kernel<1,", "HGMMA", "HGMMA", 2),
                ("ring_hop", "ring_hop_mma_kernel", "HMMA", "HMMA", 4)]
# The column tiles of the TMA kernels (csrc/gmm.cu gmm_tile, csrc/tgmm.cu
# tgmm_tile), timed in turn: tgmm's and tgmm_swiglu's in both walks of
# their tiles.
GMM_TILES = (128, 256)
TILE_MODES = {"gmm": G.PLAIN, "gmm_swiglu": G.SWIGLU_IN, "gmm_dy_swiglu": G.SWIGLU_BWD_OUT,
              "gmm_dual": G.DUAL, "tgmm": G.PLAIN, "tgmm_swiglu": G.SWIGLU_IN}
TGMM_WALKS = {1: "largest group first, snaking", 0: "group order"}

# A kernel's bf16 output against the float32 plain version on the same bf16
# inputs: bf16 rounding of the output alone is ~2^-8 of |value| (K10's values
# reach 2.64, so ~1e-2). K2's bias gradient sums N·L rows of its rounded
# dqkv, so it is held relative to its largest entry.
KERNEL_MAX_ABS, KERNEL_MEAN_ABS = 2e-2, 2e-3
DB_MAX_REL = 1e-2
# K10's cases (N, source side or (H, W), size) beyond the main shape: sizes
# 1, 7, 223 and 224; sources from 1 px to 1024 px (past the first design's
# 48 KB cap from 128 px); a non-square source within size; the largest size,
# whose one-row band fills 227 KB of shared memory. Timed: the main shape
# and 512 px at N = 64. Float32 output against the plain version, at every
# size: both round the coordinate and the weights alike and differ only in
# the order of their products (a few float32 ulps of values up to 255, each
# scaled by at most 0.0175); a tap one ulp of u off moves an output by
# 1e-4 at 127 px.
K10_CASES = [(64, 32, 1), (64, 32, 7), (64, 32, 223), (64, 32, 224), (64, 1, 224),
             (64, 17, 224), (64, 127, 224), (64, 128, 224), (64, 160, 224), (64, 512, 224),
             (64, 1024, 224), (64, (17, 31), 224), (4, 32, 2640)]
K10_TIMED = [(512, 32, 224), (64, 512, 224)]
K10_F32_MAX, K10_F32_MEAN = 1e-5, 1e-6
# Sources and sizes at which train_augment_plan (the kernel's) and
# augment_band_rows (the wrapper's) must make the same plan.
K10_PLAN_SOURCES = (1, 2, 17, 31, 32, 127, 128, 160, 224, 225, 512, 1024, 4096, 20000)

# Train slice: bench.py's protocol (bench.py:54-111).
TRAIN_DATA = {"dataset_name": "synthetic-4096", "batch_size": 512, "val_batch_size": 256,
              "size": 224, "compute_dtype": "bfloat16", "seed": 0}
OPTIMIZER = {"optimizer": "sgd", "lr": 0.01, "momentum": 0.9}
SCHEDULER = {"scheduler": "cosine", "warmup": 100}
TRAIN_STEPS, WARMUP_STEPS, TIMED_STEPS = 1000, 3, 10
AUTO_MICROBATCH = 256   # the app's default split: 512 -> 2 x 256
GRAD_CLIP = 1.0
# Gradients of one microbatch, kernel path vs plain path, both bf16 through 12
# layers (the eval logits already differ by ~1.2e-2): relative L2 bound.
GRAD_REL_L2 = 5e-2
FIXED_BATCH, FIXED_STEPS = 64, 20
# The paper's model-size ablation (apps/vit/scripts/ablation/model_size.sh):
# ViT-L/16 and ViT-H/14 finetuned with the same protocol at full width and
# depth, random weights from a seed. Batch 512 in microbatches that fit the
# card's 80 GB as measured (PERF.md section 5: 65.81 and 74.98 GiB peaks), a
# constant of the phase; 3 warm-up and 5 timed steps each way (a ViT-H/14
# step takes about 2 s).
VIT_L16 = {**VIT_B16, "model_name": "large"}
VIT_H14 = {**VIT_B16, "model_name": "huge", "patch_size": 14}
SIZES = {"ViT-L/16": (VIT_L16, 256), "ViT-H/14": (VIT_H14, 128)}
SIZE_WARMUP, SIZE_TIMED = 3, 5
# ViT-H/14's attention: 16 heads of width 80 over E = 1280, L = 257. K1 and
# K2 at its microbatch and at the tiles' edge lengths; K1's causal and
# masked modes and K3 (no preset of the repo takes them at d = 80) at a few.
VIT_H_HEADS, VIT_H_L = (16, 1280), 257
D80_EDGE_SHAPES = [(8, l) for l in (16, 17, 33, 64, 65, 129, 257)]
D80_MODE_LENGTHS = (17, 65, 129, 257)
# K3 against its algebra emulated in float32 (P and dS rounded to bf16),
# past half a bf16 ulp of each output: float32 summation order and the
# tensor cores' truncating accumulation over 257 keys read 4.9e-3 at
# ViT-H/14's shape (PERF.md section 6), so the limit is about twice that.
EMULATED_ABS = 1e-2
# The ViT-H/14 cross-check runs its full width at 4 of its 32 blocks.
VIT_H_CHECK_BLOCKS = 4
# Whole-model logits, kernel path vs plain attention path, both bf16: the two
# attention paths round to bf16 at different places (the kernel rounds the
# unnormalised probabilities and divides by the row sum last, the plain path
# rounds the normalised weights), and 12 residual blocks compound each
# ~2^-9 relative difference. Logits of this model are O(1).
LOGITS_MAX_ABS, LOGITS_MEAN_ABS = 1e-1, 2e-2

# GPT-2 slice: tools/bench_models.py bench_gpt2 (:77-121) at its batch 64.
GPT2_BASE = {"implementation": "gpt2", "model_name": "base", "compute_dtype": "bfloat16",
             "seed": 0}
GPT2_BATCH, GPT2_LR = 64, 3e-4
GPT2_OPTIMIZER = {"optimizer": "adamw", "lr": GPT2_LR}
GPT2_SHAPE = (64, 1024)                      # (N, L) of the train step
# The causal checks: the train step's shape (timed), then 14 lengths at N=8.
CAUSAL_SHAPES = [GPT2_SHAPE] + [(8, l) for l in (1, 16, 17, 33, 64, 65, 129, 255, 256, 257,
                                                  511, 512, 513, 1024)]
GPT2_CHECK_BATCH, GPT2_FIXED_BATCH = 4, 8

# The flash kernels: (N, h, L, causal). bf16 at the Llama-1B train step's
# attention (timed) and at edge lengths; float32 at GPT-2 base's heads.
FLASH_BF16 = [(4, 32, 1024, True)] + [(2, 32, l, causal)
                                      for l in (1, 16, 63, 64, 65, 127, 129, 1000)
                                      for causal in (True, False)]
FLASH_FP32 = [(8, 12, 1024, True)] + [(2, 12, l, causal)
                                      for l in (1, 16, 17, 65, 129, 1000)
                                      for causal in (True, False)]
# float32 throughout, against the float32 plain version: only the order of
# summation differs (~1e-6 seen), so the limits are 100x that.
FLASH_FP32_MAX_ABS, FLASH_FP32_MEAN_ABS = 1e-4, 1e-5

# GPT-2 float32: its default compute dtype (vitef_tpu/models/gpt2.py:38).
GPT2_FP32 = {**GPT2_BASE, "compute_dtype": "float32"}
# float32 throughout on both paths (TF32 off): logits held relative to their
# largest entry, gradients by relative L2, at 100x what float32 summation
# order gives through 12 layers.
FP32_LOGITS_REL, FP32_GRAD_REL_L2 = 1e-3, 1e-3

# Llama slice: tools/bench_models.py bench_llama(batch=4, size="1b") (:132-194,
# :228-235): the "1b" preset at seq_len 1024, bf16, AdamW 3e-4 like GPT-2's.
LLAMA_1B = {"implementation": "llama", "model_name": "1b", "seq_len": 1024,
            "pretrained": False, "compute_dtype": "bfloat16", "seed": 0}
LLAMA_BATCH, LLAMA_WARMUP = 4, 2
# The fused loss against the unfused one on bf16 logits of |x| < 4: bf16
# rounding of the logits moves the CE by well under this.
FUSED_LOSS_ABS = 1e-2

# MoE slice: tools/bench_models.py bench_llama(batch=8, size="8x124m",
# implementation="moe") (:132-194, :216-220): the "8x124m" preset at seq_len
# 1024, bf16, AdamW 3e-4 like GPT-2's.
MOE_8X124M = {"implementation": "moe", "model_name": "8x124m", "seq_len": 1024,
              "compute_dtype": "bfloat16", "moe_impl": "auto", "seed": 0}
MOE_BATCH, MOE_FIXED_BATCH = 8, 8
# The grouped products: (E, d, f, group sizes). The step's shapes (E=8,
# d=768, f=2048, 8 x 1024 tokens' top-2 claims from a seeded router draw;
# timed), then edge cases: empty and one-row experts with G=1000 (not a tile
# multiple), every row in one expert, the tiny preset's widths; float32 at a
# small shape.
GROUPED_EDGES = [(8, 768, 2048, [0, 1, 300, 0, 250, 1, 448, 0]),
                 (8, 768, 2048, [0, 0, 0, 1000, 0, 0, 0, 0]),
                 (4, 64, 128, [0, 37, 1, 62]),
                 (3, 72, 136, [63, 2, 65]),
                 (3, 136, 72, [127, 2, 129])]
GROUPED_FP32 = [(4, 128, 256, [100, 0, 1, 199])]
GROUPED = ("gmm", "gmm_swiglu", "gmm_dy_swiglu", "gmm_dual", "tgmm_swiglu", "tgmm")

# K6, LayerNorm at ViT-B/16's eps: the finetune's rows (a microbatch of 256
# images x 197 tokens = 50,432) in bfloat16 and the analysis's (128 x 197 =
# 25,216) in float32, then every edge case of rows x widths x bias x eps.
# float32 against the float32 plain version differs by the order of summation
# only (~1e-6), so its limits are 100x that.
LN_BF16_ROWS, LN_FP32_ROWS = 256 * 197, 128 * 197
LN_EDGE_ROWS, LN_EDGE_WIDTHS, LN_EDGE_EPS = (1, 7, 255, 257, 1000), (64, 768, 1024, 1280), \
    (1e-12, 1e-6)
LN_FP32_MAX_ABS, LN_FP32_MEAN_ABS = 1e-4, 1e-5
VIT_B16_K6 = {**VIT_B16, "norm_impl": "kernel"}

# The read-outs on ViT-B/16: the plasticity analysis in float32 at batch 128
# (apps/vit/analysis.py's defaults, AnalysisConfig :90, :99, with analysis()'s
# in21k model), two synthetic batches from different seeds; the linear
# probing features in bfloat16 at batch 512 (LinearProbingConfig :129) over
# a synthetic train loader (the on-device probe runs in the ViT apps phase).
VIT_B16_ANALYSIS = {"implementation": "vit", "model_name": "base", "patch_size": 16,
                    "image_dim": (3, 224, 224), "pretrained": True, "in21k": True,
                    "compute_dtype": "float32", "norm_impl": "kernel", "seed": 0}
ANALYSIS_BATCH = 128
# Each distance against the plain path's, relative to the key's largest: the
# float32 kernel and plain LN differ by summation order (~1e-6) and 12 blocks
# hardly grow it, so 1e-4 is 100x that.
ANALYSIS_REL = 1e-4
VIT_B16_PROBING = {**VIT_B16_ANALYSIS, "compute_dtype": "bfloat16"}
PROBING_TRAIN = {"dataset_name": "synthetic-2048", "batch_size": 512, "val_batch_size": 512,
                 "size": 224, "compute_dtype": "bfloat16", "seed": 0}
# The L2-normalised bf16 embeddings of each key, kernel path (K1 + K6) vs the
# plain path: both bf16 through up to 12 blocks, as the eval logits, so the
# gradients' relative L2 bound holds them.
PROBE_EMB_REL_L2 = GRAD_REL_L2

# The ViT apps phase: the paper's train command line as the sweep runs it
# (apps/vit/configs/cifar10.yaml: ViT-B/16, batch 512 as 2 x 256, bf16, SGD
# momentum 0.9, lr 1e-2, cosine schedule, clip 1) with one of sweep_lib.sh's
# freeze configs (the embedding and the head train), from random weights, on
# CIFAR-10 files at CIFAR-10's size (class-separable pixels from
# default_rng(0), as tests/test_apps_train_eval.py builds them). 60 steps
# with warmup 10 (the config's 2000 would hold the lr near 0) and an
# evaluation every 30; then a resume to step 70, the eval command line as a
# subprocess, and linear probing on a second set of 5,000 + 1,000 images.
REPO_ROOT = Path(__file__).resolve().parent
APPS_CIFAR = (50_000, 10_000)
APPS_PROBE_CIFAR = (5_000, 1_000)
APPS_COMPONENTS = ["attn_norm", "mha", "ffn_norm", "ffn_fc1", "ffn_fc2"]
APPS_MODEL = {"implementation": "vit", "model_name": "base", "pretrained": False,
              "in21k": True, "patch_size": 16, "image_dim": (3, 224, 224), "finetuning": True,
              "n_classes": 10, "compute_dtype": "bfloat16"}
APPS_STEPS, APPS_RESUMED_STEPS, APPS_EVAL_PERIOD, APPS_LOGGING_PERIOD = 60, 70, 30, 10
APPS_SPLIT_TIMED = 10     # steps timed at 1 x 512 and at 2 x 256
APPS_BATCH = 512
TRAIN_RECORD_KEYS = {"loss", "step", "lr", "grad_norm", "elapsed_steps", "ts"}
EVAL_RECORD_KEYS = {"eval_acc", "eval_loss", "step", "ts"}
CHECKPOINT_FILES = {"model.npz", "optim.npz", "training.json", "params.json"}
# The sweep's name of that run (sweep_lib.sh: its freeze config is comp_1),
# which the plots' readers parse.
APPS_LOG_DIR = "vit_cifar10_seed_42_lr_1e-2_comp_1"

# The plots phase, on phase 34's CIFAR-10 files: the loss-landscape ``save``
# command (save_results' defaults: ln1, fc1 and mha at block 0 of ViT-B/16
# in float32, batch 4, 20 SGD steps at lr 1e-3, a 20 x 20 grid over +-0.5),
# each surface recomputed on the host CPU at its four corners and one
# interior point within PLOTS_REL of the card's (float32 both, TF32 off:
# the card and the host sum in different orders, ~1e-6 relative); each PCA
# plane against numpy's SVD of the same trajectory in float64. Then the
# token radius at print_radius's settings and the bounds of ViT-B/16,
# ViT-L/16 and ViT-H/14, a few blocks of each against scipy's float64 SVDs
# on the host (float32 SVDs on the card, ~1e-6 relative).
PLOTS_POINTS = [(0, 0), (0, 19), (19, 0), (19, 19), (7, 12)]   # (row j, column i)
PLOTS_REL = 1e-4
PCA_ABS = 1e-6
RADIUS = {"model_name": "base", "patch_size": 16, "dataset_name": "cifar10",
          "batch_size": 16, "max_steps": 1000}
RADIUS_HOST_STEPS = 20
BOUND_MODELS = [("base", 16), ("large", 16), ("huge", 14)]
BOUND_CHECK_BLOCKS = {"base": [0, 11], "large": [23], "huge": [31]}
BOUND_REL = 1e-5

# The serving slice: GPT-2 base in bf16 (random weights from seed 0;
# pretrained=True falls back to them without a local cache) at
# tools/profile_decode.py's shapes: batch 256, prompts of 32-128 tokens from
# np.random.default_rng(0) left-padded to P = 128, 128 new tokens, in its
# "topk" (T 0.8, top-k 40) and "greedy" modes.
GPT2_SERVE = {**GPT2_BASE, "pretrained": True}
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 256, 128, 128
SERVE_MODES = {"topk": {"temperature": 0.8, "top_k": 40}, "greedy": {"temperature": 0.0}}
# K1's key-masked mode at the serving prefill (N=256, L=128, causal, lengths
# 16-128 from default_rng(0), one row of length 1), then edge lengths.
MASKED_SHAPE = (256, 128)
MASKED_EDGE_LENGTHS = (1, 63, 65, 127, 197, 512, 1024)
# bf16 logits of two paths that round at different places through 12
# blocks: relative L2 bound of the serving cross-checks.
SERVE_REL_L2 = 2e-2
# tools/profile_server.py: 256 requests (prompts 16-120, max_new 16-96, seed
# 0) through 64 slots of 256 positions, bucket 64, a harvest every 8 ticks.
SERVER_REQUESTS = 256
SERVER = {"n_slots": 64, "max_len": 256, "bucket": 64}

# Llama-3.1-8B serving: the JAX package's "8b" preset (vitef_tpu/models/
# llama.py:47-49: E = 4096, 32 heads of 128, 8 KV heads, 32 layers,
# V = 128,256) at full width and depth, random weights from seed 0, bf16,
# seq_len 1024. K1 at d = 128 first: its four modes against the float32
# plain version at L8B_K1_LENGTHS (N = 8, the masked mode with left-pad
# lengths that leave rows empty) and at the path's shapes, the generate
# prefill (masked, causal) and an admission (unmasked causal, one prompt at
# the largest bucket); timed at those two.
LLAMA_8B = {"implementation": "llama", "model_name": "8b", "seq_len": 1024,
            "pretrained": False, "compute_dtype": "bfloat16", "seed": 0}
L8B_HEADS = (32, 4096)
L8B_K1_LENGTHS = (1, 16, 17, 64, 65, 129, 257, 512, 577, 578)
L8B_ADMISSION = (1, 512)
# generate: 32 prompts of 64-512 tokens (lengths from default_rng(0)),
# left-padded to 512, 64 new tokens, greedy and top-k 40 at T 0.8.
L8B_BATCH, L8B_PROMPT, L8B_NEW = 32, 512, 64
# the server: 64 requests (prompts 32-480, 16-128 new tokens, default_rng(0))
# through 16 slots of 1024 positions, bucket 64.
L8B_REQUESTS = 64
L8B_SERVER = {"n_slots": 16, "max_len": 1024, "bucket": 64}
# int8 weights against a bf16 model holding their dequantized values: the
# power-of-two scales commute with the sums and int8 x 2^k is exact in bf16,
# so the two differ where bf16 rounds outputs of other sums (the scale is
# applied to the float32 sum before its rounding, not after); held to the
# serving checks' bound.
L8B_SERVE_ARGV = ["run", "--implementation", "llama", "--model_name", "8b", "--quantize",
                  "int8", "--demo", "16"]

# K9, the ring hop, as (N, h, segment, d): the GPT-2 sp step's hop (zigzag
# at sp = 1 and L = 1024; timed, the main path's shape), then
# tools/profile_ring_hop.py's (sp = 8 zigzag at L 8192 and 16384), then
# edge segments and d = 128. Each runs in three position cases: mid-ring
# (every key visible), diagonal, fully future.
RING_HOP_MAIN = (8, 12, 512, 64)
RING_HOP_CASES = [RING_HOP_MAIN, (1, 12, 512, 64), (1, 12, 1024, 64), (2, 12, 128, 64),
                  (2, 12, 384, 64), (2, 12, 640, 64), (2, 4, 512, 128)]
RING_HOP_CHAIN = 8          # hops per timed chain, the state fed through
# m is the running max of float32 scores whose bf16 products are exact:
# kernel and plain version differ by summation order, ~1e-6 at |m| ~ 5.
RING_HOP_M_ABS = 1e-4
# The hop's gradients through its autograd path and through its plain
# version's: one float32 replay, the bf16 casts of dq, dk, dv at 2^-9.
HOP_GRAD_REL_L2 = 1e-2

# The sp train slice: GPT-2 base through make_sp_train_step at sp = 1 (a
# one-rank NCCL group), bf16, batch 8 x 1024 tokens of default_rng(0) with
# labels rolled by -1, AdamW 3e-4 with bench_gpt2's schedule, clip 1.0:
# zigzag, then contiguous, each 2 warm-up and 10 timed steps.
SP_BATCH, SP_WARMUP = 8, 2
SP_K9_PER_LAYER = {True: 3, False: 1}   # hops taken per layer at sp = 1


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches (CUDA events).

    The device first spins (``torch.cuda._sleep``) for longer than the host
    takes to enqueue the ``iters`` calls, so they run back to back: a call
    whose host work (autograd, allocation) outlasts its device work is timed
    by the device work, not by the gaps between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = min(SPIN_MAX_MS, 1.5 * iters * host_ms + 1.0)
    torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, peak_flops: float, tensors) -> dict:
    """The least time the card could take for a call: the larger of its
    operations over the peak rate for their type and the bytes of its inputs
    and outputs (each counted once) over the memory rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def attention_flops(n: int, l: int, products: int, causal: bool, emb: int = EMB) -> float:
    """FLOPs of ``products`` L x L x d products over all N sequences and the
    heads of width ``emb``, counting only the lower triangle's L(L+1)/2
    scores when causal."""
    pairs = l * (l + 1) / 2 if causal else l * l
    return 2.0 * products * n * pairs * emb


def split_heads(qkv, bias, n_heads: int = N_HEADS):
    """q, k, v (N, h, L, d) of ``qkv + bias``: the operands of SDPA."""
    n, l, _ = qkv.shape
    return [t.reshape(n, l, n_heads, -1).transpose(1, 2) for t in (qkv + bias).chunk(3, -1)]


def sdpa_ms(qkv, bias, causal: bool, g=None, iters: int = 20, n_heads: int = N_HEADS) -> float:
    """``F.scaled_dot_product_attention`` on the same split heads, forward or
    (given the cotangent ``g``) backward: the library yardstick, used nowhere
    in the port."""
    q, k, v = split_heads(qkv, bias, n_heads)
    if g is None:
        with torch.inference_mode():
            return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                           iters)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    gh = g.reshape(out.shape[0], out.shape[2], n_heads, -1).transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), gh, retain_graph=True), iters)


def tflops(flops: float, ms: float) -> float:
    return flops / (ms * 1e-3) / 1e12


def lse_reference(q, k, causal: bool, key_mask=None):
    """(N, h, L) float32 log2-sum-exp of the plain scaled scores q kᵀ/√d, the
    causal mask's and ``key_mask``'s (N, L) invalid keys left out: what K1
    and K4 write as each row's lse (a row with no valid key gives -inf)."""
    l, d = q.shape[2], q.shape[3]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    if causal:
        scores = scores.masked_fill(torch.ones(l, l, dtype=torch.bool, device=q.device)
                                    .triu(1), -math.inf)
    if key_mask is not None:
        scores = scores.masked_fill(~key_mask[:, None, None, :], -math.inf)
    return torch.logsumexp(scores, dim=-1) / math.log(2)


@contextlib.contextmanager
def counting(module, *names):
    """Replace each function ``module.<name>`` by a wrapper that records its
    calls; yields the list of recorded names and restores the originals."""
    calls, originals = [], {name: getattr(module, name) for name in names}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapper

    for name, fn in originals.items():
        setattr(module, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


@contextlib.contextmanager
def no_plain_versions():
    """Record every call of the plain versions (of K1-K5 and K10)."""
    with counting(A, "attention_reference", "packed_mha_reference",
                  "packed_mha_bwd_reference", "flash_bwd_reference") as calls, \
            counting(T, "augment_train_reference") as aug_calls:
        yield calls, aug_calls


def kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled symbol: the last component of the
    (length-prefixed) nested name, with its integer, bool and named type
    template arguments, as in ``packed_bwd_dq_kernel<1>`` or
    ``ring_hop_mma_kernel<__half,64>``."""
    i = 3 if mangled.startswith("_ZN") else 2
    parts = []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    name = parts[-1] if parts else mangled
    if mangled[i:i + 1] != "I":
        return name
    args, i = [], i + 1
    while m := (re.match(r"L[a-z](\d+)E", mangled[i:]) or re.match(r"(\d+)", mangled[i:])):
        if m.group().startswith("L"):
            args.append(m.group(1))
            i += m.end()
        else:
            args.append(mangled[i + m.end():i + m.end() + int(m.group(1))])
            i += m.end() + int(m.group(1))
    return f"{name}<{','.join(args)}>"


def ptxas_kernels(log: str) -> list[tuple[str, str, str, str]]:
    """(kernel, registers, static shared-memory bytes, spills) of each entry
    point in a ``-Xptxas -v`` log."""
    found, name, spills = [], None, ""
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name, spills = m.group(1), ""
        elif "spill" in line:
            spills = line.strip()
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            smem = re.search(r"(\d+) bytes smem", line)
            found.append((kernel_name(name), m.group(1), smem.group(1) if smem else "0", spills))
            name = None
    return found


def sass_ops(lib: str, opcode: str = "HMMA") -> dict[str, list[str]]:
    """The instructions of each kernel in ``lib<lib>.so`` whose text holds
    ``opcode`` (HMMA: mma.sync on the tensor cores; HGMMA: wgmma), as
    ``cuobjdump -sass`` prints them, by the kernel's mangled name."""
    sass = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass",
                           str(_build.BUILD_DIR / f"lib{lib}.so")],
                          check=True, capture_output=True, text=True, timeout=120).stdout
    found = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        found[name.strip()] = [line.split("*/", 1)[-1].strip().rstrip(" ;")
                               for line in body.splitlines() if opcode in line]
    return found


def build_phase() -> None:
    t0 = time.perf_counter()
    _build.build(KERNELS)
    print(f"built {', '.join(KERNELS)} in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    t0 = time.perf_counter()
    native.eval_transform_batch(np.zeros((1, 8, 8, 3), np.uint8), 4)  # g++, at first use
    print(f"built the native image ops in {time.perf_counter() - t0:.2f} s (g++)")
    for name in KERNELS:
        for kernel, registers, smem, spills in ptxas_kernels(_build.build_log(name)):
            print(f"ptxas {name}: {kernel}: {registers} registers, {smem} bytes of static "
                  f"shared memory; {spills}")
    for name in TENSOR_CORE_LIBS:
        hmma = sum(len(lines) for lines in sass_ops(name).values())
        print(f"lib{name}.so: {hmma} HMMA (tensor-core) instructions in cuobjdump -sass")
        if hmma == 0:
            raise AssertionError(f"lib{name}.so holds no tensor-core instruction")
    for name in KERNELS:
        for line in _build.build_log(name).splitlines():
            if "Performance Loss" in line:  # ptxas serialising wgmma, and why
                print(f"ptxas {name}: {line.strip()}")
    for lib, kernel, opcode, want, count in SASS_KERNELS:
        found = {fn: lines for fn, lines in sass_ops(lib, opcode).items()
                 if kernel in kernel_name(fn)}
        for fn, lines in sorted(found.items()):
            held = [line for line in lines if want in line]
            print(f"lib{lib}.so {kernel_name(fn)}: {len(held)} {want} instructions "
                  f"({', '.join(sorted({line.split()[0] for line in lines})) or f'no {opcode}'})")
            if not held:
                raise AssertionError(f"{kernel_name(fn)} holds no {want} instruction")
        if len(found) != count:
            raise AssertionError(f"lib{lib}.so: want {kernel}'s {count} instantiations, found "
                                 f"{sorted(found)}")


def in_turns(kernel, plain, iters: int = 20) -> tuple[float, float, list[float]]:
    """(kernel ms, plain ms, all four times), timed plain, kernel, kernel, plain."""
    times = [cuda_ms(plain, iters), cuda_ms(kernel, iters), cuda_ms(kernel, iters),
             cuda_ms(plain, iters)]
    return min(times[1:3]), min(times[0], times[3]), times


def fwd_phase(device, shapes, causal: bool, seed: int, iters: int,
              heads: tuple[int, int] = (N_HEADS, EMB)) -> dict:
    """K1 (causal or not) against its float32 plain version on the same bf16
    inputs at every (N, L) of ``shapes``, its lse against the plain scores'
    and bit-identical over two launches; then timed at the first of them (the
    main path's shape, whose error is the one returned) with the plain
    version and SDPA. ``heads`` is (n_heads, E): ViT-B/16's by default,
    ViT-H/14's (16, 1280) for the head width 80."""
    gen = torch.Generator().manual_seed(seed)
    h, e = heads
    label = ("K1 causal" if causal else "K1") + ("" if e // h == 64 else f" d={e // h}")
    for n, l in shapes:
        qkv = (torch.randn(n, l, 3 * e, generator=gen) * 0.5).to(device, torch.bfloat16)
        bias = (torch.randn(3 * e, generator=gen) * 0.1).to(device, torch.bfloat16)
        with torch.inference_mode():
            out = A.fused_mha_packed(qkv, h, causal=causal, bias=bias)
            again, lse = A._launch_fwd(qkv, bias, h, causal, want_lse=True)
            ref = A.packed_mha_reference(qkv.float(), h, causal=causal,
                                         bias=bias.float())
            lse_err = (lse - lse_reference(*split_heads(qkv, bias, h)[:2], causal)).abs().max()
            lse_err = lse_err.item()
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        max_abs, mean_abs = diff.max().item(), diff.mean().item()
        identical = torch.equal(out, again)
        del ref, diff
        print(f"{label} packed_mha_fwd N={n} L={l}: max|d|={max_abs:.3e} "
              f"mean|d|={mean_abs:.3e}; lse max|d|={lse_err:.3e}; two launches "
              f"bit-identical: {identical}")
        if not (tuple(out.shape) == (n, l, e) and math.isfinite(max_abs)
                and max_abs <= KERNEL_MAX_ABS and mean_abs <= KERNEL_MEAN_ABS
                and lse_err <= LSE_MAX_ABS):
            raise AssertionError(f"{label} disagrees with its plain version at N={n} L={l}")
        if not identical:
            raise AssertionError(f"{label} is not deterministic at N={n} L={l}")
        if (n, l) == shapes[0]:
            timed, main_err = (qkv, bias), max_abs

    (n, l), (qkv, bias) = shapes[0], timed
    with torch.inference_mode():
        ms, plain_ms, times = in_turns(
            lambda: A.fused_mha_packed(qkv, h, causal=causal, bias=bias),
            lambda: A.packed_mha_reference(qkv, h, causal=causal, bias=bias), iters)
        out = A.fused_mha_packed(qkv, h, causal=causal, bias=bias)
    library_ms = sdpa_ms(qkv, bias, causal=causal, iters=iters, n_heads=h)
    flops = attention_flops(n, l, 2, causal, e)
    limit = bound(flops, PEAK_BF16_FLOPS, (qkv, bias, out))
    print(f"{label} at N={n} L={l} E={e} h={h}: kernel {times[1]:.4f}/"
          f"{times[2]:.4f} ms ({tflops(flops, ms):.1f} TFLOP/s), plain {times[0]:.4f}/"
          f"{times[3]:.4f} ms ({tflops(flops, plain_ms):.1f}), SDPA {library_ms:.4f} ms "
          f"({tflops(flops, library_ms):.1f}), bound {limit['bound_ms']:.4f} ms "
          f"({limit['bound_by']})")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms, **limit,
            "library_ms": library_ms}


def backward_graph(qkv, bias, causal: bool, n_heads: int = N_HEADS):
    """(the backward as a function of the cotangent, the forward's output):
    one K1 forward whose graph is kept, so each call runs its backward (K2,
    or K3 when causal) alone, as the train step does."""
    leaves = (qkv.detach().requires_grad_(), bias.detach().requires_grad_())
    out = A.fused_mha_packed(leaves[0], n_heads, causal=causal, bias=leaves[1])
    return lambda g: torch.autograd.grad(out, leaves, g, retain_graph=True), out


def bwd_phase(device, shapes, causal: bool, seed: int, iters: int,
              heads: tuple[int, int] = (N_HEADS, EMB)) -> dict:
    """The backward (K2, or K3 when causal), through the autograd path that
    the train step takes, against the float32 plain backward on the same bf16
    inputs at every (N, L) of ``shapes``, bit-identical over two launches;
    then timed at the first of them (the main path's shape, whose error is
    the one returned) with the plain version and SDPA's backward. ``heads``
    as in fwd_phase."""
    gen = torch.Generator().manual_seed(seed)
    h, e = heads
    label = ("K3" if causal else "K2") + ("" if e // h == 64 else f" d={e // h}")
    for n, l in shapes:
        qkv = (torch.randn(n, l, 3 * e, generator=gen) * 0.5).to(device, torch.bfloat16)
        bias = (torch.randn(3 * e, generator=gen) * 0.1).to(device, torch.bfloat16)
        g = torch.randn(n, l, e, generator=gen).to(device, torch.bfloat16)
        backward, out = backward_graph(qkv, bias, causal, h)
        launches = A.packed_mha_bwd.launches
        dqkv, db = backward(g)
        again = backward(g)
        if A.packed_mha_bwd.launches != launches + 2:
            raise AssertionError(f"the backward did not launch {label}")
        ref_dqkv, ref_db = A.packed_mha_bwd_reference(qkv.float(), bias.float(), g.float(),
                                                      h, causal=causal)
        torch.cuda.synchronize()
        diff = (dqkv.float() - ref_dqkv).abs()
        max_abs, mean_abs = diff.max().item(), diff.mean().item()
        db_max, db_scale = (db.float() - ref_db).abs().max().item(), ref_db.abs().max().item()
        del ref_dqkv, diff
        identical = torch.equal(dqkv, again[0]) and torch.equal(db, again[1])
        print(f"{label} packed_mha_bwd N={n} L={l}: dqkv max|d|={max_abs:.3e} "
              f"mean|d|={mean_abs:.3e}; db max|d|={db_max:.3e} (max|db|={db_scale:.3f}); "
              f"two launches bit-identical: {identical}")
        if not (tuple(dqkv.shape) == (n, l, 3 * e) and db.dtype == bias.dtype
                and math.isfinite(max_abs) and max_abs <= KERNEL_MAX_ABS
                and mean_abs <= KERNEL_MEAN_ABS and db_max <= DB_MAX_REL * db_scale):
            raise AssertionError(f"{label} disagrees with its plain version at N={n} L={l}")
        if not identical:
            raise AssertionError(f"{label} is not deterministic at N={n} L={l}")
        if (n, l) == shapes[0]:
            timed, main_err = (qkv, bias, g, backward, out), max_abs

    (n, l), (qkv, bias, g, backward, out) = shapes[0], timed
    # What the kernel does not take raises on CUDA; nothing falls back.
    lse = torch.zeros((n, h, l), dtype=torch.float32, device=device)
    # a head count whose width the kernel is not instantiated for: 48 at
    # ViT-B/16's E, 128 at ViT-H/14's
    bad_h = next(c for c in (16, 10) if e % c == 0 and e // c not in A._PACKED_BWD_HEAD_DIMS)
    refused = [(TypeError, lambda: A.packed_mha_bwd(qkv.float(), bias, g, out, lse, h,
                                                    causal=causal)),
               (NotImplementedError, lambda: A.packed_mha_bwd(qkv, bias, g, out, lse, bad_h,
                                                              causal=causal))]
    launches = A.packed_mha_bwd.launches
    for error, call in refused:
        try:
            call()
        except error:
            continue
        raise AssertionError(f"{label}'s wrapper did not raise {error.__name__}")
    if A.packed_mha_bwd.launches != launches:
        raise AssertionError(f"{label}'s wrapper launched on an input it does not take")
    print(f"{label} wrapper raises for float32 input and head width {e // bad_h}")

    ms, plain_ms, times = in_turns(
        lambda: backward(g),
        lambda: A.packed_mha_bwd_reference(qkv, bias, g, h, causal=causal), iters)
    library_ms = sdpa_ms(qkv, bias, causal=causal, g=g, iters=iters, n_heads=h)
    dqkv, db = backward(g)
    flops = attention_flops(n, l, 5, causal, e)
    limit = bound(flops, PEAK_BF16_FLOPS, (qkv, bias, g, out, lse, dqkv, db.float()))
    print(f"{label} at N={n} L={l} E={e} h={h}: kernel {times[1]:.4f}/"
          f"{times[2]:.4f} ms ({tflops(flops, ms):.1f} TFLOP/s of the 5 products), plain "
          f"{times[0]:.4f}/{times[3]:.4f} ms, SDPA backward {library_ms:.4f} ms "
          f"({tflops(flops, library_ms):.1f}), bound {limit['bound_ms']:.4f} ms "
          f"({limit['bound_by']})")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms, **limit,
            "library_ms": library_ms}


def flash_flops(n: int, h: int, l: int, d: int, products: int, causal: bool) -> float:
    """FLOPs of ``products`` L x L x d products over N sequences and h heads,
    counting only the lower triangle's L(L+1)/2 scores when causal."""
    pairs = l * (l + 1) / 2 if causal else l * l
    return 2.0 * products * n * h * pairs * d


def flash_inputs(gen, n: int, h: int, l: int, dtype, device):
    """q, k, v (scale 0.5, as the packed phases draw qkv) and a cotangent g,
    (N, h, L, 64) in ``dtype`` on ``device``."""
    shape = (n, h, l, 64)
    return ([(torch.randn(shape, generator=gen) * 0.5).to(device, dtype) for _ in range(3)]
            + [torch.randn(shape, generator=gen).to(device, dtype)])


def flash_limits(dtype) -> tuple[float, float, float]:
    """(max |d|, mean |d|, peak FLOP/s) of a flash kernel in ``dtype``."""
    if dtype == torch.bfloat16:
        return KERNEL_MAX_ABS, KERNEL_MEAN_ABS, PEAK_BF16_FLOPS
    return FLASH_FP32_MAX_ABS, FLASH_FP32_MEAN_ABS, PEAK_FP32_FLOPS


def flash_bound(label: str, dtype, flops: float, tensors, nhl) -> dict:
    """A flash kernel's bound. float32 runs in split TF32, TF32_PRODUCTS TF32
    products per float32 product: its least time is the lesser of that and
    the CUDA cores' bound, both printed."""
    limit = bound(flops, flash_limits(dtype)[2], tensors)
    if dtype == torch.float32:
        tf32 = bound(TF32_PRODUCTS * flops, PEAK_TF32_FLOPS, tensors)
        n, h, l = nhl
        print(f"{label} bound at N={n} h={h} L={l}: {limit['bound_ms']:.4f} ms on the CUDA "
              f"cores ({PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s), {tf32['bound_ms']:.4f} ms over the "
              f"{TF32_PRODUCTS} TF32 products per float32 product it issues "
              f"({PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s)")
        limit = min(limit, tf32, key=lambda b: b["bound_ms"])
    return limit


def flash_fwd_phase(device, dtype, cases, seed: int, iters: int) -> dict:
    """K4 against its float32 plain version (``attention_reference``) on the
    same inputs at every (N, h, L, causal) of ``cases``, its lse against the
    plain scores' and bit-identical over two launches; then timed at the
    first of them (the main path's shape, whose error is the one returned)
    with the plain version and SDPA."""
    gen = torch.Generator().manual_seed(seed)
    max_lim, mean_lim, _ = flash_limits(dtype)
    label = f"K4 flash_fwd {str(dtype).removeprefix('torch.')}"
    for n, h, l, causal in cases:
        q, k, v, _ = flash_inputs(gen, n, h, l, dtype, device)
        launches = A.flash_attention.launches
        with torch.inference_mode():
            out = A.flash_attention(q, k, v, causal=causal, impl="kernel")
            ref = A.attention_reference(q.float(), k.float(), v.float(), causal=causal)
        if A.flash_attention.launches != launches + 1:
            raise AssertionError(f"{label} did not launch at N={n} h={h} L={l}")
        with torch.inference_mode():
            again, lse = A._launch_flash_fwd(q, k, v, causal, want_lse=True)
            lse_err = (lse - lse_reference(q, k, causal)).abs().max().item()
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        max_abs, mean_abs = diff.max().item(), diff.mean().item()
        identical = torch.equal(out, again)
        del ref, diff
        print(f"{label} N={n} h={h} L={l} causal={causal}: max|d|={max_abs:.3e} "
              f"mean|d|={mean_abs:.3e}; lse max|d|={lse_err:.3e}; two launches "
              f"bit-identical: {identical}")
        if not (out.shape == q.shape and out.dtype == dtype and math.isfinite(max_abs)
                and max_abs <= max_lim and mean_abs <= mean_lim and lse_err <= LSE_MAX_ABS):
            raise AssertionError(f"{label} disagrees with its plain version at N={n} h={h} "
                                 f"L={l} causal={causal}")
        if not identical:
            raise AssertionError(f"{label} is not deterministic at N={n} h={h} L={l}")
        if (n, h, l, causal) == cases[0]:
            timed, main_err = (q, k, v, out), max_abs

    (n, h, l, causal), (q, k, v, out) = cases[0], timed
    with torch.inference_mode():
        ms, plain_ms, times = in_turns(
            lambda: A.flash_attention(q, k, v, causal=causal, impl="kernel"),
            lambda: A.attention_reference(q, k, v, causal=causal), iters)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                             iters)
    flops = flash_flops(n, h, l, 64, 2, causal)
    limit = flash_bound(label, dtype, flops, (q, k, v, out), (n, h, l))
    print(f"{label} at N={n} h={h} L={l} causal={causal}: kernel {times[1]:.4f}/"
          f"{times[2]:.4f} ms ({tflops(flops, ms):.1f} TFLOP/s), plain {times[0]:.4f}/"
          f"{times[3]:.4f} ms ({tflops(flops, plain_ms):.1f}), SDPA {library_ms:.4f} ms "
          f"({tflops(flops, library_ms):.1f}), bound {limit['bound_ms']:.4f} ms "
          f"({limit['bound_by']})")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms, **limit,
            "library_ms": library_ms}


def flash_backward_graph(q, k, v, causal: bool):
    """(the backward as a function of the cotangent, the forward's output):
    one K4 forward whose graph is kept, so each call runs K5 alone, as the
    train step does."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = A.flash_attention(*leaves, causal=causal, impl="kernel")
    return lambda g: torch.autograd.grad(out, leaves, g, retain_graph=True), out


def flash_bwd_phase(device, dtype, cases, seed: int, iters: int) -> dict:
    """K5, through the autograd path that the train step takes, against its
    float32 plain version (``flash_bwd_reference``) on the same inputs at
    every (N, h, L, causal) of ``cases``, bit-identical over two launches;
    what its wrapper does not take raises; then timed at the first case (the
    main path's shape, whose error is the one returned) with the plain
    version and SDPA's backward."""
    gen = torch.Generator().manual_seed(seed)
    max_lim, mean_lim, _ = flash_limits(dtype)
    label = f"K5 flash_bwd {str(dtype).removeprefix('torch.')}"
    for n, h, l, causal in cases:
        q, k, v, g = flash_inputs(gen, n, h, l, dtype, device)
        backward, out = flash_backward_graph(q, k, v, causal)
        launches = A.flash_bwd.launches
        grads = backward(g)
        again = backward(g)
        if A.flash_bwd.launches != launches + 2:
            raise AssertionError(f"the backward did not launch {label}")
        refs = A.flash_bwd_reference(q.float(), k.float(), v.float(), g.float(), causal=causal)
        torch.cuda.synchronize()
        diffs = [(a.float() - b).abs() for a, b in zip(grads, refs)]
        max_abs = max(d.max().item() for d in diffs)
        mean_abs = sum(d.mean().item() for d in diffs) / 3
        del refs, diffs
        identical = all(torch.equal(a, b) for a, b in zip(grads, again))
        print(f"{label} N={n} h={h} L={l} causal={causal}: dq/dk/dv max|d|={max_abs:.3e} "
              f"mean|d|={mean_abs:.3e}; two launches bit-identical: {identical}")
        if not (all(t.shape == q.shape and t.dtype == dtype for t in grads)
                and math.isfinite(max_abs) and max_abs <= max_lim and mean_abs <= mean_lim):
            raise AssertionError(f"{label} disagrees with its plain version at N={n} h={h} "
                                 f"L={l} causal={causal}")
        if not identical:
            raise AssertionError(f"{label} is not deterministic at N={n} h={h} L={l}")
        if (n, h, l, causal) == cases[0]:
            timed, main_err = (q, k, v, g, backward, out), max_abs

    (n, h, l, causal), (q, k, v, g, backward, out) = cases[0], timed
    # What the kernels do not take raises on CUDA; nothing falls back.
    lse = torch.zeros((n, h, l), dtype=torch.float32, device=device)
    narrow = [t[..., :32] for t in (q, k, v, g, out)]
    refused = [(TypeError, lambda: A.flash_bwd(*(t.half() for t in (q, k, v, g, out)), lse)),
               (NotImplementedError, lambda: A.flash_bwd(*narrow, lse)),
               (TypeError, lambda: A.flash_attention(q.half(), k.half(), v.half(),
                                                     impl="kernel")),
               (NotImplementedError, lambda: A.flash_attention(*narrow[:3], impl="kernel"))]
    launches = (A.flash_attention.launches, A.flash_bwd.launches)
    for error, call in refused:
        try:
            call()
        except error:
            continue
        raise AssertionError(f"{label}'s wrappers did not raise {error.__name__}")
    if (A.flash_attention.launches, A.flash_bwd.launches) != launches:
        raise AssertionError(f"{label}'s wrappers launched on an input they do not take")
    print(f"{label}: K4's and K5's wrappers raise for float16 input and head width 32")

    ms, plain_ms, times = in_turns(
        lambda: backward(g),
        lambda: A.flash_bwd_reference(q, k, v, g, causal=causal), iters)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    library_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True),
                         iters)
    del sdpa_out, leaves
    grads = backward(g)
    flops = flash_flops(n, h, l, 64, 5, causal)
    limit = flash_bound(label, dtype, flops, (q, k, v, g, out, lse, *grads), (n, h, l))
    print(f"{label} at N={n} h={h} L={l} causal={causal}: kernel {times[1]:.4f}/"
          f"{times[2]:.4f} ms ({tflops(flops, ms):.1f} TFLOP/s of the 5 products), plain "
          f"{times[0]:.4f}/{times[3]:.4f} ms, SDPA backward {library_ms:.4f} ms "
          f"({tflops(flops, library_ms):.1f}), bound {limit['bound_ms']:.4f} ms "
          f"({limit['bound_by']})")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms, **limit,
            "library_ms": library_ms}


def router_sizes(seed: int, n_tokens: int, n_experts: int, top_k: int = 2) -> list[int]:
    """Claims per expert of a seeded top-k router draw over ``n_tokens``
    tokens: normal logits plus a per-expert offset, so the groups are
    uneven."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n_tokens, n_experts)) + rng.normal(size=n_experts)
    picks = np.argsort(-logits, axis=1, kind="stable")[:, :top_k]
    return np.bincount(picks.ravel(), minlength=n_experts).tolist()


def grouped_case(name: str, sizes: list[int], d: int, f: int, dtype, device, gen):
    """One grouped-product entry point at (E = len(sizes), d, f): ``(kernel,
    plain, flops, tensors, library)``. ``kernel()`` and ``plain()`` (the plain
    version on the same inputs in float32) return tuples of outputs;
    ``tensors`` are the inputs and outputs the bound counts; ``library`` lists
    (label, call) yardsticks for the bare product: ``torch._grouped_mm``,
    where this torch has it, and the per-expert loop. Inputs are
    scaled so that every output is O(1)."""
    e, g_rows = len(sizes), sum(sizes)
    sz = torch.tensor(sizes, device=device)
    offs = torch.cumsum(sz, 0).to(torch.int32)
    bounds = np.cumsum([0] + sizes).tolist()

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device, dtype)

    # Outputs of standard deviation <= 0.5 stay under 4 in magnitude, where a
    # bf16 step is 2^-6 (2^-5 in [4, 8), more than the limit allows).

    def f32(*ts):
        return [t.float() for t in ts]

    def grouped_mm(a, b):
        """torch._grouped_mm of (G, k) rows by (E, k, n), and the per-expert
        torch.mm loop."""
        return [("torch._grouped_mm", lambda: torch._grouped_mm(a, b, offs=offs)),
                ("per-expert torch.mm loop", lambda: torch.cat(
                    [a[bounds[i]:bounds[i + 1]] @ b[i] for i in range(e)]))]

    def grouped_mm_t(a_t, b):
        """torch._grouped_mm of (k, G) by (G, n) into (E, k, n), and the loop."""
        return [("torch._grouped_mm", lambda: torch._grouped_mm(a_t, b, offs=offs)),
                ("per-expert torch.mm loop", lambda: torch.stack(
                    [a_t[:, bounds[i]:bounds[i + 1]] @ b[bounds[i]:bounds[i + 1]]
                     for i in range(e)]))]

    rows = max(max(sizes), 1)  # tgmm sums up to this many rows
    if name == "gmm":
        lhs, rhs = randn(g_rows, d), randn(e, d, 2 * f, scale=0.5 * d ** -0.5)
        return ((lambda: (G.gmm(lhs, rhs, sz),)),
                (lambda: (G.gmm_reference(*f32(lhs, rhs), sz),)),
                2.0 * g_rows * d * 2 * f, [lhs, rhs, sz, lhs.new_empty(g_rows, 2 * f)],
                grouped_mm(lhs, rhs))
    if name == "gmm_swiglu":
        h, w2 = randn(g_rows, 2 * f), randn(e, f, d, scale=f ** -0.5)
        y = (F.silu(h[:, :f].float()) * h[:, f:].float()).to(dtype)
        return ((lambda: (GF.gmm_swiglu(h, w2, sz),)),
                (lambda: (GF.gmm_swiglu_reference(*f32(h, w2), sz),)),
                2.0 * g_rows * f * d, [h, w2, sz, h.new_empty(g_rows, d)], grouped_mm(y, w2))
    if name == "gmm_dy_swiglu":
        g, w2t, h = randn(g_rows, d, scale=0.5), randn(e, d, f, scale=d ** -0.5), \
            randn(g_rows, 2 * f, scale=0.5)
        return ((lambda: GF.gmm_dy_swiglu(g, w2t, h, sz)),
                (lambda: GF.gmm_dy_swiglu_reference(*f32(g, w2t, h), sz)),
                2.0 * g_rows * d * f, [g, w2t, h, sz, g.new_empty(2, g_rows, f)],
                grouped_mm(g, w2t))
    if name == "gmm_dual":
        a, b = randn(g_rows, f), randn(g_rows, f)
        rt = randn(e, 2 * f, d, scale=0.5 * (2 * f) ** -0.5)
        ab = torch.cat([a, b], dim=1)
        return ((lambda: (GF.gmm_dual(a, b, rt, sz),)),
                (lambda: (GF.gmm_dual_reference(*f32(a, b, rt), sz),)),
                2.0 * g_rows * 2 * f * d, [a, b, rt, sz, a.new_empty(g_rows, d)],
                grouped_mm(ab, rt))
    if name == "tgmm_swiglu":
        h, g = randn(g_rows, 2 * f), randn(g_rows, d, scale=0.5 * rows ** -0.5)
        y = (F.silu(h[:, :f].float()) * h[:, f:].float()).to(dtype)
        return ((lambda: (GF.tgmm_swiglu(h, g, sz),)),
                (lambda: (GF.tgmm_swiglu_reference(*f32(h, g), sz),)),
                2.0 * g_rows * f * d, [h, g, sz, h.new_empty(e, f, d)], grouped_mm_t(y.t(), g))
    assert name == "tgmm"
    x, dh = randn(g_rows, d), randn(g_rows, f, scale=0.5 * rows ** -0.5)
    return ((lambda: (G.tgmm(x.t(), dh, sz, e),)),
            (lambda: (G.tgmm_reference(x.t().float(), dh.float(), sz, e),)),
            2.0 * g_rows * d * f, [x, dh, sz, x.new_empty(e, d, f)], grouped_mm_t(x.t(), dh))


def library_grouped(candidates, iters: int):
    """(ms, label) of the first yardstick that runs here and gives the last
    one's result (the per-expert loop) within 5e-2 of its largest entry."""
    with torch.inference_mode():
        ref = candidates[-1][1]()
    scale = ref.abs().max().item()
    for label, call in candidates:
        try:
            with torch.inference_mode():
                out = call()
            torch.cuda.synchronize()
        except (RuntimeError, TypeError, ValueError, NotImplementedError, AttributeError) as err:
            print(f"  yardstick {label}: not taken ({type(err).__name__}: {str(err)[:120]})")
            continue
        if out.shape != ref.shape or (out.float() - ref.float()).abs().max().item() > 5e-2 * scale:
            print(f"  yardstick {label}: not taken (another result)")
            continue
        with torch.inference_mode():
            return cuda_ms(call, iters), label
    return None, None


def tile_shapes(name: str, tensors, plain, flops: float, iters: int) -> None:
    """A TMA kernel at each column tile of GMM_TILES on the step's operands:
    csrc/gmm.cu ``gmm_tile`` for K8 ``gmm`` and K7 ``gmm_swiglu``,
    ``gmm_dy_swiglu`` and ``gmm_dual``, csrc/tgmm.cu ``tgmm_tile`` for K8
    ``tgmm`` and K7 ``tgmm_swiglu`` (also in each walk of TGMM_WALKS); each
    against the plain version within the bf16 gate and timed, in turns."""
    stream = torch.cuda.current_stream().cuda_stream
    if name.startswith("tgmm"):
        a, b, sz, out = tensors
        fn = _build.kernel_function("tgmm_tile", 4, 7, source="tgmm")
        variants = [(tile_n, walk) for tile_n in GMM_TILES for walk in TGMM_WALKS]
        pointers = (a, b, sz.to(torch.int32), out)
        shape = (a.shape[0], out.shape[1], b.shape[1], out.shape[0], TILE_MODES[name])
        outs = (out,)
    else:
        b = h = out2 = None
        if name == "gmm_dual":
            a, b, w, sz, out = tensors
        elif name == "gmm_dy_swiglu":
            a, w, h, sz, (out, out2) = tensors
        else:
            a, w, sz, out = tensors
        fn = _build.kernel_function("gmm_tile", 7, 6, source="gmm")
        variants = [(tile_n,) for tile_n in GMM_TILES]
        pointers = (a, b, w, h, sz.to(torch.int32), out, out2)
        shape = (a.shape[0], w.shape[1], w.shape[2], w.shape[0], TILE_MODES[name])
        outs = (out,) if out2 is None else (out, out2)

    def call(*variant):
        err = fn(*(None if t is None else t.data_ptr() for t in pointers), *shape, *variant,
                 stream)
        if err != 0:
            raise RuntimeError(f"{name} tile launch failed: cudaError {err} "
                               f"({label(*variant)})")

    def label(tile_n, *walk):
        return f"128 x {tile_n}" + "".join(f", {TGMM_WALKS[w]}" for w in walk)

    with torch.inference_mode():
        refs = plain()
    times = {}
    for variant in variants + variants[::-1]:
        for t in outs:
            t.zero_()
        call(*variant)
        torch.cuda.synchronize()
        diffs = [(t.float() - ref).abs() for t, ref in zip(outs, refs)]
        max_abs = max(d.max().item() for d in diffs)
        mean_abs = sum(d.mean().item() for d in diffs) / len(diffs)
        if not (max_abs <= KERNEL_MAX_ABS and mean_abs <= KERNEL_MEAN_ABS):
            raise AssertionError(f"{name} at {label(*variant)} disagrees with its plain version: "
                                 f"max|d|={max_abs:.3e} mean|d|={mean_abs:.3e}")
        times.setdefault(variant, []).append(cuda_ms(lambda: call(*variant), iters))
    print(f"{name} bf16 column tiles at the 8x124m step, timed in turns: " + "; ".join(
        f"{label(*v)}: " + "/".join(f"{ms:.4f}" for ms in times[v])
        + f" ms ({flops / min(times[v]) / 1e9:.1f} TFLOP/s)" for v in variants)
        + " (max|d| within the bf16 gate at each)")


def recip_check(device) -> None:
    """gmm_dy_swiglu's epilogue takes its sigmoid's 1 / d from recip_fast
    (csrc/gmm_common.cuh), the division's fast path without its branch: it
    must give 1.f / d's bits at every float d in [1, 2^126), the range where
    the epilogue uses it (csrc/gmm.cu gmm_recip_check)."""
    found = torch.zeros(1, dtype=torch.int64, device=device)
    err = _build.kernel_function("gmm_recip_check", 1, 0, source="gmm")(
        found.data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err != 0:
        raise RuntimeError(f"gmm_recip_check launch failed: cudaError {err}")
    print(f"gmm_dy_swiglu's recip_fast against 1.f / d at all {0x7e800000 - 0x3f800000:,} floats "
          f"in [1, 2^126): {found.item()} differ")
    if found.item():
        raise AssertionError("recip_fast differs from the division it stands for")


def grouped_phase(device, name: str, seed: int, iters: int) -> dict:
    """One grouped-product entry point in bfloat16 against its float32 plain
    version at the 8x124m step's shapes and at the edge cases, and in
    float32 at a small shape; bit-identical over two launches; the wrapper
    raises for float16 and for a width not a multiple of 8; then timed at the
    step's shapes with its plain version, its bound and the yardstick."""
    gen = torch.Generator().manual_seed(seed)
    wrapper = getattr(GF, name, None) or getattr(G, name)
    if name == "gmm_dy_swiglu":
        recip_check(device)
    step = (8, EMB, 2048, router_sizes(seed, MOE_BATCH * 1024, 8))
    cases = ([(torch.bfloat16, c) for c in [step] + GROUPED_EDGES]
             + [(torch.float32, c) for c in GROUPED_FP32])
    for dtype, (e, d, f, sizes) in cases:
        kernel, plain, flops, tensors, library = grouped_case(name, sizes, d, f, dtype, device, gen)
        launches = wrapper.launches
        outs, again = kernel(), kernel()
        if wrapper.launches != launches + 2:
            raise AssertionError(f"{name} did not launch its kernel")
        refs = plain()
        torch.cuda.synchronize()
        max_lim, mean_lim, _ = flash_limits(dtype)
        diffs = [(a.float() - b).abs() for a, b in zip(outs, refs)]
        max_abs = max(t.max().item() for t in diffs)
        mean_abs = sum(t.mean().item() for t in diffs) / len(diffs)
        identical = all(torch.equal(a, b) for a, b in zip(outs, again))
        label = f"{name} {str(dtype).removeprefix('torch.')} E={e} d={d} f={f} G={sum(sizes)}"
        print(f"{label} sizes {sizes}: max|d|={max_abs:.3e} mean|d|={mean_abs:.3e} (max|ref|="
              f"{max(r.abs().max().item() for r in refs):.3f}); two launches bit-identical: "
              f"{identical}")
        if not (all(a.shape == b.shape and a.dtype == dtype for a, b in zip(outs, refs))
                and math.isfinite(max_abs) and max_abs <= max_lim and mean_abs <= mean_lim):
            raise AssertionError(f"{label} disagrees with its plain version")
        if not identical:
            raise AssertionError(f"{label} is not deterministic")
        if name.startswith("tgmm") and any(outs[0][i].any() for i, size in enumerate(sizes)
                                           if size == 0):
            raise AssertionError(f"{label}: an empty group's output is not exactly zero")
        if (e, d, f, sizes) == step:
            timed = (kernel, plain, flops, tensors, library, max_abs)
        del outs, again, refs, diffs

    # What the kernels do not take raises on CUDA; nothing falls back.
    sz = torch.tensor([3, 5], device=device)
    x16 = torch.zeros(8, 16, device=device, dtype=torch.float16)
    w16 = torch.zeros(2, 16, 16, device=device, dtype=torch.float16)
    x12 = torch.zeros(8, 12, device=device, dtype=torch.bfloat16)
    w12 = torch.zeros(2, 12, 16, device=device, dtype=torch.bfloat16)
    refused = {"gmm": [(TypeError, lambda: G.gmm(x16, w16, sz)),
                       (ValueError, lambda: G.gmm(x12, w12, sz))],
               "tgmm": [(TypeError, lambda: G.tgmm(x16.t(), x16, sz, 2)),
                        (ValueError, lambda: G.tgmm(x12.t(), x12, sz, 2))],
               "gmm_swiglu": [(TypeError, lambda: GF.gmm_swiglu(x16, w16[:, :8], sz)),
                              (ValueError, lambda: GF.gmm_swiglu(x12, w12[:, :6], sz))],
               "gmm_dy_swiglu": [(TypeError, lambda: GF.gmm_dy_swiglu(x16, w16[:, :, :8], x16, sz)),
                                 (ValueError, lambda: GF.gmm_dy_swiglu(
                                     x12, w12[:, :, :6], x12, sz))],
               "gmm_dual": [(TypeError, lambda: GF.gmm_dual(x16[:, :8], x16[:, :8], w16, sz)),
                            (ValueError, lambda: GF.gmm_dual(x12[:, :6], x12[:, :6], w12, sz))],
               "tgmm_swiglu": [(TypeError, lambda: GF.tgmm_swiglu(x16, x16, sz)),
                               (ValueError, lambda: GF.tgmm_swiglu(x12, x12, sz))]}[name]
    launches = wrapper.launches
    for error, call in refused:
        try:
            call()
        except error:
            continue
        raise AssertionError(f"{name}'s wrapper did not raise {error.__name__}")
    if wrapper.launches != launches:
        raise AssertionError(f"{name}'s wrapper launched on an input it does not take")
    print(f"{name}: the wrapper raises for float16 input and a width of 12 or 6")

    # With no rows csrc/gmm.cu has nothing to launch, and its wrappers count
    # no launch; csrc/tgmm.cu still launches, to write each group's zeros.
    sz0 = torch.zeros(2, dtype=torch.int64, device=device)
    z16 = torch.zeros(0, 16, device=device, dtype=torch.bfloat16)
    w = torch.zeros(2, 16, 16, device=device, dtype=torch.bfloat16)
    no_rows = {"gmm": lambda: G.gmm(z16, w, sz0),
               "gmm_swiglu": lambda: GF.gmm_swiglu(z16, w[:, :8], sz0),
               "gmm_dy_swiglu": lambda: GF.gmm_dy_swiglu(z16, w[:, :, :8], z16, sz0),
               "gmm_dual": lambda: GF.gmm_dual(z16[:, :8], z16[:, :8], w, sz0)}
    if name in no_rows:
        launches = wrapper.launches
        outs = no_rows[name]()
        outs = outs if isinstance(outs, tuple) else (outs,)
        torch.cuda.synchronize()
        if wrapper.launches != launches or any(t.shape[0] != 0 for t in outs):
            raise AssertionError(f"{name} counted a launch or gave rows for an input of no rows")
        print(f"{name}: no rows, no launch counted")

    kernel, plain, flops, tensors, library, main_err = timed
    with torch.inference_mode():
        ms, plain_ms, times = in_turns(kernel, plain, iters)
    library_ms, library_label = library_grouped(library, iters)
    limit = bound(flops, PEAK_BF16_FLOPS, tensors)
    bare = "" if name in ("gmm", "tgmm") else " (the bare product, without the swiglu)"
    print(f"{name} bf16 at the 8x124m step (E=8 d={EMB} f=2048 G={sum(step[3])}): "
          f"kernel {times[1]:.4f}/{times[2]:.4f} ms, plain {times[0]:.4f}/{times[3]:.4f} ms, "
          f"yardstick {library_label}{bare} "
          + (f"{library_ms:.4f} ms" if library_ms is not None else "none")
          + f", bound {limit['bound_ms']:.4f} ms ({limit['bound_by']}); "
          f"{flops / ms / 1e9:.1f} TFLOP/s")
    tile_shapes(name, tensors, plain, flops, iters)
    # library_ms: one PyTorch call computing the same function; the K7
    # passes fuse the swiglu, which no single call does.
    same_function = name in ("gmm", "tgmm") and str(library_label).startswith("torch.")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms, **limit,
            "library_ms": library_ms if same_function else None}


def swiglu_y_phase(device, seed: int) -> None:
    """The y = bf16(silu(g)·u) that K7 ``gmm_swiglu`` and ``tgmm_swiglu``
    make in their prologues (csrc/gmm_common.cuh ``silu_fast``), read out
    exactly: ``gmm_swiglu`` with W = I gives y, ``tgmm_swiglu`` with rows of
    I as its right operand gives yᵀ, group by group. Gate values span -16 to
    4, so most lie where sigmoid is small and an absolute error on it would
    be a large relative one on y. Each y must lie within one bf16 rounding
    (2^-8 of |y|) plus 2^-12 of |y| of silu(g)·u in float64, and the two
    kernels' y must agree bit for bit, so dw2 is taken against the y that
    the forward multiplied."""
    gen = torch.Generator().manual_seed(seed)
    rows, f = 512, 256
    sizes = torch.tensor([200, rows - 200], device=device)
    g = (torch.rand(rows, f, generator=gen) * 20 - 16).to(torch.bfloat16)
    u = torch.randn(rows, f, generator=gen).to(torch.bfloat16)
    h = torch.cat([g, u], dim=1).to(device)
    eye = torch.eye(f, dtype=torch.bfloat16, device=device)
    y_fwd = GF.gmm_swiglu(h, eye.expand(2, f, f).contiguous(), sizes)
    eye_rows = torch.eye(rows, dtype=torch.bfloat16, device=device)
    y_bwd = GF.tgmm_swiglu(h, eye_rows, sizes).sum(0).t()
    torch.cuda.synchronize()
    g64, u64 = g.double(), u.double()
    exact = (g64 * torch.sigmoid(g64) * u64).to(device)
    nonzero = exact != 0
    rel = ((y_fwd.double() - exact).abs() / exact.abs())[nonzero]
    worst = rel.max().item()
    at = g.to(device)[nonzero].flatten()[rel.argmax()].item()
    limit = 2.0 ** -8 + 2.0 ** -12
    same = torch.equal(y_fwd, y_bwd)
    print(f"K7 swiglu prologue y (rows {rows}, f {f}, gate values -16 to 4, "
          f"{(g <= -2).float().mean().item():.1%} at or below -2): worst |y - exact| / |y| = "
          f"{worst:.3e} (at g = {at:.3f}; limit {limit:.3e}, one bf16 rounding 3.906e-03 plus "
          f"2^-12); gmm_swiglu's and tgmm_swiglu's y bit-identical: {same}")
    if not (math.isfinite(worst) and worst <= limit):
        raise AssertionError("the swiglu prologue's y is off by more than one bf16 rounding")
    if not same:
        raise AssertionError("gmm_swiglu and tgmm_swiglu make different y")


def k10_inputs(rng, n: int, h: int, w: int, device):
    """A uint8 batch with crops drawn as the loader draws them, the first
    eight boxes touching every edge (the whole image, 1 x 1 corners, one-pixel
    strips along each side), flips on and off in turn over the first eight."""
    raw = torch.from_numpy(rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)).to(device)
    boxes, flips = T.sample_crop_batch(rng, n, h, w)
    edges = [(0, 0, h, w), (0, 0, 1, 1), (h - 1, w - 1, 1, 1), (0, 0, 1, w),
             (h - 1, 0, 1, w), (0, 0, h, 1), (0, w - 1, h, 1), (0, w - 1, 1, 1)]
    boxes[:len(edges)] = edges[:n]
    flips[:8] = [i % 2 == 0 for i in range(min(n, 8))]
    return raw, torch.from_numpy(boxes).to(device), torch.from_numpy(flips).to(device)


def k10_gate(raw, boxes, flips, size: int) -> tuple[float, float]:
    """K10 in bf16 and in float32 against the float32 plain version on the
    same inputs: bf16 within the kernels' bf16 gates and, value by value,
    within one rounding to bf16 (2^-8 of the value) and the float32 limit;
    float32 within K10_F32_MEAN and K10_F32_MAX. Returns the bf16 output's
    (max, mean) error. Raises on disagreement."""
    n, h, w, _ = raw.shape
    rows, smem, _ = k10_plan(h, w, size)
    ref = T.augment_train_reference(raw, boxes, flips, size)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        out = T.augment_train_device(raw, boxes, flips, size=size, compute_dtype=dtype)
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        errs[dtype] = (tuple(out.shape) == (n, 3, size, size), diff.max().item(),
                       diff.mean().item())
        if dtype == torch.bfloat16:
            rounded = bool((diff <= 2.0 ** -8 * ref.abs() + K10_F32_MAX).all())
    (shape16, max16, mean16), (shape32, max32, mean32) = errs.values()
    print(f"K10 N={n} {h}x{w}->{size} (R={rows}, {smem} bytes of shared memory a block): bf16 "
          f"max|d|={max16:.3e} mean|d|={mean16:.3e}; float32 max|d|={max32:.3e} "
          f"mean|d|={mean32:.3e} (max|ref|={ref.abs().max().item():.3f})")
    if not (shape16 and shape32 and math.isfinite(max16) and math.isfinite(max32) and rounded
            and max16 <= KERNEL_MAX_ABS and mean16 <= KERNEL_MEAN_ABS
            and max32 <= K10_F32_MAX and mean32 <= K10_F32_MEAN):
        raise AssertionError(f"K10 disagrees with its plain version at N={n} {h}x{w}->{size}")
    return max16, mean16


def k10_plan(h: int, w: int, size: int) -> tuple[int, int, int]:
    """(output rows a block, shared-memory bytes, source rows) of the plan that
    csrc/train_augment.cu launches for an h x w source at ``size``. Raises
    unless the wrapper's plan (``augment_band_rows``, ``augment_smem_bytes``)
    is the same, or refuses the shape where the kernel's does."""
    plan = (ctypes.c_int * 3)()
    fn = _build.load_library("train_augment").train_augment_plan
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    fn(h, size, plan)
    rows, smem, src_rows = plan
    try:
        ours = T.augment_band_rows(h, w, size)
    except NotImplementedError:
        ours = 0
    if ours != rows or (rows and T.augment_smem_bytes(rows, h, size) != smem):
        raise AssertionError(f"K10's plans differ at {h}x{w}->{size}: the kernel's R={rows}, "
                             f"{smem} bytes; the wrapper's R={ours}")
    return rows, smem, src_rows


def k10_plans() -> None:
    """The kernel's and the wrapper's plans alike at K10_PLAN_SOURCES and
    every size up to one past the limit."""
    refused = 0
    for src in K10_PLAN_SOURCES:
        for size in range(1, 2642):
            refused += k10_plan(src, src, size)[0] == 0
    if refused != len(K10_PLAN_SOURCES):  # size 2641 alone, at every source
        raise AssertionError(f"K10's plan refused {refused} shapes, not "
                             f"{len(K10_PLAN_SOURCES)}")
    print(f"K10's plans agree at {len(K10_PLAN_SOURCES)} sources x sizes 1-2641 "
          "(size 2641 refused)")


def k10_outside_boxes(device) -> None:
    """Boxes past their image's edges: K10 launches without a fault and the
    images whose boxes lie within are still the plain version's."""
    rng = np.random.default_rng(17)
    raw, boxes, flips = k10_inputs(rng, 64, 32, 32, device)
    bad = torch.tensor([[0, 0, 1000, 1000], [20, 20, 32, 32], [-5, -7, 3, 3],
                        [31, 0, -4, 16], [0, 0, 0, 0]], dtype=boxes.dtype, device=device)
    boxes[8:8 + len(bad)] = bad
    out = T.augment_train_device(raw, boxes, flips, size=224, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    keep = torch.ones(64, dtype=torch.bool, device=device)
    keep[8:8 + len(bad)] = False
    diff = (out[keep] - T.augment_train_reference(raw, boxes, flips, 224)[keep]).abs().max()
    print(f"K10 with {len(bad)} boxes past their image: launched; the other images "
          f"max|d|={diff.item():.3e}")
    if not diff.item() <= K10_F32_MAX:
        raise AssertionError("K10 with boxes past their image changed the other images")


def k10_bound(raw, boxes, flips, size: int) -> dict:
    """K10's bound on these inputs: the source pixels its taps read (the
    rows with a non-zero y weight times the columns with a non-zero x
    weight, 3 bytes each), boxes and flips, and the bf16 output written
    once; about 9 float32 operations per output value (four taps,
    renormalise, normalise)."""
    h, w = raw.shape[1], raw.shape[2]
    values = raw.shape[0] * 3 * size * size
    b = boxes.long()
    rows = (T._bilinear_weights(b[:, 0], b[:, 2], size, h, torch.zeros_like(flips.bool()))
            != 0).any(1).sum(1)
    cols = (T._bilinear_weights(b[:, 1], b[:, 3], size, w, flips.bool()) != 0).any(1).sum(1)
    nbytes = (3 * int((rows * cols).sum()) + boxes.numel() * boxes.element_size()
              + flips.numel() * flips.element_size() + 2 * values)
    ops_ms, bytes_ms = 9.0 * values / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def k10_refusals(device) -> None:
    """The wrapper raises for what the kernel does not take, and the C entry
    point refuses a size past the plan's limit before any launch."""
    def raw(h, w, dtype=torch.uint8):
        return torch.zeros((2, h, w, 3), dtype=dtype, device=device)
    boxes = torch.tensor([[0, 0, 1, 1]] * 2, dtype=torch.int32, device=device)
    flips = torch.zeros(2, dtype=torch.bool, device=device)
    cases = {"a non-square 100x150 source at size 64": (NotImplementedError, raw(100, 150), 64,
                                                        torch.bfloat16),
             "size 2641, past the limit of 2640": (NotImplementedError, raw(32, 32), 2641,
                                                   torch.bfloat16),
             "int8 input": (ValueError, raw(32, 32, torch.int8), 224, torch.bfloat16),
             "a float16 output": (TypeError, raw(32, 32), 224, torch.float16)}
    for label, (error, images, size, dtype) in cases.items():
        try:
            T.augment_train_device(images, boxes, flips, size=size, compute_dtype=dtype)
        except error as e:
            print(f"K10 refuses {label}: {type(e).__name__}: {e}")
        else:
            raise AssertionError(f"K10 took {label}")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _build.kernel_function("train_augment", 4, 5)(None, None, None, None, 1, 32, 32,
                                                         2641, 1, stream)
    if err != 1:  # cudaErrorInvalidValue
        raise AssertionError(f"train_augment's C entry point took size 2641 (cudaError {err})")


def k10_phase(device) -> dict:
    """K10's plan held to the wrapper's; K10 against its float32 plain
    version in bf16 and float32 at the main shape (batch 512, 32x32 -> 224)
    and at K10_CASES, bit-identical over two launches, the wrapper's
    refusals, boxes past their image; timed in turns with the plain version
    beside its bound at K10_TIMED. Returns the main shape's row."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("K10's plain version must multiply in float32, not TF32")
    rng = np.random.default_rng(10)
    n = TRAIN_DATA["batch_size"]
    k10_plans()
    raw, boxes, flips = k10_inputs(rng, n, 32, 32, device)
    max_abs, _ = k10_gate(raw, boxes, flips, 224)
    for count, src, size in K10_CASES:
        h, w = src if isinstance(src, tuple) else (src, src)
        k10_gate(*k10_inputs(rng, count, h, w, device), size)
    first = T.augment_train_device(raw, boxes, flips, size=224, compute_dtype=torch.bfloat16)
    again = T.augment_train_device(raw, boxes, flips, size=224, compute_dtype=torch.bfloat16)
    if not torch.equal(first, again):
        raise AssertionError("K10 is not bit-identical over two launches")
    k10_refusals(device)
    k10_outside_boxes(device)
    timed = []
    for count, src, size in K10_TIMED:
        inputs = (raw, boxes, flips) if (count, src) == (n, 32) else \
            k10_inputs(rng, count, src, src, device)
        ms, plain_ms, times = in_turns(
            lambda: T.augment_train_device(*inputs, size=size, compute_dtype=torch.bfloat16),
            lambda: T.augment_train_reference(*inputs, size, torch.bfloat16))
        limit = k10_bound(*inputs, size)
        print(f"K10 at N={count} {src}x{src}->{size} bf16: kernel {times[1]:.4f}/{times[2]:.4f} "
              f"ms, plain {times[0]:.4f}/{times[3]:.4f} ms, bound {limit['bound_ms']:.4f} ms "
              f"({limit['bound_by']}), {limit['bound_ms'] / ms:.3f} of it; no single PyTorch "
              "call computes it")
        timed.append({"ms": ms, "plain_ms": plain_ms, **limit})
    return {"max_abs_err": max_abs, **timed[0], "library_ms": None}


def ln_inputs(gen, rows: int, e: int, dtype, device, bias: bool = True):
    """x (shifted, scale 2), a cotangent g, and LayerNorm parameters near a
    trained model's (scale 0.4·(1 ± 0.1), bias ± 0.1): outputs stay under 4
    in magnitude, where a bf16 step is 2^-6 (2^-5 in [4, 8) is more than
    KERNEL_MAX_ABS allows)."""
    x = (torch.randn(rows, e, generator=gen) * 2 + 0.5).to(device, dtype)
    g = torch.randn(rows, e, generator=gen).to(device, dtype)
    w = (0.4 * (1 + 0.1 * torch.randn(e, generator=gen))).to(device)
    b = (0.1 * torch.randn(e, generator=gen)).to(device) if bias else None
    return x, g, w, b


def ln_check(x, g, w, b, eps: float) -> tuple[float, float, float, float, bool]:
    """K6's forward and dx (from the plain version's float32 statistics)
    against their float32 plain versions: (forward max |d|, mean |d|, dx max
    |d|, mean |d|, both bit-identical over two launches)."""
    launches = (LN.layer_norm.launches, LN.layer_norm_bwd_dx.launches)
    with torch.inference_mode():
        out, out2 = (LN.layer_norm(x, w, b, eps, impl="kernel") for _ in range(2))
        mean, rstd = LN.layer_norm_stats_reference(x, eps)
        dx, dx2 = (LN.layer_norm_bwd_dx(g, x, w, mean, rstd) for _ in range(2))
        ref = LN.layer_norm_reference(x.float(), w, b, eps)
        ref_dx = LN.layer_norm_bwd_dx_reference(g.float(), x.float(), w, mean, rstd)
    torch.cuda.synchronize()
    if (LN.layer_norm.launches, LN.layer_norm_bwd_dx.launches) != (launches[0] + 2,
                                                                   launches[1] + 2):
        raise AssertionError("K6's wrappers did not launch their kernels")
    if not (out.shape == dx.shape == x.shape and out.dtype == dx.dtype == x.dtype):
        raise AssertionError(f"K6 gave {out.dtype} {tuple(out.shape)} and {dx.dtype} "
                             f"{tuple(dx.shape)} for {x.dtype} {tuple(x.shape)}")
    d_out, d_dx = (out.float() - ref).abs(), (dx.float() - ref_dx).abs()
    identical = torch.equal(out, out2) and torch.equal(dx, dx2)
    return (d_out.max().item(), d_out.mean().item(), d_dx.max().item(), d_dx.mean().item(),
            identical)


def layernorm_phase(device, seed: int, iters: int) -> dict:
    """K6 (forward and dx) against its float32 plain versions: bf16 at the
    finetune's rows, float32 at the analysis's, and every edge case; both
    bit-identical over two launches; the wrappers raise for float16 and for
    widths K6 does not take; then each entry point timed at the finetune's
    shape with its plain version, its bound and ``F.layer_norm``."""
    gen = torch.Generator().manual_seed(seed)
    cases = [(torch.bfloat16, LN_BF16_ROWS, EMB, True, 1e-12),
             (torch.float32, LN_FP32_ROWS, EMB, True, 1e-12)]
    cases += [(dtype, rows, e, bias, eps) for dtype in (torch.bfloat16, torch.float32)
              for rows in LN_EDGE_ROWS for e in LN_EDGE_WIDTHS for bias in (True, False)
              for eps in LN_EDGE_EPS]
    worst = Counter()
    for dtype, rows, e, bias, eps in cases:
        x, g, w, b = ln_inputs(gen, rows, e, dtype, device, bias)
        max_out, mean_out, max_dx, mean_dx, identical = ln_check(x, g, w, b, eps)
        max_lim, mean_lim = ((KERNEL_MAX_ABS, KERNEL_MEAN_ABS) if dtype == torch.bfloat16
                             else (LN_FP32_MAX_ABS, LN_FP32_MEAN_ABS))
        label = (f"K6 layernorm {str(dtype).removeprefix('torch.')} rows={rows} E={e} "
                 f"bias={bias} eps={eps:g}")
        if rows in (LN_BF16_ROWS, LN_FP32_ROWS):
            print(f"{label}: forward max|d|={max_out:.3e} mean|d|={mean_out:.3e}; dx "
                  f"max|d|={max_dx:.3e} mean|d|={mean_dx:.3e}; two launches bit-identical: "
                  f"{identical}")
            if dtype == torch.bfloat16:
                main_err = (max_out, max_dx)
        for key, value in (("max_out", max_out), ("mean_out", mean_out), ("max_dx", max_dx),
                           ("mean_dx", mean_dx)):
            worst[str(dtype), key] = max(worst[str(dtype), key], value)
        if not (math.isfinite(max_out) and math.isfinite(max_dx) and max_out <= max_lim
                and max_dx <= max_lim and mean_out <= mean_lim and mean_dx <= mean_lim):
            raise AssertionError(f"{label} disagrees with its plain version: {max_out}, "
                                 f"{mean_out}, {max_dx}, {mean_dx}")
        if not identical:
            raise AssertionError(f"{label} is not deterministic")
    for dtype in (torch.bfloat16, torch.float32):
        print(f"K6 layernorm {str(dtype).removeprefix('torch.')}: worst over the edge cases "
              f"(rows {LN_EDGE_ROWS} x E {LN_EDGE_WIDTHS} x bias x eps {LN_EDGE_EPS}): "
              + ", ".join(f"{key} {worst[str(dtype), key]:.3e}"
                          for key in ("max_out", "mean_out", "max_dx", "mean_dx")))

    # What the kernel does not take raises on CUDA; nothing falls back.
    ones = torch.ones(EMB, device=device)
    refused = [(TypeError, lambda: LN.layer_norm(torch.zeros(4, EMB, device=device,
                                                             dtype=torch.float16),
                                                 ones, None, 1e-6, impl="kernel")),
               (NotImplementedError, lambda: LN.layer_norm(torch.zeros(4, 100, device=device),
                                                           ones[:100], None, 1e-6,
                                                           impl="kernel")),
               (NotImplementedError, lambda: LN.layer_norm(torch.zeros(4, 4096, device=device),
                                                           torch.ones(4096, device=device), None,
                                                           1e-6, impl="kernel")),
               (TypeError, lambda: LN.layer_norm_bwd_dx(
                   *(torch.zeros(4, EMB, device=device, dtype=torch.float16) for _ in range(2)),
                   ones, torch.zeros(4, device=device), torch.ones(4, device=device)))]
    launches = (LN.layer_norm.launches, LN.layer_norm_bwd_dx.launches)
    for error, call in refused:
        try:
            call()
        except error:
            continue
        raise AssertionError(f"K6's wrapper did not raise {error.__name__}")
    if (LN.layer_norm.launches, LN.layer_norm_bwd_dx.launches) != launches:
        raise AssertionError("K6's wrappers launched on an input they do not take")
    print("K6: the wrappers raise for float16 input and for widths 100 and 4096")
    # eps = 1e-12 on constant bf16 rows: float32 two-pass statistics give a
    # variance of exactly 0, so the output is exactly the bias.
    x, _, w, b = ln_inputs(gen, 64, EMB, torch.bfloat16, device)
    with torch.inference_mode():
        out = LN.layer_norm(torch.full_like(x, 3.0), w, b, 1e-12, impl="kernel")
    if not torch.equal(out, b.to(out.dtype).expand_as(out)):
        raise AssertionError("K6 does not give the bias on constant rows at eps = 1e-12")
    print("K6: constant bf16 rows at eps = 1e-12 give exactly the bias")

    # Timed at the finetune's shape as the train step runs them: the forward
    # writing its statistics, dx from them.
    x, g, w, b = ln_inputs(gen, LN_BF16_ROWS, EMB, torch.bfloat16, device)
    rows = LN_BF16_ROWS
    wb, bb = w.to(x.dtype), b.to(x.dtype)  # F.layer_norm's parameters in x's dtype
    with torch.inference_mode():
        out, mean, rstd = LN._launch_fwd(x, w, b, 1e-12, want_stats=True)
        dx = LN.layer_norm_bwd_dx(g, x, w, mean, rstd)
        fwd = in_turns(lambda: LN._launch_fwd(x, w, b, 1e-12, want_stats=True),
                       lambda: LN.layer_norm_reference(x, w, b, 1e-12), iters)
        dx_t = in_turns(lambda: LN.layer_norm_bwd_dx(g, x, w, mean, rstd),
                        lambda: LN.layer_norm_bwd_dx_reference(g, x, w, mean, rstd), iters)
        fwd_lib = cuda_ms(lambda: F.layer_norm(x, (EMB,), wb, bb, 1e-12), iters)
    xg = x.detach().requires_grad_()
    lib_out = F.layer_norm(xg, (EMB,), wb, bb, 1e-12)  # dx only: the parameters need none
    dx_lib = cuda_ms(lambda: torch.autograd.grad(lib_out, xg, g, retain_graph=True), iters)
    del lib_out, xg
    result = {}
    # about 8 float32 operations per value forward, 10 for dx
    for name, (ms, plain_ms, times), library_ms, tensors, ops, err in (
            ("layernorm_fwd", fwd, fwd_lib, (x, w, b, out, mean, rstd), 8.0, main_err[0]),
            ("layernorm_bwd_dx", dx_t, dx_lib, (g, x, w, mean, rstd, dx), 10.0, main_err[1])):
        limit = bound(ops * rows * EMB, PEAK_FP32_FLOPS, tensors)
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        yardstick = "F.layer_norm" + (" backward (dx)" if name == "layernorm_bwd_dx" else "")
        print(f"K6 {name} bf16 at rows={rows} E={EMB}: kernel {times[1]:.4f}/{times[2]:.4f} ms, "
              f"plain {times[0]:.4f}/{times[3]:.4f} ms, {yardstick} {library_ms:.4f} ms, bound "
              f"{limit['bound_ms']:.4f} ms ({limit['bound_by']}, {nbytes / 1e6:.1f} MB); "
              f"{nbytes / ms / 1e6:.1f} GB/s")
        result[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **limit,
                        "library_ms": library_ms}
    return result


def slice_phase(device):
    model = build_model(VIT_B16, device=device)
    loader = build_loader(EVAL_DATA, device=device)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(EVAL_DATA["batch_size"], 3, 224, 224, generator=gen).to(
        device, torch.bfloat16)
    model.eval_step((x, torch.zeros(len(x), dtype=torch.long, device=device)))  # warm-up
    torch.cuda.synchronize()

    with counting(A, "attention_reference") as plain_calls:
        A.fused_mha_packed.launches = 0
        t0 = time.perf_counter()
        metrics = run_evaluation(model, loader)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = A.fused_mha_packed.launches

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


def cross_check(model, x, label: str = "ViT-B/16"):
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
    print(f"{label} bf16 device-only forward, plain attention path: "
          f"{len(x) / plain_ms * 1e3:.2f} img/s ({plain_ms:.3f} ms); kernel path "
          f"again: {len(x) / kernel_ms * 1e3:.2f} img/s ({kernel_ms:.3f} ms)")
    x = x[:64]
    diff = (kernel_logits - plain_logits).abs()
    max_abs, mean_abs = diff.max().item(), diff.mean().item()
    print(f"{label} logits kernel vs plain attention ({len(x)} images): max|d|={max_abs:.3e} "
          f"mean|d|={mean_abs:.3e} (|logits| max {plain_logits.abs().max().item():.3f})")
    if not (tuple(kernel_logits.shape) == (len(x), VIT_B16["n_classes"])
            and torch.isfinite(kernel_logits).all()
            and max_abs <= LOGITS_MAX_ABS and mean_abs <= LOGITS_MEAN_ABS):
        raise AssertionError("kernel-path logits disagree with the plain path")


def vit_flops_per_image(cfg) -> float:
    """Train FLOPs per image, 3x the forward's: ``tools/bench_models.py``'s
    ``vit_flops`` (:23-26: the linears, both attention products and the
    patch embedding; the head left out)."""
    e, tokens, patch = cfg.emb_dim, cfg.seq_len, cfg.patch_size
    return 3 * 2 * tokens * (cfg.n_layers * (12 * e * e + 2 * tokens * e) + patch * patch * 3 * e)


def train_phase(model, device, label: str = "ViT-B/16", microbatch: int = AUTO_MICROBATCH,
                warmup: int = WARMUP_STEPS, timed: int = TIMED_STEPS):
    """bench.py's finetune through the port: the train loader (K10), batch
    512 as microbatches of ``microbatch`` (K1 forward, K2 backward), clip,
    SGD, cosine schedule; with ``norm_impl="kernel"`` every LayerNorm takes
    K6 (forward and dx), else its plain version. ``warmup`` untimed and
    ``timed`` timed steps through the loader, then as many device-only.
    Returns the main path's launch counts, a device-only step, the train
    dataset and the rates (img/s loader included and device-only) and peak
    memory (GiB)."""
    schedule = build_scheduler(SCHEDULER, n_steps=TRAIN_STEPS)
    optimizer, scheduler = build_optimizer(OPTIMIZER, model.module, schedule=schedule)
    batch = TRAIN_DATA["batch_size"]
    grad_acc = auto_grad_acc(batch, microbatch)
    step_fn = make_train_step(grad_acc_steps=grad_acc, schedule=schedule,
                              base_lr=OPTIMIZER["lr"], grad_clip=GRAD_CLIP)
    state = init_train_state(model, optimizer, scheduler)
    np.random.seed(0)  # the train/val split, as the app seeds it
    train_loader, _ = build_train_val_loader(TRAIN_DATA, device=device)
    batches = make_iterable(train_loader)
    print(f"{label} train: batch {batch} as {grad_acc} x {batch // grad_acc} "
          f"(auto_microbatch={microbatch}); {len(train_loader)} batches per epoch")

    for _ in range(warmup):
        step_fn(state, next(batches))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    counters = (A.fused_mha_packed, A.packed_mha_bwd, T.augment_train_device, LN.layer_norm,
                LN.layer_norm_bwd_dx)
    with no_plain_versions() as (plain_calls, aug_calls), \
            counting(LN, "layer_norm_reference", "layer_norm_bwd_dx_reference") as ln_plain:
        for counter in counters:
            counter.launches = 0
        t0 = time.perf_counter()
        history = []
        for _ in range(timed):
            history.append((state.step, step_fn(state, next(batches))))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30

    for step, metrics in history:
        loss, norm, lr = metrics["loss"].item(), metrics["grad_norm"].item(), metrics["lr"]
        want_lr = OPTIMIZER["lr"] * step / SCHEDULER["warmup"]  # inside the warmup
        if not (math.isfinite(loss) and math.isfinite(norm) and abs(lr - want_lr) <= 1e-12):
            raise AssertionError(f"step {step}: loss {loss}, grad_norm {norm}, lr {lr} "
                                 f"(want {want_lr})")
    print(f"train steps {history[0][0]}..{history[-1][0]}: loss "
          f"{history[0][1]['loss'].item():.4f} -> {history[-1][1]['loss'].item():.4f}, "
          f"grad_norm {history[-1][1]['grad_norm'].item():.4f}, lr {history[-1][1]['lr']:.6f}")
    want = model.config.n_layers * grad_acc * timed
    # every LayerNorm of every microbatch, forward and dx, when K6 is asked for
    k6 = model.config.norm_impl in ("kernel", "pallas")
    want_k6 = (sum(isinstance(m, LayerNorm) for m in model.module.modules()) * grad_acc
               * timed if k6 else 0)
    print(f"{label} train launches over {timed} steps: {launches} (K1 and K2 want "
          f"{want}, K10 {timed}, K6 forward and dx {want_k6}); plain calls "
          f"{dict(Counter(plain_calls + aug_calls + (ln_plain if k6 else [])))}")
    if launches["fused_mha_packed"] != want or launches["packed_mha_bwd"] != want \
            or launches["augment_train_device"] != timed \
            or launches["layer_norm"] != want_k6 or launches["layer_norm_bwd_dx"] != want_k6:
        raise AssertionError("the train path did not go through every kernel every step")
    if plain_calls or aug_calls or (k6 and ln_plain):
        raise AssertionError(f"plain versions ran on CUDA: "
                             f"{Counter(plain_calls + aug_calls + ln_plain)}")
    loader_rate = batch * timed / seconds
    print(f"{label} bf16 train, loader included: {loader_rate:.2f} img/s "
          f"({seconds / timed * 1e3:.3f} ms per step of {batch}); peak memory "
          f"{peak_gib:.3f} GiB (torch.cuda.max_memory_allocated) at {grad_acc} x "
          f"{batch // grad_acc}")

    # Device-only: a device-resident raw batch, boxes drawn on the host per
    # step, augment + step (bench.py:main).
    host_rng = np.random.default_rng(0)
    raw = torch.from_numpy(host_rng.integers(0, 256, size=(batch, 32, 32, 3),
                                             dtype=np.uint8)).to(device)
    y = torch.from_numpy(host_rng.integers(0, N_CLASSES, size=(batch,))).to(device)

    def one_step():
        boxes, flips = T.sample_crop_batch(host_rng, batch, 32, 32)
        x = T.augment_train_device(raw, torch.from_numpy(boxes).to(device),
                                   torch.from_numpy(flips).to(device), size=224,
                                   compute_dtype=torch.bfloat16)
        return step_fn(state, (x, y))

    for _ in range(warmup):
        one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        metrics = one_step()
    loss = metrics["loss"].item()
    seconds = time.perf_counter() - t0
    device_rate = batch * timed / seconds
    flops = vit_flops_per_image(model.config)
    print(f"{label} bf16 train, device-only (augment + step): {device_rate:.2f} img/s "
          f"({seconds / timed * 1e3:.3f} ms per step of {batch}); "
          f"{device_rate * flops / 1e12:.1f} TFLOP/s at {flops / 1e9:.1f} GFLOP per image, "
          f"{device_rate * flops / PEAK_BF16_FLOPS:.4f} of the bf16 peak; loss {loss:.4f}")
    if not math.isfinite(loss):
        raise AssertionError("device-only train loss is not finite")
    return launches, one_step, train_loader.dataset, {
        "loader_img_s": loader_rate, "device_img_s": device_rate, "peak_gib": peak_gib}


@contextlib.contextmanager
def config_set(cfg, **fields):
    """The config's fields set to ``fields`` inside the block (every module
    reads the shared config)."""
    saved = {key: getattr(cfg, key) for key in fields}
    for key, value in fields.items():
        setattr(cfg, key, value)
    try:
        yield
    finally:
        for key, value in saved.items():
            setattr(cfg, key, value)


def grads_rel_l2(got: dict, ref: dict, n_blocks: int) -> tuple[float, list[float]]:
    """Relative L2 of two gradient dicts (name -> tensor) in float32,
    overall and per block, one parameter at a time."""
    sums = Counter()
    for name, g in got.items():
        diff = (g.float() - ref[name].float()).norm().item() ** 2
        norm = ref[name].float().norm().item() ** 2
        parts = name.split(".")
        for key in ["all"] + ([f"block {parts[1]}"] if parts[0] == "blocks" else []):
            sums[key, "diff"] += diff
            sums[key, "ref"] += norm
    rel = {key: math.sqrt(sums[key, "diff"] / sums[key, "ref"]) for key, part in sums
           if part == "diff"}
    return rel["all"], [rel[f"block {i}"] for i in range(n_blocks)]


def kernel_and_plain_grads(model, loss, plain_config=None) -> tuple[float, list[float]]:
    """Gradients of ``loss(plain)`` through the kernel path (``plain`` False)
    and through the plain path (``plain`` True: the config's fields set to
    ``plain_config``, by default ``attn_impl="plain"``): their relative L2,
    overall and per block (no flattened copy of the whole model)."""
    cfg, module = model.config, model.module
    plain_config = {"attn_impl": "plain"} if plain_config is None else plain_config
    module.train()
    module.zero_grad(set_to_none=True)
    loss(False).backward()
    kernel = {name: p.grad for name, p in module.named_parameters()}
    module.zero_grad(set_to_none=True)
    with config_set(cfg, **plain_config):
        loss(True).backward()
    rel = grads_rel_l2(kernel, {name: p.grad for name, p in module.named_parameters()},
                       len(module.blocks))
    module.zero_grad(set_to_none=True)
    return rel


def check_microbatch(dataset, device, n: int = AUTO_MICROBATCH):
    """The first ``n`` raw train images on ``device``, their labels, and
    seeded crop boxes and flips: ``(raw, boxes, flips, y)``."""
    raw = torch.from_numpy(dataset.data[:n]).to(device)
    y = torch.from_numpy(np.asarray(dataset.targets[:n], np.int64)).to(device)
    boxes, flips = T.sample_crop_batch(np.random.default_rng(3), n, *raw.shape[1:3])
    return raw, torch.from_numpy(boxes).to(device), torch.from_numpy(flips).to(device), y


def train_cross_check(model, dataset, device, n: int = AUTO_MICROBATCH,
                      label: str = "ViT-B/16", per_block: bool = False) -> None:
    """One microbatch (``n`` images) of gradients through the kernels and
    through the plain path (plain attention and its autograd backward, plain
    augment), gated overall and, with ``per_block``, in each block; then a
    loss that falls on one fixed batch."""
    raw, boxes, flips, y = check_microbatch(dataset, device, n)
    x_kernel = T.augment_train_device(raw, boxes, flips, size=224,
                                      compute_dtype=torch.bfloat16)
    x_plain = T.augment_train_reference(raw, boxes, flips, 224, torch.bfloat16)
    module = model.module
    overall, blocks = kernel_and_plain_grads(
        model, lambda plain: F.cross_entropy(module(x_plain if plain else x_kernel).float(), y))
    print(f"{label} gradients of one microbatch ({n}), kernel vs plain path: relative L2 "
          f"{overall:.3e}; per block " + " ".join(f"{r:.2e}" for r in blocks))
    if not (math.isfinite(overall) and overall <= GRAD_REL_L2
            and (not per_block or all(r <= GRAD_REL_L2 for r in blocks))):
        raise AssertionError(f"{label} kernel-path gradients disagree with the plain path: "
                             f"{overall}, {blocks}")

    optimizer, scheduler = build_optimizer(OPTIMIZER, module)
    state = init_train_state(model, optimizer, scheduler)
    step_fn = make_train_step(grad_clip=GRAD_CLIP)
    batch = (x_kernel[:FIXED_BATCH], y[:FIXED_BATCH])
    losses = [step_fn(state, batch)["loss"] for _ in range(FIXED_STEPS)]
    losses = [loss.item() for loss in losses]
    print(f"{label} fixed batch of {FIXED_BATCH}, {FIXED_STEPS} steps at constant lr "
          f"{OPTIMIZER['lr']}: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the {label} fixed-batch loss did not fall: {losses}")


@contextlib.contextmanager
def norm_impl(module, impl: str):
    """Every LayerNorm of ``module`` set to ``impl`` inside the block (a norm
    reads the ``norm_impl`` it was built with)."""
    norms = [m for m in module.modules() if isinstance(m, LayerNorm)]
    saved = [m.impl for m in norms]
    for m in norms:
        m.impl = impl
    try:
        yield
    finally:
        for m, old in zip(norms, saved):
            m.impl = old


def k6_train_cross_check(model, dataset, device) -> None:
    """One microbatch's gradients with K6 (forward and dx) against the plain
    LayerNorm and its autograd backward, the rest of the path alike (K10's
    images, K1 and K2)."""
    n = AUTO_MICROBATCH
    raw, boxes, flips, y = check_microbatch(dataset, device, n)
    x = T.augment_train_device(raw, boxes, flips, size=model.config.image_dim[-1],
                               compute_dtype=torch.bfloat16)
    module = model.module

    def loss(plain: bool):
        with norm_impl(module, "plain" if plain else "kernel"):
            return F.cross_entropy(module(x).float(), y)

    launches = (LN.layer_norm.launches, LN.layer_norm_bwd_dx.launches)
    overall, per_block = kernel_and_plain_grads(model, loss, plain_config={})
    n_norms = sum(isinstance(m, LayerNorm) for m in module.modules())
    if (LN.layer_norm.launches - launches[0], LN.layer_norm_bwd_dx.launches - launches[1]) \
            != (n_norms, n_norms):
        raise AssertionError("the cross-check's kernel route did not launch K6 in every norm")
    print(f"gradients of one microbatch ({n}), K6 vs the plain LayerNorm: relative L2 "
          f"{overall:.3e}; per block " + " ".join(f"{r:.2e}" for r in per_block))
    if not (math.isfinite(overall) and overall <= GRAD_REL_L2):
        raise AssertionError(f"K6-path gradients disagree with the plain LayerNorm: {overall}")


def bwd_emulated(qkv, bias, g, n_heads: int, causal: bool) -> torch.Tensor:
    """The algebra K2 and K3 are specified to compute, emulated in float32:
    the plain backward with P and dS rounded to bf16 where they become
    operands of a product, as the TPU kernels round them (the plain version
    keeps them in float32). Returns dqkv unrounded, float32."""
    n, l, f = qkv.shape
    scale = 1.0 / math.sqrt(f // 3 // n_heads)
    q, k, v = (A._split_heads(t, n_heads).float() for t in (qkv + bias).chunk(3, dim=-1))
    gh = A._split_heads(g, n_heads).float()
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        scores = scores.masked_fill(torch.ones(l, l, dtype=torch.bool, device=qkv.device)
                                    .triu(1), -1e30)
    p = torch.softmax(scores, dim=-1)
    dv = torch.matmul(p.bfloat16().float().transpose(-1, -2), gh)
    dp = torch.matmul(gh, v.transpose(-1, -2))
    ds = (p * (dp - (p * dp).sum(dim=-1, keepdim=True)) * scale).bfloat16().float()
    dq, dk = torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q)
    return torch.cat([A._merge_heads(t) for t in (dq, dk, dv)], dim=-1)


def emulated_bwd_check(device, n: int, seed: int) -> None:
    """K3 at d = 80 at ViT-H/14's microbatch (N = n, L = 257, causal)
    against ``bwd_emulated``: each output within half a bf16 ulp of the
    emulation (its own rounding) plus EMULATED_ABS. Against the float32
    plain version this shape's largest gradients, in [4, 8), already differ
    by up to 2^-8 · 4 = 1.56e-2 from rounding the output alone, beside the
    specified rounding of P and dS, so the absolute 2e-2 gate is held at
    the edge lengths (N = 8) and this check holds the main shape."""
    h, e = VIT_H_HEADS
    gen = torch.Generator().manual_seed(seed)
    qkv = (torch.randn(n, VIT_H_L, 3 * e, generator=gen) * 0.5).to(device, torch.bfloat16)
    bias = (torch.randn(3 * e, generator=gen) * 0.1).to(device, torch.bfloat16)
    g = torch.randn(n, VIT_H_L, e, generator=gen).to(device, torch.bfloat16)
    backward, _ = backward_graph(qkv, bias, True, h)
    dqkv = backward(g)[0].float()
    with torch.no_grad():
        emu = bwd_emulated(qkv, bias, g, h, True)
        ref = A.packed_mha_bwd_reference(qkv.float(), bias.float(), g.float(), h,
                                         causal=True)[0]
    over = ((dqkv - emu).abs() - emu.abs() * 2.0 ** -8).max().item()
    plain_err = (dqkv - ref).abs()
    print(f"K3 d=80 N={n} L={VIT_H_L} against the emulated algebra (P, dS in bf16): "
          f"max(|d| - half ulp)={over:.3e}; against the float32 plain version max|d|="
          f"{plain_err.max().item():.3e} (max|dqkv| {ref.abs().max().item():.3f}; "
          f"{int((plain_err > KERNEL_MAX_ABS).sum())} of {plain_err.numel()} values past "
          f"{KERNEL_MAX_ABS})")
    if not over <= EMULATED_ABS:
        raise AssertionError(f"K3 d=80 disagrees with its emulated algebra: {over}")


def d80_phases(device, n: int) -> dict:
    """K1, K2, K1's causal and key-masked modes and K3 at head width 80
    (ViT-H/14's 16 heads over E = 1280), each against its float32 plain
    version under the bf16 gates, with lse and determinism checks: K1 and K2
    at ViT-H/14's microbatch (N = n, L = 257; timed with the plain version,
    its bound and SDPA) and at the tiles' edge lengths; K1's causal mode and
    K3 at N = 8 and D80_MODE_LENGTHS (timed at L = 257), K3 also at the main
    shape against its emulated algebra; the masked mode at those lengths,
    causal and not. Returns the timing rows by name."""
    main = [(n, VIT_H_L)]
    modes = [(8, l) for l in sorted(D80_MODE_LENGTHS, reverse=True)]
    timing = {
        "packed_mha_fwd:d80": fwd_phase(device, main + D80_EDGE_SHAPES, False, seed=60,
                                        iters=10, heads=VIT_H_HEADS),
        "packed_mha_bwd:d80": bwd_phase(device, main + D80_EDGE_SHAPES, False, seed=61,
                                        iters=10, heads=VIT_H_HEADS),
        "packed_mha_fwd:causal:d80": fwd_phase(device, modes, True, seed=62, iters=10,
                                               heads=VIT_H_HEADS),
        "packed_mha_bwd:causal:d80": bwd_phase(device, modes, True, seed=63, iters=10,
                                               heads=VIT_H_HEADS)}
    emulated_bwd_check(device, n, seed=63)
    masked_cases(device, torch.Generator().manual_seed(64),
                 [(8, l, causal, edge_lengths(l)) for l in D80_MODE_LENGTHS
                  for causal in (True, False)], heads=VIT_H_HEADS)
    return timing


def size_phase(device, label: str) -> tuple[dict, object]:
    """One preset of the model-size ablation through ``train_phase`` at its
    microbatch (K1 and K2 n_layers x microbatches launches a step, K10 one),
    then a torch.profiler split of one device-only step. Returns the launch
    counts and the train dataset."""
    config, microbatch = SIZES[label]
    t0 = time.perf_counter()
    model = build_model(config, device=device)
    cfg = model.config
    print(f"{label}: {sum(p.numel() for p in model.module.parameters()):,} parameters, "
          f"{cfg.n_layers} blocks, E={cfg.emb_dim}, {cfg.n_heads} heads of "
          f"{cfg.emb_dim // cfg.n_heads}, L={cfg.seq_len}; built in "
          f"{time.perf_counter() - t0:.2f} s; the card holds "
          f"{torch.cuda.get_device_properties(device).total_memory / 2**30:.2f} GiB")
    launches, one_step, dataset, _ = train_phase(model, device, label, microbatch,
                                                 SIZE_WARMUP, SIZE_TIMED)
    require_kinds(profile_train_step(one_step, VIT_KINDS, label), VIT_KERNEL_KINDS, label)
    return launches, dataset


def vit_h_cross_check(device, dataset) -> None:
    """ViT-H/14 at full width and VIT_H_CHECK_BLOCKS blocks (random weights
    from a seed): its logits through the kernels against the plain attention
    path, one microbatch's gradients overall and per block, and a loss that
    falls over FIXED_STEPS steps on one fixed batch."""
    label = f"ViT-H/14 ({VIT_H_CHECK_BLOCKS} blocks)"
    tcfg = dataclasses.replace(
        vit_transformer_config(ViTConfig(model_name="huge", patch_size=14,
                                         compute_dtype="bfloat16")),
        n_layers=VIT_H_CHECK_BLOCKS, n_classes=N_CLASSES)
    module = Transformer(tcfg, device=device, generator=torch.Generator().manual_seed(0))
    model = Model(module=module.eval(), config=tcfg, name=label)
    n = SIZES["ViT-H/14"][1]
    x = torch.randn(n, 3, 224, 224, generator=torch.Generator().manual_seed(1)).to(
        device, torch.bfloat16)
    cross_check(model, x, label)
    del x
    train_cross_check(model, dataset, device, n, label, per_block=True)


def analysis_phase(device) -> None:
    """The plasticity analysis on ViT-B/16 in float32 with K6: the per-key
    distances of two synthetic batches (different seeds) through
    ``make_decomposition_distance_fn``, 48 K6 launches per call and no plain
    LayerNorm, against the same model with the plain LayerNorm; then the
    time per call."""
    model = build_model(VIT_B16_ANALYSIS, device=device)
    x1, x2 = (torch.randn(ANALYSIS_BATCH, *model.config.image_dim,
                          generator=torch.Generator().manual_seed(seed)).to(device)
              for seed in (31, 32))
    decomp_dist = AN.make_decomposition_distance_fn(model)
    decomp_dist(x1, x2)  # warm-up
    torch.cuda.synchronize()
    with counting(LN, "layer_norm_reference") as ln_plain:
        LN.layer_norm.launches = 0
        t0 = time.perf_counter()
        dists = decomp_dist(x1, x2)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = LN.layer_norm.launches
    want = 2 * 2 * model.config.n_layers
    print(f"ViT-B/16 float32 analysis, two batches of {ANALYSIS_BATCH}: {len(dists)} keys, "
          f"K6 launches {launches} (want {want}), plain LayerNorm calls {len(ln_plain)}; "
          f"{seconds:.3f} s per call (two decompositions and the distances)")
    if launches != want or ln_plain:
        raise AssertionError("the analysis did not take K6 in every norm")
    with norm_impl(model.module, "plain"):
        plain = decomp_dist(x1, x2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decomp_dist(x1, x2)
        torch.cuda.synchronize()
        plain_seconds = time.perf_counter() - t0
    rel = {key: ((dists[key] - plain[key]).abs().max() / plain[key].abs().max()).item()
           for key in plain}
    worst = max(rel, key=rel.get)
    print(f"analysis distances, K6 vs the plain LayerNorm: largest relative difference "
          f"{rel[worst]:.3e} ({worst}); plain LayerNorm path {plain_seconds:.3f} s per call")
    if not (len(dists) == 1 + 5 * model.config.n_layers
            and all(d.shape == (ANALYSIS_BATCH,) and torch.isfinite(d).all()
                    for d in dists.values()) and rel[worst] <= ANALYSIS_REL):
        raise AssertionError(f"the K6 analysis disagrees with the plain path: {rel}")


def probing_phase(device) -> None:
    """The linear-probing features on ViT-B/16 in bfloat16 with K6 and K1:
    ``get_embeddings`` over a synthetic train loader (24 K6 and 12 K1
    launches per batch, no plain version) against the plain path. The
    on-device probe itself runs in the ViT apps phase, through the
    ``linear_probing`` entry point."""
    model = build_model(VIT_B16_PROBING, device=device)
    np.random.seed(0)  # the train/val split, as the app seeds it
    train_loader, _ = build_train_val_loader(PROBING_TRAIN, device=device)
    train = list(train_loader)  # one epoch, so that both paths see the same images
    LP.get_embeddings(model, train[:1], cls_pooling=False)  # warm-up
    torch.cuda.synchronize()
    with no_plain_versions() as (plain_calls, _), \
            counting(LN, "layer_norm_reference") as ln_plain:
        LN.layer_norm.launches = A.fused_mha_packed.launches = 0
        t0 = time.perf_counter()
        emb, labels = LP.get_embeddings(model, train, cls_pooling=False)
        seconds = time.perf_counter() - t0
        launches = (LN.layer_norm.launches, A.fused_mha_packed.launches)
    layers, n = model.config.n_layers, len(train)
    print(f"ViT-B/16 bf16 probe features of {len(labels)} train images ({n} batches of "
          f"{PROBING_TRAIN['batch_size']}): {len(emb)} keys in {seconds:.3f} s "
          f"({len(labels) / seconds:.2f} img/s, host copies included); K6 and K1 launches "
          f"{launches} (want {(2 * layers * n, layers * n)}); plain calls "
          f"{len(plain_calls) + len(ln_plain)}")
    if launches != (2 * layers * n, layers * n) or plain_calls or ln_plain:
        raise AssertionError("the probe features did not take K6 and K1 in every block")
    with norm_impl(model.module, "plain"), config_set(model.config, attn_impl="plain"):
        plain, plain_labels = LP.get_embeddings(model, train, cls_pooling=False)
    rel = {key: float(np.linalg.norm(emb[key] - plain[key]) / np.linalg.norm(plain[key]))
           for key in plain}
    worst = max(rel, key=rel.get)
    print(f"probe features, K1 + K6 vs the plain path: largest relative L2 {rel[worst]:.3e} "
          f"({worst})")
    if not (len(emb) == 8 * layers and np.array_equal(labels, plain_labels)
            and all(np.isfinite(v).all() for v in emb.values())
            and rel[worst] <= PROBE_EMB_REL_L2):
        raise AssertionError(f"the K6 probe features disagree with the plain path: {rel}")


# The kernels of one K2/K3 launch (csrc/packed_mha_bwd.cu).
PACKED_BWD_KERNELS = ("packed_bwd_dq_kernel", "packed_bwd_dkv_kernel", "db_partial_kernel",
                      "db_final_kernel")
VIT_KINDS = {"K1 packed_mha_fwd": ("packed_mha_fwd",),
             "K2 packed_mha_bwd": PACKED_BWD_KERNELS,
             "K10 train_augment": ("train_augment",),
             "cuBLAS GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90_"),
             "optimizer (foreach / SGD)": ("multi_tensor", "foreach")}
VIT_KERNEL_KINDS = ("K1 packed_mha_fwd", "K2 packed_mha_bwd", "K10 train_augment")
VIT_K6_KINDS = {"K6 layernorm_fwd": ("layernorm_fwd_kernel",),
                "K6 layernorm_bwd_dx": ("layernorm_bwd_dx_kernel",), **VIT_KINDS}
GPT2_KINDS = {"K1 packed_mha_fwd (causal)": ("packed_mha_fwd",),
              "K3 packed_mha_bwd (causal)": PACKED_BWD_KERNELS,
              "cuBLAS GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90_"),
              "optimizer (foreach / AdamW)": ("multi_tensor", "foreach")}


# torch.profiler (torch 2.11 on an H100) drops the first device activities
# of a trace, about one more for every second trace taken in the process:
# from the third trace of one ViT-B/16 step on, its host-to-device copies
# and then K10 were missing, whatever the host waited before the step. So
# each trace opens with TRACE_MARKERS tiny kernels
# (torch.cuda._sleep's spin_kernel) that every reading leaves out; the count
# that survives says how many activities were dropped, and a trace that
# keeps none fails.
TRACE_MARKERS, MARKER_KERNEL = 64, "spin_kernel"


@contextlib.contextmanager
def device_trace():
    """torch.profiler over the CPU and the device, opened by TRACE_MARKERS
    marker kernels; yields the profile."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_MARKERS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        yield prof


def device_events(prof) -> tuple[list, int]:
    """The trace's device events without its markers, and how many markers it
    dropped. Raises if it dropped all of them: the traced work's start may
    be missing too."""
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    kept = sum(MARKER_KERNEL in e.name for e in events)
    if kept == 0:
        raise AssertionError(f"the trace dropped all {TRACE_MARKERS} marker kernels")
    return [e for e in events if MARKER_KERNEL not in e.name], TRACE_MARKERS - kept


def require_kinds(totals: dict, kinds, label: str) -> None:
    """Raise unless the profile of ``label`` found a kernel of every kind of
    ``kinds``."""
    unseen = [kind for kind in kinds if not totals[kind]]
    if unseen:
        raise AssertionError(f"the {label} profile found no kernel of {unseen}")


def profile_train_step(one_step, kinds: dict, label: str) -> dict:
    """torch.profiler over one device-only train step: device time by kind of
    kernel (``kinds``: name -> substrings of kernel names), and the device's
    busy share of the step. Returns the ms of each kind."""
    one_step()
    torch.cuda.synchronize()
    with device_trace() as prof:
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    totals = dict.fromkeys([*kinds, "elementwise and other"], 0.0)
    counts = Counter()
    events, dropped = device_events(prof)
    # Device work only: a record_function range (such as the optimizer's
    # "Optimizer.step#AdamW.step") also appears on the device's timeline, as
    # a span over the kernels it encloses, and would count them twice.
    events = [e for e in events if not e.is_user_annotation]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    for e in events:
        name = e.name.lower()
        kind = next((k for k, keys in kinds.items() if any(key in name for key in keys)),
                    "elementwise and other")
        totals[kind] += e.time_range.elapsed_us() / 1e3
        counts[kind] += 1
    busy, end = 0.0, -math.inf
    for start, stop in spans:  # union of kernel intervals
        if stop > end:
            busy += (stop - max(start, end)) / 1e3
            end = stop
    window = (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0
    print(f"profile of one device-only {label} train step: host wall {wall_ms:.3f} ms, device "
          f"window {window:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / max(window, 1e-9):.1f}% of the window); {len(events)} device "
          f"events, {dropped} of {TRACE_MARKERS} marker kernels dropped")
    for kind, ms in totals.items():
        print(f"  {kind}: {ms:.3f} ms ({counts[kind]} kernels)")
    by_name = Counter()
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    for name, ms in by_name.most_common(10):
        print(f"  top: {ms:8.3f} ms  {name[:110]}")
    return totals


def gpt2_flops_per_token(cfg) -> float:
    """Train FLOPs per token, 3x the forward's: ``tools/bench_models.py``'s
    ``gpt2_flops`` (:29-31, the causal half of attention) over seq_len."""
    e, layers, seq = cfg.emb_dim, cfg.n_layers, cfg.seq_len
    return 3 * 2 * (layers * (12 * e * e + 2 * (seq // 2) * e) + e * cfg.vocab_size)


def gpt2_train_phase(device):
    """``bench_gpt2``'s protocol through the port: K1 causal forward, K3
    backward, fused head + CE, clip, AdamW, cosine schedule. Returns the
    model, the main path's launch counts and a device-only step."""
    model = build_model(GPT2_BASE, device=device)
    cfg = model.config
    schedule = build_scheduler(SCHEDULER, n_steps=TRAIN_STEPS)
    optimizer, scheduler = build_optimizer(GPT2_OPTIMIZER, model.module, schedule=schedule)
    step_fn = make_train_step(schedule=schedule, base_lr=GPT2_LR, grad_clip=GRAD_CLIP,
                              hidden_loss=make_fused_head_loss(cfg))
    state = init_train_state(model, optimizer, scheduler)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(GPT2_BATCH, cfg.seq_len))).to(device)

    def one_step():
        return step_fn(state, (tokens, tokens))

    for _ in range(WARMUP_STEPS):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    counters = (A.fused_mha_packed, A.packed_mha_bwd)
    with no_plain_versions() as (plain_calls, aug_calls):
        for counter in counters:
            counter.launches = 0
        t0 = time.perf_counter()
        history = [(state.step, one_step()) for _ in range(TIMED_STEPS)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30

    for step, metrics in history:
        loss, norm, lr = metrics["loss"].item(), metrics["grad_norm"].item(), metrics["lr"]
        want_lr = GPT2_LR * step / SCHEDULER["warmup"]  # inside the warmup
        if not (math.isfinite(loss) and math.isfinite(norm) and abs(lr - want_lr) <= 1e-12):
            raise AssertionError(f"GPT-2 step {step}: loss {loss}, grad_norm {norm}, lr {lr} "
                                 f"(want {want_lr})")
    print(f"GPT-2 train steps {history[0][0]}..{history[-1][0]}: loss "
          f"{history[0][1]['loss'].item():.4f} -> {history[-1][1]['loss'].item():.4f}, "
          f"grad_norm {history[-1][1]['grad_norm'].item():.4f}, lr {history[-1][1]['lr']:.8f}")
    want = cfg.n_layers * TIMED_STEPS
    print(f"GPT-2 train launches over {TIMED_STEPS} steps: {launches} (K1 and K3 want "
          f"{want}); plain calls {dict(Counter(plain_calls + aug_calls))}")
    if launches != {"fused_mha_packed": want, "packed_mha_bwd": want}:
        raise AssertionError("the GPT-2 train path did not go through K1 and K3 every layer")
    if plain_calls or aug_calls:
        raise AssertionError(f"plain versions ran on CUDA: {Counter(plain_calls + aug_calls)}")
    # The fused head + CE alone (forward and backward) at the step's shape.
    hidden = torch.randn(GPT2_BATCH, cfg.seq_len, cfg.emb_dim, device=device,
                         dtype=torch.bfloat16, requires_grad=True)
    loss_fn = make_fused_head_loss(cfg)
    ce_ms = cuda_ms(lambda: loss_fn(model.module, hidden, tokens).backward(), iters=3,
                    warmup=1)
    model.module.zero_grad(set_to_none=True)
    print(f"fused head + CE, forward and backward, at {GPT2_BATCH} x {cfg.seq_len}: "
          f"{ce_ms:.3f} ms (four (rows x {cfg.emb_dim}) x ({cfg.emb_dim} x "
          f"{cfg.vocab_size}) products)")
    n_tokens = GPT2_BATCH * cfg.seq_len
    rate = n_tokens * TIMED_STEPS / seconds
    roofline = PEAK_BF16_FLOPS / gpt2_flops_per_token(cfg)
    print(f"GPT-2 base bf16 train, device-only: {rate:.2f} tokens/s "
          f"({seconds / TIMED_STEPS * 1e3:.3f} ms per step of {GPT2_BATCH} x "
          f"{cfg.seq_len} tokens, one microbatch); {rate / roofline:.4f} of the "
          f"{roofline:.0f} tokens/s bf16 roofline; peak memory {peak_gib:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    return model, launches, one_step


def gpt2_cross_check(model, device) -> None:
    """The gradients of GPT2_CHECK_BATCH sequences through the kernels and
    through the plain path (plain attention and its autograd backward), then a
    loss that falls on one fixed batch at constant lr."""
    cfg, module = model.config, model.module
    loss_fn = make_fused_head_loss(cfg)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(GPT2_FIXED_BATCH, cfg.seq_len))).to(device)
    check = tokens[:GPT2_CHECK_BATCH]
    overall, per_block = kernel_and_plain_grads(
        model, lambda plain: loss_fn(module, module(check, return_hidden=True), check))
    print(f"GPT-2 gradients of {GPT2_CHECK_BATCH} sequences, kernel vs plain path: relative "
          f"L2 {overall:.3e}; per block " + " ".join(f"{r:.2e}" for r in per_block))
    if not (math.isfinite(overall) and overall <= GRAD_REL_L2
            and all(r <= GRAD_REL_L2 for r in per_block)):
        raise AssertionError(f"GPT-2 kernel-path gradients disagree with the plain path: "
                             f"{overall}, {per_block}")

    optimizer, scheduler = build_optimizer(GPT2_OPTIMIZER, module)
    state = init_train_state(model, optimizer, scheduler)
    step_fn = make_train_step(grad_clip=GRAD_CLIP, hidden_loss=loss_fn)
    losses = [step_fn(state, (tokens, tokens))["loss"] for _ in range(FIXED_STEPS)]
    losses = [loss.item() for loss in losses]
    print(f"GPT-2 fixed batch of {GPT2_FIXED_BATCH}, {FIXED_STEPS} steps at constant lr "
          f"{GPT2_LR}: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the GPT-2 fixed-batch loss did not fall: {losses}")


FLASH_COUNTERS = (A.fused_mha_packed, A.packed_mha_bwd, A.flash_attention, A.flash_bwd)


def gpt2_fp32_phase(device) -> dict:
    """GPT-2 base at its default compute dtype, float32: at L=1024 its
    attention takes K4 and K5 in float32 (the repaired route). Logits of
    GPT2_CHECK_BATCH sequences and their fused-loss gradients, each against
    the plain path; K4 and K5 carry every layer. Returns the launch counts."""
    model = build_model(GPT2_FP32, device=device)
    cfg, module = model.config, model.module
    loss_fn = make_fused_head_loss(cfg)
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, size=(GPT2_CHECK_BATCH, cfg.seq_len))).to(device)

    def loss(plain=False):
        return loss_fn(module, module(tokens, return_hidden=True), tokens)

    with no_plain_versions() as (plain_calls, aug_calls):
        for counter in FLASH_COUNTERS:
            counter.launches = 0
        with torch.inference_mode():
            logits = model.apply_eval(tokens)
        module.train()
        loss().backward()
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in FLASH_COUNTERS}
    module.zero_grad(set_to_none=True)
    want = {"fused_mha_packed": 0, "packed_mha_bwd": 0, "flash_attention": 2 * cfg.n_layers,
            "flash_bwd": cfg.n_layers}
    print(f"GPT-2 base float32 at {GPT2_CHECK_BATCH} x {cfg.seq_len}, forward then forward and "
          f"backward: launches {launches} (want {want}); plain calls "
          f"{dict(Counter(plain_calls + aug_calls))}")
    if launches != want or plain_calls or aug_calls:
        raise AssertionError("float32 GPT-2 attention did not go through K4 and K5")

    impl = cfg.attn_impl
    cfg.attn_impl = "plain"
    try:
        with torch.inference_mode():
            plain_logits = model.apply_eval(tokens)
    finally:
        cfg.attn_impl = impl
    scale = plain_logits.abs().max().item()
    max_abs = (logits - plain_logits).abs().max().item()
    overall, per_block = kernel_and_plain_grads(model, loss)
    print(f"GPT-2 float32 logits, K4 vs plain path: max|d|={max_abs:.3e} (max|logits| "
          f"{scale:.3f}); gradients relative L2 {overall:.3e}, per block max "
          f"{max(per_block):.3e}")
    if not (logits.shape == (GPT2_CHECK_BATCH, cfg.seq_len, cfg.vocab_size)
            and torch.isfinite(logits).all() and max_abs <= FP32_LOGITS_REL * scale
            and math.isfinite(overall) and overall <= FP32_GRAD_REL_L2
            and max(per_block) <= FP32_GRAD_REL_L2):
        raise AssertionError("float32 GPT-2 through K4/K5 disagrees with the plain path")
    return launches


def llama_flops_per_token(cfg) -> float:
    """Train FLOPs per token, 3x the forward's: ``tools/bench_models.py``'s
    ``llama_flops`` (:124-129: GQA qkv, out, three swiglu products, the
    causal half of attention, the untied head) over seq_len."""
    e, seq = cfg.emb_dim, cfg.seq_len
    per_tok = cfg.n_layers * (e * (e + 2 * cfg.kv_dim) + e * e + 3 * e * cfg.ffn_dim
                              + 2 * (seq // 2) * e) + e * cfg.vocab_size
    return 3 * 2 * per_tok


LLAMA_KINDS = {"K4 flash_fwd (causal)": ("flash_fwd",),
               "K5 flash_bwd (causal)": ("flash_bwd_dq", "flash_bwd_dkv"),
               "cuBLAS GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90_"),
               "optimizer (foreach / AdamW)": ("multi_tensor", "foreach")}


def llama_train_phase(device):
    """``bench_llama(batch=4, size="1b")``'s protocol through the port: K4
    forward and K5 backward in every layer, fused untied head + CE, clip,
    AdamW, cosine schedule. Returns the model, the main path's launch counts
    and a device-only step."""
    t0 = time.perf_counter()
    model = build_model(LLAMA_1B, device=device)
    cfg = model.config
    n_params = sum(p.numel() for p in model.module.parameters())
    print(f"Llama-1B: {n_params:,} parameters, built in {time.perf_counter() - t0:.2f} s")
    schedule = build_scheduler(SCHEDULER, n_steps=TRAIN_STEPS)
    optimizer, scheduler = build_optimizer(GPT2_OPTIMIZER, model.module, schedule=schedule)
    step_fn = make_train_step(schedule=schedule, base_lr=GPT2_LR, grad_clip=GRAD_CLIP,
                              hidden_loss=make_fused_head_loss(cfg))
    state = init_train_state(model, optimizer, scheduler)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(LLAMA_BATCH, cfg.seq_len))).to(device)

    def one_step():
        return step_fn(state, (tokens, tokens))

    history = [(state.step, one_step()) for _ in range(LLAMA_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    with no_plain_versions() as (plain_calls, aug_calls):
        for counter in FLASH_COUNTERS:
            counter.launches = 0
        t0 = time.perf_counter()
        history += [(state.step, one_step()) for _ in range(TIMED_STEPS)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in FLASH_COUNTERS}
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30

    losses = []
    for step, metrics in history:
        loss, norm, lr = metrics["loss"].item(), metrics["grad_norm"].item(), metrics["lr"]
        want_lr = GPT2_LR * step / SCHEDULER["warmup"]  # inside the warmup
        if not (math.isfinite(loss) and math.isfinite(norm) and abs(lr - want_lr) <= 1e-12):
            raise AssertionError(f"Llama step {step}: loss {loss}, grad_norm {norm}, lr {lr} "
                                 f"(want {want_lr})")
        losses.append(loss)
    print(f"Llama-1B train steps {history[0][0]}..{history[-1][0]}: loss "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; grad_norm {history[-1][1]['grad_norm'].item():.4f}, "
          f"lr {history[-1][1]['lr']:.8f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the Llama-1B loss did not fall: {losses}")
    want = cfg.n_layers * TIMED_STEPS
    print(f"Llama-1B train launches over {TIMED_STEPS} steps: {launches} (K4 and K5 want "
          f"{want}, K1 and K3 0); plain calls {dict(Counter(plain_calls + aug_calls))}")
    if launches != {"fused_mha_packed": 0, "packed_mha_bwd": 0, "flash_attention": want,
                    "flash_bwd": want}:
        raise AssertionError("the Llama-1B train path did not go through K4 and K5 every layer")
    if plain_calls or aug_calls:
        raise AssertionError(f"plain versions ran on CUDA: {Counter(plain_calls + aug_calls)}")
    n_tokens = LLAMA_BATCH * cfg.seq_len
    rate = n_tokens * TIMED_STEPS / seconds
    roofline = PEAK_BF16_FLOPS / llama_flops_per_token(cfg)
    print(f"Llama-1B bf16 train, device-only: {rate:.2f} tokens/s "
          f"({seconds / TIMED_STEPS * 1e3:.3f} ms per step of {LLAMA_BATCH} x "
          f"{cfg.seq_len} tokens, one microbatch); {rate / roofline:.4f} of the "
          f"{roofline:.0f} tokens/s bf16 roofline ({llama_flops_per_token(cfg) / 1e9:.3f} "
          f"GFLOP per token); peak memory {peak_gib:.3f} GiB (torch.cuda.max_memory_allocated)")
    return model, launches, one_step


def llama_cross_check(model, device) -> None:
    """The gradients of one sequence through the kernels (K4, K5) and
    through the plain path (the grouped einsum and its autograd backward),
    overall and per block; and the fused head + CE against the unfused CE
    over the untied head's materialised logits at V = 128256."""
    cfg, module = model.config, model.module
    loss_fn = make_fused_head_loss(cfg)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(1, cfg.seq_len))).to(device)
    overall, per_block = kernel_and_plain_grads(
        model, lambda plain: loss_fn(module, module(tokens, return_hidden=True), tokens))
    print(f"Llama-1B gradients of one sequence, kernel vs plain path: relative L2 "
          f"{overall:.3e}; per block " + " ".join(f"{r:.2e}" for r in per_block))
    if not (math.isfinite(overall) and overall <= GRAD_REL_L2
            and all(r <= GRAD_REL_L2 for r in per_block)):
        raise AssertionError(f"Llama-1B kernel-path gradients disagree with the plain path: "
                             f"{overall}, {per_block}")

    with torch.inference_mode():
        hidden = module(tokens, return_hidden=True)
        fused = loss_fn(module, hidden, tokens).item()
        logits = module.output.output_layer["head"](hidden, cfg.cdtype()).float()
        unfused = next_token_cross_entropy(logits, tokens).item()
    print(f"Llama-1B fused head + CE {fused:.6f}, unfused over ({cfg.seq_len} x "
          f"{cfg.vocab_size}) logits {unfused:.6f}")
    if not (math.isfinite(fused) and abs(fused - unfused) <= FUSED_LOSS_ABS):
        raise AssertionError("the fused loss disagrees with the unfused one at V = 128256")


def moe_flops_per_token(cfg) -> float:
    """Train FLOPs per token, 3x the forward's, with the activated FFN
    (``ffn_dim · top_k``) as ``bench_llama`` counts it for MoE
    (``tools/bench_models.py`` :176-179)."""
    e, seq = cfg.emb_dim, cfg.seq_len
    ffn = cfg.ffn_dim * cfg.moe_top_k
    per_tok = cfg.n_layers * (e * (e + 2 * cfg.kv_dim) + e * e + 3 * e * ffn
                              + 2 * (seq // 2) * e) + e * cfg.vocab_size
    return 3 * 2 * per_tok


GROUPED_WRAPPERS = (G.gmm, G.tgmm, GF.gmm_swiglu, GF.gmm_dy_swiglu, GF.gmm_dual, GF.tgmm_swiglu)
# gmm_wgmma_kernel<mode, tile> and tgmm_wgmma_kernel<mode, tile, stages>:
# K8 gmm and tgmm are mode 0, K7 gmm_swiglu and tgmm_swiglu 1,
# gmm_dy_swiglu 2 and gmm_dual 3, so each kind names its kernel (after
# "::", which tgmm's name does not hold before "gmm") and its mode.
MOE_KINDS = {"K8 tgmm": ("::tgmm_wgmma_kernel<0,",),
             "K7 tgmm_swiglu": ("::tgmm_wgmma_kernel<1,",),
             "K8 gmm": ("::gmm_wgmma_kernel<0,",),
             "K7 gmm_swiglu": ("::gmm_wgmma_kernel<1,",),
             "K7 gmm_dy_swiglu": ("::gmm_wgmma_kernel<2,",),
             "K7 gmm_dual": ("::gmm_wgmma_kernel<3,",),
             "K1 packed_mha_fwd (causal)": ("packed_mha_fwd",),
             "K3 packed_mha_bwd (causal)": PACKED_BWD_KERNELS,
             "cuBLAS GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90_"),
             "optimizer (foreach / AdamW)": ("multi_tensor", "foreach")}


@contextlib.contextmanager
def no_moe_plain_versions():
    """Record every call of the plain versions of K1-K5 and K10, of K7 and
    K8, and of the dense MoE oracle."""
    with no_plain_versions() as (calls, aug_calls), \
            counting(G, "gmm_reference", "tgmm_reference") as k8_calls, \
            counting(GF, "gmm_swiglu_reference", "gmm_dy_swiglu_reference",
                     "gmm_dual_reference", "tgmm_swiglu_reference") as k7_calls, \
            counting(M, "apply_moe_ffn") as dense_calls:
        yield calls, aug_calls, k8_calls, k7_calls, dense_calls


def moe_train_phase(device):
    """``bench_llama(batch=8, size="8x124m", implementation="moe")``'s
    protocol through the port: the sparse dispatch with K8 and K7 in every
    layer, K1 causal forward and K3 backward, fused untied head + CE, clip,
    AdamW, cosine schedule. Returns the model, the main path's launch counts
    and a device-only step."""
    t0 = time.perf_counter()
    model = build_model(MOE_8X124M, device=device)
    cfg = model.config
    n_params = sum(p.numel() for p in model.module.parameters())
    print(f"MoE 8x124m: {n_params:,} parameters, built in {time.perf_counter() - t0:.2f} s")
    n_tokens = MOE_BATCH * cfg.seq_len
    impl = M.resolve_moe_impl(cfg, model.module.blocks[0].ffn.params(), n_tokens, device=device)
    print(f"MoE 8x124m at {MOE_BATCH} x {cfg.seq_len} tokens: resolve_moe_impl -> {impl!r}")
    if impl != "sparse":
        raise AssertionError(f"the MoE train step resolved to {impl!r}, not the sparse dispatch")
    schedule = build_scheduler(SCHEDULER, n_steps=TRAIN_STEPS)
    optimizer, scheduler = build_optimizer(GPT2_OPTIMIZER, model.module, schedule=schedule)
    step_fn = make_train_step(schedule=schedule, base_lr=GPT2_LR, grad_clip=GRAD_CLIP,
                              hidden_loss=make_fused_head_loss(cfg))
    state = init_train_state(model, optimizer, scheduler)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(MOE_BATCH, cfg.seq_len))).to(device)

    def one_step():
        return step_fn(state, (tokens, tokens))

    history = [(state.step, one_step()) for _ in range(LLAMA_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    counters = FLASH_COUNTERS + GROUPED_WRAPPERS
    with no_moe_plain_versions() as calls:
        for counter in counters:
            counter.launches = 0
        t0 = time.perf_counter()
        history += [(state.step, one_step()) for _ in range(TIMED_STEPS)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
    plain_calls = Counter(name for group in calls for name in group)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30

    losses = []
    for step, metrics in history:
        loss, norm, lr = metrics["loss"].item(), metrics["grad_norm"].item(), metrics["lr"]
        want_lr = GPT2_LR * step / SCHEDULER["warmup"]  # inside the warmup
        if not (math.isfinite(loss) and math.isfinite(norm) and abs(lr - want_lr) <= 1e-12):
            raise AssertionError(f"MoE step {step}: loss {loss}, grad_norm {norm}, lr {lr} "
                                 f"(want {want_lr})")
        losses.append(loss)
    print(f"MoE 8x124m train steps {history[0][0]}..{history[-1][0]}: loss "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; grad_norm {history[-1][1]['grad_norm'].item():.4f}, "
          f"lr {history[-1][1]['lr']:.8f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the MoE loss did not fall: {losses}")
    per_layer = cfg.n_layers * TIMED_STEPS
    want = {"fused_mha_packed": per_layer, "packed_mha_bwd": per_layer, "flash_attention": 0,
            "flash_bwd": 0, "gmm": per_layer, "tgmm": 2 * per_layer, "gmm_swiglu": per_layer,
            "gmm_dy_swiglu": per_layer, "gmm_dual": per_layer, "tgmm_swiglu": per_layer}
    print(f"MoE 8x124m train launches over {TIMED_STEPS} steps: {launches} (want {want}); "
          f"plain calls {dict(plain_calls)}")
    if launches != want:
        raise AssertionError("the MoE train path did not go through K8, K7, K1 and K3 every "
                             "layer")
    if plain_calls:
        raise AssertionError(f"plain versions ran on CUDA: {plain_calls}")
    rate = n_tokens * TIMED_STEPS / seconds
    roofline = PEAK_BF16_FLOPS / moe_flops_per_token(cfg)
    print(f"MoE 8x124m bf16 train, device-only: {rate:.2f} tokens/s "
          f"({seconds / TIMED_STEPS * 1e3:.3f} ms per step of {MOE_BATCH} x "
          f"{cfg.seq_len} tokens, one microbatch); {rate / roofline:.4f} of the "
          f"{roofline:.0f} tokens/s bf16 roofline ({moe_flops_per_token(cfg) / 1e6:.1f} "
          f"activated MFLOP per token); peak memory {peak_gib:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    return model, launches, one_step


def block_inputs(module, tokens) -> dict:
    """The input of every block's attention and FFN in one forward without
    gradients: ``{"attn": [...], "ffn": [...]}``, one entry per block."""
    inputs = {"attn": [], "ffn": []}
    hooks = [getattr(block, part).register_forward_pre_hook(
        lambda mod, args, part=part: inputs[part].append(args[0]))
        for block in module.blocks for part in inputs]
    try:
        with torch.no_grad():
            module(tokens, return_hidden=True)
    finally:
        for hook in hooks:
            hook.remove()
    return inputs


def per_block_rel_l2(parts, inputs, routes, seed: int) -> list[float]:
    """For each block's ``part`` on its recorded input, under one seeded
    cotangent: the output, the input's gradient and the part's parameter
    gradients through both ``routes`` (callables ``(part, x) -> out``), and
    the largest relative L2 of the first route's against the second's."""
    gen = torch.Generator().manual_seed(seed)
    worst = []
    for part, x in zip(parts, inputs):
        cot = torch.randn(x.shape, generator=gen).to(x.device, x.dtype)
        results = []
        for route in routes:
            xi = x.detach().clone().requires_grad_()
            part.zero_grad(set_to_none=True)
            out = route(part, xi)
            out.backward(cot)
            results.append([out.detach(), xi.grad] + [p.grad for p in part.parameters()])
        part.zero_grad(set_to_none=True)
        worst.append(max(((a.float() - b.float()).norm() / b.float().norm()).item()
                         for a, b in zip(*results)))
    return worst


def moe_cross_check(model, device) -> None:
    """The gradients of one sequence through the kernels (the sparse
    dispatch with K8 and K7, K1 and K3) and through the dense oracle with
    plain attention, overall, and per block with the share of tokens whose
    experts differ between the two; then, per block on the kernel route's
    recorded inputs, the MoE FFN (so at one routing) and the GQA/RoPE
    attention through both routes; then a loss that falls on one fixed batch
    at constant lr."""
    cfg, module = model.config, model.module
    loss_fn = make_fused_head_loss(cfg)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(MOE_FIXED_BATCH, cfg.seq_len))).to(device)
    check = tokens[:1]
    plain = {"attn_impl": "plain", "moe_impl": "dense"}
    # One sequence is 2048 claims, inside the window where "auto" takes the
    # dense oracle (resolve_moe_impl), so the kernel route is asked for.
    launches = G.gmm.launches
    with config_set(cfg, moe_impl="sparse"):
        overall, per_block = kernel_and_plain_grads(
            model, lambda plain: loss_fn(module, module(check, return_hidden=True), check), plain)
        kernel_inputs = block_inputs(module, check)
    if G.gmm.launches != launches + 2 * cfg.n_layers:
        raise AssertionError("the cross-check's kernel route did not launch K8 in every layer")
    with config_set(cfg, **plain):
        plain_inputs = block_inputs(module, check)["ffn"]
    flips = []
    for block, xk, xp in zip(module.blocks, kernel_inputs["ffn"], plain_inputs):
        picks = [M._route(block.ffn.params(), cfg, x.reshape(-1, x.shape[-1]), cfg.moe_top_k,
                          need_probs=False)[2].sort(dim=-1).values for x in (xk, xp)]
        flips.append((picks[0] != picks[1]).any(dim=-1).float().mean().item())
    print(f"MoE 8x124m gradients of one sequence, sparse kernel route vs dense oracle with "
          f"plain attention: relative L2 {overall:.3e}; per block "
          + " ".join(f"{r:.2e}" for r in per_block)
          + "; tokens routed to other experts per block "
          + " ".join(f"{100 * x:.1f}%" for x in flips))
    if not (math.isfinite(overall) and overall <= GRAD_REL_L2):
        raise AssertionError(f"MoE kernel-route gradients disagree with the dense oracle: "
                             f"{overall}, {per_block}")

    # Each block's FFN on the same input through both routes: one routing.
    worst = per_block_rel_l2(
        [block.ffn for block in module.blocks], kernel_inputs["ffn"],
        [lambda ffn, x: M.apply_moe_ffn_sparse(ffn.params(), cfg, x, top_k=cfg.moe_top_k),
         lambda ffn, x: M.apply_moe_ffn(ffn.params(), cfg, x, top_k=cfg.moe_top_k)], seed=10)
    print("MoE 8x124m FFN per block at one routing (output, dx, router, fc1, fc2 gradients), "
          "sparse kernel route vs dense oracle: largest relative L2 "
          + " ".join(f"{r:.2e}" for r in worst))
    if not all(math.isfinite(r) and r <= GRAD_REL_L2 for r in worst):
        raise AssertionError(f"a block's MoE FFN disagrees with the dense oracle: {worst}")

    # Each block's attention on the same input: K1 causal and K3 after the
    # GQA repeat and the packed rotation, against the plain grouped einsum.
    def plain_attention(attn, x):
        with config_set(cfg, attn_impl="plain"):
            return attn(x)

    k1, k3 = A.fused_mha_packed.launches, A.packed_mha_bwd.launches
    worst = per_block_rel_l2([block.attn for block in module.blocks], kernel_inputs["attn"],
                             [lambda attn, x: attn(x), plain_attention], seed=11)
    if (A.fused_mha_packed.launches - k1, A.packed_mha_bwd.launches - k3) != (cfg.n_layers,) * 2:
        raise AssertionError("the attention check's kernel route did not launch K1 and K3 in "
                             "every block")
    print("MoE 8x124m GQA/RoPE attention per block (output, dx, qkv, output gradients), K1 "
          "causal + K3 vs the plain grouped einsum: largest relative L2 "
          + " ".join(f"{r:.2e}" for r in worst))
    if not all(math.isfinite(r) and r <= GRAD_REL_L2 for r in worst):
        raise AssertionError(f"a block's attention disagrees with the plain path: {worst}")

    optimizer, scheduler = build_optimizer(GPT2_OPTIMIZER, module)
    state = init_train_state(model, optimizer, scheduler)
    step_fn = make_train_step(grad_clip=GRAD_CLIP, hidden_loss=loss_fn)
    losses = [step_fn(state, (tokens, tokens))["loss"] for _ in range(FIXED_STEPS)]
    losses = [loss.item() for loss in losses]
    print(f"MoE 8x124m fixed batch of {MOE_FIXED_BATCH}, {FIXED_STEPS} steps at constant lr "
          f"{GPT2_LR}: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the MoE fixed-batch loss did not fall: {losses}")


def left_pad_mask(lengths, l: int, device) -> torch.Tensor:
    """(N, L) bool: row i's last ``lengths[i]`` positions valid."""
    starts = l - torch.as_tensor(np.asarray(lengths), dtype=torch.long)
    return (torch.arange(l)[None, :] >= starts[:, None]).to(device)


def visible_rows(mask, causal: bool) -> torch.Tensor:
    """(N, L) bool: the query rows that see at least one valid key."""
    if causal:
        return mask.cumsum(dim=1) > 0
    return mask.any(dim=1, keepdim=True).expand_as(mask)


def masked_flops(lengths, causal: bool, emb: int = EMB) -> float:
    """The FLOPs this batch needs: two products over each row's valid
    (query, key) pairs only, m(m+1)/2 causal or m² for a row of m valid
    tokens (padded rows and keys need none), over heads of total width
    ``emb``."""
    m = np.asarray(lengths, dtype=np.float64)
    pairs = (m * (m + 1) / 2 if causal else m * m).sum()
    return 2.0 * 2 * pairs * emb


def masked_cases(device, gen, cases, heads: tuple[int, int] = (N_HEADS, EMB)) -> tuple:
    """K1's key-masked mode against its float32 plain version at every
    (N, L, causal, left-pad lengths) of ``cases``, gated on the rows with a
    valid visible key (output and lse), every other row finite; an all-true
    mask bit-equal to unmasked K1; bit-identical over two launches. Returns
    the first case's (qkv, bias, mask) and its max |d|."""
    h, e = heads
    label = "K1 masked" + ("" if e // h == 64 else f" d={e // h}")
    for n_, l_, causal, lens in cases:
        qkv = (torch.randn(n_, l_, 3 * e, generator=gen) * 0.5).to(device, torch.bfloat16)
        bias = (torch.randn(3 * e, generator=gen) * 0.1).to(device, torch.bfloat16)
        mask = left_pad_mask(lens, l_, device)
        with torch.inference_mode():
            out = A.fused_mha_packed(qkv, h, causal=causal, bias=bias, key_mask=mask)
            again = A.fused_mha_packed(qkv, h, causal=causal, bias=bias, key_mask=mask)
            ref = A.packed_mha_reference(qkv.float(), h, causal=causal,
                                         bias=bias.float(), key_mask=mask)
            all_true = A.fused_mha_packed(qkv, h, causal=causal, bias=bias,
                                          key_mask=torch.ones_like(mask))
            unmasked = A.fused_mha_packed(qkv, h, causal=causal, bias=bias)
            _, lse = A._launch_fwd(qkv, bias, h, causal, want_lse=True,
                                   key_mask=mask.contiguous().view(torch.uint8))
            lse_diff = (lse - lse_reference(*split_heads(qkv, bias, h)[:2], causal,
                                            mask)).abs()
        rows = visible_rows(mask, causal)
        diff = (out.float() - ref).abs()[rows]
        max_abs, mean_abs = diff.max().item(), diff.mean().item()
        lse_err = lse_diff.transpose(1, 2)[rows].max().item()
        finite = bool(torch.isfinite(out).all())
        print(f"{label} N={n_} L={l_} causal={causal} lengths {lens.min()}..{lens.max()}: "
              f"max|d|={max_abs:.3e} mean|d|={mean_abs:.3e} lse max|d|={lse_err:.3e} over "
              f"{int(rows.sum())} rows with a valid key; all finite {finite}")
        if not (finite and max_abs <= KERNEL_MAX_ABS and mean_abs <= KERNEL_MEAN_ABS
                and lse_err <= LSE_MAX_ABS):
            raise AssertionError(f"{label} disagrees with its plain version at N={n_} "
                                 f"L={l_} causal={causal}")
        if not torch.equal(out, again):
            raise AssertionError(f"{label} is not bit-identical over two launches")
        if not torch.equal(all_true, unmasked):
            raise AssertionError(f"{label} with an all-true mask differs from unmasked K1")
        if (n_, l_, causal) == cases[0][:3]:
            timed, main_err = (qkv, bias, mask), max_abs
    return timed, main_err


def edge_lengths(l: int) -> np.ndarray:
    """Left-pad lengths of an (8, l) masked case: full, ragged, half, one
    token, empty rows."""
    return np.array([l, max(l - 5, 1), (l + 1) // 2, 1, 0, l, 0, max(l // 3, 1)])


def masked_phase(device, seed: int, iters: int, k1_ms: float) -> dict:
    """K1's key-masked mode against its float32 plain version at the serving
    prefill's shape and at edge lengths (causal and not; left-pad lengths
    with fully masked rows and rows of length 1), as ``masked_cases``
    checks; the wrapper's refusals.
    Timed at the main shape with the plain version, its bound and SDPA with
    a boolean mask (timed only: SDPA gives NaN in fully masked rows); then
    unmasked K1 re-read at the ViT shape."""
    gen = torch.Generator().manual_seed(seed)
    n, l = MASKED_SHAPE
    lengths = np.random.default_rng(0).integers(16, l + 1, size=n)
    lengths[-1] = 1
    cases = [(n, l, True, lengths)] + [(8, e, causal, edge_lengths(e))
                                       for e in MASKED_EDGE_LENGTHS for causal in (True, False)]
    timed, main_err = masked_cases(device, gen, cases)

    qkv, bias, mask = timed
    refusals = {
        "a gradient": lambda: A.fused_mha_packed(qkv.detach().requires_grad_(), N_HEADS,
                                                 causal=True, key_mask=mask),
        "float16": lambda: A.fused_mha_packed(qkv.half(), N_HEADS, causal=True, key_mask=mask),
        "d=32": lambda: A.fused_mha_packed(qkv, 2 * N_HEADS, causal=True, key_mask=mask),
        "a (N, L-1) mask": lambda: A.fused_mha_packed(qkv, N_HEADS, causal=True,
                                                      key_mask=mask[:, 1:]),
    }
    for what, call in refusals.items():
        try:
            call()
        except (NotImplementedError, TypeError, ValueError):
            continue
        raise AssertionError(f"the masked K1 wrapper took {what}")
    print("K1 masked wrapper raises for " + ", ".join(refusals))

    with torch.inference_mode():
        ms, plain_ms, times = in_turns(
            lambda: A.fused_mha_packed(qkv, N_HEADS, causal=True, bias=bias, key_mask=mask),
            lambda: A.packed_mha_reference(qkv, N_HEADS, causal=True, bias=bias,
                                           key_mask=mask), iters)
        out = A.fused_mha_packed(qkv, N_HEADS, causal=True, bias=bias, key_mask=mask)
        q, k, v = split_heads(qkv, bias)
        allowed = torch.ones(l, l, dtype=torch.bool, device=device).tril()[None, None] \
            & mask[:, None, None, :]
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                     attn_mask=allowed), iters)
        vit = (torch.randn(VIT_SHAPE[0], VIT_SHAPE[1], 3 * EMB, generator=gen) * 0.5).to(
            device, torch.bfloat16)
        vit_ms = cuda_ms(lambda: A.fused_mha_packed(vit, N_HEADS, bias=bias), iters)
    flops = masked_flops(lengths, True)
    limit = bound(flops, PEAK_BF16_FLOPS, (qkv, bias, mask, out))
    print(f"K1 masked at N={n} L={l} causal ragged: kernel {times[1]:.4f}/{times[2]:.4f} ms "
          f"({tflops(flops, ms):.1f} TFLOP/s of valid pairs), plain {times[0]:.4f}/"
          f"{times[3]:.4f} ms ({tflops(flops, plain_ms):.1f}), SDPA with a boolean mask "
          f"{library_ms:.4f} ms ({tflops(flops, library_ms):.1f}), bound "
          f"{limit['bound_ms']:.4f} ms ({limit['bound_by']})")
    vit_flops = attention_flops(VIT_SHAPE[0], VIT_SHAPE[1], 2, False)
    print(f"K1 unmasked re-read at N={VIT_SHAPE[0]} L={VIT_SHAPE[1]}: {vit_ms:.4f} ms "
          f"({tflops(vit_flops, vit_ms):.1f} TFLOP/s; the K1 phase read {k1_ms:.4f} ms)")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms, **limit,
            "library_ms": library_ms}


def serve_batch(vocab: int, device):
    """(prompt (N, P), mask (N, P), lengths): the serving batch, each row's
    tokens right-aligned, pads 0."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(32, SERVE_PROMPT + 1, size=SERVE_BATCH)
    tokens = torch.from_numpy(rng.integers(0, vocab, size=(SERVE_BATCH, SERVE_PROMPT)))
    mask = left_pad_mask(lengths, SERVE_PROMPT, device)
    return tokens.to(device) * mask, mask, lengths


@contextlib.contextmanager
def annotated(module, name: str, label: str):
    """``module.<name>`` runs inside ``torch.profiler.record_function(label)``."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


DECODE_KINDS = ("attention over the cache", "sampling", "linears (cuBLAS)",
                "elementwise and other")


def decode_step(module, cfg, prompt, mask, new: int, sampling: dict):
    """(one decode step of the batch after its prefill, as ``generate``
    takes it: all blocks, the head and the sampler, each call at the first
    decode position; the prefill's cache) on ``module``."""
    from torch.profiler import record_function

    p = prompt.shape[1]
    gen = torch.Generator(device=prompt.device).manual_seed(0)
    with torch.inference_mode():
        logits, cache = GEN.prefill(module, cfg, prompt, p + new, mask)
        token = GEN.sample_token(logits, gen, **sampling)
    key_mask = torch.cat([mask, torch.ones((mask.shape[0], new), dtype=torch.bool,
                                           device=mask.device)], dim=1)
    logical = mask.sum(dim=1)

    @torch.inference_mode()
    def step():
        x = GEN._embed_token(module, cfg, token, logical)
        for block, lc in zip(module.blocks, cache):
            x, _ = GEN._block_decode(block, cfg, x, lc, p, key_mask, positions=logical)
        head = GEN._logits(module, cfg, x)
        with record_function("sampling"):
            return GEN.sample_token(head, gen, **sampling)

    return step, cache


def traced_step(step) -> tuple[list, list, float, int]:
    """One call of ``step`` (after one untraced call) under torch.profiler,
    with ``GEN._attend_cached`` in an "attention" range: (the device
    events, its kernels, the host wall ms, the marker kernels dropped)."""
    with torch.inference_mode():
        with annotated(GEN, "_attend_cached", "attention"):
            step()
            torch.cuda.synchronize()
            with device_trace() as prof:
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
    events, dropped = device_events(prof)
    return events, [e for e in events if not e.is_user_annotation], wall_ms, dropped


def busy_and_window_ms(kernels) -> tuple[float, float]:
    """The device's busy ms (the union of the kernels' spans) and the ms
    from the first kernel's start to the last one's end."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -math.inf
    for start, stop in spans:
        if stop > end:
            busy += (stop - max(start, end)) / 1e3
            end = stop
    return busy, (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0


def profile_decode_step(model, prompt, mask, sampling: dict, new: int = SERVE_NEW,
                        name: str = "GPT-2 base") -> float:
    """torch.profiler over one decode step of the serving batch (all blocks,
    the head, the sampler) after its prefill, on ``generate``'s decoding
    copy of the weights: device time by kind (kernels inside the "attention"
    and "sampling" ranges, then cuBLAS by name, the rest) and the device's
    idle share of the step's window, which is returned."""
    cfg = model.config
    module = GEN.decode_module(model.module, cfg)
    step, _ = decode_step(module, cfg, prompt, mask, new, sampling)
    events, kernels, wall_ms, dropped = traced_step(step)
    ranges = {label: [(e.time_range.start, e.time_range.end) for e in events
                      if e.is_user_annotation and e.name == label]
              for label in ("attention", "sampling")}
    totals = dict.fromkeys(DECODE_KINDS, 0.0)
    for e in kernels:
        start = e.time_range.start
        kind = next((k for k, label in zip(DECODE_KINDS, ("attention", "sampling"))
                     if any(a <= start < b for a, b in ranges[label])), None)
        if kind is None:
            kind = DECODE_KINDS[2] if any(key in e.name.lower() for key in (
                "gemm", "nvjet", "cutlass", "xmma", "sm90_")) else DECODE_KINDS[3]
        totals[kind] += e.time_range.elapsed_us() / 1e3
    busy, window = busy_and_window_ms(kernels)
    idle = 1 - busy / max(window, 1e-9)
    print(f"profile of one {name} decode step (batch {prompt.shape[0]}, position "
          f"{prompt.shape[1]}, {sampling}): host wall {wall_ms:.3f} ms, {len(kernels)} kernels, "
          f"device window {window:.3f} ms, busy {busy:.3f} ms, idle {100 * idle:.1f}% of the "
          f"window (device-side ranges found: { {k: len(v) for k, v in ranges.items()} }; "
          f"{dropped} of {TRACE_MARKERS} marker kernels dropped)")
    for kind, ms in totals.items():
        print(f"  {kind}: {ms:.3f} ms")
    return idle


def generate_phase(device):
    """GPT-2 base in bf16 generates for the serving batch through
    ``Model.generate``, in each of SERVE_MODES: a warm-up, then a timed run
    (12 launches of K1's masked mode, no unmasked K1, no plain version);
    prefill timed alone; the rates and peak memory; a profile of one decode
    step. Returns the model, the last run's masked launches and the greedy
    tokens."""
    model = build_model(GPT2_SERVE, device=device)
    cfg = model.config
    prompt, mask, lengths = serve_batch(cfg.vocab_size, device)
    outputs = {}
    for mode, sampling in SERVE_MODES.items():
        def run():
            return model.generate(prompt, SERVE_NEW, prompt_mask=mask, generator=torch.Generator(
                device=device).manual_seed(0), **sampling)

        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        with no_plain_versions() as (plain_calls, aug_calls):
            A.fused_mha_packed.launches = A.fused_mha_packed.masked_launches = 0
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            masked, unmasked = A.fused_mha_packed.masked_launches, A.fused_mha_packed.launches
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
        t0 = time.perf_counter()
        GEN.prefill(model.module, cfg, prompt, SERVE_PROMPT + SERVE_NEW, mask)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        decode_s = seconds - prefill_s
        steps = SERVE_NEW - 1
        print(f"GPT-2 base bf16 generate, {mode} {sampling}, batch {SERVE_BATCH}, prompts "
              f"{lengths.min()}..{lengths.max()} left-padded to {SERVE_PROMPT}, {SERVE_NEW} new: "
              f"{seconds * 1e3:.3f} ms in all; prefill {prefill_s * 1e3:.3f} ms (timed alone); "
              f"decode {decode_s / steps * 1e3:.3f} ms per step, "
              f"{SERVE_BATCH * steps / decode_s:.2f} decode tokens/s; end to end "
              f"{SERVE_BATCH * SERVE_NEW / seconds:.2f} tokens/s; peak memory {peak_gib:.3f} GiB "
              f"(torch.cuda.max_memory_allocated); K1 masked {masked}, unmasked {unmasked}; "
              f"plain calls {dict(Counter(plain_calls + aug_calls))}")
        if masked != cfg.n_layers or unmasked:
            raise AssertionError(f"generate launched K1 masked {masked} and unmasked "
                                 f"{unmasked} times, want {cfg.n_layers} and 0")
        if plain_calls or aug_calls:
            raise AssertionError(f"plain versions ran on CUDA: {Counter(plain_calls)}")
        if not (tuple(out.shape) == (SERVE_BATCH, SERVE_NEW)
                and bool(((out >= 0) & (out < cfg.vocab_size)).all())):
            raise AssertionError(f"generate returned {tuple(out.shape)} or ids out of range")
        outputs[mode] = out
        profile_decode_step(model, prompt, mask, sampling)
    return model, masked, outputs["greedy"]


def sampler_check(device) -> None:
    """The top-k sampler's candidates at the decode step's (256, V) logits:
    ``_top_k``'s order on CUDA (descending, ties to the lower index, as
    ``lax.top_k``) against its order on the CPU, on logits with many ties;
    its time beside ``torch.topk``'s on smooth logits."""
    k = SERVE_MODES["topk"]["top_k"]
    gen = torch.Generator(device=device).manual_seed(0)
    ties = torch.randint(0, 64, (SERVE_BATCH, 50_257), generator=gen, device=device).float()
    got = GEN._top_k(ties, k)
    want = GEN._top_k(ties.cpu(), k)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
        raise AssertionError("_top_k's order on CUDA differs from the CPU's")
    smooth = torch.randn(SERVE_BATCH, 50_257, generator=gen, device=device)
    ms = cuda_ms(lambda: GEN._top_k(smooth, k))
    topk_ms = cuda_ms(lambda: torch.topk(smooth, k, dim=-1))
    sample_ms = cuda_ms(lambda: GEN.sample_token(smooth, gen, **SERVE_MODES["topk"]))
    print(f"top-k sampler at {tuple(smooth.shape)}, k={k}: order on CUDA equals the CPU's "
          f"(ties); _top_k (stable sort) {ms:.4f} ms, torch.topk {topk_ms:.4f} ms, "
          f"sample_token {SERVE_MODES['topk']} {sample_ms:.4f} ms")


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def serve_cross_check(model, greedy, device, batch=None, new: int = SERVE_NEW,
                      name: str = "GPT-2 base") -> None:
    """The serving path's kernel route against its plain route (plain
    attention in the prefill): the last prefill logits of the ragged batch
    (``batch``, (prompt, mask, lengths); GPT-2's ``serve_batch`` by
    default); 4 of its rows against the same prompts prefilled alone and
    unpadded; one teacher-forced decode step's logits; then each of these
    limits with K1's mask dropped, which must fail it. The agreement of the
    ``greedy`` tokens (``new`` of them) with the plain route's is printed,
    not gated: at random weights an argmax flips where two logits are
    within a bf16 rounding (GPT-2's tied head echoes its input)."""
    cfg, module = model.config, model.module
    prompt, mask, lengths = serve_batch(cfg.vocab_size, device) if batch is None else batch
    n, p = prompt.shape
    key_mask = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=1)
    logical = mask.sum(dim=1)

    def prefill():
        return GEN.prefill(module, cfg, prompt, p + 1, mask)

    def step_logits(cache, token):
        x = GEN._embed_token(module, cfg, token, logical)
        for block, lc in zip(module.blocks, cache):
            x, _ = GEN._block_decode(block, cfg, x, lc, p, key_mask, positions=logical)
        return GEN._logits(module, cfg, x)

    real = A.fused_mha_packed

    def mask_dropped(*args, key_mask=None, **kwargs):
        return real(*args, **kwargs)

    with torch.inference_mode():
        kernel_logits, kernel_cache = prefill()
        with config_set(cfg, attn_impl="plain"):
            plain_logits, plain_cache = prefill()
        alone = torch.cat([GEN.prefill(module, cfg, prompt[i:i + 1, p - m:], m)[0]
                           for i, m in enumerate(lengths[:4])])
        token = kernel_logits.argmax(dim=-1)
        plain_step = step_logits(plain_cache, token)
        kernel_step = step_logits(kernel_cache, token)
        GEN.fused_mha_packed = mask_dropped
        try:
            faulty_logits, faulty_cache = prefill()
        finally:
            GEN.fused_mha_packed = real
        faulty_step = step_logits(faulty_cache, token)
        del kernel_cache, plain_cache, faulty_cache
        with config_set(cfg, attn_impl="plain"):
            plain_greedy = model.generate(prompt, new, temperature=0.0, prompt_mask=mask)
    checks = {"prefill logits, kernel vs plain": rel_l2(kernel_logits, plain_logits),
              "4 ragged rows vs alone unpadded": rel_l2(kernel_logits[:4], alone),
              "decode step logits, kernel vs plain": rel_l2(kernel_step, plain_step)}
    agree = (greedy == plain_greedy).float().mean().item()
    print(f"{name} serving cross-check (relative L2): " + ", ".join(
        f"{k} {v:.3e}" for k, v in checks.items()) + f"; greedy tokens equal on "
        f"{100 * agree:.2f}% of {n} x {new} (kernel vs plain route, not gated: at random "
        f"weights an argmax flips where two logits lie within a bf16 rounding)")
    if not all(math.isfinite(v) and v <= SERVE_REL_L2 for v in checks.values()):
        raise AssertionError(f"the serving kernel route disagrees with the plain one: {checks}")
    planted({"prefill logits, K1's mask dropped": rel_l2(faulty_logits, plain_logits),
             "4 ragged rows vs alone unpadded, K1's mask dropped": rel_l2(faulty_logits[:4],
                                                                          alone),
             "decode step logits, K1's mask dropped in the prefill": rel_l2(faulty_step,
                                                                            plain_step)})


def planted(readings: dict) -> None:
    """Each reading is a cross-check's relative L2 with a fault planted: it
    must exceed SERVE_REL_L2, or the check could not see that fault."""
    print("planted faults (relative L2, must exceed " + f"{SERVE_REL_L2:g}): " + ", ".join(
        f"{k} {v:.3e}" for k, v in readings.items()))
    if not all(v > SERVE_REL_L2 for v in readings.values()):
        raise AssertionError(f"a planted fault passed its serving check: {readings}")


def server_cross_check(model, device, reqs=None, server: dict = SERVER,
                       name: str = "GPT-2 base") -> None:
    """The server's logits against ``generate()``'s, bf16 on the kernel
    route: the first 4 of the server's requests admitted into 4 slots of a
    ``DecodeServer`` (right-padded to a bucket, unmasked K1) against each
    prompt prefilled alone at its own length; then one window tick of the 4
    slots, each at its own position, teacher-forced with each prompt's
    greedy token, against that prompt's first decode step after its own
    prefill. Then each limit with a fault planted. ``reqs`` (default the
    GPT-2 mix's first 4) and ``server`` set the requests and the server;
    every call runs on the server's own decoding weights."""
    cfg = model.config
    reqs = server_requests(cfg.vocab_size)[:4] if reqs is None else reqs
    srv = SRV.DecodeServer(model.module, cfg, **{**server, "n_slots": len(reqs)})
    module = srv.module
    prompts = [torch.tensor(r.prompt, device=device) for r in reqs]
    with torch.inference_mode():
        alone, steps = [], []
        for p in prompts:
            logits, cache = GEN.prefill(module, cfg, p[None], len(p) + 1)
            x = GEN._embed_token(module, cfg, logits.argmax(dim=-1), torch.tensor([len(p)],
                                                                                device=device))
            for block, lc in zip(module.blocks, cache):
                x, _ = GEN._block_decode(block, cfg, x, lc, len(p))
            alone.append(logits[0])
            steps.append(GEN._logits(module, cfg, x)[0])
        alone, steps = torch.stack(alone), torch.stack(steps)
        admitted, wrong_token = [], []
        for slot, r in enumerate(reqs):
            padded, length = srv._bucketed(r.prompt)
            admitted.append(SRV._admit(module, cfg, srv.cache, srv.pos, slot, padded, length))
            wrong_token.append(SRV._admit(module, cfg, [{k: v.clone() for k, v in lc.items()}
                                                        for lc in srv.cache],
                                          srv.pos.clone(), slot, padded, length - 1))
        token, pos = alone.argmax(dim=-1), srv.pos.clone()

        def tick(cache, pos):
            return SRV._tick_logits(module, cfg, [{k: v.clone() for k, v in lc.items()}
                                                  for lc in cache], token, pos)

        window = tick(srv.cache, pos)
        off_by_one = tick(srv.cache, pos + 1)
        rows = [{k: v.roll(1, dims=0) for k, v in lc.items()} for lc in srv.cache]
        other_rows = tick(rows, pos)
    checks = {"4 admissions vs prefill alone": rel_l2(torch.stack(admitted), alone),
              "window tick vs first decode step": rel_l2(window, steps)}
    print(f"{name} server cross-check, prompts {[len(p) for p in prompts]} (relative L2): " +
          ", ".join(f"{k} {v:.3e}" for k, v in checks.items()))
    if not all(math.isfinite(v) and v <= SERVE_REL_L2 for v in checks.values()):
        raise AssertionError(f"the server's logits disagree with generate()'s: {checks}")
    planted({"admission reading the token before the last": rel_l2(torch.stack(wrong_token),
                                                                   alone),
             "window tick, slot positions off by one": rel_l2(off_by_one, steps),
             "window tick, each slot reading another slot's cache": rel_l2(other_rows, steps)})


def server_requests(vocab: int) -> list:
    """``tools/profile_server.py``'s ``make_requests(seed=0)`` at 256 requests."""
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(SERVER_REQUESTS):
        plen = int(rng.integers(16, 121))
        mnew = int(rng.integers(16, 97))
        reqs.append(SRV.Request(prompt=rng.integers(0, vocab, size=(plen,)).tolist(),
                                max_new_tokens=mnew))
    return reqs


def server_phase(model, device) -> None:
    """The continuous-batching server over tools/profile_server.py's mix
    (greedy, no EOS, so every request gets its max_new_tokens), after a
    warm-up on 8 requests: requests/s, tokens/s, ticks and K1 launches (12
    per admission, unmasked); then the same requests in waves of n_slots
    through the serve app's ragged ``generate()`` (12 masked K1 launches per
    wave)."""
    cfg, module = model.config, model.module
    srv = SRV.DecodeServer(module, cfg, **SERVER)
    srv.serve(server_requests(cfg.vocab_size)[:8])
    srv.reset()
    torch.cuda.synchronize()
    reqs = server_requests(cfg.vocab_size)
    useful = sum(r.max_new_tokens for r in reqs)
    with no_plain_versions() as (plain_calls, _):
        A.fused_mha_packed.launches = A.fused_mha_packed.masked_launches = 0
        t0 = time.perf_counter()
        srv.serve(reqs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (A.fused_mha_packed.launches, A.fused_mha_packed.masked_launches)
    print(f"DecodeServer greedy {SERVER}, {len(reqs)} requests ({useful} tokens): "
          f"{seconds:.3f} s, {len(reqs) / seconds:.2f} requests/s, {useful / seconds:.2f} "
          f"tokens/s, {srv.steps} ticks ({useful / (srv.steps * SERVER['n_slots']):.3f} of "
          f"the slot-ticks useful); K1 unmasked {launches[0]}, masked {launches[1]}")
    if launches != (cfg.n_layers * len(reqs), 0) or plain_calls:
        raise AssertionError(f"the server's admissions launched K1 {launches}, plain calls "
                             f"{Counter(plain_calls)}")
    if not all(r.done and len(r.tokens) == r.max_new_tokens for r in reqs):
        raise AssertionError("a request did not get its max_new_tokens from the server")

    waves = server_requests(cfg.vocab_size)
    n_waves = -(-len(waves) // SERVER["n_slots"])
    with no_plain_versions() as (plain_calls, _):
        A.fused_mha_packed.launches = A.fused_mha_packed.masked_launches = 0
        t0 = time.perf_counter()
        SERVE_APP._serve_waves(model, waves, SERVER["n_slots"], 0.0, None, None, None, 0,
                               device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        masked = A.fused_mha_packed.masked_launches
    agree = np.mean([a.tokens == b.tokens for a, b in zip(reqs, waves)])
    print(f"wave mode, {n_waves} waves of {SERVER['n_slots']} through generate(): "
          f"{seconds:.3f} s, {len(waves) / seconds:.2f} requests/s, {useful / seconds:.2f} "
          f"tokens/s; K1 masked {masked} ({masked / n_waves:.1f} per wave); requests whose "
          f"tokens equal the server's: {100 * agree:.1f}% (not gated: at random weights the "
          f"tied head echoes its input, so agreement tells nothing)")
    if masked != cfg.n_layers * n_waves or plain_calls:
        raise AssertionError(f"wave mode launched K1 masked {masked} times, want "
                             f"{cfg.n_layers * n_waves}")
    if not all(r.done and len(r.tokens) == r.max_new_tokens for r in waves):
        raise AssertionError("a request did not get its max_new_tokens in wave mode")


def apps_phase(device) -> None:
    """The two serving entry points as a user runs them on the card."""
    new_ids = SAMPLE_APP.run(token_ids=[464, 3280, 318], max_new_tokens=16, device=device)
    reqs = SERVE_APP.run(demo=16, n_slots=4, device=device)
    if not (0 < len(new_ids) <= 16 and len(reqs) == 16 and all(r.done for r in reqs)):
        raise AssertionError(f"the gpt2 apps returned {new_ids} and {len(reqs)} requests")
    print(f"apps: sample.run gave {len(new_ids)} tokens; serve.run --demo 16 --n_slots 4 "
          f"served {len(reqs)} requests, {sum(len(r.tokens) for r in reqs)} tokens")


# ---------------------------------------------------------------------------
# Llama-3.1-8B serving: K1 at d = 128, generate, the server, int8 weights
# ---------------------------------------------------------------------------


def l8b_prompts(vocab: int, device):
    """(prompt (N, P), mask (N, P), lengths): the 8B generate batch, each
    row's tokens right-aligned, pads 0."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(64, L8B_PROMPT + 1, size=L8B_BATCH)
    tokens = torch.from_numpy(rng.integers(0, vocab, size=(L8B_BATCH, L8B_PROMPT)))
    mask = left_pad_mask(lengths, L8B_PROMPT, device)
    return tokens.to(device) * mask, mask, lengths


def k1_d128_phase(device, seed: int, iters: int) -> dict:
    """K1 at head width 128 (32 heads over E = 4096, Llama-3.1-8B's
    attention) in its four modes against the float32 plain version under the
    bf16 gates, lse within 1e-3 and bit-identical over two launches: causal
    at an admission (timed) and at L8B_K1_LENGTHS, non-causal at the
    generate shape and those lengths (no path runs it: checked all the
    same), key-masked causal at the generate prefill's batch (timed with its
    plain version, its bound and SDPA with a boolean mask) and both masked
    modes at those lengths; then the wrappers' refusals (a gradient at
    d = 128, d = 96). Returns the rows of packed_mha_fwd:d128 and
    packed_mha_fwd:masked:d128."""
    h, e = L8B_HEADS
    edges = [(8, l) for l in L8B_K1_LENGTHS]
    timing = {"packed_mha_fwd:d128": fwd_phase(device, [L8B_ADMISSION] + edges, True,
                                               seed=seed, iters=iters, heads=L8B_HEADS)}
    fwd_phase(device, [(L8B_BATCH, L8B_PROMPT)] + edges, False, seed=seed + 1, iters=iters,
              heads=L8B_HEADS)
    gen = torch.Generator().manual_seed(seed + 2)
    lengths = np.random.default_rng(0).integers(64, L8B_PROMPT + 1, size=L8B_BATCH)
    cases = [(L8B_BATCH, L8B_PROMPT, True, lengths)] + [
        (8, l, causal, edge_lengths(l)) for l in L8B_K1_LENGTHS for causal in (True, False)]
    (qkv, bias, mask), main_err = masked_cases(device, gen, cases, heads=L8B_HEADS)

    launches = (A.fused_mha_packed.launches, A.fused_mha_packed.masked_launches)
    wide = torch.zeros(1, 16, 3 * 3072, dtype=torch.bfloat16, device=device)
    refusals = {
        "a gradient at d=128": lambda: A.fused_mha_packed(
            qkv[:1].detach().requires_grad_(), h, causal=True),
        "a gradient at d=128, masked": lambda: A.fused_mha_packed(
            qkv[:1].detach().requires_grad_(), h, causal=True, key_mask=mask[:1]),
        "d=96": lambda: A.fused_mha_packed(wide, 32, causal=True),
        "the backward at d=128": lambda: A.packed_mha_bwd(
            qkv[:1], bias, qkv[:1, :, :e], qkv[:1, :, :e],
            torch.zeros(1, h, L8B_PROMPT, device=device), h, causal=True),
    }
    for what, call in refusals.items():
        try:
            call()
        except NotImplementedError:
            continue
        raise AssertionError(f"the K1 wrapper took {what}")
    if (A.fused_mha_packed.launches, A.fused_mha_packed.masked_launches) != launches:
        raise AssertionError("a refused call launched K1")
    print("K1 d=128 wrappers raise NotImplementedError for " + ", ".join(refusals))

    n, l = L8B_BATCH, L8B_PROMPT
    with torch.inference_mode():
        ms, plain_ms, times = in_turns(
            lambda: A.fused_mha_packed(qkv, h, causal=True, bias=bias, key_mask=mask),
            lambda: A.packed_mha_reference(qkv, h, causal=True, bias=bias, key_mask=mask),
            iters)
        out = A.fused_mha_packed(qkv, h, causal=True, bias=bias, key_mask=mask)
        q, k, v = split_heads(qkv, bias, h)
        allowed = torch.ones(l, l, dtype=torch.bool, device=device).tril()[None, None] \
            & mask[:, None, None, :]
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                     attn_mask=allowed), iters)
    flops = masked_flops(lengths, True, e)
    limit = bound(flops, PEAK_BF16_FLOPS, (qkv, bias, mask, out))
    print(f"K1 masked d=128 at N={n} L={l} causal ragged (the 8B generate prefill): kernel "
          f"{times[1]:.4f}/{times[2]:.4f} ms ({tflops(flops, ms):.1f} TFLOP/s of valid pairs), "
          f"plain {times[0]:.4f}/{times[3]:.4f} ms, SDPA with a boolean mask {library_ms:.4f} ms "
          f"({tflops(flops, library_ms):.1f}), bound {limit['bound_ms']:.4f} ms "
          f"({limit['bound_by']})")
    timing["packed_mha_fwd:masked:d128"] = {"max_abs_err": main_err, "ms": ms,
                                            "plain_ms": plain_ms, **limit,
                                            "library_ms": library_ms}
    return timing


def build_8b(device):
    """The 8B preset on the card: its parameters drawn on the host's CPU one
    tensor at a time and moved; the seconds, the count and the card's
    memory printed."""
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = build_model(LLAMA_8B, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.module.parameters())
    print(f"Llama-3.1-8B: {n_params:,} parameters (float32, "
          f"{Q.quantized_nbytes(model.module) / 2**30:.3f} GiB), {model.config.n_layers} blocks, "
          f"E={model.config.emb_dim}, {model.config.n_heads} heads of {model.config.head_dim}, "
          f"{model.config.n_kv_heads} KV heads; drawn on the host and moved in {seconds:.2f} s; "
          f"peak {torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB")
    return model


def l8b_generate_phase(model, device, card_line: str, peaks: list):
    """Llama-3.1-8B generates for the 8B batch through ``Model.generate``,
    greedy and top-k 40 at T 0.8: a warm-up, then a timed run (32 launches
    of K1's masked mode at d = 128, none unmasked, no plain version), the
    prefill timed alone, decode ms per step, tokens/s and the peak memory;
    one decode step timed on the float32 weights (each linear casting its
    weight) and on ``generate``'s bf16 copy; a profile of one decode step
    (the idle share). Before each reset of the card's peak memory its value
    is appended to ``peaks``. Returns the greedy tokens, the last run's
    masked launches and the rates."""
    cfg = model.config
    prompt, mask, lengths = l8b_prompts(cfg.vocab_size, device)
    t0 = time.perf_counter()
    copy_module = GEN.decode_module(model.module, cfg)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    matrices = Q.decode_matrices(copy_module.state_dict())
    copy_gib = sum(copy_module.get_parameter(n).numel() * 2 for n in matrices) / 2**30
    readings = {}
    for label, module in (("float32 weights", model.module), ("bf16 copy", copy_module)):
        step, cache = decode_step(module, cfg, prompt, mask, L8B_NEW, SERVE_MODES["greedy"])
        _, kernels, wall_ms, _ = traced_step(step)
        readings[label] = (busy_and_window_ms(kernels)[0], wall_ms, len(kernels))
        del step, cache
    del copy_module
    print(f"Llama-3.1-8B decode step at batch {L8B_BATCH} ({card_line}), device busy ms "
          f"(torch.profiler) / host wall ms / kernels: on the float32 weights (each linear "
          f"casts its weight to bf16 at every call) "
          f"{' / '.join(f'{x:.3f}' for x in readings['float32 weights'][:2])} / "
          f"{readings['float32 weights'][2]}, on generate()'s bf16 copy of the {len(matrices)} "
          f"weight matrices ({copy_gib:.3f} GiB, cast in {copy_s * 1e3:.1f} ms) "
          f"{' / '.join(f'{x:.3f}' for x in readings['bf16 copy'][:2])} / "
          f"{readings['bf16 copy'][2]}")

    outputs, rates = {}, {}
    for mode, sampling in SERVE_MODES.items():
        def run():
            return model.generate(prompt, L8B_NEW, prompt_mask=mask, generator=torch.Generator(
                device=device).manual_seed(0), **sampling)

        run()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated(device))
        torch.cuda.reset_peak_memory_stats(device)
        with no_plain_versions() as (plain_calls, aug_calls):
            A.fused_mha_packed.launches = A.fused_mha_packed.masked_launches = 0
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            masked, unmasked = A.fused_mha_packed.masked_launches, A.fused_mha_packed.launches
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
        t0 = time.perf_counter()
        GEN.prefill(model.module, cfg, prompt, L8B_PROMPT + L8B_NEW, mask)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        steps = L8B_NEW - 1
        decode_s = seconds - prefill_s
        rates[mode] = {"prefill_ms": prefill_s * 1e3, "step_ms": decode_s / steps * 1e3,
                       "tokens_s": L8B_BATCH * L8B_NEW / seconds}
        print(f"Llama-3.1-8B bf16 generate ({card_line}), {mode} {sampling}, batch {L8B_BATCH}, "
              f"prompts {lengths.min()}..{lengths.max()} left-padded to {L8B_PROMPT}, {L8B_NEW} "
              f"new: {seconds * 1e3:.3f} ms in all; prefill {prefill_s * 1e3:.3f} ms (timed "
              f"alone, {L8B_BATCH * L8B_PROMPT / prefill_s:.1f} prompt tokens/s); decode "
              f"{decode_s / steps * 1e3:.3f} ms per step, {L8B_BATCH * steps / decode_s:.2f} "
              f"decode tokens/s; end to end {L8B_BATCH * L8B_NEW / seconds:.2f} tokens/s; peak "
              f"memory {peak_gib:.3f} GiB; K1 masked {masked}, unmasked {unmasked}; plain calls "
              f"{dict(Counter(plain_calls + aug_calls))}")
        if masked != cfg.n_layers or unmasked:
            raise AssertionError(f"generate launched K1 masked {masked} and unmasked "
                                 f"{unmasked} times, want {cfg.n_layers} and 0")
        if plain_calls or aug_calls:
            raise AssertionError(f"plain versions ran on CUDA: {Counter(plain_calls)}")
        if not (tuple(out.shape) == (L8B_BATCH, L8B_NEW)
                and bool(((out >= 0) & (out < cfg.vocab_size)).all())):
            raise AssertionError(f"generate returned {tuple(out.shape)} or ids out of range")
        outputs[mode] = out
    rates["idle"] = profile_decode_step(model, prompt, mask, SERVE_MODES["greedy"], L8B_NEW,
                                        name="Llama-3.1-8B")
    return outputs["greedy"], masked, rates


def l8b_requests(vocab: int) -> list:
    """The 8B server's mix: L8B_REQUESTS requests, prompts of 32-480 tokens
    and 16-128 new tokens, from default_rng(0)."""
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(L8B_REQUESTS):
        plen, mnew = int(rng.integers(32, 481)), int(rng.integers(16, 129))
        reqs.append(SRV.Request(prompt=rng.integers(0, vocab, size=(plen,)).tolist(),
                                max_new_tokens=mnew))
    return reqs


def l8b_server_phase(module, cfg, device, label: str) -> tuple[int, dict]:
    """``DecodeServer`` (L8B_SERVER) serves the 8B mix greedily (no EOS, so
    every request gets its max_new_tokens) after a warm-up on 2 requests:
    32 unmasked K1 launches per admission, none masked, no plain version;
    requests/s, tokens/s, ticks. Returns the K1 launches and the rates."""
    srv = SRV.DecodeServer(module, cfg, **L8B_SERVER)
    srv.serve([SRV.Request(prompt=r.prompt, max_new_tokens=4)
               for r in l8b_requests(cfg.vocab_size)[:2]])
    srv.reset()
    torch.cuda.synchronize()
    reqs = l8b_requests(cfg.vocab_size)
    useful = sum(r.max_new_tokens for r in reqs)
    with no_plain_versions() as (plain_calls, _):
        A.fused_mha_packed.launches = A.fused_mha_packed.masked_launches = 0
        t0 = time.perf_counter()
        srv.serve(reqs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (A.fused_mha_packed.launches, A.fused_mha_packed.masked_launches)
    print(f"Llama-3.1-8B {label} DecodeServer greedy {L8B_SERVER}, {len(reqs)} requests "
          f"({useful} tokens): {seconds:.3f} s, {len(reqs) / seconds:.3f} requests/s, "
          f"{useful / seconds:.2f} tokens/s, {srv.steps} ticks "
          f"({useful / (srv.steps * L8B_SERVER['n_slots']):.3f} of the slot-ticks useful); "
          f"K1 unmasked {launches[0]} ({launches[0] / len(reqs):.1f} per admission), masked "
          f"{launches[1]}")
    if launches != (cfg.n_layers * len(reqs), 0) or plain_calls:
        raise AssertionError(f"the server's admissions launched K1 {launches}, plain calls "
                             f"{Counter(plain_calls)}")
    if not all(r.done and len(r.tokens) == r.max_new_tokens for r in reqs):
        raise AssertionError("a request did not get its max_new_tokens from the server")
    return launches[0], {"requests_s": len(reqs) / seconds, "tokens_s": useful / seconds}


def l8b_int8_phase(model, device, card_line: str, bf16_rates: dict) -> None:
    """int8 weights for the 8B model: ``quantize_decode_params`` on the card
    bit-equal to the same function on the host copy of block 0's weights;
    ``Model.quantize_int8`` (timed; ``quantized_nbytes``); the int8 model's
    prefill logits against a bf16 model holding the dequantized weights
    (relative L2 within SERVE_REL_L2, max |d| printed); greedy generate on
    int8 weights (32 masked K1 launches, no plain version; decode ms per
    step and tokens/s beside bf16's); the server on int8 weights."""
    cfg = model.config
    block = {name: t for name, t in model.module.state_dict().items()
             if name.startswith("blocks.0.")}
    on_card = Q.quantize_decode_params(block)
    on_host = Q.quantize_decode_params({k: v.cpu() for k, v in block.items()})
    unequal = [k for k in on_card if not torch.equal(on_card[k].cpu(), on_host[k])]
    n_int8 = sum(t.dtype == torch.int8 for t in on_card.values())
    print(f"quantize_decode_params of block 0 ({n_int8} int8 tables and their scales): card "
          f"and host bit-equal: {not unequal}")
    if unequal or n_int8 != 4:
        raise AssertionError(f"quantize_decode_params differs between card and host: {unequal}")
    del block, on_card, on_host

    t0 = time.perf_counter()
    qmodule = model.quantize_int8()
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    state = qmodule.state_dict()
    matrices = Q.decode_matrices(state)
    deq = Q.module_with(model.module, {
        name: Q.dequantize_weight({"weight": state[name],
                                   "scale": state[name[:-len("weight")] + "scale"]},
                                  torch.bfloat16, channel_axis=axes)
        for name, axes in matrices.items()})
    bf16_bytes = sum(deq.get_parameter(n).numel() * 2 for n in matrices)
    int8_bytes = Q.quantized_nbytes(qmodule)
    prompt, mask, _ = l8b_prompts(cfg.vocab_size, device)
    with torch.inference_mode():
        int8_logits, _ = GEN.prefill(qmodule, cfg, prompt, L8B_PROMPT + 1, mask)
        deq_logits, _ = GEN.prefill(deq, cfg, prompt, L8B_PROMPT + 1, mask)
    del deq
    rel, max_abs = rel_l2(int8_logits, deq_logits), (int8_logits - deq_logits).abs().max().item()
    print(f"Llama-3.1-8B int8 ({card_line}): quantize_int8 {quantize_s:.3f} s; weights "
          f"{int8_bytes / 2**30:.3f} GiB (quantized_nbytes: int8 matrices, float32 scales and "
          f"norms) against {bf16_bytes / 2**30:.3f} GiB of bf16 matrices; prefill logits vs "
          f"the dequantized bf16 model: relative L2 {rel:.3e}, max|d| {max_abs:.3e} (logits "
          f"up to {deq_logits.abs().max().item():.3f})")
    if not (math.isfinite(rel) and rel <= SERVE_REL_L2):
        raise AssertionError(f"int8 prefill logits disagree with the dequantized model: {rel}")

    def run():
        return GEN.generate(qmodule, cfg, prompt, L8B_NEW, temperature=0.0, prompt_mask=mask)

    run()
    torch.cuda.synchronize()
    with no_plain_versions() as (plain_calls, _):
        A.fused_mha_packed.launches = A.fused_mha_packed.masked_launches = 0
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        masked = A.fused_mha_packed.masked_launches
    t0 = time.perf_counter()
    GEN.prefill(qmodule, cfg, prompt, L8B_PROMPT + L8B_NEW, mask)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    steps = L8B_NEW - 1
    step_ms = (seconds - prefill_s) / steps * 1e3
    bf16 = bf16_rates["greedy"]
    print(f"Llama-3.1-8B int8 greedy generate ({card_line}), batch {L8B_BATCH}: prefill "
          f"{prefill_s * 1e3:.3f} ms (bf16 {bf16['prefill_ms']:.3f}), decode {step_ms:.3f} ms "
          f"per step (bf16 {bf16['step_ms']:.3f}), end to end {L8B_BATCH * L8B_NEW / seconds:.2f} "
          f"tokens/s (bf16 {bf16['tokens_s']:.2f}); K1 masked {masked}")
    if masked != cfg.n_layers or plain_calls:
        raise AssertionError(f"int8 generate launched K1 masked {masked} times, plain calls "
                             f"{Counter(plain_calls)}")
    if not (tuple(out.shape) == (L8B_BATCH, L8B_NEW)
            and bool(((out >= 0) & (out < cfg.vocab_size)).all())):
        raise AssertionError(f"int8 generate returned {tuple(out.shape)} or ids out of range")
    l8b_server_phase(qmodule, cfg, device, "int8")


def l8b_serve_command():
    """The serve command line with int8 weights as a user runs it, in a
    process of its own, started now: it draws its own 8B parameters on the
    host while this process draws the same preset's (two single-threaded
    draws on a host of 8 cores), so the two draws overlap. Returns the
    process and its start time for ``l8b_serve_result``."""
    return subprocess.Popen([sys.executable, "-m", "vitef_tpu_torch.apps.gpt2.serve",
                             *L8B_SERVE_ARGV], cwd=REPO_ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), time.perf_counter()


def l8b_serve_result(started, card_line: str) -> None:
    """Wait for the serve command line: exit 0, one result line per
    request; its seconds (the draw included) and log lines printed."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    seconds = time.perf_counter() - t0
    lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    tail = [line for line in err.splitlines() if "served" in line or "mode" in line]
    print(f"python -m vitef_tpu_torch.apps.gpt2.serve {' '.join(L8B_SERVE_ARGV)} "
          f"({card_line}): exit {proc.returncode} in {seconds:.2f} s (its 8.03 B parameters "
          f"drawn on the host included, beside this process's draw), {len(lines)} results; "
          f"{' | '.join(tail)}")
    if proc.returncode != 0 or len(lines) != 16 or not all(line["tokens"] for line in lines):
        raise AssertionError(f"the 8b serve command line failed:\n{err[-4000:]}")


def l8b_phase(device, card_line: str) -> dict:
    """The Llama-3.1-8B serving path: the serve command line with int8
    weights in its own process beside this process's build of the preset,
    waited for before anything here is timed; then generate (bf16), its
    cross-check, the server and its cross-check, int8 weights. Returns the
    launches of K1 d = 128 by mode."""
    command = l8b_serve_command()
    model = build_8b(device)
    free, total = torch.cuda.mem_get_info(device)
    print(f"the card after both processes' 8B builds: {(total - free) / 2**30:.3f} of "
          f"{total / 2**30:.3f} GiB in use (torch.cuda.mem_get_info)")
    l8b_serve_result(command, card_line)
    peaks = []
    greedy, masked, rates = l8b_generate_phase(model, device, card_line, peaks)
    serve_cross_check(model, greedy, device, batch=l8b_prompts(model.config.vocab_size, device),
                      new=L8B_NEW, name="Llama-3.1-8B")
    del greedy
    server_cross_check(model, device, reqs=l8b_requests(model.config.vocab_size)[:4],
                       server=L8B_SERVER, name="Llama-3.1-8B")
    gc.collect()
    torch.cuda.empty_cache()
    unmasked, _ = l8b_server_phase(model.module, model.config, device, "bf16")
    gc.collect()
    torch.cuda.empty_cache()
    l8b_int8_phase(model, device, card_line, rates)
    peak = max(peaks + [torch.cuda.max_memory_allocated(device)]) / 2**30
    print(f"Llama-3.1-8B serving phases: peak memory {peak:.3f} GiB "
          f"(torch.cuda.max_memory_allocated) of the card's "
          f"{torch.cuda.get_device_properties(device).total_memory / 2**30:.2f}; the idle share "
          f"of a bf16 decode step {100 * rates['idle']:.1f}%")
    if peak > 79:
        raise AssertionError(f"the 8B serving phases peaked at {peak:.3f} GiB, over 79")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"packed_mha_fwd:d128": unmasked, "packed_mha_fwd:masked:d128": masked}


# ---------------------------------------------------------------------------
# The ViT apps: the train, eval and linear-probing command lines
# ---------------------------------------------------------------------------


def write_cifar10(root: Path, n_train: int, n_test: int, seed: int = 0) -> Path:
    """CIFAR-10's on-disk format (``cifar-10-batches-py``: five train batches
    and a test batch of pickled uint8 rows of 3072) with class-separable
    pixels: noise in [0, 64) plus 19 x label in the red channel."""
    rng = np.random.default_rng(seed)
    base = root / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for name, n in [(f"data_batch_{i}", n_train // 5) for i in range(1, 6)] + [
            ("test_batch", n_test)]:
        labels = rng.integers(0, 10, size=n)
        data = rng.integers(0, 64, size=(n, 3072), dtype=np.uint8)
        data[:, :1024] += (labels[:, None] * 19).astype(np.uint8)
        with open(base / name, "wb") as f:
            pickle.dump({b"data": data, b"labels": labels.tolist()}, f)
    return root


def apps_train_argv(data_dir: Path, log_dir: str) -> list[str]:
    return [f"config={REPO_ROOT / 'apps/vit/configs/cifar10.yaml'}", "pretrained=False",
            "seed=42", "lr=1e-2", f"data_dir={data_dir}", f"n_steps={APPS_STEPS}", "warmup=10",
            f"eval_period={APPS_EVAL_PERIOD}", f"logging_period={APPS_LOGGING_PERIOD}",
            "components=" + json.dumps(APPS_COMPONENTS, separators=(",", ":")),
            f"log_dir={log_dir}"]


@contextlib.contextmanager
def apps_probes(n_layers: int):
    """Wrap the train command line's evaluation (seconds and K1 launches of
    each call, which must be n_layers per batch), its Checkpointer (kept, for
    their save timings) and its optimizer loading (the buffers loaded must
    equal optim.npz's)."""
    evals, checkpointers, loads = [], [], []
    real_eval, real_checkpointer = TRAIN_APP.run_evaluation, TRAIN_APP.Checkpointer
    real_load = TRAIN_APP.load_optimizer_state

    def timed_eval(model, loader):
        torch.cuda.synchronize()
        k1, t0 = A.fused_mha_packed.launches, time.perf_counter()
        metrics = real_eval(model, loader)
        torch.cuda.synchronize()
        evals.append({"seconds": time.perf_counter() - t0, "batches": len(loader),
                      "images": len(loader.indices),
                      "k1": A.fused_mha_packed.launches - k1})
        if evals[-1]["k1"] != n_layers * len(loader):
            raise AssertionError(f"an evaluation launched K1 {evals[-1]['k1']} times over "
                                 f"{len(loader)} batches, want {n_layers} a batch")
        return metrics

    class KeptCheckpointer(real_checkpointer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            checkpointers.append(self)

    def checked_load(optimizer, module, flat):
        real_load(optimizer, module, flat)
        params = dict(module.named_parameters())
        for key, value in flat.items():
            if key != CK.OPTIM_LAYOUT_KEY:
                name, _, buffer = key.rpartition(".")
                got = optimizer.state[params[name]][buffer].cpu().numpy()
                if not np.array_equal(got, value):
                    raise AssertionError(f"optimizer buffer {key} not loaded as saved")
        loads.append(len(flat) - 1)

    TRAIN_APP.run_evaluation, TRAIN_APP.Checkpointer = timed_eval, KeptCheckpointer
    TRAIN_APP.load_optimizer_state = checked_load
    try:
        yield evals, checkpointers, loads
    finally:
        TRAIN_APP.run_evaluation, TRAIN_APP.Checkpointer = real_eval, real_checkpointer
        TRAIN_APP.load_optimizer_state = real_load


def jsonl(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def check_run_dir(run: Path, steps: int, init: dict) -> tuple[list, list, Path]:
    """The JAX package's run dir contract: its files, the jsonl fields, one
    checkpoint at the best evaluated step holding the JAX dotted keys in the
    JAX layout, and every parameter the freeze leaves out bit-equal to its
    initial value (``init``: the model built from the same seed)."""
    tree = {str(p.relative_to(run)) for p in run.rglob("*") if "checkpoints/" not in str(
        p.relative_to(run))}
    want = {"config.json", "checkpoints", "logs", "logs/device_0.log", "metrics",
            "metrics/raw_0.jsonl", "metrics/info_model.jsonl"}
    if tree != want:
        raise AssertionError(f"run dir {sorted(tree)}, want {sorted(want)}")
    records = jsonl(run / "metrics" / "raw_0.jsonl")
    train = [r for r in records if "loss" in r]
    evals = [r for r in records if "eval_acc" in r]
    if any(set(r) != TRAIN_RECORD_KEYS for r in train) or any(
            set(r) != EVAL_RECORD_KEYS for r in evals) or len(train) + len(evals) != len(
            records):
        raise AssertionError(f"metric records off the contract: {records[:3]}")
    if [r["step"] for r in train] != list(range(APPS_LOGGING_PERIOD, steps + 1,
                                                APPS_LOGGING_PERIOD)):
        raise AssertionError(f"logged steps {[r['step'] for r in train]}")
    best = max(evals, key=lambda r: r["eval_acc"])  # the first of equals, as the app keeps
    ckpts = sorted((run / "checkpoints").iterdir())
    if [c.name for c in ckpts] != [f"{best['step']:010d}"] or {
            f.name for f in ckpts[0].iterdir()} != CHECKPOINT_FILES:
        raise AssertionError(f"checkpoints {[c.name for c in ckpts]} (best eval step "
                             f"{best['step']})")
    with np.load(ckpts[0] / "model.npz") as z:
        saved = {k: z[k] for k in z.files}
    if set(saved) != set(init) or any(saved[k].shape != init[k].shape for k in init):
        raise AssertionError("model.npz keys or shapes differ from the JAX layout")
    return train, evals, ckpts[0]


def vit_apps_phase(device, card_line: str) -> Path:
    """The paper's experiment through the port's command lines on the card:
    train (K10, K1, K2 each step, K1 in every evaluation batch, no plain
    version), the run dir's contract, a resume, the eval command line as a
    subprocess and linear probing; then 10 steps at 1 x 512 and 2 x 256.
    Returns the CIFAR-10 files' dir; the caller removes ``APPS_ROOT``."""
    log_dir = APPS_LOG_DIR
    run = APPS_ROOT / "savings" / "runs" / log_dir
    try:
        t0 = time.perf_counter()
        data = write_cifar10(APPS_ROOT / "cifar10", *APPS_CIFAR)
        probe_data = write_cifar10(APPS_ROOT / "cifar10_probe", *APPS_PROBE_CIFAR, seed=1)
        print(f"ViT apps ({card_line}): CIFAR-10 files of {APPS_CIFAR[0]:,} + "
              f"{APPS_CIFAR[1]:,} and {APPS_PROBE_CIFAR[0]:,} + {APPS_PROBE_CIFAR[1]:,} "
              f"images written in {time.perf_counter() - t0:.2f} s")
        argv = apps_train_argv(data, log_dir)
        # the model the command line builds (the config's seed 42, in21k=True
        # with the head swapped for 10 classes), built again on the host
        init_model = build_model(APPS_MODEL, device="cpu",
                                 generator=torch.Generator().manual_seed(42))
        init = CK.model_state(init_model.module)
        frozen = {k for k, v in freeze_components(init_model.module, APPS_COMPONENTS).items()
                  if not v}
        n_layers = init_model.config.n_layers
        del init_model
        gc.collect()
        torch.cuda.empty_cache()

        counters = (A.fused_mha_packed, A.packed_mha_bwd, T.augment_train_device)
        torch.cuda.synchronize(device)  # the context, if no phase made it yet
        torch.cuda.reset_peak_memory_stats(device)
        with no_plain_versions() as (plain_calls, aug_calls), \
                apps_probes(n_layers) as (evals, checkpointers, loads):
            for counter in counters:
                counter.launches = 0
            t0 = time.perf_counter()
            TRAIN_APP.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counters}
        peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
        grad_acc = APPS_BATCH // AUTO_MICROBATCH
        eval_k1 = sum(e["k1"] for e in evals)
        want = {"fused_mha_packed": n_layers * grad_acc * APPS_STEPS + eval_k1,
                "packed_mha_bwd": n_layers * grad_acc * APPS_STEPS,
                "augment_train_device": APPS_STEPS}
        print(f"train command line, {APPS_STEPS} steps in {seconds:.2f} s (start-up, "
              f"evaluations and checkpoints included): launches {launches} (want {want}; "
              f"K1 {n_layers} a batch over {sum(e['batches'] for e in evals)} evaluation "
              f"batches); plain calls {len(plain_calls) + len(aug_calls)}; peak memory "
              f"{peak_gib:.3f} GiB")
        if launches != want or plain_calls or aug_calls or len(evals) != 2:
            raise AssertionError("the train command line did not take K10, K1 and K2 as "
                                 "it should")

        train, eval_records, ckpt = check_run_dir(run, APPS_STEPS, init)
        with np.load(ckpt / "model.npz") as z:
            moved = sorted(k for k in z.files if not np.array_equal(z[k], init[k]))
            changed_frozen = [k for k in frozen if not np.array_equal(z[k], init[k])]
        losses = [r["loss"] for r in train]
        accs = [r["eval_acc"] for r in eval_records]
        print(f"train.jsonl (metrics/raw_0.jsonl): loss {' '.join(f'{v:.4f}' for v in losses)}"
              f" at steps {[r['step'] for r in train]}; eval_acc {accs} (eval_loss "
              f"{[round(r['eval_loss'], 4) for r in eval_records]}); checkpoint {ckpt.name}; "
              f"{len(frozen)} frozen tensors bit-equal to their init, {len(moved)} trained "
              f"ones moved ({', '.join(moved)})")
        if not (losses[-1] < losses[0] and max(accs) > 0.1 and not changed_frozen and moved):
            raise AssertionError(f"the run did not learn, or a frozen tensor moved "
                                 f"({changed_frozen})")

        # Rates: ts is the seconds since the logger started, so a period's rate
        # is its steps over the difference of two ts; a period after an eval
        # step carries that evaluation and its checkpoint.
        eval_steps = {r["step"] for r in eval_records}
        periods = [(b["step"], b["elapsed_steps"] * APPS_BATCH / (b["ts"] - a["ts"]),
                    a["step"] in eval_steps) for a, b in zip(train, train[1:])]
        steady = [rate for _, rate, with_eval in periods if not with_eval]
        print("train command line img/s per logged period: " + ", ".join(
            f"to step {step} {rate:.2f}{' (with an evaluation)' if with_eval else ''}"
            for step, rate, with_eval in periods) +
            f"; median of the periods without one {float(np.median(steady)):.2f} img/s")
        for e in evals:
            print(f"evaluation: {e['images']} images in {e['batches']} batches, "
                  f"{e['seconds']:.3f} s ({e['images'] / e['seconds']:.2f} img/s), K1 "
                  f"{e['k1']}")
        for timing in checkpointers[0].timings:
            print(f"checkpoint at step {timing['step']}: device->host staging "
                  f"{timing['stage_s']:.3f} s, write {timing['write_s']:.3f} s")

        # Resume: the same command line to step 70 from the best checkpoint.
        with apps_probes(n_layers) as (evals2, _, loads):
            TRAIN_APP.main(argv + [f"n_steps={APPS_RESUMED_STEPS}", "overwrite=False"])
        resumed = [r for r in jsonl(run / "metrics" / "raw_0.jsonl") if "loss" in r][len(train):]
        best = int(ckpt.name)
        if not (loads and resumed and resumed[0]["step"] == best + APPS_LOGGING_PERIOD
                and resumed[-1]["step"] == APPS_RESUMED_STEPS):
            raise AssertionError(f"the resume did not continue from step {best}: loaded "
                                 f"{loads}, logged {[r['step'] for r in resumed]}")
        print(f"resume to step {APPS_RESUMED_STEPS}: loaded the checkpoint of step {best} "
              f"with {loads[0]} optimizer buffers (bit-equal to optim.npz); logged steps "
              f"{[r['step'] for r in resumed]}, loss {resumed[-1]['loss']:.4f}")

        # The eval command line as a user runs it, then in this process with
        # the batches counted.
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "vitef_tpu_torch.apps.vit.eval",
             f"config={REPO_ROOT / 'apps/vit/configs/eval.yaml'}", f"log_dir={log_dir}",
             f"data_dir={data}"], cwd=REPO_ROOT, capture_output=True, text=True,
            timeout=600)
        eval_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the eval command line exited {proc.returncode}:\n"
                                 f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        (record,) = jsonl(run / "metrics" / "eval.jsonl")
        test_ckpt = Path(CK.Checkpointer.get_last_checkpoint_path(run / "checkpoints"))
        model = build_model(json.loads((test_ckpt / "params.json").read_text()), device=device)
        CK.load_checkpoint_params(test_ckpt, model.module)
        test_loader = build_loader({"dataset_name": "cifar10", "mode": "test",
                                    "batch_size": APPS_BATCH, "size": 224,
                                    "save_dir": str(data)}, device=device, drop_last=False)
        sizes = []
        A.fused_mha_packed.launches = 0
        metrics = run_evaluation(model, ((sizes.append(len(y)) or x, y) for x, y in test_loader))
        print(f"eval command line (subprocess): exit 0 in {eval_seconds:.2f} s, test_acc "
              f"{record['test_acc']:.6f}; in this process over {sum(sizes)} test images in "
              f"{len(sizes)} batches (the last {sizes[-1]}), K1 {A.fused_mha_packed.launches}: "
              f"{metrics['eval_acc']:.6f}")
        if not (sum(sizes) == APPS_CIFAR[1] and sizes[-1] == APPS_CIFAR[1] % APPS_BATCH
                and abs(metrics["eval_acc"] - record["test_acc"]) <= 1e-6
                and A.fused_mha_packed.launches == n_layers * len(sizes)):
            raise AssertionError("the eval command line's test_acc is not that of the "
                                 "whole test split")
        del model, test_loader
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        accs = LP.linear_probing(LP.LinearProbingConfig(
            log_dir=log_dir, data_dir=str(probe_data), probe_impl="torch"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        saved = json.loads((LP.PROBE_DIR / log_dir / "linear_probing.json").read_text())
        best_key = max(accs, key=accs.get)
        print(f"linear probing ({probe_data.name}: {APPS_PROBE_CIFAR[0]:,} train, "
              f"{APPS_PROBE_CIFAR[1]:,} test images; probe_impl torch) in {seconds:.2f} s: "
              f"{len(saved)} keys, accuracy {min(accs.values()):.4f}..{accs[best_key]:.4f} "
              f"(best {best_key})")
        if not (saved == accs and len(saved) == 8 * n_layers
                and all(0.0 <= a <= 1.0 for a in saved.values())):
            raise AssertionError(f"linear_probing.json holds {saved}")
        gc.collect()
        torch.cuda.empty_cache()

        # 1 x 512 beside 2 x 256 with the run's freeze (train_phase's protocol).
        split = {}
        for microbatch in (APPS_BATCH, AUTO_MICROBATCH):
            model = build_model(VIT_B16, device=device)
            freeze_components(model.module, APPS_COMPONENTS)
            label = f"ViT-B/16 frozen blocks {APPS_BATCH // microbatch} x {microbatch}"
            *_, split[microbatch] = train_phase(model, device, label, microbatch, warmup=2,
                                                timed=APPS_SPLIT_TIMED)
            del model
            gc.collect()
            torch.cuda.empty_cache()
        step_ms = APPS_BATCH / float(np.median(steady)) * 1e3
        loop_ms = APPS_BATCH / split[AUTO_MICROBATCH]["loader_img_s"] * 1e3
        print(f"ViT apps summary ({card_line}): command line {float(np.median(steady)):.2f} "
              f"img/s ({step_ms:.3f} ms a step) against train_phase's loop "
              f"{split[AUTO_MICROBATCH]['loader_img_s']:.2f} img/s ({loop_ms:.3f} ms) at "
              f"2 x 256 with the same freeze: the command line adds {step_ms - loop_ms:.3f} "
              f"ms a step; 1 x 512 {split[APPS_BATCH]['loader_img_s']:.2f} img/s loader "
              f"included, {split[APPS_BATCH]['device_img_s']:.2f} device-only, peak "
              f"{split[APPS_BATCH]['peak_gib']:.3f} GiB; 2 x 256 "
              f"{split[AUTO_MICROBATCH]['loader_img_s']:.2f}, "
              f"{split[AUTO_MICROBATCH]['device_img_s']:.2f}, peak "
              f"{split[AUTO_MICROBATCH]['peak_gib']:.3f} GiB")
        return data
    finally:
        # the command lines' Logger left its file and stream handlers on "vitef"
        for handler in logging.getLogger("vitef").handlers[:]:
            logging.getLogger("vitef").removeHandler(handler)
            handler.close()


# ---------------------------------------------------------------------------
# The paper's figures: the loss-landscape surfaces, the radius and the bounds
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def landscape_probes():
    """Keep each ``compute_landscape`` result, and time (synchronized) each
    SGD trajectory and each surface grid."""
    kept, timings = [], {"sgd": [], "grid": []}
    real = LL.compute_landscape, LL.sgd_trajectory, LL.surface_grid

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            timings[key].append(time.perf_counter() - t0)
            return out
        return wrapper

    def keep(*args, **kwargs):
        kept.append(real[0](*args, **kwargs))
        return kept[-1]

    LL.compute_landscape, LL.sgd_trajectory, LL.surface_grid = (
        keep, timed(real[1], "sgd"), timed(real[2], "grid"))
    try:
        yield kept, timings
    finally:
        LL.compute_landscape, LL.sgd_trajectory, LL.surface_grid = real


def sign_rule(components: np.ndarray) -> np.ndarray:
    """Each row flipped so that its entry of largest magnitude is positive."""
    largest = np.abs(components).argmax(axis=1)
    return components * np.sign(components[np.arange(len(components)), largest])[:, None]


def landscape_check(result, comp: str) -> str:
    """One component's surfaces at PLOTS_POINTS recomputed on the host CPU
    from the card's weights, batch and directions, and its PCA plane against
    numpy's SVD of the same trajectory."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on for the float32 surfaces")
    model = result.component.model
    host = Model(module=copy.deepcopy(model.module).cpu(), config=model.config, name=model.name)
    host_component = LL.Component(host, 0, comp)
    host_plane = result.plane.to("cpu")
    worst = 0.0
    for j, i in PLOTS_POINTS:
        z_loss, z_func = LL.surface_point(host_component, host_plane, result.u_coords[i],
                                          result.v_coords[j])
        for got, want, label in [(result.Z_loss[j, i], float(z_loss), "loss"),
                                 (result.Z_func[j, i], float(z_func), "rate of change")]:
            rel = abs(float(got) - want) / abs(want)
            worst = max(worst, rel)
            if not (np.isfinite(got) and rel <= PLOTS_REL):
                raise AssertionError(f"{comp} {label} at (u, v) = ({result.u_coords[i]:.4f}, "
                                     f"{result.v_coords[j]:.4f}): card {got}, host {want}")
    trajectory = result.params.cpu().double().numpy()
    trajectory -= trajectory.mean(axis=0)
    _, svals, vt = np.linalg.svd(trajectory, full_matrices=False)
    want = sign_rule(vt[:2])
    got = torch.stack([result.plane.p_dx, result.plane.p_dy]).cpu().double().numpy()
    gram = got @ got.T
    pca_err = float(np.abs(got - want).max())
    if pca_err > PCA_ABS or np.abs(gram - np.eye(2)).max() > PCA_ABS:
        raise AssertionError(f"{comp}'s PCA plane is {pca_err} from numpy's SVD (Gram "
                             f"{gram.tolist()})")
    del host, host_component, host_plane
    return (f"{comp}: 5 points within {worst:.2e} of the host's; PCA plane within "
            f"{pca_err:.2e} of numpy's SVD, singular values {svals[0]:.4e}, {svals[1]:.4e}")


def bounds_check(model, name: str, r: float, bounds: tuple, blocks: list[int]) -> float:
    """The bounds of ``blocks`` recomputed on the host from the card's weights
    with scipy's SVDs in float64; the largest relative difference."""
    from scipy.linalg import svdvals

    ln1, mha, ln2, fc1, fc2 = bounds
    n_heads, e, seq_len = TH.N_HEADS[name], TH.EMB_DIM[name], TH.SEQ_LEN[model.config.patch_size]
    d = e // n_heads
    worst = 0.0
    for b in blocks:
        block = model.module.blocks[b]
        w = {k: v.detach().cpu().double().numpy() for k, v in block.state_dict().items()}
        q, k, v = np.split(w["attn.qkv_mat.weight"], 3)
        out = w["attn.output.weight"]
        comp = 0.0
        for h in range(n_heads):
            sl = slice(h * d, (h + 1) * d)
            s_qk = svdvals(q[:, sl] @ k[:, sl].T / math.sqrt(d))[0]
            comp += svdvals(out[:, sl])[0] * svdvals(v[:, sl])[0] * math.sqrt(
                3 * seq_len + (12 * seq_len + 3) * r**4 * s_qk**2)
        want = {"LN1": w["attn_norm.weight"].max(), "LN2": w["ffn_norm.weight"].max(),
                "FC1": svdvals(w["ffn.fc1.weight"])[0], "FC2": svdvals(w["ffn.fc2.weight"])[0],
                "MHA": comp}
        got = {"LN1": ln1[b], "LN2": ln2[b], "FC1": fc1[b], "FC2": fc2[b], "MHA": mha[b]}
        for key in want:
            rel = abs(got[key] - want[key]) / abs(want[key])
            worst = max(worst, rel)
            if rel > BOUND_REL:
                raise AssertionError(f"{name} block {b} {key} bound: card {got[key]}, host "
                                     f"{want[key]}")
    return worst


def landscape_phase(card_line: str, data: Path) -> None:
    """The loss-landscape ``save`` command on the card, each surface and PCA
    plane checked on the host."""
    with landscape_probes() as (kept, timings):
        t0 = time.perf_counter()
        LL.save_results(data_dir=str(data), device="cuda")
        save_seconds = time.perf_counter() - t0
    comps = ["ln1", "fc1", "mha"]
    if len(kept) != 3:
        raise AssertionError(f"save_results computed {len(kept)} landscapes")
    for comp, result, sgd_s, grid_s in zip(comps, kept, timings["sgd"], timings["grid"]):
        saved = {}
        for key in ("loss", "func", "u_coords", "v_coords", "traj"):
            with open(LL.SAVE_DIR / f"{comp}_block_0" / f"{key}.pkl", "rb") as f:
                saved[key] = pickle.load(f)
        if not (saved["loss"].shape == saved["func"].shape == (20, 20)
                and np.isfinite(saved["loss"]).all() and (saved["func"] > 0).all()
                and len(saved["traj"]) == 20 and np.array_equal(saved["loss"], result.Z_loss)):
            raise AssertionError(f"{comp}'s pickled surfaces are off")
        n_params = result.params.shape[1]
        print(f"loss landscape {comp} block 0 ({card_line}): {n_params:,} parameters; "
              f"{sgd_s / 20 * 1e3:.3f} ms per SGD step (20 steps, batch 4, loss "
              f"{float(result.losses[0]):.4f} -> {float(result.losses[-1]):.4f}); surface "
              f"grid of 400 points {grid_s:.3f} s ({grid_s / 400 * 1e3:.3f} ms a point, "
              f"both surfaces); loss {saved['loss'].min():.4f}..{saved['loss'].max():.4f}, "
              f"rate of change {saved['func'].min():.4f}..{saved['func'].max():.4f}; "
              + landscape_check(result, comp))
    print(f"loss landscape save command: {save_seconds:.2f} s for 3 components")


def theory_phase(card_line: str, data: Path) -> None:
    """The token radius at print_radius's settings and the ``save`` command's
    bounds at base/16, large/16 and huge/14 on the card, checked on the host."""
    t0 = time.perf_counter()
    r = TH.get_radius(**RADIUS, data_dir=str(data), device="cuda")
    radius_s = time.perf_counter() - t0
    short = {**RADIUS, "max_steps": RADIUS_HOST_STEPS, "data_dir": str(data)}
    r_card, r_host = TH.get_radius(**short, device="cuda"), TH.get_radius(**short, device="cpu")
    if not (np.isfinite(r) and r > 0 and abs(r_card - r_host) <= BOUND_REL * r_host):
        raise AssertionError(f"radius {r}; over {RADIUS_HOST_STEPS} batches card {r_card}, "
                             f"host {r_host}")
    print(f"radius ({card_line}): r = {r:.6f} over {RADIUS['max_steps']} batches of "
          f"{RADIUS['batch_size']} in {radius_s:.3f} s ({radius_s / RADIUS['max_steps'] * 1e3:.3f}"
          f" ms a batch); over {RADIUS_HOST_STEPS} batches card {r_card:.7f}, host CPU "
          f"{r_host:.7f}")

    built = []
    real_build = TH._build_vit
    TH._build_vit = lambda *args: built.append(real_build(*args)) or built[-1]
    try:
        for name, patch in BOUND_MODELS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = TH.save_bounds(name, patch, r=r, device="cuda")
            seconds = time.perf_counter() - t0
            with open(path, "rb") as f:
                bounds = pickle.load(f)
            n_layers = TH.N_LAYERS[name]
            if not (len(bounds) == 5 and all(len(b) == n_layers for b in bounds)
                    and np.isfinite(bounds).all() and (np.asarray(bounds) > 0).all()):
                raise AssertionError(f"{name}'s bounds are off: {bounds}")
            model = built.pop()
            t1 = time.perf_counter()
            blocks = BOUND_CHECK_BLOCKS[name]
            worst = bounds_check(model, name, r, bounds, blocks)
            print(f"bounds ViT-{name}/{patch} ({card_line}): {seconds:.3f} s (model build "
                  f"included); blocks {blocks} within {worst:.2e} of scipy's "
                  f"float64 SVDs on the host ({time.perf_counter() - t1:.2f} s); MHA "
                  f"{bounds[1][0]:.4e}..{bounds[1][-1]:.4e}, FC1 {bounds[3][0]:.4f}, "
                  f"FC2 {bounds[4][0]:.4f}, LN1 {bounds[0][0]:.4f}")
            del model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        TH._build_vit = real_build


def plots_reader_check() -> None:
    """Phase 34's run read back by the plots' reader under its sweep name."""
    training, validation, eval_data = PLOT_FT.get_single_exp("cifar10", 42, "1e-2", 1)
    run = PLOT_FT.RUNS_DIR / APPS_LOG_DIR
    records = jsonl(run / "metrics" / "raw_0.jsonl")
    (test,) = jsonl(run / "metrics" / "eval.jsonl")
    ckpt = sorted(p.name for p in (run / "checkpoints").iterdir())[-1]
    if not (eval_data["trainable_components"] == "emb" and eval_data["n_step"] == ckpt
            and eval_data["test_acc"] == test["test_acc"]
            and list(training[0]) == [r["step"] for r in records if "loss" in r]
            and list(validation[2]) == [r["eval_acc"] for r in records if "eval_acc" in r]):
        raise AssertionError(f"get_single_exp read {eval_data}")
    print(f"plots reader: get_single_exp('cifar10', 42, '1e-2', 1) on {APPS_LOG_DIR}: "
          f"trainable {eval_data['trainable_components']}, checkpoint {eval_data['n_step']}, "
          f"test_acc {eval_data['test_acc']:.6f}, {len(training[0])} train and "
          f"{len(validation[0])} eval records")


def plots_phase(card_line: str, data: Path) -> None:
    """The paper's figures' computations on the card: the loss-landscape
    ``save`` command, the token radius and the bounds at three sizes, each
    checked on the host; then phase 34's run read back by the plots' reader."""
    t0 = time.perf_counter()
    landscape_phase(card_line, data)
    gc.collect()
    torch.cuda.empty_cache()
    theory_phase(card_line, data)
    plots_reader_check()
    print(f"plots phase: {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# K9, the ring hop, and the sequence-parallel train slice
# ---------------------------------------------------------------------------


def hop_positions(kind: str, lseg: int, device):
    """(qpos, kpos) int32 of a hop: "mid" (a mid-ring hop, every key visible,
    as tools/profile_ring_hop.py:64-65), "diagonal" (qpos = kpos) or "future"
    (every key after every query)."""
    iota = torch.arange(lseg, dtype=torch.int32, device=device)
    return {"mid": (iota + 4 * lseg, iota), "diagonal": (iota, iota),
            "future": (iota, iota + 4 * lseg)}[kind]


def hop_state_draw(gen, n: int, h: int, l: int, d: int, device, initial: bool):
    """A hop's incoming float32 state: the -1e30 start, or a non-initial one."""
    if initial:
        return (torch.full((n, h, l, 1), -1e30, device=device),
                torch.zeros((n, h, l, 1), device=device), torch.zeros((n, h, l, d), device=device))
    return ((torch.randn(n, h, l, 1, generator=gen) + 3).to(device),
            (torch.rand(n, h, l, 1, generator=gen) * 40 + 1).to(device),
            (torch.randn(n, h, l, d, generator=gen) * 5).to(device))


def hop_errors(got, ref) -> tuple[float, float, float]:
    """(max |d|, mean |d|) of acc / s, and max |d| of m, between two states."""
    out_g, out_r = (acc / s.clamp_min(1e-30) for _, s, acc in (got, ref))
    diff = (out_g - out_r).abs()
    return diff.max().item(), diff.mean().item(), (got[0] - ref[0]).abs().max().item()


def unzeroed_hop(q, qpos, k, v, kpos, m, s, acc):
    """The plain hop with a planted fault: the masked probabilities are not
    zeroed, so a block that a row may not see counts exp(0) = 1 per key
    while the row's max is still at the -1e30 start."""
    scores = torch.matmul(q.float() / math.sqrt(q.shape[-1]), k.float().transpose(-1, -2))
    scores = torch.where(kpos[None, :] <= qpos[:, None], scores, -1e30)
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    p = torch.exp(scores - m_new)
    corr = torch.exp(m - m_new)
    return m_new, s * corr + p.sum(dim=-1, keepdim=True), acc * corr + p @ v.float()


def ring_hop_phase(device, seed: int, iters: int) -> dict:
    """K9 in bf16 against its float32 plain version on the same inputs at
    RING_HOP_CASES, each mid-ring, diagonal and fully future (there the state
    comes back bit-equal, from a non-initial state and from the -1e30
    start), bit-identical over two launches; chains of 3 hops, one from a
    non-initial state and one from the start with the future block first
    (read again with the masked probabilities' zeroing planted out of the
    plain version, which must fail the gate); strided operands (a zigzag
    segment, heads read from a packed qkv) and float16; the wrapper's
    refusals. Timed at the main shape (mid-ring) as chained hops with the
    plain version, its bound and SDPA on the same block as a yardstick."""
    gen = torch.Generator().manual_seed(seed)

    def kernel(q, qpos, k, v, kpos, state):
        return RH.hop_state(q, qpos, k, v, kpos, *state, causal=True, impl="kernel")

    def plain(q, qpos, k, v, kpos, state):
        return RH.hop_state_reference(q, qpos, k, v, kpos, *state, causal=True)

    def check(label, got, ref):
        max_abs, mean_abs, m_abs = hop_errors(got, ref)
        print(f"K9 ring_hop {label}: acc/s max|d|={max_abs:.3e} mean|d|={mean_abs:.3e}, "
              f"m max|d|={m_abs:.3e}")
        if not (all(torch.isfinite(t).all() for t in got) and max_abs <= KERNEL_MAX_ABS
                and mean_abs <= KERNEL_MEAN_ABS and m_abs <= RING_HOP_M_ABS):
            raise AssertionError(f"K9 disagrees with its plain version: {label}")
        return max_abs

    for n, h, l, d in RING_HOP_CASES:
        q, k, v = (torch.randn(n, h, l, d, generator=gen).to(device, torch.bfloat16)
                   for _ in range(3))
        for kind in ("mid", "diagonal", "future"):
            qpos, kpos = hop_positions(kind, l, device)
            for initial in (False, True):
                state = hop_state_draw(gen, n, h, l, d, device, initial)
                launches = RH.hop_state.launches
                with torch.inference_mode():
                    got, again = (kernel(q, qpos, k, v, kpos, state) for _ in range(2))
                    ref = plain(q, qpos, k, v, kpos, state)
                torch.cuda.synchronize()
                if RH.hop_state.launches != launches + 2:
                    raise AssertionError("K9's wrapper did not launch it")
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"K9 is not bit-identical over two launches at "
                                         f"{(n, h, l, d)} {kind}")
                label = (f"N={n} h={h} lseg={l} d={d} {kind}, "
                         f"{'the -1e30 start' if initial else 'a non-initial state'}")
                if kind == "future":
                    if not all(torch.equal(a, b) for a, b in zip(got, state)):
                        raise AssertionError(f"K9 changed the state on a fully future block: "
                                             f"{label}")
                    print(f"K9 ring_hop {label}: the state came back bit-equal")
                    continue
                err = check(label, got, ref)
                if (n, h, l, d) == RING_HOP_MAIN and kind == "mid" and not initial:
                    main_err = err

    # Chains of three hops: from a non-initial state (mid, diagonal, future),
    # and from the start with the future block first (future, mid, diagonal).
    n, h, l, d = RING_HOP_MAIN
    blocks = {kind: ((torch.randn(n, h, l, d, generator=gen).to(device, torch.bfloat16),
                      torch.randn(n, h, l, d, generator=gen).to(device, torch.bfloat16)),
                     hop_positions(kind, l, device)) for kind in ("mid", "diagonal", "future")}
    q = torch.randn(n, h, l, d, generator=gen).to(device, torch.bfloat16)
    for order, initial in ((("mid", "diagonal", "future"), False),
                           (("future", "mid", "diagonal"), True)):
        st_k = st_p = hop_state_draw(gen, n, h, l, d, device, initial)
        with torch.inference_mode():
            for kind in order:
                (k, v), (qpos, kpos) = blocks[kind]
                st_k = kernel(q, qpos, k, v, kpos, st_k)
                st_p = plain(q, qpos, k, v, kpos, st_p)
        check(f"chain {' -> '.join(order)} from "
              f"{'the -1e30 start' if initial else 'a non-initial state'}", st_k, st_p)
    # The masked probabilities' zeroing matters for a row that has seen no
    # key yet (once a row sees one, exp(-1e30 - m) wipes what came before):
    # planted out of the plain version, the fully future hop from the start
    # must fail both the bit-equality and the gate.
    (k, v), (qpos, kpos) = blocks["future"]
    start = hop_state_draw(gen, n, h, l, d, device, True)
    with torch.inference_mode():
        faulty = unzeroed_hop(q, qpos, k, v, kpos, *start)
    planted_reading = hop_errors(kernel(q, qpos, k, v, kpos, start), faulty)[0]
    print(f"planted fault: the plain hop without the masked probabilities' zeroing, a fully "
          f"future hop from the -1e30 start: acc/s max|d|={planted_reading:.3e} (must exceed "
          f"{KERNEL_MAX_ABS:g}); state bit-equal to the start: "
          f"{all(torch.equal(a, b) for a, b in zip(faulty, start))} (must be False)")
    if not planted_reading > KERNEL_MAX_ABS or all(torch.equal(a, b)
                                                   for a, b in zip(faulty, start)):
        raise AssertionError("the K9 checks did not see the zeroing dropped")

    # The hop's own autograd path (K9 forward, the plain hop replayed
    # backward) against autograd through its plain version: both backwards
    # differentiate the same float32 replay, so only rounding may differ.
    (k, v), (qpos, kpos) = blocks["diagonal"]
    state = hop_state_draw(gen, n, h, l, d, device, False)
    cot = [torch.randn(t.shape, generator=gen).to(device) for t in state]
    grads = []
    for hop in (kernel, plain):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, *state)]
        launches = RH.hop_state.launches
        new = hop(leaves[0], qpos, leaves[1], leaves[2], kpos, leaves[3:])
        grads.append(torch.autograd.grad(new, leaves, cot))
        if hop is kernel and RH.hop_state.launches != launches + 1:
            raise AssertionError("K9's autograd path did not launch it")
    rels = [rel_l2(a, b) for a, b in zip(*grads)]
    print("K9 ring_hop autograd (K9 forward, replayed backward) against the plain hop's: "
          "relative L2 of dq, dk, dv, dm, ds, dacc " + " ".join(f"{r:.2e}" for r in rels))
    if not all(math.isfinite(r) and r <= HOP_GRAD_REL_L2 for r in rels):
        raise AssertionError("K9's backward disagrees with its plain version's")

    # Strided operands read in place: the second half of a zigzag shard, and
    # heads viewed out of a packed (N, L, 3E) qkv; then float16.
    shard = torch.randn(n, h, 2 * l, d, generator=gen).to(device, torch.bfloat16)
    packed = torch.randn(n, 2 * l, 3 * h * d, generator=gen).to(device, torch.bfloat16)
    heads = [t.reshape(n, 2 * l, h, d).transpose(1, 2)[:, :, l:] for t in packed.chunk(3, -1)]
    half = [torch.randn(n, h, l, d, generator=gen).to(device, torch.float16) for _ in range(3)]
    n128, h128, _, _ = RING_HOP_CASES[-1]
    half128 = [torch.randn(n128, h128, l, 128, generator=gen).to(device, torch.float16)
               for _ in range(3)]
    qpos, kpos = hop_positions("diagonal", l, device)
    for label, (q_, k_, v_) in {"a zigzag segment (offset view)": (shard[:, :, l:],) * 3,
                                "heads of a packed qkv (row stride 3E)": heads,
                                "float16": half, "float16 d=128": half128}.items():
        state = hop_state_draw(gen, *q_.shape[:3], q_.shape[3], device, False)
        with torch.inference_mode():
            check(label, kernel(q_, qpos, k_, v_, kpos, state),
                  plain(q_, qpos, k_, v_, kpos, state))

    # What K9 does not take raises on CUDA; nothing falls back.
    z200 = torch.zeros(1, h, 200, d, device=device, dtype=torch.bfloat16)
    pos200 = torch.arange(200, dtype=torch.int32, device=device)
    narrow = torch.zeros(1, h, 128, 96, device=device, dtype=torch.bfloat16)
    refused = {"float32": (TypeError, lambda: kernel(
                   q.float(), qpos, k.float(), v.float(), kpos,
                   hop_state_draw(gen, n, h, l, d, device, True))),
               "lseg 200": (ValueError, lambda: kernel(
                   z200, pos200, z200, z200, pos200,
                   hop_state_draw(gen, 1, h, 200, d, device, True))),
               "d=96": (NotImplementedError, lambda: kernel(
                   narrow, qpos[:128], narrow, narrow, kpos[:128],
                   hop_state_draw(gen, 1, h, 128, 96, device, True)))}
    launches = RH.hop_state.launches
    for what, (error, call) in refused.items():
        try:
            call()
        except error:
            continue
        raise AssertionError(f"K9's wrapper did not raise {error.__name__} for {what}")
    if RH.hop_state.launches != launches:
        raise AssertionError("K9's wrapper launched on an input it does not take")
    print("K9 ring_hop: the wrapper raises for " + ", ".join(refused))

    # Timed: chains of RING_HOP_CHAIN mid-ring hops, the state fed through.
    timing = {}
    for n, h, l, d in RING_HOP_CASES[:3]:
        q, k, v = (torch.randn(n, h, l, d, generator=gen).to(device, torch.bfloat16)
                   for _ in range(3))
        qpos, kpos = hop_positions("mid", l, device)
        state = hop_state_draw(gen, n, h, l, d, device, False)

        def chain(hop):
            st = state
            for _ in range(RING_HOP_CHAIN):
                st = hop(q, qpos, k, v, kpos, st)
            return st

        with torch.inference_mode():
            ms, plain_ms, times = in_turns(lambda: chain(kernel), lambda: chain(plain), iters)
            sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters)
            out = kernel(q, qpos, k, v, kpos, state)
        ms, plain_ms = ms / RING_HOP_CHAIN, plain_ms / RING_HOP_CHAIN
        limit = bound(4.0 * n * h * l * l * d, PEAK_BF16_FLOPS, (q, k, v, qpos, kpos, *state, *out))
        print(f"K9 ring_hop bf16 N={n} h={h} lseg={l} d={d} mid-ring, per hop of a chain of "
              f"{RING_HOP_CHAIN}: kernel {times[1] / RING_HOP_CHAIN:.4f}/"
              f"{times[2] / RING_HOP_CHAIN:.4f} ms, plain {times[0] / RING_HOP_CHAIN:.4f}/"
              f"{times[3] / RING_HOP_CHAIN:.4f} ms, SDPA on the same block (no state; a "
              f"yardstick only) {sdpa:.4f} ms, bound {limit['bound_ms']:.4f} ms "
              f"({limit['bound_by']}); {4.0 * n * h * l * l * d / ms / 1e9:.2f} TFLOP/s")
        if (n, h, l, d) == RING_HOP_MAIN:
            # library_ms: no single PyTorch call merges a block into a state.
            timing = {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms, **limit,
                      "library_ms": None}
    return timing


SP_KINDS = {"K9 ring_hop": ("ring_hop_mma_kernel",),
            "cuBLAS GEMMs (linears, head, the hops' replay)": ("gemm", "nvjet", "cutlass",
                                                               "xmma", "sm90_"),
            "optimizer (foreach / AdamW)": ("multi_tensor", "foreach"),
            "NCCL": ("nccl",)}
LM_COUNTERS = (A.fused_mha_packed, A.packed_mha_bwd, A.flash_attention, A.flash_bwd,
               RH.hop_state)


class KeepParameters:
    """An optimizer that leaves the parameters as they are, so that a train
    step's gradients stay in .grad."""

    def __init__(self, module):
        self.module = module

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.module.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        pass


def sp_grads(model, group, tokens, labels, zigzag: bool = True):
    """(loss, gradients) of one make_sp_train_step call, without a clip or
    an update: the all-reduced gradients."""
    module = model.module
    step = SEQ.make_sp_train_step(group=group, zigzag=zigzag)
    loss = step(init_train_state(model, KeepParameters(module)), (tokens, labels))["loss"].item()
    grads = {name: p.grad.float().clone() for name, p in module.named_parameters()}
    module.zero_grad(set_to_none=True)
    return loss, grads


def sp_train_phase(device):
    """GPT-2 base through ``make_sp_train_step`` over a one-rank NCCL group:
    zigzag, then contiguous, each SP_WARMUP warm-up and TIMED_STEPS timed
    steps with K9 carrying every hop (3 a layer zigzag, 1 contiguous), no
    other attention kernel and no plain hop forward; a profile of one zigzag
    step; the cross-check; a loss that falls. Returns the zigzag run's K9
    launches over its timed steps."""
    torch.cuda.set_device(device)
    group = SEQ.build_sp_group(1, backend="nccl")  # a one-rank group on a free localhost port
    try:
        model = build_model(GPT2_BASE, device=device)
        cfg = model.config
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=(SP_BATCH, cfg.seq_len))).to(device)
        labels = torch.roll(tokens, -1, dims=1)
        launches_of = {}
        for zigzag in (True, False):
            schedule = build_scheduler(SCHEDULER, n_steps=TRAIN_STEPS)
            optimizer, scheduler = build_optimizer(GPT2_OPTIMIZER, model.module,
                                                   schedule=schedule)
            state = init_train_state(model, optimizer, scheduler)
            step_fn = SEQ.make_sp_train_step(group=group, zigzag=zigzag, grad_clip=GRAD_CLIP,
                                             schedule=schedule, base_lr=GPT2_LR)

            def one_step():
                return step_fn(state, (tokens, labels))

            for _ in range(SP_WARMUP):
                one_step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            with counting(RH, "hop_state_reference") as plain_hops:
                for counter in LM_COUNTERS:
                    counter.launches = 0
                t0 = time.perf_counter()
                history = [one_step() for _ in range(TIMED_STEPS)]
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = {fn.__name__: fn.launches for fn in LM_COUNTERS}
            peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
            layout = "zigzag" if zigzag else "contiguous"
            losses = [m["loss"].item() for m in history]
            if not all(map(math.isfinite, losses + [history[-1]["grad_norm"].item()])):
                raise AssertionError(f"sp {layout} step: loss {losses}")
            want = {"fused_mha_packed": 0, "packed_mha_bwd": 0, "flash_attention": 0,
                    "flash_bwd": 0,
                    "hop_state": SP_K9_PER_LAYER[zigzag] * cfg.n_layers * TIMED_STEPS}
            print(f"GPT-2 sp=1 {layout} launches over {TIMED_STEPS} steps: {launches} (want "
                  f"{want}); plain hop forwards {len(plain_hops)}")
            if launches != want or plain_hops:
                raise AssertionError(f"the sp {layout} step did not go through K9 alone")
            launches_of[zigzag] = launches["hop_state"]
            n_tokens = SP_BATCH * cfg.seq_len
            rate = n_tokens * TIMED_STEPS / seconds
            roofline = PEAK_BF16_FLOPS / gpt2_flops_per_token(cfg)
            print(f"GPT-2 base bf16 sp=1 {layout} train, device-only: {rate:.2f} tokens/s "
                  f"({seconds / TIMED_STEPS * 1e3:.3f} ms per step of {SP_BATCH} x "
                  f"{cfg.seq_len} tokens); {rate / roofline:.4f} of the {roofline:.0f} tokens/s "
                  f"bf16 roofline; peak memory {peak_gib:.3f} GiB; loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}")
            if zigzag:
                profile_train_step(one_step, SP_KINDS, "GPT-2 base sp=1 zigzag")
            del state, optimizer, scheduler, step_fn, one_step, history
            gc.collect()
            torch.cuda.empty_cache()
        sp_cross_check(model, group, device)
        return launches_of[True]
    finally:
        torch.distributed.destroy_process_group()


def sp_cross_check(model, group, device) -> None:
    """On GPT2_CHECK_BATCH sequences at the same weights: the sp step's loss
    and gradients (K9 forward, the replayed backward) against the ordinary
    GPT-2 step's (K1 causal, K3) and against the sp step on the plain hop
    route, overall and per block; each limit read again with a fault planted
    that must fail it (key positions off by one segment, the skip of fully
    future pairs inverted); then a loss that falls over FIXED_STEPS steps on
    a fixed batch."""
    cfg, module = model.config, model.module
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(GPT2_FIXED_BATCH, cfg.seq_len))).to(device)
    check = tokens[:GPT2_CHECK_BATCH]
    labels = torch.roll(check, -1, dims=1)

    module.train()
    module.zero_grad(set_to_none=True)
    with counting(A, "attention_reference", "packed_mha_reference") as plain_calls:
        launches = (A.fused_mha_packed.launches, A.packed_mha_bwd.launches)
        ordinary_loss = cross_entropy_loss(module(check), labels)
        ordinary_loss.backward()
        if (A.fused_mha_packed.launches - launches[0], A.packed_mha_bwd.launches - launches[1]) \
                != (cfg.n_layers, cfg.n_layers) or plain_calls:
            raise AssertionError("the ordinary GPT-2 step did not go through K1 and K3")
    ordinary = {name: p.grad.float().clone() for name, p in module.named_parameters()}
    module.zero_grad(set_to_none=True)
    sp_loss, kernel = sp_grads(model, group, check, labels)
    with config_set(cfg, attn_impl="plain"):
        plain_loss, plain = sp_grads(model, group, check, labels)

    def reading(loss, grads, ref_loss, ref):
        overall, blocks = grads_rel_l2(grads, ref, cfg.n_layers)
        return abs(loss - ref_loss) / abs(ref_loss), overall, blocks

    checks = {"sp step vs the ordinary step (K1 causal, K3)":
              reading(sp_loss, kernel, ordinary_loss.item(), ordinary),
              "sp step vs the sp step on the plain hop":
              reading(sp_loss, kernel, plain_loss, plain)}
    for label, (loss_rel, overall, blocks) in checks.items():
        print(f"GPT-2 sp cross-check, {GPT2_CHECK_BATCH} sequences, {label}: loss relative "
              f"{loss_rel:.3e}, gradients relative L2 {overall:.3e}; per block "
              + " ".join(f"{r:.2e}" for r in blocks))
        if not all(math.isfinite(r) and r <= GRAD_REL_L2 for r in (loss_rel, overall, *blocks)):
            raise AssertionError(f"the sp step disagrees: {label}")

    real = {name: getattr(SEQ, name) for name in ("hop_state", "hop_vjp", "_fully_future")}

    def shifted(name):
        """The hop (K9 forward, or the backward's replay) reading its key
        positions one segment late."""
        def call(q, qpos, k, v, kpos, *rest, **kw):
            return real[name](q, qpos, k, v, kpos + kpos.numel(), *rest, **kw)
        return call

    faults = {"key positions off by one segment": {"hop_state": shifted("hop_state"),
                                                   "hop_vjp": shifted("hop_vjp")},
              "the skip of fully future pairs inverted": {
                  "_fully_future": lambda kpos, qpos: not real["_fully_future"](kpos, qpos)}}
    readings = {}
    for label, patches in faults.items():
        for name, fault in patches.items():
            setattr(SEQ, name, fault)
        try:
            loss, grads = sp_grads(model, group, check, labels)
        finally:
            for name, fn in real.items():
                setattr(SEQ, name, fn)
        readings[label] = reading(loss, grads, ordinary_loss.item(), ordinary)
    print(f"planted faults in the sp step against the ordinary step (a reading fails the "
          f"limit {GRAD_REL_L2:g} when it exceeds it or is not finite): " + "; ".join(
              f"{k}: loss relative {r[0]:.3e}, gradients relative L2 {r[1]:.3e}"
              for k, r in readings.items()))
    caught = {k: not all(math.isfinite(x) and x <= GRAD_REL_L2 for x in (r[0], r[1], *r[2]))
              for k, r in readings.items()}
    if not all(caught.values()):
        raise AssertionError(f"a planted fault passed the sp cross-check: {caught}")

    optimizer, scheduler = build_optimizer(GPT2_OPTIMIZER, module)
    state = init_train_state(model, optimizer, scheduler)
    step_fn = SEQ.make_sp_train_step(group=group, zigzag=True, grad_clip=GRAD_CLIP)
    fixed_labels = torch.roll(tokens, -1, dims=1)
    losses = [step_fn(state, (tokens, fixed_labels))["loss"] for _ in range(FIXED_STEPS)]
    losses = [loss.item() for loss in losses]
    print(f"GPT-2 sp=1 zigzag fixed batch of {GPT2_FIXED_BATCH}, {FIXED_STEPS} steps at "
          f"constant lr {GPT2_LR}: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the sp fixed-batch loss did not fall: {losses}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    device = torch.device("cuda", 0)
    card_line = card()
    print(card_line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    build_phase()
    vit_shapes = [VIT_SHAPE, *EDGE_SHAPES]
    timing = {"packed_mha_fwd": fwd_phase(device, vit_shapes, False, seed=0, iters=20),
              "packed_mha_bwd": bwd_phase(device, vit_shapes, False, seed=2, iters=20),
              "train_augment": k10_phase(device),
              "packed_mha_fwd:causal": fwd_phase(device, CAUSAL_SHAPES, True, seed=5, iters=10),
              "packed_mha_bwd:causal": bwd_phase(device, CAUSAL_SHAPES, True, seed=6,
                                                 iters=10),
              "flash_fwd": flash_fwd_phase(device, torch.bfloat16, FLASH_BF16, seed=12,
                                           iters=10),
              "flash_bwd": flash_bwd_phase(device, torch.bfloat16, FLASH_BF16, seed=13,
                                           iters=10),
              "flash_fwd:float32": flash_fwd_phase(device, torch.float32, FLASH_FP32,
                                                   seed=14, iters=10),
              "flash_bwd:float32": flash_bwd_phase(device, torch.float32, FLASH_FP32,
                                                   seed=15, iters=10)}
    for i, name in enumerate(GROUPED):
        timing[name] = grouped_phase(device, name, seed=20 + i, iters=10)
    swiglu_y_phase(device, seed=29)
    timing.update(layernorm_phase(device, seed=30, iters=20))
    timing["packed_mha_fwd:masked"] = masked_phase(device, seed=40, iters=20,
                                                   k1_ms=timing["packed_mha_fwd"]["ms"])
    timing["ring_hop"] = ring_hop_phase(device, seed=50, iters=10)
    timing.update(d80_phases(device, SIZES["ViT-H/14"][1]))
    timing.update(k1_d128_phase(device, seed=70, iters=10))
    model, x, _ = slice_phase(device)
    cross_check(model, x)
    del x
    launches, one_step, dataset, _ = train_phase(model, device)
    require_kinds(profile_train_step(one_step, VIT_KINDS, "ViT-B/16"), VIT_KERNEL_KINDS,
                  "ViT-B/16")
    train_cross_check(model, dataset, device)
    del model, one_step
    gc.collect()
    torch.cuda.empty_cache()

    model = build_model(VIT_B16_K6, device=device)
    k6_launches, one_step, _, _ = train_phase(model, device, label="ViT-B/16 with K6")
    require_kinds(profile_train_step(one_step, VIT_K6_KINDS, "ViT-B/16 with K6"),
                  [*VIT_KERNEL_KINDS, "K6 layernorm_fwd", "K6 layernorm_bwd_dx"],
                  "ViT-B/16 with K6")
    k6_train_cross_check(model, dataset, device)
    del model, one_step, dataset
    gc.collect()
    torch.cuda.empty_cache()

    size_launches = {}
    for label in SIZES:
        size_launches[label], dataset = size_phase(device, label)
        gc.collect()
        torch.cuda.empty_cache()
    vit_h_cross_check(device, dataset)
    del dataset
    gc.collect()
    torch.cuda.empty_cache()
    analysis_phase(device)
    gc.collect()
    torch.cuda.empty_cache()
    probing_phase(device)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        data = vit_apps_phase(device, card_line)
        gc.collect()
        torch.cuda.empty_cache()
        plots_phase(card_line, data)
    finally:
        shutil.rmtree(APPS_ROOT, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    gpt2, gpt2_launches, gpt2_step = gpt2_train_phase(device)
    profile_train_step(gpt2_step, GPT2_KINDS, "GPT-2 base")
    gpt2_cross_check(gpt2, device)
    del gpt2, gpt2_step
    gc.collect()
    torch.cuda.empty_cache()

    fp32_launches = gpt2_fp32_phase(device)
    gc.collect()
    torch.cuda.empty_cache()
    llama, llama_launches, llama_step = llama_train_phase(device)
    profile_train_step(llama_step, LLAMA_KINDS, "Llama-1B")
    del llama_step  # the optimizer state
    gc.collect()
    torch.cuda.empty_cache()
    llama_cross_check(llama, device)
    del llama
    gc.collect()
    torch.cuda.empty_cache()

    moe, moe_launches, moe_step = moe_train_phase(device)
    require_kinds(profile_train_step(moe_step, MOE_KINDS, "MoE 8x124m"),
                  [kind for kind in MOE_KINDS if kind.startswith(("K7", "K8"))], "MoE")
    del moe_step  # the optimizer state
    gc.collect()
    torch.cuda.empty_cache()
    moe_cross_check(moe, device)
    del moe
    gc.collect()
    torch.cuda.empty_cache()

    gpt2, masked_launches, greedy = generate_phase(device)
    sampler_check(device)
    serve_cross_check(gpt2, greedy, device)
    server_cross_check(gpt2, device)
    server_phase(gpt2, device)
    del gpt2, greedy
    gc.collect()
    torch.cuda.empty_cache()
    apps_phase(device)
    gc.collect()
    torch.cuda.empty_cache()
    ring_launches = sp_train_phase(device)
    gc.collect()
    torch.cuda.empty_cache()
    l8b_launches = l8b_phase(device, card_line)

    # (name, source file, main path's launch count, TPU kernel it replaces)
    entries = [
        ("packed_mha_fwd", "packed_mha_fwd", launches["fused_mha_packed"],
         "vitef_tpu/ops/attention.py:99"),
        ("packed_mha_bwd", "packed_mha_bwd", launches["packed_mha_bwd"],
         "vitef_tpu/ops/attention.py:270"),
        ("train_augment", "train_augment", launches["augment_train_device"],
         "vitef_tpu/data/images/transforms.py:187"),
        ("packed_mha_fwd:causal", "packed_mha_fwd", gpt2_launches["fused_mha_packed"],
         "vitef_tpu/ops/attention.py:99"),
        ("packed_mha_bwd:causal", "packed_mha_bwd", gpt2_launches["packed_mha_bwd"],
         "vitef_tpu/ops/attention.py:181"),
        ("flash_fwd", "flash_fwd", llama_launches["flash_attention"],
         "vitef_tpu/ops/attention.py:490"),
        ("flash_bwd", "flash_bwd", llama_launches["flash_bwd"],
         "vitef_tpu/ops/attention.py:588"),
        ("flash_fwd:float32", "flash_fwd", fp32_launches["flash_attention"],
         "vitef_tpu/ops/attention.py:490"),
        ("flash_bwd:float32", "flash_bwd", fp32_launches["flash_bwd"],
         "vitef_tpu/ops/attention.py:588"),
        ("gmm", "gmm", moe_launches["gmm"], "vitef_tpu/parallel/moe.py:428"),
        ("gmm_swiglu", "gmm", moe_launches["gmm_swiglu"], "vitef_tpu/ops/gmm_fused.py:94"),
        ("gmm_dy_swiglu", "gmm", moe_launches["gmm_dy_swiglu"],
         "vitef_tpu/ops/gmm_fused.py:177"),
        ("gmm_dual", "gmm", moe_launches["gmm_dual"], "vitef_tpu/ops/gmm_fused.py:370"),
        ("tgmm_swiglu", "tgmm", moe_launches["tgmm_swiglu"], "vitef_tpu/ops/gmm_fused.py:268"),
        ("tgmm", "tgmm", moe_launches["tgmm"], "vitef_tpu/parallel/moe.py:428"),
        ("layernorm_fwd", "layernorm", k6_launches["layer_norm"],
         "vitef_tpu/ops/layernorm.py:54"),
        ("layernorm_bwd_dx", "layernorm", k6_launches["layer_norm_bwd_dx"],
         "vitef_tpu/ops/layernorm.py:69"),
        ("packed_mha_fwd:masked", "packed_mha_fwd", masked_launches,
         "vitef_tpu/ops/attention.py:99"),
        ("ring_hop", "ring_hop", ring_launches, "vitef_tpu/parallel/sequence.py:166"),
        ("packed_mha_fwd:d80", "packed_mha_fwd", size_launches["ViT-H/14"]["fused_mha_packed"],
         "vitef_tpu/ops/attention.py:99"),
        ("packed_mha_bwd:d80", "packed_mha_bwd", size_launches["ViT-H/14"]["packed_mha_bwd"],
         "vitef_tpu/ops/attention.py:270"),
        ("packed_mha_fwd:d128", "packed_mha_fwd", l8b_launches["packed_mha_fwd:d128"],
         "vitef_tpu/ops/attention.py:99"),
        ("packed_mha_fwd:masked:d128", "packed_mha_fwd",
         l8b_launches["packed_mha_fwd:masked:d128"], "vitef_tpu/ops/attention.py:99"),
    ]
    print(card_line)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": f"vitef_tpu_torch/ops/csrc/{source}.cu",
        "replaces": replaces, "launches": count, **timing[name]}
        for name, source, count, replaces in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
