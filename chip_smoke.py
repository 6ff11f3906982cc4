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
   float16 at d = 64 and 128), in each head-width-80 instantiation of K1
   (four modes) and K2/K3 (both passes, both modes), and in each
   head-width-128 one of K1, K2/K3 and K4's and K5's bf16 kernels (none
   fails the run), with any ptxas warning that it serialises wgmma;
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
    recomputed in this process); then ``train_phase``'s protocol with the
    same freeze at 1 x 512 and 2 x 256 (2 warm-up and 5 timed steps each),
    with the peak memory of each and what the command line adds per step;
    last, the linear-probing command line (``probe_impl=torch``) on a second
    set of 5,000 + 1,000 images, started as a subprocess that runs beside 35
    and is waited for after it (exit 0, a test accuracy for each of the 96
    keys; its 96 L-BFGS fits are host-bound, 140-220 s), and its best key's
    accuracy recomputed in this process by the same command line's code
    (within one test image);
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
    surface, for the radius and for each model's bounds, all taken while
    34's linear-probing subprocess shares the card;
36. head width 128 (Llama-3.1-8B: 32 heads over E = 4096): K1 in its four
    modes against its float32 plain version under the bf16 gates, lse
    within 1e-3, bit-identical over two launches: causal at an admission
    (N=1, L=512; timed with the plain version, the bound and SDPA) and at
    L = 1, 16, 17, 64, 65, 129, 257, 512, 577, 578 (N=8), non-causal at
    N=32, L=512 and those lengths, key-masked at the 8B generate prefill
    (N=32, L=512, causal, left-pad lengths 64-512 from default_rng(0);
    timed with SDPA under a boolean mask) and at those lengths, causal and
    not, with empty rows; the wrappers raise NotImplementedError for a
    masked gradient, for d = 96 and for the backward at d = 96, before any
    launch (this runs with the other kernel phases, after 31);
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
    on int8 weights (the first 16 requests). ``python -m vitef_tpu_torch.apps.gpt2.serve run
    --implementation llama --model_name 8b --quantize int8 --demo 16`` runs
    as a process of its own, started before 37's build so that the two
    processes' host draws overlap, and waited for before 37 times anything:
    exit 0, 16 results. The phases' peak memory must stay under 79 GiB;
39. head width 128 for training (with the kernel phases, after 36): K1
    causal timed at the 8B packed route's 8 x 512; K3 (causal) and K2
    (non-causal, no path runs it) at 8 x 512 and at L = 1, 17, 63, 64, 65,
    129, 578 (N=2), K3 at N=2, L=64 against its emulated algebra (its
    largest outputs, up to 5.2, differ from the float32 plain version by
    more than the 2e-2 gate through output rounding); K4 and K5 at 4 x 32 x
    1024 (causal) and at L 1-1000, causal and not (N=2); each as phases 4,
    7 and 14 check them, their wrappers raising for float32 at d = 128;
40. Llama-3.1-8B training (after 30, before 37): the "8b" preset's width
    at 8 layers (2,795.6 M parameters, random weights from seed 0) with
    ``bench_llama``'s protocol (bf16 compute, float32 weights and AdamW
    state, AdamW 3e-4, cosine warmup 100 of 1000, clip 1.0, the fused untied
    head + CE, tokens of ``np.random.default_rng(0)``) on both attention
    routes from the same weights: 8 x 512 (K1 causal and K3 at d = 128, 8
    launches each per step) and 4 x 1024 (K4 and K5), 3 warm-up and 10
    timed steps each, no plain version, a loss that falls; tokens/s, the
    roofline share, the peak memory, a profile of one step; one sequence's
    gradients against the plain path, overall and per block;
41. speculative decoding at batch 1 (after 38, on 37's model: its bf16
    decoding copy, the float32 weights freed): the "1b" preset (Llama-3.2-1B's
    geometry) at full width and depth drafts, random weights from seed 1,
    drawn on the host in a thread beside 37's build; a 256-token prompt of
    default_rng(0), 64 new, gamma 4. Plain batch-1 ``Model.generate`` gives
    the reference stream, its float32 top-2 logit margins and its rate.
    Greedy with the 1b draft and with the target as its own draft, sampled
    at T 0.8 with the self-draft: the greedy streams equal the reference up
    to its first near tie (margin below NEAR_TIE), any divergence printed
    with its margin; the self-draft accepts every proposal but where two
    routes' rounding decides (printed: acceptance exactly 1.0 or not), and
    its cache holds the target's over the committed cells; K1 once per
    layer and model per call (32 at d = 128 and 16 at d = 64 with the 1b
    draft), no plain version; rounds, accepted/drafted, host syncs per
    round, ms per round, tokens/s beside plain generate's. Two planted
    faults must fail those checks: the draft's (gamma + 1)-th K/V write
    skipped (32 new tokens), and the commit pointer one too far (16);
42. the speculative server: ``DecodeServer`` on the 8B with the 1b draft
    (16 slots of 1,024, gamma 4) serves the first 16 of 37's 64 requests
    greedily: every request its max_new_tokens, each stream against the
    plain server's of 37 under the near-tie rule (37's server records its
    margins), K1 once
    per layer and model per admission; spec_rounds, committed tokens per
    round, requests/s, tokens/s beside 37's;
43. the prefix cache on the 8B, 38's int8 weights then bf16: a 256-token
    prefix registered (32 K1 launches), 4 admissions' logits and slot cache
    rows against ``prefill`` of [prefix ++ prompt] within 2e-2 relative L2,
    also with two planted faults that must fail it (the own tokens' RoPE not
    offset by plen; the prefix rows copied one row off); in bf16, 32
    requests of 32-224 own tokens and 16-64 new served under it (no K1: the
    own tokens' attention is plain products), prefill_tokens_saved,
    requests/s, tokens/s beside 37's;
44. the apps, each as a process of its own started beside 37's build:
    ``sample run --model_name medium --draft_model_name base`` (GPT-2 medium
    drafted by GPT-2 base, sampled) and ``serve run --prefix ... --demo
    16``: exit 0, their results and logged stats;
45. MoE decode (last): "8x124m" in bf16, random weights from seed 0:
    ``generate`` for 1 and 32 prompts of 128 tokens, 32 new (batch 1's
    decode steps take the sparse route, K8 ``gmm`` and K7 ``gmm_swiglu`` 12
    each per step; batch 32's prefill is sparse, its decode dense), the
    server with 4 slots under "auto" (dense ticks) and "sparse" (K8 and K7
    at 8 rows over 8 groups), each block's FFN at one routing on the sparse
    route's recorded inputs (a prefill of 4 x 128 and one decode step)
    against the dense oracle within 2e-2; tokens/s. Each of 41-45 prints
    its seconds and peak memory;
46. head width 8 (PatchTST: 16 heads over E = 128; with the kernel phases,
    after 39): K1, K2, K1's causal mode and K3 against their float32 plain
    versions under the bf16 gates at PatchTST-base's training microbatch
    (N = 10,272 series, L = 64; each timed with the plain version, the bound
    and SDPA; K3's dqkv there against its emulated algebra) and at L = 1, 7,
    63, 65, 200, 1000 (N = 8), K1's lse within 1e-3, bit-identical over two
    launches; K1's key-masked mode at those lengths, causal and not; the
    HMMA instructions of each d = 8 instantiation (in 2);
47. PatchTST-base (last but two, after 45): the JAX preset at the
    PatchTST/64 supervised setting (look-back 512, patch 16, stride 8,
    horizon 96) in bf16, random weights from seed 0, 10,272 seeded synthetic
    series (Electricity's 321 channels at batch 32), AdamW 1e-4, MSE and the
    running-stat update: 2 warm-up and 10 timed steps, K1 and K2 at d = 8 3
    launches each per step, K4 and K5 none, no plain version, a loss that
    falls; series/s, peak memory, a profile of one step; forecasts and
    gradients against the plain route (relative L2 5e-2, overall and per
    block), the running statistics after 3 steps of each route within 1e-2,
    eval forecasts that read them and differ from the train-mode ones; then
    the preset's default float32: the plain attention, no K1, a loss that
    falls;
48. remat: ViT-H/14 with ``remat=True`` at the paper's 2 x 256 (4 x 128 if
    it does not fit) through 10's protocol (1 warm-up and 3 timed steps
    each way; K1 twice per block per microbatch, K2 once); peak memory and
    img/s; one microbatch's (128) gradients against the same step without
    remat within relative L2 1e-3;
49. dropout: ViT-B/16 at rate 0.1 on all four sites, one train step of 256
    from a generator: each site's zeroed share within 5σ of 0.1, the same
    seed's masks and loss bit-equal, another seed's masks different, eval
    mode equal to rate 0. Each of 47-49 prints its seconds and peak memory.
50. the mesh (``mesh_phase``): the ViT-B/16 train command line at 2 x 256
    on ``synthetic-2560`` for 4 steps, on one card with no process group,
    then in a process group of ``torch.cuda.device_count()`` NCCL ranks at
    ``dp=-1`` (the data-parallel step) and ``fsdp=true`` (``shard_params``):
    the dp route's logged losses and grad norms bit-equal to the one-card
    run's, the fsdp route's within 1e-3 and its gradients within 5e-2
    relative L2, K10, K1 and K2 at 1, 24 and 24 a step on every route, img/s
    beside the one-card rate; GPT-2 base through ``DecodeServer(mesh=)``
    against the plain server (the same greedy tokens, K1 once per layer an
    admission); with two or more cards, dp = 2 and tp = 2 of both, one
    process a card (``--mesh-train`` and ``--mesh-serve`` run a rank), and
    the command line at dp = 2 with ``fsdp=true``: every rank's K10, K1 and
    K2 at 1, 24 and 24 a step (K1 and K2 at H/tp heads under tp), tp = 2's
    logged losses and grad norms within MESH_LOSS_RTOL and
    MESH_TP_NORM_RTOL of the one-card run's and fsdp's of the dp = 2 run's,
    and every rank's mesh server streams equal to the plain server's up to
    a near tie;
51. pipeline and expert parallelism (``parallel_phase``), in a one-rank
    NCCL group: ViT-B/16 bf16 through ``make_pipeline_train_step`` at pp = 1
    with bench.py's finetune on a device-resident batch of 512 as 2 x 256,
    under GPipe and 1F1B (2 warm-up and 5 timed steps each): K1 and K2 at
    24 a step on both (1F1B's last stage skips the forward phase's dead
    output), losses and grad norms within 1e-3 of ``make_train_step(
    grad_acc_steps=2)``'s on the same weights and batch, one step's
    gradients within 5e-2 relative L2, bit-equality printed, img/s beside
    the one-card step's; each schedule's peak memory at 64 rows a
    microbatch and n_micro 2 and 8 (1F1B's may grow 5% at most); MoE 8x124m
    bf16 through ``make_moe_ep_train_step`` at ep = 1 (capacity factor 2,
    dropless there) with the MoE phase's protocol: K8 gmm 12 and tgmm 24,
    each K7 pass 12, K1 and K3 12 a step, no plain version, losses within
    1e-3 of the sparse ``make_train_step``'s, one step's gradients within
    5e-2 relative L2 (overall and per block, with the share of tokens
    routed to other experts), tokens/s beside the sparse step's. With two
    cards or more, a process a card (``--parallel-rank``): pp = 2 under both
    schedules, ep = 2, the MoE's dense oracle at tp = 2 and GPT-2 base at
    sp = 2 (zigzag, K9 5 a layer), and with four pp = 4 under both
    schedules, (dp, pp) = (2, 2) and (dp, ep) = (2, 2): every rank's launches, losses within 1e-3 and grad
    norms within 1e-2 of the one-card runs'.

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
import socket
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
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
from vitef_tpu_torch.models.llama import LlamaConfig, llama_transformer_config
from vitef_tpu_torch.models import transformer as TR
from vitef_tpu_torch.models.transformer import Transformer
from vitef_tpu_torch.models.vit import ViTConfig, vit_transformer_config
from vitef_tpu_torch.models import generation as GEN
from vitef_tpu_torch.models import quantize as Q
from vitef_tpu_torch.models import serving as SRV
from vitef_tpu_torch.models import speculative as SPEC
from vitef_tpu_torch.models.norms import LayerNorm, batch_norm_sites
from vitef_tpu_torch.ops import _build
from vitef_tpu_torch.ops import attention as A
from vitef_tpu_torch.ops import layernorm as LN
from vitef_tpu_torch.ops import gmm as G
from vitef_tpu_torch.ops import gmm_fused as GF
from vitef_tpu_torch.ops import make_fused_head_loss, next_token_cross_entropy
from vitef_tpu_torch.optim import build_optimizer, build_scheduler
from vitef_tpu_torch.ops import ring_hop as RH
from vitef_tpu_torch.tools import distill_spec_pair as DSP
from vitef_tpu_torch.tools import profile_speculative as PSP
from vitef_tpu_torch import parallel as PAR
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
# modes at head width 8 (PatchTST) and at 80 (ViT-H/14), K1's four modes, K2/K3's two passes and
# K4's and K5's bf16 kernels in both modes at 128 (Llama-3.1-8B), the
# float32 kernels whose products are
# TF32 HMMA instructions (K4's and K5's at head widths 8, 64 and 128, each
# in both modes), the TMA +
# wgmma kernels, whose products are HGMMA: csrc/gmm.cu's in kPlain (K8
# gmm), kSwigluIn (K7 gmm_swiglu), kSwigluBwdOut (K7 gmm_dy_swiglu) and
# kDual (K7 gmm_dual) and csrc/tgmm.cu's in kPlain (K8 tgmm) and kSwigluIn
# (K7 tgmm_swiglu), each at both column tiles, and K9 in each (type, d) of
# bf16, float16 x 64, 128.
TENSOR_CORE_LIBS = ("packed_mha_fwd", "packed_mha_bwd", "flash_fwd", "flash_bwd", "ring_hop")
SASS_KERNELS = [("packed_mha_fwd", "packed_mha_fwd_kernel<8,", "HMMA", "HMMA", 4),
                ("packed_mha_bwd", "packed_bwd_dq_kernel<8,", "HMMA", "HMMA", 2),
                ("packed_mha_bwd", "packed_bwd_dkv_kernel<8,", "HMMA", "HMMA", 2),
                ("packed_mha_fwd", "packed_mha_fwd_kernel<80,", "HMMA", "HMMA", 4),
                ("packed_mha_fwd", "packed_mha_fwd_kernel<128,", "HMMA", "HMMA", 4),
                ("packed_mha_bwd", "packed_bwd_dq_kernel<80,", "HMMA", "HMMA", 2),
                ("packed_mha_bwd", "packed_bwd_dkv_kernel<80,", "HMMA", "HMMA", 2),
                ("packed_mha_bwd", "packed_bwd_dq_kernel<128,", "HMMA", "HMMA", 2),
                ("packed_mha_bwd", "packed_bwd_dkv_kernel<128,", "HMMA", "HMMA", 2),
                ("flash_fwd", "flash_fwd_bf16_kernel<128,", "HMMA", "HMMA", 2),
                ("flash_bwd", "flash_bwd_dq_kernel<128,", "HMMA", "HMMA", 2),
                ("flash_bwd", "flash_bwd_dkv_kernel<128,", "HMMA", "HMMA", 2),
                ("flash_fwd", "flash_fwd_tf32_kernel<8,", "HMMA", "TF32", 2),
                ("flash_bwd", "flash_bwd_dq_tf32_kernel<8,", "HMMA", "TF32", 2),
                ("flash_bwd", "flash_bwd_dkv_tf32_kernel<8,", "HMMA", "TF32", 2),
                ("flash_fwd", "flash_fwd_tf32_kernel<64,", "HMMA", "TF32", 2),
                ("flash_bwd", "flash_bwd_dq_tf32_kernel<64,", "HMMA", "TF32", 2),
                ("flash_bwd", "flash_bwd_dkv_tf32_kernel<64,", "HMMA", "TF32", 2),
                ("flash_fwd", "flash_fwd_tf32_kernel<128,", "HMMA", "TF32", 2),
                ("flash_bwd", "flash_bwd_dq_tf32_kernel<128,", "HMMA", "TF32", 2),
                ("flash_bwd", "flash_bwd_dkv_tf32_kernel<128,", "HMMA", "TF32", 2),
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
# A non-square source with a side over size (N, (H, W), size): the JAX
# package's XLA path, the antialiased resize (no K10 launch), on the card
# against the same function on the CPU in float32: the same float32 weights,
# products summed in another order (~1e-6 seen on the CPU against the JAX
# package), so 100x that; the two-tap map must differ by more than 1.0 there,
# so the batch truly downscales.
K10_NON_SQUARE, K10_NON_SQUARE_MAX = (64, (300, 200), 224), 1e-4

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
# PatchTST-base's attention (vitef_tpu/models/patchtst.py): 16 heads of
# width 8 over E = 128, L = 64 patches of a 512-step look-back (patch 16,
# stride 8), at the PatchTST/64 supervised setting's batch of 32 windows of
# Electricity's 321 channels, each channel a series of its own (N = 10,272).
# K1, K2, K3 and K1's causal and masked modes at d = 8 at that shape and at
# these lengths.
PATCHTST_HEADS, PATCHTST_SHAPE = (16, 128), (32 * 321, 64)
D8_EDGE_LENGTHS = (1, 7, 63, 65, 200, 1000)
# PatchTST-base's training at that setting (the JAX preset's sizes and fixed
# arguments, vitef_tpu/models/patchtst.py:21-81): bf16 compute, AdamW at the
# paper's lr 1e-4, MSE, the running-stat update. 2 warm-up and 10 timed
# steps; the cross-check's runs take 3 steps each, the float32 run 5.
PATCHTST = {"implementation": "patchtst", "model_name": "base", "length": 512,
            "patch_size": 16, "stride": 8, "forecasting_horizon": 96,
            "compute_dtype": "bfloat16", "seed": 0}
PATCHTST_OPTIMIZER = {"optimizer": "adamw", "lr": 1e-4}
PATCHTST_WARMUP, PATCHTST_TIMED, PATCHTST_CHECK_STEPS, PATCHTST_FP32_STEPS = 2, 10, 3, 5
# Running statistics after the cross-check's steps, kernel vs plain route:
# batch means and variances of bf16 activations over 657,408 rows, each
# step's rounding ~2^-9 relative.
PATCHTST_STATS_REL = 1e-2
# remat recomputes the same bf16 forward: the gradients of the two steps
# differ only by the order of their float32 sums.
REMAT_REL_L2, REMAT_TIMED = 1e-3, 3
DROPOUT_RATE = 0.1
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
# float32 at head width 8: PatchTST-base's attention at its float32 default
# under attn_impl="pallas" (N = 10,272 series, 16 heads, L = 64, non-causal;
# timed), then edge lengths, causal and not. At head width 128: no preset
# takes it (float32 GQA/RoPE attention is the plain grouped einsum in both
# packages), so it is timed alone at the 8B flash route's 4 x 32 heads x
# 1024, causal, then at edge lengths.
FLASH_FP32_D8 = [(PATCHTST_SHAPE[0], PATCHTST_HEADS[0], PATCHTST_SHAPE[1], False)] + [
    (2, 16, l, causal) for l in (1, 7, 63, 65, 200, 1000) for causal in (True, False)]
FLASH_FP32_D128 = [(4, 32, 1024, True)] + [(2, 8, l, causal)
                                           for l in (1, 17, 63, 65, 200, 1000)
                                           for causal in (True, False)]

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
APPS_SPLIT_TIMED = 5      # steps timed at 1 x 512 and at 2 x 256
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
# Llama-3.1-8B training (bench_llama's protocol at the preset's width, depth
# cut to L8B_TRAIN_LAYERS: 2,795.6 M parameters, whose float32 weights,
# gradients and AdamW moments take 41.7 GiB) on both attention routes: the
# packed one at 8 x 512 (inside the gate: K1 causal, K3) and the flash one
# at bench_llama's 4 x 1024 (K4, K5). K2, K3, K4 and K5 at d = 128 first, at
# those shapes and at edge lengths; K2 (non-causal, no path runs it at this
# width) at the packed shape too.
L8B_TRAIN_LAYERS, L8B_WARMUP = 8, 3
L8B_PACKED, L8B_FLASH = (8, 512), (4, 1024)
L8B_BWD_LENGTHS = (1, 17, 63, 64, 65, 129, 578)
# K3 d = 128 at N = 2, L = 64 read max |d| 2.027e-2 against the float32
# plain version, past the 2e-2 gate, as K3 d = 80 did at ViT-H/14's
# microbatch: its largest outputs (up to 5.20) lie in [4, 8), where rounding
# the output to bf16 alone moves a value by up to 1.56e-2, and against the
# emulated algebra (P and dS rounded to bf16) it reads 2.6e-3 past half an
# ulp. That shape is held to the emulated algebra instead.
L8B_K3_EMULATED = ((2, 64),)
FLASH_D128 = [(4, 32, 1024, True)] + [(2, 32, l, causal)
                                      for l in (1, 16, 63, 64, 65, 127, 129, 1000)
                                      for causal in (True, False)]
# generate: 32 prompts of 64-512 tokens (lengths from default_rng(0)),
# left-padded to 512, 64 new tokens, greedy and top-k 40 at T 0.8.
L8B_BATCH, L8B_PROMPT, L8B_NEW = 32, 512, 64
# the server: 64 requests (prompts 32-480, 16-128 new tokens, default_rng(0))
# through 16 slots of 1024 positions, bucket 64.
L8B_REQUESTS = 64
L8B_SERVER = {"n_slots": 16, "max_len": 1024, "bucket": 64}
# the server on int8 weights: the first 16 of those requests (all 64 took
# 23-27 s of the script's time limit).
L8B_INT8_REQUESTS = 16
# int8 weights against a bf16 model holding their dequantized values: the
# power-of-two scales commute with the sums and int8 x 2^k is exact in bf16,
# so the two differ where bf16 rounds outputs of other sums (the scale is
# applied to the float32 sum before its rounding, not after); held to the
# serving checks' bound.
L8B_SERVE_ARGV = ["run", "--implementation", "llama", "--model_name", "8b", "--quantize",
                  "int8", "--demo", "16"]
# Speculative decoding on Llama-3.1-8B (phases 41-42): the "1b" preset
# (Llama-3.2-1B's geometry: E = 2048, 32 heads of 64, 8 KV heads, 16 layers,
# FFN 8192, V = 128,256) drafts at full width and depth, random weights from
# seed 1, bf16, seq_len 1024. Batch 1: a prompt of 256 tokens from
# default_rng(0), 64 new (128 until the mesh phase was added: the 1b-draft
# run alone took 24 s of the script's 1,200 s limit), gamma 4, greedy and
# sampled at T 0.8; the planted faults' runs take 32 (the skipped draft
# write, with the self-draft) and 16 new tokens (the commit pointer, with
# the 1b draft).
LLAMA_1B_DRAFT = {**LLAMA_1B, "seed": 1}
SPEC_PROMPT, SPEC_NEW, SPEC_GAMMA, SPEC_TEMPERATURE = 256, 64, 4, 0.8
SPEC_FAULT_NEW = 16
# The speculative server serves the first 16 of phase 37's 64 requests: at
# random weights the 1b draft's proposals are rejected (acceptance ~0), so
# a round commits one token a slot at 5 draft steps and a window of host
# time (140-210 ms on the card), and all 64 took 47 s of the script's
# 1,200 s limit (H100 80GB HBM3, 700 W). Fewer requests save nothing: 8
# took 29.4 s against 16's 26.3 s, the rounds set by the longest stream.
SPEC_SERVER_REQUESTS = 16
# Each of them cut to its first SPEC_SERVER_NEW new tokens (up to 128 took
# 26.3 s; phase 53's trained pair carries the server's acceptance and rate,
# this phase keeps the 8B's checks at a quarter of the rounds).
SPEC_SERVER_NEW = 32
# The near-tie rule for greedy streams of two bf16 routes (a verify window
# and one-token steps, or two servers): they round at different places, so
# an argmax may flip where the reference's float32 top-2 logit margin is
# within their rounding (logits of relative L2 ~1e-2 apart at |logit| ~1,
# phase 37's cross-checks). Two streams pass when they are equal up to the
# first position where the reference's margin is below NEAR_TIE.
NEAR_TIE = 5e-2
# The prefix cache on the 8B (phase 43): a 256-token prefix, then 32
# requests of 32-224 own tokens and 16-64 new (default_rng(0)) through the
# 8B server's slots.
PREFIX_LEN, PREFIX_REQUESTS = 256, 32
# The apps (phase 44), each as a process of its own: GPT-2 medium drafted by
# GPT-2 base (sampled, T 0.8), and GPT-2 base serving 16 requests under a
# shared prefix.
SPEC_SAMPLE_ARGV = ["run", "--model_name", "medium", "--draft_model_name", "base",
                    "--token_ids", "[464, 3280, 318, 262, 3139]", "--max_new_tokens", "32"]
PREFIX_SERVE_ARGV = ["run", "--prefix", "464,3280,318,262,3139,286,1204,318", "--demo", "16",
                     "--n_slots", "4"]
# MoE decode (phase 45): "8x124m" in bf16, random weights from seed 0;
# prompts of 128 tokens (default_rng(0)), 32 new, batch 1 and 32; the server
# with 4 slots of 256 over 16 requests (prompts 32-128, 16-48 new).
# Phase 53, the trained speculative pair: vitef_tpu_torch.tools.distill_spec_pair
# at its defaults (a GPT-2-small target, 300 steps of 16 x 256 Markov tokens;
# a 2-layer draft distilled for 600), then the profile's rows at --trained
# (64-token prompt over the chain's 2,048 ids, 128 new) and the speculative
# server against the plain one on SPEC_PAIR_REQUESTS requests whose prompts
# are the chain's (markov_batches seed 3; prompts 32-128 tokens, 32-128 new,
# default_rng(3)). Per step: K1 causal and K3 once a target layer; K1 once a
# target and a draft layer and K3 once a draft layer a distillation step.
SPEC_PAIR_REQUESTS = 16
SPEC_PAIR_SERVER = {"n_slots": 16, "max_len": 512, "bucket": 64}
MOE_SERVE_PROMPT, MOE_SERVE_NEW, MOE_SERVE_BATCHES = 128, 32, (1, 32)
MOE_SERVER = {"n_slots": 4, "max_len": 256, "bucket": 64}
MOE_SERVER_REQUESTS = 16

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


SASS = {}  # cuobjdump -sass of each library, read once by build_phase


def read_sass(libs) -> None:
    """``cuobjdump -sass`` of each ``lib<lib>.so``, one process each, all
    started together, into SASS."""
    procs = {lib: subprocess.Popen([_build.cuda_tool("cuobjdump"), "-sass",
                                    str(_build.BUILD_DIR / f"lib{lib}.so")],
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for lib in libs}
    for lib, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        if proc.returncode != 0:
            raise RuntimeError(f"cuobjdump -sass lib{lib}.so failed: {err[-2000:]}")
        SASS[lib] = out


def sass_ops(lib: str, opcode: str = "HMMA") -> dict[str, list[str]]:
    """The instructions of each kernel in ``lib<lib>.so`` whose text holds
    ``opcode`` (HMMA: mma.sync on the tensor cores; HGMMA: wgmma), as
    ``cuobjdump -sass`` prints them (``read_sass``), by the kernel's
    mangled name."""
    sass = SASS[lib]
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
    t0 = time.perf_counter()
    read_sass(sorted({*TENSOR_CORE_LIBS, *(lib for lib, *_ in SASS_KERNELS)}))
    print(f"read the SASS of {len(SASS)} libraries in {time.perf_counter() - t0:.2f} s "
          f"(parallel cuobjdump)")
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
              heads: tuple[int, int] = (N_HEADS, EMB), emulated=()) -> dict:
    """The backward (K2, or K3 when causal), through the autograd path that
    the train step takes, against the float32 plain backward on the same bf16
    inputs at every (N, L) of ``shapes``, bit-identical over two launches;
    then timed at the first of them (the main path's shape, whose error is
    the one returned) with the plain version and SDPA's backward. ``heads``
    as in fwd_phase. The shapes of ``emulated`` hold dqkv's largest error to
    the emulated algebra (``emulated_over``) instead of the absolute gate,
    whose other limits (mean, db) they keep."""
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
        ref_max = ref_dqkv.abs().max().item()
        del ref_dqkv, diff
        identical = torch.equal(dqkv, again[0]) and torch.equal(db, again[1])
        print(f"{label} packed_mha_bwd N={n} L={l}: dqkv max|d|={max_abs:.3e} "
              f"mean|d|={mean_abs:.3e}; db max|d|={db_max:.3e} (max|db|={db_scale:.3f}); "
              f"two launches bit-identical: {identical}")
        max_ok = max_abs <= KERNEL_MAX_ABS
        if (n, l) in emulated:
            over = emulated_over(dqkv, qkv, bias, g, h, causal)
            print(f"{label} N={n} L={l} against the emulated algebra (P, dS in bf16): "
                  f"max(|d| - half ulp)={over:.3e} (limit {EMULATED_ABS}; max|dqkv| "
                  f"{ref_max:.3f}; the gate's {KERNEL_MAX_ABS} does not hold this shape)")
            max_ok = over <= EMULATED_ABS
        if not (tuple(dqkv.shape) == (n, l, 3 * e) and db.dtype == bias.dtype
                and math.isfinite(max_abs) and max_ok
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
    # ViT-B/16's E, 32 at ViT-H/14's, 256 at Llama-3.1-8B's, 4 at PatchTST's
    bad_h = next(c for c in (16, 10, 40, 32)
                 if e % c == 0 and e // c not in A._PACKED_BWD_HEAD_DIMS)
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


def flash_inputs(gen, n: int, h: int, l: int, dtype, device, d: int = 64):
    """q, k, v (scale 0.5, as the packed phases draw qkv) and a cotangent g,
    (N, h, L, d) in ``dtype`` on ``device``."""
    shape = (n, h, l, d)
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


def flash_fwd_phase(device, dtype, cases, seed: int, iters: int, d: int = 64) -> dict:
    """K4 against its float32 plain version (``attention_reference``) on the
    same inputs at every (N, h, L, causal) of ``cases`` at head width ``d``,
    its lse against the plain scores' and bit-identical over two launches;
    then timed at the first of them (the main path's shape, whose error is
    the one returned) with the plain version and SDPA."""
    gen = torch.Generator().manual_seed(seed)
    max_lim, mean_lim, _ = flash_limits(dtype)
    label = f"K4 flash_fwd {str(dtype).removeprefix('torch.')}" + ("" if d == 64 else f" d={d}")
    for n, h, l, causal in cases:
        q, k, v, _ = flash_inputs(gen, n, h, l, dtype, device, d)
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
    flops = flash_flops(n, h, l, d, 2, causal)
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


def flash_bwd_phase(device, dtype, cases, seed: int, iters: int, d: int = 64) -> dict:
    """K5, through the autograd path that the train step takes, against its
    float32 plain version (``flash_bwd_reference``) on the same inputs at
    every (N, h, L, causal) of ``cases`` at head width ``d``, bit-identical
    over two launches; what its wrapper does not take raises (float16, d =
    32 and float32 at d = 80); then timed at the first case (the main
    path's shape, whose error is the one returned) with the plain version
    and SDPA's backward."""
    gen = torch.Generator().manual_seed(seed)
    max_lim, mean_lim, _ = flash_limits(dtype)
    label = f"K5 flash_bwd {str(dtype).removeprefix('torch.')}" + ("" if d == 64 else f" d={d}")
    for n, h, l, causal in cases:
        q, k, v, g = flash_inputs(gen, n, h, l, dtype, device, d)
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
    narrow = [t.new_zeros((n, h, l, 32)) for t in (q, k, v, g, out)]
    d80 = [t.new_zeros((n, h, l, 80), dtype=torch.float32) for t in (q, k, v, g, out)]
    refused = [(TypeError, lambda: A.flash_bwd(*(t.half() for t in (q, k, v, g, out)), lse)),
               (NotImplementedError, lambda: A.flash_bwd(*narrow, lse)),
               (TypeError, lambda: A.flash_attention(q.half(), k.half(), v.half(),
                                                     impl="kernel")),
               (NotImplementedError, lambda: A.flash_attention(*narrow[:3], impl="kernel")),
               (NotImplementedError, lambda: A.flash_bwd(*d80, lse)),
               (NotImplementedError, lambda: A.flash_attention(*d80[:3], impl="kernel"))]
    launches = (A.flash_attention.launches, A.flash_bwd.launches)
    for error, call in refused:
        try:
            call()
        except error:
            continue
        raise AssertionError(f"{label}'s wrappers did not raise {error.__name__}")
    if (A.flash_attention.launches, A.flash_bwd.launches) != launches:
        raise AssertionError(f"{label}'s wrappers launched on an input they do not take")
    print(f"{label}: K4's and K5's wrappers raise for float16 input, head width 32 and "
          "float32 at head width 80")

    ms, plain_ms, times = in_turns(
        lambda: backward(g),
        lambda: A.flash_bwd_reference(q, k, v, g, causal=causal), iters)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    library_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True),
                         iters)
    del sdpa_out, leaves
    grads = backward(g)
    flops = flash_flops(n, h, l, d, 5, causal)
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
    cases = {"size 2641, past the limit of 2640": (NotImplementedError, raw(32, 32), 2641,
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


def k10_non_square(device) -> None:
    """K10_NON_SQUARE's batch on the card: the antialiased resize, with no
    K10 launch, against the CPU route on the same inputs, and the two-tap
    map's distance from it."""
    n, (h, w), size = K10_NON_SQUARE
    rng = np.random.default_rng(19)
    raw = rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)
    boxes, flips = T.sample_crop_batch(rng, n, h, w)
    boxes[0] = (0, 0, h, w)  # the whole image: its rows downscale
    host = [torch.from_numpy(a) for a in (raw, boxes, flips)]
    launches = T.augment_train_device.launches
    out = T.augment_train_device(*(t.to(device) for t in host), size=size)
    torch.cuda.synchronize()
    launched = T.augment_train_device.launches - launches
    ref = T.augment_train_device(*host, size=size)
    err = (out.cpu() - ref).abs().max().item()
    two_tap = (T.augment_train_reference(*host, size) - ref).abs().max().item()
    print(f"K10's route at N={n} {h}x{w}->{size} (non-square, a side over size): the "
          f"antialiased resize on the card against the CPU route max|d|={err:.3e} (limit "
          f"{K10_NON_SQUARE_MAX}); the two-tap map off it by {two_tap:.3f}; K10 launches "
          f"{launched}")
    if not (tuple(out.shape) == (n, 3, size, size) and err <= K10_NON_SQUARE_MAX
            and two_tap > 1.0 and launched == 0):
        raise AssertionError("the non-square antialiased resize is off on the card")


def k10_phase(device) -> dict:
    """K10's plan held to the wrapper's; K10 against its float32 plain
    version in bf16 and float32 at the main shape (batch 512, 32x32 -> 224)
    and at K10_CASES, bit-identical over two launches, the wrapper's
    refusals, boxes past their image, the non-square route that downscales
    (``k10_non_square``); timed in turns with the plain version
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
    k10_non_square(device)
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
    # remat recomputes each block's forward in the backward: K1 twice
    want_k1 = want * (2 if model.config.remat else 1)
    # every LayerNorm of every microbatch, forward and dx, when K6 is asked for
    k6 = model.config.norm_impl in ("kernel", "pallas")
    want_k6 = (sum(isinstance(m, LayerNorm) for m in model.module.modules()) * grad_acc
               * timed if k6 else 0)
    print(f"{label} train launches over {timed} steps: {launches} (K1 wants {want_k1}, K2 "
          f"{want}, K10 {timed}, K6 forward and dx {want_k6}); plain calls "
          f"{dict(Counter(plain_calls + aug_calls + (ln_plain if k6 else [])))}")
    if launches["fused_mha_packed"] != want_k1 or launches["packed_mha_bwd"] != want \
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


def emulated_over(dqkv, qkv, bias, g, n_heads: int, causal: bool) -> float:
    """The kernel's dqkv against ``bwd_emulated``: the largest |d| less half
    a bf16 ulp of the emulated value (the output's own rounding)."""
    with torch.no_grad():
        emu = bwd_emulated(qkv, bias, g, n_heads, causal)
    return ((dqkv.float() - emu).abs() - emu.abs() * 2.0 ** -8).max().item()


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
    over = emulated_over(dqkv, qkv, bias, g, h, True)
    with torch.no_grad():
        ref = A.packed_mha_bwd_reference(qkv.float(), bias.float(), g.float(), h,
                                         causal=True)[0]
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


def d8_phases(device) -> dict:
    """K1, K2, K1's causal and key-masked modes and K3 at head width 8
    (PatchTST's 16 heads over E = 128), each against its float32 plain
    version under the bf16 gates, with lse and determinism checks, at
    PatchTST-base's training microbatch (N = 10,272 series, L = 64 patches;
    timed with the plain version, its bound and SDPA; K3's dqkv there against
    its emulated algebra) and at N = 8 and D8_EDGE_LENGTHS; the masked mode
    at those lengths, causal and not.
    Returns the timing rows by name."""
    shapes = [PATCHTST_SHAPE] + [(8, l) for l in D8_EDGE_LENGTHS]
    timing = {}
    for causal, fwd_seed, bwd_seed in ((False, 80, 81), (True, 82, 83)):
        mode = ":causal" if causal else ""
        timing[f"packed_mha_fwd{mode}:d8"] = fwd_phase(device, shapes, causal, seed=fwd_seed,
                                                       iters=10, heads=PATCHTST_HEADS)
        # K3's largest gradients (the first keys' dV, summed over every later
        # row) lie past 8, where half a bf16 ulp of the output is 1.56e-2:
        # at the main shape its dqkv is held to the emulated algebra, as at
        # d = 80.
        timing[f"packed_mha_bwd{mode}:d8"] = bwd_phase(
            device, shapes, causal, seed=bwd_seed, iters=10, heads=PATCHTST_HEADS,
            emulated=(PATCHTST_SHAPE,) if causal else ())
    masked_cases(device, torch.Generator().manual_seed(84),
                 [(8, l, causal, edge_lengths(l)) for l in D8_EDGE_LENGTHS
                  for causal in (True, False)], heads=PATCHTST_HEADS)
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
PATCHTST_KINDS = {"K1 packed_mha_fwd": ("packed_mha_fwd",),
                  "K2 packed_mha_bwd": PACKED_BWD_KERNELS,
                  "cuBLAS GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90_"),
                  "optimizer (foreach / AdamW)": ("multi_tensor", "foreach")}
GPT2_KINDS = {"K1 packed_mha_fwd (causal)": ("packed_mha_fwd",),
              "K3 packed_mha_bwd (causal)": PACKED_BWD_KERNELS,
              "cuBLAS GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90_"),
              "optimizer (foreach / AdamW)": ("multi_tensor", "foreach")}


# torch.profiler (torch 2.11 on an H100) drops the first device activities
# of a trace, more the more traces the process has taken: from the third
# trace of one ViT-B/16 step on, its host-to-device copies and then K10 were
# missing, whatever the host waited before the step, and the 8B decode
# step's trace, late in the run, lost 52 and in another run all 64 of 64. So
# each trace opens with marker kernels (torch.cuda._sleep's spin_kernel)
# that every reading leaves out; the count that survives says how many
# activities were dropped. A trace that keeps none of them may have lost
# the traced work's start too: ``traced`` takes it again with
# TRACE_MARKER_GROWTH times the markers, up to TRACE_ATTEMPTS times.
TRACE_MARKERS, MARKER_KERNEL = 256, "spin_kernel"
TRACE_MARKER_GROWTH, TRACE_ATTEMPTS = 4, 3


@contextlib.contextmanager
def device_trace(markers: int = TRACE_MARKERS):
    """torch.profiler over the CPU and the device, opened by ``markers``
    marker kernels; yields the profile."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(markers):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        yield prof


def traced(work) -> tuple[list, str, float]:
    """``work()`` under ``device_trace``: (its device events without the
    markers, how many markers were dropped as "k of n", the host wall ms of
    the call). Takes the trace again, with more markers, while it keeps none
    of them, and raises if the last attempt keeps none either."""
    markers = TRACE_MARKERS
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with device_trace(markers) as prof:
            t0 = time.perf_counter()
            work()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events() if e.device_type.name == "CUDA"]
        kept = sum(MARKER_KERNEL in e.name for e in events)
        if kept:
            return ([e for e in events if MARKER_KERNEL not in e.name],
                    f"{markers - kept} of {markers}", wall_ms)
        print(f"trace attempt {attempt} dropped all {markers} marker kernels")
        markers *= TRACE_MARKER_GROWTH
    raise AssertionError(f"{TRACE_ATTEMPTS} traces each dropped all their marker kernels")


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
    events, dropped, wall_ms = traced(one_step)
    totals = dict.fromkeys([*kinds, "elementwise and other"], 0.0)
    counts = Counter()
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
          f"events, {dropped} marker kernels dropped")
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


def llama_flops_per_token(cfg, seq: int | None = None) -> float:
    """Train FLOPs per token, 3x the forward's: ``tools/bench_models.py``'s
    ``llama_flops`` (:124-129: GQA qkv, out, three swiglu products, the
    causal half of attention, the untied head) over ``seq`` (by default
    seq_len)."""
    e, seq = cfg.emb_dim, seq or cfg.seq_len
    per_tok = cfg.n_layers * (e * (e + 2 * cfg.kv_dim) + e * e + 3 * e * cfg.ffn_dim
                              + 2 * (seq // 2) * e) + e * cfg.vocab_size
    return 3 * 2 * per_tok


LLAMA_KINDS = {"K4 flash_fwd (causal)": ("flash_fwd",),
               "K5 flash_bwd (causal)": ("flash_bwd_dq", "flash_bwd_dkv"),
               "cuBLAS GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90_"),
               "optimizer (foreach / AdamW)": ("multi_tensor", "foreach")}
LLAMA_PACKED_KINDS = {"K1 packed_mha_fwd (causal)": ("packed_mha_fwd",),
                      "K3 packed_mha_bwd (causal)": PACKED_BWD_KERNELS,
                      **{kind: keys for kind, keys in LLAMA_KINDS.items()
                         if not kind.startswith(("K4", "K5"))}}
ROUTE_KERNELS = {"packed": "K1 and K3", "flash": "K4 and K5"}


def llama_train_phase(device):
    """``bench_llama(batch=4, size="1b")``'s protocol through the port: K4
    forward and K5 backward in every layer, fused untied head + CE, clip,
    AdamW, cosine schedule. Returns the model, the main path's launch counts
    and a device-only step."""
    t0 = time.perf_counter()
    model = build_model(LLAMA_1B, device=device)
    n_params = sum(p.numel() for p in model.module.parameters())
    print(f"Llama-1B: {n_params:,} parameters, built in {time.perf_counter() - t0:.2f} s")
    launches, one_step = llama_steps(model, device, (LLAMA_BATCH, model.config.seq_len),
                                     LLAMA_WARMUP, "Llama-1B", "flash")
    return model, launches, one_step


def bench_llama_step(model, device, shape: tuple[int, int], mesh=None):
    """``bench_llama``'s step on a Llama ``model`` (AdamW 3e-4, cosine
    schedule with warmup 100 over 1,000 steps, clip 1.0, the fused untied
    head + CE) over a (N, L) ``shape`` of tokens from default_rng(0) (on a
    ``mesh``, this rank's rows of them): ``(state, one_step)``."""
    cfg = model.config
    schedule = build_scheduler(SCHEDULER, n_steps=TRAIN_STEPS)
    optimizer, scheduler = build_optimizer(GPT2_OPTIMIZER, model.module, schedule=schedule)
    step_fn = make_train_step(schedule=schedule, base_lr=GPT2_LR, grad_clip=GRAD_CLIP,
                              hidden_loss=make_fused_head_loss(cfg))
    state = init_train_state(model, optimizer, scheduler)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=shape)).to(device)
    if mesh is not None:
        (tokens,) = PAR.shard_batch((tokens,), mesh)

    def one_step():
        return step_fn(state, (tokens, tokens))

    return state, one_step


def llama_steps(model, device, shape: tuple[int, int], warmup: int, label: str,
                route: str):
    """``bench_llama``'s step on a Llama ``model`` (AdamW 3e-4, cosine
    schedule with warmup 100 over 1,000 steps, clip 1.0, the fused untied
    head + CE) over a (N, L) ``shape`` of tokens from default_rng(0):
    ``warmup`` steps, then TIMED_STEPS timed ones in which every layer must
    take the attention ``route`` ("packed": K1 and K3; "flash": K4 and K5)
    and no plain version may run; a finite loss that falls, the grad norm
    and the lr; tokens/s and the share of the bf16 roofline at L; the peak
    memory. Returns the launch counts and a device-only step."""
    cfg = model.config
    n, l = shape
    state, one_step = bench_llama_step(model, device, shape)
    history = [(state.step, one_step()) for _ in range(warmup)]
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
            raise AssertionError(f"{label} step {step}: loss {loss}, grad_norm {norm}, lr {lr} "
                                 f"(want {want_lr})")
        losses.append(loss)
    print(f"{label} train steps {history[0][0]}..{history[-1][0]}: loss "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; grad_norm {history[-1][1]['grad_norm'].item():.4f}, "
          f"lr {history[-1][1]['lr']:.8f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the {label} loss did not fall: {losses}")
    want = cfg.n_layers * TIMED_STEPS
    pair = ("fused_mha_packed", "packed_mha_bwd") if route == "packed" else \
        ("flash_attention", "flash_bwd")
    print(f"{label} train launches over {TIMED_STEPS} steps: {launches} ({ROUTE_KERNELS[route]} "
          f"want {want}, the other pair 0); plain calls {dict(Counter(plain_calls + aug_calls))}")
    if launches != {name: want if name in pair else 0 for name in launches}:
        raise AssertionError(f"the {label} train path did not go through "
                             f"{ROUTE_KERNELS[route]} every layer")
    if plain_calls or aug_calls:
        raise AssertionError(f"plain versions ran on CUDA: {Counter(plain_calls + aug_calls)}")
    flops = llama_flops_per_token(cfg, l)
    rate = n * l * TIMED_STEPS / seconds
    roofline = PEAK_BF16_FLOPS / flops
    print(f"{label} bf16 train, device-only: {rate:.2f} tokens/s "
          f"({seconds / TIMED_STEPS * 1e3:.3f} ms per step of {n} x {l} tokens, one "
          f"microbatch); {rate / roofline:.4f} of the {roofline:.0f} tokens/s bf16 roofline "
          f"({flops / 1e9:.3f} GFLOP per token); peak memory {peak_gib:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    return launches, one_step


def llama_grads_check(model, device, label: str, seq: int):
    """The gradients of one sequence of ``seq`` tokens through the kernels
    (K1 and K3, or K4 and K5, as the length routes them) and through the
    plain path (the grouped einsum and its autograd backward), overall and
    per block, within GRAD_REL_L2. Returns the sequence."""
    cfg, module = model.config, model.module
    loss_fn = make_fused_head_loss(cfg)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(1, seq))).to(device)
    overall, per_block = kernel_and_plain_grads(
        model, lambda plain: loss_fn(module, module(tokens, return_hidden=True), tokens))
    print(f"{label} gradients of one sequence, kernel vs plain path: relative L2 "
          f"{overall:.3e}; per block " + " ".join(f"{r:.2e}" for r in per_block))
    if not (math.isfinite(overall) and overall <= GRAD_REL_L2
            and all(r <= GRAD_REL_L2 for r in per_block)):
        raise AssertionError(f"{label} kernel-path gradients disagree with the plain path: "
                             f"{overall}, {per_block}")
    return tokens


def llama_cross_check(model, device) -> None:
    """``llama_grads_check`` of one sequence at L = 1024 (K4, K5); and the
    fused head + CE against the unfused CE over the untied head's
    materialised logits at V = 128256."""
    cfg, module = model.config, model.module
    loss_fn = make_fused_head_loss(cfg)
    tokens = llama_grads_check(model, device, "Llama-1B", cfg.seq_len)

    with torch.inference_mode():
        hidden = module(tokens, return_hidden=True)
        fused = loss_fn(module, hidden, tokens).item()
        logits = module.output.output_layer["head"](hidden, cfg.cdtype()).float()
        unfused = next_token_cross_entropy(logits, tokens).item()
    print(f"Llama-1B fused head + CE {fused:.6f}, unfused over ({cfg.seq_len} x "
          f"{cfg.vocab_size}) logits {unfused:.6f}")
    if not (math.isfinite(fused) and abs(fused - unfused) <= FUSED_LOSS_ABS):
        raise AssertionError("the fused loss disagrees with the unfused one at V = 128256")


def l8b_config(n_layers: int):
    """The "8b" preset at ``n_layers`` layers, as phase 40 builds it."""
    return dataclasses.replace(
        llama_transformer_config(LlamaConfig(model_name="8b", seq_len=L8B_FLASH[1],
                                             compute_dtype="bfloat16")),
        n_layers=n_layers)


def seeded_llama(n_layers: int, device) -> Model:
    """Phase 40's model: the "8b" preset at ``n_layers`` layers drawn on the
    host from seed 0."""
    cfg = l8b_config(n_layers)
    return Model(module=Transformer(cfg, device=device,
                                    generator=torch.Generator().manual_seed(0)),
                 config=cfg, name="llama")


def l8b_train_phase(device) -> dict:
    """Llama-3.1-8B training at the preset's width (E = 4096, 32 heads of
    128, 8 KV heads, FFN 14,336, V = 128,256) and L8B_TRAIN_LAYERS layers
    (random weights from seed 0, bf16 compute, float32 weights and AdamW
    state) with ``bench_llama``'s protocol on both attention routes, each
    from the same initial weights: 8 x 512 inside the packed gate (K1 causal
    and K3 at d = 128 in every layer) and 4 x 1024 past it (K4 and K5);
    L8B_WARMUP warm-up and TIMED_STEPS timed steps each (``llama_steps``), a
    profile of one step split by kind, and one sequence's gradients against
    the plain path (``llama_grads_check``). Returns each route's launches."""
    t0 = time.perf_counter()
    model = seeded_llama(L8B_TRAIN_LAYERS, device)
    cfg, module = model.config, model.module.eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in module.parameters())
    print(f"Llama-3.1-8B at {cfg.n_layers} layers: {n_params:,} parameters, E={cfg.emb_dim}, "
          f"{cfg.n_heads} heads of {cfg.head_dim}, {cfg.n_kv_heads} KV heads, FFN "
          f"{cfg.ffn_dim}, V={cfg.vocab_size}; drawn on the host and moved in "
          f"{time.perf_counter() - t0:.2f} s")
    initial = {name: t.to("cpu", copy=True) for name, t in module.state_dict().items()}
    launches = {}
    for route, shape, kinds in (("packed", L8B_PACKED, LLAMA_PACKED_KINDS),
                                ("flash", L8B_FLASH, LLAMA_KINDS)):
        label = f"Llama-3.1-8B ({cfg.n_layers} layers, {shape[0]} x {shape[1]}, {route})"
        module.load_state_dict(initial)
        launches[route], one_step = llama_steps(model, device, shape, L8B_WARMUP, label, route)
        require_kinds(profile_train_step(one_step, kinds, label),
                      [kind for kind in kinds if kind.startswith("K")], label)
        del one_step  # the optimizer state
        gc.collect()
        torch.cuda.empty_cache()
        llama_grads_check(model, device, label, shape[1])
    del model, module, initial
    gc.collect()
    torch.cuda.empty_cache()
    return launches


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


def traced_step(step) -> tuple[list, list, float, str]:
    """One call of ``step`` (after one untraced call) under torch.profiler,
    with ``GEN._attend_cached`` in an "attention" range: (the device
    events, its kernels, the host wall ms, the marker kernels dropped)."""
    with torch.inference_mode():
        with annotated(GEN, "_attend_cached", "attention"):
            step()
            torch.cuda.synchronize()
            events, dropped, wall_ms = traced(step)
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
          f"{dropped} marker kernels dropped)")
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

    launches = (A.fused_mha_packed.launches, A.fused_mha_packed.masked_launches,
                A.packed_mha_bwd.launches)
    wide = torch.zeros(1, 16, 3 * 3072, dtype=torch.bfloat16, device=device)
    refusals = {
        "a gradient at d=128, masked": lambda: A.fused_mha_packed(
            qkv[:1].detach().requires_grad_(), h, causal=True, key_mask=mask[:1]),
        "d=96": lambda: A.fused_mha_packed(wide, 32, causal=True),
        "the backward at d=96": lambda: A.packed_mha_bwd(
            wide, None, wide[..., :3072], wide[..., :3072],
            torch.zeros(1, 32, 16, device=device), 32, causal=True),
    }
    for what, call in refusals.items():
        try:
            call()
        except NotImplementedError:
            continue
        raise AssertionError(f"the K1 wrapper took {what}")
    if (A.fused_mha_packed.launches, A.fused_mha_packed.masked_launches,
            A.packed_mha_bwd.launches) != launches:
        raise AssertionError("a refused call launched K1 or K2/K3")
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


def d128_train_kernel_phases(device) -> dict:
    """The backward kernels at head width 128 (32 heads over E = 4096) and
    the flash forward, each against its float32 plain version under the bf16
    gates and bit-identical over two launches, timed with the plain version,
    its bound and SDPA: K3 (causal) and K2 (non-causal) at the packed
    route's 8 x 512 and at L8B_BWD_LENGTHS (N = 2), with K1 causal timed at
    8 x 512 (k1_d128_phase checks it there); K4 and K5 at the flash
    route's 4 x 1024 (causal) and at edge lengths, causal and not (N = 2),
    and their wrappers' refusal of float32 at d = 80. Returns the rows by
    name."""
    edges = [(2, l) for l in L8B_BWD_LENGTHS]
    return {
        "packed_mha_fwd:causal:d128": fwd_phase(device, [L8B_PACKED], True, seed=84, iters=10,
                                                heads=L8B_HEADS),
        "packed_mha_bwd:causal:d128": bwd_phase(device, [L8B_PACKED] + edges, True, seed=80,
                                                iters=10, heads=L8B_HEADS,
                                                emulated=L8B_K3_EMULATED),
        "packed_mha_bwd:d128": bwd_phase(device, [L8B_PACKED] + edges, False, seed=81,
                                         iters=10, heads=L8B_HEADS),
        "flash_fwd:d128": flash_fwd_phase(device, torch.bfloat16, FLASH_D128, seed=82,
                                          iters=10, d=128),
        "flash_bwd:d128": flash_bwd_phase(device, torch.bfloat16, FLASH_D128, seed=83,
                                          iters=10, d=128)}


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


def top2_margin(logits) -> torch.Tensor:
    """Each row's float32 gap between its largest and second-largest logit."""
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


@contextlib.contextmanager
def stream_margins(srv):
    """Record the float32 top-2 margin of the logits behind each token that
    ``srv`` (a plain server) gives a request inside the block: yields
    ``{id(request): [margin, ...]}``, filled as the requests are served
    (each window's margins read back with its tokens)."""
    margins, ticks = {}, []
    real_tick, real_admit, real_step = SRV._tick_logits, SRV._admit, srv.step

    def tick(*args, **kwargs):
        logits = real_tick(*args, **kwargs)
        ticks.append(top2_margin(logits))
        return logits

    def admit(*args, **kwargs):
        logits = real_admit(*args, **kwargs)
        ticks.append(top2_margin(logits))
        return logits

    def step():
        owners = [(slot, req, len(req.tokens)) for slot, req in enumerate(srv._owner)
                  if req is not None]
        ticks.clear()
        real_step()
        window = torch.stack(ticks).cpu()  # (window, S)
        for slot, req, before in owners:
            margins[id(req)] += window[:len(req.tokens) - before, slot].tolist()

    def admit_request(req, slot):
        ticks.clear()
        real_admit_request(req, slot)
        margins[id(req)] = [ticks[0].item()]

    real_admit_request = srv.admit
    SRV._tick_logits, SRV._admit, srv.step, srv.admit = tick, admit, step, admit_request
    try:
        yield margins
    finally:
        SRV._tick_logits, SRV._admit = real_tick, real_admit
        del srv.step, srv.admit


def l8b_server_phase(module, cfg, device, label: str, margins: bool = False,
                     n_requests: int = L8B_REQUESTS):
    """``DecodeServer`` (L8B_SERVER) serves the first ``n_requests`` of the
    8B mix greedily (no EOS, so every request gets its max_new_tokens)
    after a warm-up on 2 requests:
    32 unmasked K1 launches per admission, none masked, no plain version;
    requests/s, tokens/s, ticks. Returns the K1 launches, the rates and the
    served requests, with ``margins`` also each token's float32 top-2 logit
    margin by ``id(request)`` (``stream_margins``; else None)."""
    srv = SRV.DecodeServer(module, cfg, **L8B_SERVER)
    srv.serve([SRV.Request(prompt=r.prompt, max_new_tokens=4)
               for r in l8b_requests(cfg.vocab_size)[:2]])
    srv.reset()
    torch.cuda.synchronize()
    reqs = l8b_requests(cfg.vocab_size)[:n_requests]
    useful = sum(r.max_new_tokens for r in reqs)
    recorded = stream_margins(srv) if margins else contextlib.nullcontext()
    with no_plain_versions() as (plain_calls, _), recorded as by_request:
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
    if margins and [len(by_request[id(r)]) for r in reqs] != [len(r.tokens) for r in reqs]:
        raise AssertionError("the server's recorded margins do not cover its tokens")
    rates = {"requests_s": len(reqs) / seconds, "tokens_s": useful / seconds}
    return launches[0], rates, reqs, by_request


def l8b_int8_phase(model, device, card_line: str, bf16_rates: dict):
    """int8 weights for the 8B model: ``quantize_decode_params`` on the card
    bit-equal to the same function on the host copy of block 0's weights;
    ``Model.quantize_int8`` (timed; ``quantized_nbytes``); the int8 model's
    prefill logits against a bf16 model holding the dequantized weights
    (relative L2 within SERVE_REL_L2, max |d| printed); greedy generate on
    int8 weights (32 masked K1 launches, no plain version; decode ms per
    step and tokens/s beside bf16's); the server on int8 weights. Returns
    the int8 module."""
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
    l8b_server_phase(qmodule, cfg, device, "int8", n_requests=L8B_INT8_REQUESTS)
    return qmodule


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
    weights and the apps' command lines (phase 44) in processes of their
    own, and the 1b draft drawn on the host in a thread, beside this
    process's build of the preset, all waited for before anything here is
    timed; then generate (bf16), its cross-check, the server and its
    cross-check, int8 weights (37-38); then, on the bf16 decoding copy and
    the int8 module, the float32 weights freed: speculative decoding (41),
    the speculative server (42) and the prefix cache (43). Returns the
    launches of K1 d = 128 by mode."""
    command, apps = l8b_serve_command(), apps_commands()
    with ThreadPoolExecutor(1) as pool:
        draft_built = pool.submit(build_model, LLAMA_1B_DRAFT, device="cpu")
        model = build_8b(device)
        free, total = torch.cuda.mem_get_info(device)
        print(f"the card after both processes' 8B builds: {(total - free) / 2**30:.3f} of "
              f"{total / 2**30:.3f} GiB in use (torch.cuda.mem_get_info)")
        l8b_serve_result(command, card_line)
        with phase_clock("44 (the apps' command lines; the wait after the 8B's build)",
                         device):
            apps_results(apps, card_line)
        peaks = []
        greedy, masked, rates = l8b_generate_phase(model, device, card_line, peaks)
        serve_cross_check(model, greedy, device,
                          batch=l8b_prompts(model.config.vocab_size, device), new=L8B_NEW,
                          name="Llama-3.1-8B")
        del greedy
        server_cross_check(model, device, reqs=l8b_requests(model.config.vocab_size)[:4],
                           server=L8B_SERVER, name="Llama-3.1-8B")
        gc.collect()
        torch.cuda.empty_cache()
        unmasked, server_rates, plain_reqs, plain_margins = l8b_server_phase(
            model.module, model.config, device, "bf16", margins=True)
        gc.collect()
        torch.cuda.empty_cache()
        qmodule = l8b_int8_phase(model, device, card_line, rates)
        target = decoding_model(model, "llama-8b")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        draft = draft_built.result()
    waited = time.perf_counter() - t0
    draft.module.to(device)
    draft = decoding_model(draft, "llama-1b")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"the 1b draft: {sum(p.numel() for p in draft.module.parameters()):,} parameters "
          f"(drawn on the host beside the 8B's build, waited {waited:.2f} s for), "
          f"{draft.config.n_layers} blocks, E={draft.config.emb_dim}, {draft.config.n_heads} "
          f"heads of {draft.config.head_dim}, {draft.config.n_kv_heads} KV heads, bf16 decoding "
          f"copy on the card")
    with phase_clock("41 (speculative decoding at batch 1)", device, peaks):
        spec_phase(target, draft, device, card_line)
    with phase_clock("42 (the speculative server)", device, peaks):
        spec_server_phase(target, draft, plain_reqs[:SPEC_SERVER_REQUESTS], plain_margins,
                          server_rates, device, card_line)
    del draft, plain_reqs, plain_margins
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("43 (the prefix cache)", device, peaks):
        prefix_phase(target, qmodule, server_rates, device, card_line)
    peak = max(peaks + [torch.cuda.max_memory_allocated(device)]) / 2**30
    print(f"Llama-3.1-8B serving phases: peak memory {peak:.3f} GiB "
          f"(torch.cuda.max_memory_allocated) of the card's "
          f"{torch.cuda.get_device_properties(device).total_memory / 2**30:.2f}; the idle share "
          f"of a bf16 decode step {100 * rates['idle']:.1f}%")
    if peak > 79:
        raise AssertionError(f"the 8B serving phases peaked at {peak:.3f} GiB, over 79")
    del target, qmodule
    gc.collect()
    torch.cuda.empty_cache()
    return {"packed_mha_fwd:d128": unmasked, "packed_mha_fwd:masked:d128": masked}


# ---------------------------------------------------------------------------
# The rest of serving on Llama-3.1-8B: speculative decoding (batch 1 and the
# server's windows) drafted by the 1b preset, the prefix cache; the apps;
# MoE decode
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def phase_clock(name: str, device, peaks: list | None = None):
    """Print the seconds and the peak memory of the block; the peak before
    it (and the block's own) are appended to ``peaks``."""
    torch.cuda.synchronize()
    if peaks is not None:
        peaks.append(torch.cuda.max_memory_allocated(device))
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    if peaks is not None:
        peaks.append(peak)
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s, peak memory {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)")


def decoding_model(model: Model, label: str) -> Model:
    """The model holding ``generate``'s decoding copy of its weight matrices
    (``GEN.decode_module``: bf16), which every later decode reuses."""
    return Model(module=GEN.decode_module(model.module, model.config), config=model.config,
                 name=label)


@contextlib.contextmanager
def k1_widths():
    """Count the prefill's K1 calls by head width: yields a Counter."""
    widths, real = Counter(), GEN.fused_mha_packed

    def counted(qkv, n_heads, *args, **kwargs):
        widths[qkv.shape[-1] // (3 * n_heads)] += 1
        return real(qkv, n_heads, *args, **kwargs)

    GEN.fused_mha_packed = counted
    try:
        yield widths
    finally:
        GEN.fused_mha_packed = real


@contextlib.contextmanager
def host_syncs():
    """Record the host-device synchronisations inside the block (torch.cuda's
    sync debug mode, one warning each): yields the list of warnings."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def logits_margins():
    """Record the float32 top-2 margin of every ``GEN._logits`` call's rows
    (the prefill's last logits, then each decode step's): yields the list."""
    margins, real = [], GEN._logits

    def recorded(*args, **kwargs):
        logits = real(*args, **kwargs)
        margins.append(top2_margin(logits))
        return logits

    GEN._logits = recorded
    try:
        yield margins
    finally:
        GEN._logits = real


def near_tie(got: list, want: list, margins: list) -> tuple[bool, str]:
    """The near-tie rule (NEAR_TIE): ``got`` passes against the reference
    stream ``want`` if the two are equal up to the first position where
    the reference's float32 top-2 margin (``margins``) is below NEAR_TIE.
    Returns (passes, what happened)."""
    if len(got) != len(want):
        return False, f"{len(got)} tokens against {len(want)}"
    diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if diff is None:
        return True, "equal"
    low = min(range(diff + 1), key=lambda i: margins[i])
    return margins[low] < NEAR_TIE, (f"first differs at {diff} (margin there "
                                      f"{margins[diff]:.4f}; smallest up to there "
                                      f"{margins[low]:.4f} at {low})")


@contextlib.contextmanager
def rejections():
    """Record each greedy and sampled verification's first rejected
    proposal: yields a list of (kind, the target's float32 top-2 margin at
    that position, the target's over the draft's probability of the
    proposal); a fully accepted window records nothing."""
    seen = []
    greedy, sampled = SPEC._accept_greedy, SPEC._accept_sampled

    def accept_greedy(proposals, logits):
        a, emit = greedy(proposals, logits)
        seen.append(("greedy", a, top2_margin(logits), proposals.shape[0], None))
        return a, emit

    def accept_sampled(proposals, logits, draft_logits, temperature, generator):
        a, emit = sampled(proposals, logits, draft_logits, temperature, generator)
        p = torch.softmax(logits[:-1] / temperature, -1).gather(1, proposals[:, None])[:, 0]
        q = torch.softmax(draft_logits / temperature, -1).gather(1, proposals[:, None])[:, 0]
        seen.append(("sampled", a, top2_margin(logits), proposals.shape[0], p / q))
        return a, emit

    found = []
    SPEC._accept_greedy, SPEC._accept_sampled = accept_greedy, accept_sampled
    try:
        yield found
    finally:
        SPEC._accept_greedy, SPEC._accept_sampled = greedy, sampled
        for kind, a, margins, gamma, ratio in seen:
            a = int(a)
            if a < gamma:
                found.append((kind, margins[a].item(),
                              None if ratio is None else ratio[a].item()))


@contextlib.contextmanager
def draft_write_skipped():
    """Planted fault: the draft's (gamma + 1)-th step leaves its K/V cell as
    it found it (the write at c + gamma skipped)."""
    real = SPEC._draft_step

    def step(module, cfg, cache, token, pos, positions, *, logits):
        if logits:
            return real(module, cfg, cache, token, pos, positions, logits=logits)
        saved = [(lc["k"][:, :, pos].clone(), lc["v"][:, :, pos].clone()) for lc in cache]
        out = real(module, cfg, cache, token, pos, positions, logits=logits)
        for lc, (k, v) in zip(cache, saved):
            lc["k"][:, :, pos], lc["v"][:, :, pos] = k, v
        return out

    SPEC._draft_step = step
    try:
        yield
    finally:
        SPEC._draft_step = real


@contextlib.contextmanager
def commit_one_too_far():
    """Planted fault: each greedy round commits one token past its accepted
    run and the target's correction (the commit pointer one too far)."""
    real = SPEC._accept_greedy

    def accept(proposals, logits):
        a, emit = real(proposals, logits)
        return torch.clamp(a + 1, max=proposals.shape[0]), emit

    SPEC._accept_greedy = accept
    try:
        yield
    finally:
        SPEC._accept_greedy = real


@contextlib.contextmanager
def kept_caches():
    """Keep the caches that ``generate_speculative``'s prefills make (the
    target's, then the draft's): yields the list."""
    caches, real = [], SPEC.prefill

    def prefill(*args, **kwargs):
        logits, cache = real(*args, **kwargs)
        caches.append(cache)
        return logits, cache

    SPEC.prefill = prefill
    try:
        yield caches
    finally:
        SPEC.prefill = real


def cache_agreement(caches, cells: int) -> float:
    """The largest relative L2, over layers and K/V, between the draft's
    and the target's cache cells [0, cells): a self-draft's cells of
    committed tokens hold what the target's hold, up to two routes'
    rounding (one-token steps against windows)."""
    target, draft = caches
    return max(rel_l2(dl[name][:, :, :cells], tl[name][:, :, :cells])
               for tl, dl in zip(target, draft) for name in ("k", "v"))


def spec_run(target: Model, draft: Model, prompt, new: int, temperature: float = 0.0,
             seed: int = 0) -> dict:
    """One ``Model.generate_speculative`` call, greedy or sampled: its
    tokens, stats, seconds, K1 calls by head width and launches, host
    syncs, plain calls, first rejections (``rejections``) and, for a
    self-draft, the agreement of the draft's cache with the target's over
    the committed tokens' cells (``cache_agreement``)."""
    device = prompt.device
    gen = torch.Generator(device=device).manual_seed(seed)
    with k1_widths() as widths, no_plain_versions() as (plain_calls, aug_calls), \
            rejections() as rejected, kept_caches() as caches:
        A.fused_mha_packed.launches = A.fused_mha_packed.masked_launches = 0
        with host_syncs() as syncs:
            t0 = time.perf_counter()
            out, stats = target.generate_speculative(prompt, new, draft=draft, gamma=SPEC_GAMMA,
                                                     temperature=temperature, generator=gen,
                                                     return_stats=True)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = (A.fused_mha_packed.launches, A.fused_mha_packed.masked_launches)
    if not (tuple(out.shape) == (1, new) and bool(((out >= 0)
                                                   & (out < target.config.vocab_size)).all())):
        raise AssertionError(f"generate_speculative returned {tuple(out.shape)} or ids out "
                             "of range")
    return {"tokens": out[0].tolist(), "stats": stats, "seconds": seconds,
            "widths": dict(widths), "launches": launches,
            "syncs": sum("ynchroniz" in str(w.message) for w in syncs),
            "plain": plain_calls + aug_calls, "rejected": rejected,
            "cache_rel": (cache_agreement(caches, prompt.shape[1] + new - 1)
                          if draft is target else None)}


def self_draft_exact(run) -> bool:
    """Every rejection of a self-draft (``spec_run``) is a rounding one (a
    near tie, or a sampled ratio within exp(-NEAR_TIE/T) of 1), and its cache
    holds what the target's holds."""
    floor = math.exp(-NEAR_TIE / SPEC_TEMPERATURE)
    return run["cache_rel"] <= SERVE_REL_L2 and all(
        margin < NEAR_TIE if ratio is None else ratio >= floor
        for _, margin, ratio in run["rejected"])


def spec_phase(target: Model, draft: Model, device, card_line: str) -> None:
    """Phase 41: speculative decoding at batch 1 on the 8B (bf16 decoding
    copy), drafted by the 1b preset and by itself. Plain batch-1
    ``Model.generate`` gives the reference stream, its float32 top-2 margins
    and its rate. Greedy with the 1b draft and with the self-draft, then
    sampled at T 0.8 with the self-draft: the greedy streams pass the
    near-tie rule against the reference; the self-draft's proposals are all
    accepted but where the window's own margin is a near tie (greedy) or the
    target's over the draft's probability is within exp(-NEAR_TIE/T) of 1
    (sampled): two routes' rounding, printed; the self-draft's cache holds
    the target's over the committed cells (``cache_agreement``, within
    SERVE_REL_L2); K1 once per layer and model
    per call (32 at d = 128, 16 at d = 64 with the 1b draft), no plain
    version; host syncs per round. Then two planted faults that must fail
    those checks: the draft's (gamma + 1)-th K/V write skipped (self-draft),
    and the commit pointer one too far (1b draft)."""
    cfg = target.config
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, SPEC_PROMPT))).to(device)
    target.generate(prompt, 4, temperature=0.0)
    spec_run(target, draft, prompt, 8)  # the 1b draft's first launches
    torch.cuda.synchronize()
    with logits_margins() as margins:
        t0 = time.perf_counter()
        want = target.generate(prompt, SPEC_NEW, temperature=0.0)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    want, margins = want[0].tolist(), torch.cat(margins).tolist()
    plain_rate = SPEC_NEW / plain_s
    print(f"Llama-3.1-8B plain batch-1 generate ({card_line}), prompt {SPEC_PROMPT}, "
          f"{SPEC_NEW} new: {plain_s:.3f} s, {plain_rate:.2f} tokens/s; float32 top-2 margins "
          f"{min(margins):.4f}..{max(margins):.4f}, {sum(m < NEAR_TIE for m in margins)} below "
          f"{NEAR_TIE:g}")

    def report(label, run, width_want):
        stats, rounds = run["stats"], run["stats"]["rounds"]
        print(f"speculative {label} ({card_line}): {rounds} rounds, accepted "
              f"{stats['accepted']}/{stats['drafted']} drafted "
              f"({stats['accepted'] / max(stats['drafted'], 1):.4f}), {run['syncs']} host "
              f"syncs ({run['syncs'] / rounds:.2f} per round), {run['seconds'] * 1e3 / rounds:.3f} "
              f"ms per round (both prefills included), {len(run['tokens']) / run['seconds']:.2f} "
              f"tokens/s against plain generate's {plain_rate:.2f}; K1 by head width "
              f"{run['widths']}, launches (unmasked, masked) {run['launches']}; first rejections "
              f"(kind, margin, p/q) {run['rejected'][:8]}")
        if run["widths"] != width_want or run["launches"] != (sum(width_want.values()), 0):
            raise AssertionError(f"{label}: K1 {run['widths']} {run['launches']}, want "
                                 f"{width_want} unmasked")
        if run["plain"]:
            raise AssertionError(f"{label}: plain versions ran on CUDA: {Counter(run['plain'])}")

    per_call = {128: cfg.n_layers, 64: draft.config.n_layers}
    runs = {"greedy, 1b draft": spec_run(target, draft, prompt, SPEC_NEW),
            "greedy, self-draft": spec_run(target, target, prompt, SPEC_NEW),
            "sampled T 0.8, self-draft": spec_run(target, target, prompt, SPEC_NEW,
                                                  temperature=SPEC_TEMPERATURE)}
    for label, run in runs.items():
        report(label, run, per_call if "1b" in label else {128: 2 * cfg.n_layers})
        if label.startswith("greedy"):
            ok, what = near_tie(run["tokens"], want, margins)
            print(f"  tokens against plain batch-1 generate (near-tie rule, {NEAR_TIE:g}): {what}")
            if not ok:
                raise AssertionError(f"{label}: the speculative stream leaves plain greedy "
                                     f"decode outside a near tie: {what}")
        if "self" in label:
            exact = run["stats"]["accepted"] == run["stats"]["drafted"]
            print(f"  self-draft acceptance exactly 1.0: {exact}; the draft's cache against "
                  f"the target's over the committed cells, largest relative L2 "
                  f"{run['cache_rel']:.3e}; every rejection a rounding one and the caches "
                  f"within {SERVE_REL_L2:g}: {self_draft_exact(run)}")
            if not self_draft_exact(run):
                raise AssertionError(f"{label}: the self-draft rejected a proposal outside a "
                                     f"near tie or its cache left the target's: "
                                     f"{run['rejected']}, {run['cache_rel']}")

    with draft_write_skipped():
        skipped = spec_run(target, target, prompt, 2 * SPEC_FAULT_NEW)
    with commit_one_too_far():
        too_far = spec_run(target, draft, prompt, SPEC_FAULT_NEW)
    faults = {"the draft's (gamma + 1)-th K/V write skipped (self-draft)":
              (self_draft_exact(skipped), f"accepted {skipped['stats']['accepted']}/"
               f"{skipped['stats']['drafted']}, rejections {skipped['rejected'][:4]}, caches "
               f"{skipped['cache_rel']:.3e} apart"),
              "the commit pointer one too far (1b draft)":
              near_tie(too_far["tokens"], want[:SPEC_FAULT_NEW], margins)}
    print("planted faults (each must fail its check): " + "; ".join(
        f"{k}: passes {ok} ({what})" for k, (ok, what) in faults.items()))
    if any(ok for ok, _ in faults.values()):
        raise AssertionError(f"a planted speculative fault passed its check: {faults}")


def spec_server_phase(target: Model, draft: Model, plain_reqs, plain_margins,
                      plain_rates: dict, device, card_line: str) -> None:
    """Phase 42: ``DecodeServer`` on the 8B with the 1b draft (L8B_SERVER,
    gamma 4) serves the first SPEC_SERVER_REQUESTS of phase 37's requests,
    each cut to SPEC_SERVER_NEW new tokens, greedily after a warm-up: every
    request its max_new_tokens; K1 once per layer and model per admission
    (32 at d = 128 and 16 at d = 64), no plain version; each stream against
    the plain server's under the near-tie rule (its margins recorded in
    phase 37); spec_rounds, committed tokens per round, requests/s and
    tokens/s beside phase 37's."""
    cfg = target.config
    srv = SRV.DecodeServer(target.module, cfg, **L8B_SERVER, draft_params=draft,
                           gamma=SPEC_GAMMA)
    srv.serve([SRV.Request(prompt=r.prompt, max_new_tokens=4)
               for r in l8b_requests(cfg.vocab_size)[:2]])
    srv.reset()
    torch.cuda.synchronize()
    reqs = [SRV.Request(prompt=r.prompt, max_new_tokens=min(r.max_new_tokens, SPEC_SERVER_NEW))
            for r in l8b_requests(cfg.vocab_size)[:SPEC_SERVER_REQUESTS]]
    useful = sum(r.max_new_tokens for r in reqs)
    with k1_widths() as widths, no_plain_versions() as (plain_calls, _):
        A.fused_mha_packed.launches = A.fused_mha_packed.masked_launches = 0
        t0 = time.perf_counter()
        srv.serve(reqs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (A.fused_mha_packed.launches, A.fused_mha_packed.masked_launches)
    verdicts = [near_tie(r.tokens, p.tokens[:len(r.tokens)], plain_margins[id(p)])
                for r, p in zip(reqs, plain_reqs)]
    equal = sum(what == "equal" for _, what in verdicts)
    print(f"Llama-3.1-8B speculative DecodeServer ({card_line}), 1b draft, gamma {SPEC_GAMMA}, "
          f"{L8B_SERVER}, {len(reqs)} requests of at most {SPEC_SERVER_NEW} new "
          f"({useful} tokens): {seconds:.3f} s, "
          f"{len(reqs) / seconds:.3f} requests/s, {useful / seconds:.2f} tokens/s (the plain "
          f"server, phase 37: {plain_rates['requests_s']:.3f} and {plain_rates['tokens_s']:.2f}); "
          f"{srv.spec_rounds} rounds, {srv.spec_committed} tokens committed by them "
          f"({srv.spec_committed / srv.spec_rounds:.3f} a round over {L8B_SERVER['n_slots']} "
          f"slots); K1 by head width {dict(widths)}, launches (unmasked, masked) {launches}; "
          f"streams equal to the plain server's: {equal} of {len(reqs)}; "
          + "; ".join(f"request {i}: {what}" for i, (_, what) in enumerate(verdicts)
                      if what != "equal")[:2000])
    want = {128: cfg.n_layers * len(reqs), 64: draft.config.n_layers * len(reqs)}
    if dict(widths) != want or launches != (sum(want.values()), 0) or plain_calls:
        raise AssertionError(f"the speculative server launched K1 {dict(widths)} {launches}, "
                             f"want {want}; plain calls {Counter(plain_calls)}")
    if not all(r.done and len(r.tokens) == r.max_new_tokens for r in reqs):
        raise AssertionError("a request did not get its max_new_tokens from the speculative "
                             "server")
    if not all(ok for ok, _ in verdicts):
        raise AssertionError("a speculative server stream leaves the plain server's outside "
                             "a near tie")


def prefix_requests(vocab: int) -> tuple[list, list]:
    """(the prefix, PREFIX_REQUESTS requests of 32-224 own tokens and 16-64
    new), from default_rng(0)."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, size=PREFIX_LEN).tolist()
    reqs = []
    for _ in range(PREFIX_REQUESTS):
        own, new = int(rng.integers(32, 225)), int(rng.integers(16, 65))
        reqs.append(SRV.Request(prompt=rng.integers(0, vocab, size=(own,)).tolist(),
                                max_new_tokens=new))
    return prefix, reqs


@contextlib.contextmanager
def rope_not_offset():
    """Planted fault: the own tokens of a prefix admission rotated at
    positions [0, Pb) instead of [plen, plen + Pb)."""
    real = SRV._rope_cos_sin

    def unshifted(cfg, positions):
        return real(cfg, positions - positions[0])

    SRV._rope_cos_sin = unshifted
    try:
        yield
    finally:
        SRV._rope_cos_sin = real


def prefix_cross_check(srv, prefix: list, reqs: list, handle: int, label: str) -> None:
    """4 requests admitted under the registered prefix (slots 0-3) against
    ``prefill`` of [prefix ++ prompt] alone (K1 at d = 128): their last
    logits, and the slot's cache rows [0, plen + len) against that
    prefill's cache (the largest relative L2 over requests, layers, K and
    V), each within SERVE_REL_L2; then the same with each of two planted
    faults (the own tokens' RoPE not offset by plen; the prefix rows copied
    one row off), which must fail it."""
    cfg, module = srv.cfg, srv.module
    kv = srv._prefixes[handle]["kv"]
    plen = len(prefix)
    with torch.inference_mode():
        alone = [GEN.prefill(module, cfg, torch.tensor([prefix + r.prompt], device=srv.device),
                             plen + len(r.prompt)) for r in reqs]

        def admitted(prefix_kv):
            """(relative L2 of the 4 admissions' logits, of their cache rows)."""
            pos, logits, rows = srv.pos.clone(), [], []
            for slot, (r, (_, cache)) in enumerate(zip(reqs, alone)):
                padded, length = srv._bucketed(r.prompt, room=srv.max_len - plen)
                logits.append(SRV._admit_prefix(module, cfg, srv.cache, pos, slot, prefix_kv,
                                                padded, length))
                rows += [rel_l2(lc[name][slot, :, :plen + length], ac[name][0])
                         for lc, ac in zip(srv.cache, cache) for name in ("k", "v")]
            return rel_l2(torch.stack(logits), torch.cat([a for a, _ in alone])), max(rows)

        good = admitted(kv)
        with rope_not_offset():
            unshifted = admitted(kv)
        off_by_one = admitted([{k: torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], dim=1)
                                for k, v in lc.items()} for lc in kv])
    print(f"Llama-3.1-8B {label} prefix cache, a {plen}-token prefix, own prompts "
          f"{[len(r.prompt) for r in reqs]}: 4 admissions vs prefill of [prefix ++ prompt] "
          f"alone, relative L2 of the logits {good[0]:.3e}, of the slot's cache rows (largest "
          f"over requests, layers, K and V) {good[1]:.3e}")
    if not all(math.isfinite(v) and v <= SERVE_REL_L2 for v in good):
        raise AssertionError(f"the prefix admissions disagree with the prefill: {good}")
    print(f"  with the planted faults, (logits, cache rows): own tokens' RoPE not offset by "
          f"plen {unshifted[0]:.3e}, {unshifted[1]:.3e}; prefix rows copied one row off "
          f"{off_by_one[0]:.3e}, {off_by_one[1]:.3e}")
    planted({"own tokens' RoPE not offset by plen": max(unshifted),
             "prefix rows copied one row off": max(off_by_one)})


def prefix_phase(target: Model, qmodule, plain_rates: dict, device, card_line: str) -> None:
    """Phase 43: the prefix cache on the 8B, int8 then bf16 weights: a
    256-token prefix registered (one prefill, 32 unmasked K1 launches) and
    ``prefix_cross_check`` with its planted faults on each; then, in bf16,
    64 requests served under it (no K1: the own tokens' attention over the
    prefix rows is plain products, as the JAX package's einsum), every
    request its max_new_tokens; prefill_tokens_saved, requests/s and
    tokens/s beside phase 37's plain server."""
    cfg = target.config
    prefix, mix = prefix_requests(cfg.vocab_size)
    for label, module in (("int8", qmodule), ("bf16", target.module)):
        srv = SRV.DecodeServer(module, cfg, **L8B_SERVER)
        A.fused_mha_packed.launches = 0
        handle = srv.register_prefix(prefix)
        if A.fused_mha_packed.launches != cfg.n_layers:
            raise AssertionError(f"register_prefix launched K1 {A.fused_mha_packed.launches} "
                                 f"times, want {cfg.n_layers}")
        prefix_cross_check(srv, prefix, mix[:4], handle, label)
        if label == "int8":
            continue
        srv.reset()
        torch.cuda.synchronize()
        reqs = [SRV.Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens, prefix=handle)
                for r in mix]
        useful = sum(r.max_new_tokens for r in reqs)
        with no_plain_versions() as (plain_calls, _):
            A.fused_mha_packed.launches = A.fused_mha_packed.masked_launches = 0
            t0 = time.perf_counter()
            srv.serve(reqs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = (A.fused_mha_packed.launches, A.fused_mha_packed.masked_launches)
        own = sum(len(r.prompt) for r in reqs)
        print(f"Llama-3.1-8B {label} DecodeServer under a {PREFIX_LEN}-token prefix "
              f"({card_line}), {L8B_SERVER}, {len(reqs)} requests ({own} own prompt tokens, "
              f"{useful} new): {seconds:.3f} s, {len(reqs) / seconds:.3f} requests/s, "
              f"{useful / seconds:.2f} tokens/s (phase 37's plain server, other requests: "
              f"{plain_rates['requests_s']:.3f} and {plain_rates['tokens_s']:.2f}); "
              f"prefill_tokens_saved {srv.prefill_tokens_saved}; {srv.steps} ticks; K1 "
              f"(unmasked, masked) {launches}")
        if srv.prefill_tokens_saved != PREFIX_LEN * len(reqs) or launches != (0, 0) \
                or plain_calls:
            raise AssertionError(f"the prefix server saved {srv.prefill_tokens_saved} tokens, "
                                 f"launched K1 {launches}, plain calls {Counter(plain_calls)}")
        if not all(r.done and len(r.tokens) == r.max_new_tokens for r in reqs):
            raise AssertionError("a request did not get its max_new_tokens under the prefix")


def apps_commands():
    """Phase 44's command lines, each a process of its own, started now so
    that they overlap the 8B's host draw: ``sample`` with GPT-2 medium
    drafted by GPT-2 base, ``serve`` under a shared prefix. Returns (app,
    argv, process, start time) for each."""
    return [(app, argv, subprocess.Popen(
        [sys.executable, "-m", f"vitef_tpu_torch.apps.gpt2.{app}", *argv], cwd=REPO_ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), time.perf_counter())
            for app, argv in (("sample", SPEC_SAMPLE_ARGV), ("serve", PREFIX_SERVE_ARGV))]


def apps_results(started, card_line: str) -> None:
    """Phase 44: wait for each command line: exit 0, its results and the
    stats it logs (the speculative rounds and acceptance; the requests
    served and the prefix tokens not prefilled)."""
    for app, argv, proc, t0 in started:
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
        seconds = time.perf_counter() - t0
        logged = [line for line in err.splitlines()
                  if line.startswith(("speculative", "served", "serving mode"))]
        print(f"python -m vitef_tpu_torch.apps.gpt2.{app} {' '.join(argv)} ({card_line}): exit "
              f"{proc.returncode} in {seconds:.2f} s (beside the 8B's host draw); "
              f"{' | '.join(logged)}; stdout {out[-300:]!r}")
        if app == "sample":
            ok = "'new_ids':" in out and any(line.startswith("speculative") for line in logged)
        else:
            lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
            ok = len(lines) == 16 and all(line["tokens"] for line in lines) and any(
                "prefix tokens not prefilled" in line for line in logged)
        if proc.returncode != 0 or not ok:
            raise AssertionError(f"the command line {app} {argv} failed:\n{err[-4000:]}")


def moe_routes_check(model: Model, device) -> None:
    """MoE decode's sparse route against the dense oracle at one routing:
    each block's FFN on the inputs recorded in a sparse-route prefill of 4
    prompts and in one decode step after it (8 claims, on 8 groups), through
    ``apply_moe_ffn_sparse`` and ``apply_moe_ffn``, relative L2 within
    SERVE_REL_L2; the logits of the two whole routes printed beside the
    share of tokens routed to other experts (random weights flip routings
    on rounding)."""
    cfg, module = model.config, model.module
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(4, MOE_SERVE_PROMPT))).to(device)
    inputs = []
    hooks = [block.ffn.register_forward_pre_hook(lambda mod, args: inputs.append(args[0]))
             for block in module.blocks]
    try:
        with torch.inference_mode(), config_set(cfg, moe_impl="sparse"):
            logits, cache = GEN.prefill(module, cfg, prompt, MOE_SERVE_PROMPT + 1)
            x = GEN._embed_token(module, cfg, logits.argmax(dim=-1),
                                 torch.full((4,), MOE_SERVE_PROMPT, device=device))
            for block, lc in zip(module.blocks, cache):
                x, _ = GEN._block_decode(block, cfg, x, lc, MOE_SERVE_PROMPT)
            step_logits = GEN._logits(module, cfg, x)
    finally:
        for hook in hooks:
            hook.remove()
    with torch.inference_mode(), config_set(cfg, moe_impl="dense"):
        dense_logits, _ = GEN.prefill(module, cfg, prompt, MOE_SERVE_PROMPT + 1)
    worst = {}
    with torch.inference_mode():
        for label, recorded in (("prefill", inputs[:cfg.n_layers]),
                                ("decode step", inputs[cfg.n_layers:])):
            rels = []
            for block, xin in zip(module.blocks, recorded):
                params = block.ffn.params()
                rels.append(rel_l2(M.apply_moe_ffn_sparse(params, cfg, xin, top_k=cfg.moe_top_k),
                                   M.apply_moe_ffn(params, cfg, xin, top_k=cfg.moe_top_k)))
            worst[label] = rels
    print(f"MoE 8x124m decode routes at one routing (each block's FFN on the sparse route's "
          f"recorded inputs, sparse vs the dense oracle, relative L2): prefill of 4 x "
          f"{MOE_SERVE_PROMPT} " + " ".join(f"{r:.2e}" for r in worst["prefill"])
          + "; one decode step of 4 " + " ".join(f"{r:.2e}" for r in worst["decode step"])
          + f"; whole-route prefill logits sparse vs dense {rel_l2(logits, dense_logits):.3e} "
          f"(not gated: routings flip); decode step logits finite "
          f"{bool(torch.isfinite(step_logits).all())}")
    if not all(math.isfinite(r) and r <= SERVE_REL_L2 for rels in worst.values() for r in rels):
        raise AssertionError(f"the sparse MoE decode route disagrees with the dense oracle: "
                             f"{worst}")


def moe_serve_phase(device, card_line: str) -> None:
    """Phase 45: MoE "8x124m" decode in bf16 on the card. ``generate`` for 1
    and for 32 prompts (resolve_moe_impl: batch 1's decode steps, 2 claims,
    take the sparse route, its 128-token prefill the dense one; at 32 the
    prefill is sparse and the decode dense): K1 12 per call, K8 gmm and K7
    gmm_swiglu 12 per sparse evaluation (the forward passes only), no plain
    version; tokens/s. ``DecodeServer`` with 4 slots under "auto" (its
    ticks' 8 claims take the dense oracle) and under "sparse" (K8 and K7 at
    8 rows over 8 groups), 12 of each per admission and tick. Then
    ``moe_routes_check``."""
    model = build_model(MOE_8X124M, device=device)
    model = decoding_model(model, "moe-8x124m")
    cfg = model.config
    counters = (A.fused_mha_packed,) + GROUPED_WRAPPERS
    rng = np.random.default_rng(0)

    def counted(run):
        with no_moe_plain_versions() as calls:
            for counter in counters:
                counter.launches = 0
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counters}
        plain = Counter(name for group in calls[:4] for name in group)
        if plain:
            raise AssertionError(f"plain kernel versions ran on CUDA: {plain}")
        return out, seconds, launches, len(calls[4])

    for batch in MOE_SERVE_BATCHES:
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               size=(batch, MOE_SERVE_PROMPT))).to(device)
        model.generate(prompt, 4, temperature=0.0)
        out, seconds, launches, dense = counted(
            lambda: model.generate(prompt, MOE_SERVE_NEW, temperature=0.0))
        steps = MOE_SERVE_NEW - 1
        sparse_prefill = 2 * batch * MOE_SERVE_PROMPT >= 4096
        sparse_decode = 2 * batch <= max(2, cfg.n_experts // 2)
        evaluations = int(sparse_prefill) + steps * int(sparse_decode)
        want = {"fused_mha_packed": cfg.n_layers, "gmm": cfg.n_layers * evaluations,
                "gmm_swiglu": cfg.n_layers * evaluations, "tgmm": 0, "gmm_dy_swiglu": 0,
                "gmm_dual": 0, "tgmm_swiglu": 0}
        print(f"MoE 8x124m bf16 generate ({card_line}), batch {batch}, prompt "
              f"{MOE_SERVE_PROMPT}, {MOE_SERVE_NEW} new: {seconds:.3f} s, "
              f"{batch * MOE_SERVE_NEW / seconds:.2f} tokens/s; prefill "
              f"{'sparse' if sparse_prefill else 'dense'}, decode "
              f"{'sparse' if sparse_decode else 'dense'}; launches {launches} (want {want}; "
              f"per decode step K8 gmm {cfg.n_layers * int(sparse_decode)}, K7 gmm_swiglu "
              f"{cfg.n_layers * int(sparse_decode)}); dense oracle calls {dense}")
        if launches != want:
            raise AssertionError(f"MoE generate at batch {batch} launched {launches}, want {want}")
        if not (tuple(out.shape) == (batch, MOE_SERVE_NEW)
                and bool(((out >= 0) & (out < cfg.vocab_size)).all())):
            raise AssertionError(f"MoE generate returned {tuple(out.shape)} or ids out of range")

    mix = np.random.default_rng(2)
    lengths = [(int(mix.integers(32, 129)), int(mix.integers(16, 49)))
               for _ in range(MOE_SERVER_REQUESTS)]
    for impl in ("auto", "sparse"):
        reqs = [SRV.Request(prompt=mix.integers(0, cfg.vocab_size, size=(n,)).tolist(),
                            max_new_tokens=new) for n, new in lengths]
        useful = sum(new for _, new in lengths)
        with config_set(cfg, moe_impl=impl):
            srv = SRV.DecodeServer(model.module, cfg, **MOE_SERVER)
            srv.serve([SRV.Request(prompt=r.prompt, max_new_tokens=2) for r in reqs[:2]])
            srv.reset()
            _, seconds, launches, dense = counted(lambda: srv.serve(reqs))
        ticks = srv.steps
        per_eval = cfg.n_layers * (len(reqs) + ticks) if impl == "sparse" else 0
        print(f"MoE 8x124m bf16 DecodeServer ({card_line}), moe_impl {impl!r}, {MOE_SERVER}, "
              f"{len(reqs)} requests ({useful} tokens): {seconds:.3f} s, "
              f"{len(reqs) / seconds:.2f} requests/s, {useful / seconds:.2f} tokens/s, {ticks} "
              f"ticks; launches {launches} (K8 gmm and K7 gmm_swiglu want {per_eval}: 12 per "
              f"admission and tick on the sparse route); dense oracle calls {dense}")
        if launches["gmm"] != per_eval or launches["gmm_swiglu"] != per_eval \
                or launches["fused_mha_packed"] != cfg.n_layers * len(reqs):
            raise AssertionError(f"the MoE server ({impl}) launched {launches}")
        if not all(r.done and len(r.tokens) == r.max_new_tokens for r in reqs):
            raise AssertionError("a request did not get its max_new_tokens from the MoE server")
    moe_routes_check(model, device)


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


def probe_result(probe) -> None:
    """Wait for the linear-probing command line that ``vit_apps_phase``
    started: exit 0, and ``linear_probing.json`` holding 8 keys a block, each
    accuracy in [0, 1]."""
    proc, t0, probe_data, n_layers = probe
    out = proc.communicate(timeout=900)[0]
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the linear-probing command line exited {proc.returncode}:\n"
                             f"{out[-4000:]}")
    saved = json.loads((LP.PROBE_DIR / APPS_LOG_DIR / "linear_probing.json").read_text())
    best_key = max(saved, key=saved.get)
    print(f"linear probing command line ({probe_data.name}: {APPS_PROBE_CIFAR[0]:,} train, "
          f"{APPS_PROBE_CIFAR[1]:,} test images; probe_impl torch): exit 0 in {seconds:.2f} s "
          f"beside the figures phase; {len(saved)} keys, accuracy "
          f"{min(saved.values()):.4f}..{saved[best_key]:.4f} (best {best_key})")
    if not (len(saved) == 8 * n_layers and all(0.0 <= a <= 1.0 for a in saved.values())):
        raise AssertionError(f"linear_probing.json holds {saved}")
    # the best key again in this process, through the command line's own
    # code with the probes cut to that key (it rewrites linear_probing.json)
    real = LP.run_linear_probing

    def one_key(model, *args, **kwargs):
        get_probes = model.get_probes
        model.get_probes = lambda x: {best_key: get_probes(x)[best_key]}
        return real(model, *args, **kwargs)

    LP.run_linear_probing = one_key
    try:
        t0 = time.perf_counter()
        again = LP.linear_probing(LP.LinearProbingConfig(
            log_dir=APPS_LOG_DIR, data_dir=str(probe_data), probe_impl="torch"))
        seconds = time.perf_counter() - t0
    finally:
        LP.run_linear_probing = real
        for handler in logging.getLogger("vitef").handlers[:]:
            logging.getLogger("vitef").removeHandler(handler)
            handler.close()
    print(f"linear probing of {best_key} in this process: {again[best_key]!r} against the "
          f"command line's {saved[best_key]!r} ({seconds:.2f} s)")
    if set(again) != {best_key} or abs(again[best_key] - saved[best_key]) > (
            1.0 / APPS_PROBE_CIFAR[1] + 1e-9):
        raise AssertionError("the linear-probing command line's accuracy is not recomputed "
                             "in this process")
    gc.collect()
    torch.cuda.empty_cache()


def vit_apps_phase(device, card_line: str) -> tuple[Path, tuple]:
    """The paper's experiment through the port's command lines on the card:
    train (K10, K1, K2 each step, K1 in every evaluation batch, no plain
    version), the run dir's contract, a resume, the eval command line as a
    subprocess; then 10 steps at 1 x 512 and 2 x 256; then it starts linear
    probing as a subprocess. Returns the CIFAR-10 files' dir and the probe
    (for :func:`probe_result`); the caller removes ``APPS_ROOT``."""
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
        # Linear probing as a user runs it, in a process of its own beside the
        # figures phase: its 96 L-BFGS fits are host-bound (140-220 s, a host
        # sync in every iteration), and that phase's work is small.
        probe = (subprocess.Popen(
            [sys.executable, "-m", "vitef_tpu_torch.apps.vit.linear_probing",
             f"log_dir={log_dir}", f"data_dir={probe_data}", "probe_impl=torch"],
            cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter(), probe_data, n_layers)
        return data, probe
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


def mse(pred, target):
    return ((pred.float() - target.float()) ** 2).mean()


def patchtst_series(n: int, seed: int, device, length: int = PATCHTST["length"],
                    horizon: int = PATCHTST["forecasting_horizon"]):
    """(x (n, length), y (n, horizon)) float32 on ``device``: seeded
    synthetic series, each a daily and a weekly cycle of an hourly series
    (periods 24 and 168) of random amplitudes and phases, a level, a slope
    and noise, drawn on the host with numpy (25 MB at Electricity's batch)."""
    rng = np.random.default_rng(seed)
    t = np.arange(length + horizon, dtype=np.float32)[None]
    amp = rng.uniform(0.5, 2.0, size=(n, 2)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=(n, 2)).astype(np.float32)
    s = (amp[:, :1] * np.sin(2 * np.pi * t / 24 + phase[:, :1])
         + amp[:, 1:] * np.sin(2 * np.pi * t / 168 + phase[:, 1:])
         + rng.normal(size=(n, 1)).astype(np.float32)
         + rng.normal(scale=1e-3, size=(n, 1)).astype(np.float32) * t
         + rng.normal(scale=0.2, size=(n, length + horizon)).astype(np.float32))
    s = torch.from_numpy(s.astype(np.float32)).to(device)
    return s[:, :length], s[:, length:]


def bn_sites(module) -> dict:
    """The running statistics of every batch norm, copied: path -> (mean, var)."""
    return {name: (m.running_mean.clone(), m.running_var.clone())
            for name, m in batch_norm_sites(module).items()}


def patchtst_steps(model, device, x, y, steps: int, plain: bool = False) -> tuple[list, dict]:
    """``steps`` AdamW steps with the running-stat update on one batch, on the
    kernel route or (``plain``) the plain attention: (losses, running
    statistics after them)."""
    optimizer, scheduler = build_optimizer(PATCHTST_OPTIMIZER, model.module)
    state = init_train_state(model, optimizer, scheduler)
    step_fn = make_train_step(loss_fn=mse, update_stats=True)
    with config_set(model.config, **({"attn_impl": "plain"} if plain else {})):
        losses = [step_fn(state, (x, y))["loss"].item() for _ in range(steps)]
    return losses, bn_sites(model.module)


def patchtst_cross_check(model, device, x, y) -> None:
    """PatchTST-base in bf16, kernel route (K1 and K2 at d = 8) against the
    plain attention route from the same weights: the train-mode forecasts and
    gradients on one batch (overall and per block), the running statistics
    after PATCHTST_CHECK_STEPS steps, and the eval forecasts that read them,
    which differ from the train-mode ones."""
    module = model.module
    start = {k: v.clone() for k, v in module.state_dict().items()}
    module.train()
    with torch.no_grad():
        kernel_out = module(x)
        with config_set(model.config, attn_impl="plain"):
            plain_out = module(x)
    out_rel = rel_l2(kernel_out, plain_out)
    overall, blocks = kernel_and_plain_grads(model, lambda plain: mse(module(x), y))
    print(f"PatchTST-base forecasts (train mode), kernel vs plain route: relative L2 "
          f"{out_rel:.3e}; gradients {overall:.3e}, per block "
          + " ".join(f"{r:.2e}" for r in blocks))
    if not (math.isfinite(out_rel) and out_rel <= GRAD_REL_L2 and overall <= GRAD_REL_L2
            and all(r <= GRAD_REL_L2 for r in blocks)):
        raise AssertionError(f"PatchTST kernel route disagrees with the plain route: "
                             f"{out_rel}, {overall}, {blocks}")

    runs = {}
    for plain in (False, True):
        module.load_state_dict(start)
        losses, stats = patchtst_steps(model, device, x, y, PATCHTST_CHECK_STEPS, plain)
        with torch.no_grad():
            train_out = module(x)
            eval_out = model.apply_eval(x)
        runs[plain] = losses, stats, eval_out, train_out
    worst = max(max(rel_l2(runs[False][1][site][i], runs[True][1][site][i]) for i in (0, 1))
                for site in runs[False][1])
    eval_rel = rel_l2(runs[False][2], runs[True][2])
    train_vs_eval = rel_l2(runs[False][2], runs[False][3])
    print(f"PatchTST-base after {PATCHTST_CHECK_STEPS} steps, kernel vs plain route: running "
          f"statistics' largest relative L2 {worst:.3e} over {len(runs[False][1])} sites; "
          f"eval forecasts {eval_rel:.3e}; eval vs train-mode forecast {train_vs_eval:.3e}; "
          f"losses {runs[False][0]} and {runs[True][0]}")
    if not (worst <= PATCHTST_STATS_REL and eval_rel <= GRAD_REL_L2
            and torch.isfinite(runs[False][2]).all() and train_vs_eval > PATCHTST_STATS_REL):
        raise AssertionError(f"PatchTST running statistics or eval forecasts disagree: "
                             f"{worst}, {eval_rel}, {train_vs_eval}")
    module.load_state_dict(start)


def patchtst_phase(device) -> dict:
    """Phase 47: PatchTST-base trains in bf16 at the PatchTST/64 supervised
    setting on seeded synthetic series (N = 10,272: Electricity's 321
    channels at batch 32, channel-independent): AdamW and MSE with the
    running-stat update, PATCHTST_WARMUP warm-up and PATCHTST_TIMED timed
    steps, K1 and K2 at d = 8 n_layers launches each a step, K4 and K5 none,
    no plain version, a loss that falls; series/s, peak memory and a profile
    of one step; the cross-check against the plain route. Then the preset at
    its default float32: the plain attention (no K1), a loss that falls; and
    under attn_impl="pallas", K4 and K5 at d = 8 (``patchtst_fp32_pallas``).
    Returns the main paths' launch counts."""
    model = build_model(PATCHTST, device=device)
    cfg = model.config
    n, _ = PATCHTST_SHAPE
    x, y = patchtst_series(n, seed=0, device=device)
    print(f"PatchTST-base: {sum(p.numel() for p in model.module.parameters()):,} parameters, "
          f"{cfg.n_layers} blocks, E={cfg.emb_dim}, {cfg.n_heads} heads of {cfg.head_dim}, "
          f"L={cfg.seq_len} patches of {cfg.patch_size} (stride {cfg.stride}) over "
          f"{cfg.length} steps, horizon {cfg.forecasting_horizon}; batch {n} series")
    optimizer, scheduler = build_optimizer(PATCHTST_OPTIMIZER, model.module)
    state = init_train_state(model, optimizer, scheduler)
    step_fn = make_train_step(loss_fn=mse, update_stats=True)
    losses = [step_fn(state, (x, y))["loss"] for _ in range(PATCHTST_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    with no_plain_versions() as (plain_calls, _):
        for counter in FLASH_COUNTERS:
            counter.launches = 0
        A.fused_mha_packed.masked_launches = 0
        t0 = time.perf_counter()
        losses += [step_fn(state, (x, y))["loss"] for _ in range(PATCHTST_TIMED)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in FLASH_COUNTERS}
        launches["masked"] = A.fused_mha_packed.masked_launches
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    losses = [loss.item() for loss in losses]
    want = cfg.n_layers * PATCHTST_TIMED
    print(f"PatchTST-base bf16 train: {n * PATCHTST_TIMED / seconds:.2f} series/s "
          f"({seconds / PATCHTST_TIMED * 1e3:.3f} ms per step of {n}); peak memory "
          f"{peak_gib:.3f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches over "
          f"{PATCHTST_TIMED} steps {launches} (K1 and K2 want {want}; K2 in its non-causal "
          f"mode, so K3 none); plain calls {dict(Counter(plain_calls))}")
    if (launches["fused_mha_packed"] != want or launches["packed_mha_bwd"] != want
            or launches["flash_attention"] or launches["flash_bwd"] or launches["masked"]
            or plain_calls or cfg.causal):
        raise AssertionError("the PatchTST step did not take K1 and K2 in every block")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the PatchTST loss did not fall: {losses}")
    require_kinds(profile_train_step(lambda: step_fn(state, (x, y)), PATCHTST_KINDS,
                                     "PatchTST-base"),
                  ("K1 packed_mha_fwd", "K2 packed_mha_bwd"), "PatchTST-base")
    del state, optimizer, scheduler, step_fn
    patchtst_cross_check(model, device, x, y)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    model = build_model({**PATCHTST, "compute_dtype": "float32"}, device=device)
    A.fused_mha_packed.launches = A.flash_attention.launches = 0
    with counting(A, "attention_reference") as plain_calls:
        t0 = time.perf_counter()
        losses, _ = patchtst_steps(model, device, x, y, PATCHTST_FP32_STEPS)
        seconds = time.perf_counter() - t0
    print(f"PatchTST-base float32 (the preset's default): {PATCHTST_FP32_STEPS} steps, "
          f"{n * PATCHTST_FP32_STEPS / seconds:.2f} series/s (synchronising each step), loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; K1 {A.fused_mha_packed.launches}, K4 "
          f"{A.flash_attention.launches}, plain attention calls {len(plain_calls)}")
    if (A.fused_mha_packed.launches or A.flash_attention.launches
            or len(plain_calls) != cfg.n_layers * PATCHTST_FP32_STEPS
            or not losses[-1] < losses[0]):
        raise AssertionError("PatchTST float32 did not take the plain attention, or its "
                             "loss did not fall")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(patchtst_fp32_pallas(device, x, y))
    return launches


def patchtst_fp32_pallas(device, x, y) -> dict:
    """PatchTST-base at its float32 default under ``attn_impl="pallas"``, as
    the JAX package runs it into its flash kernel at d = 8: one warm-up and
    PATCHTST_FP32_STEPS timed steps, K4 = K5 = n_layers a step, K1-K3 none,
    no plain version, a loss that falls, series/s; then one batch's
    gradients against the plain route's (relative L2 within
    FP32_GRAD_REL_L2, overall and per block). Returns the K4 and K5 launches
    of the timed steps."""
    model = build_model({**PATCHTST, "compute_dtype": "float32", "attn_impl": "pallas"},
                        device=device)
    cfg, n = model.config, x.shape[0]
    optimizer, scheduler = build_optimizer(PATCHTST_OPTIMIZER, model.module)
    state = init_train_state(model, optimizer, scheduler)
    step_fn = make_train_step(loss_fn=mse, update_stats=True)
    losses = [step_fn(state, (x, y))["loss"]]
    torch.cuda.synchronize()
    with no_plain_versions() as (plain_calls, _):
        for counter in FLASH_COUNTERS:
            counter.launches = 0
        t0 = time.perf_counter()
        losses += [step_fn(state, (x, y))["loss"] for _ in range(PATCHTST_FP32_STEPS)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in FLASH_COUNTERS}
    losses = [loss.item() for loss in losses]
    want = cfg.n_layers * PATCHTST_FP32_STEPS
    print(f"PatchTST-base float32, attn_impl=\"pallas\": {n * PATCHTST_FP32_STEPS / seconds:.2f} "
          f"series/s ({seconds / PATCHTST_FP32_STEPS * 1e3:.3f} ms per step of {n}); loss "
          f"{' '.join(f'{v:.4f}' for v in losses)}; launches over {PATCHTST_FP32_STEPS} steps "
          f"{launches} (K4 and K5 want {want}); plain calls {dict(Counter(plain_calls))}")
    if (launches["flash_attention"] != want or launches["flash_bwd"] != want
            or launches["fused_mha_packed"] or launches["packed_mha_bwd"] or plain_calls):
        raise AssertionError("the float32 PatchTST step did not take K4 and K5 in every block")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the float32 PatchTST loss did not fall: {losses}")
    del state, optimizer, scheduler, step_fn
    overall, blocks = kernel_and_plain_grads(model, lambda plain: mse(model.module(x), y))
    print(f"PatchTST-base float32 gradients, K4 + K5 against the plain route: relative L2 "
          f"{overall:.3e}, per block " + " ".join(f"{r:.2e}" for r in blocks)
          + f" (limit {FP32_GRAD_REL_L2})")
    if not (math.isfinite(overall) and overall <= FP32_GRAD_REL_L2
            and all(r <= FP32_GRAD_REL_L2 for r in blocks)):
        raise AssertionError("float32 PatchTST's K4/K5 gradients leave the plain route's")
    return {"fp32:flash_attention": launches["flash_attention"],
            "fp32:flash_bwd": launches["flash_bwd"]}


def remat_phase(device) -> None:
    """Phase 48: ViT-H/14 with ``remat=True`` at the paper's microbatch 2 x
    256 (without it the model fits only 4 x 128, phase 32) through
    ``train_phase`` (1 warm-up and REMAT_TIMED timed steps each way, K1
    twice per block per microbatch: forward and recompute); 4 x 128 if
    2 x 256 does not fit.
    Then one microbatch (128) of gradients with remat against the same step
    without it, within relative L2 REMAT_REL_L2."""
    model = build_model({**VIT_H14, "remat": True}, device=device)
    microbatch, ran = 256, None
    try:
        ran = train_phase(model, device, "ViT-H/14 remat", microbatch, 1, REMAT_TIMED)
    except torch.cuda.OutOfMemoryError as error:
        print(f"ViT-H/14 with remat at 2 x 256 does not fit: {str(error)[:200]}")
    if ran is None:  # outside the handler, whose traceback holds the step's tensors
        model.module.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.empty_cache()
        microbatch = 128
        ran = train_phase(model, device, "ViT-H/14 remat", microbatch, 1, REMAT_TIMED)
    # the step's SGD momentum and gradients go before the check, whose step
    # without remat at 128 takes about 75 GiB
    _, _, dataset, rates = ran
    del ran
    model.module.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"ViT-H/14 remat at {512 // microbatch} x {microbatch}: peak {rates['peak_gib']:.3f} "
          f"GiB, {rates['loader_img_s']:.2f} img/s with the loader, {rates['device_img_s']:.2f} "
          f"device-only (phase 32 reads ViT-H/14 without remat at 4 x 128)")
    raw, boxes, flips, y = check_microbatch(dataset, device, 128)
    x = T.augment_train_device(raw, boxes, flips, size=224, compute_dtype=torch.bfloat16)
    module = model.module
    overall, blocks = kernel_and_plain_grads(
        model, lambda _: F.cross_entropy(module(x).float(), y), {"remat": False})
    print(f"ViT-H/14 gradients of one microbatch (128), remat vs no remat: relative L2 "
          f"{overall:.3e}; largest per block {max(blocks):.3e}")
    if not (overall <= REMAT_REL_L2 and max(blocks) <= REMAT_REL_L2):
        raise AssertionError(f"remat changes the ViT-H/14 gradients: {overall}, {blocks}")


@contextlib.contextmanager
def dropout_masks():
    """Record what each dropout call of the model drops: a list, in call
    order, of the (values nonzero before it, values it zeroed) masks (the
    transformer's four sites: the embedding's output, each block's attention
    and FFN outputs, the head's input)."""
    masks, original = [], TR.dropout

    def recording(x, rate, generator, deterministic):
        out = original(x, rate, generator, deterministic)
        if not deterministic and rate > 0:
            live = x != 0
            masks.append((live, live & (out == 0)))
        return out

    TR.dropout = recording
    try:
        yield masks
    finally:
        TR.dropout = original


def dropout_phase(device) -> None:
    """Phase 49: ViT-B/16 with dropout at rate DROPOUT_RATE on every site, one
    train step (batch 256) from a generator: at each site the share of its
    nonzero values that dropout zeroed within 5σ of the rate; a second step
    from the same state and seed dropping the same values and giving the
    same loss bit for bit, another seed other values; eval mode equal to the
    model at rate 0."""
    tcfg = dataclasses.replace(
        vit_transformer_config(ViTConfig(model_name="base", compute_dtype="bfloat16")),
        n_classes=N_CLASSES, emb_dropout=DROPOUT_RATE, attn_dropout=DROPOUT_RATE,
        ffn_dropout=DROPOUT_RATE, output_dropout=DROPOUT_RATE)
    module = Transformer(tcfg, device=device, generator=torch.Generator().manual_seed(0))
    model = Model(module=module, config=tcfg, name="ViT-B/16 dropout")
    start = {k: v.clone() for k, v in module.state_dict().items()}
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(256, 3, 224, 224, generator=gen).to(device, torch.bfloat16)
    y = torch.randint(0, N_CLASSES, (256,), generator=gen).to(device)
    runs = []
    for seed in (7, 7, 8):
        module.load_state_dict(start)
        optimizer, scheduler = build_optimizer(OPTIMIZER, module)
        step_fn = make_train_step(grad_clip=GRAD_CLIP)
        with dropout_masks() as masks:
            loss = step_fn(init_train_state(model, optimizer, scheduler), (x, y),
                           generator=torch.Generator(device=device).manual_seed(seed))["loss"]
        runs.append((loss.item(), masks))
    loss, masks = runs[0]
    n_blocks = len(module.blocks)
    if len(masks) != 2 * n_blocks + 2:
        raise AssertionError(f"{len(masks)} dropout calls, want {2 * n_blocks + 2}")
    sites = {"embedding": masks[:1], "attention": masks[1:-1:2], "ffn": masks[2:-1:2],
             "head input": masks[-1:]}
    shares = {}
    for kind, calls in sites.items():
        dropped = sum(int(d.sum()) for _, d in calls)
        total = sum(int(live.sum()) for live, _ in calls)
        shares[kind] = dropped / total
        sigma = math.sqrt(DROPOUT_RATE * (1 - DROPOUT_RATE) / total)
        if not abs(shares[kind] - DROPOUT_RATE) <= 5 * sigma:
            raise AssertionError(f"dropout at the {kind}: {dropped} of {total} nonzero values "
                                 f"zeroed, {shares[kind]} against {DROPOUT_RATE} "
                                 f"(5σ {5 * sigma:.2e})")
    same = runs[1][0] == loss and all(torch.equal(a[1], b[1])
                                      for a, b in zip(masks, runs[1][1]))
    other = any(not torch.equal(a[1], b[1]) for a, b in zip(masks, runs[2][1]))
    del runs, masks, sites
    module.load_state_dict(start)
    with torch.no_grad():
        dropped_out = model.apply_eval(x)
        with config_set(tcfg, emb_dropout=0.0, attn_dropout=0.0, ffn_dropout=0.0,
                        output_dropout=0.0):
            plain = model.apply_eval(x)
    equal = torch.equal(dropped_out, plain)
    print(f"ViT-B/16 dropout {DROPOUT_RATE}: share of nonzero values zeroed: " + ", ".join(
        f"{k} {v:.5f}" for k, v in shares.items()) + f"; loss {loss:.4f}; seed 7 twice: the "
        f"same values dropped and loss bit-equal {same}; seed 8: other values {other}; eval "
        f"mode equals rate 0: {equal}")
    if not (same and other and equal and math.isfinite(loss)):
        raise AssertionError("dropout is not repeatable per seed, or eval mode drops")


# ---------------------------------------------------------------------------
# The mesh: the ('dp', 'tp') process group of the card(s) this machine has
# ---------------------------------------------------------------------------

# ViT-B/16 (cifar10.yaml: bf16, 2 x 256, every component trained) through the
# train command line on the synthetic set sized for MESH_STEPS steps of 512
# (2,560 images: 2,048 train, 512 validation, one evaluation at the end).
MESH_STEPS = 4
MESH_DATASET = "synthetic-2560"
MESH_LOSS_RTOL = 1e-3          # the fsdp route's losses against the one-card run's
MESH_GRAD_RTOL = 5e-2          # its gradients, relative L2
# With two cards, the logged grad norms of tp = 2 against the one-card run's
# and of dp = 2 with fsdp against dp = 2's, relative; their losses are held
# to MESH_LOSS_RTOL (four cards, H100 80GB HBM3, 700 W: tp = 2's losses
# within about 1e-4 of one card's).
MESH_TP_NORM_RTOL = 1e-2
MESH_RANK_LINE = "mesh rank: "  # a --mesh-train rank's launches and records
MESH_SERVE_REQUESTS = 16       # GPT-2 base through DecodeServer(mesh=)
MESH_SERVER = {"n_slots": 16, "max_len": 256, "bucket": 64}


def mesh_argv(log_dir: str, *extra: str) -> list[str]:
    return [f"config={REPO_ROOT / 'apps/vit/configs/cifar10.yaml'}", "pretrained=False",
            f"dataset_name={MESH_DATASET}", f"n_steps={MESH_STEPS}", "warmup=1",
            f"eval_period={MESH_STEPS}", "logging_period=1", f"log_dir={log_dir}", *extra]


def mesh_train_run(label: str, *extra: str) -> tuple[list, dict, float]:
    """One train command line run in this process: its logged train records
    (none on a rank other than the master, which alone writes them), the
    K10/K1/K2 launches of the whole run (none of a plain version) and the
    img/s of its logged periods (median)."""
    counters = (A.fused_mha_packed, A.packed_mha_bwd, T.augment_train_device)
    try:
        with no_plain_versions() as (plain_calls, aug_calls):
            for counter in counters:
                counter.launches = 0
            TRAIN_APP.main(mesh_argv(f"mesh_{label}", *extra))
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counters}
    finally:
        for handler in logging.getLogger("vitef").handlers[:]:
            logging.getLogger("vitef").removeHandler(handler)
            handler.close()
    if plain_calls or aug_calls:
        raise AssertionError(f"the {label} route called a plain version: "
                             f"{plain_calls + aug_calls}")
    # the command line has left its process group: the launch names the rank
    if int(os.environ.get("VITEF_PROCESS_ID", "0")) != 0:
        return [], launches, float("nan")
    records = jsonl(APPS_ROOT / "savings" / "runs" / f"mesh_{label}" / "metrics" / "raw_0.jsonl")
    train = [r for r in records if "loss" in r]
    rates = [b["elapsed_steps"] * APPS_BATCH / (b["ts"] - a["ts"])
             for a, b in zip(train, train[1:])]
    return train, launches, float(np.median(rates))


def mesh_grads_check(device) -> float:
    """One step's gradients of ViT-B/16 bf16 (one microbatch of
    AUTO_MICROBATCH) under ``shard_params(fsdp=True)`` on this mesh against
    the unsharded model's: relative L2 over every parameter."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(AUTO_MICROBATCH, 3, 224, 224, generator=gen).to(device, torch.bfloat16)
    y = torch.randint(0, 10, (AUTO_MICROBATCH,), generator=gen).to(device)
    grads = []
    for fsdp in (False, True):
        model = build_model(APPS_MODEL, device=device,
                            generator=torch.Generator().manual_seed(42))
        if fsdp:
            PAR.shard_params(model, PAR.build_mesh(), fsdp=True)
        optimizer, scheduler = build_optimizer({"optimizer": "sgd", "lr": 0.0}, model.module)
        make_train_step()(init_train_state(model, optimizer, scheduler), (x, y))
        grads.append(torch.cat([p.grad.float().reshape(-1)
                                for p in model.module.parameters()]))
        del model, optimizer, scheduler
    err = float(torch.linalg.vector_norm(grads[1] - grads[0])
                / torch.linalg.vector_norm(grads[0]))
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    return err


MESH_SERVE_MODELS = {"GPT-2 base bf16": (GPT2_BASE, False),
                     "GPT-2 base int8": (GPT2_BASE, True),
                     "MoE 8x124m bf16": (MOE_8X124M, False)}


def mesh_server_check(device, mesh, exact: bool = True,
                      label: str = "GPT-2 base bf16") -> None:
    """A model of MESH_SERVE_MODELS (GPT-2 base bf16 by default; its int8
    weights; MoE 8x124m, whose experts split over 'tp') through
    ``DecodeServer(mesh=)`` and the plain server over MESH_SERVE_REQUESTS
    requests: every request served to its budget, K1 once per layer at
    every admission this rank owns, and the same greedy tokens: all of them
    (``exact``), or, across cards, where the partial products are summed in
    another order (tp) and the slots batched otherwise (dp), each stream up
    to a near tie of the plain server's (the near-tie rule, NEAR_TIE; the
    CPU tests hold the ranks to the one-rank server in float32)."""
    config, int8 = MESH_SERVE_MODELS[label]
    model = build_model(config, device=device)
    module = model.quantize_int8() if int8 else model.module
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, model.config.vocab_size, size=(int(rng.integers(16, 121)),))
             .tolist(), int(rng.integers(16, 97))) for _ in range(MESH_SERVE_REQUESTS)]
    tokens = {}
    for which, kw in (("plain", {}), ("mesh", {"mesh": mesh})):
        srv = SRV.DecodeServer(module, model.config, **MESH_SERVER, **kw)
        requests = [SRV.Request(prompt=p, max_new_tokens=n) for p, n in reqs]
        # the plain streams' float32 top-2 margins, for the near-tie rule
        recorded = stream_margins(srv) if which == "plain" else contextlib.nullcontext()
        with recorded as by_request:
            A.fused_mha_packed.launches = 0
            t0 = time.perf_counter()
            srv.serve(requests)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        if which == "plain":
            margins = [by_request[id(r)] for r in requests]
        tokens[which] = [r.tokens for r in requests]
        k1 = A.fused_mha_packed.launches
        # a rank prefills the admissions into its own slots
        own = (sum(r.slot // (srv.n_slots // mesh.dp) == mesh.dp_rank for r in requests)
               if which == "mesh" else len(requests))
        print(f"DecodeServer ({which}, {label}, {MESH_SERVE_REQUESTS} requests, "
              f"{MESH_SERVER['n_slots']} slots{', margins recorded' if by_request else ''}): "
              f"{sum(map(len, tokens[which]))} tokens in {seconds:.2f} s, K1 {k1} over "
              f"this rank's {own} admissions")
        if which == "mesh" and k1 != model.config.n_layers * own:
            raise AssertionError(f"the mesh server's admissions launched K1 {k1} times, want "
                                 f"{model.config.n_layers} each")
    if [len(t) for t in tokens["mesh"]] != [n for _, n in reqs]:
        raise AssertionError("the mesh server did not serve every request to its budget")
    verdicts = [near_tie(got, want, m)
                for got, want, m in zip(tokens["mesh"], tokens["plain"], margins)]
    same = sum(a == b for a, b in zip(tokens["mesh"], tokens["plain"]))
    ties = [f"request {i}: {what}" for i, (ok, what) in enumerate(verdicts)
            if ok and what != "equal"]
    off = [f"request {i}: {what}" for i, (ok, what) in enumerate(verdicts) if not ok]
    print(f"DecodeServer(mesh=dp {mesh.dp} x tp {mesh.tp}, {label}) rank {mesh.rank}: "
          f"{same} of {len(reqs)} requests' greedy tokens equal the plain server's"
          + (f"; after a near tie: {'; '.join(ties)}" if ties else "")
          + (f"; off: {'; '.join(off)}" if off else ""))
    if off or (exact and same != len(reqs)):
        raise AssertionError(f"the mesh server's greedy tokens ({label}) differ from the "
                             "plain server's")
    del model, module
    gc.collect()
    torch.cuda.empty_cache()


def mesh_ranks(world: int, dp: int, tp: int, want: dict, ref: list | None = None,
               fsdp: bool = False) -> list:
    """The train command line (``fsdp``: with fsdp=true) and, without fsdp,
    the mesh server over ``world`` cards, one process a card as a user
    launches them (VITEF_COORDINATOR_ADDRESS, VITEF_NUM_PROCESSES,
    VITEF_PROCESS_ID, VITEF_LOCAL_RANK), each a run of this script
    (``--mesh-train``, ``--mesh-serve``); every rank must exit 0 (a server
    rank fails on its own check), and every train rank's K10/K1/K2 launches
    must be ``want``. ``ref``: the logged train records of a run on the same
    data (the one-card run under tp alone, the dp run under fsdp), to which
    the losses and grad norms are held. Returns the master's records."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for what in ("train",) if fsdp else ("train", "serve"):
        cmd = [sys.executable, str(Path(__file__).resolve()), f"--mesh-{what}", str(dp), str(tp),
               *(["fsdp"] if fsdp else [])]
        procs = [subprocess.Popen(cmd, cwd=REPO_ROOT, env={
            **os.environ, "VITEF_COORDINATOR_ADDRESS": f"localhost:{port + (what == 'serve')}",
            "VITEF_NUM_PROCESSES": str(world), "VITEF_PROCESS_ID": str(rank),
            "VITEF_LOCAL_RANK": str(rank)}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for rank in range(world)]
        t0 = time.perf_counter()
        outs = [proc.communicate(timeout=600)[0] for proc in procs]
        for rank, (proc, out) in enumerate(zip(procs, outs)):
            if proc.returncode != 0:
                raise AssertionError(f"{what} at dp {dp} x tp {tp}, rank {rank} exited "
                                     f"{proc.returncode}:\n{out[-4000:]}")
        if what == "serve":
            for out in outs:
                print("\n".join(line for line in out.splitlines() if "DecodeServer" in line))
            print(f"  (serve: {time.perf_counter() - t0:.2f} s with start-up)")
            continue
        ranks = [json.loads(next(line for line in out.splitlines()
                                 if line.startswith(MESH_RANK_LINE))[len(MESH_RANK_LINE):])
                 for out in outs]
        train = ranks[0]["train"]
        rates = [b["elapsed_steps"] * APPS_BATCH * dp / (b["ts"] - a["ts"])
                 for a, b in zip(train, train[1:])]
        print(f"train command line at dp {dp} x tp {tp}{' fsdp' if fsdp else ''} over {world} "
              f"cards: loss "
              f"{' '.join(repr(r['loss']) for r in train)}; grad_norm "
              f"{' '.join(repr(r['grad_norm']) for r in train)}; launches by rank "
              f"{[r['launches'] for r in ranks]} (want {want} each); "
              f"{float(np.median(rates)):.2f} img/s over the mesh "
              f"({time.perf_counter() - t0:.2f} s with start-up)")
        if any(r["launches"] != want for r in ranks):
            raise AssertionError(f"a rank's launches at dp {dp} x tp {tp} are not {want}")
        if len(train) != MESH_STEPS or not all(math.isfinite(r["loss"]) for r in train):
            raise AssertionError(f"dp {dp} x tp {tp} train records: {train}")
        if ref is not None:
            errs = {key: max(abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(train, ref))
                    for key in ("loss", "grad_norm")}
            print(f"dp {dp} x tp {tp}{' fsdp' if fsdp else ''} against "
                  f"{'the dp run' if fsdp else 'one card'}: losses within {errs['loss']:.3e} "
                  f"relative (limit {MESH_LOSS_RTOL}), grad norms within "
                  f"{errs['grad_norm']:.3e} (limit {MESH_TP_NORM_RTOL})")
            if errs["loss"] > MESH_LOSS_RTOL or errs["grad_norm"] > MESH_TP_NORM_RTOL:
                raise AssertionError(f"the dp {dp} x tp {tp} route is off its reference")
    return train


def mesh_train_rank(dp: int, tp: int, fsdp: bool) -> None:
    """A rank of ``mesh_ranks``' train run (``--mesh-train dp tp [fsdp]``):
    the train command line's main in this process, on the environment's
    process group, with this rank's launches counted; prints them, and the
    master its logged train records, on one MESH_RANK_LINE."""
    try:
        train, launches, _ = mesh_train_run(f"{dp}x{tp}{'_fsdp' if fsdp else ''}", f"dp={dp}",
                                            f"tp={tp}", f"fsdp={fsdp}")
        print(MESH_RANK_LINE + json.dumps({"launches": launches, "train": train}))
    finally:
        shutil.rmtree(APPS_ROOT, ignore_errors=True)


def mesh_serve_rank(dp: int, tp: int) -> None:
    """A rank of ``mesh_ranks``' server run (``--mesh-serve dp tp``): GPT-2
    base bf16, and at tp > 1 also its int8 weights and MoE 8x124m."""
    mesh = PAR.build_computing_manager(PAR.computing_config_from_env(dp, tp), device="cuda")
    try:
        for label in MESH_SERVE_MODELS if tp > 1 else list(MESH_SERVE_MODELS)[:1]:
            mesh_server_check(torch.device("cuda", torch.cuda.current_device()), mesh,
                              exact=False, label=label)
    finally:
        torch.distributed.destroy_process_group()


def mesh_phase(device, card_line: str) -> dict:
    """Phase 50, the ('dp', 'tp') mesh over the process group of this
    machine's cards (NCCL, torch.cuda.device_count() ranks; on one card a
    one-rank group): the ViT-B/16 train command line at 2 x 256 for
    MESH_STEPS steps on one card without a group, then on the mesh at
    dp = -1 (the data-parallel step) and with fsdp = true (shard_params and
    the sharded model's step): the dp route's logged losses and grad norms
    bit-equal to the one-card run's, the fsdp route's within MESH_LOSS_RTOL
    and its gradients within MESH_GRAD_RTOL, K10, K1 and K2 at 1, 24 and 24
    a step on every route; then DecodeServer(mesh=) on GPT-2 base against the
    plain server; with two or more cards, dp = 2 and tp = 2 of both
    and dp = 2 with fsdp (``mesh_ranks``: every rank's launches, tp = 2
    against the one-card run, fsdp against dp = 2, every server rank up to a
    near tie). Returns the launches of the mesh
    routes."""
    world = torch.cuda.device_count()
    torch.cuda.set_device(device)
    shutil.rmtree(APPS_ROOT, ignore_errors=True)
    try:
        one, one_launches, one_rate = mesh_train_run("one_card")
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        torch.distributed.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                             world_size=1, rank=0)
        try:
            if world > 1:
                print(f"mesh phase: {world} cards; the routes below run on a one-rank NCCL "
                      "group of card 0, the dp = 2 and tp = 2 runs after them on the cards")
            runs = {"dp": mesh_train_run("dp"), "fsdp": mesh_train_run("fsdp", "fsdp=true")}
            grads_err = mesh_grads_check(device)
            mesh_server_check(device, PAR.build_mesh())
        finally:
            torch.distributed.destroy_process_group()
        n_layers = build_model(APPS_MODEL, device="meta").config.n_layers
        grad_acc = APPS_BATCH // AUTO_MICROBATCH
        eval_k1 = n_layers * -(-(2560 - 2048) // APPS_BATCH)
        want = {"fused_mha_packed": n_layers * grad_acc * MESH_STEPS + eval_k1,
                "packed_mha_bwd": n_layers * grad_acc * MESH_STEPS,
                "augment_train_device": MESH_STEPS}
        for label, (train, launches, rate) in {"one card": (one, one_launches, one_rate),
                                               **runs}.items():
            print(f"train command line, {label} ({card_line}): loss "
                  f"{' '.join(repr(r['loss']) for r in train)}; grad_norm "
                  f"{' '.join(repr(r['grad_norm']) for r in train)}; launches {launches} (want "
                  f"{want}: K10 1, K1 {n_layers * grad_acc} and K2 {n_layers * grad_acc} a "
                  f"step, K1 {eval_k1} in the evaluation); {rate:.2f} img/s (median of the "
                  f"logged periods; one card {one_rate:.2f})")
            if launches != want:
                raise AssertionError(f"the {label} route's launches are {launches}")
        dp, _, _ = runs["dp"]
        if [(r["loss"], r["grad_norm"]) for r in dp] != [(r["loss"], r["grad_norm"])
                                                         for r in one]:
            raise AssertionError("the dp route's losses and grad norms are not the one-card "
                                 "run's bit for bit")
        fsdp, _, _ = runs["fsdp"]
        loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(fsdp, one))
        print(f"mesh routes: dp bit-equal to one card; fsdp losses within {loss_err:.3e} "
              f"relative (limit {MESH_LOSS_RTOL}), gradients within {grads_err:.3e} relative "
              f"L2 (limit {MESH_GRAD_RTOL}); a one-rank group splits no parameter, so these "
              "limits hold by construction here (FSDP at dp 2 is held to the JAX package in "
              "the CPU tests, and, with two cards, to the dp = 2 run below)")
        if not (len(fsdp) == len(one) == MESH_STEPS and loss_err <= MESH_LOSS_RTOL
                and grads_err <= MESH_GRAD_RTOL):
            raise AssertionError("the fsdp route is off the one-card run")
        if world >= 2:
            dp2 = mesh_ranks(2, 2, 1, want)
            mesh_ranks(2, 2, 1, want, ref=dp2, fsdp=True)
            mesh_ranks(2, 1, 2, want, ref=one)
        else:
            print("mesh phase: one card, so dp = 2 and tp = 2 (two ranks) are not run here")
        return {label: launches for label, (_, launches, _) in runs.items()}
    finally:
        shutil.rmtree(APPS_ROOT, ignore_errors=True)


# ---------------------------------------------------------------------------
# Pipeline and expert parallelism: phase 51
# ---------------------------------------------------------------------------

# ViT-B/16 bf16 through the pipelined step with bench.py's finetune (SGD 0.9,
# lr 0.01, cosine, clip 1.0) on a device-resident batch of 512 as 2 x 256.
PP_BATCH, PP_MICRO = 512, 2
PP_WARMUP, PP_TIMED = 2, 5
# Peak memory of one step of each schedule at 64 rows a microbatch, n_micro 2
# and 8: 1F1B's may grow by this share at most (its batch grows by 56 MiB).
PP_MEMORY_ROWS, PP_MEMORY_MICRO, PP_MEMORY_GROWTH = 64, (2, 8), 0.05
# MoE 8x124m bf16 through make_moe_ep_train_step with the MoE phase's
# protocol (8 x 1024, AdamW, clip 1.0); at ep = 1 a capacity factor of 2 is
# dropless (its buckets hold twice the claims, the second half inert).
EP_WARMUP, EP_TIMED, EP_CAPACITY_FACTOR = 2, 5, 2.0
# With two cards or more: the steps of each run of one process a card, and of
# the one-card run it is held to.
PARALLEL_STEPS = 3
PARALLEL_RANK_LINE = "parallel rank: "
# K9 launches a layer of GPT-2 at sp = 2, zigzag: each rank's two chunks
# meet its own (3 pairs, one in the future skipped) and the other rank's
# (2 pairs: the other two lie in the future), one K9 a pair at 256 rows.
SP2_K9_PER_LAYER = 5


def counted_steps(one_step, warmup: int, timed: int, counters, plain=no_plain_versions):
    """``warmup`` then ``timed`` calls of ``one_step``: every step's metrics
    as floats, the counters' launches over the timed steps, their seconds
    and the plain versions called then."""
    history = [one_step() for _ in range(warmup)]
    torch.cuda.synchronize()
    with plain() as calls:
        for counter in counters:
            counter.launches = 0
        t0 = time.perf_counter()
        history += [one_step() for _ in range(timed)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
    metrics = [{key: float(value) for key, value in m.items()} for m in history]
    return metrics, launches, seconds, Counter(name for group in calls for name in group)


def train_setup(template, place, make_step, optimizer, lr_key: str = "lr"):
    """A copy of ``template`` placed by ``place`` (or not), its optimizer
    (``optimizer``'s config with the cosine schedule; None keeps the
    parameters and their gradients) and ``make_step(schedule, lr)``'s
    step: ``(model, state, step)``."""
    model = copy.deepcopy(template)
    if place is not None:
        place(model)
    schedule = build_scheduler(SCHEDULER, n_steps=TRAIN_STEPS)
    if optimizer is None:
        state, lr = init_train_state(model, KeepParameters(model.module)), 0.0
    else:
        state = init_train_state(model, *build_optimizer(optimizer, model.module,
                                                         schedule=schedule))
        lr = optimizer[lr_key]
    return model, state, make_step(schedule, lr)


def vit_pp_batch(device, rows: int = PP_BATCH):
    """A seeded device-resident ViT-B/16 batch, the same on every card."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(rows, 3, 224, 224, generator=gen, device=device).to(torch.bfloat16)
    y = torch.randint(0, N_CLASSES, (rows,), generator=gen, device=device)
    return x, y


def pp_setup(template, mesh, schedule: str | None, optimizer=OPTIMIZER, grad_clip=GRAD_CLIP,
             n_micro: int = PP_MICRO):
    """ViT through the pipelined step (``schedule``) on ``mesh``, or, with
    ``schedule`` None, through ``make_train_step(grad_acc_steps=n_micro)``,
    the one-card reference."""
    if schedule is None:
        return train_setup(template, None, lambda s, lr: make_train_step(
            grad_acc_steps=n_micro, schedule=s, base_lr=lr, grad_clip=grad_clip), optimizer)
    return train_setup(
        template, lambda m: PAR.place_stages(m, mesh),
        lambda s, lr: PAR.make_pipeline_train_step(
            template.config, mesh, n_micro=n_micro, grad_clip=grad_clip, schedule=s,
            base_lr=lr, pp_schedule=schedule), optimizer)


def pp_want(cfg, mesh, schedule: str, n_micro: int, steps: int) -> dict:
    """K1 and K2 launches of ``steps`` steps on this rank's stage: one K2 a
    block a microbatch; one K1 too, and a second on a 1F1B stage that is not
    the last (its forward phase, then the recompute in the backward tick)."""
    blocks = cfg.n_layers // mesh.pp * n_micro * steps
    twice = schedule == "1f1b" and mesh.pp_rank != mesh.pp - 1
    return {"fused_mha_packed": blocks * (2 if twice else 1), "packed_mha_bwd": blocks}


PP_COUNTERS = (A.fused_mha_packed, A.packed_mha_bwd)


def pipeline_phase(device, mesh) -> dict:
    """ViT-B/16 through ``make_pipeline_train_step`` at pp = 1 under GPipe
    and 1F1B against ``make_train_step(grad_acc_steps=2)`` on the same
    weights and batch: losses, grad norms, one step's gradients, img/s, K1
    and K2 every block; then each schedule's peak memory at n_micro 2 and 8.
    Returns the two schedules' per-step metrics."""
    template = build_model(VIT_B16, device=device)
    cfg = template.config
    batch = vit_pp_batch(device)
    runs = {}
    for schedule in (None, "gpipe", "1f1b"):
        label = schedule or "make_train_step"
        model, state, step = pp_setup(template, mesh, schedule)
        metrics, launches, seconds, plain = counted_steps(
            lambda: step(state, batch), PP_WARMUP, PP_TIMED, PP_COUNTERS)
        want = pp_want(cfg, mesh, schedule or "gpipe", PP_MICRO, PP_TIMED)
        extra = (f", {step.n_ticks} ticks, at most {step.saved_inputs} stage inputs saved"
                 if schedule else "")
        runs[label] = (metrics, PP_BATCH * PP_TIMED / seconds)
        print(f"ViT-B/16 bf16 {label} at {PP_MICRO} x {PP_BATCH // PP_MICRO}{extra}: loss "
              + " ".join(repr(m["loss"]) for m in metrics) + "; grad_norm "
              + " ".join(repr(m["grad_norm"]) for m in metrics)
              + f"; launches over {PP_TIMED} steps {launches} (want {want}); plain calls "
              f"{dict(plain)}; {runs[label][1]:.2f} img/s")
        if launches != want or plain:
            raise AssertionError(f"the {label} step did not go through K1 and K2 every block")
        if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in metrics):
            raise AssertionError(f"{label}: {metrics}")
        del model, state, step
        gc.collect()
        torch.cuda.empty_cache()
    ref, ref_rate = runs["make_train_step"]
    for schedule in ("gpipe", "1f1b"):
        metrics, rate = runs[schedule]
        errs = {key: max(abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(metrics, ref))
                for key in ("loss", "grad_norm")}
        same = [(a["loss"], a["grad_norm"]) for a in metrics] == [(b["loss"], b["grad_norm"])
                                                                 for b in ref]
        print(f"pipeline {schedule} against make_train_step(grad_acc_steps={PP_MICRO}) over "
              f"{len(ref)} steps: losses within {errs['loss']:.3e} relative, grad norms within "
              f"{errs['grad_norm']:.3e} (limit {MESH_LOSS_RTOL} each); bit-equal: {same}; "
              f"{rate:.2f} img/s against the one-card step's {ref_rate:.2f}")
        if max(errs.values()) > MESH_LOSS_RTOL:
            raise AssertionError(f"the {schedule} step is off make_train_step's")

    # One step's gradients (no clip, no update) of each route.
    grads = {}
    for schedule in (None, "gpipe", "1f1b"):
        model, state, step = pp_setup(template, mesh, schedule, optimizer=None, grad_clip=None)
        step(state, batch)
        grads[schedule] = {name: p.grad.float().clone()
                           for name, p in model.module.named_parameters()}
        del model, state, step
    for schedule in ("gpipe", "1f1b"):
        overall, per_block = grads_rel_l2(grads[schedule], grads[None], cfg.n_layers)
        same = all(torch.equal(grads[schedule][k], grads[None][k]) for k in grads[None])
        print(f"pipeline {schedule} gradients of one step against make_train_step's: relative "
              f"L2 {overall:.3e} (limit {MESH_GRAD_RTOL}); per block "
              + " ".join(f"{r:.2e}" for r in per_block) + f"; bit-equal: {same}")
        if not overall <= MESH_GRAD_RTOL:
            raise AssertionError(f"the {schedule} gradients are off make_train_step's")
    del grads
    gc.collect()
    torch.cuda.empty_cache()

    # Peak memory of one step (after one that makes the optimizer's state)
    # at 64 rows a microbatch, n_micro 2 and 8.
    peaks = {}
    for schedule in ("gpipe", "1f1b"):
        for n_micro in PP_MEMORY_MICRO:
            rows = PP_MEMORY_ROWS * n_micro
            model, state, step = pp_setup(template, mesh, schedule, n_micro=n_micro)
            part = (batch[0][:rows], batch[1][:rows])
            step(state, part)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            step(state, part)
            torch.cuda.synchronize()
            peaks[schedule, n_micro] = torch.cuda.max_memory_allocated(device) / 2**30
            del model, state, step
            gc.collect()
            torch.cuda.empty_cache()
    low, high = PP_MEMORY_MICRO
    growth = {s: peaks[s, high] / peaks[s, low] - 1 for s in ("gpipe", "1f1b")}
    print(f"pipeline peak memory of one step at {PP_MEMORY_ROWS} rows a microbatch "
          "(torch.cuda.max_memory_allocated): "
          + "; ".join(f"{s} n_micro {n} {peaks[s, n]:.3f} GiB" for s, n in peaks)
          + f"; from n_micro {low} to {high} 1F1B's grows {100 * growth['1f1b']:.2f}% (limit "
          f"{100 * PP_MEMORY_GROWTH:.0f}%), GPipe's {100 * growth['gpipe']:.2f}%")
    if growth["1f1b"] > PP_MEMORY_GROWTH:
        raise AssertionError("1F1B's peak memory grows with n_micro")
    del template
    gc.collect()
    torch.cuda.empty_cache()
    return {schedule: runs[schedule][0] for schedule in ("gpipe", "1f1b")}


def moe_tokens(cfg, device):
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(MOE_BATCH, cfg.seq_len))).to(device)


def ep_setup(template, mesh, route: str = "ep", optimizer=GPT2_OPTIMIZER,
             grad_clip=GRAD_CLIP):
    """MoE through ``make_moe_ep_train_step`` on the ('dp', 'ep') ``mesh``
    (``route`` "ep", the experts placed by ``shard_experts``), or through
    ``make_train_step`` with the fused head loss (the MoE phase's step):
    "sparse" (what "auto" takes at this batch), "dense" (the oracle) or
    "tp" (the oracle with the experts split by ``shard_params`` on the
    ('dp', 'tp') ``mesh``)."""
    loss = make_fused_head_loss(template.config)
    if route == "ep":
        return train_setup(
            template, lambda m: PAR.shard_experts(m, mesh),
            lambda s, lr: PAR.make_moe_ep_train_step(
                mesh, grad_clip=grad_clip, hidden_loss=loss, capacity_factor=EP_CAPACITY_FACTOR,
                schedule=s, base_lr=lr), optimizer)

    def place(model):
        model.config.moe_impl = {"sparse": "sparse", "dense": "dense", "tp": "dense"}[route]
        if route == "tp":
            PAR.shard_params(model, mesh)

    return train_setup(template, place, lambda s, lr: make_train_step(
        grad_clip=grad_clip, hidden_loss=loss, schedule=s, base_lr=lr), optimizer)


MOE_COUNTERS = FLASH_COUNTERS + GROUPED_WRAPPERS


def moe_want(cfg, steps: int) -> dict:
    per_layer = cfg.n_layers * steps
    return {"fused_mha_packed": per_layer, "packed_mha_bwd": per_layer, "flash_attention": 0,
            "flash_bwd": 0, "gmm": per_layer, "tgmm": 2 * per_layer, "gmm_swiglu": per_layer,
            "gmm_dy_swiglu": per_layer, "gmm_dual": per_layer, "tgmm_swiglu": per_layer}


def ep_phase(device, mesh) -> list:
    """MoE 8x124m through ``make_moe_ep_train_step`` at ep = 1 against
    ``make_train_step``'s sparse step on the same weights and batch: the
    launches, losses, one step's loss and gradients (overall and per block,
    with the share of tokens routed to other experts), tokens/s. Returns
    the EP run's per-step metrics."""
    t0 = time.perf_counter()
    template = build_model(MOE_8X124M, device=device)
    cfg = template.config
    print(f"MoE 8x124m built in {time.perf_counter() - t0:.2f} s")
    tokens = moe_tokens(cfg, device)
    n_tokens = MOE_BATCH * cfg.seq_len
    runs = {}
    for ep in (False, True):
        label = "make_moe_ep_train_step (ep = 1)" if ep else "make_train_step (sparse)"
        model, state, step = ep_setup(template, mesh, "ep" if ep else "sparse")
        metrics, launches, seconds, plain = counted_steps(
            lambda: step(state, (tokens, tokens)), EP_WARMUP, EP_TIMED, MOE_COUNTERS,
            no_moe_plain_versions)
        want = moe_want(cfg, EP_TIMED)
        runs[ep] = (metrics, n_tokens * EP_TIMED / seconds)
        print(f"MoE 8x124m bf16 {label}: loss " + " ".join(repr(m["loss"]) for m in metrics)
              + "; grad_norm " + " ".join(repr(m["grad_norm"]) for m in metrics)
              + f"; launches over {EP_TIMED} steps {launches} (want {want}); plain calls "
              f"{dict(plain)}; {runs[ep][1]:.2f} tokens/s")
        if launches != want or plain:
            raise AssertionError(f"the {label} step did not go through K8, K7, K1 and K3 "
                                 "every layer")
        del model, state, step
        gc.collect()
        torch.cuda.empty_cache()
    (ep_metrics, ep_rate), (ref, ref_rate) = runs[True], runs[False]
    err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(ep_metrics, ref))
    print(f"EP step against the sparse step over {len(ref)} steps: losses within {err:.3e} "
          f"relative (limit {MESH_LOSS_RTOL}); {ep_rate:.2f} tokens/s against the sparse "
          f"step's {ref_rate:.2f} (capacity factor {EP_CAPACITY_FACTOR}: expert 0's group "
          f"also takes the {n_tokens * cfg.moe_top_k} unfilled bucket rows)")
    if err > MESH_LOSS_RTOL:
        raise AssertionError("the EP step's losses are off the sparse step's")

    # One step's loss and gradients of each route on the same weights, and
    # each block's share of tokens routed to other experts.
    grads, picks, losses = {}, {}, {}
    for ep in (False, True):
        model, state, step = ep_setup(template, mesh, "ep" if ep else "sparse", optimizer=None,
                                      grad_clip=None)
        inputs = []
        hooks = [block.ffn.register_forward_pre_hook(
            lambda mod, args: inputs.append(args[0].detach())) for block in model.module.blocks]
        losses[ep] = step(state, (tokens, tokens))["loss"].item()
        for hook in hooks:
            hook.remove()
        grads[ep] = {name: p.grad.float().clone() for name, p in model.module.named_parameters()}
        picks[ep] = [M._route(block.ffn.params(), cfg, x.reshape(-1, x.shape[-1]),
                              cfg.moe_top_k, need_probs=False)[2].sort(dim=-1).values
                     for block, x in zip(model.module.blocks, inputs)]
        del model, state, step, inputs
        gc.collect()
        torch.cuda.empty_cache()
    overall, per_block = grads_rel_l2(grads[True], grads[False], cfg.n_layers)
    flips = [(a != b).any(dim=-1).float().mean().item() for a, b in zip(picks[True], picks[False])]
    loss_err = abs(losses[True] - losses[False]) / abs(losses[False])
    print(f"EP step's loss and gradients of one step against the sparse step's: loss "
          f"{losses[True]!r} vs {losses[False]!r} ({loss_err:.3e} relative), gradients "
          f"relative L2 {overall:.3e} (limit {GRAD_REL_L2}); per block "
          + " ".join(f"{r:.2e}" for r in per_block) + "; tokens routed to other experts per "
          "block " + " ".join(f"{100 * x:.1f}%" for x in flips))
    if loss_err > MESH_LOSS_RTOL or not overall <= GRAD_REL_L2:
        raise AssertionError("the EP step's gradients are off the sparse step's")
    del grads, picks, template
    gc.collect()
    torch.cuda.empty_cache()
    return ep_metrics


@contextlib.contextmanager
def no_plain_hops():
    """Record the plain versions of K1-K5 and K10 and the plain hop forward."""
    with no_plain_versions() as calls, counting(RH, "hop_state_reference") as hops:
        yield (*calls, hops)


def run_of(kind: str, device, mesh, steps: int, warmup: int = 0):
    """``steps`` counted steps of ``kind`` on ``mesh`` from the seeded weights
    and batch ("pp:<schedule>": ViT-B/16 pipelined; "ep": MoE 8x124m
    expert-parallel; "tp": its dense oracle with the experts over 'tp';
    "dense": the same on one card; "sp": GPT-2 base at sp = the default
    group's size, zigzag): ``counted_steps``' results and the launches this
    rank should have made."""
    if kind.startswith("pp:"):
        template = build_model(VIT_B16, device=device)
        schedule = kind[3:]
        model, state, step = pp_setup(template, mesh, schedule)
        batch = PAR.shard_batch(vit_pp_batch(device), mesh)
        counters, plain = PP_COUNTERS, no_plain_versions
        want = pp_want(template.config, mesh, schedule, PP_MICRO, steps)
    elif kind in ("ep", "tp", "dense"):
        template = build_model(MOE_8X124M, device=device)
        tokens = moe_tokens(template.config, device)
        counters, plain = MOE_COUNTERS, no_moe_plain_versions
        model, state, step = ep_setup(template, mesh, kind)
        batch = PAR.shard_batch((tokens, tokens), mesh) if kind != "dense" else (tokens, tokens)
        want = moe_want(template.config, steps)
        if kind != "ep":  # the oracle: no grouped product; K1 and K3 at H / tp heads
            want = {name: count if name in ("fused_mha_packed", "packed_mha_bwd") else 0
                    for name, count in want.items()}
        if kind == "dense":
            plain = no_plain_versions  # the oracle is this route's FFN
    else:
        template = build_model(GPT2_BASE, device=device)
        tokens = moe_tokens(template.config, device)[:SP_BATCH]
        model, state, step = train_setup(template, None, lambda s, lr: SEQ.make_sp_train_step(
            zigzag=True, grad_clip=GRAD_CLIP, schedule=s, base_lr=lr), GPT2_OPTIMIZER)
        batch = (tokens, torch.roll(tokens, -1, dims=1))
        counters, plain = LM_COUNTERS, no_plain_hops
        sp = torch.distributed.get_world_size()
        per_layer = {1: SP_K9_PER_LAYER[True], 2: SP2_K9_PER_LAYER}[sp]
        want = {"fused_mha_packed": 0, "packed_mha_bwd": 0, "flash_attention": 0,
                "flash_bwd": 0, "hop_state": per_layer * template.config.n_layers * steps}
    del template
    result = counted_steps(lambda: step(state, batch), warmup, steps, counters, plain)
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return result, want


PARALLEL_MESHES = {"pp": PAR.build_pipeline_mesh, "ep": PAR.build_ep_mesh,
                   "tp": lambda n, dp: PAR.build_mesh(dp, n), "sp": lambda n, dp: None}


def parallel_rank(kind: str, dp: int, n: int) -> None:
    """A rank of ``parallel_ranks`` (``--parallel-rank <kind> <dp> <n>``):
    joins the launch's NCCL group on its card (VITEF_COORDINATOR_ADDRESS,
    VITEF_NUM_PROCESSES, VITEF_PROCESS_ID, VITEF_LOCAL_RANK), runs
    PARALLEL_STEPS steps of ``kind`` and prints its launches, the launches
    it should have made, its plain calls and its metrics on one
    PARALLEL_RANK_LINE."""
    local = int(os.environ.get("VITEF_LOCAL_RANK", "0"))
    torch.cuda.set_device(local)
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://{os.environ['VITEF_COORDINATOR_ADDRESS']}",
        world_size=int(os.environ["VITEF_NUM_PROCESSES"]),
        rank=int(os.environ["VITEF_PROCESS_ID"]))
    try:
        mesh = PARALLEL_MESHES[kind.split(":")[0]](n, dp)
        (metrics, launches, seconds, plain), want = run_of(kind, torch.device("cuda", local),
                                                           mesh, PARALLEL_STEPS)
        print(PARALLEL_RANK_LINE + json.dumps({
            "launches": launches, "want": want, "plain": dict(plain), "seconds": seconds,
            "loss": [m["loss"] for m in metrics], "grad_norm": [m["grad_norm"] for m in metrics]}))
    finally:
        torch.distributed.destroy_process_group()


def parallel_ranks(kind: str, dp: int, n: int, ref: list) -> None:
    """``kind`` over dp · n cards, one process a card as a user launches
    them, each a run of this script (``--parallel-rank``): every rank must
    exit 0 with the launches it should have made and no plain call, and its
    losses within MESH_LOSS_RTOL and grad norms within MESH_TP_NORM_RTOL of
    ``ref``, the one-card run's first PARALLEL_STEPS steps."""
    world = dp * n
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, str(Path(__file__).resolve()), "--parallel-rank", kind, str(dp),
           str(n)]
    procs = [subprocess.Popen(cmd, cwd=REPO_ROOT, env={
        **os.environ, "VITEF_COORDINATOR_ADDRESS": f"localhost:{port}",
        "VITEF_NUM_PROCESSES": str(world), "VITEF_PROCESS_ID": str(rank),
        "VITEF_LOCAL_RANK": str(rank)}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    t0 = time.perf_counter()
    try:
        outs = [proc.communicate(timeout=600)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    label = f"{kind} at dp {dp} x {n}"
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            raise AssertionError(f"{label}, rank {rank} exited {proc.returncode}:\n{out[-4000:]}")
    ranks = [json.loads(next(line for line in out.splitlines()
                             if line.startswith(PARALLEL_RANK_LINE))[len(PARALLEL_RANK_LINE):])
             for out in outs]
    errs = {key: max(abs(a - b[key]) / abs(b[key]) for r in ranks for a, b in zip(r[key], ref))
            for key in ("loss", "grad_norm")}
    print(f"{label} over {world} cards: loss {' '.join(repr(x) for x in ranks[0]['loss'])}; "
          f"grad_norm {' '.join(repr(x) for x in ranks[0]['grad_norm'])}; launches by rank "
          f"{[r['launches'] for r in ranks]} (want {[r['want'] for r in ranks]}); plain calls "
          f"{[r['plain'] for r in ranks]}; against one card: losses within {errs['loss']:.3e} "
          f"(limit {MESH_LOSS_RTOL}), grad norms within {errs['grad_norm']:.3e} (limit "
          f"{MESH_TP_NORM_RTOL}); {max(r['seconds'] for r in ranks):.2f} s for "
          f"{PARALLEL_STEPS} steps ({time.perf_counter() - t0:.2f} s with start-up)")
    if any(r["launches"] != r["want"] or r["plain"] for r in ranks):
        raise AssertionError(f"a rank of {label} missed a kernel or ran a plain version")
    if errs["loss"] > MESH_LOSS_RTOL or errs["grad_norm"] > MESH_TP_NORM_RTOL:
        raise AssertionError(f"{label} is off the one-card run")


def parallel_phase(device, card_line: str) -> None:
    """Phase 51, pipeline and expert parallelism in a one-rank NCCL group
    (as phase 50): ViT-B/16 pipelined at pp = 1 under GPipe and 1F1B
    (``pipeline_phase``), MoE 8x124m expert-parallel at ep = 1
    (``ep_phase``); with two cards or more, pp = 2 under both schedules,
    ep = 2, the MoE at tp = 2 and GPT-2 base at sp = 2, and with four,
    pp = 4 under both schedules (stages 2 and 3 post nothing in the first
    tick), (dp, pp) = (2, 2) and (dp, ep) = (2, 2), each held to the one-card
    run (``parallel_ranks``)."""
    world = torch.cuda.device_count()
    torch.cuda.set_device(device)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.distributed.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                         world_size=1, rank=0)
    try:
        print(f"phase 51 ({card_line.splitlines()[0]}): one-rank NCCL group of card 0"
              + (f"; the runs over {world} cards follow" if world > 1 else ""))
        pp = pipeline_phase(device, PAR.build_pipeline_mesh(1))
        ep = ep_phase(device, PAR.build_ep_mesh(1))
        refs = {}
        if world >= 2:  # the one-card runs the ranks are held to
            for kind in ("dense", "sp"):
                (metrics, _, _, _), _ = run_of(kind, device, PAR.build_mesh(), PARALLEL_STEPS)
                refs[kind] = metrics
    finally:
        torch.distributed.destroy_process_group()
    if world < 2:
        print("phase 51: one card, so pp = 2, ep = 2, the MoE at tp = 2 and sp = 2 (a process "
              "a card) are not run here")
        return
    first = PARALLEL_STEPS
    parallel_ranks("pp:gpipe", 1, 2, pp["gpipe"][:first])
    parallel_ranks("pp:1f1b", 1, 2, pp["1f1b"][:first])
    parallel_ranks("ep", 1, 2, ep[:first])
    parallel_ranks("tp", 1, 2, refs["dense"])
    parallel_ranks("sp", 1, 2, refs["sp"])
    if world >= 4:
        parallel_ranks("pp:gpipe", 1, 4, pp["gpipe"][:first])
        parallel_ranks("pp:1f1b", 1, 4, pp["1f1b"][:first])
        parallel_ranks("pp:1f1b", 2, 2, pp["1f1b"][:first])
        parallel_ranks("ep", 2, 2, ep[:first])


# ---------------------------------------------------------------------------
# FSDP by unit: phase 52
# ---------------------------------------------------------------------------

# Llama-3.1-8B ("8b", all 32 layers, bf16 compute, float32 weights) through
# bench_llama's step under shard_params(fsdp=True) at dp = FSDP_WORLD, 4 x 512
# a rank, FSDP_WARMUP + FSDP_TIMED steps; its 8-layer cut (phase 40's seed-0
# weights) at 2 x 512 a rank for FSDP_CHECK_STEPS steps, held to one card at
# 8 x 512 within MESH_LOSS_RTOL (losses) and MESH_TP_NORM_RTOL (grad norms).
FSDP_WORLD, FSDP_ROWS, FSDP_WARMUP, FSDP_TIMED, FSDP_CHECK_STEPS = 4, 4, 2, 5, 3
FSDP_RANK_LINE = "fsdp rank: "


def sharded_llama(cfg, mesh, device, seed: int) -> Model:
    """A Llama of ``cfg`` under ``shard_params(fsdp=True)`` on ``mesh``, built
    on the meta device and then drawn on the card one whole tensor at a time
    (each from its own generator seeded from ``seed``: the rms norms ones,
    the token table N(0, 1), each linear U(±1/√fan_in), the port's init),
    of which the rank keeps its shard: no rank holds the whole model."""
    with torch.device("meta"):
        module = Transformer(cfg, device=torch.device("meta"),
                             generator=torch.Generator())
    PAR.shard_params(module, mesh, fsdp=True)
    layout = module.mesh_layout
    module.to_empty(device=device)  # the shards, uninitialised
    gen = torch.Generator(device=device)
    with torch.no_grad():
        for i, (name, p) in enumerate(module.named_parameters()):
            whole = torch.empty(layout.full_shapes[name], device=device)
            gen.manual_seed(seed * 100_003 + i)
            if name.endswith("norm.weight"):
                whole.fill_(1.0)
            elif name == "embedding.token_emb.weight":
                whole.normal_(generator=gen)
            else:
                bound = 1.0 / math.sqrt(whole.shape[-1])
                whole.uniform_(-bound, bound, generator=gen)
            p.copy_(layout.local(name, whole))
            del whole
    return Model(module=module, config=cfg, name="llama")


def fsdp_rank(world: int) -> None:
    """A rank of ``fsdp_phase`` (``--fsdp-rank <world>``): joins the launch's
    NCCL group on its card, then (1) "check": the 8-layer cut from phase
    40's seed-0 weights at dp = world, FSDP_CHECK_STEPS steps on its rows of
    8 x 512; (2) "full": the 32-layer 8B drawn on the card
    (``sharded_llama``) at FSDP_ROWS x 512 a rank, FSDP_WARMUP + FSDP_TIMED
    steps. Prints each run's metrics, its timed steps' launches, plain
    calls and seconds, its peak memory and its gathered high-water mark on
    one FSDP_RANK_LINE."""
    local = int(os.environ.get("VITEF_LOCAL_RANK", "0"))
    device = torch.device("cuda", local)
    torch.cuda.set_device(device)
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://{os.environ['VITEF_COORDINATOR_ADDRESS']}",
        world_size=world, rank=int(os.environ["VITEF_PROCESS_ID"]))
    out = {}
    try:
        mesh = PAR.build_mesh(world, 1)
        for label, shape, warmup, timed in (
                ("check", L8B_PACKED, 0, FSDP_CHECK_STEPS),
                ("full", (FSDP_ROWS * world, L8B_PACKED[1]), FSDP_WARMUP, FSDP_TIMED)):
            if label == "check":
                model = PAR.shard_params(seeded_llama(L8B_TRAIN_LAYERS, device), mesh,
                                         fsdp=True)
            else:
                model = sharded_llama(l8b_config(32), mesh, device, seed=0)
            layout = model.module.mesh_layout
            _, one_step = bench_llama_step(model, device, shape, mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            layout.peak_held = 0
            metrics, launches, seconds, plain = counted_steps(one_step, warmup, timed,
                                                              FLASH_COUNTERS)
            shard = sum(p.numel() for p in model.module.parameters())
            out[label] = {
                "loss": [m["loss"] for m in metrics],
                "grad_norm": [m["grad_norm"] for m in metrics], "launches": launches,
                "plain": dict(plain), "seconds": seconds,
                "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
                "held_gib": layout.peak_held * 4 / 2**30, "shard_gib": shard * 4 / 2**30}
            del model, layout, one_step, metrics
            gc.collect()
            torch.cuda.empty_cache()
        print(FSDP_RANK_LINE + json.dumps(out))
    finally:
        torch.distributed.destroy_process_group()


def fsdp_phase(device, card_line: str) -> None:
    """Phase 52, FSDP by unit across FSDP_WORLD cards (fewer: not run): the
    8-layer 8B on card 0 alone (phase 40's seed-0 weights, 8 x 512,
    FSDP_CHECK_STEPS steps), then ``fsdp_rank`` on every card as a user
    launches it; every rank's 8-layer losses and grad norms held to card
    0's, its 32-layer launches K1 causal = K3 = 32 a step (K4 = K5 = 0) and
    no plain call, its 32-layer losses falling; tokens/s over the cards and
    the share of their bf16 roofline, each run's peak memory a rank."""
    world = torch.cuda.device_count()
    if world < FSDP_WORLD:
        print(f"phase 52: {world} card(s), so the 8B under FSDP at dp = {FSDP_WORLD} "
              "is not run here")
        return
    torch.cuda.set_device(device)
    _, one_step = bench_llama_step(seeded_llama(L8B_TRAIN_LAYERS, device), device,
                                   L8B_PACKED)
    torch.cuda.reset_peak_memory_stats(device)
    ref, _, _, _ = counted_steps(one_step, 0, FSDP_CHECK_STEPS, FLASH_COUNTERS)
    one_peak = torch.cuda.max_memory_allocated(device) / 2**30
    del one_step
    gc.collect()
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, str(Path(__file__).resolve()), "--fsdp-rank", str(FSDP_WORLD)]
    procs = [subprocess.Popen(cmd, cwd=REPO_ROOT, env={
        **os.environ, "VITEF_COORDINATOR_ADDRESS": f"localhost:{port}",
        "VITEF_NUM_PROCESSES": str(FSDP_WORLD), "VITEF_PROCESS_ID": str(rank),
        "VITEF_LOCAL_RANK": str(rank)}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(FSDP_WORLD)]
    t0 = time.perf_counter()
    try:
        outs = [proc.communicate(timeout=900)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            raise AssertionError(f"fsdp rank {rank} exited {proc.returncode}:\n"
                                 f"{out[-4000:]}")
    ranks = [json.loads(next(line for line in out.splitlines()
                             if line.startswith(FSDP_RANK_LINE))[len(FSDP_RANK_LINE):])
             for out in outs]

    def peaks(run: str) -> str:
        r = ranks[0][run]
        return (f"peak {[round(rank[run]['peak_gib'], 3) for rank in ranks]} GiB a rank, "
                f"shards {r['shard_gib']:.3f} GiB, gathered at most "
                f"{r['held_gib']:.3f} GiB")

    errs = {key: max(abs(a - b[key]) / abs(b[key]) for r in ranks
                     for a, b in zip(r["check"][key], ref))
            for key in ("loss", "grad_norm")}
    check = ranks[0]["check"]
    print(f"phase 52 ({card_line.splitlines()[0]}): the 8B at {L8B_TRAIN_LAYERS} layers, "
          f"dp {FSDP_WORLD} x 2 x 512 against one card at 8 x 512: loss "
          f"{' '.join(repr(x) for x in check['loss'])} (one card "
          f"{' '.join(repr(m['loss']) for m in ref)}); grad_norm "
          f"{' '.join(repr(x) for x in check['grad_norm'])} (one card "
          f"{' '.join(repr(m['grad_norm']) for m in ref)}); losses within "
          f"{errs['loss']:.3e} (limit {MESH_LOSS_RTOL}), grad norms within "
          f"{errs['grad_norm']:.3e} (limit {MESH_TP_NORM_RTOL}); {peaks('check')} "
          f"(one card {one_peak:.3f})")
    cfg = l8b_config(32)
    full = [r["full"] for r in ranks]
    want = {"fused_mha_packed": cfg.n_layers * FSDP_TIMED,
            "packed_mha_bwd": cfg.n_layers * FSDP_TIMED, "flash_attention": 0,
            "flash_bwd": 0}
    seconds = max(r["seconds"] for r in full)
    rate = FSDP_ROWS * FSDP_WORLD * L8B_PACKED[1] * FSDP_TIMED / seconds
    roofline = FSDP_WORLD * PEAK_BF16_FLOPS / llama_flops_per_token(cfg, L8B_PACKED[1])
    losses = full[0]["loss"]
    print(f"phase 52: Llama-3.1-8B at {cfg.n_layers} layers under FSDP over {FSDP_WORLD} "
          f"cards, {FSDP_ROWS} x {L8B_PACKED[1]} a rank, {FSDP_WARMUP} warm-up + "
          f"{FSDP_TIMED} timed steps: loss {' '.join(f'{x:.4f}' for x in losses)}; "
          f"grad_norm {' '.join(f'{x:.4f}' for x in full[0]['grad_norm'])}; {rate:.2f} "
          f"tokens/s ({seconds / FSDP_TIMED * 1e3:.3f} ms a step), "
          f"{rate / roofline:.4f} of "
          f"the {roofline:.0f} tokens/s bf16 roofline of {FSDP_WORLD} cards; "
          f"{peaks('full')}; launches by rank {[r['launches'] for r in full]} (want "
          f"{want}); plain calls {[r['plain'] for r in full]} "
          f"({time.perf_counter() - t0:.2f} s with start-up)")
    if errs["loss"] > MESH_LOSS_RTOL or errs["grad_norm"] > MESH_TP_NORM_RTOL:
        raise AssertionError("the 8-layer 8B under FSDP is off the one-card run")
    if any(r["launches"] != want or r["plain"] for r in full):
        raise AssertionError("a rank of the 32-layer 8B missed K1/K3 or ran a plain "
                             "version")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the 32-layer 8B loss did not fall: {losses}")


def spec_pair_requests() -> list:
    """SPEC_PAIR_REQUESTS greedy requests whose prompts are the Markov
    chain's (``markov_batches`` seed 3): 32-128 tokens each and 32-128 new,
    from default_rng(3)."""
    rng = np.random.default_rng(3)
    x, _ = next(DSP.markov_batches(1, seed=3))
    reqs = []
    for row in x[:SPEC_PAIR_REQUESTS].tolist():
        plen, mnew = int(rng.integers(32, 129)), int(rng.integers(32, 129))
        reqs.append(SRV.Request(prompt=row[:plen], max_new_tokens=mnew))
    return reqs


def pair_training(label: str, run, steps: int, want: dict) -> list[float]:
    """``run()`` (a tool's training loop, returning its per-step losses)
    with the attention counters reset and the plain versions recorded:
    prints its seconds and launches a step, and fails on other launches
    than ``want`` a step, a plain call or a loss that does not fall."""
    with no_plain_versions() as (plain_calls, aug_calls):
        for counter in FLASH_COUNTERS:
            counter.launches = 0
        A.fused_mha_packed.masked_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in FLASH_COUNTERS}
        launches["masked"] = A.fused_mha_packed.masked_launches
    per_step = {name: count / steps for name, count in launches.items()}
    print(f"phase 53 {label}: {steps} steps in {seconds:.2f} s ({seconds / steps * 1e3:.3f} ms a "
          f"step, Markov draws on the host included); loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"launches a step {per_step} (want {want}); plain calls "
          f"{dict(Counter(plain_calls + aug_calls))}")
    if per_step != {**dict.fromkeys(launches, 0.0), **want} or plain_calls or aug_calls:
        raise AssertionError(f"phase 53 {label} launched {per_step}, want {want}")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"phase 53 {label}: the loss did not fall: {losses[::50]}")
    return losses


def spec_pair_phase(device, card_line: str) -> None:
    """Phase 53, the trained speculative pair: ``distill_spec_pair`` at its
    full defaults on the card (its loss and KL printed every 50 and 100
    steps; K1 causal = K3 = 12 a target step, K1 14 and K3 2 a distillation
    step, no plain version; both losses falling), the pair saved and read
    back through the JAX layout; ``profile_speculative``'s rows at
    ``--trained``: the distilled draft's sampled alpha (T 0.8) strictly
    inside (0, 1) at every gamma and its greedy alpha above 0 (on order-1
    Markov data greedy acceptance is 1 by construction: the target's argmax
    is a function of the current token alone, which the draft learns; the
    JAX tool's own record reads 1.00 there and 0.50-0.71 sampled), both
    greedy speculative streams equal to plain ``generate``
    under the near-tie rule, the self-draft's rejections all rounding ones
    (``self_draft_exact``); then the speculative ``DecodeServer`` against
    the plain one on the same SPEC_PAIR_REQUESTS Markov requests: each
    stream under the near-tie rule, K1 once a target and a draft layer an
    admission, both rates."""
    target, draft = DSP.gpt2ish(12, 0, device), DSP.gpt2ish(2, 7, device)
    n_t, n_d = target.config.n_layers, draft.config.n_layers
    pair_training("target training", lambda: DSP.train_target(target), DSP.TARGET_STEPS,
                  {"fused_mha_packed": n_t, "packed_mha_bwd": n_t})
    pair_training("draft distillation", lambda: DSP.distill_draft(draft, target),
                  DSP.DRAFT_STEPS, {"fused_mha_packed": n_t + n_d, "packed_mha_bwd": n_d})
    with tempfile.TemporaryDirectory() as pair_dir:
        DSP.save_pair(target, draft, Path(pair_dir))
        loaded = PSP.load_trained_pair(DSP.gpt2ish(12, 0, device), DSP.gpt2ish(2, 7, device),
                                       pair_dir)
    if not all(torch.equal(a, b) for model, back in zip((target, draft), loaded)
               for a, b in zip(model.module.state_dict().values(),
                               back.module.state_dict().values())):
        raise AssertionError("the saved pair did not read back bit for bit")
    del target, draft
    gc.collect()
    torch.cuda.empty_cache()
    target, draft = loaded

    prompt = PSP.prompt_of(True, device)
    print(f"phase 53 profile_speculative --trained ({card_line}):")
    rows = {row["name"]: row for row in PSP.profile_rows(target, draft, prompt, PSP.NEW)}
    with logits_margins() as margins:
        want = target.generate(prompt, PSP.NEW, temperature=0.0)
    want, margins = want[0].tolist(), torch.cat(margins).tolist()
    self_run = spec_run(target, target, prompt, PSP.NEW)
    alpha = rows["draft-2L g=4"]["alpha"]
    sampled = {name: row["alpha"] for name, row in rows.items() if "T=0.8 g=" in name}
    verdicts = {name: near_tie(rows[name]["tokens"], want, margins)
                for name in ("draft-2L g=4", "self-draft g=4")}
    print("phase 53: alpha by row " + ", ".join(
        f"{name} {row['alpha']!r}" for name, row in rows.items() if "alpha" in row)
        + f"; plain greedy {rows['plain greedy']['tok_s']:.2f} tokens/s, the distilled draft's "
        f"greedy {rows['draft-2L g=4']['tok_s']:.2f}; greedy streams against plain generate "
        f"(near-tie rule, {NEAR_TIE:g}): {verdicts}; the self-draft (spec_run) accepted "
        f"{self_run['stats']['accepted']}/{self_run['stats']['drafted']}, first rejections "
        f"{self_run['rejected'][:8]}, caches {self_run['cache_rel']:.3e} apart")
    if not (0.0 < alpha <= 1.0 and len(sampled) == 4
            and all(0.0 < a < 1.0 for a in sampled.values())):
        raise AssertionError(f"the distilled draft's acceptance is degenerate: greedy {alpha}, "
                             f"sampled {sampled} (want greedy above 0 and every sampled alpha "
                             "inside (0, 1))")
    if not all(ok for ok, _ in verdicts.values()):
        raise AssertionError(f"a greedy speculative stream leaves plain generate outside a "
                             f"near tie: {verdicts}")
    if not self_draft_exact(self_run):
        raise AssertionError("the trained self-draft rejected a proposal outside a near tie "
                             "or its cache left the target's")

    cfg = target.config
    plain_srv = SRV.DecodeServer(target.module, cfg, **SPEC_PAIR_SERVER)
    spec_srv = SRV.DecodeServer(target.module, cfg, **SPEC_PAIR_SERVER, draft_params=draft,
                                gamma=SPEC_GAMMA)
    rates = {}
    for label, srv in (("plain", plain_srv), ("speculative", spec_srv)):
        srv.serve([SRV.Request(prompt=r.prompt, max_new_tokens=4)
                   for r in spec_pair_requests()[:2]])
        srv.reset()
        reqs = spec_pair_requests()
        with k1_widths() as widths, no_plain_versions() as (plain_calls, _):
            A.fused_mha_packed.launches = A.fused_mha_packed.masked_launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.serve(reqs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = (A.fused_mha_packed.launches, A.fused_mha_packed.masked_launches)
        useful = sum(r.max_new_tokens for r in reqs)
        rates[label] = (reqs, useful / seconds, seconds, dict(widths), launches)
        layers = n_t + (n_d if srv is spec_srv else 0)
        if (dict(widths) != {64: layers * len(reqs)} or launches != (layers * len(reqs), 0)
                or plain_calls):
            raise AssertionError(f"the {label} server launched K1 {dict(widths)} {launches}; "
                                 f"plain calls {Counter(plain_calls)}")
        if not all(r.done and len(r.tokens) == r.max_new_tokens for r in reqs):
            raise AssertionError(f"a request did not get its max_new_tokens from the {label} "
                                 "server")
    plain_srv.reset()
    margin_reqs = spec_pair_requests()
    with stream_margins(plain_srv) as stream:
        plain_srv.serve(margin_reqs)
    served = [near_tie(r.tokens, p.tokens, stream[id(p)])
              for r, p in zip(rates["speculative"][0], margin_reqs)]
    equal = sum(what == "equal" for _, what in served)
    print(f"phase 53 DecodeServer ({card_line}), {SPEC_PAIR_SERVER}, {SPEC_PAIR_REQUESTS} "
          f"Markov requests ({sum(r.max_new_tokens for r in margin_reqs)} tokens): plain "
          f"{rates['plain'][1]:.2f} tokens/s ({rates['plain'][2]:.3f} s), speculative "
          f"(the distilled draft, gamma {SPEC_GAMMA}) {rates['speculative'][1]:.2f} tokens/s "
          f"({rates['speculative'][2]:.3f} s, {spec_srv.spec_rounds} rounds, "
          f"{spec_srv.spec_committed / max(spec_srv.spec_rounds, 1):.3f} tokens committed a "
          f"round over {SPEC_PAIR_SERVER['n_slots']} slots); K1 by head width "
          f"{rates['plain'][3]} and {rates['speculative'][3]}; speculative streams equal to "
          f"the plain server's: {equal} of {len(served)}; "
          + "; ".join(f"request {i}: {what}" for i, (_, what) in enumerate(served)
                      if what != "equal")[:2000])
    if not all(ok for ok, _ in served):
        raise AssertionError("a speculative server stream leaves the plain server's outside "
                             "a near tie")


def stopwatch():
    """A function that prints the seconds since the script's start and since
    its last call, beside a label: where the script's time limit goes."""
    start = last = time.perf_counter()

    def stamp(label: str) -> None:
        nonlocal last
        now = time.perf_counter()
        print(f"[{now - start:.1f} s] {label}: {now - last:.1f} s")
        last = now

    return stamp


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    device = torch.device("cuda", 0)
    card_line = card()
    print(card_line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    stamp = stopwatch()

    build_phase()
    stamp("the build")
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
                                                   seed=15, iters=10),
              "flash_fwd:float32:d8": flash_fwd_phase(device, torch.float32, FLASH_FP32_D8,
                                                      seed=16, iters=10, d=8),
              "flash_bwd:float32:d8": flash_bwd_phase(device, torch.float32, FLASH_FP32_D8,
                                                      seed=17, iters=10, d=8),
              "flash_fwd:float32:d128": flash_fwd_phase(device, torch.float32,
                                                        FLASH_FP32_D128, seed=18, iters=10,
                                                        d=128),
              "flash_bwd:float32:d128": flash_bwd_phase(device, torch.float32,
                                                        FLASH_FP32_D128, seed=19, iters=10,
                                                        d=128)}
    for i, name in enumerate(GROUPED):
        timing[name] = grouped_phase(device, name, seed=20 + i, iters=10)
    swiglu_y_phase(device, seed=29)
    timing.update(layernorm_phase(device, seed=30, iters=20))
    timing["packed_mha_fwd:masked"] = masked_phase(device, seed=40, iters=20,
                                                   k1_ms=timing["packed_mha_fwd"]["ms"])
    timing["ring_hop"] = ring_hop_phase(device, seed=50, iters=10)
    timing.update(d80_phases(device, SIZES["ViT-H/14"][1]))
    timing.update(k1_d128_phase(device, seed=70, iters=10))
    timing.update(d128_train_kernel_phases(device))
    timing.update(d8_phases(device))
    stamp("the kernel phases")
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
    stamp("the ViT train phases")
    analysis_phase(device)
    gc.collect()
    torch.cuda.empty_cache()
    probing_phase(device)
    gc.collect()
    torch.cuda.empty_cache()
    stamp("analysis and probing")
    probe = None
    try:
        data, probe = vit_apps_phase(device, card_line)
        gc.collect()
        torch.cuda.empty_cache()
        stamp("the ViT apps")
        print("phase 35's seconds below are taken while phase 34's linear-probing "
              "subprocess shares the card")
        plots_phase(card_line, data)
        probe_result(probe)
    finally:
        if probe is not None and probe[0].poll() is None:
            probe[0].kill()
            probe[0].wait()
        shutil.rmtree(APPS_ROOT, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    stamp("the figures")

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
    stamp("GPT-2 and Llama-1B training")

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
    stamp("MoE training")

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
    stamp("GPT-2 serving")
    ring_launches = sp_train_phase(device)
    gc.collect()
    torch.cuda.empty_cache()
    stamp("sequence parallelism")
    l8b_train = l8b_train_phase(device)
    stamp("Llama-3.1-8B training")
    l8b_launches = l8b_phase(device, card_line)
    gc.collect()
    torch.cuda.empty_cache()
    stamp("Llama-3.1-8B serving")
    with phase_clock("45 (MoE decode)", device):
        moe_serve_phase(device, card_line)
    stamp("MoE decode")
    with phase_clock("47 (PatchTST)", device):
        patchtst_launches = patchtst_phase(device)
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("48 (remat)", device):
        remat_phase(device)
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("49 (dropout)", device):
        dropout_phase(device)
    stamp("PatchTST, remat and dropout")
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("50 (mesh)", device):
        mesh_phase(device, card_line)
    stamp("the mesh")
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("51 (pipeline and expert parallelism)", device):
        parallel_phase(device, card_line)
    stamp("pipeline and expert parallelism")
    with phase_clock("52 (FSDP by unit)", device):
        fsdp_phase(device, card_line)
    stamp("FSDP by unit")
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock("53 (the trained speculative pair)", device):
        spec_pair_phase(device, card_line)
    stamp("the trained speculative pair")

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
        ("packed_mha_fwd:causal:d128", "packed_mha_fwd",
         l8b_train["packed"]["fused_mha_packed"], "vitef_tpu/ops/attention.py:99"),
        ("packed_mha_bwd:causal:d128", "packed_mha_bwd",
         l8b_train["packed"]["packed_mha_bwd"], "vitef_tpu/ops/attention.py:181"),
        ("flash_fwd:d128", "flash_fwd", l8b_train["flash"]["flash_attention"],
         "vitef_tpu/ops/attention.py:490"),
        ("flash_bwd:d128", "flash_bwd", l8b_train["flash"]["flash_bwd"],
         "vitef_tpu/ops/attention.py:588"),
        ("packed_mha_fwd:d8", "packed_mha_fwd", patchtst_launches["fused_mha_packed"],
         "vitef_tpu/ops/attention.py:99"),
        ("packed_mha_bwd:d8", "packed_mha_bwd", patchtst_launches["packed_mha_bwd"],
         "vitef_tpu/ops/attention.py:270"),
        # no preset takes the causal modes at d = 8: no launch on a path
        ("packed_mha_bwd:causal:d8", "packed_mha_bwd", 0, "vitef_tpu/ops/attention.py:181"),
        ("flash_fwd:float32:d8", "flash_fwd", patchtst_launches["fp32:flash_attention"],
         "vitef_tpu/ops/attention.py:490"),
        ("flash_bwd:float32:d8", "flash_bwd", patchtst_launches["fp32:flash_bwd"],
         "vitef_tpu/ops/attention.py:588"),
        # no preset takes float32 attention at d = 128 (the plain grouped einsum)
        ("flash_fwd:float32:d128", "flash_fwd", 0, "vitef_tpu/ops/attention.py:490"),
        ("flash_bwd:float32:d128", "flash_bwd", 0, "vitef_tpu/ops/attention.py:588"),
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
    if sys.argv[1:2] == ["--mesh-train"]:
        mesh_train_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4:5] == ["fsdp"])
    elif sys.argv[1:2] == ["--mesh-serve"]:
        mesh_serve_rank(int(sys.argv[2]), int(sys.argv[3]))
    elif sys.argv[1:2] == ["--parallel-rank"]:
        parallel_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    elif sys.argv[1:2] == ["--fsdp-rank"]:
        fsdp_rank(int(sys.argv[2]))
    else:
        main()
