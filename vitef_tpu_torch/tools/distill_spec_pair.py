"""A target and draft pair that accept each other partly, for speculative decoding.

Counterpart of ``tools/distill_spec_pair.py``. At random weights a decoder
degenerates into repeated tokens, so a random draft "accepts" near 100% (or,
unrelated to its target, near 0%): neither says what a real draft gives.
This tool builds a pair whose acceptance alpha lies strictly between, with
no download:

1. train the GPT-2-small-shaped target (12 layers, seed 0) for 300 AdamW
   steps at lr 3e-4 on synthetic order-1 Markov sequences over 2,048 of its
   50,257 ids (about 8 successors a state: varied but learnable);
2. distil a 2-layer draft of the same width (seed 7) from the target's
   logits for 600 steps at lr 6e-4, minimising KL(target || draft);
3. save both under ``MODEL_DIR / "spec_pair"`` as ``target.npz`` and
   ``draft.npz`` in the JAX package's flat dotted-path layout
   (``to_jax_params``), which ``tools/profile_speculative.py --trained`` and
   :mod:`vitef_tpu_torch.tools.profile_speculative` both read.

The Markov draws are the JAX tool's, bit for bit (the same numpy calls in
the same order). AdamW is ``optax.adamw``'s defaults: b1 0.9, b2 0.999, eps
1e-8 outside the square root, weight decay 1e-4 on every parameter, no clip
and no schedule. The target's loss is the mean softmax cross entropy of its
float32 logits; the draft's is KL(target || draft) in float32, summed over
the vocabulary and averaged over positions, the target's logits taken with
no gradient.

Run from the repo root: ``python -m vitef_tpu_torch.tools.distill_spec_pair``
(on the card; ``--device cpu`` on the CPU, where a step of the full-size
target takes seconds).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..config import MODEL_DIR
from ..models import build_model
from ..models.convert import to_jax_params

VOCAB = 50257
EFF_VOCAB = 2048   # Markov support: keeps the transition table small
SEQ = 256
BATCH = 16
WEIGHT_DECAY = 1e-4  # optax.adamw's default (torch.optim.AdamW's is 1e-2)
TARGET_STEPS, TARGET_LR = 300, 3e-4
DRAFT_STEPS, DRAFT_LR = 600, 6e-4


def gpt2ish(layers: int, seed: int, device="cuda"):
    """A GPT-2-small-width decoder (E 768, 12 heads, tied head, bf16 compute)
    of ``layers`` blocks, drawn from ``seed``."""
    return build_model(dict(
        implementation="transformer", vocab_size=VOCAB, emb_type="dict",
        emb_dim=768, n_heads=12, n_layers=layers, seq_len=1024, causal=True,
        pre_norm=True, weight_tying=True, output_type="sequence_to_sequence",
        attn_bias=True, ffn_bias=True, norm_bias=True,
        compute_dtype="bfloat16", seed=seed), device=device)


def markov_batches(n_steps: int, seed: int = 0):
    """Order-1 Markov chain over EFF_VOCAB tokens, ~8 successors per state:
    ``n_steps`` pairs of (BATCH, SEQ) int64 CPU tensors, inputs and their
    next tokens. The numpy draws are the JAX tool's, in its order: the
    successor table, the transition CDFs, then per step the first column
    and one ``rng.random(BATCH)`` a position."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, EFF_VOCAB, size=(EFF_VOCAB, 8))
    cum = rng.dirichlet(np.full(8, 0.6), size=EFF_VOCAB).cumsum(axis=1)
    for _ in range(n_steps):
        toks = np.empty((BATCH, SEQ + 1), np.int64)
        toks[:, 0] = rng.integers(0, EFF_VOCAB, size=BATCH)
        for t in range(SEQ):
            cur = toks[:, t]
            u = rng.random(BATCH)  # inverse-CDF draw, vectorized over batch
            choice = np.minimum((u[:, None] > cum[cur]).sum(axis=1), 7)
            toks[:, t + 1] = succ[cur, choice]
        toks = torch.from_numpy(toks)
        yield toks[:, :-1], toks[:, 1:]


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; to the card from pinned memory without waiting,
    so that the host draws the next batch while the card computes."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def adamw(module: torch.nn.Module, lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)`` over every parameter of ``module``."""
    return torch.optim.AdamW(module.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=WEIGHT_DECAY)


def _run(step, batches, every: int, label: str, metric: str, device) -> list[float]:
    """``step(x, y)`` (a 0-d loss tensor) over ``batches``, printing
    ``"<label> <i>: <metric> <value> (<seconds>s)"`` every ``every`` steps;
    returns every step's loss, read back once at the end (and at each
    print)."""
    losses = []
    t0 = time.perf_counter()
    for i, (x, y) in enumerate(batches):
        losses.append(step(_on(x, device), _on(y, device)))
        if (i + 1) % every == 0:
            print(f"{label} {i + 1}: {metric} {float(losses[-1]):.3f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    return torch.stack(losses).tolist() if losses else []


def train_target(model, n_steps: int = TARGET_STEPS, lr: float = TARGET_LR) -> list[float]:
    """Train ``model`` (a seq2seq decoder) in place on ``markov_batches(n_steps,
    seed=1)`` with AdamW: the mean softmax cross entropy of its float32
    logits against the next tokens. Returns each step's loss."""
    module = model.module
    device = next(module.parameters()).device
    opt = adamw(module, lr)
    module.train()

    def step(x, y):
        logits = module(x)
        loss = torch.nn.functional.cross_entropy(logits.float().flatten(0, 1), y.flatten())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    try:
        return _run(step, markov_batches(n_steps, seed=1), 50, "target step", "loss", device)
    finally:
        module.eval()


def distill_draft(draft, target, n_steps: int = DRAFT_STEPS, lr: float = DRAFT_LR) -> list[float]:
    """Distil ``draft`` in place from ``target``'s logits on
    ``markov_batches(n_steps, seed=2)`` with AdamW: KL(target || draft) in
    float32, summed over the vocabulary and averaged over positions, the
    target's logits under ``torch.no_grad()``. Returns each step's KL."""
    module, teacher = draft.module, target.module
    device = next(module.parameters()).device
    opt = adamw(module, lr)
    module.train()
    teacher.eval()

    def step(x, _):
        with torch.no_grad():
            t_logp = torch.log_softmax(teacher(x).float(), dim=-1)
        d_logp = torch.log_softmax(module(x).float(), dim=-1)
        loss = torch.mean(torch.sum(torch.exp(t_logp) * (t_logp - d_logp), dim=-1))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    try:
        return _run(step, markov_batches(n_steps, seed=2), 100, "distill step", "KL", device)
    finally:
        module.eval()


def save_pair(target, draft, out_dir: Path) -> None:
    """``target.npz`` and ``draft.npz`` under ``out_dir``, in the JAX
    package's flat dotted-path layout (linear weights (in, out))."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for model, name in ((target, "target"), (draft, "draft")):
        np.savez(out_dir / f"{name}.npz", **to_jax_params(model.module.state_dict()))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("distill_spec_pair: no CUDA device (pass --device cpu for the CPU)")
    out_dir = MODEL_DIR / "spec_pair"
    target = gpt2ish(12, 0, device)
    draft = gpt2ish(2, 7, device)
    print("training target on Markov data...", flush=True)
    train_target(target)
    print("distilling draft...", flush=True)
    distill_draft(draft, target)
    save_pair(target, draft, out_dir)
    print(f"saved pair under {out_dir}", flush=True)


if __name__ == "__main__":
    main()
