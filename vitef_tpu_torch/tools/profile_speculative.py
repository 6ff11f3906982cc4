"""Batch-1 decode latency: plain ``generate`` against speculative decoding.

Counterpart of ``tools/profile_speculative.py``. The target is the
GPT-2-small-shaped decoder of :mod:`.distill_spec_pair` (12 layers, seed
0), the draft its 2-layer decoder of the same width (seed 7). At random
weights the acceptance is what an unrelated draft gives, and the self-draft
row shows the mechanical upper bound of full acceptance; with ``--trained``
the pair is the distilled one that :mod:`.distill_spec_pair` saved, whose
acceptance alpha lies strictly between. ``--int8`` decodes both with
weight-only int8 weights (``Model.quantize_int8``).

Rows: plain greedy and plain sampled at T 0.8, then speculative decoding
with the 2-layer draft at gamma 4 (greedy), with the target drafting for
itself at gamma 4 (greedy), and with the 2-layer draft at T 0.8 for gamma
2, 3, 4 and 6; each warmed up once and then timed, with its ms, tokens/s
and, for speculative rows, its rounds, accepted/drafted proposals, alpha
and whether its tokens equal plain greedy decoding's. The prompt is 64
tokens from ``default_rng(0)`` over 2,048 ids (the Markov chain's support)
with ``--trained``, else over the 50,257 of the vocabulary; 128 new tokens.

Run from the repo root: ``python -m vitef_tpu_torch.tools.profile_speculative
[--trained] [--int8]`` (on the card; ``--device cpu`` on the CPU).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..config import MODEL_DIR
from ..models.convert import from_jax_params
from ..models.generation import generate
from ..models.speculative import generate_speculative
from .distill_spec_pair import EFF_VOCAB, VOCAB, gpt2ish

PROMPT_LEN, NEW = 64, 128
TEMPERATURE = 0.8


def load_trained_pair(target, draft, pair_dir: Path | None = None):
    """Load the distilled pair that :mod:`.distill_spec_pair` saved
    (``target.npz`` and ``draft.npz`` under ``MODEL_DIR / "spec_pair"``, the
    JAX package's flat layout) into the two models' modules in place."""
    pair_dir = MODEL_DIR / "spec_pair" if pair_dir is None else Path(pair_dir)
    for model, name in ((target, "target"), (draft, "draft")):
        with np.load(pair_dir / f"{name}.npz") as z:
            flat = {k: z[k] for k in z.files}
        model.module.load_state_dict(from_jax_params(flat))
    return target, draft


def prompt_of(trained: bool, device) -> torch.Tensor:
    """The (1, PROMPT_LEN) prompt: ids from ``default_rng(0)`` over the
    Markov chain's EFF_VOCAB with ``trained``, else over VOCAB."""
    ids = np.random.default_rng(0).integers(0, EFF_VOCAB if trained else VOCAB,
                                            size=(1, PROMPT_LEN))
    return torch.from_numpy(ids).to(device)


def _timed(fn, device) -> tuple[object, float]:
    """``fn()`` and its seconds, the device drained before and after."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def profile_rows(target, draft, prompt, new: int = NEW, *, int8: bool = False) -> list[dict]:
    """The tool's rows for ``target`` and ``draft`` (Models) on ``prompt``
    (1, P), printed as the JAX tool prints them. Each row: ``name``,
    ``ms``, ``tok_s``, ``tokens`` (the timed call's, a list) and, for a
    speculative row, ``rounds``, ``accepted``, ``drafted``, ``alpha`` and
    ``greedy_equal``. Each call runs once to warm up (sampled ones with a
    generator seeded 1) and is then timed (seeded 2)."""
    device = prompt.device
    cfg, draft_cfg = target.config, draft.config
    t_mod = target.quantize_int8() if int8 else target.module
    d_mod = draft.quantize_int8() if int8 else draft.module
    if int8:
        print("int8 weight-only quantized target+draft", flush=True)

    def seeded(seed):
        return torch.Generator(device=device).manual_seed(seed)

    rows = []

    def plain(name, temperature):
        def call(seed):
            return generate(t_mod, cfg, prompt, new, temperature=temperature,
                            generator=seeded(seed))
        call(1)
        out, dt = _timed(lambda: call(2), device)
        rows.append({"name": name, "ms": dt * 1e3, "tok_s": new / dt,
                     "tokens": out[0].tolist()})
        print(f"{name:17s} {dt * 1000:7.1f} ms  {new / dt:6.1f} tok/s", flush=True)

    plain("plain greedy", 0.0)
    plain("plain T=0.8", TEMPERATURE)
    greedy = rows[0]["tokens"]
    configs = [("draft-2L g=4", d_mod, draft_cfg, 0.0, 4),
               ("self-draft g=4", t_mod, cfg, 0.0, 4)]
    for gamma in (2, 3, 4, 6):
        configs.append((f"draft-2L T=0.8 g={gamma}", d_mod, draft_cfg, TEMPERATURE, gamma))
    for name, dr, dr_cfg, temperature, gamma in configs:
        def call(seed):
            return generate_speculative(t_mod, cfg, prompt, new, draft_params=dr,
                                        draft_cfg=dr_cfg, gamma=gamma,
                                        temperature=temperature, generator=seeded(seed),
                                        return_stats=True)
        call(1)
        (got, stats), dt = _timed(lambda: call(2), device)
        r, acc, drf = stats["rounds"], stats["accepted"], stats["drafted"]
        tokens = got[0].tolist()
        same = tokens == greedy
        rows.append({"name": name, "ms": dt * 1e3, "tok_s": new / dt, "tokens": tokens,
                     "rounds": r, "accepted": acc, "drafted": drf,
                     "alpha": acc / max(drf, 1), "greedy_equal": same})
        print(f"speculative {name:20s} {dt * 1000:7.1f} ms  {new / dt:6.1f} tok/s  "
              f"rounds={r} accept={acc}/{drf} alpha={acc / max(drf, 1):.2f}  "
              f"greedy-equal={same}", flush=True)
    return rows


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trained", action="store_true",
                        help="the distilled pair under MODEL_DIR/spec_pair")
    parser.add_argument("--int8", action="store_true", help="weight-only int8 weights")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_speculative: no CUDA device (pass --device cpu for the CPU)")
    target, draft = gpt2ish(12, 0, device), gpt2ish(2, 7, device)
    if args.trained:
        load_trained_pair(target, draft)
        print("using distilled target/draft pair (vitef_tpu_torch.tools.distill_spec_pair)")
    return profile_rows(target, draft, prompt_of(args.trained, device), int8=args.int8)


if __name__ == "__main__":
    main()
