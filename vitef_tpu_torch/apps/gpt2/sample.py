"""GPT-2 text generation CLI, the serving entry point for one prompt.
Counterpart of ``apps/gpt2/sample.py``.

    python -m vitef_tpu_torch.apps.gpt2.sample run --token_ids "[464, 3280, 318]"
    python -m vitef_tpu_torch.apps.gpt2.sample run --token_ids "[464, 3280, 318]" --top_k 40 --temperature 0.8
    python -m vitef_tpu_torch.apps.gpt2.sample run --token_ids "[464, 3280, 318]" \
        --model_name medium --draft_model_name base

KV-cache ``generate()`` with greedy, temperature, top-k and top-p sampling,
an EOS stop and an optional int8 KV cache, on the card unless ``--device
cpu``; or speculative decoding (``--draft_model_name``, ``--gamma``
proposals a round) with a smaller GPT-2 drafting, whose weights come from
``--seed`` + 1, temperature only. The port has no GPT-2 tokenizer:
``--prompt`` exits and asks for ``--token_ids``, as the JAX app does without
its tokenizer files. Real continuations need the local pretrained weights
(``--pretrained``, the default, falls back to random weights from ``--seed``
without them).
"""

from __future__ import annotations

import logging

import torch

from vitef_tpu_torch.models import build_model
from vitef_tpu_torch.utils.cli import make_cli

logger = logging.getLogger(__name__)

EOS_ID = 50256  # GPT-2's <|endoftext|>


def run(prompt: str | None = None, token_ids: list | None = None,
        model_name: str = "base", max_new_tokens: int = 32,
        temperature: float = 0.8, top_k: int | None = None,
        top_p: float | None = None, eos: bool = True,
        kv_cache_dtype: str | None = None, draft_model_name: str | None = None,
        gamma: int = 4, pretrained: bool = True, seed: int = 0,
        compute_dtype: str = "bfloat16", device: str = "cuda"):
    """Generate a continuation; prints and returns the new token ids.

    ``top_k`` defaults to 40 in plain mode (``--top_k 0`` disables top-k).
    The speculative mode samples with the temperature alone and refuses the
    flags it would ignore (``top_k``, ``top_p``, ``kv_cache_dtype``)."""
    if (prompt is None) == (token_ids is None):
        raise SystemExit("pass exactly one of --prompt or --token_ids")
    if prompt is not None:
        raise SystemExit("tokenizer unavailable (the port has no GPT-2 tokenizer); "
                         "pass --token_ids instead")
    if draft_model_name is not None:
        ignored = [name for name, val in (("top_k", top_k), ("top_p", top_p),
                                          ("kv_cache_dtype", kv_cache_dtype))
                   if val is not None]
        if ignored:
            raise SystemExit(f"--draft_model_name (speculative) does not support "
                             f"{', '.join(ignored)}; it samples with temperature only")
    model = build_model(dict(implementation="gpt2", model_name=model_name,
                             pretrained=pretrained, compute_dtype=compute_dtype, seed=seed),
                        device=device)
    ids = torch.tensor([[int(t) for t in token_ids]], dtype=torch.long, device=device)
    eos_id = EOS_ID if eos else None
    generator = torch.Generator(device=device).manual_seed(seed)
    if draft_model_name is not None:
        draft = build_model(dict(implementation="gpt2", model_name=draft_model_name,
                                 pretrained=pretrained, compute_dtype=compute_dtype,
                                 seed=seed + 1), device=device)
        out, stats = model.generate_speculative(ids, max_new_tokens, draft=draft, gamma=gamma,
                                                temperature=temperature, generator=generator,
                                                return_stats=True)
        logger.info("speculative: %d rounds, accepted %d/%d drafted", stats["rounds"],
                    stats["accepted"], stats["drafted"])
    else:
        top_k = 40 if top_k is None else (top_k if top_k > 0 else None)
        out = model.generate(ids, max_new_tokens, temperature=temperature, top_k=top_k,
                             top_p=top_p, eos_token_id=eos_id, kv_cache_dtype=kv_cache_dtype,
                             generator=generator)

    new_ids = out[0].tolist()
    if eos_id is not None and eos_id in new_ids:
        new_ids = new_ids[:new_ids.index(eos_id)]
    print({"prompt_ids": ids[0].tolist(), "new_ids": new_ids})
    return new_ids


def main() -> None:
    """``python -m vitef_tpu_torch.apps.gpt2.sample run --token_ids '[...]' [--flags]``."""
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    make_cli({"run": run})


if __name__ == "__main__":
    main()
