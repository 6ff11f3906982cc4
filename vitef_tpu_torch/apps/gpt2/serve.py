"""GPT-2 continuous-batching server CLI. Counterpart of ``apps/gpt2/serve.py``.

Batch-offline serving of a request file through a fixed pool of KV-cache
slots, a request admitted the moment a slot frees
(:mod:`vitef_tpu_torch.models.serving`), or in waves of ragged batches
through ``generate()``:

    python -m vitef_tpu_torch.apps.gpt2.serve run --requests requests.jsonl --n_slots 8
    python -m vitef_tpu_torch.apps.gpt2.serve run --demo 16 --n_slots 4   # synthetic stream

``requests.jsonl`` holds one request per line,
``{"token_ids": [464, 3280, ...], "max_new_tokens": 32}``; results stream to
stdout as jsonl, ``{"id": i, "tokens": [...]}``. The port has no GPT-2
tokenizer, so text prompts exit. Runs on the card unless ``--device cpu``.
``--quantize int8`` serves weight-only int8 weights (``models/quantize.py``),
for example Llama-3.1-8B:

    python -m vitef_tpu_torch.apps.gpt2.serve run --implementation llama --model_name 8b \
        --demo 16 --quantize int8

Not ported yet: ``--prefix`` (the prefix cache), which raises.
"""

from __future__ import annotations

import json
import logging
import time

import numpy as np
import torch

from vitef_tpu_torch.models import build_model
from vitef_tpu_torch.models.serving import DecodeServer, Request
from vitef_tpu_torch.utils.cli import make_cli

logger = logging.getLogger(__name__)

# Above this dispatch round-trip the per-window host syncs of continuous
# batching cost more than its saved ticks; the JAX app's threshold.
RTT_WAVE_THRESHOLD_MS = 2.0
EOS_ID = 50256  # GPT-2's <|endoftext|>


def measure_dispatch_rtt(device, reps: int = 10) -> float:
    """Median host -> device -> host round-trip of a trivial op, in ms: an
    add, then a synchronise (``torch.cuda.synchronize`` on the card) and the
    value's copy to the host."""
    x = torch.zeros((), dtype=torch.long, device=device)
    samples = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        x = x + 1
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        int(x)
        samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples[1:]))  # the first one warms up


def _serve_waves(model, reqs: list[Request], n_slots: int, temperature: float, top_k, top_p,
                 eos_id, seed: int, device) -> None:
    """Wave batching: FIFO groups of ``n_slots`` through ragged-batch
    ``generate()`` (left-padded prompts and their mask; each request's output
    is its unpadded generation). One host round-trip per wave."""
    for start in range(0, len(reqs), n_slots):
        wave = reqs[start:start + n_slots]
        plens = [len(w.prompt) for w in wave]
        p = max(plens)
        max_new = max(w.max_new_tokens for w in wave)
        prompt = np.zeros((len(wave), p), np.int64)
        mask = np.zeros((len(wave), p), bool)
        for i, w in enumerate(wave):
            prompt[i, p - plens[i]:] = w.prompt
            mask[i, p - plens[i]:] = True
        out = model.generate(
            torch.from_numpy(prompt).to(device), max_new, temperature=temperature,
            top_k=top_k, top_p=top_p, prompt_mask=torch.from_numpy(mask).to(device),
            eos_token_id=eos_id,
            generator=torch.Generator(device=device).manual_seed(seed + start)).tolist()
        for i, w in enumerate(wave):
            toks = out[i][:w.max_new_tokens]
            if eos_id is not None and eos_id in toks:
                toks = toks[:toks.index(eos_id) + 1]
            w.tokens = toks
            w.done = True


def _load_requests(path: str | None, demo: int, vocab: int, max_new_tokens: int):
    if path is not None:
        reqs = []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                rec = json.loads(line)
                if "token_ids" in rec:
                    ids = [int(t) for t in rec["token_ids"]]
                elif "prompt" in rec:
                    raise SystemExit("text prompts need a GPT-2 tokenizer, which the port "
                                     "has not; use token_ids")
                else:
                    raise SystemExit(f"bad request line: {line!r}")
                reqs.append(Request(prompt=ids, max_new_tokens=int(
                    rec.get("max_new_tokens", max_new_tokens))))
        return reqs
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(0, vocab, size=(int(rng.integers(8, 64)),)).tolist(),
                    max_new_tokens=int(rng.integers(8, max_new_tokens + 1)))
            for _ in range(demo)]


def run(requests: str | None = None, demo: int = 0, model_name: str = "base",
        n_slots: int = 8, max_len: int = 512, max_new_tokens: int = 64,
        temperature: float = 0.0, top_k: int | None = None,
        top_p: float | None = None, eos: bool = True, bucket: int = 64,
        pretrained: bool = True, seed: int = 0,
        compute_dtype: str = "bfloat16", quantize: str | None = None,
        prefix: str | None = None, implementation: str = "gpt2",
        mode: str = "auto", device: str = "cuda"):
    """Serve a request file (or ``--demo N`` synthetic requests) and print
    jsonl results in input order; returns the requests.

    ``--mode``: ``continuous`` (the slot server), ``wave`` (FIFO
    ``generate()`` batches) or ``auto``: measure the dispatch round-trip and
    take waves above ``RTT_WAVE_THRESHOLD_MS``, where the per-window host
    syncs of continuous batching cost more than its saved ticks. Greedy wave
    outputs equal the continuous server's. ``--implementation llama`` or
    ``moe`` (with their ``--model_name``) serves those families by token ids.
    ``--quantize int8``: weight-only int8 weights (``Model.quantize_int8``),
    the full-precision ones freed before serving.
    """
    if (requests is None) == (demo == 0):
        raise SystemExit("pass exactly one of --requests or --demo N")
    if quantize not in (None, "int8"):
        raise SystemExit(f"--quantize must be int8, got {quantize!r}")
    if prefix is not None:
        raise NotImplementedError("--prefix (the prefix cache) is not ported yet")
    if mode not in ("auto", "continuous", "wave"):
        raise SystemExit(f"--mode must be auto|continuous|wave, got {mode!r}")
    build_args = dict(implementation=implementation, model_name=model_name,
                      compute_dtype=compute_dtype, seed=seed)
    if implementation != "moe":  # moe ships no pretrained-checkpoint map
        build_args["pretrained"] = pretrained
    if implementation in ("llama", "moe"):
        build_args["seq_len"] = max_len  # cap the rope/cache length
    model = build_model(build_args, device=device)
    if quantize is not None:
        model.module = model.quantize_int8()

    reqs = _load_requests(requests, demo, model.config.vocab_size, max_new_tokens)
    eos_id = (EOS_ID if eos and implementation == "gpt2"
              and model.config.vocab_size > EOS_ID else None)
    if mode == "auto":
        rtt = measure_dispatch_rtt(device)
        mode = "wave" if rtt > RTT_WAVE_THRESHOLD_MS else "continuous"
        logger.info("serving mode: %s (measured dispatch RTT %.3f ms %s threshold %.1f ms)",
                    mode, rtt, ">" if mode == "wave" else "<=", RTT_WAVE_THRESHOLD_MS)

    t0 = time.perf_counter()
    if mode == "wave":
        _serve_waves(model, reqs, n_slots, temperature, top_k, top_p, eos_id, seed, device)
        ticks_note = "wave"
    else:
        srv = DecodeServer(model.module, model.config, n_slots=n_slots, max_len=max_len,
                           temperature=temperature, top_k=top_k, top_p=top_p,
                           eos_token_id=eos_id, bucket=bucket,
                           generator=torch.Generator(device=device).manual_seed(seed))
        srv.serve(reqs)
        ticks_note = f"{srv.steps} ticks"
    dt = time.perf_counter() - t0
    total = 0
    for i, req in enumerate(reqs):
        total += len(req.tokens)
        print(json.dumps({"id": i, "tokens": req.tokens}))
    logger.info("served %d requests / %d tokens in %.1fs (%.0f tok/s, %s mode, %s x %d slots)",
                len(reqs), total, dt, total / dt, mode, ticks_note, n_slots)
    return reqs


def main() -> None:
    """``python -m vitef_tpu_torch.apps.gpt2.serve run --requests file.jsonl [--flags]``."""
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    make_cli({"run": run})


if __name__ == "__main__":
    main()
