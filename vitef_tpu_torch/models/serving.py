"""Continuous batching: a slot-based decode server over the KV cache.
Counterpart of ``vitef_tpu/models/serving.py``.

A fixed pool of ``n_slots`` cache rows per layer, (n_slots, n_kv_heads,
max_len, head_dim). A request is admitted into a free slot the moment one
finishes (EOS or its budget), so the card does not wait for the longest
request of a wave:

- admission (:func:`_admit`, ``_make_admit_fn`` :452) prefills one prompt,
  right-padded to a bucket length, into its slot's cache rows ``[0, len)``
  (unmasked causal attention: a real query row only reads real keys, and
  the padded tail sits beyond the slot's position until the next admission
  overwrites it), and returns the last real token's logits;
- a window of decode ticks (:func:`_run_window`, ``_make_window_fn`` :111)
  advances every slot at its own position (:func:`_tick_logits`: the JAX
  ``_block_decode_slots`` :61 is ``generation._block_decode`` with a
  per-slot position), with the budget (``pos < limit``) and EOS freezes on
  the device, and returns the window's (window, n_slots) tokens for one
  host harvest;
- :class:`DecodeServer` (:503) keeps the host side: which slot holds which
  :class:`Request`, admission in FIFO order, and truncation of each stream
  exactly as a per-tick protocol would.

Greedy invariant: every request's output through the server equals a
standalone ``generate()`` on its prompt, whatever its co-tenants. The server
decodes with ``generation.decode_module``'s copy of the weight matrices in
the compute dtype, made once, and serves a module from
``Model.quantize_int8`` (int8 weights) through the same functions.
Not ported yet (they raise ``NotImplementedError``): the prefix cache
(``register_prefix``), speculative windows (``draft_params``) and the
multi-device server (``mesh``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from .generation import (_block_decode, _block_prefill, _check_decoder, _embed_token, _logits,
                         _split_heads, decode_module, init_kv_cache, sample_token)
from .quantize import embed_rows
from .transformer import TransformerConfig


def _tick_logits(module, cfg: TransformerConfig, cache, token, pos):
    """One decode tick of every slot at its own cache position ``pos`` (S,):
    writes each slot's k/v at its position (in place) and returns the (S, V)
    logits. Slot prompts start at cache position 0, so a slot's logical
    position is its cache position."""
    x = _embed_token(module, cfg, token, pos)
    for block, lc in zip(module.blocks, cache):
        x, _ = _block_decode(block, cfg, x, lc, pos)
    return _logits(module, cfg, x)


def _run_window(module, cfg: TransformerConfig, cache, token, pos, active, limit,
                generator, *, window: int, temperature: float, top_k, top_p, eos_id):
    """``window`` decode ticks for every slot: ``(token, pos, toks)`` with
    toks (window, S). A slot ticks while it is active and below its budget
    (``pos < limit``); after it emits EOS it stays frozen for the rest of the
    window. A frozen slot still computes, but keeps its token and position
    (its cache write lands on a cell no live request reads)."""
    toks = []
    for _ in range(window):
        tick = active & (pos < limit)
        nxt = sample_token(_tick_logits(module, cfg, cache, token, pos), generator, temperature,
                           top_k, top_p=top_p)
        token = torch.where(tick, nxt, token)
        pos = torch.where(tick, pos + 1, pos)
        if eos_id is not None:
            active = active & (token != eos_id)
        toks.append(token)
    return token, pos, torch.stack(toks)


def _admit(module, cfg: TransformerConfig, cache, pos, slot: int, prompt, length: int):
    """Prefill one right-padded prompt (Pb,) into cache rows ``[0, Pb)`` of
    ``slot``, set its position to ``length`` and return the logits (V,) of
    its last real token."""
    cd = cfg.cdtype()
    pb = prompt.shape[0]
    emb = module.embedding
    x = embed_rows(emb.token_emb, prompt[None], cd)
    if cfg.pos_emb:
        x = x + emb.pos_emb[:, :pb].to(cd)
    for block, lc in zip(module.blocks, cache):
        x, k, v = _block_prefill(block, cfg, x)
        lc["k"][slot, :, :pb] = _split_heads(k.to(cd), cfg.n_kv_heads)[0].to(lc["k"].dtype)
        lc["v"][slot, :, :pb] = _split_heads(v.to(cd), cfg.n_kv_heads)[0].to(lc["v"].dtype)
    pos[slot] = length
    return _logits(module, cfg, x[0, length - 1])


@dataclass
class Request:
    prompt: Any  # 1-D sequence of token ids
    max_new_tokens: int
    prefix: int | None = None  # a register_prefix handle (not ported yet)
    tokens: list = field(default_factory=list)  # the output, filled by the server
    slot: int | None = None
    done: bool = False


class DecodeServer:
    """Continuous-batching decode server over ``n_slots`` KV-cache rows of
    ``module`` (a causal :class:`~vitef_tpu_torch.models.transformer.Transformer`).

    ``serve(requests)`` admits and steps until every request is complete;
    outputs land in ``request.tokens``. Greedy by default (temperature 0),
    the mode whose outputs equal a standalone ``generate()``; sampling draws
    from ``generator`` (default: seeded 0 on the module's device). Each
    :meth:`step` runs ``harvest_every`` ticks and reads their tokens back in
    one host copy.
    """

    def __init__(self, module, cfg: TransformerConfig, *, n_slots: int,
                 max_len: int | None = None, temperature: float = 0.0,
                 top_k: int | None = None, top_p: float | None = None,
                 eos_token_id: int | None = None, bucket: int = 64, harvest_every: int = 8,
                 generator: torch.Generator | None = None, mesh=None, draft_params=None):
        _check_decoder(cfg)
        if mesh is not None:
            raise NotImplementedError("multi-device serving (mesh=) is not ported yet")
        if draft_params is not None:
            raise NotImplementedError("speculative serving (draft_params=) is not ported yet")
        self.module, self.cfg = decode_module(module, cfg), cfg
        self.device = next(module.parameters()).device
        self.n_slots = n_slots
        self.max_len = max_len or cfg.seq_len
        if self.max_len > cfg.seq_len:
            raise ValueError(f"max_len {self.max_len} exceeds the model's seq_len {cfg.seq_len}")
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.eos_token_id = eos_token_id
        self.bucket = bucket
        self.window = max(1, harvest_every)
        self.cache = init_kv_cache(cfg, n_slots, self.max_len, device=self.device)
        self.reset(generator if generator is not None
                   else torch.Generator(device=self.device).manual_seed(0))

    def reset(self, generator: torch.Generator | None = None) -> None:
        """Clear all slots. The cache needs no zeroing: admission overwrites
        ``[0, len)`` and each slot's position masks everything beyond."""
        def zeros():
            return torch.zeros(self.n_slots, dtype=torch.long, device=self.device)

        self.pos, self.token, self.limit = zeros(), zeros(), zeros()
        self.active = [False] * self.n_slots
        self._owner: list[Request | None] = [None] * self.n_slots
        self.steps = 0  # decode ticks executed
        if generator is not None:
            self.generator = generator

    def register_prefix(self, prefix_tokens) -> int:
        raise NotImplementedError("prefix caching (register_prefix) is not ported yet")

    def _bucketed(self, prompt):
        """``(prompt right-padded to its bucket on the device, its length)``;
        the bucket never exceeds ``max_len``."""
        p = torch.as_tensor(prompt, dtype=torch.long).reshape(-1)
        length = p.shape[0]
        pb = min(max(self.bucket, -(-length // self.bucket) * self.bucket), self.max_len)
        padded = torch.zeros(pb, dtype=torch.long)
        padded[:length] = p
        return padded.to(self.device), length

    def _sample(self, logits):
        return sample_token(logits[None], self.generator, self.temperature, self.top_k,
                            top_p=self.top_p)[0]

    @torch.inference_mode()
    def admit(self, req: Request, slot: int) -> None:
        if req.prefix is not None:
            raise NotImplementedError("prefix caching (Request.prefix) is not ported yet")
        length = len(req.prompt)
        if length < 1 or req.max_new_tokens < 1 or length + req.max_new_tokens > self.max_len:
            raise ValueError(f"a request of {length} prompt and {req.max_new_tokens} new "
                             f"tokens does not fit max_len {self.max_len}")
        padded, length = self._bucketed(req.prompt)
        logits = _admit(self.module, self.cfg, self.cache, self.pos, slot, padded, length)
        first = self._sample(logits)
        self.token[slot] = first
        # the remaining max_new - 1 ticks end when the position reaches this
        self.limit[slot] = length + req.max_new_tokens - 1
        self.active[slot] = True
        self._owner[slot] = req
        req.slot = slot
        req.tokens.append(int(first))
        self._maybe_finish(slot, req.tokens[-1])

    def _maybe_finish(self, slot: int, tok: int) -> None:
        req = self._owner[slot]
        if req is None:
            return
        if (self.eos_token_id is not None and tok == self.eos_token_id) or \
                len(req.tokens) >= req.max_new_tokens:
            req.done = True
            self.active[slot] = False
            self._owner[slot] = None

    @torch.inference_mode()
    def step(self) -> None:
        """One window of decode ticks for all slots, harvested in one copy to
        the host; each owner's stream is cut at its budget or EOS."""
        active = torch.tensor(self.active, device=self.device)
        self.token, self.pos, toks = _run_window(
            self.module, self.cfg, self.cache, self.token, self.pos, active, self.limit,
            self.generator, window=self.window, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p, eos_id=self.eos_token_id)
        self.steps += self.window
        toks = toks.cpu().tolist()  # (window, S)
        for t in range(self.window):
            for slot, owner in enumerate(self._owner):
                if owner is not None and self.active[slot]:
                    owner.tokens.append(toks[t][slot])
                    self._maybe_finish(slot, toks[t][slot])

    def serve(self, requests: list[Request]) -> list[Request]:
        """Admit and step until every request completes (FIFO admission)."""
        queue = list(requests)
        while queue or any(self.active):
            while queue and not all(self.active):
                self.admit(queue.pop(0), self.active.index(False))
            if any(self.active):
                self.step()
        return requests
