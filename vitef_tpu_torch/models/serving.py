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

- the prefix cache (:meth:`DecodeServer.register_prefix` :648-673,
  :func:`_admit_prefix`, ``_make_admit_prefix_fn`` :339-450): a shared
  prefix is prefilled once; admission copies its K/V into the slot's rows
  ``[0, plen)`` and prefills only the request's own tokens at positions
  ``[plen, plen + len)``, their queries attending to [prefix K/V ++ own
  causal K/V] (plain products, as the JAX package's einsum);
- speculative windows (``draft_params=``, :func:`_run_spec_window`,
  ``_make_spec_window_fn`` :252-336): each window is ``harvest_every``
  draft-and-verify rounds over all slots, the draft's own slot cache filled
  at admission, per-slot commit counts cut on the device by budget and EOS.
  Greedy only, as in the JAX package.

Greedy invariant: every request's output through the server equals a
standalone ``generate()`` on its prompt (on [prefix ++ prompt] with a
prefix), whatever its co-tenants, speculative or not. The server decodes
with ``generation.decode_module``'s copy of the weight matrices in the
compute dtype, made once, and serves a module from ``Model.quantize_int8``
(int8 weights) through the same functions. Not ported yet: the
multi-device server (``mesh``), which raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import torch

from ..ops.common import bmm_f32
from .generation import (_NEG_INF, _block_decode, _block_prefill, _check_decoder, _embed_token,
                         _logits, _residual_block, _rope_cos_sin, _split_heads, decode_module,
                         init_kv_cache, prefill, sample_token)
from .quantize import embed_rows
from .registry import Model
from .rope import apply_rope
from .speculative import _draft_step, _forward_window
from .transformer import TransformerConfig, split_qkv


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


def _attend_prefix(attn, cfg: TransformerConfig, x, ctx_k, ctx_v):
    """The own tokens' attention of a prefix-cached admission: ``x`` (1, Pb,
    E) at positions ``[plen, plen + Pb)`` attends causally to itself after
    the prefix's ``ctx_k``/``ctx_v`` (kv_heads, plen, d), rotated for RoPE
    models as the prefill cached them. Returns ``(out, k, v)``, k/v
    head-split (1, kv_heads, Pb, d). Right-padded rows are harmless:
    causality keeps real queries off them, and their K/V lands past the
    slot's position."""
    cd = cfg.cdtype()
    _, pb, e = x.shape
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g, plen = h // kv, ctx_k.shape[1]
    q, k, v = split_qkv(cfg, attn.qkv_mat(x, cd))
    own = torch.arange(pb, device=x.device)
    if cfg.uses_rope:
        cos, sin = _rope_cos_sin(cfg, plen + own)
        cos, sin = cos[:, None], sin[:, None]  # over (1, Pb, heads, d)
        q = apply_rope(q.reshape(1, pb, h, d), cos, sin).reshape(1, pb, e)
        k = apply_rope(k.reshape(1, pb, kv, d), cos, sin).reshape(1, pb, kv * d)
    kh, vh = _split_heads(k, kv), _split_heads(v, kv)
    keys = torch.cat([ctx_k[None].to(kh.dtype), kh], dim=2)  # (1, kv, plen + Pb, d)
    values = torch.cat([ctx_v[None].to(vh.dtype), vh], dim=2)
    qh = _split_heads(q, h).reshape(1, kv, g * pb, d)
    scores = bmm_f32(qh, keys.transpose(-1, -2)).reshape(1, kv, g, pb, -1)
    scores = scores * (1.0 / math.sqrt(d))
    j = torch.arange(plen + pb, device=x.device)
    visible = (j[None, :] < plen) | ((j[None, :] - plen) <= own[:, None])  # (Pb, plen + Pb)
    scores = scores.masked_fill(~visible, _NEG_INF)
    weights = torch.softmax(scores, dim=-1).to(values.dtype).reshape(1, kv, g * pb, -1)
    z = bmm_f32(weights, values).to(cd)
    z = z.reshape(1, h, pb, d).transpose(1, 2).reshape(1, pb, e)
    return attn.output(z, cd), kh, vh


def _admit_prefix(module, cfg: TransformerConfig, cache, pos, slot: int, prefix_kv, prompt,
                  length: int):
    """Admission under a registered prefix: copy each layer's prefix K/V
    into cache rows ``[0, plen)`` of ``slot``, then prefill only the
    right-padded own tokens (Pb,) at positions ``[plen, plen + Pb)``,
    attending to the slot's prefix rows, into rows ``[plen, plen + Pb)``;
    set the slot's position to ``plen + length`` and return the logits (V,)
    of its last real token."""
    cd = cfg.cdtype()
    pb = prompt.shape[0]
    plen = prefix_kv[0]["k"].shape[1]
    emb = module.embedding
    x = embed_rows(emb.token_emb, prompt[None], cd)
    if cfg.pos_emb:
        x = x + emb.pos_emb[0][plen:plen + pb].to(cd)[None]
    for block, pkv, lc in zip(module.blocks, prefix_kv, cache):
        for name in ("k", "v"):
            lc[name][slot, :, :plen] = pkv[name].to(lc[name].dtype)
        own = {}

        def attn(x_in, block=block, lc=lc, own=own):
            out, own["k"], own["v"] = _attend_prefix(
                block.attn, cfg, x_in, lc["k"][slot, :, :plen], lc["v"][slot, :, :plen])
            return out

        x = _residual_block(block, cfg, x, attn)
        for name in ("k", "v"):
            lc[name][slot, :, plen:plen + pb] = own[name][0].to(lc[name].dtype)
    pos[slot] = plen + length
    return _logits(module, cfg, x[0, length - 1])


def _run_spec_window(module, cfg: TransformerConfig, draft, draft_cfg: TransformerConfig,
                     cache, draft_cache, token, pos, active, limit, *, rounds: int,
                     gamma: int, eos_id):
    """``rounds`` greedy draft-and-verify rounds over every slot:
    ``(token, pos, emits (rounds, S, gamma + 1), counts (rounds, S))``.

    Each round the draft takes ``gamma + 1`` one-token steps per slot from
    ``token`` at the slot's ``pos`` (the last one only for its K/V write),
    the target verifies all slots in one (S, gamma + 1) window, and each
    slot commits its longest matching prefix plus the target's correction,
    cut on the device by its budget (``limit - pos``) and at its first EOS,
    after which it stays frozen. Rejected proposals cost nothing to undo:
    ``pos`` does not pass them, and both caches mask cells past it."""
    w = gamma + 1
    steps = torch.arange(w, device=token.device)
    emits, counts = [], []
    act = active
    for _ in range(rounds):
        tok, proposals = token, []
        for i in range(w):
            logits = _draft_step(draft, draft_cfg, draft_cache, tok, pos + i, pos + i,
                                 logits=i < gamma)
            if logits is not None:
                tok = torch.argmax(logits, dim=-1)
                proposals.append(tok)
        g = torch.stack(proposals, dim=1)  # (S, gamma)
        window = torch.cat([token[:, None], g], dim=1)  # (S, W)
        t = torch.argmax(_forward_window(module, cfg, window, cache, pos), dim=-1)  # (S, W)
        a = torch.cumprod((g == t[:, :gamma]).long(), dim=1).sum(dim=1)  # (S,)
        emit = torch.where(steps[None, :] < a[:, None], torch.cat([g, g.new_zeros(len(g), 1)],
                                                                  dim=1), t)
        n_emit = torch.where(act, torch.minimum(a + 1, (limit - pos).clamp_min(0)), 0)
        if eos_id is not None:
            is_eos = emit == eos_id
            first_eos = torch.argmax(is_eos.long(), dim=1)  # 0 when none
            has_eos = is_eos.any(dim=1)
            n_emit = torch.minimum(n_emit, torch.where(has_eos, first_eos + 1, w))
            act = act & ~(has_eos & (first_eos < n_emit))  # frozen after its EOS
        pos = pos + n_emit
        last = emit.gather(1, (n_emit.clamp_min(1) - 1)[:, None])[:, 0]
        token = torch.where(n_emit > 0, last, token)
        emits.append(emit)
        counts.append(n_emit)
    return token, pos, torch.stack(emits), torch.stack(counts)


@dataclass
class Request:
    prompt: Any  # 1-D sequence of token ids
    max_new_tokens: int
    prefix: int | None = None  # a handle from DecodeServer.register_prefix
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

    ``draft_params``: speculative serving with a draft model, a
    :class:`~vitef_tpu_torch.models.registry.Model` or a module beside its
    ``draft_cfg`` (the JAX package's params and config): each step runs
    ``harvest_every`` rounds of ``gamma`` proposals per slot. Greedy only;
    the outputs are the plain server's. ``spec_rounds`` counts the rounds,
    ``spec_committed`` and ``steps`` the tokens they committed. It does not
    compose with :meth:`register_prefix` (the draft's cache would need the
    prefix too).
    """

    def __init__(self, module, cfg: TransformerConfig, *, n_slots: int,
                 max_len: int | None = None, temperature: float = 0.0,
                 top_k: int | None = None, top_p: float | None = None,
                 eos_token_id: int | None = None, bucket: int = 64, harvest_every: int = 8,
                 generator: torch.Generator | None = None, mesh=None, draft_params=None,
                 draft_cfg: TransformerConfig | None = None, gamma: int = 4):
        _check_decoder(cfg)
        if mesh is not None:
            raise NotImplementedError("multi-device serving (mesh=) is not ported yet")
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
        self._prefixes: dict[int, dict] = {}
        self.prefill_tokens_saved = 0  # prefix tokens copied, not recomputed
        self.draft = None
        if draft_params is not None:
            if isinstance(draft_params, Model):
                draft_params, draft_cfg = draft_params.module, draft_params.config
            if draft_cfg is None:
                raise ValueError("a draft module needs its draft_cfg")
            _check_decoder(draft_cfg)
            if temperature != 0.0:
                raise ValueError("speculative serving is greedy only (temperature 0)")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(f"the draft's vocabulary ({draft_cfg.vocab_size}) is not the "
                                 f"target's ({cfg.vocab_size})")
            if gamma < 1:
                raise ValueError("gamma must be >= 1")
            if self.max_len > draft_cfg.seq_len:
                raise ValueError(f"max_len {self.max_len} exceeds the draft's seq_len "
                                 f"{draft_cfg.seq_len}")
            self.draft = (self.module if draft_params is module
                          else decode_module(draft_params, draft_cfg))
            self.draft_cfg = draft_cfg
            self.gamma = gamma
            self.draft_cache = init_kv_cache(draft_cfg, n_slots, self.max_len,
                                             device=self.device)
        self.reset(generator if generator is not None
                   else torch.Generator(device=self.device).manual_seed(0))

    def reset(self, generator: torch.Generator | None = None) -> None:
        """Clear all slots and the step counters (registered prefixes stay).
        The caches need no zeroing: admission overwrites ``[0, len)`` and each
        slot's position masks everything beyond."""
        def zeros():
            return torch.zeros(self.n_slots, dtype=torch.long, device=self.device)

        self.pos, self.token, self.limit = zeros(), zeros(), zeros()
        self.active = [False] * self.n_slots
        self._owner: list[Request | None] = [None] * self.n_slots
        self.steps = 0  # decode ticks executed (speculative: tokens committed)
        self.spec_rounds = 0  # draft-and-verify rounds run
        self.spec_committed = 0  # tokens those rounds committed
        if generator is not None:
            self.generator = generator

    @torch.inference_mode()
    def register_prefix(self, prefix_tokens) -> int:
        """Prefill a shared prefix (a system prompt) once and return its
        handle. A request with ``prefix=handle`` skips the prefix's prefill
        at admission: each layer's (kv_heads, plen, d) K/V is copied into
        its slot and only its own tokens run through the model. Greedy
        outputs equal a standalone ``generate()`` on [prefix ++ prompt]."""
        p = torch.as_tensor(prefix_tokens, dtype=torch.long).reshape(-1)
        plen = p.shape[0]
        if not 1 <= plen < self.max_len:
            raise ValueError(f"a prefix of {plen} tokens must leave room in max_len "
                             f"{self.max_len}")
        _, cache = prefill(self.module, self.cfg, p[None].to(self.device), plen)
        handle = len(self._prefixes)
        self._prefixes[handle] = {"kv": [{"k": lc["k"][0], "v": lc["v"][0]} for lc in cache],
                                  "plen": plen}
        return handle

    def _bucketed(self, prompt, room: int | None = None):
        """``(prompt right-padded to its bucket on the device, its length)``;
        the bucket never exceeds the ``room`` left in the slot (``max_len``
        by default)."""
        p = torch.as_tensor(prompt, dtype=torch.long).reshape(-1)
        length = p.shape[0]
        room = self.max_len if room is None else room
        pb = min(max(self.bucket, -(-length // self.bucket) * self.bucket), room)
        padded = torch.zeros(pb, dtype=torch.long)
        padded[:length] = p
        return padded.to(self.device), length

    def _sample(self, logits):
        return sample_token(logits[None], self.generator, self.temperature, self.top_k,
                            top_p=self.top_p)[0]

    @torch.inference_mode()
    def admit(self, req: Request, slot: int) -> None:
        length = len(req.prompt)
        plen = 0
        if req.prefix is not None:
            if self.draft is not None:
                raise ValueError("prefix caching does not compose with speculative serving")
            plen = self._prefixes[req.prefix]["plen"]
        # a speculative window writes up to gamma cells past the slot's position
        headroom = self.gamma if self.draft is not None else 0
        need = plen + length + req.max_new_tokens + headroom
        if length < 1 or req.max_new_tokens < 1 or need > self.max_len:
            raise ValueError(f"a request of {plen} prefix, {length} prompt and "
                             f"{req.max_new_tokens} new tokens (and {headroom} of speculative "
                             f"headroom) does not fit max_len {self.max_len}")
        padded, length = self._bucketed(req.prompt, room=self.max_len - plen)
        if plen:
            logits = _admit_prefix(self.module, self.cfg, self.cache, self.pos, slot,
                                   self._prefixes[req.prefix]["kv"], padded, length)
            self.prefill_tokens_saved += plen
        else:
            logits = _admit(self.module, self.cfg, self.cache, self.pos, slot, padded, length)
            if self.draft is not None:
                _admit(self.draft, self.draft_cfg, self.draft_cache, self.pos, slot, padded,
                       length)
        first = self._sample(logits)
        self.token[slot] = first
        # the remaining max_new - 1 ticks end when the position reaches this
        self.limit[slot] = plen + length + req.max_new_tokens - 1
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
        """One window of decode ticks (or speculative rounds) for all slots,
        harvested in one copy to the host; each owner's stream is cut at its
        budget or EOS."""
        active = torch.tensor(self.active, device=self.device)
        if self.draft is not None:
            self._spec_step(active)
            return
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

    def _spec_step(self, active) -> None:
        """``harvest_every`` speculative rounds: the device returns each
        round's (S, gamma + 1) tokens and per-slot commit counts, already cut
        at budget and EOS, and the host appends exactly the committed ones."""
        self.token, self.pos, emits, counts = _run_spec_window(
            self.module, self.cfg, self.draft, self.draft_cfg, self.cache, self.draft_cache,
            self.token, self.pos, active, self.limit, rounds=self.window, gamma=self.gamma,
            eos_id=self.eos_token_id)
        self.spec_rounds += self.window
        # (rounds, S, gamma + 2): each row's tokens, then its commit count
        rows = torch.cat([emits, counts[..., None]], dim=2).cpu().tolist()
        for r in range(self.window):
            for slot, owner in enumerate(self._owner):
                if owner is None or not self.active[slot]:
                    continue
                *tokens, count = rows[r][slot]
                for tok in tokens[:count]:
                    owner.tokens.append(tok)
                    self.steps += 1
                    self.spec_committed += 1
                    self._maybe_finish(slot, tok)
                    if not self.active[slot]:
                        break

    def serve(self, requests: list[Request]) -> list[Request]:
        """Admit and step until every request completes (FIFO admission)."""
        queue = list(requests)
        while queue or any(self.active):
            while queue and not all(self.active):
                self.admit(queue.pop(0), self.active.index(False))
            if any(self.active):
                self.step()
        return requests
