"""Speculative decoding: draft and verify, for latency-bound decode.
Counterpart of ``vitef_tpu/models/speculative.py``.

Batch-1 decode reads all of the target's weights for one token. A cheap
draft model proposes ``gamma`` tokens one at a time, and the target checks
them in one windowed forward of ``gamma + 1`` queries against its KV cache,
so the target's weights are read once a window (Leviathan et al. 2023).
Greedy output equals the target's own greedy decode; sampled output has the
target's distribution, whatever the draft.

- :func:`_attend_window` (:56) attends W queries against the cache, query w
  seeing the keys at positions ``<= pos + w``, with float32 scores and
  softmax, as the one-token ``generation._attend_cached``; an int ``pos``
  reads the cache prefix ``[:pos + W]``, a (S,) tensor (the server's slots,
  the JAX ``serving._attend_window_slots`` :154) reads every position;
- :func:`_block_decode_window` (:82) writes the window's K/V at
  ``[pos, pos + W)`` in place, RoPE at ``pos + arange(W)``;
- :func:`_forward_window` (:125) is the target's verify pass;
- :func:`generate_speculative` (:141-287) is a Python loop over rounds
  where the JAX package has one ``lax.while_loop``. Each round the draft
  takes ``gamma + 1`` one-token steps (:func:`_draft_round`); the last
  step's sample is dropped, but its K/V write at ``c + gamma`` is
  load-bearing: a fully accepted round moves the commit pointer past it.
  Rollback is only the commit pointer ``c``: the stale cells past it stay
  and are masked by position until a later round overwrites them. The
  accepted count is read on the host once a round (the round's one host
  sync), because the one-token steps read the cache prefix ``[:c + 1]``.
"""

from __future__ import annotations

import math

import torch

from ..ops.common import bmm_f32
from .generation import (_NEG_INF, _block_decode, _categorical, _check_decoder, _embed_token,
                         _logits, _residual_block, _rope_cos_sin, _split_heads, decode_module,
                         prefill, sample_token)
from .quantize import embed_rows
from .rope import apply_rope
from .transformer import TransformerConfig, split_qkv


def _window_positions(pos, w: int, device) -> torch.Tensor:
    """The window's cache positions: (W,) for an int ``pos``, (S, W) for a
    (S,) tensor of per-slot positions."""
    steps = torch.arange(w, device=device)
    return pos + steps if isinstance(pos, int) else pos[:, None] + steps


def _attend_window(q, k_cache, v_cache, n_heads: int, pos):
    """W-query attention against the (N, kv_heads, Lmax, d) cache, the
    window's own K/V already written at ``[pos, pos + W)``.

    ``q``: (N, W, E). Query w sees the keys at positions ``<= pos + w``. An
    int ``pos`` reads the prefix ``[:pos + W]``; a (N,) tensor reads all
    Lmax positions and masks per slot. Scores and softmax are float32; the
    weights are cast to the cache's dtype for the second product. Query
    heads [k*g, (k+1)*g) share kv head k.
    """
    n, w, e = q.shape
    kvh = k_cache.shape[1]
    g = n_heads // kvh
    d = e // n_heads
    if isinstance(pos, int):
        k_cache, v_cache = k_cache[:, :, :pos + w], v_cache[:, :, :pos + w]
    keys = torch.arange(k_cache.shape[2], device=q.device)
    valid = keys <= _window_positions(pos, w, q.device)[..., None]  # (W, P) or (N, W, P)
    qh = _split_heads(q, n_heads).reshape(n, kvh, g * w, d)
    scores = bmm_f32(qh, k_cache.transpose(-1, -2)).reshape(n, kvh, g, w, -1)
    scores = scores * (1.0 / math.sqrt(d))
    mask = valid if isinstance(pos, int) else valid[:, None, None]
    scores = scores.masked_fill(~mask, _NEG_INF)
    weights = torch.softmax(scores, dim=-1).to(v_cache.dtype).reshape(n, kvh, g * w, -1)
    out = bmm_f32(weights, v_cache).to(q.dtype)  # (N, kvh, g*W, d)
    return out.reshape(n, n_heads, w, d).transpose(1, 2).reshape(n, w, e)


def _block_decode_window(block, cfg: TransformerConfig, x, layer_cache: dict, pos):
    """W-token block step: writes the window's k/v into ``layer_cache`` at
    ``[pos, pos + W)`` in place (per slot for a (N,) tensor ``pos``) and
    returns the block's output (N, W, E). The cache holds the compute
    dtype (no int8 K/V: neither speculative path takes ``kv_cache_dtype``)."""
    cd = cfg.cdtype()
    n, w, e = x.shape
    kv, d = cfg.n_kv_heads, cfg.head_dim

    def attn(x_in):
        q, k, v = split_qkv(cfg, block.attn.qkv_mat(x_in, cd))
        positions = _window_positions(pos, w, x.device)
        if cfg.uses_rope:
            cos, sin = _rope_cos_sin(cfg, positions)  # (W, d/2) or (N, W, d/2)
            cos, sin = cos[..., None, :], sin[..., None, :]  # over (N, W, heads, d)
            q = apply_rope(q.reshape(n, w, cfg.n_heads, d), cos, sin).reshape(n, w, e)
            k = apply_rope(k.reshape(n, w, kv, d), cos, sin).reshape(n, w, kv * d)
        kh, vh = k.reshape(n, w, kv, d), v.reshape(n, w, kv, d)
        if isinstance(pos, int):
            layer_cache["k"][:, :, pos:pos + w] = kh.transpose(1, 2).to(layer_cache["k"].dtype)
            layer_cache["v"][:, :, pos:pos + w] = vh.transpose(1, 2).to(layer_cache["v"].dtype)
        else:  # cache[s, :, pos[s] + w] = kh[s, w]
            rows = torch.arange(n, device=x.device)[:, None]
            layer_cache["k"][rows, :, positions] = kh.to(layer_cache["k"].dtype)
            layer_cache["v"][rows, :, positions] = vh.to(layer_cache["v"].dtype)
        z = _attend_window(q, layer_cache["k"], layer_cache["v"], cfg.n_heads, pos)
        return block.attn.output(z, cd)

    return _residual_block(block, cfg, x, attn)


def _forward_window(module, cfg: TransformerConfig, tokens, cache, pos):
    """The target's verify pass: (N, W) tokens at cache positions
    ``[pos, pos + W)`` (an int, or a (N,) tensor of the slots' own) ->
    (N, W, V) float32 logits, their K/V written into ``cache`` in place."""
    emb = module.embedding
    x = embed_rows(emb.token_emb, tokens, cfg.cdtype())
    if cfg.pos_emb:
        positions = _window_positions(pos, tokens.shape[1], tokens.device)
        x = x + emb.pos_emb[0][positions].to(x.dtype)
    for block, lc in zip(module.blocks, cache):
        x = _block_decode_window(block, cfg, x, lc, pos)
    return _logits(module, cfg, x)


def _draft_step(module, cfg: TransformerConfig, cache, token, pos, positions, *, logits: bool):
    """One one-token decode step of the draft at cache position ``pos``
    (an int shared by the rows, or a (N,) tensor), writing its K/V in
    place; returns the (N, V) logits, or None when ``logits`` is false."""
    x = _embed_token(module, cfg, token, positions)
    for block, lc in zip(module.blocks, cache):
        x, _ = _block_decode(block, cfg, x, lc, pos)
    return _logits(module, cfg, x) if logits else None


def _draft_round(module, cfg: TransformerConfig, cache, token, c: int, gamma: int,
                 positions, generator, temperature: float):
    """The draft's ``gamma + 1`` one-token steps from ``token`` (1,) at
    commit pointer ``c``: ``(proposals (gamma,), their logits (gamma, V))``.
    The last step only writes its K/V at ``c + gamma``: its sample would be
    dropped, so its head is not computed."""
    proposals, draft_logits = [], []
    for i in range(gamma + 1):
        logits = _draft_step(module, cfg, cache, token, c + i, positions[c + i:c + i + 1],
                             logits=i < gamma)
        if logits is None:
            break
        token = sample_token(logits, generator, temperature)
        proposals.append(token)
        draft_logits.append(logits[0])
    return torch.cat(proposals), torch.stack(draft_logits)


def _accept_greedy(proposals, logits):
    """Greedy verification of one window: ``(a, emit (W,))``, ``a`` the
    device count of leading proposals equal to the target's argmax, ``emit``
    the accepted proposals followed by the target's own tokens (its
    correction at ``a``)."""
    t = torch.argmax(logits, dim=-1)  # (W,)
    a = torch.cumprod((proposals == t[:-1]).long(), dim=0).sum()
    padded = torch.cat([proposals, proposals.new_zeros(1)])
    return a, torch.where(torch.arange(t.shape[0], device=t.device) < a, padded, t)


def _accept_sampled(proposals, logits, draft_logits, temperature: float, generator):
    """Leviathan et al.'s acceptance for one window: proposal i (drawn from
    the draft's q) is accepted when ``u·q(g_i) <= p(g_i)``, u uniform; the
    first rejection is resampled from the normalised residual max(0, p - q),
    and a full acceptance draws its bonus token from p (the zero row
    appended to Q makes the residual cover it). ``(a, emit (W,))``."""
    gamma = proposals.shape[0]
    p = torch.softmax(logits / temperature, dim=-1)  # (W, V)
    q = torch.cat([torch.softmax(draft_logits / temperature, dim=-1),
                   p.new_zeros(1, p.shape[-1])])
    p_g = p[:gamma].gather(1, proposals[:, None])[:, 0]
    q_g = q[:gamma].gather(1, proposals[:, None])[:, 0]
    u = torch.rand(gamma, generator=generator, device=p.device)
    a = torch.cumprod((u * q_g <= p_g).long(), dim=0).sum()
    p_a, q_a = p.index_select(0, a[None]), q.index_select(0, a[None])  # (1, V)
    resid = torch.clamp(p_a - q_a, min=0.0)
    # identical p and q rows leave an all-zero residual (acceptance should
    # then have fired, round-off aside): draw from p there
    resid = torch.where(resid.sum() > 0, resid, p_a)
    fix = _categorical(torch.log(resid.clamp_min(1e-38)), generator)  # (1,)
    padded = torch.cat([proposals, proposals.new_zeros(1)])
    return a, torch.where(torch.arange(gamma + 1, device=p.device) < a, padded, fix)


@torch.inference_mode()
def generate_speculative(module, cfg: TransformerConfig, prompt, max_new_tokens: int, *,
                         draft_params, draft_cfg: TransformerConfig, gamma: int = 4,
                         temperature: float = 0.0, generator: torch.Generator | None = None,
                         return_stats: bool = False):
    """Speculative decoding of ``prompt`` (1, P) with ``draft_params`` (the
    draft's module, sharing the target's vocabulary) proposing for
    ``module``: (1, max_new_tokens) int64 on the prompt's device.

    ``temperature == 0``: greedy, token for token the target's greedy
    decode. ``temperature > 0``: Leviathan et al.'s acceptance rule, the
    target's sampling distribution; draws come from ``generator`` (default
    seeded 0 on the prompt's device), so streams differ from the JAX
    package's. ``return_stats`` also returns ``{"rounds", "drafted",
    "accepted"}`` (host ints): both counters count only proposals that land
    inside the ``max_new_tokens`` budget. Modules from
    ``Model.quantize_int8`` decode with int8 weights on either side.
    """
    _check_decoder(cfg)
    _check_decoder(draft_cfg)
    n, p = prompt.shape
    if n != 1:
        raise ValueError("generate_speculative is the batch-1 latency path")
    if gamma < 1:
        raise ValueError("gamma must be >= 1")
    total = p + max_new_tokens + gamma + 1
    if total > min(cfg.seq_len, draft_cfg.seq_len):
        raise ValueError(f"prompt + max_new_tokens + gamma + 1 = {total} exceeds seq_len "
                         f"{min(cfg.seq_len, draft_cfg.seq_len)}")
    device = prompt.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    sampling = temperature > 0.0
    target = decode_module(module, cfg)
    draft = target if draft_params is module else decode_module(draft_params, draft_cfg)
    module = target

    t_logits, t_cache = prefill(module, cfg, prompt, total)
    _, d_cache = prefill(draft, draft_cfg, prompt, total)
    token = sample_token(t_logits, generator, temperature)  # (1,)
    buf = torch.zeros(max_new_tokens + gamma + 1, dtype=torch.long, device=device)
    buf[:1] = token
    positions = torch.arange(total, device=device)
    # cache cells [0, c) hold the K/V of sequence tokens [0, c); `token`
    # sits at index c and is fed by the next round's forwards
    n_done, c, rounds, accepted, drafted = 1, p, 0, 0, 0
    while n_done < max_new_tokens:
        proposals, draft_logits = _draft_round(draft, draft_cfg, d_cache, token, c, gamma,
                                               positions, generator, temperature)
        window = torch.cat([token, proposals])[None]  # (1, gamma + 1)
        logits = _forward_window(module, cfg, window, t_cache, c)[0]
        if sampling:
            a, emit = _accept_sampled(proposals, logits, draft_logits, temperature, generator)
        else:
            a, emit = _accept_greedy(proposals, logits)
        a = int(a)  # the round's host sync
        buf[n_done:n_done + gamma + 1] = emit
        useful = min(gamma, max_new_tokens - n_done)
        rounds, accepted, drafted = rounds + 1, accepted + min(a, useful), drafted + useful
        n_done, c, token = n_done + a + 1, c + a + 1, emit[a:a + 1]
    tokens = buf[:max_new_tokens][None]
    if return_stats:
        return tokens, {"rounds": rounds, "accepted": accepted, "drafted": drafted}
    return tokens
