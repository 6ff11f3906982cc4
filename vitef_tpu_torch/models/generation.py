"""Autoregressive decoding with a static KV cache. Counterpart of ``vitef_tpu/models/generation.py``.

The serving path of a causal decoder, with the JAX module's names:

- :func:`init_kv_cache` (:59-88) allocates each layer's K/V once, head-split
  (batch, n_kv_heads, max_len, head_dim), in the compute dtype or as int8
  rows with float32 scales (:func:`quantize_kv`, :97-110);
- :func:`prefill` (:406-450) runs one causal forward over the prompt and
  fills the cache's first P positions. Ragged batches are left-padded with a
  ``prompt_mask``: positions follow each row's own tokens and padded keys are
  masked out of every attention. In bfloat16 inside the packed gate the
  attention is kernel K1 (:func:`~vitef_tpu_torch.ops.attention.fused_mha_packed`),
  its key-masked mode for a ragged batch, exactly where the JAX package takes
  its Pallas kernel (:232-249); otherwise the grouped einsum with -1e30;
- :func:`_block_decode` (:311-366) writes one token's K/V at ``pos`` in place
  and attends over the cache (:func:`_attend_cached`, :113-173). It reads
  only the prefix ``[:pos+1]``: the JAX version reads all ``max_len``
  positions and masks the unwritten ones, which adds exact zeros, so both
  compute the same function;
- :func:`sample_token` (:453-504): greedy, temperature, top-k and top-p,
  with ``lax.top_k``'s candidate order; categorical draws are Gumbel-max from
  an explicit ``torch.Generator`` on the logits' device (streams differ from
  ``jax.random``'s; the distributions are the same);
- :func:`generate` (:507-586): a Python loop of decode steps under
  ``torch.inference_mode``, the cache preallocated at ``P + max_new_tokens``,
  EOS handled on the device (no host sync per step), on
  :func:`decode_module`'s copy of the weight matrices in the compute dtype.

A module from ``Model.quantize_int8`` (``models/quantize.py``) decodes with
int8 weights through the same functions: its linears take the int8 branch,
and the token table and a tied head read its int8 rows times their scales.

The functions take the model's :class:`~vitef_tpu_torch.models.transformer.Transformer`
module where the JAX ones take its parameter tree, and use its submodules
(linears, norms, FFN), so their numerics are the training forward's.
"""

from __future__ import annotations

import math

import torch

from ..ops.attention import attention_route, fused_mha_packed
from ..ops.common import bmm_f32, mm_f32
from .quantize import decode_matrices, embed_rows, module_with
from .rope import apply_rope, rope_angles
from .transformer import TransformerConfig, split_qkv

_NEG_INF = -1e30


def _check_decoder(cfg: TransformerConfig) -> None:
    if not cfg.causal:
        raise ValueError("generate() requires a causal (decoder-only) model")
    if cfg.patch_type or cfg.cls_token:
        raise ValueError("generate() is for token-sequence models (no patching/cls)")
    if cfg.emb_type.lower() != "dict":
        raise ValueError("generate() requires a dict token embedding")
    if cfg.output_type.lower() != "sequence_to_sequence":
        raise ValueError("generate() requires output_type=sequence_to_sequence")
    if cfg.norm.lower() == "batch":
        raise ValueError("batch-norm models are not supported for decoding")


def decode_module(module, cfg: TransformerConfig):
    """The module that :func:`generate` and ``DecodeServer`` decode with:
    ``module`` itself, or, where its weight matrices (``decode_matrices``)
    are float but not in the compute dtype (the float32 weights of a
    bfloat16 model), a copy holding them cast to the compute dtype once,
    every other tensor shared. Each linear casts its weight at every call,
    and each product and gather reads exactly the cast values, so the
    outputs are the same; the copy costs the matrices' bytes in the compute
    dtype while it lives (16 GB for Llama-3.1-8B in bfloat16) and saves a
    decode step reading the float32 weights and writing their cast."""
    cd = cfg.cdtype()
    state = module.state_dict()
    cast = {name: state[name].to(cd) for name in decode_matrices(state)
            if state[name].is_floating_point() and state[name].dtype != cd}
    return module_with(module, cast) if cast else module


def _check_kv_dtype(kv_cache_dtype) -> None:
    if kv_cache_dtype not in (None, "int8"):
        raise ValueError(f"kv_cache_dtype must be None or 'int8', got {kv_cache_dtype!r}")


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  kv_cache_dtype: str | None = None, *, device) -> list[dict]:
    """Per-layer zeroed K/V buffers (batch, n_kv_heads, max_len, head_dim) in
    the compute dtype, or int8 with ``k_scale``/``v_scale`` (batch,
    n_kv_heads, max_len) float32 for ``kv_cache_dtype="int8"``."""
    _check_kv_dtype(kv_cache_dtype)
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    if kv_cache_dtype is None:
        return [{"k": torch.zeros(shape, dtype=cfg.cdtype(), device=device),
                 "v": torch.zeros(shape, dtype=cfg.cdtype(), device=device)}
                for _ in range(cfg.n_layers)]
    return [{"k": torch.zeros(shape, dtype=torch.int8, device=device),
             "v": torch.zeros(shape, dtype=torch.int8, device=device),
             "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
             "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device)}
            for _ in range(cfg.n_layers)]


def _split_heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(N, L, E) -> (N, h, L, d)."""
    n, l, e = t.shape
    return t.reshape(n, l, n_heads, e // n_heads).transpose(1, 2)


def quantize_kv(t: torch.Tensor):
    """Symmetric per-row int8 quantization of (..., d) K/V vectors:
    ``(int8 values, float32 scales (...,))`` with ``t ≈ values * scales``."""
    tf = t.float()
    scale = (tf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.round(tf / scale[..., None])
    return q.clamp(-127, 127).to(torch.int8), scale


def _attend_cached(q, k_cache, v_cache, n_heads: int, pos, key_mask=None,
                   k_scale=None, v_scale=None):
    """One-token attention against the (N, kv_heads, Lmax, d) cache.

    ``q``: (N, E), the token at cache position ``pos``. An int ``pos`` (the
    batch-synchronous decode) reads the cache prefix ``[:pos+1]``; a (N,)
    tensor (the server's per-slot positions) reads all Lmax positions and
    masks those past each row's own. ``key_mask`` (N, Lmax) also masks the
    left padding of ragged prompts. Scores and softmax are float32. An int8
    cache's K scale multiplies the scores and its V scale the weights, so the
    cache is read as int8 values cast to the compute dtype. Query heads
    [k*g, (k+1)*g) share kv head k.
    """
    n, kvh, lmax, d = k_cache.shape
    g = n_heads // kvh
    cd = q.dtype
    if isinstance(pos, int):
        k_cache, v_cache = k_cache[:, :, :pos + 1], v_cache[:, :, :pos + 1]
        if k_scale is not None:
            k_scale, v_scale = k_scale[..., :pos + 1], v_scale[..., :pos + 1]
        valid = None if key_mask is None else key_mask[:, :pos + 1]
    else:
        valid = torch.arange(lmax, device=q.device)[None, :] <= pos[:, None]
        if key_mask is not None:
            valid = valid & key_mask
    quantized = k_cache.dtype == torch.int8
    kc = k_cache.to(cd) if quantized else k_cache
    vc = v_cache.to(cd) if quantized else v_cache
    scores = bmm_f32(q.reshape(n, kvh, g, d), kc.transpose(-1, -2))  # (N, kvh, g, P)
    if quantized:
        scores = scores * k_scale[:, :, None, :]
    scores = scores * (1.0 / math.sqrt(d))
    if valid is not None:
        scores = scores.masked_fill(~valid[:, None, None, :], _NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    if quantized:
        weights = weights * v_scale[:, :, None, :]
    out = bmm_f32(weights.to(vc.dtype), vc).to(cd)
    return out.reshape(n, n_heads * d)


def _rope_cos_sin(cfg: TransformerConfig, positions):
    """(cos, sin) for rope models, else (None, None)."""
    if not cfg.uses_rope:
        return None, None
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def _attention_prefill(attn, cfg: TransformerConfig, x, key_mask=None, positions=None):
    """Causal self-attention of block attention module ``attn`` over the
    prompt, returning ``(out, k, v)`` for the cache.

    q and k of rope models are rotated at ``positions`` ((N, L) logical
    positions of a ragged batch; arange(L) by default) before attention, and
    the rotated k is returned. bfloat16 inside the packed gate takes K1 on
    the packed [q | k | v], each k/v head repeated over its query group
    (the cache keeps the unrepeated k/v), with ``key_mask`` (N, L) in the
    kernel's masked mode; otherwise the grouped einsum with float32 scores.
    """
    cd = cfg.cdtype()
    n, l = x.shape[:2]
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    e = h * d  # the attention width: this rank's heads under tensor parallelism
    q, k, v = split_qkv(cfg, attn.qkv_mat(x, cd))
    if cfg.uses_rope:
        pos_ids = torch.arange(l, device=x.device) if positions is None else positions
        cos, sin = _rope_cos_sin(cfg, pos_ids)
        cos, sin = cos[..., :, None, :], sin[..., :, None, :]  # over (N, L, heads, d)
        q = apply_rope(q.reshape(n, l, h, d), cos, sin).reshape(n, l, e)
        k = apply_rope(k.reshape(n, l, kv, d), cos, sin).reshape(n, l, kv * d)
    impl = cfg.attn_impl if cfg.flash else "plain"
    if attention_route(impl, x.device, seq_len=l, emb_dim=e, n_heads=h, dtype=cd) == "packed":
        kq, vq = k, v
        if kv < h:
            def rep(t):
                return t.reshape(n, l, kv, 1, d).expand(n, l, kv, h // kv, d).reshape(n, l, e)
            kq, vq = rep(k), rep(v)
        z = fused_mha_packed(torch.cat([q, kq, vq], dim=-1), h, causal=True,
                             key_mask=key_mask)
        return attn.output(z, cd), k, v
    qh = _split_heads(q, h).reshape(n, kv, h // kv, l, d)
    kh, vh = _split_heads(k, kv), _split_heads(v, kv)
    scores = torch.matmul(qh.float(), kh.float()[:, :, None].transpose(-1, -2))
    scores = scores * (1.0 / math.sqrt(d))
    scores = scores.masked_fill(torch.ones(l, l, dtype=torch.bool, device=x.device).triu(1),
                                _NEG_INF)
    if key_mask is not None:
        scores = scores.masked_fill(~key_mask[:, None, None, None, :], _NEG_INF)
    weights = torch.softmax(scores, dim=-1).to(vh.dtype)
    z = torch.matmul(weights.float(), vh.float()[:, :, None]).to(cd)
    z = z.reshape(n, h, l, d).transpose(1, 2).reshape(n, l, e)
    return attn.output(z, cd), k, v


def _block_prefill(block, cfg: TransformerConfig, x, key_mask=None, positions=None):
    """The block's deterministic forward, also returning its (k, v). The FFN
    is the block's own: dense, or the MoE FFN, whose forward takes the sparse
    dispatch or the dense oracle as ``resolve_moe_impl`` picks for the
    call's token count (the JAX ``_ffn``, :274-285)."""
    if cfg.pre_norm:
        att, k, v = _attention_prefill(block.attn, cfg, block.attn_norm(x), key_mask,
                                       positions)
        out = x + att
        out = out + block.ffn(block.ffn_norm(out))
    else:
        att, k, v = _attention_prefill(block.attn, cfg, x, key_mask, positions)
        out = block.attn_norm(x + att)
        out = block.ffn_norm(out + block.ffn(out))
    return out, k, v


def _residual_block(block, cfg: TransformerConfig, x, attn):
    """The block's residual structure around ``attn`` (its attention on the
    normed input, pre-norm, or on ``x``, post-norm) and its FFN."""
    if cfg.pre_norm:
        out = x + attn(block.attn_norm(x))
        return out + block.ffn(block.ffn_norm(out))
    out = block.attn_norm(x + attn(x))
    return block.ffn_norm(out + block.ffn(out))


def _block_decode(block, cfg: TransformerConfig, x, layer_cache: dict, pos,
                  key_mask=None, positions=None):
    """One-token block step: writes this token's k/v into ``layer_cache`` at
    ``pos`` in place and returns ``(out, layer_cache)``.

    ``x``: (N, E). ``pos``: the cache position, an int shared by every row
    (``generate``) or a (N,) tensor of each row's own (the server's slots,
    the JAX ``_block_decode_slots``). ``positions``: (N,) logical positions
    for RoPE (ragged prompts decode at one cache position but different
    logical ones); default ``pos``.
    """
    cd = cfg.cdtype()
    kv, d = cfg.n_kv_heads, cfg.head_dim
    n = x.shape[0]
    at = ((slice(None), slice(None), pos) if isinstance(pos, int)
          else (torch.arange(n, device=x.device), slice(None), pos))

    def attn(x_in):
        q, k, v = split_qkv(cfg, block.attn.qkv_mat(x_in, cd))
        if cfg.uses_rope:
            pos_ids = positions if positions is not None else (
                torch.full((n,), pos, device=x.device) if isinstance(pos, int) else pos)
            cos, sin = _rope_cos_sin(cfg, pos_ids)  # (N, d/2)
            q = apply_rope(q.reshape(n, cfg.n_heads, d), cos[:, None], sin[:, None]).reshape(n, -1)
            k = apply_rope(k.reshape(n, kv, d), cos[:, None], sin[:, None]).reshape(n, -1)
        kh, vh = k.reshape(n, kv, d), v.reshape(n, kv, d)
        if layer_cache["k"].dtype == torch.int8:
            kh, layer_cache["k_scale"][at] = quantize_kv(kh)
            vh, layer_cache["v_scale"][at] = quantize_kv(vh)
        layer_cache["k"][at] = kh.to(layer_cache["k"].dtype)
        layer_cache["v"][at] = vh.to(layer_cache["v"].dtype)
        z = _attend_cached(q, layer_cache["k"], layer_cache["v"], cfg.n_heads, pos, key_mask,
                           layer_cache.get("k_scale"), layer_cache.get("v_scale"))
        return block.attn.output(z, cd)

    return _residual_block(block, cfg, x, attn), layer_cache


def _logits(module, cfg: TransformerConfig, x):
    """The seq2seq head on (..., E) hidden states -> (..., V) float32 logits:
    the final norm, then the tied head (the token table in the compute dtype;
    an int8 table's per-row scale multiplies the float32 logits) or the
    untied one."""
    cd = cfg.cdtype()
    out = module.output.output_layer["norm"](x)
    if not cfg.weight_tying:
        return module.output.output_layer["head"](out, cd).float()
    tok = module.embedding.token_emb
    flat = out.reshape(-1, out.shape[-1]).to(cd)
    logits = mm_f32(flat, tok["weight"].to(cd).t())
    if tok["weight"].dtype == torch.int8:
        logits = logits * tok["scale"]
    return logits.reshape(*out.shape[:-1], -1)


def _embed_token(module, cfg: TransformerConfig, token, positions):
    """(N,) tokens at per-row logical ``positions`` -> (N, E)."""
    emb = module.embedding
    x = embed_rows(emb.token_emb, token, cfg.cdtype())
    if cfg.pos_emb:
        x = x + emb.pos_emb[0][positions].to(x.dtype)
    return x


@torch.inference_mode()
def prefill(module, cfg: TransformerConfig, prompt, max_len: int, prompt_mask=None,
            kv_cache_dtype: str | None = None):
    """Batched causal forward over ``prompt`` (N, P), filling the KV cache.

    Ragged batches are left-padded to P with ``prompt_mask`` (N, P) bool
    marking the real, right-aligned tokens: every row's next token then lands
    in cache position P. Positions are each row's own (``cumsum(mask) - 1``)
    and padded keys are masked out of every attention. Returns
    ``(last_logits (N, V) float32, cache)``, the cache sized ``max_len`` with
    positions [0, P) filled.
    """
    _check_decoder(cfg)
    _check_kv_dtype(kv_cache_dtype)
    n, p = prompt.shape
    cd = cfg.cdtype()
    emb = module.embedding
    x = embed_rows(emb.token_emb, prompt, cd)
    positions = None
    if prompt_mask is not None:
        prompt_mask = prompt_mask.bool()
        positions = (prompt_mask.long().cumsum(dim=1) - 1).clamp_min(0)
    if cfg.pos_emb:
        pe = emb.pos_emb[:, :p] if prompt_mask is None else emb.pos_emb[0][positions]
        x = x + pe.to(cd)
    cache = init_kv_cache(cfg, n, max_len, kv_cache_dtype, device=prompt.device)
    for block, lc in zip(module.blocks, cache):
        x, k, v = _block_prefill(block, cfg, x, prompt_mask, positions)
        kh, vh = _split_heads(k.to(cd), cfg.n_kv_heads), _split_heads(v.to(cd), cfg.n_kv_heads)
        if kv_cache_dtype == "int8":
            kh, lc["k_scale"][:, :, :p] = quantize_kv(kh)
            vh, lc["v_scale"][:, :, :p] = quantize_kv(vh)
        lc["k"][:, :, :p] = kh
        lc["v"][:, :, :p] = vh
    return _logits(module, cfg, x[:, -1, :]), cache


def _top_k(logits: torch.Tensor, k: int):
    """``(values, indices)`` of each row's ``k`` largest logits in
    ``jax.lax.top_k``'s order: descending, ties to the lower index first.
    A stable descending sort keeps equal values in ascending index order;
    ``torch.topk`` does not specify its order among them."""
    vals, idx = logits.sort(dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits), by Gumbel-max."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_token(logits: torch.Tensor, generator: torch.Generator | None = None,
                 temperature: float = 1.0, top_k: int | None = None,
                 approx_top_k: bool = False, top_p: float | None = None,
                 top_p_candidates: int = 256) -> torch.Tensor:
    """Next tokens (N,) int64 from (N, V) float32 logits.

    ``temperature == 0`` (or ``top_k == 1``) is greedy argmax (the first
    index on ties). Otherwise a temperature-scaled categorical draw from
    ``generator`` (a new one seeded 0 on the logits' device when None),
    restricted to the ``top_k`` largest logits and/or the ``top_p`` nucleus:
    the smallest prefix of descending-probability tokens whose probability
    before each token is <= ``top_p``, with probabilities normalised over the
    whole vocabulary, among the ``top_k`` (or ``top_p_candidates``) largest.
    ``approx_top_k`` is accepted and exact.
    """
    del approx_top_k
    if temperature == 0.0 or top_k == 1:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        generator = torch.Generator(device=logits.device).manual_seed(0)
    if top_p is not None:
        k = min(top_k or top_p_candidates, logits.shape[-1])
        vals, idx = _top_k(logits, k)
        scaled = vals / temperature  # descending
        lse = torch.logsumexp(logits / temperature, dim=-1, keepdim=True)
        probs = torch.exp(scaled - lse)
        before = torch.cumsum(probs, dim=-1) - probs  # cumulative before each token
        scaled = torch.where(before <= top_p, scaled, _NEG_INF)
        return idx.gather(-1, _categorical(scaled, generator)[..., None])[..., 0]
    if top_k is not None:
        vals, idx = _top_k(logits, top_k)
        return idx.gather(-1, _categorical(vals / temperature, generator)[..., None])[..., 0]
    return _categorical(logits / temperature, generator)


@torch.inference_mode()
def generate(module, cfg: TransformerConfig, prompt, max_new_tokens: int, *,
             temperature: float = 1.0, top_k: int | None = None,
             generator: torch.Generator | None = None, prompt_mask=None,
             kv_cache_dtype: str | None = None, top_p: float | None = None,
             eos_token_id: int | None = None):
    """Generate ``max_new_tokens`` tokens after ``prompt`` (N, P): (N,
    max_new_tokens) int64 on the prompt's device.

    Ragged batches are left-padded to P with ``prompt_mask`` (N, P) bool
    marking the real, right-aligned tokens; each row's result is then the
    one of generating it unpadded. ``kv_cache_dtype="int8"`` stores the cache
    as int8 rows with float32 scales. ``top_p``: nucleus sampling
    (:func:`sample_token`). ``eos_token_id``: once a row emits EOS, all its
    later tokens are EOS; every row runs all steps, and the flags stay on the
    device. ``generator`` (default: seeded 0 on the prompt's device) draws
    the samples.
    """
    _check_decoder(cfg)
    n, p = prompt.shape
    total = p + max_new_tokens
    if total > cfg.seq_len:
        raise ValueError(f"prompt ({p}) + max_new_tokens ({max_new_tokens}) exceeds "
                         f"seq_len {cfg.seq_len}")
    device = prompt.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    module = decode_module(module, cfg)
    key_mask = None
    lengths = torch.full((n,), p, dtype=torch.long, device=device)
    if prompt_mask is not None:
        prompt_mask = prompt_mask.bool()
        lengths = prompt_mask.long().sum(dim=1)
        # pad slots stay masked for the whole generation; decoded slots are valid
        key_mask = torch.cat([prompt_mask, torch.ones((n, max_new_tokens), dtype=torch.bool,
                                                      device=device)], dim=1)

    last_logits, cache = prefill(module, cfg, prompt, total, prompt_mask, kv_cache_dtype)
    token = sample_token(last_logits, generator, temperature, top_k, top_p=top_p)
    out = torch.empty((n, max_new_tokens), dtype=torch.long, device=device)
    out[:, 0] = token
    done = None if eos_token_id is None else token == eos_token_id
    for i in range(1, max_new_tokens):
        pos = p + i - 1  # the cache position of the token being fed
        logical = lengths + (pos - p)
        x = _embed_token(module, cfg, token, logical)
        for block, lc in zip(module.blocks, cache):
            x, _ = _block_decode(block, cfg, x, lc, pos, key_mask, positions=logical)
        token = sample_token(_logits(module, cfg, x), generator, temperature, top_k,
                             top_p=top_p)
        if done is not None:
            token = torch.where(done, eos_token_id, token)
            done = done | (token == eos_token_id)
        out[:, i] = token
    return out
