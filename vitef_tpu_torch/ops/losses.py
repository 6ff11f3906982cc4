"""Next-token cross entropy, and the vocabulary head fused into it.

Counterpart of ``vitef_tpu/ops/losses.py``: :func:`next_token_cross_entropy`
(:32-47), the chunked custom VJP ``_fused_ce_sum`` (:86-176) as the
``torch.autograd.Function`` :class:`_FusedCESum`, :func:`fused_next_token_ce`
(:179-205) and :func:`make_fused_head_loss` (:208-228).

The fused loss never holds an (N, L, V) tensor: the forward walks the rows in
chunks, computes each chunk's (C, V) float32 logits and reduces them at once
to their log-sum-exp and target logit, keeping only the (M,) log-sum-exp row
for the backward; the backward re-runs each chunk's head product, forms
``(softmax - onehot) * g`` for that chunk and contracts it into dh and dW
straight away. This is XLA code in the JAX package, not a Pallas kernel: its
vocabulary products are cuBLAS matmuls here, with a float32 output where the
JAX package asks for one (:func:`~.common.mm_f32`).
"""

from __future__ import annotations

import torch

from .common import mm_f32


def next_token_cross_entropy(logits, tokens, *, ignore_index: int | None = None):
    """Mean next-token CE: ``logits`` (N, L, V) predict ``tokens`` shifted left.

    ``logits[:, t]`` scores ``tokens[:, t+1]``; the last logit column is
    dropped. ``ignore_index``: label value excluded from the mean (padding).
    Returns a float32 scalar.
    """
    lg = logits[:, :-1]
    tgt = tokens[:, 1:].long()
    lse = torch.logsumexp(lg.float(), dim=-1)
    valid = tgt != ignore_index if ignore_index is not None else None
    index = tgt if valid is None else torch.where(valid, tgt, 0)
    nll = lse - lg.gather(-1, index[..., None])[..., 0].float()
    if valid is None:
        return nll.mean()
    valid = valid.float()
    return (nll * valid).sum() / valid.sum().clamp_min(1.0)


def _chunk_logits(hc, w, b, w_layout: str):
    """(C, V) float32 logits of one row chunk: ``w`` is (V, d) for the tied
    embedding layout ``'vd'``, (d, V) for the untied head layout ``'dv'``."""
    lg = mm_f32(hc, w.t() if w_layout == "vd" else w)
    if b is not None:
        lg = lg + b.float()
    return lg


class _FusedCESum(torch.autograd.Function):
    """Σ over rows with ``tgt >= 0`` of ``logsumexp(h·Wᵀ + b) - logit[tgt]``.

    ``h`` (M, d) rows in the compute dtype, M a multiple of ``chunk``; ``w``
    the vocabulary weight in its parameter dtype (cast to the compute dtype
    inside, so dW comes back in the parameter dtype); ``tgt`` (M,) int64,
    -1 for masked and padding rows.
    """

    @staticmethod
    def forward(ctx, h, w, b, tgt, w_layout: str, chunk: int):
        wc = w.to(h.dtype)
        bc = None if b is None else b.to(h.dtype)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        lses = []
        for hc, tc in zip(h.split(chunk), tgt.split(chunk)):
            lg = _chunk_logits(hc, wc, bc, w_layout)
            lse = torch.logsumexp(lg, dim=-1)
            picked = lg.gather(1, tc.clamp_min(0)[:, None])[:, 0]
            total += torch.where(tc >= 0, lse - picked, 0.0).sum()
            lses.append(lse)
        ctx.save_for_backward(h, w, b, tgt, torch.cat(lses))
        ctx.w_layout, ctx.chunk = w_layout, chunk
        return total

    @staticmethod
    def backward(ctx, g):
        h, w, b, tgt, lses = ctx.saved_tensors
        cd, layout, chunk = h.dtype, ctx.w_layout, ctx.chunk
        wc = w.to(cd)
        bc = None if b is None else b.to(cd)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = None if b is None else torch.zeros(b.shape, dtype=torch.float32, device=b.device)
        dhs = []
        for hc, tc, lsec in zip(h.split(chunk), tgt.split(chunk), lses.split(chunk)):
            valid = tc >= 0
            p = _chunk_logits(hc, wc, bc, layout).sub_(lsec[:, None]).exp_()  # softmax
            rows = torch.arange(len(tc), device=tc.device)
            p[rows, tc.clamp_min(0)] -= valid.float()  # - onehot(target)
            dlog = p.mul_(torch.where(valid, g, 0.0)[:, None]).to(cd)
            if layout == "vd":
                dhs.append(torch.mm(dlog, wc))
                dw += mm_f32(dlog.t(), hc)
            else:
                dhs.append(torch.mm(dlog, wc.t()))
                dw += mm_f32(hc.t(), dlog)
            if db is not None:
                db += dlog.float().sum(dim=0)
        dh = torch.cat(dhs).to(h.dtype)
        return (dh, dw.to(w.dtype), None if b is None else db.to(b.dtype),
                None, None, None)


def fused_next_token_ce(hidden, w, tokens, *, bias=None, w_layout: str = "vd",
                        ignore_index: int | None = None, chunk: int = 2048):
    """Mean next-token CE computed from the pre-head hidden, with the
    vocabulary head fused into the loss.

    ``hidden`` (N, L, d) post-final-norm rows (``module(x, return_hidden=True)``);
    ``w`` (V, d) in the tied-embedding layout (``w_layout='vd'``) or (d, V)
    in the untied head layout (``'dv'``); ``tokens`` (N, L) integer labels:
    ``hidden[:, t]`` predicts ``tokens[:, t+1]``, as in
    :func:`next_token_cross_entropy`. Returns a float32 scalar. ``chunk``
    rows of logits is the only vocabulary-sized buffer alive at once; the
    last chunk is padded with masked zero rows.
    """
    if w_layout not in ("vd", "dv"):
        raise ValueError(f"w_layout must be 'vd' or 'dv', got {w_layout!r}")
    d = hidden.shape[-1]
    h = hidden[:, :-1].reshape(-1, d)
    tgt = tokens[:, 1:].reshape(-1).long()
    if ignore_index is not None:
        tgt = torch.where(tgt == ignore_index, -1, tgt)
    m = h.shape[0]
    c = min(chunk, m)
    pad = (-m) % c
    if pad:
        h = torch.cat([h, h.new_zeros((pad, d))])
        tgt = torch.cat([tgt, tgt.new_full((pad,), -1)])
    total = _FusedCESum.apply(h, w, bias, tgt, w_layout, c)
    return total / (tgt >= 0).float().sum().clamp_min(1.0)


def make_fused_head_loss(cfg, *, ignore_index: int | None = None, chunk: int = 2048):
    """``(module, hidden, tokens) -> loss`` for seq2seq models: takes the tied
    token embedding or the untied head (its weight is (V, d) in the port's
    layout, and its bias if it has one) from the module and fuses the
    vocabulary product into the CE. Pass as ``make_train_step(...,
    hidden_loss=...)``."""
    if cfg.output_type.lower() != "sequence_to_sequence":
        raise ValueError("fused head loss requires a seq2seq output head")

    def loss(module, hidden, tokens):
        if cfg.weight_tying:
            w, b = module.embedding.token_emb["weight"], None
        else:
            head = module.output.output_layer["head"]
            w, b = head.weight, head.bias
        return fused_next_token_ce(hidden, w, tokens, bias=b, w_layout="vd",
                                   ignore_index=ignore_index, chunk=chunk)

    return loss
