"""Tensor parallelism inside a block: the two collectives and the local config.

Under a ``('dp', 'tp')`` mesh with tp > 1 (``parallel.mesh.shard_params``)
each rank of a tp group holds H/tp attention heads and F/tp FFN columns of
every block: the packed qkv and fc1 are column-parallel (each rank computes
its heads' q, k and v, its FFN columns), the attention output and fc2 are
row-parallel (each rank multiplies its slice of the inner axis and one
all-reduce over the group sums the partial products; the bias is added once,
after it). This is the placement of ``vitef_tpu/parallel/mesh.py``'s
``_TP_RULES`` (:156-163), where GSPMD inserts the sums; here they are
explicit:

- :func:`tp_enter` is the identity forward and sums the gradient over the
  group backward (the replicated input feeds every rank's columns);
- :func:`tp_reduce` sums over the group forward (in float32) and is the
  identity backward.

With ``group=None`` both are the identity: one card, or tp = 1.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist


def _all_reduce_f32(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, taken in float32, in ``t``'s dtype."""
    out = t.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_enter(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; backward, the gradient summed over ``group``."""
    return x if group is None else _Enter.apply(x, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The partial products summed over ``group``; identity backward."""
    return x if group is None else _Reduce.apply(x, group)


def local_config(cfg, tp: int):
    """The config one rank's attention and FFN compute with under tensor
    parallelism of degree ``tp``: ``n_heads``, ``n_kv_heads``, ``emb_dim``
    (the attention width, n_heads · head_dim) and ``ffn_dim`` divided by
    ``tp``, so that ``head_dim`` and ``kv_dim`` are the local ones and every
    other field is the model's. Raises ``ValueError`` unless the heads, the
    KV heads and the FFN width divide. An MoE model's FFN splits its experts,
    not its width (:func:`~vitef_tpu_torch.parallel.moe.apply_moe_ffn_tp`):
    its ``ffn_dim`` is kept and need not divide."""
    names = ("n_heads", "n_kv_heads") + (() if cfg.n_experts else ("ffn_dim",))
    for name in names:
        if getattr(cfg, name) % tp:
            raise ValueError(f"tensor parallelism needs {name} % tp == 0, got "
                             f"{getattr(cfg, name)} at tp={tp}")
    local = copy.copy(cfg)
    local.n_heads, local.n_kv_heads = cfg.n_heads // tp, cfg.n_kv_heads // tp
    local.emb_dim = cfg.emb_dim // tp
    if not cfg.n_experts:
        local.ffn_dim = cfg.ffn_dim // tp
    return local
