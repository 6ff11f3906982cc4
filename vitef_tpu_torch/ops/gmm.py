"""Grouped matrix products over sorted row groups: kernel K8 and its plain versions.

Counterpart of the megablox ``gmm``/``tgmm`` that ``vitef_tpu/parallel/moe.py``
calls (``_mb_backend`` :420, ``_gmm`` :427-462; the TPU kernels are
``jax/experimental/pallas/ops/tpu/megablox/gmm.py`` ``gmm`` :314 and ``tgmm``
:573). Rows are sorted by group: group ``e`` owns the ``group_sizes[e]``
consecutive rows that start at the sum of the sizes before it.

- :func:`gmm_reference` and :func:`tgmm_reference` — the plain versions: a
  per-group loop of float32 products on the rows of each group, rounded to
  ``out_dtype``;
- :func:`gmm` — ``out[rows of e] = lhs[rows of e] @ rhs[e]``: on a CUDA
  tensor it launches ``csrc/gmm.cu`` in its plain mode;
- :func:`tgmm` — ``out[e] = lhs_t[:, rows of e] @ rhs[rows of e]``: on a
  CUDA tensor it launches ``csrc/tgmm.cu`` in its plain mode;
- :class:`_GMM` — the unfused expert product under autograd (``_gmm``'s
  custom VJP): forward :func:`gmm`; backward :func:`gmm` on the explicitly
  transposed weight (:456) and :func:`tgmm` (:457).

On a CPU tensor each wrapper runs its plain version. On a CUDA tensor it
launches its kernel or raises: bfloat16 or float32 operands of one dtype, an
``out_dtype`` equal to it (every call site of the JAX package asks for the
compute dtype, :440-458), the contracted and output widths multiples of 8.
The kernels read ``group_sizes`` on the card: nothing here reads it on the
host, so no launch waits for the card. The sizes must sum to the row count;
the kernels clamp to it, so a wrong sum cannot read or write out of bounds,
but on the card it is not checked (that would need a host read).
"""

from __future__ import annotations

import torch

from ._build import kernel_function

# Modes of csrc/gmm.cu (its enum Mode) and csrc/tgmm.cu.
PLAIN, SWIGLU_IN, SWIGLU_BWD_OUT, DUAL = 0, 1, 2, 3
_DTYPES = (torch.bfloat16, torch.float32)


def group_bounds(group_sizes) -> list[tuple[int, int]]:
    """``[(start, end), ...]`` of each group's rows, read on the host (plain
    versions only)."""
    bounds, start = [], 0
    for size in group_sizes.tolist():
        bounds.append((start, start + size))
        start += size
    return bounds


def _check_sizes(group_sizes, rows: int) -> None:
    """The plain versions' check that the groups cover exactly ``rows`` rows."""
    if group_sizes.dim() != 1 or int(group_sizes.sum()) != rows or bool((group_sizes < 0).any()):
        raise ValueError(f"group_sizes {group_sizes.tolist()} must be >= 0 and sum to {rows}")


def gmm_reference(lhs, rhs, group_sizes, out_dtype=None):
    """Plain version of :func:`gmm`: ``lhs`` (G, k), ``rhs`` (E, k, n) ->
    (G, n); each group's rows times its expert's matrix in float32, rounded
    to ``out_dtype`` (default: lhs's dtype)."""
    _check_sizes(group_sizes, lhs.shape[0])
    out = torch.empty((lhs.shape[0], rhs.shape[2]), dtype=torch.float32, device=lhs.device)
    for e, (start, end) in enumerate(group_bounds(group_sizes)):
        out[start:end] = lhs[start:end].float() @ rhs[e].float()
    return out.to(out_dtype or lhs.dtype)


def tgmm_reference(lhs_t, rhs, group_sizes, num_groups: int, out_dtype=None):
    """Plain version of :func:`tgmm`: ``lhs_t`` (k, G), ``rhs`` (G, n) ->
    (num_groups, k, n); each group's columns of lhs_t times its rows of rhs
    in float32 (an empty group gives zeros), rounded to ``out_dtype``
    (default: lhs_t's dtype)."""
    _check_sizes(group_sizes, rhs.shape[0])
    out = torch.zeros((num_groups, lhs_t.shape[0], rhs.shape[1]), dtype=torch.float32,
                      device=rhs.device)
    for e, (start, end) in enumerate(group_bounds(group_sizes)):
        out[e] = lhs_t[:, start:end].float() @ rhs[start:end].float()
    return out.to(out_dtype or lhs_t.dtype)


def kernel_operands(name: str, tensors: dict, group_sizes, out_dtype):
    """Check that the kernel ``name`` takes ``tensors`` (name -> tensor) and
    ``group_sizes``; return them contiguous and 16-byte aligned, and the
    sizes as int32 on the same device."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {first.device}")
    if first.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype must be bfloat16 or float32, got {first.dtype}")
    for key, t in tensors.items():
        if t.dtype != first.dtype or t.device != first.device:
            raise ValueError(f"{name}: {key} is {t.dtype} on {t.device}, beside "
                             f"{first.dtype} on {first.device}")
    if out_dtype not in (None, first.dtype):
        raise ValueError(f"{name}: the kernel writes its operands' dtype {first.dtype}, "
                         f"not {out_dtype}")
    if group_sizes.dim() != 1 or group_sizes.device != first.device \
            or group_sizes.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: group_sizes must be a 1-D integer tensor on "
                         f"{first.device}, got {group_sizes.dtype} {tuple(group_sizes.shape)} "
                         f"on {group_sizes.device}")
    out = {}
    for key, t in tensors.items():
        t = t.contiguous()
        out[key] = t if t.data_ptr() % 16 == 0 else t.clone()
    return out, group_sizes.to(torch.int32).contiguous()


def check_widths(name: str, **widths) -> None:
    """Raise unless every width is a positive multiple of 8 (the kernels move
    rows in 16-byte pieces)."""
    bad = {k: v for k, v in widths.items() if v <= 0 or v % 8}
    if bad:
        raise ValueError(f"{name}: widths must be positive multiples of 8, got {bad}")


def launch_gmm(mode: int, a, b, w, h, group_sizes, out, out2, k: int, n: int) -> bool:
    """``csrc/gmm.cu`` on checked operands: G = a's rows, E = w's groups, the
    contraction width ``k`` and output width ``n`` of ``mode``. Returns
    whether it launched: with no rows there is nothing to compute."""
    g_rows, n_groups = a.shape[0], w.shape[0]
    if g_rows == 0:
        return False
    pointers = [a, b, w, h, group_sizes, out, out2]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = kernel_function("gmm", len(pointers), 6)(
            *(None if t is None else t.data_ptr() for t in pointers), g_rows, k, n, n_groups,
            mode, int(a.dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"gmm launch failed: cudaError {err} (mode {mode}, G={g_rows}, "
                           f"k={k}, n={n}, E={n_groups}, {a.dtype})")
    return True


def launch_tgmm(mode: int, a, b, group_sizes, out, k: int, n: int) -> None:
    """``csrc/tgmm.cu`` on checked operands: a (G, k) (or h (G, 2k) with
    ``SWIGLU_IN``), b (G, n), out (E, k, n)."""
    pointers = [a, b, group_sizes, out]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = kernel_function("tgmm", len(pointers), 6)(
            *(t.data_ptr() for t in pointers), b.shape[0], k, n, out.shape[0], mode,
            int(a.dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"tgmm launch failed: cudaError {err} (mode {mode}, G={b.shape[0]}, "
                           f"k={k}, n={n}, E={out.shape[0]}, {a.dtype})")


def gmm(lhs, rhs, group_sizes, out_dtype=None):
    """Grouped product ``out[rows of e] = lhs[rows of e] @ rhs[e]``: lhs
    (G, k), rhs (E, k, n), group_sizes (E,) -> (G, n) in ``out_dtype``
    (default: lhs's dtype), float32 accumulation.

    A CPU tensor goes through :func:`gmm_reference`. A CUDA tensor launches
    ``csrc/gmm.cu`` (plain mode; in bfloat16 a persistent TMA + ``wgmma``
    pipeline over 128 x 256 output tiles, whose tensor maps need the
    16-byte aligned operands that :func:`kernel_operands` gives it), or
    raises if the kernel does not take it. ``gmm.launches`` counts its
    launches.
    """
    if lhs.device.type == "cpu":
        return gmm_reference(lhs, rhs, group_sizes, out_dtype)
    ops, sizes = kernel_operands("gmm", {"lhs": lhs, "rhs": rhs}, group_sizes, out_dtype)
    lhs, rhs = ops["lhs"], ops["rhs"]
    g_rows, k = lhs.shape
    if rhs.dim() != 3 or rhs.shape[1] != k or sizes.shape[0] != rhs.shape[0]:
        raise ValueError(f"gmm: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)} and "
                         f"group_sizes {tuple(sizes.shape)} do not fit")
    n = rhs.shape[2]
    check_widths("gmm", k=k, n=n)
    out = torch.empty((g_rows, n), dtype=lhs.dtype, device=lhs.device)
    if launch_gmm(PLAIN, lhs, None, rhs, None, sizes, out, None, k, n):
        gmm.launches += 1
    return out


gmm.launches = 0


def tgmm(lhs_t, rhs, group_sizes, num_groups: int, out_dtype=None):
    """Grouped transposed product ``out[e] = lhs_t[:, rows of e] @ rhs[rows
    of e]``: lhs_t (k, G), rhs (G, n) -> (num_groups, k, n) in ``out_dtype``
    (default: lhs_t's dtype), float32 accumulation; an empty group gives
    zeros.

    ``lhs_t`` is read as the (G, k) rows it transposes: pass ``x.t()`` of a
    contiguous (G, k) ``x``, and nothing is copied. A CPU tensor goes through
    :func:`tgmm_reference`. A CUDA tensor launches ``csrc/tgmm.cu`` (plain
    mode; in bfloat16 a persistent TMA + ``wgmma`` pipeline over 128 x 256
    output tiles, largest group first, whose tensor maps need the 16-byte
    aligned operands that :func:`kernel_operands` gives it; each tile sums
    its group's rows in a fixed order, no atomics, so two launches give the
    same bits), or raises if the kernel does not take it. ``tgmm.launches``
    counts its launches.
    """
    if rhs.device.type == "cpu":
        return tgmm_reference(lhs_t, rhs, group_sizes, num_groups, out_dtype)
    ops, sizes = kernel_operands("tgmm", {"lhs": lhs_t.t(), "rhs": rhs}, group_sizes,
                                 out_dtype)
    lhs, rhs = ops["lhs"], ops["rhs"]
    if lhs.shape[0] != rhs.shape[0] or sizes.shape[0] != num_groups:
        raise ValueError(f"tgmm: lhs_t {tuple(lhs_t.shape)}, rhs {tuple(rhs.shape)} and "
                         f"group_sizes {tuple(sizes.shape)} do not fit {num_groups} groups")
    k, n = lhs.shape[1], rhs.shape[1]
    check_widths("tgmm", k=k, n=n)
    out = torch.empty((num_groups, k, n), dtype=lhs.dtype, device=lhs.device)
    launch_tgmm(PLAIN, lhs, rhs, sizes, out, k, n)
    tgmm.launches += 1
    return out


tgmm.launches = 0


class _GMM(torch.autograd.Function):
    """The unfused expert product (``_gmm``'s custom VJP, :427-462): forward
    ``gmm(lhs, rhs)`` in ``out_dtype``; backward ``dlhs = gmm(g, rhsᵀ)`` on
    the explicitly transposed (E, n, k) weight, in lhs's dtype, and ``drhs =
    tgmm(lhsᵀ, g)`` in rhs's dtype."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, out_dtype):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return gmm(lhs, rhs, group_sizes, out_dtype)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, group_sizes = ctx.saved_tensors
        g = g.contiguous()
        dlhs = gmm(g, rhs.transpose(1, 2).contiguous(), group_sizes, lhs.dtype)
        drhs = tgmm(lhs.t(), g, group_sizes, rhs.shape[0], rhs.dtype)
        return dlhs, drhs, None, None


def gmm_autograd(lhs, rhs, group_sizes, out_dtype=None):
    """:func:`gmm` with its gradient (:class:`_GMM`)."""
    return _GMM.apply(lhs, rhs, group_sizes, out_dtype or lhs.dtype)
