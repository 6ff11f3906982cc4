"""Shared op policy: which implementation runs, and what float32 means.

Counterpart of ``vitef_tpu/ops/common.py`` (``best_precision`` :9-18,
``resolve_impl`` :21-59), and :func:`mm_f32` and :func:`bmm_f32` for the JAX
package's ``preferred_element_type=float32`` products.
"""

from __future__ import annotations

import torch

# The JAX package's names for the two implementations, accepted so that one
# config dict builds both packages.
_ALIASES = {"pallas": "kernel", "xla": "plain"}
# float32 attention at this length or longer takes the kernel on CUDA.
_KERNEL_MIN_SEQ = 512


def use_true_fp32() -> None:
    """Make float32 matmuls and convolutions run in full float32 on the card.

    The JAX package runs every float32 matmul at HIGHEST precision
    (``best_precision``); its float32 path is the parity and analysis path.
    On CUDA, PyTorch may route float32 matmuls (``torch.backends.cuda.matmul
    .allow_tf32``) and convolutions (``torch.backends.cudnn.allow_tf32``, True
    by default) through TF32, which keeps about three decimal digits. This
    sets both flags to False. They are process-wide settings of PyTorch;
    bfloat16 work is unaffected.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_impl(impl: str, device: torch.device, *, seq_len: int | None = None,
                 dtype: torch.dtype | None = None) -> str:
    """Resolve ``impl`` to ``"kernel"`` (a hand-written CUDA kernel) or ``"plain"``.

    ``"auto"`` is one policy:

    - a tensor that is not on a CUDA device takes the plain PyTorch path;
    - on CUDA, bfloat16 attention (``seq_len`` and ``dtype`` given) takes the
      kernel;
    - on CUDA, float32 attention below L=512 takes the plain
      path, as in the JAX package: float32 is the parity/analysis path;
    - norms (no ``seq_len``) take the plain path.

    ``"kernel"`` and ``"plain"`` (or the JAX names ``"pallas"`` and ``"xla"``)
    pick one explicitly.
    """
    impl = canonical_impl(impl)
    if impl == "auto":
        if torch.device(device).type != "cuda":
            return "plain"
        if seq_len is not None and dtype == torch.bfloat16:
            return "kernel"
        if seq_len is not None and seq_len >= _KERNEL_MIN_SEQ:
            return "kernel"
        return "plain"
    return impl


def canonical_impl(impl: str) -> str:
    """``impl`` with the JAX names mapped to the port's (``"pallas"`` ->
    ``"kernel"``, ``"xla"`` -> ``"plain"``); raises ``ValueError`` for a name
    that is none of auto/kernel/plain, so that a config can be checked when
    a model is built."""
    impl = _ALIASES.get(impl, impl)
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}; choose auto/kernel/plain")
    return impl


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 2-D tensors with a float32 result: an einsum with
    ``preferred_element_type=jnp.float32`` in the JAX package.

    float32 operands multiply as they are. On CUDA, lower-precision operands
    go to cuBLAS with a float32 output (``torch.mm(..., out_dtype=...)``:
    bf16 in, float32 accumulate and out). That call has no autograd formula,
    so where autograd needs the product's gradient, and on the CPU, the
    operands are widened to float32 first, which gives the same products (a
    product of two bfloat16 values is exact in float32), summed in another
    order, at float32 speed.
    """
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda and not (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over equal leading batch axes with a float32 result, as an
    einsum with ``preferred_element_type=float32``: bfloat16 operands on CUDA
    go to cuBLAS with a float32 output; elsewhere they are widened first (a
    product of two bfloat16 values is exact in float32). No autograd."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        batch = a.shape[:-2]
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.reshape(*batch, *out.shape[-2:])
    return torch.matmul(a.float(), b.float())
