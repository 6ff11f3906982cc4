"""Int8 weight tables for decoding. Counterpart of ``vitef_tpu/models/quantize.py``.

Ported: :func:`embed_rows` (:139-151), the token gather that both the full-
precision and the int8-quantized embedding tables go through. Not ported
yet: ``quantize_params`` and the int8 linears.
"""

from __future__ import annotations

import torch


def embed_rows(tok_emb, token: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Gather token-embedding rows, dequantizing int8 tables on the fly.

    ``tok_emb`` maps ``"weight"`` to the (V, E) table (full precision) or to
    an int8 (V, E) table beside a float32 ``"scale"`` (V,). The gather reads
    only the selected rows; an int8 row times its scale is formed in float32
    (exact for power-of-two scales), then cast to the compute dtype.
    """
    w = tok_emb["weight"]
    if w.dtype == torch.int8:
        rows = w[token].float() * tok_emb["scale"][token][..., None]
        return rows.to(compute_dtype)
    return w[token].to(compute_dtype)
