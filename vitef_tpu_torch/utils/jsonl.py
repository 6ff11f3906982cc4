"""JSONL metric IO. Counterpart of ``vitef_tpu/utils/jsonl.py`` (:1-63), copied.

The jsonl files the monitor writes (``metrics/raw_<rank>.jsonl``,
``metrics/eval.jsonl``, ``metrics/info_model.jsonl``) are a public contract
that ``apps/plots`` reads: :func:`load_jsonl_to_numpy` reads them as a dict
of arrays, NaN where a record lacks a key.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def read_jsonl(path) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def write_jsonl(path, records: list[dict], mode: str = "w") -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, mode) as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def get_jsonl_keys(path) -> list[str]:
    """Union of keys across all records, in first-seen order."""
    keys: dict[str, None] = {}
    for rec in read_jsonl(path):
        for k in rec:
            keys.setdefault(k, None)
    return list(keys)


def load_jsonl_to_numpy(path, keys: list[str] | None = None) -> dict[str, np.ndarray]:
    """Read jsonl as a dict of numpy arrays, NaN for missing values."""
    records = read_jsonl(path)
    if keys is None:
        keys = list({k: None for rec in records for k in rec})
    out: dict[str, list] = {k: [] for k in keys}
    for rec in records:
        for k in keys:
            out[k].append(rec.get(k, np.nan))
    result = {}
    for k, vals in out.items():
        try:
            result[k] = np.asarray(vals, dtype=float)
        except (TypeError, ValueError):
            result[k] = np.asarray(vals, dtype=object)
    return result
