"""Bucketed padding helpers (counterparts of the ones in
:mod:`toad_tpu.data.batching` that serving needs)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; the largest bucket if n exceeds them all (the
    bag is then truncated to it)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _pad_bag(feats: np.ndarray, bucket: int) -> tuple[np.ndarray, np.ndarray]:
    n, d = feats.shape
    if n > bucket:
        feats = feats[:bucket]
        n = bucket
    out = np.zeros((bucket, d), dtype=np.float32)
    out[:n] = feats
    mask = np.zeros((bucket,), dtype=np.float32)
    mask[:n] = 1.0
    return out, mask


def resolve_transfer_dtype(transfer_dtype: str, compute_dtype: str) -> str:
    """'auto' -> bfloat16 iff the model computes in bf16 (the features are
    rounded to bf16 either side of the wire, so the host-side cast changes
    nothing and halves the host-to-device bytes); float32 otherwise."""
    if transfer_dtype != "auto":
        return transfer_dtype
    return "bfloat16" if compute_dtype == "bfloat16" else "float32"
