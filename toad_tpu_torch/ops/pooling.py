"""Masked attention pooling, the MIL core, batched over bags.

PyTorch counterpart of :mod:`toad_tpu.ops.pooling`: ``A = softmax(scores^T)``
over each bag's patches, ``M = A @ h``, with a padding mask. Masked patches
get a ``NEG_INF`` score and so zero weight, which makes padding exact.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Numerically stable softmax over ``dim`` with zero weight where
    ``mask == 0``. ``scores`` [..., N], ``mask`` broadcastable to it."""
    live = mask > 0
    scores = torch.where(live, scores, NEG_INF)
    m = scores.amax(dim=dim, keepdim=True)
    # a fully-masked row has max NEG_INF: shift by 0 instead
    m = torch.where(m <= NEG_INF / 2, 0.0, m)
    e = torch.exp(scores - m) * live
    denom = e.sum(dim=dim, keepdim=True)
    # real rows have denom >= 1 (max-shifted exp); the floor only guards
    # fully-masked rows, and 1e-12 survives squaring in f32
    return e / denom.clamp_min(1e-12)


def masked_attention_pool(
    scores: torch.Tensor,  # [B, N, T] raw attention logits, one column per task
    h: torch.Tensor,  # [B, N, H] patch embeddings
    mask: torch.Tensor,  # [B, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Softmax-weighted mean per task: (M [B, T, H], A [B, T, N])."""
    attn = masked_softmax(scores.transpose(1, 2), mask[:, None, :], dim=-1)
    return torch.bmm(attn, h.float()), attn
