"""Fused trunk + gated attention + pooling over padded bags.

PyTorch counterpart of :mod:`toad_tpu.ops.fused_pool`. Per bag:

    h = relu(x @ W1 + b1); h = relu(h @ W2 + b2)          # trunk MLP
    a = tanh(h @ Wa + ba); g = sigmoid(h @ Wb + bb)       # gate
    s = (a * g) @ Wc + bc                                  # [N, T] scores
    A = masked_softmax(s^T); M = A @ h                     # [T, H] pooled

A CUDA tensor goes to the hand-written kernel (:mod:`.cuda_pool`; the int8
pool to :mod:`.cuda_pool_int8`); a CPU tensor goes to the plain version
(below; the int8 one in :mod:`.quantize`). The kernel computes the gated
attention only, as the JAX package's: :func:`kernel_pools` sends un-gated
params to the plain version on the tensors' own device, the card included,
where the JAX package takes its XLA path. Nothing else chooses between them.
``params`` is the JAX package's pytree layout: ``{"trunk": {"fc1": {"w",
"b"}, "fc2": ...}, "attn": {"a", "b", "c"}}`` with [in, out] weights.
"""

from __future__ import annotations

from typing import Any

import torch

from toad_tpu_torch.ops import cuda_pool, cuda_pool_int8
from toad_tpu_torch.ops.pooling import NEG_INF, masked_attention_pool
from toad_tpu_torch.ops.quantize import plain_int8_pool


def kernel_pools(params: dict[str, Any]) -> bool:
    """Whether the float pooling kernel computes ``params``: gated attention
    only (``"b"`` in ``params["attn"]``). Every caller routes by it: un-gated
    params pool through the plain version on the tensors' own device, as the
    JAX package's ``fused_trunk_attention_pool`` and ``bag_sharded_pool``
    take their XLA path for them."""
    return "b" in params["attn"]


def _trunk_scores(params: dict[str, Any], x: torch.Tensor, compute_dtype: torch.dtype = torch.float32, drop=None):
    """Trunk MLP then gated attention scores, the plain version.

    x: [B, N, D] -> (h [B, N, H] in ``compute_dtype``, scores [B, N, T] f32).
    Casts where the JAX version does: weights, biases and activations in the
    compute dtype, the score head accumulated in f32. Differentiable: the
    training forward runs it under autograd.

    ``drop(site, value)`` is an optional hook applied at the reference's four
    dropout positions (after each trunk ReLU, after tanh, after sigmoid), so
    that this one definition serves the eval path (``drop=None``) and the
    training path.
    """
    dt = compute_dtype
    d = drop if drop is not None else (lambda site, v: v)

    def lin(p):
        return p["w"].to(dt), p["b"].to(dt)

    w1, b1 = lin(params["trunk"]["fc1"])
    w2, b2 = lin(params["trunk"]["fc2"])
    wa, ba = lin(params["attn"]["a"])
    wc, bc = params["attn"]["c"]["w"].to(dt), params["attn"]["c"]["b"]

    x = x.to(dt)
    h = d(0, torch.relu(x @ w1 + b1))
    h = d(1, torch.relu(h @ w2 + b2))
    a = d(2, torch.tanh(h @ wa + ba))
    if "b" in params["attn"]:
        wb, bb = lin(params["attn"]["b"])
        a = a * d(3, torch.sigmoid(h @ wb + bb))
    # products of compute-dtype values are exact in f32: this is the JAX
    # einsum with preferred_element_type=float32
    scores = a.float() @ wc.float() + bc.to(dt).float()
    return h, scores


def plain_pool(
    params: dict[str, Any], x: torch.Tensor, mask: torch.Tensor, compute_dtype: torch.dtype, with_scores: bool
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The plain version of the pool: (M [B, T, H] f32, raw scores [B, T, N]
    f32 or None). It runs on the CPU and is what the kernel is held against."""
    h, scores = _trunk_scores(params, x, compute_dtype)
    m, _ = masked_attention_pool(scores, h, mask)
    return m, (scores.transpose(1, 2) if with_scores else None)


def fused_trunk_attention_pool(
    params: dict[str, Any],
    x: torch.Tensor,  # [B, N, D]
    mask: torch.Tensor,  # [B, N]
    *,
    compute_dtype: torch.dtype = torch.float32,
    with_scores: bool = False,
    operands=None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Returns (M [B, T, H] pooled f32, raw task-major scores [B, T, N] f32,
    or None unless ``with_scores``). The caller masks the scores (A_raw) or
    softmaxes them. Without scores, the kernel writes none and skips row
    tiles of pure padding.

    On CUDA, ``operands`` are the kernel's packed weights
    (:func:`.cuda_pool.pack_params`), packed once by the caller; without
    them the call packs ``params`` itself. Un-gated params take the plain
    version on CUDA too (:func:`kernel_pools`)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no pooling path for device {x.device} (cuda or cpu)")
    if x.device.type == "cuda" and kernel_pools(params):
        if operands is None:
            operands = cuda_pool.pack_params(params, compute_dtype)
        return cuda_pool.pool(operands, x, mask, with_scores=with_scores)
    return plain_pool(params, x, mask, compute_dtype, with_scores)


def plain_pool_partial(
    params: dict[str, Any], x: torch.Tensor, mask: torch.Tensor, compute_dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the pool's partial mode on one shard of the patch
    dimension, the counterpart of ``toad_tpu.ops.pallas_pool.xla_pool_partial``
    without its padding of the task axis: (acc [B, T, H] f32 = sum over the
    live rows of exp(s - max) h, stats [B, 2, T] f32 with ``stats[:, 0]`` =
    max, NEG_INF where no row is live, and ``stats[:, 1]`` = denom)."""
    h, scores = _trunk_scores(params, x, compute_dtype)
    return partial_stats(h, scores, mask)


def partial_stats(h: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(acc [B, T, H], stats [B, 2, T]) of :func:`plain_pool_partial` from one
    shard's embeddings h [B, N, H] and raw scores [B, N, T]; differentiable
    (the training forward under a mesh runs it under autograd)."""
    live = mask[:, :, None] > 0
    s = torch.where(live, scores, NEG_INF)  # [B, N, T]
    mx = s.amax(dim=1)  # [B, T]
    safe = torch.where(mx <= NEG_INF / 2, 0.0, mx)
    e = torch.exp(s - safe[:, None, :]) * live
    acc = torch.bmm(e.transpose(1, 2), h.float())  # [B, T, H]
    return acc, torch.stack([mx, e.sum(dim=1)], dim=1)


def partial_from_pooled(m: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(acc, stats) of one shard, as :func:`plain_pool_partial` gives them,
    from a pooling pass in scored mode: its M [B, T, H] and raw scores
    [B, T, N]. The denominator is recomputed from the scores and acc = M *
    denom: the same statistics to rounding, for a kernel that has no partial
    mode of its own (the int8 pool) or a pass that must return the scores."""
    live = mask[:, None, :] > 0
    s = torch.where(live, scores, NEG_INF)  # [B, T, N]
    mx = s.amax(dim=2)  # [B, T]
    safe = torch.where(mx <= NEG_INF / 2, 0.0, mx)
    denom = (torch.exp(s - safe[:, :, None]) * live).sum(dim=2)
    # a shard without live rows weighs 0 in the combine, whatever its M
    acc = torch.where(denom[:, :, None] > 0, m * denom[:, :, None], 0.0)
    return acc, torch.stack([mx, denom], dim=1)


def fused_pool_partial(
    params: dict[str, Any],
    x: torch.Tensor,  # [B, N_local, D], one shard of the patch dimension
    mask: torch.Tensor,  # [B, N_local]
    *,
    compute_dtype: torch.dtype = torch.float32,
    operands=None,
    out: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shard-local pooling statistics (acc [B, T, H], stats [B, 2, T]), see
    :func:`plain_pool_partial`; a CUDA tensor goes to the kernel's partial
    mode (:func:`.cuda_pool.pool_partial`, which can write into ``out``), a
    CPU tensor, or un-gated params (:func:`kernel_pools`), to the plain
    version. ``operands`` given, ``params`` may be None: packed operands are
    gated. :func:`toad_tpu_torch.parallel.bag_shard.combine_partial_pool`
    makes the pooled result of the shards' statistics."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no pooling path for device {x.device} (cuda or cpu)")
    if x.device.type == "cuda" and (operands is not None or kernel_pools(params)):
        if operands is None:
            operands = cuda_pool.pack_params(params, compute_dtype)
        return cuda_pool.pool_partial(operands, x, mask, out=out)
    acc, stats = plain_pool_partial(params, x, mask, compute_dtype)
    if out is not None:
        out[0].copy_(acc)
        out[1].copy_(stats)
        return out
    return acc, stats


def fused_int8_pool(
    qparams: dict[str, torch.Tensor],
    xq: torch.Tensor,  # [B, N, D] int8
    sx: torch.Tensor,  # [B, N] f32 per-row scales
    mask: torch.Tensor,  # [B, N]
    *,
    with_scores: bool = False,
    operands: cuda_pool_int8.Int8PoolOperands | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The int8 pool over pre-quantized rows (``qparams`` from
    :func:`.quantize.quantize_pool_params`), with the contract of
    :func:`fused_trunk_attention_pool`. On CUDA, ``operands`` are the
    kernel's packed weights (:func:`.cuda_pool_int8.pack_qparams`), packed
    once by the caller; without them the call packs ``qparams`` itself."""
    if xq.device.type == "cuda":
        if operands is None:
            operands = cuda_pool_int8.pack_qparams(qparams)
        return cuda_pool_int8.pool_int8(operands, xq, sx, mask, with_scores=with_scores)
    if xq.device.type != "cpu":
        raise ValueError(f"no int8 pooling path for device {xq.device} (cuda or cpu)")
    return plain_int8_pool(qparams, xq, sx, mask, with_scores)
