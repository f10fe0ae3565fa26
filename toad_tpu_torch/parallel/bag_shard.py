"""Bag-sharded attention pooling: one long bag pooled in pieces.

PyTorch counterpart of :mod:`toad_tpu.parallel.bag_shard`. A bag's patch
dimension is cut into shards; each shard yields shard-local flash statistics
(the unnormalised weighted sum, the running max and the denominator) from
the pooling kernel's partial mode, and one small combine makes the exact
pooled result of them. Exact because TOAD pooling is a softmax-weighted mean
(a single softmax), not pairwise attention; what crosses shards is
O(B * T * H), independent of N.

On one card the shards run one after another on the current stream. Across
cards the same partials are what each card would compute for its shard and
exchange (an all-gather or all-reduce of ``[B, T, H]`` + ``[B, 2, T]`` over
NCCL); that transport is not ported yet (ROADMAP.md, multi-GPU).
"""

from __future__ import annotations

from typing import Any

import torch

from toad_tpu_torch.ops import cuda_pool
from toad_tpu_torch.ops.fused_pool import fused_pool_partial
from toad_tpu_torch.ops.pooling import NEG_INF


def plain_combine_partial_pool(acc: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """The plain version of the combine (the ``pmax`` / ``psum`` of the JAX
    version as reductions over the leading shard axis)."""
    mx, denom = stats[:, :, 0, :], stats[:, :, 1, :]  # [S, B, T]
    gmax = mx.amax(dim=0, keepdim=True)
    # fully masked shards contribute nothing (scale 0), and exp stays finite
    scale = torch.where(mx <= NEG_INF / 2, 0.0, torch.exp(mx - torch.where(gmax <= NEG_INF / 2, 0.0, gmax)))
    acc = (acc * scale[..., None]).sum(dim=0)
    denom = (denom * scale).sum(dim=0)
    return acc / denom.clamp_min(1e-12)[..., None]


def combine_partial_pool(acc: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """Flash-combine shard-local (acc [S, B, T, H], stats [S, B, 2, T]) into
    the exact pooled M [B, T, H]. CUDA tensors go to the hand-written combine
    kernel, CPU tensors to the plain version; nothing else chooses."""
    if acc.device.type == "cuda":
        return cuda_pool.combine_shards(acc, stats)
    if acc.device.type != "cpu":
        raise ValueError(f"no combine path for device {acc.device} (cuda or cpu)")
    return plain_combine_partial_pool(acc, stats)


def bag_sharded_pool(
    params: dict[str, Any] | cuda_pool.PoolOperands,
    x: torch.Tensor,  # [B, N, D]
    mask: torch.Tensor,  # [B, N]
    n_shards: int,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Pooled M [B, T, H] f32 with the patch dimension cut into ``n_shards``
    equal contiguous slices (N must divide), each pooled in partial mode, one
    after another on the current stream, then combined.

    ``params`` is the JAX params layout (packed for the kernel here, per
    call) or, on CUDA, operands already packed by
    :func:`toad_tpu_torch.ops.cuda_pool.pack_params`. Un-gated params raise
    ``NotImplementedError`` on CUDA, as every launch of the kernel does."""
    b_, n = x.shape[0], x.shape[1]
    if n_shards < 1 or n % n_shards:
        raise ValueError(f"the patch dimension {n} must divide into {n_shards} shards")
    operands = None
    if isinstance(params, cuda_pool.PoolOperands):
        if x.device.type != "cuda":
            raise ValueError("packed kernel operands need CUDA tensors; pass the params dict on the CPU")
        operands, params = params, None
        t_dim, h_dim = operands.wc.shape[1], operands.w1.shape[0]
    else:
        if x.device.type == "cuda":
            operands = cuda_pool.pack_params(params, compute_dtype)
        t_dim, h_dim = params["attn"]["c"]["w"].shape[1], params["trunk"]["fc2"]["w"].shape[1]
    acc = torch.empty((n_shards, b_, t_dim, h_dim), device=x.device, dtype=torch.float32)
    stats = torch.empty((n_shards, b_, 2, t_dim), device=x.device, dtype=torch.float32)
    per = n // n_shards
    for s in range(n_shards):
        sl = slice(s * per, (s + 1) * per)
        fused_pool_partial(params, x[:, sl], mask[:, sl], compute_dtype=compute_dtype, operands=operands,
                           out=(acc[s], stats[s]))
    return combine_partial_pool(acc, stats)
