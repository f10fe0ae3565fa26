"""Bag-sharded attention pooling: one long bag pooled in pieces.

PyTorch counterpart of :mod:`toad_tpu.parallel.bag_shard`. A bag's patch
dimension is cut into shards; each shard yields shard-local flash statistics
(the unnormalised weighted sum, the running max and the denominator) from
the pooling kernel's partial mode, and one small combine makes the exact
pooled result of them. Exact because TOAD pooling is a softmax-weighted mean
(a single softmax), not pairwise attention; what crosses shards is
O(B * T * H), independent of N.

With ``n_shards`` on a card the kernel pools every shard of every bag in
one launch and merges the partials at its end
(:func:`~toad_tpu_torch.ops.cuda_pool.pool_sharded`); on the CPU the shards
run one after another through the plain version. With a mesh (:mod:`.mesh`)
each shard runs on the device of its column of the grid, with that device's
copy of the weights, reading its slice of the batch in place, and its
partials (``[B, T, H]`` + ``[B, 2, T]``, a few KB a bag) go straight into
their slot of one buffer on the mesh's first device, where one combine
makes the result: what the JAX package's ``psum`` over the bag axis does,
as explicit copies from one controller.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from toad_tpu_torch.ops import cuda_pool
from toad_tpu_torch.ops.fused_pool import fused_pool_partial, kernel_pools
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


def combine_partial_pool(
    acc: torch.Tensor | Sequence[torch.Tensor],
    stats: torch.Tensor | Sequence[torch.Tensor],
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Flash-combine shard-local (acc [S, B, T, H], stats [S, B, 2, T]) into
    the exact pooled M [B, T, H]. ``acc`` and ``stats`` may also be
    sequences of the S shards' [B, T, H] and [B, 2, T] partials, each on its
    own device: they are copied to ``device`` (the first shard's device when
    None, a mesh's primary device for a mesh) and stacked there first. CUDA
    tensors go to the hand-written combine kernel, CPU tensors to the plain
    version; nothing else chooses."""
    if not isinstance(acc, torch.Tensor):
        device = torch.device(device) if device is not None else acc[0].device
        acc = torch.stack([a.to(device, non_blocking=True) for a in acc])
        stats = torch.stack([t.to(device, non_blocking=True) for t in stats])
    elif device is not None:
        acc, stats = acc.to(device), stats.to(device)
    if acc.device.type == "cuda":
        return cuda_pool.combine_shards(acc, stats)
    if acc.device.type != "cpu":
        raise ValueError(f"no combine path for device {acc.device} (cuda or cpu)")
    return plain_combine_partial_pool(acc, stats)


def _params_on(params: dict[str, Any], dev: torch.device) -> dict[str, Any]:
    """The params pytree with every tensor on ``dev`` (views where it is there already)."""
    if isinstance(params, dict):
        return {k: _params_on(v, dev) for k, v in params.items()}
    return torch.as_tensor(params).to(dev)


def _partial_buffers(params: dict[str, Any], n_shards: int, b_: int, dev: torch.device):
    """Empty (acc [S, B, T, H], stats [S, B, 2, T]) f32 on ``dev``: each
    shard's slot, which its partials are written or copied into."""
    t_dim, h_dim = params["attn"]["c"]["w"].shape[1], params["trunk"]["fc2"]["w"].shape[1]
    return (torch.empty((n_shards, b_, t_dim, h_dim), device=dev, dtype=torch.float32),
            torch.empty((n_shards, b_, 2, t_dim), device=dev, dtype=torch.float32))


def bag_sharded_pool(
    params: dict[str, Any] | cuda_pool.PoolOperands,
    x: torch.Tensor,  # [B, N, D]
    mask: torch.Tensor,  # [B, N]
    n_shards: int | None = None,
    *,
    mesh=None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Pooled M [B, T, H] f32 with the patch dimension cut into equal
    contiguous slices (N must divide), each pooled in partial mode, then
    combined.

    Give ``n_shards`` to pool the shards on ``x``'s device (on a card in
    one launch, :func:`~toad_tpu_torch.ops.cuda_pool.pool_sharded`; on the
    CPU one after another), or a ``mesh`` to cut N over its ``bag`` axis:
    shard j runs on the device of the first row's column j (the data axis is
    not used: every row would compute the same bag), one partial-mode launch
    reading its slice in place, and the combine runs on ``mesh.primary``,
    which the result is on.

    ``params`` is the JAX params layout (packed for the kernel here, per
    call and device) or, with ``n_shards`` on CUDA, operands already packed
    by :func:`toad_tpu_torch.ops.cuda_pool.pack_params`. Un-gated params
    pool each shard through the plain version on its own device, the card
    included (:func:`~toad_tpu_torch.ops.fused_pool.kernel_pools`), as the
    JAX version takes its XLA path for them."""
    if (n_shards is None) == (mesh is None):
        raise ValueError("give exactly one of n_shards (one device) or mesh (the mesh's bag axis)")
    b_, n = x.shape[0], x.shape[1]
    if mesh is not None:
        if isinstance(params, cuda_pool.PoolOperands):
            raise ValueError("a mesh pools with each device's own operands: pass the params dict")
        devices = mesh.grid[0]
        if n % len(devices):
            raise ValueError(f"the patch dimension {n} must divide into the mesh's {len(devices)} bag shards")
        per = n // len(devices)
        on_dev: dict[torch.device, dict[str, Any]] = {}
        acc, stats = _partial_buffers(params, len(devices), b_, mesh.primary)
        for s, dev in enumerate(devices):
            if dev not in on_dev:
                p = _params_on(params, dev)
                on_dev[dev] = (p, cuda_pool.pack_params(p, compute_dtype) if dev.type == "cuda" and kernel_pools(p)
                               else None)
            p, operands = on_dev[dev]
            sl = slice(s * per, (s + 1) * per)
            home = dev == mesh.primary  # the partials land in their slot directly, else are copied there
            a, t = fused_pool_partial(p, x[:, sl].to(dev), mask[:, sl].to(dev), compute_dtype=compute_dtype,
                                      operands=operands, out=(acc[s], stats[s]) if home else None)
            if not home:
                acc[s].copy_(a, non_blocking=True)
                stats[s].copy_(t, non_blocking=True)
        return combine_partial_pool(acc, stats)
    if n_shards < 1 or n % n_shards:
        raise ValueError(f"the patch dimension {n} must divide into {n_shards} shards")
    operands = None
    if isinstance(params, cuda_pool.PoolOperands):
        if x.device.type != "cuda":
            raise ValueError("packed kernel operands need CUDA tensors; pass the params dict on the CPU")
        operands = params
    elif x.device.type == "cuda" and kernel_pools(params):
        operands = cuda_pool.pack_params(params, compute_dtype)
    if operands is not None:
        return cuda_pool.pool_sharded(operands, x, mask, n_shards)
    acc, stats = _partial_buffers(params, n_shards, b_, x.device)
    per = n // n_shards
    for s in range(n_shards):
        sl = slice(s * per, (s + 1) * per)
        fused_pool_partial(params, x[:, sl], mask[:, sl], compute_dtype=compute_dtype, out=(acc[s], stats[s]))
    return combine_partial_pool(acc, stats)
