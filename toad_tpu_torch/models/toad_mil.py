"""ToadMIL: attention MIL with two task heads, batched and masked.

PyTorch counterpart of :mod:`toad_tpu.models.toad_mil` (the reference's
``TOAD_fc_mtl_concat``, size 'big'):

  trunk   : in_dim -> 512 relu -> 512 relu
  attn    : gated tanh(W_a h) * sigmoid(W_b h) -> W_c -> [N, 2] scores
  pooling : per-task masked softmax over N, weighted mean -> [2, 512]
  concat  : patient sex appended -> [2, 513]
  heads   : task 0 -> n_classes logits, task 1 -> site logits

Submodules follow the JAX params pytree (``trunk.fc1``, ``attn.a``,
``cls_head``...), so the state_dict keys name their JAX counterparts; each
``nn.Linear`` keeps PyTorch's [out, in] weight layout. Init is the
reference's Xavier-normal weights and zero biases, drawn from an explicit
generator.

Three forwards, as in the JAX package: the eval forward (the hand-written
pooling kernel on CUDA, the plain version on the CPU and, for an un-gated
model, on CUDA too, as the JAX package takes its XLA path; int8 through
:meth:`ToadMIL.forward_int8`), and with ``train=True`` the training forward,
which is plain tensor code under autograd (the JAX package trains through
its XLA path too: no pooling kernel has a backward), with the reference's
four dropout sites when ``config.dropout``. The kernel path is forward-only
and raises when called with gradients enabled.

:meth:`ToadMIL.forward_sharded` runs either forward over a batch placed on a
``('data', 'bag')`` mesh (:func:`toad_tpu_torch.parallel.sharding.shard_batch`):
each grid cell pools its slice on its own device, the cells' results come to
the mesh's first device, and the heads run there once over the whole batch.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from toad_tpu_torch.config import ModelConfig
from toad_tpu_torch.ops import cuda_pool, cuda_pool_int8
from toad_tpu_torch.ops.fused_pool import (
    _trunk_scores,
    fused_int8_pool,
    fused_pool_partial,
    fused_trunk_attention_pool,
    kernel_pools,
    partial_from_pooled,
    partial_stats,
)
from toad_tpu_torch.ops.pooling import masked_attention_pool
from toad_tpu_torch.ops.quantize import quantize_pool_params, quantize_rows

N_TASKS = 2


class ToadOutputs(NamedTuple):
    """Batched analog of the reference results dict."""

    logits: torch.Tensor  # [B, n_classes]
    y_prob: torch.Tensor  # [B, n_classes]
    y_hat: torch.Tensor  # [B]
    site_logits: torch.Tensor  # [B, 2]
    site_prob: torch.Tensor  # [B, 2]
    site_hat: torch.Tensor  # [B]
    attention: torch.Tensor | None  # [B, T, N] raw (pre-softmax) scores, -inf at padding
    features: torch.Tensor  # [B, T, H+1] pooled + sex slide representation


def _linear(d_in: int, d_out: int, dtype: torch.dtype) -> nn.Linear:
    # built on the meta device so that nn.Linear's own init draws nothing
    # from the global generator; reset_parameters fills it
    return nn.Linear(d_in, d_out, dtype=dtype, device="meta").to_empty(device="cpu")


class ToadMIL(nn.Module):
    """The MIL model. Built on the CPU; move it with ``.to(device)``."""

    def __init__(self, config: ModelConfig, generator: torch.Generator | None = None):
        super().__init__()
        c = config
        self.config = c
        dt = getattr(torch, c.param_dtype)
        self.trunk = nn.ModuleDict({
            "fc1": _linear(c.in_dim, c.hidden_dim, dt),
            "fc2": _linear(c.hidden_dim, c.hidden_dim, dt),
        })
        attn = {"a": _linear(c.hidden_dim, c.attn_dim, dt)}
        if c.gate:
            attn["b"] = _linear(c.hidden_dim, c.attn_dim, dt)
        attn["c"] = _linear(c.attn_dim, N_TASKS, dt)
        self.attn = nn.ModuleDict(attn)
        self.cls_head = _linear(c.hidden_dim + 1, c.n_classes, dt)
        self.site_head = _linear(c.hidden_dim + 1, c.n_site_classes, dt)
        self._packed: dict[torch.dtype, tuple] = {}  # compute dtype -> (weights' key, kernel operands)
        self._int8: tuple | None = None  # (weights' key, int8 params, int8 kernel operands or None)
        self._replicas: dict[torch.device, tuple] = {}  # device -> (weights' key, eval copy there), under a mesh
        self.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier-normal weights, zero biases (reference ``initialize_weights``)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                fan_out, fan_in = m.weight.shape
                std = (2.0 / (fan_in + fan_out)) ** 0.5
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
                m.bias.zero_()

    def pool_params(self) -> dict[str, Any]:
        """The trunk and attention weights in the JAX params layout ([in, out]
        views of the Linear weights), as the plain pool takes them."""

        def lin(m: nn.Linear) -> dict[str, torch.Tensor]:
            return {"w": m.weight.t(), "b": m.bias}

        return {
            "trunk": {k: lin(m) for k, m in self.trunk.items()},
            "attn": {k: lin(m) for k, m in self.attn.items()},
        }

    def _pool_weights_key(self) -> tuple:
        """Identifies the pooling weights' current values: a weight that moves
        or changes in place changes the key."""
        lins = {**self.trunk, **self.attn}
        if torch.is_grad_enabled() and any(m.weight.requires_grad or m.bias.requires_grad for m in lins.values()):
            raise RuntimeError("the pooling kernel is forward-only: call it under torch.no_grad() or inference_mode()")
        return tuple((p.device, p.data_ptr(), p._version) for m in lins.values() for p in (m.weight, m.bias))

    def kernel_operands(self, compute_dtype: torch.dtype) -> cuda_pool.PoolOperands:
        """The pooling kernel's packed weights, packed once per compute dtype
        and re-packed only when a weight moves or changes in place."""
        lins = {**self.trunk, **self.attn}
        key = self._pool_weights_key()
        hit = self._packed.get(compute_dtype)
        if hit is None or hit[0] != key:
            hit = (key, cuda_pool.pack_linears({k: (m.weight, m.bias) for k, m in lins.items()}, compute_dtype))
            self._packed[compute_dtype] = hit
        return hit[1]

    def _operands_on(self, device: torch.device, compute_dtype: torch.dtype) -> cuda_pool.PoolOperands | None:
        """The pooling kernel's operands where a pool on ``device`` launches
        it (a CUDA device and gated weights:
        :func:`~toad_tpu_torch.ops.fused_pool.kernel_pools`), else None: the
        plain version pools there, un-gated on the card too."""
        if device.type == "cuda" and kernel_pools(self.pool_params()):
            return self.kernel_operands(compute_dtype)
        return None

    def int8_operands(self) -> tuple[dict[str, torch.Tensor], cuda_pool_int8.Int8PoolOperands | None]:
        """(int8 pooling params, the int8 kernel's packed operands or None off
        CUDA), quantized and packed once and again only when a weight moves
        or changes in place."""
        key = self._pool_weights_key()
        if self._int8 is None or self._int8[0] != key:
            qparams = quantize_pool_params(self.pool_params())
            packed = cuda_pool_int8.pack_qparams(qparams) if self.trunk.fc1.weight.device.type == "cuda" else None
            self._int8 = (key, qparams, packed)
        return self._int8[1], self._int8[2]

    def forward(
        self,
        x: torch.Tensor,  # [B, N, D]
        mask: torch.Tensor,  # [B, N]
        sex: torch.Tensor,  # [B] (0/1)
        *,
        train: bool = False,
        generator: torch.Generator | None = None,
        need_attention: bool = True,
        attention_only: bool = False,
    ):
        """``train=True`` is the differentiable forward: parameters stay f32
        and are cast to the compute dtype inside, under autograd; with
        ``config.dropout`` the masks of the four dropout sites are drawn from
        ``generator``, which must live on ``x``'s device. Otherwise the eval
        forward: the kernel on CUDA (forward-only), the plain version on the
        CPU, and on CUDA for an un-gated model."""
        compute_dtype = getattr(torch, self.config.compute_dtype)
        need_attention = need_attention or attention_only
        if train:
            m, scores = self._forward_train(x, mask, compute_dtype, generator)
            return self._finish(m, scores.transpose(1, 2) if need_attention else None, mask, sex, attention_only)
        # classification only: the kernel writes no [B, T, N] scores
        m, scores = fused_trunk_attention_pool(
            self.pool_params(), x, mask, compute_dtype=compute_dtype, with_scores=need_attention,
            operands=self._operands_on(x.device, compute_dtype),
        )
        return self._finish(m, scores, mask, sex, attention_only)

    def _forward_train(self, x, mask, compute_dtype: torch.dtype, generator: torch.Generator | None):
        """Trunk, scores and pooling as plain tensor code; dropout p =
        ``config.dropout_rate`` after each trunk ReLU, after tanh and after
        sigmoid when ``config.dropout``. ``F.dropout`` takes no generator, so
        each mask is drawn with ``torch.rand(..., generator=g) < keep`` and
        the kept values are scaled by 1 / keep."""
        drop = None
        if self.config.dropout:
            if generator is None:
                raise ValueError("dropout requires a generator in train mode")
            keep = 1.0 - self.config.dropout_rate

            def drop(site, v):
                kept = torch.rand(v.shape, device=v.device, generator=generator) < keep
                return torch.where(kept, v / keep, torch.zeros((), dtype=v.dtype, device=v.device))

        h, scores = _trunk_scores(self.pool_params(), x, compute_dtype, drop=drop)
        m, _ = masked_attention_pool(scores, h, mask)
        return m, scores

    def forward_int8(
        self,
        xq: torch.Tensor,  # [B, N, D] int8 (pre-quantized rows, ops/quantize.py)
        sx: torch.Tensor,  # [B, N] f32 per-row scales
        mask: torch.Tensor,  # [B, N]
        sex: torch.Tensor,  # [B] (0/1)
        *,
        need_attention: bool = True,
        attention_only: bool = False,
    ):
        """Quantized-inference forward, the counterpart of the JAX
        ``ToadMIL.apply_int8``: the trunk and gate GEMMs run int8 (weights
        quantized per column once, :meth:`int8_operands`); the heads and
        softmax stay f32, so the outputs have :meth:`forward`'s contract."""
        need_attention = need_attention or attention_only
        qparams, operands = self.int8_operands()
        m, scores = fused_int8_pool(qparams, xq, sx, mask, with_scores=need_attention, operands=operands)
        return self._finish(m, scores, mask, sex, attention_only)

    def _replica(self, dev: torch.device) -> "ToadMIL":
        """This model's eval-mode copy on ``dev`` (itself where it lives),
        made again only when a pooling weight moves or changes in place."""
        if dev == self.trunk.fc1.weight.device:
            return self
        key = self._pool_weights_key()
        hit = self._replicas.get(dev)
        if hit is None or hit[0] != key:
            from toad_tpu_torch.parallel.sharding import copy_to

            hit = (key, copy_to(self, dev))
            self._replicas[dev] = hit
        return hit[1]

    def forward_sharded(
        self,
        batch,  # toad_tpu_torch.parallel.sharding.ShardedBatch
        *,
        train: bool = False,
        generator: torch.Generator | None = None,
        need_attention: bool = True,
        attention_only: bool = False,
        int8: bool = False,
    ):
        """:meth:`forward` (or, with ``int8``, :meth:`forward_int8`) over a
        batch placed on a mesh; the outputs are on the mesh's first device,
        where this model must live.

        Eval: with a bag axis of 1 each data shard runs the pooling kernel
        (classification or scored mode) on its device with that device's
        copy of the weights, and the pooled M comes to the first device.
        With a bag axis above 1 each cell runs the kernel's partial mode K1p
        (the scored kernel, or the int8 kernel, then the statistics from its
        scores: :func:`~toad_tpu_torch.ops.fused_pool.partial_from_pooled`),
        and one combine kernel on the first device makes M.

        Train: the plain differentiable forward, each cell on its device from
        copies of the parameters that autograd carries the gradients back
        across, so that they sum into the one set of parameters; under a bag
        axis the plain partial statistics and the plain combine. The four
        dropout masks are drawn from ``generator`` at the whole batch's
        shapes, in the order of the unsharded forward, and each cell takes
        its slice: a mesh step draws what the unsharded step draws."""
        mesh = batch.mesh
        if self.trunk.fc1.weight.device != mesh.primary:
            raise ValueError(f"the model must live on the mesh's first device {mesh.primary}")
        need_attention = need_attention or attention_only
        compute_dtype = getattr(torch, self.config.compute_dtype)
        if train:
            m, scores = self._sharded_train(batch, compute_dtype, generator)
            scores = scores.transpose(1, 2) if need_attention else None
        else:
            m, scores = self._sharded_eval(batch, compute_dtype, need_attention, int8)
        return self._finish(m, scores, batch["patch_mask"], batch["sex"], attention_only)

    def _sharded_eval(self, batch, compute_dtype: torch.dtype, need_attention: bool, int8: bool):
        """(M [B, T, H], scores [B, T, N] or None) on the first device. Each
        cell's results go straight into its rows (under a bag axis, of its
        shard's slot) of buffers on the first device: a cell there writes
        them itself, another device's are copied in; under a bag axis one
        combine then makes M."""
        mesh = batch.mesh
        primary, bag_n = mesh.primary, mesh.shape["bag"]
        per_b, per_n = batch.cells[0][0]["features"].shape[:2]
        b_, h_dim = per_b * len(batch.cells), self.config.hidden_dim
        f32 = dict(device=primary, dtype=torch.float32)
        if bag_n > 1:
            acc = torch.empty((bag_n, b_, N_TASKS, h_dim), **f32)
            stats = torch.empty((bag_n, b_, 2, N_TASKS), **f32)
        else:
            m = torch.empty((b_, N_TASKS, h_dim), **f32)
        scores = torch.empty((b_, N_TASKS, per_n * bag_n), **f32) if need_attention else None
        for d, row in enumerate(batch.cells):
            rows = slice(d * per_b, (d + 1) * per_b)
            for j, cell in enumerate(row):
                dev = mesh.grid[d][j]
                slot = (acc[j, rows], stats[j, rows]) if bag_n > 1 else (m[rows],)
                outs = self._replica(dev)._cell_pool(cell, compute_dtype, bag_n > 1, need_attention, int8,
                                                     out=slot if dev == primary and bag_n > 1 else None)
                for dst, src in zip(slot, outs):
                    if src is not dst:
                        dst.copy_(src, non_blocking=True)
                if need_attention:
                    scores[rows, :, j * per_n:(j + 1) * per_n].copy_(outs[2], non_blocking=True)
        if bag_n > 1:
            from toad_tpu_torch.parallel.bag_shard import combine_partial_pool

            m = combine_partial_pool(acc, stats)  # one combine over the whole batch
        return m, scores

    def _cell_pool(self, cell: dict, compute_dtype: torch.dtype, partial: bool, with_scores: bool, int8: bool,
                   out: tuple[torch.Tensor, torch.Tensor] | None = None):
        """One grid cell's pool on this model's device: (M, None, scores or
        None) or, with ``partial``, (acc, stats, scores or None). Partial
        statistics come from the kernel's partial mode K1p (written into
        ``out`` where given: the cell's slot of the combine's buffers); where
        the scores are wanted too, or from the int8 kernel (which has no
        partial mode), from a scored pass."""
        x, mask = cell["features"], cell["patch_mask"]
        if int8:
            xq, sx = (x, cell["scales"]) if "scales" in cell else quantize_rows(x)
            qparams, operands = self.int8_operands()
            m, s = fused_int8_pool(qparams, xq, sx, mask, with_scores=with_scores or partial, operands=operands)
        else:
            operands = self._operands_on(x.device, compute_dtype)
            if partial and not with_scores:
                acc, stats = fused_pool_partial(self.pool_params(), x, mask, compute_dtype=compute_dtype,
                                                operands=operands, out=out)
                return acc, stats, None
            m, s = fused_trunk_attention_pool(self.pool_params(), x, mask, compute_dtype=compute_dtype,
                                              with_scores=with_scores or partial, operands=operands)
        if partial:
            acc, stats = partial_from_pooled(m, s, mask)
            return acc, stats, s if with_scores else None
        return m, None, s

    def _sharded_train(self, batch, compute_dtype: torch.dtype, generator: torch.Generator | None):
        """(M [B, T, H], scores [B, N, T]) on the first device, differentiable."""
        from toad_tpu_torch.parallel.bag_shard import plain_combine_partial_pool

        mesh = batch.mesh
        primary, bag_n = mesh.primary, mesh.shape["bag"]
        b_, n = batch["patch_mask"].shape
        per_b, per_n = b_ // mesh.shape["data"], n // bag_n
        masks = None
        if self.config.dropout:
            if generator is None:
                raise ValueError("dropout requires a generator in train mode")
            keep = 1.0 - self.config.dropout_rate
            c = self.config
            shapes = [(b_, n, c.hidden_dim)] * 2 + [(b_, n, c.attn_dim)] * (2 if c.gate else 1)
            # the unsharded forward draws the four sites' masks in this order, each at its value's shape
            masks = [torch.rand(shape, device=primary, generator=generator) < keep for shape in shapes]
        params = self.pool_params()
        ms, accs, stats, scores = [], [], [], []
        for d, row in enumerate(batch.cells):
            row_acc, row_stats, row_scores = [], [], []
            for j, cell in enumerate(row):
                dev = mesh.grid[d][j]
                p = {g: {k: {"w": v["w"].to(dev), "b": v["b"].to(dev)} for k, v in params[g].items()} for g in params}
                drop = None
                if masks is not None:
                    cut = (slice(d * per_b, (d + 1) * per_b), slice(j * per_n, (j + 1) * per_n))
                    kept = [mk[cut].to(dev, non_blocking=True) for mk in masks]

                    def drop(site, v, kept=kept):
                        return torch.where(kept[site], v / keep, torch.zeros((), dtype=v.dtype, device=v.device))

                h, s = _trunk_scores(p, cell["features"], compute_dtype, drop=drop)
                if bag_n > 1:
                    a, t = partial_stats(h, s, cell["patch_mask"])
                    row_acc.append(a.to(primary))
                    row_stats.append(t.to(primary))
                else:
                    ms.append(masked_attention_pool(s, h, cell["patch_mask"])[0].to(primary))
                row_scores.append(s.to(primary))
            accs.append(row_acc)
            stats.append(row_stats)
            scores.append(torch.cat(row_scores, dim=1))
        if bag_n > 1:
            m = plain_combine_partial_pool(torch.stack([torch.cat([r[j] for r in accs]) for j in range(bag_n)]),
                                           torch.stack([torch.cat([r[j] for r in stats]) for j in range(bag_n)]))
        else:
            m = torch.cat(ms)
        return m, torch.cat(scores)

    def _finish(self, m, scores, mask, sex, attention_only: bool):
        """A_raw masking, sex concat, the two f32 heads, output pack.
        ``scores`` are the raw task-major scores [B, T, N] or None."""
        a_raw = None
        if scores is not None:
            # -inf at padding (reference A_raw)
            a_raw = torch.where(mask[:, None, :] > 0, scores, float("-inf"))
        if attention_only:
            return a_raw[:, 0, :]

        sex_col = sex.to(torch.float32)[:, None, None].expand(m.shape[0], N_TASKS, 1)
        feats = torch.cat([m, sex_col], dim=-1)  # [B, T, H+1]
        logits = feats[:, 0, :] @ self.cls_head.weight.float().t() + self.cls_head.bias.float()
        site_logits = feats[:, 1, :] @ self.site_head.weight.float().t() + self.site_head.bias.float()
        return ToadOutputs(
            logits=logits,
            y_prob=torch.softmax(logits, dim=-1),
            y_hat=logits.argmax(dim=-1),
            site_logits=site_logits,
            site_prob=torch.softmax(site_logits, dim=-1),
            site_hat=site_logits.argmax(dim=-1),
            attention=a_raw,
            features=feats,
        )

