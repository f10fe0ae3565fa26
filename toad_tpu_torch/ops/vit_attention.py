"""Fused multi-head self-attention for the ViT encoder.

PyTorch counterpart of :mod:`toad_tpu.ops.vit_attention`. Per image and head:

    s = q @ k^T * head_dim^-1/2        # f32
    p = softmax(s)                     # f32, then cast to qkv's dtype
    o = p @ v                          # accumulated in f32, cast once

Layout contract: ``qkv`` is the raw ``[B, N, 3*D]`` projection output (bias
added), columns ``[q_h0..q_h{H-1} | k_h0.. | v_h0..]`` with each head a
contiguous ``head_dim`` slice, exactly what the encoder's block produces, so
no transpose or reshape feeds the kernel; the context comes back ``[B, N, D]``
with the heads concatenated.

A CUDA tensor goes to the hand-written kernel (:mod:`.cuda_mha`), which never
writes the ``[B, H, N, N]`` scores to device memory; a CPU tensor goes to the
plain version below. Nothing else chooses between them. Forward only: the
encoder is frozen in the TOAD pipeline.

:func:`fused_mha_new` is the same function with the softmax of the ViT
probe's variant (``experiments/vit_softmax_probe.py::_mha_kernel_new``, P7):
scale * log2(e) folded into q, a bare exp2, the normalisation deferred past
p @ v onto the [N, Dh] context. Its kernel is a second instance of the same
CUDA source; nothing in the encoder calls it.
"""

from __future__ import annotations

import torch

from toad_tpu_torch.ops import cuda_mha


def plain_mha(qkv: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """The plain version, with the kernel's rounding points (those of the JAX
    ``mha_reference``): scores and softmax in f32, ``p`` cast to qkv's dtype,
    the context accumulated in f32 and cast once. It runs on the CPU and is
    what the kernel is held against."""
    b, n, _ = qkv.shape
    q, k, v = qkv.reshape(b, n, 3, heads, head_dim).unbind(2)  # [B, N, H, Dh] each
    # products of bf16 values are exact in f32: an f32 matmul of the widened
    # operands is the JAX einsum with preferred_element_type=float32
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    p = torch.softmax(s * float(head_dim) ** -0.5, dim=-1).to(qkv.dtype)
    o = torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float())
    return o.reshape(b, n, heads * head_dim).to(qkv.dtype)


def plain_mha_new(qkv: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """The plain version of P7, at ``_mha_kernel_new``'s rounding points:
    ``qs = q * c`` in f32 rounded to qkv's dtype, ``s = qs k^T`` in f32,
    ``p = exp2(s - rowmax)`` kept in f32, ``denom`` the sum of that f32 ``p``,
    ``o = p.to(dtype) @ v`` accumulated in f32, then ``o / denom`` (a true
    division) rounded to the dtype once."""
    b, n, _ = qkv.shape
    q, k, v = qkv.reshape(b, n, 3, heads, head_dim).unbind(2)  # [B, N, H, Dh] each
    qs = (q.float() * cuda_mha.new_softmax_factor(head_dim)).to(qkv.dtype)
    s = torch.einsum("bnhd,bmhd->bhnm", qs.float(), k.float())
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)  # [B, H, N, 1]
    o = torch.einsum("bhnm,bmhd->bhnd", p.to(qkv.dtype).float(), v.float())
    return (o / denom).permute(0, 2, 1, 3).reshape(b, n, heads * head_dim).to(qkv.dtype)


def _check_width(qkv: torch.Tensor, heads: int, head_dim: int) -> None:
    three_d = qkv.shape[-1]
    if three_d != 3 * heads * head_dim:
        raise ValueError(f"qkv last dim {three_d} != 3*heads*head_dim {3 * heads * head_dim}")


def fused_mha(qkv: torch.Tensor, heads: int, head_dim: int, variant: str = "k3") -> torch.Tensor:
    """``[B, N, 3*H*Dh]`` qkv (head-major column layout, see module doc) ->
    ``[B, N, H*Dh]`` attention context, softmax statistics in f32.
    ``variant``: "k3" (the encoder's) or "new" (P7: the folded exp2 and the
    deferred normalisation, see :func:`plain_mha_new`). A CUDA tensor goes to
    the kernel, a CPU tensor to the variant's plain version."""
    if variant not in _PLAIN:
        raise ValueError(f"unknown attention variant {variant!r} (k3 or new)")
    _check_width(qkv, heads, head_dim)
    if qkv.device.type == "cuda":
        return cuda_mha.mha(qkv, heads, head_dim, variant=variant)
    if qkv.device.type != "cpu":
        raise ValueError(f"no attention path for device {qkv.device} (cuda or cpu)")
    return _PLAIN[variant](qkv, heads, head_dim)


def fused_mha_new(qkv: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """P7: ``fused_mha(..., variant="new")``."""
    return fused_mha(qkv, heads, head_dim, variant="new")


_PLAIN = {"k3": plain_mha, "new": plain_mha_new}
