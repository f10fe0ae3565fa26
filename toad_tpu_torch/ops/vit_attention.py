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


def fused_mha(qkv: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """``[B, N, 3*H*Dh]`` qkv (head-major column layout, see module doc) ->
    ``[B, N, H*Dh]`` attention context, softmax statistics in f32."""
    three_d = qkv.shape[-1]
    d = heads * head_dim
    if three_d != 3 * d:
        raise ValueError(f"qkv last dim {three_d} != 3*heads*head_dim {3 * d}")
    if qkv.device.type == "cuda":
        return cuda_mha.mha(qkv, heads, head_dim)
    if qkv.device.type != "cpu":
        raise ValueError(f"no attention path for device {qkv.device} (cuda or cpu)")
    return plain_mha(qkv, heads, head_dim)
