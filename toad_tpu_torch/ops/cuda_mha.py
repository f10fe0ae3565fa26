"""Wrapper of the ViT attention kernel ``csrc/mha.cu``.

The kernel replaces the TPU kernel
``toad_tpu/ops/vit_attention.py::_mha_kernel`` (K3): per image and head,
softmax(q k^T Dh^-1/2) v with f32 scores and softmax, the probabilities
rounded to the input dtype, f32 context accumulation, heads concatenated. On
an H100 it is memory-bound (N/2 FLOP per byte of bf16 qkv and context, ~99 at
197 tokens against the card's ~295), so it reads qkv once, keeps scores and
probabilities on chip and writes the context once. A persistent grid (one
block an SM) takes the place of the TPU kernel's loop over images and heads
inside a sequential grid step: each block walks (image, head) units, stages a
unit's Q, K and V into shared memory once with a producer warp while its
consumer warps compute the unit before (see the notes in ``csrc/mha.cu``).

:func:`mha` launches the kernel on a CUDA tensor and raises on anything the
kernel does not take. The plain version is
:func:`toad_tpu_torch.ops.vit_attention.plain_mha`.

``variant="new"`` launches P7, the second instance of the same source, which
replaces the probe kernel ``experiments/vit_softmax_probe.py::_mha_kernel_new``:
q pre-scaled by scale·log2(e), a bare exp2, the context divided by the f32
row sum at the end (plain version
:func:`toad_tpu_torch.ops.vit_attention.plain_mha_new`). Same shapes, the
same refusals, its own launch count.
"""

from __future__ import annotations

import torch

from toad_tpu_torch.ops import _build

LAUNCHES = 0  # K3 launches in this process (one per call of mha)
NEW_LAUNCHES = 0  # P7 launches in this process (one per call of mha with variant="new")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SOFTMAX_CODE = {"k3": 0, "new": 1}


def new_softmax_factor(head_dim: int) -> float:
    """P7's factor on q, Dh^-1/2 * log2(e), formed in float64 as the probe
    forms it from Python floats; rounded to f32 once where it is used."""
    return float(head_dim) ** -0.5 * 1.4426950408889634


def mha(qkv: torch.Tensor, heads: int, head_dim: int, variant: str = "k3") -> torch.Tensor:
    """Launch the attention kernel: qkv [B, N, 3*H*Dh] (columns
    ``[q_h0..|k_h0..|v_h0..]``) -> context [B, N, H*Dh] in qkv's dtype.
    ``variant``: "k3" (the encoder's) or "new" (P7)."""
    global LAUNCHES, NEW_LAUNCHES
    if variant not in _SOFTMAX_CODE:
        raise ValueError(f"unknown attention kernel variant {variant!r} (k3 or new)")
    if qkv.device.type != "cuda":
        raise ValueError(f"the CUDA attention kernel needs a CUDA tensor, got {qkv.device}")
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {qkv.dtype} not supported by the attention kernel (float32, bfloat16)")
    if qkv.dim() != 3 or qkv.shape[2] != 3 * heads * head_dim:
        raise ValueError(f"qkv must be [B, N, 3*heads*head_dim = {3 * heads * head_dim}], got {tuple(qkv.shape)}")
    b, n, _ = qkv.shape
    if b == 0 or n == 0:
        raise ValueError(f"empty batch {tuple(qkv.shape)}")
    lib = _build.load_library()
    code = _DTYPE_CODE[qkv.dtype]
    if head_dim != lib.toad_mha_head_dim():
        raise ValueError(
            f"head_dim {head_dim} not supported: the attention kernel has instances for "
            f"head_dim {lib.toad_mha_head_dim()} only"
        )
    max_tokens = lib.toad_mha_max_tokens(code)
    if n > max_tokens:
        raise ValueError(
            f"{n} tokens not supported: the {str(qkv.dtype)[6:]} attention kernel takes at most {max_tokens} "
            "(a query row's scores over all keys are held in registers)"
        )
    qkv = qkv.contiguous()
    out = torch.empty((b, n, heads * head_dim), device=qkv.device, dtype=qkv.dtype)
    if qkv.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    # K3 scales the scores by Dh^-1/2, P7 q by c = Dh^-1/2 * log2(e) (the
    # float64 product, rounded to f32 by ctypes as the plain version rounds it)
    scale = new_softmax_factor(head_dim) if variant == "new" else float(head_dim) ** -0.5
    with torch.cuda.device(qkv.device):
        err = lib.toad_mha_forward(
            _SOFTMAX_CODE[variant], code, qkv.data_ptr(), out.data_ptr(), b, n, heads, head_dim,
            scale, torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err} ({lib.toad_cuda_error_string(err).decode()})")
    if variant == "new":
        NEW_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def smem_bytes(dtype: torch.dtype, n_tokens: int) -> int:
    """Dynamic shared memory one block of the kernel takes: one (image,
    head)'s buffer, twice where two fit."""
    return int(_build.load_library().toad_mha_smem_bytes(_DTYPE_CODE[dtype], n_tokens))
