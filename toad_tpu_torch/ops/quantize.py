"""Dynamic int8 quantization for the MIL pooling fast path.

PyTorch counterpart of :mod:`toad_tpu.ops.quantize`, with the same scheme:

- activations: per-row scales, ``scale = max(amax(|row|), 1e-6) / 127`` and
  ``q = clip(round_half_even(x / scale), -127, 127)``, computed where the bag
  is already touched (request decode, bag load), so the kernel reads int8;
- weights: per-column scales of the [in, out] W1, W2 and [Wa|Wb], quantized
  once per model. The score head Wc, biases, softmax and heads stay float.

Every quantizer here gives the same bytes as the JAX package's: f32
throughout, a true division ``x / scale`` (never a multiply by a
reciprocal: on CUDA, PyTorch divides by a Python scalar that way, so the
divisors below are tensors), round half to even, then the clip.

:func:`plain_int8_pool` is the plain version of the int8 fused pool at the
rounding points of the kernel (``csrc/pool_int8.cu``): the CPU path, and what
the kernel is held against on the card.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from toad_tpu_torch.ops.pooling import NEG_INF

QMAX = 127.0
AMAX_FLOOR = 1e-6


def quantize_rows_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[N, D] float -> (int8 [N, D], f32 per-row scales [N]); the host-side
    twin of :func:`quantize_rows`. All-zero rows get q=0 (exact for any
    scale: padding-slot scales may be any positive number)."""
    x = np.asarray(x, np.float32)
    amax = np.max(np.abs(x), axis=1)
    scale = np.maximum(amax, np.float32(AMAX_FLOOR)) / np.float32(QMAX)
    q = np.clip(np.rint(x / scale[:, None]), -QMAX, QMAX).astype(np.int8)
    return q, scale.astype(np.float32)


def _quantize(x: torch.Tensor, dim: int, floor: float = AMAX_FLOOR) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 values and f32 scales of ``x`` with one scale per slice along
    ``dim``; ``floor`` bounds amax from below."""
    x = x.detach().to(torch.float32)
    amax = x.abs().amax(dim=dim)
    scale = amax.clamp_min(floor) / torch.full_like(amax, QMAX)
    q = torch.round(x / scale.unsqueeze(dim)).clamp_(-QMAX, QMAX).to(torch.int8)
    return q, scale


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize along the last axis (any leading dims): (int8, f32 scales),
    bit-identical to :func:`quantize_rows_np`."""
    return _quantize(x, -1)


def _quant_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[D_in, D_out] float -> (int8, f32 per-column scales [D_out])."""
    return _quantize(w, 0)


def quantize_pool_params(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Pool params in the JAX layout ([in, out] weights, as
    ``ToadMIL.pool_params`` gives them) -> the int8 pooling weights, keyed as
    the JAX function keys them: ``w1q/sw1/b1, w2q/sw2/b2, wabq/swab/bab,
    wc/bc`` with [Wa|Wb] concatenated along the output axis. Gated attention
    only; the heads are not here."""
    attn = params["attn"]
    if "b" not in attn:
        raise ValueError("int8 pooling implements the gated attention variant only")

    def f32(t):
        return t.detach().to(torch.float32)

    w1q, sw1 = _quant_cols(params["trunk"]["fc1"]["w"])
    w2q, sw2 = _quant_cols(params["trunk"]["fc2"]["w"])
    wabq, swab = _quant_cols(torch.cat([f32(attn["a"]["w"]), f32(attn["b"]["w"])], dim=1))
    return {
        "w1q": w1q, "sw1": sw1, "b1": f32(params["trunk"]["fc1"]["b"]),
        "w2q": w2q, "sw2": sw2, "b2": f32(params["trunk"]["fc2"]["b"]),
        "wabq": wabq, "swab": swab, "bab": torch.cat([f32(attn["a"]["b"]), f32(attn["b"]["b"])]),
        "wc": f32(attn["c"]["w"]), "bc": f32(attn["c"]["b"]),
    }


def _int_gemm(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., K] int8 x [K, M] int8 -> [..., M] f32, exactly (int32 sums of
    at most K*127^2 < 2^24, so the conversion to f32 is exact too)."""
    y = torch._int_mm(q.reshape(-1, q.shape[-1]), w)
    return y.reshape(*q.shape[:-1], w.shape[1]).to(torch.float32)


def _dequant(y: torch.Tensor, s_row: torch.Tensor, s_col: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y * (s_row * s_col) + b, the scale product first and each step
    rounded to f32 (the TPU kernel's association, ``pallas_pool.py:244``)."""
    return y * (s_row[..., None] * s_col) + b


def plain_int8_pool(
    qparams: dict[str, torch.Tensor],
    xq: torch.Tensor,  # [B, N, D] int8
    sx: torch.Tensor,  # [B, N] f32 per-row scales
    mask: torch.Tensor,  # [B, N]
    with_scores: bool,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The int8 fused pool in plain PyTorch at the kernel's rounding points:
    (M [B, T, H] f32, raw task-major scores [B, T, N] f32 or None).

    The three big GEMMs are exact int8 x int8 -> int32; h1 and h2 are
    requantized per row; gated, Wc, h2 and the softmax weights e are rounded
    to bf16 before their products (f32 accumulation);
    ``M = sum(e_bf16 * h2_bf16) / max(sum(e), 1e-30)``. The kernel's online
    softmax rounds e against a running max, this version against the bag's
    max, so the two differ by bf16 rounding of e."""
    a_dim = qparams["wabq"].shape[1] // 2
    sx = sx.to(torch.float32)
    h1 = torch.relu(_dequant(_int_gemm(xq, qparams["w1q"]), sx, qparams["sw1"], qparams["b1"]))
    h1q, sh1 = quantize_rows(h1)
    h2 = torch.relu(_dequant(_int_gemm(h1q, qparams["w2q"]), sh1, qparams["sw2"], qparams["b2"]))
    h2q, sh2 = quantize_rows(h2)
    uv = _dequant(_int_gemm(h2q, qparams["wabq"]), sh2, qparams["swab"], qparams["bab"])
    gated = (torch.tanh(uv[..., :a_dim]) * torch.sigmoid(uv[..., a_dim:])).to(torch.bfloat16)
    wc = qparams["wc"].to(torch.bfloat16).float()
    scores = (gated.float() @ wc + qparams["bc"]).transpose(1, 2)  # [B, T, N]

    live = mask[:, None, :] > 0
    s = torch.where(live, scores, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m <= NEG_INF / 2, 0.0, m)  # a fully-masked bag: shift by 0
    e = torch.exp(s - m) * live
    acc = torch.bmm(e.to(torch.bfloat16).float(), h2.to(torch.bfloat16).float())
    pooled = acc / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return pooled, (scores if with_scores else None)
