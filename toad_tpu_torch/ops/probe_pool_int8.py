"""The int8 pooling probe's chain variants: plain versions and kernel wrapper.

Counterpart of the TPU probes ``experiments/int8_probe.py::make_kernel_int8``
(P4: ``int8_chain`` with the per-row requantization, ``int8_gemms`` without
it) and ``make_kernel_int8_inquant`` (P3: ``int8_inquant``,
``int8_inquant_bf16``, ``int8_h_only``: x arrives bf16 and is quantized per
row inside the kernel), at the probes' T_PAD = 8 task columns: [B, 8, H] f32.

:func:`plain_probe_int8` and :func:`plain_probe_int8_inquant` are the plain
versions at the probe's rounding points; :func:`probe_pool_int8` launches
``csrc/pool_int8_probe.cu`` on CUDA tensors and raises on anything the
kernel does not take. The kernel runs the pass K2 (``csrc/pool_int8.cu``)
ran on ``mma.sync`` before its GEMMs moved onto int8 wgmma: 64-row tiles,
one weight stream of 32 KB slices through a 3-slot swizzled ring, the grid
in whole waves; :func:`plan`, :func:`layout`,
:func:`stream_schedule` and :func:`split` give its tile, threads, ring,
shared-memory regions, the slices each variant stages a tile and its split.
:func:`probe_qparams` quantizes the probe's weights as ``int8_probe.main``
does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from toad_tpu_torch.ops import _build, cuda_pool_int8 as k2
from toad_tpu_torch.ops.cuda_pool import MAX_SMEM, interleave_gate, wave_split_plan
from toad_tpu_torch.ops.pooling import NEG_INF
from toad_tpu_torch.ops.probe_pool import A, D, H, T_PAD
from toad_tpu_torch.ops.quantize import _int_gemm, _quant_cols, quantize_rows

PREQUANTIZED = ("int8_chain", "int8_gemms")  # x int8 with per-row scales
IN_KERNEL = ("int8_inquant", "int8_inquant_bf16", "int8_h_only")  # x bf16
VARIANTS = PREQUANTIZED + IN_KERNEL
_CODE = {name: i for i, name in enumerate(VARIANTS)}

LAUNCHES = 0  # launches of the kernel in this process (one per call of probe_pool_int8)
INSTANCE_LAUNCHES = dict.fromkeys(VARIANTS, 0)  # the same, by kernel instance


class Int8ProbePlan(NamedTuple):
    """How the kernel runs every instance (``csrc/pool_int8_probe.cu``'s
    ``probe_layout8``; ``toad_probe_int8_smem_bytes`` and
    ``toad_probe_int8_rows_per_tile`` agree with it)."""

    rows: int  # rows of a tile
    threads: int  # threads of a CTA
    slots: int  # slots of the weight ring
    smem: int  # dynamic shared memory of a CTA, bytes


# the mma.sync pass's own strides: h1q/h2q in padded rows, 8 warps as 2 (rows) x 4 (columns)
LD_ACT = k2.HIDDEN + 16  # row stride (bytes) of the int8 activations h1q / h2q
COL_WARPS = 4


def layout() -> dict[str, tuple[int, int]]:
    """The kernel's shared-memory regions in its order, name -> (offset,
    bytes), each 16-byte aligned: K2's weight and x rings (swizzled), h1q/h2q,
    h2 in bf16 (which holds the x tile quantized in the kernel, 64 x (D + 16)
    bytes, before GEMM1), the row scales, each column warp's row amax, the
    column warps' partial scores [4][64][8], s and e [64][8] and the
    statistics [24]. Wc and the running sums [8][H] stay in device memory,
    so A does not enter."""
    sizes = {
        "ws": k2.RING_SLOTS * k2.SLOT_BYTES, "xs": k2.RING_SLOTS * k2.ROWS * k2.TRUNK_DEPTH,
        "act": k2.ROWS * LD_ACT, "h2": 2 * k2.ROWS * k2.LD_H2, "rs": 4 * k2.ROWS,
        "amax": 4 * COL_WARPS * k2.ROWS, "spart": 4 * COL_WARPS * k2.ROWS * T_PAD,
        "s": 4 * k2.ROWS * T_PAD, "e": 4 * k2.ROWS * T_PAD, "stat": 4 * 3 * T_PAD,
    }
    out, offset = {}, 0
    for name, size in sizes.items():
        out[name] = (offset, size)
        offset += -(-size // 16) * 16
    return out


def plan(a_dim: int = A) -> Int8ProbePlan:
    """The kernel's plan at attention width A (H = 512; the same for every
    instance and every A it takes); ValueError for an A the kernel does not
    take or a layout over a CTA's shared memory."""
    if a_dim <= 0 or a_dim % 128 or a_dim > H:
        raise ValueError(f"A={a_dim} not supported by the int8 probe kernel: need A % 128 == 0 and 0 < A <= {H}")
    smem = max(offset + -(-size // 16) * 16 for offset, size in layout().values())
    if smem > MAX_SMEM:
        raise ValueError(f"the int8 probe kernel would need {smem} B of shared memory with {k2.RING_SLOTS} ring "
                         f"slots, over the card's {MAX_SMEM}")
    return Int8ProbePlan(k2.ROWS, k2.THREADS, k2.RING_SLOTS, smem)


def stream_schedule(variant: str, d: int, a_dim: int) -> list[tuple[str, int, int, int, int, int]]:
    """The slices one tile's weight stream stages for ``variant``, in order
    (the kernel's ``stage_slice``): (GEMM, first weight row, first reduction
    byte, rows, bytes a row, bytes of each x row that ride along). W1 first:
    K2's D/64 int8 slices, each with the x tile's same 64 bytes
    (``int8_chain``, ``int8_gemms``), the same without x (``int8_inquant``,
    ``int8_inquant_bf16``: x is quantized in the kernel), or 2D/64 bf16
    slices with 64 bytes of the bf16 x tile (``int8_h_only``); then W2 and
    the gate passes as K2's (:func:`~toad_tpu_torch.ops.cuda_pool_int8.stream_schedule`)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown int8 probe variant {variant!r}: {', '.join(VARIANTS)}")
    w1_bytes = 2 * d if variant == "int8_h_only" else d
    x_bytes = 0 if variant in IN_KERNEL[:2] else k2.TRUNK_DEPTH
    out = [("w1", 0, k0, H, k2.TRUNK_DEPTH, x_bytes) for k0 in range(0, w1_bytes, k2.TRUNK_DEPTH)]
    return out + [(*sl, 0) for sl in k2.stream_schedule(d, a_dim) if sl[0] != "w1"]


def split(b_: int, n: int, n_sms: int) -> tuple[int, int]:
    """(tiles_per_split, n_splits) of the kernel's grid: whole waves of one
    CTA an SM (:func:`~toad_tpu_torch.ops.cuda_pool.wave_split_plan`), as
    K2's."""
    return wave_split_plan(b_, n, k2.ROWS, n_sms)


class Int8ProbeOperands(NamedTuple):
    """The kernel's weights: W1 int8 (``int8_h_only``: bf16), W2 and [Wa|Wb]
    int8, all [out, in] with f32 per-output scales and biases, the rows of
    [Wa|Wb] interleaved in groups of 32; Wc [A, 8] bf16, bc [8] f32."""

    w1: torch.Tensor
    sw1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    sw2: torch.Tensor
    b2: torch.Tensor
    wab: torch.Tensor
    swab: torch.Tensor
    bab: torch.Tensor
    wc: torch.Tensor
    bc: torch.Tensor


def probe_float_weights(seed: int = 0) -> tuple[np.ndarray, ...]:
    """``int8_probe.main``'s f32 weights (w1f, w2f, wabf, wcf), [in, out],
    drawn from ``np.random.RandomState(seed)`` in its order; Wc padded to 8
    columns with zeros."""
    rng = np.random.RandomState(seed)
    w1f = rng.randn(D, H).astype(np.float32) * 0.03
    w2f = rng.randn(H, H).astype(np.float32) * 0.04
    wabf = rng.randn(H, 2 * A).astype(np.float32) * 0.04
    wcf = np.pad(rng.randn(A, 2).astype(np.float32) * 0.05, ((0, 0), (0, T_PAD - 2)))
    return w1f, w2f, wabf, wcf


def probe_qparams(seed: int = 0, h_only: bool = False, device: torch.device | str = "cpu") -> tuple[torch.Tensor, ...]:
    """``int8_probe.main``'s qparams (w1q, sw1, b1, w2q, sw2, b2, wabq, swab,
    bab, wc, bc): per-output-column int8 weights (its ``qcols``, whose
    arithmetic is :func:`~toad_tpu_torch.ops.quantize._quant_cols`'), Wc in
    bf16, zero f32 biases; ``h_only``: W1 in bf16 (its ``hparams``)."""
    w1f, w2f, wabf, wcf = (torch.from_numpy(a) for a in probe_float_weights(seed))
    (w1q, sw1), (w2q, sw2), (wabq, swab) = _quant_cols(w1f), _quant_cols(w2f), _quant_cols(wabf)
    if h_only:
        w1q = w1f.to(torch.bfloat16)
    zeros = torch.zeros
    out = (w1q, sw1, zeros(H), w2q, sw2, zeros(H), wabq, swab, zeros(2 * A), wcf.to(torch.bfloat16), zeros(T_PAD))
    return tuple(t.to(device) for t in out)


def probe_bf16_weights(seed: int = 0, device: torch.device | str = "cpu") -> tuple[torch.Tensor, ...]:
    """The weights of ``int8_probe.main``'s ``bf16`` variant, in
    :func:`~toad_tpu_torch.ops.probe_pool.plain_probe_pool`'s order: its f32
    weights rounded to bf16, zero f32 biases. (``mfu_probe`` rounds the f64
    draws, scaled in f64, instead: the two probes' bf16 weights differ.)"""
    w1f, w2f, wabf, wcf = (torch.from_numpy(a).to(torch.bfloat16) for a in probe_float_weights(seed))
    zeros = torch.zeros
    return tuple(t.to(device) for t in (w1f, zeros(H), w2f, zeros(H), wabf, zeros(2 * A), wcf, zeros(T_PAD)))


def pack_probe_qparams(qparams) -> Int8ProbeOperands:
    """The probe's qparams ([in, out] weights) -> the kernel's operands, on
    the weights' device."""
    w1, sw1, b1, w2, sw2, b2, wab, swab, bab, wc, bc = qparams

    def f32(t):
        return t.detach().to(torch.float32).contiguous()

    return Int8ProbeOperands(
        w1.t().contiguous(), f32(sw1), f32(b1), w2.t().contiguous(), f32(sw2), f32(b2),
        interleave_gate(wab.t()), interleave_gate(f32(swab)), interleave_gate(f32(bab)),
        wc.to(torch.bfloat16).contiguous(), f32(bc),
    )


# -- the row quantizers and the plain versions ---------------------------------


def _requant_rows_bf16(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe's ``_requant_rows_bf16``: inv = bf16(127 / max(amax,
    1e-6)), q = clip(round_half_even(bf16(bf16(y) * inv)), +-127), scale =
    amax / 127 in f32. A product of two bf16 values is exact in f32, so
    rounding it once to bf16 is the bf16 multiply. Divisors are tensors (a
    true division on every device)."""
    amax = y.float().abs().amax(dim=-1)
    inv = (torch.full_like(amax, 127.0) / amax.clamp_min(1e-6)).to(torch.bfloat16).float()
    prod = (y.to(torch.bfloat16).float() * inv[..., None]).to(torch.bfloat16).float()
    q = torch.round(prod).clamp(-127.0, 127.0).to(torch.int8)
    return q, amax / torch.full_like(amax, 127.0)


def _cast_int8(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``requant=False``'s f32 -> int8 cast with unit scales: truncated
    toward zero and saturated to [-128, 127], as XLA casts. (``.to(int8)``
    alone wraps around: 300.7 -> 44.)"""
    q = torch.trunc(y).clamp(-128.0, 127.0).to(torch.int8)
    return q, torch.ones(y.shape[:-1], dtype=torch.float32, device=y.device)


def _dequant(y: torch.Tensor, s_row: torch.Tensor, s_col: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y * (s_row * s_col) + b, the scale product first, each step rounded."""
    return y * (s_row[..., None] * s_col) + b


def _gate_pool(uv: torch.Tensor, h2: torch.Tensor, wc: torch.Tensor, bc: torch.Tensor, mask: torch.Tensor):
    """gated = bf16(tanh(u) sigmoid(v)), s = gated Wc_bf16 + bc, then the
    masked softmax pooling of h2 with e and h2 rounded to bf16: [B, 8, H]."""
    a_dim = uv.shape[-1] // 2
    gated = (torch.tanh(uv[..., :a_dim]) * torch.sigmoid(uv[..., a_dim:])).to(torch.bfloat16).float()
    s = gated @ wc.to(torch.bfloat16).float() + bc  # [B, N, 8]
    live = mask[..., None] > 0
    s = torch.where(live, s, NEG_INF)
    mx = s.amax(dim=1, keepdim=True)
    e = torch.exp(s - torch.where(mx <= NEG_INF / 2, 0.0, mx)) * live
    acc = torch.bmm(e.to(torch.bfloat16).float().transpose(1, 2), h2.to(torch.bfloat16).float())
    return acc / e.sum(dim=1).clamp_min(1e-30)[..., None]


def _chain_tail(qparams, hq, sh, rq, mask):
    """From h1 quantized: the W2 and [Wa|Wb] GEMMs, requantized with rq, then the pooling."""
    _, _, _, w2q, sw2, b2, wabq, swab, bab, wc, bc = qparams
    h2 = torch.relu(_dequant(_int_gemm(hq, w2q), sh, sw2, b2))
    h2q, sh2 = rq(h2)
    uv = _dequant(_int_gemm(h2q, wabq), sh2, swab, bab)
    return _gate_pool(uv, h2, wc, bc, mask)


def plain_probe_int8(qparams, xq: torch.Tensor, sx: torch.Tensor, mask: torch.Tensor, requant: bool) -> torch.Tensor:
    """``make_kernel_int8(requant)`` in plain PyTorch from pre-quantized rows
    (xq [B, N, D] int8, sx [B, N] f32): [B, 8, H] f32. ``requant`` is K2's
    arithmetic at 8 task columns; without it the activations are cast to
    int8 with unit scales (the probe's wrong-by-design bound)."""
    w1q, sw1, b1 = qparams[:3]
    rq = quantize_rows if requant else _cast_int8
    h = torch.relu(_dequant(_int_gemm(xq, w1q), sx.float(), sw1, b1))
    hq, sh = rq(h)
    return _chain_tail(qparams, hq, sh, rq, mask)


def plain_probe_int8_inquant(qparams, x: torch.Tensor, mask: torch.Tensor, quant_bf16: bool,
                             h_only: bool) -> torch.Tensor:
    """``make_kernel_int8_inquant(quant_bf16, h_only)`` in plain PyTorch from
    bf16 rows x [B, N, D]: [B, 8, H] f32. The rows of x (``h_only``: the
    product x W1 in bf16 with f32 sums, not x) and of h1 and h2 are quantized
    with the f32 or (``quant_bf16``) the bf16 quantizer."""
    w1, sw1, b1 = qparams[:3]
    rq = _requant_rows_bf16 if quant_bf16 else (lambda y: quantize_rows(y.float()))
    if h_only:
        h = torch.relu(x.to(torch.bfloat16).float() @ w1.float() + b1)
    else:
        xq, sx = rq(x)
        h = torch.relu(_dequant(_int_gemm(xq, w1), sx, sw1, b1))
    hq, sh = rq(h)
    return _chain_tail(qparams, hq, sh, rq, mask)


def plain_probe_pool_int8(qparams, x: torch.Tensor, sx: torch.Tensor | None, mask: torch.Tensor,
                          variant: str) -> torch.Tensor:
    """The plain version of ``variant``, with :func:`probe_pool_int8`'s arguments."""
    if variant in PREQUANTIZED:
        return plain_probe_int8(qparams, x, sx, mask, requant=variant == "int8_chain")
    if variant not in IN_KERNEL:
        raise ValueError(f"unknown int8 probe variant {variant!r}: {', '.join(VARIANTS)}")
    return plain_probe_int8_inquant(qparams, x, mask, quant_bf16=variant != "int8_inquant",
                                    h_only=variant == "int8_h_only")


def probe_pool_int8(ops: Int8ProbeOperands, x: torch.Tensor, sx: torch.Tensor | None, mask: torch.Tensor,
                    variant: str) -> torch.Tensor:
    """Launch the int8 probe kernel's instance for ``variant`` on CUDA
    tensors: x int8 [B, N, D] with sx [B, N] (``int8_chain``,
    ``int8_gemms``) or bf16 x and no sx (the in-kernel variants) -> [B, 8,
    H] f32."""
    global LAUNCHES
    if variant not in VARIANTS:
        raise ValueError(f"unknown int8 probe variant {variant!r}: {', '.join(VARIANTS)}")
    prequant = variant in PREQUANTIZED
    if prequant != (sx is not None):
        raise ValueError(f"{variant} takes {'int8 x with row scales sx' if prequant else 'bf16 x and no sx'}")
    if x.dtype != (torch.int8 if prequant else torch.bfloat16):
        raise TypeError(f"{variant} takes {'int8' if prequant else 'bf16'} x, got {x.dtype}")
    w1_dtype = torch.bfloat16 if variant == "int8_h_only" else torch.int8
    if (ops.w1.dtype != w1_dtype or ops.w2.dtype != torch.int8 or ops.wab.dtype != torch.int8
            or ops.wc.dtype != torch.bfloat16 or any(t.dtype != torch.float32 for t in ops[1:3] + ops[4:6] + ops[7:9] + ops[10:])):
        raise TypeError(f"operands must come from pack_probe_qparams{' (h_only)' if variant == 'int8_h_only' else ''}")
    if x.dim() != 3 or tuple(mask.shape) != tuple(x.shape[:2]) or (sx is not None and tuple(sx.shape) != tuple(x.shape[:2])):
        raise ValueError(f"need x [B, N, D] with mask (and sx) [B, N], got {tuple(x.shape)} and {tuple(mask.shape)}")
    b_, n, d = x.shape
    h_dim, a_dim = ops.w1.shape[0], ops.wc.shape[0]
    if ops.w1.shape[1] != d or ops.wab.shape != (2 * a_dim, h_dim) or ops.wc.shape[1] != T_PAD:
        raise ValueError(f"operand shapes do not fit D={d}, H={h_dim}, A={a_dim}, {T_PAD} task columns")
    if h_dim != H or d % 64 or a_dim % 128 or a_dim > h_dim or (variant in IN_KERNEL[:2] and (d % 256 or d > 1024)):
        raise ValueError(f"widths D={d}, H={h_dim}, A={a_dim} not supported: need H == {H}, D % 64 == 0 "
                         "(quantized in the kernel: D % 256 == 0 and D <= 1024), A % 128 == 0 and A <= H")
    if b_ == 0 or n == 0 or n % 64:
        raise ValueError(f"N={n} must be a positive multiple of the kernel's 64-row tile")
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA int8 probe kernel needs CUDA tensors, got {x.device}")
    tensors = (mask, *ops) + ((sx,) if sx is not None else ())
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"mask, scales and kernel operands must be on {x.device}")
    x, mask = x.contiguous(), mask.to(torch.float32).contiguous()
    sx = sx.to(torch.float32).contiguous() if sx is not None else None
    for t in (x, mask, *ops) + ((sx,) if sx is not None else ()):
        if t.data_ptr() % 16 or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous and 16-byte aligned")
    dev = x.device
    lib = _build.load_library()
    per, n_splits = split(b_, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((b_, T_PAD, h_dim), device=dev, dtype=torch.float32)
    part_acc = torch.empty((b_ * n_splits * T_PAD * h_dim,), device=dev, dtype=torch.float32)
    part_stat = torch.empty((b_ * n_splits * 2 * T_PAD,), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = lib.toad_probe_int8_forward(
            _CODE[variant], x.data_ptr(), sx.data_ptr() if sx is not None else None, mask.data_ptr(),
            b_, n, d, h_dim, a_dim, *(t.data_ptr() for t in ops), per, n_splits,
            part_acc.data_ptr(), part_stat.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 probe kernel launch failed: CUDA error {err} ({lib.toad_cuda_error_string(err).decode()})")
    LAUNCHES += 1
    INSTANCE_LAUNCHES[variant] += 1
    return out


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for k in INSTANCE_LAUNCHES:
        INSTANCE_LAUNCHES[k] = 0


def smem_bytes() -> int:
    """Dynamic shared memory one block of the kernel takes (every instance
    and A), as the library computes it (:func:`plan`'s ``smem`` must
    agree)."""
    return int(_build.load_library().toad_probe_int8_smem_bytes())


def ops_per_row(variant: str, d: int = D, h_dim: int = H, a_dim: int = A) -> dict[str, int]:
    """Operations one row costs in the kernel, by operand type: the int8
    GEMMs, and in bf16 the score head, e^T h and (``int8_h_only``) x W1."""
    bf16 = 2 * (a_dim * T_PAD + T_PAD * h_dim)
    int8 = 2 * (h_dim * h_dim + h_dim * 2 * a_dim)
    if variant == "int8_h_only":
        bf16 += 2 * d * h_dim
    else:
        int8 += 2 * d * h_dim
    return {"int8": int8, "bf16": bf16}
