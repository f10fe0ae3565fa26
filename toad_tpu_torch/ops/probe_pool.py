"""The pooling probe's ablation ladder: plain version and kernel wrapper.

Counterpart of the TPU probes ``experiments/mfu_probe.py::make_kernel``
(P1: variants ``full``, ``fusedab``, ``exp2``, ``nogate``, ``nosoftmax``,
``trunkonly``), ``make_kernel_b2`` (P2: two bags a block) and
``experiments/int8_probe.py::make_kernel_bf16`` (P5, the int8 probe's bf16
baseline). ``fusedab`` and ``bf16`` run ``full``'s body in the probes (the
fused [Wa|Wb] is already production), so here they are the same kernel
instance as ``full``, counted under ``full``. Every variant computes the
probes' T_PAD = 8 task columns: [B, 8, H] f32.

:func:`plain_probe_pool` is the plain version, at the probe's rounding
points; :func:`probe_pool` launches ``csrc/pool_probe.cu`` on CUDA tensors
and raises on anything the kernel does not take (it never falls back to the
plain version). The kernel is the mma.sync design K1's bf16 instance ran
before its GEMMs moved onto wgmma (``csrc/pool.cu``): 128-row tiles (the
pair: 64 rows of each of two bags), one CTA an SM, a 3-slot
weight ring, the grid in whole waves; :func:`plan` and :func:`split` give
its tile, threads, ring slots, shared memory and split. :func:`probe_weights`
draws the probes' weights.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from toad_tpu_torch.ops import _build
from toad_tpu_torch.ops.cuda_pool import MAX_SMEM, interleave_gate, wave_split_plan
from toad_tpu_torch.ops.pooling import NEG_INF

T_PAD = 8  # the probes' task columns
D, H, A = 1024, 512, 384  # the probes' widths
KERNEL_VARIANTS = ("full", "exp2", "nogate", "nosoftmax", "trunkonly", "b2")  # the kernel's instances
ALIASES = {"fusedab": "full", "bf16": "full"}  # probe variants whose body is full's
_CODE = {"full": 0, "exp2": 1, "nogate": 2, "nosoftmax": 3, "trunkonly": 4, "b2": 0}

LAUNCHES = 0  # launches of the kernel in this process (one per call of probe_pool)
INSTANCE_LAUNCHES = dict.fromkeys(KERNEL_VARIANTS, 0)  # the same, by kernel instance


class ProbeOperands(NamedTuple):
    """The kernel's weights: bf16 [out, in], f32 biases, the rows of [Wa|Wb]
    interleaved in groups of 32 (as K1's), Wc transposed to [8, A] bf16 (the
    score head's B operand on the tensor cores)."""

    w1: torch.Tensor  # [H, D]
    b1: torch.Tensor  # [H]
    w2: torch.Tensor  # [H, H]
    b2: torch.Tensor  # [H]
    wab: torch.Tensor  # [2A, H]
    bab: torch.Tensor  # [2A]
    wc: torch.Tensor  # [8, A]
    bc: torch.Tensor  # [8]


class ProbePlan(NamedTuple):
    """How the kernel runs an instance (``csrc/pool_probe.cu``'s
    ``probe_layout``; ``toad_probe_pool_smem_bytes`` and
    ``toad_probe_pool_rows_per_tile`` agree with it)."""

    rows: int  # rows of a tile
    rows_per_bag: int  # rows of each bag in a tile (the pair: half)
    threads: int  # threads of a CTA
    slots: int  # slots of the cp.async weight ring
    smem: int  # dynamic shared memory of a CTA, bytes


def instance(variant: str) -> str:
    """The kernel instance that runs a probe variant; ValueError on an unknown one."""
    name = ALIASES.get(variant, variant)
    if name not in KERNEL_VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}: {', '.join(KERNEL_VARIANTS + tuple(ALIASES))}")
    return name


def probe_weights(seed: int = 0, device: torch.device | str = "cpu") -> tuple[torch.Tensor, ...]:
    """``mfu_probe.main``'s weights (w1, b1, w2, b2, wab, bab, wc, bc): [in,
    out] bf16 drawn from ``np.random.RandomState(seed)`` in the probe's order,
    Wc padded to 8 columns with zeros, zero f32 biases."""
    rng = np.random.RandomState(seed)

    def bf(a):
        return torch.from_numpy(a).to(torch.bfloat16).to(device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    w1 = bf(rng.randn(D, H) * 0.03)
    w2 = bf(rng.randn(H, H) * 0.04)
    wab = bf(rng.randn(H, 2 * A) * 0.04)
    wc = bf(np.pad(rng.randn(A, 2) * 0.05, ((0, 0), (0, T_PAD - 2))))
    return w1, zeros(H), w2, zeros(H), wab, zeros(2 * A), wc, zeros(T_PAD)


def pack_probe_params(params) -> ProbeOperands:
    """The probe's (w1, b1, w2, b2, wab, bab, wc, bc) with [in, out] weights
    -> the kernel's operands, on the weights' device."""
    w1, b1, w2, b2, wab, bab, wc, bc = params

    def w(t):
        return t.detach().t().to(torch.bfloat16).contiguous()

    def f32(t):
        return t.detach().to(torch.float32).contiguous()

    return ProbeOperands(w(w1), f32(b1), w(w2), f32(b2), interleave_gate(w(wab)), interleave_gate(f32(bab)), w(wc),
                         f32(bc))


def _align16(n: int) -> int:
    return (n + 15) & ~15


def plan(pair: bool = False, h_dim: int = H, a_dim: int = A) -> ProbePlan:
    """The kernel's plan: 128-row tiles of one bag, or 64 rows of each of two
    for the pair; one region for h1 and h2 (rows of H + 8 bf16), the weight
    ring of 3 slots of 256 x 40 bf16, the x ring (3 slots of 128 x 40 bf16,
    or GEMM2's stash of 32 words a thread, or the score scratch: the column
    warps' partial scores [4][128][8], s and e [128][8] in f32) and two bag
    slots' statistics (max, denom, corr [8] each); Wc and the running sums
    stay in device memory, so A does not enter. ValueError for widths the
    kernel does not take."""
    if h_dim != H or a_dim % 128 or not 0 < a_dim <= h_dim:
        raise ValueError(f"widths H={h_dim}, A={a_dim} not supported: need H == {H}, A % 128 == 0 and A <= H")
    rows, threads, slots, stride = 128, 256, 3, 40
    parts = (2 * rows * (h_dim + 8), 2 * slots * 256 * stride,
             max(2 * slots * rows * stride, 4 * 32 * threads, 4 * (4 + 2) * rows * T_PAD), 4 * 2 * 3 * T_PAD)
    smem = sum(map(_align16, parts))
    if smem > MAX_SMEM:
        raise ValueError(f"a CTA would need {smem} B of shared memory, over the card's {MAX_SMEM}")
    return ProbePlan(rows, rows // 2 if pair else rows, threads, slots, smem)


def split(b_: int, n: int, pair: bool, n_sms: int) -> tuple[int, int]:
    """(tiles_per_split, n_splits) of the kernel's grid: whole waves of one
    CTA an SM (:func:`~toad_tpu_torch.ops.cuda_pool.wave_split_plan`) over
    the B / 2 bag pairs of the pair instance, else the B bags."""
    return wave_split_plan(b_ // 2 if pair else b_, n, plan(pair).rows_per_bag, n_sms)


def _gate(u: torch.Tensor, v: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "exp2":  # tanh(u) = 1 - 2 / (e^{2u} + 1), sigmoid(v) = 1 / (1 + e^{-v})
        return (1.0 - 2.0 / (torch.exp(2.0 * u) + 1.0)) * (1.0 / (1.0 + torch.exp(-v)))
    if kind == "nogate":
        return (u * 0.125) * (v * 0.125 + 0.5)
    return torch.tanh(u) * torch.sigmoid(v)


def plain_probe_pool(params, x: torch.Tensor, mask: torch.Tensor, variant: str, tile: int) -> torch.Tensor:
    """The probe's body in plain PyTorch: [B, 8, H] f32 from x [B, N, D]
    bf16 and mask [B, N]. Its rounding points: the products of bf16 values
    summed in f32, h1 and h2 rounded to bf16 after each ReLU, uv, the gate,
    the scores and the softmax in f32, gated and e rounded to bf16 before
    their products; the denominator sums the unrounded e. ``trunkonly``
    divides the sum of h2 over every row (mask ignored) by ``N // tile``, the
    probe's count of grid steps."""
    kind = instance(variant)
    w1, b1, w2, b2, wab, bab, wc, bc = params
    b_, n, _ = x.shape
    h = torch.relu(x.to(torch.bfloat16).float() @ w1.float() + b1).to(torch.bfloat16)
    h = torch.relu(h.float() @ w2.float() + b2).to(torch.bfloat16).float()  # [B, N, H]
    if kind == "trunkonly":
        m = h.sum(dim=1) / (n // tile)
        return m[:, None, :].expand(b_, T_PAD, h.shape[-1]).contiguous()
    a_dim = wab.shape[1] // 2
    uv = h @ wab.float() + bab
    gated = _gate(uv[..., :a_dim], uv[..., a_dim:], kind).to(torch.bfloat16).float()
    s = gated @ wc.float() + bc  # [B, N, 8]
    live = mask[..., None] > 0
    if kind == "nosoftmax":
        e = torch.minimum(s, torch.ones_like(s)) * live
    else:
        s = torch.where(live, s, NEG_INF)
        mx = s.amax(dim=1, keepdim=True)
        e = torch.exp(s - torch.where(mx <= NEG_INF / 2, 0.0, mx)) * live
    acc = torch.bmm(e.to(torch.bfloat16).float().transpose(1, 2), h)  # [B, 8, H]
    return acc / e.sum(dim=1).clamp_min(1e-30)[..., None]


def probe_pool(ops: ProbeOperands, x: torch.Tensor, mask: torch.Tensor, variant: str, tile: int) -> torch.Tensor:
    """Launch the probe kernel's instance for ``variant`` on CUDA tensors:
    [B, 8, H] f32."""
    global LAUNCHES
    kind = instance(variant)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the probe kernel takes bf16 x, got {x.dtype}")
    if any(t.dtype != torch.bfloat16 for t in (ops.w1, ops.w2, ops.wab, ops.wc)) or any(
            t.dtype != torch.float32 for t in (ops.b1, ops.b2, ops.bab, ops.bc)):
        raise TypeError("operands must come from pack_probe_params: bf16 weights, f32 biases")
    if x.dim() != 3 or tuple(mask.shape) != tuple(x.shape[:2]):
        raise ValueError(f"need x [B, N, D] and mask [B, N], got {tuple(x.shape)} and {tuple(mask.shape)}")
    b_, n, d = x.shape
    h_dim, a_dim = ops.w1.shape[0], ops.wc.shape[1]
    if ops.w1.shape[1] != d or ops.wab.shape != (2 * a_dim, h_dim) or ops.wc.shape[0] != T_PAD:
        raise ValueError(f"operand shapes do not fit D={d}, H={h_dim}, A={a_dim}, {T_PAD} task columns")
    if h_dim != H or d % 32 or a_dim % 128 or a_dim > h_dim:
        raise ValueError(f"widths D={d}, H={h_dim}, A={a_dim} not supported: need H == {H}, D % 32 == 0, "
                         "A % 128 == 0 and A <= H")
    if b_ == 0 or n == 0 or tile <= 0 or n % tile:
        raise ValueError(f"N={n} must be a positive multiple of the probe's tile {tile}")
    if n % 64:
        raise ValueError(f"N={n} must be a multiple of 64, the rows of each bag in the pair's tile (half the "
                         "kernel's 128-row tile)")
    if kind == "b2" and b_ % 2:
        raise ValueError(f"the pair variant b2 takes bags two by two: B={b_} is odd")
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA probe kernel needs CUDA tensors, got {x.device}")
    if mask.device != x.device or any(t.device != x.device for t in ops):
        raise ValueError(f"mask and kernel operands must be on {x.device}")
    x, mask = x.contiguous(), mask.to(torch.float32).contiguous()
    for t in (x, mask, *ops):
        if t.data_ptr() % 16 or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous and 16-byte aligned")
    dev = x.device
    lib = _build.load_library()
    pair = int(kind == "b2")
    per, n_splits = split(b_, n, bool(pair), torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((b_, T_PAD, h_dim), device=dev, dtype=torch.float32)
    part_acc = torch.empty((b_ * n_splits * T_PAD * h_dim,), device=dev, dtype=torch.float32)
    part_stat = torch.empty((b_ * n_splits * 2 * T_PAD,), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = lib.toad_probe_pool_forward(
            _CODE[kind], pair, x.data_ptr(), mask.data_ptr(), b_, n, d, h_dim, a_dim,
            *(t.data_ptr() for t in ops), n // tile, per, n_splits,
            part_acc.data_ptr(), part_stat.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe kernel launch failed: CUDA error {err} ({lib.toad_cuda_error_string(err).decode()})")
    LAUNCHES += 1
    INSTANCE_LAUNCHES[kind] += 1
    return out


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for k in INSTANCE_LAUNCHES:
        INSTANCE_LAUNCHES[k] = 0


def smem_bytes() -> int:
    """Dynamic shared memory one block of the kernel takes, as the library
    computes it (:func:`plan`'s ``smem`` must agree)."""
    return int(_build.load_library().toad_probe_pool_smem_bytes())


def ops_per_row(variant: str, d: int = D, h_dim: int = H, a_dim: int = A) -> int:
    """Multiply-add operations one row costs in the kernel instance of
    ``variant``: the GEMMs it runs, the 8-column score head and e^T h
    (``trunkonly``: the trunk and its 1^T h only)."""
    trunk = 2 * (d * h_dim + h_dim * h_dim) + 2 * T_PAD * h_dim
    if instance(variant) == "trunkonly":
        return trunk
    return trunk + 2 * (h_dim * 2 * a_dim + a_dim * T_PAD)


def eager_probe_pool(params, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``full``'s math as the framework schedules it, the counterpart of the
    JAX probe's ``xla`` variant (``run_chain_xla``): bf16 GEMMs (cuBLAS on
    the card, h through device memory), then softmax over N. Its GEMMs
    round their outputs to bf16 before the bias is added, one more rounding
    than the JAX version, which keeps the sums in f32: a timing arm, held to
    the plain version with the bf16 budget of the other kernels."""
    w1, b1, w2, b2, wab, bab, wc, bc = params
    a_dim = wab.shape[1] // 2
    x = x.to(torch.bfloat16)
    h = torch.relu((x @ w1).float() + b1).to(torch.bfloat16)
    h = torch.relu((h @ w2).float() + b2).to(torch.bfloat16)
    uv = (h @ wab).float() + bab
    gated = (torch.tanh(uv[..., :a_dim]) * torch.sigmoid(uv[..., a_dim:])).to(torch.bfloat16)
    s = (gated @ wc).float() + bc
    s = torch.where(mask[..., None] > 0, s, NEG_INF)
    w = torch.softmax(s, dim=1)  # [B, N, 8]
    return (w.to(torch.bfloat16).transpose(1, 2) @ h).float()
