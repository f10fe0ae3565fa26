"""Wrapper of the fused int8 pooling kernel ``csrc/pool_int8.cu``.

The kernel replaces the TPU kernel
``toad_tpu/ops/pallas_pool.py::_pool_kernel_body_int8`` (K2) and its
bag-pair form ``_pool_kernel_body_int8_pair`` (K2b): int8 x int8 -> int32
trunk and gate GEMMs on the tensor cores (int8 wgmma, two warpgroups) with
per-row requantization inside the kernel, then K1's online masked-softmax
pooling and, at the end of the same launch, the merge of each bag's split
partials (``pool_tail``; see the notes in ``csrc/pool_int8.cu``). K2b is a
launch choice, not a second kernel: every batch, even or odd, runs the same
split-N grid as K1.

:func:`plan` gives the kernel's row tile, threads, ring slots and shared
memory, :func:`layout` its shared-memory regions, :func:`swizzle` the byte
order of its ring slots and activation panels and :func:`stream_schedule`
the slices its one weight stream stages a tile, each mirroring the kernel.
:func:`pack_qparams` lays the int8 weights out for the kernel, once per
model; :func:`pool_int8` launches the kernel on CUDA tensors in whole waves
of one CTA an SM (:func:`~toad_tpu_torch.ops.cuda_pool.wave_split_plan`), one
launch a call, and raises on anything the kernel does not take. The plain
version is :func:`toad_tpu_torch.ops.quantize.plain_int8_pool`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from toad_tpu_torch.ops import _build
from toad_tpu_torch.ops.cuda_pool import MAX_SMEM, N_TASKS, interleave_gate, launch_buffers, tickets, wave_split_plan

LAUNCHES = 0  # kernel launches in this process (one per call of pool_int8)
SCORED_LAUNCHES = 0  # those of them in scored mode (with_scores: the raw scores written)

HIDDEN = 512  # the kernel's trunk width: one GEMM pass covers a whole row
ROWS = 64  # rows of a tile (one wgmma M): each trunk GEMM keeps 64 x 512 int32 sums in registers
THREADS = 256  # 8 warps: two warpgroups, each 256 trunk columns (m64n256k32) and 128 of a gate pass (m64n128k32)
WARPGROUPS = 2
RING_SLOTS = 3  # slots of the weight ring: two slices in flight
SLOT_BYTES = 32_768  # a weight slot: 512 trunk rows x 64 B, or 256 gate rows x 128 B
TRUNK_DEPTH = 64  # bytes of the reduction a trunk slice covers (and an x slice: 64 rows x 64 B)
GATE_COLS = 256  # interleaved [Wa|Wb] rows of a gate slice (one gate pass)
GATE_DEPTH = 128  # bytes of the reduction a gate slice covers
PANEL_BYTES = ROWS * TRUNK_DEPTH  # h1q / h2q as HIDDEN / 64 panels of 64 rows x 64 B (an x slot's shape)
LD_H2 = HIDDEN + 8  # row stride (bf16 elements) of h2


class Int8PoolPlan(NamedTuple):
    """How the kernel runs at one width (``csrc/pool_int8.cu``'s constants and
    ``layout8``; the launcher and ``toad_pool_int8_smem_bytes`` /
    ``toad_pool_int8_rows_per_tile`` agree with it)."""

    rows: int  # rows of a tile
    threads: int  # threads of a CTA
    slots: int  # slots of the weight ring
    smem: int  # dynamic shared memory of a CTA, bytes


def layout(a_dim: int) -> dict[str, tuple[int, int]]:
    """The kernel's shared-memory regions in its order, name -> (offset,
    bytes), as ``layout8`` lays them out: the weight ring, the x ring (both
    swizzled), h1q/h2q as swizzled panels, each followed by a 1024-byte
    boundary (so that the x ring, the panels and h2 start on one: the
    swizzles are functions of the address); h2 in bf16, Wc in f32, the row
    scales, each warpgroup's row amax and partial scores, s, e, the running
    acc and the stats, each 16-byte aligned. Every region has its own bytes:
    none is reused while another is live (the rings hold the merge's scratch
    at the launch's end)."""
    regions = [  # name, bytes, the alignment after it
        ("ws", RING_SLOTS * SLOT_BYTES, 1024), ("xs", RING_SLOTS * ROWS * TRUNK_DEPTH, 1024),
        ("panels", ROWS * HIDDEN, 1024), ("h2", 2 * ROWS * LD_H2, 16), ("wc", 4 * N_TASKS * a_dim, 16),
        ("rs", 4 * ROWS, 16), ("wg_amax", 4 * WARPGROUPS * ROWS, 16),
        ("wg_spart", 4 * WARPGROUPS * ROWS * N_TASKS, 16),
        ("s", 4 * N_TASKS * ROWS, 16), ("e", 4 * N_TASKS * ROWS, 16), ("acc", 4 * N_TASKS * HIDDEN, 16),
        ("stat", 4 * 8, 16),
    ]
    out, offset = {}, 0
    for name, size, align in regions:
        out[name] = (offset, size)
        offset += -(-size // align) * align
    return out


def plan(a_dim: int) -> Int8PoolPlan:
    """The kernel's plan at attention width A (H = 512); ValueError for an A
    the kernel does not take or whose layout does not fit a CTA's shared
    memory."""
    if a_dim <= 0 or a_dim % 128 or a_dim > HIDDEN:
        raise ValueError(f"A={a_dim} not supported by the int8 kernel: need A % 128 == 0 and 0 < A <= {HIDDEN}")
    smem = max(offset + -(-size // 16) * 16 for offset, size in layout(a_dim).values())
    if smem > MAX_SMEM:
        raise ValueError(f"A={a_dim} not supported by the int8 kernel: a CTA would need {smem} B of shared memory "
                         f"with {RING_SLOTS} ring slots, over the card's {MAX_SMEM}")
    return Int8PoolPlan(ROWS, THREADS, RING_SLOTS, smem)


def swizzle(offset: int, row_bytes: int) -> int:
    """Where byte ``offset`` of a region of ``row_bytes``-byte rows is stored,
    in the swizzle wgmma's descriptors read (``csrc/wgmma.cuh``): rows of 64
    bytes (trunk and x slots, h1q/h2q's panels) in the 64-byte swizzle, the
    16-byte chunk index (bits 4-5) XOR bits 7-8 (bits 1-2 of the row); rows
    of 128 bytes (gate slots) in the 128-byte swizzle, the chunk index (bits
    4-6) XOR bits 7-9 (the row mod 8; the kernel's ``swz``). Either way the 8
    rows of one 8-row group at one chunk fall in 8 different bank groups."""
    if row_bytes == TRUNK_DEPTH:
        return offset ^ ((offset >> 3) & 0x30)
    if row_bytes == GATE_DEPTH:
        return offset ^ ((offset >> 3) & 0x70)
    raise ValueError(f"no swizzle for rows of {row_bytes} bytes")


def stream_schedule(d: int, a_dim: int) -> list[tuple[str, int, int, int, int]]:
    """The slices one tile's weight stream stages, in order (the kernel's
    ``stage_slice``): (GEMM, first weight row, first reduction byte, rows,
    bytes a row). D/64 of W1 (each with the x tile's same 64 bytes), 8 of W2,
    then 2A/256 gate passes of 4 slices of 256 interleaved [Wa|Wb] rows. Every
    slice fills one slot."""
    out = [("w1", 0, k0, HIDDEN, TRUNK_DEPTH) for k0 in range(0, d, TRUNK_DEPTH)]
    out += [("w2", 0, k0, HIDDEN, TRUNK_DEPTH) for k0 in range(0, HIDDEN, TRUNK_DEPTH)]
    out += [("wab", n0, k0, GATE_COLS, GATE_DEPTH)
            for n0 in range(0, 2 * a_dim, GATE_COLS) for k0 in range(0, HIDDEN, GATE_DEPTH)]
    return out


class Int8PoolOperands(NamedTuple):
    """The kernel's weights: int8 in nn.Linear layout [out, in] with f32
    per-output scales and biases, the rows of [Wa|Wb] interleaved in groups
    of 32 as for K1, Wc [A, 2] rounded to bf16 (``pallas_pool.py:368-369``)."""

    w1: torch.Tensor  # [H, D] int8
    sw1: torch.Tensor  # [H]
    b1: torch.Tensor  # [H]
    w2: torch.Tensor  # [H, H] int8
    sw2: torch.Tensor  # [H]
    b2: torch.Tensor  # [H]
    wab: torch.Tensor  # [2A, H] int8
    swab: torch.Tensor  # [2A]
    bab: torch.Tensor  # [2A]
    wc: torch.Tensor  # [A, 2] bf16
    bc: torch.Tensor  # [2]


def pack_qparams(qparams: dict[str, torch.Tensor]) -> Int8PoolOperands:
    """:func:`~toad_tpu_torch.ops.quantize.quantize_pool_params` dict ([in,
    out] int8 weights, per-column scales) -> the kernel's operands, on the
    weights' device."""

    def f32(name):
        return qparams[name].to(torch.float32).contiguous()

    return Int8PoolOperands(
        qparams["w1q"].t().contiguous(), f32("sw1"), f32("b1"),
        qparams["w2q"].t().contiguous(), f32("sw2"), f32("b2"),
        interleave_gate(qparams["wabq"].t()), interleave_gate(f32("swab")), interleave_gate(f32("bab")),
        qparams["wc"].to(torch.bfloat16).contiguous(), f32("bc"),
    )


def pool_int8(
    ops: Int8PoolOperands, xq: torch.Tensor, sx: torch.Tensor, mask: torch.Tensor, with_scores: bool, *,
    split: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch the fused int8 pooling kernel: (M [B, 2, H] f32, raw scores
    [B, 2, N] f32 or None). Scores are written only when ``with_scores``;
    without them, row tiles that hold only padding are skipped. ``split`` =
    (tiles_per_split, n_splits) runs each bag in those runs of row tiles in
    place of the default whole-wave plan; the scores do not depend on it, M
    only by the rounding of e to bf16 against each run's running max."""
    global LAUNCHES, SCORED_LAUNCHES
    if xq.device.type != "cuda":
        raise ValueError(f"the CUDA int8 pooling kernel needs CUDA tensors, got {xq.device}")
    if sx.device != xq.device or mask.device != xq.device or any(t.device != xq.device for t in ops):
        raise ValueError(f"scales, mask and kernel operands must be on {xq.device}")
    if xq.dtype != torch.int8:
        raise TypeError(f"xq must be int8, got {xq.dtype}")
    int8_ops = (ops.w1, ops.w2, ops.wab)
    f32_ops = (ops.sw1, ops.b1, ops.sw2, ops.b2, ops.swab, ops.bab, ops.bc)
    if (any(t.dtype != torch.int8 for t in int8_ops) or ops.wc.dtype != torch.bfloat16
            or any(t.dtype != torch.float32 for t in f32_ops)):
        raise TypeError("operands must come from pack_qparams: int8 weights, bf16 Wc, f32 scales and biases")
    if xq.dim() != 3:
        raise ValueError(f"xq must be [B, N, D], got {tuple(xq.shape)}")
    b_, n, d = xq.shape
    if tuple(sx.shape) != (b_, n) or tuple(mask.shape) != (b_, n):
        raise ValueError(f"sx and mask must be [{b_}, {n}], got {tuple(sx.shape)} and {tuple(mask.shape)}")
    if b_ == 0 or n == 0:
        raise ValueError(f"empty batch {tuple(xq.shape)}")
    h_dim, a_dim = ops.w1.shape[0], ops.wc.shape[0]
    if ops.wc.shape[1] != N_TASKS:
        raise ValueError(f"the kernel computes {N_TASKS} task columns, operands have {ops.wc.shape[1]}")
    if ops.w1.shape[1] != d or ops.w2.shape != (h_dim, h_dim) or ops.wab.shape != (2 * a_dim, h_dim):
        raise ValueError(f"operand shapes do not fit D={d}, H={h_dim}, A={a_dim}")
    if d % 64 or h_dim != HIDDEN or a_dim % 128 or a_dim > h_dim:
        raise ValueError(
            f"widths D={d}, H={h_dim}, A={a_dim} not supported: need D % 64 == 0, "
            f"H == {HIDDEN}, A % 128 == 0 and A <= H"
        )
    if split is not None:
        per, n_splits = split
        n_tiles = -(-n // ROWS)
        if per < 1 or not per * (n_splits - 1) < n_tiles <= per * n_splits:
            raise ValueError(f"split {split} does not cover the {n_tiles} row tiles once without an empty run")

    dev = xq.device
    xq = xq.contiguous()
    sx = sx.to(torch.float32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    for tensor in (xq, sx, mask, *ops):
        if tensor.data_ptr() % 16 or not tensor.is_contiguous():
            raise ValueError("kernel operands must be contiguous and 16-byte aligned")
    lib = _build.load_library()
    splitter = wave_split_plan if split is None else lambda *_: split
    per, n_splits, m, scores, part_acc, part_stat = launch_buffers(
        b_, n, h_dim, with_scores, lib.toad_pool_int8_rows_per_tile(), dev, splitter=splitter)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.toad_pool_int8_forward(
            xq.data_ptr(), sx.data_ptr(), mask.data_ptr(), b_, n, d, h_dim, a_dim,
            *(tensor.data_ptr() for tensor in ops),
            per, n_splits,
            scores.data_ptr() if scores is not None else None, part_acc.data_ptr(), part_stat.data_ptr(),
            tickets(dev, stream, b_).data_ptr(), m.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"int8 pooling kernel launch failed: CUDA error {err} ({lib.toad_cuda_error_string(err).decode()})")
    LAUNCHES += 1
    SCORED_LAUNCHES += with_scores
    return m, scores


def smem_bytes(a_dim: int) -> int:
    """Dynamic shared memory one block of the kernel takes, as the library
    computes it (:func:`plan`'s ``smem`` must agree)."""
    return int(_build.load_library().toad_pool_int8_smem_bytes(a_dim))
