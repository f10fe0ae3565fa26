"""Wrapper of the fused pooling kernel ``csrc/pool.cu``.

The kernel replaces the TPU kernel
``toad_tpu/ops/pallas_pool.py::_pool_kernel_body`` (trunk MLP, gated
attention scores and online masked-softmax pooling in one pass per bag). On
an H100 it is tensor-core bound (~1,150 FLOP per byte of bf16 input against
the card's ~295), so it keeps every intermediate on chip and streams weight
slices from L2; the TPU's sequential per-bag grid becomes a split-N grid with
an exact merge of the partial softmax statistics at the end of the same
launch (see the notes in ``csrc/pool.cu``), so that one call is one launch.
The TPU's bag-pair form (two bags merged per grid step to
fill its matrix unit) has no counterpart here: on Hopper the split-N grid
already keeps every SM busy with full row tiles.

:func:`plan` gives each instance's row tile, threads, ring slots and shared
memory, both on Hopper's ``wgmma``: the bf16 instance 128-row tiles (two
warpgroups of 64 rows, each every column of a 256-column pass, the weights
through a 4-slot ring, :func:`bf16_layout`), the f32 instance 64-row tiles
(two warpgroups of H/2 columns on tf32 ``wgmma``, :func:`f32_layout`) with
its products as error-compensated TF32 (3xTF32: each f32 operand split into
two TF32 halves, three tensor-core products summed in f32), each with h1 and
h2 in one shared region; both run their grid in whole waves of one CTA an SM
(:func:`wave_split_plan`). :func:`pack_params` lays the
weights out for the kernel, once per model and compute dtype; :func:`pool` launches the kernel on CUDA tensors and
raises on anything the kernel does not take. The plain version is
:func:`toad_tpu_torch.ops.fused_pool.plain_pool`, which the CPU path runs
and the chip check compares with. :func:`pool_partial` is the same launch
ending without the division (the TPU kernel's partial form,
``pallas_pool_partial``), one shard's share of a bag too long for one piece,
read in place where the shard is a slice of a larger batch;
:func:`combine_shards` merges shards' partials that come from several
devices, and :func:`pool_sharded` pools all of a bag's shards on one card in
one launch (:mod:`toad_tpu_torch.parallel.bag_shard`).

Each launch ends in a merge that the block finishing a bag's partials last
runs; the blocks find it by drawing tickets from one int32 counter a bag,
which :func:`tickets` keeps per device and stream, zeroed once, and which
every completed launch leaves at zero.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, NamedTuple

import torch

from toad_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches in this process (one per call of pool)
SCORED_LAUNCHES = 0  # those of them in scored mode (with_scores: the raw scores written)
PARTIAL_LAUNCHES = 0  # launches of the kernel's partial mode (one per call of pool_partial)
SHARDED_LAUNCHES = 0  # launches of the one-launch bag-sharded pool (one per call of pool_sharded)
COMBINE_LAUNCHES = 0  # launches of the cross-shard combine (one per call of combine_shards)

N_TASKS = 2  # the kernel computes exactly the two task columns
GATE_GROUP = 32  # [Wa|Wb] rows interleave in groups of this many (csrc/pool.cu)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BLOCKS_PER_SM = 4  # grid target of split_plan: several blocks per SM even for one bag
TRUNK_WIDTHS = (256, 512)  # trunk widths H whose layouts fit one CTA's shared memory
MAX_SMEM = 232_448  # dynamic shared memory one CTA may take on the card (227 KB)


class PoolOperands(NamedTuple):
    """The kernel's weights: [out, in] in the compute dtype, biases f32, the
    rows of [Wa|Wb] interleaved in groups of GATE_GROUP, Wc as [A, 2]."""

    w1: torch.Tensor  # [H, D]
    b1: torch.Tensor  # [H]
    w2: torch.Tensor  # [H, H]
    b2: torch.Tensor  # [H]
    wab: torch.Tensor  # [2A, H]
    bab: torch.Tensor  # [2A]
    wc: torch.Tensor  # [A, 2]
    bc: torch.Tensor  # [2]


def interleave_gate(t: torch.Tensor) -> torch.Tensor:
    """[2A, ...] rows u_0..u_{A-1}, v_0..v_{A-1} -> for each group g of 32:
    u rows g*32..g*32+31, then the v rows of the same j. Views and one copy
    on the tensor's device (an index tensor would need a host-to-device copy
    that waits for the stream)."""
    a_dim = t.shape[0] // 2
    return t.reshape(2, a_dim // GATE_GROUP, GATE_GROUP, *t.shape[1:]).transpose(0, 1).reshape(t.shape).contiguous()


def pack_linears(lins: dict[str, tuple[torch.Tensor, torch.Tensor]], dtype: torch.dtype) -> PoolOperands:
    """(weight [out, in], bias) pairs in nn.Linear layout, keyed fc1, fc2, a,
    b, c -> the kernel's operands, on the weights' device."""
    if "b" not in lins:
        raise NotImplementedError(
            "un-gated attention has no CUDA kernel (the kernel computes the gated variant only, as the JAX "
            "package's): ops.fused_pool.kernel_pools routes un-gated params to the plain version on the card"
        )

    def w(name):
        return lins[name][0].detach().to(dtype).contiguous()

    def b(name):
        return lins[name][1].detach().to(torch.float32).contiguous()

    return PoolOperands(
        w("fc1"), b("fc1"), w("fc2"), b("fc2"),
        interleave_gate(torch.cat([w("a"), w("b")])), interleave_gate(torch.cat([b("a"), b("b")])),
        w("c").t().contiguous(), b("c"),
    )


def pack_params(params: dict[str, Any], dtype: torch.dtype) -> PoolOperands:
    """The JAX params layout ([in, out] weights) -> the kernel's operands."""
    lins = {**params["trunk"], **params["attn"]}
    return pack_linears({k: (torch.as_tensor(p["w"]).t(), torch.as_tensor(p["b"])) for k, p in lins.items()}, dtype)


class PoolPlan(NamedTuple):
    """How the kernel runs one compute dtype at one width (``csrc/pool.cu``'s
    ``layout_bf16`` and ``layout_f32``; the launcher and
    ``toad_pool_smem_bytes`` / ``toad_pool_rows_per_tile`` agree with it)."""

    rows: int  # rows of a tile
    threads: int  # threads of a CTA
    slots: int  # slots of a weight ring (the bf16 instance's one; each f32 warpgroup's own)
    smem: int  # dynamic shared memory of a CTA, bytes


def _align16(n: int) -> int:
    return (n + 15) & ~15


BF16_ROWS = 128  # the bf16 instance's tile: two warpgroups of one wgmma M each
BF16_SLOTS = 4  # slots of the bf16 instance's weight and x rings: two slices in flight beside the one multiplied
BF16_DEPTH = 32  # reduction depth of a bf16 slice: two bf16 wgmma K, 64-byte rows
F32_ROWS = 64  # the f32 instance's tile: one wgmma M
F32_SLOTS = 2  # slots of each warpgroup's cp.async ring in the f32 instance
F32_DEPTH = 16  # reduction depth of an f32 slice: two tf32 wgmma K, 64-byte rows


def bf16_layout(h_dim: int) -> dict[str, int]:
    """The bf16 instance's shared memory by part, in bytes, each padded as
    ``csrc/pool.cu``'s ``layout_bf16`` pads it: the region for h1 and h2 as
    H/32 panels of 128 rows x 32 bf16 and the weight ring of 4 slots of 256
    rows x 32 bf16, both of 64-byte rows in wgmma's swizzle (no padding) on
    1024-byte boundaries; the x ring of 4 such slots of 128 rows, which also
    holds half of GEMM2's stash (32 of a thread's 64 packed words), then the
    scores and e; the stats. The running acc is the block's slot of the
    partials in device memory and Wc stays there, so A does not change it."""
    parts = {"h": 2 * BF16_ROWS * h_dim, "ring": 2 * BF16_SLOTS * 256 * BF16_DEPTH,
             "xs": max(2 * BF16_SLOTS * BF16_ROWS * BF16_DEPTH, 4 * 32 * 256), "stat": 4 * 8}
    return {k: _align16(v) for k, v in parts.items()}


def f32_layout(h_dim: int) -> dict[str, int]:
    """The f32 instance's shared memory by part, in bytes, each padded as
    ``csrc/pool.cu``'s ``layout_f32`` pads it: the region [64][H + 4] for
    GEMM1's x slices, h1 and h2 (ending on a 1024-byte boundary, where the
    swizzled rings start); the two warpgroups' weight rings of 2 slots of
    H/2 rows x 16 f32 (64-byte rows) and their small halves of one slice
    (which at a tile's end hold the partial scores, s and e); the stats.
    The running acc stays in registers and Wc in device memory, so A does
    not change it."""
    parts = {"h": 4 * F32_ROWS * (h_dim + 4), "ring": 4 * 2 * F32_SLOTS * (h_dim // 2) * F32_DEPTH,
             "small": 4 * 2 * (h_dim // 2) * F32_DEPTH, "stat": 4 * 8}
    padded = {k: _align16(v) for k, v in parts.items()}
    padded["h"] = (parts["h"] + 1023) & ~1023
    return padded


def plan(compute_dtype: torch.dtype, h_dim: int, a_dim: int) -> PoolPlan:
    """The kernel's plan for (compute dtype, H, A); ValueError for H outside
    ``TRUNK_WIDTHS`` (a layout that does not fit a CTA's shared memory),
    TypeError for a dtype without an instance."""
    if compute_dtype not in _DTYPE_CODE:
        raise TypeError(f"compute dtype {compute_dtype} not supported by the kernel (float32, bfloat16)")
    if h_dim not in TRUNK_WIDTHS:
        raise ValueError(f"H={h_dim} not supported in {str(compute_dtype)[6:]}: the kernel's tile of h1 and h2 fits "
                         f"shared memory only at H in {TRUNK_WIDTHS}")
    if compute_dtype == torch.bfloat16:
        rows, threads, slots = BF16_ROWS, 256, BF16_SLOTS
        smem = sum(bf16_layout(h_dim).values())
    else:
        rows, threads, slots = F32_ROWS, 256, F32_SLOTS
        smem = sum(f32_layout(h_dim).values())
    if smem > MAX_SMEM:
        raise ValueError(f"H={h_dim}, A={a_dim} not supported in {compute_dtype}: a CTA would need {smem} B of "
                         f"shared memory, over the card's {MAX_SMEM}")
    return PoolPlan(rows, threads, slots, smem)


def split_plan(n_bags: int, n_rows: int, rows_per_tile: int, n_sms: int) -> tuple[int, int]:
    """(tiles_per_split, n_splits): cut each bag's row tiles into contiguous
    runs so that the grid has about ``_BLOCKS_PER_SM`` blocks per SM."""
    n_tiles = -(-n_rows // rows_per_tile)
    want = max(1, -(-_BLOCKS_PER_SM * n_sms // n_bags))
    per = -(-n_tiles // min(n_tiles, want))
    return per, -(-n_tiles // per)


@functools.lru_cache(maxsize=256)
def wave_split_plan(n_bags: int, n_rows: int, rows_per_tile: int, n_sms: int) -> tuple[int, int]:
    """(tiles_per_split, n_splits) for a kernel that holds an SM with one CTA
    (both instances of K1): the grid runs in ceil(blocks / n_sms) waves of up to
    ``tiles_per_split`` tiles each, and the plan takes the fewest tile-times
    that way, and of those the fewest splits. Where a bag's tiles allow, that
    is one whole wave of the fair share, ceil(tiles / n_sms) tiles a CTA."""
    n_tiles = -(-n_rows // rows_per_tile)
    best = None
    for splits in range(1, n_tiles + 1):
        per = -(-n_tiles // splits)
        if -(-n_tiles // per) != splits:  # the same runs as a smaller split count
            continue
        cost = -(-n_bags * splits // n_sms) * per
        if best is None or cost < best[0]:
            best = (cost, per, splits)
    return best[1], best[2]


def shard_split_plan(n_bags: int, n_shards: int, shard_rows: int, rows_per_tile: int, n_sms: int) -> tuple[int, int]:
    """(tiles_per_split, n_splits a shard) for one launch over ``n_shards``
    equal shards of each of ``n_bags`` bags (:func:`pool_sharded`): each
    shard's tiles cut into contiguous runs that never cross into the next
    shard, so that every partial is a shard-local flash statistic. The grid
    of n_bags x n_shards x n_splits CTAs takes the fewest tile-times in whole
    waves of one CTA an SM, and of those the fewest splits, as
    :func:`wave_split_plan` does for one piece. That is ceil(tiles / n_sms)
    tile-times for all the tiles of the batch, the same as one launch on the
    unsharded bags where the shard divides by the tile: 163,840 rows in 4
    shards of 128-row tiles run 128 CTAs of 10 tiles, where one launch a
    shard takes 4 x 3."""
    return wave_split_plan(n_bags * n_shards, shard_rows, rows_per_tile, n_sms)


def fixed_split_plan(n_rows: int, rows_per_tile: int, rows_per_split: int) -> tuple[int, int]:
    """(tiles_per_split, n_splits) that cut each bag into runs of
    ``rows_per_split`` rows (the last may be shorter); ValueError unless that
    is a positive multiple of the kernel's row tile."""
    if rows_per_split <= 0 or rows_per_split % rows_per_tile:
        raise ValueError(f"rows_per_split={rows_per_split} must be a positive multiple of the kernel's "
                         f"{rows_per_tile}-row tile")
    per = rows_per_split // rows_per_tile
    return per, -(-n_rows // rows_per_split)


def launch_buffers(b_: int, n: int, h_dim: int, with_scores: bool, rows_per_tile: int, dev: torch.device,
                   rows_per_split: int | None = None, splitter=split_plan, parts_per_split: int = 1):
    """The split plan (``splitter``: :func:`split_plan` or
    :func:`wave_split_plan`, called as ``splitter(b_, n, rows_per_tile,
    n_sms)``; :func:`fixed_split_plan` for a given ``rows_per_split``) and
    the buffers a split-N pooling launch writes: (tiles_per_split, n_splits,
    M [B, 2, H], scores [B, 2, N] or None, partial acc, partial stats), with
    ``parts_per_split`` partials a split and bag (the shards of one launch)."""
    if rows_per_split is None:
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        per, n_splits = splitter(b_, n, rows_per_tile, n_sms)
    else:
        per, n_splits = fixed_split_plan(n, rows_per_tile, rows_per_split)
    parts = b_ * n_splits * parts_per_split
    m = torch.empty((b_, N_TASKS, h_dim), device=dev, dtype=torch.float32)
    scores = torch.empty((b_, N_TASKS, n), device=dev, dtype=torch.float32) if with_scores else None
    part_acc = torch.empty((parts * N_TASKS * h_dim,), device=dev, dtype=torch.float32)
    part_stat = torch.empty((parts * 4,), device=dev, dtype=torch.float32)
    return per, n_splits, m, scores, part_acc, part_stat


_tickets: dict[tuple[torch.device, int], torch.Tensor] = {}
_tickets_lock = threading.Lock()


def tickets(dev: torch.device, stream: int, n_bags: int) -> torch.Tensor:
    """The int32 counters (one a bag, at least ``n_bags``) that the pooling
    launches on ``stream`` of ``dev`` draw their merge's tickets from. Made
    zeroed once a (device, stream), and again, larger, when a launch has more
    bags than the buffer has counters; every completed launch leaves them at
    zero (the bag's last block resets its counter), so no launch fills them."""
    key = (dev, stream)
    with _tickets_lock:
        buf = _tickets.get(key)
        if buf is None or buf.numel() < n_bags:
            buf = torch.zeros(max(n_bags, 64, 2 * (buf.numel() if buf is not None else 0)), dtype=torch.int32,
                              device=dev)
            _tickets[key] = buf
        return buf


def rows_in_place(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` [B, N, ...] in ``dtype`` as the kernel reads it: each bag's rows
    contiguous, one bag to the next at ``t.stride(0)``. A slice of a larger
    batch along N (a shard) is such a view and is returned as it is; a cast
    or a tensor whose rows are not contiguous is copied."""
    t = t.to(dtype)
    row = 1
    for size, stride in reversed(list(zip(t.shape[1:], t.stride()[1:]))):
        if size != 1 and stride != row:
            return t.contiguous()
        row *= size
    return t


def bag_stride(t: torch.Tensor) -> int:
    """Elements from one bag to the next of a tensor from :func:`rows_in_place`."""
    return t.stride(0) if t.shape[0] > 1 else 0


def _prepare(ops: PoolOperands, x: torch.Tensor, mask: torch.Tensor):
    """The checks every launch of the pooling kernel makes, the shapes and
    widths before the devices (so that a width the kernel does not take is
    refused before anything is built); returns (x in the operands' dtype, f32
    mask, each with contiguous rows (:func:`rows_in_place`: a shard sliced
    out of a batch is not copied), B, N, D, H, A and the kernel's plan)."""
    dt = ops.w1.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"compute dtype {dt} not supported by the kernel (float32, bfloat16)")
    if any(t.dtype != dt for t in ops[0::2]) or any(t.dtype != torch.float32 or not t.is_contiguous() for t in ops[1::2]):
        raise TypeError("operands must come from pack_params: weights in one dtype, f32 biases")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, D], got {tuple(x.shape)}")
    b_, n, d = x.shape
    if tuple(mask.shape) != (b_, n):
        raise ValueError(f"mask must be [{b_}, {n}], got {tuple(mask.shape)}")
    if b_ == 0 or n == 0:
        raise ValueError(f"empty batch {tuple(x.shape)}")
    h_dim, a_dim = ops.w1.shape[0], ops.wc.shape[0]
    if ops.wc.shape[1] != N_TASKS:
        raise ValueError(f"the kernel computes {N_TASKS} task columns, operands have {ops.wc.shape[1]}")
    if ops.w1.shape[1] != d or ops.w2.shape != (h_dim, h_dim) or ops.wab.shape != (2 * a_dim, h_dim):
        raise ValueError(f"operand shapes do not fit D={d}, H={h_dim}, A={a_dim}")
    if d % 32 or h_dim % 256 or a_dim % 128 or a_dim > h_dim:
        raise ValueError(
            f"widths D={d}, H={h_dim}, A={a_dim} not supported: need D % 32 == 0, "
            "H % 256 == 0, A % 128 == 0 and A <= H"
        )
    kernel_plan = plan(dt, h_dim, a_dim)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA pooling kernel needs CUDA tensors, got {x.device}")
    if mask.device != x.device or any(t.device != x.device for t in ops):
        raise ValueError(f"mask and kernel operands must be on {x.device}")
    x = rows_in_place(x, dt)
    if b_ > 1 and x.stride(0) * x.element_size() % 16:  # each bag's first row 16-byte aligned for cp.async
        x = x.contiguous()
    mask = rows_in_place(mask, torch.float32)
    if x.data_ptr() % 16 or any(t.data_ptr() % 16 or not t.is_contiguous() for t in ops):
        raise ValueError("kernel operands must be contiguous and 16-byte aligned")
    return x, mask, b_, n, d, h_dim, a_dim, kernel_plan


def _splitter(compute_dtype: torch.dtype):
    """The default split plan of an instance: whole waves, since both the
    bf16 and the f32 instance hold an SM with one CTA (as K2 and both
    probes do)."""
    return wave_split_plan


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({lib.toad_cuda_error_string(err).decode()})")


def pool(
    ops: PoolOperands, x: torch.Tensor, mask: torch.Tensor, with_scores: bool, *, rows_per_split: int | None = None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch the fused pooling kernel, one launch: (M [B, 2, H] f32, raw
    scores [B, 2, N] f32 or None), computing in the dtype of ``ops``. Scores are
    written only when ``with_scores``; without them, row tiles that hold only
    padding are skipped. ``rows_per_split`` cuts each bag into blocks of that
    many rows (a multiple of the kernel's row tile, :func:`plan`'s rows)
    instead of the default plan's (:func:`wave_split_plan`); 2,048 is the long-bag probe's tiling
    (``experiments/longbag_probe.py::pool_tile2048``)."""
    global LAUNCHES, SCORED_LAUNCHES
    x, mask, b_, n, d, h_dim, a_dim, kernel_plan = _prepare(ops, x, mask)
    dev = x.device
    lib = _build.load_library()
    code = _DTYPE_CODE[ops.w1.dtype]
    per, n_splits, m, scores, part_acc, part_stat = launch_buffers(
        b_, n, h_dim, with_scores, kernel_plan.rows, dev, rows_per_split, _splitter(ops.w1.dtype))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.toad_pool_forward(
            code, x.data_ptr(), mask.data_ptr(), bag_stride(x), bag_stride(mask), b_, n, d, h_dim, a_dim,
            *(tensor.data_ptr() for tensor in ops),
            per, n_splits,
            scores.data_ptr() if scores is not None else None, part_acc.data_ptr(), part_stat.data_ptr(),
            tickets(dev, stream, b_).data_ptr(), m.data_ptr(), stream,
        )
    _raise_on(err, lib, "pooling kernel")
    LAUNCHES += 1
    SCORED_LAUNCHES += with_scores
    return m, scores


def pool_partial(
    ops: PoolOperands, x: torch.Tensor, mask: torch.Tensor, out: tuple[torch.Tensor, torch.Tensor] | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the pooling kernel in partial mode, one launch, on one shard
    of the patch dimension (x [B, N_local, D], mask [B, N_local], read in
    place where they are slices of a batch): (acc [B, 2, H] f32 =
    sum over the live rows of exp(s - max) h, stats [B, 2, 2] f32 with
    ``stats[:, 0]`` = max and ``stats[:, 1]`` = denom per task), the pooled
    mean's numerator and denominator before the division. A shard without
    live rows gives max = NEG_INF, denom = 0, acc = 0. :func:`combine_shards`
    makes the result of several shards' partials. ``out`` = (acc, stats)
    are contiguous f32 tensors of those shapes to write into (for instance
    one shard's slot of the stacked buffers); without it new ones are made."""
    global PARTIAL_LAUNCHES
    x, mask, b_, n, d, h_dim, a_dim, kernel_plan = _prepare(ops, x, mask)
    dev = x.device
    lib = _build.load_library()
    code = _DTYPE_CODE[ops.w1.dtype]
    per, n_splits, acc, _, part_acc, part_stat = launch_buffers(
        b_, n, h_dim, False, kernel_plan.rows, dev, splitter=_splitter(ops.w1.dtype))
    if out is None:
        stats = torch.empty((b_, 2, N_TASKS), device=dev, dtype=torch.float32)
    else:
        acc, stats = out
        for t, shape in ((acc, (b_, N_TASKS, h_dim)), (stats, (b_, 2, N_TASKS))):
            if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
                raise ValueError(f"out must be contiguous f32 {shape} on {dev}, got {tuple(t.shape)} {t.dtype} {t.device}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.toad_pool_partial_forward(
            code, x.data_ptr(), mask.data_ptr(), bag_stride(x), bag_stride(mask), b_, n, d, h_dim, a_dim,
            *(tensor.data_ptr() for tensor in ops),
            per, n_splits, part_acc.data_ptr(), part_stat.data_ptr(), tickets(dev, stream, b_).data_ptr(),
            acc.data_ptr(), stats.data_ptr(), stream,
        )
    _raise_on(err, lib, "partial pooling kernel")
    PARTIAL_LAUNCHES += 1
    return acc, stats


def pool_sharded(ops: PoolOperands, x: torch.Tensor, mask: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The bag-sharded pool on one card in one launch: each bag's N rows cut
    into ``n_shards`` equal contiguous shards (N must divide), each shard
    pooled in partial mode in runs of its own tiles
    (:func:`shard_split_plan`), and the end of the launch merging every
    partial of a bag: pooled M [B, 2, H] f32 = sum acc w / max(sum denom w,
    1e-12), what :func:`pool_partial` per shard and :func:`combine_shards`
    give, in one pass over the card instead of one launch a shard."""
    global SHARDED_LAUNCHES
    x, mask, b_, n, d, h_dim, a_dim, kernel_plan = _prepare(ops, x, mask)
    if n_shards < 1 or n % n_shards:
        raise ValueError(f"the patch dimension {n} must divide into {n_shards} shards")
    dev = x.device
    lib = _build.load_library()
    shard = n // n_shards
    per, n_splits, m, _, part_acc, part_stat = launch_buffers(
        b_, shard, h_dim, False, kernel_plan.rows, dev,
        splitter=lambda b, rows, r, sms: shard_split_plan(b, n_shards, rows, r, sms), parts_per_split=n_shards)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.toad_pool_sharded_forward(
            _DTYPE_CODE[ops.w1.dtype], x.data_ptr(), mask.data_ptr(), bag_stride(x), bag_stride(mask), b_, n_shards,
            shard, d, h_dim, a_dim, *(tensor.data_ptr() for tensor in ops),
            per, n_splits, part_acc.data_ptr(), part_stat.data_ptr(), tickets(dev, stream, b_).data_ptr(),
            m.data_ptr(), stream,
        )
    _raise_on(err, lib, "sharded pooling kernel")
    SHARDED_LAUNCHES += 1
    return m


def combine_shards(acc: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """Launch the cross-shard combine, for partials that come from several
    devices (on one card :func:`pool_sharded` merges them in its own launch):
    acc [S, B, 2, H] and stats [S, B, 2, 2] from :func:`pool_partial` ->
    pooled M [B, 2, H] f32 =
    sum_s acc_s w_s / max(sum_s denom_s w_s, 1e-12) with w_s = exp(max_s -
    max over shards), 0 for a shard without live rows."""
    global COMBINE_LAUNCHES
    if acc.device.type != "cuda" or stats.device != acc.device:
        raise ValueError(f"the CUDA combine needs CUDA tensors on one device, got {acc.device} and {stats.device}")
    if acc.dim() != 4 or acc.shape[2] != N_TASKS or tuple(stats.shape) != (*acc.shape[:2], 2, N_TASKS):
        raise ValueError(f"need acc [S, B, 2, H] and stats [S, B, 2, 2], got {tuple(acc.shape)} and {tuple(stats.shape)}")
    if acc.dtype != torch.float32 or stats.dtype != torch.float32:
        raise TypeError("partials are float32")
    s_, b_, _, h_dim = acc.shape
    if s_ == 0 or b_ == 0 or h_dim % 32:
        raise ValueError(f"empty partials or H % 32 != 0: {tuple(acc.shape)}")
    acc, stats = acc.contiguous(), stats.contiguous()
    dev = acc.device
    lib = _build.load_library()
    m = torch.empty((b_, N_TASKS, h_dim), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = lib.toad_pool_combine_shards(
            acc.data_ptr(), stats.data_ptr(), s_, b_, h_dim, m.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib, "shard combine kernel")
    COMBINE_LAUNCHES += 1
    return m


def library_launches() -> int:
    """Kernel launches the library's pooling entry points (``csrc/pool.cu``:
    K1, K1p, the sharded pool and the cross-shard combine) have made in this
    process: what a profiler would count, from the library's own side."""
    return int(_build.load_library().toad_pool_launches())


def smem_bytes(compute_dtype: torch.dtype, h_dim: int, a_dim: int) -> int:
    """Dynamic shared memory one block of the kernel takes, as the library
    computes it (:func:`plan`'s ``smem`` must agree)."""
    return int(_build.load_library().toad_pool_smem_bytes(_DTYPE_CODE[compute_dtype], h_dim, a_dim))


def flops_per_row(d: int, h_dim: int, a_dim: int) -> int:
    """Multiply-add FLOPs the kernel spends on one row (GEMMs and scores)."""
    return 2 * (d * h_dim + h_dim * h_dim + h_dim * 2 * a_dim + a_dim * N_TASKS + N_TASKS * h_dim)

