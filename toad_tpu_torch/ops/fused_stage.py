"""A BN-folded ResNet bottleneck stage, fused: the kernel ``csrc/stage.cu``
(KS), its plain version and its wrapper.

PyTorch counterpart of ``experiments/pallas_stage_fusion.py`` (``fused_stage``
and the TPU kernel ``_make_stage_kernel`` behind ``_stage_call``). Per image,
each block computes, at the probe's rounding points (``:81-97``)::

    h1  = relu(x . w1 + b1)                       # f32 accumulate, rounded to T
    h2  = relu(conv3x3_s(h1) + b2)                # 9 tap products, f32; rounded
    out = relu(h2 . w3 + b3 + skip)               # all f32, rounded once

with ``skip = x`` or ``x[::s, ::s] . wd + bd``. These differ from the
encoder's own blocks (:mod:`toad_tpu_torch.models.resnet_encoder`), which
round each conv to T and add its bias in T, as the JAX encoder does.

Activations are NHWC ``[B, H, W, C]``, as the probe takes them (a
``channels_last`` NCHW tensor of the encoder, permuted, is such a tensor
without a copy). A CUDA tensor goes to the kernel, one launch per block, and
anything the kernel does not take raises; a CPU tensor goes to
:func:`plain_stage`. Nothing else chooses between them. Like the probe, this
is not wired into the encoder: ``featurize`` runs its convs through cuDNN.
"""

from __future__ import annotations

import functools
import weakref
from typing import NamedTuple

import torch
from torch import nn

from toad_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches in this process (one per bottleneck block)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ELEM = {torch.float32: 4, torch.bfloat16: 2}
WIDTHS = (64, 128, 256)  # the truncated ResNet-50's stage widths
IN_CHANNELS = (64, 256, 512, 1024)

# What csrc/stage.cu's instances take: the depth of a staged chunk and the
# columns of a GEMM pass (kKC, kNB), a CTA's dynamic shared memory (kSmemMax),
# the halo rows its phase-1 accumulator holds (kRows1Bf16, kRows1F32), the
# output pixels a CTA of its phase-2/3 instances, and the cp.async ring's slots.
CHUNK = 64
SMEM_MAX = 232_448
PASS_ROWS_MAX = {torch.bfloat16: 192, torch.float32: 160}
TILE_PIXELS = {torch.bfloat16: (16, 32, 64, 128), torch.float32: (16, 32, 64)}
MAX_STAGES = 4


class StagePlan(NamedTuple):
    """How KS cuts one block: a CTA computes a ``th`` x ``tw`` tile of output
    pixels, the tile's input halo of ``halo`` rows (padded to 16) runs phase 1
    in passes of at most ``rows`` rows, the weights stream through a ring of
    ``stages`` cp.async slots, and the CTA takes ``smem`` bytes of shared
    memory."""

    th: int
    tw: int
    halo: int
    rows: int
    stages: int
    smem: int

    @property
    def passes(self) -> int:
        return -(-self.halo // self.rows)

    def tiles(self, ho: int, wo: int) -> tuple[int, int]:
        """The CTAs a launch has for each image of an ho x wo output map: (rows, columns) of tiles."""
        return -(-ho // self.th), -(-wo // self.tw)

    def __str__(self) -> str:
        return (f"{self.th}x{self.tw} px, {self.passes} pass{'es' if self.passes > 1 else ''} of <= {self.rows} of "
                f"{self.halo} halo rows, {self.stages} slots, {self.smem} B")


# (th, tw, rows, stages) by (width, stride), chosen by timing plans against
# each other on the card (chip_smoke.py --stage-ab; PERF.md §6). bf16: 128
# output pixels a CTA in layer2-3, but 64 at layer3's stride 2, whose 8x16
# halo would not fit; layer1 keeps the first kernel's 8x8. Two ring slots
# where the bytes of a third buy a second CTA an SM or fewer halo passes,
# three where they buy nothing else. f32: the first kernel's tiles (the
# largest of 8x8, 4x8, 4x4 whose halo the f32 accumulator holds and whose
# shared memory in its layout left two CTAs an SM, else the smallest that
# fit), in one pass through a ring of 2 slots.
_PLANS = {
    torch.bfloat16: {(64, 1): (8, 8, 112, 2), (64, 2): (8, 8, 192, 2), (128, 1): (8, 16, 64, 2),
                     (128, 2): (8, 16, 128, 2), (256, 1): (8, 16, 192, 3), (256, 2): (8, 8, 128, 2)},
    torch.float32: {(64, 1): (4, 8, 64, 2), (64, 2): (4, 4, 96, 2), (128, 1): (4, 4, 48, 2),
                    (128, 2): (4, 4, 96, 2), (256, 1): (4, 4, 48, 2), (256, 2): (4, 4, 96, 2)},
}


def halo_rows(th: int, tw: int, stride: int) -> int:
    """The input pixels a th x tw output tile's 3x3 conv reads, padded to 16 rows."""
    m1 = (stride * (th - 1) + 3) * (stride * (tw - 1) + 3)
    return -(-m1 // 16) * 16


def plan_bytes(compute_dtype: torch.dtype, width: int, stride: int, th: int, tw: int, rows: int, stages: int) -> int:
    """A CTA's shared memory under a plan, stage.cu's ``layout``: h1 (in phase 3
    the downsample's A ring or the identity's two skip tiles, and an output
    tile), h2 (in phase 1 its A ring), the weights' ring, then the halo,
    subsample and output offsets as int32. Rows are padded by 16 bytes."""
    elem = _ELEM[compute_dtype]
    pad = 16 // elem
    m1p, m2 = halo_rows(th, tw, stride), th * tw
    r1 = max(m1p * (width + pad), (stages + 1) * m2 * (CHUNK + pad))
    r2 = max(m2 * (width + pad), stages * rows * (CHUNK + pad))
    ring = stages * CHUNK * (CHUNK + pad)
    return elem * (r1 + r2 + ring) + 4 * (m1p + 2 * m2)


@functools.lru_cache(maxsize=None)
def plan(compute_dtype: torch.dtype, width: int, stride: int) -> StagePlan:
    """The plan KS launches a block of this width and stride with."""
    th, tw, rows, stages = _PLANS[compute_dtype][(width, stride)]
    return StagePlan(th, tw, halo_rows(th, tw, stride), rows, stages,
                     plan_bytes(compute_dtype, width, stride, th, tw, rows, stages))


def check_plan(p: StagePlan, compute_dtype: torch.dtype, width: int, stride: int) -> None:
    """Raises ValueError for a plan the kernel refuses (stage.cu's ``launch_block``)."""
    want = plan_bytes(compute_dtype, width, stride, p.th, p.tw, p.rows, p.stages)
    fault = None
    if p.th < 1 or p.tw < 1 or p.th * p.tw not in TILE_PIXELS[compute_dtype]:
        fault = f"a tile of {TILE_PIXELS[compute_dtype]} pixels"
    elif p.rows < 16 or p.rows % 16 or p.rows > PASS_ROWS_MAX[compute_dtype]:
        fault = f"passes of a multiple of 16 rows up to {PASS_ROWS_MAX[compute_dtype]}"
    elif not 2 <= p.stages <= MAX_STAGES:
        fault = f"2 to {MAX_STAGES} slots"
    elif p.halo != halo_rows(p.th, p.tw, stride) or p.smem != want:
        fault = f"the halo and shared memory of its layout ({halo_rows(p.th, p.tw, stride)} rows, {want} B)"
    elif want > SMEM_MAX:
        fault = f"at most {SMEM_MAX} B of shared memory"
    if fault is not None:
        raise ValueError(f"fused_stage: no {str(compute_dtype)[6:]} kernel instance takes the plan {p} at width "
                         f"{width}, stride {stride}: it needs {fault}")


class BlockOperands(NamedTuple):
    """One block's weights in the kernel's layout (the probe's
    ``_stage_weights``): [in, out] matrices and the 3x3 kernel as 9 taps in
    (dy, dx) row-major order, in the compute dtype; biases f32."""

    w1: torch.Tensor  # [Cin, w]
    b1: torch.Tensor  # [w]
    w2: torch.Tensor  # [9, w, w]
    b2: torch.Tensor  # [w]
    w3: torch.Tensor  # [w, 4w]
    b3: torch.Tensor  # [4w]
    wd: torch.Tensor | None  # [Cin, 4w]
    bd: torch.Tensor | None  # [4w]


_CACHE: "weakref.WeakKeyDictionary[nn.Module, dict]" = weakref.WeakKeyDictionary()


def _pack_block(blk: nn.Module, dt: torch.dtype) -> BlockOperands:
    def mat(conv) -> torch.Tensor:  # [out, in, 1, 1] -> [in, out]
        return conv.weight.detach()[:, :, 0, 0].t().to(dt).contiguous()

    def bias(conv) -> torch.Tensor:
        return conv.bias.detach().float().contiguous()

    w2 = blk.conv2.weight.detach()  # [out, in, 3, 3] -> [3, 3, in, out] -> [9, in, out]
    taps = w2.permute(2, 3, 1, 0).reshape(9, w2.shape[1], w2.shape[0]).to(dt).contiguous()
    ds = blk.downsample[0] if blk.downsample is not None else None
    return BlockOperands(mat(blk.conv1), bias(blk.conv1), taps, bias(blk.conv2), mat(blk.conv3), bias(blk.conv3),
                         mat(ds) if ds is not None else None, bias(ds) if ds is not None else None)


def stage_weights(stage: nn.Module, compute_dtype: torch.dtype) -> list[BlockOperands]:
    """A BN-folded stage of :class:`~toad_tpu_torch.models.resnet_encoder.ResNetEncoder`
    (``encoder.layer1`` ...) -> its blocks' operands, cast once per compute
    dtype and again when a weight moves or changes in place."""
    if any(blk.bn1 is not None for blk in stage):
        raise ValueError("fused_stage needs BN-folded weights: call the encoder's fold_bn() first")
    key = tuple((p.device, p.data_ptr(), p._version) for p in stage.parameters())
    per_stage = _CACHE.setdefault(stage, {})
    hit = per_stage.get(compute_dtype)
    if hit is None or hit[0] != key:
        hit = (key, [_pack_block(blk, compute_dtype) for blk in stage])
        per_stage[compute_dtype] = hit
    return hit[1]


def _subsample(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Rows and columns 0, s, 2s, ... of [B, H, W, C] (the probe's ``_subsample2``)."""
    return x if stride == 1 else x[:, ::stride, ::stride, :]


def plain_block(ops: BlockOperands, x: torch.Tensor, stride: int) -> torch.Tensor:
    """One block at the kernel's rounding points, in PyTorch. Products of
    compute-dtype values are exact in f32, so f32 products of the widened
    operands are the probe's ``preferred_element_type=float32`` dots."""
    dt = x.dtype
    b, h, w, _ = x.shape
    ho, wo = h // stride, w // stride
    width = ops.w1.shape[1]
    h1 = torch.relu(x.float() @ ops.w1.float() + ops.b1).to(dt)
    h1p = torch.nn.functional.pad(h1, (0, 0, 1, 1, 1, 1)).float()  # zero halo around h1, not h1 of a padded x
    acc = None
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        window = _subsample(h1p[:, dy:dy + h, dx:dx + w, :], stride)
        part = window.reshape(b, ho, wo, width) @ ops.w2[tap].float()
        acc = part if acc is None else acc + part
    h2 = torch.relu(acc + ops.b2).to(dt)
    h3 = h2.float() @ ops.w3.float() + ops.b3
    if ops.wd is not None:
        skip = _subsample(x, stride).float() @ ops.wd.float() + ops.bd
    else:
        skip = x.float()
    return torch.relu(h3 + skip).to(dt)


def check_block(ops: BlockOperands, x: torch.Tensor, stride: int) -> None:
    """Raises ValueError, naming the shape, for a block the kernel does not take."""
    cin, width = ops.w1.shape
    cout = ops.w3.shape[1]
    shape = f"x {tuple(x.shape)}, Cin {cin}, width {width}, Cout {cout}, stride {stride}"
    if x.dim() != 4 or x.shape[3] != cin or min(x.shape) < 1:
        raise ValueError(f"fused_stage: x must be [B, H, W, Cin={cin}] and not empty: {shape}")
    if width not in WIDTHS or cout != 4 * width or cin not in IN_CHANNELS or stride not in (1, 2):
        raise ValueError(f"fused_stage: no kernel instance for {shape} (widths {WIDTHS}, Cout = 4 x width, "
                         f"Cin in {IN_CHANNELS}, stride 1 or 2: the truncated ResNet-50's blocks)")
    if ops.wd is None and (stride != 1 or cin != cout):
        raise ValueError(f"fused_stage: an identity skip needs stride 1 and Cin == Cout: {shape}")
    if x.shape[1] % stride or x.shape[2] % stride:
        raise ValueError(f"fused_stage: the map's sides must be multiples of the stride: {shape}")
    if x.shape[0] > 65535:
        raise ValueError(f"fused_stage: at most 65,535 images a launch: {shape}")


def stage_block(ops: BlockOperands, x: torch.Tensor, stride: int, tile_plan: StagePlan | None = None) -> torch.Tensor:
    """Launch KS for one block: x [B, H, W, Cin] on a CUDA device in the
    operands' dtype -> [B, H/s, W/s, Cout], under ``tile_plan`` (default:
    :func:`plan`; another is for timing plans against each other)."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA stage kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE or x.dtype != ops.w1.dtype:
        raise TypeError(f"x dtype {x.dtype} must be float32 or bfloat16 and match the weights' {ops.w1.dtype}")
    check_block(ops, x, stride)
    b, h, w, cin = x.shape
    width, cout = ops.w1.shape[1], ops.w3.shape[1]
    p = plan(x.dtype, width, stride) if tile_plan is None else tile_plan
    check_plan(p, x.dtype, width, stride)
    x = x.contiguous()
    out = torch.empty((b, h // stride, w // stride, cout), device=x.device, dtype=x.dtype)
    tensors = [x, out, *(t for t in ops if t is not None)]
    if any(t.device != x.device for t in tensors):
        raise ValueError("the stage's weights and x must be on the same device")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("kernel operands must be 16-byte aligned")
    lib = _build.load_library()
    ptr = [t.data_ptr() if t is not None else None for t in ops]
    with torch.cuda.device(x.device):
        err = lib.toad_stage_block_forward(
            _DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(), b, h, w, cin, width, cout, stride,
            p.th, p.tw, p.rows, p.stages, p.smem, *ptr, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stage kernel launch failed for x {tuple(x.shape)}, width {width}, Cout {cout}, stride "
                           f"{stride}, plan {p}: CUDA error {err} ({lib.toad_cuda_error_string(err).decode()})")
    LAUNCHES += 1
    return out


def _blocks(stage: nn.Module, x: torch.Tensor, first_stride: int, compute_dtype: torch.dtype):
    ops = stage_weights(stage, compute_dtype)
    return [(o, first_stride if i == 0 else 1) for i, o in enumerate(ops)], x.to(compute_dtype)


def plain_stage(stage: nn.Module, x: torch.Tensor, first_stride: int = 1,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain version of :func:`fused_stage`: the CPU path, and what the
    kernel is held against on the card."""
    blocks, x = _blocks(stage, x, first_stride, compute_dtype)
    for ops, stride in blocks:
        x = plain_block(ops, x, stride)
    return x


@torch.no_grad()
def fused_stage(stage: nn.Module, x: torch.Tensor, *, first_stride: int = 1,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Run one BN-folded bottleneck stage fused, block by block: ``stage`` is
    the encoder's ``layerN`` after ``fold_bn()``, ``x`` [B, H, W, Cin] ->
    [B, H/s, W/s, Cout] in the compute dtype."""
    blocks, x = _blocks(stage, x, first_stride, compute_dtype)
    if x.device.type == "cuda":
        for ops, stride in blocks:
            x = stage_block(ops, x, stride)
        return x
    if x.device.type != "cpu":
        raise ValueError(f"no stage path for device {x.device} (cuda or cpu)")
    for ops, stride in blocks:
        x = plain_block(ops, x, stride)
    return x


def block_work(ops: BlockOperands, x_shape: tuple, stride: int) -> tuple[int, int]:
    """(operations, bytes) one block needs at the least: the products of its
    convs at their own resolution (conv1 at the input's, the rest at the
    output's), and x, out and the operands each moved once."""
    b, h, w, cin = x_shape
    width, cout = ops.w1.shape[1], ops.w3.shape[1]
    p_in, p_out = b * h * w, b * (h // stride) * (w // stride)
    flops = 2 * p_in * cin * width + 2 * p_out * (9 * width * width + width * cout)
    if ops.wd is not None:
        flops += 2 * p_out * cin * cout
    elem = ops.w1.element_size()
    moved = elem * (p_in * cin + p_out * cout) + sum(t.numel() * t.element_size() for t in ops if t is not None)
    return flops, moved
