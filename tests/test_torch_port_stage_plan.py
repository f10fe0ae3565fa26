"""The fused stage kernel's plans (``toad_tpu_torch.ops.fused_stage.plan``).

KS (``csrc/stage.cu``) launches each bottleneck block under a plan computed in
Python: an output tile a CTA, the halo rows of a phase-1 pass, the cp.async
ring's slots and the shared memory they take. The launcher refuses a plan its
instances do not take, and ``check_plan`` refuses the same before a launch.
These tests hold the plans of the truncated ResNet-50's 13 blocks, at the
256-px and 224-px tiles that featurization sees, to what the kernel needs, and
the f32 plans to the kernel's first tile rule. No card is needed: the plan is
arithmetic.
"""

import pytest
import torch

from toad_tpu_torch.config import EncoderConfig
from toad_tpu_torch.ops import fused_stage as fs

BF16, F32 = torch.bfloat16, torch.float32


def _blocks() -> list[tuple[str, int, int, int]]:
    """(name, Cin, width, stride) of each block of the truncated ResNet-50."""
    cfg = EncoderConfig()
    out, cin = [], cfg.stem_width
    for s, (n, width) in enumerate(zip(cfg.blocks, cfg.stage_widths)):
        for b in range(n):
            out.append((f"layer{s + 1}.{b}", cin, width, 2 if (s > 0 and b == 0) else 1))
            cin = width * cfg.expansion
    return out


BLOCKS = _blocks()
# the block's input map side for a tile of px: the stem and its max-pool take px / 4, each stage's stride the rest
CASES = [pytest.param(blk, px, id=f"{blk[0]}-{px}px") for blk in BLOCKS for px in (256, 224)]


def _in_side(name: str, px: int) -> int:
    stage, block = int(name[5]), int(name.split(".")[1])
    side = px // 4
    for s in range(2, stage + 1):
        side //= 2
    return side * 2 if (stage > 1 and block == 0) else side


def test_the_blocks_are_the_truncated_resnet50s():
    assert len(BLOCKS) == 13
    assert [(c, w, s) for _, c, w, s in BLOCKS if s == 2] == [(256, 128, 2), (512, 256, 2)]
    assert _in_side("layer3.0", 256) == 32 and _in_side("layer3.1", 256) == 16 and _in_side("layer2.0", 224) == 56


@pytest.mark.parametrize("blk,px", CASES)
def test_bf16_plan_gives_layer2_and_3_at_least_64_pixels_a_cta(blk, px):
    name, _, width, stride = blk
    p = fs.plan(BF16, width, stride)
    pixels = p.th * p.tw
    if name.startswith("layer1"):
        assert (p.th, p.tw) == (8, 8)  # layer1 keeps the first kernel's tile
    else:
        assert pixels >= 64
        if stride == 1:
            assert pixels == 128


@pytest.mark.parametrize("dt", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("blk,px", CASES)
def test_plan_shared_memory_fits_a_cta_and_matches_its_layout(blk, px, dt):
    _, _, width, stride = blk
    p = fs.plan(dt, width, stride)
    assert p.smem <= fs.SMEM_MAX == 232_448
    assert p.smem == fs.plan_bytes(dt, width, stride, p.th, p.tw, p.rows, p.stages)
    fs.check_plan(p, dt, width, stride)


@pytest.mark.parametrize("dt", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("blk,px", CASES)
def test_halo_passes_fit_the_phase1_accumulator_and_cover_the_halo(blk, px, dt):
    _, _, width, stride = blk
    p = fs.plan(dt, width, stride)
    assert p.halo == fs.halo_rows(p.th, p.tw, stride) >= (stride * (p.th - 1) + 3) * (stride * (p.tw - 1) + 3)
    assert p.rows % 16 == 0 and 16 <= p.rows <= fs.PASS_ROWS_MAX[dt]
    sizes = [min(p.rows, p.halo - r0) for r0 in range(0, p.halo, p.rows)]
    assert len(sizes) == p.passes and sum(sizes) == p.halo and all(0 < n <= p.rows and n % 16 == 0 for n in sizes)


@pytest.mark.parametrize("blk,px", CASES)
def test_tiles_cover_the_output_map(blk, px):
    name, _, width, stride = blk
    side = _in_side(name, px) // stride
    for dt in (BF16, F32):
        p = fs.plan(dt, width, stride)
        ty, tx = p.tiles(side, side)
        assert (ty - 1) * p.th < side <= ty * p.th and (tx - 1) * p.tw < side <= tx * p.tw
    if px == 224 and name.startswith("layer3"):  # 14 x 14: the bf16 tiles' last row and column are ragged
        p = fs.plan(BF16, width, stride)
        assert side == 14 and side % p.th and side % p.tw


def _first_choose_tile(elem: int, width: int, stride: int) -> tuple[int, int]:
    """The first kernel's ``choose_tile`` (csrc/stage.cu), written out: the largest of
    8x8, 4x8, 4x4 whose halo fits 160 register rows and whose shared memory
    (h1, h2, two A and two B slots, the offsets) leaves room for two CTAs an
    SM, else the smallest that fits at all."""
    pad = 16 // elem
    found = None
    for th, tw in ((8, 8), (4, 8), (4, 4)):
        m1p = -(-((stride * (th - 1) + 3) * (stride * (tw - 1) + 3)) // 16) * 16
        m2 = th * tw
        if m1p > 160:
            continue
        els = (m1p + m2) * (width + pad) + 2 * m1p * (64 + pad) + 2 * 64 * (64 + pad)
        smem = els * elem + 4 * (m1p + 2 * m2)
        if smem <= 112_640:
            return th, tw
        if smem <= 232_448:
            found = (th, tw)
    return found


@pytest.mark.parametrize("width", fs.WIDTHS)
@pytest.mark.parametrize("stride", [1, 2])
def test_f32_plan_keeps_the_first_tiles_in_one_pass(width, stride):
    p = fs.plan(F32, width, stride)
    assert (p.th, p.tw) == _first_choose_tile(4, width, stride)
    assert p.passes == 1 and p.stages == 2


@pytest.mark.parametrize("width,stride,smem", [(128, 2, 167_360), (128, 1, 158_464), (256, 2, 223_680),
                                               (256, 1, 198_400)])
def test_plan_bytes_match_the_layout_arithmetic(width, stride, smem):
    """The shared memory of the 64- and 128-pixel plans at 128-row passes
    (64 at layer3's stride 2) and three slots, worked out by hand: h1, or the
    downsample's A ring and an output tile (4 x 128 rows outgrow h1's 192 rows
    at width 128), then h2 or phase 1's A ring, the weights' ring, the int
    offsets."""
    th, tw = (8, 8) if stride == 2 else (8, 16)
    rows = 64 if (width, stride) == (256, 2) else 128
    assert fs.plan_bytes(BF16, width, stride, th, tw, rows, 3) == smem


def _bad(dt, width, stride, **change):
    p = fs.plan(dt, width, stride)._replace(**change)
    return p._replace(smem=fs.plan_bytes(dt, width, stride, p.th, p.tw, p.rows, p.stages)) if "smem" not in change \
        else p


@pytest.mark.parametrize("case", ["pixels", "f32_128_pixels", "rows_not_16", "rows_past_accumulator",
                                  "one_slot", "five_slots", "smem_not_layout", "smem_past_limit", "halo"])
def test_wrapper_refuses_what_the_kernel_refuses(case):
    dt, width, stride = {"f32_128_pixels": (F32, 128, 1), "rows_past_accumulator": (F32, 256, 2),
                         "smem_past_limit": (BF16, 256, 2)}.get(case, (BF16, 128, 1))
    p = {
        "pixels": lambda: _bad(dt, width, stride, th=16, tw=16),
        "f32_128_pixels": lambda: _bad(dt, width, stride, th=8, tw=16, halo=192, rows=160),
        "rows_not_16": lambda: _bad(dt, width, stride, rows=100),
        "rows_past_accumulator": lambda: _bad(dt, width, stride, rows=176),
        "one_slot": lambda: _bad(dt, width, stride, stages=1),
        "five_slots": lambda: _bad(dt, width, stride, stages=5),
        "smem_not_layout": lambda: _bad(dt, width, stride, smem=fs.plan(dt, width, stride).smem - 16),
        "smem_past_limit": lambda: _bad(dt, width, stride, rows=192),
        "halo": lambda: _bad(dt, width, stride, halo=176),
    }[case]()
    with pytest.raises(ValueError, match="no .* kernel instance takes the plan"):
        fs.check_plan(p, dt, width, stride)
    fs.check_plan(fs.plan(dt, width, stride), dt, width, stride)  # the default plan is taken

