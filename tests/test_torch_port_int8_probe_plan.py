"""The int8 pooling probe's plan (``toad_tpu_torch.ops.probe_pool_int8``).

P3/P4 (``csrc/pool_int8_probe.cu``) run K2's pass: 64-row tiles of 8 warps,
the weights one stream of 32 KB slices a tile through K2's 3-slot swizzled
ring, the grid in whole waves of one CTA an SM. ``plan``, ``layout``,
``stream_schedule`` and ``split`` mirror the kernel (``chip_smoke.py`` phase
2 asserts that the library's shared memory agrees on the card): the layout
is K2's with Wc and the running sums moved to device memory and room for 8
task columns' scores, the same at every A; each variant's stream stages
every weight byte once in the order its GEMMs consume it. No card is
needed.
"""

import numpy as np
import pytest

from toad_tpu_torch.ops import cuda_pool, cuda_pool_int8 as k2, probe_pool_int8 as p8

N_SMS = 132  # the H100's SMs
A_DIMS = [128, 256, 384]


def test_plan_at_toad_width_fits_one_cta():
    """K2's rings (3 x 32 KB weight slots, 3 x 4 KB x slots), h1q/h2q 64 x 528
    B, h2 64 x 520 bf16, and 13,664 B for the row scales, the column warps'
    amax and partial scores of 8 tasks, s and e [64][8] and the statistics:
    under the card's 232,448 B, where K2's layout with Wc [A][8] in f32 and
    the 8-task scratch would not fit."""
    p = p8.plan(384)
    assert p == p8.Int8ProbePlan(64, 256, 3, 224_608)
    assert 3 * 32_768 + 3 * 4_096 + 33_792 + 66_560 + 13_664 == p.smem <= cuda_pool.MAX_SMEM
    assert p.smem + 4 * 8 * 384 > cuda_pool.MAX_SMEM  # Wc [A][8] in f32 beside it would not fit


@pytest.mark.parametrize("a_dim", A_DIMS)
def test_plan_is_k2s_tile_at_every_width(a_dim):
    p, kp = p8.plan(a_dim), k2.plan(a_dim)
    assert (p.rows, p.threads, p.slots) == (kp.rows, kp.threads, kp.slots) == (64, 256, 3)
    assert p.smem == p8.plan(384).smem <= cuda_pool.MAX_SMEM  # A does not enter: Wc stays in device memory


@pytest.mark.parametrize("a_dim", [0, 100, 640, 1024])
def test_plan_refuses_widths_the_kernel_does_not_take(a_dim):
    with pytest.raises(ValueError, match=f"A={a_dim} not supported by the int8 probe kernel"):
        p8.plan(a_dim)


def test_plan_refuses_a_layout_over_shared_memory(monkeypatch):
    """A fourth ring slot would not fit: 224,608 + 32,768 + 4,096 B."""
    monkeypatch.setattr(k2, "RING_SLOTS", 4)
    with pytest.raises(ValueError, match="261472 B of shared memory with 4 ring slots"):
        p8.plan(384)


@pytest.mark.parametrize("a_dim", A_DIMS)
def test_regions_do_not_overlap(a_dim):
    """Every region has bytes of its own, 16-byte aligned; the swizzled rings
    start on 1 KB; the last region ends at the plan's shared memory; the x
    tile quantized in the kernel, 64 rows of D + 16 bytes at D = 1,024, fills
    h2's region exactly."""
    lay = p8.layout()
    regions = sorted(lay.values())
    for (o1, s1), (o2, _) in zip(regions, regions[1:]):
        assert o1 + s1 <= o2
    assert all(o % 16 == 0 for o, _ in regions)
    assert lay["ws"][0] % 1024 == 0 and lay["xs"][0] % 1024 == 0
    assert regions[-1][0] + regions[-1][1] == p8.plan(a_dim).smem
    assert lay["h2"][1] == k2.ROWS * (1024 + 16)
    assert {k: v[1] for k, v in lay.items() if k in k2.layout(a_dim)} == {
        k: v[1] for k, v in k2.layout(a_dim).items() if k in ("ws", "xs", "act", "h2", "rs", "amax")} | {
        k: 4 * v[1] for k, v in k2.layout(a_dim).items() if k in ("spart", "s", "e")} | {"stat": 96}


@pytest.mark.parametrize("a_dim", A_DIMS)
@pytest.mark.parametrize("variant", p8.VARIANTS)
def test_stream_stages_every_weight_byte_once_in_the_order_consumed(variant, a_dim):
    """Each tile's stream covers W1 (int8 [512, D], or bf16 [512, 2D bytes]
    for int8_h_only), W2 [512, 512] and the interleaved [Wa|Wb] [2A, 512]
    exactly once, every slice filling a slot, GEMM by GEMM over k; the x
    tile's bytes ride along with W1's slices once (int8: D bytes a row;
    h_only: 2D), and not at all where x is quantized in the kernel."""
    d = 1024
    sched = p8.stream_schedule(variant, d, a_dim)
    w1_bytes = 2 * d if variant == "int8_h_only" else d
    shapes = {"w1": (512, w1_bytes), "w2": (512, 512), "wab": (2 * a_dim, 512)}
    seen = {name: np.zeros(shape, np.int32) for name, shape in shapes.items()}
    x_seen = np.zeros(w1_bytes, np.int32)
    for gemm, n0, k0, rows, depth, x_bytes in sched:
        assert rows * depth == k2.SLOT_BYTES
        seen[gemm][n0:n0 + rows, k0:k0 + depth] += 1
        assert x_bytes in (0, depth) and (gemm == "w1" or x_bytes == 0)
        x_seen[k0:k0 + x_bytes] += 1
    assert all((count == 1).all() for count in seen.values())
    assert (x_seen == (0 if variant in ("int8_inquant", "int8_inquant_bf16") else 1)).all()
    order = {"w1": 0, "w2": 1, "wab": 2}
    assert sched == sorted(sched, key=lambda s: (order[s[0]], s[1], s[2]))
    assert len(sched) == w1_bytes // 64 + 8 + (2 * a_dim // 256) * 4
    # past W1, every variant stages K2's own slices
    assert [s[:5] for s in sched if s[0] != "w1"] == [s for s in k2.stream_schedule(d, a_dim) if s[0] != "w1"]


def test_stream_refuses_an_unknown_variant():
    with pytest.raises(ValueError, match="unknown int8 probe variant"):
        p8.stream_schedule("int8_nosuch", 1024, 384)


@pytest.mark.parametrize("b,n,want", [
    (32, 8192, (32, 4)),  # the probes' shape: 128 CTAs of 32 tiles, one wave
    (4, 4096, (2, 32)),
    (2, 4160, (1, 65)),
    (1, 131072, (16, 128)),
])
def test_grid_is_whole_waves(b, n, want):
    """The grid runs in whole waves of one CTA an SM (132 on an H100), the
    fewest tile-times first, then the fewest splits, as K2's; split_plan's
    several blocks an SM took as many tile-times or more."""
    per, splits = p8.split(b, n, N_SMS)
    assert (per, splits) == want == cuda_pool.wave_split_plan(b, n, k2.ROWS, N_SMS)
    tiles = n // 64
    assert per * (splits - 1) < tiles <= per * splits
    cost = -(-b * splits // N_SMS) * per
    assert cost == min(-(-b * s // N_SMS) * -(-tiles // s) for s in range(1, tiles + 1))
    per0, splits0 = cuda_pool.split_plan(b, n, k2.ROWS, N_SMS)
    assert -(-b * splits0 // N_SMS) * per0 >= cost
