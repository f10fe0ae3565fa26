"""The pooling kernel's plans (``toad_tpu_torch.ops.cuda_pool``).

K1 (``csrc/pool.cu``) runs its bf16 instance on 128-row tiles with 8 warps
of 64 x 64 warp tiles, h1 and h2 in one shared region, and its f32 instance on the first
kernel's 32-row tiles. ``plan`` gives each instance's rows, threads, ring
slots and shared memory as the library computes them (``chip_smoke.py``
phase 2 asserts that the two agree on the card), and refuses a width whose
layout does not fit a CTA. The bf16 grid fills whole waves of one CTA an SM
(``wave_split_plan``); the f32 instance, K2 and the probes keep
``split_plan``. No card is needed: the plans are arithmetic.
"""

import pytest
import torch

from toad_tpu_torch.ops import _build, cuda_pool

BF16, F32 = torch.bfloat16, torch.float32
N_SMS = 132  # the H100's SMs
SHAPES = [(1, 65536), (32, 8192), (4, 29568), (1, 40960), (2, 100), (3, 129)]


def _tiles(n: int, rows: int) -> int:
    return -(-n // rows)


def _cost(b: int, splits: int, per: int) -> int:
    """Tile-times of a grid of b * splits one-CTA-an-SM blocks of up to per tiles."""
    return -(-b * splits // N_SMS) * per


@pytest.mark.parametrize("h_dim,a_dim", [(512, 384), (512, 256), (256, 128)])
def test_bf16_plan_runs_128_rows_within_shared_memory(h_dim, a_dim):
    p = cuda_pool.plan(BF16, h_dim, a_dim)
    assert (p.rows, p.threads) == (128, 256)
    assert p.slots >= 2
    assert p.smem <= cuda_pool.MAX_SMEM == 232_448
    region = 2 * p.rows * (h_dim + 8)  # h1, then h2: one bf16 region of 128 rows
    assert region < p.smem < 2 * region + 2 * p.slots * 256 * 40  # one region beside the weight ring, not two


@pytest.mark.parametrize("h_dim", [768, 1024])
def test_bf16_plan_refuses_widths_whose_layout_does_not_fit(h_dim):
    with pytest.raises(ValueError, match=f"H={h_dim} not supported in bfloat16"):
        cuda_pool.plan(BF16, h_dim, 384)


def _operands(h_dim: int, a_dim: int, d: int, dtype: torch.dtype) -> cuda_pool.PoolOperands:
    def w(*shape):
        return torch.zeros(*shape, dtype=dtype)

    def b(n):
        return torch.zeros(n, dtype=torch.float32)

    return cuda_pool.PoolOperands(w(h_dim, d), b(h_dim), w(h_dim, h_dim), b(h_dim), w(2 * a_dim, h_dim),
                                  b(2 * a_dim), w(a_dim, 2), b(2))


@pytest.mark.parametrize("h_dim", [768, 1024])
def test_wrapper_refuses_those_widths_before_building(h_dim):
    ops = _operands(h_dim, 384, 64, BF16)
    x, mask = torch.zeros(1, 8, 64), torch.ones(1, 8)
    for call in (lambda: cuda_pool.pool(ops, x, mask, True), lambda: cuda_pool.pool_partial(ops, x, mask)):
        with pytest.raises(ValueError, match=f"H={h_dim} not supported in bfloat16"):
            call()
    assert not _build.is_loaded()


@pytest.mark.parametrize("h_dim,a_dim,smem", [(512, 384, 178_848), (512, 256, 177_824), (256, 128, 109_216)])
def test_f32_plan_is_the_first_kernels(h_dim, a_dim, smem):
    """32-row tiles, 8 warps, staged synchronously: h1 and h2 [32][H + 8],
    one 256 x 33 weight slice, one 32 x 33 x slice, Wc, s, e, acc, stats."""
    assert cuda_pool.plan(F32, h_dim, a_dim) == cuda_pool.PoolPlan(32, 256, 1, smem)


@pytest.mark.parametrize("b,n", SHAPES)
def test_wave_split_plan_covers_every_tile_once(b, n):
    per, splits = cuda_pool.wave_split_plan(b, n, 128, N_SMS)
    n_tiles = _tiles(n, 128)
    assert per * splits >= n_tiles > per * (splits - 1)  # every tile once, no empty split


@pytest.mark.parametrize("b,n", SHAPES)
def test_wave_split_plan_fills_whole_waves(b, n):
    """At these shapes the grid runs the fair share, ceil(tiles / SMs) tiles
    a CTA, in whole waves of 132 (one wave where the tiles fit in one)."""
    per, splits = cuda_pool.wave_split_plan(b, n, 128, N_SMS)
    tiles = b * _tiles(n, 128)
    assert _cost(b, splits, per) == max(1, -(-tiles // N_SMS))
    if tiles >= N_SMS:
        assert b * splits <= N_SMS


@pytest.mark.parametrize("b,n", [(32, 8320), (3, 12800), (7, 1000), (200, 300), (1, 1_000_000)])
def test_wave_split_plan_is_the_fewest_tile_times(b, n):
    """Against every split count: no plan runs fewer tile-times, and none
    with as few has fewer splits."""
    per, splits = cuda_pool.wave_split_plan(b, n, 128, N_SMS)
    n_tiles = _tiles(n, 128)
    costs = {s: _cost(b, s, -(-n_tiles // s)) for s in range(1, n_tiles + 1)}
    assert _cost(b, splits, per) == min(costs.values())
    assert splits == min(s for s, c in costs.items() if c == costs[splits])


def test_default_split_plans_by_instance():
    """The bf16 instance takes whole waves; f32 keeps split_plan, as K2 and
    the probes do (each calls it with its own row tile)."""
    assert cuda_pool._splitter(BF16) is cuda_pool.wave_split_plan
    assert cuda_pool._splitter(F32) is cuda_pool.split_plan
    assert cuda_pool.split_plan(1, 40960, 64, N_SMS) == (2, 320)  # several blocks an SM, as before


def test_fixed_split_plan_takes_2048_rows_at_the_128_row_tile():
    rows = cuda_pool.plan(BF16, 512, 384).rows
    assert cuda_pool.fixed_split_plan(131072, rows, 2048) == (16, 64)


@pytest.mark.parametrize("rows_per_split", [64, 0, 2000])
def test_fixed_split_plan_refuses_what_is_no_multiple_of_the_tile(rows_per_split):
    rows = cuda_pool.plan(BF16, 512, 384).rows
    with pytest.raises(ValueError, match="multiple of the kernel's 128-row tile"):
        cuda_pool.fixed_split_plan(131072, rows, rows_per_split)
