"""The pooling kernel's plans (``toad_tpu_torch.ops.cuda_pool``).

K1 (``csrc/pool.cu``) runs its bf16 instance on 128-row tiles with 8 warps
as two warpgroups of 64 rows on bf16 wgmma m64n256k16, and its f32 instance
on 64-row tiles with 8 warps as two warpgroups of H/2 columns on tf32 wgmma,
each instance with h1 and h2 in one shared region; the f32 products are
3xTF32 (each operand split into two TF32 halves). ``plan`` gives each
instance's rows, threads, ring slots and shared memory as the library
computes them (``chip_smoke.py`` phase 2 asserts that the two agree on the
card), and refuses a width whose layout does not fit a CTA. Both grids fill
whole waves of one CTA an SM (``wave_split_plan``), as K2's and the probes'
do. No card is needed: the plans are arithmetic, the bf16 instance's
accumulator mapping, ring and panel swizzles are index arithmetic, and the 3xTF32
numerics are modelled here on the CPU.
"""

from collections import Counter

import numpy as np
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


BF16_SMEM = {512: 229_408, 256: 163_872}


@pytest.mark.parametrize("h_dim,a_dim", [(512, 384), (512, 256), (256, 128)])
def test_bf16_plan_runs_128_rows_within_shared_memory(h_dim, a_dim):
    """The bf16 instance's plan: 128-row tiles, 8 warps as two warpgroups of
    64 rows, 4-slot rings. One region of H/32 panels [128][32] for h1 and
    h2, then the weight ring of 4 slots of 256 rows x 32 bf16, both of
    64-byte rows in wgmma's swizzle (no padding) on 1024-byte boundaries; the
    x ring of 4 slots [128][32], which also holds half of GEMM2's stash (32
    packed words a thread), then the scores and e; the stats. The running
    acc is in device memory and Wc too, so A does not change it. Within one
    CTA's shared memory."""
    p = cuda_pool.plan(BF16, h_dim, a_dim)
    assert p == cuda_pool.PoolPlan(128, 256, 4, BF16_SMEM[h_dim])
    assert p.smem <= cuda_pool.MAX_SMEM == 232_448
    parts = cuda_pool.bf16_layout(h_dim)
    assert sum(parts.values()) == p.smem
    region = 2 * p.rows * h_dim  # h1, then h2: one bf16 region of 128 rows, unpadded
    assert parts["h"] == region and region % 1024 == 0  # the swizzle needs 1024-byte alignment of what follows
    assert parts["ring"] == p.slots * 256 * 64 and parts["ring"] % 1024 == 0  # 64-byte rows, whole swizzle atoms
    assert parts["xs"] == p.slots * p.rows * 64 == 4 * 32 * p.threads  # the x ring, then the stash's half
    assert parts["xs"] >= 4 * (p.rows * 2 + p.rows * 2)  # s and e of the tile's rows
    assert region < p.smem < 2 * region + parts["ring"]  # one region beside the ring, not two


@pytest.mark.parametrize("h_dim", [768, 1024])
def test_bf16_plan_refuses_widths_whose_layout_does_not_fit(h_dim):
    with pytest.raises(ValueError, match=f"H={h_dim} not supported in bfloat16"):
        cuda_pool.plan(BF16, h_dim, 384)


# -- the bf16 instance's wgmma layouts, as index arithmetic -----------------------


def _acc_coords(tid: int, i: int) -> tuple[int, int]:
    """(tile row, pass column) of register i of thread tid in the bf16
    instance: wgmma m64n256's accumulator layout in the thread's warpgroup
    (warp w, lane (g, q)), the warpgroup's 64 rows at 64 wg."""
    wg, w, lane = tid // 128, tid % 128 // 32, tid % 32
    g, q = lane // 4, lane % 4
    return 64 * wg + 16 * w + g + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * q + (i & 1)


def test_bf16_accumulators_cover_each_pass_once():
    """The 256 threads' 128 registers are the pass's 128 x 256 outputs, each once."""
    seen = Counter(_acc_coords(tid, i) for tid in range(256) for i in range(128))
    assert len(seen) == 128 * 256 and set(seen.values()) == {1}


@pytest.mark.parametrize("a_dim", [384, 128])  # the gate widths of H = 512 and 256: 3 passes and 1
def test_bf16_gate_pass_pairs_u_and_v_of_one_j_in_one_thread(a_dim):
    """gate_fold's pairing in every gate pass of interleaved [Wa|Wb] columns
    (``cuda_pool.interleave_gate``): register group 8m + ni (ni < 4) is u_j
    and group 8m + ni + 4 v_j of the same row and the same j = n0/2 + 32m +
    8ni + 2q + e, the Wc row the thread reads; every (row, j) of the tile is
    folded by exactly one thread."""
    src = cuda_pool.interleave_gate(torch.arange(2 * a_dim)).tolist()  # interleaved column -> row of [Wa|Wb]
    owned = Counter()
    for n0 in range(0, 2 * a_dim, 256):
        for tid in range(256):
            q = tid % 4
            for m in range(4):
                for ni in range(4):
                    for hf in range(2):
                        for e in range(2):
                            iu = 4 * (8 * m + ni) + 2 * hf + e
                            (ru, cu), (rv, cv) = _acc_coords(tid, iu), _acc_coords(tid, iu + 16)
                            j = n0 // 2 + 32 * m + 8 * ni + 2 * q + e
                            assert ru == rv
                            assert src[n0 + cu] == j and src[n0 + cv] == a_dim + j
                            owned[ru, j] += 1
    assert len(owned) == 128 * a_dim and set(owned.values()) == {1}


def _swizzled(n: int, c: int) -> int:
    """The 16-byte unit of chunk c of 64-byte row n in wgmma's 64-byte swizzle (sw64_desc_lo)."""
    return 4 * n + (c ^ ((n >> 1) & 3))


@pytest.mark.parametrize("rows", [256, 128])  # a weight slot, an x slot
def test_bf16_ring_copies_fill_the_64_byte_swizzle(rows):
    """stage_bf16's 16-byte copies: thread t's chunk t % 4 of row n = t / 4 +
    64j lands where wgmma reads it, and a slice's copies fill the slot once."""
    units = []
    for t in range(256):
        for j in range(rows // 64):
            unit = 4 * (t >> 2) + ((t & 3) ^ ((t >> 3) & 3)) + 256 * j  # the kernel's index
            assert unit == _swizzled(t // 4 + 64 * j, t % 4)
            units.append(unit)
    assert sorted(units) == list(range(4 * rows))


def test_bf16_epilogue_stores_fill_the_panels_once():
    """PanelPut's 4-byte stores of a 256-column pass: thread tid's pair
    j, hf (row 16 warp + g + 8hf, columns 8j + 2q (+1), _acc_coords') goes to
    panel j / 4, chunk j % 4 of its row, swizzled by bits 1-2 of g, which is
    where the panels' swizzle puts those columns; accumulate_panels reads
    column c of row r at the same place. The pass's stores cover its 8
    panels once, and a warp's 32 stores hit 32 banks."""
    words = Counter()
    for tid in range(256):
        lane = tid % 32
        sw = (lane >> 3) & 3
        for hf in range(2):
            for j in range(32):
                r, c = _acc_coords(tid, 4 * j + 2 * hf)
                elem = (j >> 2) * 128 * 32 + (16 * (tid >> 5) + (lane >> 2)) * 32 + 2 * (lane & 3) \
                    + 8 * hf * 32 + (((j & 3) ^ sw) << 3)  # the kernel's offset
                chunk = (c >> 3) & 3
                assert elem == (c >> 5) * 128 * 32 + 8 * _swizzled(r, chunk) + (c & 7)  # the panels' layout
                assert elem == (c >> 5) * 128 * 32 + r * 32 + ((chunk ^ ((r % 8) >> 1)) << 3) + (c & 7)  # the reads'
                words[elem // 2] += 1
    assert len(words) == 128 * 256 // 2 and set(words.values()) == {1}
    for warp in range(8):
        for hf in range(2):
            for j in range(32):
                banks = {(((j >> 2) * 128 * 32 + (16 * warp + lane // 4 + 8 * hf) * 32 + 2 * (lane % 4)
                           + ((((j & 3) ^ ((lane >> 3) & 3))) << 3)) // 2) % 32 for lane in range(32)}
                assert len(banks) == 32


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


@pytest.mark.parametrize("h_dim,a_dim,smem", [(512, 384, 230_432), (512, 256, 230_432), (256, 128, 115_744)])
def test_f32_plan_is_the_first_kernels(h_dim, a_dim, smem):
    """The f32 instance's plan: 64-row tiles (one wgmma M), 8 warps as two
    warpgroups, each with a 2-slot ring. One region [64][H + 4] for x slices,
    h1 and h2, ending on a 1024-byte boundary where the swizzled rings start:
    each warpgroup's ring [2][H/2][16] of 64-byte rows (no padding: wgmma's
    layout has none) and its small halves [H/2][16] of one slice, which at
    a tile's end hold the partial scores, s and e; the stats. The running
    acc stays in registers and Wc in device memory, so A does not change
    it. Within one CTA's shared memory."""
    p = cuda_pool.plan(F32, h_dim, a_dim)
    assert p == cuda_pool.PoolPlan(64, 256, 2, smem)
    assert p.smem <= cuda_pool.MAX_SMEM
    region = 4 * p.rows * (h_dim + 4)
    assert region < p.smem < 2 * region  # h1 and h2 take turns in one region
    parts = cuda_pool.f32_layout(h_dim)
    assert sum(parts.values()) == p.smem
    assert parts["h"] == region and region % 1024 == 0  # the rings' swizzle needs 1024-byte alignment
    assert parts["ring"] == 2 * p.slots * (h_dim // 2) * 64  # two warpgroups, H/2 rows of 16 f32 a slot
    assert parts["small"] == 2 * (h_dim // 2) * 64  # one slice's small halves a warpgroup
    assert parts["small"] // 2 >= 4 * (2 * p.rows * 2 + 2 * p.rows * 2)  # warpgroup 0's: partial scores, s, e
    # x slices: each warpgroup's ring of 2 slots of [64][16 + 4] in the region
    assert 2 * p.slots * p.rows * 20 * 4 <= region


@pytest.mark.parametrize("h_dim", [768, 1024])
def test_f32_plan_refuses_widths_whose_layout_does_not_fit(h_dim):
    with pytest.raises(ValueError, match=f"H={h_dim} not supported in float32"):
        cuda_pool.plan(F32, h_dim, 384)
    ops = _operands(h_dim, 384, 64, F32)
    with pytest.raises(ValueError, match=f"H={h_dim} not supported in float32"):
        cuda_pool.pool(ops, torch.zeros(1, 8, 64), torch.ones(1, 8), False)
    assert not _build.is_loaded()


@pytest.mark.parametrize("b,n", [(32, 8192), (4, 29568), (1, 40960)])
def test_f32_plan_halves_the_tiles_and_fills_whole_waves(b, n):
    """At the smoke's, the eval rung's and K1p's shapes: half the first
    kernel's 32-row tiles, one CTA an SM for at most ceil(tiles / SMs) tiles."""
    rows = cuda_pool.plan(F32, 512, 384).rows
    per, splits = cuda_pool.wave_split_plan(b, n, rows, N_SMS)
    tiles = b * _tiles(n, rows)
    assert 2 * tiles == b * _tiles(n, 32)
    assert _cost(b, splits, per) == -(-tiles // N_SMS)


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
    """Both instances hold an SM with one CTA and take whole waves, as K2
    and the probes do; split_plan stays for callers that ask for it."""
    assert cuda_pool._splitter(BF16) is cuda_pool.wave_split_plan
    assert cuda_pool._splitter(F32) is cuda_pool.wave_split_plan
    assert cuda_pool.split_plan(1, 40960, 64, N_SMS) == (2, 320)  # several blocks an SM, as before


def test_fixed_split_plan_takes_2048_rows_at_the_128_row_tile():
    rows = cuda_pool.plan(BF16, 512, 384).rows
    assert cuda_pool.fixed_split_plan(131072, rows, 2048) == (16, 64)


@pytest.mark.parametrize("rows_per_split", [64, 0, 2000])
def test_fixed_split_plan_refuses_what_is_no_multiple_of_the_tile(rows_per_split):
    rows = cuda_pool.plan(BF16, 512, 384).rows
    with pytest.raises(ValueError, match="multiple of the kernel's 128-row tile"):
        cuda_pool.fixed_split_plan(131072, rows, rows_per_split)


# -- the numerics of the f32 instance's products --------------------------------


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the bit pattern: round the 23-bit mantissa to 10
    bits, to nearest with ties away from zero (add 0x1000, clear the low 13
    bits; finite values)."""
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _truncated(v: torch.Tensor) -> torch.Tensor:
    """An f32 operand as the tensor cores read it as tf32: the low 13 bits of
    the mantissa dropped."""
    return (v.view(torch.int32) & -0x2000).view(torch.float32)


def _toward_zero(v: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero, as the tensor cores round the f32 sums
    they write."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _tensor_core(a: torch.Tensor, b: torch.Tensor, steps, depth: int, sliced: bool = True) -> torch.Tensor:
    """C = A B in slices of ``depth`` as the kernel's tensor-core products
    take them: ``steps`` lists a slice's products in order, each (a part, b
    part, k8 step within the slice), and each adds its exact products to an
    f32 sum and rounds it toward zero. Sliced, each slice's products go to a
    sum of their own, started at 0, which is added to C once (an f32 add,
    rounded to nearest), as the kernel does; else they go straight to C."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], depth):
        part = torch.zeros_like(acc) if sliced else acc
        for pa, pb, kk in steps:
            ks = slice(k0 + 8 * kk, k0 + 8 * kk + 8)
            part = _toward_zero(part.double() + pa(a[:, ks]).double() @ pb(b[ks]).double())
        acc = (acc.double() + part.double()).float() if sliced else part
    return acc


def _small(v: torch.Tensor) -> torch.Tensor:
    """The small half of an A operand: x - tf32(x), exact in f32, passed as
    it is and truncated by the tensor cores."""
    return _truncated(v - _tf32(v))


def _small_of_raw(v: torch.Tensor) -> torch.Tensor:
    """The small half of a weight whose big half is its raw f32 value, read
    truncated: w - trunc(w), exact in f32, truncated in turn."""
    return _truncated(v - _truncated(v))


def _steps(big_b, small_b, order: str):
    """A 16-deep slice's products: for each (product, k8 step) of ``order``
    ("sb0" = A small . B big of the first k8 step), its (a part, b part, step)."""
    parts = {"sb": (_small, big_b), "bs": (_tf32, small_b), "bb": (_tf32, big_b)}
    return [(*parts[o[:2]], int(o[2])) for o in order.split()]


# (B's big half, B's small half, the order of a 16-deep slice's products):
# the earlier kernel's m16n8k8 steps, both operands rounded to nearest, each
# k8 step's three products in turn; the wgmma kernel's, its weights' big
# half the raw slice read truncated and their small half w - trunc(w)
# written beside it, small.big and big.big of both k8 steps issued while the
# small halves are written, then big.small of both.
SCHEMES = {"mma.sync rna": (_tf32, _small, "sb0 bs0 bb0 sb1 bs1 bb1"),
           "wgmma raw big": (_truncated, _small_of_raw, "sb0 bb0 sb1 bb1 bs0 bs1")}


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_3xtf32_is_as_accurate_as_f32_fma_and_one_tf32_product_is_not(scheme):
    """The model of the f32 instance's products on seeded 64 x 1024 x 128
    operands, against the f64 product, relative to its largest output:
    3xTF32 (small.big + big.small + big.big, A's big half tf32(x) rounded to
    nearest and its small half x - big, which the kernel passes as it is and
    the tensor cores truncate; B's halves and the products' order as the
    scheme makes them) in 16-deep slices stays within 2x of sequential f32
    FMA over k. Summed straight into one running sum, the truncation of every
    step gathers a bias over K that misses it 5x or more; one TF32 product
    misses it by 50x or more."""
    big_b, small_b, order = SCHEMES[scheme]
    rng = np.random.default_rng(15)
    a = torch.from_numpy(rng.standard_normal((64, 1024)).astype(np.float32))
    b = torch.from_numpy((0.03 * rng.standard_normal((1024, 128))).astype(np.float32))
    want = a.double() @ b.double()
    scale = want.abs().max().item()

    fma = torch.zeros(64, 128, dtype=torch.float32)
    for k in range(a.shape[1]):  # one rounding a step: the f64 sum of an exact product, rounded to f32
        fma = (fma.double() + a[:, k:k + 1].double() * b[k:k + 1].double()).float()

    steps = _steps(big_b, small_b, order)
    sliced = _tensor_core(a, b, steps, 16)
    running = _tensor_core(a, b, steps, 16, sliced=False)
    one = _tensor_core(a, b, _steps(big_b, small_b, "bb0 bb1"), 16)
    err_fma, err_sliced, err_running, err_one = (
        (c.double() - want).abs().max().item() / scale for c in (fma, sliced, running, one))
    assert 0 < err_fma < 1e-5
    assert err_sliced <= 2 * err_fma
    assert err_running >= 5 * err_fma
    assert err_one >= 50 * err_fma


def test_tf32_split_is_exact_and_rounds_to_nearest():
    """big + small recovers x to within small's truncation to tf32; big keeps
    10 mantissa bits, rounded half away from zero: the kernel's bits + 0x1000,
    read with the low 13 bits dropped, is the same value."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 3.14159265])
    big = _tf32(x)
    assert big.tolist()[:4] == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10)]
    assert not (big.view(torch.int32) & 0x1FFF).any()
    rest = x - big  # exact in f32
    assert ((big.double() + rest.double()) == x.double()).all()
    assert ((big.double() + _truncated(rest).double() - x.double()).abs() <= x.double().abs() * 2.0 ** -21).all()
    assert torch.equal(_truncated((x.view(torch.int32) + 0x1000).view(torch.float32)), big)
