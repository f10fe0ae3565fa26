"""The int8 pooling kernel's plan (``toad_tpu_torch.ops.cuda_pool_int8``).

K2 (``csrc/pool_int8.cu``) runs 64-row tiles with 8 warps and streams its
weights through one 3-slot cp.async ring of 32 KB slots, stored without
padding under a 128-byte XOR swizzle; the stream stages the same slice
sequence every tile and runs on from one GEMM into the next and from one
tile into the next. ``plan``, ``layout``, ``swizzle`` and ``stream_schedule``
mirror the kernel (``chip_smoke.py`` phase 2 asserts that the library's
shared memory agrees on the card); a Python model of the ring checks the
kernel's cursor arithmetic. Its grid fills whole waves of one CTA an SM.
The requantization quantizes with the row's reciprocal and two Newton steps
on the remainder, modelled here in exact arithmetic against the IEEE
quotient and the JAX quantizer. No card is needed.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest

from toad_tpu.ops.quantize import quantize_rows as jax_quantize_rows
from toad_tpu_torch.ops import cuda_pool, cuda_pool_int8 as k2

N_SMS = 132  # the H100's SMs


def test_plan_at_toad_width_fits_one_cta():
    """TOAD's A=384: 3 x 32 KB weight slots, 3 x 4 KB x slots, h1q/h2q 64 x
    528 B, h2 64 x 520 bf16, and 11,552 B for Wc, the row scales, the column
    warps' amax and partial scores, s, e, acc and the stats."""
    p = k2.plan(384)
    assert p == k2.Int8PoolPlan(64, 256, 3, 222_496)
    assert 3 * 32_768 + 3 * 4_096 + 33_792 + 66_560 + 11_552 == p.smem <= cuda_pool.MAX_SMEM == 232_448


@pytest.mark.parametrize("a_dim", [128, 256, 384, 512])
def test_plan_fits_every_width_the_kernel_takes(a_dim):
    p = k2.plan(a_dim)
    assert p.smem <= cuda_pool.MAX_SMEM and (p.rows, p.threads, p.slots) == (64, 256, 3)
    assert p.smem == k2.plan(384).smem + 8 * (a_dim - 384)  # only Wc [A][2] f32 moves with A


@pytest.mark.parametrize("a_dim", [0, 100, 640, 1024])
def test_plan_refuses_widths_the_kernel_does_not_take(a_dim):
    with pytest.raises(ValueError, match=f"A={a_dim} not supported by the int8 kernel"):
        k2.plan(a_dim)


def test_plan_refuses_a_layout_over_shared_memory(monkeypatch):
    """A fourth ring slot would not fit beside h2 and h2q: 259,360 B."""
    monkeypatch.setattr(k2, "RING_SLOTS", 4)
    with pytest.raises(ValueError, match="259360 B of shared memory with 4 ring slots"):
        k2.plan(384)


@pytest.mark.parametrize("a_dim", [128, 384, 512])
def test_regions_do_not_overlap(a_dim):
    """Every region has bytes of its own (none is live while another reuses
    it), 16-byte aligned; the swizzled rings start on 1 KB, where the
    swizzle's 128-byte lines and 1 KB blocks begin; the last region ends at
    the plan's shared memory."""
    regions = sorted(k2.layout(a_dim).values())
    for (o1, s1), (o2, _) in zip(regions, regions[1:]):
        assert o1 + s1 <= o2
    assert all(o % 16 == 0 for o, _ in regions)
    assert k2.layout(a_dim)["ws"][0] % 1024 == 0 and k2.layout(a_dim)["xs"][0] % 1024 == 0
    assert regions[-1][0] + regions[-1][1] == k2.plan(a_dim).smem


# (slot bytes, bytes a row): a trunk weight slice, a gate weight slice, an x slice
SLOT_SHAPES = [(k2.SLOT_BYTES, k2.TRUNK_DEPTH), (k2.SLOT_BYTES, k2.GATE_DEPTH), (k2.ROWS * k2.TRUNK_DEPTH, k2.TRUNK_DEPTH)]


@pytest.mark.parametrize("slot,row_bytes", SLOT_SHAPES)
def test_swizzle_is_a_bijection_of_each_slot(slot, row_bytes):
    """Every 16-byte chunk of a slot lands on one chunk of the same slot,
    and within the same 1 KB block."""
    chunks = range(0, slot, 16)
    stored = [k2.swizzle(o) for o in chunks]
    assert sorted(stored) == list(chunks)
    assert all(s // 1024 == o // 1024 and s % 16 == 0 for o, s in zip(chunks, stored))
    assert all(k2.swizzle(k2.swizzle(o)) == o for o in chunks)


def _bank_groups(offsets) -> set[int]:
    """The 16-byte groups of 4 banks (0..7) that 16-byte reads at these
    offsets of a 128-byte aligned region hit."""
    return {(o >> 4) & 7 for o in offsets}


@pytest.mark.parametrize("slot,row_bytes", SLOT_SHAPES)
def test_swizzle_keeps_ldmatrix_conflict_free(slot, row_bytes):
    """One ldmatrix phase reads 8 consecutive rows (from a multiple of 8) at
    one 16-byte chunk: under the swizzle they hit 8 different bank groups;
    unswizzled 64-byte rows would hit 2 (4-way conflicts) and 128-byte rows
    1."""
    for r0 in range(0, slot // row_bytes, 8):
        for c in range(0, row_bytes, 16):
            rows = [(r0 + i) * row_bytes + c for i in range(8)]
            assert len(_bank_groups(k2.swizzle(o) for o in rows)) == 8
            assert len(_bank_groups(rows)) == 1024 // row_bytes // 8


def test_activation_rows_stay_conflict_free_by_their_stride():
    """h1q/h2q are not swizzled: their 528-byte rows shift each row by one
    chunk, so the A fragments' 8 rows at one chunk hit 8 bank groups."""
    for r0 in range(0, k2.ROWS, 8):
        for c in range(0, k2.HIDDEN, 16):
            assert len(_bank_groups((r0 + i) * k2.LD_ACT + c for i in range(8))) == 8


@pytest.mark.parametrize("d,a_dim", [(1024, 384), (1024, 128), (512, 512), (64, 256)])
def test_stream_stages_every_weight_byte_once_in_the_order_consumed(d, a_dim):
    """Each tile's stream covers W1 [512, D], W2 [512, 512] and the
    interleaved [Wa|Wb] [2A, 512] exactly once, every slice filling a slot,
    in the order the GEMMs consume them: GEMM1 over k, GEMM2 over k, then the
    gate pass by pass, each over k."""
    sched = k2.stream_schedule(d, a_dim)
    shapes = {"w1": (k2.HIDDEN, d), "w2": (k2.HIDDEN, k2.HIDDEN), "wab": (2 * a_dim, k2.HIDDEN)}
    seen = {name: np.zeros(shape, np.int32) for name, shape in shapes.items()}
    for gemm, n0, k0, rows, depth in sched:
        assert rows * depth == k2.SLOT_BYTES
        seen[gemm][n0:n0 + rows, k0:k0 + depth] += 1
    assert all((count == 1).all() for count in seen.values())
    order = {"w1": 0, "w2": 1, "wab": 2}
    assert sched == sorted(sched, key=lambda s: (order[s[0]], s[1], s[2]))
    assert len(sched) == d // 64 + 8 + (2 * a_dim // 256) * 4
    assert len(k2.stream_schedule(1024, 384)) == 36  # where a ring restarted per GEMM took 48 slices


class _Ring:
    """The kernel's stream in Python: the producer's cursor (tile, slice,
    slot) two slices ahead of the consumers' slot, one group a slice, both
    wrapping into the next tile the block runs; a slot holds (tile, slice)."""

    def __init__(self, tiles: list[int], n_slices: int):
        self.tiles, self.n_slices = tiles, n_slices
        self.slots: list[tuple[int, int] | None] = [None] * k2.RING_SLOTS
        self.consumed: set[tuple[int, int]] = set()
        self.p_tile = tiles[0] if tiles else None
        self.p_s = self.p_slot = self.c_slot = 0
        self.next = None  # set at each tile's start, as the kernel's `next`
        self.staged: list[tuple[int, int]] = []

    def issue(self):
        if self.p_tile is not None:
            old = self.slots[self.p_slot]
            assert old is None or old in self.consumed, f"slot {self.p_slot} overwritten before {old} was consumed"
            self.slots[self.p_slot] = (self.p_tile, self.p_s)
            self.staged.append((self.p_tile, self.p_s))
        self.p_slot = (self.p_slot + 1) % k2.RING_SLOTS
        self.p_s += 1
        if self.p_s == self.n_slices:
            self.p_s, self.p_tile = 0, self.next

    def run(self) -> list[tuple[int, int]]:
        for _ in range(k2.RING_SLOTS - 1):
            self.issue()
        order = []
        for i, tile in enumerate(self.tiles):
            self.next = self.tiles[i + 1] if i + 1 < len(self.tiles) else None
            for s in range(self.n_slices):
                self.issue()  # after the step's barrier: every warp is done with the slot it refills
                got = self.slots[self.c_slot]
                assert got == (tile, s), f"step {s} of tile {tile} found {got}"
                self.consumed.add(got)
                order.append(got)
                self.c_slot = (self.c_slot + 1) % k2.RING_SLOTS
        return order


@pytest.mark.parametrize("tiles", [[0], [0, 1, 2], [3, 7, 8], []])
def test_ring_model_runs_one_stream_across_gemms_and_tiles(tiles):
    """Tiles 3, 7, 8: a block that skips padding tiles; []: a block with
    none live. Every slice is staged once, into a slot no unconsumed slice
    holds, and consumed in order; nothing is staged past the last tile."""
    n_slices = len(k2.stream_schedule(1024, 384))
    ring = _Ring(tiles, n_slices)
    want = [(t, s) for t in tiles for s in range(n_slices)]
    assert ring.run() == want
    assert ring.staged == want


@pytest.mark.parametrize("b,n,wave_splits,old_cost,old_splits", [
    (32, 8192, 4, 32, 16), (1, 65536, 128, 8, 512), (4, 29568, 33, 16, 116)])
def test_whole_waves_at_k2_shapes(b, n, wave_splits, old_cost, old_splits):
    """K2 holds an SM with one CTA (222,496 B), so it takes whole waves: at
    the smoke's 32 x 8,192, one long bag and the eval rung 4 x 29,568 the
    fair share ceil(tiles / SMs) tile-times, where split_plan's four blocks
    an SM took as many or more, with up to 4x the splits."""
    tiles = -(-n // k2.ROWS)
    per, splits = cuda_pool.wave_split_plan(b, n, k2.ROWS, N_SMS)
    assert per * splits >= tiles > per * (splits - 1)
    assert splits == wave_splits
    assert -(-b * splits // N_SMS) * per == -(-b * tiles // N_SMS)
    per0, splits0 = cuda_pool.split_plan(b, n, k2.ROWS, N_SMS)
    assert (-(-b * splits0 // N_SMS) * per0, splits0) == (old_cost, old_splits)


def _rn32(x: Fraction) -> Fraction:
    """x rounded to the nearest float32, ties to even (normal range)."""
    if x == 0:
        return x
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    e += (Fraction(2) ** (e + 1) <= x) - (Fraction(2) ** e > x)
    m = x / Fraction(2) ** (e - 23)  # in [2^23, 2^24)
    n, rem = divmod(m.numerator, m.denominator)
    n += 2 * rem > m.denominator or (2 * rem == m.denominator and n % 2 == 1)
    return sign * n * Fraction(2) ** (e - 23)


def _fma(a: Fraction, b: Fraction, c: Fraction) -> Fraction:
    return _rn32(a * b + c)


def _kernel_quotient(v: float, scale: float, steps: int = 2) -> Fraction:
    """The kernel's quant_row before its rounding, in exact arithmetic: y =
    fl(v * fl(1 / scale)), then ``steps`` Newton steps y = fma(fma(-y, scale,
    v), inv, y)."""
    v, scale = Fraction(float(v)), Fraction(float(scale))
    inv = _rn32(1 / scale)
    y = _rn32(v * inv)
    for _ in range(steps):
        y = _fma(_fma(-y, scale, v), inv, y)
    return y


def _rows_next_to_ties(seed: int, n_rows: int) -> np.ndarray:
    """Rows of |values| within 6 ulps of every third (k + 1/2) * scale, k <
    127, and seeded values, each row led by its amax (so that its scale is
    amax / 127); one amax with an all-ones significand."""
    rng = np.random.default_rng(seed)
    amaxes = list(rng.uniform(0.01, 50.0, n_rows - 1).astype(np.float32)) + [np.float32(2.0 - 2.0 ** -23)]
    rows = []
    for amax in amaxes:
        scale = amax / np.float32(127)
        vals = [amax, *rng.uniform(0, amax, 40).astype(np.float32)]
        for k in range(0, 127, 3):
            for direction in (np.float32(np.inf), np.float32(-np.inf)):
                v = np.float32((k + 0.5) * np.float64(scale))
                for _ in range(7):
                    vals.append(v)
                    v = np.nextafter(v, direction)
        rows.append(np.array([v for v in vals if v <= amax], np.float32))
    x = np.zeros((len(rows), max(map(len, rows))), np.float32)
    for i, row in enumerate(rows):
        x[i, :len(row)] = row
    return x


def test_newton_quotient_is_the_ieee_quotient():
    """fl(v * inv) and two Newton steps give fl(v / scale) exactly (checked
    in exact arithmetic and against numpy's f32 division) next to every
    half-integer multiple of the scale, where rne decides; the product alone
    misses it in a large share, so the steps are what make it exact."""
    x = _rows_next_to_ties(3, 8)
    scale = np.maximum(x[:, 0], np.float32(1e-6)) / np.float32(127)
    product_wrong = 0
    for row, s in zip(x, scale):
        for v in row[row > 0]:
            want = v / s  # numpy: the correctly rounded f32 quotient
            assert Fraction(float(want)) == _rn32(Fraction(float(v)) / Fraction(float(s)))
            assert _kernel_quotient(v, s) == Fraction(float(want))
            product_wrong += _kernel_quotient(v, s, steps=0) != Fraction(float(want))
    assert product_wrong > 500


def test_newton_quantizer_matches_jax():
    """The kernel's q = clip(rint(quotient), +-127) on rows next to every
    tie and on seeded rows gives the int8 values of the JAX quantizer
    (y / scale, round half to even, clip); rounding the product alone
    would not."""
    x = np.concatenate([_rows_next_to_ties(5, 12).ravel(), np.random.default_rng(9).standard_normal(2000)])
    x = np.abs(x.astype(np.float32))  # after the ReLU, as in the kernel
    x = np.pad(x, (0, -len(x) % 128)).reshape(-1, 128)
    x[:, 0] = np.where(np.arange(len(x)) % 3 == 0, 0.0, x[:, 0])  # some rows with a smaller amax
    x[-1] = 0.0  # an all-zero row: the 1e-6 floor
    q, scale = (np.asarray(a) for a in jax_quantize_rows(jnp.asarray(x)))
    got = np.array([[int(np.clip(np.rint(np.float32(float(_kernel_quotient(v, s)))), -127, 127)) for v in row]
                    for row, s in zip(x, scale)])
    np.testing.assert_array_equal(got, q)
    naive = np.clip(np.rint(x * (np.float32(1) / scale[:, None])), -127, 127)
    assert (naive != q).sum() > 0
