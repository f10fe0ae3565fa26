"""The int8 pooling kernel's plan (``toad_tpu_torch.ops.cuda_pool_int8``).

K2 (``csrc/pool_int8.cu``) runs 64-row tiles with 8 warps as two warpgroups
on int8 wgmma (each trunk GEMM m64n256k32 a warpgroup over 256 of the 512
columns, the gate m64n128k32 over 128 of a pass's 256) and streams its
weights through one 3-slot cp.async ring of 32 KB slots, stored without
padding in the swizzles wgmma's descriptors read: trunk and x slices of
64-byte rows in the 64-byte swizzle, gate slices of 128-byte rows in the
128-byte one; h1q and h2q are 8 panels of 64 rows x 64 bytes in the 64-byte
swizzle. The stream stages the same slice sequence every tile and runs on
from one GEMM into the next and from one tile into the next. ``plan``,
``layout``, ``swizzle`` and ``stream_schedule`` mirror the kernel
(``chip_smoke.py`` phase 2 asserts that the library's shared memory agrees
on the card); a Python model of the ring checks the kernel's cursor
arithmetic, and index arithmetic its copies, its accumulator mapping, its
panel stores and what its descriptors read. Its grid fills whole waves of
one CTA an SM. The requantization quantizes with the row's reciprocal and
two Newton steps on the remainder, modelled here in exact arithmetic against
the IEEE quotient and the JAX quantizer. No card is needed.
"""

from collections import Counter
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toad_tpu.ops.quantize import quantize_rows as jax_quantize_rows
from toad_tpu_torch.ops import cuda_pool, cuda_pool_int8 as k2

N_SMS = 132  # the H100's SMs


def test_plan_at_toad_width_fits_one_cta():
    """TOAD's A=384: 3 x 32 KB weight slots, 3 x 4 KB x slots, h1q/h2q as 8
    panels of 64 x 64 B, h2 64 x 520 bf16, and 10,016 B for Wc, the row
    scales, the warpgroups' amax and partial scores, s, e, acc and the
    stats."""
    p = k2.plan(384)
    assert p == k2.Int8PoolPlan(64, 256, 3, 219_936)
    assert 3 * 32_768 + 3 * 4_096 + 32_768 + 66_560 + 10_016 == p.smem <= cuda_pool.MAX_SMEM == 232_448


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
    """A fourth ring slot would not fit beside h2 and the panels: 256,800 B."""
    monkeypatch.setattr(k2, "RING_SLOTS", 4)
    with pytest.raises(ValueError, match="256800 B of shared memory with 4 ring slots"):
        k2.plan(384)


@pytest.mark.parametrize("a_dim", [128, 384, 512])
def test_regions_do_not_overlap(a_dim):
    """Every region has bytes of its own (none is live while another reuses
    it), 16-byte aligned; the swizzled rings and panels, and h2, start on 1
    KB, where the swizzles' 8-row groups begin; the last region ends at the
    plan's shared memory; the rings hold the merge's scratch at the end."""
    lay = k2.layout(a_dim)
    regions = sorted(lay.values())
    for (o1, s1), (o2, _) in zip(regions, regions[1:]):
        assert o1 + s1 <= o2
    assert all(o % 16 == 0 for o, _ in regions)
    assert all(lay[name][0] % 1024 == 0 for name in ("ws", "xs", "panels", "h2"))
    assert regions[-1][0] + regions[-1][1] == k2.plan(a_dim).smem
    # pool_tail's scratch for a bag of 132 partials: 8 warps' sums of 1,024 outputs, the divisors and weights
    assert 4 * (8 * 1024 + 8 + 2 * 132) <= lay["panels"][0]


# (slot bytes, bytes a row): a trunk weight slice, a gate weight slice, an x slice (and an h1q panel)
SLOT_SHAPES = [(k2.SLOT_BYTES, k2.TRUNK_DEPTH), (k2.SLOT_BYTES, k2.GATE_DEPTH), (k2.PANEL_BYTES, k2.TRUNK_DEPTH)]


@pytest.mark.parametrize("slot,row_bytes", SLOT_SHAPES)
def test_swizzle_is_a_bijection_of_each_slot(slot, row_bytes):
    """Every 16-byte chunk of a slot lands on one chunk of the same slot,
    and within the same 8-row group (512 B for 64-byte rows, 1 KB for 128)."""
    chunks = range(0, slot, 16)
    stored = [k2.swizzle(o, row_bytes) for o in chunks]
    assert sorted(stored) == list(chunks)
    group = 8 * row_bytes
    assert all(s // group == o // group and s % 16 == 0 for o, s in zip(chunks, stored))
    assert all(k2.swizzle(k2.swizzle(o, row_bytes), row_bytes) == o for o in chunks)


def _bank_groups(offsets) -> set[int]:
    """The 16-byte groups of 4 banks (0..7) that 16-byte accesses at these
    offsets of a 128-byte aligned region hit."""
    return {(o >> 4) & 7 for o in offsets}


@pytest.mark.parametrize("slot,row_bytes", SLOT_SHAPES)
def test_swizzle_keeps_8_row_reads_conflict_free(slot, row_bytes):
    """The tensor cores read an operand as 8 rows (from a multiple of 8) at
    one 16-byte chunk: under the swizzle they hit 8 different bank groups;
    unswizzled 64-byte rows would hit 2 (4-way conflicts) and 128-byte rows
    1."""
    for r0 in range(0, slot // row_bytes, 8):
        for c in range(0, row_bytes, 16):
            rows = [(r0 + i) * row_bytes + c for i in range(8)]
            assert len(_bank_groups(k2.swizzle(o, row_bytes) for o in rows)) == 8
            assert len(_bank_groups(rows)) == 1024 // row_bytes // 8


def _acc_coords(tid: int, i: int, width: int) -> tuple[int, int]:
    """(tile row, column) of register i of thread tid in wgmma's accumulator
    layout: warp w of the thread's warpgroup wg holds rows 16w + g and 16w +
    g + 8, register i is row 16w + g + 8((i >> 1) & 1), column 8(i >> 2) + 2q
    + (i & 1) of the warpgroup's ``width`` columns, which start at width wg
    (g = lane / 4, q = lane % 4)."""
    wg, w, lane = tid // 128, tid % 128 // 32, tid % 32
    g, q = lane // 4, lane % 4
    return 16 * w + g + 8 * ((i >> 1) & 1), width * wg + 8 * (i >> 2) + 2 * q + (i & 1)


def _panel_store(tid: int, j: int, hf: int) -> int:
    """requant8's byte offset in the panels of thread tid's pair j, hf: panel
    4 wg + j / 8, its row at 64 bytes, chunk (j % 8) / 2 XOR bits 1-2 of g,
    byte 8 (j % 2) + 2q of the chunk."""
    wg, lane = tid // 128, tid % 32
    g, q = lane // 4, lane % 4
    row = 16 * (tid % 128 // 32) + g + 8 * hf
    return ((4 * wg + (j >> 3)) * k2.PANEL_BYTES + row * 64 + ((((j & 7) >> 1) ^ ((lane >> 3) & 3)) << 4)
            + 8 * (j & 1) + 2 * q)


def test_epilogue_stores_are_conflict_free():
    """A warp's 2-byte stores of one pair of h1q/h2q into the panels hit 32
    banks or share a word (the quad's lanes 0-1 and 2-3), and its 4-byte
    stores of h2 in bf16 (rows of 1,040 bytes) hit 32 different banks."""
    for warp in range(8):
        for j in range(32):
            for hf in range(2):
                lanes = range(32 * warp, 32 * warp + 32)
                words = {_panel_store(t, j, hf) // 4 for t in lanes}
                assert len({w % 32 for w in words}) == len(words) == 16
                h2 = [_acc_coords(t, 4 * j + 2 * hf, 256) for t in lanes]
                assert len({(r * k2.LD_H2 * 2 + 2 * c) // 4 % 32 for r, c in h2}) == 32


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
    wrapping into the next tile the block runs; a slot holds (tile, slice).
    Each step takes its slice, issues its products and then (``refill_after``)
    waits for the products of the slices before it but the last
    ``in_flight`` and, behind a barrier, refills a slot, which must hold no
    slice whose products may still read it; or (not ``refill_after``) waits
    and refills before it issues them."""

    def __init__(self, tiles: list[int], n_slices: int, in_flight: int = 1, refill_after: bool = True):
        self.tiles, self.n_slices, self.in_flight, self.refill_after = tiles, n_slices, in_flight, refill_after
        self.slots: list[tuple[int, int] | None] = [None] * k2.RING_SLOTS
        self.done: set[tuple[int, int]] = set()  # slices whose products every warpgroup has waited for
        self.issued: list[tuple[int, int]] = []  # slices whose products were issued, in order
        self.p_tile = tiles[0] if tiles else None
        self.p_s = self.p_slot = self.c_slot = 0
        self.next = None  # set at each tile's start, as the kernel's `next`
        self.staged: list[tuple[int, int]] = []

    def issue(self):
        if self.p_tile is not None:
            old = self.slots[self.p_slot]
            assert old is None or old in self.done, f"slot {self.p_slot} refilled while {old}'s products may read it"
            self.slots[self.p_slot] = (self.p_tile, self.p_s)
            self.staged.append((self.p_tile, self.p_s))
        self.p_slot = (self.p_slot + 1) % k2.RING_SLOTS
        self.p_s += 1
        if self.p_s == self.n_slices:
            self.p_s, self.p_tile = 0, self.next

    def refill(self):
        self.done.update(self.issued[:len(self.issued) - self.in_flight])  # wgmma_wait, then the barrier
        self.issue()

    def run(self) -> list[tuple[int, int]]:
        for _ in range(k2.RING_SLOTS - 1):
            self.issue()
        order = []
        for i, tile in enumerate(self.tiles):
            self.next = self.tiles[i + 1] if i + 1 < len(self.tiles) else None
            for s in range(self.n_slices):
                if not self.refill_after:
                    self.refill()
                got = self.slots[self.c_slot]  # take: its copies landed, behind the barrier
                assert got == (tile, s), f"step {s} of tile {tile} found {got}"
                self.issued.append(got)  # its products
                if self.refill_after:
                    self.refill()
                order.append(got)
                self.c_slot = (self.c_slot + 1) % k2.RING_SLOTS
        return order


@pytest.mark.parametrize("tiles", [[0], [0, 1, 2], [3, 7, 8], []])
def test_ring_model_runs_one_stream_across_gemms_and_tiles(tiles):
    """Tiles 3, 7, 8: a block that skips padding tiles; []: a block with
    none live. Every slice is staged once, into a slot whose slice's
    products are done, and consumed in order, while one slice's products
    stay in flight; nothing is staged past the last tile."""
    n_slices = len(k2.stream_schedule(1024, 384))
    ring = _Ring(tiles, n_slices)
    want = [(t, s) for t in tiles for s in range(n_slices)]
    assert ring.run() == want
    assert ring.staged == want


def test_three_slots_refill_only_after_the_next_products_are_issued():
    """With 3 slots and two slices in flight, the slot a step refills held
    the slice just before it: refilling it before this step's products are
    issued would need that slice's products done there, with nothing queued
    behind them (wgmma_wait<0>); refilling after issuing them lets one
    slice's products stay in flight. Refilling first with one in flight
    would let the copy overwrite what they read."""
    n_slices = len(k2.stream_schedule(1024, 384))
    with pytest.raises(AssertionError, match="refilled while"):
        _Ring([0, 1], n_slices, in_flight=1, refill_after=False).run()
    assert len(_Ring([0, 1], n_slices, in_flight=0, refill_after=False).run()) == 2 * n_slices
    assert len(_Ring([0, 1], n_slices, in_flight=1, refill_after=True).run()) == 2 * n_slices


@pytest.mark.parametrize("b,n,wave_splits,old_cost,old_splits", [
    (32, 8192, 4, 32, 16), (1, 65536, 128, 8, 512), (4, 29568, 33, 16, 116)])
def test_whole_waves_at_k2_shapes(b, n, wave_splits, old_cost, old_splits):
    """K2 holds an SM with one CTA (219,936 B), so it takes whole waves: at
    the smoke's 32 x 8,192, one long bag and the eval rung 4 x 29,568 the
    fair share ceil(tiles / SMs) tile-times, where split_plan's four blocks
    an SM took as many or more, with up to 4x the splits."""
    assert 2 * k2.plan(384).smem > 228 * 1024  # two CTAs do not share an SM's 228 KB
    tiles = -(-n // k2.ROWS)
    per, splits = cuda_pool.wave_split_plan(b, n, k2.ROWS, N_SMS)
    assert per * splits >= tiles > per * (splits - 1)
    assert splits == wave_splits
    assert -(-b * splits // N_SMS) * per == -(-b * tiles // N_SMS)
    per0, splits0 = cuda_pool.split_plan(b, n, k2.ROWS, N_SMS)
    assert (-(-b * splits0 // N_SMS) * per0, splits0) == (old_cost, old_splits)


# -- the wgmma layouts, as index arithmetic -------------------------------------


def test_trunk_accumulators_cover_each_column_once():
    """The 256 threads' 128 int32 sums of a trunk GEMM (m64n256k32, warpgroup
    wg at columns 256 wg..) are the tile's 64 x 512 outputs, each once: one
    pass over all of a row's columns, whose amax the requantization needs."""
    seen = Counter(_acc_coords(tid, i, 256) for tid in range(256) for i in range(128))
    assert len(seen) == 64 * 512 and set(seen.values()) == {1}


@pytest.mark.parametrize("a_dim", [384, 128])  # 3 gate passes and 1
def test_gate_pass_pairs_u_and_v_of_one_j_in_one_thread(a_dim):
    """gate_fold8's pairing in every gate pass of interleaved [Wa|Wb] columns
    (``cuda_pool.interleave_gate``), warpgroup wg at the pass's columns 128
    wg.. (m64n128k32): register group 8m + ni (ni < 4) is u_j and group 8m +
    ni + 4 v_j of the same row and the same j = n0/2 + 64 wg + 32m + 8ni + 2q
    + e, the Wc row the thread reads; every (row, j) of the tile is folded by
    exactly one thread."""
    src = cuda_pool.interleave_gate(torch.arange(2 * a_dim)).tolist()  # interleaved column -> row of [Wa|Wb]
    owned = Counter()
    for n0 in range(0, 2 * a_dim, 256):
        for tid in range(256):
            wg, q = tid // 128, tid % 4
            for m in range(2):
                for ni in range(4):
                    for hf in range(2):
                        for e in range(2):
                            iu = 4 * (8 * m + ni) + 2 * hf + e
                            (ru, cu), (rv, cv) = _acc_coords(tid, iu, 128), _acc_coords(tid, iu + 16, 128)
                            j = (n0 + 128 * wg) // 2 + 32 * m + 8 * ni + 2 * q + e
                            assert ru == rv
                            assert src[n0 + cu] == j and src[n0 + cv] == a_dim + j
                            owned[ru, j] += 1
    assert len(owned) == 64 * a_dim and set(owned.values()) == {1}


@pytest.mark.parametrize("what", ["trunk weights", "x", "gate weights"])
def test_ring_copies_fill_the_swizzle(what):
    """stage8's 16-byte copies of one slice: thread t's chunk of its rows
    lands where the slot's swizzle puts that (row, chunk) (64-byte rows:
    chunk t % 4 of rows t / 4 + 64i at unit 4 (t / 4) + (t % 4 ^ bits 3-4 of
    t) + 256i; gate rows: chunk t % 8 of rows t / 8 + 32i at swz(16t) + 4096
    i), and the copies fill the slot once."""
    stored = []
    for t in range(256):
        if what == "gate weights":
            for i in range(8):
                row, chunk = t // 8 + 32 * i, t % 8
                at = k2.swizzle(16 * t, 128) + 4096 * i  # the kernel's offset
                assert at == k2.swizzle(row * 128 + 16 * chunk, 128)
                stored.append(at)
        else:
            for i in range(8 if what == "trunk weights" else 1):
                row, chunk = t // 4 + 64 * i, t % 4
                at = 16 * (4 * (t >> 2) + ((t & 3) ^ ((t >> 3) & 3)) + 256 * i)  # the kernel's unit
                assert at == k2.swizzle(row * 64 + 16 * chunk, 64)
                stored.append(at)
    size = k2.PANEL_BYTES if what == "x" else k2.SLOT_BYTES
    assert sorted(stored) == list(range(0, size, 16))


def test_panel_stores_fill_each_panel_once():
    """requant8's stores of a tile's 64 x 512 int8 values: thread tid's pair
    j, hf (row and columns of _acc_coords) goes where the panels' swizzle
    puts those bytes (panel col / 64, row at 64 bytes), and the 8 panels'
    32 KB are written once, two bytes at a time."""
    written = Counter()
    for tid in range(256):
        for j in range(32):
            for hf in range(2):
                row, col = _acc_coords(tid, 4 * j + 2 * hf, 256)
                at = _panel_store(tid, j, hf)
                assert at == (col // 64) * k2.PANEL_BYTES + k2.swizzle(row * 64 + col % 64, 64)
                written[at] += 1
                written[at + 1] += 1
    assert sorted(written) == list(range(8 * k2.PANEL_BYTES)) and set(written.values()) == {1}


def _descriptor_reads(start: int, row_bytes: int, rows: int) -> dict[tuple[int, int], int]:
    """What a wgmma reads through a K-major descriptor in the swizzle of
    ``row_bytes``-byte rows starting at byte ``start`` (8-row groups
    ``8 row_bytes`` apart): (row, byte k < 32 of its K step) -> the shared
    memory byte, the swizzle applied to the address (bits 4-5, or 4-6, XOR
    bits 7-8, or 7-9)."""
    mask = 0x30 if row_bytes == 64 else 0x70
    return {(r, k): (a := start + (r // 8) * 8 * row_bytes + (r % 8) * row_bytes + k) ^ ((a >> 3) & mask)
            for r in range(rows) for k in range(32)}


@pytest.mark.parametrize("operand", ["trunk A (x slot)", "trunk A (h1q panel)", "trunk B", "gate A", "gate B"])
def test_descriptors_read_what_the_copies_stored(operand):
    """Each wgmma's descriptors (trunk_wgmma, gate_wgmma) against the layout
    the copies and panel stores wrote, at the kernel's own addresses (the
    layout's offsets, 1 KB aligned): for every K step kk of a slice and each
    warpgroup, the byte the descriptor reads for (row, k) holds element (row,
    32 kk + k) of the operand's rows (the warpgroup's weight rows for B)."""
    lay = k2.layout(384)
    slot, panel = 2, 5  # any slot of the rings, any panel
    for wg in range(2):
        if operand.startswith("trunk"):
            steps, row_bytes, rows = range(2), 64, 64 if operand.startswith("trunk A") else 256
            base = {"trunk A (x slot)": lay["xs"][0] + slot * k2.PANEL_BYTES,
                    "trunk A (h1q panel)": lay["panels"][0] + panel * k2.PANEL_BYTES,
                    "trunk B": lay["ws"][0] + slot * k2.SLOT_BYTES}[operand]
            first = 256 * wg if operand == "trunk B" else 0
            for kk in steps:
                start = base + (256 * wg * 64 if operand == "trunk B" else 0) + 32 * kk  # + kk * kHalfDesc
                for (r, k), at in _descriptor_reads(start, row_bytes, rows).items():
                    assert at == base + k2.swizzle((first + r) * 64 + 32 * kk + k, 64)
        elif operand == "gate A":  # h2q's panels 2s and 2s + 1 hold bytes 128 s.. of the rows
            s = 1
            for kk in range(4):
                start = lay["panels"][0] + (2 * s + kk // 2) * k2.PANEL_BYTES + 32 * (kk % 2)
                for (r, k), at in _descriptor_reads(start, 64, 64).items():
                    byte = 128 * s + 32 * kk + k  # of row r of h2q
                    assert at == lay["panels"][0] + (byte // 64) * k2.PANEL_BYTES + k2.swizzle(r * 64 + byte % 64, 64)
        else:  # gate B: the warpgroup's 128 of the slot's 256 rows of 128 bytes
            base = lay["ws"][0] + slot * k2.SLOT_BYTES
            for kk in range(4):
                start = base + 128 * wg * 128 + 32 * kk
                for (r, k), at in _descriptor_reads(start, 128, 128).items():
                    assert at == base + k2.swizzle((128 * wg + r) * 128 + 32 * kk + k, 128)


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
