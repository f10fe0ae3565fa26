// The trunk and gate of the fused pooling kernels, shared by csrc/pool.cu
// (K1 and its partial mode: the gate function and the bf16 constants),
// csrc/pool_int8.cu (K2: the int8 constants, swz, the dequantization and the
// row quantizers), csrc/pool_probe.cu (P1/P2/P5) and
// csrc/pool_int8_probe.cu (P3/P4). Each tile streams all of
// the weights from L2, so the rows a staged slice feeds set the L2 traffic
// and the products between two barriers. Here:
//   - bf16, 128-row tiles (the bf16 probe, P1/P2/P5, on the pass K1's bf16
//     instance ran before its GEMMs moved onto wgmma in csrc/pool.cu): one
//     CTA an SM of 8 warps of 64 x 64, gemm_rows128 (256-column passes of
//     mma.sync m16n8k16 fed by ldmatrix, weights through a 3-slot cp.async
//     ring of 32-deep slices), relu_pack / store_packed, and GEMM2's stash
//     (stash_put / stash_take), so that h1 and h2 share one region; rows of
//     one bag, or 64 of each of two (NB = 2);
//   - int8, 64-row tiles of 8 warps as 2 (rows) x 4 (columns) (the int8
//     probe, P3/P4, on the pass K2 ran before its GEMMs moved onto int8
//     wgmma in csrc/pool_int8.cu): one weight stream of 32 KB slices a tile
//     through a 3-slot swizzled cp.async ring (swz, stage_slice; the cursor
//     is the kernel's own), trunk_slice (int8 m16n8k32 s8 with int32 sums, or bf16
//     m16n8k16 with f32 sums over the same bytes) and gate_slice, the
//     accumulators left in registers; requant_rows (dequantize, ReLU, one
//     ordered amax a row over all 512 columns, the row quantizer as a
//     template argument: the JAX one through quant_row's reciprocal and two
//     Newton steps, the probe's bf16 one with one division a row, or the
//     saturating cast), gate_epilogue and reduce_scores for T task columns.
// Every dequantization and requantization step is an explicitly rounded
// multiply, divide or add (no FMA contraction but quant_row's exact
// remainders), so the integer parts of the GEMMs equal those of the plain
// versions. Everything sits in an anonymous namespace, as in
// pool_common.cuh.

#pragma once

#include <type_traits>

#include "pool_common.cuh"

namespace {

typedef unsigned char u8;

constexpr int kTileRows = 64;  // GEMM rows per tile of the int8 kernels
constexpr int kTrunkH = 512;   // trunk width of the probes and of K2

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16(v)); }

// ---------------------------------------------------------------------------
// The gate of the bf16 GEMM's epilogue: kEpiRelu = no gate (out = relu(acc +
// bias)); else a(u) * g(v) with a, g = tanh, sigmoid (kEpiTanh), the same
// through exp (kEpiExp2: 1 - 2 / (e^{2u} + 1) and 1 / (1 + e^{-v})) or linear
// (kEpiLinear: u / 8 and v / 8 + 1/2).

enum TrunkEpi { kEpiRelu = -1, kEpiTanh = 0, kEpiExp2 = 1, kEpiLinear = 2 };

template <int kEpi>
__device__ __forceinline__ float gate(float u, float v) {
  if (kEpi == kEpiExp2) return (1.f - 2.f / (expf(2.f * u) + 1.f)) * (1.f / (1.f + expf(-v)));
  if (kEpi == kEpiLinear) return (u * 0.125f) * (v * 0.125f + 0.5f);
  return tanhf(u) * sigmoidf(v);
}

// ---------------------------------------------------------------------------
// The bf16 GEMM of 128-row tiles: one CTA an SM, warps arranged as
// 128 / (16 kMi) (rows) x 4 (columns). Warp (wr, wc) owns rows wr*16*kMi +
// mi*16 + {g, g+8} (mi < kMi) and columns wc*64 + ni*8 + 2q (+1) of each
// 256-column pass (g = lane / 4, q = lane % 4), the accumulator layout of
// mma.m16n8k16. A tile holds the rows of one bag (NB = 1), or 64 rows of
// each of two bags (NB = 2: rows 0-63 of the first, 64-127 of the second).

constexpr int kColWarps = 4;
constexpr int kBN = 256;         // GEMM output columns per pass
constexpr int kBK = 32;          // reduction depth per staged slice
constexpr int kSBf16 = kBK + 8;  // staged row stride (elements): conflict-free ldmatrix, 16-byte cp.async
constexpr int kHPad = 8;         // row padding of the bf16 activation region
constexpr int kRowsBf16 = 128;   // rows a tile
constexpr int kMi = 4;           // m16 tiles a warp: 64 x 64 warp tiles, 8 warps (kMi = 2: 16 warps)
constexpr int kThreadsBf16 = 32 * kColWarps * kRowsBf16 / (16 * kMi);
constexpr int kSlotsBf16 = 3;    // slots of the cp.async ring: two slices in flight
// GEMM2's first pass waits for the second in its stash, 16 kMi packed
// registers a thread; the first half of the warp's row blocks waits in the x
// ring instead (idle in GEMM2), so that the second pass keeps its registers.
constexpr int kStashSmem = 8 * kMi;
constexpr size_t kXRingSlots = sizeof(bf16) * kSlotsBf16 * kRowsBf16 * kSBf16;
constexpr size_t kXStash = sizeof(uint32_t) * kStashSmem * kThreadsBf16;
constexpr size_t kXRingBytes = kXRingSlots > kXStash ? kXRingSlots : kXStash;  // the x ring, or the stash

// ws[n][k] <- wt[n0 + n][k0 + k] (n < 256, k < 32) and (kFromX) xs[r][k] <-
// row r of the tile (row row0 + r of bag xb[0], or for NB = 2 row row0 + r %
// 64 of bag xb[r / 64]), rows past the bag's end N zero-filled, in 16-byte
// copies; commits one group.
template <bool kFromX, int NB>
__device__ __forceinline__ void stage_rows128(const bf16* __restrict__ wt, int K, int n0, int k0, bf16* ws,
                                              const bf16* const* xb, int N, int D, int row0, bf16* xs) {
  constexpr int kChunks = kBK / 8;
  constexpr int kCopies = kRowsBf16 * kChunks / kThreadsBf16;  // x copies a thread, each of kThreadsBf16 / kChunks rows
  static_assert(NB == 1 || kRowsBf16 / NB == kThreadsBf16 / kChunks, "each x copy stays inside one bag");
#pragma unroll
  for (int j = 0; j < kBN * kChunks / kThreadsBf16; ++j) {
    const int i = threadIdx.x + j * kThreadsBf16;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    cp_async16(ws + r * kSBf16 + c, wt + (size_t)(n0 + r) * K + k0 + c, 16);
  }
  if (kFromX) {
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int i = threadIdx.x + j * kThreadsBf16;
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const int slot = NB == 1 ? 0 : j;  // copy j's rows are those of bag slot j
      const bf16* x = xb[slot];
      const int row = row0 + r - slot * (kRowsBf16 / NB);
      const bool ok = row < N;
      cp_async16(xs + r * kSBf16 + c, ok ? x + (size_t)row * D + k0 + c : x, ok ? 16 : 0);
    }
  }
  cp_async_commit();
}

// acc = A[128, K] . Wt[n0 : n0 + 256, K]^T, A the staged x tile (kFromX) or
// h [128][ldh]. A fragments come from ldmatrix on the row-major A tile, B
// fragments from ldmatrix on the staged [n][k] slice (two n-tiles an x4).
// Each output is the sum of its k16 products in ascending k.
template <bool kFromX, int NB = 1>
__device__ __forceinline__ void gemm_rows128(float (&acc)[kMi][8][4], const bf16* __restrict__ wt, int K, int n0,
                                             const bf16* h, int ldh, const bf16* const* xb, int N, int D,
                                             int row0, bf16* ws, bf16* xs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  const int n_steps = K / kBK;
  auto issue = [&](int step) {
    if (step < n_steps) {
      const int slot = step % kSlotsBf16;
      stage_rows128<kFromX, NB>(wt, K, n0, step * kBK, ws + slot * kBN * kSBf16, xb, N, D, row0,
                                xs + slot * kRowsBf16 * kSBf16);
    } else {
      cp_async_commit();  // empty group: keeps one group per step for the wait count
    }
  };
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // the ring is free, and the previous epilogue's writes to h are visible,
  // once every warp has arrived here
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSlotsBf16 - 1; ++s) issue(s);
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kSlotsBf16 - 2>();  // this thread's copies of `step` have landed
    __syncthreads();                  // everyone's have, and slot (step - 1) is free
    issue(step + kSlotsBf16 - 1);
    const int slot = step % kSlotsBf16;
    const bf16* a_base = kFromX ? xs + slot * kRowsBf16 * kSBf16 : h + step * kBK;
    const int la = kFromX ? kSBf16 : ldh;
    const bf16* w_base = ws + slot * kBN * kSBf16;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[kMi][4];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
        ldsm_x4(af[mi], a_base + (wr * 16 * kMi + mi * 16 + (lane & 15)) * la + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];  // b0, b1 of n-tile 2np, then of n-tile 2np + 1
        ldsm_x4(bf, w_base + (wc * 64 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * kSBf16 + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < kMi; ++mi) {
          mma_bf16(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
}

// The ReLU epilogue of columns n0..n0+255: packed bf16(relu(acc + bias)),
// out[mi][ni][hf] = the pair of row (mi, hf) in n-tile ni.
__device__ __forceinline__ void relu_pack(const float (&acc)[kMi][8][4], const float* __restrict__ bias, int n0,
                                          uint32_t (&out)[kMi][8][2]) {
  const int lane = threadIdx.x & 31, wc = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = n0 + wc * 64 + ni * 8 + 2 * (lane & 3);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float v0 = fmaxf(acc[mi][ni][2 * hf] + __ldg(bias + col), 0.f);
        const float v1 = fmaxf(acc[mi][ni][2 * hf + 1] + __ldg(bias + col + 1), 0.f);
        const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
        out[mi][ni][hf] = *reinterpret_cast<const uint32_t*>(&p);
      }
    }
}

// h[row][n0 + col] <- the packed pairs of relu_pack
__device__ __forceinline__ void store_packed(const uint32_t (&v)[kMi][8][2], int n0, bf16* h, int ldh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = wr * 16 * kMi + mi * 16 + (lane >> 2) + hf * 8;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
        *reinterpret_cast<uint32_t*>(h + row * ldh + n0 + wc * 64 + ni * 8 + 2 * (lane & 3)) = v[mi][ni][hf];
    }
}

// GEMM2's stash. GEMM2 writes h2 over h1, so its first 256-column pass (at
// H = 512) waits in packed bf16 until the second pass has read all of h1:
// the second row block of the warp (mi >= kMi / 2) in registers, the first in
// the x ring (stash_s [kStashSmem][threads], idle in GEMM2). A kernel runs
// the trunk as the probe does (csrc/pool_probe.cu): GEMM1 passes through
// relu_pack and store_packed into h; GEMM2's first pass into stash_put; its
// second pass; a barrier; stash_take and both passes' store_packed.
// (Wrapped in one shared function, the same trunk cost K1 five more
// registers when it ran this pass.)
__device__ __forceinline__ void stash_put(const uint32_t (&packed)[kMi][8][2], uint32_t (&stash)[kMi / 2][8][2],
                                          uint32_t* stash_s, int tid) {
#pragma unroll
  for (int mi = 0; mi < kMi / 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        stash_s[((mi * 8 + ni) * 2 + hf) * kThreadsBf16 + tid] = packed[mi][ni][hf];
        stash[mi][ni][hf] = packed[kMi / 2 + mi][ni][hf];
      }
}

// first <- the pass that stash_put kept
__device__ __forceinline__ void stash_take(uint32_t (&first)[kMi][8][2], const uint32_t (&stash)[kMi / 2][8][2],
                                           const uint32_t* stash_s, int tid) {
#pragma unroll
  for (int mi = 0; mi < kMi / 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        first[mi][ni][hf] = stash_s[((mi * 8 + ni) * 2 + hf) * kThreadsBf16 + tid];
        first[kMi / 2 + mi][ni][hf] = stash[mi][ni][hf];
      }
}

// ---------------------------------------------------------------------------
// The int8 probe's pass (P3/P4; K2's until its GEMMs moved onto wgmma, whose
// kernel keeps the constants, swz, dequant and the quantizers): 64-row tiles of 8
// warps as 2 (rows) x 4 (columns). A row's scale needs the amax of all 512
// trunk columns, so each trunk GEMM is one pass over them: warp (wr, wc) owns
// rows wr*32 + mi*16 + {g, g+8} and columns wc*128 + ni*8 + 2q (+1) (g = lane
// / 4, q = lane % 4), 128 sums a thread, the accumulator layout of both
// mma.m16n8k32.s8 and mma.m16n8k16.bf16. The weights reach the tile as one
// stream of 32 KB slices through a 3-slot cp.async ring (the kernel keeps its
// cursor and one step counter across GEMMs and tiles):
//   - trunk slices: 512 weight rows x 64 bytes, D/64 (x bf16: 2D/64) of W1,
//     each with the x tile's 64 rows x the same 64 bytes where x rides along,
//     then 8 of W2;
//   - gate slices: 256 interleaved [Wa|Wb] rows x 128 bytes, 4 a gate pass.
// The slots hold their rows without padding under a 128-byte XOR swizzle
// (swz).

constexpr int kBK8 = 64;                     // reduction depth (bytes) of a trunk slice
constexpr int kLdAct = kTrunkH + 16;         // int8 activation row stride (bytes)
constexpr int kLdH2 = kTrunkH + 8;           // bf16 h2 row stride (elements)
constexpr int kGateCols = 256;               // interleaved [Wa|Wb] columns per gate pass
constexpr int kRing8 = 3;                    // slots of the weight ring: two slices in flight
constexpr int kSlot8 = 32768;                // a weight slot: 512 trunk rows x 64 B or 256 gate rows x 128 B
constexpr int kXSlot8 = kTileRows * kBK8;    // an x slot: 64 rows x 64 B
constexpr int kGateBK8 = 128;                // reduction depth (bytes) of a gate slice
constexpr int kW2Slices = kTrunkH / kBK8;    // 8
constexpr int kGateSlices = kTrunkH / kGateBK8;  // 4 a gate pass
static_assert(kTrunkH * kBK8 == kSlot8 && kGateCols * kGateBK8 == kSlot8, "both slice shapes fill a slot");
static_assert(kSlot8 / 16 == 8 * kThreads && kXSlot8 / 16 == kThreads, "16-byte chunks per thread");

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The slots' swizzle: byte offset -> stored offset, the 16-byte chunk index
// (bits 4-6) XOR the 128-byte line index mod 8 (bits 7-9). It keeps each
// 1 KB block in place, so swz(a + 1024 m) = swz(a) + 1024 m.
__device__ __forceinline__ int swz(int off) { return off ^ ((off >> 3) & 0x70); }

// Slice s of a tile's stream into a weight slot (and, kWithX for W1, an x slot):
//   s < n1:            W1 rows 0..511 (rows of kb1 bytes), bytes 64 s.. (and x
//                      rows row0.., rows of kb1 bytes, the same bytes; rows
//                      past N zero)
//   s < n1 + 8:        W2 rows 0..511, bytes 64 (s - n1)..
//   else j = s - n1 - 8: [Wa|Wb] rows 256 (j / 4).., bytes 128 (j % 4)..
// Chunk i of a slot is 16 bytes at swz(16 i): 4 chunks a 64-B row, 8 a
// 128-B row. Commits nothing.
template <bool kWithX>
__device__ __forceinline__ void stage_slice(int s, int n1, int row0, const u8* __restrict__ w1, int kb1,
                                            const u8* __restrict__ w2, const u8* __restrict__ wab,
                                            const u8* __restrict__ xb, int N, u8* wslot, u8* xslot) {
  const int tid = threadIdx.x;
  const int off = swz(16 * tid);  // this thread's chunk in each 4 KB of a slot
  if (s < n1 + kW2Slices) {
    const bool first = s < n1;
    const u8* wt = first ? w1 : w2;
    const int kb = first ? kb1 : kTrunkH, k0 = (first ? s : s - n1) * kBK8;
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int r = (tid >> 2) + 64 * it;
      cp_async16(wslot + off + 4096 * it, wt + (size_t)r * kb + k0 + (tid & 3) * 16, 16);
    }
    if (kWithX && first) {
      const int r = tid >> 2;
      const bool ok = row0 + r < N;
      cp_async16(xslot + off, ok ? xb + (size_t)(row0 + r) * kb1 + k0 + (tid & 3) * 16 : xb, ok ? 16 : 0);
    }
  } else {
    const int j = s - n1 - kW2Slices;
    const u8* wt = wab + (size_t)(j / kGateSlices) * kGateCols * kTrunkH + (j % kGateSlices) * kGateBK8;
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int r = (tid >> 3) + 32 * it;
      cp_async16(wslot + off + 4096 * it, wt + (size_t)r * kTrunkH + (tid & 7) * 16, 16);
    }
  }
}

// acc += A[64, 64 B] . W[512, 64 B]^T for one trunk slice: A the swizzled x
// slot (kFromX) or bytes k0.. of a [64][lda] tile, W the swizzled weight
// slot. Int8 (int sums: mma m16n8k32.s8) or bf16 (float sums: a 64-byte
// slice is 32 bf16 values, mma m16n8k16.bf16, whose ldmatrix addresses are
// the int8 ones).
template <bool kFromX, typename Acc>
__device__ __forceinline__ void trunk_slice(Acc (&acc)[2][16][4], const u8* a, int lda, int k0, const u8* w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp / kColWarps, wc = warp % kColWarps;
  const int br = (lane >> 4) * 8 + (lane & 7);  // the lane's row of the 16 an x4 B load reads
#pragma unroll
  for (int kk = 0; kk < kBK8; kk += 32) {
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wr * 32 + mi * 16, k = kk + (lane >> 4) * 16;
      ldsm_x4(af[mi], kFromX ? a + r * kBK8 + swz((lane & 15) * kBK8 + k)
                             : a + (r + (lane & 15)) * lda + k0 + k);
    }
    const u8* wl = w + wc * 128 * kBK8 + swz(br * kBK8 + kk + ((lane >> 3) & 1) * 16);
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      uint32_t bf[4];  // b0, b1 of n-tile 2np, then of n-tile 2np + 1
      ldsm_x4(bf, wl + np * 16 * kBK8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if constexpr (std::is_same<Acc, float>::value) {
          mma_bf16(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        } else {
          mma_s8(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          mma_s8(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
}

// acc += h2q[64, bytes k0..k0+127] . W[256 gate rows, 128 B]^T for one gate
// slice; warp wc owns the pass's columns wc*64 + ni*8 + 2q (+1).
__device__ __forceinline__ void gate_slice(int (&acc)[2][8][4], const u8* act, int k0, const u8* w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp / kColWarps, wc = warp % kColWarps;
  const int br = (lane >> 4) * 8 + (lane & 7);
#pragma unroll
  for (int kk = 0; kk < kGateBK8; kk += 32) {
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm_x4(af[mi], act + (wr * 32 + mi * 16 + (lane & 15)) * kLdAct + k0 + kk + (lane >> 4) * 16);
    const u8* wl = w + wc * 64 * kGateBK8 + swz(br * kGateBK8 + kk + ((lane >> 3) & 1) * 16);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, wl + np * 16 * kGateBK8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_s8(acc[mi][2 * np], af[mi], bf[0], bf[1]);
        mma_s8(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
      }
    }
  }
}

// f32(y) * (s_row * s_col) + b, each step rounded (no FMA contraction)
__device__ __forceinline__ float dequant(int y, float s_row, float s_col, float b) {
  return __fadd_rn(__fmul_rn(static_cast<float>(y), __fmul_rn(s_row, s_col)), b);
}
__device__ __forceinline__ float clamp127(float v) { return fminf(fmaxf(v, -127.f), 127.f); }

// The JAX quantizer's q = clip(rne(fl(v / scale)), +-127) from the row's
// reciprocal inv = fl(1 / scale), without a division or a branch: fl(v *
// inv) is within 1.5 ulp of v / scale; one Newton step on the remainder
// (fma: v - q scale, then q + r inv) makes it faithful, and a second gives
// fl(v / scale) itself (Markstein: inv correctly rounded, q within an ulp;
// no underflow matters, since a quotient under 1/2 rounds to 0 either way).
__device__ __forceinline__ int quant_row(float v, float scale, float inv) {
  float y = __fmul_rn(v, inv);
  y = __fmaf_rn(__fmaf_rn(-y, scale, v), inv, y);
  y = __fmaf_rn(__fmaf_rn(-y, scale, v), inv, y);
  return __float2int_rn(clamp127(rintf(y)));
}

// The row quantizers: a row of amax `amax` gets its scale and a reciprocal
// once (row_scale, row_inv), then q of each value v (quant).
//   kReqF32  (the JAX quantizer): scale = max(amax, 1e-6) / 127, inv =
//            fl(1 / scale), q = clip(rne(v / scale), +-127) with the IEEE
//            quotient (quant_row);
//   kReqBf16 (the probe's _requant_rows_bf16): inv = bf16(127 / max(amax,
//            1e-6)), q = clip(rne(bf16(bf16(v) * inv)), +-127), scale =
//            amax / 127;
//   kReqNone (the probe's requant=False): the f32 -> int8 cast, truncated
//            toward zero and saturated to [-128, 127], scale 1.
enum Requant { kReqF32 = 0, kReqBf16 = 1, kReqNone = 2 };

template <int kReq>
__device__ __forceinline__ float row_scale(float amax) {
  if (kReq == kReqF32) return __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
  if (kReq == kReqBf16) return __fdiv_rn(amax, 127.f);
  return 1.f;
}
template <int kReq>
__device__ __forceinline__ float row_inv(float amax, float scale) {
  if (kReq == kReqF32) return __fdiv_rn(1.f, scale);
  if (kReq == kReqBf16) return bf16_round(__fdiv_rn(127.f, fmaxf(amax, 1e-6f)));
  return 1.f;
}
template <int kReq>
__device__ __forceinline__ int quant(float v, float scale, float inv) {
  if (kReq == kReqF32) return quant_row(v, scale, inv);
  if (kReq == kReqBf16) return __float2int_rn(clamp127(rintf(bf16_round(__fmul_rn(bf16_round(v), inv)))));
  return __float2int_rn(fminf(fmaxf(truncf(v), -128.f), 127.f));
}

// Trunk epilogue over all 512 columns: h = relu(dequant(acc)) (the float
// sums of a bf16 GEMM: relu(acc + b)), h2 (kToH2) rounded to bf16 for the
// pooling, then the row quantizer into act and the rows' scales into rs.
// Each row's amax: the max over its quad of lanes, each column warp's into
// amax_s [4][64], and after one barrier the max of the four in column-warp
// order (no atomics); the values are quantized from registers into act, in
// place of the GEMM's own input.
template <int kReq, bool kToH2, typename Acc>
__device__ __forceinline__ void requant_rows(Acc (&acc)[2][16][4], const float* __restrict__ s_col,
                                             const float* __restrict__ bias, float* rs, float* amax_s, u8* act,
                                             bf16* h2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp / kColWarps, wc = warp % kColWarps;
  float v[2][16][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = wr * 32 + mi * 16 + g + hf * 8;
      const float s_row = std::is_same<Acc, float>::value ? 1.f : rs[row];
      float mx = 0.f;
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) {
        const int col = wc * 128 + ni * 8 + 2 * q;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float h;
          if constexpr (std::is_same<Acc, float>::value)
            h = __fadd_rn(acc[mi][ni][2 * hf + e], __ldg(bias + col + e));
          else
            h = dequant(acc[mi][ni][2 * hf + e], s_row, __ldg(s_col + col + e), __ldg(bias + col + e));
          h = fmaxf(h, 0.f);
          v[mi][ni][2 * hf + e] = h;
          mx = fmaxf(mx, h);
        }
        if (kToH2)
          *reinterpret_cast<__nv_bfloat162*>(h2 + row * kLdH2 + col) =
              __floats2bfloat162_rn(v[mi][ni][2 * hf], v[mi][ni][2 * hf + 1]);
      }
      if (kReq != kReqNone) {
        // the four lanes of a quad hold the same row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (q == 0) amax_s[wc * kTileRows + row] = mx;
      }
    }
  }
  // every row's amax is known, and every warp has finished reading act (the
  // GEMM's input) and rs
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = wr * 32 + mi * 16 + g + hf * 8;
      const float amax = kReq == kReqNone ? 0.f
                                          : fmaxf(fmaxf(amax_s[row], amax_s[kTileRows + row]),
                                                  fmaxf(amax_s[2 * kTileRows + row], amax_s[3 * kTileRows + row]));
      const float scale = row_scale<kReq>(amax);
      const float inv = row_inv<kReq>(amax, scale);
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) {
        const int col = wc * 128 + ni * 8 + 2 * q;
        const int q0 = quant<kReq>(v[mi][ni][2 * hf], scale, inv);
        const int q1 = quant<kReq>(v[mi][ni][2 * hf + 1], scale, inv);
        *reinterpret_cast<uint16_t*>(act + row * kLdAct + col) = static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
      }
      if (wc == 0 && q == 0) rs[row] = scale;
    }
  }
}

// w[t] <- p[t], t < T (p 16-byte aligned where T % 4 == 0)
template <int T>
__device__ __forceinline__ void load_row(const float* p, float (&w)[T]) {
  if constexpr (T % 4 == 0) {
#pragma unroll
    for (int k = 0; k < T / 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(p)[k];
      w[4 * k] = v.x; w[4 * k + 1] = v.y; w[4 * k + 2] = v.z; w[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < T; ++t) w[t] = p[t];
  }
}

// w[t] <- p[t], t < 8, from 8 bf16 values in device memory (one 16-byte read)
__device__ __forceinline__ void load_row(const bf16* __restrict__ p, float (&w)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(pair[k]);
    w[2 * k] = f.x;
    w[2 * k + 1] = f.y;
  }
}

// Gate epilogue of one pass over interleaved [Wa|Wb] columns n0..n0+255:
// warp column wc holds u_j in n-tiles 0-3 and v_j (32 columns further) in
// n-tiles 4-7 for j = n0/2 + wc*32 + ni*8 + 2q (+1); gated is rounded to
// bf16 and folded into the thread's partial scores sacc[mi][hf][t] against
// the T columns of wc_w [A][T] (f32 in shared memory, or 8 bf16 columns in
// device memory), so the gated tile never reaches shared memory.
template <int T, typename W>
__device__ __forceinline__ void gate_epilogue(int (&acc)[2][8][4], int n0, const float* rs,
                                              const float* __restrict__ swab, const float* __restrict__ bab,
                                              const W* wc_w, float (&sacc)[2][2][T]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp / kColWarps, wc = warp % kColWarps;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float s_row = rs[wr * 32 + mi * 16 + g + hf * 8];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cu = n0 + wc * 64 + ni * 8 + 2 * q + e;
          const float u = dequant(acc[mi][ni][2 * hf + e], s_row, __ldg(swab + cu), __ldg(bab + cu));
          const float v = dequant(acc[mi][ni + 4][2 * hf + e], s_row, __ldg(swab + cu + 32), __ldg(bab + cu + 32));
          const float gv = bf16_round(tanhf(u) * sigmoidf(v));
          const int j = n0 / 2 + wc * 32 + ni * 8 + 2 * q + e;
          float w[T];
          load_row(wc_w + j * T, w);
#pragma unroll
          for (int t = 0; t < T; ++t) sacc[mi][hf][t] = fmaf(gv, w[t], sacc[mi][hf][t]);
        }
      }
    }
  }
}

// s = sum of the partial scores + bc, in a fixed order: the quad's lanes,
// then the four column warps, into s_s [64][T]; where scores is not null,
// also the raw scores [B][T][N] of the tile's rows inside the bag.
template <int T>
__device__ __forceinline__ void reduce_scores(float (&sacc)[2][2][T], float* spart, const float* __restrict__ bc,
                                              float* s_s, float* scores, int b, int N, int row0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp / kColWarps, wc = warp % kColWarps;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float v = sacc[mi][hf][t];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q == 0) spart[(wc * kTileRows + wr * 32 + mi * 16 + g + hf * 8) * T + t] = v;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kTileRows * T; i += kThreads) {
    const int r = i / T, t = i % T;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kColWarps; ++w) s += spart[(w * kTileRows + r) * T + t];
    s += __ldg(bc + t);
    s_s[i] = s;
    if (scores != nullptr && row0 + r < N) scores[((size_t)b * T + t) * N + row0 + r] = s;
  }
  __syncthreads();
}

}  // namespace
