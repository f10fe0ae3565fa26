// The trunk and gate of the fused pooling kernels, shared by csrc/pool.cu
// (K1 and its partial mode), csrc/pool_int8.cu (K2: the int8 mma, the
// dequantization, the gate epilogue and reduce_scores; its weight stream and
// requantization are its own), csrc/pool_probe.cu (P1/P2/P5) and
// csrc/pool_int8_probe.cu (P3/P4). The probes run
// 64-row tiles through 8 warps arranged as 2 (rows) x 4 (columns), with
// weights streamed from L2 through a cp.async ring and the tile's activations
// in shared memory. Each tile streams all of the weights from L2, so the
// rows a staged slice feeds set the L2 traffic and the products between two
// barriers: K1's bf16 instance (csrc/pool.cu) has its own 128-row GEMM of
// 64 x 64 warp tiles and shares only the gate, reduce_scores (rows, threads
// and warp tile as template parameters) and pool_common.cuh. Here:
//   - bf16: gemm_pass_bf16, one 256-column pass of mma.sync m16n8k16 fed by
//     ldmatrix (3-deep ring of 32-deep slices), with a ReLU or gate epilogue;
//   - int8: gemm8, int8 (m16n8k32 s8, int32 sums) or bf16 (m16n8k16, f32
//     sums) over 64-byte slices (2-deep ring), the accumulators left in
//     registers; requant_epilogue (dequantize, ReLU, per-row requantization
//     over all 512 columns), gate_epilogue and reduce_scores for T task
//     columns.
// Every dequantization and requantization step is an explicitly rounded
// multiply, divide or add (no FMA contraction), so the integer parts of the
// GEMMs equal those of the plain versions. Everything sits in an anonymous
// namespace, as in pool_common.cuh.

#pragma once

#include <type_traits>

#include "pool_common.cuh"

namespace {

typedef unsigned char u8;

constexpr int kTileRows = 64;  // GEMM rows per tile (all bags of a block together)
constexpr int kTrunkH = 512;   // trunk width of the int8 and probe instances

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
// bf16 GEMM pass.

constexpr int kBN = 256;           // GEMM output columns per pass
constexpr int kBK = 32;            // reduction depth per staged slice
constexpr int kSBf16 = kBK + 8;    // staged row stride (elements): conflict-free ldmatrix, 16-byte cp.async
constexpr int kRingBf16 = 3;       // slices in flight in the cp.async ring

// ws[n][k] <- wt[n0 + n][k0 + k] and (kFromX) xs[r][k] <- row r of the tile:
// row row0 + r % RB of bag slot r / RB (base xb[slot], RB = 64 / NB), rows
// past the bag's end N zero-filled; always commits one group.
template <bool kFromX, int NB>
__device__ __forceinline__ void stage_bf16(const bf16* __restrict__ wt, int K, int n0, int k0, bf16* ws,
                                           const bf16* const* xb, int N, int D, int row0, bf16* xs) {
  constexpr int RB = kTileRows / NB;
  for (int i = threadIdx.x; i < kBN * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
    cp_async16(ws + r * kSBf16 + c, wt + (size_t)(n0 + r) * K + k0 + c, 16);
  }
  if (kFromX) {
    for (int i = threadIdx.x; i < kTileRows * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bf16* x = xb[NB == 1 ? 0 : r / RB];
      const int row = row0 + (NB == 1 ? r : r % RB);
      const bool ok = row < N;
      cp_async16(xs + r * kSBf16 + c, ok ? x + (size_t)row * D + k0 + c : x, ok ? 16 : 0);
    }
  }
  cp_async_commit();
}

// One pass: out[64, n0 : n0 + 256] of A[64, K] . Wt[n0 : n0 + 256, K]^T, A
// the staged x tile (kFromX; NB bags' rows as stage_bf16 lays them out) or
// the activation buffer a_s [64][lda]. A warp owns 32 rows x 64 columns = 2
// x 8 m16n8 tiles. Fragment layouts are those of PTX mma.m16n8k16 (g = lane
// / 4, q = lane % 4): C rows g, g+8 at cols 2q (+1). A fragments come from
// ldmatrix on the row-major A tile (matrices: rows 0-7 / 8-15 x cols 0-7 /
// 8-15); B fragments from ldmatrix on the staged [n][k] slice, whose rows
// are B's columns (two n-tiles per x4).
// kEpiRelu: out[r][n0 + c] = bf16(relu(acc + bias)); a gate: out[r][j] =
// bf16(gate(u_j, v_j)) over [Wa|Wb]'s columns interleaved in groups of 32
// (j = n0/2 + position within the u half).
template <int kEpi, bool kFromX, int NB>
__device__ void gemm_pass_bf16(const bf16* __restrict__ wt, int K, int n0, const float* __restrict__ bias,
                               const bf16* a_s, int lda, const bf16* const* xb, int N, int D, int row0, bf16* ws,
                               bf16* xs, bf16* out, int ldo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, q = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;
  const int n_steps = K / kBK;
  auto issue = [&](int step) {
    if (step < n_steps) {
      const int slot = step % kRingBf16;
      stage_bf16<kFromX, NB>(wt, K, n0, step * kBK, ws + slot * kBN * kSBf16, xb, N, D, row0,
                             xs + slot * kTileRows * kSBf16);
    } else {
      cp_async_commit();  // empty group: keeps one group per step for the wait count
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // the ring is free once every warp has left the previous pass
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kRingBf16 - 1; ++s) issue(s);
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kRingBf16 - 2>();  // this thread's copies of `step` have landed
    __syncthreads();                 // everyone's have, and slot (step - 1) is free
    issue(step + kRingBf16 - 1);
    const int slot = step % kRingBf16;
    const bf16* a_base = kFromX ? xs + slot * kTileRows * kSBf16 : a_s + step * kBK;
    const int la = kFromX ? kSBf16 : lda;
    const bf16* w_base = ws + slot * kBN * kSBf16;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], a_base + (wr * 32 + mi * 16 + (lane & 15)) * la + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];  // b0, b1 of n-tile 2np, then of n-tile 2np + 1
        ldsm_x4(bf, w_base + (wc * 64 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * kSBf16 + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = wr * 32 + mi * 16 + gr + hf * 8;
      if (kEpi == kEpiRelu) {
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int col = n0 + wc * 64 + ni * 8 + 2 * q;
          const float v0 = fmaxf(acc[mi][ni][2 * hf] + __ldg(bias + col), 0.f);
          const float v1 = fmaxf(acc[mi][ni][2 * hf + 1] + __ldg(bias + col + 1), 0.f);
          *reinterpret_cast<__nv_bfloat162*>(out + row * ldo + col) = __floats2bfloat162_rn(v0, v1);
        }
      } else {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int cu = n0 + wc * 64 + ni * 8 + 2 * q;  // u column; v is 32 further
          float gv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            gv[e] = gate<kEpi>(acc[mi][ni][2 * hf + e] + __ldg(bias + cu + e),
                               acc[mi][ni + 4][2 * hf + e] + __ldg(bias + cu + 32 + e));
          const int j = n0 / 2 + wc * 32 + ni * 8 + 2 * q;
          *reinterpret_cast<__nv_bfloat162*>(out + row * ldo + j) = __floats2bfloat162_rn(gv[0], gv[1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// int8 GEMMs and their epilogues.

constexpr int kBK8 = 64;             // reduction depth (bytes) per staged slice
constexpr int kS8 = kBK8 + 16;       // staged row stride: conflict-free ldmatrix, 16-byte cp.async
constexpr int kStages8 = 2;          // slices in flight in the cp.async ring
constexpr int kLdAct = kTrunkH + 16;  // int8 activation row stride (bytes)
constexpr int kLdH2 = kTrunkH + 8;    // bf16 h2 row stride (elements)
constexpr int kGateCols = 256;       // interleaved [Wa|Wb] columns per gate pass
constexpr int kColWarps = 4;

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage one 64-byte slice: ws[n][.] <- wt[n0 + n][k0 ..] (rows of kb bytes)
// for n < NT * 32 and (kFromX) xs[r][.] <- x[row0 + r][k0 ..] (rows of db
// bytes), rows past the bag's end N zero-filled; commits one group.
template <int NT, bool kFromX>
__device__ __forceinline__ void stage8(const u8* __restrict__ wt, int kb, int n0, int k0, u8* ws,
                                       const u8* __restrict__ x, int N, int db, int row0, u8* xs) {
  constexpr int kChunks = kBK8 / 16;
  for (int i = threadIdx.x; i < NT * 32 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 16;
    cp_async16(ws + r * kS8 + c, wt + (size_t)(n0 + r) * kb + k0 + c, 16);
  }
  if (kFromX) {
    for (int i = threadIdx.x; i < kTileRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 16;
      const bool ok = row0 + r < N;
      cp_async16(xs + r * kS8 + c, ok ? x + (size_t)(row0 + r) * db + k0 + c : x, ok ? 16 : 0);
    }
  }
  cp_async_commit();
}

// acc = A[64, K] . Wt[n0 : n0 + NT*32, K]^T, int8 (int32 sums) or bf16
// (kBf16: f32 sums; a 64-byte slice is then 32 bf16 values and the ldmatrix
// addresses of the two fragment layouts coincide); A the staged x tile
// (kFromX) or a_s [64][lda bytes]. Warp (wr, wc) owns rows wr*32 + mi*16 +
// {g, g+8} and columns n0 + wc*NT*8 + ni*8 + 2q (+1) (g = lane / 4, q = lane
// % 4), the accumulator layout of both m16n8k32.s8 and m16n8k16.bf16.
template <int NT, bool kFromX, bool kBf16, typename Acc>
__device__ __forceinline__ void gemm8(Acc (&acc)[2][NT][4], const u8* __restrict__ wt, int kb, int n0, const u8* a_s,
                                      int lda, const u8* __restrict__ x, int N, int db, int row0, u8* ws, u8* xs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp / kColWarps, wc = warp % kColWarps;
  const int n_steps = kb / kBK8;
  auto issue = [&](int step) {
    if (step < n_steps) {
      const int slot = step % kStages8;
      stage8<NT, kFromX>(wt, kb, n0, step * kBK8, ws + slot * kTrunkH * kS8, x, N, db, row0,
                         xs + slot * kTileRows * kS8);
    } else {
      cp_async_commit();  // empty group: keeps one group per step for the wait count
    }
  };
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // the ring is free, and the previous epilogue's writes to a_s are
  // visible, once every warp has arrived here
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kStages8 - 1; ++s) issue(s);
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages8 - 2>();  // this thread's copies of `step` have landed
    __syncthreads();                // everyone's have, and slot (step - 1) is free
    issue(step + kStages8 - 1);
    const int slot = step % kStages8;
    const u8* a_base = kFromX ? xs + slot * kTileRows * kS8 : a_s + step * kBK8;
    const int la = kFromX ? kS8 : lda;
    const u8* w_base = ws + slot * kTrunkH * kS8;
#pragma unroll
    for (int kk = 0; kk < kBK8; kk += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], a_base + (wr * 32 + mi * 16 + (lane & 15)) * la + kk + (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];  // b0, b1 of n-tile 2np, then of n-tile 2np + 1
        ldsm_x4(bf, w_base + (wc * NT * 8 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * kS8 + kk +
                        ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if constexpr (kBf16) {
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
}

// f32(y) * (s_row * s_col) + b, each step rounded (no FMA contraction)
__device__ __forceinline__ float dequant(int y, float s_row, float s_col, float b) {
  return __fadd_rn(__fmul_rn(static_cast<float>(y), __fmul_rn(s_row, s_col)), b);
}
__device__ __forceinline__ float clamp127(float v) { return fminf(fmaxf(v, -127.f), 127.f); }

// The row quantizers: q of a value v in a row of amax `amax`, and the row's
// scale.
//   kReqF32  (the JAX quantizer): scale = max(amax, 1e-6) / 127,
//            q = clip(rne(v / scale), +-127), IEEE division;
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
__device__ __forceinline__ int quant(float v, float amax, float scale) {
  if (kReq == kReqF32) return __float2int_rn(clamp127(rintf(__fdiv_rn(v, scale))));
  if (kReq == kReqBf16) {
    const float inv = bf16_round(__fdiv_rn(127.f, fmaxf(amax, 1e-6f)));
    return __float2int_rn(clamp127(rintf(bf16_round(__fmul_rn(bf16_round(v), inv)))));
  }
  return __float2int_rn(fminf(fmaxf(truncf(v), -128.f), 127.f));
}

// Trunk epilogue over all 512 columns: h = relu(dequant(acc)) (f32 sums of
// a bf16 GEMM: relu(acc + b)), h2 (kToBf16) rounded to bf16 for the pooling,
// then the row quantizer into act and the row scales into rs. rmax [64] must
// be zero on entry. A row's scale needs the amax of all 512 columns: each
// row's max is reduced over the quad of lanes that share it, then across the
// four column warps with a shared-memory atomicMax on the float bits (valid:
// every value is >= 0 after the ReLU), and after one barrier the values are
// quantized from registers into act, in place of the GEMM's own input.
template <int kReq, bool kToBf16, typename Acc>
__device__ __forceinline__ void requant_epilogue(Acc (&acc)[2][16][4], const float* __restrict__ s_col,
                                                 const float* __restrict__ bias, float* rs, float* rmax, u8* act,
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
      const float s_row = rs[row];
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
        if (kToBf16)
          *reinterpret_cast<__nv_bfloat162*>(h2 + row * kLdH2 + col) =
              __floats2bfloat162_rn(v[mi][ni][2 * hf], v[mi][ni][2 * hf + 1]);
      }
      if (kReq != kReqNone) {
        // the four lanes of a quad hold the same row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (q == 0) atomicMax(reinterpret_cast<int*>(rmax + row), __float_as_int(mx));
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
      const float amax = rmax[row];
      const float scale = row_scale<kReq>(amax);
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) {
        const int col = wc * 128 + ni * 8 + 2 * q;
        const int q0 = quant<kReq>(v[mi][ni][2 * hf], amax, scale);
        const int q1 = quant<kReq>(v[mi][ni][2 * hf + 1], amax, scale);
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

// Gate epilogue of one pass over interleaved [Wa|Wb] columns n0..n0+255:
// warp column wc holds u_j in n-tiles 0-3 and v_j (32 columns further) in
// n-tiles 4-7 for j = n0/2 + wc*32 + ni*8 + 2q (+1); gated is rounded to
// bf16 and folded into the thread's partial scores sacc[mi][hf][t] against
// the T columns of wc_s [A][T], so the gated tile never reaches shared memory.
template <int T>
__device__ __forceinline__ void gate_epilogue(int (&acc)[2][8][4], int n0, const float* rs,
                                              const float* __restrict__ swab, const float* __restrict__ bab,
                                              const float* wc_s, float (&sacc)[2][2][T]) {
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
          load_row<T>(wc_s + j * T, w);
#pragma unroll
          for (int t = 0; t < T; ++t) sacc[mi][hf][t] = fmaf(gv, w[t], sacc[mi][hf][t]);
        }
      }
    }
  }
}

// s = sum of the partial scores + bc, in a fixed order: the quad's lanes,
// then the four column warps, into s_s [R][T]; where scores is not null,
// also the raw scores [B][T][N] of the tile's rows inside the bag. R rows of
// NT threads, warp w owning MI m16 tiles from row (w / 4)*16*MI (K1's bf16
// instance: 128 rows, its own thread count and MI).
template <int T, int R = kTileRows, int NT = kThreads, int MI = 2>
__device__ __forceinline__ void reduce_scores(float (&sacc)[MI][2][T], float* spart, const float* __restrict__ bc,
                                              float* s_s, float* scores, int b, int N, int row0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp / kColWarps, wc = warp % kColWarps;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float v = sacc[mi][hf][t];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q == 0) spart[(wc * R + wr * 16 * MI + mi * 16 + g + hf * 8) * T + t] = v;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < R * T; i += NT) {
    const int r = i / T, t = i % T;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kColWarps; ++w) s += spart[(w * R + r) * T + t];
    s += __ldg(bc + t);
    s_s[i] = s;
    if (scores != nullptr && row0 + r < N) scores[((size_t)b * T + t) * N + row0 + r] = s;
  }
  __syncthreads();
}

}  // namespace
