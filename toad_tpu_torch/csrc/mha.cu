// Multi-head self-attention core of the ViT encoder, hand-written for Hopper
// (sm_90a).
//
// Replaces toad_tpu/ops/vit_attention.py:42 _mha_kernel (the TPU kernel K3).
// Per image b and head h, over the raw qkv projection [B, N, 3*H*Dh] with
// columns [q_h0..|k_h0..|v_h0..]:
//     s = q k^T (f32) * Dh^-1/2;  p = softmax(s) (f32), rounded to the input
//     dtype;  o = p v (f32 accumulate), rounded once;  heads concatenated
//     into out [B, N, H*Dh].
// These are the TPU kernel's rounding points. The [N, N] scores never reach
// device memory.
//
// What bounds it on an H100: it must read qkv and write the context once,
// 8 bytes per 4*N multiply-adds of a (token, head-dim) element in bf16: at
// N = 197 that is ~99 FLOP/byte against the card's ~295, so it is bound by
// bytes (103.3 MB, 0.031 ms at B=64 x 197, H=16), and its 10.2 GFLOP take
// 0.010 ms even at wgmma's peak and ~0.02 at mma.sync's. wgmma and TMA
// tensor maps would not move that bound; what matters is moving each byte
// once and keeping the loads in flight while the tensor cores work.
//
// What held the first design back (one block of 4 warps per image, head and
// 64 query rows):
//   1. K and V staged four times: each of an (image, head)'s 4 query blocks
//      loaded all of K and V, ~240 MB of loads against 77.5 MB of qkv;
//   2. a quarter of the blocks staged a full K and V for 5 query rows
//      (197 = 3 * 64 + 5);
//   3. 2 resident blocks an SM (198 registers x 128 threads), 8 warps;
//   4. no overlap: a block loaded, computed, stored and exited, and only the
//      other resident block could hide its loads.
// What this design does about each:
//   1, 2. The unit of work is one (image, head). Its Q, K and V rows (N
//      padded to a multiple of 16, padding zero-filled; 144-byte rows,
//      conflict-free for ldmatrix) are staged into shared memory once, and
//      the block's warps take its ceil(N/16) sixteen-row query tiles in turn.
//   3, 4. A persistent grid: as many blocks as fit on the card (one an SM),
//      each walking the units blockIdx.x, + gridDim.x, ... One producer warp
//      stages unit k + 1 into the second of two shared-memory buffers with
//      cp.async while 7 consumer warps compute unit k from the first; each
//      buffer has a "full" mbarrier (the producer lanes' cp.async completions
//      arrive on it: cp.async.mbarrier.arrive.noinc) and an "empty" one (each
//      consumer warp arrives when done with the unit). No block-wide barrier
//      follows the prologue, so a warp that ends its tiles of unit k starts
//      on unit k + 1 at once, and the tile -> warp assignment continues from
//      unit to unit (see walk_units). Where
//      two buffers do not fit (N > 208: 272-row buffers) the same code runs
//      with one, and a unit's loads wait for the one before it to finish.
//
// The bf16 tile body is the first design's: per warp 16 query rows, S = Q K^T
// by mma.sync m16n8k16 over all keys at once into f32 registers (padded key
// columns set to -inf before the row max, so no online softmax), the row
// softmax in registers with quad shuffles (normalised by the row's reciprocal
// sum before the rounding to bf16), P rounded to bf16 straight into A
// fragments, P V with ldmatrix.trans on V, the context staged in the tile's
// spent Q rows and written as whole 128-byte head rows. The f32 instance uses
// FMA so that f32 stays f32 (no TF32); it stages K and V (272-byte rows) and
// reads its q rows through L1. Its loops are register-tiled: a lane holds 4
// query rows x N/8 keys of scores (each float4 of K feeds 16 FMAs) and 4 rows
// x 8 head columns of the context (each p, shuffled from the lane that holds
// it, feeds 8 FMAs); its K3 softmax multiplies each p by the row's reciprocal
// sum, as the bf16 instance does (the first design divided each p).
//
// P7, the softmax variant of experiments/vit_softmax_probe.py:44
// _mha_kernel_new, is a second instance of both kernels (template argument
// SM = kSoftmaxP7):
//     c = Dh^-1/2 * log2(e) (formed in f64 by the caller, passed as f32);
//     qs = q * c in f32, rounded to the input dtype;  s = qs k^T (f32);
//     p = exp2(s - rowmax) kept in f32;  denom = sum of that f32 p;
//     o = p (rounded to the input dtype) v, f32 accumulate;  o / denom (a true
//     division) rounded once.
// The rescale of q happens on the A fragments in registers, element by
// element; the unrounded f32 p feeds the row sum, its bf16 rounding the P V
// product; the division uses __fdiv_rn (the build has no fast-math flags).
// Padded key columns are -inf before the row max (exp2 -> 0) and padded V
// rows zero, as in K3. Same grid, shared memory and bound as K3.

#include <algorithm>
#include <cmath>

#include "pool_common.cuh"

namespace {

constexpr int kDh = 64;                          // head size the instances are written for
// warps that compute; one more warp stages the units. 8 warps are 2 on each of an SM's four
// schedulers, which leaves a thread up to 255 registers; 12 warps (3 a scheduler, so at most 168
// registers) measured slower on an H100.
constexpr int kConsumers = 7;
constexpr int kMhaThreads = 32 * (kConsumers + 1);
constexpr int kLd = kDh + 8;                     // bf16 row stride in shared memory: 144 B, conflict-free ldmatrix
constexpr int kLdF = kDh + 4;                    // f32 row stride: 272 B, 16-B rows, conflict-free float4 reads
constexpr int kMaxKeyTiles = 17;                 // bf16: 16-key tiles whose scores one thread holds (N <= 272)
constexpr int kSmallKeyTiles = 13;               // the smaller bf16 instance (N <= 208: ViT at 224 px)
constexpr int kMaxKeysPerLane = 34;              // f32: keys whose scores one lane holds, N <= 8 * 34 = 272
constexpr int kSmallKeysPerLane = 26;            // the smaller f32 instance (N <= 208)
constexpr int kMaxSmem = 232448;                 // shared memory a block can opt in to on sm_90
constexpr int kMaxDynSmem = kMaxSmem - 64;       // less the static mbarriers
constexpr int kSoftmaxK3 = 0;                    // softmax of K3: scale after q k^T, exp, p normalised before rounding
constexpr int kSoftmaxP7 = 1;                    // softmax of P7: q pre-scaled by c, exp2, the context divided at the end

// Whether a sequence takes the smaller instance, which spares registers, and the key rows its
// instance covers (bf16 16 a key tile; f32 8 a key slot, one lane each)
__host__ __device__ inline bool small_instance(int N) { return N <= kSmallKeyTiles * 16; }
__host__ __device__ inline int instance_rows(bool bf16_io, int N) {
  return bf16_io ? (small_instance(N) ? kSmallKeyTiles : kMaxKeyTiles) * 16
                 : (small_instance(N) ? kSmallKeysPerLane : kMaxKeysPerLane) * 8;
}
// one unit's buffer, every row of the instance (rows past N zero-filled, so the loops need no
// bounds): bf16 Q, K, V [rows][kLd]; f32 K, V [rows][kLdF]
__host__ __device__ inline size_t stage_bytes(bool bf16_io, int N) {
  const size_t rows = instance_rows(bf16_io, N);
  return bf16_io ? sizeof(bf16) * 3 * rows * kLd : sizeof(float) * 2 * rows * kLdF;
}
// two buffers where they fit (the next unit lands while this one computes), else one
__host__ __device__ inline int n_stages(bool bf16_io, int N) { return 2 * stage_bytes(bf16_io, N) <= kMaxDynSmem ? 2 : 1; }
__host__ __device__ inline size_t smem_bytes(bool bf16_io, int N) { return n_stages(bf16_io, N) * stage_bytes(bf16_io, N); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two packed bf16 values times c in f32, each rounded back to bf16
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float c) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return pack_bf16(__low2float(x) * c, __high2float(x) * c);
}

// -inf into the score columns at or past N when tile C is the first that reaches past it: that tile
// in part, every later tile whole
template <int KT, int C>
__device__ __forceinline__ void mask_from_tile(float (&s)[KT][2][4], int N, int q) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (C * 16 + hf * 8 + 2 * q + (e & 1) >= N) s[C][hf][e] = -INFINITY;
#pragma unroll
  for (int kt = C + 1; kt < KT; ++kt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[kt][hf][e] = -INFINITY;
}
// one jump to the tile the sequence ends in, instead of a compare and a select for every score
// (with the exact q prescale of bf16_tile, measured faster on an H100 than masking every score)
template <int KT>
__device__ __forceinline__ void mask_padding(float (&s)[KT][2][4], int N, int q) {
  static_assert(KT <= 17, "add cases");
  switch (N >> 4) {
#define MHA_MASK_CASE(c) \
  case c:                \
    if constexpr (c < KT) mask_from_tile<KT, c>(s, N, q); \
    break;
    MHA_MASK_CASE(0) MHA_MASK_CASE(1) MHA_MASK_CASE(2) MHA_MASK_CASE(3) MHA_MASK_CASE(4) MHA_MASK_CASE(5)
    MHA_MASK_CASE(6) MHA_MASK_CASE(7) MHA_MASK_CASE(8) MHA_MASK_CASE(9) MHA_MASK_CASE(10) MHA_MASK_CASE(11)
    MHA_MASK_CASE(12) MHA_MASK_CASE(13) MHA_MASK_CASE(14) MHA_MASK_CASE(15) MHA_MASK_CASE(16)
#undef MHA_MASK_CASE
    default:
      break;
  }
}

// -- mbarriers (shared::cta) ------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(smem_addr(bar)) : "memory");
}
// arrives on bar once every cp.async this thread started before it has landed
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// waits until the phase of the given parity has completed (labels are local to the braces)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The producer/consumer walk shared by both dtypes. The producer warp stages
// unit k into buffer k % stages once the consumers have released that
// buffer's previous unit; consumer warp w waits for unit k, runs tile(u, t,
// buffer) on its tiles t of the unit and releases the buffer. Tile t of unit
// k is item k * n_tiles + t of the block, and item i goes to warp
// i % kConsumers: a warp's tiles continue from unit to unit, so the 13 tiles
// of a 197-token unit spread evenly over the warps. (Claiming tiles from a
// counter in shared memory instead measured slower on an H100.)
// `stage(u, buf, lane)` starts one lane's share of a unit's cp.async copies.
template <typename Stage, typename Tile>
__device__ __forceinline__ void walk_units(unsigned char* smem, size_t stage_size, int stages, int units, int n_tiles,
                                           Stage stage, Tile tile) {
  __shared__ __align__(8) uint64_t full[2], empty[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);           // the producer's lanes, one cp.async arrival each
      mbar_init(&empty[s], kConsumers);  // one arrival per consumer warp
    }
  }
  __syncthreads();
  const int n_mine = (units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (warp == kConsumers) {
    for (int k = 0; k < n_mine; ++k) {
      const int s = k % stages;
      if (k >= stages) mbar_wait(&empty[s], (k / stages - 1) & 1);
      stage((int)blockIdx.x + k * (int)gridDim.x, smem + s * stage_size, lane);
      cp_async_mbar_arrive(&full[s]);
    }
    cp_async_wait<0>();
    return;
  }
  int first = warp;  // this warp's first tile of unit k: (warp - k * n_tiles) mod kConsumers
  for (int k = 0; k < n_mine; ++k) {
    const int s = k % stages;
    mbar_wait(&full[s], (k / stages) & 1);
    for (int t = first; t < n_tiles; t += kConsumers) tile((int)blockIdx.x + k * (int)gridDim.x, t, smem + s * stage_size);
    first = ((first - n_tiles) % kConsumers + kConsumers) % kConsumers;
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// ---------------------------------------------------------------------------
// bf16: KT = number of 16-key tiles the instance unrolls (a thread holds
// 8 * KT scores of its two rows). Every tile is computed: K and V rows past
// the sequence's end are zero, their scores are masked to -inf (p = 0), and
// no branch splits the loops, so the compiler can overlap one key tile's
// ldmatrix with the products of the one before.
// Fragment layouts are those of PTX mma.m16n8k16 (g = lane / 4, q = lane % 4):
// C rows g, g+8 at cols 2q (+1); the C fragments of two neighbouring 8-key
// score tiles are exactly the A fragment of the 16-key step of P V.
// SM: kSoftmaxK3 (scale = Dh^-1/2) or kSoftmaxP7 (scale = c, see the top).
template <int KT, int SM>
__device__ __forceinline__ void bf16_tile(bf16* q_s, const bf16* k_s, const bf16* v_s, int N, float scale, bf16* out,
                                          int rows, size_t out_ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  uint32_t qf[kDh / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) ldsm_x4(qf[kk], q_s + (lane & 15) * kLd + kk * 16 + (lane >> 4) * 8);
  // K3: scale = Dh^-1/2 = 2^-3 is a power of two (checked by the launcher), so q * scale is exact in
  // bf16 and every f32 partial sum of the product scales exactly: the scores equal (q k^T) * scale to
  // the bit, for 16 multiplies a tile instead of 104. P7: q * c rounded to bf16 (its rounding point).
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if constexpr (SM == kSoftmaxK3) {
        const __nv_bfloat162 x = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&qf[kk][r]), __float2bfloat162_rn(scale));
        qf[kk][r] = *reinterpret_cast<const uint32_t*>(&x);
      } else {
        qf[kk][r] = scale_bf16x2(qf[kk][r], scale);
      }
    }
  float s[KT][2][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[kt][hf][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      uint32_t kf[4];  // b0, b1 of keys kt*16.., then of keys kt*16 + 8..
      ldsm_x4(kf, k_s + (kt * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd + kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[kt][0], qf[kk], kf[0], kf[1]);
      mma_bf16(s[kt][1], qf[kk], kf[2], kf[3]);
    }
  }

  // row softmax in f32: elements 0, 1 belong to row g, elements 2, 3 to row g + 8
  mask_padding<KT>(s, N, q);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[kt][hf][e]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = SM == kSoftmaxK3 ? expf(s[kt][hf][e] - mx[e >> 1]) : exp2f(s[kt][hf][e] - mx[e >> 1]);
        s[kt][hf][e] = p;
        sum[e >> 1] += p;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }
  if constexpr (SM == kSoftmaxK3) {
    // one IEEE division per row; a division per score cost a third of the kernel's time
    const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[kt][hf][e] = s[kt][hf][e] * inv[e >> 1];
  }

  float o[kDh / 8][4];
#pragma unroll
  for (int nt = 0; nt < kDh / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    // P rounded to bf16, the A fragment of this 16-key step
    const uint32_t pf[4] = {pack_bf16(s[kt][0][0], s[kt][0][1]), pack_bf16(s[kt][0][2], s[kt][0][3]),
                            pack_bf16(s[kt][1][0], s[kt][1][1]), pack_bf16(s[kt][1][2], s[kt][1][3])};
#pragma unroll
    for (int np = 0; np < kDh / 16; ++np) {
      uint32_t vf[4];  // b0, b1 of head columns np*16.., then of np*16 + 8..
      ldsm_x4_trans(vf, v_s + (kt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd + np * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * np], pf, vf[0], vf[1]);
      mma_bf16(o[2 * np + 1], pf, vf[2], vf[3]);
    }
  }

  if constexpr (SM == kSoftmaxP7) {
#pragma unroll
    for (int nt = 0; nt < kDh / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = __fdiv_rn(o[nt][e], sum[e >> 1]);
  }

  // the tile's 16 query rows in shared memory are spent (they sit in qf):
  // stage the context there and write whole 128-byte head rows
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < kDh / 8; ++nt) {
    *reinterpret_cast<uint32_t*>(q_s + g * kLd + nt * 8 + 2 * q) = pack_bf16(o[nt][0], o[nt][1]);
    *reinterpret_cast<uint32_t*>(q_s + (g + 8) * kLd + nt * 8 + 2 * q) = pack_bf16(o[nt][2], o[nt][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * (kDh / 8); i += 32) {
    const int r = i / (kDh / 8), c = (i % (kDh / 8)) * 8;
    if (r < rows)
      *reinterpret_cast<uint4*>(out + r * out_ld + c) = *reinterpret_cast<const uint4*>(q_s + r * kLd + c);
  }
}

template <int KT, int SM>
__global__ void __launch_bounds__(kMhaThreads, 1)
mha_bf16_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H, int units, int stages, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int n_pad = KT * 16;
  const int n_qt = (N + 15) / 16;
  const int D = H * kDh;
  const size_t ld = 3 * (size_t)D;

  // one lane's share of unit u's Q, K and V rows: lane / 8 picks the row, lane % 8 the 16-byte piece.
  // Rows past the sequence's end are zero-filled (a padded V row meets p = 0 and must not be NaN).
  auto stage = [&](int u, unsigned char* buf, int lane) {
    const bf16* base = qkv + (size_t)(u / H) * N * ld + (u % H) * kDh;  // q of token 0; k at +D, v at +2D
    bf16* dst = reinterpret_cast<bf16*>(buf);
    const int c = (lane & 7) * 8;
    for (int m = 0; m < 3; ++m)
      for (int r = lane >> 3; r < n_pad; r += 4) {
        const bool ok = r < N;
        cp_async16(dst + (m * n_pad + r) * kLd + c, ok ? base + (size_t)r * ld + m * D + c : base, ok ? 16 : 0);
      }
  };
  auto tile = [&](int u, int t, unsigned char* buf) {
    bf16* q_s = reinterpret_cast<bf16*>(buf);
    const int row0 = t * 16;
    bf16_tile<KT, SM>(q_s + row0 * kLd, q_s + n_pad * kLd, q_s + 2 * n_pad * kLd, N, scale,
                      out + ((size_t)(u / H) * N + row0) * D + (u % H) * kDh, min(16, N - row0), (size_t)D);
  };
  walk_units(smem, stage_bytes(true, N), stages, units, n_qt, stage, tile);
}

// ---------------------------------------------------------------------------
// f32: KPL = keys per lane the instance unrolls (8 * KPL key rows staged,
// those past N zero; as in bf16 the loops cover them all, unbranched).
// A warp's 16 query rows: lane / 8 holds rows 4 * (lane / 8) ..+3,
// lane % 8 = i holds the scores of keys i, i + 8, .. and context columns
// 4i..4i+3 and 32 + 4i..+3. Each score is summed over the head dimension in
// order with fmaf, as the first design did. SM as in the bf16 kernel.
template <int KPL, int SM>
__device__ __forceinline__ void f32_tile(const float* qkv_q, const float* k_s, const float* v_s, int N, int row0,
                                         float scale, size_t ld, float* out, size_t out_ld) {
  const int lane = threadIdx.x & 31, ki = lane & 7, r0 = row0 + (lane >> 3) * 4;
  float s[4][KPL];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < KPL; ++j) s[r][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < kDh; d += 4) {
    float4 qv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // a row past the end reads the last row (no branch: the shuffles below need the warp converged);
      // its context is not stored
      qv[r] = __ldg(reinterpret_cast<const float4*>(qkv_q + (size_t)min(r0 + r, N - 1) * ld + d));
      if constexpr (SM == kSoftmaxP7) {
        qv[r].x *= scale;
        qv[r].y *= scale;
        qv[r].z *= scale;
        qv[r].w *= scale;
      }
    }
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(k_s + (ki + 8 * j) * kLdF + d);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[r][j] = fmaf(qv[r].x, kv.x, s[r][j]);
        s[r][j] = fmaf(qv[r].y, kv.y, s[r][j]);
        s[r][j] = fmaf(qv[r].z, kv.z, s[r][j]);
        s[r][j] = fmaf(qv[r].w, kv.w, s[r][j]);
      }
    }
  }

  // row softmax: a row's keys are spread over the 8 lanes of its group
  float mx[4], sum[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) mx[r] = -INFINITY;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if constexpr (SM == kSoftmaxK3) s[r][j] *= scale;
    if (__builtin_expect(8 * j + 8 > N, 0)) {  // only key slots that reach past the end hold padding
      const bool pad = ki + 8 * j >= N;
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r][j] = pad ? -INFINITY : s[r][j];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) mx[r] = fmaxf(mx[r], s[r][j]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
    sum[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float p = SM == kSoftmaxK3 ? expf(s[r][j] - mx[r]) : exp2f(s[r][j] - mx[r]);
      s[r][j] = p;
      sum[r] += p;
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
  }
  if constexpr (SM == kSoftmaxK3) {
    float inv[4];  // one IEEE division per row, as in the bf16 instance
#pragma unroll
    for (int r = 0; r < 4; ++r) inv[r] = 1.f / sum[r];
#pragma unroll
    for (int j = 0; j < KPL; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r][j] = s[r][j] * inv[r];
  }

  // P V over the keys in order: key 8j + i's p comes from lane (lane & ~7) | i
  float o[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) o[r][c] = 0.f;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
#pragma unroll 2
    for (int i = 0; i < 8; ++i) {
      const float* vrow = v_s + (8 * j + i) * kLdF + 4 * ki;
      const float4 va = *reinterpret_cast<const float4*>(vrow);
      const float4 vb = *reinterpret_cast<const float4*>(vrow + 32);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = __shfl_sync(0xffffffffu, s[r][j], (lane & ~7) | i);
        o[r][0] = fmaf(p, va.x, o[r][0]);
        o[r][1] = fmaf(p, va.y, o[r][1]);
        o[r][2] = fmaf(p, va.z, o[r][2]);
        o[r][3] = fmaf(p, va.w, o[r][3]);
        o[r][4] = fmaf(p, vb.x, o[r][4]);
        o[r][5] = fmaf(p, vb.y, o[r][5]);
        o[r][6] = fmaf(p, vb.z, o[r][6]);
        o[r][7] = fmaf(p, vb.w, o[r][7]);
      }
    }
  }
  if constexpr (SM == kSoftmaxP7) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) o[r][c] = __fdiv_rn(o[r][c], sum[r]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r0 + r < N) {
      float* orow = out + (size_t)(r0 + r) * out_ld + 4 * ki;
      *reinterpret_cast<float4*>(orow) = make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
      *reinterpret_cast<float4*>(orow + 32) = make_float4(o[r][4], o[r][5], o[r][6], o[r][7]);
    }
  }
}

template <int KPL, int SM>
__global__ void __launch_bounds__(kMhaThreads, 1)
mha_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int N, int H, int units, int stages, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int n_pad = KPL * 8;
  const int n_qt = (N + 15) / 16;
  const int D = H * kDh;
  const size_t ld = 3 * (size_t)D;

  // one lane's share of unit u's K and V rows: lane / 16 picks the row, lane % 16 the 16-byte piece
  auto stage = [&](int u, unsigned char* buf, int lane) {
    const float* base = qkv + (size_t)(u / H) * N * ld + (u % H) * kDh;
    float* dst = reinterpret_cast<float*>(buf);
    const int c = (lane & 15) * 4;
    for (int m = 0; m < 2; ++m)
      for (int r = lane >> 4; r < n_pad; r += 2) {
        const bool ok = r < N;
        cp_async16(dst + (m * n_pad + r) * kLdF + c, ok ? base + (size_t)r * ld + (m + 1) * D + c : base, ok ? 16 : 0);
      }
  };
  auto tile = [&](int u, int t, unsigned char* buf) {
    const float* k_s = reinterpret_cast<const float*>(buf);
    const size_t img = (size_t)(u / H) * N;
    f32_tile<KPL, SM>(qkv + img * ld + (u % H) * kDh, k_s, k_s + n_pad * kLdF, N, t * 16, scale, ld,
                      out + img * D + (u % H) * kDh, (size_t)D);
  };
  walk_units(smem, stage_bytes(false, N), stages, units, n_qt, stage, tile);
}

template <typename T>
int launch_mha(void (*kernel)(const T*, T*, int, int, int, int, float), const void* qkv, void* out, int B, int N, int H,
               float scale, cudaStream_t stream) {
  const bool bf16_io = sizeof(T) == 2;
  const size_t smem = smem_bytes(bf16_io, N);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMhaThreads, smem)) != cudaSuccess)
    return (int)err;
  const int units = B * H;
  const int grid = std::min(units, sms * std::max(per_sm, 1));
  kernel<<<grid, kMhaThreads, smem, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out), N, H, units,
                                              n_stages(bf16_io, N), scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The head size the kernel is written for.
int toad_mha_head_dim() { return kDh; }

// The longest sequence an instance takes (0 = float32, 1 = bfloat16): a
// thread holds its query rows' scores over all keys in registers.
int toad_mha_max_tokens(int dtype) { return dtype == 1 ? kMaxKeyTiles * 16 : kMaxKeysPerLane * 8; }

// Dynamic shared memory of one block in bytes: one unit's buffer, twice
// where two fit.
long long toad_mha_smem_bytes(int dtype, int N) { return (long long)smem_bytes(dtype == 1, N); }

// Launches the attention kernel on `stream` over qkv [B, N, 3*H*64] into out
// [B, N, H*64]: softmax 0 = K3 (scale = Dh^-1/2 = 1/8, a power of two), 1 = P7
// (scale = c, see the top); returns the launch's cudaError_t (0 on success;
// cudaErrorInvalidValue for a shape no instance takes). Does not synchronise.
int toad_mha_forward(int softmax, int dtype, const void* qkv, void* out, int B, int N, int H, int head_dim,
                     float scale, void* stream) {
  if ((softmax != kSoftmaxK3 && softmax != kSoftmaxP7) || head_dim != kDh || B < 1 || N < 1 || H < 1 ||
      H > 65535 || N > toad_mha_max_tokens(dtype) || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int exponent = 0;
  if (softmax == kSoftmaxK3 && frexpf(scale, &exponent) != 0.5f) return (int)cudaErrorInvalidValue;  // see bf16_tile
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool p7 = softmax == kSoftmaxP7;
  const bool small = small_instance(N);
  if (dtype != 1)
    return launch_mha<float>(small ? (p7 ? mha_f32_kernel<kSmallKeysPerLane, kSoftmaxP7>
                                         : mha_f32_kernel<kSmallKeysPerLane, kSoftmaxK3>)
                                   : (p7 ? mha_f32_kernel<kMaxKeysPerLane, kSoftmaxP7>
                                         : mha_f32_kernel<kMaxKeysPerLane, kSoftmaxK3>),
                             qkv, out, B, N, H, scale, s);
  return launch_mha<bf16>(small ? (p7 ? mha_bf16_kernel<kSmallKeyTiles, kSoftmaxP7>
                                      : mha_bf16_kernel<kSmallKeyTiles, kSoftmaxK3>)
                                : (p7 ? mha_bf16_kernel<kMaxKeyTiles, kSoftmaxP7>
                                      : mha_bf16_kernel<kMaxKeyTiles, kSoftmaxK3>),
                          qkv, out, B, N, H, scale, s);
}

}  // extern "C"
