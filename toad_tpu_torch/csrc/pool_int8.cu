// Fused int8 trunk + gated attention + masked online-softmax pooling over
// padded bags of pre-quantized rows, hand-written for Hopper (sm_90a).
//
// Replaces toad_tpu/ops/pallas_pool.py::_pool_kernel_body_int8 (the TPU
// kernel K2, with its trunk _int8_trunk_scores) and its bag-pair form
// _pool_kernel_body_int8_pair (K2b), which here is a launch choice: every
// batch runs the same split-N grid. Per bag and per 64-row tile:
//     y1 = xq W1q (int8 x int8 -> int32, exact)
//     h1 = relu(f32(y1) * (sx_row * sw1_col) + b1), requantized per row
//     y2 = h1q W2q;  h2 = relu(f32(y2) * (sh1_row * sw2_col) + b2), requantized
//     uv = f32(h2q [Wa|Wb]q) * (sh2_row * swab_col) + bab
//     gated = bf16(tanh(u) * sigmoid(v));  s = gated Wc_bf16 + bc (f32 sums)
// then the online masked softmax of K1 with e and h2 rounded to bf16 before
// e^T h2. Requantization is the JAX quantizer's: scale = max(amax, 1e-6) / 127,
// q = clip(rne(h / scale), +-127), the quotient IEEE-rounded. Every
// dequantization step is an explicitly rounded multiply or add (__fmul_rn /
// __fadd_rn: no FMA contraction), so the integer parts of all three GEMMs
// equal those of the plain version (toad_tpu_torch/ops/quantize.py::
// plain_int8_pool).
//
// What bounds it on an H100: ~2.4 MOP per 1024-d row against 1 KB of int8
// input, far above the card's int8 ridge, so it is tensor-core bound. The
// 1.15 MB of int8 weights stream from L2 once a 64-row tile while the tile's
// activations stay in shared memory.
//
// A row's scale needs the amax of all H = 512 columns before any element can
// be quantized, so the two trunk GEMMs run as one pass over all 512 columns:
// 8 warps as 2 (rows) x 4 (columns), each warp 32 rows x 128 columns = 2 x 16
// mma tiles of int32 sums in registers (128 a thread). That fixes the tile at
// 64 rows. The gate GEMM needs no requantization and runs in passes of 256
// interleaved [Wa|Wb] columns whose epilogue folds the gated values into
// partial scores in registers (pool_trunk.cuh's gate_epilogue and
// reduce_scores), so the gated tile never reaches shared memory.
//
// The weights reach the tile as one stream: every tile stages the same fixed
// sequence of 32 KB slices, D/64 of W1 (512 rows x 64 B, each with the x
// tile's 64 rows x 64 B), 8 of W2 (512 x 64 B) and 2A/256 passes x 4 of
// [Wa|Wb] (256 interleaved rows x 128 B), through one 3-slot cp.async ring
// and one step counter that carry on across the GEMMs and into the next
// tile. So the first two slices of each GEMM are in flight during the
// epilogue before it (the requantizations, the scores, the online softmax),
// and a gate slice fills its slot (36 barriers a 1024-d tile, where a ring
// restarted per GEMM with 64-B gate slices took 48). The slots hold their
// rows without padding: the 16-byte chunk index of a byte offset is XORed
// with its 128-byte line index (swz), so the 8 rows one ldmatrix phase
// reads at one chunk fall in 8 different bank groups for 64- and 128-byte
// rows alike. The plan (rows, threads, slots, shared memory) is
// ops/cuda_pool_int8.plan, the slice sequence its stream_schedule; the grid
// fills whole waves of one CTA an SM (cuda_pool.wave_split_plan).
//
// The requantization quantizes with the row's reciprocal: v * (1/scale)
// and two Newton steps on the remainder, all fma, give the IEEE quotient
// itself, so the int8 values are the JAX quantizer's without a division or
// a branch per value (an IEEE division per value took 38 % of the time of a
// kernel that had it; dividing only near half-integers, behind a branch per
// value, still cost 22 % of its kernel's; PERF.md §6). Each
// row's amax is reduced over its quad of lanes and then over the four column
// warps through a [4][64] scratch, one ordered max and no atomics. The warp
// layout, not the stream, fixes the f32 order of every sum that is not an
// integer product, so the scores do not depend on the split, and M only by
// the rounding of e to bf16 against each run's running max.
//
// What bounds it now (PERF.md §6): the epilogues, during which the tensor
// cores idle (the gate's tanh and sigmoid, the requantization, the online
// softmax; a build without copies and products keeps 44 % of the time),
// then the products and the L2 stream, which overlap only in part. No
// wgmma, TMA or warp specialisation: a ninth (producer) warp would not find
// registers beside the trunk's 128 int32 sums a thread.
//
// Layout contract (the Python wrapper ops/cuda_pool_int8.py prepares it):
//   xq [B, N, D] int8, sx [B, N] and mask [B, N] f32; int8 weights in
//   nn.Linear layout [out, in] with f32 per-output scales and biases; the 2A
//   rows of [Wa|Wb]q (and their scales and biases) interleaved in groups of
//   32 as for K1; Wc [A, 2] bf16, bc [2] f32; H == 512.

#include "pool_trunk.cuh"

namespace {

constexpr int kR8 = kTileRows;          // rows per tile
constexpr int kH8 = kTrunkH;            // trunk width: one GEMM pass covers a whole row
constexpr int kRing8 = 3;               // slots of the weight ring: two slices in flight
constexpr int kSlot8 = 32768;           // a weight slot: 512 trunk rows x 64 B or 256 gate rows x 128 B
constexpr int kXSlot8 = kR8 * kBK8;     // an x slot: 64 rows x 64 B
constexpr int kGateBK8 = 128;           // reduction depth (bytes) of a gate slice
constexpr int kW2Slices = kH8 / kBK8;   // 8
constexpr int kGateSlices = kH8 / kGateBK8;  // 4 a gate pass
static_assert(kH8 * kBK8 == kSlot8 && kGateCols * kGateBK8 == kSlot8, "both slice shapes fill a slot");
static_assert(kSlot8 / 16 == 8 * kThreads && kXSlot8 / 16 == kThreads, "16-byte chunks per thread");

// The slots' swizzle: byte offset -> stored offset, the 16-byte chunk index
// (bits 4-6) XOR the 128-byte line index mod 8 (bits 7-9). It keeps each
// 1 KB block in place, so swz(a + 1024 m) = swz(a) + 1024 m.
__device__ __forceinline__ int swz(int off) { return off ^ ((off >> 3) & 0x70); }

struct Layout8 {
  size_t ws, xs, act, h2, wc, rs, amax, spart, s, e, acc, stat, total;
};

__host__ __device__ inline Layout8 layout8(int A) {
  Layout8 L;
  size_t o = 0;
  L.ws = o;    o = align16(o + (size_t)kRing8 * kSlot8);            // weight slices (int8, swizzled)
  L.xs = o;    o = align16(o + (size_t)kRing8 * kXSlot8);           // x slices (int8, swizzled)
  L.act = o;   o = align16(o + (size_t)kR8 * kLdAct);               // h1q, then h2q (int8)
  L.h2 = o;    o = align16(o + sizeof(bf16) * kR8 * kLdH2);         // h2 for pooling (bf16)
  L.wc = o;    o = align16(o + sizeof(float) * 2 * A);
  L.rs = o;    o = align16(o + sizeof(float) * kR8);                // row scales of the GEMM input
  L.amax = o;  o = align16(o + sizeof(float) * kColWarps * kR8);    // row amax of each column warp
  L.spart = o; o = align16(o + sizeof(float) * kColWarps * kR8 * 2);
  L.s = o;     o = align16(o + sizeof(float) * 2 * kR8);
  L.e = o;     o = align16(o + sizeof(float) * 2 * kR8);
  L.acc = o;   o = align16(o + sizeof(float) * 2 * kH8);
  L.stat = o;  o = align16(o + sizeof(float) * 8);
  L.total = o;
  return L;
}

// Slice s of a tile's stream into a weight slot (and, for W1, an x slot):
//   s < n1:            W1 rows 0..511, bytes 64 s.. (and x rows row0.., the same bytes; rows past N zero)
//   s < n1 + 8:        W2 rows 0..511, bytes 64 (s - n1)..
//   else j = s - n1 - 8: [Wa|Wb] rows 256 (j / 4).., bytes 128 (j % 4)..
// Chunk i of a slot is 16 bytes at swz(16 i): 4 chunks a 64-B row, 8 a
// 128-B row. Commits nothing.
__device__ __forceinline__ void stage_slice(int s, int n1, int row0, const u8* __restrict__ w1, int D,
                                            const u8* __restrict__ w2, const u8* __restrict__ wab,
                                            const u8* __restrict__ xb, int N, u8* wslot, u8* xslot) {
  const int tid = threadIdx.x;
  const int off = swz(16 * tid);  // this thread's chunk in each 4 KB of a slot
  if (s < n1 + kW2Slices) {
    const bool first = s < n1;
    const u8* wt = first ? w1 : w2;
    const int kb = first ? D : kH8, k0 = (first ? s : s - n1) * kBK8;
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int r = (tid >> 2) + 64 * it;
      cp_async16(wslot + off + 4096 * it, wt + (size_t)r * kb + k0 + (tid & 3) * 16, 16);
    }
    if (first) {
      const int r = tid >> 2;
      const bool ok = row0 + r < N;
      cp_async16(xslot + off, ok ? xb + (size_t)(row0 + r) * D + k0 + (tid & 3) * 16 : xb, ok ? 16 : 0);
    }
  } else {
    const int j = s - n1 - kW2Slices;
    const u8* wt = wab + (size_t)(j / kGateSlices) * kGateCols * kH8 + (j % kGateSlices) * kGateBK8;
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int r = (tid >> 3) + 32 * it;
      cp_async16(wslot + off + 4096 * it, wt + (size_t)r * kH8 + (tid & 7) * 16, 16);
    }
  }
}

// acc += A[64, 64 B] . W[512, 64 B]^T for one trunk slice: A the swizzled x
// slot (kFromX) or act's bytes k0.., W the swizzled weight slot. Warp (wr,
// wc) owns rows wr*32 + mi*16 + {g, g+8} and columns wc*128 + ni*8 + 2q (+1),
// the fragment layout of pool_trunk.cuh's gemm8.
template <bool kFromX>
__device__ __forceinline__ void trunk_slice(int (&acc)[2][16][4], const u8* a, int k0, const u8* w) {
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
                             : a + (r + (lane & 15)) * kLdAct + k0 + k);
    }
    const u8* wl = w + wc * 128 * kBK8 + swz(br * kBK8 + kk + ((lane >> 3) & 1) * 16);
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      uint32_t bf[4];  // b0, b1 of n-tile 2np, then of n-tile 2np + 1
      ldsm_x4(bf, wl + np * 16 * kBK8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_s8(acc[mi][2 * np], af[mi], bf[0], bf[1]);
        mma_s8(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
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

// Trunk epilogue over all 512 columns: h = relu(dequant(acc)), h2 (kToH2)
// rounded to bf16 for the pooling, then the row quantizer into act and the
// rows' scales into rs. Each row's amax: the max over its quad of lanes,
// each column warp's into amax_s [4][64], and after one barrier the max of
// the four in column-warp order; the values are quantized from registers
// into act, in place of the GEMM's own input.
template <bool kToH2>
__device__ __forceinline__ void requant_rows(int (&acc)[2][16][4], const float* __restrict__ s_col,
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
      const float s_row = rs[row];
      float mx = 0.f;
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) {
        const int col = wc * 128 + ni * 8 + 2 * q;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float h = fmaxf(dequant(acc[mi][ni][2 * hf + e], s_row, __ldg(s_col + col + e), __ldg(bias + col + e)), 0.f);
          v[mi][ni][2 * hf + e] = h;
          mx = fmaxf(mx, h);
        }
        if (kToH2)
          *reinterpret_cast<__nv_bfloat162*>(h2 + row * kLdH2 + col) =
              __floats2bfloat162_rn(v[mi][ni][2 * hf], v[mi][ni][2 * hf + 1]);
      }
      // the four lanes of a quad hold the same row
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (q == 0) amax_s[wc * kR8 + row] = mx;
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
      const float amax = fmaxf(fmaxf(amax_s[row], amax_s[kR8 + row]), fmaxf(amax_s[2 * kR8 + row], amax_s[3 * kR8 + row]));
      const float scale = row_scale<kReqF32>(amax);
      const float inv = __fdiv_rn(1.f, scale);
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) {
        const int col = wc * 128 + ni * 8 + 2 * q;
        const int q0 = quant_row(v[mi][ni][2 * hf], scale, inv);
        const int q1 = quant_row(v[mi][ni][2 * hf + 1], scale, inv);
        *reinterpret_cast<uint16_t*>(act + row * kLdAct + col) = static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
      }
      if (wc == 0 && q == 0) rs[row] = scale;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
pool_int8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx, const float* __restrict__ mask,
                 int N, int D, int A,
                 const int8_t* __restrict__ w1t, const float* __restrict__ sw1, const float* __restrict__ b1,
                 const int8_t* __restrict__ w2t, const float* __restrict__ sw2, const float* __restrict__ b2,
                 const int8_t* __restrict__ wabt, const float* __restrict__ swab, const float* __restrict__ bab,
                 const bf16* __restrict__ wc, const float* __restrict__ bc,
                 int tiles_per_split, int n_splits,
                 float* __restrict__ scores, float* __restrict__ part_acc, float* __restrict__ part_stat) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout8 L = layout8(A);
  u8* ws = smem + L.ws;
  u8* xs = smem + L.xs;
  u8* act = smem + L.act;
  bf16* h2 = reinterpret_cast<bf16*>(smem + L.h2);
  float* wc_s = reinterpret_cast<float*>(smem + L.wc);
  float* rs = reinterpret_cast<float*>(smem + L.rs);
  float* amax_s = reinterpret_cast<float*>(smem + L.amax);
  float* spart = reinterpret_cast<float*>(smem + L.spart);
  float* s_s = reinterpret_cast<float*>(smem + L.s);      // [R][2] raw scores
  float* e_s = reinterpret_cast<float*>(smem + L.e);      // [R][2] e rounded to bf16
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);  // [2][H]
  float* stat = reinterpret_cast<float*>(smem + L.stat);  // max[2], denom[2], corr[2]

  const int tid = threadIdx.x;
  const int split = blockIdx.x, b = blockIdx.y;
  const u8* xb = reinterpret_cast<const u8*>(xq) + (size_t)b * N * D;
  const u8* w1 = reinterpret_cast<const u8*>(w1t);
  const u8* w2 = reinterpret_cast<const u8*>(w2t);
  const u8* wab = reinterpret_cast<const u8*>(wabt);
  const float* sb = sx + (size_t)b * N;
  const float* mb = mask + (size_t)b * N;

  for (int i = tid; i < 2 * A; i += kThreads) wc_s[i] = __bfloat162float(wc[i]);
  for (int i = tid; i < 2 * kH8; i += kThreads) acc_s[i] = 0.f;
  if (tid < 2) {
    stat[tid] = kNegInf;
    stat[2 + tid] = 0.f;
  }

  const int n_tiles = (N + kR8 - 1) / kR8;
  const int t_end = min(n_tiles, (split + 1) * tiles_per_split);
  // the next tile this block runs after t (block-uniform): classification
  // mode skips tiles of pure padding (the online update is the identity
  // there); scored mode writes every row's score
  auto next_tile = [&](int t) {
    for (++t; t < t_end && scores == nullptr; ++t)
      if (__syncthreads_or(tid < kR8 && t * kR8 + tid < N && mb[t * kR8 + tid] > 0.f)) break;
    return t;
  };
  const int n1 = D / kBK8;
  const int n_slices = n1 + kW2Slices + (2 * A / kGateCols) * kGateSlices;

  // The stream: the producer's cursor (tile, slice of the tile, slot) runs
  // two slices ahead of the consumers' slot; both wrap into the next tile.
  int tile = next_tile(split * tiles_per_split - 1), next = t_end;
  int p_tile = tile, p_s = 0, p_slot = 0, c_slot = 0;
  auto issue = [&]() {
    if (p_tile < t_end)
      stage_slice(p_s, n1, p_tile * kR8, w1, D, w2, wab, xb, N, ws + p_slot * kSlot8, xs + p_slot * kXSlot8);
    cp_async_commit();  // one group a slice, empty past the last tile: the wait count holds
    p_slot = p_slot == kRing8 - 1 ? 0 : p_slot + 1;
    if (++p_s == n_slices) {
      p_s = 0;
      p_tile = next;
    }
  };
  // waits for the consumers' next slice and returns its slot; issues the
  // slice two ahead into the slot every warp has just finished with
  auto step = [&]() {
    cp_async_wait<kRing8 - 2>();  // this thread's copies of the slice have landed
    __syncthreads();              // everyone's have, and the slot before it is free
    issue();
    const int slot = c_slot;
    c_slot = c_slot == kRing8 - 1 ? 0 : c_slot + 1;
    return slot;
  };
#pragma unroll
  for (int i = 0; i < kRing8 - 1; ++i) issue();

  while (tile < t_end) {
    next = next_tile(tile);  // before the cursor wraps, n_slices - 3 steps on
    const int row0 = tile * kR8;
    if (tid < kR8) rs[tid] = row0 + tid < N ? sb[row0 + tid] : 0.f;  // rows past the end are zeros

    int acc[2][16][4];
    // h1 = relu(dequant(xq W1q)) -> act (int8), rs <- its row scales
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 16; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    for (int s = 0; s < n1; ++s) {
      const int slot = step();
      trunk_slice<true>(acc, xs + slot * kXSlot8, 0, ws + slot * kSlot8);
    }
    requant_rows<false>(acc, sw1, b1, rs, amax_s, act, nullptr);
    // h2 = relu(dequant(h1q W2q)) -> h2 (bf16) and act (int8), rs <- its row scales
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 16; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    for (int s = 0; s < kW2Slices; ++s) {
      const int slot = step();
      trunk_slice<false>(acc, act, s * kBK8, ws + slot * kSlot8);
    }
    requant_rows<true>(acc, sw2, b2, rs, amax_s, act, h2);
    // scores from the gate, pass by pass
    float sacc[2][2][2] = {};
    for (int n0 = 0; n0 < 2 * A; n0 += kGateCols) {
      int accg[2][8][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) accg[mi][ni][e] = 0;
      for (int s = 0; s < kGateSlices; ++s) {
        const int slot = step();
        gate_slice(accg, act, s * kGateBK8, ws + slot * kSlot8);
      }
      gate_epilogue<2>(accg, n0, rs, swab, bab, wc_s, sacc);
    }
    reduce_scores<2>(sacc, spart, bc, s_s, scores, b, N, row0);

    online_stats<kR8, bf16>(s_s, mb, row0, N, e_s, stat);
    __syncthreads();
    online_accumulate<kR8, bf16>(acc_s, e_s, stat, h2, kLdH2, kH8);
    tile = next;
  }
  cp_async_wait<0>();
  __syncthreads();

  const size_t p = (size_t)b * n_splits + split;
  for (int i = tid; i < 2 * kH8; i += kThreads) part_acc[p * 2 * kH8 + i] = acc_s[i];
  if (tid < 4) part_stat[p * 4 + tid] = stat[tid];
}

}  // namespace

extern "C" {

int toad_pool_int8_rows_per_tile() { return kR8; }

// Dynamic shared memory of the int8 pooling kernel in bytes.
long long toad_pool_int8_smem_bytes(int A) { return (long long)layout8(A).total; }

// Launches the int8 pooling and combine kernels on `stream`; returns the
// cudaError_t of the launches (0 on success). Does not synchronise.
int toad_pool_int8_forward(const void* xq, const float* sx, const float* mask, int B, int N, int D, int H, int A,
                           const void* w1t, const float* sw1, const float* b1,
                           const void* w2t, const float* sw2, const float* b2,
                           const void* wabt, const float* swab, const float* bab,
                           const void* wc, const float* bc,
                           int tiles_per_split, int n_splits,
                           float* scores, float* part_acc, float* part_stat, float* out, void* stream) {
  if (H != kH8 || D % kBK8 != 0 || A % (kGateCols / 2) != 0 || A > kH8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = layout8(A).total;
  cudaError_t err = cudaFuncSetAttribute(pool_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pool_int8_kernel<<<dim3(n_splits, B), kThreads, smem, s>>>(
      static_cast<const int8_t*>(xq), sx, mask, N, D, A,
      static_cast<const int8_t*>(w1t), sw1, b1, static_cast<const int8_t*>(w2t), sw2, b2,
      static_cast<const int8_t*>(wabt), swab, bab, static_cast<const bf16*>(wc), bc,
      tiles_per_split, n_splits, scores, part_acc, part_stat);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine(part_acc, part_stat, n_splits, B, kH8, out, s);
}

}  // extern "C"
