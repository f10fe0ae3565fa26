// The int8 pooling probe's chain variants, hand-written for Hopper (sm_90a).
//
// Replaces experiments/int8_probe.py::make_kernel_int8(requant) (P4; its
// pallas_call at :287) and make_kernel_int8_inquant(quant_bf16, h_only)
// (P3; :211), at T_PAD = 8 task columns. Per bag and 64-row tile:
//     GEMM1: xq W1q (int8, x pre-quantized per row or quantized here from
//            bf16 x with f32 or bf16 arithmetic), or x W1 in bf16 (h_only)
//     h1 = relu(f32(y1) * (s_row * sw1_col) + b1)   (h_only: relu(y1 + b1))
//     h1 -> int8 per row; h2 = relu(dequant(h1q W2q)) -> int8 per row
//     uv = dequant(h2q [Wa|Wb]q); gated = bf16(tanh(u) * sigmoid(v))
//     s  = gated Wc_bf16 + bc [rows, 8]; online masked softmax, e and h2
//          rounded to bf16 before e^T h2.
// The row quantizers, each the probe's own (pool_trunk.cuh's Requant):
//   f32  (_requant_rows):      scale = max(amax, 1e-6) / 127,
//                              q = clip(rne(y / scale), +-127), the IEEE
//                              quotient from the row's reciprocal and two
//                              Newton steps (K2's quant_row);
//   bf16 (_requant_rows_bf16): inv = bf16(127 / max(amax, 1e-6)) once a row,
//                              q = clip(rne(bf16(bf16(y) * inv)), +-127),
//                              scale = amax / 127 (f32);
//   none (requant=False):      q = the f32 -> int8 cast, truncated toward
//                              zero and saturated to [-128, 127], scale 1:
//                              wrong numerics by design, the probe's bound
//                              on what the requantization costs.
// Every dequantization step is an explicitly rounded multiply or add (no
// FMA contraction), so the integers of all three GEMMs equal those of the
// plain version (ops/probe_pool_int8.py).
//
// What bounds it on an H100: ~2.4 MOP per 1024-d row against 1 KB of int8
// (2 KB of bf16) input: tensor-core bound, as K2.
//
// The design is the pass K2 (csrc/pool_int8.cu) ran on mma.sync before its
// GEMMs moved onto int8 wgmma, so the ladder of the variants splits that
// pass's time, no longer K2's: 64-row tiles of 8 warps as 2 (rows) x 4
// (columns), each trunk GEMM one pass over all 512 columns; the weights one
// stream of 32 KB slices a tile through a 3-slot swizzled cp.async ring,
// whose cursor and step counter run on across GEMM1, GEMM2, the gate passes
// and into the next tile; the requantization over a [4][64] amax scratch;
// the grid in whole waves of one CTA an SM (ops/cuda_pool.wave_split_plan).
// The stream, GEMMs and epilogues are that pass's code (pool_trunk.cuh:
// stage_slice, trunk_slice, gate_slice, requant_rows with the quantizer as a
// template argument, gate_epilogue and reduce_scores at 8 task columns).
// What each variant stages and adds:
//   - int8_chain, int8_gemms: K2's own stream, D/64 W1 slices each with the
//     x tile's 64 bytes;
//   - int8_inquant, int8_inquant_bf16: W1 slices without x. At each tile's
//     start a warp per row reads the 64 bf16 rows (a whole row in
//     registers), takes the row's amax with one warp reduction and writes
//     the int8 tile into the h2 buffer (64 x (D + 16) bytes = 66,560 at D =
//     1024, the bf16 h2 tile's size), from where GEMM1 reads its A operand;
//   - int8_h_only: 2D/64 bf16 W1 slices, each with 64 bytes (32 values) of
//     the bf16 x tile, through mma.sync m16n8k16 (trunk_slice's bf16 form:
//     the ldmatrix addresses are the int8 ones), f32 sums;
//   - 8 task columns: partial scores [2][2][8] a thread, summed over the
//     quad and the four column warps in a fixed order, then the probes'
//     epilogue at 64 rows a tile (probe_common.cuh). Wc [A][8] is read from
//     device memory (16 bytes a row), and the running sums acc [8][H] live in
//     the CTA's own slot of part_acc, the partial the combine reads: each
//     tile reads and writes its 16 KB (L2-resident) in the pass that folds
//     e^T h2, so that no register holds them across the trunk.
//
// Layout contract (ops/probe_pool_int8.py prepares it): x [B, N, D] int8
// with sx [B, N] f32, or bf16; mask [B, N] f32, N a multiple of 64; W1 int8
// (h_only: bf16), W2 and [Wa|Wb] int8 in nn.Linear layout [out, in] with f32
// per-output scales and biases, the 2A rows of [Wa|Wb] interleaved in groups
// of 32 as for K1; Wc [A, 8] bf16; bc [8] f32; H == 512.

#include "probe_common.cuh"

namespace {

enum Input { kPreQ = 0, kQuantF32 = 1, kQuantBf16 = 2, kHOnly = 3 };

// The weight and x rings (swizzled, from a 1 KB boundary), h1q/h2q, the h2
// tile in bf16 (before GEMM1 the x tile quantized in the kernel, [64][D +
// 16]), the row scales, each column warp's row amax, the column warps'
// partial scores, s and e [64][8], the softmax statistics [24]. Wc and the
// running sums stay in device memory, so A does not enter.
struct ProbeLayout8 {
  size_t ws, xs, act, h2, rs, amax, spart, s, e, stat, total;
};

__host__ __device__ inline ProbeLayout8 probe_layout8() {
  ProbeLayout8 L;
  size_t o = 0;
  L.ws = o;    o = align16(o + (size_t)kRing8 * kSlot8);
  L.xs = o;    o = align16(o + (size_t)kRing8 * kXSlot8);
  L.act = o;   o = align16(o + (size_t)kTileRows * kLdAct);
  L.h2 = o;    o = align16(o + sizeof(bf16) * kTileRows * kLdH2);
  L.rs = o;    o = align16(o + sizeof(float) * kTileRows);
  L.amax = o;  o = align16(o + sizeof(float) * kColWarps * kTileRows);
  L.spart = o; o = align16(o + sizeof(float) * kColWarps * kTileRows * kTasks);
  L.s = o;     o = align16(o + sizeof(float) * kTileRows * kTasks);
  L.e = o;     o = align16(o + sizeof(float) * kTileRows * kTasks);
  L.stat = o;  o = align16(o + sizeof(float) * kStatStride);
  L.total = o;
  return L;
}
static_assert(2 * kThreads == kTrunkH, "a thread owns two columns of every task");

// The x tile quantized in the kernel with the row quantizer kReq: a warp per
// row holds the row's D bf16 values (D / 256 16-byte chunks a lane, D <=
// 1024), takes its amax and writes int8 into xq [64][D + 16] and the row's
// scale into rs. (Two or four rows of a warp in flight made ptxas spill
// 152-488 bytes and the variants slower: PERF.md §6.)
template <int kReq>
__device__ __forceinline__ void quantize_tile(const bf16* __restrict__ xb, int D, int row0, u8* xq, float* rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunks = D / 256;
  for (int r = warp; r < kTileRows; r += kThreads / 32) {
    const bf16* row = xb + (size_t)(row0 + r) * D;
    uint4 raw[4];
    float mx = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < n_chunks) {
        raw[i] = __ldg(reinterpret_cast<const uint4*>(row + (i * 32 + lane) * 8));
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(p[k]);
          mx = fmaxf(mx, fmaxf(fabsf(f.x), fabsf(f.y)));
        }
      }
    }
    mx = warp_max(mx);
    const float scale = row_scale<kReq>(mx), inv = row_inv<kReq>(mx, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < n_chunks) {
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(p[k]);
          const uint32_t pair = (uint32_t)(quant<kReq>(f.x, scale, inv) & 0xff) |
                                ((uint32_t)(quant<kReq>(f.y, scale, inv) & 0xff) << 8);
          w[k / 2] |= pair << (16 * (k % 2));
        }
        *reinterpret_cast<uint2*>(xq + r * (D + 16) + (i * 32 + lane) * 8) = make_uint2(w[0], w[1]);
      }
    }
    if (lane == 0) rs[r] = scale;
  }
}

template <int kIn, int kReq>
__global__ void __launch_bounds__(kThreads, 1)
probe_int8_kernel(const void* __restrict__ x, const float* __restrict__ sx, const float* __restrict__ mask, int N,
                  int D, int A, const void* __restrict__ w1t, const float* __restrict__ sw1,
                  const float* __restrict__ b1, const int8_t* __restrict__ w2t, const float* __restrict__ sw2,
                  const float* __restrict__ b2, const int8_t* __restrict__ wabt, const float* __restrict__ swab,
                  const float* __restrict__ bab, const bf16* __restrict__ wc, const float* __restrict__ bc,
                  int tiles_per_split, float* __restrict__ part_acc, float* __restrict__ part_stat) {
  constexpr bool kWithX = kIn == kPreQ || kIn == kHOnly;       // x slices ride along with W1's
  constexpr bool kQuantX = kIn == kQuantF32 || kIn == kQuantBf16;  // x quantized here, GEMM1's A in h2's buffer
  using Acc1 = typename std::conditional<kIn == kHOnly, float, int>::type;
  extern __shared__ __align__(1024) unsigned char smem[];
  const ProbeLayout8 L = probe_layout8();
  u8* ws = smem + L.ws;
  u8* xs = smem + L.xs;
  u8* act = smem + L.act;
  bf16* h2 = reinterpret_cast<bf16*>(smem + L.h2);
  u8* xq_s = smem + L.h2;  // the x tile quantized in the kernel, [64][D + 16]
  float* rs = reinterpret_cast<float*>(smem + L.rs);
  float* amax_s = reinterpret_cast<float*>(smem + L.amax);
  float* spart = reinterpret_cast<float*>(smem + L.spart);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* e_s = reinterpret_cast<float*>(smem + L.e);
  float* stat = reinterpret_cast<float*>(smem + L.stat);

  const int tid = threadIdx.x, c0 = 2 * tid;
  const int split = blockIdx.x, n_splits = gridDim.x, b = blockIdx.y;
  const int kb1 = kIn == kHOnly ? 2 * D : D;  // bytes of a W1 row, and of an x row where x rides along
  const u8* xb = static_cast<const u8*>(x) + (size_t)b * N * (kIn == kPreQ ? D : 2 * D);
  const u8* w1 = static_cast<const u8*>(w1t);
  const u8* w2 = reinterpret_cast<const u8*>(w2t);
  const u8* wab = reinterpret_cast<const u8*>(wabt);
  float* acc_g = part_acc + ((size_t)b * n_splits + split) * kTasks * kTrunkH;  // the block's running acc [8][H]

#pragma unroll
  for (int t = 0; t < kTasks; ++t) *reinterpret_cast<float2*>(acc_g + t * kTrunkH + c0) = make_float2(0.f, 0.f);
  probe_stats_init<1, kModeSoftmax>(stat);

  const int t0 = split * tiles_per_split, t_end = min(N / kTileRows, t0 + tiles_per_split);
  const int n1 = kb1 / kBK8;
  const int n_slices = n1 + kW2Slices + (2 * A / kGateCols) * kGateSlices;

  // The stream, as K2's: the producer's cursor (tile, slice of the tile,
  // slot) runs two slices ahead of the consumers' slot; both wrap into the
  // next tile.
  int p_tile = t0, p_s = 0, p_slot = 0, c_slot = 0;
  auto issue = [&]() {
    if (p_tile < t_end)
      stage_slice<kWithX>(p_s, n1, p_tile * kTileRows, w1, kb1, w2, wab, xb, N, ws + p_slot * kSlot8,
                          xs + p_slot * kXSlot8);
    cp_async_commit();  // one group a slice, empty past the last tile: the wait count holds
    p_slot = p_slot == kRing8 - 1 ? 0 : p_slot + 1;
    if (++p_s == n_slices) {
      p_s = 0;
      ++p_tile;
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

  for (int tile = t0; tile < t_end; ++tile) {
    const int row0 = tile * kTileRows;
    if constexpr (kQuantX) {
      __syncthreads();  // the last tile's pooling has read h2, whose buffer takes the quantized x tile
      quantize_tile<kReq>(reinterpret_cast<const bf16*>(xb), D, row0, xq_s, rs);
    } else if constexpr (kIn == kPreQ) {
      if (tid < kTileRows) rs[tid] = sx[(size_t)b * N + row0 + tid];
    }
    // h1 -> act (int8), rs <- its row scales
    {
      Acc1 acc[2][16][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 16; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
      for (int s = 0; s < n1; ++s) {
        const int slot = step();
        if constexpr (kQuantX)
          trunk_slice<false>(acc, xq_s, D + 16, s * kBK8, ws + slot * kSlot8);
        else
          trunk_slice<true>(acc, xs + slot * kXSlot8, 0, 0, ws + slot * kSlot8);
      }
      requant_rows<kReq, false>(acc, sw1, b1, rs, amax_s, act, nullptr);
    }
    // h2 -> h2 (bf16) and act (int8), rs <- its row scales
    {
      int acc[2][16][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 16; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
      for (int s = 0; s < kW2Slices; ++s) {
        const int slot = step();
        trunk_slice<false>(acc, act, kLdAct, s * kBK8, ws + slot * kSlot8);
      }
      requant_rows<kReq, true>(acc, sw2, b2, rs, amax_s, act, h2);
    }
    // scores from the gate, pass by pass
    float sacc[2][2][kTasks] = {};
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
      gate_epilogue<kTasks>(accg, n0, rs, swab, bab, wc, sacc);
    }
    reduce_scores<kTasks>(sacc, spart, bc, s_s, nullptr, b, N, row0);
    probe_stats<kTileRows, 1, kModeSoftmax>(s_s, mask + (size_t)b * N, N, row0, e_s, stat);
    __syncthreads();  // e and the statistics are in place
    float a[kTasks][2];
#pragma unroll
    for (int t = 0; t < kTasks; ++t) {
      const float2 v = *reinterpret_cast<const float2*>(acc_g + t * kTrunkH + c0);
      a[t][0] = v.x;
      a[t][1] = v.y;
    }
    probe_fold<kTileRows, 1, false>(a, 0, kTileRows, e_s, stat, h2, kLdH2);
#pragma unroll
    for (int t = 0; t < kTasks; ++t) *reinterpret_cast<float2*>(acc_g + t * kTrunkH + c0) = make_float2(a[t][0], a[t][1]);
  }
  cp_async_wait<0>();
  // the partial: acc is in its slot already; max[8] and denom[8] beside it
  if (tid < 2 * kTasks) part_stat[((size_t)b * n_splits + split) * 2 * kTasks + tid] = stat[tid];
}

template <int kIn, int kReq>
int launch_int8_probe(const void* x, const float* sx, const float* mask, int B, int N, int D, int A,
                      const void* w1t, const float* sw1, const float* b1, const void* w2t, const float* sw2,
                      const float* b2, const void* wabt, const float* swab, const float* bab, const void* wc,
                      const float* bc, int tiles_per_split, int n_splits, float* part_acc, float* part_stat,
                      float* out, cudaStream_t stream) {
  const size_t smem = probe_layout8().total;
  cudaError_t err = cudaFuncSetAttribute(probe_int8_kernel<kIn, kReq>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  probe_int8_kernel<kIn, kReq><<<dim3(n_splits, B), kThreads, smem, stream>>>(
      x, sx, mask, N, D, A, w1t, sw1, b1, static_cast<const int8_t*>(w2t), sw2, b2,
      static_cast<const int8_t*>(wabt), swab, bab, static_cast<const bf16*>(wc), bc, tiles_per_split, part_acc,
      part_stat);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<kTasks>(part_acc, part_stat, n_splits, B, kTrunkH, out, stream);
}

}  // namespace

extern "C" {

int toad_probe_int8_rows_per_tile() { return kTileRows; }

// Dynamic shared memory of a block (the same for every instance and A).
long long toad_probe_int8_smem_bytes() { return (long long)probe_layout8().total; }

// variant: 0 int8_chain, 1 int8_gemms (x int8 with sx), 2 int8_inquant,
// 3 int8_inquant_bf16, 4 int8_h_only (x bf16, sx unused). out [B][8][H]
// f32. Returns the launches' cudaError_t (0 on success); does not
// synchronise.
int toad_probe_int8_forward(int variant, const void* x, const float* sx, const float* mask, int B, int N, int D, int H,
                            int A, const void* w1t, const float* sw1, const float* b1, const void* w2t,
                            const float* sw2, const float* b2, const void* wabt, const float* swab, const float* bab,
                            const void* wc, const float* bc, int tiles_per_split, int n_splits, float* part_acc,
                            float* part_stat, float* out, void* stream) {
  const bool in_kernel_quant = variant == 2 || variant == 3;
  if (H != kTrunkH || D % kBK8 != 0 || A % (kGateCols / 2) != 0 || A > H || N % kTileRows != 0 ||
      (in_kernel_quant && (D % 256 != 0 || D > 1024)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TOAD_INT8_PROBE_ARGS \
  x, sx, mask, B, N, D, A, w1t, sw1, b1, w2t, sw2, b2, wabt, swab, bab, wc, bc, tiles_per_split, n_splits, part_acc, part_stat, out, s
  switch (variant) {
    case 0: return launch_int8_probe<kPreQ, kReqF32>(TOAD_INT8_PROBE_ARGS);
    case 1: return launch_int8_probe<kPreQ, kReqNone>(TOAD_INT8_PROBE_ARGS);
    case 2: return launch_int8_probe<kQuantF32, kReqF32>(TOAD_INT8_PROBE_ARGS);
    case 3: return launch_int8_probe<kQuantBf16, kReqBf16>(TOAD_INT8_PROBE_ARGS);
    case 4: return launch_int8_probe<kHOnly, kReqBf16>(TOAD_INT8_PROBE_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TOAD_INT8_PROBE_ARGS
}

}  // extern "C"
