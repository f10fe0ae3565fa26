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
// The row quantizers, each the probe's own:
//   f32  (_requant_rows):      scale = max(amax, 1e-6) / 127,
//                              q = clip(rne(y / scale), +-127);
//   bf16 (_requant_rows_bf16): inv = bf16(127 / max(amax, 1e-6)),
//                              q = clip(rne(bf16(bf16(y) * inv)), +-127),
//                              scale = amax / 127 (f32);
//   none (requant=False):      q = the f32 -> int8 cast, truncated toward
//                              zero and saturated to [-128, 127], scale 1:
//                              wrong numerics by design, the probe's bound
//                              on what the requantization costs.
// Every step is an explicitly rounded multiply, divide or add (no FMA
// contraction), so the integers of all three GEMMs equal those of the plain
// version (ops/probe_pool_int8.py).
//
// What bounds it on an H100: ~2.4 MOP per 1024-d row against 1 KB of int8
// (2 KB of bf16) input: tensor-core bound, as K2. The design is the one K2
// (csrc/pool_int8.cu) had before its one weight stream and its division-free
// quantizer, and so are its GEMM and epilogues (pool_trunk.cuh:
// gemm8, requant_epilogue with the quantizer as a template parameter,
// gate_epilogue and reduce_scores at 8 task columns): one GEMM pass over all
// 512 trunk columns so that each row's amax is known in registers (quad
// shuffles, then a shared atomicMax on the float bits across the four column
// warps), int8 mma.sync m16n8k32 fed by ldmatrix, weights from L2 through a
// 2-deep cp.async ring, gated values folded into per-thread partial scores.
// What the variants add:
//   - in-kernel quantization of x: a warp per row reads the 64 bf16 rows
//     (registers hold a whole row), takes the row's amax with one warp
//     reduction and writes the int8 tile into shared memory, into the buffer
//     that h2 takes later in the tile (64 x (D + 16) bytes = 66,560 at D =
//     1024, the size of the bf16 h2 tile), so the variant costs no shared
//     memory; GEMM1 then reads its A operand from there;
//   - h_only: GEMM1 runs bf16 mma.sync m16n8k16 over the same byte layout
//     (a 64-byte slice is 32 bf16 or 64 int8 values, and the ldmatrix
//     addresses of the two fragment layouts coincide), f32 accumulators;
//   - 8 task columns: partial scores [2][2][8] a thread, summed over the
//     quad and the four column warps in a fixed order, then the probes'
//     epilogue at 64 rows a tile (probe_common.cuh).
//
// Layout contract (ops/probe_pool_int8.py prepares it): x [B, N, D] int8
// with sx [B, N] f32, or bf16; mask [B, N] f32, N a multiple of 64; W1 int8
// (h_only: bf16), W2 and [Wa|Wb] int8 in nn.Linear layout [out, in] with f32
// per-output scales and biases, the 2A rows of [Wa|Wb] interleaved in groups
// of 32 as for K1; Wc [A, 8] bf16; bc [8] f32; H == 512.

#include "probe_common.cuh"

namespace {

enum Input { kPreQ = 0, kQuantF32 = 1, kQuantBf16 = 2, kHOnly = 3 };

struct Layout8 {
  size_t ws, xs, act, h2, wc, rs, rmax, spart, s, e, stat, total;
};

__host__ __device__ inline Layout8 layout8(int A) {
  Layout8 L;
  size_t o = 0;
  L.ws = o;    o = align16(o + (size_t)kStages8 * kTrunkH * kS8);
  L.xs = o;    o = align16(o + (size_t)kStages8 * kTileRows * kS8);
  L.act = o;   o = align16(o + (size_t)kTileRows * kLdAct);
  L.h2 = o;    o = align16(o + sizeof(bf16) * kTileRows * kLdH2);  // also the quantized x tile
  L.wc = o;    o = align16(o + sizeof(float) * kTasks * A);
  L.rs = o;    o = align16(o + sizeof(float) * kTileRows);
  L.rmax = o;  o = align16(o + sizeof(float) * 2 * kTileRows);
  L.spart = o; o = align16(o + sizeof(float) * kColWarps * kTileRows * kTasks);
  L.s = o;     o = align16(o + sizeof(float) * kTasks * kTileRows);
  L.e = o;     o = align16(o + sizeof(float) * kTasks * kTileRows);
  L.stat = o;  o = align16(o + sizeof(float) * kStatStride);
  L.total = o;
  return L;
}

// The x tile quantized in the kernel: a warp per row holds the row's D bf16
// values (D / 256 16-byte chunks a lane, D <= 1024), takes its amax and
// writes int8 into xq [64][D + 16] and the row's scale into rs.
template <int kIn>
__device__ __forceinline__ void quantize_tile(const bf16* __restrict__ xb, int D, int row0, u8* xq, float* rs) {
  constexpr int kReq = kIn == kQuantBf16 ? kReqBf16 : kReqF32;
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
    const float scale = row_scale<kReq>(mx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < n_chunks) {
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(p[k]);
          const uint32_t pair = (uint32_t)(quant<kReq>(f.x, mx, scale) & 0xff) |
                                ((uint32_t)(quant<kReq>(f.y, mx, scale) & 0xff) << 8);
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
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout8 L = layout8(A);
  u8* ws = smem + L.ws;
  u8* xs = smem + L.xs;
  u8* act = smem + L.act;
  bf16* h2 = reinterpret_cast<bf16*>(smem + L.h2);
  u8* xq_s = smem + L.h2;  // the x tile quantized in the kernel, [64][D + 16]
  float* wc_s = reinterpret_cast<float*>(smem + L.wc);
  float* rs = reinterpret_cast<float*>(smem + L.rs);
  float* rmax = reinterpret_cast<float*>(smem + L.rmax);
  float* spart = reinterpret_cast<float*>(smem + L.spart);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* e_s = reinterpret_cast<float*>(smem + L.e);
  float* stat = reinterpret_cast<float*>(smem + L.stat);

  const int tid = threadIdx.x;
  const int split = blockIdx.x, n_splits = gridDim.x, b = blockIdx.y;
  const int xbytes = kIn == kPreQ ? 1 : 2;
  const u8* xb = static_cast<const u8*>(x) + (size_t)b * N * D * xbytes;
  const u8* w1 = static_cast<const u8*>(w1t);
  const u8* w2 = reinterpret_cast<const u8*>(w2t);
  const u8* wab = reinterpret_cast<const u8*>(wabt);

  for (int i = tid; i < kTasks * A; i += kThreads) wc_s[i] = __bfloat162float(wc[i]);
  probe_stats_init<1, kModeSoftmax>(stat);
  float acc[kTasks][2];
#pragma unroll
  for (int t = 0; t < kTasks; ++t) acc[t][0] = acc[t][1] = 0.f;

  const int n_tiles = N / kTileRows;
  const int t_end = min(n_tiles, (split + 1) * tiles_per_split);
  for (int tile = split * tiles_per_split; tile < t_end; ++tile) {
    const int row0 = tile * kTileRows;
    __syncthreads();  // the last tile's pooling has read h2 (the quantized x tile's buffer)
    if (tid < kTileRows) {
      rmax[tid] = 0.f;
      rmax[kTileRows + tid] = 0.f;
      if (kIn == kPreQ) rs[tid] = sx[(size_t)b * N + row0 + tid];
    }
    // h1 -> act (int8), rs <- its row scales
    if constexpr (kIn == kHOnly) {
      float acc1[2][16][4];
      gemm8<16, true, true>(acc1, w1, 2 * D, 0, nullptr, 0, xb, N, 2 * D, row0, ws, xs);
      requant_epilogue<kReq, false>(acc1, nullptr, b1, rs, rmax, act, nullptr);
    } else if constexpr (kIn == kPreQ) {
      int acc1[2][16][4];
      gemm8<16, true, false>(acc1, w1, D, 0, nullptr, 0, xb, N, D, row0, ws, xs);
      requant_epilogue<kReq, false>(acc1, sw1, b1, rs, rmax, act, nullptr);
    } else {
      quantize_tile<kIn>(reinterpret_cast<const bf16*>(xb), D, row0, xq_s, rs);
      int acc1[2][16][4];
      gemm8<16, false, false>(acc1, w1, D, 0, xq_s, D + 16, nullptr, N, 0, row0, ws, xs);
      requant_epilogue<kReq, false>(acc1, sw1, b1, rs, rmax, act, nullptr);
    }
    // h2 -> h2 (bf16) and act (int8), rs <- its row scales
    {
      int acc2[2][16][4];
      gemm8<16, false, false>(acc2, w2, kTrunkH, 0, act, kLdAct, nullptr, N, 0, row0, ws, xs);
      requant_epilogue<kReq, true>(acc2, sw2, b2, rs, rmax + kTileRows, act, h2);
    }
    // scores from the gate, pass by pass
    float sacc[2][2][kTasks] = {};
    for (int n0 = 0; n0 < 2 * A; n0 += kGateCols) {
      int accg[2][8][4];
      gemm8<8, false, false>(accg, wab, kTrunkH, n0, act, kLdAct, nullptr, N, 0, row0, ws, xs);
      gate_epilogue<kTasks>(accg, n0, rs, swab, bab, wc_s, sacc);
    }
    reduce_scores<kTasks>(sacc, spart, bc, s_s, nullptr, b, N, row0);
    probe_stats<kTileRows, 1, kModeSoftmax>(s_s, mask + (size_t)b * N, N, row0, e_s, stat);
    __syncthreads();
    probe_fold<kTileRows, 1, false>(acc, 0, kTileRows, e_s, stat, h2, kLdH2);
  }
  probe_write_partials(acc, stat, b, split, n_splits, part_acc, part_stat);
}

template <int kIn, int kReq>
int launch_int8_probe(const void* x, const float* sx, const float* mask, int B, int N, int D, int A,
                      const void* w1t, const float* sw1, const float* b1, const void* w2t, const float* sw2,
                      const float* b2, const void* wabt, const float* swab, const float* bab, const void* wc,
                      const float* bc, int tiles_per_split, int n_splits, float* part_acc, float* part_stat,
                      float* out, cudaStream_t stream) {
  const size_t smem = layout8(A).total;
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

long long toad_probe_int8_smem_bytes(int A) { return (long long)layout8(A).total; }

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
