// The pooling probe's ablation ladder, hand-written for Hopper (sm_90a).
//
// Replaces experiments/mfu_probe.py::make_kernel (P1: the variants full,
// fusedab = full, exp2, nogate, nosoftmax, trunkonly; its pallas_call at
// :135), make_kernel_b2 (P2, two bags per step; :223) and
// experiments/int8_probe.py::make_kernel_bf16 (P5, the int8 probe's bf16
// baseline, full's body; :324). Per bag, over T_PAD = 8 task columns:
//     h1 = bf16(relu(x W1 + b1)); h2 = bf16(relu(h1 W2 + b2))     (f32 sums)
//     uv = h2 [Wa|Wb] + bab; gated = bf16(a(u) * g(v))           f32 gate
//     s  = gated Wc + bc  [rows, 8] f32
// with a, g = tanh, sigmoid (full, nosoftmax), the same through exp (exp2:
// 1 - 2 / (e^{2u} + 1) and 1 / (1 + e^{-v})) or linear (nogate: u / 8 and
// v / 8 + 1/2), then the online masked softmax with e rounded to bf16 before
// e^T h2 (full, exp2, nogate), a plain running sum of e = min(s, 1) on live
// rows (nosoftmax, out = acc / max(sum e, 1e-30)), or no gate at all
// (trunkonly: out = sum over every row of h2 / the probe's count of row
// tiles, the mask ignored, as the probe computes it). Columns 2-7 of the
// probes' Wc are zero: their softmax is uniform and they are computed all
// the same.
//
// What bounds it on an H100: the GEMMs, ~2.4 MFLOP per 1024-d row against
// 2 KB of bf16 input (trunkonly 1.6 MFLOP), far above the card's ~295
// FLOP/byte: tensor-core bound. The design is K1's (csrc/pool.cu; the
// variants are its template parameter): a split-N grid of (split, bag)
// blocks, 64-row tiles whose h1, h2 and gated activations stay in shared
// memory, K1's own GEMM pass (gemm_pass_bf16 in pool_trunk.cuh: 256-column
// passes of mma.sync m16n8k16 fed by ldmatrix, weights streamed from L2
// through a 3-deep cp.async ring; the gate variant is its epilogue), each
// block's partial (acc, max, denom) merged exactly by K1's combine
// (pool_combine_kernel at 8 task columns, pool_common.cuh). The 8 task
// columns do not fit K1's shared memory beside the activations (acc [8][512]
// f32 alone is 16 KB), so the sums live in registers (16 a thread, see
// probe_common.cuh) and the score head is a warp per row against Wc in
// shared memory. The TPU's tile of 1,024 rows is not carried over: it
// enters only as trunkonly's divisor.
//
// The pair instance (P2) runs 32 rows of each of two bags as one 64-row
// GEMM chain, then the softmax bookkeeping per bag. A 128-row chain (64 of
// each, the TPU probe's doubled M) would need 266 KB for h1 and h2 alone,
// over the 227 KB a block can have, so the pair keeps the block's M at 64
// and halves each bag's share: what it measures on this card is one weight
// stream and one block's overhead serving two bags.
//
// Layout contract (ops/probe_pool.py prepares it): x [B, N, D] bf16, mask
// [B, N] f32, N a multiple of 64; weights bf16 in nn.Linear layout [out,
// in], the 2A rows of [Wa|Wb] (and bab) interleaved in groups of 32 as for
// K1; Wc [A, 8] bf16; biases f32; H == 512.

#include "probe_common.cuh"

namespace {

constexpr int kLdh = kTrunkH + 8;  // activation row stride (elements)

enum Variant { kFull = 0, kExp2 = 1, kNoGate = 2, kNoSoftmax = 3, kTrunkOnly = 4 };

struct ProbeLayout {
  size_t ha, hb, ws, xs, wc, s, e, stat, total;
};

__host__ __device__ inline ProbeLayout probe_layout(int A) {
  ProbeLayout L;
  size_t o = 0;
  L.ha = o;   o = align16(o + sizeof(bf16) * kTileRows * kLdh);
  L.hb = o;   o = align16(o + sizeof(bf16) * kTileRows * kLdh);
  L.ws = o;   o = align16(o + sizeof(bf16) * kRingBf16 * kBN * kSBf16);
  L.xs = o;   o = align16(o + sizeof(bf16) * kRingBf16 * kTileRows * kSBf16);
  L.wc = o;   o = align16(o + sizeof(float) * kTasks * A);
  L.s = o;    o = align16(o + sizeof(float) * kTasks * kTileRows);
  L.e = o;    o = align16(o + sizeof(float) * kTasks * kTileRows);
  L.stat = o; o = align16(o + sizeof(float) * 2 * kStatStride);
  L.total = o;
  return L;
}

// NB bags per block (1, or 2 for the pair), grid (n_splits, B / NB); block
// (split, p) runs row tiles split * tiles_per_split .. of bags p*NB.. .
template <int kVar, int NB>
__global__ void __launch_bounds__(kThreads, 1)
probe_pool_kernel(const bf16* __restrict__ x, const float* __restrict__ mask, int N, int D, int A,
                  const bf16* __restrict__ w1t, const float* __restrict__ b1,
                  const bf16* __restrict__ w2t, const float* __restrict__ b2,
                  const bf16* __restrict__ wabt, const float* __restrict__ bab,
                  const bf16* __restrict__ wc, const float* __restrict__ bc,
                  int tiles_per_split, float* __restrict__ part_acc, float* __restrict__ part_stat) {
  constexpr int RB = kTileRows / NB;
  constexpr int kMode = kVar == kTrunkOnly ? kModeTrunk : (kVar == kNoSoftmax ? kModeSum : kModeSoftmax);
  constexpr int kGate = kVar == kExp2 ? kEpiExp2 : (kVar == kNoGate ? kEpiLinear : kEpiTanh);
  extern __shared__ __align__(16) unsigned char smem[];
  const ProbeLayout L = probe_layout(A);
  bf16* ha = reinterpret_cast<bf16*>(smem + L.ha);
  bf16* hb = reinterpret_cast<bf16*>(smem + L.hb);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  float* wc_s = reinterpret_cast<float*>(smem + L.wc);  // [A][8]
  float* s_s = reinterpret_cast<float*>(smem + L.s);    // [64][8] raw scores
  float* e_s = reinterpret_cast<float*>(smem + L.e);    // [64][8] e rounded to bf16
  float* stat = reinterpret_cast<float*>(smem + L.stat);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, n_splits = gridDim.x, bag0 = blockIdx.y * NB;
  const bf16* xb[NB];
  const float* mb[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    xb[i] = x + (size_t)(bag0 + i) * N * D;
    mb[i] = mask + (size_t)(bag0 + i) * N;
  }
  for (int i = tid; i < kTasks * A; i += kThreads) wc_s[i] = __bfloat162float(wc[i]);
  probe_stats_init<NB, kMode>(stat);
  float acc[NB][kTasks][2];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int t = 0; t < kTasks; ++t) acc[i][t][0] = acc[i][t][1] = 0.f;
  __syncthreads();

  const int n_tiles = N / RB;
  const int t_end = min(n_tiles, (split + 1) * tiles_per_split);
  for (int tile = split * tiles_per_split; tile < t_end; ++tile) {
    const int row0 = tile * RB;
    for (int n0 = 0; n0 < kTrunkH; n0 += kBN)  // h1 = relu(x W1 + b1) -> ha
      gemm_pass_bf16<kEpiRelu, true, NB>(w1t, D, n0, b1, nullptr, kLdh, xb, N, D, row0, ws, xs, ha, kLdh);
    for (int n0 = 0; n0 < kTrunkH; n0 += kBN)  // h2 = relu(h1 W2 + b2) -> hb
      gemm_pass_bf16<kEpiRelu, false, NB>(w2t, kTrunkH, n0, b2, ha, kLdh, xb, N, D, row0, ws, xs, hb, kLdh);
    if (kMode != kModeTrunk) {
      for (int n0 = 0; n0 < 2 * A; n0 += kBN)  // gated -> ha[:, :A]
        gemm_pass_bf16<kGate, false, NB>(wabt, kTrunkH, n0, bab, hb, kLdh, xb, N, D, row0, ws, xs, ha, kLdh);
      __syncthreads();
      // scores s = gated Wc + bc, one warp per row
      for (int r = warp; r < kTileRows; r += kThreads / 32) {
        float s[kTasks] = {};
        for (int j = lane; j < A; j += 32) {
          const float gv = __bfloat162float(ha[r * kLdh + j]);
          float w[kTasks];
          load_row<kTasks>(wc_s + j * kTasks, w);
#pragma unroll
          for (int t = 0; t < kTasks; ++t) s[t] = fmaf(gv, w[t], s[t]);
        }
#pragma unroll
        for (int t = 0; t < kTasks; ++t) s[t] = warp_sum(s[t]);
        if (lane < kTasks) {
          float v = s[0];
#pragma unroll
          for (int t = 1; t < kTasks; ++t) v = lane == t ? s[t] : v;
          s_s[r * kTasks + lane] = v + __ldg(bc + lane);
        }
      }
      __syncthreads();
      probe_stats<NB, kMode>(s_s, mb, row0, e_s, stat);
    }
    __syncthreads();
    probe_accumulate<NB, kMode == kModeTrunk>(acc, e_s, stat, hb, kLdh);
  }
  probe_write_partials<NB, kMode == kModeTrunk>(acc, stat, bag0, split, n_splits, part_acc, part_stat);
}

template <int kVar, int NB>
int launch_probe(const void* x, const float* mask, int B, int N, int D, int A, const void* w1t, const float* b1,
                 const void* w2t, const float* b2, const void* wabt, const float* bab, const void* wc,
                 const float* bc, int tiles_per_split, int n_splits, float divisor, float* part_acc,
                 float* part_stat, float* out, cudaStream_t stream) {
  const size_t smem = probe_layout(A).total;
  cudaError_t err = cudaFuncSetAttribute(probe_pool_kernel<kVar, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  probe_pool_kernel<kVar, NB><<<dim3(n_splits, B / NB), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), mask, N, D, A, static_cast<const bf16*>(w1t), b1, static_cast<const bf16*>(w2t),
      b2, static_cast<const bf16*>(wabt), bab, static_cast<const bf16*>(wc), bc, tiles_per_split, part_acc, part_stat);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<kTasks>(part_acc, part_stat, n_splits, B, kTrunkH, out, stream, divisor);
}

}  // namespace

extern "C" {

// Rows of one bag in a tile: 64, or 32 for the pair instance.
int toad_probe_pool_rows_per_tile(int pair) { return pair ? kTileRows / 2 : kTileRows; }

long long toad_probe_pool_smem_bytes(int A) { return (long long)probe_layout(A).total; }

// variant: 0 full, 1 exp2, 2 nogate, 3 nosoftmax, 4 trunkonly; pair = 1
// (full only): two bags a block. out [B][8][H] f32; probe_tiles: the
// probe's count of row tiles per bag (trunkonly's divisor). Returns the
// launches' cudaError_t (0 on success); does not synchronise.
int toad_probe_pool_forward(int variant, int pair, const void* x, const float* mask, int B, int N, int D, int H, int A,
                            const void* w1t, const float* b1, const void* w2t, const float* b2,
                            const void* wabt, const float* bab, const void* wc, const float* bc,
                            int probe_tiles, int tiles_per_split, int n_splits,
                            float* part_acc, float* part_stat, float* out, void* stream) {
  if (H != kTrunkH || D % kBK != 0 || A % (kBN / 2) != 0 || A > H || N % kTileRows != 0 || (pair && B % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TOAD_PROBE_ARGS x, mask, B, N, D, A, w1t, b1, w2t, b2, wabt, bab, wc, bc, tiles_per_split, n_splits
  if (pair) {
    if (variant != kFull) return (int)cudaErrorInvalidValue;
    return launch_probe<kFull, 2>(TOAD_PROBE_ARGS, 0.f, part_acc, part_stat, out, s);
  }
  switch (variant) {
    case kFull: return launch_probe<kFull, 1>(TOAD_PROBE_ARGS, 0.f, part_acc, part_stat, out, s);
    case kExp2: return launch_probe<kExp2, 1>(TOAD_PROBE_ARGS, 0.f, part_acc, part_stat, out, s);
    case kNoGate: return launch_probe<kNoGate, 1>(TOAD_PROBE_ARGS, 0.f, part_acc, part_stat, out, s);
    case kNoSoftmax: return launch_probe<kNoSoftmax, 1>(TOAD_PROBE_ARGS, 0.f, part_acc, part_stat, out, s);
    case kTrunkOnly:
      return launch_probe<kTrunkOnly, 1>(TOAD_PROBE_ARGS, (float)probe_tiles, part_acc, part_stat, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TOAD_PROBE_ARGS
}

}  // extern "C"
