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
// FLOP/byte: tensor-core bound.
//
// The design is the mma.sync pass K1's bf16 instance ran before its GEMMs
// moved onto wgmma (csrc/pool.cu), so that the ladder's deltas were K1's:
// 128-row tiles, one CTA an SM of 8 warps of 64 x 64, h1
// and h2 in one shared region with GEMM2's stash (half in registers, half in
// the x ring), weights streamed from L2 through a 3-slot cp.async ring, the
// grid in whole waves (ops/cuda_pool.wave_split_plan), each block's partial
// merged by pool_combine_kernel<8> (pool_common.cuh). The trunk and the
// gate GEMM are that pass's code (pool_trunk.cuh: gemm_rows128, relu_pack,
// store_packed, stash_put, stash_take), in K1's order. The variants are
// template parameters of one kernel: the gate epilogue (tanh/sigmoid, exp2
// or linear), the mode (online softmax, plain sum, or trunk only: no gate
// pass, the mask ignored) and the bags a tile (1, or 2 for the pair: 64 rows
// of each in one 128-row tile, the TPU probe's 2 x tile rows in one GEMM
// chain).
//
// The 8 task columns. K1's mma.sync pass folded its 2 gated columns into 16
// f32 registers a thread and kept acc [2][H] in 4 KB of shared memory; at 8
// columns that would be 64 registers (it had 247 and 8 to spare) and 16 KB
// (its layout left under 1 KB). What the probe does instead:
//   - the score head runs on the tensor cores: each gate pass rounds its
//     gated values to bf16 and repacks them as A fragments of
//     mma.m16n8k16 (the m16n8 accumulators of two n-tiles are one k16 A
//     fragment), times Wc^T [8][A] from device memory as the B operand, one
//     n-tile: 4 f32 registers per 16-row block, 16 a thread, as many as that
//     pass's two columns took. The column warps' partial scores then meet in the x
//     ring (spart [4][128][8], s and e [128][8]: 24 KB of its 32 KB);
//   - the running acc [8][H] of each bag lives in the CTA's own slot of
//     part_acc in device memory, the partial the combine reads: each tile
//     reads and writes its 16 KB (L2-resident) in the CUDA-core pass that
//     K1 runs for its e^T h2 (each thread owns 2 columns of every task, 16
//     sums in registers during that pass only), against 256 KB of x and 2.3
//     MB of weights streamed from L2 per tile.
// The alternative, a 2-slot weight ring that frees 20 KB of shared memory
// for acc [8][H], timed within 4 % of this design either way by instance
// (PERF.md §6) and would have changed the trunk K1 ran.
//
// Layout contract (ops/probe_pool.py prepares it): x [B, N, D] bf16, mask
// [B, N] f32, N a multiple of 64 (the pair's rows of each bag in a tile; a
// single bag's last 128-row tile may end 64 rows past N, where rows are
// zero-filled and excluded by their index, in trunkonly too); weights bf16
// in nn.Linear layout [out, in], the 2A rows of [Wa|Wb] (and bab)
// interleaved in groups of 32 as for K1; Wc transposed, [8, A] bf16; biases
// f32; H == 512.

#include "probe_common.cuh"

namespace {

constexpr int kLdh = kTrunkH + kHPad;  // activation row stride (elements)

enum Variant { kFull = 0, kExp2 = 1, kNoGate = 2, kNoSoftmax = 3, kTrunkOnly = 4 };

// One region h [128][H + 8] holds h1, then h2; the weight ring; the x ring,
// which holds half of GEMM2's stash after GEMM1 and the score scratch after
// the gate passes; stat [2][24] (max, denom and corr of each bag slot).
struct ProbeLayout {
  size_t h, ws, xs, stat, total;
};

__host__ __device__ inline ProbeLayout probe_layout() {
  ProbeLayout L;
  size_t o = 0;
  L.h = o;    o = align16(o + sizeof(bf16) * kRowsBf16 * kLdh);
  L.ws = o;   o = align16(o + sizeof(bf16) * kSlotsBf16 * kBN * kSBf16);
  L.xs = o;   o = align16(o + kXRingBytes);
  L.stat = o; o = align16(o + sizeof(float) * 2 * kStatStride);
  L.total = o;
  return L;
}
static_assert(sizeof(float) * (kColWarps + 2) * kRowsBf16 * kTasks <= kXRingBytes, "the score scratch fits the x ring");
static_assert(2 * kThreadsBf16 == kTrunkH && kThreadsBf16 == kThreads, "a thread owns two columns of every task");

// The gate epilogue of interleaved [Wa|Wb] columns n0..n0+255 with the score
// head on the tensor cores. Warp column wc holds u_j in n-tiles 0-3 and v_j
// (32 columns further) in n-tiles 4-7 for j = n0/2 + wc*32 + ni*8 + 2q (+1);
// bf16(gate(u_j, v_j)) of n-tiles 2kk and 2kk + 1 is the A fragment of k16
// step kk (rows g, g+8; k = ni*8 + 2q (+1) within the step), and Wc^T's rows
// are B's columns: b0 = Wc[j0 + 2q (+1)][g], b1 = Wc[j0 + 8 + 2q (+1)][g].
// sacc[mi] is the m16n8 accumulator of rows (g, g+8) x tasks (2q, 2q+1).
template <int kGate>
__device__ __forceinline__ void gate_mma(const float (&acc)[kMi][8][4], const float* __restrict__ bias,
                                         const bf16* __restrict__ wct, int A, int n0, float (&sacc)[kMi][4]) {
  const int lane = threadIdx.x & 31, wc = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
  uint32_t bw[2][2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const bf16* w = wct + (size_t)g * A + n0 / 2 + wc * 32 + kk * 16 + 2 * q;
    bw[kk][0] = __ldg(reinterpret_cast<const unsigned*>(w));
    bw[kk][1] = __ldg(reinterpret_cast<const unsigned*>(w + 8));
  }
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi) {
    uint32_t af[2][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int cu = n0 + wc * 64 + ni * 8 + 2 * q;  // u column; v is 32 further
        const float g0 = gate<kGate>(acc[mi][ni][2 * hf] + __ldg(bias + cu), acc[mi][ni + 4][2 * hf] + __ldg(bias + cu + 32));
        const float g1 = gate<kGate>(acc[mi][ni][2 * hf + 1] + __ldg(bias + cu + 1),
                                     acc[mi][ni + 4][2 * hf + 1] + __ldg(bias + cu + 33));
        const __nv_bfloat162 p = __floats2bfloat162_rn(g0, g1);
        af[ni >> 1][(ni & 1) * 2 + hf] = *reinterpret_cast<const uint32_t*>(&p);
      }
    mma_bf16(sacc[mi], af[0], bw[0][0], bw[0][1]);
    mma_bf16(sacc[mi], af[1], bw[1][0], bw[1][1]);
  }
}

// s = the four column warps' partial scores + bc, summed in a fixed order,
// into s_s [128][8]; spart [4][128][8] in the x ring.
__device__ __forceinline__ void reduce_scores_mma(const float (&sacc)[kMi][4], float* spart,
                                                  const float* __restrict__ bc, float* s_s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 2, wc = warp & 3;
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = wr * 16 * kMi + mi * 16 + (lane >> 2) + hf * 8;
      *reinterpret_cast<float2*>(spart + (wc * kRowsBf16 + row) * kTasks + 2 * (lane & 3)) =
          make_float2(sacc[mi][2 * hf], sacc[mi][2 * hf + 1]);
    }
  __syncthreads();
  for (int i = tid; i < kRowsBf16 * kTasks; i += kThreadsBf16) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kColWarps; ++w) s += spart[w * kRowsBf16 * kTasks + i];
    s_s[i] = s + __ldg(bc + i % kTasks);
  }
  __syncthreads();
}

// NB bags a block (1, or 2 for the pair), grid (n_splits, B / NB); block
// (split, p) runs row tiles split * tiles_per_split .. of bags p*NB.., each
// tile rows row0 .. row0 + 128 / NB - 1 of each of its bags.
template <int kGate, int kMode, int NB>
__global__ void __launch_bounds__(kThreadsBf16, 1)
probe_pool_kernel(const bf16* __restrict__ x, const float* __restrict__ mask, int N, int D, int A,
                  const bf16* __restrict__ w1t, const float* __restrict__ b1,
                  const bf16* __restrict__ w2t, const float* __restrict__ b2,
                  const bf16* __restrict__ wabt, const float* __restrict__ bab,
                  const bf16* __restrict__ wct, const float* __restrict__ bc,
                  int tiles_per_split, float* __restrict__ part_acc, float* __restrict__ part_stat) {
  constexpr int RB = kRowsBf16 / NB;
  constexpr bool kTrunk = kMode == kModeTrunk;
  constexpr int kSums = kTrunk ? 1 : kTasks;  // task rows of acc a tile updates
  extern __shared__ __align__(16) unsigned char smem[];
  const ProbeLayout L = probe_layout();
  bf16* h = reinterpret_cast<bf16*>(smem + L.h);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  float* spart = reinterpret_cast<float*>(smem + L.xs);  // [4][128][8] partial scores of the column warps
  float* s_s = spart + kColWarps * kRowsBf16 * kTasks;     // [128][8] raw scores
  float* e_s = s_s + kRowsBf16 * kTasks;                   // [128][8] e rounded to bf16
  float* stat = reinterpret_cast<float*>(smem + L.stat);   // [NB][24]

  const int tid = threadIdx.x, c0 = 2 * tid;
  const int split = blockIdx.x, n_splits = gridDim.x, bag0 = blockIdx.y * NB;
  const bf16* xb[NB];
  float* acc_g[NB];  // the block's slot of part_acc for each bag: its running acc [8][H]
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    xb[i] = x + (size_t)(bag0 + i) * N * D;
    acc_g[i] = part_acc + ((size_t)(bag0 + i) * n_splits + split) * kTasks * kTrunkH;
#pragma unroll
    for (int t = 0; t < kSums; ++t) *reinterpret_cast<float2*>(acc_g[i] + t * kTrunkH + c0) = make_float2(0.f, 0.f);
  }
  probe_stats_init<NB, kMode>(stat);
  __syncthreads();

  const int n_tiles = (N + RB - 1) / RB;
  const int t_end = min(n_tiles, (split + 1) * tiles_per_split);
  for (int tile = split * tiles_per_split; tile < t_end; ++tile) {
    const int row0 = tile * RB;
    {  // h1 = relu(x W1 + b1) -> h, then h2 = relu(h1 W2 + b2) over it, K1's trunk at H = 512
      float acc[kMi][8][4];
      uint32_t packed[kMi][8][2], stash[kMi / 2][8][2];
      uint32_t* stash_s = reinterpret_cast<uint32_t*>(xs);
      for (int n0 = 0; n0 < kTrunkH; n0 += kBN) {
        gemm_rows128<true, NB>(acc, w1t, D, n0, nullptr, 0, xb, N, D, row0, ws, xs);
        relu_pack(acc, b1, n0, packed);
        store_packed(packed, n0, h, kLdh);
      }
      gemm_rows128<false, NB>(acc, w2t, kTrunkH, 0, h, kLdh, nullptr, N, D, row0, ws, xs);
      relu_pack(acc, b2, 0, packed);
      stash_put(packed, stash, stash_s, tid);
      gemm_rows128<false, NB>(acc, w2t, kTrunkH, kBN, h, kLdh, nullptr, N, D, row0, ws, xs);
      relu_pack(acc, b2, kBN, packed);
      __syncthreads();
      uint32_t first[kMi][8][2];
      stash_take(first, stash, stash_s, tid);
      store_packed(first, 0, h, kLdh);
      store_packed(packed, kBN, h, kLdh);
    }
    if constexpr (!kTrunk) {
      float sacc[kMi][4] = {};
      for (int n0 = 0; n0 < 2 * A; n0 += kBN) {
        float acc[kMi][8][4];
        gemm_rows128<false, NB>(acc, wabt, kTrunkH, n0, h, kLdh, nullptr, N, D, row0, ws, xs);
        gate_mma<kGate>(acc, bab, wct, A, n0, sacc);
      }
      reduce_scores_mma(sacc, spart, bc, s_s);
      probe_stats<kRowsBf16, NB, kMode>(s_s, mask + (size_t)bag0 * N, N, row0, e_s, stat);
    }
    __syncthreads();  // h2, e and the statistics are in place
    const int n_rows = min(RB, N - row0);  // rows of each bag inside it
#pragma unroll
    for (int slot = 0; slot < NB; ++slot) {
      float a[kTasks][2];
#pragma unroll
      for (int t = 0; t < kSums; ++t) {
        const float2 v = *reinterpret_cast<const float2*>(acc_g[slot] + t * kTrunkH + c0);
        a[t][0] = v.x;
        a[t][1] = v.y;
      }
      probe_fold<kRowsBf16, NB, kTrunk>(a, slot, n_rows, e_s, stat, h, kLdh);
#pragma unroll
      for (int t = 0; t < kSums; ++t) *reinterpret_cast<float2*>(acc_g[slot] + t * kTrunkH + c0) = make_float2(a[t][0], a[t][1]);
    }
  }
  // each bag's partial: acc is in its slot already (trunk mode copies its one
  // sum to the 8 task rows); max[8] and denom[8] beside it
#pragma unroll
  for (int slot = 0; slot < NB; ++slot) {
    const size_t p = (size_t)(bag0 + slot) * n_splits + split;
    if (tid < 2 * kTasks) part_stat[p * 2 * kTasks + tid] = stat[slot * kStatStride + tid];
    if constexpr (kTrunk) {
      const float2 v = *reinterpret_cast<const float2*>(acc_g[slot] + c0);
#pragma unroll
      for (int t = 1; t < kTasks; ++t) *reinterpret_cast<float2*>(acc_g[slot] + t * kTrunkH + c0) = v;
    }
  }
}

template <int kGate, int kMode, int NB>
int launch_probe(const void* x, const float* mask, int B, int N, int D, int A, const void* w1t, const float* b1,
                 const void* w2t, const float* b2, const void* wabt, const float* bab, const void* wct,
                 const float* bc, int tiles_per_split, int n_splits, float divisor, float* part_acc,
                 float* part_stat, float* out, cudaStream_t stream) {
  const size_t smem = probe_layout().total;
  auto kernel = probe_pool_kernel<kGate, kMode, NB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_splits, B / NB), kThreadsBf16, smem, stream>>>(
      static_cast<const bf16*>(x), mask, N, D, A, static_cast<const bf16*>(w1t), b1, static_cast<const bf16*>(w2t),
      b2, static_cast<const bf16*>(wabt), bab, static_cast<const bf16*>(wct), bc, tiles_per_split, part_acc, part_stat);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<kTasks>(part_acc, part_stat, n_splits, B, kTrunkH, out, stream, divisor);
}

}  // namespace

extern "C" {

// Rows of one bag in a tile: 128, or 64 for the pair instance.
int toad_probe_pool_rows_per_tile(int pair) { return pair ? kRowsBf16 / 2 : kRowsBf16; }

// Dynamic shared memory of a block (the same for every instance and A).
long long toad_probe_pool_smem_bytes() { return (long long)probe_layout().total; }

// variant: 0 full, 1 exp2, 2 nogate, 3 nosoftmax, 4 trunkonly; pair = 1
// (full only): two bags a block. out [B][8][H] f32; probe_tiles: the
// probe's count of row tiles per bag (trunkonly's divisor); part_acc [B]
// [n_splits][8][H] and part_stat [B][n_splits][16] are the blocks'
// partials. Returns the launches' cudaError_t (0 on success); does not
// synchronise.
int toad_probe_pool_forward(int variant, int pair, const void* x, const float* mask, int B, int N, int D, int H, int A,
                            const void* w1t, const float* b1, const void* w2t, const float* b2,
                            const void* wabt, const float* bab, const void* wct, const float* bc,
                            int probe_tiles, int tiles_per_split, int n_splits,
                            float* part_acc, float* part_stat, float* out, void* stream) {
  if (H != kTrunkH || D % kBK != 0 || A % (kBN / 2) != 0 || A > H || N % (kRowsBf16 / 2) != 0 ||
      (pair && B % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TOAD_PROBE_ARGS x, mask, B, N, D, A, w1t, b1, w2t, b2, wabt, bab, wct, bc, tiles_per_split, n_splits
  if (pair) {
    if (variant != kFull) return (int)cudaErrorInvalidValue;
    return launch_probe<kEpiTanh, kModeSoftmax, 2>(TOAD_PROBE_ARGS, 0.f, part_acc, part_stat, out, s);
  }
  switch (variant) {
    case kFull: return launch_probe<kEpiTanh, kModeSoftmax, 1>(TOAD_PROBE_ARGS, 0.f, part_acc, part_stat, out, s);
    case kExp2: return launch_probe<kEpiExp2, kModeSoftmax, 1>(TOAD_PROBE_ARGS, 0.f, part_acc, part_stat, out, s);
    case kNoGate: return launch_probe<kEpiLinear, kModeSoftmax, 1>(TOAD_PROBE_ARGS, 0.f, part_acc, part_stat, out, s);
    case kNoSoftmax: return launch_probe<kEpiTanh, kModeSum, 1>(TOAD_PROBE_ARGS, 0.f, part_acc, part_stat, out, s);
    case kTrunkOnly:
      return launch_probe<kEpiRelu, kModeTrunk, 1>(TOAD_PROBE_ARGS, (float)probe_tiles, part_acc, part_stat, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TOAD_PROBE_ARGS
}

}  // extern "C"
