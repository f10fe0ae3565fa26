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
// q = clip(rne(h / scale), +-127), with IEEE division. Every dequantization
// step is an explicitly rounded multiply or add (__fmul_rn / __fadd_rn: no
// FMA contraction), so the integer parts of all three GEMMs equal those of
// the plain version (toad_tpu_torch/ops/quantize.py::plain_int8_pool).
//
// What bounds it on an H100: ~2.4 MOP per 1024-d row against 1 KB of int8
// input, far above the card's int8 ridge, so it is tensor-core bound. The
// 1.15 MB of int8 weights stream from L2 as 64-deep slices through a 2-deep
// cp.async ring while a tile's activations stay in shared memory.
//
// The design problem is the per-row requantization: a row's scale needs the
// amax of all H = 512 columns before any element can be quantized. So the
// two trunk GEMMs run as one pass over all 512 columns: 8 warps as 2 (rows)
// x 4 (columns), each warp 32 rows x 128 columns = 2 x 16 mma tiles of
// int32 accumulators in registers. The epilogue dequantizes in registers,
// reduces each row's max over the quad of lanes that share it, then across
// the four column warps with a shared-memory atomicMax on the float bits
// (valid: every value is >= 0 after the ReLU), and after one barrier
// quantizes from registers into the tile's int8 activation buffer, in place
// of the GEMM's own input. The gate GEMM needs no requantization and runs in
// passes of 256 interleaved [Wa|Wb] columns; each thread folds its gated
// values into partial scores in registers, so the gated tile never reaches
// shared memory, and the partials of the four column warps are summed in a
// fixed order. The integer GEMMs use mma.sync m16n8k32 s8 (s32 accumulate)
// fed by ldmatrix: int8 fragments have the byte layout of K1's bf16 ones.
// The GEMM and its epilogues are pool_trunk.cuh's (gemm8, requant_epilogue
// with the JAX quantizer, gate_epilogue and reduce_scores at 2 task columns),
// shared with the int8 probe kernel. A first kernel: no wgmma, TMA or warp
// specialisation yet.
//
// Layout contract (the Python wrapper ops/cuda_pool_int8.py prepares it):
//   xq [B, N, D] int8, sx [B, N] and mask [B, N] f32; int8 weights in
//   nn.Linear layout [out, in] with f32 per-output scales and biases; the 2A
//   rows of [Wa|Wb]q (and their scales and biases) interleaved in groups of
//   32 as for K1; Wc [A, 2] bf16, bc [2] f32; H == 512.

#include "pool_trunk.cuh"

namespace {

constexpr int kR8 = kTileRows;  // rows per tile
constexpr int kH8 = kTrunkH;    // trunk width: one GEMM pass covers a whole row

struct Layout8 {
  size_t ws, xs, act, h2, wc, rs, rmax, spart, s, e, acc, stat, total;
};

__host__ __device__ inline Layout8 layout8(int A) {
  Layout8 L;
  size_t o = 0;
  L.ws = o;    o = align16(o + (size_t)kStages8 * kH8 * kS8);       // weight slices (int8)
  L.xs = o;    o = align16(o + (size_t)kStages8 * kR8 * kS8);       // input slices (int8)
  L.act = o;   o = align16(o + (size_t)kR8 * kLdAct);               // h1q, then h2q (int8)
  L.h2 = o;    o = align16(o + sizeof(bf16) * kR8 * kLdH2);         // h2 for pooling (bf16)
  L.wc = o;    o = align16(o + sizeof(float) * 2 * A);
  L.rs = o;    o = align16(o + sizeof(float) * kR8);                // row scales of the GEMM input
  L.rmax = o;  o = align16(o + sizeof(float) * 2 * kR8);            // row amax of h1, h2
  L.spart = o; o = align16(o + sizeof(float) * kColWarps * kR8 * 2);
  L.s = o;     o = align16(o + sizeof(float) * 2 * kR8);
  L.e = o;     o = align16(o + sizeof(float) * 2 * kR8);
  L.acc = o;   o = align16(o + sizeof(float) * 2 * kH8);
  L.stat = o;  o = align16(o + sizeof(float) * 8);
  L.total = o;
  return L;
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
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout8 L = layout8(A);
  u8* ws = smem + L.ws;
  u8* xs = smem + L.xs;
  u8* act = smem + L.act;
  bf16* h2 = reinterpret_cast<bf16*>(smem + L.h2);
  float* wc_s = reinterpret_cast<float*>(smem + L.wc);
  float* rs = reinterpret_cast<float*>(smem + L.rs);
  float* rmax = reinterpret_cast<float*>(smem + L.rmax);
  float* spart = reinterpret_cast<float*>(smem + L.spart);
  float* s_s = reinterpret_cast<float*>(smem + L.s);      // [R][2] raw scores
  float* e_s = reinterpret_cast<float*>(smem + L.e);      // [R][2] e rounded to bf16
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);  // [2][H]
  float* stat = reinterpret_cast<float*>(smem + L.stat);  // max[2], denom[2], corr[2]

  const int tid = threadIdx.x;
  const int split = blockIdx.x, b = blockIdx.y;
  const u8* xb = reinterpret_cast<const u8*>(xq) + (size_t)b * N * D;
  const float* sb = sx + (size_t)b * N;
  const float* mb = mask + (size_t)b * N;

  for (int i = tid; i < 2 * A; i += kThreads) wc_s[i] = __bfloat162float(wc[i]);
  for (int i = tid; i < 2 * kH8; i += kThreads) acc_s[i] = 0.f;
  if (tid < 2) {
    stat[tid] = kNegInf;
    stat[2 + tid] = 0.f;
  }
  __syncthreads();

  const int n_tiles = (N + kR8 - 1) / kR8;
  const int t_end = min(n_tiles, (split + 1) * tiles_per_split);
  for (int tile = split * tiles_per_split; tile < t_end; ++tile) {
    const int row0 = tile * kR8;
    const bool live = tid < kR8 && row0 + tid < N && mb[row0 + tid] > 0.f;
    // classification mode skips tiles of pure padding (the online update is
    // the identity there); scored mode writes every row's score
    if (!__syncthreads_or(live) && scores == nullptr) continue;
    if (tid < kR8) {
      rs[tid] = row0 + tid < N ? sb[row0 + tid] : 0.f;  // rows past the end are zeros
      rmax[tid] = 0.f;
      rmax[kR8 + tid] = 0.f;
    }

    int acc[2][16][4];
    // h1 = relu(dequant(xq W1q)) -> act (int8), rs <- its row scales
    gemm8<16, true, false>(acc, reinterpret_cast<const u8*>(w1t), D, 0, nullptr, 0, xb, N, D, row0, ws, xs);
    requant_epilogue<kReqF32, false>(acc, sw1, b1, rs, rmax, act, nullptr);
    // h2 = relu(dequant(h1q W2q)) -> h2 (bf16) and act (int8), rs <- its row scales
    gemm8<16, false, false>(acc, reinterpret_cast<const u8*>(w2t), kH8, 0, act, kLdAct, nullptr, N, D, row0, ws, xs);
    requant_epilogue<kReqF32, true>(acc, sw2, b2, rs, rmax + kR8, act, h2);
    // scores from the gate, pass by pass
    float sacc[2][2][2] = {};
    for (int n0 = 0; n0 < 2 * A; n0 += kGateCols) {
      int accg[2][8][4];
      gemm8<8, false, false>(accg, reinterpret_cast<const u8*>(wabt), kH8, n0, act, kLdAct, nullptr, N, D, row0, ws, xs);
      gate_epilogue<2>(accg, n0, rs, swab, bab, wc_s, sacc);
    }
    reduce_scores<2>(sacc, spart, bc, s_s, scores, b, N, row0);

    online_stats<kR8, bf16>(s_s, mb, row0, N, e_s, stat);
    __syncthreads();
    online_accumulate<kR8, bf16>(acc_s, e_s, stat, h2, kLdH2, kH8);
  }
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
