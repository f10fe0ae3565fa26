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
// fills whole waves of one CTA an SM (cuda_pool.wave_split_plan). The
// stream's and the requantization's pieces (swz, stage_slice, trunk_slice,
// gate_slice, requant_rows with quant_row) are in pool_trunk.cuh, shared with
// the int8 probe (csrc/pool_int8_probe.cu); the cursor and the tile loop are
// this kernel's own.
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

constexpr int kR8 = kTileRows;  // rows per tile
constexpr int kH8 = kTrunkH;    // trunk width: one GEMM pass covers a whole row

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
      stage_slice<true>(p_s, n1, p_tile * kR8, w1, D, w2, wab, xb, N, ws + p_slot * kSlot8, xs + p_slot * kXSlot8);
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
      trunk_slice<true>(acc, xs + slot * kXSlot8, 0, 0, ws + slot * kSlot8);
    }
    requant_rows<kReqF32, false>(acc, sw1, b1, rs, amax_s, act, nullptr);
    // h2 = relu(dequant(h1q W2q)) -> h2 (bf16) and act (int8), rs <- its row scales
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
    requant_rows<kReqF32, true>(acc, sw2, b2, rs, amax_s, act, h2);
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
