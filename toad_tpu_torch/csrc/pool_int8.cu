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
// A first kernel: no wgmma, TMA or warp specialisation yet.
//
// Layout contract (the Python wrapper ops/cuda_pool_int8.py prepares it):
//   xq [B, N, D] int8, sx [B, N] and mask [B, N] f32; int8 weights in
//   nn.Linear layout [out, in] with f32 per-output scales and biases; the 2A
//   rows of [Wa|Wb]q (and their scales and biases) interleaved in groups of
//   32 as for K1; Wc [A, 2] bf16, bc [2] f32; H == 512.

#include "pool_common.cuh"

namespace {

constexpr int kR8 = 64;             // rows per tile
constexpr int kH8 = 512;            // trunk width: one GEMM pass covers a whole row
constexpr int kBK8 = 64;            // reduction depth (bytes) per staged slice
constexpr int kS8 = kBK8 + 16;      // staged row stride: conflict-free ldmatrix, 16-byte cp.async
constexpr int kStages8 = 2;         // slices in flight in the cp.async ring
constexpr int kLdAct = kH8 + 16;    // int8 activation row stride (bytes)
constexpr int kLdH2 = kH8 + 8;      // bf16 h2 row stride (elements)
constexpr int kGateCols = 256;      // interleaved [Wa|Wb] columns per gate pass
constexpr int kColWarps = 4;

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

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage one K-slice: ws[n][k] <- wt[n0 + n][k0 + k] for n < NT * 32 and
// (kFromX) xs[r][k] <- x[row0 + r][k0 + k], rows past the bag's end
// zero-filled; always commits one group.
template <int NT, bool kFromX>
__device__ __forceinline__ void stage8(const int8_t* __restrict__ wt, int K, int n0, int k0, int8_t* ws,
                                       const int8_t* __restrict__ x, int N, int D, int row0, int8_t* xs) {
  constexpr int kChunks = kBK8 / 16;
  for (int i = threadIdx.x; i < NT * 32 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 16;
    cp_async16(ws + r * kS8 + c, wt + (size_t)(n0 + r) * K + k0 + c, 16);
  }
  if (kFromX) {
    for (int i = threadIdx.x; i < kR8 * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 16;
      const bool ok = row0 + r < N;
      cp_async16(xs + r * kS8 + c, ok ? x + (size_t)(row0 + r) * D + k0 + c : x, ok ? 16 : 0);
    }
  }
  cp_async_commit();
}

// acc = A[kR8, K] . Wt[n0 : n0 + NT*32, K]^T as int32. A is the staged x
// tile (kFromX) or the int8 activation buffer a_s [kR8][kLdAct]. Warp
// (wr, wc) owns rows wr*32 + mi*16 + {g, g+8} and columns
// n0 + wc*NT*8 + ni*8 + 2q (+1) (g = lane / 4, q = lane % 4), the PTX
// m16n8k32 accumulator layout.
template <int NT, bool kFromX>
__device__ __forceinline__ void gemm8(int (&acc)[2][NT][4], const int8_t* __restrict__ wt, int K, int n0,
                                      const int8_t* a_s, const int8_t* __restrict__ x, int N, int D, int row0,
                                      int8_t* ws, int8_t* xs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp / kColWarps, wc = warp % kColWarps;
  const int n_steps = K / kBK8;
  auto issue = [&](int step) {
    if (step < n_steps) {
      const int slot = step % kStages8;
      stage8<NT, kFromX>(wt, K, n0, step * kBK8, ws + slot * kH8 * kS8, x, N, D, row0, xs + slot * kR8 * kS8);
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
    const int8_t* a_base = kFromX ? xs + slot * kR8 * kS8 : a_s + step * kBK8;
    const int la = kFromX ? kS8 : kLdAct;
    const int8_t* w_base = ws + slot * kH8 * kS8;
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
          mma_s8(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          mma_s8(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
}

// f32(y) * (s_row * s_col) + b, each step rounded (no FMA contraction)
__device__ __forceinline__ float dequant(int y, float s_row, float s_col, float b) {
  return __fadd_rn(__fmul_rn(static_cast<float>(y), __fmul_rn(s_row, s_col)), b);
}

// Trunk epilogue over all kH8 columns: h = relu(dequant(acc)), h2 (kToBf16)
// rounded to bf16 for the pooling, then per-row requantization into act and
// the row scales into rs. rmax [kR8] must be zero on entry.
template <bool kToBf16>
__device__ __forceinline__ void requant_epilogue(int (&acc)[2][16][4], const float* __restrict__ s_col,
                                                 const float* __restrict__ bias, float* rs, float* rmax,
                                                 int8_t* act, bf16* h2) {
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
        if (kToBf16)
          *reinterpret_cast<__nv_bfloat162*>(h2 + row * kLdH2 + col) =
              __floats2bfloat162_rn(v[mi][ni][2 * hf], v[mi][ni][2 * hf + 1]);
      }
      // the four lanes of a quad hold the same row
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (q == 0) atomicMax(reinterpret_cast<int*>(rmax + row), __float_as_int(mx));
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
      const float scale = __fdiv_rn(fmaxf(rmax[row], 1e-6f), 127.f);
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) {
        const int col = wc * 128 + ni * 8 + 2 * q;
        int qv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          qv[e] = __float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(v[mi][ni][2 * hf + e], scale)), -127.f), 127.f));
        *reinterpret_cast<uint16_t*>(act + row * kLdAct + col) =
            static_cast<uint16_t>((qv[0] & 0xff) | ((qv[1] & 0xff) << 8));
      }
      if (wc == 0 && q == 0) rs[row] = scale;
    }
  }
}

// Gate epilogue of one pass over interleaved [Wa|Wb] columns n0..n0+255:
// warp column wc holds u_j in n-tiles 0-3 and v_j (32 columns further) in
// n-tiles 4-7 for j = n0/2 + wc*32 + ni*8 + 2q (+1); gated is rounded to
// bf16 and folded into the thread's partial scores sacc[mi][hf][t].
__device__ __forceinline__ void gate_epilogue(int (&acc)[2][8][4], int n0, const float* rs,
                                              const float* __restrict__ swab, const float* __restrict__ bab,
                                              const float* wc_s, float (&sacc)[2][2][2]) {
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
          const float gv = __bfloat162float(__float2bfloat16(tanhf(u) * sigmoidf(v)));
          const int j = n0 / 2 + wc * 32 + ni * 8 + 2 * q + e;
          sacc[mi][hf][0] = fmaf(gv, wc_s[2 * j], sacc[mi][hf][0]);
          sacc[mi][hf][1] = fmaf(gv, wc_s[2 * j + 1], sacc[mi][hf][1]);
        }
      }
    }
  }
}

// s = sum of the partial scores + bc, in a fixed order: the quad's lanes,
// then the four column warps. Writes s_s [kR8][2] and the live rows' raw
// scores (scored mode).
__device__ __forceinline__ void reduce_scores(float (&sacc)[2][2][2], float* spart, const float* __restrict__ bc,
                                              float* s_s, float* scores, int b, int N, int row0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp / kColWarps, wc = warp % kColWarps;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float v = sacc[mi][hf][t];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q == 0) spart[(wc * kR8 + wr * 32 + mi * 16 + g + hf * 8) * 2 + t] = v;
      }
    }
  }
  __syncthreads();
  if (tid < 2 * kR8) {
    const int r = tid >> 1, t = tid & 1;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kColWarps; ++w) s += spart[(w * kR8 + r) * 2 + t];
    s += __ldg(bc + t);
    s_s[2 * r + t] = s;
    if (scores != nullptr && row0 + r < N) scores[((size_t)b * 2 + t) * N + row0 + r] = s;
  }
  __syncthreads();
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
  int8_t* ws = reinterpret_cast<int8_t*>(smem + L.ws);
  int8_t* xs = reinterpret_cast<int8_t*>(smem + L.xs);
  int8_t* act = reinterpret_cast<int8_t*>(smem + L.act);
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
  const int8_t* xb = xq + (size_t)b * N * D;
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
    gemm8<16, true>(acc, w1t, D, 0, nullptr, xb, N, D, row0, ws, xs);
    requant_epilogue<false>(acc, sw1, b1, rs, rmax, act, nullptr);
    // h2 = relu(dequant(h1q W2q)) -> h2 (bf16) and act (int8), rs <- its row scales
    gemm8<16, false>(acc, w2t, kH8, 0, act, nullptr, N, D, row0, ws, xs);
    requant_epilogue<true>(acc, sw2, b2, rs, rmax + kR8, act, h2);
    // scores from the gate, pass by pass
    float sacc[2][2][2] = {};
    for (int n0 = 0; n0 < 2 * A; n0 += kGateCols) {
      int accg[2][8][4];
      gemm8<8, false>(accg, wabt, kH8, n0, act, nullptr, N, D, row0, ws, xs);
      gate_epilogue(accg, n0, rs, swab, bab, wc_s, sacc);
    }
    reduce_scores(sacc, spart, bc, s_s, scores, b, N, row0);

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
