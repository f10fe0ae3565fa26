// Fused trunk + gated attention + masked online-softmax pooling over padded
// bags, hand-written for Hopper (sm_90a).
//
// Replaces toad_tpu/ops/pallas_pool.py::_pool_kernel_body (the TPU kernel K1).
// Per bag and per row tile it computes
//     h1 = relu(x W1 + b1); h2 = relu(h1 W2 + b2)            (compute dtype)
//     uv = h2 [Wa|Wb] + [ba|bb]; gated = tanh(u) * sigmoid(v) (f32, rounded)
//     s  = gated Wc + bc                                      [rows, 2] f32
// and folds the tile into an online masked softmax (running max, denominator
// and acc[2, H] += e^T h2), so the [N, H] activations never reach device
// memory. The rounding points are the TPU kernel's: h1, h2 and gated are
// rounded to the compute dtype, tanh/sigmoid/scores/softmax stay f32, and e
// is rounded to the compute dtype before e^T h2.
//
// What bounds it on an H100: about 2.4 MFLOP per 1024-d row against 2 KB of
// bf16 input, ~1,150 FLOP/byte, far above the card's ~295, so it is
// tensor-core bound, not HBM bound. The 2.3 MB (bf16) of weights do not fit
// in shared memory, so each GEMM streams 256-column x 32-deep weight slices
// from L2 (where all weights stay resident) through shared memory, while the
// row tile's h1, h2 and gated activations stay in shared memory. The TPU's
// sequential grid (state carried across a bag's tiles) becomes a split-N
// grid: block (split, bag) runs a contiguous range of row tiles and writes a
// partial (acc, max, denom); pool_combine_kernel merges the partials exactly
// (and, in partial mode, leaves the division to the cross-shard combine),
// spread over 2H/32 blocks per bag so that one large bag combines in parallel.
// The bf16 instance uses mma.sync m16n8k16 (f32 accumulate) fed by ldmatrix,
// with a 3-deep cp.async ring of weight/input slices; the f32 instance uses
// FMA so that f32 stays f32 (no TF32) and stages synchronously. A first
// kernel: no wgmma, TMA or warp specialisation yet.
//
// Layout contract (the Python wrapper ops/cuda_pool.py prepares it):
//   x [B, N, D] and weights in the compute dtype T, weights in nn.Linear
//   layout [out, in]; the 2A rows of [Wa|Wb]^T are interleaved in groups of
//   32 (u rows g*32.., then v rows g*32..) so that a thread holds u_j and v_j
//   of the same j; biases, mask and all outputs are f32.

#include "pool_trunk.cuh"

namespace {

constexpr int kHPad = 8;       // row padding of the activation buffers

// Rows per tile, staging stride (elements) and staging depth per compute
// dtype. bf16: gemm_pass_bf16's (pool_trunk.cuh), rows padded by 16 bytes;
// f32 rows by one word (conflict-free column reads), staged synchronously
// through one buffer.
template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int R = kTileRows;
  static constexpr int S = kSBf16;
  static constexpr int kStages = kRingBf16;
};
template <> struct Cfg<float> {
  static constexpr int R = 32;
  static constexpr int S = kBK + 1;
  static constexpr int kStages = 1;
};

struct Layout {
  size_t ha, hb, ws, xs, wc, s, e, acc, stat, total;
};

template <typename T>
__host__ __device__ inline Layout layout(int H, int A) {
  constexpr int R = Cfg<T>::R;
  constexpr int S = Cfg<T>::S;
  Layout L;
  size_t o = 0;
  L.ha = o;   o = align16(o + sizeof(T) * R * (H + kHPad));
  L.hb = o;   o = align16(o + sizeof(T) * R * (H + kHPad));
  L.ws = o;   o = align16(o + sizeof(T) * Cfg<T>::kStages * kBN * S);
  L.xs = o;   o = align16(o + sizeof(T) * Cfg<T>::kStages * R * S);
  L.wc = o;   o = align16(o + sizeof(float) * 2 * A);
  L.s = o;    o = align16(o + sizeof(float) * 2 * R);
  L.e = o;    o = align16(o + sizeof(float) * 2 * R);
  L.acc = o;  o = align16(o + sizeof(float) * 2 * H);
  L.stat = o; o = align16(o + sizeof(float) * 8);
  L.total = o;
  return L;
}

// ---------------------------------------------------------------------------
// Staging of one K-slice of the f32 instance into shared memory (the bf16
// instance's is stage_bf16, in pool_trunk.cuh).

// f32: ws[n][k] <- wt[n0 + n][k0 + k], n < kBN, k < kBK
__device__ __forceinline__ void stage_w(const float* __restrict__ wt, int K, int n0, int k0, float* ws) {
  for (int i = threadIdx.x; i < kBN * (kBK / 4); i += kThreads) {
    const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(wt + (size_t)(n0 + r) * K + k0 + c));
    float* d = ws + r * Cfg<float>::S + c;
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
}

// f32: xs[r][k] <- x[row0 + r][k0 + k]; rows past the bag's end read as zeros
__device__ __forceinline__ void stage_x(const float* __restrict__ x, int N, int D, int row0, int k0, float* xs) {
  constexpr int R = Cfg<float>::R;
  for (int i = threadIdx.x; i < R * (kBK / 4); i += kThreads) {
    const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < N) v = __ldg(reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * D + k0 + c));
    float* d = xs + r * Cfg<float>::S + c;
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
}

// ---------------------------------------------------------------------------
// One GEMM pass: out[R, n0 : n0+kBN] of  A[R, K] . Wt[n0 : n0+kBN, K]^T.
// A is the staged x tile (kFromX) or an activation buffer in shared memory.
// kEpiRelu epilogue: out[r][n0 + c] = T(relu(acc + bias)).
// kEpiTanh epilogue: out[r][j] = T(tanh(u_j) * sigmoid(v_j)) over the
// interleaved [Wa|Wb] columns (j = n0/2 + position within the u half).

struct GemmArgs {
  const void* x;  // bag base [N, D] (kFromX only)
  int N, D, row0;
  const void* a_s;  // activation buffer [R][lda] (not kFromX)
  int lda, K;
  const void* wt;  // [n_out, K]
  const float* bias;
  int n0;
  void* ws;
  void* xs;
  void* out;  // [R][ldo]
  int ldo;
};

// bf16: gemm_pass_bf16 (pool_trunk.cuh) on one bag
template <int kEpi, bool kFromX>
__device__ void gemm_pass(const GemmArgs& g, bf16*) {
  const bf16* xb[1] = {static_cast<const bf16*>(g.x)};
  gemm_pass_bf16<kEpi, kFromX, 1>(static_cast<const bf16*>(g.wt), g.K, g.n0, g.bias, static_cast<const bf16*>(g.a_s),
                                  g.lda, xb, g.N, g.D, g.row0, static_cast<bf16*>(g.ws), static_cast<bf16*>(g.xs),
                                  static_cast<bf16*>(g.out), g.ldo);
}

// f32: thread (tr = tid / 32, tc = tid % 32) owns rows tr + 8i (i < 4) and
// columns tc + 32c (c < 8); columns tc + 64p and tc + 64p + 32 are u_j, v_j.
template <int kEpi, bool kFromX>
__device__ void gemm_pass(const GemmArgs& g, float*) {
  constexpr int S = Cfg<float>::S;
  const int tc = threadIdx.x & 31, tr = threadIdx.x >> 5;
  float* ws = static_cast<float*>(g.ws);
  float* xs = static_cast<float*>(g.xs);
  const float* a_s = static_cast<const float*>(g.a_s);

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < g.K; k0 += kBK) {
    __syncthreads();
    stage_w(static_cast<const float*>(g.wt), g.K, g.n0, k0, ws);
    if (kFromX) stage_x(static_cast<const float*>(g.x), g.N, g.D, g.row0, k0, xs);
    __syncthreads();
    const float* a_base = kFromX ? xs : a_s + k0;
    const int la = kFromX ? S : g.lda;
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], w[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_base[(tr + 8 * i) * la + kk];
#pragma unroll
      for (int c = 0; c < 8; ++c) w[c] = ws[(tc + 32 * c) * S + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], w[c], acc[i][c]);
    }
  }

  float* out = static_cast<float*>(g.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = tr + 8 * i;
    if (kEpi == kEpiRelu) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = g.n0 + tc + 32 * c;
        out[row * g.ldo + col] = fmaxf(acc[i][c] + __ldg(g.bias + col), 0.f);
      }
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int cu = g.n0 + tc + 64 * p;
        const float u = acc[i][2 * p] + __ldg(g.bias + cu);
        const float v = acc[i][2 * p + 1] + __ldg(g.bias + cu + 32);
        out[row * g.ldo + g.n0 / 2 + 32 * p + tc] = tanhf(u) * sigmoidf(v);
      }
    }
  }
}

// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
pool_kernel(const T* __restrict__ x, const float* __restrict__ mask, int N, int D, int H, int A,
            const T* __restrict__ w1t, const float* __restrict__ b1,
            const T* __restrict__ w2t, const float* __restrict__ b2,
            const T* __restrict__ wabt, const float* __restrict__ bab,
            const T* __restrict__ wc, const float* __restrict__ bc,
            int tiles_per_split, int n_splits,
            float* __restrict__ scores, float* __restrict__ part_acc, float* __restrict__ part_stat) {
  constexpr int R = Cfg<T>::R;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T>(H, A);
  T* ha = reinterpret_cast<T*>(smem + L.ha);
  T* hb = reinterpret_cast<T*>(smem + L.hb);
  float* wc_s = reinterpret_cast<float*>(smem + L.wc);
  float* s_s = reinterpret_cast<float*>(smem + L.s);    // [R][2] raw scores
  float* e_s = reinterpret_cast<float*>(smem + L.e);    // [R][2] e rounded to T
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);  // [2][H]
  float* stat = reinterpret_cast<float*>(smem + L.stat);  // max[2], denom[2], corr[2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, b = blockIdx.y;
  const int ldh = H + kHPad;
  const T* xb = x + (size_t)b * N * D;
  const float* mb = mask + (size_t)b * N;

  for (int i = tid; i < 2 * A; i += kThreads) wc_s[i] = to_f(wc[i]);
  for (int i = tid; i < 2 * H; i += kThreads) acc_s[i] = 0.f;
  if (tid < 2) {
    stat[tid] = kNegInf;
    stat[2 + tid] = 0.f;
  }
  __syncthreads();

  const int n_tiles = (N + R - 1) / R;
  const int t_end = min(n_tiles, (split + 1) * tiles_per_split);
  for (int tile = split * tiles_per_split; tile < t_end; ++tile) {
    const int row0 = tile * R;
    const bool live = tid < R && row0 + tid < N && mb[row0 + tid] > 0.f;
    // classification mode skips tiles of pure padding (the online update is
    // the identity there); scored mode writes every row's score
    if (!__syncthreads_or(live) && scores == nullptr) continue;

    GemmArgs g;
    g.x = xb; g.N = N; g.D = D; g.row0 = row0;
    g.ws = smem + L.ws; g.xs = smem + L.xs; g.ldo = ldh; g.lda = ldh;
    // h1 = relu(x W1 + b1) -> ha
    g.K = D; g.wt = w1t; g.bias = b1; g.out = ha; g.a_s = nullptr;
    for (int n0 = 0; n0 < H; n0 += kBN) { g.n0 = n0; gemm_pass<kEpiRelu, true>(g, (T*)nullptr); }
    // h2 = relu(h1 W2 + b2) -> hb
    g.K = H; g.wt = w2t; g.bias = b2; g.out = hb; g.a_s = ha;
    for (int n0 = 0; n0 < H; n0 += kBN) { g.n0 = n0; gemm_pass<kEpiRelu, false>(g, (T*)nullptr); }
    // gated = tanh(h2 Wa + ba) * sigmoid(h2 Wb + bb) -> ha[:, :A]
    g.wt = wabt; g.bias = bab; g.out = ha; g.a_s = hb;
    for (int n0 = 0; n0 < 2 * A; n0 += kBN) { g.n0 = n0; gemm_pass<kEpiTanh, false>(g, (T*)nullptr); }
    __syncthreads();

    // scores s = gated Wc + bc, one warp per row
    for (int r = warp; r < R; r += kThreads / 32) {
      float s0 = 0.f, s1 = 0.f;
      for (int j = lane; j < A; j += 32) {
        const float gv = to_f(ha[r * ldh + j]);
        s0 = fmaf(gv, wc_s[2 * j], s0);
        s1 = fmaf(gv, wc_s[2 * j + 1], s1);
      }
      s0 = warp_sum(s0) + __ldg(bc);
      s1 = warp_sum(s1) + __ldg(bc + 1);
      if (lane == 0) {
        s_s[2 * r] = s0;
        s_s[2 * r + 1] = s1;
        if (scores != nullptr && row0 + r < N) {
          scores[((size_t)b * 2) * N + row0 + r] = s0;
          scores[((size_t)b * 2 + 1) * N + row0 + r] = s1;
        }
      }
    }
    __syncthreads();

    online_stats<R, T>(s_s, mb, row0, N, e_s, stat);
    __syncthreads();
    online_accumulate<R, T>(acc_s, e_s, stat, hb, ldh, H);
  }
  __syncthreads();

  const size_t p = (size_t)b * n_splits + split;
  for (int i = tid; i < 2 * H; i += kThreads) part_acc[p * 2 * H + i] = acc_s[i];
  if (tid < 4) part_stat[p * 4 + tid] = stat[tid];
}

template <typename T>
int launch(const void* x, const float* mask, int B, int N, int D, int H, int A,
           const void* w1t, const float* b1, const void* w2t, const float* b2,
           const void* wabt, const float* bab, const void* wc, const float* bc,
           int tiles_per_split, int n_splits,
           float* scores, float* part_acc, float* part_stat, float* out, float* stat_out, cudaStream_t stream) {
  const size_t smem = layout<T>(H, A).total;
  cudaError_t err = cudaFuncSetAttribute(pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pool_kernel<T><<<dim3(n_splits, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), mask, N, D, H, A,
      static_cast<const T*>(w1t), b1, static_cast<const T*>(w2t), b2,
      static_cast<const T*>(wabt), bab, static_cast<const T*>(wc), bc,
      tiles_per_split, n_splits, scores, part_acc, part_stat);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // partial mode (K1p, the TPU kernel's stats_out_ref form): the same merge
  // of the split partials without the division, so that `out` and `stat_out`
  // are one unnormalised (acc, max, denom) per bag for a later combine
  if (stat_out != nullptr)
    return launch_combine_strided<2, false>(part_acc, part_stat, n_splits, n_splits, 1, B, H, 0.f, 0.f, out, stat_out,
                                            stream);
  return launch_combine(part_acc, part_stat, n_splits, B, H, out, stream);
}

}  // namespace

extern "C" {

// Rows per tile of the instance: 0 = float32, 1 = bfloat16.
int toad_pool_rows_per_tile(int dtype) { return dtype == 1 ? Cfg<bf16>::R : Cfg<float>::R; }

// Dynamic shared memory of the pooling kernel in bytes.
long long toad_pool_smem_bytes(int dtype, int H, int A) {
  return (long long)(dtype == 1 ? layout<bf16>(H, A).total : layout<float>(H, A).total);
}

// Launches the pooling and combine kernels on `stream`; returns the
// cudaError_t of the launches (0 on success). Does not synchronise.
int toad_pool_forward(int dtype, const void* x, const float* mask, int B, int N, int D, int H, int A,
                      const void* w1t, const float* b1, const void* w2t, const float* b2,
                      const void* wabt, const float* bab, const void* wc, const float* bc,
                      int tiles_per_split, int n_splits,
                      float* scores, float* part_acc, float* part_stat, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<bf16>(x, mask, B, N, D, H, A, w1t, b1, w2t, b2, wabt, bab, wc, bc,
                        tiles_per_split, n_splits, scores, part_acc, part_stat, out, nullptr, s);
  return launch<float>(x, mask, B, N, D, H, A, w1t, b1, w2t, b2, wabt, bab, wc, bc,
                       tiles_per_split, n_splits, scores, part_acc, part_stat, out, nullptr, s);
}

// The pooling kernel in partial mode (classification only, no scores): writes
// acc [B][2][H] = sum over the live rows of exp(s - max) h and stats [B][2][2]
// = (max[2], denom[2]) instead of the pooled mean; max = -1e30, denom = 0 and
// acc = 0 where no row is live. Replaces the TPU kernel's partial form
// (toad_tpu/ops/pallas_pool.py::pallas_pool_partial).
int toad_pool_partial_forward(int dtype, const void* x, const float* mask, int B, int N, int D, int H, int A,
                              const void* w1t, const float* b1, const void* w2t, const float* b2,
                              const void* wabt, const float* bab, const void* wc, const float* bc,
                              int tiles_per_split, int n_splits,
                              float* part_acc, float* part_stat, float* acc, float* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch<bf16>(x, mask, B, N, D, H, A, w1t, b1, w2t, b2, wabt, bab, wc, bc,
                        tiles_per_split, n_splits, nullptr, part_acc, part_stat, acc, stats, s);
  return launch<float>(x, mask, B, N, D, H, A, w1t, b1, w2t, b2, wabt, bab, wc, bc,
                       tiles_per_split, n_splits, nullptr, part_acc, part_stat, acc, stats, s);
}

// Combines the partials of S shards of B bags, acc [S][B][2][H] and stats
// [S][B][2][2] as toad_pool_partial_forward writes them, into the pooled
// out [B][2][H] = sum_s acc_s w_s / max(sum_s denom_s w_s, 1e-12): the
// cross-shard combine of toad_tpu/parallel/bag_shard.py::combine_partial_pool.
int toad_pool_combine_shards(const float* acc, const float* stats, int S, int B, int H, float* out, void* stream) {
  return launch_combine_strided<2, true>(acc, stats, S, 1, B, B, H, 1e-12f, 0.f, out, nullptr,
                                      static_cast<cudaStream_t>(stream));
}

const char* toad_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
