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
// bf16 input, ~1,150 FLOP/byte, far above the card's ~295, so the bound is
// the tensor cores, not HBM. The 2.3 MB (bf16) of weights do not fit in
// shared memory (the TPU kernel keeps them all in VMEM), so each GEMM streams
// 256-column x 32-deep weight slices from L2 through a cp.async ring while
// the tile's activations stay in shared memory: every row tile costs one pass
// over all of the weights. With 64-row tiles (the first kernel) that was 9.66
// GB from L2 at B=32 x 8,192, and each slice fed 64 x 256 x 32 products
// between two barriers (14 % of the bound, PERF.md §6).
//
// The bf16 instance runs 128-row tiles, one CTA an SM, 8 warps of 64 x 64
// warp tiles (16 warps of 32 x 64 were 2-4 % slower): each staged slice feeds
// twice the rows, which halves the weight stream and doubles the products
// under each barrier. Shared memory limits the tile, since h1 and h2 of 128
// rows take 130 KB each, so they share one region:
//   - GEMM1 writes h1 there;
//   - GEMM2's first 256-column pass keeps its output as packed bf16 (the
//     stash: half in registers, half in the x ring, idle in GEMM2) while the
//     second pass still reads h1; both halves of h2 go over the dead h1 after
//     a barrier;
//   - the gate pass never writes `gated`: its epilogue rounds each value to
//     bf16 and folds it into per-row partial scores against Wc, summed over
//     the quad and then over the column warps in the x ring.
// Each h1, h2 and gated value is the same sequence of k16 products as in the
// 64-row kernel, so they keep its bits; the f32 summation order of the scores
// and the rows grouped into one online-softmax update move. The plan (rows,
// threads, ring slots, shared memory) is ops/cuda_pool.plan; the bf16
// instance takes H = 256 or 512. What bounds it now (PERF.md §6, PR 14):
// neither the L2 stream nor the products alone. A build without the copies
// keeps 72 % of the time, one without the products and ldmatrix 66 %, one
// without ldmatrix 97 %; a 2-slot ring, 16 warps or a ring run on across the
// passes change it by a few %. mma.sync behind a barrier every 32-deep slice
// (about 32 % of the bf16 peak alone) and the L2 stream overlap only in part:
// wgmma and one L2 read for several CTAs (TMA multicast) are what is left.
//
// The TPU's sequential grid (state carried across a bag's tiles) becomes a
// split-N grid: block (split, bag) runs a contiguous range of row tiles and
// writes a partial (acc, max, denom); pool_combine_kernel merges the partials
// exactly (and, in partial mode, leaves the division to the cross-shard
// combine), spread over 2H/32 blocks per bag so that one large bag combines
// in parallel. The bf16 grid fills whole waves of one CTA an SM
// (cuda_pool.wave_split_plan). The f32 instance keeps the first design:
// 32-row tiles, 8 warps, FMA so that f32 stays f32 (no TF32), staged
// synchronously. No wgmma, TMA or warp specialisation.
//
// Layout contract (the Python wrapper ops/cuda_pool.py prepares it):
//   x [B, N, D] and weights in the compute dtype T, weights in nn.Linear
//   layout [out, in]; the 2A rows of [Wa|Wb]^T are interleaved in groups of
//   32 (u rows g*32.., then v rows g*32..) so that a thread holds u_j and v_j
//   of the same j; biases, mask and all outputs are f32.

#include "pool_trunk.cuh"

namespace {

constexpr int kHPad = 8;       // row padding of the activation buffers

// Rows per tile, staging stride (elements) and staging depth of the f32
// instance: rows padded by one word (conflict-free column reads), staged
// synchronously through one buffer. The bf16 instance's are below.
template <typename T> struct Cfg;
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
// Staging of one K-slice of the f32 instance into shared memory.

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

// ---------------------------------------------------------------------------
// The bf16 instance: 128-row tiles, one CTA an SM, warps arranged as
// 128 / (16 kMi) (rows) x 4 (columns). Warp (wr, wc) owns rows wr*16*kMi +
// mi*16 + {g, g+8} (mi < kMi) and columns wc*64 + ni*8 + 2q (+1) of each
// 256-column pass (g = lane / 4, q = lane % 4), the accumulator layout of
// mma.m16n8k16.

constexpr int kRowsBf16 = 128;  // rows a tile
constexpr int kMi = 4;          // m16 tiles a warp: 64 x 64 warp tiles, 8 warps (kMi = 2: 16 warps)
constexpr int kThreadsBf16 = 32 * kColWarps * kRowsBf16 / (16 * kMi);
constexpr int kSlotsBf16 = 3;   // slots of the cp.async ring: two slices in flight
// GEMM2's first pass waits for the second in its stash, 16 kMi packed
// registers a thread; the first half of the warp's row blocks waits in the x
// ring instead (idle in GEMM2), so that the second pass keeps its registers.
constexpr int kStashSmem = 8 * kMi;

// One region h [128][H + kHPad] holds h1, then h2; the weight ring ws
// [slots][256][kSBf16] and the x ring xs [slots][128][kSBf16], which after
// GEMM1 (until the next tile's) holds half of GEMM2's stash [kStashSmem]
// [threads], then the score scratch: the column warps' partial scores
// [4][128][2], s [128][2] and e [128][2]; the running acc [2][H] and stat
// (max[2], denom[2], corr[2]). Wc is read from device memory (3 KB, cached).
struct LayoutBf16 {
  size_t h, ws, xs, acc, stat, total;
};

__host__ __device__ inline LayoutBf16 layout_bf16(int H) {
  LayoutBf16 L;
  size_t o = 0;
  L.h = o;    o = align16(o + sizeof(bf16) * kRowsBf16 * (H + kHPad));
  L.ws = o;   o = align16(o + sizeof(bf16) * kSlotsBf16 * kBN * kSBf16);
  const size_t ring = sizeof(bf16) * kSlotsBf16 * kRowsBf16 * kSBf16;
  const size_t stash = sizeof(uint32_t) * kStashSmem * kThreadsBf16;
  L.xs = o;   o = align16(o + (ring > stash ? ring : stash));
  L.acc = o;  o = align16(o + sizeof(float) * 2 * H);
  L.stat = o; o = align16(o + sizeof(float) * 8);
  L.total = o;
  return L;
}

// ws[n][k] <- wt[n0 + n][k0 + k] (n < 256, k < 32) and (kFromX) xs[r][k] <-
// x[row0 + r][k0 + k] (r < 128), rows past the bag's end N zero-filled, in
// 16-byte copies; commits one group.
template <bool kFromX>
__device__ __forceinline__ void stage_slice(const bf16* __restrict__ wt, int K, int n0, int k0, bf16* ws,
                                            const bf16* __restrict__ x, int N, int D, int row0, bf16* xs) {
  constexpr int kChunks = kBK / 8;
#pragma unroll
  for (int j = 0; j < kBN * kChunks / kThreadsBf16; ++j) {
    const int i = threadIdx.x + j * kThreadsBf16;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    cp_async16(ws + r * kSBf16 + c, wt + (size_t)(n0 + r) * K + k0 + c, 16);
  }
  if (kFromX) {
#pragma unroll
    for (int j = 0; j < kRowsBf16 * kChunks / kThreadsBf16; ++j) {
      const int i = threadIdx.x + j * kThreadsBf16;
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = row0 + r < N;
      cp_async16(xs + r * kSBf16 + c, ok ? x + (size_t)(row0 + r) * D + k0 + c : x, ok ? 16 : 0);
    }
  }
  cp_async_commit();
}

// acc = A[128, K] . Wt[n0 : n0 + 256, K]^T, A the staged x tile (kFromX) or
// h [128][ldh]. A fragments come from ldmatrix on the row-major A tile, B
// fragments from ldmatrix on the staged [n][k] slice (two n-tiles an x4).
// Each output is the same sequence of k16 products (k ascending) as in the
// 64-row pass gemm_pass_bf16, so it has the same bits.
template <bool kFromX>
__device__ __forceinline__ void gemm_rows128(float (&acc)[kMi][8][4], const bf16* __restrict__ wt, int K, int n0,
                                             const bf16* h, int ldh, const bf16* __restrict__ x, int N, int D,
                                             int row0, bf16* ws, bf16* xs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  const int n_steps = K / kBK;
  auto issue = [&](int step) {
    if (step < n_steps) {
      const int slot = step % kSlotsBf16;
      stage_slice<kFromX>(wt, K, n0, step * kBK, ws + slot * kBN * kSBf16, x, N, D, row0,
                          xs + slot * kRowsBf16 * kSBf16);
    } else {
      cp_async_commit();  // empty group: keeps one group per step for the wait count
    }
  };
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // the ring is free, and the previous epilogue's writes to h are visible,
  // once every warp has arrived here
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSlotsBf16 - 1; ++s) issue(s);
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kSlotsBf16 - 2>();  // this thread's copies of `step` have landed
    __syncthreads();                  // everyone's have, and slot (step - 1) is free
    issue(step + kSlotsBf16 - 1);
    const int slot = step % kSlotsBf16;
    const bf16* a_base = kFromX ? xs + slot * kRowsBf16 * kSBf16 : h + step * kBK;
    const int la = kFromX ? kSBf16 : ldh;
    const bf16* w_base = ws + slot * kBN * kSBf16;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[kMi][4];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
        ldsm_x4(af[mi], a_base + (wr * 16 * kMi + mi * 16 + (lane & 15)) * la + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];  // b0, b1 of n-tile 2np, then of n-tile 2np + 1
        ldsm_x4(bf, w_base + (wc * 64 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * kSBf16 + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < kMi; ++mi) {
          mma_bf16(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
}

// The ReLU epilogue of columns n0..n0+255: packed bf16(relu(acc + bias)),
// out[mi][ni][hf] = the pair of row (mi, hf) in n-tile ni.
__device__ __forceinline__ void relu_pack(const float (&acc)[kMi][8][4], const float* __restrict__ bias, int n0,
                                          uint32_t (&out)[kMi][8][2]) {
  const int lane = threadIdx.x & 31, wc = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = n0 + wc * 64 + ni * 8 + 2 * (lane & 3);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float v0 = fmaxf(acc[mi][ni][2 * hf] + __ldg(bias + col), 0.f);
        const float v1 = fmaxf(acc[mi][ni][2 * hf + 1] + __ldg(bias + col + 1), 0.f);
        const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
        out[mi][ni][hf] = *reinterpret_cast<const uint32_t*>(&p);
      }
    }
}

// h[row][n0 + col] <- the packed pairs of relu_pack
__device__ __forceinline__ void store_packed(const uint32_t (&v)[kMi][8][2], int n0, bf16* h, int ldh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = wr * 16 * kMi + mi * 16 + (lane >> 2) + hf * 8;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
        *reinterpret_cast<uint32_t*>(h + row * ldh + n0 + wc * 64 + ni * 8 + 2 * (lane & 3)) = v[mi][ni][hf];
    }
}

// The gate epilogue of interleaved [Wa|Wb] columns n0..n0+255: warp column wc
// holds u_j in n-tiles 0-3 and v_j (32 columns further) in n-tiles 4-7 for
// j = n0/2 + wc*32 + ni*8 + 2q (+1). gated_j = bf16(tanh(u_j) sigmoid(v_j))
// (the TPU kernel's rounding point) is folded into the thread's partial
// scores sacc[mi][hf][t] += gated_j Wc[j][t]; it never reaches shared memory.
__device__ __forceinline__ void gate_fold(const float (&acc)[kMi][8][4], const float* __restrict__ bias,
                                          const bf16* __restrict__ wc_g, int n0, float (&sacc)[kMi][2][2]) {
  const int lane = threadIdx.x & 31, wc = (threadIdx.x >> 5) & 3;
  float2 w[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = n0 / 2 + wc * 32 + ni * 8 + 2 * (lane & 3) + e;
      const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(wc_g) + j);  // Wc[j][0], Wc[j][1]
      w[ni][e] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
    }
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cu = n0 + wc * 64 + ni * 8 + 2 * (lane & 3) + e;  // u column; v is 32 further
          const float gv = bf16_round(gate<kEpiTanh>(acc[mi][ni][2 * hf + e] + __ldg(bias + cu),
                                                     acc[mi][ni + 4][2 * hf + e] + __ldg(bias + cu + 32)));
          sacc[mi][hf][0] = fmaf(gv, w[ni][e].x, sacc[mi][hf][0]);
          sacc[mi][hf][1] = fmaf(gv, w[ni][e].y, sacc[mi][hf][1]);
        }
}

__global__ void __launch_bounds__(kThreadsBf16, 1)
pool_kernel_bf16(const bf16* __restrict__ x, const float* __restrict__ mask, int N, int D, int H, int A,
                 const bf16* __restrict__ w1t, const float* __restrict__ b1,
                 const bf16* __restrict__ w2t, const float* __restrict__ b2,
                 const bf16* __restrict__ wabt, const float* __restrict__ bab,
                 const bf16* __restrict__ wc, const float* __restrict__ bc,
                 int tiles_per_split, int n_splits,
                 float* __restrict__ scores, float* __restrict__ part_acc, float* __restrict__ part_stat) {
  constexpr int R = kRowsBf16;
  extern __shared__ __align__(16) unsigned char smem[];
  const LayoutBf16 L = layout_bf16(H);
  bf16* h = reinterpret_cast<bf16*>(smem + L.h);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  float* spart = reinterpret_cast<float*>(smem + L.xs);  // [4][R][2] partial scores of the column warps
  float* s_s = spart + kColWarps * R * 2;                  // [R][2] raw scores
  float* e_s = s_s + R * 2;                                // [R][2] e rounded to bf16
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);   // [2][H]
  float* stat = reinterpret_cast<float*>(smem + L.stat);   // max[2], denom[2], corr[2]

  const int tid = threadIdx.x;
  const int split = blockIdx.x, b = blockIdx.y;
  const int ldh = H + kHPad;
  const bf16* xb = x + (size_t)b * N * D;
  const float* mb = mask + (size_t)b * N;

  for (int i = tid; i < 2 * H; i += kThreadsBf16) acc_s[i] = 0.f;
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

    float acc[kMi][8][4];
    uint32_t packed[kMi][8][2];
    // h1 = relu(x W1 + b1) -> h
    for (int n0 = 0; n0 < H; n0 += kBN) {
      gemm_rows128<true>(acc, w1t, D, n0, nullptr, 0, xb, N, D, row0, ws, xs);
      relu_pack(acc, b1, n0, packed);
      store_packed(packed, n0, h, ldh);
    }
    // h2 = relu(h1 W2 + b2) -> h, over h1 once every warp has read all of it:
    // at H = 512 the first pass's columns wait (the stash), the second row
    // block's in registers, the first's in the x ring
    constexpr int kHalf = kMi / 2;
    uint32_t stash[kHalf][8][2];
    uint32_t* stash_s = reinterpret_cast<uint32_t*>(xs);  // [kStashSmem][threads]
    if (H == 2 * kBN) {
      gemm_rows128<false>(acc, w2t, H, 0, h, ldh, nullptr, N, D, row0, ws, xs);
      relu_pack(acc, b2, 0, packed);
#pragma unroll
      for (int mi = 0; mi < kHalf; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            stash_s[((mi * 8 + ni) * 2 + hf) * kThreadsBf16 + tid] = packed[mi][ni][hf];
            stash[mi][ni][hf] = packed[kHalf + mi][ni][hf];
          }
    }
    gemm_rows128<false>(acc, w2t, H, H - kBN, h, ldh, nullptr, N, D, row0, ws, xs);
    relu_pack(acc, b2, H - kBN, packed);
    __syncthreads();
    if (H == 2 * kBN) {
      uint32_t first[kMi][8][2];
#pragma unroll
      for (int mi = 0; mi < kHalf; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            first[mi][ni][hf] = stash_s[((mi * 8 + ni) * 2 + hf) * kThreadsBf16 + tid];
            first[kHalf + mi][ni][hf] = stash[mi][ni][hf];
          }
      store_packed(first, 0, h, ldh);
    }
    store_packed(packed, H - kBN, h, ldh);
    // gated = bf16(tanh(h2 Wa + ba) * sigmoid(h2 Wb + bb)), folded into the scores
    float sacc[kMi][2][2] = {};
    for (int n0 = 0; n0 < 2 * A; n0 += kBN) {
      gemm_rows128<false>(acc, wabt, H, n0, h, ldh, nullptr, N, D, row0, ws, xs);
      gate_fold(acc, bab, wc, n0, sacc);
    }
    // s = gated Wc + bc: the quad, then the four column warps (the x ring is
    // idle until the next tile's GEMM1, past two barriers)
    reduce_scores<2, R, kThreadsBf16, kMi>(sacc, spart, bc, s_s, scores, b, N, row0);

    online_stats<R, bf16>(s_s, mb, row0, N, e_s, stat);
    __syncthreads();
    online_accumulate<R, bf16, kThreadsBf16>(acc_s, e_s, stat, h, ldh, H);
  }
  __syncthreads();

  const size_t p = (size_t)b * n_splits + split;
  for (int i = tid; i < 2 * H; i += kThreadsBf16) part_acc[p * 2 * H + i] = acc_s[i];
  if (tid < 4) part_stat[p * 4 + tid] = stat[tid];
}

template <typename T>
int launch(const void* x, const float* mask, int B, int N, int D, int H, int A,
           const void* w1t, const float* b1, const void* w2t, const float* b2,
           const void* wabt, const float* bab, const void* wc, const float* bc,
           int tiles_per_split, int n_splits,
           float* scores, float* part_acc, float* part_stat, float* out, float* stat_out, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    if (H != kBN && H != 2 * kBN) return (int)cudaErrorInvalidValue;  // the plan's BF16_WIDTHS
    const size_t smem = layout_bf16(H).total;
    err = cudaFuncSetAttribute(pool_kernel_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    pool_kernel_bf16<<<dim3(n_splits, B), kThreadsBf16, smem, stream>>>(
        static_cast<const bf16*>(x), mask, N, D, H, A,
        static_cast<const bf16*>(w1t), b1, static_cast<const bf16*>(w2t), b2,
        static_cast<const bf16*>(wabt), bab, static_cast<const bf16*>(wc), bc,
        tiles_per_split, n_splits, scores, part_acc, part_stat);
  } else {
    const size_t smem = layout<T>(H, A).total;
    err = cudaFuncSetAttribute(pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    pool_kernel<T><<<dim3(n_splits, B), kThreads, smem, stream>>>(
        static_cast<const T*>(x), mask, N, D, H, A,
        static_cast<const T*>(w1t), b1, static_cast<const T*>(w2t), b2,
        static_cast<const T*>(wabt), bab, static_cast<const T*>(wc), bc,
        tiles_per_split, n_splits, scores, part_acc, part_stat);
  }
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
int toad_pool_rows_per_tile(int dtype) { return dtype == 1 ? kRowsBf16 : Cfg<float>::R; }

// Dynamic shared memory of the pooling kernel in bytes.
long long toad_pool_smem_bytes(int dtype, int H, int A) {
  return (long long)(dtype == 1 ? layout_bf16(H).total : layout<float>(H, A).total);
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
