// Pieces shared by the kernels: staging and mma.sync fragment helpers (also
// used by csrc/mha.cu, K3, and csrc/stage.cu, KS), and for the fused pooling
// kernels csrc/pool.cu (K1, bf16/f32) and csrc/pool_int8.cu (K2, int8) the
// per-tile online masked-softmax update, and for those and the pooling
// probes the exact combine of the split-N partials (their trunk is in
// pool_trunk.cuh). Everything sits in an anonymous namespace, so each
// translation unit that includes this header gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps (K1's bf16 instance derives its own from its warp tile)
constexpr float kNegInf = -1e30f;

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// 16-byte cp.async copy; src_bytes < 16 zero-fills the rest (0: all zeros)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// four 8x8 b16 matrices (8 rows of 16 bytes each) from shared memory; lane
// l gives the row address of matrix l / 8, row l % 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// the same four matrices, each transposed on the way: a [k][n] row-major
// tile in shared memory gives the col-major B fragments of mma.sync
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Online masked softmax over one tile of R rows, the TPU kernels'
// _online_update. stat holds max[2], denom[2], corr[2].

// Warp t (t < 2) updates task t's running max and denominator from the raw
// scores s_s [R][2] of the tile's live rows, and writes e = exp(s - max)
// rounded to E (the TPU kernel's rounding point before e^T h) into e_s.
template <int R, typename E>
__device__ __forceinline__ void online_stats(const float* s_s, const float* mb, int row0, int N,
                                             float* e_s, float* stat) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= 2) return;
  const int t = warp;
  float mx = kNegInf;
  for (int r = lane; r < R; r += 32) {
    if (row0 + r < N && mb[row0 + r] > 0.f) mx = fmaxf(mx, s_s[2 * r + t]);
  }
  mx = warp_max(mx);
  const float m_prev = stat[t];
  const float m_new = fmaxf(m_prev, mx);
  const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
  float sum = 0.f;
  for (int r = lane; r < R; r += 32) {
    float e = 0.f;
    if (row0 + r < N && mb[row0 + r] > 0.f) e = expf(s_s[2 * r + t] - m_safe);
    sum += e;
    e_s[2 * r + t] = to_f(from_f<E>(e));
  }
  sum = warp_sum(sum);
  const float corr = expf((m_prev <= kNegInf / 2 ? kNegInf : m_prev) - m_safe);
  if (lane == 0) {
    stat[t] = m_new;
    stat[2 + t] = stat[2 + t] * corr + sum;
    stat[4 + t] = corr;
  }
}

// acc[2][H] = acc * corr + e^T h over the tile's R rows of h [R][ldh], by a
// block of NT threads
template <int R, typename T, int NT = kThreads>
__device__ __forceinline__ void online_accumulate(float* acc_s, const float* e_s, const float* stat,
                                                  const T* h, int ldh, int H) {
  for (int i = threadIdx.x; i < 2 * H; i += NT) {
    const int t = i >= H, c = i - t * H;
    float a = acc_s[i] * stat[4 + t];
    for (int r = 0; r < R; ++r) a = fmaf(e_s[2 * r + t], to_f(h[r * ldh + c]), a);
    acc_s[i] = a;
  }
}

// ---------------------------------------------------------------------------
// Exact flash combine of one bag's partials (acc [T][H], max[T], denom[T]) of
// T task columns (2 for K1, K1p and K2; 8 for the probes). Partial s of bag b
// sits at index b * stride_b + s * stride_s of part_acc (x T*H floats) and
// part_stat (x 2T floats), which covers both users:
//   - the split-N partials of one launch, [B][n_splits]: stride_b = n_splits,
//     stride_s = 1;
//   - the shard partials of a bag-sharded pool, [S][B]: stride_b = 1,
//     stride_s = B (the TPU version's pmax / psum over the bag axis).
// With gmax the largest max (0 where every partial is masked) and
// w_s = exp(max_s - gmax) (0 for a masked partial; 1 for the probes' plain
// sums, whose max is 0):
//   kDivide:  out = sum_s acc_s w_s / den, den = divisor where divisor > 0
//             (the probes' trunkonly: its count of row tiles), else
//             max(sum_s denom_s w_s, eps);
//   !kDivide: out = sum_s acc_s w_s and stat_out[b] = (max[T], denom[T]) =
//             (largest max, sum_s denom_s w_s): one unnormalised partial,
//             itself an input of a later combine. A bag without live rows
//             gives max = kNegInf, denom = 0, acc = 0.
// Block (c, b) finishes the 32 outputs c*32.. of bag b's [T][H]; its warps
// split the partials between them, so that a bag with many splits (one large
// bag spread over the card) is combined by many SMs.
constexpr int kCombineCols = 32;

template <int T, bool kDivide>
__global__ void __launch_bounds__(kThreads)
pool_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_stat,
                    int n_parts, int stride_b, int stride_s, int H, float eps, float divisor,
                    float* __restrict__ out, float* __restrict__ stat_out) {
  extern __shared__ float w_s[];  // [n_parts] rescale weights of this block's task
  __shared__ float red[kThreads / 32][kCombineCols];
  __shared__ float denom_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, i0 = blockIdx.x * kCombineCols;
  const int t = i0 / H;  // H % kCombineCols == 0: one task per block
  const size_t p0 = (size_t)b * stride_b;
  if (warp == 0) {
    float mx = kNegInf;
    for (int s = lane; s < n_parts; s += 32) mx = fmaxf(mx, part_stat[(p0 + (size_t)s * stride_s) * 2 * T + t]);
    mx = warp_max(mx);
    const float m_safe = mx <= kNegInf / 2 ? 0.f : mx;
    float den = 0.f;
    for (int s = lane; s < n_parts; s += 32) {
      const float* st = part_stat + (p0 + (size_t)s * stride_s) * 2 * T;
      const float m = st[t];
      const float w = expf((m <= kNegInf / 2 ? kNegInf : m) - m_safe);
      w_s[s] = w;
      den = fmaf(st[T + t], w, den);
    }
    den = warp_sum(den);
    if (lane == 0) {
      denom_s = kDivide ? (divisor > 0.f ? divisor : fmaxf(den, eps)) : 1.f;
      if (!kDivide && i0 == t * H) {  // the first block of each task writes its statistics
        stat_out[(size_t)b * 2 * T + t] = mx;
        stat_out[(size_t)b * 2 * T + T + t] = den;
      }
    }
  }
  __syncthreads();
  float a = 0.f;
  for (int s = warp; s < n_parts; s += kThreads / 32)
    a = fmaf(part_acc[(p0 + (size_t)s * stride_s) * T * H + i0 + lane], w_s[s], a);
  red[warp][lane] = a;
  __syncthreads();
  if (warp == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += red[w][lane];
    out[(size_t)b * T * H + i0 + lane] = kDivide ? sum / denom_s : sum;
  }
}

// Launches the combine of B bags' partials into out [B][T][H] (and, without
// the division, stat_out [B][2][T]); returns the launch's cudaError_t.
template <int T, bool kDivide>
inline int launch_combine_strided(const float* part_acc, const float* part_stat, int n_parts, int stride_b,
                                  int stride_s, int B, int H, float eps, float divisor, float* out,
                                  float* stat_out, cudaStream_t stream) {
  pool_combine_kernel<T, kDivide><<<dim3(T * H / kCombineCols, B), kThreads, sizeof(float) * n_parts, stream>>>(
      part_acc, part_stat, n_parts, stride_b, stride_s, H, eps, divisor, out, stat_out);
  return (int)cudaGetLastError();
}

// The combine that ends a split-N pooling launch of T task columns:
// acc / max(denom, 1e-30), or acc / divisor where divisor > 0.
template <int T = 2>
inline int launch_combine(const float* part_acc, const float* part_stat, int n_splits, int B, int H,
                          float* out, cudaStream_t stream, float divisor = 0.f) {
  return launch_combine_strided<T, true>(part_acc, part_stat, n_splits, n_splits, 1, B, H, 1e-30f, divisor, out,
                                         nullptr, stream);
}

}  // namespace
