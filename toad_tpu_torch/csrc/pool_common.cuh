// Pieces shared by the kernels: staging and mma.sync fragment helpers (also
// used by csrc/mha.cu, K3, and csrc/stage.cu, KS), and for the fused pooling
// kernels csrc/pool.cu (K1, bf16/f32) and csrc/pool_int8.cu (K2, int8) the
// per-tile online masked-softmax update, and for those and the pooling
// probes the exact combine of the split-N partials: a kernel of its own
// after the probes, the tail of K1's and K2's own launch (their trunk is in
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

// acc[2][H] = acc * corr + e^T h over the tile's R rows of h [R][ldh]
template <int R, typename T>
__device__ __forceinline__ void online_accumulate(float* acc_s, const float* e_s, const float* stat,
                                                  const T* h, int ldh, int H) {
  for (int i = threadIdx.x; i < 2 * H; i += kThreads) {
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
// part_stat (x 2T floats), which covers both users of the kernel:
//   - the split-N partials of one launch of a probe, [B][n_splits]:
//     stride_b = n_splits, stride_s = 1;
//   - the shard partials of a bag-sharded pool over a mesh, [S][B]:
//     stride_b = 1, stride_s = B (the TPU version's pmax / psum over the bag
//     axis).
// K1, K1p and K2 merge their split partials at the end of their own launch
// (pool_tail below), in the same order of summation.
// With gmax the largest max (0 where every partial is masked) and
// w_s = exp(max_s - gmax) (0 for a masked partial; 1 for the probes' plain
// sums, whose max is 0): out = sum_s acc_s w_s / den, den = divisor where
// divisor > 0 (the probes' trunkonly: its count of row tiles), else
// max(sum_s denom_s w_s, eps). pool_tail's partial mode (K1p) leaves the
// division out: out = sum_s acc_s w_s and stat_out = (max[T], denom[T]) =
// (largest max, sum_s denom_s w_s), one unnormalised partial, itself an input
// of a later combine; a bag without live rows gives max = kNegInf, denom =
// 0, acc = 0.
// The order of summation, which both the combine kernel and pool_tail keep:
// lane l of one warp takes the statistics of partials l, l+32, ... (then a
// butterfly over the warp); for each output, warp w (of 8) sums acc_s w_s
// over s = w, w+8, ... in fmaf from 0, and the 8 warp sums are added in
// order from 0.
constexpr int kCombineCols = 32;
constexpr int kCombineWarps = 8;

template <bool kL2>
__device__ __forceinline__ float load_part(const float* p) { return kL2 ? __ldcg(p) : *p; }

// Task t's weights w_s[s] of n_parts partials (partial s's statistics at
// part_stat + (p0 + s * stride_s) * 2T), by one warp; returns (gmax, sum_s
// denom_s w_s). kL2 (pool_tail: partials other blocks of this launch wrote)
// reads past L1 and keeps the statistics of 8 partials a lane in flight at
// once; the sums keep their order either way.
template <int T, bool kL2>
__device__ __forceinline__ float2 combine_weights(const float* part_stat, int n_parts, size_t p0, int stride_s,
                                                  int t, float* w_s) {
  constexpr int kBatch = kL2 ? 8 : 1;
  const int lane = threadIdx.x & 31;
  float mx = kNegInf;
  for (int s0 = lane; s0 < n_parts; s0 += 32 * kBatch) {
    float m[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int s = s0 + 32 * i;
      m[i] = s < n_parts ? load_part<kL2>(part_stat + (p0 + (size_t)s * stride_s) * 2 * T + t) : kNegInf;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) mx = fmaxf(mx, m[i]);
  }
  mx = warp_max(mx);
  const float m_safe = mx <= kNegInf / 2 ? 0.f : mx;
  float den = 0.f;
  for (int s0 = lane; s0 < n_parts; s0 += 32 * kBatch) {
    float m[kBatch], d[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const float* st = part_stat + (p0 + (size_t)(s0 + 32 * i) * stride_s) * 2 * T;
      if (s0 + 32 * i < n_parts) {
        m[i] = load_part<kL2>(st + t);
        d[i] = load_part<kL2>(st + T + t);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (s0 + 32 * i < n_parts) {
        const float w = expf((m[i] <= kNegInf / 2 ? kNegInf : m[i]) - m_safe);
        w_s[s0 + 32 * i] = w;
        den = fmaf(d[i], w, den);
      }
    }
  }
  return make_float2(mx, warp_sum(den));
}

template <int T>
__global__ void __launch_bounds__(kThreads)
pool_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_stat,
                    int n_parts, int stride_b, int stride_s, int H, float eps, float divisor,
                    float* __restrict__ out) {
  static_assert(kThreads / 32 == kCombineWarps, "the order of summation is that of 8 warps");
  extern __shared__ float w_s[];  // [n_parts] rescale weights of this block's task
  __shared__ float red[kCombineWarps][kCombineCols];
  __shared__ float denom_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, i0 = blockIdx.x * kCombineCols;
  const int t = i0 / H;  // H % kCombineCols == 0: one task per block
  const size_t p0 = (size_t)b * stride_b;
  if (warp == 0) {
    const float2 md = combine_weights<T, false>(part_stat, n_parts, p0, stride_s, t, w_s);
    if (lane == 0) denom_s = divisor > 0.f ? divisor : fmaxf(md.y, eps);
  }
  __syncthreads();
  float a = 0.f;
  for (int s = warp; s < n_parts; s += kCombineWarps)
    a = fmaf(part_acc[(p0 + (size_t)s * stride_s) * T * H + i0 + lane], w_s[s], a);
  red[warp][lane] = a;
  __syncthreads();
  if (warp == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kCombineWarps; ++w) sum += red[w][lane];
    out[(size_t)b * T * H + i0 + lane] = sum / denom_s;
  }
}

// Launches the combine of B bags' partials into out [B][T][H]; returns the
// launch's cudaError_t.
template <int T>
inline int launch_combine_strided(const float* part_acc, const float* part_stat, int n_parts, int stride_b,
                                  int stride_s, int B, int H, float eps, float divisor, float* out,
                                  cudaStream_t stream) {
  pool_combine_kernel<T><<<dim3(T * H / kCombineCols, B), kThreads, sizeof(float) * n_parts, stream>>>(
      part_acc, part_stat, n_parts, stride_b, stride_s, H, eps, divisor, out);
  return (int)cudaGetLastError();
}

// The combine that ends a split-N pooling launch of T task columns (the
// probes): acc / max(denom, 1e-30), or acc / divisor where divisor > 0.
template <int T = 2>
inline int launch_combine(const float* part_acc, const float* part_stat, int n_splits, int B, int H,
                          float* out, cudaStream_t stream, float divisor = 0.f) {
  return launch_combine_strided<T>(part_acc, part_stat, n_splits, n_splits, 1, B, H, 1e-30f, divisor, out, stream);
}

// ---------------------------------------------------------------------------
// The merge at the end of a pooling launch (csrc/pool.cu: K1, K1p and the
// one-launch bag-sharded pool; csrc/pool_int8.cu: K2), in place of a combine
// launch of its own.
// Every block of a group (the blocks of one bag) writes its partial, then
// draws a ticket from the group's counter; the block that draws the last
// ticket merges the group's partials with the combine's arithmetic and order
// (above), so the output has the bits of the combine kernel's, and resets the
// counter to 0 for the next launch. The merge reads the partials past L1
// (other SMs wrote them), 4 outputs a thread in 16-byte loads: warp w reads
// whole partials s = w, w+8, ... (T*H <= 1,024 outputs: K1's 2 x 256 or
// 2 x 512), each lane up to 8 float4 of each, and sums them in registers;
// the scratch (at least tail_scratch_floats(T, n_parts) floats of shared
// memory, which the block no longer uses) holds the warps' sums and the
// weights. One CTA reads all of a bag's partials, at most ~50-90 GB/s: 6-11
// us for 64-128 partials of 4 KB on an H100 (PERF.md §6).
constexpr int kTailCols = kCombineWarps * 32 * 4;  // the outputs it takes: 8 float4 a lane

__host__ __device__ inline size_t tail_scratch_floats(int T, int n_parts) {
  return (size_t)kCombineWarps * kTailCols + 4 * T + (size_t)T * n_parts;
}

// Called by every thread of a block of kThreads (8 warps) after it wrote its
// partial at part_acc + p * T*H and part_stat + p * 2T; the group's n_parts
// partials are p0 .. p0 + n_parts - 1. divide: out = acc / max(denom, eps)
// [T][H]; else out = acc and stat_out = (max[T], denom[T]). H % 128 == 0 and
// T * H <= kTailCols.
template <int T>
__device__ __noinline__ void pool_tail(const float* part_acc, const float* part_stat, size_t p0, int n_parts,
                                       int* ticket, int H, bool divide, float eps, float* out, float* stat_out,
                                       float* scratch) {
  static_assert(kThreads / 32 == kCombineWarps, "the order of summation is that of 8 warps");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* red = scratch;                                   // [8][kTailCols] the warps' sums
  float* den = red + kCombineWarps * kTailCols;           // [T] divisors, then a flag
  int* last = reinterpret_cast<int*>(den + 2 * T);
  float* w_s = den + 4 * T;                               // [T][n_parts]
  __threadfence();  // this block's partial is visible device-wide before its ticket
  __syncthreads();
  if (tid == 0) *last = atomicAdd(ticket, 1) == n_parts - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();  // the other blocks' partials, seen through their tickets
  for (int t = warp; t < T; t += kCombineWarps) {
    const float2 md = combine_weights<T, true>(part_stat, n_parts, p0, 1, t, w_s + (size_t)t * n_parts);
    if (lane == 0) {
      den[t] = fmaxf(md.y, eps);
      if (!divide) {
        stat_out[t] = md.x;
        stat_out[T + t] = md.y;
      }
    }
  }
  __syncthreads();
  const int TH = T * H;
  float4 a[kCombineWarps];  // chunk j: outputs j * 128 + 4 lane .. + 3
  const float* wj[kCombineWarps];  // its task's weights
#pragma unroll
  for (int j = 0; j < kCombineWarps; ++j) {
    a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    wj[j] = w_s + (size_t)(min(j * 128, TH - 1) / H) * n_parts;
  }
#pragma unroll 2
  for (int s = warp; s < n_parts; s += kCombineWarps) {
    const float4* src = reinterpret_cast<const float4*>(part_acc + (p0 + s) * TH) + lane;
#pragma unroll
    for (int j = 0; j < kCombineWarps; ++j) {
      if (j * 128 < TH) {
        const float4 v = __ldcg(src + j * 32);
        const float wv = wj[j][s];
        a[j].x = fmaf(v.x, wv, a[j].x);
        a[j].y = fmaf(v.y, wv, a[j].y);
        a[j].z = fmaf(v.z, wv, a[j].z);
        a[j].w = fmaf(v.w, wv, a[j].w);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kCombineWarps; ++j) reinterpret_cast<float4*>(red + warp * kTailCols + j * 128)[lane] = a[j];
  __syncthreads();
  if (4 * tid < TH) {  // this thread's 4 outputs
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kCombineWarps; ++w) {
      const float4 r = reinterpret_cast<const float4*>(red + w * kTailCols)[tid];
      sum.x += r.x;
      sum.y += r.y;
      sum.z += r.z;
      sum.w += r.w;
    }
    if (divide) {
      const float d = den[4 * tid / H];
      sum = make_float4(sum.x / d, sum.y / d, sum.z / d, sum.w / d);
    }
    reinterpret_cast<float4*>(out)[tid] = sum;
  }
  if (tid == 0) *ticket = 0;
}

}  // namespace
