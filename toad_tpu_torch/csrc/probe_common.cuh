// Pieces shared by the pooling-probe kernels csrc/pool_probe.cu (P1/P2/P5,
// the bf16 ablation ladder on the 128-row mma.sync pass K1 bf16 ran before
// its wgmma GEMMs) and
// csrc/pool_int8_probe.cu (P3/P4, the int8 chain variants on the 64-row
// mma.sync pass K2 ran before its wgmma GEMMs): the probes' epilogue at T_PAD = 8 task columns, templated on the
// rows R of a tile. Per tile (one bag's R rows, or R / 2 rows of each of two
// bags):
//   - probe_stats: the per-(bag, task) online masked softmax of the raw
//     scores s_s [R][8] (max, denominator, the rescale of the running sums),
//     or the plain running sum of min(s, 1) of the `nosoftmax` variant, and
//     e rounded to bf16 into e_s [R][8]; rows at or past the bag's end N are
//     not live, whatever the mask;
//   - probe_fold: a[t][c] = a * corr + sum_r e[r][t] h[r][c] over one bag
//     slot's rows: thread i owns the columns 2i, 2i + 1 of every task (H =
//     512 = 2 x 256 threads), reading h as bf16 pairs and e as broadcast rows.
// Both kernels keep the running sums a[8][H] in the CTA's own slot of
// part_acc (device memory), which they read into registers for probe_fold
// and write back a tile, and which pool_combine_kernel<8> (pool_common.cuh)
// then merges. Everything sits in an anonymous namespace, as in
// pool_common.cuh.

#pragma once

#include "pool_trunk.cuh"

namespace {

constexpr int kTasks = 8;        // the probes' T_PAD
constexpr int kStatStride = 3 * kTasks;  // per bag: max[8], denom[8], corr[8]

enum ProbeMode { kModeSoftmax = 0, kModeSum = 1, kModeTrunk = 2 };

// Initial per-bag statistics: max = -1e30 for the softmax (0 for the plain
// sums, so that the combine weights every partial by exp(0) = 1), denom 0.
template <int NB, int kMode>
__device__ __forceinline__ void probe_stats_init(float* stat) {
  for (int i = threadIdx.x; i < NB * kStatStride; i += kThreads) {
    const int k = i % kStatStride;
    stat[i] = k < kTasks ? (kMode == kModeSoftmax ? kNegInf : 0.f) : (k < 2 * kTasks ? 0.f : 1.f);
  }
}

// Warp w takes the (bag slot, task) pairs w, w + 8, ...: the rows of slot
// are slot * RB .. slot * RB + RB - 1 of the tile (RB = R / NB), rows row0..
// of its bag, whose mask starts at mask0 + slot * N. A row is live where it
// lies inside the bag (row0 + rr < N) and its mask is positive.
template <int R, int NB, int kMode>
__device__ __forceinline__ void probe_stats(const float* s_s, const float* mask0, int N, int row0, float* e_s,
                                            float* stat) {
  constexpr int RB = R / NB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < NB * kTasks; c += kThreads / 32) {
    const int slot = c / kTasks, t = c % kTasks;
    float* st = stat + slot * kStatStride;
    const float* m = mask0 + (size_t)slot * N + row0;
    const int n = min(RB, N - row0);
    if (kMode == kModeSoftmax) {
      float mx = kNegInf;
      for (int rr = lane; rr < n; rr += 32)
        if (m[rr] > 0.f) mx = fmaxf(mx, s_s[(slot * RB + rr) * kTasks + t]);
      mx = warp_max(mx);
      const float m_prev = st[t];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      float sum = 0.f;
      for (int rr = lane; rr < RB; rr += 32) {
        const int r = slot * RB + rr;
        const float e = rr < n && m[rr] > 0.f ? expf(s_s[r * kTasks + t] - m_safe) : 0.f;
        sum += e;
        e_s[r * kTasks + t] = bf16_round(e);
      }
      sum = warp_sum(sum);
      const float corr = expf((m_prev <= kNegInf / 2 ? kNegInf : m_prev) - m_safe);
      if (lane == 0) {
        st[t] = m_new;
        st[kTasks + t] = st[kTasks + t] * corr + sum;
        st[2 * kTasks + t] = corr;
      }
    } else {  // kModeSum: e = min(s, 1) on live rows, denom the unrounded sum of e
      float sum = 0.f;
      for (int rr = lane; rr < RB; rr += 32) {
        const int r = slot * RB + rr;
        const float e = rr < n && m[rr] > 0.f ? fminf(s_s[r * kTasks + t], 1.f) : 0.f;
        sum += e;
        e_s[r * kTasks + t] = bf16_round(e);
      }
      sum = warp_sum(sum);
      if (lane == 0) st[kTasks + t] += sum;
    }
  }
}

// a[t][k] for column 2 * tid + k over the first n rows of bag slot `slot`
// (RB = R / NB rows a slot); kTrunk: e = 1 on each of those rows (the
// `trunkonly` variant's 1^T h, mask ignored), one task kept in a[0].
template <int R, int NB, bool kTrunk>
__device__ __forceinline__ void probe_fold(float (&a)[kTasks][2], int slot, int n, const float* e_s,
                                           const float* stat, const bf16* h, int ldh) {
  constexpr int RB = R / NB;
  const int c0 = 2 * threadIdx.x;
  if (!kTrunk) {
#pragma unroll
    for (int t = 0; t < kTasks; ++t) {
      const float corr = stat[slot * kStatStride + 2 * kTasks + t];
      a[t][0] *= corr;
      a[t][1] *= corr;
    }
  }
  for (int rr = 0; rr < n; ++rr) {
    const int r = slot * RB + rr;
    const float2 hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h + r * ldh + c0));
    if (kTrunk) {
      a[0][0] += hv.x;
      a[0][1] += hv.y;
    } else {
      float e[kTasks];
      load_row<kTasks>(e_s + r * kTasks, e);
#pragma unroll
      for (int t = 0; t < kTasks; ++t) {
        a[t][0] = fmaf(e[t], hv.x, a[t][0]);
        a[t][1] = fmaf(e[t], hv.y, a[t][1]);
      }
    }
  }
}

}  // namespace
