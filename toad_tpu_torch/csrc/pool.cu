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
// writes a partial (acc, max, denom), then draws a ticket of its bag; the
// block that draws a bag's last ticket merges the bag's partials exactly
// (pool_tail in pool_common.cuh: the combine kernel's arithmetic and order,
// so one launch gives the two-launch design's bits) and, in partial mode,
// leaves the division to the cross-shard combine. A bag may also be cut into
// S equal shards of N rows that one launch pools together (the one-card
// bag-sharded pool): block (shard * n_splits + split, bag) runs a range of
// its shard's tiles, masked by the shard's end, so that every partial is a
// shard-local flash statistic, and the tail merges all S * n_splits of them
// (cuda_pool.shard_split_plan). Rows are read through a bag stride, so a
// shard sliced out of a larger batch is read in place. Both instances hold an
// SM with one CTA, and their grids fill whole waves
// (cuda_pool.wave_split_plan). No wgmma, TMA or warp specialisation.
//
// The f32 instance (the default of serve, eval and the f32 trainer's
// passes) keeps f32 f32: Hopper has no f32 tensor-core product, and a single
// TF32 product is off by ~1e-3. Its f32 weights are 4.72 MB, twice bf16's,
// and h1 or h2 of 64 rows already take 132 KB, so it runs 64-row tiles, 8
// warps as 2 (rows) x 4 (columns), and each trunk GEMM as one pass over all
// H columns (32 x 128 warp tiles, 128 f32 sums a thread): the pass's output
// reaches shared memory only after its last slice, so h1 and h2 take turns
// in one region, and GEMM1's x slices ride in that region while it is dead.
// Weights come through a 2-slot cp.async ring of H-column x 16-deep slices.
// The gate runs in 256-column passes that fold gated values into per-row
// scores in registers, as the bf16 instance does. The products are
// error-compensated TF32 ("3xTF32"): each f32 operand splits in registers
// into big = x rounded to tf32 and small = x - big (exact in f32, read as
// tf32 by truncation), and each m16n8k8 step accumulates small.big +
// big.small + big.big in f32. The tensor cores
// truncate the sums they write, so each 16-deep slice sums into registers
// of its own that one f32 add folds into the running sum: a running sum
// that keeps its sign would gather the truncation's bias over all of K (10x
// f32 FMA's error on the card); so summed it is as accurate as f32 FMA
// (PERF.md §6). Against the first kernel's 32-row tiles this halves the
// weight stream from L2.
//
// Layout contract (the Python wrapper ops/cuda_pool.py prepares it):
//   x [B, N, D] with contiguous rows (bag b's rows at x + b * x_bag, x_bag
//   a multiple of 8 elements) and weights in the compute dtype T, mask rows
//   at mask + b * m_bag, weights in nn.Linear
//   layout [out, in]; the 2A rows of [Wa|Wb]^T are interleaved in groups of
//   32 (u rows g*32.., then v rows g*32..) so that a thread holds u_j and v_j
//   of the same j; biases, mask and all outputs are f32.

#include <atomic>

#include "pool_trunk.cuh"

namespace {

static_assert(kThreadsBf16 == kThreads, "both instances end in pool_tail's 8 warps");

std::atomic<long long> g_launches{0};  // kernel launches made by this file's entry points

// ---------------------------------------------------------------------------
// The f32 instance. Warp (wr, wc) owns rows wr*32 + mi*16 + {g, g+8} (mi < 2)
// and columns wc*8*NT + ni*8 + 2q (+1) (ni < NT) of a pass of 32*NT columns
// (g = lane / 4, q = lane % 4), the accumulator layout of mma.m16n8k8.

constexpr int kRowsF32 = 64;        // rows a tile
constexpr int kBKF32 = 16;          // reduction depth of a staged slice
constexpr int kSF32 = kBKF32 + 4;   // staged row stride (words): 16-byte copies, conflict-free fragment loads
constexpr int kHPadF32 = 4;         // row padding of the f32 region: H + 4 puts rows g on banks 4g
constexpr int kSlotsF32 = 2;        // slots of the cp.async ring: one slice in flight
constexpr int kGatePass = 256;      // interleaved [Wa|Wb] columns a gate pass
static_assert(kRowsF32 * kBKF32 / 4 == kThreads, "one 16-byte x copy a thread a slice");

// One region h [64][H + 4] holds GEMM1's x slices, then h1, then h2; the
// weight ring ws [2][H][20]; the column warps' partial scores [4][64][2], s
// [64][2] and e [64][2]; the running acc [2][H] and stat (max[2], denom[2],
// corr[2]). Wc is read from device memory.
struct LayoutF32 {
  size_t h, ws, spart, s, e, acc, stat, total;
};

__host__ __device__ inline LayoutF32 layout_f32(int H) {
  LayoutF32 L;
  size_t o = 0;
  L.h = o;     o = align16(o + sizeof(float) * kRowsF32 * (H + kHPadF32));
  L.ws = o;    o = align16(o + sizeof(float) * kSlotsF32 * H * kSF32);
  L.spart = o; o = align16(o + sizeof(float) * kColWarps * kRowsF32 * 2);
  L.s = o;     o = align16(o + sizeof(float) * kRowsF32 * 2);
  L.e = o;     o = align16(o + sizeof(float) * kRowsF32 * 2);
  L.acc = o;   o = align16(o + sizeof(float) * 2 * H);
  L.stat = o;  o = align16(o + sizeof(float) * 8);
  L.total = o;
  return L;
}

// ws[n][k] <- wt[n0 + n][k0 + k] (n < NC, k < 16) and (kFromX) xs[r][k] <-
// x[row0 + r][k0 + k] (r < 64), rows past the bag's end N zero-filled, in
// 16-byte copies; commits one group.
template <int NC, bool kFromX>
__device__ __forceinline__ void stage_f32(const float* __restrict__ wt, int K, int n0, int k0, float* ws,
                                          const float* __restrict__ x, int N, int D, int row0, float* xs) {
  constexpr int kChunks = kBKF32 / 4;
#pragma unroll
  for (int j = 0; j < NC * kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kChunks, c = (i % kChunks) * 4;
    cp_async16(ws + r * kSF32 + c, wt + (size_t)(n0 + r) * K + k0 + c, 16);
  }
  if (kFromX) {
    const int r = threadIdx.x / kChunks, c = (threadIdx.x % kChunks) * 4;
    const bool ok = row0 + r < N;
    cp_async16(xs + r * kSF32 + c, ok ? x + (size_t)(row0 + r) * D + k0 + c : x, ok ? 16 : 0);
  }
  cp_async_commit();
}

// c[16x8] += a[16x8] . b[8x8], tf32 operands (each f32's low 13 bits dropped), f32 sums
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v = big + small as two tf32 operands. The tensor cores read the top 19
// bits of a tf32 operand and drop the low 13, so big = bits + 0x1000 reads as
// v rounded to nearest, ties away, as cvt.rna.tf32.f32 would round it, and
// small = v - that (exact in f32) reads as itself truncated: three
// instructions, where two cvt.rna compile to compares and selects on sm_90a
// (the kernel was 1.16x slower with them, PERF.md §6)
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(v) + 0x1000u;
  small = __float_as_uint(v - __uint_as_float(big & 0xffffe000u));
}

// acc += A[64, 16] . W[32*NT columns, 16]^T over one staged slice in 3xTF32:
// a_base the slice's row 0 (row stride la), w_base its column 0 of the pass
// (stride kSF32); m16n8k8 fragments loaded as f32 and split in registers,
// the small products first.
template <int NT>
__device__ __forceinline__ void slice_product(float (&acc)[2][NT][4], const float* a_base, int la,
                                              const float* w_base) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3, g = lane >> 2, q = lane & 3;
  const float* a_row = a_base + (wr * 32 + g) * la;
  const float* w_col = w_base + (wc * 8 * NT) * kSF32;
  uint32_t ab[2][2][4], as[2][2][4];  // a fragments of k8 step s, m-tile mi: big, small
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int r = 0; r < 4; ++r)  // (g, q), (g+8, q), (g, q+4), (g+8, q+4)
        split_tf32(a_row[(mi * 16 + (r & 1) * 8) * la + 8 * s + q + (r >> 1) * 4], ab[s][mi][r], as[s][mi][r]);
  // four n-tiles at a time, eight independent sums between two products
  // into one. The slice's products go to sums of their own, added to acc
  // once: the tensor cores truncate each sum they write, and a running sum
  // that kept its sign would gather that bias over all K
#pragma unroll
  for (int n4 = 0; n4 < NT; n4 += 4) {
    float part[2][4][4] = {};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t bb[4][2], bs[4][2];  // b0 (k = q), b1 (k = q + 4) of column (n4 + j)*8 + g
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* w = w_col + ((n4 + j) * 8 + g) * kSF32 + 8 * s + q;
        split_tf32(w[0], bb[j][0], bs[j][0]);
        split_tf32(w[4], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_tf32(part[mi][j], as[s][mi], bb[j][0], bb[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_tf32(part[mi][j], ab[s][mi], bs[j][0], bs[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_tf32(part[mi][j], ab[s][mi], bb[j][0], bb[j][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][n4 + j][e] += part[mi][j][e];
  }
}

// acc = A[64, K] . Wt[n0 : n0 + 32*NT, K]^T in one pass over K, A the staged
// x tile (kFromX; its slices ride in xs) or h [64][ldh].
template <int NT, bool kFromX>
__device__ __forceinline__ void gemm_rows64(float (&acc)[2][NT][4], const float* __restrict__ wt, int K, int n0,
                                            const float* h, int ldh, const float* __restrict__ x, int N, int D,
                                            int row0, float* ws, float* xs) {
  constexpr int NC = kColWarps * 8 * NT;
  const int n_steps = K / kBKF32;
  auto issue = [&](int step) {
    if (step < n_steps) {
      const int slot = step % kSlotsF32;
      stage_f32<NC, kFromX>(wt, K, n0, step * kBKF32, ws + slot * NC * kSF32, x, N, D, row0,
                            xs + slot * kRowsF32 * kSF32);
    } else {
      cp_async_commit();  // empty group: keeps one group per step for the wait count
    }
  };
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // the ring and the x slots are free, and the previous epilogue's writes to
  // h are visible, once every warp has arrived here
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSlotsF32 - 1; ++s) issue(s);
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kSlotsF32 - 2>();  // this thread's copies of `step` have landed
    __syncthreads();                 // everyone's have, and slot (step - 1) is free
    issue(step + kSlotsF32 - 1);
    const int slot = step % kSlotsF32;
    slice_product<NT>(acc, kFromX ? xs + slot * kRowsF32 * kSF32 : h + step * kBKF32, kFromX ? kSF32 : ldh,
                      ws + slot * NC * kSF32);
  }
}

// h[row][col] <- relu(acc + bias) over the pass's 32*NT columns
template <int NT>
__device__ __forceinline__ void store_relu(const float (&acc)[2][NT][4], const float* __restrict__ bias, float* h,
                                           int ldh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = wr * 32 + mi * 16 + g + hf * 8;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int col = wc * 8 * NT + ni * 8 + 2 * q;
        *reinterpret_cast<float2*>(h + row * ldh + col) =
            make_float2(fmaxf(acc[mi][ni][2 * hf] + __ldg(bias + col), 0.f),
                        fmaxf(acc[mi][ni][2 * hf + 1] + __ldg(bias + col + 1), 0.f));
      }
    }
}

// The gate epilogue of interleaved [Wa|Wb] columns n0..n0+255: warp column wc
// holds u_j in n-tiles 0-3 and v_j (32 columns further) in n-tiles 4-7 for
// j = n0/2 + wc*32 + ni*8 + 2q (+1). gated_j = tanh(u_j) sigmoid(v_j) (f32)
// is folded into the thread's partial scores sacc[mi][hf][t] += gated_j
// Wc[j][t]; it never reaches shared memory.
__device__ __forceinline__ void gate_fold_f32(const float (&acc)[2][8][4], const float* __restrict__ bias,
                                              const float* __restrict__ wc_g, int n0, float (&sacc)[2][2][2]) {
  const int lane = threadIdx.x & 31, wc = (threadIdx.x >> 5) & 3;
  float2 w[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      w[ni][e] = __ldg(reinterpret_cast<const float2*>(wc_g) + n0 / 2 + wc * 32 + ni * 8 + 2 * (lane & 3) + e);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cu = n0 + wc * 64 + ni * 8 + 2 * (lane & 3) + e;  // u column; v is 32 further
          const float gv = gate<kEpiTanh>(acc[mi][ni][2 * hf + e] + __ldg(bias + cu),
                                          acc[mi][ni + 4][2 * hf + e] + __ldg(bias + cu + 32));
          sacc[mi][hf][0] = fmaf(gv, w[ni][e].x, sacc[mi][hf][0]);
          sacc[mi][hf][1] = fmaf(gv, w[ni][e].y, sacc[mi][hf][1]);
        }
}

// NT = H / 32: the trunk GEMMs' n-tiles a warp
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
pool_kernel_f32(const float* __restrict__ x, const float* __restrict__ mask, long long x_bag, long long m_bag,
                int N, int D, int H, int A,
                const float* __restrict__ w1t, const float* __restrict__ b1,
                const float* __restrict__ w2t, const float* __restrict__ b2,
                const float* __restrict__ wabt, const float* __restrict__ bab,
                const float* __restrict__ wc, const float* __restrict__ bc,
                int tiles_per_split, int n_splits,
                float* __restrict__ scores, float* __restrict__ part_acc, float* __restrict__ part_stat,
                int* __restrict__ tickets, float eps, float* __restrict__ out, float* __restrict__ stat_out) {
  constexpr int R = kRowsF32;
  extern __shared__ __align__(16) unsigned char smem[];
  const LayoutF32 L = layout_f32(H);
  float* h = reinterpret_cast<float*>(smem + L.h);
  float* ws = reinterpret_cast<float*>(smem + L.ws);
  float* spart = reinterpret_cast<float*>(smem + L.spart);  // [4][R][2] partial scores of the column warps
  float* s_s = reinterpret_cast<float*>(smem + L.s);        // [R][2] raw scores
  float* e_s = reinterpret_cast<float*>(smem + L.e);        // [R][2] e
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);    // [2][H]
  float* stat = reinterpret_cast<float*>(smem + L.stat);    // max[2], denom[2], corr[2]

  const int tid = threadIdx.x;
  const int shard = blockIdx.x / n_splits, split = blockIdx.x - shard * n_splits, b = blockIdx.y;
  const int ldh = H + kHPadF32;
  const float* xb = x + (size_t)b * x_bag + (size_t)shard * N * D;  // the shard's N rows
  const float* mb = mask + (size_t)b * m_bag + (size_t)shard * N;

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

    {
      float acc[2][NT][4];
      // h1 = relu(x W1 + b1) -> h, once every warp has read its last x slice there
      gemm_rows64<NT, true>(acc, w1t, D, 0, nullptr, 0, xb, N, D, row0, ws, h);
      __syncthreads();
      store_relu<NT>(acc, b1, h, ldh);
      // h2 = relu(h1 W2 + b2) -> h, over h1 once every warp has read all of it
      gemm_rows64<NT, false>(acc, w2t, H, 0, h, ldh, nullptr, N, D, row0, ws, nullptr);
      __syncthreads();
      store_relu<NT>(acc, b2, h, ldh);
    }
    // gated = tanh(h2 Wa + ba) * sigmoid(h2 Wb + bb), folded into the scores
    float sacc[2][2][2] = {};
    for (int n0 = 0; n0 < 2 * A; n0 += kGatePass) {
      float acc[2][8][4];
      gemm_rows64<8, false>(acc, wabt, H, n0, h, ldh, nullptr, N, D, row0, ws, nullptr);
      gate_fold_f32(acc, bab, wc, n0, sacc);
    }
    // s = gated Wc + bc: the quad, then the four column warps
    reduce_scores<2>(sacc, spart, bc, s_s, scores, b, N, row0);

    online_stats<R, float>(s_s, mb, row0, N, e_s, stat);
    __syncthreads();
    online_accumulate<R, float>(acc_s, e_s, stat, h, ldh, H);
  }
  __syncthreads();

  const size_t p = (size_t)b * gridDim.x + blockIdx.x;
  for (int i = tid; i < 2 * H; i += kThreads) part_acc[p * 2 * H + i] = acc_s[i];
  if (tid < 4) part_stat[p * 4 + tid] = stat[tid];
  pool_tail<2>(part_acc, part_stat, (size_t)b * gridDim.x, gridDim.x, tickets + b, H, stat_out == nullptr, eps,
               out + (size_t)b * 2 * H, stat_out == nullptr ? nullptr : stat_out + (size_t)b * 4,
               reinterpret_cast<float*>(smem));
}

// ---------------------------------------------------------------------------
// The bf16 instance: 128-row tiles, one CTA an SM, 8 warps of 64 x 64; its
// GEMM, ReLU epilogue and GEMM2's stash are pool_trunk.cuh's gemm_rows128,
// relu_pack, store_packed, stash_put and stash_take, which the bf16 probe
// (csrc/pool_probe.cu) shares.

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
  L.xs = o;   o = align16(o + kXRingBytes);
  L.acc = o;  o = align16(o + sizeof(float) * 2 * H);
  L.stat = o; o = align16(o + sizeof(float) * 8);
  L.total = o;
  return L;
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
pool_kernel_bf16(const bf16* __restrict__ x, const float* __restrict__ mask, long long x_bag, long long m_bag,
                 int N, int D, int H, int A,
                 const bf16* __restrict__ w1t, const float* __restrict__ b1,
                 const bf16* __restrict__ w2t, const float* __restrict__ b2,
                 const bf16* __restrict__ wabt, const float* __restrict__ bab,
                 const bf16* __restrict__ wc, const float* __restrict__ bc,
                 int tiles_per_split, int n_splits,
                 float* __restrict__ scores, float* __restrict__ part_acc, float* __restrict__ part_stat,
                 int* __restrict__ tickets, float eps, float* __restrict__ out, float* __restrict__ stat_out) {
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
  const int shard = blockIdx.x / n_splits, split = blockIdx.x - shard * n_splits, b = blockIdx.y;
  const int ldh = H + kHPad;
  const bf16* xb = x + (size_t)b * x_bag + (size_t)shard * N * D;  // the shard's N rows
  const float* mb = mask + (size_t)b * m_bag + (size_t)shard * N;

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

    // h1 = relu(x W1 + b1), then h2 = relu(h1 W2 + b2) -> h
    float acc[kMi][8][4];
    uint32_t packed[kMi][8][2];
    // h1 = relu(x W1 + b1) -> h
    for (int n0 = 0; n0 < H; n0 += kBN) {
      gemm_rows128<true>(acc, w1t, D, n0, nullptr, 0, &xb, N, D, row0, ws, xs);
      relu_pack(acc, b1, n0, packed);
      store_packed(packed, n0, h, ldh);
    }
    constexpr int kHalf = kMi / 2;
    uint32_t stash[kHalf][8][2];
    uint32_t* stash_s = reinterpret_cast<uint32_t*>(xs);  // [kStashSmem][threads]
    if (H == 2 * kBN) {
      gemm_rows128<false>(acc, w2t, H, 0, h, ldh, nullptr, N, D, row0, ws, xs);
      relu_pack(acc, b2, 0, packed);
      stash_put(packed, stash, stash_s, tid);
    }
    gemm_rows128<false>(acc, w2t, H, H - kBN, h, ldh, nullptr, N, D, row0, ws, xs);
    relu_pack(acc, b2, H - kBN, packed);
    __syncthreads();
    if (H == 2 * kBN) {
      uint32_t first[kMi][8][2];
      stash_take(first, stash, stash_s, tid);
      store_packed(first, 0, h, ldh);
    }
    store_packed(packed, H - kBN, h, ldh);
    // gated = bf16(tanh(h2 Wa + ba) * sigmoid(h2 Wb + bb)), folded into the scores
    float sacc[kMi][2][2] = {};
    for (int n0 = 0; n0 < 2 * A; n0 += kBN) {
      float acc[kMi][8][4];
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

  const size_t p = (size_t)b * gridDim.x + blockIdx.x;
  for (int i = tid; i < 2 * H; i += kThreadsBf16) part_acc[p * 2 * H + i] = acc_s[i];
  if (tid < 4) part_stat[p * 4 + tid] = stat[tid];
  pool_tail<2>(part_acc, part_stat, (size_t)b * gridDim.x, gridDim.x, tickets + b, H, stat_out == nullptr, eps,
               out + (size_t)b * 2 * H, stat_out == nullptr ? nullptr : stat_out + (size_t)b * 4,
               reinterpret_cast<float*>(smem));
}

// One launch over B bags of n_shards shards of N rows each, n_splits runs a
// shard: the kernel and its tail (divide where stat_out is null).
template <typename T>
int launch(const void* x, const float* mask, long long x_bag, long long m_bag, int B, int n_shards, int N, int D,
           int H, int A, const void* w1t, const float* b1, const void* w2t, const float* b2,
           const void* wabt, const float* bab, const void* wc, const float* bc,
           int tiles_per_split, int n_splits, float* scores, float* part_acc, float* part_stat, int* tickets,
           float eps, float* out, float* stat_out, cudaStream_t stream) {
  // the plan's TRUNK_WIDTHS; 2H outputs within what pool_tail takes in one pass
  if ((H != kBN && H != 2 * kBN) || 2 * H > kTailCols) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    const LayoutBf16 L = layout_bf16(H);
    // the tail's scratch lies in the shared memory before the running acc
    if (sizeof(float) * tail_scratch_floats(2, n_shards * n_splits) > L.acc) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(pool_kernel_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (err != cudaSuccess) return (int)err;
    pool_kernel_bf16<<<dim3(n_shards * n_splits, B), kThreadsBf16, L.total, stream>>>(
        static_cast<const bf16*>(x), mask, x_bag, m_bag, N, D, H, A,
        static_cast<const bf16*>(w1t), b1, static_cast<const bf16*>(w2t), b2,
        static_cast<const bf16*>(wabt), bab, static_cast<const bf16*>(wc), bc,
        tiles_per_split, n_splits, scores, part_acc, part_stat, tickets, eps, out, stat_out);
  } else {
    const LayoutF32 L = layout_f32(H);
    if (sizeof(float) * tail_scratch_floats(2, n_shards * n_splits) > L.acc) return (int)cudaErrorInvalidValue;
    auto kernel = H == kBN ? pool_kernel_f32<kBN / 32> : pool_kernel_f32<2 * kBN / 32>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(n_shards * n_splits, B), kThreads, L.total, stream>>>(
        static_cast<const float*>(x), mask, x_bag, m_bag, N, D, H, A,
        static_cast<const float*>(w1t), b1, static_cast<const float*>(w2t), b2,
        static_cast<const float*>(wabt), bab, static_cast<const float*>(wc), bc,
        tiles_per_split, n_splits, scores, part_acc, part_stat, tickets, eps, out, stat_out);
  }
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launches;
  return (int)err;
}

}  // namespace

extern "C" {

// Rows per tile of the instance: 0 = float32, 1 = bfloat16.
int toad_pool_rows_per_tile(int dtype) { return dtype == 1 ? kRowsBf16 : kRowsF32; }

// Dynamic shared memory of the pooling kernel in bytes.
long long toad_pool_smem_bytes(int dtype, int H, int A) {
  return (long long)(dtype == 1 ? layout_bf16(H).total : layout_f32(H).total);
}

// Launches the pooling kernel on `stream`: M [B][2][H] = acc / max(denom,
// 1e-30) and, where scores is not null, the raw scores [B][2][N]. tickets
// holds B int32 counters, all 0 (every launch leaves them so). Returns the
// launch's cudaError_t (0 on success); does not synchronise.
int toad_pool_forward(int dtype, const void* x, const float* mask, long long x_bag, long long m_bag, int B, int N,
                      int D, int H, int A, const void* w1t, const float* b1, const void* w2t, const float* b2,
                      const void* wabt, const float* bab, const void* wc, const float* bc,
                      int tiles_per_split, int n_splits, float* scores, float* part_acc, float* part_stat,
                      int* tickets, float* out, void* stream) {
  auto go = dtype == 1 ? &launch<bf16> : &launch<float>;
  return go(x, mask, x_bag, m_bag, B, 1, N, D, H, A, w1t, b1, w2t, b2, wabt, bab, wc, bc, tiles_per_split, n_splits,
            scores, part_acc, part_stat, tickets, 1e-30f, out, nullptr, static_cast<cudaStream_t>(stream));
}

// The pooling kernel in partial mode (classification only, no scores): writes
// acc [B][2][H] = sum over the live rows of exp(s - max) h and stats [B][2][2]
// = (max[2], denom[2]) instead of the pooled mean; max = -1e30, denom = 0 and
// acc = 0 where no row is live. Replaces the TPU kernel's partial form
// (toad_tpu/ops/pallas_pool.py::pallas_pool_partial).
int toad_pool_partial_forward(int dtype, const void* x, const float* mask, long long x_bag, long long m_bag, int B,
                              int N, int D, int H, int A, const void* w1t, const float* b1, const void* w2t,
                              const float* b2, const void* wabt, const float* bab, const void* wc, const float* bc,
                              int tiles_per_split, int n_splits, float* part_acc, float* part_stat, int* tickets,
                              float* acc, float* stats, void* stream) {
  if (stats == nullptr) return (int)cudaErrorInvalidValue;
  auto go = dtype == 1 ? &launch<bf16> : &launch<float>;
  return go(x, mask, x_bag, m_bag, B, 1, N, D, H, A, w1t, b1, w2t, b2, wabt, bab, wc, bc, tiles_per_split, n_splits,
            nullptr, part_acc, part_stat, tickets, 0.f, acc, stats, static_cast<cudaStream_t>(stream));
}

// The bag-sharded pool in one launch: each bag's rows cut into S shards of N
// rows (shard s at rows s * N), each shard pooled in runs of its own tiles
// (tiles_per_split, n_splits a shard), and every partial of a bag merged:
// out [B][2][H] = acc / max(denom, 1e-12), the split merge and the
// cross-shard combine of toad_tpu/parallel/bag_shard.py in one pass.
int toad_pool_sharded_forward(int dtype, const void* x, const float* mask, long long x_bag, long long m_bag, int B,
                              int S, int N, int D, int H, int A, const void* w1t, const float* b1, const void* w2t,
                              const float* b2, const void* wabt, const float* bab, const void* wc, const float* bc,
                              int tiles_per_split, int n_splits, float* part_acc, float* part_stat, int* tickets,
                              float* out, void* stream) {
  auto go = dtype == 1 ? &launch<bf16> : &launch<float>;
  return go(x, mask, x_bag, m_bag, B, S, N, D, H, A, w1t, b1, w2t, b2, wabt, bab, wc, bc, tiles_per_split, n_splits,
            nullptr, part_acc, part_stat, tickets, 1e-12f, out, nullptr, static_cast<cudaStream_t>(stream));
}

// Combines the partials of S shards of B bags, acc [S][B][2][H] and stats
// [S][B][2][2] as toad_pool_partial_forward writes them, into the pooled
// out [B][2][H] = sum_s acc_s w_s / max(sum_s denom_s w_s, 1e-12): the
// cross-shard combine of toad_tpu/parallel/bag_shard.py::combine_partial_pool,
// for partials that come from several devices.
int toad_pool_combine_shards(const float* acc, const float* stats, int S, int B, int H, float* out, void* stream) {
  const int err = launch_combine_strided<2>(acc, stats, S, 1, B, B, H, 1e-12f, 0.f, out,
                                            static_cast<cudaStream_t>(stream));
  if (err == 0) ++g_launches;
  return err;
}

// Kernel launches made by this file's entry points so far (each forward is one).
long long toad_pool_launches() { return g_launches.load(); }

const char* toad_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
