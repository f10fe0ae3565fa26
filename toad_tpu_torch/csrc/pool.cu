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
// The bf16 instance runs 128-row tiles, one CTA an SM, its 8 warps as two
// warpgroups that each own 64 rows (one wgmma M) and every column of a
// 256-column pass: each staged slice feeds 128 rows, which halves the weight
// stream of 64-row tiles. Its products are wgmma m64n256k16 with both
// operands in shared memory, K-major in the 64-byte swizzle: B from a 4-slot
// cp.async ring of 256 x 32 weight slices, A from the x slices (a 4-slot
// ring beside it) or from h1 and h2, which the epilogues store as 32-deep
// panels of the same swizzle. Each warpgroup issues a slice's two wgmmas and
// waits only for the slice before, so the products of one slice run while
// the next is issued and two more are in flight. (A from registers, loaded
// with ldmatrix from padded row-major tiles, made ptxas serialize the wgmmas:
// the next slice's A registers are written while a wgmma is in flight.)
// Shared memory limits the tile, since h1 and h2 of 128 rows take 128 KB
// each, so they share one region:
//   - GEMM1 writes h1 there;
//   - GEMM2's first 256-column pass keeps its output as packed bf16 (the
//     stash: half in registers, half in the x ring, idle in GEMM2) while the
//     second pass still reads h1; both halves of h2 go over the dead h1 after
//     a barrier;
//   - the gate pass never writes `gated`: its epilogue rounds each value to
//     bf16 and folds it into per-row partial scores against Wc; a thread's
//     sums are one row pair over all 256 columns, so a row's score is its
//     quad's sum.
// The running acc [2][H] lives in the block's slot of part_acc in device
// memory, which makes room for the fourth ring slot. h1, h2 and gated round
// where the TPU kernel does; wgmma sums a value's k16 products in ascending k
// as mma.sync did, and the scores' f32 order is each thread's columns, then
// its quad. The plan (rows, threads, ring slots, shared memory) is
// ops/cuda_pool.plan; the bf16 instance takes H = 256 or 512. What bounds it
// (PERF.md §6, §7): the passes' serial order. The L2 weight stream hides
// under the products (a build without the weight copies is no faster); a
// build without the products keeps ~75 % of the time, and each of a tile's
// passes (7 at H = 512) ends in a wait for its last slice and an epilogue (ReLU and
// stores, or the gate's tanh and sigmoid: a linear gate takes ~12-18 % off)
// while the tensor cores idle. One warpgroup's epilogue under the other's
// products, or the next pass's first slices under this pass's epilogue, is
// what is left.
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
// (cuda_pool.wave_split_plan). Neither uses TMA or warp specialisation; both
// issue their products as wgmma, the bf16 instance's m64n256k16 in bf16, the
// f32 instance's m64n64k8 in tf32.
//
// The f32 instance (the default of serve, eval, predict, infer and the f32
// trainer's passes) keeps f32 f32: Hopper has no f32 tensor-core product,
// and a single TF32 product is off by ~1e-3. So its products are
// error-compensated TF32 ("3xTF32"), three TF32 products for each f32 one,
// bound by operations: 3 x 2.4 MFLOP a 1024-d row at 495 TFLOP/s. Its f32
// weights are 4.72 MB, twice bf16's, and h1 or h2 of 64 rows already take
// 132 KB, so it runs 64-row tiles, one wgmma M, and each trunk GEMM as one
// pass over all H columns: the pass's output reaches shared memory only after
// its last slice, so h1 and h2 take turns in one region, and GEMM1's x slices
// ride in that region while it is dead. Its 8 warps are two warpgroups that
// split a pass's columns (H/2 each in the trunk, 128 of each 256-column gate
// pass, whose epilogue folds gated values into per-row scores in registers
// as the bf16 instance does) and keep to themselves between the passes'
// barriers: each streams its half of the weights through its own 2-slot
// cp.async ring of 16-deep slices (64-byte rows in the 64-byte swizzle that
// wgmma reads; 32-byte rows made twice the L2 requests) and issues wgmma
// m64n64k8 with A from registers and B from shared memory. A (x, h1 or h2)
// splits in registers into big = a rounded to tf32 and small = a - big
// (exact in f32, read as tf32 by truncation); W's big half is its raw f32
// slice, which the tensor cores read truncated, and its small half
// w - trunc(w), exact, is written beside the slice once it lands (not kept in
// device memory: that would double the L2 stream). Each slice and 64-column
// piece is small.big, big.big, then big.small for both k8 halves into 32
// sums of their own, which one f32 add folds into the running 128 a thread:
// the tensor cores truncate the sums they write, and a running sum that kept
// its sign would gather that bias over all of K (10x f32 FMA's error on the
// card, PERF.md §6), so summed it is as accurate as f32 FMA
// (tests/test_torch_port_pool_plan.py models it). The first two pieces'
// products that need only the raw slice run while the small halves are
// written, and the fold of one piece overlaps the next piece's products.
// What bounds it now (PERF.md §6): the L2 weight stream, ~5.2 ms of ~8.5 at
// B=32 x 8,192 alone (a build without the products), with one slice in
// flight a warpgroup; the products add ~3.4 ms over it and the small halves'
// writes ~1.3 ms. One L2 read for two CTAs (TMA multicast over a cluster)
// is what is left; the shared memory holds no third slot.
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
#include "wgmma.cuh"

namespace {

static_assert(kThreadsBf16 == kThreads, "both instances end in pool_tail's 8 warps");

std::atomic<long long> g_launches{0};  // kernel launches made by this file's entry points

// ---------------------------------------------------------------------------
// The f32 instance. Its 8 warps are two warpgroups; warpgroup wg owns columns
// wg*NW .. wg*NW + NW - 1 of a pass (NW = H/2 in the trunk, 128 of a 256-
// column gate pass) and all 64 rows. Its products are wgmma m64n64k8 pieces:
// warp w of the group holds rows 16w + g and 16w + g + 8 of each piece, and
// register i of a piece is row 16w + g + 8*((i >> 1) & 1), column 8*(i >> 2) +
// 2q + (i & 1) (g = lane / 4, q = lane % 4), the accumulator layout of wgmma.

constexpr int kRowsF32 = 64;        // rows a tile: one wgmma M
constexpr int kBKF32 = 16;          // reduction depth of a staged slice: two tf32 wgmma K (64-byte rows)
constexpr int kPiece = 64;          // columns of one wgmma (m64n64k8: 32 sums a thread)
constexpr int kSlotsF32 = 2;        // slots of a warpgroup's cp.async ring: one slice in flight
constexpr int kXSF32 = kBKF32 + 4;  // x slot row stride (words): conflict-free fragment loads
constexpr int kHPadF32 = 4;         // row padding of the f32 region: H + 4 puts rows g on banks 4g
constexpr int kGatePass = 256;      // interleaved [Wa|Wb] columns a gate pass
constexpr int kWarpgroups = kThreads / 128;
static_assert(kWarpgroups == 2 && kRowsF32 * kBKF32 / 4 == 2 * 128, "two warpgroups, two 16-byte x copies a thread");

// One region h [64][H + 4] holds GEMM1's x slices (each warpgroup's ring of
// [64][20] slots), then h1, then h2; each warpgroup's weight ring ws [2][H/2]
// [16] of 64-byte swizzled rows, and its small halves [H/2][16] beside them,
// which at a tile's end (every product done) hold the warpgroups' partial
// scores [2][64][2], s [64][2] and e [64][2]; stat (max[2], denom[2],
// corr[2]). The running acc [2][H] is the block's own slot of part_acc in
// device memory (each thread its own entries), and Wc is read from there.
// The rings start on a 1024-byte boundary: the swizzle is a function of the
// address.
struct LayoutF32 {
  size_t h, ws, small, stat, total;
};

__host__ __device__ inline LayoutF32 layout_f32(int H) {
  LayoutF32 L;
  size_t o = 0;
  L.h = o;     o = align1024(o + sizeof(float) * kRowsF32 * (H + kHPadF32));
  L.ws = o;    o = align16(o + sizeof(float) * kWarpgroups * kSlotsF32 * (H / 2) * kBKF32);
  L.small = o; o = align16(o + sizeof(float) * kWarpgroups * (H / 2) * kBKF32);
  L.stat = o;  o = align16(o + sizeof(float) * 8);
  L.total = o;
  return L;
}

// the descriptors' step to the next piece's rows (sw64_desc_lo and kHalfDesc in wgmma.cuh)
constexpr uint32_t kPieceDesc = kPiece * 64 / 16;

// d[64 x 64] (+)= a[64 x 8] . b[64 x 8]^T: A (tf32 in f32 registers, the
// m16n8k8 fragment of this warp's 16 rows) from registers, B from shared
// memory; kScaleD = 0 writes the products over d
template <int kScaleD>
__device__ __forceinline__ void wgmma_tf32(float (&d)[kPiece / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  static_assert(kPiece == 64, "the operand list is m64n64k8's");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(kScaleD));
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

// w - w truncated to tf32: exact in f32, the small half of a weight whose big
// half is the raw f32 value as the tensor cores read it
__device__ __forceinline__ float tf32_rest(float w) { return w - __uint_as_float(__float_as_uint(w) & 0xffffe000u); }

// The 16-byte chunks of a warpgroup's weight slice that thread t copies: j <
// NW / 32, row n = t/4 + 32j, chunk c = t % 4 (four threads a 64-byte row);
// its float4 index in the slot, the 64-byte swizzle's.
__device__ __forceinline__ int chunk_f4(int t, int j) {
  return 4 * (t >> 2) + ((t & 3) ^ ((t >> 3) & 3)) + 128 * j;  // bits 1-2 of n are bits 3-4 of t
}

// Warpgroup wg's share of slice k0..k0+15: its NW weight rows wt[n][k0..] (wt
// at its first row, row stride K) into a ring slot in the 64-byte swizzle,
// and (kFromX) the 64 x rows' k0..k0+15 into its x slot (rows past the bag's
// end N zero-filled), in 16-byte copies; commits one group.
template <int NW, bool kFromX>
__device__ __forceinline__ void stage_f32(const float* __restrict__ wt, int K, int k0, float* slot,
                                          const float* __restrict__ x, int N, int D, int row0, float* xs) {
  const int t = threadIdx.x & 127;
  const float* src = wt + (size_t)(t >> 2) * K + k0 + (t & 3) * 4;  // chunk 0's; chunk j's is 32j rows further
#pragma unroll
  for (int j = 0; j < NW / 32; ++j, src += (size_t)32 * K)
    cp_async16(reinterpret_cast<float4*>(slot) + chunk_f4(t, j), src, 16);
  if (kFromX) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = (t >> 2) + 32 * j, c = t & 3;
      const bool ok = row0 + r < N;
      cp_async16(xs + r * kXSF32 + c * 4, ok ? x + (size_t)(row0 + r) * D + k0 + c * 4 : x, ok ? 16 : 0);
    }
  }
  cp_async_commit();
}

// run = A[64, K] . Wt[n0 + wg*NW .. + NW, K]^T for warpgroup wg in one pass
// over K, A the staged x tile (kFromX; its slices ride in xs) or h [64][ldh],
// in 3xTF32: A splits in registers into big (rounded) and small, W's big half
// is its raw f32 slice (read truncated) and its small half w - trunc(w) is
// written beside it once the slice lands (each thread the chunks it copied).
// Each 16-deep slice and 64-column piece is six wgmmas (small.big and big.big
// of each k8 half, then big.small of each) into sums of their own, started by
// the first, which one f32 add folds into run: the tensor cores truncate each
// sum they write, and a running sum that kept its sign would gather that bias
// over all K. Pieces 0 and 1 start their products on the raw slice while the
// small halves are written; the fold of piece p overlaps the products of
// piece p + 1. The warpgroup keeps to itself (its own ring, x slots and
// barriers), so the other one's products fill its barriers, splits and folds.
template <int NW, bool kFromX>
__device__ __forceinline__ void gemm_wg(float (&run)[NW / 2], const float* __restrict__ wt, int K, int n0,
                                        const float* h, int ldh, const float* __restrict__ x, int N, int D, int row0,
                                        float* ring, float* small, float* xring) {
  constexpr int NP = NW / kPiece;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int lane = t & 31, g = lane >> 2, q = lane & 3, a_row = 16 * (t >> 5) + g;
  const int n_steps = K / kBKF32;
  wt += (size_t)(n0 + wg * NW) * K;
  auto issue = [&](int step) {
    if (step < n_steps) {
      const int slot = step % kSlotsF32;
      stage_f32<NW, kFromX>(wt, K, step * kBKF32, ring + slot * NW * kBKF32, x, N, D, row0,
                            xring + slot * kRowsF32 * kXSF32);
    } else {
      cp_async_commit();  // empty group: keeps one group per step for the wait count
    }
  };
  constexpr int PR = kPiece / 2;  // a piece's sums a thread: run[p * PR + i]
  float part[2][PR];              // the pieces' sums, in turn
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) run[i] = 0.f;
#pragma unroll
  for (int i = 0; i < PR; ++i) part[0][i] = part[1][i] = 0.f;

  bar_wg(wg);  // every warp of the group is done with the ring and small halves of its last pass
#pragma unroll
  for (int s = 0; s < kSlotsF32 - 1; ++s) issue(s);
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kSlotsF32 - 2>();  // this thread's copies of `step` have landed
    bar_wg(wg);  // the group's have, and its products of `step - 1` are done: that slot and `small` are free
    issue(step + kSlotsF32 - 1);
    const int slot = step % kSlotsF32;
    const float* raw = ring + slot * NW * kBKF32;
    const float* a = kFromX ? xring + slot * kRowsF32 * kXSF32 : h + step * kBKF32;
    const int la = kFromX ? kXSF32 : ldh;
    uint32_t ab[2][4], as[2][4];  // each k8 half: (g, q), (g+8, q), (g, q+4), (g+8, q+4)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_tf32(a[(a_row + (r & 1) * 8) * la + 8 * kk + q + (r >> 1) * 4], ab[kk][r], as[kk][r]);
    const uint32_t db_lo = sw64_desc_lo(raw), ds_lo = sw64_desc_lo(small);
    // piece p's descriptors of the raw slice and of the small halves
    auto descs = [&](int p, uint64_t& db, uint64_t& ds) {
      db = (uint64_t)kDescHi << 32 | (db_lo + p * kPieceDesc);
      ds = (uint64_t)kDescHi << 32 | (ds_lo + p * kPieceDesc);
    };
    // the products of piece p that read the raw slice only: small.big and big.big of each k8 half
    auto raw_products = [&](int p) {
      uint64_t db, ds;
      descs(p, db, ds);
      wgmma_fence();  // the fold's reads of these registers, and the A fragments' writes, come first
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (kk == 0)
          wgmma_tf32<0>(part[p & 1], as[kk], db + kk * kHalfDesc);
        else
          wgmma_tf32<1>(part[p & 1], as[kk], db + kk * kHalfDesc);
        wgmma_tf32<1>(part[p & 1], ab[kk], db + kk * kHalfDesc);
      }
    };
    // pieces 0 and 1 start on the raw slice while the small halves are written
    raw_products(0);
    wgmma_commit();
    raw_products(1);
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < NW / 32; ++j) {
      const float4 v = reinterpret_cast<const float4*>(raw)[chunk_f4(t, j)];
      reinterpret_cast<float4*>(small)[chunk_f4(t, j)] =
          make_float4(tf32_rest(v.x), tf32_rest(v.y), tf32_rest(v.z), tf32_rest(v.w));
    }
    fence_async_smem();
    bar_wg(wg);  // the group's small halves are written
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (p >= 2) raw_products(p);
      uint64_t db, ds;
      descs(p, db, ds);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) wgmma_tf32<1>(part[p & 1], ab[kk], ds + kk * kHalfDesc);
      wgmma_commit();
      if (p > 0) {
        wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < PR; ++i) run[(p - 1) * PR + i] += part[(p - 1) & 1][i];
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < PR; ++i) run[(NP - 1) * PR + i] += part[(NP - 1) & 1][i];
  }
}

// h[row][col] <- relu(run + bias) over warpgroup wg's NW columns: run[4j +
// 2hf + e] is row 16w + g + 8hf, column 8j + 2q + e of them
template <int NW>
__device__ __forceinline__ void store_relu(const float (&run)[NW / 2], const float* __restrict__ bias, float* h,
                                           int ldh) {
  const int tid = fresh_tid(), wg = tid >> 7, t = tid & 127;
  const int lane = t & 31, row = 16 * (t >> 5) + (lane >> 2), q = lane & 3;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = wg * NW + j * 8 + 2 * q;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(h + (row + 8 * hf) * ldh + col) =
          make_float2(fmaxf(run[4 * j + 2 * hf] + b0, 0.f), fmaxf(run[4 * j + 2 * hf + 1] + b1, 0.f));
  }
}

// The gate epilogue of interleaved [Wa|Wb] columns n0 + wg*128 .. + 127: in
// each 64-column block, n-tiles 0-3 hold u_j and n-tiles 4-7 v_j (32 columns
// further) for j = n0/2 + wg*64 + blk*32 + ni*8 + 2q (+1). gated_j =
// tanh(u_j) sigmoid(v_j) (f32) is folded into the thread's partial scores
// sacc[hf][t] += gated_j Wc[j][t] (rows g, g + 8 of its warp); it never
// reaches shared memory.
__device__ __forceinline__ void gate_fold_f32(const float (&run)[kGatePass / 4], const float* __restrict__ bias,
                                              const float* __restrict__ wc_g, int n0, float (&sacc)[2][2]) {
  const int tid = fresh_tid(), wg = tid >> 7, q = tid & 3;
#pragma unroll
  for (int blk = 0; blk < kGatePass / 2 / 64; ++blk)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cu = n0 + wg * (kGatePass / 2) + blk * 64 + ni * 8 + 2 * q + e;  // u column; v is 32 further
        const float2 w = __ldg(reinterpret_cast<const float2*>(wc_g) + n0 / 2 + wg * (kGatePass / 4) + blk * 32 +
                               ni * 8 + 2 * q + e);
        const float bu = __ldg(bias + cu), bv = __ldg(bias + cu + 32);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float gv = gate<kEpiTanh>(run[32 * blk + 4 * ni + 2 * hf + e] + bu,
                                          run[32 * blk + 4 * (ni + 4) + 2 * hf + e] + bv);
          sacc[hf][0] = fmaf(gv, w.x, sacc[hf][0]);
          sacc[hf][1] = fmaf(gv, w.y, sacc[hf][1]);
        }
      }
}

// s = sum of the partial scores + bc, in a fixed order: the quad's lanes,
// then warpgroup 0's and 1's, into s_s [64][2]; where scores is not null,
// also the raw scores [B][2][N] of the tile's rows inside the bag. spart
// lies over the small halves: both warpgroups' products are done first.
__device__ __forceinline__ void reduce_scores_f32(float (&sacc)[2][2], float* spart, const float* __restrict__ bc,
                                                  float* s_s, float* scores, int b, int N, int row0) {
  const int tid = fresh_tid(), wg = tid >> 7, lane = tid & 31;
  const int row = 16 * ((tid & 127) >> 5) + (lane >> 2);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      sacc[hf][t] += __shfl_xor_sync(0xffffffffu, sacc[hf][t], 1);
      sacc[hf][t] += __shfl_xor_sync(0xffffffffu, sacc[hf][t], 2);
    }
  __syncthreads();
  if ((lane & 3) == 0)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int t = 0; t < 2; ++t) spart[(wg * kRowsF32 + row + 8 * hf) * 2 + t] = sacc[hf][t];
  __syncthreads();
  if (tid < kRowsF32 * 2) {
    const int r = tid / 2, t = tid % 2;
    const float s = spart[tid] + spart[kRowsF32 * 2 + tid] + __ldg(bc + t);
    s_s[tid] = s;
    if (scores != nullptr && row0 + r < N) scores[((size_t)b * 2 + t) * N + row0 + r] = s;
  }
  __syncthreads();
}

// NW = H / 2: the trunk GEMMs' columns a warpgroup
template <int NW>
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
  constexpr int R = kRowsF32, kAcc = 4 * NW / kThreads;  // running acc [2][H] entries a thread
  extern __shared__ __align__(1024) unsigned char smem_f32[];
  const LayoutF32 L = layout_f32(H);
  float* h = reinterpret_cast<float*>(smem_f32 + L.h);
  const int tid = threadIdx.x, wg = tid >> 7;
  // this warpgroup's weight ring, small halves and (in h, while GEMM1 runs) x ring
  float* ring = reinterpret_cast<float*>(smem_f32 + L.ws) + wg * kSlotsF32 * NW * kBKF32;
  float* small = reinterpret_cast<float*>(smem_f32 + L.small) + wg * NW * kBKF32;
  float* xring = h + wg * kSlotsF32 * R * kXSF32;
  float* spart = reinterpret_cast<float*>(smem_f32 + L.small);  // [2][R][2] partial scores of the warpgroups
  float* s_s = spart + kWarpgroups * R * 2;                      // [R][2] raw scores
  float* e_s = s_s + R * 2;                                      // [R][2] e
  float* stat = reinterpret_cast<float*>(smem_f32 + L.stat);     // max[2], denom[2], corr[2]

  const int shard = blockIdx.x / n_splits, split = blockIdx.x - shard * n_splits, b = blockIdx.y;
  const int ldh = H + kHPadF32;
  const float* xb = x + (size_t)b * x_bag + (size_t)shard * N * D;  // the shard's N rows
  const float* mb = mask + (size_t)b * m_bag + (size_t)shard * N;
  const size_t p = (size_t)b * gridDim.x + blockIdx.x;
  float* acc = part_acc + p * 2 * H;  // the running acc [2][H], entries tid + k * kThreads this thread's

#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[tid + k * kThreads] = 0.f;
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
    // the identity there); scored mode writes every row's score. The barrier
    // also frees h, s and e: the last tile's e^T h2 has read them
    if (!__syncthreads_or(live) && scores == nullptr) continue;

    {
      float run[NW / 2];
      // h1 = relu(x W1 + b1) -> h, once both warpgroups have read their last x slice there
      gemm_wg<NW, true>(run, w1t, D, 0, nullptr, 0, xb, N, D, row0, ring, small, xring);
      __syncthreads();
      store_relu<NW>(run, b1, h, ldh);
      __syncthreads();
      // h2 = relu(h1 W2 + b2) -> h, over h1 once both warpgroups have read all of it
      gemm_wg<NW, false>(run, w2t, H, 0, h, ldh, nullptr, N, D, row0, ring, small, nullptr);
      __syncthreads();
      store_relu<NW>(run, b2, h, ldh);
      __syncthreads();
    }
    // gated = tanh(h2 Wa + ba) * sigmoid(h2 Wb + bb), folded into the scores
    float sacc[2][2] = {};
    for (int n0 = 0; n0 < 2 * A; n0 += kGatePass) {
      float run[kGatePass / 4];
      gemm_wg<kGatePass / 2, false>(run, wabt, H, n0, h, ldh, nullptr, N, D, row0, ring, small, nullptr);
      gate_fold_f32(run, bab, wc, n0, sacc);
    }
    // s = gated Wc + bc: the quad, then the two warpgroups
    reduce_scores_f32(sacc, spart, bc, s_s, scores, b, N, row0);

    online_stats<R, float>(s_s, mb, row0, N, e_s, stat);
    __syncthreads();
    // acc = acc * corr + e^T h2, as online_accumulate sums it
    const int tid2 = fresh_tid();
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      const int i = tid2 + k * kThreads, t = i >= H, c = i - t * H;
      float a = acc[i] * stat[4 + t];
      for (int r = 0; r < R; ++r) a = fmaf(e_s[2 * r + t], h[r * ldh + c], a);
      acc[i] = a;
    }
  }
  __syncthreads();

  if (tid < 4) part_stat[p * 4 + tid] = stat[tid];
  pool_tail<2>(part_acc, part_stat, (size_t)b * gridDim.x, gridDim.x, tickets + b, H, stat_out == nullptr, eps,
               out + (size_t)b * 2 * H, stat_out == nullptr ? nullptr : stat_out + (size_t)b * 4,
               reinterpret_cast<float*>(smem_f32));
}

// ---------------------------------------------------------------------------
// The bf16 instance: 128-row tiles, one CTA an SM, 8 warps as two warpgroups
// that own the tile's row halves (warpgroup wg rows 64 wg .. 64 wg + 63) and
// every column of a 256-column pass. Its products are wgmma m64n256k16 with
// both operands in shared memory, K-major in the 64-byte swizzle: A (the x
// slice, h1 or h2) as 64 rows of one 32-deep panel, B a weight ring slot.
// Warp w of the group holds rows 16w + g and 16w + g + 8 of its half, and
// register 4j + 2hf + e is row 16w + g + 8hf, column 8j + 2q + e (j < 32; g
// = lane / 4, q = lane % 4), the accumulator layout of wgmma. So a thread's
// 128 sums are one row pair over the whole pass, and a gate pass's
// interleaved [Wa|Wb] columns give it u_j (j mod 8 < 4) and v_j (4 register
// groups further) of the same j; a row's scores need only its quad's sum.

constexpr int kSlotsW = 4;               // ring slots: two slices in flight beside the one multiplied
constexpr int kLead = kSlotsW - 2;       // slices staged ahead of the one multiplied
constexpr int kAccW = kBN / 2;           // sums a thread: m64n256 f32
constexpr int kPanel = kRowsBf16 * kBK;  // bf16 values of a 32-deep panel of the tile: 128 rows of 64 bytes
constexpr int kSliceW = kBN * kBK;       // bf16 values of a weight slot: 256 rows of 64 bytes
constexpr int kStashW = kAccW / 4;       // GEMM2's first pass: packed words a thread that wait in the x ring
constexpr size_t kXRingW = sizeof(uint32_t) * kStashW * kThreadsBf16;  // the x ring, then the stash
static_assert(kThreadsBf16 == 2 * 128 && kRowsBf16 == 2 * 64, "two warpgroups, each a wgmma M of rows");
static_assert(kBK * sizeof(bf16) == 64, "a slice row is one 64-byte swizzle row (sw64_desc_lo)");
static_assert(sizeof(bf16) * kSlotsW * kPanel <= kXRingW, "the x ring's slots fit the stash's region");

// One region h [H / 32][128][32] holds h1, then h2, as 32-deep panels (row r
// at 64 bytes, its 16-byte chunk c at (c ^ bits 1-2 of r) * 16, the 64-byte
// swizzle that sw64_desc_lo reads), then the weight ring ws [4][256][32] of
// rows swizzled the same way, both on 1024-byte boundaries; the x ring xs
// [4][128][32] (swizzled as the panels), which after GEMM1 (until the next
// tile's) holds half of GEMM2's stash [kStashW][threads], then the scores s
// [128][2] and e [128][2]; stat (max[2], denom[2], corr[2]). The running acc
// [2][H] is the block's own slot of part_acc in device memory (each thread
// its own entries), and Wc is read from there too (3 KB, cached).
struct LayoutBf16 {
  size_t h, ws, xs, stat, total;
};

__host__ __device__ inline LayoutBf16 layout_bf16(int H) {
  LayoutBf16 L;
  size_t o = 0;
  L.h = o;    o = align1024(o + sizeof(bf16) * kRowsBf16 * H);
  L.ws = o;   o = align1024(o + sizeof(bf16) * kSlotsW * kSliceW);
  L.xs = o;   o = align16(o + kXRingW);
  L.stat = o; o = align16(o + sizeof(float) * 8);
  L.total = o;
  return L;
}

// d[64 x 256] (+)= a[64 x 16] . b[256 x 16]^T, both K-major in shared
// memory through their descriptors; scale_d = 0 writes the products over d
__device__ __forceinline__ void wgmma_bf16(float (&d)[kAccW], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  static_assert(kAccW == 128, "the operand list is m64n256k16's");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Slice k0..k0+31 of weight rows n0..n0+255 into a ring slot (row n at byte
// 64n, its 16-byte chunk c at (c ^ bits 1-2 of n) * 16; thread t copies chunk
// t % 4 of rows t / 4 + 64j) and (kFromX) the tile's 128 x rows' k0..k0+31
// into an x slot, swizzled the same way (rows past the bag's end N
// zero-filled), in 16-byte copies; commits one group.
template <bool kFromX>
__device__ __forceinline__ void stage_bf16(const bf16* __restrict__ wt, int K, int n0, int k0, bf16* ws,
                                           const bf16* __restrict__ xb, int N, int D, int row0, bf16* xs) {
  const int t = threadIdx.x;
  const int unit = 4 * (t >> 2) + ((t & 3) ^ ((t >> 3) & 3));  // bits 1-2 of the row are bits 3-4 of t
  const bf16* src = wt + (size_t)(n0 + (t >> 2)) * K + k0 + (t & 3) * 8;
#pragma unroll
  for (int j = 0; j < kBN / 64; ++j)
    cp_async16(reinterpret_cast<uint4*>(ws) + unit + 256 * j, src + (size_t)64 * j * K, 16);
  if (kFromX) {
#pragma unroll
    for (int j = 0; j < kRowsBf16 / 64; ++j) {
      const int r = (t >> 2) + 64 * j;
      const bool ok = row0 + r < N;
      cp_async16(reinterpret_cast<uint4*>(xs) + unit + 256 * j,
                 ok ? xb + (size_t)(row0 + r) * D + k0 + (t & 3) * 8 : xb, ok ? 16 : 0);
    }
  }
  cp_async_commit();
}

// acc = A[128, K] . Wt[n0 : n0 + 256, K]^T, each warpgroup its 64 rows: A
// the staged x tile (kFromX) or h's panels, the weights through the 4-slot
// ring. Each 32-deep slice is two wgmmas (k16 halves, the second 32 bytes
// into each swizzled row), committed as one group; the warpgroup then waits
// for the slice before it only, so one slice's products run while the next
// is issued. A slot (weights and x) is refilled two slices after its
// products were issued, behind the barrier that follows every warpgroup's
// wait for them. Each output is the sum of its k16 products in ascending k.
template <bool kFromX>
__device__ __forceinline__ void gemm_wgmma(float (&acc)[kAccW], const bf16* __restrict__ wt, int K, int n0,
                                           const bf16* h, const bf16* __restrict__ xb, int N, int D, int row0,
                                           bf16* ws, bf16* xs) {
  const int a_rows = (threadIdx.x >> 7) * 64 * kBK;  // this warpgroup's 64 rows of a panel
  const int n_steps = K / kBK;
  auto issue = [&](int step) {
    if (step < n_steps)
      stage_bf16<kFromX>(wt, K, n0, step * kBK, ws + (step % kSlotsW) * kSliceW, xb, N, D, row0,
                         xs + (step % kSlotsW) * kPanel);
    else
      cp_async_commit();  // empty group: keeps one group per step for the wait count
  };
  // the ring is free (every warpgroup's products of the last pass are done),
  // and the previous epilogue's writes to h are seen by the tensor cores,
  // once every warp has arrived here
  fence_async_smem();
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kLead; ++s) issue(s);
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kLead - 1>();  // this thread's copies of `step` have landed
    fence_async_smem();          // ... and are seen by the tensor cores' reads
    __syncthreads();             // everyone's have, and every warpgroup's products of step - 2 are done
    issue(step + kLead);         // into their slot
    const int slot = step % kSlotsW;
    const uint32_t la = sw64_desc_lo((kFromX ? xs + slot * kPanel : h + step * kPanel) + a_rows);
    const uint32_t lb = sw64_desc_lo(ws + slot * kSliceW);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_bf16(acc, (uint64_t)kDescHi << 32 | (la + kk * kHalfDesc), (uint64_t)kDescHi << 32 | (lb + kk * kHalfDesc),
                 step | kk);  // the pass's first product starts the sums
    wgmma_commit();
    wgmma_wait<1>();  // the products of step - 1 are done
  }
  wgmma_wait<0>();
}

// The ReLU epilogue of columns n0..n0+255: each pair bf16(relu(acc + bias))
// of the thread's row hf, columns n0 + 8j + 2q (+1), packed and handed to
// put(j, hf, pair) as soon as it is made (so no array of them is live)
template <typename Put>
__device__ __forceinline__ void relu_pairs(const float (&acc)[kAccW], const float* __restrict__ bias, int n0,
                                           Put&& put) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kAccW / 4; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + n0 + 8 * j + 2 * q));
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(fmaxf(acc[4 * j + 2 * hf] + b.x, 0.f), fmaxf(acc[4 * j + 2 * hf + 1] + b.y, 0.f));
      put(j, hf, *reinterpret_cast<const uint32_t*>(&v));
    }
  }
}

// Stores the thread's pairs of a pass at n0 into h's panels: pair (j, hf)
// sits in panel n0 / 32 + j / 4, chunk j % 4 of its row, which bits 1-2 of
// the thread's rows (those of g) swizzle alike
struct PanelPut {
  bf16* p;
  int sw;
  __device__ __forceinline__ PanelPut(bf16* h, int n0) {
    const int tid = fresh_tid(), lane = tid & 31;
    p = h + (n0 / kBK) * kPanel + (16 * (tid >> 5) + (lane >> 2)) * kBK + 2 * (lane & 3);
    sw = (lane >> 3) & 3;
  }
  __device__ __forceinline__ void operator()(int j, int hf, uint32_t v) const {
    *reinterpret_cast<uint32_t*>(p + 8 * hf * kBK + (j >> 2) * kPanel + (((j & 3) ^ sw) << 3)) = v;
  }
};

// acc[2][H] = acc * corr + e^T h2 over the tile's 128 rows, as
// online_accumulate sums it (fmaf over the rows in order), h2 in its panels
__device__ __forceinline__ void accumulate_panels(float* acc, const float* e_s, const float* stat, const bf16* h,
                                                  int H) {
  for (int i = fresh_tid(); i < 2 * H; i += kThreadsBf16) {
    const int t = i >= H, c = i - t * H, chunk = (c >> 3) & 3;
    const bf16* col = h + (c >> 5) * kPanel + (c & 7);
    float a = acc[i] * stat[4 + t];
    for (int r0 = 0; r0 < kRowsBf16; r0 += 8)
#pragma unroll
      for (int u = 0; u < 8; ++u)
        a = fmaf(e_s[2 * (r0 + u) + t], __bfloat162float(col[(r0 + u) * kBK + ((chunk ^ (u >> 1)) << 3)]), a);
    acc[i] = a;
  }
}

// The gate epilogue of interleaved [Wa|Wb] columns n0..n0+255: register group
// 8m + ni (ni < 4) holds u_j and group 8m + ni + 4 v_j (32 columns further)
// for j = n0/2 + 32m + 8ni + 2q (+1). gated_j = bf16(tanh(u_j) sigmoid(v_j))
// (the TPU kernel's rounding point) is folded into the thread's partial
// scores sacc[hf][t] += gated_j Wc[j][t]; it never reaches shared memory.
__device__ __forceinline__ void gate_fold(const float (&acc)[kAccW], const float* __restrict__ bias,
                                          const bf16* __restrict__ wc_g, int n0, float (&sacc)[2][2]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int cu = n0 + 64 * m + 8 * ni + 2 * q;  // u columns cu, cu + 1; v is 32 further
      const float2 bu = __ldg(reinterpret_cast<const float2*>(bias + cu));
      const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + cu + 32));
      // Wc[j][0], Wc[j][1], Wc[j + 1][0], Wc[j + 1][1]
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(wc_g) + (n0 / 2 + 32 * m + 8 * ni + 2 * q) / 2);
      const float2 w[2] = {__bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x)),
                           __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y))};
      const int ru = 4 * (8 * m + ni), rv = ru + 16;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float gv = bf16_round(gate<kEpiTanh>(acc[ru + 2 * hf + e] + (e ? bu.y : bu.x),
                                                     acc[rv + 2 * hf + e] + (e ? bv.y : bv.x)));
          sacc[hf][0] = fmaf(gv, w[e].x, sacc[hf][0]);
          sacc[hf][1] = fmaf(gv, w[e].y, sacc[hf][1]);
        }
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
  extern __shared__ __align__(1024) unsigned char smem[];
  const LayoutBf16 L = layout_bf16(H);
  bf16* h = reinterpret_cast<bf16*>(smem + L.h);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  float* s_s = reinterpret_cast<float*>(smem + L.xs);    // [R][2] raw scores
  float* e_s = s_s + R * 2;                                // [R][2] e rounded to bf16
  float* stat = reinterpret_cast<float*>(smem + L.stat);  // max[2], denom[2], corr[2]

  const int tid = threadIdx.x;
  const int shard = blockIdx.x / n_splits, split = blockIdx.x - shard * n_splits, b = blockIdx.y;
  const bf16* xb = x + (size_t)b * x_bag + (size_t)shard * N * D;  // the shard's N rows
  const float* mb = mask + (size_t)b * m_bag + (size_t)shard * N;
  const size_t p = (size_t)b * gridDim.x + blockIdx.x;
  float* acc_g = part_acc + p * 2 * H;  // the running acc [2][H], entries tid + k * threads this thread's

  for (int i = tid; i < 2 * H; i += kThreadsBf16) acc_g[i] = 0.f;
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

    float acc[kAccW];
    // h1 = relu(x W1 + b1) -> h
    for (int n0 = 0; n0 < H; n0 += kBN) {
      gemm_wgmma<true>(acc, w1t, D, n0, nullptr, xb, N, D, row0, ws, xs);
      relu_pairs(acc, b1, n0, PanelPut(h, n0));
    }
    // h2 = relu(h1 W2 + b2) -> h, over h1: at H = 512 the first pass waits
    // packed until the second has read all of h1 (the stash), columns 8j.. of
    // j < 16 in the x ring (stash_s [kStashW][threads], idle in GEMM2), the
    // rest in registers; they go to h after the barrier that ends the
    // second pass's reads, before its own pairs are made
    constexpr int kHalf = kAccW / 8;
    uint32_t stash[kHalf][2];
    uint32_t* stash_s = reinterpret_cast<uint32_t*>(xs);
    if (H == 2 * kBN) {
      gemm_wgmma<false>(acc, w2t, H, 0, h, nullptr, N, D, row0, ws, xs);
      const int t2 = fresh_tid();
      relu_pairs(acc, b2, 0, [&](int j, int hf, uint32_t v) {
        if (j < kHalf)
          stash_s[(2 * j + hf) * kThreadsBf16 + t2] = v;
        else
          stash[j % kHalf][hf] = v;
      });
    }
    gemm_wgmma<false>(acc, w2t, H, H - kBN, h, nullptr, N, D, row0, ws, xs);
    __syncthreads();
    if (H == 2 * kBN) {
      const PanelPut put(h, 0);
      const int t2 = fresh_tid();
#pragma unroll
      for (int j = 0; j < kHalf; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          put(j, hf, stash_s[(2 * j + hf) * kThreadsBf16 + t2]);
          put(kHalf + j, hf, stash[j][hf]);
        }
    }
    relu_pairs(acc, b2, H - kBN, PanelPut(h, H - kBN));
    // gated = bf16(tanh(h2 Wa + ba) * sigmoid(h2 Wb + bb)), folded into the scores
    float sacc[2][2] = {};
    for (int n0 = 0; n0 < 2 * A; n0 += kBN) {
      gemm_wgmma<false>(acc, wabt, H, n0, h, nullptr, N, D, row0, ws, xs);
      gate_fold(acc, bab, wc, n0, sacc);
    }
    // s = gated Wc + bc: each row's sum over its quad (the x ring is idle
    // until the next tile's GEMM1, past two barriers)
    {
      const int t2 = fresh_tid(), lane = t2 & 31;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          sacc[hf][t] += __shfl_xor_sync(0xffffffffu, sacc[hf][t], 1);
          sacc[hf][t] += __shfl_xor_sync(0xffffffffu, sacc[hf][t], 2);
        }
      if ((lane & 3) == 0)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * (t2 >> 5) + (lane >> 2) + 8 * hf;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const float s = sacc[hf][t] + __ldg(bc + t);
            s_s[2 * r + t] = s;
            if (scores != nullptr && row0 + r < N) scores[((size_t)b * 2 + t) * N + row0 + r] = s;
          }
        }
    }
    __syncthreads();

    online_stats<R, bf16>(s_s, mb, row0, N, e_s, stat);
    __syncthreads();
    accumulate_panels(acc_g, e_s, stat, h, H);
  }
  __syncthreads();

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
    // the tail's scratch lies in the dead h region and rings
    if (sizeof(float) * tail_scratch_floats(2, n_shards * n_splits) > L.stat) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(pool_kernel_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (err != cudaSuccess) return (int)err;
    pool_kernel_bf16<<<dim3(n_shards * n_splits, B), kThreadsBf16, L.total, stream>>>(
        static_cast<const bf16*>(x), mask, x_bag, m_bag, N, D, H, A,
        static_cast<const bf16*>(w1t), b1, static_cast<const bf16*>(w2t), b2,
        static_cast<const bf16*>(wabt), bab, static_cast<const bf16*>(wc), bc,
        tiles_per_split, n_splits, scores, part_acc, part_stat, tickets, eps, out, stat_out);
  } else {
    const LayoutF32 L = layout_f32(H);
    // the tail's scratch lies in the dead h region
    if (sizeof(float) * tail_scratch_floats(2, n_shards * n_splits) > L.ws) return (int)cudaErrorInvalidValue;
    auto kernel = H == kBN ? pool_kernel_f32<kBN / 2> : pool_kernel_f32<kBN>;
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
