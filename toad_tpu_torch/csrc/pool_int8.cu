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
// The products are int8 wgmma (m64nNk32, s8 x s8 -> s32), both operands
// K-major in shared memory through descriptors; the 8 warps are two
// warpgroups. A row's scale needs the amax of all H = 512 columns before any
// element can be quantized, so each trunk GEMM is one pass over them:
// warpgroup wg owns columns 256 wg .. 256 wg + 255 of all 64 rows, one
// m64n256k32 accumulator of 128 int32 sums a thread (a row pair over the
// warpgroup's 256 columns). That fixes the tile at 64 rows. The gate GEMM
// runs in passes of 256 interleaved [Wa|Wb] columns, 128 a warpgroup
// (m64n128k32): the groups of 32 leave u_j and v_j of one j in one thread,
// whose epilogue folds the gated values into partial scores in registers,
// so the gated tile never reaches shared memory; a row's score is its
// quad's sum, then the two warpgroups' sum, then bc.
//
// The weights reach the tile as one stream: every tile stages the same fixed
// sequence of 32 KB slices, D/64 of W1 (512 rows x 64 B, each with the x
// tile's 64 rows x 64 B), 8 of W2 (512 x 64 B) and 2A/256 passes x 4 of
// [Wa|Wb] (256 interleaved rows x 128 B), through one 3-slot cp.async ring
// and one step counter that carry on across the GEMMs and into the next
// tile. So the first two slices of each GEMM are in flight during the
// epilogue before it (the requantizations, the scores, the online softmax).
// The slots hold their rows without padding in the swizzles wgmma's
// descriptors read (wgmma.cuh): trunk and x slices of 64-byte rows in the
// 64-byte swizzle, gate slices of 128-byte rows in the 128-byte one. h1q and
// h2q are stored as 8 panels of 64 rows x 64 B in the 64-byte swizzle, GEMM2's
// and the gate's A operand. Each step waits for its slice (a barrier),
// issues the slice's products, waits for its warpgroup's products of the
// slice before and, behind a second barrier, refills that slice's slot with
// the slice two ahead: so with 3 slots two slices are in flight and one
// slice's products run on through the next step's barriers and copies. (A
// fourth slot does not fit beside h2 and the panels; one made room for by
// keeping half of h2 in registers through the gate was no faster, PERF.md
// §6.) The epilogues and the copies compute their addresses where they run,
// from fresh_tid (wgmma.cuh): kept in registers through the products, they
// spilled. The plan (rows, threads,
// slots, shared memory) is ops/cuda_pool_int8.plan, the slice sequence its
// stream_schedule; the grid fills whole waves of one CTA an SM
// (cuda_pool.wave_split_plan), and each launch ends in its own merge
// (pool_tail, pool_common.cuh): every block writes its partial and draws a
// ticket of its bag, the last merges.
//
// The requantization quantizes with the row's reciprocal: v * (1/scale)
// and two Newton steps on the remainder, all fma, give the IEEE quotient
// itself, so the int8 values are the JAX quantizer's without a division or
// a branch per value (quant_row in pool_trunk.cuh; an IEEE division per
// value took 38 % of the time of a kernel that had it, PERF.md §6). Each
// row's amax is reduced over its quad of lanes and then over the two
// warpgroups through a [2][64] scratch, one ordered max and no atomics. The
// warp layout, not the stream, fixes the f32 order of every sum that is not
// an integer product, so the scores do not depend on the split, and M only
// by the rounding of e to bf16 against each run's running max.
//
// What bounds it now: PERF.md §6 (the ablation builds below, timed by
// chip_smoke.py --k2-ablations). The int8 pass on mma.sync in pool_trunk.cuh
// is the int8 probe's (csrc/pool_int8_probe.cu). No TMA or warp
// specialisation.
//
// Layout contract (the Python wrapper ops/cuda_pool_int8.py prepares it):
//   xq [B, N, D] int8, sx [B, N] and mask [B, N] f32; int8 weights in
//   nn.Linear layout [out, in] with f32 per-output scales and biases; the 2A
//   rows of [Wa|Wb]q (and their scales and biases) interleaved in groups of
//   32 as for K1; Wc [A, 2] bf16, bc [2] f32; H == 512.

#include "pool_trunk.cuh"
#include "wgmma.cuh"

// A build that leaves one part out, to time the rest (chip_smoke.py
// --k2-ablations): 1 no products, 2 no weight copies, 3 the requantization
// a saturating cast (kReqNone). 0, the kernel, otherwise.
#ifndef TOAD_K2_ABLATE
#define TOAD_K2_ABLATE 0
#endif

namespace {

constexpr int kR8 = kTileRows;          // rows per tile: one wgmma M
constexpr int kH8 = kTrunkH;            // trunk width: one GEMM pass covers a whole row
constexpr int kWgCols = kH8 / 2;        // trunk columns a warpgroup: m64n256k32
constexpr int kAcc8 = kWgCols / 2;      // its int32 sums a thread
constexpr int kGateWg = kGateCols / 2;  // gate columns a warpgroup a pass: m64n128k32
constexpr int kAccG = kGateWg / 2;      // its int32 sums a thread
constexpr int kPanel8 = kR8 * kBK8;     // bytes of a 64-deep panel of the tile (an x slot, one of h1q's 8)
constexpr int kAblate = TOAD_K2_ABLATE;
constexpr int kReq8 = kAblate == 3 ? kReqNone : kReqF32;
static_assert(kThreads == 2 * 128 && kAcc8 == 128 && kAccG == 64, "two warpgroups, the operand lists' widths");
static_assert(kXSlot8 == kPanel8, "an x slot is one panel");

// The weight ring ws [3][32 KB] and the x ring xs [3][64][64 B] (both
// swizzled), h1q/h2q as 8 panels [64][64 B], each on a 1024-byte boundary;
// h2 [64][520] bf16 for the pooling; Wc [A][2] in f32, the row scales, each
// warpgroup's row amax [2][64] and partial scores [2][64][2], s, e, the
// running acc [2][H] and the stats (max[2], denom[2], corr[2]). At the
// launch's end the rings hold pool_tail's scratch.
struct Layout8 {
  size_t ws, xs, panels, h2, wc, rs, wg_amax, wg_spart, s, e, acc, stat, total;
};

__host__ __device__ inline Layout8 layout8(int A) {
  Layout8 L;
  size_t o = 0;
  L.ws = o;    o = align1024(o + (size_t)kRing8 * kSlot8);
  L.xs = o;    o = align1024(o + (size_t)kRing8 * kXSlot8);
  L.panels = o; o = align1024(o + (size_t)kR8 * kH8);
  L.h2 = o;    o = align16(o + sizeof(bf16) * kR8 * kLdH2);
  L.wc = o;    o = align16(o + sizeof(float) * 2 * A);
  L.rs = o;    o = align16(o + sizeof(float) * kR8);
  L.wg_amax = o; o = align16(o + sizeof(float) * 2 * kR8);
  L.wg_spart = o; o = align16(o + sizeof(float) * 2 * kR8 * 2);
  L.s = o;     o = align16(o + sizeof(float) * 2 * kR8);
  L.e = o;     o = align16(o + sizeof(float) * 2 * kR8);
  L.acc = o;   o = align16(o + sizeof(float) * 2 * kH8);
  L.stat = o;  o = align16(o + sizeof(float) * 8);
  L.total = o;
  return L;
}

// d[64 x 256] += a[64 x 32 B] . b[256 x 32 B]^T, int8 with int32 sums, both
// K-major in shared memory through their descriptors. (Integer wgmma has no
// transpose and no operand scales.)
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[kAcc8], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[64 x 128] += a[64 x 32 B] . b[128 x 32 B]^T, as wgmma_s8_n256
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[kAccG], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Slice s of a tile's stream into weight slot wslot (and, for W1, x slot xslot):
//   s < n1:      W1 rows 0..511, bytes 64 s.. (and the tile's 64 x rows' same
//                bytes, rows past N zero-filled);
//   s < n1 + 8:  W2 rows 0..511, bytes 64 (s - n1)..;
//   else j = s - n1 - 8: [Wa|Wb] rows 256 (j / 4).., bytes 128 (j % 4)...
// Rows of 64 bytes in the 64-byte swizzle: thread t copies chunk t % 4 of
// rows t / 4 + 64 i, 16-byte unit 4 (t / 4) + (t % 4 ^ bits 1-2 of the row)
// + 256 i. Gate rows of 128 bytes in the 128-byte swizzle (swz). Commits
// nothing. (Its addresses are computed where it runs, from fresh_tid: kept
// in registers through the tile, they spilled.)
__device__ __forceinline__ void stage8(int s, int n1, int row0, const u8* __restrict__ w1, int D,
                                       const u8* __restrict__ w2, const u8* __restrict__ wab,
                                       const u8* __restrict__ xb, int N, u8* wslot, u8* xslot) {
  const int t = fresh_tid();
  if (s < n1 + kW2Slices) {
    const bool first = s < n1;
    const int kb = first ? D : kH8;
    const u8* src = (first ? w1 + s * kBK8 : w2 + (s - n1) * kBK8) + (size_t)(t >> 2) * kb + (t & 3) * 16;
    uint4* dst = reinterpret_cast<uint4*>(wslot) + 4 * (t >> 2) + ((t & 3) ^ ((t >> 3) & 3));
    if (kAblate != 2) {
#pragma unroll
      for (int i = 0; i < kSlot8 / (kThreads * 16); ++i) cp_async16(dst + 256 * i, src + (size_t)64 * i * kb, 16);
    }
    if (first) {
      const int r = t >> 2;
      const bool ok = row0 + r < N;
      cp_async16(reinterpret_cast<uint4*>(xslot) + 4 * r + ((t & 3) ^ ((t >> 3) & 3)),
                 ok ? xb + (size_t)(row0 + r) * D + s * kBK8 + (t & 3) * 16 : xb, ok ? 16 : 0);
    }
  } else if (kAblate != 2) {
    const int j = s - n1 - kW2Slices;
    const u8* wt = wab + (size_t)(j / kGateSlices) * kGateCols * kH8 + (j % kGateSlices) * kGateBK8;
    const int off = swz(16 * t);  // this thread's chunk in each 4 KB of the slot
#pragma unroll
    for (int i = 0; i < 8; ++i)
      cp_async16(wslot + off + 4096 * i, wt + (size_t)((t >> 3) + 32 * i) * kH8 + (t & 7) * 16, 16);
  }
}

// acc += A[64, 64 B] . W[256 wg .. 256 wg + 255, 64 B]^T for one trunk
// slice and this thread's warpgroup wg: two k32 wgmmas (the second 32 bytes
// into each row), A the x slot or an h1q panel and the warpgroup's 256
// weight rows, both in the 64-byte swizzle, committed as one group
__device__ __forceinline__ void trunk_wgmma(int (&acc)[kAcc8], const u8* a, const u8* wslot) {
  if (kAblate == 1) return;
  const uint32_t la = sw64_desc_lo(a);
  const uint32_t lb = sw64_desc_lo(wslot + (threadIdx.x >> 7) * kWgCols * kBK8);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    wgmma_s8_n256(acc, wgmma_desc(la + kk * kHalfDesc, kDescHi), wgmma_desc(lb + kk * kHalfDesc, kDescHi));
  wgmma_commit();
}

// acc += h2q[64, bytes 128 s .. 128 s + 127] . W[128 wg .. 128 wg + 127 of
// the pass, 128 B]^T for gate slice s: four k32 wgmmas, A from h2q's panels
// 2s and 2s + 1 (64-byte swizzle), B the warpgroup's 128 gate rows (128-byte
// swizzle), committed as one group
__device__ __forceinline__ void gate_wgmma(int (&acc)[kAccG], const u8* act, int s, const u8* wslot) {
  if (kAblate == 1) return;
  const uint32_t la = sw64_desc_lo(act + 2 * s * kPanel8);
  const uint32_t lb = sw64_desc_lo(wslot + (threadIdx.x >> 7) * kGateWg * kGateBK8);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_s8_n128(acc, wgmma_desc(la + (kk >> 1) * (kPanel8 / 16) + (kk & 1) * kHalfDesc, kDescHi),
                  wgmma_desc(lb + kk * kHalfDesc, kDescHi128));
  wgmma_commit();
}

// The rows of this thread in wgmma's accumulator layout: warp w of its
// warpgroup holds rows 16 w + g and 16 w + g + 8 (g = lane / 4), and register
// 4j + 2hf + e is row 16 w + g + 8 hf, column 8j + 2q + e of the warpgroup's
// columns (q = lane % 4)
__device__ __forceinline__ int acc_row0(int tid) { return 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2); }

// Trunk epilogue over all 512 columns: h = relu(dequant(acc)), (kToH2) h2
// rounded to bf16 for the pooling, then the row quantizer into act's panels
// and the rows' scales into rs. Each row's amax: the max over its quad of
// lanes, each warpgroup's into amax_s [2][64], and after one barrier the max
// of the two in order (no atomics); the values are quantized from registers
// into act, in place of the GEMM's own input (every warpgroup has waited for
// its products before it arrives here).
template <int kReq, bool kToH2>
__device__ __forceinline__ void requant8(const int (&acc)[kAcc8], const float* __restrict__ s_col,
                                         const float* __restrict__ bias, float* rs, float* amax_s, u8* act,
                                         bf16* h2) {
  const int tid = fresh_tid(), lane = tid & 31, wg = tid >> 7, q = lane & 3;
  const int r0 = acc_row0(tid), c0 = kWgCols * wg + 2 * q;
  const float s_row[2] = {rs[r0], rs[r0 + 8]};
  float v[kAcc8], mx[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kAcc8 / 4; ++j) {
    const int col = c0 + 8 * j;
    const float2 sc = __ldg(reinterpret_cast<const float2*>(s_col + col));
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float h0 = fmaxf(dequant(acc[4 * j + 2 * hf], s_row[hf], sc.x, bb.x), 0.f);
      const float h1 = fmaxf(dequant(acc[4 * j + 2 * hf + 1], s_row[hf], sc.y, bb.y), 0.f);
      v[4 * j + 2 * hf] = h0;
      v[4 * j + 2 * hf + 1] = h1;
      mx[hf] = fmaxf(mx[hf], fmaxf(h0, h1));
      if (kToH2)
        *reinterpret_cast<__nv_bfloat162*>(h2 + (r0 + 8 * hf) * kLdH2 + col) = __floats2bfloat162_rn(h0, h1);
    }
  }
  if (kReq != kReqNone) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      if (q == 0) amax_s[wg * kR8 + r0 + 8 * hf] = mx[hf];
    }
  }
  // every row's amax is known, and every warp has finished reading rs
  __syncthreads();
  // column c0 + 8j of the thread's rows: panel 4 wg + j / 8, byte 8 (j % 8) + 2q of its row, i.e. chunk
  // (j % 8) / 2, which bits 1-2 of the row (those of g) swizzle
  const int sw = (lane >> 3) & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + 8 * hf;
    const float amax = kReq == kReqNone ? 0.f : fmaxf(amax_s[row], amax_s[kR8 + row]);
    const float scale = row_scale<kReq>(amax);
    const float inv = row_inv<kReq>(amax, scale);
    u8* dst = act + 4 * wg * kPanel8 + row * kBK8 + 2 * q;
#pragma unroll
    for (int j = 0; j < kAcc8 / 4; ++j) {
      const int q0 = quant<kReq>(v[4 * j + 2 * hf], scale, inv);
      const int q1 = quant<kReq>(v[4 * j + 2 * hf + 1], scale, inv);
      *reinterpret_cast<uint16_t*>(dst + (j >> 3) * kPanel8 + ((((j & 7) >> 1) ^ sw) << 4) + 8 * (j & 1)) =
          static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
    }
    if (wg == 0 && q == 0) rs[row] = scale;
  }
}

// The gate epilogue of one pass over interleaved [Wa|Wb] columns n0..n0+255:
// the warpgroup's columns n0 + 128 wg.. are groups 2 wg and 2 wg + 1 of 32 u
// then 32 v columns, so register group 8m + ni (ni < 4) holds u_j and group
// 8m + ni + 4 v_j for j = n0 / 2 + 64 wg + 32 m + 8 ni + 2q (+1).
// gated_j = bf16(tanh(u_j) sigmoid(v_j)) is folded into the thread's partial
// scores sacc[hf][t] += gated_j Wc[j][t] (Wc in f32 in shared memory). (A
// fold of one pass under the next pass's products, in a second accumulator,
// made ptxas serialize every wgmma: C7514.)
__device__ __forceinline__ void gate_fold8(const int (&acc)[kAccG], int n0, const float* rs,
                                           const float* __restrict__ swab, const float* __restrict__ bab,
                                           const float* wc_s, float (&sacc)[2][2]) {
  const int tid = fresh_tid(), wg = tid >> 7, q = tid & 3, r0 = acc_row0(tid);
  const float s_row[2] = {rs[r0], rs[r0 + 8]};
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int cu = n0 + kGateWg * wg + 64 * m + 8 * ni + 2 * q;  // u columns cu, cu + 1; v is 32 further
      const int j = (n0 + kGateWg * wg) / 2 + 32 * m + 8 * ni + 2 * q;
      const float2 su = __ldg(reinterpret_cast<const float2*>(swab + cu));
      const float2 sv = __ldg(reinterpret_cast<const float2*>(swab + cu + 32));
      const float2 bu = __ldg(reinterpret_cast<const float2*>(bab + cu));
      const float2 bv = __ldg(reinterpret_cast<const float2*>(bab + cu + 32));
      const float4 w = *reinterpret_cast<const float4*>(wc_s + 2 * j);  // Wc[j][0..1], Wc[j + 1][0..1]
      const int ru = 4 * (8 * m + ni), rv = ru + 16;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float u = dequant(acc[ru + 2 * hf + e], s_row[hf], e ? su.y : su.x, e ? bu.y : bu.x);
          const float vv = dequant(acc[rv + 2 * hf + e], s_row[hf], e ? sv.y : sv.x, e ? bv.y : bv.x);
          const float gv = bf16_round(gate<kEpiTanh>(u, vv));
          sacc[hf][0] = fmaf(gv, e ? w.z : w.x, sacc[hf][0]);
          sacc[hf][1] = fmaf(gv, e ? w.w : w.y, sacc[hf][1]);
        }
    }
}

// e^T h2 over the tile's 64 rows into the running acc [2][H]: each output
// acc * corr, then fmaf over the rows in order, as online_accumulate sums it;
// thread tid takes columns 2 tid and 2 tid + 1 of both tasks, so that a row's
// two h2 values and two e values are one load each
__device__ __forceinline__ void accumulate8(float* acc_s, const float* e_s, const float* stat, const bf16* h2) {
  const int c = 2 * fresh_tid();
  float a[2][2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int k = 0; k < 2; ++k) a[t][k] = acc_s[t * kH8 + c + k] * stat[4 + t];
  for (int r = 0; r < kR8; ++r) {
    const float2 e = *reinterpret_cast<const float2*>(e_s + 2 * r);
    const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h2 + r * kLdH2 + c));
    a[0][0] = fmaf(e.x, h.x, a[0][0]);
    a[0][1] = fmaf(e.x, h.y, a[0][1]);
    a[1][0] = fmaf(e.y, h.x, a[1][0]);
    a[1][1] = fmaf(e.y, h.y, a[1][1]);
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int k = 0; k < 2; ++k) acc_s[t * kH8 + c + k] = a[t][k];
}

// s = each row's partial scores summed over its quad, then warpgroup 0's
// plus warpgroup 1's, then bc (a fixed order), into s_s [64][2]; where
// scores is not null, also the raw scores [B][2][N] of the tile's rows
// inside the bag
__device__ __forceinline__ void scores8(float (&sacc)[2][2], float* spart, const float* __restrict__ bc,
                                        float* s_s, float* scores, int b, int N, int row0) {
  const int tid = fresh_tid(), wg = tid >> 7, r0 = acc_row0(tid);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float v = sacc[hf][t];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((tid & 3) == 0) spart[(wg * kR8 + r0 + 8 * hf) * 2 + t] = v;
    }
  __syncthreads();
  if (tid < 2 * kR8) {
    const int r = tid >> 1, t = tid & 1;
    float s = spart[tid];
    s += spart[2 * kR8 + tid];
    s += __ldg(bc + t);
    s_s[tid] = s;
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
                 const bf16* __restrict__ wc, const float* __restrict__ bc, int tiles_per_split,
                 float* __restrict__ scores, float* __restrict__ part_acc, float* __restrict__ part_stat,
                 int* __restrict__ tickets, float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout8 L = layout8(A);
  u8* ws = smem + L.ws;
  u8* xs = smem + L.xs;
  u8* act = smem + L.panels;
  bf16* h2 = reinterpret_cast<bf16*>(smem + L.h2);
  float* wc_s = reinterpret_cast<float*>(smem + L.wc);
  float* rs = reinterpret_cast<float*>(smem + L.rs);
  float* amax_s = reinterpret_cast<float*>(smem + L.wg_amax);
  float* spart = reinterpret_cast<float*>(smem + L.wg_spart);
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
      stage8(p_s, n1, p_tile * kR8, w1, D, w2, wab, xb, N, ws + p_slot * kSlot8, xs + p_slot * kXSlot8);
    cp_async_commit();  // one group a slice, empty past the last tile: the wait count holds
    p_slot = p_slot == kRing8 - 1 ? 0 : p_slot + 1;
    if (++p_s == n_slices) {
      p_s = 0;
      p_tile = next;
    }
  };
  // waits for the consumers' next slice and returns its slot
  auto take = [&]() {
    cp_async_wait<kRing8 - 2>();  // this thread's copies of the slice have landed
    fence_async_smem();           // ... and they and its stores are seen by the tensor cores
    __syncthreads();              // everyone's are
    const int slot = c_slot;
    c_slot = c_slot == kRing8 - 1 ? 0 : c_slot + 1;
    return slot;
  };
  // after a slice's products are issued: once every warpgroup's products of
  // the slice before are done, the slice two ahead goes into that slot (so
  // the products of one slice run on through this barrier and the next)
  auto refill = [&]() {
    wgmma_wait<1>();
    __syncthreads();
    issue();
  };
#pragma unroll
  for (int i = 0; i < kRing8 - 1; ++i) issue();

  while (tile < t_end) {
    next = next_tile(tile);  // before the cursor wraps, n_slices - 3 steps on
    const int row0 = tile * kR8;
    if (tid < kR8) rs[tid] = row0 + tid < N ? sb[row0 + tid] : 0.f;  // rows past the end are zeros

    // Each GEMM's sums start from zeros written just before it, so that no
    // register of the accumulators is live from one GEMM's epilogue into the
    // next GEMM (the products read them)
    int acc[kAcc8];
    // h1 = relu(dequant(xq W1q)) -> act (int8 panels), rs <- its row scales
#pragma unroll
    for (int i = 0; i < kAcc8; ++i) acc[i] = 0;
    for (int s = 0; s < n1; ++s) {
      const int slot = take();
      trunk_wgmma(acc, xs + slot * kXSlot8, ws + slot * kSlot8);
      refill();
    }
    wgmma_wait<0>();
    requant8<kReq8, false>(acc, sw1, b1, rs, amax_s, act, nullptr);
    // h2 = relu(dequant(h1q W2q)) -> h2 (bf16) and act (int8 panels), rs <- its row scales
#pragma unroll
    for (int i = 0; i < kAcc8; ++i) acc[i] = 0;
    for (int s = 0; s < kW2Slices; ++s) {
      const int slot = take();
      trunk_wgmma(acc, act + s * kPanel8, ws + slot * kSlot8);
      refill();
    }
    wgmma_wait<0>();
    requant8<kReq8, true>(acc, sw2, b2, rs, amax_s, act, h2);
    // scores from the gate, pass by pass
    float sacc[2][2] = {};
    for (int n0 = 0; n0 < 2 * A; n0 += kGateCols) {
      int accg[kAccG];
#pragma unroll
      for (int i = 0; i < kAccG; ++i) accg[i] = 0;
      for (int s = 0; s < kGateSlices; ++s) {
        const int slot = take();
        gate_wgmma(accg, act, s, ws + slot * kSlot8);
        refill();
      }
      wgmma_wait<0>();
      gate_fold8(accg, n0, rs, swab, bab, wc_s, sacc);
    }
    scores8(sacc, spart, bc, s_s, scores, b, N, row0);

    online_stats<kR8, bf16>(s_s, mb, row0, N, e_s, stat);
    __syncthreads();
    accumulate8(acc_s, e_s, stat, h2);
    tile = next;
  }
  cp_async_wait<0>();
  __syncthreads();

  const size_t p = (size_t)b * gridDim.x + split;
  for (int i = tid; i < 2 * kH8; i += kThreads) part_acc[p * 2 * kH8 + i] = acc_s[i];
  if (tid < 4) part_stat[p * 4 + tid] = stat[tid];
  // the last block of the bag merges its partials (the rings are dead: the scratch)
  pool_tail<2>(part_acc, part_stat, (size_t)b * gridDim.x, gridDim.x, tickets + b, kH8, true, 1e-30f,
               out + (size_t)b * 2 * kH8, nullptr, reinterpret_cast<float*>(smem));
}

}  // namespace

extern "C" {

int toad_pool_int8_rows_per_tile() { return kR8; }

// Dynamic shared memory of the int8 pooling kernel in bytes.
long long toad_pool_int8_smem_bytes(int A) { return (long long)layout8(A).total; }

// Launches the int8 pooling kernel on `stream`: M [B][2][H] = acc / max(denom,
// 1e-30), merged at the end of the launch, and, where scores is not null, the
// raw scores [B][2][N]. tickets holds B int32 counters, all 0 (every launch
// leaves them so). Returns the launch's cudaError_t (0 on success); does not
// synchronise.
int toad_pool_int8_forward(const void* xq, const float* sx, const float* mask, int B, int N, int D, int H, int A,
                           const void* w1t, const float* sw1, const float* b1,
                           const void* w2t, const float* sw2, const float* b2,
                           const void* wabt, const float* swab, const float* bab,
                           const void* wc, const float* bc,
                           int tiles_per_split, int n_splits,
                           float* scores, float* part_acc, float* part_stat, int* tickets, float* out, void* stream) {
  if (H != kH8 || D % kBK8 != 0 || A % (kGateCols / 2) != 0 || A > kH8) return (int)cudaErrorInvalidValue;
  const Layout8 L = layout8(A);
  // the tail's scratch lies in the dead rings
  if (sizeof(float) * tail_scratch_floats(2, n_splits) > L.panels) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(pool_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  pool_int8_kernel<<<dim3(n_splits, B), kThreads, L.total, s>>>(
      static_cast<const int8_t*>(xq), sx, mask, N, D, A,
      static_cast<const int8_t*>(w1t), sw1, b1, static_cast<const int8_t*>(w2t), sw2, b2,
      static_cast<const int8_t*>(wabt), swab, bab, static_cast<const bf16*>(wc), bc,
      tiles_per_split, scores, part_acc, part_stat, tickets, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
