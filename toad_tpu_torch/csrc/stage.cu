// One BN-folded ResNet bottleneck block, fused, hand-written for Hopper
// (sm_90a). A stage is one launch per block (3, 4 or 6 launches).
//
// Replaces experiments/pallas_stage_fusion.py::_make_stage_kernel (the TPU
// kernel KS, reached through _stage_call / fused_stage). Per image, with x
// NHWC [H, W, Cin], folded weights w1 [Cin, w], w2 [9, w, w] (taps in (dy, dx)
// row-major order), w3 [w, 4w], optional downsample wd [Cin, 4w], f32 biases:
//     h1  = relu(x . w1 + b1)                    f32 accumulate, rounded to T
//     h2  = relu(sum_taps h1[tap] . w2[tap] + b2)  3x3, pad 1, stride s; rounded
//     out = relu(h2 . w3 + b3 + skip)            skip = x, or x[::s, ::s] . wd + bd;
//                                                 all in f32, rounded once
// These are the TPU kernel's rounding points (pallas_stage_fusion.py:81-97).
//
// Why the TPU design does not carry over: the TPU kernel holds one whole
// image's stage in VMEM (grid = (B,), 100 MB limit). One image's layer1 map
// at 256 px is already 2 MiB, against a block's 227 KB of shared memory. So
// here a block owns one image and a tile of TH x TW output pixels of one
// bottleneck block, and h1, h2, h3 and the residual add stay on chip:
//   1. h1 over the tile's input halo ((s(TH-1)+3) x (s(TW-1)+3) pixels), from
//      x rows gathered out of device memory by cp.async, in passes of at most
//      `rows` halo rows; halo pixels outside the image are set to 0 after the
//      ReLU (the 3x3 conv pads h1 with zeros, not h1 of a zero-padded x,
//      which would be relu(b1)).
//   2. h2 by 9 tap GEMMs whose A rows are gathered from the h1 tile in shared
//      memory: ldmatrix takes one row address per lane, so the shifted and
//      (at stride 2) subsampled tap windows cost no copy.
//   3. h3 + skip in f32 registers, 64 output channels a pass; the downsample
//      GEMM accumulates into the same registers; ReLU, cast, store.
// Only x, the weights and out touch device memory.
//
// What bounds it on an H100: per batch of 64 tiles of 256 px, layer1's block
// inputs and outputs take longer at 3.35 TB/s than its operations at the bf16
// peak, layer2's and layer3's the other way round. But every CTA streams all
// of its block's weights (w1, the 9 taps of w2, w3, wd: up to 3 MB) and
// re-reads its x rows through 16-byte cp.async copies from L2; these loads
// and the ldmatrix/mma.sync issue, not device memory, set the pace (PERF.md
// §6). So the design cuts the bytes each CTA loads per output pixel,
// and keeps them in flight:
//   - more pixels a CTA: the plan (th x tw, the halo rows a phase-1 pass,
//     the ring's slots; ops/fused_stage.plan computes it, the launcher
//     checks it) gives layer2/3 blocks 64 or 128 output pixels a CTA.
//     Their halo lives in shared memory, not in registers: phase 1
//     runs in passes whose A staging shares h2's region (h2 is not written
//     yet), phase 3's downsample shares h1's (h1 is dead after phase 2);
//   - the downsample's A rows (x[::s, ::s], all of Cin) are loaded once, not
//     once a column group; the identity's skip tile is loaded with the
//     group's first chunk by cp.async, not read from device memory one pair
//     at a time after the products;
//   - each GEMM's first chunks are issued before the previous GEMM's
//     epilogue, and the CTAs that run together take the column groups in
//     rotated orders, so that they do not all ask one L2 slice for the same
//     weight chunk at once.
// Weights stream through a ring of `stages` cp.async slots with one barrier
// a chunk. The bf16 instances run mma.sync m16n8k16 with f32 accumulation,
// the 8 warps split over rows and columns so that each has work on a tile of
// 16, 32, 64 or 128 pixels (two products a ldmatrix at 128); each lane's
// fragment addresses are computed once a chunk. The f32 instance is plain
// FMA (no TF32). Every output element is the same sequence of k16 products
// whatever the plan, so plans differ in time, never in bits. Next: wgmma
// with TMA (one copy of a weight chunk for a cluster), not taken here.

#include "pool_common.cuh"

namespace {

constexpr int kSThreads = 256;
constexpr int kNB = 64;                // output channels per GEMM pass
constexpr int kKC = 64;                // reduction depth of one staged chunk
constexpr int kRows1Bf16 = 192;        // halo rows a phase-1 pass: the bf16 accumulator's 12 m-tiles
constexpr int kRows1F32 = 160;         // and the f32 one's 10 rows a thread
constexpr int kMaxStages = 4;          // slots of the cp.async ring
constexpr size_t kSmemMax = 232448;    // dynamic shared memory a block can opt in to on sm_90
constexpr size_t kSmemPerSM = 233472;  // an SM's shared memory, of which each resident block takes
constexpr size_t kSmemReserved = 1024; // this much more than it asks for

__host__ __device__ inline int round_up_to(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ inline size_t max_of(size_t a, size_t b) { return a > b ? a : b; }

// padding of a shared-memory row, in elements: 16 bytes, so that ldmatrix
// rows fall on distinct banks
__host__ __device__ inline int row_pad(int elem) { return 16 / elem; }

struct Geom {
  int th, tw, hh, hw, m1, m1p, m2;
};

__host__ __device__ inline Geom geom(int th, int tw, int stride) {
  Geom g;
  g.th = th;
  g.tw = tw;
  g.hh = stride * (th - 1) + 3;
  g.hw = stride * (tw - 1) + 3;
  g.m1 = g.hh * g.hw;
  g.m1p = round_up_to(g.m1, 16);
  g.m2 = th * tw;
  return g;
}

// Shared memory of a block, in elements of T, region by region:
//   r1: h1 [m1p][width + pad]; in phase 3 the downsample's A ring, stages x [m2][kKC + pad],
//       or the identity's two skip tiles, and one output tile [m2][kKC + pad]
//   r2: h2 [m2][width + pad]; in phase 1 its A ring, stages x [rows][kKC + pad]
//   rb: the weights' ring, stages x [kKC][kNB + pad]
// then the int arrays halo_off [m1p], sub_off [m2], out_off [m2].
// ops/fused_stage.plan_bytes is the same sum.
struct Layout {
  size_t r1, r2, rb;
};

__host__ __device__ inline Layout layout(int elem, int width, const Geom& g, int rows, int stages) {
  const int p = row_pad(elem);
  Layout l;
  l.r1 = max_of((size_t)g.m1p * (width + p), (size_t)(stages + 1) * g.m2 * (kKC + p));
  l.r2 = max_of((size_t)g.m2 * (width + p), (size_t)stages * rows * (kKC + p));
  l.rb = (size_t)stages * kKC * (kNB + p);
  return l;
}

inline size_t smem_bytes(int elem, int width, const Geom& g, int rows, int stages) {
  const Layout l = layout(elem, width, g, rows, stages);
  return (l.r1 + l.r2 + l.rb) * elem + sizeof(int) * (size_t)(g.m1p + 2 * g.m2);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }

// ---------------------------------------------------------------------------
// The accumulator of one GEMM pass: rows [0, 16 * mtiles) x kNB columns,
// split over the block's threads. mma_chunk adds A[rows, kKC] . B[kKC, kNB]
// with A's row r at aptr(r) (shared memory, k = 0 of the chunk) and B at b
// (shared memory, row stride ldb); each(f) visits the thread's values as
// (row, col, v[col], v[col + 1]).
//
// bf16: the 8 warps as WM row groups x 8 / WM column groups, so that a pass
// of few rows (an output tile of 16 or 32 pixels) still keeps every warp
// busy; a warp holds MT m-tiles of 16 rows (m-tile wm + WM i) and WM n-tiles
// of 8 columns. Per 16-deep step a warp issues (WM + 1) / 2 + MT ldmatrix for
// MT x WM products: <4, 2> (128 pixels) two products a load.
template <typename T, int WM, int MT> struct Acc;

template <int WM, int MT> struct Acc<bf16, WM, MT> {
  static constexpr int kNT = WM;  // n-tiles a warp
  float c[MT][kNT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][n][e] = 0.f;
  }

  template <class AP>
  __device__ __forceinline__ void mma_chunk(int mtiles, AP aptr, const bf16* b, int ldb) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wm = warp % WM, col0 = (warp / WM) * 8 * kNT;
    // each lane's A row of every m-tile and its B row, once a chunk: aptr may
    // gather (phase 2's tap windows) and cost divisions
    const bf16* arow[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mt = wm + WM * i;
      arow[i] = mt < mtiles ? aptr(mt * 16 + (lane & 15)) + (lane >> 4) * 8 : nullptr;
    }
    const bf16* brow = b + (((lane >> 3) & 1) * 8 + (lane & 7)) * ldb + col0 + (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      // b0, b1 of n-tiles 2np and 2np + 1 (with one n-tile a warp, the second
      // half reads the row's padding or the next warp's columns, unused)
      uint32_t bf[(kNT + 1) / 2][4];
#pragma unroll
      for (int np = 0; np < (kNT + 1) / 2; ++np) ldsm_x4_trans(bf[np], brow + ks * 16 * ldb + np * 16);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (arow[i] != nullptr) {
          uint32_t af[4];
          ldsm_x4(af, arow[i] + ks * 16);
#pragma unroll
          for (int n = 0; n < kNT; ++n) mma_bf16(c[i][n], af, bf[n / 2][(n % 2) * 2], bf[n / 2][(n % 2) * 2 + 1]);
        }
      }
    }
  }

  // C fragment of m16n8: rows g and g + 8, columns 2q and 2q + 1
  template <class F>
  __device__ __forceinline__ void each(int mtiles, F f) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wm = warp % WM, col0 = (warp / WM) * 8 * kNT;
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mt = wm + WM * i;
      if (mt < mtiles) {
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const int col = col0 + n * 8 + 2 * q;
          f(mt * 16 + g, col, c[i][n][0], c[i][n][1]);
          f(mt * 16 + g + 8, col, c[i][n][2], c[i][n][3]);
        }
      }
    }
  }
};

// f32: thread (ty, tx) holds rows ty + 16 i and columns 4 tx .. 4 tx + 3
template <int WM, int MT> struct Acc<float, WM, MT> {
  static constexpr int kR = kRows1F32 / 16;  // rows a thread: ty + 16 i
  float c[kR][4];                            // columns 4 tx .. 4 tx + 3

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }

  template <class AP>
  __device__ __forceinline__ void mma_chunk(int mtiles, AP aptr, const float* b, int ldb) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, rows = mtiles * 16;
    const float* ap[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) ap[i] = ty + 16 * i < rows ? aptr(ty + 16 * i) : nullptr;
#pragma unroll 4
    for (int k = 0; k < kKC; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(b + k * ldb + 4 * tx);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        if (ap[i] != nullptr) {
          const float a = ap[i][k];
          c[i][0] = fmaf(a, bv.x, c[i][0]);
          c[i][1] = fmaf(a, bv.y, c[i][1]);
          c[i][2] = fmaf(a, bv.z, c[i][2]);
          c[i][3] = fmaf(a, bv.w, c[i][3]);
        }
      }
    }
  }

  template <class F>
  __device__ __forceinline__ void each(int mtiles, F f) const {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, rows = mtiles * 16;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      if (ty + 16 * i < rows) {
        f(ty + 16 * i, 4 * tx, c[i][0], c[i][1]);
        f(ty + 16 * i, 4 * tx + 2, c[i][2], c[i][3]);
      }
    }
  }
};

// B chunk: rows k0 .. k0 + kKC, columns n0 .. n0 + kNB of a row-major [K][N]
// weight in device memory (L2 after its first reader) -> dst [kKC][kNB + pad]
template <typename T>
__device__ __forceinline__ void load_b(const T* w, int n, int k0, int n0, T* dst) {
  constexpr int per_row = kNB * sizeof(T) / 16, vec = 16 / sizeof(T), ld = kNB + 16 / sizeof(T);
  for (int i = threadIdx.x; i < kKC * per_row; i += kSThreads) {
    const int r = i / per_row, c = (i % per_row) * vec;
    cp_async16(dst + r * ld + c, w + (size_t)(k0 + r) * n + n0 + c, 16);
  }
}

// A chunk: channels k0 .. k0 + kc of the pixels off[0 .. rows) of one image
// (-1: a zero row) -> dst [rows][ld]
template <typename T>
__device__ __forceinline__ void load_a(const T* x, const int* off, int rows, int cin, int k0, T* dst, int kc = kKC,
                                       int ld = kKC + 16 / sizeof(T)) {
  constexpr int vec = 16 / sizeof(T);
  const int per_row = kc / vec;
  for (int i = threadIdx.x; i < rows * per_row; i += kSThreads) {
    const int r = i / per_row, c = (i % per_row) * vec;
    const int o = off[r];
    cp_async16(dst + r * ld + c, o >= 0 ? x + (size_t)o * cin + k0 + c : x, o >= 0 ? 16 : 0);
  }
}

// cp.async.wait_group takes an immediate: at most n of this thread's groups still in flight
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<2>();
}

// A GEMM's first chunks: 0 .. stages - 2 into slots 0 .. stages - 2, one
// cp.async group each (empty ones too, so that the count of groups stays the
// chunk's index). issue(c, slot) starts the copies of chunk c into a slot.
// The caller starts the next GEMM's chunks as soon as the last one has passed
// its final barrier, so that they land while it runs its epilogue.
template <class Issue>
__device__ __forceinline__ void ring_start(int n_chunks, int stages, Issue issue) {
  for (int c = 0; c < stages - 1; ++c) {
    if (c < n_chunks) issue(c, c);
    cp_async_commit();
  }
}

// acc += A . B over n_chunks chunks of kKC through a ring of `stages` slots,
// started by ring_start with the same issue(c, slot); aptr(c, slot, r) is A's
// row r of chunk c in shared memory. Per chunk c: wait for it, one barrier
// (chunk c has landed for every thread, and every thread is past chunk c - 1),
// refill chunk c - 1's slot with chunk c + stages - 1, multiply. Ends with
// every thread past its last read of the ring.
template <typename T, class A, class Issue, class AP>
__device__ __forceinline__ void gemm(A& acc, int mtiles, int n_chunks, int stages, Issue issue, AP aptr,
                                     const T* b_s) {
  constexpr int ldb = kNB + 16 / sizeof(T);
  int slot = 0;  // c % stages
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_pending(stages - 2);
    __syncthreads();
    if (c + stages - 1 < n_chunks) issue(c + stages - 1, slot == 0 ? stages - 1 : slot - 1);
    cp_async_commit();
    acc.mma_chunk(mtiles, [&](int r) { return aptr(c, slot, r); }, b_s + (size_t)slot * kKC * ldb, ldb);
    slot = slot + 1 == stages ? 0 : slot + 1;
  }
  __syncthreads();
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }

struct BlockArgs {
  int H, W, cin, width, cout, stride, th, tw, rows, stages, tiles_x;
  const float *b1, *b2, *b3, *bd;
};

// WM2, MT2: the bf16 warp layout of phases 2 and 3, 16 * WM2 * MT2 = the tile's pixels.
// MINB: the CTAs an SM that the registers leave room for (2: at most 128 a
// thread), where shared memory allows two; 1 gives the accumulators room.
template <typename T, int WM2, int MT2, int MINB>
__global__ void __launch_bounds__(kSThreads, MINB)
stage_block_kernel(const T* __restrict__ x, T* __restrict__ out, const T* __restrict__ w1,
                   const T* __restrict__ w2, const T* __restrict__ w3, const T* __restrict__ wd, BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom g = geom(a.th, a.tw, a.stride);
  const Layout l = layout(sizeof(T), a.width, g, a.rows, a.stages);
  const int P = 16 / sizeof(T), ldh = a.width + P, lda = kKC + P, ldb = kNB + P;
  const int Ho = a.H / a.stride, Wo = a.W / a.stride;
  T* h1_s = reinterpret_cast<T*>(smem);  // r1: h1 [m1p][ldh]; phase 3: the downsample's A ring
  T* h2_s = h1_s + l.r1;                 // r2: h2 [m2][ldh]; phase 1: its A ring
  T* b_s = h2_s + l.r2;                  // stages x [kKC][ldb]
  int* halo_off = reinterpret_cast<int*>(b_s + l.rb);  // [m1p] input pixel of a halo row, -1 outside
  int* sub_off = halo_off + g.m1p;       // [m2] input pixel (s oy, s ox) of an output row, -1 past the map
  int* out_off = sub_off + g.m2;         // [m2] output pixel, -1 past the map

  const int img = blockIdx.y, tile = blockIdx.x;
  const int oy0 = (tile / a.tiles_x) * a.th, ox0 = (tile % a.tiles_x) * a.tw;
  const T* xb = x + (size_t)img * a.H * a.W * a.cin;
  T* ob = out + (size_t)img * Ho * Wo * a.cout;
  for (int r = threadIdx.x; r < g.m1p; r += kSThreads) {
    int o = -1;
    if (r < g.m1) {
      const int iy = a.stride * oy0 - 1 + r / g.hw, ix = a.stride * ox0 - 1 + r % g.hw;
      if (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W) o = iy * a.W + ix;
    }
    halo_off[r] = o;
  }
  for (int r = threadIdx.x; r < g.m2; r += kSThreads) {
    const int oy = oy0 + r / g.tw, ox = ox0 + r % g.tw;
    const bool ok = oy < Ho && ox < Wo;
    out_off[r] = ok ? oy * Wo + ox : -1;
    sub_off[r] = ok ? a.stride * oy * a.W + a.stride * ox : -1;
  }
  __syncthreads();

  Acc<T, 4, 3> acc;          // phase 1: a pass of up to 192 halo rows
  Acc<T, WM2, MT2> acc2;     // phases 2 and 3: the tile's 16 * WM2 * MT2 pixels
  const int mt2 = g.m2 / 16;
  T* const a_ring1 = h2_s;   // phase 1's A ring, stages x [rows][lda]
  T* const a_ring3 = h1_s;   // phase 3's downsample A ring, stages x [m2][lda]
  auto b_slot = [&](int buf) { return b_s + (size_t)buf * kKC * ldb; };

  // Each phase's chunk c of the GEMM for output columns n0 .. n0 + kNB (phase 1:
  // of the pass from halo row r0) into ring slot buf.
  const int per_tap = a.width / kKC, n_h3 = a.width / kKC, n_ds = wd != nullptr ? a.cin / kKC : 0;
  const int chunks1 = a.cin / kKC, chunks2 = 9 * per_tap, chunks3 = n_h3 + n_ds;
  auto issue1 = [&](int r0, int n0, int c, int buf) {
    load_a(xb, halo_off + r0, min(a.rows, g.m1p - r0), a.cin, c * kKC, a_ring1 + (size_t)buf * a.rows * lda);
    load_b(w1, a.width, c * kKC, n0, b_slot(buf));
  };
  auto issue2 = [&](int n0, int c, int buf) { load_b(w2, a.width, c * kKC, n0, b_slot(buf)); };
  // identity: with chunk 0, the skip tile x[.., n0 .. n0 + kNB) into one of two
  // buffers in h1's region (dead in phase 3; the downsample's ring is not used),
  // the j-th group's into buffer j % 2
  auto skip_buf = [&](int j) { return a_ring3 + (size_t)(j & 1) * g.m2 * lda; };
  // downsample: its A rows x[s oy, s ox, 0 .. Cin) once, with the first group's
  // chunk 0, into h1's region where they fit (every ResNet-50 block), instead
  // of once a column group through the ring
  const int ldx = a.cin + P;
  const bool ds_resident = wd != nullptr && (size_t)g.m2 * (ldx + lda) <= l.r1;
  T* const xs_s = h1_s;  // [m2][ldx]
  // the downsample's output tile [m2][lda], after its A rows or ring; the identity's is its skip tile
  T* const out_tile = ds_resident ? xs_s + (size_t)g.m2 * ldx : a_ring3 + (size_t)a.stages * g.m2 * lda;
  auto issue3 = [&](int j, int n0, int c, int buf) {
    if (c < n_h3) {
      load_b(w3, a.cout, c * kKC, n0, b_slot(buf));
    } else {
      if (!ds_resident) load_a(xb, sub_off, g.m2, a.cin, (c - n_h3) * kKC, a_ring3 + (size_t)buf * g.m2 * lda);
      load_b(wd, a.cout, (c - n_h3) * kKC, n0, b_slot(buf));
    }
    if (c == 0 && wd == nullptr) load_a(xb, sub_off, g.m2, a.cin, n0, skip_buf(j));
    if (c == 0 && j == 0 && ds_resident) load_a(xb, sub_off, g.m2, a.cin, 0, xs_s, a.cin, ldx);
  };
  // The CTAs that run together take a phase's column groups in rotated orders,
  // so that they do not all ask L2 for the same weight chunk at once. Each
  // output column is computed whole either way.
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  const int groups12 = a.width / kNB, groups3 = a.cout / kNB;
  auto col12 = [&](int j) { return (j + cta) % groups12 * kNB; };
  auto col3 = [&](int j) { return (j + cta) % groups3 * kNB; };

  // 1. h1 = relu(x . w1 + b1) on the halo, pass by pass; 0 outside the image
  ring_start(chunks1, a.stages, [&](int c, int buf) { issue1(0, col12(0), c, buf); });
  for (int r0 = 0; r0 < g.m1p; r0 += a.rows) {
    const int n = min(a.rows, g.m1p - r0);
    const int* off = halo_off + r0;
    for (int j = 0; j < groups12; ++j) {
      const int n0 = col12(j);
      acc.zero();
      gemm<T>(acc, n / 16, chunks1, a.stages, [&](int c, int buf) { issue1(r0, n0, c, buf); },
              [&](int, int buf, int r) { return a_ring1 + ((size_t)buf * a.rows + r) * lda; }, b_s);
      if (j + 1 < groups12)
        ring_start(chunks1, a.stages, [&](int c, int buf) { issue1(r0, col12(j + 1), c, buf); });
      else if (r0 + a.rows < g.m1p)
        ring_start(chunks1, a.stages, [&](int c, int buf) { issue1(r0 + a.rows, col12(0), c, buf); });
      else
        ring_start(chunks2, a.stages, [&](int c, int buf) { issue2(col12(0), c, buf); });
      acc.each(n / 16, [&](int r, int col, float v0, float v1) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(a.b1 + n0 + col));
        const bool in = off[r] >= 0;
        store2(h1_s + (size_t)(r0 + r) * ldh + n0 + col, in ? fmaxf(v0 + bb.x, 0.f) : 0.f,
               in ? fmaxf(v1 + bb.y, 0.f) : 0.f);
      });
    }
  }

  // 2. h2 = relu(sum over the 9 taps of h1[window] . w2[tap] + b2), w2 read as [9 w][w]
  for (int j = 0; j < groups12; ++j) {
    const int n0 = col12(j);
    acc2.zero();
    gemm<T>(acc2, mt2, chunks2, a.stages, [&](int c, int buf) { issue2(n0, c, buf); },
            [&](int c, int, int r) {
              const int tap = c / per_tap, k = (c - tap * per_tap) * kKC;
              const int hr = (a.stride * (r / g.tw) + tap / 3) * g.hw + a.stride * (r % g.tw) + tap % 3;
              return h1_s + (size_t)hr * ldh + k;
            },
            b_s);
    if (j + 1 < groups12)
      ring_start(chunks2, a.stages, [&](int c, int buf) { issue2(col12(j + 1), c, buf); });
    else  // h1 is dead: phase 3's downsample ring and skip tiles may land in its region
      ring_start(chunks3, a.stages, [&](int c, int buf) { issue3(0, col3(0), c, buf); });
    acc2.each(mt2, [&](int r, int col, float v0, float v1) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(a.b2 + n0 + col));
      store2(h2_s + (size_t)r * ldh + n0 + col, fmaxf(v0 + bb.x, 0.f), fmaxf(v1 + bb.y, 0.f));
    });
  }

  // 3. out = relu(h2 . w3 + b3 + skip), skip = x or x[::s, ::s] . wd + bd: w3's chunks,
  // then (downsample) wd's, accumulate into the same registers through one ring
  for (int j = 0; j < groups3; ++j) {
    const int n0 = col3(j);
    acc2.zero();
    gemm<T>(acc2, mt2, chunks3, a.stages, [&](int c, int buf) { issue3(j, n0, c, buf); },
            [&](int c, int buf, int r) {
              if (c < n_h3) return h2_s + (size_t)r * ldh + c * kKC;
              return ds_resident ? xs_s + (size_t)r * ldx + (c - n_h3) * kKC
                                 : a_ring3 + ((size_t)buf * g.m2 + r) * lda;
            },
            b_s);
    if (j + 1 < groups3) ring_start(chunks3, a.stages, [&](int c, int buf) { issue3(j + 1, col3(j + 1), c, buf); });
    // through shared memory (the identity's over its own skip tile, each value
    // read and then written by one thread), so that each output row's kNB
    // channels leave in 16-byte stores
    T* const o_s = wd != nullptr ? out_tile : skip_buf(j);
    acc2.each(mt2, [&](int r, int col, float v0, float v1) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(a.b3 + n0 + col));
      const float2 sk = wd != nullptr ? __ldg(reinterpret_cast<const float2*>(a.bd + n0 + col))
                                      : load2(o_s + (size_t)r * lda + col);
      v0 += bb.x;
      v1 += bb.y;
      v0 += sk.x;
      v1 += sk.y;
      store2(o_s + (size_t)r * lda + col, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
    });
    __syncthreads();
    constexpr int vec = 16 / sizeof(T), per_row = kNB / vec;
    for (int i = threadIdx.x; i < g.m2 * per_row; i += kSThreads) {
      const int r = i / per_row, c = (i % per_row) * vec, o = out_off[r];
      if (o >= 0)
        *reinterpret_cast<uint4*>(ob + (size_t)o * a.cout + n0 + c) =
            *reinterpret_cast<const uint4*>(o_s + (size_t)r * lda + c);
    }
  }
}

// The shapes of the truncated ResNet-50's blocks: width 64/128/256, Cout = 4
// width, Cin one of 64/256/512/1024; stride 2 only with the downsample, the
// identity skip only at stride 1 with Cin == Cout.
inline bool supported(int cin, int width, int cout, int stride, bool has_ds) {
  if (width != 64 && width != 128 && width != 256) return false;
  if (cout != 4 * width) return false;
  if (cin != 64 && cin != 256 && cin != 512 && cin != 1024) return false;
  if (stride != 1 && stride != 2) return false;
  if (!has_ds && (stride != 1 || cin != cout)) return false;
  return true;
}

template <typename T, int WM2, int MT2, int MINB>
int launch_instance(const void* x, void* out, int B, const void* w1, const void* w2, const void* w3, const void* wd,
                    size_t smem, const BlockArgs& a, int n_tiles, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(stage_block_kernel<T, WM2, MT2, MINB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stage_block_kernel<T, WM2, MT2, MINB><<<dim3((unsigned)n_tiles, (unsigned)B), kSThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(w3), static_cast<const T*>(wd), a);
  return (int)cudaGetLastError();
}

// bf16: the instance that leaves registers for two CTAs an SM where shared
// memory holds two, else the one with room for the accumulators; f32 keeps
// the first kernel's register budget (two CTAs) throughout
template <typename T, int WM2, int MT2>
int launch_tile(const void* x, void* out, int B, const void* w1, const void* w2, const void* w3, const void* wd,
                size_t smem, const BlockArgs& a, int n_tiles, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2)
    if (2 * (smem + kSmemReserved) > kSmemPerSM)
      return launch_instance<T, WM2, MT2, 1>(x, out, B, w1, w2, w3, wd, smem, a, n_tiles, stream);
  return launch_instance<T, WM2, MT2, 2>(x, out, B, w1, w2, w3, wd, smem, a, n_tiles, stream);
}

// The plan (ops/fused_stage.plan): a th x tw output tile of 16, 32, 64 or (bf16)
// 128 pixels, phase-1 passes of `rows` halo rows (a multiple of 16 up to the
// phase-1 accumulator's), a ring of 2 .. kMaxStages slots, and the shared
// memory the caller computed for it, which must be this file's layout's and
// within kSmemMax. Anything else is cudaErrorInvalidValue, before a launch.
template <typename T>
int launch_block(const void* x, void* out, int B, int H, int W, int cin, int width, int cout, int stride, int th,
                 int tw, int rows, int stages, long long smem_plan, const void* w1, const float* b1, const void* w2,
                 const float* b2, const void* w3, const float* b3, const void* wd, const float* bd,
                 cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int max_rows = kBf16 ? kRows1Bf16 : kRows1F32;
  if (th < 1 || tw < 1 || rows < 16 || rows % 16 || rows > max_rows || stages < 2 || stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  const Geom g = geom(th, tw, stride);
  const size_t smem = smem_bytes(sizeof(T), width, g, rows, stages);
  if (smem > kSmemMax || (long long)smem != smem_plan) return (int)cudaErrorInvalidValue;
  const int Ho = H / stride, Wo = W / stride;
  const int tiles_x = (Wo + tw - 1) / tw, tiles_y = (Ho + th - 1) / th;
  const BlockArgs a{H, W, cin, width, cout, stride, th, tw, rows, stages, tiles_x, b1, b2, b3, bd};
  const int n = tiles_x * tiles_y;
  switch (g.m2) {
    case 16: return launch_tile<T, 1, 1>(x, out, B, w1, w2, w3, wd, smem, a, n, stream);
    case 32: return launch_tile<T, 2, 1>(x, out, B, w1, w2, w3, wd, smem, a, n, stream);
    case 64: return launch_tile<T, 4, 1>(x, out, B, w1, w2, w3, wd, smem, a, n, stream);
    case 128:
      if constexpr (kBf16) return launch_tile<T, 4, 2>(x, out, B, w1, w2, w3, wd, smem, a, n, stream);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches one fused bottleneck block on `stream`: x [B, H, W, Cin] -> out
// [B, H/s, W/s, Cout], both NHWC in the compute dtype (0 = float32, 1 =
// bfloat16); w1 [Cin, w], w2 [9, w, w], w3 [w, Cout], wd [Cin, Cout] or NULL
// (identity skip) in the compute dtype, biases f32; the plan th, tw, rows,
// stages and its shared memory in bytes (launch_block). Returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for a shape or plan no
// instance takes). Does not synchronise.
int toad_stage_block_forward(int dtype, const void* x, void* out, int B, int H, int W, int cin, int width, int cout,
                             int stride, int th, int tw, int rows, int stages, long long smem, const void* w1,
                             const void* b1, const void* w2, const void* b2, const void* w3, const void* b3,
                             const void* wd, const void* bd, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || H % stride || W % stride ||
      !supported(cin, width, cout, stride, wd != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *fb1 = static_cast<const float*>(b1), *fb2 = static_cast<const float*>(b2),
              *fb3 = static_cast<const float*>(b3), *fbd = static_cast<const float*>(bd);
  if (dtype == 1)
    return launch_block<bf16>(x, out, B, H, W, cin, width, cout, stride, th, tw, rows, stages, smem, w1, fb1, w2,
                              fb2, w3, fb3, wd, fbd, s);
  return launch_block<float>(x, out, B, H, W, cin, width, cout, stride, th, tw, rows, stages, smem, w1, fb1, w2,
                             fb2, w3, fb3, wd, fbd, s);
}

}  // extern "C"
