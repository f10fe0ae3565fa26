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
//      x rows gathered out of device memory by cp.async; halo pixels outside
//      the image are set to 0 after the ReLU (the 3x3 conv pads h1 with zeros,
//      not h1 of a zero-padded x, which would be relu(b1)).
//   2. h2 by 9 tap GEMMs whose A rows are gathered from the h1 tile in shared
//      memory: ldmatrix takes one row address per lane, so the shifted and
//      (at stride 2) subsampled tap windows cost no copy.
//   3. h3 + skip in f32 registers, 64 output channels a pass; the downsample
//      GEMM accumulates into the same registers; ReLU, cast, store.
// Only x, the weights and out touch device memory. Weights stream from L2
// through a double-buffered cp.async ring of 64 x 64 chunks.
//
// What bounds it on an H100: per batch of 64 tiles of 256 px, layer1's block
// inputs and outputs take longer at 3.35 TB/s than its operations at the bf16
// peak, layer3's the other way round; a block's h1 is recomputed on the halo
// (up to 1.9x of conv1's work on the smallest tiles). The bf16 instance runs
// mma.sync m16n8k16 with f32 accumulation, its 8 warps split over rows
// and columns so that each has work on a tile of 16, 32 or 64 pixels; the f32 instance is plain FMA (no TF32) for the f32 path. A
// first kernel: no wgmma or TMA yet.

#include "pool_common.cuh"

namespace {

constexpr int kSThreads = 256;
constexpr int kNB = 64;                // output channels per GEMM pass
constexpr int kKC = 64;                // reduction depth of one staged chunk
constexpr int kMaxRows = 160;          // halo rows an instance's registers cover
constexpr size_t kSmemTarget = 112640; // two blocks an SM where a tile allows it
constexpr size_t kSmemMax = 232448;    // dynamic shared memory a block can opt in to on sm_90

__host__ __device__ inline int round_up_to(int v, int m) { return (v + m - 1) / m * m; }

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

__host__ __device__ inline size_t smem_bytes(int elem, int width, const Geom& g) {
  const int p = row_pad(elem);
  const size_t els = (size_t)(g.m1p + g.m2) * (width + p) + 2 * (size_t)g.m1p * (kKC + p) + 2 * (size_t)kKC * (kNB + p);
  return els * elem + sizeof(int) * (size_t)(g.m1p + 2 * g.m2);
}

// The output tile: the largest of 8x8, 4x8, 4x4 whose halo the registers
// cover and whose shared memory leaves room for two blocks an SM, else the
// smallest that fits at all. Returns 0 when none fits.
inline int choose_tile(int elem, int width, int stride, Geom* out) {
  const int cands[3][2] = {{8, 8}, {4, 8}, {4, 4}};
  int found = -1;
  for (int i = 0; i < 3; ++i) {
    const Geom g = geom(cands[i][0], cands[i][1], stride);
    if (g.m1p > kMaxRows) continue;
    const size_t s = smem_bytes(elem, width, g);
    if (s <= kSmemTarget) { found = i; break; }
    if (s <= kSmemMax) found = i;
  }
  if (found < 0) return 0;
  *out = geom(cands[found][0], cands[found][1], stride);
  return 1;
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
// of 8 columns.
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
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      // b0, b1 of n-tiles 2np and 2np + 1 (with one n-tile a warp, the second
      // half reads the row's padding or the next warp's columns, unused)
      uint32_t bf[(kNT + 1) / 2][4];
#pragma unroll
      for (int np = 0; np < (kNT + 1) / 2; ++np)
        ldsm_x4_trans(bf[np], b + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldb + col0 + np * 16 +
                                  (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mt = wm + WM * i;
        if (mt < mtiles) {
          uint32_t af[4];
          ldsm_x4(af, aptr(mt * 16 + (lane & 15)) + ks * 16 + (lane >> 4) * 8);
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
  static constexpr int kR = kMaxRows / 16;  // rows a thread: ty + 16 i
  float c[kR][4];                           // columns 4 tx .. 4 tx + 3

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

// A chunk: channels k0 .. k0 + kKC of the pixels off[0 .. rows) of one image
// (-1: a zero row) -> dst [rows][kKC + pad]
template <typename T>
__device__ __forceinline__ void load_a(const T* x, const int* off, int rows, int cin, int k0, T* dst) {
  constexpr int per_row = kKC * sizeof(T) / 16, vec = 16 / sizeof(T), ld = kKC + 16 / sizeof(T);
  for (int i = threadIdx.x; i < rows * per_row; i += kSThreads) {
    const int r = i / per_row, c = (i % per_row) * vec;
    const int o = off[r];
    cp_async16(dst + r * ld + c, o >= 0 ? x + (size_t)o * cin + k0 + c : x, o >= 0 ? 16 : 0);
  }
}

// acc += A . B over n_chunks chunks of kKC. issue(c, buf) starts the cp.async
// copies of chunk c into ring slot buf; aptr(c, buf, r) is A's row r of chunk
// c in shared memory. Ends with every thread past its last read of the ring.
template <typename T, class A, class Issue, class AP>
__device__ __forceinline__ void gemm(A& acc, int mtiles, int n_chunks, Issue issue, AP aptr, const T* b_s) {
  constexpr int ldb = kNB + 16 / sizeof(T);
  issue(0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) issue(c + 1, (c + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    acc.mma_chunk(mtiles, [&](int r) { return aptr(c, c & 1, r); }, b_s + (c & 1) * kKC * ldb, ldb);
    __syncthreads();  // slot c & 1 is refilled by the next iteration's issue
  }
}

struct BlockArgs {
  int H, W, cin, width, cout, stride, th, tw, tiles_x;
  const float *b1, *b2, *b3, *bd;
};

// WM2: the bf16 warp layout of phases 2 and 3, 16 * WM2 = the tile's pixels
template <typename T, int WM2>
__global__ void __launch_bounds__(kSThreads)
stage_block_kernel(const T* __restrict__ x, T* __restrict__ out, const T* __restrict__ w1,
                   const T* __restrict__ w2, const T* __restrict__ w3, const T* __restrict__ wd, BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geom g = geom(a.th, a.tw, a.stride);
  const int P = 16 / sizeof(T), ldh = a.width + P, lda = kKC + P;
  const int Ho = a.H / a.stride, Wo = a.W / a.stride;
  T* h1_s = reinterpret_cast<T*>(smem);      // [m1p][ldh]
  T* h2_s = h1_s + (size_t)g.m1p * ldh;     // [m2][ldh]
  T* a_s = h2_s + (size_t)g.m2 * ldh;       // 2 x [m1p][lda]
  T* b_s = a_s + 2 * (size_t)g.m1p * lda;   // 2 x [kKC][kNB + P]
  int* halo_off = reinterpret_cast<int*>(b_s + 2 * kKC * (kNB + P));  // [m1p] input pixel of a halo row, -1 outside
  int* sub_off = halo_off + g.m1p;          // [m2] input pixel (s oy, s ox) of an output row, -1 past the map
  int* out_off = sub_off + g.m2;            // [m2] output pixel, -1 past the map

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

  Acc<T, 4, 3> acc;     // phase 1: up to 192 halo rows
  Acc<T, WM2, 1> acc2;  // phases 2 and 3: the tile's 16 * WM2 pixels
  const int mt1 = g.m1p / 16, mt2 = g.m2 / 16;
  auto staged_a = [&](int, int buf, int r) { return a_s + ((size_t)buf * g.m1p + r) * lda; };

  // 1. h1 = relu(x . w1 + b1) on the halo; 0 outside the image
  for (int n0 = 0; n0 < a.width; n0 += kNB) {
    acc.zero();
    gemm<T>(acc, mt1, a.cin / kKC,
            [&](int c, int buf) {
              load_a(xb, halo_off, g.m1p, a.cin, c * kKC, a_s + (size_t)buf * g.m1p * lda);
              load_b(w1, a.width, c * kKC, n0, b_s + buf * kKC * (kNB + P));
            },
            staged_a, b_s);
    acc.each(mt1, [&](int r, int col, float v0, float v1) {
      const float2 bb = *reinterpret_cast<const float2*>(a.b1 + n0 + col);
      const bool in = halo_off[r] >= 0;
      store2(h1_s + (size_t)r * ldh + n0 + col, in ? fmaxf(v0 + bb.x, 0.f) : 0.f, in ? fmaxf(v1 + bb.y, 0.f) : 0.f);
    });
  }
  __syncthreads();

  // 2. h2 = relu(sum over the 9 taps of h1[window] . w2[tap] + b2), w2 read as [9 w][w]
  for (int n0 = 0; n0 < a.width; n0 += kNB) {
    acc2.zero();
    gemm<T>(acc2, mt2, 9 * a.width / kKC,
            [&](int c, int buf) { load_b(w2, a.width, c * kKC, n0, b_s + buf * kKC * (kNB + P)); },
            [&](int c, int, int r) {
              const int kg = c * kKC, tap = kg / a.width, k = kg - tap * a.width;
              const int hr = (a.stride * (r / g.tw) + tap / 3) * g.hw + a.stride * (r % g.tw) + tap % 3;
              return h1_s + (size_t)hr * ldh + k;
            },
            b_s);
    acc2.each(mt2, [&](int r, int col, float v0, float v1) {
      const float2 bb = *reinterpret_cast<const float2*>(a.b2 + n0 + col);
      store2(h2_s + (size_t)r * ldh + n0 + col, fmaxf(v0 + bb.x, 0.f), fmaxf(v1 + bb.y, 0.f));
    });
  }
  __syncthreads();

  // 3. out = relu(h2 . w3 + b3 + skip), skip = x or x[::s, ::s] . wd + bd
  for (int n0 = 0; n0 < a.cout; n0 += kNB) {
    acc2.zero();
    gemm<T>(acc2, mt2, a.width / kKC,
            [&](int c, int buf) { load_b(w3, a.cout, c * kKC, n0, b_s + buf * kKC * (kNB + P)); },
            [&](int c, int, int r) { return h2_s + (size_t)r * ldh + c * kKC; }, b_s);
    if (wd != nullptr)
      gemm<T>(acc2, mt2, a.cin / kKC,
              [&](int c, int buf) {
                load_a(xb, sub_off, g.m2, a.cin, c * kKC, a_s + (size_t)buf * g.m1p * lda);
                load_b(wd, a.cout, c * kKC, n0, b_s + buf * kKC * (kNB + P));
              },
              staged_a, b_s);
    acc2.each(mt2, [&](int r, int col, float v0, float v1) {
      const int o = out_off[r];
      if (o < 0) return;
      const float2 bb = *reinterpret_cast<const float2*>(a.b3 + n0 + col);
      v0 += bb.x;
      v1 += bb.y;
      if (wd != nullptr) {
        const float2 bs = *reinterpret_cast<const float2*>(a.bd + n0 + col);
        v0 += bs.x;
        v1 += bs.y;
      } else {  // identity: Cin == Cout, stride 1
        const T* xs = xb + (size_t)sub_off[r] * a.cin + n0 + col;
        v0 += to_f(xs[0]);
        v1 += to_f(xs[1]);
      }
      store2(ob + (size_t)o * a.cout + n0 + col, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
    });
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

template <typename T, int WM2>
int launch_tile(const void* x, void* out, int B, int H, int W, int cin, int width, int cout, int stride,
                const void* w1, const void* w2, const void* w3, const void* wd, const Geom& g, const BlockArgs& a,
                int n_tiles, cudaStream_t stream) {
  const size_t smem = smem_bytes(sizeof(T), width, g);
  const cudaError_t err =
      cudaFuncSetAttribute(stage_block_kernel<T, WM2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stage_block_kernel<T, WM2><<<dim3((unsigned)n_tiles, (unsigned)B), kSThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(w3), static_cast<const T*>(wd), a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_block(const void* x, void* out, int B, int H, int W, int cin, int width, int cout, int stride,
                 const void* w1, const float* b1, const void* w2, const float* b2, const void* w3, const float* b3,
                 const void* wd, const float* bd, cudaStream_t stream) {
  Geom g;
  if (!choose_tile(sizeof(T), width, stride, &g)) return (int)cudaErrorInvalidValue;
  const int Ho = H / stride, Wo = W / stride;
  const int tiles_x = (Wo + g.tw - 1) / g.tw, tiles_y = (Ho + g.th - 1) / g.th;
  const BlockArgs a{H, W, cin, width, cout, stride, g.th, g.tw, tiles_x, b1, b2, b3, bd};
  const int n = tiles_x * tiles_y;
  switch (g.m2 / 16) {
    case 1: return launch_tile<T, 1>(x, out, B, H, W, cin, width, cout, stride, w1, w2, w3, wd, g, a, n, stream);
    case 2: return launch_tile<T, 2>(x, out, B, H, W, cin, width, cout, stride, w1, w2, w3, wd, g, a, n, stream);
    case 4: return launch_tile<T, 4>(x, out, B, H, W, cin, width, cout, stride, w1, w2, w3, wd, g, a, n, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The output tile of a launch as th * 256 + tw (0: no instance fits), and its
// dynamic shared memory in bytes: 0 = float32, 1 = bfloat16.
int toad_stage_tile(int dtype, int width, int stride) {
  Geom g;
  return choose_tile(dtype == 1 ? 2 : 4, width, stride, &g) ? g.th * 256 + g.tw : 0;
}

long long toad_stage_smem_bytes(int dtype, int width, int stride) {
  Geom g;
  const int elem = dtype == 1 ? 2 : 4;
  return choose_tile(elem, width, stride, &g) ? (long long)smem_bytes(elem, width, g) : 0;
}

// Launches one fused bottleneck block on `stream`: x [B, H, W, Cin] -> out
// [B, H/s, W/s, Cout], both NHWC in the compute dtype; w1 [Cin, w], w2
// [9, w, w], w3 [w, Cout], wd [Cin, Cout] or NULL (identity skip) in the
// compute dtype, biases f32. Returns the launch's cudaError_t (0 on success;
// cudaErrorInvalidValue for a shape no instance takes). Does not synchronise.
int toad_stage_block_forward(int dtype, const void* x, void* out, int B, int H, int W, int cin, int width, int cout,
                             int stride, const void* w1, const void* b1, const void* w2, const void* b2,
                             const void* w3, const void* b3, const void* wd, const void* bd, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || H % stride || W % stride ||
      !supported(cin, width, cout, stride, wd != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *fb1 = static_cast<const float*>(b1), *fb2 = static_cast<const float*>(b2),
              *fb3 = static_cast<const float*>(b3), *fbd = static_cast<const float*>(bd);
  if (dtype == 1)
    return launch_block<bf16>(x, out, B, H, W, cin, width, cout, stride, w1, fb1, w2, fb2, w3, fb3, wd, fbd, s);
  return launch_block<float>(x, out, B, H, W, cin, width, cout, stride, w1, fb1, w2, fb2, w3, fb3, wd, fbd, s);
}

}  // extern "C"
