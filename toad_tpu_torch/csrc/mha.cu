// Multi-head self-attention core of the ViT encoder, hand-written for Hopper
// (sm_90a).
//
// Replaces toad_tpu/ops/vit_attention.py::_mha_kernel (the TPU kernel K3).
// Per image b and head h, over the raw qkv projection [B, N, 3*H*Dh] with
// columns [q_h0..|k_h0..|v_h0..]:
//     s = q k^T (f32) * Dh^-1/2;  p = softmax(s) (f32), rounded to the input
//     dtype;  o = p v (f32 accumulate), rounded once;  heads concatenated
//     into out [B, N, H*Dh].
// These are the TPU kernel's rounding points. The [N, N] scores never reach
// device memory.
//
// What bounds it on an H100: it reads qkv and writes the context once, 8
// bytes per 4*N multiply-adds of a (token, head-dim) element in bf16, which
// at N = 197 is ~99 FLOP/byte against the card's ~295: memory-bound. So the
// design keeps everything between the qkv read and the context write on
// chip. The TPU kernel loops over several images and all heads inside one
// sequential grid step; here the unit is one block per (image, head, 64 query
// rows), blocks running in parallel over the SMs, with that head's K and V
// (2 * 197 * 64 bf16 = 50 KB) staged once per block into shared memory by
// cp.async (V lands while the scores are computed). The bf16 instance gives
// each of its 4 warps 16 query rows: S = Q K^T by mma.sync m16n8k16 over all
// keys at once into f32 registers (keys padded to a multiple of 16, the
// padded columns set to -inf before the row max, so no online softmax), the
// row softmax in registers with quad shuffles (normalised by the row's
// reciprocal sum: within an f32 ulp of the quotient, before the rounding to
// bf16), P rounded to bf16 straight into A fragments, P V with ldmatrix.trans on V, one coalesced bf16 store.
// The f32 instance uses FMA so that f32 stays f32 (no TF32): a warp takes one
// query row at a time, lanes over keys for the scores and over head columns
// for P V. A first kernel: no wgmma or TMA yet, and the 4 query blocks of an
// (image, head) each stage the same K and V (from L2 after the first).
//
// P7, the softmax variant of experiments/vit_softmax_probe.py::_mha_kernel_new,
// is a second instance of both kernels (template argument SM = kSoftmaxP7):
//     c = Dh^-1/2 * log2(e) (formed in f64 by the caller, passed as f32);
//     qs = q * c in f32, rounded to the input dtype;  s = qs k^T (f32);
//     p = exp2(s - rowmax) kept in f32;  denom = sum of that f32 p;
//     o = p (rounded to the input dtype) v, f32 accumulate;  o / denom (a true
//     division) rounded once.
// The rescale of q happens on the A fragments in registers, element by
// element, so no pass over shared memory and no barrier is added; the
// unrounded f32 p feeds the row sum, its bf16 rounding the P V product; the
// division uses __fdiv_rn (the build has no fast-math flags). Padded key
// columns are -inf before the row max (exp2 -> 0) and padded V rows zero, as
// in K3. Same launch shape, shared memory and bound as K3.

#include "pool_common.cuh"

namespace {

constexpr int kDh = 64;           // head size the instances are written for
constexpr int kQRows = 64;        // query rows per block: 4 warps x 16 rows
constexpr int kMhaThreads = 128;
constexpr int kLd = kDh + 8;      // bf16 row stride in shared memory: 144 B, conflict-free ldmatrix
constexpr int kLdF = kDh + 1;     // f32 row stride: conflict-free reads down a column
constexpr int kMaxKeyTiles = 17;  // bf16: 16-key tiles whose scores one thread holds (N <= 272)
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can opt in to on sm_90
constexpr int kSoftmaxK3 = 0;     // softmax of K3: scale after q k^T, exp, p normalised before rounding
constexpr int kSoftmaxP7 = 1;     // softmax of P7: q pre-scaled by c, exp2, the context divided at the end

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

__host__ __device__ inline size_t smem_bf16(int N) {
  return sizeof(bf16) * (size_t)(kQRows + 2 * round_up(N, 16)) * kLd;
}
__host__ __device__ inline size_t smem_f32(int N) {
  return sizeof(float) * ((size_t)2 * N * kLdF + (size_t)(kMhaThreads / 32) * round_up(N, 32));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two packed bf16 values times c in f32, each rounded back to bf16
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float c) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return pack_bf16(__low2float(x) * c, __high2float(x) * c);
}

// ---------------------------------------------------------------------------
// bf16: KT = number of 16-key tiles the instance unrolls (a thread holds
// 8 * KT scores of its two rows); tiles past the sequence's own are skipped.
// Fragment layouts are those of PTX mma.m16n8k16 (g = lane / 4, q = lane % 4):
// C rows g, g+8 at cols 2q (+1); the C fragments of two neighbouring 8-key
// score tiles are exactly the A fragment of the 16-key step of P V.
// SM: kSoftmaxK3 (scale = Dh^-1/2) or kSoftmaxP7 (scale = c, see the top).
template <int KT, int SM>
__global__ void __launch_bounds__(kMhaThreads)
mha_bf16_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H, int n_qt, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_kt = (N + 15) / 16, n_pad = n_kt * 16;
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kQRows][kLd]
  bf16* k_s = q_s + kQRows * kLd;             // [n_pad][kLd]
  bf16* v_s = k_s + n_pad * kLd;              // [n_pad][kLd]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.x / n_qt, qt = blockIdx.x % n_qt, h = blockIdx.y;
  const int D = H * kDh;
  const size_t ld = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * N * ld + h * kDh;  // q of token 0; k at +D, v at +2D
  const int row0 = qt * kQRows;

  // group 0: the query tile and K; group 1: V. Rows past the sequence's end
  // are zero-filled (a padded V row meets p = 0 and must not be NaN).
  for (int i = tid; i < kQRows * (kDh / 8); i += kMhaThreads) {
    const int r = i / (kDh / 8), c = (i % (kDh / 8)) * 8;
    const bool ok = row0 + r < N;
    cp_async16(q_s + r * kLd + c, ok ? base + (size_t)(row0 + r) * ld + c : base, ok ? 16 : 0);
  }
  for (int i = tid; i < n_pad * (kDh / 8); i += kMhaThreads) {
    const int r = i / (kDh / 8), c = (i % (kDh / 8)) * 8;
    const bool ok = r < N;
    cp_async16(k_s + r * kLd + c, ok ? base + (size_t)r * ld + D + c : base, ok ? 16 : 0);
  }
  cp_async_commit();
  for (int i = tid; i < n_pad * (kDh / 8); i += kMhaThreads) {
    const int r = i / (kDh / 8), c = (i % (kDh / 8)) * 8;
    const bool ok = r < N;
    cp_async16(v_s + r * kLd + c, ok ? base + (size_t)r * ld + 2 * D + c : base, ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int wrow = warp * 16;
  const bool live = row0 + wrow < N;  // a warp whose 16 rows all lie past the end only helps staging
  float s[KT][2][4];
  float den[2];  // P7: the rows' f32 sums of p, the divisors of the context
  if (live) {
    uint32_t qf[kDh / 16][4];
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk)
      ldsm_x4(qf[kk], q_s + (wrow + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
    if constexpr (SM == kSoftmaxP7) {
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) qf[kk][r] = scale_bf16x2(qf[kk][r], scale);
    }
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[kt][hf][e] = 0.f;
      if (kt < n_kt) {
#pragma unroll
        for (int kk = 0; kk < kDh / 16; ++kk) {
          uint32_t kf[4];  // b0, b1 of keys kt*16.., then of keys kt*16 + 8..
          ldsm_x4(kf, k_s + (kt * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[kt][0], qf[kk], kf[0], kf[1]);
          mma_bf16(s[kt][1], qf[kk], kf[2], kf[3]);
        }
      }
    }

    // row softmax in f32: elements 0, 1 belong to row g, elements 2, 3 to row g + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt < n_kt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kt * 16 + hf * 8 + 2 * q + (e & 1);
            const float v = col < N ? (SM == kSoftmaxK3 ? s[kt][hf][e] * scale : s[kt][hf][e]) : -INFINITY;
            s[kt][hf][e] = v;
            mx[e >> 1] = fmaxf(mx[e >> 1], v);
          }
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt < n_kt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = SM == kSoftmaxK3 ? expf(s[kt][hf][e] - mx[e >> 1]) : exp2f(s[kt][hf][e] - mx[e >> 1]);
            s[kt][hf][e] = p;
            sum[e >> 1] += p;
          }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      den[r] = sum[r];
    }
    if constexpr (SM == kSoftmaxK3) {
      // one IEEE division per row; a division per score cost a third of the kernel's time
      const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        if (kt < n_kt) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[kt][hf][e] = s[kt][hf][e] * inv[e >> 1];
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // V has landed for every thread; no block-wide barrier follows
  if (!live) return;

  float o[kDh / 8][4];
#pragma unroll
  for (int nt = 0; nt < kDh / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (kt < n_kt) {
      // P rounded to bf16, the A fragment of this 16-key step
      const uint32_t pf[4] = {pack_bf16(s[kt][0][0], s[kt][0][1]), pack_bf16(s[kt][0][2], s[kt][0][3]),
                              pack_bf16(s[kt][1][0], s[kt][1][1]), pack_bf16(s[kt][1][2], s[kt][1][3])};
#pragma unroll
      for (int np = 0; np < kDh / 16; ++np) {
        uint32_t vf[4];  // b0, b1 of head columns np*16.., then of np*16 + 8..
        ldsm_x4_trans(vf, v_s + (kt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd + np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], pf, vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pf, vf[2], vf[3]);
      }
    }
  }

  if constexpr (SM == kSoftmaxP7) {
#pragma unroll
    for (int nt = 0; nt < kDh / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = __fdiv_rn(o[nt][e], den[e >> 1]);
  }

  // the warp's 16 query rows in shared memory are spent (they sit in qf):
  // stage the context there and write whole 128-byte head rows
  bf16* st = q_s + wrow * kLd;
#pragma unroll
  for (int nt = 0; nt < kDh / 8; ++nt) {
    *reinterpret_cast<uint32_t*>(st + g * kLd + nt * 8 + 2 * q) = pack_bf16(o[nt][0], o[nt][1]);
    *reinterpret_cast<uint32_t*>(st + (g + 8) * kLd + nt * 8 + 2 * q) = pack_bf16(o[nt][2], o[nt][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * (kDh / 8); i += 32) {
    const int r = i / (kDh / 8), c = (i % (kDh / 8)) * 8;
    const int row = row0 + wrow + r;
    if (row < N)
      *reinterpret_cast<uint4*>(out + ((size_t)b * N + row) * D + h * kDh + c) =
          *reinterpret_cast<const uint4*>(st + r * kLd + c);
  }
}

// ---------------------------------------------------------------------------
// f32: K and V of the head in shared memory; a warp takes its 16 query rows
// one at a time, the row's q in registers. Lane j computes the scores of
// keys j, j + 32, .. into the warp's row buffer p_s, then head columns j and
// j + 32 of p V. SM as in the bf16 kernel.
template <int SM>
__global__ void __launch_bounds__(kMhaThreads)
mha_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int N, int H, int n_qt, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);  // [N][kLdF]
  float* v_s = k_s + (size_t)N * kLdF;          // [N][kLdF]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* p_s = v_s + (size_t)N * kLdF + warp * round_up(N, 32);  // this warp's [N] scores
  const int b = blockIdx.x / n_qt, qt = blockIdx.x % n_qt, h = blockIdx.y;
  const int D = H * kDh;
  const size_t ld = 3 * (size_t)D;
  const float* base = qkv + (size_t)b * N * ld + h * kDh;

  for (int i = tid; i < N * (kDh / 4); i += kMhaThreads) {
    const int r = i / (kDh / 4), c = (i % (kDh / 4)) * 4;
    const float4 kv = __ldg(reinterpret_cast<const float4*>(base + (size_t)r * ld + D + c));
    const float4 vv = __ldg(reinterpret_cast<const float4*>(base + (size_t)r * ld + 2 * D + c));
    float* kd = k_s + r * kLdF + c;
    float* vd = v_s + r * kLdF + c;
    kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
    vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
  }
  __syncthreads();

  for (int rr = 0; rr < 16; ++rr) {
    const int row = qt * kQRows + warp * 16 + rr;
    if (row >= N) break;
    float qr[kDh];
#pragma unroll
    for (int c = 0; c < kDh; c += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(base + (size_t)row * ld + c));
      qr[c] = v.x; qr[c + 1] = v.y; qr[c + 2] = v.z; qr[c + 3] = v.w;
    }
    if constexpr (SM == kSoftmaxP7) {
#pragma unroll
      for (int c = 0; c < kDh; ++c) qr[c] = qr[c] * scale;
    }
    float mx = -INFINITY;
    for (int key = lane; key < N; key += 32) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < kDh; ++d) acc = fmaf(qr[d], k_s[key * kLdF + d], acc);
      if constexpr (SM == kSoftmaxK3) acc *= scale;
      p_s[key] = acc;
      mx = fmaxf(mx, acc);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int key = lane; key < N; key += 32) {
      const float e = SM == kSoftmaxK3 ? expf(p_s[key] - mx) : exp2f(p_s[key] - mx);
      p_s[key] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if constexpr (SM == kSoftmaxK3)
      for (int key = lane; key < N; key += 32) p_s[key] = p_s[key] / sum;
    __syncwarp();
    float o0 = 0.f, o1 = 0.f;
    for (int key = 0; key < N; ++key) {
      const float p = p_s[key];
      o0 = fmaf(p, v_s[key * kLdF + lane], o0);
      o1 = fmaf(p, v_s[key * kLdF + lane + 32], o1);
    }
    if constexpr (SM == kSoftmaxP7) {
      o0 = __fdiv_rn(o0, sum);
      o1 = __fdiv_rn(o1, sum);
    }
    float* orow = out + ((size_t)b * N + row) * D + h * kDh;
    orow[lane] = o0;
    orow[lane + 32] = o1;
    __syncwarp();  // the next row overwrites p_s
  }
}

template <typename T>
int launch_mha(void (*kernel)(const T*, T*, int, int, int, float), size_t smem, const void* qkv, void* out,
               int B, int N, int H, float scale, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (N + kQRows - 1) / kQRows;
  kernel<<<dim3((unsigned)(B * n_qt), H), kMhaThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, H, n_qt, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The head size the kernel is written for.
int toad_mha_head_dim() { return kDh; }

// The longest sequence an instance takes: 0 = float32 (K, V and the warps'
// score rows must fit in a block's shared memory), 1 = bfloat16 (a thread
// holds a query row's scores over all keys in registers).
int toad_mha_max_tokens(int dtype) {
  if (dtype == 1) return kMaxKeyTiles * 16;
  int n = 0;
  while (smem_f32(n + 1) <= (size_t)kMaxSmem) ++n;
  return n;
}

// Dynamic shared memory of one block in bytes.
long long toad_mha_smem_bytes(int dtype, int N) { return (long long)(dtype == 1 ? smem_bf16(N) : smem_f32(N)); }

// Launches the attention kernel on `stream` over qkv [B, N, 3*H*64] into out
// [B, N, H*64]: softmax 0 = K3 (scale = Dh^-1/2), 1 = P7 (scale = c, see the
// top); returns the launch's cudaError_t (0 on success; cudaErrorInvalidValue
// for a shape no instance takes). Does not synchronise.
int toad_mha_forward(int softmax, int dtype, const void* qkv, void* out, int B, int N, int H, int head_dim,
                     float scale, void* stream) {
  if ((softmax != kSoftmaxK3 && softmax != kSoftmaxP7) || head_dim != kDh || B < 1 || N < 1 || H < 1 ||
      H > 65535 || N > toad_mha_max_tokens(dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool p7 = softmax == kSoftmaxP7;
  if (dtype != 1)
    return launch_mha<float>(p7 ? mha_f32_kernel<kSoftmaxP7> : mha_f32_kernel<kSoftmaxK3>, smem_f32(N), qkv, out,
                             B, N, H, scale, s);
  // the smaller instance spares registers where the sequence allows it (N <= 208: ViT at 224 px)
  if (N <= 13 * 16)
    return launch_mha<bf16>(p7 ? mha_bf16_kernel<13, kSoftmaxP7> : mha_bf16_kernel<13, kSoftmaxK3>, smem_bf16(N),
                            qkv, out, B, N, H, scale, s);
  return launch_mha<bf16>(p7 ? mha_bf16_kernel<kMaxKeyTiles, kSoftmaxP7> : mha_bf16_kernel<kMaxKeyTiles, kSoftmaxK3>,
                          smem_bf16(N), qkv, out, B, N, H, scale, s);
}

}  // extern "C"
