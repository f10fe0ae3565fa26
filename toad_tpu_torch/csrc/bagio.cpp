// Native bag IO: parallel pread of float32 feature-bag payloads directly
// into a preallocated padded batch buffer.
//
// The PyTorch port's copy of toad_tpu/native/bagio.cpp: the same ABI (4), the
// same toad_pack_bags* / toad_pack_segs* entry points and the same code. Only
// comments differ: the binding and the twins they name are the port's
// (toad_tpu_torch/native/__init__.py, toad_tpu_torch/ops/quantize.py), and
// in the port the destination of a batch on a CUDA device is a slot of the
// batcher's pinned ring (toad_tpu_torch/data/batching.py). That slot is
// reused, so the caller zeroes only what these functions do not write (each
// bag's padding rows, the mask plane; the scales plane is set to the padding
// scale) instead of handing in a freshly zeroed buffer.
//
// Instead of a load -> pad -> stage chain of copies per slide in Python, the
// batcher resolves each bag file's raw payload (offset, rows) once, and this
// library fills the [B, bucket, D] batch with one pread per bag or segment,
// multithreaded, GIL-free, with no intermediate allocations. Works for any
// format whose payload is contiguous little-endian float32 on disk: .npy,
// torch-zip .pt members (stored, uncompressed), and contiguous h5 datasets;
// and for the int8 stores' .npz members (toad_pack_*_q8).
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 bagio.cpp -o libbagio.so
// (toad_tpu_torch/native/__init__.py, at first use, into _build/).

#include <atomic>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// Read exactly `count` bytes at `offset` into `buf`; returns 0 on success.
int pread_full(int fd, void* buf, size_t count, int64_t offset) {
    char* p = static_cast<char*>(buf);
    while (count > 0) {
        ssize_t got = ::pread(fd, p, count, offset);
        if (got < 0) {
            if (errno == EINTR) continue;
            return errno ? errno : EIO;
        }
        if (got == 0) return EIO;  // unexpected EOF
        p += got;
        offset += got;
        count -= static_cast<size_t>(got);
    }
    return 0;
}

// f32 -> bf16 with round-to-nearest-even, matching torch's (and ml_dtypes')
// cast bit-for-bit on finite values, inf and overflow to inf (NaN is
// quieted, keeping its sign and payload).
inline uint16_t f32_to_bf16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    if ((x & 0x7fffffffu) > 0x7f800000u) {               // NaN: keep sign, quiet
        return static_cast<uint16_t>((x >> 16) | 0x0040u);
    }
    x += 0x7fffu + ((x >> 16) & 1u);                     // RNE bias
    return static_cast<uint16_t>(x >> 16);
}

// One row of dynamic int8 quantization, the exact twin of
// toad_tpu_torch/ops/quantize.py::quantize_rows_np: scale = max(amax(|row|), 1e-6) / 127,
// q = clip(rint(x / scale), -127, 127). All math in f32 with f32 division
// and rintf (round-half-to-even), so results are bit-identical to numpy's.
inline float quantize_row(const float* x, int8_t* q, int64_t dim) {
    float amax = 0.0f;
    for (int64_t c = 0; c < dim; ++c) {
        float a = std::fabs(x[c]);
        if (a > amax) amax = a;
    }
    float scale = (amax > 1e-6f ? amax : 1e-6f) / 127.0f;
    for (int64_t c = 0; c < dim; ++c) {
        float v = std::rintf(x[c] / scale);
        if (v > 127.0f) v = 127.0f;
        if (v < -127.0f) v = -127.0f;
        q[c] = static_cast<int8_t>(v);
    }
    return scale;
}

// Shared work loop for the converting packers: stream each entry's payload
// through a chunk-sized f32 scratch buffer (so the fused convert runs
// cache-hot, one pass over the data instead of numpy's read-then-abs-max-
// divide-rint-clip passes), handing each chunk to `emit(row0, nrows_chunk,
// scratch)`. An "entry" is one contiguous on-disk payload: a whole bag for
// the toad_pack_bags_* wrappers, or one SEGMENT of a multi-file bag (e.g. a
// patient-concat bag, one slide file per segment) for toad_pack_segs_* —
// the emit callbacks address the destination via dst_rows[j], so segment
// granularity is invisible here.
template <typename Emit>
int64_t pack_convert(const char** paths, const int64_t* offsets,
                     const int64_t* nrows, int64_t dim, int64_t nbags,
                     int32_t nthreads, Emit emit_for_bag) {
    if (nthreads <= 0) {
        nthreads = static_cast<int32_t>(std::thread::hardware_concurrency());
        if (nthreads <= 0) nthreads = 4;
    }
    if (nthreads > nbags) nthreads = static_cast<int32_t>(nbags > 0 ? nbags : 1);

    // chunk: ~1 MB of f32 rows per read (cache-friendly, few syscalls)
    int64_t chunk_rows = (1 << 18) / (dim > 0 ? dim : 1);
    if (chunk_rows < 1) chunk_rows = 1;

    std::atomic<int64_t> next(0);
    std::atomic<int64_t> failed(0);

    auto worker = [&]() {
        std::vector<float> scratch(static_cast<size_t>(chunk_rows) * dim);
        for (;;) {
            int64_t j = next.fetch_add(1, std::memory_order_relaxed);
            if (j >= nbags || failed.load(std::memory_order_relaxed)) return;
            int fd = ::open(paths[j], O_RDONLY);
            if (fd < 0) {
                int64_t expect = 0;
                failed.compare_exchange_strong(expect, j + 1);
                return;
            }
#ifdef POSIX_FADV_SEQUENTIAL
            ::posix_fadvise(fd, offsets[j], nrows[j] * dim * sizeof(float),
                            POSIX_FADV_SEQUENTIAL);
#endif
            int err = 0;
            for (int64_t r0 = 0; r0 < nrows[j] && !err; r0 += chunk_rows) {
                int64_t rows = nrows[j] - r0 < chunk_rows ? nrows[j] - r0 : chunk_rows;
                err = pread_full(fd, scratch.data(),
                                 static_cast<size_t>(rows) * dim * sizeof(float),
                                 offsets[j] + r0 * dim * static_cast<int64_t>(sizeof(float)));
                if (!err) emit_for_bag(j, r0, rows, scratch.data());
            }
            ::close(fd);
            if (err != 0) {
                int64_t expect = 0;
                failed.compare_exchange_strong(expect, j + 1);
                return;
            }
        }
    };

    if (nthreads <= 1) {
        worker();
    } else {
        std::vector<std::thread> threads;
        threads.reserve(nthreads);
        for (int32_t t = 0; t < nthreads; ++t) threads.emplace_back(worker);
        for (auto& t : threads) t.join();
    }
    return failed.load();
}

// Thread-pooled per-entry driver shared by the raw (non-converting)
// packers: opens entry j's file, hands (j, fd) to `read_entry` (which does
// the pread(s)), and marks the mask rows at dst_rows[j] on success. Keeps
// the fetch_add work loop / first-failure protocol / spawn-join logic in
// ONE place (pack_convert owns the converting variant).
template <typename ReadEntry>
int64_t pack_direct(const char** paths, const int64_t* nrows,
                    const int64_t* dst_rows, float* mask, int64_t nseg,
                    int32_t nthreads, ReadEntry read_entry) {
    if (nthreads <= 0) {
        nthreads = static_cast<int32_t>(std::thread::hardware_concurrency());
        if (nthreads <= 0) nthreads = 4;
    }
    if (nthreads > nseg) nthreads = static_cast<int32_t>(nseg > 0 ? nseg : 1);

    std::atomic<int64_t> next(0);
    std::atomic<int64_t> failed(0);  // 0 = ok, else j+1

    auto worker = [&]() {
        for (;;) {
            int64_t j = next.fetch_add(1, std::memory_order_relaxed);
            if (j >= nseg || failed.load(std::memory_order_relaxed)) return;
            int fd = ::open(paths[j], O_RDONLY);
            int err = fd < 0 ? (errno ? errno : EIO) : read_entry(j, fd);
            if (fd >= 0) ::close(fd);
            if (err != 0) {
                int64_t expect = 0;
                failed.compare_exchange_strong(expect, j + 1);
                return;
            }
            float* m = mask + dst_rows[j];
            for (int64_t r = 0; r < nrows[j]; ++r) m[r] = 1.0f;
        }
    };

    if (nthreads <= 1) {
        worker();
    } else {
        std::vector<std::thread> threads;
        threads.reserve(nthreads);
        for (int32_t t = 0; t < nthreads; ++t) threads.emplace_back(worker);
        for (auto& t : threads) t.join();
    }
    return failed.load();
}

}  // namespace

extern "C" {

// Fill a padded batch from raw contiguous payloads, segment-granular.
//   paths[j]    : file containing segment j
//   offsets[j]  : byte offset of segment j's float32 payload within the file
//   nrows[j]    : rows to read for segment j
//   dst_rows[j] : destination row index into the FLATTENED [nbags*bucket]
//                 batch (bag_slot*bucket + row_start_within_bag) — whole
//                 bags pass bag_slot*bucket; multi-file bags (patient-concat)
//                 pass one entry per slide file with cumulative row starts
//   dim         : feature dimension D
//   out         : [nbags, bucket, dim] float32 viewed flat, caller-zeroed
//   mask        : [nbags, bucket]      float32 viewed flat, caller-zeroed
//   nthreads    : worker threads (<=0 -> hardware_concurrency)
// Returns 0 on success, or (j+1) for the first segment whose read failed.
int64_t toad_pack_segs(const char** paths, const int64_t* offsets,
                       const int64_t* nrows, const int64_t* dst_rows,
                       int64_t dim, float* out, float* mask, int64_t nseg,
                       int32_t nthreads) {
    return pack_direct(
        paths, nrows, dst_rows, mask, nseg, nthreads, [=](int64_t j, int fd) {
#ifdef POSIX_FADV_SEQUENTIAL
            ::posix_fadvise(fd, offsets[j], nrows[j] * dim * sizeof(float),
                            POSIX_FADV_SEQUENTIAL);
#endif
            return pread_full(fd, out + dst_rows[j] * dim,
                              static_cast<size_t>(nrows[j]) * dim * sizeof(float),
                              offsets[j]);
        });
}

// Whole-bag convenience wrapper: bag j lands at batch slot j.
int64_t toad_pack_bags(const char** paths, const int64_t* offsets,
                       const int64_t* nrows, int64_t dim, int64_t bucket,
                       float* out, float* mask, int64_t nbags,
                       int32_t nthreads) {
    std::vector<int64_t> dst_rows(static_cast<size_t>(nbags > 0 ? nbags : 0));
    for (int64_t j = 0; j < nbags; ++j) dst_rows[j] = j * bucket;
    return toad_pack_segs(paths, offsets, nrows, dst_rows.data(), dim, out,
                          mask, nbags, nthreads);
}

// Like toad_pack_bags, but converts to bfloat16 on the fly (fused read +
// cast): the bf16 wire halves H2D bytes, and doing the cast here removes a
// full numpy pass over the batch on the (1-core) host.
//   out  : [nbags, bucket, dim] uint16 (bf16 bits), caller-zeroed
//   mask : [nbags, bucket] float32, caller-zeroed
int64_t toad_pack_segs_bf16(const char** paths, const int64_t* offsets,
                            const int64_t* nrows, const int64_t* dst_rows,
                            int64_t dim, uint16_t* out, float* mask,
                            int64_t nseg, int32_t nthreads) {
    return pack_convert(
        paths, offsets, nrows, dim, nseg, nthreads,
        [=](int64_t j, int64_t r0, int64_t rows, const float* src) {
            uint16_t* dst = out + (dst_rows[j] + r0) * dim;
            for (int64_t i = 0; i < rows * dim; ++i) dst[i] = f32_to_bf16(src[i]);
            float* m = mask + dst_rows[j] + r0;
            for (int64_t r = 0; r < rows; ++r) m[r] = 1.0f;
        });
}

int64_t toad_pack_bags_bf16(const char** paths, const int64_t* offsets,
                            const int64_t* nrows, int64_t dim, int64_t bucket,
                            uint16_t* out, float* mask, int64_t nbags,
                            int32_t nthreads) {
    std::vector<int64_t> dst_rows(static_cast<size_t>(nbags > 0 ? nbags : 0));
    for (int64_t j = 0; j < nbags; ++j) dst_rows[j] = j * bucket;
    return toad_pack_segs_bf16(paths, offsets, nrows, dst_rows.data(), dim,
                               out, mask, nbags, nthreads);
}

// Like toad_pack_bags, but emits the int8 wire (fused read + per-row dynamic
// quantization, ops/quantize.py::quantize_rows_np semantics): 4x fewer H2D
// bytes than f32 with no separate numpy quantization pass.
//   out_q  : [nbags, bucket, dim] int8, caller-zeroed
//   scales : [nbags, bucket] float32, caller-prefilled with a positive value
//            (padding rows keep it; q=0 rows are exact under any scale)
//   mask   : [nbags, bucket] float32, caller-zeroed
int64_t toad_pack_segs_int8(const char** paths, const int64_t* offsets,
                            const int64_t* nrows, const int64_t* dst_rows,
                            int64_t dim, int8_t* out_q, float* scales,
                            float* mask, int64_t nseg, int32_t nthreads) {
    return pack_convert(
        paths, offsets, nrows, dim, nseg, nthreads,
        [=](int64_t j, int64_t r0, int64_t rows, const float* src) {
            int8_t* dst = out_q + (dst_rows[j] + r0) * dim;
            float* s = scales + dst_rows[j] + r0;
            float* m = mask + dst_rows[j] + r0;
            for (int64_t r = 0; r < rows; ++r) {
                s[r] = quantize_row(src + r * dim, dst + r * dim, dim);
                m[r] = 1.0f;
            }
        });
}

int64_t toad_pack_bags_int8(const char** paths, const int64_t* offsets,
                            const int64_t* nrows, int64_t dim, int64_t bucket,
                            int8_t* out_q, float* scales, float* mask,
                            int64_t nbags, int32_t nthreads) {
    std::vector<int64_t> dst_rows(static_cast<size_t>(nbags > 0 ? nbags : 0));
    for (int64_t j = 0; j < nbags; ++j) dst_rows[j] = j * bucket;
    return toad_pack_segs_int8(paths, offsets, nrows, dst_rows.data(), dim,
                               out_q, scales, mask, nbags, nthreads);
}

// Read-through for int8 bag STORES (data/bags.py::save_int8_bag .npz): the
// rows are already quantized on disk, so both the int8 payload and the f32
// per-row scales pread straight into the wire buffers — zero host
// conversion of any kind (the dequantize->requantize round-trip the numpy
// fallback pays is skipped entirely).
//   q_offsets[j] : byte offset of bag j's int8 [nrows, dim] payload
//   s_offsets[j] : byte offset of bag j's f32 [nrows] scales payload
//   out_q  : [nbags, bucket, dim] int8, caller-zeroed
//   scales : [nbags, bucket] float32, caller-prefilled positive
//   mask   : [nbags, bucket] float32, caller-zeroed
int64_t toad_pack_segs_q8(const char** paths, const int64_t* q_offsets,
                          const int64_t* s_offsets, const int64_t* nrows,
                          const int64_t* dst_rows, int64_t dim, int8_t* out_q,
                          float* scales, float* mask, int64_t nseg,
                          int32_t nthreads) {
    return pack_direct(
        paths, nrows, dst_rows, mask, nseg, nthreads, [=](int64_t j, int fd) {
#ifdef POSIX_FADV_SEQUENTIAL
            ::posix_fadvise(fd, q_offsets[j], nrows[j] * dim, POSIX_FADV_SEQUENTIAL);
#endif
            int err = pread_full(fd, out_q + dst_rows[j] * dim,
                                 static_cast<size_t>(nrows[j]) * dim, q_offsets[j]);
            if (err) return err;
            return pread_full(fd, scales + dst_rows[j],
                              static_cast<size_t>(nrows[j]) * sizeof(float),
                              s_offsets[j]);
        });
}

int64_t toad_pack_bags_q8(const char** paths, const int64_t* q_offsets,
                          const int64_t* s_offsets, const int64_t* nrows,
                          int64_t dim, int64_t bucket, int8_t* out_q,
                          float* scales, float* mask, int64_t nbags,
                          int32_t nthreads) {
    std::vector<int64_t> dst_rows(static_cast<size_t>(nbags > 0 ? nbags : 0));
    for (int64_t j = 0; j < nbags; ++j) dst_rows[j] = j * bucket;
    return toad_pack_segs_q8(paths, q_offsets, s_offsets, nrows,
                             dst_rows.data(), dim, out_q, scales, mask, nbags,
                             nthreads);
}

// Version/ABI probe for the ctypes loader.
int32_t toad_bagio_abi_version() { return 4; }

}  // extern "C"
