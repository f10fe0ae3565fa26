"""The native bag loader (``csrc/bagio.cpp``), built at first use and bound
with ctypes.

Counterpart of :mod:`toad_tpu.native`: the same entry points (``pack_bags*``
for whole bags, ``pack_segs*`` for bags split into segments at given rows),
the same argument checks in front of every raw-pointer write. ``g++ -O3
-shared -fPIC -pthread -std=c++17`` compiles the source on the first call of
a process into the package's git-ignored ``_build/`` directory, under a name
keyed by a hash of the source and the command, and the library is renamed
into place atomically, so that concurrent builders never load a partial file.
Nothing is built at import time.

One deliberate difference from the JAX package: there a library that does not
build lets the batcher fall back to numpy without a word. Here a failed build
or load raises :class:`NativeBuildError` with the compiler's message, and the
batcher, asked for the native feed or finding every bag eligible for it,
passes it on. Without a compiler, ``train --native_io off`` (or
``native='off'`` to ``BagBatcher``, ``DataConfig`` or ``evaluate_split``)
reads the bags with numpy; ``eval`` has no such flag and needs the compiler
for a store the native feed reads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "bagio.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
ABI_VERSION = 4
_WITHOUT = ("; to read the bags with numpy instead pass `train --native_io off` (native='off' to BagBatcher,"
            " DataConfig or evaluate_split); `eval` has no such flag: set CXX to a working C++17 compiler")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the last compile (None: loaded from _build/)
build_command: list[str] | None = None  # the compile command of this process, if it compiled


class NativeBuildError(RuntimeError):
    """The native bag loader did not build or load."""


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    """Where the library for this source and compile command lives."""
    h = hashlib.sha256(" ".join((_compiler(), *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libbagio_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    global build_seconds, build_command
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out.parent))
    cmd = [_compiler(), *CXX_FLAGS, str(SOURCE), "-o", str(tmp / out.name)]
    try:
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"native bag loader: `{' '.join(cmd)}` could not run: {e}{_WITHOUT}") from e
        if proc.returncode != 0:
            raise NativeBuildError(f"native bag loader: `{' '.join(cmd)}` failed ({proc.returncode}):\n"
                                   f"{(proc.stderr or proc.stdout).strip()[-2000:]}{_WITHOUT}")
        os.replace(tmp / out.name, out)  # atomic: a concurrent loader never sees a partial file
        build_seconds = time.perf_counter() - t0
        build_command = cmd
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _bind(lib: ctypes.CDLL) -> None:
    i64p, f32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float)
    i8p, u16p = ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint16)
    paths = ctypes.POINTER(ctypes.c_char_p)
    tail = [ctypes.c_int64, ctypes.c_int32]  # entries, threads
    # (paths, offsets, nrows, dim, bucket, <outputs>, nbags, nthreads)
    bags = [paths, i64p, i64p, ctypes.c_int64, ctypes.c_int64]
    # (paths, offsets, nrows, dst_rows, dim, <outputs>, nseg, nthreads)
    segs = [paths, i64p, i64p, i64p, ctypes.c_int64]
    signatures = {
        "toad_pack_bags": bags + [f32p, f32p] + tail,
        "toad_pack_bags_bf16": bags + [u16p, f32p] + tail,
        "toad_pack_bags_int8": bags + [i8p, f32p, f32p] + tail,
        # (paths, q_offsets, s_offsets, nrows, dim, bucket, ...)
        "toad_pack_bags_q8": [paths, i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, i8p, f32p, f32p] + tail,
        "toad_pack_segs": segs + [f32p, f32p] + tail,
        "toad_pack_segs_bf16": segs + [u16p, f32p] + tail,
        "toad_pack_segs_int8": segs + [i8p, f32p, f32p] + tail,
        # (paths, q_offsets, s_offsets, nrows, dst_rows, dim, ...)
        "toad_pack_segs_q8": [paths, i64p, i64p, i64p, i64p, ctypes.c_int64, i8p, f32p, f32p] + tail,
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int64


def get_lib() -> ctypes.CDLL:
    """The library, compiled on the first call of the process (or found in
    ``_build/`` from an earlier one). Raises :class:`NativeBuildError`."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _compile(out)
            try:
                lib = ctypes.CDLL(str(out))
                lib.toad_bagio_abi_version.restype = ctypes.c_int32
                abi = lib.toad_bagio_abi_version()
                if abi != ABI_VERSION:
                    raise NativeBuildError(f"native bag loader: {out} has ABI {abi}, expected {ABI_VERSION}")
                _bind(lib)
            except (OSError, AttributeError) as e:
                raise NativeBuildError(f"native bag loader: {out} did not load: {e}{_WITHOUT}") from e
            _lib = lib
        return _lib


def _check_buf(name: str, buf: np.ndarray, shape: tuple, dtype) -> None:
    # real checks, not asserts: they guard raw-pointer C writes and must
    # survive python -O
    if buf.shape != shape or buf.dtype != dtype or not buf.flags.c_contiguous or not buf.flags.writeable:
        raise ValueError(
            f"{name} must be a writeable C-contiguous {np.dtype(dtype).name} {shape}, got "
            f"{buf.dtype} {buf.shape} contiguous={buf.flags.c_contiguous} writeable={buf.flags.writeable}"
        )


def _pack_common(paths, offsets, nrows, bucket):
    """Validate and marshal the shared (paths, offsets, nrows) arguments."""
    lib = get_lib()
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    offsets = np.ascontiguousarray(offsets, np.int64)
    nrows = np.ascontiguousarray(nrows, np.int64)
    if offsets.shape != (n,) or nrows.shape != (n,):
        raise ValueError(f"offsets/nrows must be length {n}, got {offsets.shape}/{nrows.shape}")
    if n and (int(nrows.min()) < 0 or int(nrows.max()) > bucket):
        raise ValueError(
            f"nrows must lie in [0, bucket={bucket}] (row {int(np.argmax(nrows))} has "
            f"{int(nrows.max())}): an oversized row count would overrun the next bag's slice"
        )
    if n and int(offsets.min()) < 0:
        raise ValueError("offsets must be non-negative file positions")
    return lib, n, c_paths, offsets, nrows


def _check_offsets(s_offsets, n: int) -> np.ndarray:
    s_offsets = np.ascontiguousarray(s_offsets, np.int64)
    if s_offsets.shape != (n,):
        raise ValueError(f"s_offsets must be shape {(n,)}, got {s_offsets.shape}")
    if n and int(s_offsets.min()) < 0:
        raise ValueError("s_offsets must be non-negative file positions")
    return s_offsets


def _raise_on_rc(rc: int, paths, offsets, nrows) -> None:
    if rc != 0:
        j = int(rc) - 1
        raise OSError(f"native bag read failed for {paths[j]} (offset {int(offsets[j])}, rows {int(nrows[j])})")


def _p(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def pack_bags(paths, offsets, nrows, dim: int, bucket: int, out: np.ndarray, mask: np.ndarray,
              nthreads: int = 0) -> None:
    """Read bag j's float32 payload into ``out[j]`` ([B, bucket, dim], zero
    where no bag row lands) and set its rows of ``mask``. Raises on any read
    failure."""
    lib, n, c_paths, offsets, nrows = _pack_common(paths, offsets, nrows, bucket)
    _check_buf("out", out, (n, bucket, dim), np.float32)
    _check_buf("mask", mask, (n, bucket), np.float32)
    rc = lib.toad_pack_bags(c_paths, _p(offsets, ctypes.c_int64), _p(nrows, ctypes.c_int64), dim, bucket,
                            _p(out, ctypes.c_float), _p(mask, ctypes.c_float), n, nthreads)
    _raise_on_rc(rc, paths, offsets, nrows)


def pack_bags_bf16(paths, offsets, nrows, dim: int, bucket: int, out: np.ndarray, mask: np.ndarray,
                   nthreads: int = 0) -> None:
    """Read and cast to bf16 (nearest even) in one pass: ``out`` is a uint16
    view of a bf16 buffer."""
    lib, n, c_paths, offsets, nrows = _pack_common(paths, offsets, nrows, bucket)
    _check_buf("out", out, (n, bucket, dim), np.uint16)
    _check_buf("mask", mask, (n, bucket), np.float32)
    rc = lib.toad_pack_bags_bf16(c_paths, _p(offsets, ctypes.c_int64), _p(nrows, ctypes.c_int64), dim, bucket,
                                 _p(out, ctypes.c_uint16), _p(mask, ctypes.c_float), n, nthreads)
    _raise_on_rc(rc, paths, offsets, nrows)


def pack_bags_int8(paths, offsets, nrows, dim: int, bucket: int, out_q: np.ndarray, scales: np.ndarray,
                   mask: np.ndarray, nthreads: int = 0) -> None:
    """Read and quantize per row in one pass (the exact twin of
    :func:`toad_tpu_torch.ops.quantize.quantize_rows_np`); ``scales`` keeps
    the caller's positive value on padding rows (q = 0 there: exact under any
    scale)."""
    lib, n, c_paths, offsets, nrows = _pack_common(paths, offsets, nrows, bucket)
    _check_buf("out_q", out_q, (n, bucket, dim), np.int8)
    _check_buf("scales", scales, (n, bucket), np.float32)
    _check_buf("mask", mask, (n, bucket), np.float32)
    rc = lib.toad_pack_bags_int8(c_paths, _p(offsets, ctypes.c_int64), _p(nrows, ctypes.c_int64), dim, bucket,
                                 _p(out_q, ctypes.c_int8), _p(scales, ctypes.c_float), _p(mask, ctypes.c_float),
                                 n, nthreads)
    _raise_on_rc(rc, paths, offsets, nrows)


def pack_bags_q8(paths, q_offsets, s_offsets, nrows, dim: int, bucket: int, out_q: np.ndarray,
                 scales: np.ndarray, mask: np.ndarray, nthreads: int = 0) -> None:
    """Read an int8 store's rows and scales (:func:`toad_tpu_torch.data.
    native_bags.resolve_payload_q8`) straight into the int8 wire's planes,
    with no dequantization and requantization."""
    lib, n, c_paths, q_offsets, nrows = _pack_common(paths, q_offsets, nrows, bucket)
    s_offsets = _check_offsets(s_offsets, n)
    _check_buf("out_q", out_q, (n, bucket, dim), np.int8)
    _check_buf("scales", scales, (n, bucket), np.float32)
    _check_buf("mask", mask, (n, bucket), np.float32)
    rc = lib.toad_pack_bags_q8(c_paths, _p(q_offsets, ctypes.c_int64), _p(s_offsets, ctypes.c_int64),
                               _p(nrows, ctypes.c_int64), dim, bucket, _p(out_q, ctypes.c_int8),
                               _p(scales, ctypes.c_float), _p(mask, ctypes.c_float), n, nthreads)
    _raise_on_rc(rc, paths, q_offsets, nrows)


def _check_dst_rows(dst_rows, nrows: np.ndarray, n: int, b: int, bucket: int) -> np.ndarray:
    """Every segment must land inside one bag slot (row_start + nrows <=
    bucket) and inside the [b, bucket] buffer. Guards raw C writes."""
    dst_rows = np.ascontiguousarray(dst_rows, np.int64)
    if dst_rows.shape != (n,):
        raise ValueError(f"dst_rows must be shape {(n,)}, got {dst_rows.shape}")
    if n == 0:
        return dst_rows
    if int(dst_rows.min()) < 0:
        raise ValueError("dst_rows must be non-negative")
    if int((dst_rows % bucket + nrows).max()) > bucket:
        raise ValueError("a segment crosses its bag slot (row_start + nrows > bucket)")
    if int((dst_rows + nrows).max()) > b * bucket:
        raise ValueError("a segment lands past the end of the batch buffer")
    return dst_rows


def _seg_common(paths, offsets, nrows, dst_rows, mask: np.ndarray):
    b, bucket = mask.shape if mask.ndim == 2 else (0, 0)
    lib, n, c_paths, offsets, nrows = _pack_common(paths, offsets, nrows, bucket)
    _check_buf("mask", mask, (b, bucket), np.float32)
    return lib, n, b, bucket, c_paths, offsets, nrows, _check_dst_rows(dst_rows, nrows, n, b, bucket)


def pack_segs(paths, offsets, nrows, dst_rows, dim: int, out: np.ndarray, mask: np.ndarray, nthreads: int = 0) -> None:
    """Segment-granular :func:`pack_bags`: entry j lands at flattened row
    ``dst_rows[j]`` of the [B, bucket, dim] buffer. A bag of several files (a
    patient's slides) passes one entry per file at cumulative row starts."""
    lib, n, b, bucket, c_paths, offsets, nrows, dst_rows = _seg_common(paths, offsets, nrows, dst_rows, mask)
    _check_buf("out", out, (b, bucket, dim), np.float32)
    rc = lib.toad_pack_segs(c_paths, _p(offsets, ctypes.c_int64), _p(nrows, ctypes.c_int64),
                            _p(dst_rows, ctypes.c_int64), dim, _p(out, ctypes.c_float), _p(mask, ctypes.c_float),
                            n, nthreads)
    _raise_on_rc(rc, paths, offsets, nrows)


def pack_segs_bf16(paths, offsets, nrows, dst_rows, dim: int, out: np.ndarray, mask: np.ndarray,
                   nthreads: int = 0) -> None:
    """Segment-granular :func:`pack_bags_bf16` (``out`` a uint16 view of bf16)."""
    lib, n, b, bucket, c_paths, offsets, nrows, dst_rows = _seg_common(paths, offsets, nrows, dst_rows, mask)
    _check_buf("out", out, (b, bucket, dim), np.uint16)
    rc = lib.toad_pack_segs_bf16(c_paths, _p(offsets, ctypes.c_int64), _p(nrows, ctypes.c_int64),
                                 _p(dst_rows, ctypes.c_int64), dim, _p(out, ctypes.c_uint16),
                                 _p(mask, ctypes.c_float), n, nthreads)
    _raise_on_rc(rc, paths, offsets, nrows)


def pack_segs_int8(paths, offsets, nrows, dst_rows, dim: int, out_q: np.ndarray, scales: np.ndarray,
                   mask: np.ndarray, nthreads: int = 0) -> None:
    """Segment-granular :func:`pack_bags_int8`. Quantization is per row, so a
    bag quantized segment by segment equals the concatenated bag quantized."""
    lib, n, b, bucket, c_paths, offsets, nrows, dst_rows = _seg_common(paths, offsets, nrows, dst_rows, mask)
    _check_buf("out_q", out_q, (b, bucket, dim), np.int8)
    _check_buf("scales", scales, (b, bucket), np.float32)
    rc = lib.toad_pack_segs_int8(c_paths, _p(offsets, ctypes.c_int64), _p(nrows, ctypes.c_int64),
                                 _p(dst_rows, ctypes.c_int64), dim, _p(out_q, ctypes.c_int8),
                                 _p(scales, ctypes.c_float), _p(mask, ctypes.c_float), n, nthreads)
    _raise_on_rc(rc, paths, offsets, nrows)


def pack_segs_q8(paths, q_offsets, s_offsets, nrows, dst_rows, dim: int, out_q: np.ndarray, scales: np.ndarray,
                 mask: np.ndarray, nthreads: int = 0) -> None:
    """Segment-granular :func:`pack_bags_q8` (int8-store read-through)."""
    lib, n, b, bucket, c_paths, q_offsets, nrows, dst_rows = _seg_common(paths, q_offsets, nrows, dst_rows, mask)
    s_offsets = _check_offsets(s_offsets, n)
    _check_buf("out_q", out_q, (b, bucket, dim), np.int8)
    _check_buf("scales", scales, (b, bucket), np.float32)
    rc = lib.toad_pack_segs_q8(c_paths, _p(q_offsets, ctypes.c_int64), _p(s_offsets, ctypes.c_int64),
                               _p(nrows, ctypes.c_int64), _p(dst_rows, ctypes.c_int64), dim,
                               _p(out_q, ctypes.c_int8), _p(scales, ctypes.c_float), _p(mask, ctypes.c_float),
                               n, nthreads)
    _raise_on_rc(rc, paths, q_offsets, nrows)
