"""Build the package's CUDA kernels on first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` of the package for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface. The library lands in the package's
git-ignored ``_build/`` directory under a name keyed by a hash of the sources
and flags, so an edited kernel rebuilds and an unchanged one loads at once.
Nothing is built at import time: :func:`load_library` runs on the first
kernel launch.
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

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # each kernel's registers, shared memory and spills, kept in build_log
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc runs (None: loaded from cache)
build_log = ""  # what nvcc and ptxas printed for each source in the last build

# every pointer and the stream go as c_void_p: a bare Python int would be cut to 32 bits
_p, _i = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "toad_pool_rows_per_tile": ([_i], ctypes.c_int),
    "toad_pool_smem_bytes": ([_i, _i, _i], ctypes.c_longlong),
    "toad_pool_forward": (
        [_i, _p, _p, _i, _i, _i, _i, _i,  # dtype, x, mask, B, N, D, H, A
         _p, _p, _p, _p, _p, _p, _p, _p,  # w1t, b1, w2t, b2, wabt, bab, wc, bc
         _i, _i,  # tiles_per_split, n_splits
         _p, _p, _p, _p, _p],  # scores, part_acc, part_stat, out, stream
        ctypes.c_int,
    ),
    "toad_pool_partial_forward": (
        [_i, _p, _p, _i, _i, _i, _i, _i,  # dtype, x, mask, B, N, D, H, A
         _p, _p, _p, _p, _p, _p, _p, _p,  # w1t, b1, w2t, b2, wabt, bab, wc, bc
         _i, _i,  # tiles_per_split, n_splits
         _p, _p, _p, _p, _p],  # part_acc, part_stat, acc, stats, stream
        ctypes.c_int,
    ),
    "toad_pool_combine_shards": ([_p, _p, _i, _i, _i, _p, _p], ctypes.c_int),  # acc, stats, S, B, H, out, stream
    "toad_pool_int8_rows_per_tile": ([], ctypes.c_int),
    "toad_pool_int8_smem_bytes": ([_i], ctypes.c_longlong),
    "toad_pool_int8_forward": (
        [_p, _p, _p, _i, _i, _i, _i, _i,  # xq, sx, mask, B, N, D, H, A
         _p, _p, _p, _p, _p, _p, _p, _p, _p,  # w1t, sw1, b1, w2t, sw2, b2, wabt, swab, bab
         _p, _p,  # wc, bc
         _i, _i,  # tiles_per_split, n_splits
         _p, _p, _p, _p, _p],  # scores, part_acc, part_stat, out, stream
        ctypes.c_int,
    ),
    "toad_mha_head_dim": ([], ctypes.c_int),
    "toad_mha_max_tokens": ([_i], ctypes.c_int),
    "toad_mha_smem_bytes": ([_i, _i], ctypes.c_longlong),
    "toad_mha_forward": (
        [_i, _p, _p, _i, _i, _i, _i, ctypes.c_float, _p],  # dtype, qkv, out, B, N, H, Dh, scale, stream
        ctypes.c_int,
    ),
    "toad_stage_tile": ([_i, _i, _i], ctypes.c_int),  # dtype, width, stride
    "toad_stage_smem_bytes": ([_i, _i, _i], ctypes.c_longlong),
    "toad_stage_block_forward": (
        [_i, _p, _p, _i, _i, _i, _i, _i, _i, _i,  # dtype, x, out, B, H, W, Cin, width, Cout, stride
         _p, _p, _p, _p, _p, _p, _p, _p, _p],  # w1, b1, w2, b2, w3, b3, wd, bd, stream
        ctypes.c_int,
    ),
    "toad_cuda_error_string": ([_i], ctypes.c_char_p),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {candidate} and on PATH): cannot build the CUDA kernels")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtoad_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; their output, or RuntimeError naming
    the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, text in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
    return outs


def _compile(out: Path) -> None:
    global build_seconds, build_log
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        srcs = sorted(CSRC_DIR.glob("*.cu"))
        objs = [tmp / f"{src.stem}.o" for src in srcs]
        t0 = time.perf_counter()
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(srcs, objs)])
        lib = tmp / "lib.so"
        _run_all([[nvcc, "-shared", "-o", str(lib), *map(str, objs)]])
        build_seconds = time.perf_counter() - t0
        build_log = "\n".join(f"{src.name}:\n{text}" for src, text in zip(srcs, logs))
        os.replace(lib, out)  # atomic: a concurrent loader never sees a partial file
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call of the process
    (or found in ``_build/`` from an earlier one)."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _compile(out)
            lib = ctypes.CDLL(str(out))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def is_loaded() -> bool:
    return _lib is not None
