"""Build the package's CUDA kernels on first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` of the package for ``sm_90a`` into one
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc run (None: loaded from cache)

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


def _compile(out: Path) -> None:
    global build_seconds
    cu = [str(p) for p in sorted(CSRC_DIR.glob("*.cu"))]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file


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
