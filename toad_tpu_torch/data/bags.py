"""Feature-bag readers: ``.pt`` (``torch.load``), ``.npy``, ``.npz`` and
``.h5`` (``features`` + ``coords``; needs h5py).

Counterpart of :mod:`toad_tpu.data.bags`: the same on-disk contracts,
returning numpy arrays. int8 stores (:func:`save_int8_bag`) are ``.npz``
files with ``features_int8`` [N, D] int8, ``scales`` [N] f32 and optionally
``coords``, so a store written by either package reads in the other.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from toad_tpu_torch.ops.quantize import quantize_rows_np


def load_pt_tensor(path: str | os.PathLike) -> np.ndarray:
    """A ``torch.save``d tensor, or a dict holding it under ``features``,
    ``feats`` or ``x``. bf16 widens to f32 (exactly)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        key = next((k for k in ("features", "feats", "x") if k in obj), None)
        if key is None:
            raise ValueError(f"{path}: dict payload without a 'features' entry (keys: {list(obj)})")
        obj = obj[key]
    if not isinstance(obj, torch.Tensor):
        raise ValueError(f"{path}: expected a tensor, got {type(obj)}")
    if obj.dtype == torch.bfloat16:
        obj = obj.float()
    return obj.numpy()


def load_h5_bag(path: str | os.PathLike, with_coords: bool = False):
    """``features`` (+ ``coords``) from an h5 bag."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"reading {path} needs h5py, which is not installed; store bags as .pt or .npy") from e
    with h5py.File(path, "r") as f:
        features = np.asarray(f["features"][:])
        coords = f["coords"][:] if (with_coords and "coords" in f) else None
    return (features, coords) if with_coords else features


def bag_path(data_dir: str | os.PathLike, slide_id: str, use_h5: bool = False) -> Path:
    """The on-disk bag file of a slide: the requested format first, then any
    of .pt, .h5, .npy, .npz, so that converted stores just work."""
    d = Path(data_dir)
    preferred = ".h5" if use_h5 else ".pt"
    for ext in dict.fromkeys([preferred, ".pt", ".h5", ".npy", ".npz"]):
        p = d / f"{slide_id}{ext}"
        if p.exists():
            return p
    return d / f"{slide_id}{preferred}"  # let the open fail with a clear path


def bag_shape(path: str | os.PathLike) -> tuple[int, ...]:
    """(n_patches, dim) from file metadata without reading the payload: .npy
    from the memory-mapped header, .npz from the zip member's npy header, .pt
    from a memory-mapped ``torch.load``, .h5 from the dataset's shape. Serves
    the batcher's exact ``__len__`` and the auto bucket ladder at O(1) IO per
    bag."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".npy":
        return tuple(np.load(path, mmap_mode="r").shape)
    if ext == ".pt":
        obj = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        if isinstance(obj, dict):
            obj = next((obj[k] for k in ("features", "feats", "x") if k in obj), None)
        if not isinstance(obj, torch.Tensor):
            raise ValueError(f"{path}: expected a tensor or a dict with a 'features' entry")
        return tuple(obj.shape)
    if ext == ".npz":
        import zipfile

        with zipfile.ZipFile(path) as zf:
            names = zf.namelist()
            member = next((w for w in ("features_int8.npy", "features.npy") if w in names), names[0])
            with zf.open(member) as fp:
                version = np.lib.format.read_magic(fp)
                read_header = {
                    (1, 0): np.lib.format.read_array_header_1_0,
                    (2, 0): np.lib.format.read_array_header_2_0,
                }[version]
                shape, _, _ = read_header(fp)
        return tuple(shape)
    if ext == ".h5":
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"reading {path} needs h5py, which is not installed; store bags as .pt or .npy") from e
        with h5py.File(path, "r") as f:
            return tuple(f["features"].shape)
    raise ValueError(f"unsupported bag format: {path}")


def _sidecar_coords(path: Path) -> np.ndarray | None:
    """Coords for formats that cannot embed them: a ``{stem}.coords.npy`` sibling."""
    p = path.with_suffix(".coords.npy")
    return np.load(p) if p.exists() else None


def save_int8_bag(path: str | os.PathLike, features: np.ndarray, coords: np.ndarray | None = None) -> None:
    """Write a row-quantized int8 bag: 4x smaller than f32, and the int8
    serving path reads it without quantizing again (:func:`load_bag_quantized`)."""
    path = Path(path)
    if path.suffix.lower() != ".npz":
        raise ValueError(f"int8 bags are .npz files, got {path}")
    path.parent.mkdir(parents=True, exist_ok=True)
    xq, scales = quantize_rows_np(features)
    payload = {"features_int8": xq, "scales": scales}
    if coords is not None:
        payload["coords"] = coords
    np.savez(path, **payload)


def load_bag_quantized(path: str | os.PathLike):
    """(xq int8 [N, D], scales f32 [N], coords or None) from an int8 bag, or
    None if the file is not one (the caller then loads and quantizes)."""
    path = Path(path)
    if path.suffix.lower() != ".npz":
        return None
    z = np.load(path)
    if "features_int8" not in z.files:
        return None
    return z["features_int8"], z["scales"], (z["coords"] if "coords" in z.files else None)


def load_bag(path: str | os.PathLike, with_coords: bool = False):
    """A feature bag [N, D] from any supported format. int8 ``.npz`` bags
    dequantize to f32."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext in (".pt", ".npy"):
        feats = load_pt_tensor(path) if ext == ".pt" else np.load(path)
        return (feats, _sidecar_coords(path)) if with_coords else feats
    if ext == ".h5":
        return load_h5_bag(path, with_coords=with_coords)
    if ext == ".npz":
        z = np.load(path)
        if "features_int8" in z.files:
            feats = z["features_int8"].astype(np.float32) * z["scales"][:, None]
        else:
            feats = z["features"] if "features" in z.files else z[z.files[0]]
        coords = z["coords"] if "coords" in z.files else None
        return (feats, coords) if with_coords else feats
    raise ValueError(f"unsupported bag format: {path}")
