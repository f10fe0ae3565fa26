"""Feature-bag readers: ``.pt`` (``torch.load``), ``.npy``, ``.npz`` and
``.h5`` (``features`` + ``coords``; needs h5py).

Counterpart of :func:`toad_tpu.data.bags.load_bag`: the same on-disk
contracts, returning numpy arrays.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch


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


def _sidecar_coords(path: Path) -> np.ndarray | None:
    """Coords for formats that cannot embed them: a ``{stem}.coords.npy`` sibling."""
    p = path.with_suffix(".coords.npy")
    return np.load(p) if p.exists() else None


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
