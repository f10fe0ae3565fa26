"""Writing feature bags (counterpart of :func:`toad_tpu.pipeline.featurize.write_bag`;
the featurizer itself is not ported yet)."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from toad_tpu_torch.data.bags import save_int8_bag


def write_bag(
    path: str | os.PathLike,
    features: np.ndarray,
    coords: np.ndarray | None = None,
    int8: bool = False,
) -> None:
    """Write a feature bag in the format the extension names: ``.npy``,
    ``.npz``, ``.pt`` (a bare f32 tensor) or ``.h5`` (features + coords;
    needs h5py). ``.npy`` and ``.pt`` cannot embed coords, which go to a
    ``{stem}.coords.npy`` sidecar. With ``int8=True`` (``.npz`` only) the
    rows are quantized on write (:func:`~toad_tpu_torch.data.bags.save_int8_bag`)."""
    path = Path(path)
    ext = path.suffix.lower()
    if int8:
        save_int8_bag(path, features, coords)
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    if ext == ".h5":
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"writing {path} needs h5py, which is not installed; write .pt, .npy or .npz") from e
        with h5py.File(path, "w") as f:
            f.create_dataset("features", data=features)
            if coords is not None:
                f.create_dataset("coords", data=coords)
    elif ext == ".npy":
        np.save(path, features)
    elif ext == ".npz":
        np.savez(path, features=features, **({"coords": coords} if coords is not None else {}))
    elif ext == ".pt":
        torch.save(torch.from_numpy(np.ascontiguousarray(features, np.float32)), path)
    else:
        raise ValueError(f"unsupported bag format: {path}")
    if coords is not None and ext in (".npy", ".pt"):
        np.save(path.with_suffix(".coords.npy"), coords)
