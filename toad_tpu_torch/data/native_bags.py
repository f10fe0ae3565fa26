"""Where a bag file's rows lie on disk, for the native loader.

Counterpart of :mod:`toad_tpu.data.native_bags`: maps a bag file to the
(byte offset, rows, dim) of its contiguous float32 payload, so that
:func:`toad_tpu_torch.native.pack_segs` can ``pread`` it straight into a
padded batch, with no array made in Python. Eligible (anything else resolves
to None, and the batcher reads the bag with numpy):

- ``.npy``  v1/v2/v3, dtype ``<f4``, C order, two dimensions;
- ``.pt``   a ``torch.save`` zip whose tensor (or its ``features``, ``feats``
  or ``x`` entry) is float32, contiguous, at storage offset 0, in a stored
  (uncompressed) member: the reference's bag format;
- ``.h5``   a ``features`` dataset that is contiguous (not chunked or
  compressed) float32 (needs h5py);
- ``.npz``  an int8 store (:func:`toad_tpu_torch.data.bags.save_int8_bag`:
  ``features_int8`` and ``scales``, stored), through
  :func:`resolve_payload_q8`.

A ``.pt`` file is read with a restricted unpickler of its own that makes no
tensor: it records each storage's key and type and each tensor's offset,
shape and strides, and refuses every global but the few a saved tensor
needs, so that resolving a file runs none of its code. The storage's zip
member is then found with :mod:`zipfile`.
"""

from __future__ import annotations

import ast
import collections
import io
import os
import pickle
import struct
import zipfile
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class PayloadInfo:
    path: str
    offset: int  # byte offset of the float32 payload
    nrows: int
    dim: int


@dataclass(frozen=True)
class SegmentedPayload:
    """A bag of several files in concatenation order (a patient's slides,
    :class:`toad_tpu_torch.data.wsi_dataset.PatientBagSplit`). ``nrows`` is
    the total; the batcher packs each part at its cumulative row offset."""

    parts: tuple  # PayloadInfo | Q8PayloadInfo, one per file
    nrows: int
    dim: int


@dataclass(frozen=True)
class Q8PayloadInfo:
    """An int8 store's raw payloads: the quantized rows and their per-row f32
    scales, read straight onto the int8 wire."""

    path: str
    offset: int  # byte offset of the int8 [nrows, dim] payload
    scales_offset: int  # byte offset of the f32 [nrows] scales payload
    nrows: int
    dim: int


def _read_npy_header(f) -> tuple[dict, int] | None:
    """(header dict, payload offset) of the npy array at ``f``'s position."""
    if f.read(6) != b"\x93NUMPY":
        return None
    major = f.read(2)[0]
    if major == 1:
        (hlen,) = struct.unpack("<H", f.read(2))
    else:
        (hlen,) = struct.unpack("<I", f.read(4))
    header = f.read(hlen).decode("latin1")
    offset = f.tell()
    try:
        meta = ast.literal_eval(header)
    except (ValueError, SyntaxError):
        return None
    if not isinstance(meta, dict) or meta.get("fortran_order"):
        return None
    return meta, offset


def _stored_member_data(f, header_offset: int) -> int | None:
    """Byte offset of a stored (uncompressed) zip member's data, from its
    local file header (the central directory's extra field can differ)."""
    f.seek(header_offset)
    lh = f.read(30)
    if len(lh) != 30 or lh[:4] != b"PK\x03\x04":
        return None
    if struct.unpack("<H", lh[8:10])[0] != 0:  # ZIP_STORED only
        return None
    name_len, extra_len = struct.unpack("<HH", lh[26:30])
    return header_offset + 30 + name_len + extra_len


def _npy_member_payload(f, header_offset: int):
    """(descr, shape, payload offset) of a stored npy zip member, or None."""
    data = _stored_member_data(f, header_offset)
    if data is None:
        return None
    f.seek(data)
    got = _read_npy_header(f)
    if got is None:
        return None
    meta, payload_offset = got
    return meta.get("descr"), tuple(meta.get("shape", ())), payload_offset


def resolve_payload_q8(path: str | os.PathLike) -> Q8PayloadInfo | None:
    """Q8PayloadInfo for an int8 store (.npz with ``features_int8`` int8
    [N, D] and ``scales`` f32 [N], both stored), else None (the batcher then
    reads it with numpy, which dequantizes)."""
    path = Path(path)
    try:
        if path.suffix.lower() != ".npz":
            return None
        with open(path, "rb") as f:
            with zipfile.ZipFile(f) as zf:
                infos = {i.filename: i.header_offset for i in zf.infolist()}
            if "features_int8.npy" not in infos or "scales.npy" not in infos:
                return None
            q = _npy_member_payload(f, infos["features_int8.npy"])
            s = _npy_member_payload(f, infos["scales.npy"])
        if q is None or s is None:
            return None
        (q_descr, q_shape, q_off), (s_descr, s_shape, s_off) = q, s
        if q_descr != "|i1" or len(q_shape) != 2 or s_descr != "<f4" or s_shape != (q_shape[0],):
            return None
        return Q8PayloadInfo(str(path), q_off, s_off, int(q_shape[0]), int(q_shape[1]))
    except Exception:
        return None


def _resolve_npy(path: Path) -> PayloadInfo | None:
    with open(path, "rb") as f:
        got = _read_npy_header(f)
    if got is None:
        return None
    meta, offset = got
    shape = meta.get("shape", ())
    if meta.get("descr") != "<f4" or len(shape) != 2:
        return None
    return PayloadInfo(str(path), offset, int(shape[0]), int(shape[1]))


# -- .pt: the pickle's structure, without making a tensor ------------------------


class _StorageType:
    """Stands for a ``torch.<Name>Storage`` global; only its name is read."""

    def __init__(self, name: str) -> None:
        self.name = name


@dataclass(frozen=True)
class _MetaStorage:
    key: str
    type_name: str
    numel: int


@dataclass(frozen=True)
class _MetaTensor:
    storage: _MetaStorage
    storage_offset: int
    shape: tuple
    stride: tuple

    @property
    def contiguous(self) -> bool:
        expect = 1
        for dim, st in zip(reversed(self.shape), reversed(self.stride)):
            if dim > 1 and st != expect:
                return False
            expect *= dim
        return True


def _rebuild_meta(storage, storage_offset, size, stride, *unused) -> _MetaTensor:
    if not isinstance(storage, _MetaStorage):
        raise pickle.UnpicklingError("a tensor without a storage")
    return _MetaTensor(storage, int(storage_offset), tuple(int(s) for s in size), tuple(int(s) for s in stride))


class _MetaUnpickler(pickle.Unpickler):
    """Unpickles a ``torch.save`` archive's ``data.pkl`` into plain
    containers and :class:`_MetaTensor` records; every global outside the
    few a saved tensor uses raises."""

    def persistent_load(self, pid):
        if not isinstance(pid, tuple) or len(pid) < 5 or pid[0] != "storage":
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r:.60}")
        storage_type, key, _location, numel = pid[1], pid[2], pid[3], pid[4]
        name = storage_type.name if isinstance(storage_type, _StorageType) else type(storage_type).__name__
        return _MetaStorage(str(key), name, int(numel))

    def find_class(self, module, name):
        if module == "torch._utils" and name in ("_rebuild_tensor_v2", "_rebuild_tensor"):
            return _rebuild_meta
        if module == "torch" and name.endswith("Storage"):
            return _StorageType(name)
        if module == "torch" and name == "Size":
            return tuple
        if module == "collections" and name == "OrderedDict":
            return collections.OrderedDict
        raise pickle.UnpicklingError(f"{module}.{name} is not part of a saved feature tensor")


def _resolve_pt(path: Path) -> PayloadInfo | None:
    with zipfile.ZipFile(path) as zf:
        pkl = next((n for n in zf.namelist() if n.endswith("data.pkl")), None)
        if pkl is None:
            return None
        prefix = pkl[: -len("data.pkl")]
        obj = _MetaUnpickler(io.BytesIO(zf.read(pkl))).load()
        tensor = obj if isinstance(obj, _MetaTensor) else None
        if isinstance(obj, dict):
            tensor = next((obj[k] for k in ("features", "feats", "x") if isinstance(obj.get(k), _MetaTensor)), None)
        if tensor is None or tensor.storage.type_name != "FloatStorage" or tensor.storage_offset != 0 \
                or not tensor.contiguous or len(tensor.shape) != 2:
            return None
        member = zf.getinfo(f"{prefix}data/{tensor.storage.key}")
        if member.compress_type != zipfile.ZIP_STORED or member.file_size < tensor.shape[0] * tensor.shape[1] * 4:
            return None
    with open(path, "rb") as f:
        offset = _stored_member_data(f, member.header_offset)
    if offset is None:
        return None
    return PayloadInfo(str(path), offset, tensor.shape[0], tensor.shape[1])


def _resolve_h5(path: Path) -> PayloadInfo | None:
    import h5py
    import numpy as np

    with h5py.File(path, "r") as f:
        if "features" not in f:
            return None
        ds = f["features"]
        if ds.dtype != np.dtype("<f4") or ds.chunks is not None or ds.compression is not None or len(ds.shape) != 2:
            return None
        offset = ds.id.get_offset()
        if offset is None:
            return None
        return PayloadInfo(str(path), int(offset), int(ds.shape[0]), int(ds.shape[1]))


def resolve_payload(path: str | os.PathLike) -> PayloadInfo | None:
    """PayloadInfo for a float32 bag file, or None when the native loader
    cannot read it (the batcher then reads it with numpy, which raises the
    descriptive error for a missing or broken file)."""
    path = Path(path)
    resolve = {".npy": _resolve_npy, ".pt": _resolve_pt, ".h5": _resolve_h5}.get(path.suffix.lower())
    if resolve is None:
        return None
    try:
        return resolve(path)
    except Exception:  # unreadable, truncated, or (.h5) no h5py: ineligible
        return None
