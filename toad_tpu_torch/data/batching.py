"""Bucketed bag batching with padding masks, threaded prefetch and a pinned
host-to-device feed.

PyTorch counterpart of :mod:`toad_tpu.data.batching`:

- each bag's length N is rounded up to a bucket size; bags in a batch share
  one bucket, so the device sees a small, fixed set of shapes;
- a batch is ``[B, N_bucket, D]`` features + ``[B, N_bucket]`` patch mask +
  ``[B]`` bag-validity mask (partial final batches are padded with bags of
  ``bag_mask`` 0 and an all-zero patch mask, never ragged);
- finished batches are queued ahead of the training step by a producer
  thread.

Sampling modes mirror the reference: sequential, shuffled, class-balanced
with replacement, and the 1% ``--testing`` subsample. The epoch's order is
drawn from ``np.random.RandomState`` exactly as the JAX package draws it, so
both packages see the same batches in the same order.

Two feeds fill a batch, and give the same bytes:

- the native feed (``native='auto'`` or ``'on'``): every bag's rows are
  located on disk once per batcher (:mod:`toad_tpu_torch.data.native_bags`),
  and for each batch ``num_workers`` C++ threads read them with one
  ``pread`` per file, cast or quantized on the way
  (:mod:`toad_tpu_torch.native`). Under ``'auto'`` a split takes it when
  every bag resolves (``.npy``, ``.pt``, contiguous ``.h5``; int8 stores on
  the int8 wire) to one feature dim; ``'on'`` raises where one does not, and
  a loader that does not build raises in both;
- the numpy feed (``'off'``, or a split the native one cannot read): bag IO
  in a thread pool, then padding, casting and quantizing in the producer
  thread.

Three wires carry the features to the device: float32, bfloat16 (cast on the
host) and, for quantized evaluation only, int8: the real rows of every bag
are quantized per row and travel with their f32 scales, a quarter of the
float32 bytes.

With a CUDA ``device`` the producer thread also starts the copy to the card:
each batch lies in one of a small ring of pinned host buffers (the native
feed packs it there directly; the numpy feed copies it in, cast to the wire
dtype on the way), is copied from there with ``non_blocking=True`` on a side
stream, and an event recorded behind the copy travels with the batch; the
consumer's stream waits on it (:meth:`BagBatch.wait`). A ring slot is
refilled only after the event of its last copy has completed.
"""

from __future__ import annotations

import math
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from toad_tpu_torch.config import DEFAULT_BUCKETS
from toad_tpu_torch.ops.quantize import quantize_rows_np


@dataclass
class BagBatch:
    """One batch of padded bags. ``features``, ``patch_mask`` and ``scales``
    are numpy arrays on the host or, once placed by the batcher's device feed
    (or cast to bf16 for the transfer), torch tensors; the small per-bag
    fields stay numpy arrays on the host, where the eval pass reads them."""

    features: np.ndarray | torch.Tensor  # [B, N, D] float32, or the transfer dtype (int8 on the int8 wire)
    patch_mask: np.ndarray | torch.Tensor  # [B, N] float32 (1 = real patch)
    bag_mask: np.ndarray  # [B] float32 (1 = real bag)
    label: np.ndarray  # [B] int32
    site: np.ndarray  # [B] int32
    sex: np.ndarray  # [B] int32
    indices: np.ndarray  # [B] int64: positions within the split (-1 = pad)
    ready: "torch.cuda.Event | None" = None  # recorded behind the copy to the card
    scales: np.ndarray | torch.Tensor | None = None  # [B, N] f32 per-row quantization scales (int8 wire only)

    @property
    def batch_size(self) -> int:
        return self.features.shape[0]

    @property
    def bucket(self) -> int:
        return self.features.shape[1]

    def wait(self) -> None:
        """Make the current CUDA stream wait for this batch's copy to the
        card, and tell the allocator that the stream uses its tensors."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.features.device)
            stream.wait_event(self.ready)
            for t in (self.features, self.patch_mask, self.scales):
                if t is not None:
                    t.record_stream(stream)
            self.ready = None

    @property
    def wire_bytes(self) -> int:
        """Bytes of the planes that cross to the device: features, patch
        mask and, on the int8 wire, scales."""
        return sum(int(np.prod(t.shape)) * (t.element_size() if isinstance(t, torch.Tensor) else t.dtype.itemsize)
                   for t in (self.features, self.patch_mask, self.scales) if t is not None)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; the largest bucket if n exceeds them all (the
    bag is then truncated to it)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def suggest_buckets(counts: np.ndarray, max_buckets: int = 6, multiple_of: int = 128) -> list[int]:
    """Quantile ladder rounded up to multiples of ``multiple_of``,
    deduplicated, capped at ``max_buckets`` rungs. Every bag fits the top
    rung by construction (q=1.0 is included)."""
    if len(counts) == 0:
        return []
    qs = np.linspace(0, 1, max_buckets + 1)[1:]
    m = max(int(multiple_of), 1)
    rungs = sorted({int(np.ceil(np.quantile(counts, q) / m) * m) for q in qs})
    return [max(r, m) for r in rungs]


def auto_bucket_ladder(split, max_buckets: int = 6, multiple_of: int = 128) -> tuple[int, ...]:
    """Derive a bucket ladder from the split's real patch-count distribution
    using metadata-only reads (:func:`toad_tpu_torch.data.bags.bag_shape`).
    A data-derived ladder cuts the padding the default ladder pays on skewed
    archives. Works for a ``WSIBagSplit`` (per-slide counts) and a
    ``PatientBagSplit`` (the group's slides summed)."""
    from toad_tpu_torch.data.bags import bag_shape

    def n_or_none(path):
        try:
            return bag_shape(path)[0]
        except (OSError, ValueError, KeyError, ImportError, RuntimeError):
            return None  # missing or unreadable: left out of the ladder's statistics

    groups = getattr(split, "groups", None)
    skipped = 0
    if groups is not None:  # patient-concat bags: sum the group's slides
        parent = split.parent
        slide_n = [n_or_none(parent.bag_file(i)) for i in range(len(parent))]
        out_counts = []
        for g in groups:
            ns = [slide_n[int(i)] for i in g]
            if any(v is None for v in ns):
                skipped += 1
                continue
            out_counts.append(int(sum(ns)))
        counts = np.array(out_counts)
    else:
        ns = [n_or_none(split.bag_file(i)) for i in range(len(split))]
        skipped = sum(v is None for v in ns)
        counts = np.array([v for v in ns if v is not None])
    if skipped:
        # a run does not fail over bags that its splits may never touch
        print(f"auto bucket ladder: skipped {skipped} missing/unreadable bag(s)")
    ladder = suggest_buckets(counts, max_buckets=max_buckets, multiple_of=multiple_of)
    if not ladder:
        raise ValueError("auto bucket ladder: no readable bags in the split")
    return tuple(ladder)


def _pad_bag(feats: np.ndarray, bucket: int) -> tuple[np.ndarray, np.ndarray]:
    n, d = feats.shape
    if n > bucket:
        feats = feats[:bucket]
        n = bucket
    out = np.zeros((bucket, d), dtype=np.float32)
    out[:n] = feats
    mask = np.zeros((bucket,), dtype=np.float32)
    mask[:n] = 1.0
    return out, mask


def resolve_transfer_dtype(transfer_dtype: str, compute_dtype: str) -> str:
    """'auto' -> bfloat16 iff the model computes in bf16 (the features are
    rounded to bf16 either side of the wire, so the host-side cast changes
    nothing and halves the host-to-device bytes); float32 otherwise."""
    if transfer_dtype != "auto":
        return transfer_dtype
    return "bfloat16" if compute_dtype == "bfloat16" else "float32"


_TRANSFER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
PAD_SCALE = np.float32(1.0 / 127.0)  # scale of a padding row on the int8 wire (its q is 0: exact under any positive scale)


def plane_offsets(plane_bytes: Sequence[int], align: int = 16) -> tuple[list[int], int]:
    """Byte offsets of planes laid one behind another in a staging buffer,
    each start rounded up to ``align``, and the buffer's size. An int8 plane
    can end at any byte; the f32 planes behind it are viewed as float32 (4-byte
    alignment) and the int8 pooling kernel wants 16-byte-aligned operands."""
    offsets, end = [], 0
    for n in plane_bytes:
        start = -(-end // align) * align
        offsets.append(start)
        end = start + int(n)
    return offsets, end


def plane_views(buf: torch.Tensor, specs: Sequence[tuple[Sequence[int], torch.dtype]],
                offsets: Sequence[int]) -> list[torch.Tensor]:
    """The uint8 buffer ``buf`` seen as one typed tensor per ``(shape,
    dtype)`` plane, each at its byte offset."""
    return [buf[start:start + math.prod(shape) * dt.itemsize].view(dt).view(tuple(shape))
            for (shape, dt), start in zip(specs, offsets)]


def stage_planes(buf: torch.Tensor, planes: Sequence[tuple[torch.Tensor, torch.dtype]],
                 offsets: Sequence[int]) -> list[torch.Tensor]:
    """Copy each ``(tensor, dtype)`` plane into the uint8 buffer ``buf`` at
    its byte offset, cast to ``dtype`` on the way; returns the buffer's typed
    views, in order."""
    views = plane_views(buf, [(t.shape, dt) for t, dt in planes], offsets)
    for view, (t, _) in zip(views, planes):
        view.copy_(t)
    return views


def numpy_view(t: torch.Tensor) -> np.ndarray:
    """A numpy array on ``t``'s memory (a CPU tensor); bf16 as its uint16 bits."""
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


class _DeviceFeed:
    """The pinned ring and side stream of one epoch's copies to a CUDA device."""

    # a prefetch queue of depth d holds d + 1 batches on the card; batches of
    # giant bags (163,840 x 1024 x B) must not multiply there, so those stay
    # on the host and are copied when the step takes them
    MAX_BYTES = 512 * 1024 * 1024

    def __init__(self, device: torch.device, dtype: torch.dtype, slots: int) -> None:
        self.device = device
        self.dtype = dtype
        self.stream = torch.cuda.Stream(device)
        self.buffers: list[torch.Tensor | None] = [None] * slots
        self.events: list[torch.cuda.Event | None] = [None] * slots
        self.turn = 0

    def _slot(self, nbytes: int) -> tuple[torch.Tensor, int]:
        i = self.turn % len(self.buffers)
        self.turn += 1
        if self.events[i] is not None:
            self.events[i].synchronize()  # the copy out of this slot has finished
        if self.buffers[i] is None or self.buffers[i].numel() < nbytes:
            self.buffers[i] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return self.buffers[i], i

    def place(self, b: BagBatch) -> BagBatch:
        """One pinned slot per batch: the features in the wire dtype, then (int8
        wire) the f32 scales, then the f32 patch mask; one event behind the
        copies. The size guard counts the wire's bytes, so an int8 batch may
        be four times as long as a float32 one and still go ahead of the step."""

        def tensor(a) -> torch.Tensor:
            return a if isinstance(a, torch.Tensor) else torch.from_numpy(a)

        planes = [(tensor(b.features), self.dtype)]
        if b.scales is not None:
            planes.append((tensor(b.scales), torch.float32))
        planes.append((tensor(b.patch_mask), torch.float32))
        if planes[0][0].numel() * self.dtype.itemsize > self.MAX_BYTES:
            return b
        offsets, total = plane_offsets([t.numel() * dt.itemsize for t, dt in planes])
        buf, i = self._slot(total)
        staged = stage_planes(buf, planes, offsets)  # casts to the transfer dtype on the way
        return self._send(b, staged, i)

    def _send(self, b: BagBatch, staged: list[torch.Tensor], i: int) -> BagBatch:
        """Start the copy of slot ``i``'s planes (features, [scales,] mask) to
        the card behind the batch's event."""
        with torch.cuda.stream(self.stream):
            on_card = [v.to(self.device, non_blocking=True) for v in staged]
            b.features, b.patch_mask = on_card[0], on_card[-1]
            if len(on_card) == 3:
                b.scales = on_card[1]
            b.ready = torch.cuda.Event()
            b.ready.record(self.stream)
        self.events[i] = b.ready
        return b


class BagBatcher:
    """Iterate a split as :class:`BagBatch`es.

    Parameters
    ----------
    split:
        a ``WSIBagSplit`` (anything with ``__len__``, ``load_bag(i)``,
        ``labels/sites/sexes`` arrays and ``class_weights()``).
    batch_size:
        bags per batch. 1 reproduces reference semantics exactly.
    bucket_sizes:
        padding ladder; None pools bags by exact length (reference-parity
        mode, meant for ``batch_size=1``; a warning is emitted otherwise).
    mode:
        'sequential' | 'shuffle' | 'weighted'.
    native:
        'auto' (the native feed where every bag is eligible, else numpy),
        'on' (the native feed; raises where a bag is not eligible) or 'off'
        (numpy). A loader that does not build raises under 'auto' and 'on'.
    transfer_dtype:
        'float32', 'bfloat16' (cast on the host) or 'int8' (rows quantized
        per row on the host, with their scales in ``BagBatch.scales``; for a
        quantized eval step only).
    device:
        None or a CPU device leaves the batches on the host; a CUDA device
        makes the producer thread start each batch's copy to the card.
    """

    def __init__(
        self,
        split,
        batch_size: int = 1,
        bucket_sizes: Sequence[int] | None = DEFAULT_BUCKETS,
        mode: str = "sequential",
        seed: int = 0,
        testing_frac: float | None = None,
        max_bag_size: int | None = None,
        num_workers: int = 8,
        prefetch: int = 2,
        feature_dim: int | None = None,
        native: str = "auto",
        transfer_dtype: str = "float32",
        device: str | torch.device | None = None,
    ) -> None:
        self.split = split
        self.batch_size = int(batch_size)
        self.bucket_sizes = tuple(bucket_sizes) if bucket_sizes else None
        self.mode = mode
        self.seed = seed
        self.testing_frac = testing_frac
        self.max_bag_size = max_bag_size
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.feature_dim = feature_dim
        if native not in ("auto", "on", "off"):
            raise ValueError(f"native {native!r} not supported (auto, on, off)")
        self.native = native
        if transfer_dtype == "auto":
            raise ValueError(
                "transfer_dtype='auto' must be resolved against the model's "
                "compute dtype before constructing a BagBatcher: call "
                "resolve_transfer_dtype(dtype, model_compute_dtype)"
            )
        if transfer_dtype not in _TRANSFER_DTYPES:
            raise ValueError(f"transfer_dtype {transfer_dtype!r} not supported (float32, bfloat16, int8)")
        self.transfer_dtype = transfer_dtype
        self.device = torch.device(device) if device is not None else None
        if self.bucket_sizes is None and self.batch_size > 1:
            import warnings

            warnings.warn(
                "bucket_sizes=None pools bags by exact length; at batch_size"
                f"={self.batch_size} batches only fill when bags share a length"
                " (rare for real WSIs): pass a bucket ladder for throughput",
                stacklevel=2,
            )
        self._payloads: list | None | bool = False  # False = not yet resolved
        self._lengths: list | None | bool = False  # False = not yet probed
        self.native_active: bool | None = None  # which feed ran: set by the first epoch
        self._epoch = 0

    @property
    def feed_kind(self) -> str | None:
        """'native' or 'numpy' once an epoch has started, else None."""
        return None if self.native_active is None else ("native" if self.native_active else "numpy")

    def _resolve_payloads(self) -> list | None:
        """Every bag's payload on disk, resolved once a batcher (the length
        probe and the native feed share it): None when the split has no bag
        files; an entry is None where a bag does not resolve. A bag of
        several files (``PatientBagSplit``) is a :class:`SegmentedPayload` in
        concatenation order."""
        if self._payloads is not False:
            return self._payloads
        from toad_tpu_torch.data.native_bags import SegmentedPayload, resolve_payload, resolve_payload_q8

        def one(f):
            # a float32 payload, else an int8 store's raw payloads (native only
            # on the int8 wire; its lengths serve any wire)
            return resolve_payload(f) or resolve_payload_q8(f)

        if hasattr(self.split, "bag_file"):
            self._payloads = [one(self.split.bag_file(i)) for i in range(len(self.split))]
        elif hasattr(self.split, "groups") and hasattr(getattr(self.split, "parent", None), "bag_file"):
            self._payloads = []
            for g in self.split.groups:
                parts = [one(self.split.parent.bag_file(int(j))) for j in g]
                if any(p is None for p in parts) or len({p.dim for p in parts}) != 1:
                    self._payloads.append(None)
                else:
                    self._payloads.append(SegmentedPayload(tuple(parts), sum(p.nrows for p in parts), parts[0].dim))
        else:
            self._payloads = None
        return self._payloads

    def _bag_lengths(self) -> list | None:
        """Per-bag row counts from file metadata (no payload reads), probed
        once: from the resolved payloads where every bag resolves, else from
        each file's header; None when the split has no files or any bag is
        unreadable."""
        if self._lengths is not False:
            return self._lengths
        payloads = self._resolve_payloads()
        if payloads is not None and all(p is not None for p in payloads):
            self._lengths = [p.nrows for p in payloads]
            return self._lengths
        from toad_tpu_torch.data.bags import bag_shape

        def rows(path) -> int:
            shape = bag_shape(path)
            if len(shape) != 2:
                raise ValueError(f"{path}: shape {shape}, expected [N, D]")
            return int(shape[0])

        try:
            if hasattr(self.split, "bag_file"):
                self._lengths = [rows(self.split.bag_file(i)) for i in range(len(self.split))]
            elif hasattr(self.split, "groups") and hasattr(getattr(self.split, "parent", None), "bag_file"):
                # multi-file bags (PatientBagSplit): the group's slides summed
                self._lengths = [sum(rows(self.split.parent.bag_file(int(j))) for j in g) for g in self.split.groups]
            else:
                self._lengths = None
        except (OSError, ValueError, KeyError, ImportError, RuntimeError):
            self._lengths = None
        return self._lengths

    def _epoch_rng(self) -> np.random.RandomState:
        return np.random.RandomState((self.seed * 1_000_003 + self._epoch) % (2**31 - 1))

    def __len__(self) -> int:
        """Batch count for the current epoch (``set_epoch``): exact whenever
        bag lengths are readable from file metadata, since bucket grouping
        does not depend on the order and weighted/testing draws replay this
        epoch's rng stream. Otherwise ceil(n_bags / batch_size), a lower
        bound (bucket grouping can only split batches)."""
        order = self._order(self._epoch_rng())
        lengths = self._bag_lengths()
        if lengths is None:
            return (len(order) + self.batch_size - 1) // self.batch_size
        return sum(1 for _ in self._bucket_groups(order, lengths))

    def _bucket_groups(self, order: np.ndarray, lengths: list) -> Iterator[tuple[int, list[int]]]:
        """The epoch's batches as ``(bucket, split positions)`` from known bag
        lengths: each length cut at ``max_bag_size`` and rounded up to its
        bucket, a batch whenever a bucket's pool fills, then the partial
        pools in bucket order (the numpy feed groups its loaded bags so)."""
        pools: dict[int, list[int]] = {}
        for i in order:
            n = lengths[int(i)]
            if self.max_bag_size is not None:
                n = min(n, self.max_bag_size)
            bucket = n if self.bucket_sizes is None else bucket_for(n, self.bucket_sizes)
            pools.setdefault(bucket, []).append(int(i))
            if len(pools[bucket]) == self.batch_size:
                yield bucket, pools.pop(bucket)
        for bucket in sorted(pools):  # partials, padded with bag_mask 0
            yield bucket, pools[bucket]

    @property
    def n_bags(self) -> int:
        return len(self._order(np.random.RandomState(0)))

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _order(self, rng: np.random.RandomState) -> np.ndarray:
        n = len(self.split)
        if self.testing_frac is not None:
            ids = rng.choice(np.arange(n), int(n * self.testing_frac), replace=False)
            return np.sort(ids)
        if self.mode == "sequential":
            return np.arange(n)
        if self.mode == "shuffle":
            return rng.permutation(n)
        if self.mode == "weighted":
            w = self.split.class_weights()
            p = w / w.sum()
            return rng.choice(np.arange(n), size=n, replace=True, p=p)
        raise ValueError(f"unknown mode {self.mode!r}")

    def _load(self, i: int) -> tuple[int, np.ndarray]:
        feats = self.split.load_bag(int(i))
        feats = np.asarray(feats, dtype=np.float32)
        if feats.ndim != 2:
            raise ValueError(f"bag {i} has shape {feats.shape}, expected [N, D]")
        if self.feature_dim is not None and feats.shape[1] != self.feature_dim:
            raise ValueError(f"bag {i} has feature dim {feats.shape[1]}, expected {self.feature_dim}")
        if self.max_bag_size is not None and feats.shape[0] > self.max_bag_size:
            feats = feats[: self.max_bag_size]
        return i, feats

    def _assemble(self, group: list[tuple[int, np.ndarray]], bucket: int) -> BagBatch:
        b = self.batch_size
        d = group[0][1].shape[1]
        feats = np.zeros((b, bucket, d), dtype=np.float32)
        pmask = np.zeros((b, bucket), dtype=np.float32)
        for j, (_, bag) in enumerate(group):
            feats[j], pmask[j] = _pad_bag(bag, bucket)
        return BagBatch(feats, pmask, *self._metadata([i for i, _ in group]))

    def _metadata(self, group: list[int]) -> tuple[np.ndarray, ...]:
        """bag_mask, label, site, sex and indices of a batch of split positions."""
        b = self.batch_size
        bmask = np.zeros((b,), dtype=np.float32)
        label = np.zeros((b,), dtype=np.int32)
        site = np.zeros((b,), dtype=np.int32)
        sex = np.zeros((b,), dtype=np.int32)
        idxs = np.full((b,), -1, dtype=np.int64)
        for j, i in enumerate(group):
            bmask[j] = 1.0
            label[j] = self.split.labels[i]
            site[j] = self.split.sites[i]
            sex[j] = self.split.sexes[i]
            idxs[j] = i
        return bmask, label, site, sex, idxs

    # -- the native feed -------------------------------------------------------

    def _ineligible(self, payloads: list) -> str | None:
        """Why the native feed cannot read this split, or None."""
        from toad_tpu_torch.data.native_bags import Q8PayloadInfo, SegmentedPayload

        missing = [i for i, p in enumerate(payloads) if p is None]
        if missing:
            return (f"{len(missing)} of {len(payloads)} bags (the first at split position {missing[0]}) have no "
                    "payload it reads (.npy, .pt, contiguous .h5 float32 or an int8 .npz store)")
        if self.transfer_dtype != "int8":
            def q8(p) -> bool:
                return any(isinstance(q, Q8PayloadInfo) for q in (p.parts if isinstance(p, SegmentedPayload) else (p,)))

            if any(q8(p) for p in payloads):
                return f"int8-store bags read natively only on the int8 wire, not on {self.transfer_dtype}"
        dims = {p.dim for p in payloads}
        if len(dims) > 1 or (self.feature_dim is not None and dims and dims != {self.feature_dim}):
            return f"the bags' feature dims {sorted(dims)} are not one" + (
                f" equal to feature_dim {self.feature_dim}" if self.feature_dim is not None else "")
        return None

    def _native_ready(self) -> bool:
        """Whether this batcher runs the native feed, decided once: never
        under 'off'; never for a split without bag files (structurally
        ineligible, under 'on' too); where every bag is eligible, after the
        library has loaded (a build that fails raises); else the numpy feed
        under 'auto' and an error under 'on'."""
        if self.native_active is not None:
            return self.native_active
        if self.native == "off" or self._resolve_payloads() is None:
            self.native_active = False
            return False
        reason = self._ineligible(self._payloads)
        if reason is not None:
            if self.native == "on":
                raise RuntimeError(f"native bag IO requested (native='on') but {reason}")
            self.native_active = False
            return False
        from toad_tpu_torch import native as native_lib

        native_lib.get_lib()
        self.native_active = True
        return True

    def _assemble_native(self, group: list[int], bucket: int, feed: "_DeviceFeed | None" = None) -> BagBatch:
        """One batch read by the native loader. With a device feed (and a
        batch within its size guard) the planes are the views of a pinned
        ring slot, which still holds an older batch: the rows and planes the
        loader does not write are cleared first, after the slot's last copy
        has completed; then the copy to the card starts. Otherwise fresh
        host arrays."""
        from toad_tpu_torch import native as native_lib
        from toad_tpu_torch.data.native_bags import Q8PayloadInfo, SegmentedPayload

        b = self.batch_size
        d = self._payloads[group[0]].dim
        cap = bucket if self.max_bag_size is None else min(bucket, self.max_bag_size)
        # one segment per contiguous payload on disk (a patient bag: one per
        # slide file, at its cumulative row), cut at cap as the numpy feed cuts
        # the concatenated bag; int8-store segments (int8 wire only) read raw
        f32_segs: list = []  # (path, offset, rows, dst_row)
        q8_segs: list = []  # (path, q_offset, s_offset, rows, dst_row)
        takes = [0] * b  # rows written in each bag slot
        for slot, i in enumerate(group):
            p = self._payloads[i]
            for part in p.parts if isinstance(p, SegmentedPayload) else (p,):
                take = min(part.nrows, cap - takes[slot])
                if take <= 0:
                    break
                dst = slot * bucket + takes[slot]
                if isinstance(part, Q8PayloadInfo):
                    q8_segs.append((part.path, part.offset, part.scales_offset, take, dst))
                else:
                    f32_segs.append((part.path, part.offset, take, dst))
                takes[slot] += take

        int8 = self.transfer_dtype == "int8"
        specs = [((b, bucket, d), _TRANSFER_DTYPES[self.transfer_dtype])]
        if int8:
            specs.append(((b, bucket), torch.float32))
        specs.append(((b, bucket), torch.float32))
        sizes = [math.prod(shape) * dt.itemsize for shape, dt in specs]
        placed = feed is not None and sizes[0] <= feed.MAX_BYTES
        if placed:
            offsets, total = plane_offsets(sizes)
            buf, ring_slot = feed._slot(total)  # waits for the slot's last copy
            planes = plane_views(buf, specs, offsets)
        else:
            planes = [torch.zeros(shape, dtype=dt) for shape, dt in specs]
        feats, mask = numpy_view(planes[0]), numpy_view(planes[-1])
        scales = numpy_view(planes[1]) if int8 else None
        if placed:
            for j, take in enumerate(takes):
                feats[j, take:] = 0
            mask[...] = 0
        if int8:
            scales[...] = PAD_SCALE  # padding rows keep it: q = 0 there, exact under any scale

        def cols(segs, k):
            return np.array([s[k] for s in segs], np.int64)

        n = self.num_workers
        if f32_segs:
            paths, offs, rows, dst = [s[0] for s in f32_segs], cols(f32_segs, 1), cols(f32_segs, 2), cols(f32_segs, 3)
            if int8:  # read and quantize per row in one pass
                native_lib.pack_segs_int8(paths, offs, rows, dst, d, feats, scales, mask, n)
            elif self.transfer_dtype == "bfloat16":  # read and round to bf16 in one pass
                native_lib.pack_segs_bf16(paths, offs, rows, dst, d, feats, mask, n)
            else:
                native_lib.pack_segs(paths, offs, rows, dst, d, feats, mask, n)
        if q8_segs:
            native_lib.pack_segs_q8([s[0] for s in q8_segs], cols(q8_segs, 1), cols(q8_segs, 2), cols(q8_segs, 3),
                                    cols(q8_segs, 4), d, feats, scales, mask, n)
        batch = BagBatch(planes[0] if self.transfer_dtype == "bfloat16" else feats, mask, *self._metadata(group),
                         scales=scales)
        return feed._send(batch, planes, ring_slot) if placed else batch

    def _batches_native(self, feed: "_DeviceFeed | None" = None) -> Iterator[BagBatch]:
        # every bag resolved, so the lengths are the payloads' row counts
        for bucket, group in self._bucket_groups(self._order(self._epoch_rng()), self._bag_lengths()):
            yield self._assemble_native(group, bucket, feed)

    # -- the numpy feed ----------------------------------------------------------

    def _batches_raw(self) -> Iterator[BagBatch]:
        order = self._order(self._epoch_rng())
        pools: dict[int, list[tuple[int, np.ndarray]]] = {}

        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            # a bounded window of loads in flight, not ex.map over the whole
            # epoch: map holds every finished bag that was not yet taken, so a
            # consumer slower than the disk would gather the epoch's bags in
            # host memory. FIFO keeps the load order.
            idx_iter = iter(order)
            pending: deque = deque()

            def _submit_one() -> None:
                i = next(idx_iter, None)
                if i is not None:
                    pending.append(ex.submit(self._load, int(i)))

            try:
                for _ in range(2 * self.num_workers):
                    _submit_one()
                while pending:
                    i, feats = pending.popleft().result()
                    _submit_one()
                    n = feats.shape[0]
                    bucket = n if self.bucket_sizes is None else bucket_for(n, self.bucket_sizes)
                    pools.setdefault(bucket, []).append((i, feats))
                    if len(pools[bucket]) == self.batch_size:
                        yield self._assemble(pools.pop(bucket), bucket)
                # flush partials, padded to full batch shape with bag_mask=0
                for bucket in sorted(pools):
                    group = pools[bucket]
                    if group:
                        yield self._assemble(group, bucket)
            finally:
                for fut in pending:  # the consumer stopped early: drop the loads not yet started
                    fut.cancel()

    def _convert(self, b: BagBatch) -> BagBatch:
        """The batch in the transfer dtype, converted in the producer thread,
        so that the queued batches are already small and the conversion
        overlaps the device's work."""
        if self.transfer_dtype == "int8":
            # Quantize only the real rows (padding is trailing by construction,
            # _pad_bag), so that a bag just over a bucket does not double the
            # abs/max/rint work; padding stays q = 0 under PAD_SCALE.
            # quantize_rows_np gives the same bytes as quantize_rows on the device.
            n_bags, n, d = b.features.shape
            q = np.zeros((n_bags, n, d), np.int8)
            s = np.full((n_bags, n), PAD_SCALE, np.float32)
            for i in range(n_bags):
                live = int(b.patch_mask[i].sum())
                if live:
                    q[i, :live], s[i, :live] = quantize_rows_np(b.features[i, :live])
            b.features, b.scales = q, s
        elif self.transfer_dtype != "float32":
            b.features = torch.from_numpy(b.features).to(_TRANSFER_DTYPES[self.transfer_dtype])
        return b

    def __iter__(self) -> Iterator[BagBatch]:
        def src() -> Iterator[BagBatch]:
            finish, feed = self._convert, None
            if self.device is not None and self.device.type == "cuda":
                feed = _DeviceFeed(self.device, _TRANSFER_DTYPES[self.transfer_dtype],
                                   max(int(self.prefetch or 0), 1) + 1)
            if self._native_ready():  # packed in the wire dtype, into the ring slot where there is one
                yield from self._batches_native(feed)
                return
            if feed is not None:
                if self.transfer_dtype == "int8":  # quantized here, then placed
                    def finish(b):
                        return feed.place(self._convert(b))
                else:  # the feed's copy into the pinned buffer casts, so the batch needs no separate cast
                    finish = feed.place
            raw = self._batches_raw()
            try:
                for b in raw:
                    yield finish(b)
            finally:
                raw.close()  # shuts the loaders' thread pool down

        if self.prefetch and self.prefetch > 0:
            yield from _prefetch_iter(src, self.prefetch)
        else:
            yield from src()


def _prefetch_iter(make_iter: Callable[[], Iterator], depth: int) -> Iterator:
    """Run an iterator in a background thread, keeping ``depth`` items ready.
    If the consumer abandons the generator (an exception in the step, an
    epoch stopped early), the producer sees the stop event, closes its
    source (which shuts the loaders' thread pool down) and ends, instead of
    blocking forever on the bounded queue; the consumer joins it."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    error: list[BaseException] = []
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        it = None
        try:
            it = make_iter()
            for item in it:
                if not _put(item):
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            error.append(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
            _put(sentinel)

    t = threading.Thread(target=worker, name="bag-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()
        t.join(timeout=30)
