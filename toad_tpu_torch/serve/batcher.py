"""Dynamic request batching for online MIL inference.

PyTorch counterpart of :mod:`toad_tpu.serve.batcher`, with the same
batching discipline:

- requests arrive on arbitrary threads and enqueue ``(features, sex, future)``;
- one dispatch thread collects up to ``max_batch`` requests, waiting at most
  ``max_wait_ms`` after the first arrival;
- requests are grouped by (padding bucket, attention), the batch dimension
  is padded to a power of two (one live zero patch per padding row keeps its
  softmax finite), and one forward serves the whole group.

The model's parameters are put on the device once. A batch is assembled in
pinned host memory and copied with ``non_blocking=True``; it travels as
bf16 iff the model computes in bf16 (``transfer_dtype='auto'``). In int8
mode (``ServeConfig.int8``) requests are quantized per row on the handler
thread (or arrive quantized), the batch travels as int8 rows plus f32 row
scales, and the forward is :meth:`ToadMIL.forward_int8`.

Mean-of-folds ensemble serving: pass a list of state_dicts. Each member is
its own :class:`ToadMIL` on the device with its own packed (or quantized)
kernel operands, so a batch costs one pooling-kernel launch per member; the
members' outputs are combined on the device by the rule of
:class:`~toad_tpu_torch.pipeline.infer.EnsembleInference`.

Pass a ``('data', 'bag')`` mesh (:mod:`toad_tpu_torch.parallel.mesh`) to
serve over several devices: the members live on the mesh's first device
(with a copy of their pooling weights on each other device), a request
batch is padded to a multiple of the data axis and placed over the mesh
(the batch dimension over ``data``, the patch dimension over ``bag``), and
each member runs :meth:`ToadMIL.forward_sharded` on it (int8 too: each cell
pools with the int8 kernel). The ladder's rungs must divide by the bag axis.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, replace
from typing import Any, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from toad_tpu_torch.config import DEFAULT_BUCKETS, ModelConfig
from toad_tpu_torch.data.batching import bucket_for, resolve_transfer_dtype
from toad_tpu_torch.evaluate.calibration import apply_temperature
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.ops.quantize import quantize_rows
from toad_tpu_torch.pipeline.infer import SlidePrediction


@dataclass(frozen=True)
class ServeConfig:
    """Serving knobs (see the module docstring for the batching discipline)."""

    max_batch: int = 32
    max_wait_ms: float = 5.0
    bucket_sizes: tuple[int, ...] = DEFAULT_BUCKETS
    # default for requests that do not say: attention costs an extra [B, T, N]
    # device tensor, so it is opt-in per request (submit(..., attention=True))
    need_attention: bool = False
    # host->device feature dtype: 'auto' picks bfloat16 iff the model
    # computes in bf16; 'float32' is exact under f32 compute
    transfer_dtype: str = "auto"
    # int8 quantized inference (ops/quantize.py): bags quantized per row on
    # the handler thread, int8 host-to-device rows (4x fewer bytes than f32)
    # and the int8 pooling kernel; heads and softmax stay f32. Overrides
    # transfer_dtype.
    int8: bool = False
    # calibrated temperature for class probabilities (on the host, or per
    # member before the mean in ensemble mode); site probabilities stay raw
    temperature: float = 1.0


class _Request(NamedTuple):
    features: torch.Tensor  # [n, D] on the host (int8 in int8 mode), truncated to its bucket
    n: int
    bucket: int
    sex: int
    attention: bool
    future: Future
    scales: torch.Tensor | None = None  # [n] f32 per-row scales (int8 mode)


class BatcherStats(NamedTuple):
    requests: int
    batches: int
    batched_slides: int  # requests served
    padded_slots: int  # batch slots wasted by power-of-two padding
    # dispatch-thread wall seconds: building padded host batches, and the
    # device forward from the host-to-device copy to the results on the host
    assemble_s: float
    forward_s: float
    attention_batches: int  # batches served with attention (the kernels' scored mode)

    @property
    def mean_batch_size(self) -> float:
        return self.batched_slides / self.batches if self.batches else 0.0


def _pow2_at_least(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


_TRANSFER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DynamicBatcher:
    """Coalesces concurrent single-slide requests into padded batched
    forwards. Thread-safe; use as a context manager or call :meth:`close`.

    ``params`` is the model's state_dict (for example from
    :func:`toad_tpu_torch.train.checkpoint.load_params_any`), or a list of
    them for a mean-of-folds ensemble. Ensemble mode follows from the list,
    not from its length: a one-member list keeps the ensemble contract
    (temperature per member on the device, attention as softmaxed pooling
    weights), as a 1-fold results dir served with ``--ensemble`` must."""

    def __init__(
        self,
        params: Mapping[str, torch.Tensor] | Sequence[Mapping[str, torch.Tensor]],
        model_cfg: ModelConfig,
        cfg: ServeConfig = ServeConfig(),
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        self.mesh = mesh
        self.device = mesh.primary if mesh is not None else torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: serve on device 'cpu' explicitly if that is meant")
        self.ensemble = isinstance(params, (list, tuple))
        members = list(params) if self.ensemble else [params]
        if not members:
            raise ValueError("DynamicBatcher needs at least one state_dict")
        self.n_members = len(members)
        # one model a member on the device, each packing (or quantizing) its
        # own kernel operands at its first forward
        self.members = []
        for sd in members:
            model = ToadMIL(model_cfg)
            model.load_state_dict(sd)
            self.members.append(model.to(self.device).eval().requires_grad_(False))
        self.model = self.members[0]
        cfg = replace(cfg, transfer_dtype=resolve_transfer_dtype(cfg.transfer_dtype, model_cfg.compute_dtype))
        if cfg.transfer_dtype not in _TRANSFER_DTYPES:
            raise ValueError(f"transfer_dtype {cfg.transfer_dtype!r} not in {sorted(_TRANSFER_DTYPES)}")
        self.cfg = cfg
        self._feat_dtype = _TRANSFER_DTYPES[cfg.transfer_dtype]
        self.buckets = tuple(sorted(cfg.bucket_sizes))
        self._data_n = 1
        if mesh is not None:
            bag_n = mesh.shape["bag"]
            bad = [b for b in self.buckets if b % bag_n]
            if bad:
                raise ValueError(f"bucket sizes {bad} not divisible by bag axis {bag_n}")
            self._data_n = mesh.shape["data"]
        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        self._stop = threading.Event()
        # serializes submit-enqueue against close(): without it a submit that
        # passed the is_set() check could enqueue after the final drain and
        # hang its caller forever
        self._submit_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._requests = 0
        self._batches = 0
        self._batched = 0
        self._padded = 0
        self._assemble_s = 0.0
        self._forward_s = 0.0
        self._attention_batches = 0
        self._thread = threading.Thread(target=self._run, name="toad-serve-batcher", daemon=True)
        self._thread.start()

    # -- client side -----------------------------------------------------------

    def submit(self, features: Any, sex: int, attention: bool | None = None) -> Future:
        """Enqueue one bag ``[n, D]`` (numpy array or CPU tensor, f32 or
        bf16); the Future resolves to a :class:`SlidePrediction`.
        ``attention=None`` falls back to ``ServeConfig.need_attention``."""
        if self._stop.is_set():
            raise RuntimeError("batcher is closed")
        features = torch.as_tensor(features)
        if features.dtype not in (torch.float32, torch.bfloat16):
            features = features.to(torch.float32)
        if features.dim() != 2:
            raise ValueError(f"features must be [n_patches, dim], got shape {tuple(features.shape)}")
        in_dim = self.model.config.in_dim
        if features.shape[1] != in_dim:
            raise ValueError(f"feature dim {features.shape[1]} != model in_dim {in_dim}")
        n = int(features.shape[0])
        if n == 0:
            raise ValueError("empty bag")
        scales = None
        if self.cfg.int8:
            # quantize here, on the handler thread, so that the queue carries
            # int8; after the head truncation, so that dropped rows cost nothing
            features, scales = quantize_rows(features[: self.buckets[-1]])
            n = int(features.shape[0])
        return self._enqueue(features, scales, n, int(sex), attention)

    def predict(self, features: Any, sex: int, attention: bool | None = None) -> SlidePrediction:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(features, sex, attention).result()

    def submit_quantized(self, xq: Any, scales: Any, sex: int, attention: bool | None = None) -> Future:
        """int8 mode only: enqueue pre-quantized rows ``[n, D]`` int8 and
        their ``[n]`` f32 scales (from a client or an int8 bag store,
        :func:`~toad_tpu_torch.data.bags.load_bag_quantized`), skipping the
        handler-thread quantization."""
        if not self.cfg.int8:
            raise ValueError("submit_quantized requires ServeConfig(int8=True)")
        if self._stop.is_set():
            raise RuntimeError("batcher is closed")
        xq = torch.as_tensor(xq)
        if xq.dtype != torch.int8:
            # a float bag passed here by mistake would truncate to garbage
            # int8 values and be served as a confident wrong answer
            raise TypeError(f"submit_quantized expects int8 rows (use submit() for float features), got dtype {xq.dtype}")
        scales = torch.as_tensor(scales).to(torch.float32)
        in_dim = self.model.config.in_dim
        if xq.dim() != 2 or xq.shape[1] != in_dim:
            raise ValueError(f"xq must be [n_patches, {in_dim}] int8, got {tuple(xq.shape)}")
        if tuple(scales.shape) != (xq.shape[0],):
            raise ValueError(f"scales must be [{xq.shape[0]}], got {tuple(scales.shape)}")
        n = int(xq.shape[0])
        if n == 0:
            raise ValueError("empty bag")
        return self._enqueue(xq, scales, n, int(sex), attention)

    def _enqueue(
        self, features: torch.Tensor, scales: torch.Tensor | None, n: int, sex: int, attention: bool | None
    ) -> Future:
        """Bucket and head-truncate, then the close-race-safe enqueue."""
        bucket = bucket_for(n, self.buckets)
        if n > bucket:  # longer than the largest bucket: head-truncate (batcher policy)
            features, n = features[:bucket], bucket
            if scales is not None:
                scales = scales[:bucket]
        fut: Future = Future()
        want_attn = self.cfg.need_attention if attention is None else bool(attention)
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("batcher is closed")
            with self._stats_lock:
                self._requests += 1
            self._queue.put(_Request(features, n, bucket, sex, want_attn, fut, scales))
        return fut

    def stats(self) -> BatcherStats:
        with self._stats_lock:
            return BatcherStats(self._requests, self._batches, self._batched, self._padded, self._assemble_s,
                                self._forward_s, self._attention_batches)

    # -- dispatch thread ---------------------------------------------------------

    def _collect(self) -> list[_Request]:
        """Block for the first request, then drain up to max_batch within the
        max_wait window."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        if first is None:  # close() sentinel
            return []
        batch = [first]
        deadline = time.monotonic() + self.cfg.max_wait_ms / 1e3
        while len(batch) < self.cfg.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req is None:
                break
            batch.append(req)
        return batch

    def _serve_groups(self, batch: list[_Request]) -> None:
        groups: dict[tuple[int, bool], list[_Request]] = {}
        for r in batch:
            groups.setdefault((r.bucket, r.attention), []).append(r)
        for (bucket, want_attn), group in groups.items():
            # the dispatch thread is a singleton: it must survive every
            # failure, else all pending and future requests hang
            try:
                self._dispatch(bucket, want_attn, group)
            except BaseException as e:  # noqa: BLE001 - handed to every waiting caller
                for r in group:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if batch:
                self._serve_groups(batch)
        # graceful drain: serve everything enqueued before close(); submit()
        # holds _submit_lock against close(), so every accepted request
        # precedes the None sentinel
        pending: list[_Request] = []
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                pending.append(req)
        for start in range(0, len(pending), self.cfg.max_batch):
            self._serve_groups(pending[start : start + self.cfg.max_batch])

    def _padded_batch(self, b_requests: int) -> int:
        b_pad = _pow2_at_least(b_requests, self.cfg.max_batch)
        if b_pad % self._data_n:  # the mesh's data axis needs even batch slices
            b_pad = ((b_pad + self._data_n - 1) // self._data_n) * self._data_n
        return b_pad

    def _assemble(self, bucket: int, b_pad: int, group: Sequence[_Request]):
        """Zero-padded [b_pad, bucket, dim] host inputs (pinned when serving
        on CUDA); rows past len(group) are padding, with one live zero patch
        that keeps their softmax finite. In int8 mode also the [b_pad,
        bucket] f32 row scales, 1/127 where a row is padding (any positive
        scale is exact for a zero row), else None."""
        pin = self.device.type == "cuda"
        dim = self.model.config.in_dim
        feat_dtype = torch.int8 if self.cfg.int8 else self._feat_dtype
        feats = torch.empty((b_pad, bucket, dim), dtype=feat_dtype, pin_memory=pin)
        mask = torch.zeros((b_pad, bucket), dtype=torch.float32, pin_memory=pin)
        sex = torch.zeros((b_pad,), dtype=torch.int32, pin_memory=pin)
        scales = torch.full((b_pad, bucket), 1.0 / 127.0, dtype=torch.float32, pin_memory=pin) if self.cfg.int8 else None
        for i, r in enumerate(group):
            feats[i, : r.n] = r.features  # f32 -> bf16 here rounds to nearest even
            feats[i, r.n :] = 0
            mask[i, : r.n] = 1.0
            sex[i] = r.sex
            if scales is not None:
                scales[i, : r.n] = r.scales
        feats[len(group) :] = 0
        mask[len(group) :, 0] = 1.0
        return feats, mask, sex, scales

    def _device_forward(self, feats, mask, sex, scales, want_attn: bool):
        """One forward of every member on the device (int8 when ``scales`` is
        given), combined: (y_prob, site_prob, attention or None), as host
        tensors."""
        dev = self.device
        with torch.inference_mode():
            if self.mesh is not None:
                from toad_tpu_torch.parallel.sharding import shard_batch

                batch = {"features": feats, "patch_mask": mask, "sex": sex}
                if scales is not None:
                    batch["scales"] = scales
                sb = shard_batch(batch, self.mesh)
                outs = [m.forward_sharded(sb, need_attention=want_attn, int8=scales is not None) for m in self.members]
                y_prob, site_prob, attn = self._combine(outs, sb["patch_mask"], want_attn)
                return y_prob.cpu(), site_prob.cpu(), attn.cpu() if attn is not None else None
            feats, mask, sex = (t.to(dev, non_blocking=True) for t in (feats, mask, sex))
            if scales is not None:
                scales = scales.to(dev, non_blocking=True)
            outs = [
                m.forward_int8(feats, scales, mask, sex, need_attention=want_attn) if scales is not None
                else m(feats, mask, sex, need_attention=want_attn)
                for m in self.members
            ]
            y_prob, site_prob, attn = self._combine(outs, mask, want_attn)
            return y_prob.cpu(), site_prob.cpu(), attn.cpu() if attn is not None else None

    def _combine(self, outs, mask: torch.Tensor, want_attn: bool):
        """The members' outputs -> (y_prob, site_prob, attention or None), the
        JAX batcher's ``_combine``.

        Plain serving: the class softmax of the f32 logits and the raw
        attention scores; the host applies the temperature afterwards.

        Ensemble mode (any member count, 1 included): each member's class
        softmax of its f32 logits / T, then the mean over the members; the
        mean of the members' site probabilities; with attention, the mean of
        the members' masked softmax over the real rows (raw attention logits
        are not comparable across members). Members are not stacked into one
        batched weight operand: no kernel takes one, and each member's
        launch is one of its own."""
        if not self.ensemble:
            (out,) = outs
            return torch.softmax(out.logits.float(), dim=-1), out.site_prob, out.attention if want_attn else None
        t = self.cfg.temperature
        y_prob = torch.stack([torch.softmax(o.logits.float() / t, dim=-1) for o in outs]).mean(dim=0)
        site_prob = torch.stack([o.site_prob.float() for o in outs]).mean(dim=0)
        if not want_attn:
            return y_prob, site_prob, None
        # finfo.min, not -inf, where mask == 0: a padding row of the batch has
        # one live zero row, so every softmax stays finite
        live = mask[:, None, :] > 0
        floor = torch.finfo(torch.float32).min
        weights = [torch.softmax(torch.where(live, o.attention.float(), floor), dim=-1) for o in outs]
        return y_prob, site_prob, torch.stack(weights).mean(dim=0)

    def warmup(
        self,
        buckets: Sequence[int] | None = None,
        batch_sizes: Sequence[int] | None = None,
        attention: bool | None = None,
    ) -> int:
        """Run the forward once for the shapes requests will hit, so that the
        first requests do not pay the kernel build and allocator growth.

        Defaults: every configured bucket x the two ends of the batch ladder
        (1 and max_batch) x the configured attention mode. Synchronous;
        returns the number of shape variants run."""
        buckets = tuple(buckets) if buckets else self.buckets
        bad = [b for b in buckets if b not in self.buckets]
        if bad:
            raise ValueError(f"warmup buckets {bad} not in the configured ladder {self.buckets}")
        if batch_sizes is None:
            batch_sizes = (1, self.cfg.max_batch)
        attns = (self.cfg.need_attention,) if attention is None else (bool(attention),)
        # cap batch x bucket so giant rungs do not assemble multi-GB zero batches
        max_slots = 1 << 20
        done: set[tuple[int, int, bool]] = set()
        for bucket in buckets:
            for bs in batch_sizes:
                bs = max(1, min(int(bs), self.cfg.max_batch, max_slots // bucket))
                b_pad = self._padded_batch(bs)
                for want_attn in attns:
                    key = (bucket, b_pad, want_attn)
                    if key in done:
                        continue
                    done.add(key)
                    self._device_forward(*self._assemble(bucket, b_pad, ()), want_attn)
        return len(done)

    def _dispatch(self, bucket: int, want_attn: bool, group: list[_Request]) -> None:
        b = len(group)
        b_pad = self._padded_batch(b)
        t0 = time.perf_counter()
        inputs = self._assemble(bucket, b_pad, group)
        t1 = time.perf_counter()
        y_prob, site_prob, attn = self._device_forward(*inputs, want_attn)
        t2 = time.perf_counter()
        with self._stats_lock:
            self._assemble_s += t1 - t0
            self._forward_s += t2 - t1
            self._batches += 1
            self._attention_batches += want_attn
            self._batched += b
            self._padded += b_pad - b
        y_prob = y_prob.numpy()
        if self.cfg.temperature != 1.0 and not self.ensemble:
            # an ensemble applied T per member on the device (the mean of
            # T-scaled softmaxes is not the T-scaled mean)
            y_prob = apply_temperature(y_prob, self.cfg.temperature)
        site_prob = site_prob.numpy()
        for i, r in enumerate(group):
            yp = y_prob[i]
            sp = site_prob[i]
            # stable sort + argmax y_hat: ties resolve as in the JAX serving path
            order = np.argsort(-yp, kind="stable")
            if want_attn:
                a, sa = attn[i, 0, : r.n].numpy(), attn[i, 1, : r.n].numpy()
            else:
                a = sa = np.zeros((0,), np.float32)
            pred = SlidePrediction(
                y_hat=int(yp.argmax()),
                y_prob=yp,
                site_hat=int(sp.argmax()),
                site_prob=sp,
                attention=a,
                site_attention=sa,
                topk=[(int(j), float(yp[j])) for j in order],
            )
            if not r.future.done():
                r.future.set_result(pred)

    # -- lifecycle ---------------------------------------------------------------

    def close(self, timeout: float = 60.0) -> bool:
        """Stop the dispatch thread after it has served everything accepted.
        Returns True once it has fully drained; False if it is still busy
        after ``timeout`` seconds."""
        with self._submit_lock:
            already = self._stop.is_set()
            self._stop.set()
        if not already:
            self._queue.put(None)
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
