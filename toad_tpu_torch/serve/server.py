"""Online inference service: JSON over HTTP in front of the dynamic batcher.

PyTorch counterpart of :mod:`toad_tpu.serve.server`, on one device or a
``('data', 'bag')`` mesh (:class:`~toad_tpu_torch.serve.batcher.DynamicBatcher`). Stdlib
``ThreadingHTTPServer``: each request thread blocks on its Future while the
single dispatch thread feeds the device, so concurrency in the HTTP layer
becomes device batch size. A single checkpoint or, with
``from_checkpoint(..., ensemble=True)``, every fold of a results dir as a
mean-of-folds ensemble.

API:

- ``GET  /healthz`` -> ``{"status": "ok", "device": <GPU name or "cpu">}``
- ``GET  /stats``   -> request/batch counters incl. mean batch size, the
  dispatch thread's seconds in batch assembly and in device forwards, the
  pooling kernels' launches (and those in scored mode), and the deployed
  config (``ensemble_members`` among it)
- ``POST /heatmap`` -> JSON ``{"bag_path": ..., "sex": ..., "patch_size"?,
  "downscale"?, "task"?: "origin"|"site"}`` -> the attention heatmap as
  ``image/png`` bytes (the bag must carry coords: ``.h5``, ``.npz``, or a
  ``{stem}.coords.npy`` sidecar)
- ``POST /predict`` -> body is JSON with either
    - ``features_b64``: base64 little-endian float32 ``[n*dim]`` + ``shape``, or
    - ``features_int8_b64`` + ``scales_b64`` + ``shape``: rows quantized by
      the client (``ops/quantize.py::quantize_rows_np``; int8 mode only), or
    - ``features``: nested lists ``[n][dim]`` (convenience, slow), or
    - ``bag_path``: server-side path to a ``.pt``/``.npy``/``.npz``/``.h5`` bag
      (in int8 mode an int8 ``.npz`` store is served as stored);
  plus ``sex`` ("F"/"M"/0/1), optional ``top_k`` (default 5) and
  ``attention`` (bool; include raw per-patch attention scores).
- ``POST /predict`` with ``Content-Type: application/octet-stream``: the body
  is the feature bytes; ``X-Toad-Shape: <n>,<dim>`` and ``X-Toad-Sex`` are
  required, ``X-Toad-Dtype: float32|bfloat16|int8``, ``X-Toad-Top-K`` and
  ``X-Toad-Attention: 0|1`` optional. For ``int8`` (int8 mode only) the body
  is ``n*dim`` int8 row bytes followed by ``n`` little-endian f32 row scales.
  The response is the same JSON.

An int8 payload sent to a server that is not in int8 mode answers 400.

A POST with an ``X-Toad-Trace`` header is answered with ``X-Toad-Timing:
accepted=<s>,queued=<s>``: when its handler began and when the decoded
request went to the batcher, on the host's monotonic clock
(``time.perf_counter``), so that a client on the same host can tell where a
slow request waited (``experiments/serve_load.py --timestamps``).

Every POST body is capped at ``max_body_bytes`` (413 beyond it).
"""

from __future__ import annotations

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from toad_tpu_torch.config import ModelConfig, TaskConfig
from toad_tpu_torch.cli.common import parse_sex
from toad_tpu_torch.data.bags import load_bag, load_bag_quantized
from toad_tpu_torch.ops import cuda_pool, cuda_pool_int8
from toad_tpu_torch.pipeline.heatmap import encode_png, render_heatmap
from toad_tpu_torch.pipeline.infer import SlidePrediction, find_fold_checkpoints
from toad_tpu_torch.serve.batcher import DynamicBatcher, ServeConfig
from toad_tpu_torch.utils import invert_labels


class InferenceService:
    """Checkpoint + task vocabulary + dynamic batcher, as one object."""

    def __init__(
        self,
        params: Mapping[str, torch.Tensor] | Sequence[Mapping[str, torch.Tensor]],
        model_cfg: ModelConfig,
        serve_cfg: ServeConfig = ServeConfig(),
        task: TaskConfig | None = None,
        bag_root: Any = None,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        self.model_cfg = model_cfg
        self.batcher = DynamicBatcher(params, model_cfg, serve_cfg, device=device, mesh=mesh)
        # bag_path requests may only read under this directory; None = no
        # restriction (HTTP additionally requires a root beyond loopback)
        self.bag_root: Path | None = Path(bag_root).resolve() if bag_root is not None else None
        self.task = task
        self.inv_labels: dict[int, str] | None = None
        self.inv_site: dict[int, str] | None = None
        if task is not None:
            self.inv_labels = invert_labels(task.label_dicts[0])
            if len(task.label_dicts) > 1:
                self.inv_site = invert_labels(task.label_dicts[1])

    @classmethod
    def from_checkpoint(cls, ckpt_path, model_cfg: ModelConfig, serve_cfg: ServeConfig = ServeConfig(),
                        task: TaskConfig | None = None, bag_root: Any = None,
                        device: str | torch.device = "cuda", ensemble: bool = False,
                        mesh=None) -> "InferenceService":
        """A reference-layout ``s_k_checkpoint.pt``; with ``ensemble=True``
        ``ckpt_path`` is a training results dir (the ``cli/train.py`` layout)
        and every ``s_<k>_checkpoint`` member is served as a mean-of-folds
        ensemble (one pooling-kernel launch per member and batch, see
        :class:`~toad_tpu_torch.serve.batcher.DynamicBatcher`)."""
        from toad_tpu_torch.train.checkpoint import load_params_any

        if ensemble:
            found = find_fold_checkpoints(ckpt_path)
            if not found:
                raise FileNotFoundError(f"--ensemble: no s_<k>_checkpoint members under {ckpt_path}")
            params = [load_params_any(p, model_cfg) for _, p in found]
        else:
            params = load_params_any(ckpt_path, model_cfg)
        return cls(params, model_cfg, serve_cfg, task=task, bag_root=bag_root, device=device, mesh=mesh)

    @property
    def device_name(self) -> str:
        dev = self.batcher.device
        return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    # -- prediction --------------------------------------------------------------

    def _resolve_bag_path(self, bag_path) -> Path:
        """Resolve a client-supplied bag path against ``bag_root`` and refuse
        escapes (``..``, absolute paths, symlinks out of the root)."""
        p = Path(bag_path)
        if self.bag_root is None:
            return p
        resolved = (p if p.is_absolute() else self.bag_root / p).resolve()
        if not resolved.is_relative_to(self.bag_root):
            raise PermissionError("bag_path resolves outside the served bag root")
        return resolved

    def predict_features(self, features: Any, sex: int, top_k: int = 5, attention: bool = False) -> dict:
        pred = self.batcher.predict(features, sex, attention=attention)
        return self._to_json(pred, top_k, attention)

    def predict_quantized_features(
        self, xq: Any, scales: Any, sex: int, top_k: int = 5, attention: bool = False
    ) -> dict:
        """Rows quantized by the client (int8 + per-row scales): 4x fewer wire
        bytes than f32 and no handler-thread quantization. int8 mode only."""
        pred = self.batcher.submit_quantized(xq, scales, sex, attention=attention).result()
        return self._to_json(pred, top_k, attention)

    def predict_bag(self, bag_path, sex: int, top_k: int = 5, attention: bool = False) -> dict:
        bag_path = self._resolve_bag_path(bag_path)
        if not bag_path.exists():
            raise FileNotFoundError(f"feature bag not found: {bag_path}")
        if self.batcher.cfg.int8:
            # an int8 store is served as stored: its rows are the quantized rows
            stored = load_bag_quantized(bag_path)
            if stored is not None:
                return self.predict_quantized_features(stored[0], stored[1], sex, top_k, attention)
        return self.predict_features(np.asarray(load_bag(bag_path), np.float32), sex, top_k, attention)

    def heatmap_png(self, bag_path, sex: int, patch_size: int = 256, downscale: int = 32, task: str = "origin") -> bytes:
        """Attention heatmap PNG of a bag that carries coords (``.h5``,
        ``.npz``, or ``.npy``/``.pt`` with a coords sidecar), the serving
        counterpart of ``infer --heatmap``. ``task`` picks the attention head:
        'origin' or 'site'. The bag goes through the batcher with attention
        (the pooling kernel's scored mode on CUDA; under int8 its rows are
        quantized on the handler thread)."""
        if task not in ("origin", "site"):
            raise ValueError(f"task must be 'origin' or 'site', got {task!r}")
        if patch_size < 1 or downscale < 1:
            raise ValueError(f"patch_size/downscale must be >= 1, got {patch_size}/{downscale}")
        bag_path = self._resolve_bag_path(bag_path)
        if not bag_path.exists():
            raise FileNotFoundError(f"feature bag not found: {bag_path}")
        feats, coords = load_bag(bag_path, with_coords=True)
        if coords is None:
            raise ValueError(f"{bag_path} carries no patch coordinates: cannot render a heatmap")
        pred = self.batcher.predict(np.asarray(feats, np.float32), sex, attention=True)
        scores = pred.attention if task == "origin" else pred.site_attention
        coords = np.asarray(coords)[: len(scores)]  # a bag past the top bucket is head-truncated
        return encode_png(render_heatmap(coords, scores, patch_size=patch_size, downscale=downscale))

    def _to_json(self, pred: SlidePrediction, top_k: int, attention: bool) -> dict:
        def label(i: int) -> str:
            return self.inv_labels.get(i, str(i)) if self.inv_labels else str(i)

        def site_label(i: int) -> str:
            return self.inv_site.get(i, str(i)) if self.inv_site else str(i)

        out = {
            "y_hat": pred.y_hat,
            "label": label(pred.y_hat),
            "y_prob": [float(p) for p in pred.y_prob],
            "topk": [[label(i), p] for i, p in pred.topk[:top_k]],
            "site_hat": pred.site_hat,
            "site_label": site_label(pred.site_hat),
            "site_prob": [float(p) for p in pred.site_prob],
        }
        if attention:
            out["attention"] = [float(a) for a in pred.attention]
        return out

    def stats(self) -> dict:
        s = self.batcher.stats()
        cfg = self.batcher.cfg
        return {
            "requests": s.requests,
            "batches": s.batches,
            "served": s.batched_slides,
            "padded_slots": s.padded_slots,
            "mean_batch_size": round(s.mean_batch_size, 3),
            "attention_batches": s.attention_batches,
            "assemble_s": s.assemble_s,
            "forward_s": s.forward_s,
            # fused pooling kernel launches in this process (float and int8),
            # and those in scored mode: show that the served batches went
            # through the CUDA kernels, one launch per member and batch
            "kernel_launches": cuda_pool.LAUNCHES,
            "scored_kernel_launches": cuda_pool.SCORED_LAUNCHES,
            "int8_kernel_launches": cuda_pool_int8.LAUNCHES,
            "int8_scored_kernel_launches": cuda_pool_int8.SCORED_LAUNCHES,
            "config": {
                "buckets": list(self.batcher.buckets),
                "max_batch": cfg.max_batch,
                "max_wait_ms": cfg.max_wait_ms,
                "int8": cfg.int8,
                "temperature": cfg.temperature,
                "transfer_dtype": cfg.transfer_dtype,
                "ensemble_members": self.batcher.n_members,
                "device": self.device_name,
            },
        }

    def close(self, timeout: float = 60.0) -> bool:
        """True when the dispatch thread fully drained."""
        return self.batcher.close(timeout)


def _valid_shape(shape) -> bool:
    return (
        isinstance(shape, list)
        and len(shape) == 2
        and all(isinstance(v, int) and not isinstance(v, bool) and v > 0 for v in shape)
    )


def _decode_features(body: dict, in_dim: int) -> np.ndarray:
    if "features_b64" in body:
        shape = body.get("shape")
        if not _valid_shape(shape):
            raise ValueError("features_b64 requires 'shape': [n_patches, dim] (positive integers)")
        if shape[1] != in_dim:
            raise ValueError(f"feature dim {shape[1]} != model in_dim {in_dim}")
        arr = np.frombuffer(bytearray(base64.b64decode(body["features_b64"])), dtype="<f4")
        if arr.size != shape[0] * shape[1]:
            raise ValueError(f"payload has {arr.size} floats, shape says {shape[0] * shape[1]}")
        return arr.reshape(shape[0], shape[1])
    if "features" in body:
        arr = np.asarray(body["features"], np.float32)
        if arr.ndim != 2 or arr.shape[1] != in_dim:
            raise ValueError(f"features must be [n_patches, {in_dim}], got shape {arr.shape}")
        return arr
    raise ValueError("body needs one of: features_b64, features_int8_b64, features, bag_path")


def _decode_features_int8(body: dict, in_dim: int) -> tuple[np.ndarray, np.ndarray]:
    """``features_int8_b64`` (int8 rows) + ``scales_b64`` (f32 per row) +
    ``shape`` -> (xq [n, dim] int8, scales [n] f32)."""
    shape = body.get("shape")
    if not _valid_shape(shape):
        raise ValueError("features_int8_b64 requires 'shape': [n_patches, dim] (positive integers)")
    if shape[1] != in_dim:
        raise ValueError(f"feature dim {shape[1]} != model in_dim {in_dim}")
    if "scales_b64" not in body:
        raise ValueError("features_int8_b64 requires 'scales_b64' (base64 f32 [n_patches])")
    xq = np.frombuffer(bytearray(base64.b64decode(body["features_int8_b64"])), dtype=np.int8)
    if xq.size != shape[0] * shape[1]:
        raise ValueError(f"payload has {xq.size} int8 values, shape says {shape[0] * shape[1]}")
    scales = np.frombuffer(bytearray(base64.b64decode(body["scales_b64"])), dtype="<f4")
    if scales.size != shape[0]:
        raise ValueError(f"scales_b64 has {scales.size} floats, shape says {shape[0]} rows")
    return xq.reshape(shape[0], shape[1]), scales


def _decode_raw_request(headers, body: bytearray, in_dim: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Raw ``application/octet-stream`` body -> (features [n, dim] f32, bf16
    or int8, row scales [n] f32 for int8 else None), views of the body."""
    shape_hdr = headers.get("X-Toad-Shape")
    if not shape_hdr:
        raise ValueError("octet-stream predict requires 'X-Toad-Shape: <n_patches>,<dim>'")
    try:
        n, dim = (int(v) for v in shape_hdr.split(","))
    except ValueError:
        raise ValueError(f"malformed X-Toad-Shape {shape_hdr!r} (want '<n_patches>,<dim>')") from None
    if n <= 0 or dim <= 0:
        raise ValueError(f"X-Toad-Shape dims must be positive, got {n},{dim}")
    if dim != in_dim:
        raise ValueError(f"feature dim {dim} != model in_dim {in_dim}")
    dtype = (headers.get("X-Toad-Dtype") or "float32").strip().lower()
    if dtype in ("float32", "f32"):
        if len(body) != n * dim * 4:
            raise ValueError(f"body has {len(body)} bytes, shape {n},{dim} f32 needs {n * dim * 4}")
        return torch.from_numpy(np.frombuffer(body, dtype="<f4").reshape(n, dim)), None
    if dtype in ("bfloat16", "bf16"):
        # half the wire bytes of f32; under bf16 compute the server would
        # round the rows to bf16 anyway, so the client-side cast changes nothing
        if len(body) != n * dim * 2:
            raise ValueError(f"body has {len(body)} bytes, shape {n},{dim} bf16 needs {n * dim * 2}")
        return torch.from_numpy(np.frombuffer(body, dtype="<i2").reshape(n, dim)).view(torch.bfloat16), None
    if dtype == "int8":
        if len(body) != n * dim + n * 4:
            raise ValueError(f"body has {len(body)} bytes, shape {n},{dim} int8+scales needs {n * dim + n * 4}")
        xq = torch.from_numpy(np.frombuffer(body, dtype=np.int8, count=n * dim).reshape(n, dim))
        # the scales start at byte n * dim, which need not be 4-byte aligned: copy them
        return xq, torch.from_numpy(np.frombuffer(body, dtype="<f4", offset=n * dim).copy())
    raise ValueError(f"unsupported X-Toad-Dtype {dtype!r} (float32, bfloat16 or int8)")


def _predict_json(service: InferenceService, req: dict, sex: int, in_dim: int) -> dict:
    """A JSON /predict body -> the response document."""
    top_k = int(req.get("top_k", 5))
    attention = bool(req.get("attention", False))
    if "bag_path" in req:
        return service.predict_bag(req["bag_path"], sex, top_k, attention)
    if "features_int8_b64" in req:
        xq, sx = _decode_features_int8(req, in_dim)
        return service.predict_quantized_features(xq, sx, sex, top_k, attention)
    return service.predict_features(_decode_features(req, in_dim), sex, top_k, attention)


def _read_body(rfile, length: int) -> bytearray:
    """The whole body into a writable buffer (tensors view it without a copy)."""
    buf = bytearray(length)
    view = memoryview(buf)
    got = 0
    while got < length:
        k = rfile.readinto(view[got:])
        if not k:
            raise ValueError(f"body ended after {got} of {length} bytes")
        got += k
    return buf


class DrainableHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` that can wait for in-request handler threads,
    so that shutdown lets drained responses finish writing before exit."""

    # listen backlog: socketserver's default of 5 resets connections when a
    # burst of clients connects at once
    request_queue_size = 128

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._inflight = 0
        self._inflight_cv = threading.Condition()

    def request_began(self) -> None:
        with self._inflight_cv:
            self._inflight += 1

    def request_done(self) -> None:
        with self._inflight_cv:
            self._inflight -= 1
            self._inflight_cv.notify_all()

    def drain_requests(self, timeout: float = 10.0) -> bool:
        """Wait until no handler is mid-request; True if fully drained."""
        deadline = time.monotonic() + timeout
        with self._inflight_cv:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_cv.wait(remaining)
        return True


def make_http_server(
    service: InferenceService,
    host: str = "127.0.0.1",
    port: int = 8000,
    max_body_bytes: int = 1 << 30,
) -> DrainableHTTPServer:
    """Build (not start) the server; ``port=0`` picks a free port
    (``server.server_address[1]``). The caller owns serve_forever/shutdown.

    Server-side ``bag_path`` requests are honoured only when the service has
    a ``bag_root`` or the server is bound to loopback."""
    bag_paths_ok = service.bag_root is not None or host in ("127.0.0.1", "localhost", "::1")
    in_dim = service.model_cfg.in_dim

    class Handler(BaseHTTPRequestHandler):
        # a client that stalls mid-body loses its connection instead of
        # pinning a handler thread forever
        timeout = 120

        def log_message(self, *a):  # quiet; /stats has the counters
            pass

        def _send(self, code: int, obj: dict) -> None:
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            if self.headers.get("X-Toad-Trace") and self.command == "POST":
                # the request's stages on the host's monotonic clock (time.perf_counter), for a
                # client on the same host: the handler began, the decoded request went to the batcher
                self.send_header("X-Toad-Timing", f"accepted={self._accepted:.6f},queued={self._queued:.6f}")
            self.end_headers()
            self.wfile.write(payload)

        def _send_bytes(self, payload: bytes, ctype: str = "image/png") -> None:
            """Binary 200. Swallows a client's disconnect mid-write, so that
            the error mapping never tries a second response on a dead socket."""
            try:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
            except (BrokenPipeError, ConnectionResetError):
                pass

        def do_GET(self):
            self.server.request_began()
            try:
                if self.path == "/healthz":
                    self._send(200, {"status": "ok", "device": service.device_name})
                elif self.path == "/stats":
                    self._send(200, service.stats())
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
            finally:
                self.server.request_done()

        def do_POST(self):
            self._accepted = self._queued = time.perf_counter()
            self.server.request_began()
            try:
                self._handle_post()
            finally:
                self.server.request_done()

        def _handle_post(self):
            if self.path not in ("/predict", "/heatmap"):
                self.close_connection = True  # the unread body must not parse as a request
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0) or 0)
            except ValueError:
                self.close_connection = True
                self._send(400, {"error": "malformed Content-Length"})
                return
            if length > max_body_bytes:
                self.close_connection = True
                self._send(413, {"error": f"body {length} bytes exceeds cap {max_body_bytes}"})
                return
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip().lower()
            if ctype == "application/octet-stream" and self.path != "/predict":
                self.close_connection = True  # the unread body must not parse as a request
                self._send(400, {"error": "octet-stream bodies are only accepted on /predict"})
                return
            png = None
            try:
                body = _read_body(self.rfile, length)
                if ctype == "application/octet-stream":
                    sex = parse_sex(self.headers.get("X-Toad-Sex", ""))
                    top_k = int(self.headers.get("X-Toad-Top-K", 5))
                    attention = (self.headers.get("X-Toad-Attention") or "0").strip().lower() in ("1", "true", "yes")
                    feats, scales = _decode_raw_request(self.headers, body, in_dim)
                    self._queued = time.perf_counter()
                    if scales is not None:
                        out = service.predict_quantized_features(feats, scales, sex, top_k, attention)
                    else:
                        out = service.predict_features(feats, sex, top_k, attention)
                else:
                    req = json.loads(body or b"{}")
                    sex = parse_sex(req.get("sex", ""))
                    if "bag_path" in req and not bag_paths_ok:
                        self._send(403, {"error": "server-side bag_path disabled: start with --bag_root "
                                                  "to serve bags on a network-exposed host"})
                        return
                    if self.path == "/heatmap":
                        if "bag_path" not in req:
                            raise ValueError("heatmap requires 'bag_path' (needs patch coordinates)")
                        png = service.heatmap_png(req["bag_path"], sex, patch_size=int(req.get("patch_size", 256)),
                                                  downscale=int(req.get("downscale", 32)),
                                                  task=str(req.get("task", "origin")))
                    else:
                        self._queued = time.perf_counter()
                        out = _predict_json(service, req, sex, in_dim)
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})
                return
            except PermissionError:
                self._send(403, {"error": "bag_path outside the served bag root"})
                return
            except FileNotFoundError:
                # no path echo: probing outside bag_root must not leak host structure
                self._send(404, {"error": "feature bag not found"})
                return
            except Exception as e:  # device/runtime failure: report it, keep serving
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            # outside the error mapping: a client that disconnects mid-write
            # must not trigger a second response
            if png is not None:
                self._send_bytes(png)
            else:
                self._send(200, out)

    return DrainableHTTPServer((host, port), Handler)


def serve_in_thread(service: InferenceService, host: str = "127.0.0.1", port: int = 0):
    """Start the HTTP server on a daemon thread; returns (server, port)."""
    server = make_http_server(service, host, port)
    threading.Thread(target=server.serve_forever, name="toad-serve-http", daemon=True).start()
    return server, server.server_address[1]
