"""Serving load test: drive the DynamicBatcher at a given concurrency and
report throughput, latency percentiles and coalescing.

Counterpart of ``experiments/serve_load.py`` on the port, with a seeded
``ToadMIL`` (random weights) on the card. ``--wire none`` calls the batcher
directly and measures the serving core (coalescing, padded batched
forwards, one pooling-kernel launch per batch, the fan-out of results);
``--wire json`` and ``--wire raw`` send every request through the real HTTP
server on loopback, as a ``features_b64`` JSON document or as
``application/octet-stream`` bytes with ``X-Toad-*`` headers. The report
then tells the wire's host cost apart: ``host_cpu_s`` is the process's CPU
time over the run and ``host_cpu_ms_per_req`` that time per request.

With ``--timestamps`` each request is stamped at four stages on the
host's monotonic clock: ``sent`` (the client starts it), ``accepted`` (the
server's handler began; over no wire, the call into the batcher),
``queued`` (the decoded request went to the batcher; over no wire, the
enqueue returned) and ``answered`` (the client has the whole answer), and
one JSON line a request, before the run's line, gives the four in ms from
the burst's start and its largest gap named by the stage it ended
(``accepted``: connecting and the request's headers; ``queued``: the body
read and decoded; ``answered``: batching, the forward and the reply), so
that a request that stalls names the side that held it.

Run: python -m toad_tpu_torch.experiments.serve_load [--concurrency 32
     --requests 512 --bag_n 8192 --max_batch 32 --max_wait_ms 5 --bf16
     --int8 --wire raw --device cuda --timestamps]
Prints one JSON line, with the keys of the JAX probe's (after the
requests' lines with ``--timestamps``); ``device`` is the GPU's name
(``cpu`` with ``--device cpu``, where the plain versions run and no device
metric is claimed).
"""

from __future__ import annotations

import argparse
import base64
import http.client
import json
import threading
import time

import numpy as np
import torch

from toad_tpu_torch.cli.common import add_xla_only_args, note_xla_only
from toad_tpu_torch.config import DEFAULT_BUCKETS, ModelConfig
from toad_tpu_torch.experiments import device_name, resolve_device
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.serve import DynamicBatcher, InferenceService, ServeConfig, serve_in_thread

N_BAGS = 4  # distinct bags, reused round-robin: payloads differ per thread, device work is representative
STAGES = ("sent", "accepted", "queued", "answered")  # --timestamps: a request's stages, in order


def _http_request(port: int, wire: str, bag: np.ndarray, sex: int) -> tuple[float, float]:
    """One /predict over loopback, as a features_b64 JSON document or raw
    bytes; returns the server's (accepted, queued) stamps."""
    if wire == "json":
        body = json.dumps({
            "features_b64": base64.b64encode(bag.astype("<f4").tobytes()).decode(),
            "shape": [int(bag.shape[0]), int(bag.shape[1])],
            "sex": sex,
        }).encode()
        headers = {"Content-Type": "application/json"}
    else:
        body = bag.astype("<f4").tobytes()
        headers = {"Content-Type": "application/octet-stream", "X-Toad-Shape": f"{bag.shape[0]},{bag.shape[1]}",
                   "X-Toad-Sex": str(sex)}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/predict", body, {**headers, "X-Toad-Trace": "1"})
        r = conn.getresponse()
        out = r.read()
    finally:
        conn.close()
    if r.status != 200:
        raise RuntimeError(f"/predict answered {r.status}: {out[:200]!r}")
    stamps = dict(kv.split("=") for kv in r.getheader("X-Toad-Timing").split(","))
    return float(stamps["accepted"]), float(stamps["queued"])


def request_line(index: int, stamps: tuple[float, ...], t0: float) -> dict:
    """One request's --timestamps line: its stages in ms from ``t0`` and the
    largest gap between two stages, named by the stage it ended."""
    ms = [round((t - t0) * 1e3, 3) for t in stamps]
    gaps = {STAGES[i]: ms[i] - ms[i - 1] for i in range(1, len(STAGES))}
    worst = max(gaps, key=gaps.get)
    return {"request": index, **dict(zip(STAGES, ms)), "largest_gap": worst, "largest_gap_ms": round(gaps[worst], 3)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--concurrency", type=int, default=32)
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--bag_n", type=int, default=8192)
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--max_batch", type=int, default=32)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--bf16_transfer", action="store_true")
    ap.add_argument("--int8", action="store_true",
                    help="the int8 serving path: rows quantized on the handler thread, the int8 pooling kernel")
    ap.add_argument("--wire", choices=("none", "json", "raw"), default="none",
                    help="route requests through the real HTTP server: json=features_b64 document, "
                    "raw=application/octet-stream; none=direct batcher calls")
    ap.add_argument("--device", default="cuda", help="cuda (the default), or cpu for the plain versions")
    ap.add_argument("--timestamps", action="store_true",
                    help="one JSON line a request before the run's: its stages sent, accepted, queued, answered "
                    "and its largest gap")
    add_xla_only_args(ap, "pallas")
    args = ap.parse_args(argv)
    note_xla_only(args)
    dev = resolve_device(args.device)

    cfg = ModelConfig(in_dim=args.dim, n_classes=18, compute_dtype="bfloat16" if args.bf16 else "float32")
    params = ToadMIL(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    bags = [rng.standard_normal((args.bag_n, args.dim)).astype(np.float32) for _ in range(N_BAGS)]
    serve_cfg = ServeConfig(max_batch=args.max_batch, max_wait_ms=args.max_wait_ms, bucket_sizes=DEFAULT_BUCKETS,
                            transfer_dtype="bfloat16" if args.bf16_transfer else "float32", int8=args.int8)

    if args.wire == "none":
        batcher = DynamicBatcher(params, cfg, serve_cfg, device=dev)

        def predict(bag, sex):
            accepted = time.perf_counter()
            fut = batcher.submit(bag, sex)
            queued = time.perf_counter()
            fut.result()
            return accepted, queued

        close = batcher.close
    else:
        service = InferenceService(params, cfg, serve_cfg, device=dev)
        batcher = service.batcher
        server, port = serve_in_thread(service)

        def predict(bag, sex):
            return _http_request(port, args.wire, bag, sex)

        def close():
            server.shutdown()
            server.server_close()
            service.close()

    lat: list[float] = []
    stamps: list[tuple[float, ...]] = []
    lat_lock = threading.Lock()
    errors: list[BaseException] = []
    try:
        predict(bags[0], 0)  # the first call builds the kernels and sizes the allocator
        per_thread = args.requests // args.concurrency

        def client(tid: int) -> None:
            try:
                for i in range(per_thread):
                    sent = time.perf_counter()
                    accepted, queued = predict(bags[(tid + i) % N_BAGS], (tid + i) % 2)
                    answered = time.perf_counter()
                    with lat_lock:
                        lat.append(answered - sent)
                        stamps.append((sent, accepted, queued, answered))
            except BaseException as e:  # noqa: BLE001 - raised again on the main thread
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t,)) for t in range(args.concurrency)]
        cpu0 = time.process_time()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        host_cpu = time.process_time() - cpu0
        stats = batcher.stats()
    finally:
        close()
    if errors:
        raise errors[0]

    if args.timestamps:
        for i, st in enumerate(sorted(stamps)):
            print(json.dumps(request_line(i, st, t0)))
    lat_ms = np.asarray(lat) * 1e3
    print(json.dumps({
        "requests": len(lat),
        "concurrency": args.concurrency,
        "slides_per_sec": round(len(lat) / wall, 1),
        "latency_p50_ms": round(float(np.percentile(lat_ms, 50)), 2),
        "latency_p95_ms": round(float(np.percentile(lat_ms, 95)), 2),
        "latency_p99_ms": round(float(np.percentile(lat_ms, 99)), 2),
        "mean_batch_size": round(stats.mean_batch_size, 2),
        "batches": stats.batches,
        "padded_slot_frac": round(stats.padded_slots / max(stats.batched_slides + stats.padded_slots, 1), 3),
        "max_batch": args.max_batch,
        "max_wait_ms": args.max_wait_ms,
        "bag_n": args.bag_n,
        "transfer": "int8" if args.int8 else ("bf16" if args.bf16_transfer else "f32"),
        "wire": args.wire,
        "host_cpu_s": round(host_cpu, 2),
        "host_cpu_ms_per_req": round(host_cpu / max(len(lat), 1) * 1e3, 2),
        "device": device_name(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
