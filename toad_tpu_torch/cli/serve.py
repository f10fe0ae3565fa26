"""``python -m toad_tpu_torch serve``: online prediction server.

Loads a reference-layout ``s_{fold}_checkpoint.pt`` (or, with
``--ensemble``, every fold of a training results dir) and serves ``POST
/predict`` and ``POST /heatmap`` with dynamic batching
(:mod:`toad_tpu_torch.serve`) on one device, or with ``--data_shards`` /
``--bag_shards`` over a ``('data', 'bag')`` mesh of the visible cards (on the
CPU, of the CPU device repeated). On CUDA the fused pooling kernel is the
path, launched once per ensemble member and batch (under a bag axis its
partial mode, once per bag shard, and the combine); with ``--int8``, the
fused int8 pooling kernel.

``--max_rss_gb`` is the JAX CLI's memory watermark: a watchdog thread reads
the process's RSS every RSS_POLL_S seconds and, once it crosses the
watermark, drains the server and exits RESTART_EXIT_CODE so that a
supervisor starts a fresh one. One deliberate difference: a watermark at or
under the RSS the server has once its model is on the device is refused at
start, where the JAX CLI would serve nothing and exit for a restart at its
first poll, and so again after every restart.
"""

from __future__ import annotations

import argparse
import signal
import threading
import time

from toad_tpu_torch.cli.common import add_xla_only_args, mesh_from_args, note_xla_only
from toad_tpu_torch.utils import profiling

# exit code signalling "restart me" to a supervisor after an RSS-watermark
# drain (distinct from 0 = clean stop and 1 = error)
RESTART_EXIT_CODE = 42
RSS_POLL_S = 5.0  # seconds between the watchdog's reads of the RSS



def make_parser() -> argparse.ArgumentParser:
    from toad_tpu_torch.cli.common import add_buckets_arg, add_temperature_from_arg

    p = argparse.ArgumentParser(prog="python -m toad_tpu_torch serve", description=__doc__)
    p.add_argument("--ckpt", type=str, required=True,
                   help="reference-layout s_k_checkpoint.pt (with --ensemble: a training results dir)")
    p.add_argument("--task", type=str, default=None, help="task JSON (for label names in responses)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default), cuda:<i> or cpu")
    p.add_argument("--encoding_size", type=int, default=1024)
    p.add_argument("--n_classes", type=int, default=None, help="defaults to the task's class count (or 18)")
    p.add_argument("--max_batch", type=int, default=32, help="dynamic-batch size cap")
    p.add_argument("--max_wait_ms", type=float, default=5.0, help="batching window after first request")
    p.add_argument("--attention", action="store_true", help="compute attention scores on every request")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument(
        "--int8", action="store_true",
        help="quantized inference: bags quantized per row on the handler thread (or sent or stored "
        "as int8), int8 host-to-device rows (4x fewer bytes than f32) and the int8 pooling kernel; "
        "heads and softmax stay f32",
    )
    p.add_argument(
        "--bf16_transfer", action="store_true",
        help="force bfloat16 host->device feature transfer even under f32 compute "
        "(on automatically with --bf16)",
    )
    p.add_argument(
        "--temperature", type=float, default=1.0,
        help="calibrated softmax temperature for class probabilities (fit with eval --calibrate; for "
        "--ensemble it is applied per member before the mean, matching predict --ensemble)",
    )
    add_temperature_from_arg(p)
    p.add_argument(
        "--ensemble", action="store_true",
        help="serve the mean-of-folds CV ensemble: --ckpt is a training results dir and every "
        "s_<k>_checkpoint becomes a member; each member runs its own pooling-kernel launch on every "
        "request batch (K x the work). Attention responses carry the mean of the members' softmaxed "
        "pooling weights instead of raw scores",
    )
    add_buckets_arg(p)
    p.add_argument(
        "--bag_root", type=str, default=None, metavar="DIR",
        help="restrict request bag_path to this directory (required for bag_path "
        "when binding beyond loopback); relative bag_paths resolve against it",
    )
    p.add_argument("--max_body_mb", type=int, default=1024, metavar="MB", help="reject POST bodies beyond this size with 413")
    p.add_argument(
        "--max_rss_gb", type=float, default=None, metavar="GB",
        help=f"memory watermark: when host RSS crosses GB, drain gracefully and exit {RESTART_EXIT_CODE} so that a "
        "supervisor restarts the server; refused at start when GB is at or under the RSS the server has once its "
        "model is loaded",
    )
    p.add_argument(
        "--warmup", type=str, default=None, nargs="?", const="all", metavar="BUCKETS",
        help="run the serving shapes once before accepting traffic: 'all' (every "
        "bucket) or comma-separated bucket sizes, each at batch 1 and max_batch",
    )
    p.add_argument(
        "--data_shards", type=int, default=None,
        help="mesh data axis (data-parallel serving); the other axis is inferred when omitted",
    )
    p.add_argument(
        "--bag_shards", type=int, default=None,
        help="mesh bag axis (patch-dim sharding); the other axis is inferred when omitted",
    )
    add_xla_only_args(p, "pallas", "compile_cache")
    return p


def main(argv=None) -> None:
    args = make_parser().parse_args(argv)
    note_xla_only(args)

    import torch

    from toad_tpu_torch.config import ModelConfig
    from toad_tpu_torch.registry import load_task
    from toad_tpu_torch.cli.common import resolve_buckets, resolve_temperature
    from toad_tpu_torch.serve import InferenceService, ServeConfig, make_http_server

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"error: --device {args.device} but CUDA is not available here; pass --device cpu to serve on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"error: --device must be cuda, cuda:<i> or cpu, got {args.device!r}")
    task = load_task(args.task) if args.task else None
    n_classes = args.n_classes or (task.n_classes[0] if task else 18)
    model_cfg = ModelConfig(
        in_dim=args.encoding_size,
        n_classes=n_classes,
        compute_dtype="bfloat16" if args.bf16 else "float32",
    )
    mesh = None
    if args.data_shards is not None or args.bag_shards is not None:
        for name, v in (("data_shards", args.data_shards), ("bag_shards", args.bag_shards)):
            if v is not None and v < 1:
                raise SystemExit(f"--{name} must be >= 1, got {v}")
        # mesh_shape_for infers the other axis when only one flag is given
        mesh = mesh_from_args(args.data_shards, args.bag_shards, device)
        if mesh.size == 1:
            mesh = None  # a single device: the mesh adds nothing
    # the ladder against the actual bag-shard count (the mesh may have inferred it), so that a bad ladder is
    # refused at start, not per request
    buckets = resolve_buckets(args.buckets, bag_shards=mesh.shape["bag"] if mesh is not None else 1)
    serve_cfg = ServeConfig(
        **({"bucket_sizes": buckets} if buckets else {}),
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        need_attention=args.attention,
        transfer_dtype="bfloat16" if args.bf16_transfer else "auto",
        int8=args.int8,
        temperature=resolve_temperature(args.temperature, args.temperature_from),
    )
    service = InferenceService.from_checkpoint(
        args.ckpt, model_cfg, serve_cfg, task=task, bag_root=args.bag_root, device=device, ensemble=args.ensemble,
        mesh=mesh,
    )
    if args.ensemble:
        print(f"ensemble: {service.batcher.n_members} fold checkpoints from {args.ckpt}", flush=True)
    if args.warmup is not None:
        warm = None if args.warmup == "all" else tuple(int(v) for v in args.warmup.split(","))
        t0 = time.perf_counter()
        n = service.batcher.warmup(warm)
        print(f"warmup: {n} shape variants in {time.perf_counter() - t0:.1f}s", flush=True)
    if args.max_rss_gb is not None:
        rss = profiling.host_rss_gb()
        if args.max_rss_gb <= rss:
            service.close()
            raise SystemExit(
                f"error: --max_rss_gb {args.max_rss_gb:g} is at or under this server's RSS with its model loaded, "
                f"{rss:.2f} GiB: the watchdog would drain it before it served anything; give a watermark above it"
            )
    server = make_http_server(service, args.host, args.port, max_body_bytes=args.max_body_mb << 20)
    print(
        f"serving on http://{args.host}:{server.server_address[1]}  "
        f"(POST /predict, POST /heatmap, GET /stats, GET /healthz) on {service.device_name}"
        f"{', int8' if args.int8 else ''}{f'; mesh {mesh.shape}' if mesh is not None else ''}",
        flush=True,
    )

    # graceful stop on SIGTERM/SIGINT: shutdown() blocks until serve_forever
    # exits, so it must run off the serving thread
    def _stop(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    rss_tripped = threading.Event()
    if args.max_rss_gb is not None:
        def _rss_watchdog():
            while not rss_tripped.is_set():
                rss = profiling.host_rss_gb()
                if rss >= args.max_rss_gb:
                    print(
                        f"host RSS {rss:.1f} GiB >= --max_rss_gb {args.max_rss_gb:.1f}: "
                        f"draining for supervisor restart (exit {RESTART_EXIT_CODE})",
                        flush=True,
                    )
                    rss_tripped.set()
                    threading.Thread(target=server.shutdown, daemon=True).start()
                    return
                time.sleep(RSS_POLL_S)

        threading.Thread(target=_rss_watchdog, daemon=True, name="toad-rss-watchdog").start()
    try:
        server.serve_forever()
    finally:
        server.server_close()
        drained = service.close()
        # the batcher drain resolved the futures; let the handler threads
        # finish writing those responses before the process exits
        handlers_done = server.drain_requests(30.0)
        if drained and handlers_done:
            print("server stopped; in-flight requests drained", flush=True)
        elif drained:
            print("server stopped; in-flight requests drained (WARNING: a handler was still writing its response at exit)", flush=True)
        else:
            print("server stopped; WARNING: dispatch thread still busy after timeout", flush=True)
        if rss_tripped.is_set():
            raise SystemExit(RESTART_EXIT_CODE)


if __name__ == "__main__":
    main()
