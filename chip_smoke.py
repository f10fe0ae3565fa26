"""Chip smoke test of the PyTorch/CUDA port (toad_tpu_torch) on one GPU.

Run from the repository root on a machine with one Hopper card:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the exit code is not 0):

1. CUDA present with compute capability (9, 0); the card's name and power limit.
2. Build the fused pooling kernel (toad_tpu_torch/csrc/pool.cu) with nvcc.
3. Kernel vs its plain PyTorch version at full TOAD width (D=1024, H=512,
   A=384, T=2), f32 and bf16, scored and classification modes, including a
   bag whose tiles past bucket/2+1 are padding and a fully-masked bag: M,
   raw scores and the heads' logits, within the tolerances stated below.
4. Serve end to end: a reference-layout checkpoint and .pt bags from a seed,
   ``python -m toad_tpu_torch serve --bf16`` on port 0, a burst of 24
   concurrent requests over the octet-stream f32/bf16, JSON features_b64 and
   bag_path routes, with and without attention; every answer checked against
   the plain forward on the card. Twice: at the default 5 ms batching window
   (the main path: its kernel launch count is the one reported, and its
   requests/s and p50 are timed), then at a 300 ms window, where /stats must
   show coalescing; SIGTERM drain with requests in flight.
5. Timing: kernel launch vs plain version (CUDA events, median of 5 after
   warm-up) and the serving burst's requests/s and p50 latency, each with the
   card's name and power limit.

The second-to-last line is the kernels' JSON record, the last line the device
record. Weights and data are random, made from --seed.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# Tolerances, kernel vs plain version on the card.
# f32: both compute in full f32 (no TF32); they differ only in summation
# order, as the TPU kernel's parity test (tests/test_pallas.py) allows.
TOL_F32 = dict(atol=2e-3, rtol=2e-3)
# bf16: the plain version rounds each activation after adding its bias in
# bf16 (x@W in bf16, then + b in bf16), the kernel adds the f32 bias to the
# f32 accumulator and rounds once, and the kernel rounds the softmax weights
# to bf16 before e^T h (the TPU kernel's rounding points). Each intermediate
# may then differ by about one bf16 ulp (2^-8 relative), which the 384-wide
# score head can sum to ~1e-2 on O(1) scores; pooled means average it down.
TOL_BF16_M = dict(atol=1e-2, rtol=1e-2)
TOL_BF16_S = dict(atol=4e-2, rtol=4e-2)
TOL_BF16_LOGITS = dict(atol=2e-2, rtol=2e-2)
TOL_PROB = 1e-2  # served class probabilities vs the plain forward (bf16 compute)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: dict) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    bad = err > tol["atol"] + tol["rtol"] * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} values outside {tol}, max abs err {err.max().item():.3e}")
    return err.max().item()


def seeded_model(seed: int):
    from toad_tpu_torch.config import ModelConfig
    from toad_tpu_torch.models.toad_mil import ToadMIL

    g = torch.Generator().manual_seed(seed)
    model = ToadMIL(ModelConfig(in_dim=1024, n_classes=18), generator=g)
    with torch.no_grad():  # reference init zeroes the biases; random ones exercise the bias paths
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.05)
    return model


def plain_forward(model, x, mask, sex, compute_dtype, need_attention):
    """The model's forward with the plain pooling in place of the kernel."""
    from toad_tpu_torch.ops.fused_pool import plain_pool

    m, scores = plain_pool(model.pool_params(), x, mask, compute_dtype, with_scores=need_attention)
    return model._finish(m, scores, mask, sex, False)


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """The plain pool's params already in the compute dtype, so that timing
    it leaves out the per-call weight casts, as the kernel's packed operands do."""
    return {k: cast_params(v, dtype) if isinstance(v, dict) else v.to(dtype) for k, v in params.items()}


# -- phases -------------------------------------------------------------------


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False: this check needs a CUDA GPU")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: compute capability {cap}, the kernels are built for sm_90a (9, 0)")
    line = gpu_line()
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} capability {cap}, "
        f"torch {torch.__version__} cuda {torch.version.cuda}, python {sys.version.split()[0]}")
    return torch.cuda.get_device_name(0), line


def phase_build(card: str) -> None:
    from toad_tpu_torch.ops import _build, cuda_pool

    t0 = time.perf_counter()
    _build.load_library()
    took = time.perf_counter() - t0
    how = f"nvcc {_build.build_seconds:.2f} s" if _build.build_seconds is not None else "found built in _build/"
    log(f"phase 2 build: {_build.library_path().name} ready in {took:.2f} s ({how}); "
        f"pool smem/block bf16 {cuda_pool.smem_bytes(torch.bfloat16, 512, 384)} B, "
        f"f32 {cuda_pool.smem_bytes(torch.float32, 512, 384)} B [{card}]")


def phase_compare(model, seed: int) -> float:
    from toad_tpu_torch.ops import cuda_pool
    from toad_tpu_torch.ops.fused_pool import plain_pool

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = model.pool_params()
    g = torch.Generator(device=dev).manual_seed(seed)
    cases = []  # (label, B, N, mask)
    for b, n in ((1, 8192), (3, 8192), (32, 8192), (1, 65536)):
        cases.append((f"B={b} N={n}", b, n, (torch.rand(b, n, device=dev, generator=g) < 0.9).float()))
    tail = torch.zeros(2, 8192, device=dev)
    tail[0, : 8192 // 2 + 1] = 1.0  # bag at bucket/2+1: every later tile is padding
    tail[1, :100] = 1.0
    cases.append(("padding tiles B=2 N=8192", 2, 8192, tail))
    masked = torch.ones(3, 4096, device=dev)
    masked[1] = 0.0  # one fully-masked bag between live ones
    cases.append(("fully-masked bag B=3 N=4096", 3, 4096, masked))

    worst = 0.0
    for label, b, n, mask in cases:
        x = torch.randn(b, n, 1024, device=dev, generator=g)
        sex = torch.arange(b, device=dev) % 2
        for dt, tol_m, tol_s, tol_l in (
            (torch.float32, TOL_F32, TOL_F32, TOL_F32),
            (torch.bfloat16, TOL_BF16_M, TOL_BF16_S, TOL_BF16_LOGITS),
        ):
            for scored in (True, False):
                with torch.inference_mode():
                    mk, sk = cuda_pool.pool(model.kernel_operands(dt), x, mask, with_scores=scored)
                    mp, sp = plain_pool(params, x, mask, dt, with_scores=scored)
                    lk = model._finish(mk, None, mask, sex, False).logits
                    lp = model._finish(mp, None, mask, sex, False).logits
                torch.cuda.synchronize()
                mode = "scored" if scored else "classification"
                em = check_close(f"{label} {dt} {mode} M", mk, mp, tol_m)
                el = check_close(f"{label} {dt} {mode} logits", lk, lp, tol_l)
                es = check_close(f"{label} {dt} {mode} scores", sk, sp, tol_s) if scored else 0.0
                if not scored and sk is not None:
                    raise AssertionError("classification mode returned scores")
                dead = mask.sum(1) == 0
                if dead.any() and (mk[dead].abs().max().item() != 0.0):
                    raise AssertionError(f"{label}: a fully-masked bag pooled to nonzero M")
                worst = max(worst, em, es)
                log(f"phase 3 compare {label} {str(dt)[6:]} {mode}: max abs err M {em:.2e} "
                    f"scores {es:.2e} logits {el:.2e}")
    return worst


def cuda_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of fn() after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_timing(model, gpu: str) -> tuple[float, float]:
    """Kernel launches on pre-packed operands against the plain version on
    pre-cast weights: both leave out the weight preparation a model does once."""
    from toad_tpu_torch.ops import cuda_pool
    from toad_tpu_torch.ops.fused_pool import plain_pool

    dev = torch.device("cuda")
    main = None
    for dt, b, n in ((torch.bfloat16, 32, 8192), (torch.float32, 32, 8192), (torch.bfloat16, 1, 65536), (torch.float32, 1, 65536)):
        x = torch.randn(b, n, 1024, device=dev).to(dt)
        mask = torch.ones(b, n, device=dev)
        with torch.inference_mode():
            ops, params = model.kernel_operands(dt), cast_params(model.pool_params(), dt)
            # plain, kernel, kernel, plain: drift on the card hits both alike
            p1 = cuda_ms(lambda: plain_pool(params, x, mask, dt, False))
            k1 = cuda_ms(lambda: cuda_pool.pool(ops, x, mask, False))
            k2 = cuda_ms(lambda: cuda_pool.pool(ops, x, mask, False))
            p2 = cuda_ms(lambda: plain_pool(params, x, mask, dt, False))
        k, p = min(k1, k2), min(p1, p2)
        tflops = cuda_pool.flops_per_row(1024, 512, 384) * b * n / (k * 1e-3) / 1e12
        verdict = "kernel faster" if k < p else "kernel SLOWER than plain"
        log(f"phase 5 timing pool {str(dt)[6:]} B={b} N={n} D=1024 classification: kernel {k:.3f} ms "
            f"({k1:.3f}/{k2:.3f}), plain {p:.3f} ms ({p1:.3f}/{p2:.3f}), {tflops:.1f} TFLOP/s, {verdict} [{gpu}]")
        if main is None:
            main = (k, p)
        del x
    return main


def _post(url: str, data: bytes, headers: dict) -> dict:
    req = urllib.request.Request(url, data=data, headers=headers, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def make_requests(seed: int, bag_dir: Path) -> list[dict]:
    """24 requests of 3,000-60,000 patches over four routes, attention on half."""
    rng = np.random.default_rng(seed)
    sizes = [3000, 5000, 7000, 9000, 12000, 20000, 30000, 60000]
    reqs = []
    for i in range(24):
        route = ROUTES[i % 4]
        n = sizes[(i * 3) % len(sizes)]
        if route == "json_b64":
            n = min(n, 9000)  # base64 JSON is the slow convenience route
        feats = rng.standard_normal((n, 1024), dtype=np.float32)
        if route == "octet_bf16":
            feats = torch.from_numpy(feats).bfloat16().float().numpy()  # what the client sends, exactly
        path = None
        if route == "bag_path":
            path = bag_dir / f"slide_{i}.pt"
            torch.save(torch.from_numpy(feats), path)
        reqs.append(dict(route=route, feats=feats, sex=i % 2, attention=(i // 4) % 2 == 1, path=path))
    return reqs


ROUTES = ["octet_f32", "octet_bf16", "json_b64", "bag_path"]


def send(base: str, r: dict) -> tuple[dict, float]:
    t0 = time.perf_counter()
    if r["route"].startswith("octet"):
        bf16 = r["route"] == "octet_bf16"
        body = (torch.from_numpy(r["feats"]).bfloat16().view(torch.int16).numpy().tobytes()
                if bf16 else r["feats"].tobytes())
        hdr = {"Content-Type": "application/octet-stream", "X-Toad-Shape": f"{len(r['feats'])},1024",
               "X-Toad-Dtype": "bfloat16" if bf16 else "float32", "X-Toad-Sex": str(r["sex"]),
               "X-Toad-Attention": "1" if r["attention"] else "0"}
        out = _post(base + "/predict", body, hdr)
    else:
        doc = {"sex": r["sex"], "attention": r["attention"], "top_k": 3}
        if r["route"] == "bag_path":
            doc["bag_path"] = r["path"].name
        else:
            doc["features_b64"] = base64.b64encode(r["feats"].tobytes()).decode()
            doc["shape"] = list(r["feats"].shape)
        out = _post(base + "/predict", json.dumps(doc).encode(), {"Content-Type": "application/json"})
    return out, time.perf_counter() - t0


def burst(base: str, reqs: list[dict]) -> tuple[list, float]:
    """All requests at once, one client thread each: (answers, wall seconds)."""
    results: list = [None] * len(reqs)
    errors: list = []

    def worker(i: int) -> None:
        try:
            results[i] = send(base, reqs[i])
        except Exception as e:  # handed to the main thread, which raises
            errors.append((i, repr(e)))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError(f"requests failed: {errors}")
    return results, wall


def check_answers(model, reqs: list[dict], results: list) -> tuple[float, int]:
    """Every answer against the plain forward on the card: (max |y_prob
    error|, near-ties)."""
    dev = torch.device("cuda")
    near_ties = 0
    worst = 0.0
    for r, (out, _lat) in zip(reqs, results):
        x = torch.from_numpy(r["feats"]).to(dev)[None]
        mask = torch.ones(1, x.shape[1], device=dev)
        with torch.inference_mode():
            ref = plain_forward(model, x, mask, torch.tensor([r["sex"]], device=dev), torch.bfloat16, r["attention"])
        p_ref = ref.y_prob[0].cpu().numpy()
        p_got = np.asarray(out["y_prob"])
        err = float(np.abs(p_got - p_ref).max())
        worst = max(worst, err)
        if err > TOL_PROB:
            raise AssertionError(f"{r['route']} n={len(r['feats'])}: y_prob off by {err:.3e} > {TOL_PROB}")
        if out["y_hat"] != int(p_ref.argmax()):
            top2 = np.sort(p_ref)[-2:]
            if top2[1] - top2[0] > 2 * TOL_PROB:
                raise AssertionError(f"{r['route']}: y_hat {out['y_hat']} != plain {int(p_ref.argmax())}")
            near_ties += 1  # the two best classes are closer than the tolerance
        if r["attention"]:
            a_ref = ref.attention[0, 0].cpu().numpy()
            a_got = np.asarray(out["attention"])
            if a_got.shape != a_ref.shape:
                raise AssertionError(f"attention shape {a_got.shape} != {a_ref.shape}")
            check_close(f"{r['route']} attention", torch.from_numpy(a_got), torch.from_numpy(a_ref), TOL_BF16_S)
        elif "attention" in out:
            raise AssertionError("attention returned without being asked for")
    return worst, near_ties


class Server:
    """``python -m toad_tpu_torch serve --bf16`` on port 0 in a child process."""

    def __init__(self, ckpt: Path, bag_dir: Path, workdir: Path, extra: list[str]):
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [sys.executable, "-m", "toad_tpu_torch", "serve", "--ckpt", str(ckpt), "--task", "dummy_mtl_concat",
               "--bf16", "--port", "0", "--bag_root", str(bag_dir), *extra]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=workdir)
        self.lines: list[str] = []

    def __enter__(self) -> "Server":
        deadline = time.monotonic() + 300
        port = None
        while port is None:
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError(f"server exited before serving (rc {self.proc.poll()}):\n{''.join(self.lines)}")
            self.lines.append(line)
            if line.startswith("serving on "):
                port = int(line.split()[2].rsplit(":", 1)[1])
            if time.monotonic() > deadline:
                raise RuntimeError("server did not start within 300 s")
        threading.Thread(target=lambda: self.lines.extend(self.proc.stdout), daemon=True).start()
        self.base = f"http://127.0.0.1:{port}"
        return self

    def stop(self, signalled: bool = False) -> int:
        """SIGTERM (graceful drain) unless already sent; the exit code, which
        must be 0."""
        if not signalled:
            self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=300)
        if rc != 0 or not any("in-flight requests drained" in ln for ln in self.lines):
            raise AssertionError(f"server did not drain and exit 0 (rc {rc}):\n{''.join(self.lines[-20:])}")
        return rc

    def __exit__(self, *exc) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def phase_serve(model, seed: int, gpu: str, workdir: Path) -> dict:
    from toad_tpu_torch.models.interop import reference_state_dict

    ckpt = workdir / "s_0_checkpoint.pt"
    torch.save({k: v.cpu() for k, v in reference_state_dict(model.state_dict(), dropout=True).items()}, ckpt)
    bag_dir = workdir / "bags"
    bag_dir.mkdir()
    reqs = make_requests(seed, bag_dir)
    attn = sum(r["attention"] for r in reqs)

    # main path: the server as a user starts it (default 5 ms batching window,
    # no --warmup). Its kernel launch count starts at 0 in the fresh process;
    # /stats reads it after the burst.
    with Server(ckpt, bag_dir, workdir, []) as srv:
        health = _get(srv.base + "/healthz")
        if health.get("device") != gpu.split(",")[0].strip():
            raise AssertionError(f"/healthz device {health} is not the card {gpu}")
        before = _get(srv.base + "/stats")
        if before["kernel_launches"] != 0 or before["requests"] != 0:
            raise AssertionError(f"fresh server already counts work: {before}")
        results, wall = burst(srv.base, reqs)
        stats = _get(srv.base + "/stats")
        worst, near_ties = check_answers(model, reqs, results)
        if stats["requests"] != len(reqs) or stats["kernel_launches"] < max(1, stats["batches"]):
            raise AssertionError(f"kernel launches {stats['kernel_launches']} < batches {stats['batches']}: {stats}")
        srv.stop()
    by_route = ", ".join(
        f"{route} {statistics.median(res[1] for r, res in zip(reqs, results) if r['route'] == route) * 1e3:.1f}"
        for route in ROUTES)
    log(f"phase 4 serve (5 ms window): p50 latency by route (ms): {by_route} [{gpu}]")
    lat = sorted(res[1] for res in results)
    log(f"phase 4 serve (5 ms window): {len(reqs)} concurrent requests ({', '.join(ROUTES)}; attention on "
        f"{attn}), {stats['batches']} batches, mean batch {stats['mean_batch_size']}, kernel launches "
        f"{stats['kernel_launches']}, max |y_prob - plain| {worst:.2e}, near-ties {near_ties}; "
        f"burst wall {wall:.3f} s, dispatch thread in batch assembly {stats['assemble_s']:.3f} s, "
        f"in device forwards {stats['forward_s']:.3f} s [{gpu}]")
    main = dict(launches=stats["kernel_launches"], batches=stats["batches"], worst=worst,
                rps=len(reqs) / wall, p50=statistics.median(lat), wall=wall)

    # coalescing and drain: a 300 ms window gathers the burst into shared forwards
    with Server(ckpt, bag_dir, workdir, ["--max_wait_ms", "300"]) as srv:
        results, wall = burst(srv.base, reqs)
        stats = _get(srv.base + "/stats")
        worst, near_ties = check_answers(model, reqs, results)
        if not stats["batches"] < stats["requests"] == len(reqs):
            raise AssertionError(f"no coalescing: {stats}")
        if stats["kernel_launches"] < stats["batches"]:
            raise AssertionError(f"kernel launches {stats['kernel_launches']} < batches {stats['batches']}")
        lat = sorted(res[1] for res in results)
        log(f"phase 4 serve (300 ms window): {stats['batches']} batches, mean batch {stats['mean_batch_size']}, "
            f"kernel launches {stats['kernel_launches']}, max |y_prob - plain| {worst:.2e}, near-ties {near_ties}, "
            f"{len(reqs) / wall:.2f} requests/s, p50 {statistics.median(lat) * 1e3:.1f} ms; burst wall "
            f"{wall:.3f} s, assembly {stats['assemble_s']:.3f} s, forwards {stats['forward_s']:.3f} s [{gpu}]")

        # graceful drain: SIGTERM while accepted requests are still in flight
        tail: list = [None] * 4
        errors: list = []

        def worker(i: int) -> None:
            try:
                tail[i] = send(srv.base, reqs[i])
            except Exception as e:  # handed to the main thread, which raises
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        while _get(srv.base + "/stats")["requests"] < stats["requests"] + 4:
            if time.monotonic() > deadline:
                raise AssertionError("drain requests never reached the batcher")
            time.sleep(0.01)
        srv.proc.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(300)
        rc = srv.stop(signalled=True)
        if errors or any(res is None for res in tail):
            raise AssertionError(f"drain failed: errors {errors}")
        check_answers(model, reqs[:4], tail)
    log(f"phase 4 drain: SIGTERM with 4 requests in flight, all answered, server exit {rc}")
    return main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    card, gpu = phase_device()
    log(gpu)
    phase_build(gpu)
    model = seeded_model(args.seed).cuda().eval()
    worst = phase_compare(model, args.seed)
    with tempfile.TemporaryDirectory(prefix="toad_smoke_") as tmp:
        served = phase_serve(model, args.seed, gpu, Path(tmp))
    kernel_ms, plain_ms = phase_timing(model, gpu)
    log(f"phase 5 timing serve: {served['rps']:.2f} requests/s, p50 latency {served['p50'] * 1e3:.1f} ms "
        f"over a burst of 24 concurrent requests (3,000-60,000 patches, bf16 compute, default 5 ms "
        f"batching window, no warmup) [{gpu}]")
    record = {"kernels": [{
        "name": "fused_trunk_attention_pool",
        "route": "cuda",
        "source": "toad_tpu_torch/csrc/pool.cu",
        "replaces": "toad_tpu/ops/pallas_pool.py:93",
        "launches": served["launches"],
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}
    log(gpu)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
