"""Chip smoke test of the PyTorch/CUDA port (toad_tpu_torch) on one GPU.

Run from the repository root on a machine with one Hopper card:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the exit code is not 0):

1. CUDA present with compute capability (9, 0); the card's name and power limit.
2. Build the fused pooling kernels (toad_tpu_torch/csrc/pool.cu, K1, and
   pool_int8.cu, K2) with nvcc, one process per source; shared memory per
   block and ptxas's register counts.
3. K1 vs its plain PyTorch version at full TOAD width (D=1024, H=512,
   A=384, T=2), f32 and bf16, scored and classification modes, including a
   bag whose tiles past bucket/2+1 are padding and a fully-masked bag: M,
   raw scores and the heads' logits, within the tolerances stated below.
   Then K2 (int8) vs plain_int8_pool on the same cases.
4. Serve end to end: a reference-layout checkpoint and .pt bags from a seed,
   ``python -m toad_tpu_torch serve --bf16`` on port 0, a burst of 24
   concurrent requests over the octet-stream f32/bf16, JSON features_b64 and
   bag_path routes, with and without attention; every answer checked against
   the plain forward on the card. Twice: at the default 5 ms batching window
   (the main path of K1: its kernel launch count is the one reported, and its
   requests/s and p50 are timed), then at a 300 ms window, where /stats must
   show coalescing; SIGTERM drain with requests in flight.
   Then ``serve --int8`` (the main path of K2) at the default window, no
   warmup: 24 concurrent requests over the octet int8, JSON
   features_int8_b64, bag_path (an int8 store made by
   ``python -m toad_tpu_torch convert``) and octet f32 (quantized on the
   handler thread) routes, each answer checked against the plain int8
   forward and the plain bf16 forward on the card; /stats must count int8
   kernel launches >= batches.
5. Timing: kernel launches vs plain versions (CUDA events, median of 5 after
   warm-up, in the order plain, kernel, kernel, plain) and the serving
   bursts' requests/s and p50 latency, each with the card's name and power
   limit.

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
# int8, K2 vs plain_int8_pool: the integer GEMMs and every dequantization
# and requantization step round identically (explicitly rounded kernel
# arithmetic), so scores differ only where tanhf/expf round a gated value to
# the other side of a bf16 tie (~1e-4 on a score); the kernel's online
# softmax rounds e to bf16 against a running max, the plain version against
# the bag's max, which moves pooled means by ~1 bf16 ulp of e averaged over
# the bag.
TOL_INT8_S = dict(atol=1e-3, rtol=1e-3)
TOL_INT8_M = dict(atol=2e-3, rtol=2e-3)
TOL_INT8_LOGITS = dict(atol=2e-3, rtol=2e-3)
# served int8 answers: vs the plain int8 forward on the card, as TOL_PROB;
# vs the plain bf16 forward, the quantization budget of tests/test_int8.py
TOL_INT8_VS_BF16 = 0.02


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
    from toad_tpu_torch.ops import _build, cuda_pool, cuda_pool_int8

    t0 = time.perf_counter()
    _build.load_library()
    took = time.perf_counter() - t0
    how = f"nvcc {_build.build_seconds:.2f} s" if _build.build_seconds is not None else "found built in _build/"
    log(f"phase 2 build: {_build.library_path().name} ready in {took:.2f} s ({how}); "
        f"pool smem/block bf16 {cuda_pool.smem_bytes(torch.bfloat16, 512, 384)} B, "
        f"f32 {cuda_pool.smem_bytes(torch.float32, 512, 384)} B, "
        f"int8 {cuda_pool_int8.smem_bytes(384)} B [{card}]")
    # ptxas -v: each kernel's registers and spills
    kernel = None
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel is not None and ("registers" in line or "spill stores" in line):
            names = {"pool_int8_kernel": "K2 int8", "pool_kernelIf": "K1 f32", "pool_kernelI13": "K1 bf16",
                     "pool_combine_kernel": "combine"}
            name = next((v for k, v in names.items() if k in kernel), kernel)
            log(f"phase 2 build: {name}: {line.split(':', 1)[-1].strip()}")


def compare_cases(g: torch.Generator) -> list:
    """(label, B, N, mask) at the serving shapes, a bag at bucket/2+1 and a
    fully-masked bag between live ones."""
    dev = torch.device("cuda")
    cases = []
    for b, n in ((1, 8192), (3, 8192), (32, 8192), (1, 65536)):
        cases.append((f"B={b} N={n}", b, n, (torch.rand(b, n, device=dev, generator=g) < 0.9).float()))
    tail = torch.zeros(2, 8192, device=dev)
    tail[0, : 8192 // 2 + 1] = 1.0  # bag at bucket/2+1: every later tile is padding
    tail[1, :100] = 1.0
    cases.append(("padding tiles B=2 N=8192", 2, 8192, tail))
    masked = torch.ones(3, 4096, device=dev)
    masked[1] = 0.0  # one fully-masked bag between live ones
    cases.append(("fully-masked bag B=3 N=4096", 3, 4096, masked))
    return cases


def check_modes(label: str, mask, outs: dict, tols: tuple) -> float:
    """Checks one case's kernel and plain outputs in scored and classification
    mode; ``outs[scored] = (M_k, scores_k, logits_k, M_p, scores_p,
    logits_p)``. Returns the largest error of M and scores."""
    tol_m, tol_s, tol_l = tols
    worst = 0.0
    for scored, (mk, sk, lk, mp, sp, lp) in outs.items():
        mode = "scored" if scored else "classification"
        em = check_close(f"{label} {mode} M", mk, mp, tol_m)
        el = check_close(f"{label} {mode} logits", lk, lp, tol_l)
        es = check_close(f"{label} {mode} scores", sk, sp, tol_s) if scored else 0.0
        if not scored and sk is not None:
            raise AssertionError("classification mode returned scores")
        dead = mask.sum(1) == 0
        if dead.any() and (mk[dead].abs().max().item() != 0.0):
            raise AssertionError(f"{label}: a fully-masked bag pooled to nonzero M")
        worst = max(worst, em, es)
        log(f"phase 3 compare {label} {mode}: max abs err M {em:.2e} scores {es:.2e} logits {el:.2e}")
    return worst


def phase_compare(model, seed: int) -> float:
    from toad_tpu_torch.ops import cuda_pool
    from toad_tpu_torch.ops.fused_pool import plain_pool

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = model.pool_params()
    g = torch.Generator(device=dev).manual_seed(seed)
    worst = 0.0
    for label, b, n, mask in compare_cases(g):
        x = torch.randn(b, n, 1024, device=dev, generator=g)
        sex = torch.arange(b, device=dev) % 2
        for dt, tols in (
            (torch.float32, (TOL_F32, TOL_F32, TOL_F32)),
            (torch.bfloat16, (TOL_BF16_M, TOL_BF16_S, TOL_BF16_LOGITS)),
        ):
            outs = {}
            for scored in (True, False):
                with torch.inference_mode():
                    mk, sk = cuda_pool.pool(model.kernel_operands(dt), x, mask, with_scores=scored)
                    mp, sp = plain_pool(params, x, mask, dt, with_scores=scored)
                    lk = model._finish(mk, None, mask, sex, False).logits
                    lp = model._finish(mp, None, mask, sex, False).logits
                torch.cuda.synchronize()
                outs[scored] = (mk, sk, lk, mp, sp, lp)
            worst = max(worst, check_modes(f"{label} {str(dt)[6:]}", mask, outs, tols))
    return worst


def phase_compare_int8(model, seed: int) -> float:
    """K2 against plain_int8_pool on the cases of phase_compare, from rows
    quantized on the card."""
    from toad_tpu_torch.ops import cuda_pool_int8
    from toad_tpu_torch.ops.quantize import plain_int8_pool, quantize_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.inference_mode():
        qparams, ops = model.int8_operands()
    worst = 0.0
    for label, b, n, mask in compare_cases(g):
        xq, sx = quantize_rows(torch.randn(b, n, 1024, device=dev, generator=g))
        sex = torch.arange(b, device=dev) % 2
        outs = {}
        for scored in (True, False):
            with torch.inference_mode():
                mk, sk = cuda_pool_int8.pool_int8(ops, xq, sx, mask, with_scores=scored)
                mp, sp = plain_int8_pool(qparams, xq, sx, mask, with_scores=scored)
                lk = model._finish(mk, None, mask, sex, False).logits
                lp = model._finish(mp, None, mask, sex, False).logits
            torch.cuda.synchronize()
            outs[scored] = (mk, sk, lk, mp, sp, lp)
        worst = max(worst, check_modes(f"{label} int8", mask, outs, (TOL_INT8_M, TOL_INT8_S, TOL_INT8_LOGITS)))
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


def time_pair(label: str, plain_fn, kernel_fn, ops_per_call: float, unit: str, gpu: str) -> tuple[float, float]:
    """Kernel vs plain version, timed plain, kernel, kernel, plain so that
    drift on the card hits both alike: (kernel ms, plain ms), each the
    better of its two medians."""
    p1, k1, k2, p2 = (cuda_ms(fn) for fn in (plain_fn, kernel_fn, kernel_fn, plain_fn))
    k, p = min(k1, k2), min(p1, p2)
    rate = ops_per_call / (k * 1e-3) / 1e12
    verdict = "kernel faster" if k < p else "kernel SLOWER than plain"
    log(f"phase 5 timing {label}: kernel {k:.3f} ms ({k1:.3f}/{k2:.3f}), plain {p:.3f} ms ({p1:.3f}/{p2:.3f}), "
        f"{rate:.1f} {unit}, {verdict} [{gpu}]")
    return k, p


def phase_timing(model, gpu: str) -> dict:
    """Kernel launches on pre-packed operands against the plain versions on
    pre-cast (or pre-quantized) weights: both leave out the weight
    preparation a model does once. Returns {(kernel, B): (ms, plain ms)}."""
    from toad_tpu_torch.ops import cuda_pool, cuda_pool_int8
    from toad_tpu_torch.ops.fused_pool import plain_pool
    from toad_tpu_torch.ops.quantize import plain_int8_pool, quantize_rows

    dev = torch.device("cuda")
    out = {}
    for b, n in ((32, 8192), (1, 65536)):
        x = torch.randn(b, n, 1024, device=dev)
        mask = torch.ones(b, n, device=dev)
        ops_per_call = cuda_pool.flops_per_row(1024, 512, 384) * b * n
        with torch.inference_mode():
            for dt in (torch.bfloat16, torch.float32):
                xd = x.to(dt)
                ops, params = model.kernel_operands(dt), cast_params(model.pool_params(), dt)
                out[(str(dt)[6:], b)] = time_pair(
                    f"pool {str(dt)[6:]} B={b} N={n} D=1024 classification",
                    lambda: plain_pool(params, xd, mask, dt, False), lambda: cuda_pool.pool(ops, xd, mask, False),
                    ops_per_call, "TFLOP/s", gpu)
                del xd
            xq, sx = quantize_rows(x)
            qparams, ops8 = model.int8_operands()
            out[("int8", b)] = time_pair(
                f"pool int8 B={b} N={n} D=1024 classification",
                lambda: plain_int8_pool(qparams, xq, sx, mask, False),
                lambda: cuda_pool_int8.pool_int8(ops8, xq, sx, mask, False),
                ops_per_call, "TOP/s", gpu)
        del x, xq
    return out


def _post(url: str, data: bytes, headers: dict) -> dict:
    req = urllib.request.Request(url, data=data, headers=headers, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def make_requests(seed: int, bag_dir: Path, routes: list[str]) -> list[dict]:
    """24 requests of 3,000-60,000 patches over four routes, attention on
    half. bag_path requests get their bag saved as an f32 .pt under
    ``bag_dir``; int8 routes carry the rows quantized on the client."""
    from toad_tpu_torch.ops.quantize import quantize_rows_np

    rng = np.random.default_rng(seed)
    sizes = [3000, 5000, 7000, 9000, 12000, 20000, 30000, 60000]
    reqs = []
    for i in range(24):
        route = routes[i % 4]
        n = sizes[(i * 3) % len(sizes)]
        if route == "json_b64":
            n = min(n, 9000)  # base64 JSON is the slow convenience route
        elif route == "json_int8":
            n = min(n, 20000)  # int8 rows are a quarter of the f32 bytes
        feats = rng.standard_normal((n, 1024), dtype=np.float32)
        if route == "octet_bf16":
            feats = torch.from_numpy(feats).bfloat16().float().numpy()  # what the client sends, exactly
        path = None
        if route == "bag_path":
            path = bag_dir / f"slide_{i}.pt"
            torch.save(torch.from_numpy(feats), path)
        req = dict(route=route, feats=feats, sex=i % 2, attention=(i // 4) % 2 == 1, path=path)
        if route in ("octet_int8", "json_int8"):
            req["xq"], req["sx"] = quantize_rows_np(feats)
        reqs.append(req)
    return reqs


ROUTES = ["octet_f32", "octet_bf16", "json_b64", "bag_path"]
ROUTES_INT8 = ["octet_int8", "json_int8", "bag_path", "octet_f32"]


def send(base: str, r: dict) -> tuple[dict, float]:
    t0 = time.perf_counter()
    if r["route"].startswith("octet"):
        dtype = r["route"].split("_")[1]
        if dtype == "bf16":
            body = torch.from_numpy(r["feats"]).bfloat16().view(torch.int16).numpy().tobytes()
        elif dtype == "int8":
            body = r["xq"].tobytes() + r["sx"].tobytes()
        else:
            body = r["feats"].tobytes()
        hdr = {"Content-Type": "application/octet-stream", "X-Toad-Shape": f"{len(r['feats'])},1024",
               "X-Toad-Dtype": {"bf16": "bfloat16", "f32": "float32"}.get(dtype, dtype), "X-Toad-Sex": str(r["sex"]),
               "X-Toad-Attention": "1" if r["attention"] else "0"}
        out = _post(base + "/predict", body, hdr)
    else:
        doc = {"sex": r["sex"], "attention": r["attention"], "top_k": 3}
        if r["route"] == "bag_path":
            doc["bag_path"] = r["path"].name
        elif r["route"] == "json_int8":
            doc["features_int8_b64"] = base64.b64encode(r["xq"].tobytes()).decode()
            doc["scales_b64"] = base64.b64encode(r["sx"].tobytes()).decode()
            doc["shape"] = list(r["xq"].shape)
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


def plain_bf16_reference(model, r: dict):
    """The plain bf16 forward of one request on the card."""
    dev = torch.device("cuda")
    x = torch.from_numpy(r["feats"]).to(dev)[None]
    mask = torch.ones(1, x.shape[1], device=dev)
    with torch.inference_mode():
        return plain_forward(model, x, mask, torch.tensor([r["sex"]], device=dev), torch.bfloat16, r["attention"])


def plain_int8_reference(model, r: dict):
    """The plain int8 forward of one request on the card, from its rows
    quantized on the host (what every int8 route serves: the client's rows,
    the store's rows, or the handler thread's quantization of f32 rows)."""
    from toad_tpu_torch.ops.quantize import plain_int8_pool, quantize_rows_np

    dev = torch.device("cuda")
    xq, sx = (torch.from_numpy(a).to(dev)[None] for a in quantize_rows_np(r["feats"]))
    mask = torch.ones(1, xq.shape[1], device=dev)
    with torch.inference_mode():
        qparams, _ = model.int8_operands()
        m, scores = plain_int8_pool(qparams, xq, sx, mask, with_scores=r["attention"])
        return model._finish(m, scores, mask, torch.tensor([r["sex"]], device=dev), False)


def check_answers(model, reqs: list[dict], results: list, reference=plain_bf16_reference,
                  tol_attention: dict = TOL_BF16_S) -> tuple[float, int]:
    """Every answer against a plain forward on the card: (max |y_prob
    error|, near-ties)."""
    near_ties = 0
    worst = 0.0
    for r, (out, _lat) in zip(reqs, results):
        ref = reference(model, r)
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
            check_close(f"{r['route']} attention", torch.from_numpy(a_got), torch.from_numpy(a_ref), tol_attention)
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


def write_checkpoint(model, workdir: Path) -> Path:
    """The model as a reference-layout s_0_checkpoint.pt."""
    from toad_tpu_torch.models.interop import reference_state_dict

    ckpt = workdir / "s_0_checkpoint.pt"
    torch.save({k: v.cpu() for k, v in reference_state_dict(model.state_dict(), dropout=True).items()}, ckpt)
    return ckpt


def p50_by_route(reqs: list[dict], results: list, routes: list[str]) -> str:
    return ", ".join(
        f"{route} {statistics.median(res[1] for r, res in zip(reqs, results) if r['route'] == route) * 1e3:.1f}"
        for route in routes)


def phase_serve(model, seed: int, gpu: str, workdir: Path) -> dict:
    ckpt = write_checkpoint(model, workdir)
    bag_dir = workdir / "bags"
    bag_dir.mkdir()
    reqs = make_requests(seed, bag_dir, ROUTES)
    attn = sum(r["attention"] for r in reqs)

    # main path: the server as a user starts it (default 5 ms batching window,
    # no --warmup). Its kernel launch count starts at 0 in the fresh process;
    # /stats reads it after the burst.
    with Server(ckpt, bag_dir, workdir, []) as srv:
        health = _get(srv.base + "/healthz")
        if health.get("device") != gpu.split(",")[0].strip():
            raise AssertionError(f"/healthz device {health} is not the card {gpu}")
        before = _get(srv.base + "/stats")
        if before["kernel_launches"] != 0 or before["int8_kernel_launches"] != 0 or before["requests"] != 0:
            raise AssertionError(f"fresh server already counts work: {before}")
        results, wall = burst(srv.base, reqs)
        stats = _get(srv.base + "/stats")
        worst, near_ties = check_answers(model, reqs, results)
        if stats["requests"] != len(reqs) or stats["kernel_launches"] < max(1, stats["batches"]):
            raise AssertionError(f"kernel launches {stats['kernel_launches']} < batches {stats['batches']}: {stats}")
        if stats["int8_kernel_launches"] != 0:
            raise AssertionError(f"the bf16 server launched the int8 kernel: {stats}")
        srv.stop()
    log(f"phase 4 serve (5 ms window): p50 latency by route (ms): {p50_by_route(reqs, results, ROUTES)} [{gpu}]")
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


def phase_serve_int8(model, seed: int, gpu: str, workdir: Path) -> dict:
    """``serve --int8`` as a user starts it (default 5 ms window, no
    --warmup), fed by an int8 store that ``convert`` makes from .pt bags."""
    ckpt = write_checkpoint(model, workdir)
    src, store = workdir / "bags8_f32", workdir / "bags8"
    src.mkdir()
    reqs = make_requests(seed + 1, src, ROUTES_INT8)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    conv = subprocess.run([sys.executable, "-m", "toad_tpu_torch", "convert", "--data_dir", str(src), "--out_dir",
                           str(store), "--format", "int8"], capture_output=True, text=True, env=env, cwd=workdir,
                          timeout=600)
    if conv.returncode != 0:
        raise AssertionError(f"convert failed ({conv.returncode}):\n{conv.stdout}{conv.stderr}")
    log(f"phase 4 serve int8: {conv.stdout.strip()} in {time.perf_counter() - t0:.2f} s")
    for r in reqs:
        if r["path"] is not None:
            r["path"] = store / f"{r['path'].stem}.npz"
    attn = sum(r["attention"] for r in reqs)

    with Server(ckpt, store, workdir, ["--int8"]) as srv:
        before = _get(srv.base + "/stats")
        if before["int8_kernel_launches"] != 0 or before["kernel_launches"] != 0 or before["requests"] != 0:
            raise AssertionError(f"fresh server already counts work: {before}")
        if before["config"]["int8"] is not True:
            raise AssertionError(f"/stats does not show int8 mode: {before['config']}")
        results, wall = burst(srv.base, reqs)
        stats = _get(srv.base + "/stats")
        srv.stop()
    worst, near_ties = check_answers(model, reqs, results, plain_int8_reference, TOL_INT8_S)
    if stats["requests"] != len(reqs) or stats["int8_kernel_launches"] < max(1, stats["batches"]):
        raise AssertionError(f"int8 kernel launches {stats['int8_kernel_launches']} < batches {stats['batches']}: {stats}")
    if stats["kernel_launches"] != 0:
        raise AssertionError(f"the int8 server launched the float kernel: {stats}")
    # against the bf16 plain forward: the quantization budget
    vs_bf16, top1 = 0.0, 0
    for r, (out, _lat) in zip(reqs, results):
        p_ref = plain_bf16_reference(model, r).y_prob[0].cpu().numpy()
        vs_bf16 = max(vs_bf16, float(np.abs(np.asarray(out["y_prob"]) - p_ref).max()))
        top1 += out["y_hat"] == int(p_ref.argmax())
    if vs_bf16 > TOL_INT8_VS_BF16:
        raise AssertionError(f"int8 answers off the bf16 forward by {vs_bf16:.3e} > {TOL_INT8_VS_BF16}")
    lat = sorted(res[1] for res in results)
    log(f"phase 4 serve int8 (5 ms window): p50 latency by route (ms): {p50_by_route(reqs, results, ROUTES_INT8)} [{gpu}]")
    log(f"phase 4 serve int8 (5 ms window): {len(reqs)} concurrent requests ({', '.join(ROUTES_INT8)}; attention "
        f"on {attn}), {stats['batches']} batches, mean batch {stats['mean_batch_size']}, int8 kernel launches "
        f"{stats['int8_kernel_launches']}, max |y_prob - plain int8| {worst:.2e}, near-ties {near_ties}; "
        f"max |y_prob - plain bf16| {vs_bf16:.2e}, top-1 agreement with bf16 {top1}/{len(reqs)}; burst wall "
        f"{wall:.3f} s, dispatch thread in batch assembly {stats['assemble_s']:.3f} s, in device forwards "
        f"{stats['forward_s']:.3f} s [{gpu}]")
    return dict(launches=stats["int8_kernel_launches"], batches=stats["batches"], worst=worst,
                rps=len(reqs) / wall, p50=statistics.median(lat), wall=wall)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    card, gpu = phase_device()
    log(gpu)
    phase_build(gpu)
    model = seeded_model(args.seed).cuda().eval()
    worst = phase_compare(model, args.seed)
    worst8 = phase_compare_int8(model, args.seed)
    with tempfile.TemporaryDirectory(prefix="toad_smoke_") as tmp:
        served = phase_serve(model, args.seed, gpu, Path(tmp))
    with tempfile.TemporaryDirectory(prefix="toad_smoke_int8_") as tmp:
        served8 = phase_serve_int8(model, args.seed, gpu, Path(tmp))
    times = phase_timing(model, gpu)
    for label, res in (("bf16 compute", served), ("int8", served8)):
        log(f"phase 5 timing serve ({label}): {res['rps']:.2f} requests/s, p50 latency {res['p50'] * 1e3:.1f} ms "
            f"over a burst of 24 concurrent requests (3,000-60,000 patches, default 5 ms batching window, "
            f"no warmup) [{gpu}]")
    record = {"kernels": [
        {
            "name": "fused_trunk_attention_pool",
            "route": "cuda",
            "source": "toad_tpu_torch/csrc/pool.cu",
            "replaces": "toad_tpu/ops/pallas_pool.py:93",
            "launches": served["launches"],
            "max_abs_err": worst,
            "ms": times[("bfloat16", 32)][0],
            "plain_ms": times[("bfloat16", 32)][1],
        },
        {
            "name": "int8_trunk_attention_pool",
            "route": "cuda",
            "source": "toad_tpu_torch/csrc/pool_int8.cu",
            "replaces": "toad_tpu/ops/pallas_pool.py:259",
            "launches": served8["launches"],
            "max_abs_err": worst8,
            "ms": times[("int8", 32)][0],
            "plain_ms": times[("int8", 32)][1],
        },
    ]}
    log(gpu)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
