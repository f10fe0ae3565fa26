"""The bf16 matmul rate this card reaches: the denominator for the pooling
kernels' share of the card's peak.

Counterpart of ``experiments/matmul_ceiling.py``, on cuBLAS (``torch.mm``):
no kernel of the repo runs here. The shapes are the JAX probe's: two large
squares (the card's best case) and the pooling kernel's own per-tile GEMMs,
trunk1 [tile, 1024] @ [1024, 512], trunk2 [tile, 512] @ [512, 512] and gate
[tile, 512] @ [512, 768], at 1,024, 2,048 and 8,192 rows. Inputs are bf16,
products accumulate in f32 and the output is f32 (the JAX
``preferred_element_type``). Each timing is a chain of ``--k`` calls (8 where
m > 4096), each input the last one plus bf16(sum(out) * 1e-12), so that every
call depends on the one before and none can be skipped, ended by one scalar
read; x is drawn on the device from a seeded generator in each run, w once.
On the card the chain is captured once as a CUDA graph and replayed, as the
JAX chain is one compiled loop: the host's launch issue, which would set the
pace of the small shapes, is not timed. The best of ``--runs`` after a
warm-up; TFLOP/s over 2·m·k·n a call, against ``PEAK_BF16`` (989 TFLOP/s,
dense bf16, H100 SXM at 700 W).

Run: python -m toad_tpu_torch.experiments.matmul_ceiling [--k 64 --runs 3] [--device cpu]
Prints one JSON line a shape.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from toad_tpu_torch.experiments import PEAK_BF16, resolve_device

SHAPES = [
    ("square4096", 4096, 4096, 4096),
    ("square8192", 8192, 8192, 8192),
    ("trunk1_t1024", 1024, 1024, 512),
    ("trunk2_t1024", 1024, 512, 512),
    ("gate_t1024", 1024, 512, 768),
    ("trunk1_t2048", 2048, 1024, 512),
    ("trunk2_t2048", 2048, 512, 512),
    ("trunk1_t8192", 8192, 1024, 512),
]


def mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x @ bf16 w with f32 accumulation and an f32 output. The CPU has no
    ``out_dtype`` matmul: there the bf16 values are widened first, which
    gives the same exact products."""
    if x.device.type == "cuda":
        return torch.mm(x, w, out_dtype=torch.float32)
    return torch.mm(x.float(), w.float())


def make_chain(w: torch.Tensor, m: int, k: int):
    """f(seed) -> float: draws x [m, K] (f32 normal, rounded to bf16), runs the
    chain of k dependent calls and reads the f32 sum of every output back."""
    dev, kk = w.device, w.shape[0]
    x = torch.empty(m, kk, dtype=torch.bfloat16, device=dev)

    def body() -> torch.Tensor:
        xx, acc = x, torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(k):
            s = mm_f32(xx, w).sum()
            xx = xx + (s * 1e-12).to(torch.bfloat16)
            acc = acc + s
        return acc

    def draw(seed: int) -> None:
        g = torch.Generator(device=dev).manual_seed(seed)
        x.copy_(torch.randn(m, kk, generator=g, device=dev).to(torch.bfloat16))

    if dev.type != "cuda":
        def run(seed: int) -> float:
            draw(seed)
            return float(body())
        return run

    side = torch.cuda.Stream(dev)  # capture needs one eager pass first, on a side stream
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        acc = body()

    def replay(seed: int) -> float:
        draw(seed)
        graph.replay()
        return float(acc)

    return replay


@torch.inference_mode()
def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--k", type=int, default=64, help="chained calls per timing")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (the default), or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for name, m, kk, n in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        w = (torch.randn(kk, n, generator=g, device=dev) * 0.02).to(torch.bfloat16)
        k = args.k if m <= 4096 else max(8, args.k // 8)
        f = make_chain(w, m, k)
        f(6)  # warm-up (the JAX probe's key 7 + -1)
        times = []
        for i in range(args.runs):
            t0 = time.perf_counter()
            f(7 + i)
            times.append(time.perf_counter() - t0)
        t = min(times)
        tf = 2 * m * kk * n * k / t / 1e12
        print(json.dumps({
            "shape": name, "mkn": [m, kk, n],
            "tflops": round(tf, 1), "pct_peak": round(100 * tf / PEAK_BF16, 1),
            "us_per_call": round(t / k * 1e6, 1),
        }), flush=True)
        del f, w
    return 0


if __name__ == "__main__":
    sys.exit(main())
