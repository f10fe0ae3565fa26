"""Is int8 worth it for the ViT-L/16 encoder's GEMMs?

Counterpart of ``experiments/vit_int8_probe.py``: chains of the four block
GEMMs at ViT-L's shapes over M = 128 tiles x 197 tokens = 25,216 rows,

    qkv:  [M, 1024] @ [1024, 3072]     proj: [M, 1024] @ [1024, 1024]
    fc1:  [M, 1024] @ [1024, 4096]     fc2:  [M, 4096] @ [4096, 1024]

each product's input the first K columns of the last one's output, K_CHAIN
serially dependent passes a run:

- A_bf16:      bf16 GEMMs (f32 sums rounded to bf16), tanh(h) * 0.1 after
               each to keep magnitudes bounded;
- B_int8_full: int8 x int8 -> int32 GEMMs (``torch._int_mm``) with the rows
               of each input quantized per row (:func:`quant_rows`), the
               weights per column, and the dequantization ``y * s_row *
               s_col`` in f32: what a real int8 block would pay;
- C_int8_raw:  the int8 GEMMs alone, each int32 result cut back to int8 by
               ``>> 8`` (wrapping, as the JAX conversion does).

The weights are drawn from a seeded generator (normal * 0.02), the input of
each run on the card. The JAX probe computes these GEMMs as plain
``dot_general``s outside any Pallas kernel; here they are cuBLAS calls.
Each line: ms per run, TFLOP/s (TOP/s) counted as 2·M·sum(K·N)·K_CHAIN, and
the speed-up over A_bf16.

Run: python -m toad_tpu_torch.experiments.vit_int8_probe [--m 25216 --k_chain 8]
Prints one JSON line per arm.
"""

from __future__ import annotations

import argparse
import sys

import torch

from toad_tpu_torch.experiments import resolve_device
from toad_tpu_torch.experiments.vit_probe_common import bf16_value, emit, launch_counts, select_arms, serial_time
from toad_tpu_torch.ops.quantize import _quantize

M = 128 * 197
SHAPES = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)]
K_CHAIN = 8
RUNS = 3
AMAX_FLOOR = 1e-8  # the probe's floor (the pooling quantizer's is 1e-6)
ARMS = ["A_bf16", "B_int8_full", "C_int8_raw"]


def quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[M, K] float -> (int8, f32 per-row scales [M]): scale = max(amax,
    1e-8) / 127, q = clip(round_half_even(x / scale), -127, 127), the clip
    before the cast."""
    return _quantize(x, -1, AMAX_FLOOR)


def probe_weights(seed: int, device: torch.device):
    """(f32 weights [K, N], bf16 weights, int8 weights, f32 column scales
    [N]), the weights drawn normal * 0.02 from a seeded generator. The int8
    weights are stored column-major (an [N, K] array seen as [K, N]), the
    layout cuBLASLt's int8 tensor-core GEMM reads as it is."""
    g = torch.Generator().manual_seed(seed)
    ws = [(torch.randn(k, n, generator=g) * 0.02).to(device) for k, n in SHAPES]
    wq = [_quantize(w, 0, AMAX_FLOOR) for w in ws]
    return ws, [w.to(torch.bfloat16) for w in ws], [q.t().contiguous().t() for q, _ in wq], [s for _, s in wq]


def chain_bf16(ws: list[torch.Tensor], x: torch.Tensor, k_chain: int) -> torch.Tensor:
    """x [M, 1024] bf16 through k_chain passes: the last x."""
    tenth, eps = bf16_value(0.1), bf16_value(1e-6)
    for _ in range(k_chain):
        h = x
        for w in ws:
            h = torch.tanh(h[:, : w.shape[0]] @ w) * tenth
        x = h[:, :1024] + x * eps
    return x


def chain_int8(wqs: list[torch.Tensor], wss: list[torch.Tensor], x: torch.Tensor, k_chain: int) -> torch.Tensor:
    """x [M, 1024] f32 through k_chain passes of quantize -> int8 GEMM ->
    dequantize -> tanh * 0.1: the last x."""
    for _ in range(k_chain):
        h = x
        for wq, ws_ in zip(wqs, wss):
            hq, hs = quant_rows(h[:, : wq.shape[0]])
            h = torch.tanh(torch._int_mm(hq, wq).float() * hs[:, None] * ws_[None, :]) * 0.1
        x = h[:, :1024] + x * 1e-6
    return x


def chain_int8_raw(wqs: list[torch.Tensor], x: torch.Tensor, k_chain: int) -> torch.Tensor:
    """x [M, 1024] int8 through k_chain passes of int8 GEMMs, each int32
    result cut back by (y >> 8) to int8 (wrapping), pass i adding i % 2 to
    element [0, 0]: the last x."""
    for i in range(k_chain):
        h = x
        for wq in wqs:
            h = (torch._int_mm(h[:, : wq.shape[0]].contiguous(), wq) >> 8).to(torch.int8)
        x = h[:, :1024].clone()
        x[0, 0] += i % 2
    return x


def counted_flops(m: int, k_chain: int) -> float:
    return 2 * m * sum(k * n for k, n in SHAPES) * k_chain


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--m", type=int, default=M, help="rows (the JAX probe's M = 128 tiles x 197 tokens)")
    ap.add_argument("--k_chain", type=int, default=K_CHAIN, help="serially dependent passes a run")
    ap.add_argument("--runs", type=int, default=RUNS, help="timed runs, the best kept")
    ap.add_argument("--arms", default=None, help="comma-separated arms to run (default: all, in the JAX order)")
    ap.add_argument("--device", default="cuda", help="cuda (the default), or cpu for the plain versions")
    args = ap.parse_args(argv)
    names = select_arms(args.arms, ARMS)
    dev = resolve_device(args.device)
    ws, ws_bf16, wqs, wss = probe_weights(0, dev)
    del ws

    def draw(seed, kind):
        g = torch.Generator(device=dev).manual_seed(seed)
        if kind == "int8":
            return torch.randint(-127, 128, (args.m, 1024), generator=g, device=dev, dtype=torch.int32).to(torch.int8)
        x = torch.randn(args.m, 1024, generator=g, device=dev)
        return x.to(torch.bfloat16) if kind == "bf16" else x

    # each run ends in the sum of the last x (int64 for the int8 chain)
    runs = {"A_bf16": lambda s: chain_bf16(ws_bf16, draw(s, "bf16"), args.k_chain).sum(),
            "B_int8_full": lambda s: chain_int8(wqs, wss, draw(s, "f32"), args.k_chain).sum(),
            "C_int8_raw": lambda s: chain_int8_raw(wqs, draw(s, "int8"), args.k_chain).sum()}
    flops = counted_flops(args.m, args.k_chain)
    t_bf16 = None
    for name in names:
        before = launch_counts()
        with torch.inference_mode():
            t = serial_time(runs[name], 1, runs=args.runs)
        if name == "A_bf16":
            t_bf16 = t
        rate = flops / t / 1e12 if dev.type == "cuda" else None  # no device rate from a CPU run
        emit({"arm": name, "ms": t * 1e3, "tflops_counted": rate,
              "x_bf16": t_bf16 / t if t_bf16 is not None and name != "A_bf16" else None}, dev, before)
    return 0


if __name__ == "__main__":
    sys.exit(main())
