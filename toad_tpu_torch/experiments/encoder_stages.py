"""Per-stage timing of the truncated ResNet-50 encoder: where its tiles/s go,
and how far each stage is from the card's conv ceiling.

Counterpart of ``experiments/encoder_stages.py``, on the port's own encoder
(full width, BN folded, bf16, cuDNN convs in ``channels_last`` on the card;
weights from a seeded generator): the stem with its max pool
(``ResNetEncoder._stem``, the space-to-depth stem where the config has it)
and layer1-3 (``ResNetEncoder.run_stage``), each timed alone on an input of
its own shape at 256 px, then the whole encoder (``apply_folded``), then two
3x3 convs at high channel counts (``F.conv2d`` in bf16 ``channels_last``) as
the achievable conv rate. Each timing is a chain of ``--k`` calls, each input
the last one plus bf16(sum(out) * 1e-12), the input drawn on the device from
a seeded generator in each run, ended by one scalar read; the best of 3
after a warm-up. FLOPs a tile are the JAX probe's exact per-block count
(torchvision v1: the stride on conv2; the downsample in each stage's first
block).

Run: python -m toad_tpu_torch.experiments.encoder_stages [--batch 128 --k 16] [--device cpu]
Prints one JSON line a stage, then ``full``, then the two ceilings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.nn.functional as F

from toad_tpu_torch.config import EncoderConfig
from toad_tpu_torch.experiments import resolve_device
from toad_tpu_torch.models.resnet_encoder import ResNetEncoder

HW = 256
RUNS = 3


def conv_flops(out_h: int, out_w: int, cout: int, kh: int, kw: int, cin: int) -> int:
    return 2 * out_h * out_w * cout * kh * kw * cin


def stage_flops(cfg: EncoderConfig, hw: int = HW) -> list[tuple[str, int]]:
    """(stage, FLOPs a tile) for stem+pool and layer1..N at ``hw`` px."""
    stem_out = hw // 2
    out = [("stem+pool", conv_flops(stem_out, stem_out, cfg.stem_width, 7, 7, 3))]
    spatial, cin = hw // 4, cfg.stem_width
    for s, (n_blocks, width) in enumerate(zip(cfg.blocks, cfg.stage_widths)):
        cout = width * cfg.expansion
        s_out = spatial if s == 0 else spatial // 2
        fl = 0
        for b in range(n_blocks):
            cin_b, s_in = (cin, spatial) if b == 0 else (cout, s_out)
            fl += conv_flops(s_in, s_in, width, 1, 1, cin_b)  # conv1 1x1 (its full-size input)
            fl += conv_flops(s_out, s_out, width, 3, 3, width)  # conv2 3x3 (the stride here)
            fl += conv_flops(s_out, s_out, cout, 1, 1, width)  # conv3 1x1
            if b == 0:
                fl += conv_flops(s_out, s_out, cout, 1, 1, cin_b)  # downsample
        out.append((f"layer{s + 1}", fl))
        spatial, cin = s_out, cout
    return out


def stage_fns(enc: ResNetEncoder, hw: int = HW) -> list[tuple[str, object, tuple[int, ...], bool, int]]:
    """(name, fn(x) -> y, input shape, channels_last input, FLOPs a tile) a
    stage: the stem takes tiles [B, hw, hw, 3] in the compute dtype, a layer
    its NCHW input in channels_last memory."""
    cfg = enc.config
    dt = getattr(torch, cfg.compute_dtype)
    flops = dict(stage_flops(cfg, hw))
    out = [("stem+pool", lambda x: enc._stem(enc._weights(dt), x), (hw, hw, 3), False, flops["stem+pool"])]
    spatial, cin = hw // 4, cfg.stem_width
    for s, ((stage, stride), width) in enumerate(zip(enc.stages(), cfg.stage_widths)):
        name = f"layer{s + 1}"
        out.append((name, lambda x, stage=stage, stride=stride: enc.run_stage(stage, x, stride), (cin, spatial, spatial),
                    True, flops[name]))
        spatial, cin = spatial // stride, width * cfg.expansion
    return out


def time_chain(fn, in_shape: tuple[int, ...], b: int, k: int, dev: torch.device, channels_last: bool,
               runs: int = RUNS) -> float:
    """Best wall time of ``runs`` chains of k dependent calls of fn on a bf16
    input [b, *in_shape] (standard normal), after a warm-up chain."""

    @torch.inference_mode()
    def chain(seed: int) -> float:
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(b, *in_shape, generator=g, device=dev).to(torch.bfloat16)
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(k):
            s = fn(x).sum()
            x = x + (s * 1e-12).to(torch.bfloat16)
            acc = acc + s.float()
        return float(acc)

    chain(6)  # warm-up (the JAX probe's key 7 + -1)
    best = float("inf")
    for i in range(runs):
        t0 = time.perf_counter()
        chain(7 + i)
        best = min(best, time.perf_counter() - t0)
    return best


def conv3x3(w: torch.Tensor):
    return lambda x: F.conv2d(x, w, padding=1)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (the default), or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b, k, hw = args.batch, args.k, HW
    enc = ResNetEncoder(EncoderConfig(), generator=torch.Generator().manual_seed(0)).fold_bn().to(dev).eval()

    total_fl = 0
    for name, fn, in_shape, channels_last, fl in stage_fns(enc, hw):
        t = time_chain(fn, in_shape, b, k, dev, channels_last)
        total_fl += fl
        print(json.dumps({"stage": name, "tflops": round(fl * b * k / t / 1e12, 1),
                          "ms_per_batch": round(t / k * 1e3, 2),
                          "gflop_per_img": round(fl / 1e9, 2)}), flush=True)

    t = time_chain(enc.apply_folded, (hw, hw, 3), b, k, dev, False)
    print(json.dumps({"stage": "full", "tflops": round(total_fl * b * k / t / 1e12, 1),
                      "ms_per_batch": round(t / k * 1e3, 2),
                      "patches_per_sec": round(b * k / t, 1)}), flush=True)

    # the achievable conv rate: 3x3 convs at layer3's and at layer1-2's channel counts
    g = torch.Generator(device=dev).manual_seed(1)
    for cin, side, bb, kk in ((256, hw // 16, b * 8, k * 4), (128, hw // 4, b, k * 4)):
        w = (torch.randn(cin, cin, 3, 3, generator=g, device=dev) * 0.02).to(torch.bfloat16)
        w = w.contiguous(memory_format=torch.channels_last)
        t = time_chain(conv3x3(w), (cin, side, side), bb, kk, dev, True)
        fl = conv_flops(side, side, cin, 3, 3, cin)
        print(json.dumps({"stage": f"conv_ceiling_3x3_{cin}ch_{side}px",
                          "tflops": round(fl * bb * kk / t / 1e12, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
