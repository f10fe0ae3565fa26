"""The price of the ViT-L/16 encoder's elementwise work: LayerNorm and GELU.

Counterpart of ``experiments/vit_elementwise_probe.py``: the full bf16
forward with K3 and each of

- A_prod:       f32 LayerNorm statistics, exact (erf) GELU (control);
- D1_bf16_ln:   LayerNorm computed in bf16, statistics included (also the
                final norm);
- D2_tanh_gelu: the tanh approximation of GELU;
- D3_both:      D1 + D2.

Each line has the arm's tiles/s and ``rel_dev``, its largest deviation from
A_prod's features on 4 seeded tiles relative to A_prod's largest |feature|:
the numerics price of any gain.

Run: python -m toad_tpu_torch.experiments.vit_elementwise_probe [--batch 128 --hw 224 --k 4]
Prints one JSON line per arm.
"""

from __future__ import annotations

import sys

import torch

from toad_tpu_torch.experiments import resolve_device
from toad_tpu_torch.experiments.vit_probe_common import (
    bf16_value, emit, heads, launch_counts, make_block, make_vit_fwd, probe_parser, seeded_encoder, select_arms, serial_time,
    tile_chain)
from toad_tpu_torch.models.vit_encoder import ViTConfig, _layer_norm
from toad_tpu_torch.ops.vit_attention import fused_mha

B, HW, K = 128, 224, 4
RUNS = 3
SMALL = 4  # tiles of the deviation check
C = ViTConfig(attention="fused")
ARMS = {"A_prod": (False, False), "D1_bf16_ln": (True, False), "D2_tanh_gelu": (False, True), "D3_both": (True, True)}


def bf16_layer_norm(x: torch.Tensor, ln, eps: float) -> torch.Tensor:
    """LayerNorm with every step in bf16, as the probe's ``make_ln(True)``:
    each mean sums in f32 and rounds once (what ``jnp.mean`` does with bf16),
    every elementwise step rounds to bf16, eps too."""
    xb = x.to(torch.bfloat16)
    n = xb.shape[-1]
    mu = (xb.float().sum(-1, keepdim=True) / n).to(torch.bfloat16)
    d = xb - mu
    var = ((d * d).float().sum(-1, keepdim=True) / n).to(torch.bfloat16)
    # rsqrt in f32, rounded to bf16 (as XLA evaluates a bf16 rsqrt; PyTorch's bf16 rsqrt on the CPU is off by an ulp)
    r = torch.rsqrt((var + bf16_value(eps)).float()).to(torch.bfloat16)
    return d * r * ln.weight.to(torch.bfloat16) + ln.bias.to(torch.bfloat16)


def make_fwd(enc, bf16_ln: bool, tanh_gelu: bool):
    ln = bf16_layer_norm if bf16_ln else _layer_norm
    # the LayerNorm under test applies to the final cls-token norm too
    return make_vit_fwd(C, enc, make_block(C, heads(fused_mha, C), tanh_gelu, layer_norm=ln), final_norm=ln)


def main(argv: list[str] | None = None) -> int:
    args = probe_parser(__doc__, B, HW, K, RUNS).parse_args(argv)
    names = select_arms(args.arms, list(ARMS))
    dev = resolve_device(args.device)
    enc = seeded_encoder(C, dev)
    g = torch.Generator(device=dev).manual_seed(9)
    small = torch.rand(SMALL, args.hw, args.hw, 3, generator=g, device=dev) * 255
    base = make_fwd(enc, False, False)(small)
    for name in names:
        fwd = make_fwd(enc, *ARMS[name])
        before = launch_counts()
        t = serial_time(tile_chain(fwd, args.batch, args.hw, args.k, dev), 1, runs=args.runs)
        dev_rel = ((fwd(small) - base).abs().max() / (base.abs().max() + 1e-9)).item()
        emit({"arm": name, f"{name}_tiles_per_s": args.batch * args.k / t, "rel_dev": dev_rel}, dev, before)
    return 0


if __name__ == "__main__":
    sys.exit(main())
