"""P7 against K3 in the ViT-L/16 encoder: speed and accuracy.

Counterpart of ``experiments/vit_softmax_probe.py``. P7, the probe's softmax
variant of the fused ViT attention (scale * log2(e) folded into q, a bare
exp2, the normalisation deferred past p @ v onto the [N, 64] context), is the
second instance of ``csrc/mha.cu``
(:func:`toad_tpu_torch.ops.vit_attention.fused_mha_new`); K3 is the
encoder's (:func:`~toad_tpu_torch.ops.vit_attention.fused_mha`). Arms:

- ab:        the full bf16 forward (tanh GELU) with K3 ("old") and with P7
             ("new"), interleaved --reps times, tiles/s of each and their
             ratio t_old / t_new (one line per rep: rep0, rep1, ...);
- deviation: both forwards on 8 tiles against the f32 truth (the f32
             encoder with the einsum attention, ``plain_mha``, and exact
             GELU: the JAX probe's ``attention="xla"`` encoder), as a
             fraction of the truth's mean |feature|, and P7 against K3.

Run: python -m toad_tpu_torch.experiments.vit_softmax_probe [--batch 128 --hw 224 --k 4]
Prints one JSON line per rep and one for the deviation.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from toad_tpu_torch.experiments import resolve_device
from toad_tpu_torch.experiments.vit_probe_common import (
    emit, heads, launch_counts, make_block, make_vit_fwd, probe_parser, seeded_encoder, select_arms,
    serial_time, tile_chain)
from toad_tpu_torch.models.vit_encoder import ViTConfig
from toad_tpu_torch.ops.vit_attention import fused_mha, fused_mha_new, plain_mha

B, HW, K = 128, 224, 4
RUNS = 2  # serial_time(..., runs=2) in the JAX probe
REPS = 3
TRUTH_TILES = 8
C = ViTConfig()
ARMS = ["ab", "deviation"]


def main(argv: list[str] | None = None) -> int:
    ap = probe_parser(__doc__, B, HW, K, RUNS)
    ap.add_argument("--reps", type=int, default=REPS, help="interleaved old/new repetitions")
    args = ap.parse_args(argv)
    arms = select_arms(args.arms, ARMS)
    dev = resolve_device(args.device)
    enc = seeded_encoder(C, dev)
    fwd_old = make_vit_fwd(C, enc, make_block(C, heads(fused_mha, C), tanh_gelu=True))
    fwd_new = make_vit_fwd(C, enc, make_block(C, heads(fused_mha_new, C), tanh_gelu=True))

    for arm in arms:
        if arm == "ab":
            fn_old = tile_chain(fwd_old, args.batch, args.hw, args.k, dev)
            fn_new = tile_chain(fwd_new, args.batch, args.hw, args.k, dev)
            n = args.batch * args.k
            for rep in range(args.reps):  # interleaved, so that drift on the card cannot favour one arm
                before = launch_counts()
                t_old = serial_time(fn_old, 1, runs=args.runs)
                t_new = serial_time(fn_new, 1, runs=args.runs)
                emit({"arm": f"rep{rep}", "old_tiles_per_s": n / t_old, "new_tiles_per_s": n / t_new,
                      "ratio": t_old / t_new}, dev, before)
        else:
            before = launch_counts()
            g = torch.Generator(device=dev).manual_seed(9)
            tiles = torch.rand(TRUTH_TILES, args.hw, args.hw, 3, generator=g, device=dev)
            c32 = dataclasses.replace(C, compute_dtype="float32")
            # (the encoder runs the truth's f32 patch embedding without TF32 itself)
            truth = make_vit_fwd(c32, enc, make_block(c32, heads(plain_mha, C), tanh_gelu=False))(tiles)
            sc = truth.abs().mean().item()
            f_new, f_old = fwd_new(tiles.to(torch.bfloat16)), fwd_old(tiles.to(torch.bfloat16))
            emit({"arm": "deviation", "feature_scale": sc,
                  "old_kernel": (f_old - truth).abs().max().item() / sc,
                  "new_kernel": (f_new - truth).abs().max().item() / sc,
                  "new_vs_old": (f_new - f_old).abs().max().item() / sc}, dev, before)
    return 0


if __name__ == "__main__":
    sys.exit(main())
