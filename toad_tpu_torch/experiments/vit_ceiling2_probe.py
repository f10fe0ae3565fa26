"""Where is the ViT-L/16 ceiling with the fused attention and tanh GELU?

Counterpart of ``experiments/vit_ceiling2_probe.py``: the full bf16 forward
(tanh GELU) with the attention core and the LayerNorm each on or off, to
split the time between the attention kernel (K3), the f32 LayerNorm and the
block GEMMs:

- A_full_fused:     K3, LayerNorm on (the encoder as it ships);
- B_identity_attn:  attention replaced by the v columns, LayerNorm on;
- C_fused_no_ln:    K3, LayerNorm replaced by the identity;
- D_identity_no_ln: both off (GEMMs + GELU + residual floor).

Run: python -m toad_tpu_torch.experiments.vit_ceiling2_probe [--batch 128 --hw 224 --k 4]
Prints one JSON line per arm.
"""

from __future__ import annotations

import sys

from toad_tpu_torch.experiments import resolve_device
from toad_tpu_torch.experiments.vit_probe_common import (
    emit, heads, identity_attention, launch_counts, make_block, make_vit_fwd, probe_parser, seeded_encoder,
    select_arms, serial_time, tile_chain)
from toad_tpu_torch.models.vit_encoder import ViTConfig, _layer_norm
from toad_tpu_torch.ops.vit_attention import fused_mha

B, HW, K = 128, 224, 4
RUNS = 3
C = ViTConfig()  # gelu="auto" -> tanh under bf16


def no_norm(x, ln, eps):
    return x


def arms() -> dict:
    """name -> (attention core, layer norm)."""
    fused, identity = heads(fused_mha, C), identity_attention(C)
    return {"A_full_fused": (fused, _layer_norm), "B_identity_attn": (identity, _layer_norm),
            "C_fused_no_ln": (fused, no_norm), "D_identity_no_ln": (identity, no_norm)}


def main(argv: list[str] | None = None) -> int:
    args = probe_parser(__doc__, B, HW, K, RUNS).parse_args(argv)
    table = arms()
    names = select_arms(args.arms, list(table))
    dev = resolve_device(args.device)
    enc = seeded_encoder(C, dev)
    for name in names:
        attn, ln = table[name]
        before = launch_counts()
        fn = tile_chain(make_vit_fwd(C, enc, make_block(C, attn, tanh_gelu=True, layer_norm=ln)), args.batch,
                        args.hw, args.k, dev)
        t = serial_time(fn, 1, runs=args.runs)
        emit({"arm": name, f"{name}_tiles_per_s": args.batch * args.k / t}, dev, before)
    return 0


if __name__ == "__main__":
    sys.exit(main())
