"""The ViT-L/16 attention core's share of the forward (B=128, 224 px).

Counterpart of ``experiments/vit_attn_probe.py``: the full bf16 forward with
exact (erf) GELU and four attention cores, each over qkv [B, N, 3*width]:

- A_full:        the einsum path (``einsum_attention``): bf16 score products
                 with f32 results, softmax in f32, p rounded to bf16, p @ v a
                 bf16 product (the JAX encoder's ``attention="xla"`` block);
                 the f32 [B, H, N, N] scores pass through device memory;
- E_identity:    attention replaced by the v columns: A - E is the core's cost;
- F_dpa:         ``F.scaled_dot_product_attention`` over [B, H, N, Dh], the
                 counterpart of the probe's ``jax.nn.dot_product_attention``
                 arm (a library call, not a kernel of this package);
- G_bf16_scores: the scores rounded to bf16 (a bf16 product), softmax in f32.

Run: python -m toad_tpu_torch.experiments.vit_attn_probe [--batch 128 --hw 224 --k 4]
Prints one JSON line per arm.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from toad_tpu_torch.experiments import resolve_device
from toad_tpu_torch.experiments.vit_probe_common import (
    einsum_attention, emit, identity_attention, launch_counts, make_block, make_vit_fwd, probe_parser, seeded_encoder,
    select_arms, serial_time, tile_chain)
from toad_tpu_torch.models.vit_encoder import ViTConfig

B, HW, K = 128, 224, 4
RUNS = 3
C = ViTConfig()


def _split(qkv: torch.Tensor):
    """qkv [B, N, 3*H*Dh] -> q, k, v [B, H, N, Dh] (views)."""
    b, n, _ = qkv.shape
    return qkv.view(b, n, 3, C.heads, C.head_dim).permute(2, 0, 3, 1, 4).unbind(0)


def _merge(o: torch.Tensor) -> torch.Tensor:
    """[B, H, N, Dh] -> [B, N, H*Dh]."""
    b, h, n, d = o.shape
    return o.transpose(1, 2).reshape(b, n, h * d)


def attn_dpa(qkv: torch.Tensor) -> torch.Tensor:
    return _merge(F.scaled_dot_product_attention(*_split(qkv)))


def attn_bf16_scores(qkv: torch.Tensor) -> torch.Tensor:
    """Scores from a bf16 product (f32 sums rounded to bf16 once), softmax in
    f32 of the scaled bf16 scores, p rounded to bf16, p @ v a bf16 product."""
    q, k, v = _split(qkv)
    s = q @ k.transpose(-1, -2)
    p = torch.softmax(s.float() * C.head_dim ** -0.5, dim=-1).to(qkv.dtype)
    return _merge(p @ v)


def arms() -> dict:
    return {"A_full": einsum_attention(C), "E_identity": identity_attention(C), "F_dpa": attn_dpa,
            "G_bf16_scores": attn_bf16_scores}


def main(argv: list[str] | None = None) -> int:
    args = probe_parser(__doc__, B, HW, K, RUNS).parse_args(argv)
    table = arms()
    names = select_arms(args.arms, list(table))
    dev = resolve_device(args.device)
    enc = seeded_encoder(C, dev)
    for name in names:
        before = launch_counts()
        fn = tile_chain(make_vit_fwd(C, enc, make_block(C, table[name], tanh_gelu=False)), args.batch, args.hw,
                        args.k, dev)
        t = serial_time(fn, 1, runs=args.runs)
        emit({"arm": name, f"{name}_tiles_per_s": args.batch * args.k / t}, dev, before)
    return 0


if __name__ == "__main__":
    sys.exit(main())
