"""ViT patch encoder (ViT-L/16 "UNI"-style).

PyTorch counterpart of :mod:`toad_tpu.models.vit_encoder`. Pathology
foundation models like UNI (Chen et al. 2024) are timm ViT-L/16 checkpoints
trained with the DINOv2 recipe: pre-norm transformer blocks with LayerScale,
a GELU MLP, a cls token whose final-norm embedding is the 1024-d tile
feature, a drop-in replacement for the truncated ResNet-50 at the same
feature width.

- The module's parameters are named as timm names them (``patch_embed.proj``,
  ``blocks.{i}.attn.qkv``, ``blocks.{i}.ls1.gamma``, ``norm``...), so a timm
  ``state_dict`` loads directly; :func:`params_from_timm_state_dict` cleans
  one up (prefixes, wrappers, the older ``gamma_1`` naming) and infers the
  config from it.
- Casts follow the JAX encoder: the residual stream, the matrix products and
  the patch-embed convolution run in the compute dtype (bf16 by default),
  LayerNorm in f32 with the biased variance, softmax statistics in f32
  (:func:`~toad_tpu_torch.ops.vit_attention.fused_mha`), the result is f32.
  The weights are cast to the compute dtype once per model and again only
  when one changes (the JAX encoder casts inside its jitted program).
- Tiles come in as the JAX encoder takes them, ``[B, H, W, 3]``; position
  embeddings are resized on the fly for tiles off the pretrain size, with the
  cubic kernel of ``jax.image.resize``.
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from toad_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from toad_tpu_torch.models import exact_f32_convs
from toad_tpu_torch.ops.vit_attention import fused_mha


@dataclass(frozen=True)
class ViTConfig:
    """ViT-L/16 by default (UNI's architecture)."""

    patch_size: int = 16
    width: int = 1024
    depth: int = 24
    heads: int = 16
    mlp_ratio: int = 4
    pretrain_img_size: int = 224  # grid the stored pos_embed was trained at
    layerscale: bool = True  # DINOv2/UNI use LayerScale; vanilla ViT doesn't
    ln_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # attention core: 'auto' and 'fused' both mean fused_mha, whose kernel
    # runs on a CUDA tensor and whose plain version on a CPU tensor. The JAX
    # package's third value, 'xla' (its einsum path), has no counterpart.
    attention: str = "auto"
    # GELU form: 'exact' = erf (timm's nn.GELU), 'tanh' = the tanh
    # approximation, 'auto' = tanh under bf16 compute (the deviation is below
    # bf16's own rounding), exact under f32
    gelu: str = "auto"

    @property
    def out_dim(self) -> int:
        return self.width

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


def _check_attention(c: ViTConfig) -> None:
    if c.attention not in ("auto", "fused"):
        raise ValueError(
            f"ViTConfig.attention must be auto|fused, got {c.attention!r} "
            "('xla' names the JAX package's einsum path, which this package does not have)"
        )


def _resolve_gelu(c: ViTConfig) -> bool:
    """True = tanh-approximate GELU (see ViTConfig.gelu)."""
    if c.gelu not in ("auto", "exact", "tanh"):
        raise ValueError(f"ViTConfig.gelu must be auto|exact|tanh, got {c.gelu!r}")
    if c.gelu == "auto":
        return c.compute_dtype == "bfloat16"
    return c.gelu == "tanh"


def _layer_norm(x: torch.Tensor, ln: nn.Module, eps: float) -> torch.Tensor:
    """LayerNorm in f32 with the biased variance over the last axis, by the
    parameters of ``ln`` (a LayerNorm module): x in any dtype -> f32."""
    return F.layer_norm(x.float(), (x.shape[-1],), ln.weight, ln.bias, eps)


def _block(x: torch.Tensor, bw: dict[str, Any], norms: tuple, c: ViTConfig, dt: torch.dtype,
           attn: Callable[[torch.Tensor], torch.Tensor], tanh_gelu: bool, layer_norm=_layer_norm) -> torch.Tensor:
    """One pre-norm block on tokens ``x`` [B, N, width] in ``dt``: ``bw`` the
    block's weights in ``dt`` (:meth:`ViTEncoder._weights`), ``norms`` its
    (norm1, norm2), ``attn`` the attention core, qkv [B, N, 3*width] ->
    context [B, N, width]. ``layer_norm(x, ln, eps)`` is the normalisation
    (the probes swap it out); its result is cast to ``dt``."""
    h = layer_norm(x, norms[0], c.ln_eps).to(dt)
    qkv = h @ bw["qkv"][0].t() + bw["qkv"][1]
    o = attn(qkv)
    o = o @ bw["proj"][0].t() + bw["proj"][1]
    if "ls1" in bw:
        o = o * bw["ls1"]
    x = x + o

    h = layer_norm(x, norms[1], c.ln_eps).to(dt)
    h = F.gelu(h @ bw["fc1"][0].t() + bw["fc1"][1], approximate="tanh" if tanh_gelu else "none")
    h = h @ bw["fc2"][0].t() + bw["fc2"][1]
    if "ls2" in bw:
        h = h * bw["ls2"]
    return x + h


# ---------------------------------------------------------------------------
# Position-embedding resize with the cubic kernel of jax.image.resize


def _cubic_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_in, n_out] interpolation weights of ``jax.image.resize(...,
    "cubic")`` along one axis: the Keys kernel with a = -0.5 at half-pixel
    centres, widened when shrinking (antialias), each output's weights
    renormalised to sum 1 (which is what happens at the edges, where part of
    the kernel falls outside). ``F.interpolate(mode="bicubic")`` uses
    a = -0.75 and clamps instead, and differs at the 1e-2 level."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    total = w.sum(0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > 1000.0 * eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_pos_embed(pos: torch.Tensor, c: ViTConfig, gh: int, gw: int) -> torch.Tensor:
    """Cubic grid resize of the stored pos_embed ``[1, 1 + n0*n0, D]`` to the
    tile's grid (timm ``dynamic_img_size``); the cls position passes through."""
    n0 = c.pretrain_img_size // c.patch_size
    if (gh, gw) == (n0, n0):
        return pos
    cls_pos, grid = pos[:, :1, :], pos[:, 1:, :]
    grid = grid.reshape(n0, n0, c.width).float()
    wh, ww = _cubic_weights(n0, gh).to(pos.device), _cubic_weights(n0, gw).to(pos.device)
    grid = torch.einsum("ia,ijd->ajd", wh, grid)
    grid = torch.einsum("jb,ajd->abd", ww, grid)
    return torch.cat([cls_pos, grid.reshape(1, gh * gw, c.width).to(pos.dtype)], dim=1)


# ---------------------------------------------------------------------------
# The module: containers named as timm names them; the forward is ViTEncoder's


class _Attention(nn.Module):
    def __init__(self, d: int, **kw):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d, **kw)
        self.proj = nn.Linear(d, d, **kw)


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int, **kw):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden, **kw)
        self.fc2 = nn.Linear(hidden, d, **kw)


class _LayerScale(nn.Module):
    def __init__(self, d: int, **kw):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(d, **kw))


class _Block(nn.Module):
    def __init__(self, c: ViTConfig, **kw):
        super().__init__()
        f32 = {**kw, "dtype": torch.float32}
        self.norm1 = nn.LayerNorm(c.width, eps=c.ln_eps, **f32)
        self.attn = _Attention(c.width, **kw)
        self.norm2 = nn.LayerNorm(c.width, eps=c.ln_eps, **f32)
        self.mlp = _Mlp(c.width, c.mlp_ratio * c.width, **kw)
        if c.layerscale:
            self.ls1 = _LayerScale(c.width, **f32)
            self.ls2 = _LayerScale(c.width, **f32)


class _PatchEmbed(nn.Module):
    def __init__(self, c: ViTConfig, **kw):
        super().__init__()
        self.proj = nn.Conv2d(3, c.width, c.patch_size, stride=c.patch_size, **kw)


def _trunc_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal(0, std) truncated at two standard deviations, by inverting the
    CDF on uniforms from ``generator``."""
    lo, hi = (0.5 * (1.0 + math.erf(v / 2.0**0.5)) for v in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator) * (hi - lo) + lo
    return (torch.erfinv(2.0 * u - 1.0) * (2.0**0.5 * std)).clamp_(-2.0 * std, 2.0 * std)


class ViTEncoder(nn.Module):
    """The UNI-style ViT tile encoder. Built on the CPU; move it with
    ``.to(device)``. Forward only. ``init=False`` leaves the parameters unset,
    for a state_dict to fill."""

    def __init__(self, config: ViTConfig = ViTConfig(), generator: torch.Generator | None = None, *,
                 init: bool = True):
        super().__init__()
        c = config
        _check_attention(c)
        _resolve_gelu(c)
        self.config = c
        # built on the meta device so that the layers' own init draws nothing
        # from the global generator; reset_parameters fills them
        kw = {"device": "meta", "dtype": getattr(torch, c.param_dtype)}
        n_grid = c.pretrain_img_size // c.patch_size
        self.patch_embed = _PatchEmbed(c, **kw)
        self.cls_token = nn.Parameter(torch.empty(1, 1, c.width, **kw))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + n_grid * n_grid, c.width, **kw))
        self.blocks = nn.ModuleList(_Block(c, **kw) for _ in range(c.depth))
        self.norm = nn.LayerNorm(c.width, eps=c.ln_eps, device="meta", dtype=torch.float32)
        self.to_empty(device="cpu")
        self.requires_grad_(False)
        # preprocessing constants; not part of the state_dict, which stays timm's
        self.register_buffer("pixel_mean", torch.tensor(IMAGENET_MEAN, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(IMAGENET_STD, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_max", torch.tensor(255.0), persistent=False)
        self._cast: dict[torch.dtype, tuple] = {}  # compute dtype -> (weights' key, cast weights)
        if init:
            self.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Truncated-normal(0.02) weights like timm, zero biases and cls
        token, LayerScale gamma 1e-5 like DINOv2."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                p.fill_(1e-5)
            elif name == "pos_embed" or (leaf == "weight" and p.dim() > 1):
                p.copy_(_trunc_normal(p.shape, 0.02, generator))
            elif leaf == "weight":  # LayerNorm scale
                p.fill_(1.0)
            else:  # biases, cls_token
                p.zero_()

    # -- weights in the compute dtype, cast once ------------------------------

    def _weights(self, dt: torch.dtype) -> dict[str, Any]:
        """The weights as the forward uses them: matrices and biases of the
        products, the LayerScale gammas, cls token and pos_embed in the
        compute dtype (LayerNorm stays f32), cast once per compute dtype and
        again only when a parameter moves or changes in place."""
        key = tuple((p.device, p.data_ptr(), p._version) for p in self.parameters())
        hit = self._cast.get(dt)
        if hit is None or hit[0] != key:
            def lin(m):
                return m.weight.detach().to(dt), m.bias.detach().to(dt)

            blocks = []
            for blk in self.blocks:
                w = {"qkv": lin(blk.attn.qkv), "proj": lin(blk.attn.proj), "fc1": lin(blk.mlp.fc1), "fc2": lin(blk.mlp.fc2)}
                if self.config.layerscale:
                    w["ls1"], w["ls2"] = blk.ls1.gamma.detach().to(dt), blk.ls2.gamma.detach().to(dt)
                blocks.append(w)
            hit = (key, {"patch": lin(self.patch_embed.proj), "cls": self.cls_token.detach().to(dt),
                         "pos": {}, "blocks": blocks})
            self._cast[dt] = hit
        return hit[1]

    def _pos(self, w: dict[str, Any], dt: torch.dtype, gh: int, gw: int) -> torch.Tensor:
        """pos_embed resized to the grid in the compute dtype, kept with the
        cast weights."""
        if (gh, gw) not in w["pos"]:
            w["pos"][(gh, gw)] = resize_pos_embed(self.pos_embed.detach(), self.config, gh, gw).to(dt)
        return w["pos"][(gh, gw)]

    # -- forward --------------------------------------------------------------

    @torch.no_grad()
    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized float tiles [B, H, W, 3] -> cls features [B, width] f32."""
        c = self.config
        dt = getattr(torch, c.compute_dtype)
        w = self._weights(dt)
        tokens = self._embed_tokens(x, w, dt)
        attn = functools.partial(fused_mha, heads=c.heads, head_dim=c.head_dim)
        tanh_gelu = _resolve_gelu(c)
        for blk, bw in zip(self.blocks, w["blocks"]):
            tokens = _block(tokens, bw, (blk.norm1, blk.norm2), c, dt, attn, tanh_gelu)
        return _layer_norm(tokens[:, 0, :], self.norm, c.ln_eps)

    def _embed_tokens(self, x: torch.Tensor, w: dict[str, Any], dt: torch.dtype) -> torch.Tensor:
        """Normalized float tiles [B, H, W, 3] -> tokens [B, 1 + gh*gw, width]
        in ``dt``: the patch embedding, the cls token first, the position
        embedding (resized to the grid) added."""
        c = self.config
        b, hh, ww, _ = x.shape
        if hh % c.patch_size or ww % c.patch_size:
            raise ValueError(f"tile {hh}x{ww} not divisible by patch size {c.patch_size}")
        gh, gw = hh // c.patch_size, ww // c.patch_size
        pw, pb = w["patch"]
        # NHWC -> NCHW as a view: the convolution reads it channels-last; in f32 without TF32
        with exact_f32_convs(dt):
            tokens = F.conv2d(x.to(dt).permute(0, 3, 1, 2), pw, stride=c.patch_size) + pb[None, :, None, None]
        tokens = tokens.flatten(2).transpose(1, 2)  # [B, gh*gw, width]
        tokens = torch.cat([w["cls"].expand(b, 1, c.width), tokens], dim=1)
        return tokens + self._pos(w, dt, gh, gw)

    forward = apply

    def preprocess(self, tiles: torch.Tensor, mean=None, std=None) -> torch.Tensor:
        """uint8 (or float) tiles [B, H, W, 3] in 0..255 -> ImageNet-normalized
        f32. Divides by tensors: a division by a Python scalar becomes a
        multiplication by its reciprocal on CUDA, which rounds otherwise."""
        mean = self.pixel_mean if mean is None else torch.as_tensor(mean, dtype=torch.float32, device=tiles.device)
        std = self.pixel_std if std is None else torch.as_tensor(std, dtype=torch.float32, device=tiles.device)
        return (tiles.to(torch.float32) / self.pixel_max - mean) / std

    def embed(self, tiles: torch.Tensor) -> torch.Tensor:
        return self.apply(self.preprocess(tiles))

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


# ---------------------------------------------------------------------------
# timm-layout weight ingestion (UNI ships as a timm ViT state_dict)


def _f32(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(v, np.float32))


def params_from_timm_state_dict(
    sd: Mapping[str, Any], config: ViTConfig | None = None, heads: int | None = None
) -> tuple[dict[str, torch.Tensor], ViTConfig]:
    """timm ViT state_dict -> (the encoder's state_dict in f32, config).
    Infers depth, width, patch size, pretrain grid and LayerScale from the
    keys when ``config`` is None; the head count is NOT stored in a
    state_dict, so it defaults to head_dim=64 (correct for ViT-S/B/L/H and
    UNI) and must be passed explicitly for other geometries. Ignores
    classifier heads (num_classes=0 for UNI anyway)."""
    sd = {k.removeprefix("module.").removeprefix("model."): v for k, v in sd.items()}
    width = int(sd["cls_token"].shape[-1])
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    layerscale = "blocks.0.ls1.gamma" in sd or "blocks.0.gamma_1" in sd
    patch = int(sd["patch_embed.proj.weight"].shape[-1])  # [D, 3, P, P]
    n_pos = int(sd["pos_embed"].shape[1]) - 1
    grid = int(round(float(np.sqrt(n_pos))))
    if config is None:
        if heads is None:
            if width % 64 != 0:
                raise ValueError(
                    f"cannot infer head count for width {width} (not a multiple of 64); "
                    "pass heads= explicitly"
                )
            heads = width // 64
        config = ViTConfig(
            patch_size=patch,
            width=width,
            depth=depth,
            heads=heads,
            pretrain_img_size=grid * patch,
            layerscale=layerscale,
        )
    names = ["patch_embed.proj", "norm"]
    for i in range(depth):
        names += [f"blocks.{i}.{m}" for m in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2")]
    out = {"cls_token": _f32(sd["cls_token"]), "pos_embed": _f32(sd["pos_embed"])}
    for name in names:
        out[f"{name}.weight"] = _f32(sd[f"{name}.weight"])
        out[f"{name}.bias"] = _f32(sd[f"{name}.bias"])
    for i in range(depth):
        p = f"blocks.{i}"
        if f"{p}.ls1.gamma" in sd:
            out[f"{p}.ls1.gamma"], out[f"{p}.ls2.gamma"] = _f32(sd[f"{p}.ls1.gamma"]), _f32(sd[f"{p}.ls2.gamma"])
        elif f"{p}.gamma_1" in sd:  # older DINO naming
            out[f"{p}.ls1.gamma"], out[f"{p}.ls2.gamma"] = _f32(sd[f"{p}.gamma_1"]), _f32(sd[f"{p}.gamma_2"])
    return out, config


def load_timm_weights(
    path: str | os.PathLike, config: ViTConfig | None = None, heads: int | None = None
) -> tuple[dict[str, torch.Tensor], ViTConfig]:
    """Load a timm ViT checkpoint file (e.g. UNI's ``pytorch_model.bin``):
    (state_dict for :class:`ViTEncoder`, config)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: expected a state_dict")
    for key in ("state_dict", "model", "teacher"):
        if key in sd and isinstance(sd[key], dict):
            sd = sd[key]
            break
    return params_from_timm_state_dict(sd, config, heads=heads)


def encoder_from_state_dict(sd: Mapping[str, torch.Tensor], config: ViTConfig) -> ViTEncoder:
    """A :class:`ViTEncoder` of ``config`` holding ``sd`` (strict)."""
    enc = ViTEncoder(config, init=False)
    enc.load_state_dict(dict(sd))
    return enc
