"""Truncated ResNet-50 patch encoder.

PyTorch counterpart of :mod:`toad_tpu.models.resnet_encoder`: the stem (7x7/2
conv + BN + ReLU + 3x3/2 max-pool), bottleneck stages layer1 (3 blocks),
layer2 (4, /2) and layer3 (6, /2), **no layer4 and no fc**, and a global
average pool to 1024-d per tile (reference ``models/resnet_custom.py:62-70,
96-109``).

- The module's parameters are named as torchvision names them (``conv1``,
  ``bn1``, ``layer1.0.conv1``, ``layer1.0.downsample.0`` ...), weights OIHW,
  so the truncated part of a torchvision ``resnet50`` state_dict loads into
  it; :func:`params_from_torchvision_state_dict` picks that part out.
- Inference BatchNorm can be folded into the preceding conv
  (:meth:`ResNetEncoder.fold_bn`, in place and idempotent): each BN goes and
  its conv gains a bias, named ``{conv}.bias``.
- Activations are NCHW tensors in ``channels_last`` memory, i.e. physically
  NHWC, the JAX encoder's layout; a stage's input is what the fused stage
  kernel (:mod:`toad_tpu_torch.ops.fused_stage`) reads.
- Casts follow the JAX encoder: every conv runs in the compute dtype (bf16
  by default) and gives that dtype, its bias (or the BN's scale and shift,
  computed in f32) is added in the compute dtype, the pool's mean is taken in
  f32. The weights are cast once per compute dtype and again only when one
  changes. The convolutions themselves go to cuDNN on the card; with f32
  compute they run in TF32 unless ``torch.backends.cudnn.allow_tf32`` is
  False (``featurize --no_bf16`` sets it False).
"""

from __future__ import annotations

import os
from typing import Any, Iterator, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from toad_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD, EncoderConfig


class _Conv(nn.Module):
    """A conv's weight [Cout, Cin, kh, kw] and, once BN is folded, its bias."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(cout), requires_grad=False) if bias else None


class _BN(nn.Module):
    """Inference BatchNorm: scale (``weight``), shift (``bias``) and the
    running statistics, torchvision's names."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


class _Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, cout: int, downsample: bool, folded: bool):
        super().__init__()
        # registered in torchvision's order: conv1, bn1, conv2, bn2, conv3, bn3, downsample
        self.conv1 = _Conv(cin, width, 1, folded)
        self.bn1 = None if folded else _BN(width)
        self.conv2 = _Conv(width, width, 3, folded)
        self.bn2 = None if folded else _BN(width)
        self.conv3 = _Conv(width, cout, 1, folded)
        self.bn3 = None if folded else _BN(cout)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(_Conv(cin, cout, 1, folded), *(() if folded else (_BN(cout),)))


def _fold(conv: _Conv, bn: _BN, eps: float) -> None:
    """w' = w * s, b' = beta - mean * s with s = gamma / sqrt(var + eps), in
    f32 operation by operation as the JAX package's numpy fold, each
    correctly rounded, so the folded weights are the same numbers. (PyTorch's
    vectorized f32 sqrt is not correctly rounded; the f32 root of the f64 root
    is.)"""
    s = bn.weight.float() / torch.sqrt((bn.running_var.float() + eps).double()).float()
    w = conv.weight.float() * s[:, None, None, None]
    b = bn.bias.float() - bn.running_mean.float() * s
    conv.weight = nn.Parameter(w.to(conv.weight.dtype), requires_grad=False)
    conv.bias = nn.Parameter(b, requires_grad=False)


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C]; channel order (dy, dx, c)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def stem_s2d_weights(w: torch.Tensor) -> torch.Tensor:
    """A [Cout, Cin, 7, 7] stride-2 stem kernel -> the equivalent
    [Cout, 4*Cin, 4, 4] stride-1 kernel over space-to-depth(2) input, with
    padding (2, 1). Output (i, j) of the pad-3 conv reads input rows
    u = 2i + p - 3 (p in 0..6); with u = 2a + dy the block offset t = a - i + 2
    runs over 0..3 and the tap is p = 2t + dy - 1, so the 7 taps scatter by
    parity into 4x4 (the p = -1 slot is zero). Exact."""
    cout, cin, kh, kw = w.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"s2d stem expects a 7x7 kernel, got {(kh, kw)}")
    hwio = F.pad(w.permute(2, 3, 1, 0), (0, 0, 0, 0, 1, 0, 1, 0))  # [8, 8, Cin, Cout]: tap index p+1 = 2t+dy
    wr = hwio.reshape(4, 2, 4, 2, cin, cout).permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * cin, cout)
    return wr.permute(3, 2, 0, 1).contiguous()


def _kaiming(shape, generator: torch.Generator) -> torch.Tensor:
    cout, _, kh, kw = shape
    return torch.randn(shape, generator=generator) * float(np.sqrt(2.0 / (kh * kw * cout)))


class ResNetEncoder(nn.Module):
    """The truncated ResNet-50 tile encoder. Built on the CPU, unfolded
    (``folded=True`` builds the folded form, for a folded state_dict); move it
    with ``.to(device)``. Forward only. ``init=False`` leaves the weights
    unset, for a state_dict to fill."""

    def __init__(self, config: EncoderConfig = EncoderConfig(), generator: torch.Generator | None = None, *,
                 folded: bool = False, init: bool = True):
        super().__init__()
        c = self.config = config
        self.conv1 = _Conv(3, c.stem_width, 7, folded)
        self.bn1 = None if folded else _BN(c.stem_width)
        cin = c.stem_width
        for s, (n_blocks, width) in enumerate(zip(c.blocks, c.stage_widths)):
            cout = width * c.expansion
            blocks = []
            for b in range(n_blocks):
                blocks.append(_Bottleneck(cin, width, cout, b == 0 and (cin != cout or s > 0), folded))
                cin = cout
            self.add_module(f"layer{s + 1}", nn.Sequential(*blocks))
        self.to(getattr(torch, c.param_dtype))
        self.requires_grad_(False)
        # preprocessing constants; not part of the state_dict, which stays torchvision's
        self.register_buffer("pixel_mean", torch.tensor(IMAGENET_MEAN, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(IMAGENET_STD, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_max", torch.tensor(255.0), persistent=False)
        self._cast: dict[torch.dtype, tuple] = {}  # compute dtype -> (weights' key, cast weights)
        if init:
            self.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Kaiming fan-out normal conv weights, BN gamma 1 / beta 0 / mean 0 /
        var 1, zero conv biases (reference ``resnet_custom.py:72-77``)."""
        for m in self.modules():
            if isinstance(m, _Conv):
                m.weight.copy_(_kaiming(m.weight.shape, generator))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, _BN):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)

    def stages(self) -> Iterator[tuple[nn.Sequential, int]]:
        """(stage, stride of its first block) for layer1..layerN."""
        for s in range(len(self.config.blocks)):
            yield getattr(self, f"layer{s + 1}"), 1 if s == 0 else 2

    # -- BN folding -------------------------------------------------------------

    @property
    def folded(self) -> bool:
        return self.bn1 is None

    @torch.no_grad()
    def fold_bn(self) -> "ResNetEncoder":
        """Fold every inference BN into its conv, in place; a folded encoder
        is left as it is. Returns self."""
        eps = self.config.bn_eps
        if self.bn1 is not None:
            _fold(self.conv1, self.bn1, eps)
            self.bn1 = None
        for stage, _ in self.stages():
            for blk in stage:
                if blk.bn1 is None:
                    continue
                for i in (1, 2, 3):
                    _fold(getattr(blk, f"conv{i}"), getattr(blk, f"bn{i}"), eps)
                    setattr(blk, f"bn{i}", None)
                if blk.downsample is not None:
                    _fold(blk.downsample[0], blk.downsample[1], eps)
                    del blk.downsample[1]
        self._cast.clear()
        return self

    # -- weights in the compute dtype, cast once ------------------------------

    def _weights(self, dt: torch.dtype) -> dict[Any, Any]:
        """The weights as the forward uses them, in the compute dtype: each
        conv's weight (channels_last; the stem also rewritten for s2d) under
        ``id(conv)``, its bias under ``("bias", id(conv))``, each BN's
        (scale, shift) under ``("bn", id(bn))``. Cast once per compute dtype
        and again when a parameter moves or changes in place."""
        key = tuple((p.device, p.data_ptr(), p._version) for p in self.parameters())
        hit = self._cast.get(dt)
        if hit is None or hit[0] != key:
            cast = {}
            for m in self.modules():
                if isinstance(m, _Conv):
                    w = m.weight.detach()
                    if m is self.conv1 and self.config.stem_s2d:
                        cast[("s2d", id(m))] = stem_s2d_weights(w).to(dt).contiguous(memory_format=torch.channels_last)
                    cast[id(m)] = w.to(dt).contiguous(memory_format=torch.channels_last)
                    if m.bias is not None:
                        cast[("bias", id(m))] = m.bias.detach().to(dt)[:, None, None]
                elif isinstance(m, _BN):
                    scale = m.weight.detach() * torch.rsqrt(m.running_var + self.config.bn_eps)
                    shift = m.bias.detach() - m.running_mean * scale
                    cast[("bn", id(m))] = (scale.to(dt)[:, None, None], shift.to(dt)[:, None, None])
            hit = (key, cast)
            self._cast[dt] = hit
        return hit[1]

    # -- forward ----------------------------------------------------------------

    def _conv(self, w: dict, x: torch.Tensor, conv: _Conv, bn: _BN | None, relu: bool,
              stride: int = 1, padding: int = 0) -> torch.Tensor:
        """conv in the compute dtype, then + bias (folded) or BN, then ReLU."""
        out = F.conv2d(x, w[id(conv)], stride=stride, padding=padding)
        out = self._affine(w, out, conv, bn)
        return out.relu_() if relu else out

    @staticmethod
    def _affine(w: dict, out: torch.Tensor, conv: _Conv, bn: _BN | None) -> torch.Tensor:
        if bn is not None:
            scale, shift = w[("bn", id(bn))]
            return out.mul_(scale).add_(shift)
        return out.add_(w[("bias", id(conv))])

    def _stem(self, w: dict, x: torch.Tensor) -> torch.Tensor:
        """Normalized tiles [B, H, W, 3] in the compute dtype -> the stem's
        output, NCHW in channels_last memory."""
        if self.config.stem_s2d and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
            x2 = space_to_depth2(x).permute(0, 3, 1, 2)  # channels_last view
            out = F.conv2d(F.pad(x2, (2, 1, 2, 1)), w[("s2d", id(self.conv1))])
        else:
            out = F.conv2d(x.permute(0, 3, 1, 2), w[id(self.conv1)], stride=2, padding=3)
        out = self._affine(w, out.contiguous(memory_format=torch.channels_last), self.conv1, self.bn1).relu_()
        return F.max_pool2d(out, 3, 2, 1)  # pads with -inf, as the JAX reduce_window

    def _bottleneck(self, w: dict, x: torch.Tensor, blk: _Bottleneck, stride: int) -> torch.Tensor:
        """conv1x1-BN-relu -> conv3x3(stride)-BN-relu -> conv1x1-BN + skip,
        relu (reference Bottleneck_Baseline, ``resnet_custom.py:19-49``)."""
        out = self._conv(w, x, blk.conv1, blk.bn1, True)
        out = self._conv(w, out, blk.conv2, blk.bn2, True, stride=stride, padding=1)
        out = self._conv(w, out, blk.conv3, blk.bn3, False)
        if blk.downsample is not None:
            bn = blk.downsample[1] if len(blk.downsample) > 1 else None
            sc = self._conv(w, x, blk.downsample[0], bn, False, stride=stride)
        else:
            sc = x
        return out.add_(sc).relu_()

    @torch.no_grad()
    def run_stage(self, stage: nn.Sequential, x: torch.Tensor, first_stride: int) -> torch.Tensor:
        """One stage's blocks through cuDNN: x NCHW (channels_last memory) in
        the compute dtype."""
        w = self._weights(getattr(torch, self.config.compute_dtype))
        for b, blk in enumerate(stage):
            x = self._bottleneck(w, x, blk, first_stride if b == 0 else 1)
        return x

    @torch.no_grad()
    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized float tiles [B, H, W, 3] -> features [B, out_dim] f32,
        through the unfolded or the folded weights, whichever the module holds."""
        dt = getattr(torch, self.config.compute_dtype)
        x = self._stem(self._weights(dt), x.to(dt))
        for stage, stride in self.stages():
            x = self.run_stage(stage, x, stride)
        return x.float().mean(dim=(2, 3))  # global average pool (reference AdaptiveAvgPool2d(1))

    forward = apply

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`apply` through BN-folded weights; raises on an unfolded
        encoder (call :meth:`fold_bn` first)."""
        if not self.folded:
            raise ValueError("apply_folded needs BN-folded weights: call fold_bn() first")
        return self.apply(x)

    def preprocess(self, tiles: torch.Tensor) -> torch.Tensor:
        """uint8 RGB tiles [B, H, W, 3] -> ImageNet-normalized f32. Divides by
        tensors: a division by a Python scalar becomes a multiplication by
        its reciprocal on CUDA, which rounds otherwise."""
        return (tiles.to(torch.float32) / self.pixel_max - self.pixel_mean) / self.pixel_std

    def embed(self, tiles: torch.Tensor) -> torch.Tensor:
        """uint8 tiles -> [B, out_dim] features (normalize + forward)."""
        return self.apply(self.preprocess(tiles))

    def param_count(self) -> int:
        """Weights of the convs and BNs (running statistics included, as the
        JAX params pytree counts them)."""
        return sum(p.numel() for p in self.parameters()) + sum(
            b.numel() for name, b in self.named_buffers() if name.endswith(("running_mean", "running_var")))


# ---------------------------------------------------------------------------
# torchvision weight ingestion


def _f32(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(v, np.float32))


def state_dict_keys(config: EncoderConfig = EncoderConfig(), folded: bool = False) -> list[str]:
    """The keys of the encoder's state_dict, unfolded or folded."""
    return list(ResNetEncoder(config, folded=folded, init=False).state_dict())


def params_from_torchvision_state_dict(sd: Mapping[str, Any], config: EncoderConfig = EncoderConfig()
                                       ) -> dict[str, torch.Tensor]:
    """torchvision ``resnet50`` state_dict -> the encoder's (unfolded)
    state_dict, f32. ``module.`` prefixes are stripped; ``layer4.*``,
    ``fc.*``, ``num_batches_tracked`` and any other keys are never read, the
    reference's ``strict=False`` truncation (``resnet_custom.py:121-124``)."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    return {k: _f32(sd[k]) for k in state_dict_keys(config)}


def load_torchvision_weights(path: str | os.PathLike, config: EncoderConfig = EncoderConfig()
                             ) -> dict[str, torch.Tensor]:
    """Load a torchvision ``resnet50-*.pth`` file (a state_dict, or a dict
    holding one under ``state_dict``) -> the encoder's state_dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: expected a state_dict")
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return params_from_torchvision_state_dict(sd, config)


def encoder_from_state_dict(sd: Mapping[str, torch.Tensor], config: EncoderConfig = EncoderConfig()
                            ) -> ResNetEncoder:
    """A :class:`ResNetEncoder` of ``config`` holding ``sd`` (strict), folded
    if ``sd`` is (no ``bn1.*`` keys)."""
    enc = ResNetEncoder(config, folded="bn1.weight" not in sd, init=False)
    enc.load_state_dict(dict(sd))
    return enc
