"""The patch encoders run their float32 convolutions without TF32, from inside
the encoder, and put cuDNN's flag back as they found it.

On the card ``torch.backends.cudnn.allow_tf32`` (PyTorch's default, True)
runs a float32 ``F.conv2d`` in TF32, where the JAX reference computes in
float32. On the CPU the flag changes no number, so these tests record its
value at every ``F.conv2d`` call of a forward at a small width.
"""

import argparse

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from toad_tpu_torch.cli import featurize as featurize_cli
from toad_tpu_torch.config import EncoderConfig
from toad_tpu_torch.models import exact_f32_convs
from toad_tpu_torch.models.resnet_encoder import ResNetEncoder
from toad_tpu_torch.models.vit_encoder import ViTConfig, ViTEncoder

HW = 32  # tile side: four 8-px ViT patches a side; three stride-2 steps of the ResNet


def _vit(dtype: str):
    cfg = ViTConfig(patch_size=8, width=64, depth=1, heads=1, pretrain_img_size=HW, compute_dtype=dtype)
    return ViTEncoder(cfg, torch.Generator().manual_seed(0)).eval()


def _resnet(dtype: str):
    cfg = EncoderConfig(stem_width=8, blocks=(1, 1, 1), compute_dtype=dtype)
    return ResNetEncoder(cfg, torch.Generator().manual_seed(0)).eval()


@pytest.fixture
def conv_flags(monkeypatch):
    """The value of cuDNN's TF32 flag at each F.conv2d call; the flag is put
    back after the test whatever it did."""
    seen = []
    real = F.conv2d

    def recording(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*args, **kwargs)

    monkeypatch.setattr(F, "conv2d", recording)
    found = torch.backends.cudnn.allow_tf32
    yield seen
    torch.backends.cudnn.allow_tf32 = found


@pytest.mark.parametrize("flag", [True, False], ids=["flag_true", "flag_false"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("make", [_vit, _resnet], ids=["vit", "resnet"])
def test_encoder_convs_see_no_tf32_in_f32(make, dtype, flag, conv_flags):
    """f32: every convolution sees the flag False; bf16: as the caller set it;
    either way the flag is the caller's again after the forward."""
    enc = make(dtype)
    tiles = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, HW, HW, 3), dtype=np.uint8))
    torch.backends.cudnn.allow_tf32 = flag
    feats = enc.embed(tiles)
    assert feats.shape == (2, enc.config.out_dim) and torch.isfinite(feats).all()
    assert conv_flags, "the forward ran no convolution"
    assert conv_flags == [False if dtype == "float32" else flag] * len(conv_flags)
    assert torch.backends.cudnn.allow_tf32 is flag


@pytest.mark.parametrize("flag", [True, False], ids=["flag_true", "flag_false"])
def test_exact_f32_convs_puts_the_flag_back_on_error(flag, conv_flags):
    torch.backends.cudnn.allow_tf32 = flag
    with pytest.raises(RuntimeError, match="inside"):
        with exact_f32_convs(torch.float32):
            assert torch.backends.cudnn.allow_tf32 is False
            raise RuntimeError("inside")
    assert torch.backends.cudnn.allow_tf32 is flag


@pytest.mark.parametrize("no_bf16", [True, False], ids=["f32", "bf16"])
def test_featurize_cli_sets_no_process_wide_tf32(no_bf16, conv_flags):
    """``featurize --no_bf16`` builds its ResNet without touching the global
    flag: the encoder guards its own convolutions."""
    torch.backends.cudnn.allow_tf32 = True
    enc = featurize_cli._resnet(argparse.Namespace(no_bf16=no_bf16, no_fold_bn=False, weights=None))
    assert enc.config.compute_dtype == ("float32" if no_bf16 else "bfloat16")
    assert torch.backends.cudnn.allow_tf32 is True
