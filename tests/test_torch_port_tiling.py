"""The port's tiling, ``tile`` CLI and default-encoder ``featurize`` CLI
against the JAX package.

Tiling is numpy on both sides, so its arrays must be byte-equal. The
``featurize`` check runs the truncated ResNet-50 at its full width (the CLI
has no width flag) on a few 32-px tiles, in f32 on the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from toad_tpu.cli import featurize as jax_featurize_cli
from toad_tpu.data import bags as jax_bags
from toad_tpu.pipeline import tiling as jax_tiling
from toad_tpu_torch.cli import tile as port_tile_cli
from toad_tpu_torch.config import EncoderConfig
from toad_tpu_torch.data.bags import load_bag
from toad_tpu_torch.models.resnet_encoder import ResNetEncoder
from toad_tpu_torch.pipeline import tiling as port_tiling

REPO = Path(__file__).resolve().parent.parent
TOL_F32 = 1e-4  # f32 on both sides, relative to the largest |feature|: summation order through 13 blocks


def _slide(seed: int, h: int = 300, w: int = 420) -> np.ndarray:
    """Seeded RGB noise (high saturation: tissue) with a near-white band
    (background, dropped by the filter) and a black corner (max 0)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[:, : w // 3] = rng.integers(236, 256, (h, w // 3, 1), dtype=np.uint8)
    img[:40, -40:] = 0
    return img


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    Image.fromarray(_slide(0)).save(root / "s1.png")
    Image.fromarray(_slide(1, 200, 260)).save(root / "s2.png")
    (root / "notes.txt").write_text("not an image")
    return root


def test_saturation_is_byte_equal():
    rng = np.random.default_rng(2)
    tiles = rng.integers(0, 256, (37, 16, 16, 3), dtype=np.uint8)
    tiles[3] = 0  # black: max 0
    tiles[4] = 200  # grey: no saturation
    for chunk in (1024, 5):
        got, want = port_tiling.saturation(tiles, chunk=chunk), jax_tiling.saturation(tiles, chunk=chunk)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("patch_size,stride,threshold", [(64, None, 0.05), (64, 32, 0.05), (50, None, None),
                                                         (512, None, 0.05)])
def test_tile_image_is_byte_equal(patch_size, stride, threshold):
    img = _slide(0)
    got, want = (mod.tile_image(img, patch_size=patch_size, stride=stride, tissue_threshold=threshold)
                 for mod in (port_tiling, jax_tiling))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
    if patch_size == 512:
        assert got[0].shape == (0, 512, 512, 3) and got[1].shape == (0, 2)  # larger than the image
    with pytest.raises(ValueError, match=r"expected \[H, W, 3\]"):
        port_tiling.tile_image(img[..., 0])


@pytest.mark.parametrize("ext", [".h5", ".npz"])
def test_image_to_patch_file_matches_jax(image_dir, tmp_path, ext):
    want = jax_tiling.image_to_patch_file(image_dir / "s1.png", tmp_path / "jax.h5", patch_size=64)
    got = port_tiling.image_to_patch_file(image_dir / "s1.png", tmp_path / f"port{ext}", patch_size=64)
    assert {**got, "out": None} == {**want, "out": None}
    assert 0 < got["n_patches"] < got["n_grid"]
    with h5py.File(tmp_path / "jax.h5") as f:
        ref = (f["imgs"][:], f["coords"][:])
        ref_chunks = f["imgs"].chunks
    if ext == ".h5":
        with h5py.File(tmp_path / "port.h5") as f:
            mine = (f["imgs"][:], f["coords"][:])
            assert f["imgs"].chunks == ref_chunks == (got["n_patches"], 64, 64, 3)
    else:
        with np.load(tmp_path / "port.npz") as f:
            mine = (f["imgs"], f["coords"])
    for g, w in zip(mine, ref):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    with pytest.raises(ValueError, match="expected .h5 or .npz"):
        port_tiling.write_patch_file(tmp_path / "x.zarr", *ref)


def test_empty_patch_h5_is_written_contiguous(tmp_path):
    port_tiling.write_patch_h5(tmp_path / "empty.h5", np.zeros((0, 8, 8, 3), np.uint8), np.zeros((0, 2), np.int64))
    with h5py.File(tmp_path / "empty.h5") as f:
        assert f["imgs"].shape == (0, 8, 8, 3) and f["imgs"].chunks is None


def _run(module: str, *args, cwd):
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "HOME": str(cwd), "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


def test_tile_cli_matches_the_jax_cli(image_dir, tmp_path):
    args = ("tile", "--image_dir", str(image_dir), "--patch_size", "64", "--stride", "48")
    port = _run("toad_tpu_torch", *args, "--patch_dir", "port", cwd=tmp_path)
    ref = _run("toad_tpu", *args, "--patch_dir", "jax", cwd=tmp_path)
    assert port.returncode == 0 and ref.returncode == 0, port.stderr + ref.stderr
    assert port.stdout.strip().splitlines()[-1] == ref.stdout.strip().splitlines()[-1]
    said = json.loads(port.stdout.strip().splitlines()[-1])
    assert said["slides"] == 2 and said["patches"] > 0
    for name in ("s1", "s2"):
        with h5py.File(tmp_path / "port" / f"{name}.h5") as a, h5py.File(tmp_path / "jax" / f"{name}.h5") as b:
            for key in ("imgs", "coords"):
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key][:], b[key][:])
    # --skip_done skips what exists
    again = _run("toad_tpu_torch", *args, "--patch_dir", "port", "--skip_done", cwd=tmp_path)
    assert "s1: exists, skipped" in again.stdout and json.loads(again.stdout.strip().splitlines()[-1])["patches"] == 0


def test_tile_cli_writes_npz_without_h5py(image_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "h5py", None)  # `import h5py` raises ImportError
    port_tile_cli.main(["--image_dir", str(image_dir), "--patch_dir", str(tmp_path / "p"), "--patch_size", "64"])
    out, err = capsys.readouterr()
    assert "h5py is not installed: writing .npz patch files" in err
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == ["s1.npz", "s2.npz"]
    imgs, coords = jax_tiling.tile_image(_slide(0), patch_size=64)
    with np.load(tmp_path / "p" / "s1.npz") as f:
        assert np.array_equal(f["imgs"], imgs) and np.array_equal(f["coords"], coords)
    assert json.loads(out.strip().splitlines()[-1])["slides"] == 2
    with pytest.raises(ImportError, match="needs h5py"):
        port_tiling.write_patch_h5(tmp_path / "x.h5", imgs, coords)


def test_tile_cli_without_pillow_names_it(image_dir, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs Pillow"):
        port_tile_cli.main(["--image_dir", str(image_dir), "--patch_dir", str(tmp_path / "p")])
    with pytest.raises(FileNotFoundError, match="no images"):
        port_tile_cli.main(["--image_dir", str(tmp_path / "p"), "--patch_dir", str(tmp_path / "q")])


@pytest.fixture(scope="module")
def resnet_weights(tmp_path_factory):
    """A full-width torchvision-layout state_dict from a seed, with BN
    statistics off their init so that folding does something."""
    g = torch.Generator().manual_seed(0)
    sd = ResNetEncoder(EncoderConfig(), g).state_dict()
    for k, v in sd.items():
        if k.endswith("running_var"):
            v.copy_(0.5 + torch.rand(v.shape, generator=g))
        elif k.endswith(("running_mean", "bn1.bias", "bn2.bias", "bn3.bias", "downsample.1.bias")):
            v.copy_(torch.randn(v.shape, generator=g) * 0.1)
    path = tmp_path_factory.mktemp("weights") / "resnet50.pth"
    torch.save({**sd, "fc.weight": torch.zeros(10, 2048), "fc.bias": torch.zeros(10)}, path)
    return path


def test_featurize_default_encoder_matches_the_jax_cli(resnet_weights, tmp_path):
    """``featurize --device cpu`` with no ``--encoder`` (ResNet-50) against
    the JAX CLI's bag from the same .h5 and weights, f32 compute."""
    rng = np.random.default_rng(3)
    tiles = rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    coords = rng.integers(0, 10_000, (6, 2)).astype(np.int64)
    (tmp_path / "patches").mkdir()
    with h5py.File(tmp_path / "patches" / "s1.h5", "w") as f:
        f.create_dataset("imgs", data=tiles)
        f.create_dataset("coords", data=coords)
    common = ["--patch_dir", str(tmp_path / "patches"), "--weights", str(resnet_weights), "--no_bf16",
              "--batch_size", "4", "--format", "npz"]
    jax_featurize_cli.main([*common, "--feat_dir", str(tmp_path / "jax")])
    want, want_coords = jax_bags.load_bag(tmp_path / "jax" / "s1.npz", with_coords=True)
    run = _run("toad_tpu_torch", "featurize", "--device", "cpu", *common, "--feat_dir", "port", cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    assert "loaded encoder weights" in run.stdout
    said = json.loads(run.stdout.strip().splitlines()[-1])
    assert {k: said[k] for k in ("slides", "patches", "batches", "attention_kernel_launches", "device")} == \
        {"slides": 1, "patches": 6, "batches": 2, "attention_kernel_launches": 0, "device": "cpu"}
    got, got_coords = load_bag(tmp_path / "port" / "s1.npz", with_coords=True)
    assert got.shape == want.shape == (6, 1024) and np.array_equal(got_coords, want_coords)
    assert np.abs(got - want).max() <= TOL_F32 * np.abs(want).max()
    # BN kept unfolded: the same features to rounding
    unfolded = _run("toad_tpu_torch", "featurize", "--device", "cpu", *common, "--no_fold_bn", "--feat_dir", "unfolded",
                    cwd=tmp_path)
    assert unfolded.returncode == 0, unfolded.stderr
    assert np.abs(load_bag(tmp_path / "unfolded" / "s1.npz") - want).max() <= TOL_F32 * np.abs(want).max()
