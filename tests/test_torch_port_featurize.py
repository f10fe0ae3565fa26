"""The port's featurization pipeline and CLI against the JAX package.

One slide of seeded uint8 tiles goes through the JAX package (from an .h5
patch file) and through the port (from the .h5 and from its .npz twin), with
the same tiny ViT weights; the bags must agree. On the CPU the port's
attention runs its plain version; the JAX side runs the Pallas kernel in
interpret mode. f32 compute throughout, so the tolerance is summation order."""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import h5py
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from toad_tpu.data import bags as jax_bags
from toad_tpu.models import vit_encoder as jax_vit
from toad_tpu.pipeline import featurize as jax_featurize
from toad_tpu_torch.data.bags import load_bag, load_bag_quantized
from toad_tpu_torch.models import vit_encoder as port_vit
from toad_tpu_torch.models.interop import vit_params_from_jax
from toad_tpu_torch.pipeline import featurize as port_featurize

REPO = Path(__file__).resolve().parent.parent
TINY = dict(patch_size=8, width=64, depth=2, heads=1, pretrain_img_size=32, compute_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)  # f32 on both sides: summation order
N_TILES, BATCH = 10, 4  # three batches, the last one padded


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_vit.ViTConfig(**TINY, attention="fused")
    params = jax.tree.map(np.asarray, jax_vit.ViTEncoder(cfg).init(jax.random.PRNGKey(0)))
    for blk in params["blocks"]:  # the init's 1e-5 would hide the blocks
        blk["ls1"], blk["ls2"] = blk["ls1"] + 0.5, blk["ls2"] + 0.5
    return params


@pytest.fixture(scope="module")
def slide(tmp_path_factory):
    """(tiles, coords, path of the .h5, path of its .npz twin)."""
    root = tmp_path_factory.mktemp("patches")
    rng = np.random.default_rng(0)
    tiles = rng.integers(0, 256, (N_TILES, 32, 32, 3), dtype=np.uint8)
    coords = rng.integers(0, 50_000, (N_TILES, 2)).astype(np.int64)
    with h5py.File(root / "s1.h5", "w") as f:
        f.create_dataset("imgs", data=tiles)
        f.create_dataset("coords", data=coords)
    (root / "twin").mkdir()
    np.savez(root / "twin" / "s1.npz", imgs=tiles, coords=coords)
    return tiles, coords, root / "s1.h5", root / "twin" / "s1.npz"


@pytest.fixture(scope="module")
def jax_bag(jax_params, slide, tmp_path_factory):
    """The JAX package's bag of the slide, from its .h5."""
    out = tmp_path_factory.mktemp("jax_feats") / "s1.npz"
    embedder = jax_featurize.TileEmbedder(jax_params, jax_vit.ViTConfig(**TINY, attention="fused"), batch_size=BATCH)
    stats = jax_featurize.featurize_patch_file(embedder, slide[2], out)
    assert stats["n_patches"] == N_TILES
    return jax_bags.load_bag(out, with_coords=True)


@pytest.fixture
def embedder(jax_params):
    enc = port_vit.encoder_from_state_dict(vit_params_from_jax(jax_params), port_vit.ViTConfig(**TINY))
    return port_featurize.TileEmbedder(enc.eval(), batch_size=BATCH)


@pytest.fixture(scope="module")
def weights_file(jax_params, tmp_path_factory):
    """The tiny weights as a timm-layout file that torch.save wrote."""
    path = tmp_path_factory.mktemp("weights") / "tiny.bin"
    torch.save({"model": vit_params_from_jax(jax_params)}, path)
    return path


# -- (e) featurize_patch_file -------------------------------------------------


@pytest.mark.parametrize("source", ["h5", "npz"])
@pytest.mark.parametrize("fmt", ["h5", "npy", "npz", "pt", "int8"])
def test_featurize_patch_file_matches_jax_bag(embedder, slide, jax_bag, tmp_path, source, fmt):
    want, want_coords = jax_bag
    src = slide[2] if source == "h5" else slide[3]
    out = tmp_path / f"s1.{'npz' if fmt == 'int8' else fmt}"
    stats = port_featurize.featurize_patch_file(embedder, src, out, int8=fmt == "int8")
    assert stats["n_patches"] == N_TILES and stats["out"] == str(out) and stats["patches_per_s"] > 0
    assert embedder.batches == 3
    got, got_coords = load_bag(out, with_coords=True)
    np.testing.assert_array_equal(got_coords, want_coords)
    assert got.shape == (N_TILES, 64) and got.dtype == np.float32
    if fmt == "int8":
        xq, scales, _ = load_bag_quantized(out)
        assert xq.dtype == np.int8
        # within half a quantization step of the JAX bag, and the JAX reader reads it too
        assert (np.abs(got - want) <= 0.5 * scales[:, None] + TOL["atol"]).all()
        np.testing.assert_array_equal(jax_bags.load_bag(out), got)
    else:
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(jax_bags.load_bag(out), want, **TOL)  # the JAX package reads the port's bag


def test_read_patch_file_keys_and_errors(tmp_path):
    tiles = np.zeros((2, 8, 8, 3), np.uint8)
    np.savez(tmp_path / "p.npz", patches=tiles)  # the older dataset name, no coords
    f, imgs, coords = port_featurize.read_patch_file(tmp_path / "p.npz")
    assert imgs.shape == (2, 8, 8, 3) and coords is None
    f.close()
    np.savez(tmp_path / "bad.npz", features=tiles)
    with pytest.raises(KeyError, match="no 'imgs'/'patches' dataset"):
        port_featurize.read_patch_file(tmp_path / "bad.npz")
    with pytest.raises(ValueError, match="unsupported patch file"):
        port_featurize.read_patch_file(tmp_path / "p.zarr")


def test_iter_tile_batches_pads_the_last_batch(slide):
    want = list(jax_featurize.iter_tile_batches(slide[0], BATCH))
    got = list(port_featurize.iter_tile_batches(slide[0], BATCH))
    assert [v for _, v in got] == [v for _, v in want] == [4, 4, 2]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not got[-1][0][2:].any()


def test_embed_all_equals_batch_calls_and_handles_no_tiles(embedder, slide):
    feats = embedder.embed_all(slide[0])
    assert feats.shape == (N_TILES, 64) and feats.dtype == np.float32
    np.testing.assert_allclose(feats[:BATCH], embedder(slide[0][:BATCH]).numpy(), rtol=1e-6, atol=1e-6)
    seen = []
    embedder.embed_all(slide[0], progress=lambda done, n: seen.append((done, n)))
    assert seen == [(4, 10), (8, 10), (10, 10)]
    assert embedder.embed_all(np.zeros((0, 32, 32, 3), np.uint8)).shape == (0, 64)


# -- the tile-directory route, and (g) its producer thread --------------------


@pytest.fixture(scope="module")
def tile_dir(slide, tmp_path_factory):
    root = tmp_path_factory.mktemp("tiles") / "s1"
    root.mkdir()
    tiles, coords = slide[0], slide[1]
    order = np.lexsort((coords[:, 1], coords[:, 0]))
    for i in order:
        Image.fromarray(tiles[i]).save(root / f"s1_{coords[i, 0]:06d}_{coords[i, 1]:06d}.png")
    return root


def test_featurize_tile_dir_matches_jax(embedder, jax_params, tile_dir, tmp_path):
    jax_embedder = jax_featurize.TileEmbedder(jax_params, jax_vit.ViTConfig(**TINY, attention="fused"), batch_size=BATCH)
    jax_featurize.featurize_tile_dir(jax_embedder, tile_dir, tmp_path / "jax.npz")
    stats = port_featurize.featurize_tile_dir(embedder, tile_dir, tmp_path / "port.npz")
    assert stats["n_patches"] == N_TILES and stats["decode_s"] >= 0
    want, want_coords = jax_bags.load_bag(tmp_path / "jax.npz", with_coords=True)
    got, got_coords = load_bag(tmp_path / "port.npz", with_coords=True)
    np.testing.assert_array_equal(got_coords, want_coords)
    np.testing.assert_allclose(got, want, **TOL)
    files = port_featurize.list_tile_files(tile_dir)
    assert files == jax_featurize.list_tile_files(tile_dir)
    np.testing.assert_array_equal(port_featurize.parse_tile_coords(files), jax_featurize.parse_tile_coords(files))
    assert port_featurize.parse_tile_coords([Path("a_1_2.png"), Path("thumb.png")]) is None
    with pytest.raises(FileNotFoundError, match="no tile images"):
        port_featurize.list_tile_files(tmp_path)


def _decode_threads():
    return [t for t in threading.enumerate() if t.name == "toad-tile-decode" and t.is_alive()]


def test_decode_generator_closed_early_leaves_no_thread(tile_dir):
    """The consumer stops after one batch while the producer sits on a full
    queue: closing the generator must end the producer (the JAX package's
    stays blocked in q.put for ever)."""
    files = port_featurize.list_tile_files(tile_dir)
    gen = port_featurize.iter_decoded_tile_batches(files, batch_size=1, prefetch=1)
    batch, valid = next(gen)
    assert batch.shape == (1, 32, 32, 3) and valid == 1
    deadline = time.monotonic() + 10
    while not _decode_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _decode_threads()  # alive, with nine tiles still to hand over
    gen.close()
    assert _decode_threads() == []


def test_decode_generator_ends_its_thread_when_the_consumer_raises(embedder, tile_dir, tmp_path):
    calls = []

    def failing_progress(done, n):
        calls.append(done)
        raise RuntimeError("consumer gave up")

    embedder.batch_size = 1
    with pytest.raises(RuntimeError, match="consumer gave up"):
        port_featurize.featurize_tile_dir(embedder, tile_dir, tmp_path / "x.npz", progress=failing_progress, prefetch=1)
    assert calls == [1] and _decode_threads() == []


def test_decode_errors_surface_in_the_consumer(tile_dir, tmp_path):
    files = port_featurize.list_tile_files(tile_dir)
    odd = tmp_path / "odd_0_0.png"
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(odd)
    with pytest.raises(ValueError, match=r"tile shape \(16, 16, 3\) != first tile's \(32, 32, 3\)"):
        list(port_featurize.iter_decoded_tile_batches(files[:2] + [odd], batch_size=4))
    assert _decode_threads() == []
    batches = list(port_featurize.iter_decoded_tile_batches(files, batch_size=4))
    assert [v for _, v in batches] == [4, 4, 2] and not batches[-1][0][2:].any()


# -- (f) the CLI --------------------------------------------------------------


def _cli(*args, cwd):
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "HOME": str(cwd)}
    return subprocess.run([sys.executable, "-m", "toad_tpu_torch", "featurize", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


def test_cli_end_to_end_on_the_cpu(slide, jax_bag, weights_file, tmp_path):
    patch_dir = slide[3].parent
    base = ("--device", "cpu", "--encoder", "vit", "--weights", str(weights_file), "--no_bf16",
            "--patch_dir", str(patch_dir), "--feat_dir", "feats", "--batch_size", str(BATCH))
    run = _cli(*base, "--format", "pt", cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    assert "loaded ViT weights" in run.stdout and "[1/1] s1: 10 patches" in run.stdout
    said = json.loads(run.stdout.strip().splitlines()[-1])
    assert said == {"slides": 1, "patches": 10, "patches_per_s": said["patches_per_s"], "shadowed_stale_bags": 0,
                    "device": "cpu", "batches": 3, "attention_kernel_launches": 0}
    got, coords = load_bag(tmp_path / "feats" / "s1.pt", with_coords=True)
    np.testing.assert_allclose(got, jax_bag[0], **TOL)
    np.testing.assert_array_equal(coords, jax_bag[1])

    # --skip_done skips a bag of the asked format and nothing runs
    again = _cli(*base, "--format", "pt", "--skip_done", cwd=tmp_path)
    assert "s1: exists, skipped" in again.stdout and json.loads(again.stdout.strip().splitlines()[-1])["patches"] == 0

    # an .npz next to the .pt is shadowed at load time: the warning and its count
    shadow = _cli(*base, "--format", "npz", cwd=tmp_path)
    assert shadow.returncode == 0, shadow.stderr
    assert "WARNING: 1 stale bag(s) in other formats shadow the .npz output" in shadow.stdout
    assert json.loads(shadow.stdout.strip().splitlines()[-1])["shadowed_stale_bags"] == 1

    # int8 and f32 bags share .npz: --skip_done looks inside
    as_int8 = _cli(*base, "--format", "int8", "--skip_done", cwd=tmp_path)
    assert "exists, skipped" not in as_int8.stdout
    assert load_bag_quantized(tmp_path / "feats" / "s1.npz") is not None
    kept = _cli(*base, "--format", "int8", "--skip_done", cwd=tmp_path)
    assert "s1: exists, skipped" in kept.stdout


def test_cli_bf16_is_the_default_compute(slide, jax_bag, weights_file, tmp_path):
    run = _cli("--device", "cpu", "--encoder", "vit", "--weights", str(weights_file), "--patch_dir",
               str(slide[3].parent), "--feat_dir", "feats", "--format", "npy", cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    got = load_bag(tmp_path / "feats" / "s1.npy")
    assert np.abs(got - jax_bag[0]).max() > 1e-4  # not the f32 result
    np.testing.assert_allclose(got, jax_bag[0], rtol=3e-2, atol=3e-2)  # bf16 rounding of every activation


def test_cli_tile_dir_route(tile_dir, jax_bag, weights_file, tmp_path):
    run = _cli("--device", "cpu", "--encoder", "vit", "--weights", str(weights_file), "--no_bf16", "--tile_dir",
               str(tile_dir.parent), "--feat_dir", "feats", "--format", "npz", "--batch_size", str(BATCH), cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    got, coords = load_bag(tmp_path / "feats" / "s1.npz", with_coords=True)
    order = np.lexsort((jax_bag[1][:, 1], jax_bag[1][:, 0]))  # tiles sorted by file name
    np.testing.assert_array_equal(coords, jax_bag[1][order])
    np.testing.assert_allclose(got, jax_bag[0][order], **TOL)


def test_cli_refuses_what_is_not_ported_or_not_there(slide, tmp_path):
    patch_dir = str(slide[3].parent)
    # the default encoder, the ported ResNet-50, runs (random init at full width), folded or not
    default = _cli("--device", "cpu", "--patch_dir", patch_dir, "--feat_dir", "feats", "--format", "npy", cwd=tmp_path)
    assert default.returncode == 0, default.stderr
    assert "random encoder init" in default.stdout and load_bag(tmp_path / "feats" / "s1.npy").shape == (N_TILES, 1024)
    resnet = _cli("--device", "cpu", "--encoder", "resnet50", "--no_fold_bn", "--patch_dir", patch_dir, "--feat_dir",
                  "feats_unfolded", "--format", "npy", cwd=tmp_path)
    assert resnet.returncode == 0, resnet.stderr
    np.testing.assert_allclose(load_bag(tmp_path / "feats_unfolded" / "s1.npy"), load_bag(tmp_path / "feats" / "s1.npy"),
                               rtol=0.1, atol=0.1)  # bf16: folded and unfolded round at other places
    both = _cli("--encoder", "vit", "--patch_dir", patch_dir, "--tile_dir", patch_dir, "--feat_dir", "feats", cwd=tmp_path)
    assert both.returncode != 0 and "exactly one of --patch_dir" in both.stderr
    # --data_shards is ported (multi-GPU): each tile batch of 64 cut in two over the CPU device, the bag of one device
    sharded = _cli("--device", "cpu", "--patch_dir", patch_dir, "--feat_dir", "feats_sharded", "--format", "npy",
                   "--data_shards", "2", cwd=tmp_path)
    assert sharded.returncode == 0 and "not ported" not in sharded.stderr, sharded.stderr
    np.testing.assert_array_equal(load_bag(tmp_path / "feats_sharded" / "s1.npy"), load_bag(tmp_path / "feats" / "s1.npy"))
    from toad_tpu_torch.cli import featurize as cli_featurize

    with pytest.raises(SystemExit, match="--batch_size 64 is not divisible by --data_shards 3"):
        cli_featurize.main(["--device", "cpu", "--patch_dir", patch_dir, "--feat_dir", str(tmp_path / "feats_odd"),
                            "--data_shards", "3"])
    # --compile_cache configures XLA in the JAX CLI: taken, with one note on stderr, and the same bags as without it
    cached = _cli("--device", "cpu", "--patch_dir", patch_dir, "--feat_dir", "feats_cached", "--format", "npy",
                  "--compile_cache", "d", cwd=tmp_path)
    assert cached.returncode == 0, cached.stderr
    assert cached.stderr.count("--compile_cache has no effect here") == 1 and not (tmp_path / "d").exists()
    np.testing.assert_array_equal(load_bag(tmp_path / "feats_cached" / "s1.npy"), load_bag(tmp_path / "feats" / "s1.npy"))
    # --profile is ported (the ops tooling): taken, not refused
    profiled = cli_featurize.make_parser().parse_args(["--feat_dir", "feats", "--patch_dir", patch_dir, "--profile", "d"])
    assert profiled.profile == "d" and not hasattr(cli_featurize, "_NOT_PORTED")
    if not torch.cuda.is_available():
        # the card is the default: without one, and without --device cpu, nothing runs on the CPU silently
        no_card = _cli("--encoder", "vit", "--patch_dir", patch_dir, "--feat_dir", "feats_no_card", cwd=tmp_path)
        assert no_card.returncode not in (0, 2) and "CUDA is not available" in no_card.stderr
        assert not (tmp_path / "feats_no_card").exists()


def test_cli_refuses_two_patch_files_for_one_slide(slide, weights_file, tmp_path):
    both = tmp_path / "both"
    both.mkdir()
    for src in (slide[2], slide[3]):
        (both / src.name).write_bytes(src.read_bytes())
    run = _cli("--device", "cpu", "--encoder", "vit", "--weights", str(weights_file), "--patch_dir", str(both),
               "--feat_dir", "feats", cwd=tmp_path)
    assert run.returncode != 0 and "more than one format for ['s1']" in run.stderr
