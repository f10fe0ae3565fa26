"""Heatmaps and the four slide-inference commands of the PyTorch port
against the JAX package, on the CPU.

``toad_tpu_torch.pipeline.heatmap`` is numpy and the standard library: its
functions must give the JAX module's arrays and bytes bit for bit, both with
matplotlib and Pillow present and with them hidden (the card's machine has
neither, so its heatmaps take the built-in jet ramp and the stdlib PNG
writer). The ``infer``, ``predict``, ``heatmap`` and ``export`` CLIs run
through ``main(argv)`` on the same bags and checkpoint as the JAX CLIs.

Tolerances: probabilities 1e-5 in f32 (the same forward in another summation
order; tests/test_torch_port_infer.py), 1e-4 in bf16, 0.02 with ``--int8``
(the int8 budget of tests/test_torch_port_eval.py); every other cell equal.
Raw attention 1e-4 of its largest |score|. Exported weights bit for bit.
"""

import contextlib
import io
import json
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from toad_tpu.cli import export as jax_export_cli
from toad_tpu.cli import heatmap as jax_heatmap_cli
from toad_tpu.cli import infer as jax_infer_cli
from toad_tpu.cli import predict as jax_predict_cli
from toad_tpu.config import ModelConfig as JaxModelConfig
from toad_tpu.models.toad_mil import ToadMIL as JaxToadMIL
from toad_tpu.models.torch_interop import export_torch_checkpoint
from toad_tpu.pipeline import heatmap as jax_heatmap
from toad_tpu.train.checkpoint import load_params_any as jax_load_params_any
from toad_tpu_torch.cli import export as export_cli
from toad_tpu_torch.cli import heatmap as heatmap_cli
from toad_tpu_torch.cli import infer as infer_cli
from toad_tpu_torch.cli import predict as predict_cli
from toad_tpu_torch.config import ModelConfig, OptimConfig
from toad_tpu_torch.models.interop import params_from_jax
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.pipeline import heatmap
from toad_tpu_torch.pipeline.featurize import write_bag
from toad_tpu_torch.pipeline.infer import SlideInference
from toad_tpu_torch.train.optim import make_optimizer
from toad_tpu_torch.utils import io as port_io

REPO = Path(__file__).resolve().parent.parent
D, N_CLS = 64, 18
BUCKETS = "128,256"  # the JAX CLI takes multiples of 128 only
TOL_PROB = {"float32": 1e-5, "bfloat16": 1e-4, "int8": 0.02}
NO_LIBS = ("matplotlib", "PIL")


def _hide(monkeypatch, *names):
    """Make ``import name`` raise ImportError in both packages."""
    for name in names:
        for mod in [m for m in sys.modules if m == name or m.startswith(name + ".")]:
            monkeypatch.delitem(sys.modules, mod)
        monkeypatch.setitem(sys.modules, name, None)


# -- the rendering functions ------------------------------------------------------


SCORES = {
    "random": np.random.default_rng(0).standard_normal(200).astype(np.float32),
    "ties": np.array([0.1, 5.0, 5.0, -2.0, 9.0, 5.0, 0.1]),
    "one": np.array([3.0]),
    "empty": np.zeros(0),
    "constant": np.full(9, 0.25),
}


@pytest.mark.parametrize("name", SCORES)
def test_to_percentiles_equals_jax(name):
    got, want = heatmap.to_percentiles(SCORES[name]), jax_heatmap.to_percentiles(SCORES[name])
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _grid(n, side, step=256, offset=0):
    i = np.arange(n)
    return np.stack([offset + step * (i % side), offset + step * (i // side)], axis=1).astype(np.int64)


@pytest.mark.parametrize("coords,patch,down", [(_grid(30, 6), 256, 32), (_grid(7, 3, 512), 512, 16),
                                               (np.zeros((0, 2), np.int64), 256, 32), (_grid(5, 5, 100, 33), 256, 7)])
def test_canvas_shape_equals_jax(coords, patch, down):
    assert heatmap.canvas_shape(coords, patch, down) == jax_heatmap.canvas_shape(coords, patch, down)


RENDER_CASES = {
    "percentile": dict(),
    "raw_scores": dict(percentile=False),
    "explicit_canvas": dict(canvas_wh=(1024, 1536)),  # patches past the canvas are dropped
    "coarse": dict(patch_size=512, downscale=64),
    "background": dict(background=True, alpha=0.3),
}


@pytest.mark.parametrize("libs", ["present", "hidden"])
@pytest.mark.parametrize("case", RENDER_CASES)
def test_render_heatmap_equals_jax(case, libs, monkeypatch):
    if libs == "hidden":
        _hide(monkeypatch, *NO_LIBS)
    kw = dict(RENDER_CASES[case])
    coords = _grid(40, 7)
    scores = np.random.default_rng(1).random(40).astype(np.float32)
    if kw.pop("background", False):
        h, w = heatmap.canvas_shape(coords, 256, 32)
        kw["background"] = np.random.default_rng(2).integers(0, 256, (h, w, 3), dtype=np.uint8)
    got = heatmap.render_heatmap(coords, scores, **kw)
    want = jax_heatmap.render_heatmap(coords, scores, **kw)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def _decode_png(data: bytes) -> np.ndarray:
    """An 8-bit RGB PNG without filters (what the stdlib writer emits) -> [H, W, 3]."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        assert struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0] == zlib.crc32(tag + body)
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color = hdr[:4]
    assert (depth, color) == (8, 2)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 3 * w + 1)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("libs", ["present", "hidden"])
def test_colorize_and_encode_png_equal_jax_bytes(libs, monkeypatch):
    """With matplotlib and Pillow hidden (the card's machine), the built-in jet
    ramp and the stdlib PNG writer must give the JAX module's bytes."""
    if libs == "hidden":
        _hide(monkeypatch, *NO_LIBS)
    values = np.random.default_rng(3).random((17, 23)).astype(np.float32) * 1.2 - 0.1  # some outside [0, 1]
    rgb = heatmap.colorize(values)
    assert np.array_equal(rgb, jax_heatmap.colorize(values))
    png = heatmap.encode_png(rgb)
    assert png == jax_heatmap.encode_png(rgb)
    if libs == "hidden":
        assert np.array_equal(_decode_png(png), rgb)
        with pytest.raises(ValueError, match="needs matplotlib"):
            heatmap.colorize(values, cmap="viridis")
    else:
        assert np.array_equal(heatmap.colorize(values, cmap="viridis"), jax_heatmap.colorize(values, cmap="viridis"))


@pytest.mark.parametrize("name", ["map.png", "map.jpg", "sub/map"])
def test_save_png_without_pillow_writes_the_stdlib_png(name, tmp_path, monkeypatch):
    _hide(monkeypatch, *NO_LIBS)
    img = heatmap.render_heatmap(_grid(12, 4), np.arange(12.0))
    heatmap.save_png(tmp_path / "port" / name, img)
    jax_heatmap.save_png(tmp_path / "jax" / name, img)
    data = (tmp_path / "port" / name).read_bytes()
    assert data == (tmp_path / "jax" / name).read_bytes()
    assert np.array_equal(_decode_png(data), img)


# -- the CLIs: bags, checkpoints and manifests shared by both packages ----------------------


def _jax_params(seed):
    cfg = JaxModelConfig(in_dim=D, n_classes=N_CLS)
    params = jax.tree.map(np.asarray, JaxToadMIL(cfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for lin in (*params["trunk"].values(), *params["attn"].values(), params["cls_head"], params["site_head"]):
        lin["b"] = (rng.standard_normal(lin["b"].shape) * 0.05).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Two reference-layout checkpoints (written by the JAX exporter, one in
    each key layout), a bag dir of .npy (one past the largest bucket, one
    with a coords sidecar) and one .npz with coords, and a manifest."""
    root = tmp_path_factory.mktemp("port_infer_cli")
    params = [_jax_params(s) for s in (0, 1)]
    for fold, p in enumerate(params):
        export_torch_checkpoint(root / f"s_{fold}_checkpoint.pt", p, dropout=fold == 1)
    bags = root / "bags"
    bags.mkdir()
    rng = np.random.default_rng(4)
    for i, n in enumerate((30, 64, 100, 180, 300)):
        np.save(bags / f"S{i}.npy", rng.standard_normal((n, D)).astype(np.float32))
    np.save(bags / "S1.coords.npy", _grid(64, 8))
    write_bag(bags / "S5.npz", rng.standard_normal((120, D)).astype(np.float32), _grid(120, 11))
    (root / "manifest.csv").write_text("slide_id,sex\nS0,F\nS1,1\nS2,\nS3,NaN\nS4,0.0\nS5,M\n")
    return {"root": root, "params": params, "bags": bags, "ckpt": root / "s_0_checkpoint.pt"}


def _run(main, argv):
    """(stdout, stderr) of a CLI main in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


def _read_csv(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def _is_float_col(name):
    return name.startswith("p_") or name == "site_p" or (name.startswith("top") and name.endswith("_p"))


PREDICT_FLAGS = {
    "f32": [],
    "bf16": ["--bf16"],
    "int8": ["--int8"],
    "temperature_topk_task": ["--temperature", "2.0", "--topk", "5", "--task", "dummy_mtl_concat"],
    "ensemble": ["--ensemble"],
    "no_manifest": ["--sex", "M"],
}


@pytest.mark.parametrize("case", PREDICT_FLAGS)
def test_cli_predict_matches_the_jax_cli(env, case, tmp_path, monkeypatch):
    flags = list(PREDICT_FLAGS[case])
    ckpt = env["ckpt"]
    if case == "ensemble":
        ckpt = f"{env['root'] / 's_0_checkpoint.pt'},{env['root'] / 's_1_checkpoint.pt'}"
    base = ["--ckpt", str(ckpt), "--data_dir", str(env["bags"]), "--encoding_size", str(D), "--buckets", BUCKETS]
    if case != "no_manifest":
        base += ["--csv", str(env["root"] / "manifest.csv"), "--sex", "F"]
    written = []
    real = port_io.write_rows_csv
    monkeypatch.setattr(port_io, "write_rows_csv", lambda path, rows, **kw: (written.append(rows), real(path, rows, **kw)))
    ours, theirs = tmp_path / "port.csv", tmp_path / "jax.csv"
    out, err = _run(predict_cli.main, [*base, "--out", str(ours), "--device", "cpu", *flags])
    jax_out, _ = _run(jax_predict_cli.main, [*base, "--out", str(theirs), *flags])

    a, b = _read_csv(ours), _read_csv(theirs)
    assert a[0] == b[0] and len(a) == len(b) == 7
    assert a[0][:7] == ["slide_id", "sex", "Y_hat", "prediction", "site_hat", "site", "n_patches"]
    tol = TOL_PROB["int8" if case == "int8" else "bfloat16" if case == "bf16" else "float32"]
    for row_a, row_b in zip(a[1:], b[1:]):
        for name, x, y in zip(a[0], row_a, row_b):
            if _is_float_col(name):
                assert abs(float(x) - float(y)) <= tol, (name, x, y)
            elif case != "int8" or name in ("slide_id", "sex", "n_patches"):  # int8 may flip a near tie
                assert x == y, (name, x, y)
    assert [r[0] for r in a[1:]] == ["S0", "S1", "S2", "S3", "S4", "S5"]
    assert [r[6] for r in a[1:]] == ["30", "64", "100", "180", "256", "120"]  # S4 head-truncated
    lines, jax_lines = out.splitlines(), [ln for ln in jax_out.splitlines() if not ln.startswith("temperature ")]
    assert len(lines) == len(jax_lines) and lines[-1] == f"wrote {ours} (6 slides)"
    assert ("ensemble: 2 fold checkpoints" in lines) == (case == "ensemble")
    assert "pooling kernel launches 0 (float kernel 0, 0 in scored mode; int8 kernel 0, 0 in scored mode)" in err
    assert "6 slides in" in err and "slides/s on cpu" in err
    # the file holds the bytes pandas writes for the same rows
    import pandas as pd

    assert ours.read_text() == pd.DataFrame(written[0]).to_csv(index=False)


def test_cli_predict_takes_the_jax_cli_s_pallas_flag_with_one_note(env, tmp_path):
    """--pallas configures XLA in the JAX CLI: here it is taken, with one note
    on stderr, and the predictions are the bytes written without it."""
    base = ["--ckpt", str(env["ckpt"]), "--data_dir", str(env["bags"]), "--encoding_size", str(D), "--buckets", BUCKETS,
            "--csv", str(env["root"] / "manifest.csv"), "--sex", "F", "--device", "cpu"]
    out, err = _run(predict_cli.main, [*base, "--out", str(tmp_path / "plain.csv")])
    out_p, err_p = _run(predict_cli.main, [*base, "--out", str(tmp_path / "pallas.csv"), "--pallas"])
    assert (tmp_path / "pallas.csv").read_bytes() == (tmp_path / "plain.csv").read_bytes()
    assert out_p.splitlines()[:-1] == out.splitlines()[:-1] and out_p.endswith("(6 slides)\n")
    assert err_p.count("--pallas has no effect here") == 1 and "--pallas" not in err
    assert len(err_p.splitlines()) == len(err.splitlines()) + 1


def test_cli_predict_sex_falls_back_as_pandas_reads_it(env, tmp_path):
    """Blank and NaN cells take --sex, '1.0' and '0' parse; an all-integer id
    column loses its leading zeros, as pandas reads it."""
    bags = tmp_path / "bags"
    bags.mkdir()
    for name in ("7", "12"):
        np.save(bags / f"{name}.npy", np.random.default_rng(int(name)).standard_normal((20, D)).astype(np.float32))
    (tmp_path / "m.csv").write_text("slide_id,sex\n007,1.0\n12,\n")
    base = ["--ckpt", str(env["ckpt"]), "--data_dir", str(bags), "--csv", str(tmp_path / "m.csv"),
            "--encoding_size", str(D), "--sex", "F", "--topk", "0"]
    _run(predict_cli.main, [*base, "--out", str(tmp_path / "p.csv"), "--device", "cpu"])
    _run(jax_predict_cli.main, [*base, "--out", str(tmp_path / "j.csv")])
    ours, theirs = _read_csv(tmp_path / "p.csv"), _read_csv(tmp_path / "j.csv")
    assert [r[:2] for r in ours] == [r[:2] for r in theirs] == [["slide_id", "sex"], ["7", "1"], ["12", "0"]]
    with pytest.raises(SystemExit, match="no --sex fallback"):
        _run(predict_cli.main, [*base[:-4], "--encoding_size", str(D), "--out", str(tmp_path / "x.csv"),
                                "--device", "cpu"])


@pytest.mark.parametrize("cli", [infer_cli, predict_cli], ids=["infer", "predict"])
def test_cli_needs_the_card_unless_the_cpu_is_asked_for(env, cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    argv = ["--ckpt", str(env["ckpt"]), "--encoding_size", str(D)]
    argv += (["--bag", str(env["bags"] / "S0.npy"), "--sex", "F"] if cli is infer_cli
             else ["--data_dir", str(env["bags"]), "--out", str(tmp_path / "p.csv"), "--sex", "F"])
    with pytest.raises(SystemExit, match="pass --device cpu"):
        cli.main(argv)
    assert not (tmp_path / "p.csv").exists()


INFER_CASES = {
    "npz_origin": (["--bag", "S5.npz"], "a.npz"),
    "npy_sidecar_site": (["--bag", "S1.npy", "--attention_task", "site"], "a.npz"),
    "h5_export": (["--bag", "S5.npz", "--topk", "3"], "a.h5"),
    "ensemble_int8": (["--bag", "S5.npz", "--ensemble", "--int8"], "a.npz"),
    "truncated_no_coords": (["--bag", "S4.npy"], "a.npz"),
}


@pytest.mark.parametrize("case", INFER_CASES)
def test_cli_infer_matches_the_jax_cli(env, case, tmp_path):
    flags, att_name = INFER_CASES[case]
    flags = [str(env["bags"] / f) if f.startswith("S") else f for f in flags]
    if att_name.endswith(".h5"):
        pytest.importorskip("h5py")
    ckpt = env["ckpt"]
    if "--ensemble" in flags:
        ckpt = f"{env['root'] / 's_0_checkpoint.pt'},{env['root'] / 's_1_checkpoint.pt'}"
    base = ["--ckpt", str(ckpt), "--sex", "M", "--encoding_size", str(D), "--buckets", BUCKETS, *flags]
    out, _ = _run(infer_cli.main, [*base, "--device", "cpu", "--heatmap", str(tmp_path / "port.png"),
                                   "--save_attention", str(tmp_path / "port" / att_name)])
    jax_out, _ = _run(jax_infer_cli.main, [*base, "--heatmap", str(tmp_path / "jax.png"),
                                           "--save_attention", str(tmp_path / "jax.h5")])
    got, want = json.loads(out), json.loads(jax_out[jax_out.index("{"):])
    assert list(got) == list(want)
    tol = TOL_PROB["int8" if "--int8" in flags else "float32"]
    for key in ("y_hat", "prediction", "site", "n_patches", "attention_task"):
        assert got[key] == want[key], key
    assert [t["class"] for t in got["topk"]] == [t["class"] for t in want["topk"]]
    np.testing.assert_allclose([t["prob"] for t in got["topk"]], [t["prob"] for t in want["topk"]], atol=tol + 1e-6)
    np.testing.assert_allclose(got["site_prob"], want["site_prob"], atol=tol + 1e-6)
    assert got["attention_file"] == str((tmp_path / "port" / att_name).absolute())

    import h5py

    with h5py.File(tmp_path / "jax.h5") as f:
        jax_attn = f["attention"][:]
        jax_coords = f["coords"][:] if "coords" in f else None
        assert f["attention"].attrs["task"] == got["attention_task"]
    got_attn, got_coords, task = _read_attention_export(tmp_path / "port" / att_name)
    assert task == got["attention_task"] and got_attn.shape == (got["n_patches"],)
    scale = 1.0 if "--ensemble" in flags else np.abs(jax_attn).max()  # an ensemble exports softmaxed weights
    assert np.abs(got_attn - jax_attn).max() <= (1e-2 if "--int8" in flags else 1e-4) * scale
    if jax_coords is None:
        assert got_coords is None and got["heatmap"] == want["heatmap"] == "skipped: no coords in input"
        return
    np.testing.assert_array_equal(got_coords, jax_coords)
    # the PNG is the heatmap of the exported attention, at canvas_shape's size
    png = (tmp_path / "port.png").read_bytes()
    assert png == heatmap.encode_png(heatmap.render_heatmap(got_coords, got_attn))
    from PIL import Image

    with Image.open(tmp_path / "port.png") as im:
        assert im.size[::-1] == heatmap.canvas_shape(got_coords, 256, 32)


def _read_attention_export(path):
    """(attention, coords or None, task) of an exported attention file."""
    if path.suffix == ".npz":
        z = np.load(path)
        return z["attention"], (z["coords"] if "coords" in z.files else None), str(z["task"])
    import h5py

    with h5py.File(path) as f:
        return f["attention"][:], (f["coords"][:] if "coords" in f else None), f["attention"].attrs["task"]


def test_cli_infer_refusals(env, tmp_path, monkeypatch):
    base = ["--ckpt", str(env["ckpt"]), "--sex", "F", "--encoding_size", str(D), "--device", "cpu"]
    with pytest.raises(SystemExit, match="--patches requires --weights"):
        infer_cli.main([*base, "--patches", str(tmp_path / "p.npz")])
    # --pallas configures XLA in the JAX CLI: taken, with one note on stderr, and the same answer as without it
    bag = ["--bag", str(env["bags"] / "S0.npy")]
    plain_out, plain_err = _run(infer_cli.main, [*base, *bag])
    out, err = _run(infer_cli.main, [*base, *bag, "--pallas"])
    assert out == plain_out and json.loads(out)["n_patches"] == 30
    assert err.count("--pallas has no effect here") == 1 and err.replace(err.splitlines()[0] + "\n", "", 1) == plain_err
    _hide(monkeypatch, "h5py")
    with pytest.raises(ImportError, match=r"\.npz"):
        _run(infer_cli.main, [*base, "--bag", str(env["bags"] / "S0.npy"), "--save_attention", str(tmp_path / "a.h5")])


def _attention_files(tmp_path, scores, coords):
    """The same attention as an .npz (``attention``) and as an .h5 (``scores``)."""
    import h5py

    np.savez(tmp_path / "a.npz", attention=scores, coords=coords, task=np.array("origin"))
    with h5py.File(tmp_path / "a.h5", "w") as f:
        f.create_dataset("scores", data=scores)
        f.create_dataset("coords", data=coords)
    return tmp_path / "a.npz", tmp_path / "a.h5"


@pytest.mark.parametrize("flags", [[], ["--no_percentile", "--cmap", "viridis"], ["--background", "thumb.png"]],
                         ids=["default", "raw_viridis", "background"])
def test_cli_heatmap_reads_both_formats_as_the_jax_cli(flags, tmp_path):
    pytest.importorskip("h5py")
    from PIL import Image

    coords = _grid(30, 6)
    scores = np.random.default_rng(5).standard_normal(30).astype(np.float32)
    npz, h5 = _attention_files(tmp_path, scores, coords)
    Image.fromarray(np.full((100, 80, 3), 120, np.uint8)).save(tmp_path / "thumb.png")
    flags = [str(tmp_path / f) if f.endswith(".png") else f for f in flags]
    out_npz, _ = _run(heatmap_cli.main, ["--attention", str(npz), "--out", str(tmp_path / "n.png"), *flags])
    _run(heatmap_cli.main, ["--attention", str(h5), "--out", str(tmp_path / "h.png"), *flags])
    jax_out, _ = _run(jax_heatmap_cli.main, ["--attention", str(h5), "--out", str(tmp_path / "j.png"), *flags])
    data = (tmp_path / "j.png").read_bytes()
    assert (tmp_path / "n.png").read_bytes() == (tmp_path / "h.png").read_bytes() == data
    assert out_npz.split("(")[1] == jax_out.split("(")[1]  # "(WxH)"


def test_cli_heatmap_without_pillow_or_coords(tmp_path, monkeypatch):
    coords = _grid(16, 4)
    scores = np.linspace(0, 1, 16).astype(np.float32)
    np.savez(tmp_path / "a.npz", attention=scores, coords=coords)
    np.savez(tmp_path / "nocoords.npz", attention=scores)
    with pytest.raises(KeyError, match="coords"):
        heatmap_cli.main(["--attention", str(tmp_path / "nocoords.npz"), "--out", str(tmp_path / "x.png")])
    _hide(monkeypatch, *NO_LIBS)
    with pytest.raises(ImportError, match="Pillow"):
        heatmap_cli.main(["--attention", str(tmp_path / "a.npz"), "--out", str(tmp_path / "x.png"),
                          "--background", str(tmp_path / "thumb.png")])
    _run(heatmap_cli.main, ["--attention", str(tmp_path / "a.npz"), "--out", str(tmp_path / "hm.png")])
    img = _decode_png((tmp_path / "hm.png").read_bytes())  # the stdlib writer and the built-in ramp
    assert np.array_equal(img, jax_heatmap.render_heatmap(coords, scores))


# -- export ---------------------------------------------------------------------


def _assert_same_params(got, want):
    flat_g, flat_w = jax.tree_util.tree_flatten_with_path(got)[0], jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert np.array_equal(np.asarray(g), np.asarray(w)), path


@pytest.mark.parametrize("drop_out", [False, True])
@pytest.mark.parametrize("source", ["reference_pt_plain", "reference_pt_dropout", "resume_snapshot"])
def test_cli_export_round_trips_through_the_jax_loader(env, source, drop_out, tmp_path):
    params = env["params"][1 if source == "reference_pt_dropout" else 0]
    if source == "resume_snapshot":
        model = ToadMIL(ModelConfig(in_dim=D, n_classes=N_CLS))
        model.load_state_dict(params_from_jax(params))
        ckpt = tmp_path / "s_0_resume.pt"
        # the trainer's snapshot (train/loop.py, _save_resume)
        torch.save({"model": model.state_dict(), "optimizer": make_optimizer(OptimConfig(), model.parameters()).state_dict(),
                    "generator": torch.Generator().get_state(), "epoch": 2, "best_saved": 1}, ckpt)
    else:
        ckpt = env["root"] / f"s_{1 if source == 'reference_pt_dropout' else 0}_checkpoint.pt"
    out = tmp_path / "out" / "s_0_checkpoint.pt"
    said, _ = _run(export_cli.main, ["--ckpt", str(ckpt), "--out", str(out), "--encoding_size", str(D)]
                   + (["--drop_out"] if drop_out else []))
    assert said.strip() == f"exported {ckpt} -> {out} (reference state_dict layout, drop_out={drop_out})"
    sd = torch.load(out, weights_only=True)
    assert ("attention_net.3.weight" in sd) == drop_out and ("attention_net.2.weight" in sd) != drop_out
    _assert_same_params(jax_load_params_any(out, JaxModelConfig(in_dim=D, n_classes=N_CLS)), params)
    if source != "resume_snapshot":  # the JAX CLI re-exports a .pt to the same file contents
        theirs = tmp_path / "jax.pt"
        _run(jax_export_cli.main, ["--ckpt", str(ckpt), "--out", str(theirs), "--encoding_size", str(D)]
             + (["--drop_out"] if drop_out else []))
        jsd = jax_load_params_any(theirs, JaxModelConfig(in_dim=D, n_classes=N_CLS))
        _assert_same_params(jax_load_params_any(out, JaxModelConfig(in_dim=D, n_classes=N_CLS)), jsd)


def test_cli_export_refuses_an_orbax_directory_and_a_wrong_width(env, tmp_path):
    (tmp_path / "s_0_checkpoint").mkdir()
    with pytest.raises(ValueError, match="python -m toad_tpu export"):
        export_cli.main(["--ckpt", str(tmp_path / "s_0_checkpoint"), "--out", str(tmp_path / "o.pt")])
    with pytest.raises(ValueError, match="trunk fc1 shape"):
        export_cli.main(["--ckpt", str(env["ckpt"]), "--out", str(tmp_path / "o.pt")])  # --encoding_size 1024
    assert not (tmp_path / "o.pt").exists()


def test_exported_checkpoint_predicts_as_its_source(env, tmp_path):
    out = tmp_path / "e.pt"
    _run(export_cli.main, ["--ckpt", str(env["root"] / "s_1_checkpoint.pt"), "--out", str(out),
                           "--encoding_size", str(D)])
    cfg = ModelConfig(in_dim=D, n_classes=N_CLS)
    feats = np.load(env["bags"] / "S2.npy")
    a = SlideInference.from_checkpoint(out, cfg, device="cpu").predict(feats, 0)
    b = SlideInference.from_checkpoint(env["root"] / "s_1_checkpoint.pt", cfg, device="cpu").predict(feats, 0)
    np.testing.assert_array_equal(a.y_prob, b.y_prob)


# -- the dispatcher ----------------------------------------------------------------


@pytest.mark.parametrize("command", ["infer", "predict", "heatmap", "export"])
def test_dispatcher_runs_the_four_commands(command):
    run = subprocess.run([sys.executable, "-m", "toad_tpu_torch", command, "--help"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0 and f"python -m toad_tpu_torch {command}" in run.stdout
