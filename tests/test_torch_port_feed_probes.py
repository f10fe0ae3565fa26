"""The disk-fed probes of the port (``io_overlap_probe``,
``bf16_transfer_probe``, ``patient_native_probe``) and their fixture, on the
CPU at a toy size (the probes' constants set to bags of 64 x 32 instead of
8,192 x 1024, one epoch a timed run, one rep a case).

- The fixture writes the rows ``bench._ensure_io_fixture`` writes (the JAX
  function's row expression evaluated from its source, serialized by
  pandas) and, for slide i, the draws of ``RandomState(1000 + i).randn``,
  which the JAX package's loader reads back the same.
- Each probe's ``main`` prints its keys; both arms of the two A/B probes give
  the same per-slide ``y_prob`` (0.0 apart), and those rows agree with the
  JAX ``ToadMIL`` on the same bags, the weights carried across by
  ``models/interop.py``, within ``test_torch_port_model.py``'s bf16
  tolerance (2e-3).
- The patient probe's native and numpy feeds give the same batches, bit for
  bit, on both of its wires.
- With no card, each probe asked for the card exits with
  ``resolve_device``'s message.
"""

import ast
import importlib
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from toad_tpu.config import ModelConfig as JaxModelConfig
from toad_tpu.data.bags import load_bag as jax_load_bag
from toad_tpu.data.synthetic import DEFAULT_ORIGINS as JAX_ORIGINS
from toad_tpu.models.toad_mil import ToadMIL as JaxToadMIL
from toad_tpu_torch.data.batching import BagBatcher
from toad_tpu_torch.data.synthetic import write_io_fixture
from toad_tpu_torch.experiments import bf16_transfer_probe, io_overlap_probe, patient_native_probe
from toad_tpu_torch.models.interop import params_to_jax_layout

REPO = Path(__file__).resolve().parent.parent
N_SLIDES, BAG_N, DIM = 16, 64, 32
TOL_BF16 = dict(rtol=2e-3, atol=2e-3)  # test_torch_port_model.py's bf16 tolerance on y_prob


@pytest.fixture(autouse=True)
def toy_sizes(monkeypatch):
    for name, value in (("N_SLIDES", N_SLIDES), ("BAG_N", BAG_N), ("DIM", DIM), ("EPOCHS", 1)):
        monkeypatch.setattr(io_overlap_probe, name, value)
    monkeypatch.setattr(patient_native_probe, "REPS", 1)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    data_dir = tmp_path_factory.mktemp("io_fixture")
    return write_io_fixture(data_dir, N_SLIDES, BAG_N, DIM)


def _jax_fixture_rows(n_slides: int) -> list[dict]:
    """The rows ``bench._ensure_io_fixture`` writes, from its own source: its
    ``rows = [...]`` expression evaluated on the JAX package's origins (the
    function itself writes into a fixed directory under /tmp)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "_ensure_io_fixture")
    assign = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "rows")
    expr = compile(ast.Expression(assign.value), "bench.py", "eval")
    return eval(expr, {"labels": list(JAX_ORIGINS), "n_slides": n_slides, "range": range, "len": len})


def test_fixture_writes_the_jax_fixture_s_rows_and_draws(fixture):
    data_dir, csv_path = fixture
    assert csv_path == data_dir / f"io_{N_SLIDES}.csv"
    assert csv_path.read_text() == pd.DataFrame(_jax_fixture_rows(N_SLIDES)).to_csv(index=False)
    for i in range(N_SLIDES):
        path = data_dir / f"BENCH-SLIDE_{i}.pt"
        want = np.random.RandomState(1000 + i).randn(BAG_N, DIM).astype(np.float32)
        got = torch.load(path, weights_only=True)
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
        assert np.array_equal(jax_load_bag(path), want)  # the JAX package reads the port's .pt the same
    assert not list(data_dir.glob("*.part"))


def test_fixture_reuses_what_is_there(fixture):
    data_dir, csv_path = fixture
    stamps = {p: p.stat().st_mtime_ns for p in data_dir.iterdir()}
    assert write_io_fixture(data_dir, N_SLIDES, BAG_N, DIM) == (data_dir, csv_path)
    assert {p: p.stat().st_mtime_ns for p in data_dir.iterdir()} == stamps


@pytest.mark.parametrize("probe,keys", [
    (io_overlap_probe, ["dispatch_h2d_slides_per_sec", "producer_device_put_slides_per_sec", "speedup"]),
    (bf16_transfer_probe, ["f32_transfer_slides_per_sec", "bf16_transfer_slides_per_sec", "speedup", "max_prob_dev"]),
], ids=["io_overlap", "bf16_transfer"])
def test_ab_probe_prints_its_keys_and_both_arms_agree(fixture, probe, keys, capsys):
    data_dir, _ = fixture
    assert probe.main(["--data_dir", str(data_dir), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line)[:len(keys)] == keys  # the JAX probe's keys, in its order
    assert list(line)[len(keys):] == [k for k in ("max_prob_dev", "k1_launches", "device") if k not in keys]
    rates = [v for k, v in line.items() if k.endswith("slides_per_sec")]
    assert len(rates) == 2 and all(r > 0 for r in rates)
    # the probe divides the unrounded rates (as the JAX probe does) and prints each rate rounded to 0.01: the ratio
    # of the printed rates is the speedup within that rounding (each rate off by at most 0.005)
    r0, r1 = rates
    assert abs(line["speedup"] - r1 / r0) <= 5e-4 + 0.005 * (1 + r1 / r0) / r0
    assert line["max_prob_dev"] == 0.0 and line["k1_launches"] == 0 and line["device"] == "cpu"


@pytest.mark.parametrize("probe", [io_overlap_probe, bf16_transfer_probe], ids=["io_overlap", "bf16_transfer"])
def test_ab_probe_speedup_is_the_ratio_of_the_unrounded_rates(fixture, probe, monkeypatch, capsys):
    """Both arms' rates fixed (the base arm timed first): the speedup is
    their unrounded ratio rounded to 3 places, 0.974 here, where the ratio of
    the printed (rounded) rates would give 0.976."""
    data_dir, _ = fixture
    fixed = iter((8.6049, 8.3851))
    monkeypatch.setattr(io_overlap_probe, "slides_per_sec", lambda *a, **k: next(fixed))
    assert probe.main(["--data_dir", str(data_dir), "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [v for k, v in line.items() if k.endswith("slides_per_sec")] == [8.6, 8.39]
    assert line["speedup"] == round(8.3851 / 8.6049, 3) == 0.974


def test_probe_forward_matches_the_jax_model_on_the_fixture(fixture):
    """The A/B probes' per-slide y_prob against the JAX ToadMIL (bf16 compute)
    on the same bags, the probes' seeded weights carried across."""
    data_dir, _ = fixture
    dev = torch.device("cpu")
    split = io_overlap_probe.fixture_split(data_dir, "io_probe")
    model = io_overlap_probe.seeded_model(dev)
    got = io_overlap_probe.slide_probs(
        model, BagBatcher(split, batch_size=8, bucket_sizes=(BAG_N,), mode="sequential"), dev)
    jax_model = JaxToadMIL(JaxModelConfig(in_dim=DIM, n_classes=18, compute_dtype="bfloat16"))
    x = np.stack([split.load_bag(i) for i in range(N_SLIDES)])
    mask = np.ones((N_SLIDES, BAG_N), np.float32)
    want = jax_model.apply(params_to_jax_layout(model), jnp.asarray(x), jnp.asarray(mask), jnp.asarray(split.sexes),
                           train=False, need_attention=False).y_prob
    assert got.shape == (N_SLIDES, 18)
    np.testing.assert_allclose(got, np.asarray(want), **TOL_BF16)


def test_patient_probe_prints_a_line_a_case(fixture, capsys):
    data_dir, _ = fixture
    assert patient_native_probe.main(["--data_dir", str(data_dir), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"8 patient bags, 2x{BAG_N}x{DIM} f32 slides each"
    cases = [(w, n) for w in ("bfloat16", "int8") for n in ("on", "off")]
    assert [ln.split(":")[0] for ln in lines[1:]] == [f"wire={w:9s} native={n:3s}" for w, n in cases]
    assert all(ln.endswith(" s/epoch") and float(ln.split(":")[1].split()[0]) >= 0 for ln in lines[1:])


@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
def test_patient_probe_native_and_numpy_feeds_give_the_same_batches(fixture, wire):
    data_dir, _ = fixture
    split = patient_native_probe.patient_split(data_dir)
    assert len(split) == 8 and [list(g) for g in split.groups] == [[2 * p, 2 * p + 1] for p in range(8)]
    on = patient_native_probe.batcher(split, wire, "on")
    off = patient_native_probe.batcher(split, wire, "off")
    batches_on, batches_off = list(on), list(off)
    assert on.feed_kind == "native" and off.feed_kind == "numpy"
    assert len(batches_on) == len(batches_off) == 2
    bits = {torch.bfloat16: torch.int16, torch.int8: torch.int8, torch.float32: torch.int32}

    def planes(b):
        out = []
        for t in (b.features, b.patch_mask, b.scales):
            if t is not None:
                t = torch.as_tensor(t)
                out.append(t.view(bits[t.dtype]))
        return out

    for a, b in zip(batches_on, batches_off):
        assert a.features.shape == (4, 2 * BAG_N, DIM)
        pa, pb = planes(a), planes(b)
        assert len(pa) == len(pb) == (3 if wire == "int8" else 2)
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))
        for field in ("bag_mask", "label", "site", "sex", "indices"):
            assert np.array_equal(getattr(a, field), getattr(b, field)), field
    # every real row of each patient bag is its two slides, concatenated
    first = torch.as_tensor(batches_off[0].features)
    want = np.concatenate([split.parent.load_bag(0), split.parent.load_bag(1)])
    if wire == "bfloat16":
        assert torch.equal(first[0], torch.from_numpy(want).to(torch.bfloat16))
    assert float(torch.as_tensor(batches_off[0].patch_mask).sum()) == 4 * 2 * BAG_N


@pytest.mark.parametrize("name", ["io_overlap_probe", "bf16_transfer_probe", "patient_native_probe"])
def test_probe_without_a_card_exits_with_resolve_device_s_message(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    probe = importlib.import_module(f"toad_tpu_torch.experiments.{name}")
    with pytest.raises(SystemExit, match=r"torch.cuda.is_available\(\) is False.*--device cpu"):
        probe.main(["--data_dir", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []  # the device is resolved before the fixture is written
