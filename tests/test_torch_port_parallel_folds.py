"""Fold-parallel CV of the port (``train/parallel_folds.py``, ``train
--fold_devices``, ``eval --fold_devices``) and ``train`` over a mesh, on the
CPU, the cases of ``tests/test_parallel_folds.py``.

The contract is placement only: every fold runs the unchanged sequential
FoldTrainer on its own device, so each fold's results must equal a
sequential run's bit for bit. The CPU stands in for the cards: a device
list may repeat it (``[cpu] * 2``), as the JAX tests' 8 virtual CPU devices
stand in for chips; two worker threads then train two folds at once.

The mesh CLI run (``train --data_shards 2 --bag_shards 2 --device cpu``)
is held against the JAX CLI's run of the same shape on the same bags and
splits: each fold's val and test AUCs within 1e-6 and accuracies equal, the
weights starting equal (the JAX run's initial weights copied in). The two
runs differ in summation order only (f32 on both sides; the port on its
CPU mesh, the JAX package under GSPMD on 4 virtual devices).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from toad_tpu_torch import config
from toad_tpu_torch.data import synthetic
from toad_tpu_torch.data.splits import generate_splits
from toad_tpu_torch.data.wsi_dataset import WSIBagDataset
from toad_tpu_torch.train import parallel_folds as pf
from toad_tpu_torch.train.loop import FoldTrainer
from toad_tpu_torch.train.parallel_folds import map_folds_over_devices, resolve_fold_devices, train_folds_parallel

D, N_CLS = 32, 18
CPU = torch.device("cpu")



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads a test process: the suite runs in several worker
    processes at once, and two folds train at once here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _cfg(max_epochs: int = 2, **kw) -> config.TrainConfig:
    return config.TrainConfig(
        max_epochs=max_epochs,
        seed=1,
        model=config.ModelConfig(in_dim=D, n_classes=N_CLS),
        optim=config.OptimConfig(lr=3e-4),
        data=config.DataConfig(batch_size=4, bucket_sizes=(64, 128, 256)),
        **kw,
    )


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_folds")
    csv_path = root / "dummy.csv"
    manifest = synthetic.write_dummy_csv(csv_path, n_patients=54, max_slides_per_patient=1, seed=4)
    task = synthetic.dummy_task(str(csv_path))
    synthetic.write_dummy_bags(root / "bags", manifest, task, n_patches_range=(20, 250), dim=D, fmt="npy", seed=4)
    ds = WSIBagDataset(task, data_dir=str(root / "bags"))
    counts = np.array([len(c) for c in ds.slide_cls_ids])
    jobs = []
    for fold, spec in enumerate(generate_splits(ds.slide_cls_ids, np.maximum((counts * 0.15).astype(int), 1),
                                                np.maximum((counts * 0.2).astype(int), 1), ds.n_slides, n_splits=3,
                                                seed=1)):
        jobs.append((fold, (ds.subset(spec.train), ds.subset(spec.val), ds.subset(spec.test))))
    (root / "tasks").mkdir()
    (root / "tasks" / "dummy_mtl_concat.json").write_text(task.to_json())
    return {"root": root, "task": task, "ds": ds, "jobs": jobs}


def _quiet(_):
    pass


def _assert_same(a: dict, b: dict) -> None:
    for key in ("cls_test_auc", "cls_val_auc", "cls_test_acc", "site_test_auc"):
        assert a[key] == b[key] or (np.isnan(a[key]) and np.isnan(b[key])), key
    assert a["params"].keys() == b["params"].keys()
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


def test_parallel_matches_sequential_bitwise(env, tmp_path):
    cfg = _cfg(max_epochs=1)
    seq = {fold: FoldTrainer(cfg, fold=fold, results_dir=tmp_path / "seq", device="cpu").train(*splits, log_fn=_quiet)
           for fold, splits in env["jobs"][:2]}
    par = train_folds_parallel(cfg, env["jobs"][:2], tmp_path / "par", n_devices=2, log_fn=_quiet, devices=[CPU] * 2)
    assert sorted(par) == [0, 1]
    for fold in (0, 1):
        _assert_same(seq[fold], par[fold])


def test_more_folds_than_devices(env, tmp_path):
    """3 folds on 2 devices: the work queue drains without a round barrier."""
    lines = []
    par = train_folds_parallel(_cfg(max_epochs=1), env["jobs"], tmp_path, n_devices=2, log_fn=lines.append,
                               devices=[CPU] * 2)
    assert sorted(par) == [0, 1, 2]
    assert all(np.isfinite(r["cls_val_auc"]) for r in par.values())
    assert sorted(ln for ln in lines if "] -> " in ln) == [f"[fold {i}] -> cpu" for i in range(3)]


def test_each_fold_runs_on_its_device_with_it_current(env, monkeypatch):
    """map_folds_over_devices hands each job its worker's device, one job a
    device at a time, and makes the device current around the job."""
    entered = []

    class Current:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(self.dev)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(pf, "_current", Current)
    devs = [torch.device("cpu"), torch.device("meta")]
    got = map_folds_over_devices([(i, i * 10) for i in range(4)], lambda fold, payload, dev, log: (payload, dev),
                                 n_devices=2, log_fn=_quiet, devices=devs)
    assert sorted(got) == [0, 1, 2, 3] and {v[0] for v in got.values()} == {0, 10, 20, 30}
    assert {v[1] for v in got.values()} <= set(devs) and len(entered) == 4


def test_refuses_mesh_combination(env, tmp_path):
    with pytest.raises(ValueError, match="data_shards"):
        train_folds_parallel(_cfg(data_shards=2), env["jobs"][:1], tmp_path, n_devices=2, devices=[CPU] * 2)


def test_refuses_profile(env, tmp_path):
    with pytest.raises(ValueError, match="profile"):
        train_folds_parallel(_cfg(profile_dir=str(tmp_path / "trace")), env["jobs"][:1], tmp_path, n_devices=2,
                             devices=[CPU] * 2)


def test_fold_trainer_refuses_a_device_with_a_mesh(tmp_path):
    from toad_tpu_torch.parallel.mesh import make_mesh

    msg = r"device= \(fold-parallel\) cannot combine with mesh/data_shards/bag_shards"
    with pytest.raises(ValueError, match=msg):
        FoldTrainer(_cfg(bag_shards=2), 0, tmp_path, device="cpu")
    with pytest.raises(ValueError, match=msg):
        FoldTrainer(_cfg(), 0, tmp_path, mesh=make_mesh(1, 2, devices=[CPU] * 2), device="cpu")


def test_resolve_fold_devices_bounds(monkeypatch):
    assert resolve_fold_devices(-1, [CPU] * 3) == [CPU] * 3
    assert len(resolve_fold_devices(2, [CPU] * 3)) == 2
    with pytest.raises(ValueError, match="only 3 local devices"):
        resolve_fold_devices(10_000, [CPU] * 3)
    with pytest.raises(ValueError, match=">= 1"):
        resolve_fold_devices(0, [CPU] * 3)
    # without a list: the visible cards (none here, two patched in)
    assert resolve_fold_devices(-1) == []
    monkeypatch.setattr(pf, "visible_devices", lambda: [torch.device("cuda", 0), torch.device("cuda", 1)])
    assert resolve_fold_devices(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="fold_devices=3 but only 2 local devices are visible"):
        resolve_fold_devices(3)


def test_worker_error_propagates(env, tmp_path):
    """A fold raising mid-train surfaces as RuntimeError naming the fold."""
    fold, (tr, va, te) = env["jobs"][0]

    class Broken:
        # quacks enough to get past the split bookkeeping, then fails in the batcher
        slide_ids = tr.slide_ids

        def __len__(self):
            return len(tr)

        def __getattr__(self, name):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="fold 0 failed") as e:
        train_folds_parallel(_cfg(max_epochs=1), [(0, (Broken(), va, te))], tmp_path, n_devices=1, devices=[CPU])
    assert "boom" in str(e.value.__cause__)


# -- the CLIs --


@pytest.fixture(scope="module")
def cli_env(env, tmp_path_factory):
    """Two folds' split files for the CLIs."""
    from toad_tpu_torch.cli import create_splits

    root = tmp_path_factory.mktemp("port_folds_cli")
    create_splits.main(["--task", str(env["root"] / "tasks" / "dummy_mtl_concat.json"), "--k", "2", "--seed", "1",
                        "--val_frac", "0.34", "--test_frac", "0.34", "--split_root", str(root / "splits")])
    return {"root": root, "split_dir": str(root / "splits" / "dummy_mtl_concat_100"),
            "task": str(env["root"] / "tasks" / "dummy_mtl_concat.json"), "bags": str(env["root"] / "bags")}


def _train_args(cli_env, results_dir, *extra):
    return ["--task", cli_env["task"], "--data_root_dir", cli_env["bags"], "--exp_code", "pfres", "--k", "2",
            "--max_epochs", "2", "--encoding_size", str(D), "--batch_size", "4", "--buckets", "128,256",
            "--split_dir", cli_env["split_dir"], "--results_dir", str(results_dir), "--device", "cpu", *extra]


def test_cli_resume_composes_with_fold_devices(cli_env, tmp_path, monkeypatch, capsys):
    """``train --resume --fold_devices 2`` survives a mid-experiment
    preemption: folds completed before the crash persisted their summaries
    at once (on_result fires per fold), the restart skips them, resumes the
    interrupted fold from its epoch snapshot, and the final summary equals
    an uninterrupted run's, byte for byte."""
    from toad_tpu_torch.cli import train as train_cli

    rows_a = train_cli.main(_train_args(cli_env, tmp_path / "ra", "--resume", "--fold_devices", "2"))

    class Boom(Exception):
        pass

    real_trainer = pf.FoldTrainer

    class CrashyTrainer(real_trainer):
        def train(self, *splits, log_fn=print):
            if self.fold == 1:
                inner = log_fn

                def log_fn(s):
                    inner(s)
                    if "epoch 1: train" in s:
                        raise Boom()

            return super().train(*splits, log_fn=log_fn)

    monkeypatch.setattr(pf, "FoldTrainer", CrashyTrainer)
    with pytest.raises(RuntimeError, match="fold 1 failed"):
        train_cli.main(_train_args(cli_env, tmp_path / "rb", "--resume", "--fold_devices", "2"))
    monkeypatch.setattr(pf, "FoldTrainer", real_trainer)

    rb = tmp_path / "rb" / "pfres_s1"
    assert (rb / "fold_0_summary.json").exists()  # persisted despite the crash
    assert not (rb / "fold_1_summary.json").exists()
    assert (rb / "s_1_resume.pt").exists()  # the epoch-0 snapshot to resume from

    capsys.readouterr()
    rows_b = train_cli.main(_train_args(cli_env, tmp_path / "rb", "--resume", "--fold_devices", "2"))
    out = capsys.readouterr().out
    assert out.count("already complete") == 1  # fold 0 skipped, not retrained
    assert "[fold 1] resumed from epoch 0" in out
    assert rows_b == rows_a
    assert (rb / "summary.csv").read_bytes() == (tmp_path / "ra" / "pfres_s1" / "summary.csv").read_bytes()


def test_cli_fold_devices_refused_past_the_visible_cards(cli_env, tmp_path, monkeypatch):
    """On the card the fold devices are the visible cards: two asked of one
    card is refused with resolve_fold_devices' text before any fold runs."""
    from toad_tpu_torch.cli import train as train_cli

    monkeypatch.setattr(pf, "visible_devices", lambda: [torch.device("cuda", 0)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    args = [a for a in _train_args(cli_env, tmp_path, "--fold_devices", "2") if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit, match="fold_devices=2 but only 1 local devices are visible"):
        train_cli.main(args)
    assert not list(tmp_path.glob("*/s_*_checkpoint.pt"))


@pytest.mark.parametrize("flags,says", [
    (["--fold_devices", "2", "--data_shards", "2"], "--fold_devices cannot combine with --data_shards/--bag_shards"),
    (["--fold_devices", "2", "--bag_shards", "2"], "--fold_devices cannot combine with --data_shards/--bag_shards"),
    (["--fold_devices", "2", "--profile", "p"], "--profile supports one trace at a time; drop --fold_devices"),
])
def test_cli_fold_devices_keeps_the_jax_exclusivity_checks(cli_env, tmp_path, flags, says):
    from toad_tpu_torch.cli import train as train_cli

    with pytest.raises(ValueError, match=says):
        train_cli.main(_train_args(cli_env, tmp_path, *flags))


def test_cli_evaluate_fold_devices_matches_sequential(cli_env, tmp_path, monkeypatch):
    """``eval --fold_devices 2`` is placement only, like train: the fold CSVs,
    the ensemble CSV and the summary are the sequential run's, byte for byte."""
    from toad_tpu_torch.cli import evaluate
    from toad_tpu_torch.models.interop import reference_state_dict
    from toad_tpu_torch.models.toad_mil import ToadMIL
    from toad_tpu_torch.train.checkpoint import save_checkpoint

    models_dir = tmp_path / "results" / "pfe_s1"
    models_dir.mkdir(parents=True)
    for i in (0, 1):
        model = ToadMIL(config.ModelConfig(in_dim=D, n_classes=N_CLS), generator=torch.Generator().manual_seed(i))
        save_checkpoint(models_dir / f"s_{i}_checkpoint.pt", reference_state_dict(model.state_dict()))
    monkeypatch.chdir(tmp_path)
    base = ["--task", cli_env["task"], "--data_root_dir", cli_env["bags"], "--results_dir", str(tmp_path / "results"),
            "--models_exp_code", "pfe_s1", "--k", "2", "--split", "all", "--encoding_size", str(D), "--batch_size", "4",
            "--buckets", "128,256", "--ensemble", "--device", "cpu"]
    rows_seq = evaluate.main(base + ["--save_exp_code", "seq"])
    rows_par = evaluate.main(base + ["--save_exp_code", "par", "--fold_devices", "2"])
    assert rows_seq == rows_par
    for name in ("fold_0.csv", "fold_1.csv", "ensemble.csv", "summary.csv", "fold_0_confusion.csv"):
        a = (tmp_path / "eval_results" / "EVAL_seq" / name).read_bytes()
        assert a == (tmp_path / "eval_results" / "EVAL_par" / name).read_bytes(), name


def test_cli_train_on_a_2x2_mesh_matches_the_jax_cli(cli_env, tmp_path, monkeypatch):
    """``train --data_shards 2 --bag_shards 2 --device cpu`` against the JAX
    CLI's run of the same shape (on 4 of its 8 virtual CPU devices), the same
    bags, split and initial weights, one fold: the summary row within 1e-6 on
    AUCs, equal accuracies."""
    import jax

    from toad_tpu.cli import train as jax_train_cli
    from toad_tpu.models.toad_mil import ToadMIL as JaxToadMIL
    from toad_tpu.parallel import mesh as jax_mesh
    from toad_tpu.train import loop as jax_loop
    from toad_tpu_torch.cli import train as train_cli
    from toad_tpu_torch.models import toad_mil as port_toad_mil
    from toad_tpu_torch.models.interop import params_from_jax

    jax_init = {}
    real_init = JaxToadMIL.init

    def recording_init(self, key):
        params = real_init(self, key)
        jax_init["params"] = jax.tree.map(np.asarray, params)
        return params

    monkeypatch.setattr(JaxToadMIL, "init", recording_init)
    monkeypatch.setattr(jax_loop.ToadMIL, "init", recording_init)
    # the JAX CLI's mesh takes every device it sees (jax.devices(), 8 here): give it the first 4 for a 2 x 2 mesh
    real_make_mesh = jax_mesh.make_mesh
    monkeypatch.setattr(jax_mesh, "make_mesh", lambda d=None, b=None, devices=None: real_make_mesh(
        d, b, devices if devices is not None else jax.devices()[:4]))
    monkeypatch.chdir(tmp_path)
    shape = ["--data_shards", "2", "--bag_shards", "2"]
    common = ["--task", cli_env["task"], "--data_root_dir", cli_env["bags"], "--exp_code", "mesh", "--k", "2",
              "--k_end", "1", "--max_epochs", "1", "--encoding_size", str(D), "--batch_size", "4", "--buckets", "256,512",
              "--split_dir", cli_env["split_dir"], "--opt", "sgd", "--lr", "1e-3", *shape]
    want = jax_train_cli.main([*common, "--results_dir", str(tmp_path / "jax")])

    real_port_init = port_toad_mil.ToadMIL.reset_parameters

    def jax_weights(self, generator):
        real_port_init(self, generator)
        if self.config.in_dim == D and "params" in jax_init:
            self.load_state_dict(params_from_jax(jax_init["params"]))

    monkeypatch.setattr(port_toad_mil.ToadMIL, "reset_parameters", jax_weights)
    got = train_cli.main([*common, "--results_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert [r["folds"] for r in got] == list(want["folds"])
    for row, (_, jrow) in zip(got, want.iterrows()):
        for col in ("cls_val_auc", "cls_test_auc", "site_val_auc", "site_test_auc"):
            assert abs(row[col] - jrow[col]) <= 1e-6 or (np.isnan(row[col]) and np.isnan(jrow[col])), col
        for col in ("cls_val_acc", "cls_test_acc", "site_val_acc", "site_test_acc"):
            assert row[col] == jrow[col], col
    settings = (tmp_path / "port" / "mesh_s1" / "experiment_mesh.txt").read_text()
    assert "'data_shards': 2" in settings and "'bag_shards': 2" in settings and "'data': 2, 'bag': 2" in settings


def test_fold_trainer_on_a_mesh_matches_one_device(env, tmp_path):
    """FoldTrainer over a 2 x 2 mesh of the CPU device (SGD, one epoch):
    the batcher keeps its batches on the host, each step places them over
    the mesh, and the weights and metrics end as the one-device run's,
    summation order apart; the eval passes pool by shard (partial mode and
    combine, the plain versions here) and say so."""
    from toad_tpu_torch.parallel.mesh import make_mesh

    fold, splits = env["jobs"][0]
    cfg = dataclasses.replace(_cfg(max_epochs=1, data_shards=2, bag_shards=2), optim=config.OptimConfig(name="sgd", lr=1e-3),
                              data=config.DataConfig(batch_size=4, bucket_sizes=(128, 256)))
    lines = []
    meshed = FoldTrainer(cfg, fold=fold, results_dir=tmp_path / "mesh", mesh=make_mesh(2, 2, devices=[CPU] * 4))
    assert meshed.device == CPU and meshed._batcher(splits[0], training=True).device is None
    got = meshed.train(*splits, log_fn=lines.append)
    want = FoldTrainer(dataclasses.replace(cfg, data_shards=1, bag_shards=1), fold=fold, results_dir=tmp_path / "one",
                       device="cpu").train(*splits, log_fn=_quiet)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["val"]["y_prob"], want["val"]["y_prob"], rtol=1e-4, atol=1e-5)
    assert any("mesh {'data': 2, 'bag': 2}" in ln for ln in lines)
    assert any("partial-mode launches 0, combine launches 0" in ln for ln in lines)  # no card: the plain versions
