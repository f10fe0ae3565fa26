"""Checkpoint evaluation of the PyTorch port against the JAX package, on the CPU.

The same seeded numpy inputs and the same weights (carried across with
``models/interop.py``) go through both packages: the calibration functions,
the batcher's int8 wire, the int8 eval step, the eval engine, the CSV
writers and the ``eval`` / ``report`` / ``validate`` CLIs. On the CPU the
port runs the plain versions of its pooling kernels; the JAX side runs its
XLA path.

Tolerances:
- calibration: ECE and NLL 1e-12, fitted temperatures 1e-9 (the same search
  on the same float64 probabilities);
- the int8 wire's int8 rows and f32 scales: exactly equal to the JAX
  batcher's (the same numpy quantizer); the port's device quantizer is an
  exact twin of the host one (equal integers and scales), so wire and device
  quantization give the same answers inside the port, held to 1e-6 because
  a CPU f32 matrix product may round its last bit differently between calls;
- int8 probabilities: within 0.02 of the float step's and of the JAX int8
  step's (the budget of tests/test_int8.py: the JAX in-graph quantizer may
  differ by one step, and the kernels round gated values to bf16);
- the f32 engine: probabilities 1e-5, AUCs 1e-6 (both sides are f32 with
  another summation order), predictions, top-k, sentinels and row order equal;
- the writers: byte for byte equal to pandas' on the same pass result;
- the CLIs on the port's checkpoints: ids, labels and integer columns equal,
  float cells 1e-5, AUCs and their bootstrap bounds 1e-6, temperatures and
  ECE/NLL 1e-3 (fitted on probabilities that differ by 1e-5).
"""

import csv
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from toad_tpu import config as jax_config
from toad_tpu.data import batching as jax_batching
from toad_tpu.data.wsi_dataset import PatientBagSplit as JaxPatientBagSplit
from toad_tpu.data.wsi_dataset import WSIBagDataset as JaxDataset
from toad_tpu.evaluate import calibration as jax_calibration
from toad_tpu.evaluate import engine as jax_engine
from toad_tpu.evaluate import runner as jax_runner
from toad_tpu.models.toad_mil import ToadMIL as JaxToadMIL
from toad_tpu.ops import quantize as jax_quantize
from toad_tpu_torch import config, evaluate
from toad_tpu_torch.data import batching, synthetic
from toad_tpu_torch.data.wsi_dataset import PatientBagSplit, WSIBagDataset
from toad_tpu_torch.evaluate import calibration, engine
from toad_tpu_torch.evaluate.runner import batch_to_dict, make_eval_step
from toad_tpu_torch.models.interop import params_from_jax
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.ops import quantize
from toad_tpu_torch.utils.io import write_columns_csv, write_rows_csv

REPO = Path(__file__).resolve().parent.parent
D, N_CLS = 36, 18  # a width that is no multiple of 16: an int8 plane of the staging buffer ends anywhere
BUCKETS = (64, 128, 256)
TOL_INT8 = 0.02


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_eval")
    csv_path = root / "dummy.csv"
    manifest = synthetic.write_dummy_csv(csv_path, n_patients=14, max_slides_per_patient=2, seed=3)
    task = synthetic.dummy_task(str(csv_path))
    synthetic.write_dummy_bags(root / "bags", manifest, task, n_patches_range=(20, 250), dim=D, fmt="npy", seed=3)
    ds = WSIBagDataset(task, data_dir=str(root / "bags"))
    jds = JaxDataset(jax_config.TaskConfig(**dataclasses.asdict(task)), data_dir=str(root / "bags"))
    ids = np.arange(min(ds.n_slides, 20))
    return {"root": root, "task": task, "ds": ds, "jds": jds, "split": ds.subset(ids), "jax_split": jds.subset(ids)}


def _jax_params(seed=0, gate=True):
    cfg = jax_config.ModelConfig(in_dim=D, n_classes=N_CLS, gate=gate)
    params = jax.tree.map(np.asarray, JaxToadMIL(cfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for lin in (*params["trunk"].values(), *params["attn"].values(), params["cls_head"], params["site_head"]):
        lin["b"] = (rng.standard_normal(lin["b"].shape) * 0.05).astype(np.float32)
    return cfg, params


def _port_model(params, gate=True, **kw):
    model = ToadMIL(config.ModelConfig(in_dim=D, n_classes=N_CLS, gate=gate, **kw))
    model.load_state_dict(params_from_jax(params))
    return model.eval()


# -- calibration -----------------------------------------------------------------


def _seeded_probs(seed, n=120, c=7, sharp=3.0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, n)
    logits = rng.standard_normal((n, c)) * sharp
    logits[np.arange(n), labels] += 1.5  # some signal, so that the fitted T is inside the search bounds
    e = np.exp(logits - logits.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32), labels


def _members(seed, k=3):
    probs = [_seeded_probs(seed + i)[0] for i in range(k)]
    return np.stack(probs), _seeded_probs(seed)[1]


CALIBRATION_CASES = {
    "top_label_ece": lambda m: m.top_label_ece(*_seeded_probs(1), n_bins=10),
    "nll": lambda m: m.nll(*_seeded_probs(2)),
    "apply_temperature": lambda m: m.apply_temperature(_seeded_probs(3)[0], 1.7),
    "fit_temperature": lambda m: m.fit_temperature(*_seeded_probs(4)),
    "calibration_report": lambda m: m.calibration_report(*_seeded_probs(5), *_seeded_probs(6)),
    "calibration_report_at_the_bound": lambda m: m.calibration_report(*_seeded_probs(5, sharp=0.01), *_seeded_probs(6)),
    "apply_ensemble_temperature": lambda m: m.apply_ensemble_temperature(_members(7)[0], 0.6),
    "fit_ensemble_temperature": lambda m: m.fit_ensemble_temperature(*_members(8)),
    "ensemble_calibration_report": lambda m: m.ensemble_calibration_report(*_members(9), np.arange(120) % 3 == 0),
}


@pytest.mark.parametrize("name", list(CALIBRATION_CASES))
def test_calibration_matches_the_jax_package(name):
    got, want = CALIBRATION_CASES[name](calibration), CALIBRATION_CASES[name](jax_calibration)
    if isinstance(want, dict):
        assert list(got) == list(want)  # key by key, in the same order
        for key, v in want.items():
            if isinstance(v, str):
                assert got[key] == v
            else:
                assert abs(got[key] - v) <= (1e-9 if key == "temperature" else 1e-12), key
        assert ("warning" in want) == name.endswith("at_the_bound")
    elif isinstance(want, float):
        assert abs(got - want) <= (1e-9 if "fit" in name else 1e-12)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_calibration_refuses_what_the_jax_package_refuses():
    assert (calibration.T_SEARCH_LO, calibration.T_SEARCH_HI) == (jax_calibration.T_SEARCH_LO, jax_calibration.T_SEARCH_HI)
    members, labels = _members(1)
    with pytest.raises(ValueError, match="fit_mask selects no slides"):
        calibration.ensemble_calibration_report(members, labels, np.zeros(120, bool))
    with pytest.raises(ValueError, match=r"\[K, N, C\]"):
        calibration.apply_ensemble_temperature(members[0], 1.0)


# -- the int8 wire ---------------------------------------------------------------


@pytest.mark.parametrize("case", ["slides", "patient_bags", "max_bag_size", "batch_of_3"])
def test_int8_wire_matches_the_jax_batcher(env, case):
    split, jsplit = env["split"], env["jax_split"]
    kw = dict(batch_size=4, bucket_sizes=BUCKETS, mode="sequential", transfer_dtype="int8")
    if case == "patient_bags":
        split, jsplit = PatientBagSplit(split), JaxPatientBagSplit(jsplit)
    elif case == "max_bag_size":
        kw["max_bag_size"] = 100
    elif case == "batch_of_3":
        kw["batch_size"] = 3
    ours = list(batching.BagBatcher(split, **kw))
    theirs = list(jax_batching.BagBatcher(jsplit, native="off", **kw))
    assert len(ours) == len(theirs) >= 3
    for a, b in zip(ours, theirs):
        assert a.features.dtype == np.int8 and a.scales.dtype == np.float32
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.scales, b.scales)
        np.testing.assert_array_equal(a.patch_mask, b.patch_mask)
        np.testing.assert_array_equal(a.indices, b.indices)  # the batch order
        for f in ("bag_mask", "label", "site", "sex"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        pad = a.patch_mask == 0
        assert pad.any() and not a.features[pad].any()  # padding rows: q = 0 ...
        assert (a.scales[pad] == np.float32(1.0 / 127.0)).all()  # ... under the scale 1/127
        assert a.wire_bytes == a.features.size + 4 * a.scales.size + 4 * a.patch_mask.size
    # the rows that left the producer are the quantizer's, from the bag as stored
    first = ours[0]
    i = int(first.indices[0])
    bag = np.asarray(split.load_bag(i), np.float32)[: kw.get("max_bag_size")][: first.bucket]  # a bag over the top bucket is cut to it
    q, s = quantize.quantize_rows_np(bag)
    np.testing.assert_array_equal(first.features[0, : len(bag)], q)
    np.testing.assert_array_equal(first.scales[0, : len(bag)], s)


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_float_wires_are_unchanged(env, wire):
    kw = dict(batch_size=4, bucket_sizes=BUCKETS, mode="sequential", transfer_dtype=wire)
    ours = list(batching.BagBatcher(env["split"], **kw))
    theirs = list(jax_batching.BagBatcher(env["jax_split"], native="off", **kw))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.scales is None and b.scales is None
        feats = a.features.float().numpy() if isinstance(a.features, torch.Tensor) else a.features
        np.testing.assert_array_equal(feats, np.asarray(b.features, np.float32))
        np.testing.assert_array_equal(a.indices, b.indices)
        assert a.wire_bytes == a.features.shape[0] * a.bucket * (D * (4 if wire == "float32" else 2) + 4)


def test_batcher_names_its_three_wires(env):
    with pytest.raises(ValueError, match=r"float32, bfloat16, int8"):
        batching.BagBatcher(env["split"], transfer_dtype="float16")
    with pytest.raises(ValueError, match="resolve_transfer_dtype"):
        batching.BagBatcher(env["split"], transfer_dtype="auto")


@pytest.mark.parametrize("shape", [(3, 70, 36), (1, 1, 1), (4, 128, 1024), (2, 33, 7)])
def test_staging_buffer_planes_are_aligned_and_hold_the_batch(shape):
    """The host side of the device feed's pinned slot: int8 features, f32
    scales, f32 mask, each plane starting at a multiple of 16 bytes."""
    b, n, d = shape
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    scales = torch.from_numpy(rng.random((b, n)).astype(np.float32))
    mask = torch.from_numpy((rng.random((b, n)) < 0.5).astype(np.float32))
    planes = [(feats, torch.int8), (scales, torch.float32), (mask, torch.float32)]
    offsets, total = batching.plane_offsets([t.numel() * dt.itemsize for t, dt in planes])
    assert offsets[0] == 0 and all(o % 16 == 0 for o in offsets)
    assert all(offsets[i + 1] >= offsets[i] + planes[i][0].numel() * planes[i][1].itemsize for i in range(2))
    assert total == offsets[2] + mask.numel() * 4 and total < feats.numel() + 8 * b * n + 32
    buf = torch.empty(total, dtype=torch.uint8)
    staged = batching.stage_planes(buf, planes, offsets)
    for view, (t, dt) in zip(staged, planes):
        assert view.dtype == dt and view.shape == t.shape and view.is_contiguous()
        assert view.data_ptr() % 16 == buf.data_ptr() % 16  # as aligned as the buffer itself
        assert torch.equal(view, t)
    # a float plane is cast on the way in
    cast = batching.stage_planes(torch.empty(2 * b, dtype=torch.uint8), [(scales[:, :1], torch.bfloat16)], [0])
    assert cast[0].dtype == torch.bfloat16 and torch.equal(cast[0], scales[:, :1].bfloat16())


def test_device_feed_guard_counts_the_wire_s_bytes():
    """An int8 batch four times as long as the largest f32 batch that goes
    ahead of the step still goes ahead."""

    class Feed(batching._DeviceFeed):
        def __init__(self, dtype):  # no stream: only the guard is exercised
            self.dtype = dtype

        def _slot(self, nbytes):
            raise RuntimeError(f"placed {nbytes}")

    n = batching._DeviceFeed.MAX_BYTES // (4 * 4)  # B=4 rows x D=1: f32 at the limit
    b8 = batching.BagBatch(np.zeros((4, 4 * n, 1), np.int8), np.zeros((4, 4 * n), np.float32), *[np.zeros(4)] * 5,
                           scales=np.zeros((4, 4 * n), np.float32))
    with pytest.raises(RuntimeError, match="placed"):
        Feed(torch.int8).place(b8)
    b32 = batching.BagBatch(np.zeros((4, 4 * n, 1), np.float32), np.zeros((4, 4 * n), np.float32), *[np.zeros(4)] * 5)
    assert Feed(torch.float32).place(b32) is b32  # over the limit: left on the host


# -- the int8 eval step ----------------------------------------------------------


def _numpy_batch(seed=0, b=4, n=96):
    rng = np.random.default_rng(seed)
    mask = np.zeros((b, n), np.float32)
    for i in range(b):
        mask[i, : rng.integers(n // 3, n + 1)] = 1.0  # trailing padding, as the batcher pads
    feats = rng.standard_normal((b, n, D)).astype(np.float32) * mask[..., None]
    return {
        "features": feats,
        "patch_mask": mask,
        "bag_mask": np.ones((b,), np.float32),
        "label": rng.integers(0, N_CLS, (b,)).astype(np.int32),
        "site": rng.integers(0, 2, (b,)).astype(np.int32),
        "sex": rng.integers(0, 2, (b,)).astype(np.int32),
    }


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["label"], out["site"] = out["label"].long(), out["site"].long()
    return out


def _wire_batch(batch):
    b, n, d = batch["features"].shape
    q, s = quantize.quantize_rows_np(batch["features"].reshape(b * n, d))
    return dict(batch, features=q.reshape(b, n, d), scales=s.reshape(b, n))


def test_device_and_host_quantizers_are_exact_twins():
    x = _numpy_batch(5)["features"]
    x[0, 3] = 0.0  # an all-zero live row takes the floor scale
    q, s = quantize.quantize_rows(torch.from_numpy(x))
    qn, sn = quantize.quantize_rows_np(x.reshape(-1, D))
    np.testing.assert_array_equal(q.numpy().reshape(-1, D), qn)
    np.testing.assert_array_equal(s.numpy().ravel(), sn)
    jq, js = jax_quantize.quantize_rows_np(x.reshape(-1, D))
    np.testing.assert_array_equal(qn, jq)
    np.testing.assert_array_equal(sn, js)


def test_int8_step_from_the_wire_equals_device_quantization():
    _, params = _jax_params(1)
    step = make_eval_step(_port_model(params), int8=True)
    batch = _numpy_batch(1)
    on_device = step(_torch_batch(batch))
    from_wire = step(_torch_batch(_wire_batch(batch)))
    assert set(on_device) == {"y_prob", "y_hat", "site_prob", "site_hat", "cls_ce", "site_ce"}
    # the same integers go into the same forward; 1e-6 and not bit equality, because a CPU f32 product may
    # round its last bit differently from call to call (its blocking follows the operands' alignment)
    for k in on_device:
        torch.testing.assert_close(on_device[k], from_wire[k], atol=1e-6, rtol=0, msg=k)


@pytest.mark.parametrize("wire", [False, True])
def test_int8_step_against_the_jax_step_and_the_float_step(wire):
    cfg, params = _jax_params(2)
    model = _port_model(params)
    batch = _numpy_batch(2)
    fed = _wire_batch(batch) if wire else batch
    got = make_eval_step(model, int8=True)(_torch_batch(fed))
    jparams = jax.tree.map(jnp.asarray, params)
    want = jax_runner.make_eval_step(JaxToadMIL(cfg), int8=True, params=jparams)(jparams, {k: jnp.asarray(v) for k, v in fed.items()})
    flt = make_eval_step(model)(_torch_batch(batch))
    for k in ("y_prob", "site_prob"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=TOL_INT8)
        np.testing.assert_allclose(got[k].numpy(), flt[k].numpy(), atol=TOL_INT8)
        assert not torch.equal(got[k], flt[k])  # it is the quantized forward
        np.testing.assert_allclose(got[k].sum(-1).numpy(), 1.0, atol=1e-5)


def test_int8_step_refuses_an_ungated_model_when_it_is_built():
    cfg, params = _jax_params(3, gate=False)
    with pytest.raises(ValueError, match="gated attention variant only"):
        make_eval_step(_port_model(params, gate=False), int8=True)
    with pytest.raises(ValueError, match="gated"):  # as the JAX package, at build
        jax_runner.make_eval_step(JaxToadMIL(cfg), int8=True, params=params)
    make_eval_step(_port_model(params, gate=False))  # the float step takes it


def test_int8_step_follows_a_second_checkpoint_loaded_into_the_model():
    """The JAX step pins the params object its quantized weights came from;
    the port's model re-quantizes when a weight changes, so one step serves
    every checkpoint loaded into its model."""
    _, first = _jax_params(4)
    _, second = _jax_params(5)
    model = _port_model(first)
    step = make_eval_step(model, int8=True)
    batch = _torch_batch(_numpy_batch(4))
    before = step(batch)["y_prob"].clone()
    model.load_state_dict(params_from_jax(second))
    after = step(batch)["y_prob"]
    assert (after - before).abs().max() > 1e-3
    fresh = make_eval_step(_port_model(second), int8=True)(batch)["y_prob"]
    torch.testing.assert_close(after, fresh, atol=1e-6, rtol=0)


def test_batch_to_dict_passes_the_scales_of_the_int8_wire(env):
    b8 = next(iter(batching.BagBatcher(env["split"], batch_size=2, bucket_sizes=BUCKETS, transfer_dtype="int8", prefetch=0)))
    d8 = batch_to_dict(b8, "cpu")
    assert d8["features"].dtype == torch.int8 and d8["scales"].dtype == torch.float32 and d8["scales"].shape == d8["patch_mask"].shape
    b32 = next(iter(batching.BagBatcher(env["split"], batch_size=2, bucket_sizes=BUCKETS, prefetch=0)))
    assert "scales" not in batch_to_dict(b32, "cpu")


def test_trainer_refuses_the_int8_wire_with_the_jax_trainer_s_words(env, tmp_path):
    from toad_tpu.train import loop as jax_loop
    from toad_tpu_torch.train.loop import FoldTrainer

    def cfg(module):
        return module.TrainConfig(max_epochs=1, model=module.ModelConfig(in_dim=D, n_classes=N_CLS),
                                  data=module.DataConfig(batch_size=4, bucket_sizes=BUCKETS, transfer_dtype="int8"))

    with pytest.raises(ValueError) as ours:
        FoldTrainer(cfg(config), 0, tmp_path / "port", device="cpu").train(env["split"], env["split"], env["split"], log_fn=lambda s: None)
    with pytest.raises(ValueError) as theirs:
        jax_loop.FoldTrainer(cfg(jax_config), 0, tmp_path / "jax")._batcher(env["jax_split"], training=True)
    assert str(ours.value) == str(theirs.value) and "eval-only" in str(ours.value)


# -- the engine ------------------------------------------------------------------


def _both_engines(env, seed=0, split=None, jax_split=None, **kw):
    cfg, params = _jax_params(seed)
    split = env["split"] if split is None else split
    jax_split = env["jax_split"] if jax_split is None else jax_split
    kw = {"batch_size": 4, "bucket_sizes": BUCKETS, **kw}
    got = engine.evaluate_split(_port_model(params), split, device="cpu", **kw)
    want = jax_engine.evaluate_split(JaxToadMIL(cfg), jax.tree.map(jnp.asarray, params), jax_split, **kw)
    return got, want


def _assert_results_agree(got, want, prob_tol=1e-5, auc_tol=1e-6):
    assert list(got.df) == list(want.df.columns)
    for col in want.df.columns:
        ours, theirs = got.df[col], want.df[col].to_numpy()
        if col.startswith("p_") or col == "site_p":
            assert ours.dtype == theirs.dtype == np.float32
            np.testing.assert_allclose(ours, theirs, atol=prob_tol, rtol=0)
        elif col == "slide_id":
            assert list(ours) == list(theirs)  # the split's order
        else:
            assert ours.dtype.kind == theirs.dtype.kind, col  # float64 labels, integer predictions
            np.testing.assert_array_equal(ours, theirs)
    assert abs(got.cls_auc - want.cls_auc) <= auc_tol and abs(got.site_auc - want.site_auc) <= auc_tol
    np.testing.assert_allclose(got.cls_aucs, want.cls_aucs, atol=auc_tol, rtol=0)
    assert got.topk == want.topk and got.cls_error == want.cls_error and got.site_error == want.site_error
    assert got.cls_acc == want.cls_acc and got.site_acc == want.site_acc
    assert list(got.patient_results) == list(want.patient_results)


@pytest.mark.parametrize("kw", [{}, {"micro_average": True}, {"max_bag_size": 90}, {"batch_size": 3, "bucket_sizes": (128, 384)}],
                         ids=["macro", "micro", "max_bag_size", "odd_batch_and_128_multiples"])
def test_evaluate_split_matches_the_jax_engine(env, kw):
    got, want = _both_engines(env, seed=1, **kw)
    _assert_results_agree(got, want)
    assert list(got.df["slide_id"]) == list(env["split"].slide_ids)
    assert set(got.topk) == {1, 3, 5} and got.stats["transfer_dtype"] == "float32"
    assert got.stats["n"] == len(env["split"]) and got.stats["n_batches"] >= 5
    assert 0.0 <= got.stats["data_wait_s"] <= got.stats["seconds"]


def test_evaluate_split_on_patient_bags_matches_the_jax_engine(env):
    got, want = _both_engines(env, seed=2, split=PatientBagSplit(env["split"]), jax_split=JaxPatientBagSplit(env["jax_split"]))
    _assert_results_agree(got, want)
    assert len(got.df["slide_id"]) == len(np.unique(env["split"].case_ids)) < len(env["split"])


def test_one_class_split_gives_the_sentinels(env):
    ds, jds = env["ds"], env["jds"]
    label = int(np.bincount(ds.labels).argmax())
    ids = np.where((ds.labels == label) & (ds.sites == ds.sites[ds.labels == label][0]))[0]
    got, want = _both_engines(env, split=ds.subset(ids), jax_split=jds.subset(ids))
    assert got.cls_auc == want.cls_auc == -1.0 and got.site_auc == want.site_auc == -1.0
    assert len(got.cls_aucs) == 0
    _assert_results_agree(got, want)


@pytest.mark.parametrize("n_classes,ks", [(2, (1,)), (4, (1, 3)), (5, (1, 3)), (6, (1, 3, 5)), (18, (1, 3, 5))])
def test_topk_ladder(n_classes, ks):
    assert engine.topk_ladder(n_classes) == ks


@pytest.mark.parametrize("kw", [dict(transfer_dtype="int8"), dict(transfer_dtype="int8", int8=True, eval_step="float")],
                         ids=["without_int8", "with_a_caller_s_step"])
def test_int8_wire_needs_an_engine_built_int8_step(env, kw):
    cfg, params = _jax_params()
    model = _port_model(params)
    jkw = dict(kw)
    if kw.get("eval_step"):
        kw = dict(kw, eval_step=make_eval_step(model))
        jkw = dict(jkw, eval_step=jax_runner.make_eval_step(JaxToadMIL(cfg)))
    with pytest.raises(ValueError) as ours:
        engine.evaluate_split(model, env["split"], **kw)
    with pytest.raises(ValueError) as theirs:
        jax_engine.evaluate_split(JaxToadMIL(cfg), params, env["jax_split"], **jkw)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("asked,int8,own_step,wire", [
    ("auto", True, True, "int8"), ("bfloat16", True, True, "int8"), ("float32", True, True, "float32"),
    ("int8", True, True, "int8"), ("auto", True, False, "float32"), ("auto", False, True, "float32"),
    ("bfloat16", False, True, "bfloat16"),
])
def test_engine_picks_the_wire_as_the_jax_engine_does(env, monkeypatch, asked, int8, own_step, wire):
    seen = {}
    orig_init = batching.BagBatcher.__init__

    def spy(self, *a, **kw):
        orig_init(self, *a, **kw)
        seen["transfer_dtype"] = self.transfer_dtype

    monkeypatch.setattr(batching.BagBatcher, "__init__", spy)
    _, params = _jax_params()
    model = _port_model(params)
    res = engine.evaluate_split(model, env["split"].parent.subset(range(6)), batch_size=4, bucket_sizes=BUCKETS, int8=int8,
                                transfer_dtype=asked, eval_step=None if own_step else make_eval_step(model))
    assert seen["transfer_dtype"] == wire == res.stats["transfer_dtype"]


def test_evaluate_split_int8_wire_and_device_quantization_agree(env):
    _, params = _jax_params(3)
    kw = dict(batch_size=4, bucket_sizes=BUCKETS, int8=True)
    wire = engine.evaluate_split(_port_model(params), env["split"], **kw)
    dev = engine.evaluate_split(_port_model(params), env["split"], transfer_dtype="float32", **kw)
    flt = engine.evaluate_split(_port_model(params), env["split"], batch_size=4, bucket_sizes=BUCKETS)
    np.testing.assert_allclose(wire.probs(), dev.probs(), atol=1e-6, rtol=0)  # exact twins feed the same forward
    np.testing.assert_allclose(wire.probs(), flt.probs(), atol=TOL_INT8)
    # a quarter of the feature bytes, plus the scales: (4 D + 4) / (D + 8) per row, 3.97 at D = 1024
    assert dev.stats["wire_bytes"] * (D + 8) == wire.stats["wire_bytes"] * (4 * D + 4)
    cfg, _ = _jax_params(3)
    want = jax_engine.evaluate_split(JaxToadMIL(cfg), jax.tree.map(jnp.asarray, params), env["jax_split"], **kw)
    np.testing.assert_allclose(wire.probs(), want.df[[f"p_{c}" for c in range(N_CLS)]].to_numpy(), atol=TOL_INT8)


def test_bootstrap_cis_of_a_result_match_the_jax_engine(env):
    got, want = _both_engines(env, seed=4)
    want.df = pd.DataFrame(got.df)  # the same per-slide table on both sides
    ours = engine.bootstrap_result_cis(got, N_CLS, n_boot=40, seed=3)
    theirs = jax_engine.bootstrap_result_cis(want, N_CLS, n_boot=40, seed=3)
    assert ours == theirs and set(ours) == {"cls_auc", "cls_acc", "cls_top3_acc", "site_auc"}


def test_evaluate_checkpoint_reads_the_trainer_s_file_and_needs_a_device(env, tmp_path):
    from toad_tpu_torch.models.interop import reference_state_dict
    from toad_tpu_torch.train.checkpoint import save_checkpoint

    _, params = _jax_params(6)
    model = _port_model(params)
    save_checkpoint(tmp_path / "s_0_checkpoint.pt", reference_state_dict(model.state_dict(), dropout=False))
    kw = dict(batch_size=4, bucket_sizes=BUCKETS)
    res = engine.evaluate_checkpoint(tmp_path / "s_0_checkpoint", env["split"], model.config, device="cpu", **kw)
    np.testing.assert_allclose(res.probs(), engine.evaluate_split(model, env["split"], **kw).probs(), atol=1e-6, rtol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine.evaluate_checkpoint(tmp_path / "s_0_checkpoint.pt", env["split"], model.config, **kw)
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(ValueError, match="python -m toad_tpu export"):
        engine.evaluate_checkpoint(tmp_path / "orbax_dir", env["split"], model.config, device="cpu")
    assert set(evaluate.__all__) == set(__import__("toad_tpu.evaluate").evaluate.__all__)


# -- the writers -----------------------------------------------------------------


@pytest.fixture
def csv_pair(tmp_path):
    return tmp_path / "ours.csv", tmp_path / "theirs.csv"


@pytest.mark.parametrize("case", ["per_slide", "summary", "summary_with_ensemble_row", "confusion", "aggregate"])
def test_writers_give_the_bytes_pandas_gives(csv_pair, case):
    ours, theirs = csv_pair
    rng = np.random.default_rng(0)
    n = 200
    if case == "per_slide":
        cols = {
            "slide_id": np.array([f"slide_{i}" for i in range(n)]),
            "Y": rng.integers(0, 18, n).astype(np.float64),
            "Y_hat": rng.integers(0, 18, n),
            "site_hat": rng.integers(0, 2, n).astype(np.int32),
            "p_0": (rng.random(n) * 10.0 ** rng.integers(-12, 1, n)).astype(np.float32),
            "p_1": rng.random(n).astype(np.float32),
            "wide": rng.random(n) * 10.0 ** rng.integers(-20, 20, n),
        }
        cols["slide_id"][:3] = ["with,comma", 'with"quote', "0042"]
        cols["p_1"][:4] = [np.nan, 0.0, 1.0, 1e-5]
        cols["wide"][:3] = [np.nan, -1.0, 1e16]
        write_columns_csv(ours, cols)
        pd.DataFrame(cols).to_csv(theirs, index=False)
    elif case in ("summary", "summary_with_ensemble_row"):
        rows = [{"folds": i, "cls_test_auc": float(rng.random()), "cls_test_acc": 1 / 3, "cls_top5_acc": float("nan"),
                 "site_test_auc": -1.0, "cls_auc_ci_lo": 1e-5 * i} for i in range(3)]
        if case.endswith("ensemble_row"):  # no CI columns: empty cells; folds becomes a column of strings
            rows.append({"folds": "ensemble", "cls_test_auc": 0.5, "cls_test_acc": 0.25, "cls_top5_acc": float("nan"),
                         "site_test_auc": 0.75})
        write_rows_csv(ours, rows)
        pd.DataFrame(rows).to_csv(theirs)
    elif case == "confusion":
        names = ["Lung", "Breast, NOS", "Head & Neck"]
        cm = rng.integers(0, 50, (3, 3))
        write_columns_csv(ours, {name: cm[:, j] for j, name in enumerate(names)}, index=names)
        pd.DataFrame(cm, index=names, columns=names).to_csv(theirs)
    else:
        agg = [{"metric": "cls_test_auc", "mean": 0.1 + 0.2, "std": 0.0, "min": 1e-7, "max": 1.0, "n": 3}]
        write_columns_csv(ours, {k: [r[k] for r in agg] for k in agg[0]})
        pd.DataFrame(agg).to_csv(theirs, index=False)
    assert ours.read_bytes() == theirs.read_bytes()


# -- the CLIs --------------------------------------------------------------------

CLI_D = 32
TASK = "tasks/dummy_mtl_concat.json"


def _cli(*args, cwd):
    return subprocess.run([sys.executable, "-m", "toad_tpu_torch", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=600, env={**os.environ, "PYTHONPATH": str(REPO)})


def _eval_args(*extra, k="2"):
    return ["--task", TASK, "--data_root_dir", "bags", "--models_exp_code", "demo_s1", "--k", k, "--batch_size", "4",
            "--encoding_size", str(CLI_D), "--buckets", "128,256", *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """make-dummy -> create-splits -> train through the dispatcher, on the CPU, two folds."""
    root = tmp_path_factory.mktemp("port_eval_cli")
    for args in (
        ("make-dummy", "--out_dir", ".", "--n_patients", "40", "--max_slides_per_patient", "2", "--dim", str(CLI_D),
         "--min_patches", "20", "--max_patches", "200"),
        ("create-splits", "--task", TASK, "--k", "2", "--val_frac", "0.34", "--test_frac", "0.34"),
        ("train", "--task", TASK, "--data_root_dir", "bags", "--exp_code", "demo", "--k", "2", "--max_epochs", "2",
         "--batch_size", "4", "--encoding_size", str(CLI_D), "--buckets", "128,256", "--lr", "1e-3", "--device", "cpu"),
    ):
        run = _cli(*args, cwd=root)
        assert run.returncode == 0, run.stderr[-3000:]
    return root


@pytest.fixture(scope="module")
def evaluated(trained):
    """``eval`` on the test split by the port's CLI (a child process) and by
    the JAX CLI (in this process), on the port's checkpoints."""
    from toad_tpu.cli import evaluate as jax_evaluate

    run = _cli("eval", *_eval_args("--save_exp_code", "port", "--device", "cpu"), cwd=trained)
    assert run.returncode == 0, run.stderr[-3000:]
    cwd = os.getcwd()
    os.chdir(trained)
    try:
        jax_evaluate.main(_eval_args("--save_exp_code", "jax"))
    finally:
        os.chdir(cwd)
    return trained, run


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _assert_cells_agree(ours: Path, theirs: Path, float_cols, tol):
    a, b = _read_csv(ours), _read_csv(theirs)
    assert a[0] == b[0] and len(a) == len(b) > 1
    for row_a, row_b in zip(a[1:], b[1:]):
        for name, x, y in zip(a[0], row_a, row_b):
            if name in float_cols(name) and x != "" and y != "":
                assert abs(float(x) - float(y)) <= tol, (ours.name, name, x, y)
            else:
                assert x == y, (ours.name, name, x, y)


def _assert_json_agrees(ours: Path, theirs: Path, tol, interval_tol):
    """Same keys in the same order; strings and integers equal; floats
    within ``tol`` relative to max(1, |value|), those of a nested dict (a
    metric's interval) within ``interval_tol``."""
    a, b = json.loads(ours.read_text()), json.loads(theirs.read_text())
    assert list(a) == list(b)
    for key in a:
        if isinstance(a[key], dict):
            assert list(a[key]) == list(b[key])
            for k2 in a[key]:
                assert abs(a[key][k2] - b[key][k2]) <= interval_tol, (ours.name, key, k2)
        elif isinstance(a[key], (str, int)):
            assert a[key] == b[key], (ours.name, key)
        else:
            assert abs(a[key] - b[key]) <= tol * max(1.0, abs(b[key])), (ours.name, key)


def _prob_cols(name):
    return {name} if name.startswith("p_") or name == "site_p" else set()


def _metric_cols(name):
    return set() if name in ("", "folds") else {name}


def test_cli_eval_agrees_with_the_jax_cli_cell_by_cell(evaluated):
    root, run = evaluated
    ours, theirs = root / "eval_results" / "EVAL_port", root / "eval_results" / "EVAL_jax"
    assert {p.name for p in ours.iterdir()} == {p.name.replace("_jax", "_port") for p in theirs.iterdir()} == {
        "eval_experiment_port.txt", "fold_0.csv", "fold_1.csv", "fold_0_confusion.csv", "fold_1_confusion.csv", "summary.csv"}
    for fold in (0, 1):
        _assert_cells_agree(ours / f"fold_{fold}.csv", theirs / f"fold_{fold}.csv", _prob_cols, 1e-5)
        assert (ours / f"fold_{fold}_confusion.csv").read_bytes() == (theirs / f"fold_{fold}_confusion.csv").read_bytes()
    _assert_cells_agree(ours / "summary.csv", theirs / "summary.csv", _metric_cols, 1e-6)
    assert (ours / "eval_experiment_port.txt").read_text().replace("port", "jax") == (theirs / "eval_experiment_jax.txt").read_text()
    header = _read_csv(ours / "fold_0.csv")[0]
    assert header == ["slide_id", "sex", "Y", "Y_hat", "site", "site_hat", *[f"p_{c}" for c in range(18)], "site_p"]


def test_cli_eval_reproduces_the_trainer_s_summary(evaluated):
    root, run = evaluated
    train_rows = list(csv.DictReader(open(root / "results" / "demo_s1" / "summary.csv", newline="")))
    eval_rows = list(csv.DictReader(open(root / "eval_results" / "EVAL_port" / "summary.csv", newline="")))
    assert [r["folds"] for r in eval_rows] == ["0", "1"]
    for t, e in zip(train_rows, eval_rows):
        for key in ("cls_test_auc", "cls_test_acc", "site_test_auc", "site_test_acc"):
            assert abs(float(t[key]) - float(e[key])) < 1e-9, key
    test_ids = [r[3] for r in _read_csv(root / "results" / "demo_s1" / "splits_0.csv")[1:] if r[3]]
    assert [r[0] for r in _read_csv(root / "eval_results" / "EVAL_port" / "fold_0.csv")[1:]] == test_ids  # split order


def test_cli_eval_prints_batches_launches_rate_and_wire(evaluated):
    import re

    _, run = evaluated
    for fold in (0, 1):
        m = re.search(rf"\[fold {fold}\] eval batches (\d+), pooling kernel launches 0 \(float kernel 0, int8 kernel 0\)", run.stdout)
        assert m and int(m.group(1)) >= 2
        assert re.search(rf"\[fold {fold}\] eval pass: \d+ bags in \S+ s, \S+ slides/s \(data wait \d+%\), wire float32, "
                         r"\d+ bytes to the device", run.stdout)
    assert "wrote eval_results/EVAL_port/summary.csv" in run.stdout


@pytest.fixture(scope="module")
def ensemble_run(trained):
    run = _cli("eval", *_eval_args("--split", "all", "--ensemble", "--calibrate", "--bootstrap", "50", "--device", "cpu",
                                   "--save_exp_code", "port_all"), cwd=trained)
    assert run.returncode == 0, run.stderr[-3000:]
    return trained / "eval_results" / "EVAL_port_all", run


def test_cli_eval_all_ensemble_calibrate_bootstrap(trained, ensemble_run):
    from toad_tpu.cli import evaluate as jax_evaluate

    ours, run = ensemble_run
    cwd = os.getcwd()
    os.chdir(trained)
    try:
        jax_evaluate.main(_eval_args("--split", "all", "--ensemble", "--calibrate", "--bootstrap", "50", "--save_exp_code", "jax_all"))
    finally:
        os.chdir(cwd)
    theirs = trained / "eval_results" / "EVAL_jax_all"
    assert {p.name for p in ours.iterdir()} == {p.name.replace("jax_all", "port_all") for p in theirs.iterdir()}
    assert {"ensemble.csv", "ensemble_calibration.json", "fold_0_calibration.json", "fold_1_ci.json"} <= {p.name for p in ours.iterdir()}
    for name in ("fold_0.csv", "fold_1.csv", "ensemble.csv"):
        _assert_cells_agree(ours / name, theirs / name, _prob_cols, 1e-5)
    _assert_cells_agree(ours / "summary.csv", theirs / "summary.csv", _metric_cols, 1e-6)
    rows = _read_csv(ours / "summary.csv")
    assert [r[1] for r in rows[1:]] == ["0", "1", "ensemble"] and rows[3][-1] == "" and rows[1][-1] != ""  # no CI for the ensemble
    for name in ("fold_0_calibration.json", "fold_1_calibration.json", "ensemble_calibration.json", "fold_0_ci.json", "fold_1_ci.json"):
        _assert_json_agrees(ours / name, theirs / name, 1e-3, 1e-6)
    assert "] val pass:" in run.stdout and "ensemble (2 folds)" in run.stdout and "fit on" in run.stdout


def test_cli_eval_writers_are_byte_equal_on_the_same_pass_results(trained, monkeypatch):
    """Both CLIs in this process, the JAX engine's pass replaced by the
    port's arrays: every CSV byte for byte, every JSON equal."""
    from toad_tpu.cli import evaluate as jax_evaluate
    from toad_tpu_torch.cli import evaluate as port_evaluate

    passes = []
    real_pass = engine.run_eval_pass

    def recording(*a, **kw):
        passes.append(real_pass(*a, **kw))
        return passes[-1]

    monkeypatch.chdir(trained)
    monkeypatch.setattr(engine, "run_eval_pass", recording)
    flags = ["--split", "all", "--ensemble", "--calibrate", "--bootstrap", "20"]
    port_evaluate.main(_eval_args(*flags, "--save_exp_code", "same_port", "--device", "cpu"))
    assert len(passes) == 4  # per fold: the split, then its val split
    replay = iter(passes)
    monkeypatch.setattr(jax_engine, "run_eval_pass", lambda *a, **kw: next(replay))
    jax_evaluate.main(_eval_args(*flags, "--save_exp_code", "same_jax"))
    ours, theirs = trained / "eval_results" / "EVAL_same_port", trained / "eval_results" / "EVAL_same_jax"
    names = sorted(p.name for p in ours.iterdir() if not p.name.startswith("eval_experiment"))
    assert names == sorted(p.name for p in theirs.iterdir() if not p.name.startswith("eval_experiment")) and len(names) == 11
    for name in names:
        if name.endswith(".csv"):
            assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
        else:  # numpy sums pandas' column-major blocks in another order: the last digit of a float may differ
            _assert_json_agrees(ours / name, theirs / name, 1e-12, 1e-12)


@pytest.mark.parametrize("flags,name", [
    (["--fold", "1"], "summary_partial_1_1.csv"), (["--k_start", "0", "--k_end", "1"], "summary_partial_0_0.csv"),
    (["--k_start", "1", "--k_end", "2", "--split", "val", "--calibrate", "--micro_average"], "summary_partial_1_1.csv"),
])
def test_cli_eval_fold_windows(trained, flags, name):
    code = "win_" + "_".join(f.strip("-") for f in flags)
    run = _cli("eval", *_eval_args(*flags, "--save_exp_code", code, "--device", "cpu", "--pallas"), cwd=trained)
    assert run.returncode == 0, run.stderr[-3000:]
    out = trained / "eval_results" / f"EVAL_{code}"
    assert (out / name).exists() and not (out / "summary.csv").exists()
    assert len(_read_csv(out / name)) == 2
    assert "--pallas has no effect" in run.stderr and run.stderr.count("--pallas") == 1
    if "--calibrate" in flags:
        rep = json.loads((out / "fold_1_calibration.json").read_text())
        assert rep["note"].startswith("evaluated split IS the calibration split") and "] val pass" not in run.stdout


ALT_RUNS = {
    "int8": (["--int8"], "int8"),
    "int8_quantized_on_the_device": (["--int8", "--transfer_dtype", "float32"], "float32"),
    "bf16": (["--bf16"], "bfloat16"),
    "int8_patient_bags": (["--int8", "--patient_bags", "--buckets", "auto"], "int8"),
}


@pytest.fixture(scope="module")
def alt_runs(evaluated):
    root, _ = evaluated
    runs = {}
    for code, (flags, _) in ALT_RUNS.items():
        runs[code] = _cli("eval", *_eval_args(*flags, "--save_exp_code", code, "--device", "cpu", "--fold", "0"), cwd=root)
        assert runs[code].returncode == 0, runs[code].stderr[-3000:]
    return root, runs


@pytest.mark.parametrize("code", list(ALT_RUNS))
def test_cli_eval_int8_bf16_and_patient_bags(alt_runs, code):
    root, runs = alt_runs
    run, wire = runs[code], ALT_RUNS[code][1]
    assert f"wire {wire}," in run.stdout
    rows = _read_csv(root / "eval_results" / f"EVAL_{code}" / "fold_0.csv")
    base = _read_csv(root / "eval_results" / "EVAL_port" / "fold_0.csv")
    if "patient_bags" in code:
        assert "auto bucket ladder" in run.stdout and 1 < len(rows) <= len(base)
        return
    assert [r[0] for r in rows] == [r[0] for r in base]
    p = np.array([[float(v) for v in r[6:]] for r in rows[1:]])
    q = np.array([[float(v) for v in r[6:]] for r in base[1:]])
    np.testing.assert_allclose(p, q, atol=TOL_INT8)
    assert not np.array_equal(p, q)


def test_cli_eval_int8_wire_equals_device_quantization(alt_runs):
    root, _ = alt_runs
    a = root / "eval_results" / "EVAL_int8" / "fold_0.csv"
    b = root / "eval_results" / "EVAL_int8_quantized_on_the_device" / "fold_0.csv"
    _assert_cells_agree(a, b, _prob_cols, 1e-6)  # two processes: the last digit of a CPU f32 product may differ


@pytest.mark.parametrize("flags,says", [
    (["--fold_devices", "2"], "--fold_devices is not ported to this package: multi-GPU (ROADMAP.md queue 1.7)"),
    (["--fold_devices", "-1"], "--fold_devices is not ported"),
    (["--ensemble"], "--ensemble requires --split all"),
    (["--ensemble", "--split", "all", "--fold", "0"], "at least two folds"),
    (["--k_start", "1", "--k_end", "1"], "empty fold window"),
    (["--transfer_dtype", "int8"], "requires int8=True"),
])
def test_cli_eval_refusals(trained, flags, says):
    run = _cli("eval", *_eval_args(*flags, "--device", "cpu"), cwd=trained)
    assert run.returncode != 0 and says in run.stderr, run.stderr[-2000:]


def test_cli_eval_checks_the_val_union_before_the_first_fold(trained):
    """--ensemble --calibrate with split files whose val slides are not among
    the scored ones: the JAX CLI raises a bare ValueError after every fold
    has run; the port exits before the first, with guidance."""
    other = trained / "other_splits"
    other.mkdir(exist_ok=True)
    for fold in (0, 1):
        (other / f"splits_{fold}.csv").write_text(",train,val,test\n0,a,not_a_slide,c\n")
    run = _cli("eval", *_eval_args("--split", "all", "--ensemble", "--calibrate", "--splits_dir", "other_splits", "--device", "cpu",
                                   "--save_exp_code", "no_union"), cwd=trained)
    assert run.returncode != 0 and "pass --splits_dir" in run.stderr and "none of the" in run.stderr
    assert "cls_auc" not in run.stdout and not (trained / "eval_results" / "EVAL_no_union" / "fold_0.csv").exists()
    missing = _cli("eval", *_eval_args("--split", "all", "--ensemble", "--calibrate", "--splits_dir", "nowhere", "--device", "cpu"),
                   cwd=trained)
    assert missing.returncode != 0 and "does not exist (pass --splits_dir)" in missing.stderr and "cls_auc" not in missing.stdout


def test_cli_eval_needs_the_card_unless_the_cpu_is_asked_for(trained):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    run = _cli("eval", *_eval_args("--save_exp_code", "no_card"), cwd=trained)
    assert run.returncode != 0 and "pass --device cpu" in run.stderr
    assert not (trained / "eval_results" / "EVAL_no_card").exists()  # refused before anything is written
    assert _cli("eval", "--help", cwd=trained).returncode == 0


@pytest.mark.parametrize("which", ["eval_dir", "eval_dir_with_ensemble_and_cis", "train_dir"])
def test_cli_report_matches_the_jax_cli(trained, evaluated, ensemble_run, which, capsys, tmp_path):
    from toad_tpu.cli import report as jax_report

    d = {"eval_dir": "eval_results/EVAL_port", "eval_dir_with_ensemble_and_cis": "eval_results/EVAL_port_all",
         "train_dir": "results/demo_s1"}[which]
    run = _cli("report", "--dir", d, "--out", str(tmp_path / "ours.csv"), cwd=trained)
    assert run.returncode == 0, run.stderr
    cwd = os.getcwd()
    os.chdir(trained)
    try:
        capsys.readouterr()
        assert jax_report.main(["--dir", d, "--out", str(tmp_path / "theirs.csv")]) == 0
        theirs = capsys.readouterr().out
    finally:
        os.chdir(cwd)
    # the same table; the last JSON line and --out key by key to 1e-12: pandas' default float parser is not
    # correctly rounded (a cell may come back changed in its last digits), the port reads each cell exactly
    ours_lines, their_lines = run.stdout.splitlines(), theirs.splitlines()
    assert ours_lines[:-2] == their_lines[:-2] and len(ours_lines) > 8
    last, jlast = json.loads(ours_lines[-1]), json.loads(their_lines[-1])
    assert list(last) == list(jlast) and last["dir"] == jlast["dir"] == d
    for key in last:
        if key != "dir":
            assert abs(last[key] - jlast[key]) <= 1e-12 * max(1.0, abs(jlast[key])), key
    assert last["n_folds"] == (3 if "ensemble" in which else 2) and "cls_test_auc_mean" in last
    assert ("calibration_temperature_mean" in last) == ("ensemble" in which)
    _assert_cells_agree(tmp_path / "ours.csv", tmp_path / "theirs.csv", lambda name: set() if name in ("metric", "n") else {name}, 1e-12)


def test_cli_report_reads_cells_as_pandas_does(tmp_path):
    from toad_tpu.cli import report as jax_report
    from toad_tpu_torch.cli import report

    (tmp_path / "summary_partial_0_2.csv").write_text(
        ",folds,auc,acc,empty,text,Unnamed: 7\n0,0,0.5,1,,a,1\n1,1,,0,,b,2\n2,ensemble,nan,1,,c,3\n3,3,-1.0,NA,,d,4\n")
    ours, flat = report.aggregate(tmp_path)
    theirs, jflat = jax_report.aggregate(tmp_path)
    assert flat == jflat and flat["n_folds"] == 4 and set(flat) == {"n_folds", "dir", "auc_mean", "acc_mean"}
    assert ours == theirs.to_dict("records")  # cells that any parser reads exactly
    assert report.numeric_column(["1", "x"]) is None
    with pytest.raises(FileNotFoundError, match="no summary"):
        report.aggregate(tmp_path / "nowhere")


@pytest.mark.parametrize("broken", [False, True])
def test_cli_validate_matches_the_jax_cli(trained, capsys, broken, tmp_path):
    from toad_tpu.cli import validate as jax_validate

    bags = "bags"
    if broken:  # one bag missing, one unreadable, one of another width
        import shutil

        bags = str(tmp_path / "bags")
        shutil.copytree(trained / "bags", bags)
        files = sorted(Path(bags).glob("*.npy"))
        files[0].unlink()
        files[1].write_bytes(b"not an npy file")
        np.save(files[2], np.zeros((5, CLI_D + 1), np.float32))
    args = ["--task", TASK, "--data_root_dir", bags, "--encoding_size", str(CLI_D)]
    run = _cli("validate", *args, cwd=trained)
    cwd = os.getcwd()
    os.chdir(trained)
    try:
        capsys.readouterr()
        rc = jax_validate.main(args)
        theirs = json.loads(capsys.readouterr().out)
    finally:
        os.chdir(cwd)
    assert run.returncode == rc == (1 if broken else 0)  # the dispatcher passes the exit status on
    ours = json.loads(run.stdout)
    assert ours == theirs and ours["n_missing"] == (2 if broken else 0) and ours["n_dim_mismatch"] == (1 if broken else 0)


# -- serve and featurize refuse the JAX CLIs' unported flags by name --------------


@pytest.mark.parametrize("cli,base,flags,says", [
    ("serve", ["--ckpt", "c.pt"], ["--ensemble"], "queue 1.4"),
    ("serve", ["--ckpt", "c.pt"], ["--data_shards", "2"], "queue 1.7"),
    ("serve", ["--ckpt", "c.pt"], ["--bag_shards", "2"], "queue 1.7"),
    ("serve", ["--ckpt", "c.pt"], ["--max_rss_gb", "8"], "queue 1.6"),
    ("serve", ["--ckpt", "c.pt"], ["--pallas"], "configures XLA"),
    ("serve", ["--ckpt", "c.pt"], ["--compile_cache", "d"], "configures XLA"),
    ("featurize", ["--feat_dir", "f", "--patch_dir", "p", "--encoder", "vit"], ["--data_shards", "2"], "queue 1.7"),
    ("featurize", ["--feat_dir", "f", "--patch_dir", "p", "--encoder", "vit"], ["--profile", "d"], "queue 1.6"),
    # queue 1.5 (the ResNet-50 encoder) is ported: its flag is now taken, not refused
    ("featurize", ["--feat_dir", "f", "--patch_dir", "p", "--encoder", "vit"], ["--no_fold_bn"], "queue 1.5"),
    ("featurize", ["--feat_dir", "f", "--patch_dir", "p", "--encoder", "vit"], ["--compile_cache", "d"], "configures XLA"),
])
def test_serve_and_featurize_refuse_unported_flags_by_name(cli, base, flags, says):
    import importlib

    from toad_tpu_torch.cli.common import refuse_flags

    module = importlib.import_module(f"toad_tpu_torch.cli.{cli}")
    if says == "queue 1.5":
        args = module.make_parser().parse_args([*base, *flags])
        refuse_flags(args, module._NOT_PORTED)  # does not exit
        assert args.no_fold_bn is True and module.make_parser().parse_args(base).no_fold_bn is False
        return
    with pytest.raises(SystemExit) as e:
        module.main([*base, *flags, "--device", "cpu"])
    assert f"{flags[0]} is not ported to this package" in str(e.value) and says in str(e.value)
    assert module.make_parser().parse_args(base).__dict__[flags[0][2:]] in (None, False)  # off unless given


def test_featurize_default_encoder_stays_resnet50():
    from toad_tpu_torch.cli import featurize

    assert featurize.make_parser().parse_args(["--feat_dir", "f"]).encoder == "resnet50"
