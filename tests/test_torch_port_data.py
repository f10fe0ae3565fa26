"""Data path of the PyTorch port against the JAX package: splits, manifest
ingest, split files, synthetic fixtures and bucketed batches.

Both packages read the same files and draw from ``np.random.RandomState``
in the same order, so everything here is held EQUAL (array by array, byte by
byte for the files pandas writes on the JAX side and the stdlib ``csv``
module on the port's), except bf16 transfer, where both sides round the same
f32 rows to nearest-even and are compared after widening to f32.
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

from toad_tpu.data import batching as jax_batching
from toad_tpu.data import splits as jax_splits
from toad_tpu.data import synthetic as jax_synthetic
from toad_tpu.data.wsi_dataset import PatientBagSplit as JaxPatientBagSplit
from toad_tpu.data.wsi_dataset import WSIBagDataset as JaxDataset
from toad_tpu_torch.data import batching, bags, splits, synthetic
from toad_tpu_torch.data.wsi_dataset import (
    LabelVocabularyError,
    PatientBagSplit,
    WSIBagDataset,
    inverse_frequency_weights,
    vote_label,
)

BUCKETS = (64, 128, 256)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """One synthetic dataset, written by the port, read by both packages."""
    root = tmp_path_factory.mktemp("port_data")
    csv_path = root / "dummy.csv"
    manifest = synthetic.write_dummy_csv(csv_path, n_patients=40, max_slides_per_patient=2, seed=3)
    task = synthetic.dummy_task(str(csv_path))
    synthetic.write_dummy_bags(root / "bags", manifest, task, n_patches_range=(20, 250), dim=32, fmt="npy", seed=3)
    jax_task = jax_synthetic.dummy_task(str(csv_path))
    return {
        "root": root, "csv": csv_path, "task": task, "manifest": manifest,
        "port": WSIBagDataset(task, data_dir=str(root / "bags")),
        "jax": JaxDataset(jax_task, data_dir=str(root / "bags")),
    }


# -- splits -------------------------------------------------------------------


@pytest.mark.parametrize("seed,label_frac,held_out", [(1, 1.0, False), (7, 1.0, False), (3, 0.5, False), (5, 1.0, True)])
def test_generate_splits_draws_the_same_folds(env, seed, label_frac, held_out):
    cls_ids = env["port"].slide_cls_ids
    counts = np.array([len(c) for c in cls_ids])
    val_num, test_num = np.floor(counts * 0.2).astype(int), np.floor(counts * 0.3).astype(int)
    custom = splits.sample_held_out(cls_ids, test_num, seed) if held_out else None
    if held_out:
        np.testing.assert_array_equal(custom, jax_splits.sample_held_out(env["jax"].slide_cls_ids, test_num, seed))
    kw = dict(n_splits=3, seed=seed, label_frac=label_frac, custom_test_ids=custom)
    ours = list(splits.generate_splits(cls_ids, val_num, test_num, env["port"].n_slides, **kw))
    theirs = list(jax_splits.generate_splits(env["jax"].slide_cls_ids, val_num, test_num, env["jax"].n_slides, **kw))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        a.validate_disjoint()
        for part in ("train", "val", "test"):
            np.testing.assert_array_equal(getattr(a, part), getattr(b, part))


def test_expand_patient_split_matches(env):
    ds, jds = env["port"], env["jax"]
    spec = splits.SplitSpec(train=np.arange(0, 10), val=np.arange(10, 15), test=np.arange(15, 20))
    jspec = jax_splits.SplitSpec(train=spec.train, val=spec.val, test=spec.test)
    a = splits.expand_patient_split(spec, ds.patient_ids, ds.case_ids)
    b = jax_splits.expand_patient_split(jspec, jds.patient_ids, jds.case_ids)
    for part in ("train", "val", "test"):
        np.testing.assert_array_equal(getattr(a, part), getattr(b, part))


def _ragged_ids(ds):
    return {"train": list(ds.slide_ids[:9]), "val": list(ds.slide_ids[9:12]), "test": list(ds.slide_ids[12:17])}


def test_split_files_are_byte_identical_and_read_both_ways(env, tmp_path):
    ids = _ragged_ids(env["port"])
    for kind, ours, theirs in (("", splits.save_split_columnar, jax_splits.save_split_columnar),
                               ("bool", splits.save_split_boolean, jax_splits.save_split_boolean)):
        p, j = tmp_path / f"port_{kind}.csv", tmp_path / f"jax_{kind}.csv"
        ours(ids, p)
        theirs(ids, j)
        assert p.read_bytes() == j.read_bytes()
        # each package reads the other's file to the same lists
        assert splits.load_split_csv(j) == jax_splits.load_split_csv(p) == {k: [str(v) for v in vs] for k, vs in ids.items()}


def test_split_descriptor_csv_is_byte_identical(env, tmp_path):
    ds, jds = env["port"], env["jax"]
    spec = splits.SplitSpec(train=np.arange(0, 30), val=np.arange(30, 40), test=np.arange(40, ds.n_slides))
    jspec = jax_splits.SplitSpec(train=spec.train, val=spec.val, test=spec.test)
    desc = splits.split_descriptor(spec, ds.getlabel, ds.task.label_dicts, ds.num_classes)
    jdesc = jax_splits.split_descriptor(jspec, jds.getlabel, jds.task.label_dicts, jds.num_classes)
    np.testing.assert_array_equal(desc.counts, jdesc.to_numpy())
    assert list(desc.index) == list(jdesc.index)
    desc.to_csv(tmp_path / "p.csv")
    jdesc.to_csv(tmp_path / "j.csv")
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert splits.split_file("d", 3, "bool").name == jax_splits.split_file("d", 3, "bool").name == "splits_3_bool.csv"


def test_numeric_looking_ids_read_as_pandas_reads_them(tmp_path):
    """pandas reads an all-integer id column as integers (``0201`` -> 201);
    the port's csv reader does the same, and split files keep such ids as
    strings beside the empty cells of a shorter column."""
    csv_path = tmp_path / "num.csv"
    rows = ["slide_id,case_id,label,sex,site"]
    rows += [f"{'0' if i % 2 else ''}{200 + i},{900 + i // 2},{'Lung' if i % 3 else 'Breast'},{'F' if i % 2 else 'M'},Primary"
             for i in range(12)]
    csv_path.write_text("\n".join(rows) + "\n")
    ds = WSIBagDataset(synthetic.dummy_task(str(csv_path)))
    jds = JaxDataset(jax_synthetic.dummy_task(str(csv_path)))
    np.testing.assert_array_equal(ds.slide_ids, jds.slide_ids)
    np.testing.assert_array_equal(ds.case_ids, jds.case_ids)
    assert ds.slide_ids[1] == "201"
    ids = {"train": list(ds.slide_ids[:7]), "val": list(ds.slide_ids[7:9]), "test": list(ds.slide_ids[9:])}
    splits.save_split_columnar(ids, tmp_path / "s.csv")
    jax_splits.save_split_columnar(ids, tmp_path / "j.csv")
    assert (tmp_path / "s.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    for ours, theirs in zip(ds.return_splits_from_csv(tmp_path / "j.csv"), jds.return_splits_from_csv(tmp_path / "s.csv")):
        np.testing.assert_array_equal(ours.ids, theirs.ids)
        np.testing.assert_array_equal(ours.slide_ids, theirs.slide_ids)


# -- manifest and dataset -----------------------------------------------------


def test_synthetic_fixture_equals_the_jax_package(env, tmp_path):
    jax_manifest = jax_synthetic.write_dummy_csv(tmp_path / "j.csv", n_patients=40, max_slides_per_patient=2, seed=3)
    assert (tmp_path / "j.csv").read_bytes() == env["csv"].read_bytes()
    assert jax_manifest.to_dict("records") == env["manifest"]
    jax_synthetic.write_dummy_bags(tmp_path / "bags", jax_manifest.iloc[:5], jax_synthetic.dummy_task("x"),
                                   n_patches_range=(20, 250), dim=32, fmt="npy", seed=3)
    for row in env["manifest"][:5]:
        np.testing.assert_array_equal(np.load(tmp_path / "bags" / f"{row['slide_id']}.npy"),
                                      np.load(env["root"] / "bags" / f"{row['slide_id']}.npy"))
    assert synthetic.dummy_task("x").label_dicts == jax_synthetic.dummy_task("x").label_dicts


def test_graded_bags_equal_the_jax_package(env, tmp_path):
    import pandas as pd

    rows = env["manifest"][:6]
    synthetic.write_graded_bags(tmp_path / "p", rows, env["task"], n_patches_range=(30, 60), dim=32, seed=4)
    jax_synthetic.write_graded_bags(tmp_path / "j", pd.DataFrame(rows), env["jax"].task, n_patches_range=(30, 60), dim=32, seed=4)
    for row in rows:
        np.testing.assert_array_equal(np.load(tmp_path / "p" / f"{row['slide_id']}.npy"),
                                      np.load(tmp_path / "j" / f"{row['slide_id']}.npy"))
    np.testing.assert_array_equal(synthetic.class_direction_matrix(5, 16), jax_synthetic.class_direction_matrix(5, 16))
    with pytest.raises(ValueError, match="npy"):
        synthetic.write_graded_bags(tmp_path / "x", rows, env["task"], fmt="pt")


def test_dataset_arrays_equal(env):
    ds, jds = env["port"], env["jax"]
    for name in ("slide_ids", "case_ids", "labels", "sites", "sexes", "patient_ids", "patient_labels"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(jds, name))
        assert getattr(ds, name).dtype == getattr(jds, name).dtype or name.endswith("ids")
    for a, b in zip(ds.slide_cls_ids + ds.patient_cls_ids, jds.slide_cls_ids + jds.patient_cls_ids):
        np.testing.assert_array_equal(a, b)
    assert (len(ds), ds.n_slides, ds.num_classes) == (len(jds), jds.n_slides, jds.num_classes)
    assert ds.record(5) == type(ds.record(5))(**vars(jds.record(5)))
    assert ds.bag_file(3) == jds.bag_file(3)
    np.testing.assert_array_equal(ds.load_bag(3), jds.load_bag(3))
    np.testing.assert_array_equal(ds.getlabel([1, 4, 7], task=1), jds.getlabel([1, 4, 7], task=1))


def test_dataset_options_equal(env):
    kw = dict(shuffle=True, seed=11, filter_dict={"sex": ["F"]})
    ds = WSIBagDataset(env["task"], **kw)
    jds = JaxDataset(env["jax"].task, **kw)
    np.testing.assert_array_equal(ds.slide_ids, jds.slide_ids)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    assert set(ds.sexes.tolist()) == {0}
    sub, jsub = ds.subset([4, 2, 9]), jds.subset([4, 2, 9])
    np.testing.assert_array_equal(sub.slide_ids, jsub.slide_ids)
    np.testing.assert_array_equal(sub.class_weights(), jsub.class_weights())
    labels = np.array([0, 2, 2, 1])
    assert vote_label(labels, "max") == 2 and vote_label(labels, "maj") == 2
    np.testing.assert_array_equal(inverse_frequency_weights(labels, 4), [4.0, 2.0, 2.0, 4.0])


def test_patient_bag_split_equal(env):
    ids = np.arange(0, env["port"].n_slides, 2)
    ps, jps = PatientBagSplit(env["port"].subset(ids)), JaxPatientBagSplit(env["jax"].subset(ids))
    assert len(ps) == len(jps)
    for name in ("case_ids", "labels", "sites", "sexes"):
        np.testing.assert_array_equal(getattr(ps, name), getattr(jps, name))
    np.testing.assert_array_equal(ps.load_bag(2), jps.load_bag(2))
    np.testing.assert_array_equal(ps.slides_for(2), jps.slides_for(2))


def test_vocabulary_and_missing_files_fail_loudly(env, tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text(env["csv"].read_text().replace("Lung", "Lnug"))
    with pytest.raises(LabelVocabularyError, match="Lnug"):
        WSIBagDataset(env["task"], csv_path=bad)
    (tmp_path / "short.csv").write_text("slide_id,case_id\na,b\n")
    with pytest.raises(LabelVocabularyError, match="missing required columns"):
        WSIBagDataset(env["task"], csv_path=tmp_path / "short.csv")
    with pytest.raises(FileNotFoundError, match="dataset csv not found"):
        WSIBagDataset(env["task"], csv_path=tmp_path / "nope.csv")
    with pytest.raises(LabelVocabularyError, match="not in the dataset csv"):
        env["port"].subset_by_slide_ids(["SYN-SLIDE_0", "ghost"])
    with pytest.raises(ValueError, match="without data_dir"):
        WSIBagDataset(env["task"]).load_bag(0)


# -- bags ---------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["npy", "npz", "pt"])
def test_bag_shape_reads_metadata_only(tmp_path, fmt):
    rows = synthetic.make_dummy_manifest(n_patients=2, max_slides_per_patient=1, seed=0)
    synthetic.write_dummy_bags(tmp_path, rows, synthetic.dummy_task("x"), n_patches_range=(30, 60), dim=16, fmt=fmt, seed=1)
    for row in rows:
        path = bags.bag_path(tmp_path, row["slide_id"])
        assert path.suffix == f".{fmt}"
        feats = bags.load_bag(path)
        assert bags.bag_shape(path) == feats.shape and feats.dtype == np.float32
    assert bags.bag_path(tmp_path, "missing").name == "missing.pt"
    with pytest.raises(ValueError, match="unsupported bag format"):
        bags.bag_shape(tmp_path / "x.txt")


# -- batches ------------------------------------------------------------------


def _assert_batches_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        fa = a.features.float().numpy() if isinstance(a.features, torch.Tensor) else a.features
        np.testing.assert_array_equal(fa, np.asarray(b.features, np.float32))
        for name in ("patch_mask", "bag_mask", "label", "site", "sex", "indices"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
            assert getattr(a, name).dtype == getattr(b, name).dtype
        assert (a.batch_size, a.bucket) == (b.batch_size, b.bucket)


def _check_two_epochs(env, mode, native):
    ids = np.arange(5, 55)
    kw = dict(batch_size=4, bucket_sizes=BUCKETS, mode=mode, seed=13)
    ours = batching.BagBatcher(env["port"].subset(ids), native=native, **kw)
    theirs = jax_batching.BagBatcher(env["jax"].subset(ids), native="off", **kw)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got = list(ours)
        _assert_batches_equal(got, list(theirs))
        assert len(ours) == len(theirs) == len(got)  # the exact __len__, from file metadata
    assert ours.n_bags == theirs.n_bags == 50
    first = [b.indices.copy() for b in ours]
    ours.set_epoch(0)
    if mode != "sequential":
        assert any(not np.array_equal(a, b.indices) for a, b in zip(first, ours))  # the epoch changes the order
    assert ours.feed_kind == ("native" if native == "on" else "numpy")


@pytest.mark.parametrize("mode", ["sequential", "shuffle", "weighted"])
def test_batcher_batches_equal_over_two_epochs(env, mode):
    _check_two_epochs(env, mode, "off")  # the numpy feed


@pytest.mark.parametrize("mode", ["sequential", "shuffle", "weighted"])
def test_native_batcher_batches_equal_over_two_epochs(env, mode):
    _check_two_epochs(env, mode, "on")


OPTIONS = pytest.mark.parametrize("kw", [
    dict(batch_size=3, bucket_sizes=BUCKETS, mode="shuffle", testing_frac=0.3),
    dict(batch_size=2, bucket_sizes=BUCKETS, mode="sequential", max_bag_size=100),
    dict(batch_size=1, bucket_sizes=None, mode="sequential"),
    dict(batch_size=4, bucket_sizes=(64,), mode="weighted", prefetch=0),
    dict(batch_size=4, bucket_sizes=BUCKETS, mode="shuffle", transfer_dtype="bfloat16"),
], ids=["testing_frac", "max_bag_size", "exact_lengths", "truncating_bucket", "bf16_transfer"])


def _check_options(env, kw, native):
    ids = np.arange(0, 40)
    ours = batching.BagBatcher(env["port"].subset(ids), seed=5, native=native, **kw)
    theirs = jax_batching.BagBatcher(env["jax"].subset(ids), seed=5, native="off", **kw)
    ours.set_epoch(2)
    theirs.set_epoch(2)
    got = list(ours)
    _assert_batches_equal(got, list(theirs))
    assert len(ours) == len(theirs) == len(got)
    if kw.get("transfer_dtype") == "bfloat16":
        assert got[0].features.dtype == torch.bfloat16
    assert ours.feed_kind == ("native" if native == "on" else "numpy")


@OPTIONS
def test_batcher_options_equal(env, kw):
    _check_options(env, kw, "off")  # the numpy feed


@OPTIONS
def test_native_batcher_options_equal(env, kw):
    _check_options(env, kw, "on")


def _check_patient_bags(env, native):
    ids = np.arange(0, 50)
    kw = dict(batch_size=2, bucket_sizes=(128, 256, 512), mode="shuffle", seed=1)
    ours = batching.BagBatcher(PatientBagSplit(env["port"].subset(ids)), native=native, **kw)
    theirs = jax_batching.BagBatcher(JaxPatientBagSplit(env["jax"].subset(ids)), native="off", **kw)
    _assert_batches_equal(list(ours), list(theirs))
    assert len(ours) == len(theirs)
    assert ours.feed_kind == ("native" if native == "on" else "numpy")


def test_batcher_patient_bags_equal(env):
    _check_patient_bags(env, "off")  # the numpy feed


def test_native_batcher_patient_bags_equal(env):
    _check_patient_bags(env, "on")


def test_bucket_helpers_equal(env):
    counts = np.array([bags.bag_shape(env["port"].bag_file(i))[0] for i in range(env["port"].n_slides)])
    assert batching.suggest_buckets(counts, 4, 32) == jax_batching.suggest_buckets(counts, 4, 32)
    assert batching.suggest_buckets(np.array([]), 4, 32) == []
    split, jsplit = env["port"].subset(range(30)), env["jax"].subset(range(30))
    assert batching.auto_bucket_ladder(split, 5, 64) == jax_batching.auto_bucket_ladder(jsplit, 5, 64)
    assert batching.auto_bucket_ladder(PatientBagSplit(split), 3) == jax_batching.auto_bucket_ladder(JaxPatientBagSplit(jsplit), 3)
    assert [batching.bucket_for(n, BUCKETS) for n in (1, 64, 65, 999)] == [64, 64, 128, 256]
    assert batching.resolve_transfer_dtype("auto", "bfloat16") == "bfloat16"
    assert batching.resolve_transfer_dtype("auto", "float32") == "float32"
    with pytest.raises(ValueError, match="resolve_transfer_dtype"):
        batching.BagBatcher(split, transfer_dtype="auto")
    with pytest.raises(ValueError, match="not supported"):
        batching.BagBatcher(split, transfer_dtype="float16")
    assert batching.BagBatcher(split, transfer_dtype="int8").transfer_dtype == "int8"  # the quantized eval's wire


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "bag-prefetch" and t.is_alive()]


def _check_early_stop(env, native):
    batcher = batching.BagBatcher(env["port"].subset(range(40)), batch_size=2, bucket_sizes=BUCKETS, prefetch=1,
                                  native=native)
    it = iter(batcher)
    next(it)
    assert _prefetch_threads()
    it.close()  # the consumer abandons the epoch (an exception in the step, an early stop)
    deadline = time.monotonic() + 10
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _prefetch_threads()
    with pytest.raises(RuntimeError, match="step failed"):
        for _ in batcher:
            raise RuntimeError("step failed")
    assert not _prefetch_threads()
    assert batcher.feed_kind == ("native" if native == "on" else "numpy")


def test_producer_thread_ends_when_the_consumer_stops_early(env):
    _check_early_stop(env, "off")  # the numpy feed, with its loader pool


def test_native_producer_thread_ends_when_the_consumer_stops_early(env):
    _check_early_stop(env, "on")


def test_loader_errors_reach_the_consumer(env, tmp_path):
    ds = WSIBagDataset(env["task"], data_dir=str(tmp_path))  # no bag files there
    batcher = batching.BagBatcher(ds.subset(range(4)), batch_size=2, bucket_sizes=BUCKETS)
    assert len(batcher) == 2  # lengths unreadable: ceil(n / batch_size)
    with pytest.raises(FileNotFoundError):
        list(batcher)
    assert not _prefetch_threads()
    bad = tmp_path / "bad"
    bad.mkdir()
    np.save(bad / "SYN-SLIDE_0.npy", np.zeros((5,), np.float32))
    with pytest.raises(ValueError, match="expected \\[N, D\\]"):
        list(batching.BagBatcher(WSIBagDataset(env["task"], data_dir=str(bad)).subset([0]), prefetch=0))


def test_device_feed_needs_the_card_and_cpu_device_stays_on_the_host(env):
    b = next(iter(batching.BagBatcher(env["port"].subset(range(4)), batch_size=2, bucket_sizes=BUCKETS, device="cpu")))
    assert isinstance(b.features, np.ndarray) and b.ready is None
    b.wait()  # nothing to wait for on the host


@pytest.mark.cuda
def test_device_feed_places_batches_on_the_card(env):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: pinned buffers and a copy stream")
    split = env["port"].subset(range(30))
    host = list(batching.BagBatcher(split, batch_size=4, bucket_sizes=BUCKETS, native="off"))
    for dtype, native in itertools.product(("float32", "bfloat16"), ("off", "on")):  # staged / packed in the slot
        placed = list(batching.BagBatcher(split, batch_size=4, bucket_sizes=BUCKETS, device="cuda", prefetch=1,
                                          transfer_dtype=dtype, native=native))
        for a, b in zip(placed, host):
            a.wait()
            assert a.features.is_cuda and a.features.dtype == getattr(torch, dtype)
            torch.testing.assert_close(a.features.cpu(), torch.from_numpy(b.features).to(a.features.dtype), rtol=0, atol=0)
            torch.testing.assert_close(a.patch_mask.cpu(), torch.from_numpy(b.patch_mask), rtol=0, atol=0)
