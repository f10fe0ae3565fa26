"""The port's native bag loader against the JAX package's, on the CPU.

The same files go through both packages: where each locates a bag's payload
(``resolve_payload``, ``resolve_payload_q8``), what each C++ packer writes
for the same segments, and the batches each ``BagBatcher(native='on')``
yields, which must also be the port's numpy batches (``native='off'``). All
of it is held equal byte for byte: the two loaders are the same C++ code,
and the numpy feed casts and quantizes with twins of the C++ cast and
quantizer. Bags are at most 300 rows of at most 32 features.
"""

import dataclasses

import numpy as np
import pytest
import torch

from toad_tpu import config as jax_config
from toad_tpu import native as jax_native
from toad_tpu.data import batching as jax_batching
from toad_tpu.data import native_bags as jax_native_bags
from toad_tpu.data.wsi_dataset import PatientBagSplit as JaxPatientBagSplit
from toad_tpu.data.wsi_dataset import WSIBagDataset as JaxDataset
from toad_tpu_torch import native
from toad_tpu_torch.data import batching, native_bags, synthetic
from toad_tpu_torch.data.bags import save_int8_bag
from toad_tpu_torch.data.wsi_dataset import PatientBagSplit, WSIBagDataset
from toad_tpu_torch.ops.quantize import quantize_rows_np

D = 24
BUCKETS = (64, 128, 256)

pytestmark = pytest.mark.skipif(not jax_native.available(), reason=f"JAX loader unavailable: {jax_native.failure_reason()}")


def _datasets(root, fmt="npy", n_patients=12, seed=3, int8_every=0):
    """A synthetic cohort written by the port, read by both packages; every
    ``int8_every``-th bag (if set) converted to an int8 store."""
    csv_path = root / "dummy.csv"
    manifest = synthetic.write_dummy_csv(csv_path, n_patients=n_patients, max_slides_per_patient=2, seed=seed)
    task = synthetic.dummy_task(str(csv_path))
    bags = root / "bags"
    synthetic.write_dummy_bags(bags, manifest, task, n_patches_range=(16, 300), dim=D, fmt=fmt, seed=seed)
    if int8_every:
        for j, f in enumerate(sorted(bags.glob(f"*.{fmt}"))):
            if j % int8_every == 0:
                save_int8_bag(f.with_suffix(".npz"), np.load(f))
                f.unlink()
    ds = WSIBagDataset(task, data_dir=str(bags))
    jds = JaxDataset(jax_config.TaskConfig(**dataclasses.asdict(task)), data_dir=str(bags), print_info=False)
    ids = np.arange(ds.n_slides)
    return ds.subset(ids), jds.subset(ids)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return _datasets(tmp_path_factory.mktemp("native_npy"))


def _np(a) -> np.ndarray:
    """A batch plane as a numpy array (a bf16 tensor as its bits)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a)


def _bits(a) -> np.ndarray:
    """The bytes of a batch plane as an unsigned integer array."""
    a = _np(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _assert_same_batches(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert (a.batch_size, a.bucket) == (b.batch_size, b.bucket)
        np.testing.assert_array_equal(_bits(a.features), _bits(b.features))
        for name in ("patch_mask", "bag_mask", "label", "site", "sex", "indices"):
            x, y = _np(getattr(a, name)), _np(getattr(b, name))
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype, name
        assert (a.scales is None) == (b.scales is None)
        if a.scales is not None:
            np.testing.assert_array_equal(_bits(a.scales), _bits(b.scales))


# -- where the payload lies ---------------------------------------------------------


def _write_case(tmp_path, case):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((57, D)).astype(np.float32)
    p = tmp_path / f"{case}"
    if case == "npy":
        np.save(p.with_suffix(".npy"), x)
        return p.with_suffix(".npy")
    if case in ("pt", "pt_dict"):
        torch.save(torch.from_numpy(x) if case == "pt" else {"features": torch.from_numpy(x), "coords": torch.zeros(57, 2)},
                   p.with_suffix(".pt"))
        return p.with_suffix(".pt")
    if case == "h5":
        h5py = pytest.importorskip("h5py")
        with h5py.File(p.with_suffix(".h5"), "w") as f:
            f.create_dataset("features", data=x)
        return p.with_suffix(".h5")
    if case == "int8_store":
        save_int8_bag(p.with_suffix(".npz"), x, coords=rng.integers(0, 100, (57, 2)))
        return p.with_suffix(".npz")
    # ineligible: each must resolve to None in both packages
    if case == "f64_npy":
        np.save(p.with_suffix(".npy"), x.astype(np.float64))
    elif case == "fortran_npy":
        np.save(p.with_suffix(".npy"), np.asfortranarray(x))
    elif case == "truncated_npy":
        p.with_suffix(".npy").write_bytes(b"\x93NUMPY")
    elif case == "bf16_pt":
        torch.save(torch.from_numpy(x).bfloat16(), p.with_suffix(".pt"))
        return p.with_suffix(".pt")
    elif case == "offset_pt":
        torch.save(torch.from_numpy(x)[3:], p.with_suffix(".pt"))  # a view past the storage's start
        return p.with_suffix(".pt")
    elif case == "f32_npz":
        np.savez(p.with_suffix(".npz"), features=x)
        return p.with_suffix(".npz")
    elif case == "compressed_int8_store":
        q, s = quantize_rows_np(x)
        np.savez_compressed(p.with_suffix(".npz"), features_int8=q, scales=s)
        return p.with_suffix(".npz")
    elif case == "chunked_h5":
        h5py = pytest.importorskip("h5py")
        with h5py.File(p.with_suffix(".h5"), "w") as f:
            f.create_dataset("features", data=x, chunks=(8, D), compression="gzip")
        return p.with_suffix(".h5")
    elif case == "missing":
        return p.with_suffix(".npy")
    return p.with_suffix(".npy")


@pytest.mark.parametrize("case", ["npy", "pt", "pt_dict", "h5", "int8_store", "f64_npy", "fortran_npy", "truncated_npy",
                                  "bf16_pt", "offset_pt", "f32_npz", "compressed_int8_store", "chunked_h5", "missing"])
def test_payloads_resolve_as_in_the_jax_package(tmp_path, case):
    path = _write_case(tmp_path, case)
    for ours, theirs in ((native_bags.resolve_payload, jax_native_bags.resolve_payload),
                         (native_bags.resolve_payload_q8, jax_native_bags.resolve_payload_q8)):
        got, want = ours(path), theirs(path)
        assert (got is None) == (want is None)
        if got is not None:
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
    got = native_bags.resolve_payload(path) or native_bags.resolve_payload_q8(path)
    if case in ("npy", "pt", "pt_dict", "h5", "int8_store"):
        assert got is not None and (got.nrows, got.dim) == (57, D)
        raw = path.read_bytes()
        if case == "int8_store":  # raw reads at the offsets are the stored rows and scales
            z = np.load(path)
            np.testing.assert_array_equal(np.frombuffer(raw, np.int8, 57 * D, got.offset).reshape(57, D), z["features_int8"])
            np.testing.assert_array_equal(np.frombuffer(raw, np.float32, 57, got.scales_offset), z["scales"])
        else:
            rows = np.frombuffer(raw, np.float32, 57 * D, got.offset).reshape(57, D)
            np.testing.assert_array_equal(rows, np.random.default_rng(0).standard_normal((57, D)).astype(np.float32))
    else:
        assert got is None


def test_the_pt_resolver_runs_no_code_from_the_file(tmp_path):
    """A .pt whose pickle names another global resolves to None (the numpy
    feed's torch.load(weights_only=True) then refuses it loudly)."""
    import pickle
    import zipfile

    class Boom:
        def __reduce__(self):
            return (print, ("ran",))

    with zipfile.ZipFile(tmp_path / "evil.pt", "w") as zf:
        zf.writestr("evil/data.pkl", pickle.dumps({"features": Boom()}))
    assert native_bags.resolve_payload(tmp_path / "evil.pt") is None


# -- the packers ------------------------------------------------------------------


def _segments(tmp_path, kind):
    """Bags written to disk and segments over them: two segments of one bag
    (a patient bag), a whole bag, a bag cut short; dst rows in a [3, 64] batch."""
    rng = np.random.default_rng(1)
    bags = [rng.standard_normal((n, D)).astype(np.float32) * 3.7 for n in (40, 20, 64, 70)]
    bags[0][3] = 0.0  # an all-zero row: the amax floor
    bags[0][4, :] = 1e-9
    if kind in ("f32", "bf16"):  # ties, inf, overflow to inf, subnormals
        bags[1][0, :10] = [0.0, -0.0, 1.0, np.inf, -np.inf, 3.4e38, 1e-40, 1.00390625, 1.01171875, -3.3961e38]
    infos = []
    for j, x in enumerate(bags):
        if kind == "q8":
            save_int8_bag(tmp_path / f"b{j}.npz", x)
            infos.append(native_bags.resolve_payload_q8(tmp_path / f"b{j}.npz"))
        else:
            np.save(tmp_path / f"b{j}.npy", x)
            infos.append(native_bags.resolve_payload(tmp_path / f"b{j}.npy"))
    # (info, rows, dst): bag 0 then bag 1 in slot 0; bag 2 whole in slot 1; bag 3 cut to 50 rows in slot 2
    segs = [(infos[0], 40, 0), (infos[1], 20, 40), (infos[2], 64, 64), (infos[3], 50, 128)]
    return bags, segs


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "q8"])
def test_pack_segs_matches_the_jax_packer_bit_for_bit(tmp_path, kind):
    bags, segs = _segments(tmp_path, kind)
    paths = [s[0].path for s in segs]
    offs = np.array([s[0].offset for s in segs])
    rows = np.array([s[1] for s in segs])
    dst = np.array([s[2] for s in segs])
    out = {}
    for name, lib in (("port", native), ("jax", jax_native)):
        dt = {"f32": np.float32, "bf16": np.uint16}.get(kind, np.int8)
        feats = np.zeros((3, 64, D), dt)
        mask = np.zeros((3, 64), np.float32)
        scales = np.full((3, 64), batching.PAD_SCALE, np.float32)
        if kind == "f32":
            lib.pack_segs(paths, offs, rows, dst, D, feats, mask, nthreads=3)
        elif kind == "bf16":
            lib.pack_segs_bf16(paths, offs, rows, dst, D, feats, mask, nthreads=3)
        elif kind == "int8":
            lib.pack_segs_int8(paths, offs, rows, dst, D, feats, scales, mask, nthreads=3)
        else:
            s_offs = np.array([s[0].scales_offset for s in segs])
            lib.pack_segs_q8(paths, offs, s_offs, rows, dst, D, feats, scales, mask, nthreads=3)
        out[name] = (feats, scales, mask)
    for got, want in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    feats, scales, mask = out["port"]
    np.testing.assert_array_equal(mask.sum(1), [60, 64, 50])
    x = np.concatenate([bags[0], bags[1]])
    if kind == "f32":
        np.testing.assert_array_equal(feats[0, :60], x)
    elif kind == "bf16":  # torch's round to nearest even, as the numpy feed casts
        np.testing.assert_array_equal(feats[0, :60], torch.from_numpy(x).bfloat16().view(torch.int16).numpy().view(np.uint16))
    else:  # quantize_rows_np's bytes, from the f32 rows (int8) or as stored (q8)
        q, s = quantize_rows_np(x)
        np.testing.assert_array_equal(feats[0, :60], q)
        np.testing.assert_array_equal(scales[0, :60], s)
    assert not feats[2, 50:].any() and (scales[2, 50:] == batching.PAD_SCALE).all()


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "q8"])
def test_pack_bags_matches_the_jax_packer_bit_for_bit(tmp_path, kind):
    """The whole-bag entry points: bag j at batch slot j, cut to its row count."""
    _, segs = _segments(tmp_path, kind)
    infos, rows = [segs[1][0], segs[2][0], segs[3][0]], np.array([20, 64, 50])
    paths, offs = [i.path for i in infos], np.array([i.offset for i in infos])
    out = {}
    for name, lib in (("port", native), ("jax", jax_native)):
        feats = np.zeros((3, 64, D), {"f32": np.float32, "bf16": np.uint16}.get(kind, np.int8))
        scales, mask = np.full((3, 64), batching.PAD_SCALE, np.float32), np.zeros((3, 64), np.float32)
        if kind == "f32":
            lib.pack_bags(paths, offs, rows, D, 64, feats, mask, nthreads=2)
        elif kind == "bf16":
            lib.pack_bags_bf16(paths, offs, rows, D, 64, feats, mask, nthreads=2)
        elif kind == "int8":
            lib.pack_bags_int8(paths, offs, rows, D, 64, feats, scales, mask, nthreads=2)
        else:
            lib.pack_bags_q8(paths, offs, np.array([i.scales_offset for i in infos]), rows, D, 64, feats, scales, mask,
                             nthreads=2)
        out[name] = (feats, scales, mask)
    for got, want in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(out["port"][2].sum(1), rows)


@pytest.mark.parametrize("bad", ["dtype", "rows_past_bucket", "crossing_segment", "missing_file"])
def test_packer_guards_refuse_before_writing(tmp_path, bad):
    np.save(tmp_path / "b.npy", np.ones((20, 4), np.float32))
    info = native_bags.resolve_payload(tmp_path / "b.npy")
    feats, mask = np.zeros((2, 16, 4), np.float32), np.zeros((2, 16), np.float32)
    args = dict(paths=[info.path], offsets=[info.offset], nrows=[16], dst_rows=[0], dim=4, out=feats, mask=mask)
    if bad == "dtype":
        args["out"] = feats.astype(np.float64)
    elif bad == "rows_past_bucket":
        args["nrows"] = [17]
    elif bad == "crossing_segment":
        args["dst_rows"] = [8]
    else:
        args["paths"] = [str(tmp_path / "nope.npy")]
    with pytest.raises(OSError if bad == "missing_file" else ValueError, match="nope.npy" if bad == "missing_file" else None):
        native.pack_segs(**args)
    if bad != "missing_file":
        assert not feats.any() and not mask.any()


# -- the batcher --------------------------------------------------------------------


@pytest.mark.parametrize("case,wire", [
    ("slides", "float32"), ("slides", "bfloat16"), ("slides", "int8"),
    ("patient_bags", "float32"), ("patient_bags", "bfloat16"), ("patient_bags", "int8"),
    ("max_bag_size", "float32"), ("max_bag_size", "bfloat16"), ("max_bag_size", "int8"),
    ("int8_store", "int8"), ("mixed_store", "int8"), ("pt_bags", "float32"),
])
def test_native_batches_equal_the_jax_native_and_the_numpy_batches(tmp_path, cohort, case, wire):
    split, jsplit = cohort
    kw = dict(batch_size=4, bucket_sizes=BUCKETS, mode="shuffle", seed=5, prefetch=0, transfer_dtype=wire)
    if case == "patient_bags":
        split, jsplit = PatientBagSplit(split), JaxPatientBagSplit(jsplit)
    elif case == "max_bag_size":
        kw["max_bag_size"] = 100
    elif case in ("int8_store", "mixed_store"):
        split, jsplit = _datasets(tmp_path, int8_every=1 if case == "int8_store" else 2)
    elif case == "pt_bags":
        split, jsplit = _datasets(tmp_path, fmt="pt")
    ours = batching.BagBatcher(split, native="on", **kw)
    theirs = jax_batching.BagBatcher(jsplit, native="on", **kw)
    off = batching.BagBatcher(split, native="off", **kw)
    for epoch in (0, 1):
        for b in (ours, theirs, off):
            b.set_epoch(epoch)
        got = list(ours)
        _assert_same_batches(got, list(theirs))
        _assert_same_batches(got, list(off))
        assert len(ours) == len(got)  # the exact __len__, from the resolved payloads
    assert ours.native_active and theirs.native_active and not off.native_active
    assert (ours.feed_kind, off.feed_kind) == ("native", "numpy")
    if wire == "bfloat16":
        assert got[0].features.dtype == torch.bfloat16
    pad = got[-1].patch_mask == 0
    assert pad.any() and not _bits(got[-1].features)[pad].any()
    if wire == "int8":
        assert (got[-1].scales[pad] == batching.PAD_SCALE).all()


class _HostRing(batching._DeviceFeed):
    """The device feed's ring slot without a card: one buffer filled with
    0xFF, every batch packed into it, its planes left there."""

    def __init__(self, nbytes: int) -> None:
        self.buf = torch.full((nbytes,), 0xFF, dtype=torch.uint8)
        self.turns = 0

    def _slot(self, nbytes: int):
        assert nbytes <= self.buf.numel()
        self.turns += 1
        return self.buf, 0

    def _send(self, b, staged, i):
        b.features, b.patch_mask = staged[0], staged[-1]
        if len(staged) == 3:
            b.scales = staged[1]
        return b


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
def test_a_reused_slot_holds_the_second_batch_exactly(tmp_path, wire):
    """A long batch, then a shorter one (fewer bags, fewer rows, a smaller
    bucket) into the same slot: the second must equal the same batch packed
    into fresh zeros, its padding rows zero and their scales PAD_SCALE."""
    rng = np.random.default_rng(2)
    lengths = [250, 240, 231, 130, 60, 3]
    for j, n in enumerate(lengths):
        np.save(tmp_path / f"b{j}.npy", rng.standard_normal((n, D)).astype(np.float32))

    class Split:
        labels = np.arange(6, dtype=np.int32)
        sites = np.zeros(6, np.int32)
        sexes = np.ones(6, np.int32)

        def __len__(self):
            return 6

        def bag_file(self, i):
            return tmp_path / f"b{i}.npy"

        def load_bag(self, i):
            return np.load(self.bag_file(i))

    batcher = batching.BagBatcher(Split(), batch_size=3, bucket_sizes=BUCKETS, prefetch=0, transfer_dtype=wire)
    assert batcher._native_ready()
    ring = _HostRing(3 * 256 * D * 4 + 2 * 3 * 256 * 4 + 64)
    first = batcher._assemble_native([0, 1, 2], 256, ring)
    assert _bits(first.features).any()
    for group, bucket in (([3, 4], 256), ([4, 5], 64)):
        second = batcher._assemble_native(group, bucket, ring)
        fresh = batcher._assemble_native(group, bucket)
        _assert_same_batches([second], [fresh])
        pad = second.patch_mask.numpy() == 0
        assert pad.any() and not _bits(second.features)[pad].any()
        if wire == "int8":
            assert (second.scales.numpy()[pad] == batching.PAD_SCALE).all()
    assert ring.turns == 3


# -- when the native feed does not run ------------------------------------------------


@pytest.mark.parametrize("store", ["f32_npz", "int8_store_on_f32_wire", "mixed_dims", "pinned_dim"])
def test_ineligible_splits_raise_under_on_and_take_numpy_under_auto(tmp_path, store):
    rng = np.random.default_rng(4)
    dims = {"mixed_dims": (16, 32), "pinned_dim": (16, 16)}.get(store, (16, 16))
    for j, d in enumerate(dims):
        x = rng.standard_normal((10, d)).astype(np.float32)
        if store == "f32_npz":
            np.savez(tmp_path / f"b{j}.npz", features=x)
        elif store == "int8_store_on_f32_wire":
            save_int8_bag(tmp_path / f"b{j}.npz", x)
        else:
            np.save(tmp_path / f"b{j}.npz".replace(".npz", ".npy"), x)
    ext = ".npz" if store in ("f32_npz", "int8_store_on_f32_wire") else ".npy"

    class Split:
        labels = sites = sexes = np.zeros(2, np.int32)

        def __len__(self):
            return 2

        def bag_file(self, i):
            return tmp_path / f"b{i}{ext}"

        def load_bag(self, i):
            from toad_tpu_torch.data.bags import load_bag

            return load_bag(self.bag_file(i))

    kw = dict(batch_size=1, bucket_sizes=(16,), prefetch=0, feature_dim=32 if store == "pinned_dim" else None)
    with pytest.raises(RuntimeError, match="native bag IO requested"):
        list(batching.BagBatcher(Split(), native="on", **kw))
    auto = batching.BagBatcher(Split(), native="auto", **kw)
    if store == "pinned_dim":  # the numpy feed then names the bad dim
        with pytest.raises(ValueError, match="feature dim 16, expected 32"):
            list(auto)
    else:
        assert len(list(auto)) == 2
    assert auto.native_active is False and auto.feed_kind == "numpy"
    assert jax_batching.BagBatcher(Split(), native="auto", **kw)._native_ready() is False  # the same decision


def test_a_split_without_bag_files_takes_numpy_even_under_on():
    class MinimalSplit:
        labels = sites = sexes = np.zeros(3, np.int32)

        def __len__(self):
            return 3

        def load_bag(self, i):
            return np.full((8, 4), float(i), np.float32)

    b = batching.BagBatcher(MinimalSplit(), batch_size=2, bucket_sizes=(16,), prefetch=0, native="on")
    assert len(list(b)) == 2 and b.native_active is False


def test_a_failed_build_raises_and_never_falls_back(tmp_path, cohort, monkeypatch):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    split, _ = cohort
    for mode in ("auto", "on"):
        batcher = batching.BagBatcher(split, batch_size=4, bucket_sizes=BUCKETS, prefetch=1, native=mode)
        with pytest.raises(native.NativeBuildError, match="native_io off") as err:
            list(batcher)
        assert "no-such-compiler" in str(err.value)
    assert not any((tmp_path / "build").glob("*.so"))
    assert len(list(batching.BagBatcher(split, batch_size=4, bucket_sizes=BUCKETS, native="off"))) > 0


def test_eval_without_a_compiler_names_its_way_out_and_runs_with_native_off(tmp_path, cohort, monkeypatch):
    from toad_tpu_torch.config import ModelConfig
    from toad_tpu_torch.evaluate import engine
    from toad_tpu_torch.models.toad_mil import ToadMIL

    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    split, _ = cohort
    torch.manual_seed(0)
    model = ToadMIL(ModelConfig(in_dim=D, n_classes=int(split.labels.max()) + 1)).eval()
    kw = dict(batch_size=4, bucket_sizes=BUCKETS, device="cpu")
    with pytest.raises(native.NativeBuildError, match="`eval` has no such flag: set CXX") as err:
        engine.evaluate_split(model, split, **kw)  # 'auto', as the eval CLI runs it
    assert "evaluate_split" in str(err.value)
    res = engine.evaluate_split(model, split, native="off", **kw)
    assert res.stats["feed"] == "numpy" and res.stats["n"] == len(split)
    assert np.isfinite(res.df["p_0"]).all()


def test_the_library_builds_into_build_dir_keyed_by_source(tmp_path, monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    lib = native.get_lib()
    assert native.get_lib() is lib and native.library_path().parent == tmp_path / "build"
    assert native.library_path().exists() and [p.name for p in (tmp_path / "build").iterdir()] == [native.library_path().name]
    assert native.build_command[:6] == ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]
    assert native.SOURCE.parent.name == "csrc" and native.SOURCE.read_text().count("toad_bagio_abi_version() { return 4; }") == 1
