"""Ensemble serving of the PyTorch port against the JAX package, on the CPU.

The port's DynamicBatcher given a list of state_dicts (device="cpu": the
plain pooling path for every member) is held against the JAX
DynamicBatcher given the same members as a list, and against the port's
own EnsembleInference; then InferenceService.from_checkpoint(ensemble=True),
``serve --ensemble`` as a child process, and the serve_load probe against
the JAX one. Inputs are numpy from a seed; weights the JAX init through
params_from_jax.

Tolerances: probabilities as tests/test_torch_port_serve.py (f32 1e-4,
bf16 2e-3) and tests/test_torch_port_int8.py (int8 2e-3). Attention is
the mean of softmaxed weights of about 1/n each, so it is held relative
to each weight, not at the raw-score budgets of those files: f32 1e-4
absolute; bf16 1e-2 and int8 5e-3 of the weight, with no absolute slack
(observed 1.7e-3 and 1.1e-3 at these seeds). A uniform attention misses
them (checked). Against EnsembleInference, which takes the same
per-member softmaxes and means them in float64: 1e-5.
"""

import dataclasses
import http.client
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from toad_tpu.config import ModelConfig as JaxModelConfig
from toad_tpu.models.toad_mil import ToadMIL as JaxToadMIL
from toad_tpu.serve import DynamicBatcher as JaxBatcher
from toad_tpu.serve import ServeConfig as JaxServeConfig
from toad_tpu_torch.config import ModelConfig
from toad_tpu_torch.experiments import serve_load
from toad_tpu_torch.models import toad_mil
from toad_tpu_torch.models.interop import params_from_jax, reference_state_dict
from toad_tpu_torch.pipeline.infer import EnsembleInference
from toad_tpu_torch.serve import DynamicBatcher, InferenceService, ServeConfig, serve_in_thread

REPO = Path(__file__).resolve().parent.parent
DIM = 64
BUCKETS = (32, 64, 128)
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_BF16_P = dict(rtol=2e-3, atol=2e-3)
TOL_BF16_W = dict(rtol=1e-2, atol=0.0)
TOL_INT8_P = dict(rtol=2e-3, atol=2e-3)
TOL_INT8_W = dict(rtol=5e-3, atol=0.0)
TOL_ENSEMBLE = 1e-5


def _cfg(compute="float32"):
    return ModelConfig(in_dim=DIM, n_classes=6, compute_dtype=compute)


def _jax(cfg):
    return JaxModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def jax_members():
    model = JaxToadMIL(_jax(_cfg()))
    return [jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(k))) for k in (0, 7)]


@pytest.fixture(scope="module")
def members(jax_members):
    return [params_from_jax(p) for p in jax_members]


def _bags(count, seed, lo=5, hi=120):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((int(rng.integers(lo, hi)), DIM)).astype(np.float32), int(rng.integers(0, 2)))
            for _ in range(count)]


def _serve(batcher, bags, attention=None):
    with batcher as b:
        return [f.result(timeout=120) for f in [b.submit(x, s, attention) for x, s in bags]]


def _sc(**kw):
    return {"max_batch": 8, "max_wait_ms": 50, "bucket_sizes": BUCKETS, **kw}


def _check(got, ref, tol_p, tol_w, attention=True):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.y_prob, r.y_prob, **tol_p)
        np.testing.assert_allclose(g.site_prob, r.site_prob, **tol_p)
        if attention:
            for key in ("attention", "site_attention"):
                want = np.asarray(getattr(r, key))
                np.testing.assert_allclose(getattr(g, key), want, **tol_w)
                # the tolerance tells these weights from uniform ones
                assert not np.allclose(np.full_like(want, 1.0 / len(want)), want, **tol_w)
        assert g.attention.shape == np.asarray(r.attention).shape
        assert g.y_hat == r.y_hat and g.site_hat == r.site_hat
        assert [i for i, _ in g.topk] == [i for i, _ in r.topk]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_ensemble_batcher_matches_jax_ensemble(jax_members, members, compute):
    cfg = _cfg(compute)
    bags = _bags(11, seed=1)
    ref = _serve(JaxBatcher(jax_members, _jax(cfg), JaxServeConfig(**_sc(need_attention=True))), bags)
    batcher = DynamicBatcher(members, cfg, ServeConfig(**_sc(need_attention=True)), device="cpu")
    assert batcher.ensemble and batcher.n_members == 2
    got = _serve(batcher, bags)
    tol_p, tol_w = (TOL_F32, TOL_F32) if compute == "float32" else (TOL_BF16_P, TOL_BF16_W)
    _check(got, ref, tol_p, tol_w)
    for (x, _), g in zip(bags, got):  # softmaxed pooling weights over the real rows
        assert g.attention.shape == (len(x),)
        np.testing.assert_allclose(g.attention.sum(), 1.0, atol=1e-5)
        np.testing.assert_allclose(g.site_attention.sum(), 1.0, atol=1e-5)


def test_ensemble_without_attention_sends_no_placeholder(jax_members, members):
    bags = _bags(5, seed=2)
    ref = _serve(JaxBatcher(jax_members, _jax(_cfg()), JaxServeConfig(**_sc())), bags)
    got = _serve(DynamicBatcher(members, _cfg(), ServeConfig(**_sc()), device="cpu"), bags)
    _check(got, ref, TOL_F32, TOL_F32, attention=False)
    assert all(g.attention.shape == g.site_attention.shape == (0,) for g in got)


def test_ensemble_temperature_per_member(jax_members, members):
    """T divides each member's logits before its softmax, and the mean comes
    after: the JAX batcher's rule and EnsembleInference's."""
    bags = _bags(6, seed=3)
    ref = _serve(JaxBatcher(jax_members, _jax(_cfg()), JaxServeConfig(**_sc(temperature=2.0))), bags)
    got = _serve(DynamicBatcher(members, _cfg(), ServeConfig(**_sc(temperature=2.0)), device="cpu"), bags)
    ens = EnsembleInference(members, _cfg(), bucket_sizes=BUCKETS, temperature=2.0, device="cpu")
    cold = _serve(DynamicBatcher(members, _cfg(), ServeConfig(**_sc()), device="cpu"), bags)
    for (x, s), g, r, c in zip(bags, got, ref, cold):
        e = ens.predict(x, s)
        np.testing.assert_allclose(g.y_prob, r.y_prob, atol=TOL_ENSEMBLE)
        np.testing.assert_allclose(g.y_prob, e.y_prob, atol=TOL_ENSEMBLE)
        np.testing.assert_allclose(g.site_prob, c.site_prob, atol=1e-6)  # site probabilities stay at T = 1
        assert g.y_hat == r.y_hat == e.y_hat
        assert np.abs(g.y_prob - c.y_prob).max() > 1e-3  # T moved them


def test_ensemble_matches_ensemble_inference(members):
    """The served ensemble and the port's slide-inference ensemble: the same
    per-member forwards, the mean in f32 against the mean in float64."""
    bags = _bags(6, seed=4)
    got = _serve(DynamicBatcher(members, _cfg(), ServeConfig(**_sc(need_attention=True)), device="cpu"), bags)
    ens = EnsembleInference(members, _cfg(), bucket_sizes=BUCKETS, device="cpu")
    for (x, s), g in zip(bags, got):
        e = ens.predict(x, s)
        for key in ("y_prob", "site_prob", "attention", "site_attention"):
            np.testing.assert_allclose(getattr(g, key), getattr(e, key), atol=TOL_ENSEMBLE)
        assert g.y_hat == e.y_hat and g.site_hat == e.site_hat


def test_one_member_list_keeps_ensemble_semantics(members):
    """A 1-fold results dir served as an ensemble keeps the ensemble contract:
    attention as softmaxed weights that sum to 1 and T on the device, not the
    plain batcher's raw scores."""
    x = np.random.default_rng(5).standard_normal((40, DIM)).astype(np.float32)
    sc = ServeConfig(**_sc(need_attention=True, temperature=2.0))
    with DynamicBatcher(members[:1], _cfg(), sc, device="cpu") as b:
        assert b.ensemble and b.n_members == 1
        pred = b.predict(x, 1)
    ref = EnsembleInference(members[:1], _cfg(), bucket_sizes=BUCKETS, temperature=2.0, device="cpu").predict(x, 1)
    np.testing.assert_allclose(pred.y_prob, ref.y_prob, atol=TOL_ENSEMBLE)
    np.testing.assert_allclose(pred.attention, ref.attention, atol=1e-6)
    np.testing.assert_allclose(pred.attention.sum(), 1.0, atol=1e-5)
    with DynamicBatcher(members[0], _cfg(), sc, device="cpu") as b:
        assert not b.ensemble and b.n_members == 1
        raw = b.predict(x, 1)
    assert abs(raw.attention.sum() - 1.0) > 1e-3
    with pytest.raises(ValueError, match="at least one"):
        DynamicBatcher([], _cfg(), sc, device="cpu")


def test_int8_ensemble_matches_jax_int8_ensemble(jax_members, members):
    bags = _bags(9, seed=6, hi=300)  # some past the top bucket: head-truncated before quantizing
    sc = _sc(need_attention=True, int8=True)
    ref = _serve(JaxBatcher(jax_members, _jax(_cfg()), JaxServeConfig(**sc)), bags)
    got = _serve(DynamicBatcher(members, _cfg(), ServeConfig(**sc), device="cpu"), bags)
    _check(got, ref, TOL_INT8_P, TOL_INT8_W)
    # each member quantized its own trunk: per-channel scales belong to one member
    with DynamicBatcher(members, _cfg(), ServeConfig(**sc), device="cpu") as b:
        b.predict(bags[0][0], 0)
        (q0, _), (q1, _) = (m.int8_operands() for m in b.members)
    assert not torch.equal(q0["sw1"], q1["sw1"])


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_one_pool_call_per_member_and_batch(members, monkeypatch, int8):
    """The pooling call (the kernel's wrapper on CUDA) runs once per member
    and batch, in scored mode exactly for the batches that asked for
    attention."""
    calls = []
    name = "fused_int8_pool" if int8 else "fused_trunk_attention_pool"
    real = getattr(toad_mil, name)

    def counted(*a, with_scores=False, **kw):
        calls.append(with_scores)
        return real(*a, with_scores=with_scores, **kw)

    monkeypatch.setattr(toad_mil, name, counted)
    bags = _bags(10, seed=7, lo=70, hi=120)  # one bucket
    with DynamicBatcher(members, _cfg(), ServeConfig(**_sc(max_wait_ms=200, int8=int8)), device="cpu") as b:
        futures = [b.submit(x, s, attention=i % 2 == 0) for i, (x, s) in enumerate(bags)]
        assert all(f.result(timeout=120) for f in futures)
        stats = b.stats()
    assert len(calls) == 2 * stats.batches and sum(calls) == 2 * stats.attention_batches
    assert 0 < stats.attention_batches < stats.batches < len(bags)


def test_service_from_results_dir(tmp_path, members):
    for k, sd in enumerate(members):
        torch.save(reference_state_dict(sd), tmp_path / f"s_{k}_checkpoint.pt")
    (tmp_path / "summary.csv").write_text("folds\n")
    svc = InferenceService.from_checkpoint(tmp_path, _cfg(), ServeConfig(bucket_sizes=BUCKETS), device="cpu",
                                           ensemble=True)
    server, port = serve_in_thread(svc)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert stats["config"]["ensemble_members"] == 2
        x = np.random.default_rng(8).standard_normal((30, DIM)).astype(np.float32)
        conn.request("POST", "/predict", x.tobytes(), {"Content-Type": "application/octet-stream",
                                                       "X-Toad-Shape": f"30,{DIM}", "X-Toad-Sex": "F"})
        out = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    ref = EnsembleInference(members, _cfg(), bucket_sizes=BUCKETS, device="cpu").predict(x, 0)
    np.testing.assert_allclose(out["y_prob"], ref.y_prob, atol=TOL_ENSEMBLE)
    assert out["y_hat"] == ref.y_hat
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match=r"--ensemble: no s_<k>_checkpoint members under .*empty"):
        InferenceService.from_checkpoint(tmp_path / "empty", _cfg(), device="cpu", ensemble=True)


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}


def test_serve_cli_ensemble_child(tmp_path, members):
    """``serve --ensemble --device cpu`` as a user starts it: the ensemble
    line, the banner with /heatmap, an answer equal to EnsembleInference's,
    the member count in /stats, a SIGTERM drain."""
    for k, sd in enumerate(members):
        torch.save(reference_state_dict(sd), tmp_path / f"s_{k}_checkpoint.pt")
    x = np.random.default_rng(9).standard_normal((50, DIM)).astype(np.float32)
    proc = subprocess.Popen(
        [sys.executable, "-m", "toad_tpu_torch", "serve", "--ensemble", "--ckpt", str(tmp_path), "--device", "cpu",
         "--port", "0", "--encoding_size", str(DIM), "--n_classes", "6", "--buckets", "32,64,128"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env(), cwd=tmp_path,
    )
    try:
        lines = []
        while True:
            line = proc.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
            if line.startswith("serving on"):
                break
        assert f"ensemble: 2 fold checkpoints from {tmp_path}\n" in lines
        assert "POST /heatmap" in line
        port = int(line.split()[2].rsplit(":", 1)[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/predict", x.tobytes(), {"Content-Type": "application/octet-stream",
                                                       "X-Toad-Shape": f"50,{DIM}", "X-Toad-Sex": "M",
                                                       "X-Toad-Attention": "1"})
        out = json.loads(conn.getresponse().read())
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
        proc.terminate()
        assert proc.wait(timeout=60) == 0
        assert "in-flight requests drained" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    ref = EnsembleInference(members, _cfg(), bucket_sizes=BUCKETS, device="cpu").predict(x, 1)
    np.testing.assert_allclose(out["y_prob"], ref.y_prob, atol=TOL_ENSEMBLE)
    np.testing.assert_allclose(out["attention"], ref.attention, atol=TOL_ENSEMBLE)
    assert stats["config"]["ensemble_members"] == 2 and stats["attention_batches"] == 1
    assert stats["kernel_launches"] == stats["scored_kernel_launches"] == 0  # the CPU runs the plain versions


# -- the serve_load probe --------------------------------------------------------------


def _jax_serve_load():
    spec = importlib.util.spec_from_file_location("jax_serve_load", REPO / "experiments" / "serve_load.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TINY = ["--dim", "64", "--bag_n", "64", "--requests", "8", "--concurrency", "2"]


@pytest.mark.parametrize("wire", ["none", "raw"])
def test_serve_load_line_has_the_jax_keys(wire, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve_load.py", *TINY, "--wire", wire])
    _jax_serve_load().main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert serve_load.main([*TINY, "--wire", wire, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert list(got) == list(want)
    assert got["requests"] == want["requests"] == 8 and got["wire"] == wire and got["device"] == "cpu"
    assert got["batches"] >= 1 and got["mean_batch_size"] >= 1 and got["transfer"] == want["transfer"] == "f32"


@pytest.mark.parametrize("wire", ["none", "raw"])
def test_serve_load_timestamps_name_each_requests_largest_gap(wire, capsys):
    """--timestamps: one line a request before the run's line (the JAX
    probe's keys, unchanged), its stages present and in order, its largest
    gap one of theirs."""
    assert serve_load.main([*TINY, "--wire", wire, "--device", "cpu", "--timestamps"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    run, requests = lines[-1], lines[:-1]
    assert run["requests"] == len(requests) == 8 and run["wire"] == wire
    for i, r in enumerate(requests):
        assert list(r) == ["request", *serve_load.STAGES, "largest_gap", "largest_gap_ms"] and r["request"] == i
        times = [r[k] for k in serve_load.STAGES]
        assert 0 <= times[0] and times == sorted(times)
        gaps = {k: r[k] - r[p] for p, k in zip(serve_load.STAGES, serve_load.STAGES[1:])}
        assert r["largest_gap"] in gaps and abs(r["largest_gap_ms"] - max(gaps.values())) < 1e-2
    assert [r["sent"] for r in requests] == sorted(r["sent"] for r in requests)


def test_serve_load_int8_and_refusals(capsys):
    assert serve_load.main([*TINY, "--wire", "raw", "--int8", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["transfer"] == "int8"
    # --pallas configures XLA in the JAX probe: taken, with one note on stderr, the same line's keys and wire
    assert serve_load.main([*TINY, "--pallas", "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    line = json.loads(captured.out)
    assert captured.err.count("--pallas has no effect here") == 1
    assert line["requests"] == 8 and line["transfer"] == "f32" and line["wire"] == "none"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="cuda.is_available"):
            serve_load.main(TINY)
