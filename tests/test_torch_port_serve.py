"""Serving slice of the PyTorch port against the JAX package.

An in-process port server on the CPU (device="cpu": the plain pooling path)
answers over every wire route and is held against the JAX DynamicBatcher
(XLA path) on the same weights. Inputs are numpy from a seed.

Tolerances: f32 compute differs from XLA-CPU in summation order only (~1e-6
observed): probabilities to 1e-4 and raw attention to 1e-4. bf16 compute:
both round the wire and the activations to bf16 but evaluate bf16
elementwise ops with different internal precision: 2e-3 on probabilities,
2e-2 on O(1) raw scores.
"""

import base64
import dataclasses
import http.client
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from toad_tpu.config import ModelConfig as JaxModelConfig
from toad_tpu.models.toad_mil import ToadMIL as JaxToadMIL
from toad_tpu.serve import DynamicBatcher as JaxBatcher
from toad_tpu.serve import ServeConfig as JaxServeConfig
from toad_tpu_torch.cli import common
from toad_tpu_torch.config import ModelConfig
from toad_tpu_torch.data.bags import load_bag
from toad_tpu_torch.data.batching import _pad_bag, bucket_for
from toad_tpu_torch.evaluate.calibration import apply_temperature
from toad_tpu_torch.models.interop import params_from_jax, reference_state_dict
from toad_tpu_torch.serve import DynamicBatcher, InferenceService, ServeConfig, make_http_server, serve_in_thread

REPO = Path(__file__).resolve().parent.parent
DIM = 64
BUCKETS = (32, 64, 128)
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_BF16_P = dict(rtol=2e-3, atol=2e-3)
TOL_BF16_S = dict(rtol=2e-2, atol=2e-2)


def _jax(cfg):
    """The JAX package's ModelConfig with the port config's fields."""
    return JaxModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JaxToadMIL(_jax(ModelConfig(in_dim=DIM, n_classes=6))).init(jax.random.PRNGKey(0)))


def _bags(count, seed=0, lo=5, hi=120):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal((int(rng.integers(lo, hi)), DIM)).astype(np.float32), int(rng.integers(0, 2)))
        for _ in range(count)
    ]


def _jax_preds(jax_params, cfg, bags, attention=True):
    with JaxBatcher(jax_params, _jax(cfg), JaxServeConfig(max_batch=8, max_wait_ms=50, bucket_sizes=BUCKETS,
                                                    need_attention=attention)) as b:
        return [f.result(timeout=120) for f in [b.submit(x, s) for x, s in bags]]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_batcher_matches_jax_batcher(jax_params, compute):
    cfg = ModelConfig(in_dim=DIM, n_classes=6, compute_dtype=compute)
    bags = _bags(11, seed=1)
    ref = _jax_preds(jax_params, cfg, bags)
    with DynamicBatcher(params_from_jax(jax_params), cfg, ServeConfig(
            max_batch=8, max_wait_ms=50, bucket_sizes=BUCKETS, need_attention=True), device="cpu") as b:
        assert b.cfg.transfer_dtype == compute  # 'auto': bf16 wire iff bf16 compute
        got = [f.result(timeout=120) for f in [b.submit(x, s) for x, s in bags]]
    tol_p, tol_s = (TOL_F32, TOL_F32) if compute == "float32" else (TOL_BF16_P, TOL_BF16_S)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.y_prob, r.y_prob, **tol_p)
        np.testing.assert_allclose(g.site_prob, r.site_prob, **tol_p)
        np.testing.assert_allclose(g.attention, r.attention, **tol_s)
        np.testing.assert_allclose(g.site_attention, r.site_attention, **tol_s)
        assert g.y_hat == r.y_hat and g.site_hat == r.site_hat
        assert [i for i, _ in g.topk] == [i for i, _ in r.topk]


def test_batcher_coalesces_and_drains(jax_params):
    cfg = ModelConfig(in_dim=DIM, n_classes=6)
    b = DynamicBatcher(params_from_jax(jax_params), cfg,
                       ServeConfig(max_batch=16, max_wait_ms=200, bucket_sizes=BUCKETS), device="cpu")
    rng = np.random.default_rng(2)
    futures = [b.submit(rng.standard_normal((20, DIM)).astype(np.float32), 0) for _ in range(12)]
    assert b.close(timeout=60) is True  # graceful: everything accepted is served
    assert all(f.done() and f.exception() is None for f in futures)
    s = b.stats()
    assert s.requests == 12 and s.batched_slides == 12 and s.batches < 12
    assert s.assemble_s > 0 and s.forward_s > 0
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.zeros((3, DIM), np.float32), 0)


def test_batcher_validation_truncation_and_temperature(jax_params):
    cfg = ModelConfig(in_dim=DIM, n_classes=6)
    params = params_from_jax(jax_params)
    feats = np.random.default_rng(3).standard_normal((300, DIM)).astype(np.float32)
    with DynamicBatcher(params, cfg, ServeConfig(bucket_sizes=BUCKETS), device="cpu") as b:
        long = b.predict(feats, 1)
        head = b.predict(feats[:128], 1)  # longer than the top bucket: head-truncated
        np.testing.assert_allclose(long.y_prob, head.y_prob, rtol=1e-6, atol=1e-7)
        with pytest.raises(ValueError, match="in_dim"):
            b.submit(np.zeros((10, DIM + 1), np.float32), 0)
        with pytest.raises(ValueError, match="empty"):
            b.submit(np.zeros((0, DIM), np.float32), 0)
        assert b.warmup(batch_sizes=(1, 4)) == 6
        base = b.predict(feats[:50], 0)
    with DynamicBatcher(params, cfg, ServeConfig(bucket_sizes=BUCKETS, temperature=2.0), device="cpu") as b:
        hot = b.predict(feats[:50], 0)
    np.testing.assert_allclose(hot.y_prob, apply_temperature(base.y_prob[None], 2.0)[0], rtol=1e-6, atol=1e-7)
    assert hot.y_hat == base.y_hat


def test_cuda_device_refused_without_cuda(jax_params):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DynamicBatcher(params_from_jax(jax_params), ModelConfig(in_dim=DIM, n_classes=6), device="cuda")


@pytest.fixture(scope="module")
def http_service(jax_params, tmp_path_factory):
    root = tmp_path_factory.mktemp("port_bags")
    cfg = ModelConfig(in_dim=DIM, n_classes=6)
    svc = InferenceService(params_from_jax(jax_params), cfg,
                           ServeConfig(max_batch=8, max_wait_ms=100, bucket_sizes=BUCKETS),
                           bag_root=root, device="cpu")
    server, port = serve_in_thread(svc)
    yield svc, port, root
    server.shutdown()
    server.server_close()
    svc.close()


def _post(port, body, headers):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/predict", body=body, headers=headers)
    r = conn.getresponse()
    out = (r.status, json.loads(r.read()))
    conn.close()
    return out


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    r = conn.getresponse()
    out = (r.status, json.loads(r.read()))
    conn.close()
    return out


def test_http_routes_match_jax(http_service, jax_params):
    svc, port, root = http_service
    bags = _bags(5, seed=4)
    ref = _jax_preds(jax_params, ModelConfig(in_dim=DIM, n_classes=6), bags)
    x0, s0 = bags[0]
    np.save(root / "b1.npy", bags[1][0])
    torch.save(torch.from_numpy(bags[2][0]), root / "b2.pt")
    answers = [
        _post(port, json.dumps({"features_b64": base64.b64encode(x0.tobytes()).decode(), "shape": list(x0.shape),
                                "sex": s0, "attention": True}), {"Content-Type": "application/json"}),
        _post(port, json.dumps({"bag_path": "b1.npy", "sex": bags[1][1], "attention": True}), {}),
        _post(port, json.dumps({"bag_path": "b2.pt", "sex": bags[2][1], "attention": True}), {}),
        _post(port, bags[3][0].tobytes(), {"Content-Type": "application/octet-stream",
                                           "X-Toad-Shape": f"{len(bags[3][0])},{DIM}", "X-Toad-Sex": str(bags[3][1]),
                                           "X-Toad-Attention": "1"}),
        _post(port, json.dumps({"features": bags[4][0].tolist(), "sex": "M" if bags[4][1] else "F",
                                "attention": True, "top_k": 2}), {}),
    ]
    for (status, out), r in zip(answers, ref):
        assert status == 200, out
        np.testing.assert_allclose(out["y_prob"], r.y_prob, **TOL_F32)
        np.testing.assert_allclose(out["site_prob"], r.site_prob, **TOL_F32)
        np.testing.assert_allclose(out["attention"], r.attention, **TOL_F32)
        assert out["y_hat"] == r.y_hat
    assert len(answers[-1][1]["topk"]) == 2


def test_http_bf16_octet_route(http_service):
    """A bf16 body equals the f32 body of the same bf16-rounded values."""
    svc, port, _ = http_service
    x = torch.randn(40, DIM, generator=torch.Generator().manual_seed(5)).bfloat16()
    hdr = {"Content-Type": "application/octet-stream", "X-Toad-Shape": f"40,{DIM}", "X-Toad-Sex": "F"}
    st_bf, out_bf = _post(port, x.view(torch.int16).numpy().tobytes(), {**hdr, "X-Toad-Dtype": "bfloat16"})
    st_f, out_f = _post(port, x.float().numpy().tobytes(), hdr)
    assert st_bf == st_f == 200
    np.testing.assert_allclose(out_bf["y_prob"], out_f["y_prob"], rtol=0, atol=0)
    st, err = _post(port, b"\0" * 10, {**hdr, "X-Toad-Dtype": "bfloat16"})
    assert st == 400 and "bytes" in err["error"]


def test_http_healthz_stats_and_errors(http_service):
    svc, port, root = http_service
    assert _get(port, "/healthz") == (200, {"status": "ok", "device": "cpu"})
    status, stats = _get(port, "/stats")
    assert status == 200 and stats["config"]["device"] == "cpu" and stats["kernel_launches"] == 0
    assert _get(port, "/nope")[0] == 404
    assert _post(port, json.dumps({"bag_path": "../escape.npy", "sex": 0}), {})[0] == 403
    assert _post(port, json.dumps({"bag_path": "missing.npy", "sex": 0}), {})[0] == 404
    assert _post(port, json.dumps({"features": [[0.0] * (DIM + 1)], "sex": 0}), {})[0] == 400
    assert _post(port, json.dumps({"features": [[0.0] * DIM], "sex": "X"}), {})[0] == 400
    assert _post(port, b"abc", {"Content-Type": "application/octet-stream", "X-Toad-Sex": "F"})[0] == 400


def test_http_concurrent_clients_coalesce(http_service):
    svc, port, _ = http_service
    before = svc.stats()
    bags = _bags(12, seed=6, lo=70, hi=120)  # one bucket, so they can share forwards
    outs = [None] * len(bags)

    def go(i):
        x, s = bags[i]
        outs[i] = _post(port, x.tobytes(), {"Content-Type": "application/octet-stream",
                                            "X-Toad-Shape": f"{len(x)},{DIM}", "X-Toad-Sex": str(s)})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(bags))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert all(o is not None and o[0] == 200 for o in outs)
    after = svc.stats()
    assert after["requests"] - before["requests"] == 12
    assert after["batches"] - before["batches"] < 12


def test_http_body_cap_and_nonloopback_bag_paths(jax_params):
    cfg = ModelConfig(in_dim=DIM, n_classes=6)
    svc = InferenceService(params_from_jax(jax_params), cfg, ServeConfig(bucket_sizes=BUCKETS), device="cpu")
    try:
        server = make_http_server(svc, "127.0.0.1", 0, max_body_bytes=1000)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        port = server.server_address[1]
        assert _post(port, b"\0" * 2000, {"Content-Type": "application/octet-stream"})[0] == 413
        server.shutdown()
        server.server_close()
        exposed = make_http_server(svc, "0.0.0.0", 0)
        threading.Thread(target=exposed.serve_forever, daemon=True).start()
        assert _post(exposed.server_address[1], json.dumps({"bag_path": "x.npy", "sex": 0}), {})[0] == 403
        exposed.shutdown()
        exposed.server_close()
    finally:
        svc.close()


def test_serve_cli_requires_cuda_or_explicit_cpu(jax_params, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    ckpt = tmp_path / "s_0_checkpoint.pt"
    model_sd = params_from_jax(jax_params)
    torch.save(reference_state_dict(model_sd), ckpt)
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-m", "toad_tpu_torch", "serve", "--ckpt", str(ckpt),
                          "--encoding_size", str(DIM), "--n_classes", "6"],
                         capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr and "--device cpu" in out.stderr


def _serve_cli(jax_params, tmp_path, *extra):
    """Start the serve CLI on the CPU (checkpoint, bag_root, warmup), send one
    bag_path request, read /stats, stop it with SIGTERM: (response, stats,
    the lines up to "serving on", the lines after it, exit status)."""
    ckpt = tmp_path / "s_0_checkpoint.pt"
    torch.save(reference_state_dict(params_from_jax(jax_params)), ckpt)
    x = np.random.default_rng(7).standard_normal((50, DIM)).astype(np.float32)
    np.save(tmp_path / "slide.npy", x)
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "toad_tpu_torch", "serve", "--ckpt", str(ckpt), "--device", "cpu", "--port", "0",
         "--encoding_size", str(DIM), "--n_classes", "6", "--buckets", "128,32,64", "--bag_root", str(tmp_path),
         "--warmup", "32", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=tmp_path,
    )
    try:
        lines = []
        while True:
            line = proc.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
            if line.startswith("serving on"):
                break
        port = int(line.split()[2].rsplit(":", 1)[1])
        status, out = _post(port, json.dumps({"bag_path": "slide.npy", "sex": "F"}), {})
        assert status == 200
        stats = _get(port, "/stats")[1]
        proc.terminate()
        rest = proc.communicate(timeout=60)[0]
        return out, stats, lines, rest, proc.returncode
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serve_cli_on_cpu_answers_and_drains(jax_params, tmp_path):
    """The CLI end to end on the CPU: checkpoint, task labels, bag_path, SIGTERM drain."""
    out, stats, lines, rest, returncode = _serve_cli(jax_params, tmp_path)
    assert len(out["y_prob"]) == 6
    assert stats["config"]["buckets"] == [32, 64, 128]
    assert returncode == 0
    assert "in-flight requests drained" in rest
    assert any(ln.startswith("warmup: 2 shape variants") for ln in lines)


def test_serve_cli_takes_the_jax_cli_s_xla_only_flags_with_one_note(jax_params, tmp_path):
    """--pallas and --compile_cache configure XLA in the JAX CLI: here the
    server starts with them, notes each once, and answers as without them."""
    (tmp_path / "plain").mkdir()
    (tmp_path / "flags").mkdir()
    plain = _serve_cli(jax_params, tmp_path / "plain")
    flagged = _serve_cli(jax_params, tmp_path / "flags", "--pallas", "--compile_cache", "cache")
    assert plain[4] == flagged[4] == 0
    assert flagged[0] == plain[0] and len(flagged[0]["y_prob"]) == 6
    head = "".join(flagged[2])
    assert head.count("--pallas has no effect here") == 1 and head.count("--compile_cache has no effect here") == 1
    assert "has no effect here" not in "".join(plain[2]) and not (tmp_path / "flags" / "cache").exists()


def test_cli_helpers(tmp_path):
    assert [common.parse_sex(v) for v in ("F", "m", "female", "1", "0.0")] == [0, 1, 0, 1, 0]
    with pytest.raises(ValueError):
        common.parse_sex("x")
    assert common.resolve_buckets(None) is None
    assert common.resolve_buckets("300,100") == (100, 300)
    with pytest.raises(SystemExit):
        common.resolve_buckets("0,64")
    with pytest.raises(SystemExit):
        common.resolve_buckets("auto")
    cal = tmp_path / "fold_0_calibration.json"
    cal.write_text(json.dumps({"temperature": 1.7}))
    assert common.resolve_temperature(1.0, cal) == 1.7
    assert common.resolve_temperature(1.3, None) == 1.3
    with pytest.raises(SystemExit):
        common.resolve_temperature(2.0, cal)


def test_bags_and_padding_match_jax(tmp_path):
    from toad_tpu.data import bags as jax_bags
    from toad_tpu.data import batching as jax_batching
    from toad_tpu.evaluate.calibration import apply_temperature as jax_apply_temperature

    x = np.random.default_rng(8).standard_normal((37, DIM)).astype(np.float32)
    torch.save({"features": torch.from_numpy(x)}, tmp_path / "a.pt")
    np.save(tmp_path / "b.npy", x)
    np.savez(tmp_path / "c.npz", features=x)
    jax_bags.save_int8_bag(tmp_path / "d.npz", x)
    for name in ("a.pt", "b.npy", "c.npz", "d.npz"):
        np.testing.assert_array_equal(load_bag(tmp_path / name), jax_bags.load_bag(tmp_path / name))
    torch.save(torch.from_numpy(x).bfloat16(), tmp_path / "e.pt")
    np.testing.assert_array_equal(load_bag(tmp_path / "e.pt"), torch.from_numpy(x).bfloat16().float().numpy())
    with pytest.raises(ValueError, match="unsupported"):
        load_bag(tmp_path / "f.txt")
    for n in (1, 32, 33, 500):
        assert bucket_for(n, BUCKETS) == jax_batching.bucket_for(n, BUCKETS)
    for got, want in zip(_pad_bag(x, 64), jax_batching._pad_bag(x, 64)):
        np.testing.assert_array_equal(got, want)
    p = np.random.default_rng(9).dirichlet(np.ones(6), size=4)
    np.testing.assert_allclose(apply_temperature(p, 1.5), jax_apply_temperature(p, 1.5), rtol=0, atol=0)
