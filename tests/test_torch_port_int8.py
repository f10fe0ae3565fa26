"""int8 serving slice of the PyTorch port against the JAX package.

Inputs are numpy from a seed, as tests/test_int8.py builds them (in_dim=256,
n_classes=6, N of 256 or 512). Both packages get the same integers: the rows
are quantized once and the JAX int8 weights cross with qparams_from_jax.

Tolerances:
- quantized rows, weights and scales: exactly equal (the same f32 division,
  round half to even and clip in both packages).
- plain_int8_pool vs the Pallas kernel in interpret mode: the integer GEMMs
  agree except where XLA rounds a dequantized value differently in its last
  bit, which can move one requantized value by one step, and tanh/sigmoid
  round differently; the test_int8.py tolerances of the kernel against its
  oracle apply: M relative 5e-3, raw scores absolute 5e-3.
- against the XLA oracle xla_int8_pool, which keeps gated, Wc and h2 in f32
  where the kernels round them to bf16: the same 5e-3 (bf16 rounding of
  values of O(1) averaged over the bag and the 384-wide score head).
- forward_int8 vs apply_int8 (XLA path), and the int8 batcher and routes vs
  the JAX int8 batcher: the same difference carried through the heads,
  2e-3 on probabilities and 1e-2 on O(1) logits and raw attention.
"""

import base64
import dataclasses
import http.client
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toad_tpu.config import ModelConfig as JaxModelConfig
from toad_tpu.data import bags as jax_bags
from toad_tpu.models.toad_mil import ToadMIL as JaxToadMIL
from toad_tpu.ops import quantize as jax_quantize
from toad_tpu.ops.pallas_pool import pallas_pool_int8
from toad_tpu.serve import DynamicBatcher as JaxBatcher
from toad_tpu.serve import ServeConfig as JaxServeConfig
from toad_tpu_torch.cli import convert
from toad_tpu_torch.config import ModelConfig
from toad_tpu_torch.data.bags import load_bag, load_bag_quantized, save_int8_bag
from toad_tpu_torch.models.interop import params_from_jax, qparams_from_jax, reference_state_dict
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.ops import _build, cuda_pool, cuda_pool_int8, quantize
from toad_tpu_torch.ops.fused_pool import fused_int8_pool
from toad_tpu_torch.pipeline.featurize import write_bag
from toad_tpu_torch.serve import DynamicBatcher, InferenceService, ServeConfig, serve_in_thread

REPO = Path(__file__).resolve().parent.parent
DIM = 256
N_CLASSES = 6
BUCKETS = (64, 128, 256)
TOL_M_REL = 5e-3
TOL_S = 5e-3
TOL_P = dict(rtol=2e-3, atol=2e-3)
TOL_LOGITS = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jax_params():
    p = jax.tree.map(np.asarray, JaxToadMIL(JaxModelConfig(in_dim=DIM, n_classes=N_CLASSES)).init(jax.random.PRNGKey(0)))
    # nonzero biases so that the bias paths (and relu(b1) of zero rows) are compared too
    rng = np.random.default_rng(7)
    for lin in (*p["trunk"].values(), *p["attn"].values()):
        lin["b"] = (rng.standard_normal(lin["b"].shape) * 0.05).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def jax_qparams(jax_params):
    return jax.tree.map(np.asarray, jax_quantize.quantize_pool_params(jax_params))


def _model(jax_params):
    model = ToadMIL(ModelConfig(in_dim=DIM, n_classes=N_CLASSES))
    model.load_state_dict(params_from_jax(jax_params))
    return model.eval().requires_grad_(False)


def _bag(b, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, DIM)).astype(np.float32)
    mask = (rng.random((b, n)) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    return x, mask


def _quantized(x):
    q, s = jax_quantize.quantize_rows_np(x.reshape(-1, x.shape[-1]))
    return q.reshape(x.shape), s.reshape(x.shape[:-1])


def test_quantize_rows_match_jax_exactly():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 128)) * rng.random((64, 1)) * 10).astype(np.float32)
    x[7] = 0.0  # a padding row
    # rows whose scale is exactly 1 and 2, so that x / scale lands on halves:
    # round half to even must give 0, 2, 2, -4, 4 and 0, 2, 2, 4
    x[3, :6] = [127.0, 0.5, 1.5, 2.5, -3.5, 4.5]
    x[3, 6:] = 0.0
    x[5, :5] = [254.0, 1.0, 3.0, 5.0, 9.0]
    x[5, 5:] = 0.0
    qj, sj = jax_quantize.quantize_rows_np(x)
    qn, sn = quantize.quantize_rows_np(x)
    qt, st = quantize.quantize_rows(torch.from_numpy(x))
    for q, s in ((qn, sn), (qt.numpy(), st.numpy())):
        np.testing.assert_array_equal(q, qj)
        np.testing.assert_array_equal(s, sj)
        assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(qn[3, :6], [127, 0, 2, 2, -4, 4])
    np.testing.assert_array_equal(qn[5, :5], [127, 0, 2, 2, 4])
    assert np.all(qn[7] == 0)
    # the device twin of the JAX package gives the same integers
    qd, _ = jax.device_get(jax_quantize.quantize_rows(jnp.asarray(x)))
    np.testing.assert_array_equal(qt.numpy(), qd)
    # any leading batch dims
    qb, sb = quantize.quantize_rows(torch.from_numpy(x).reshape(4, 16, 128))
    np.testing.assert_array_equal(qb.reshape(64, 128).numpy(), qj)
    np.testing.assert_array_equal(sb.reshape(64).numpy(), sj)


def test_quantize_pool_params_match_jax_and_roundtrip(jax_params, jax_qparams):
    model = _model(jax_params)
    qp = quantize.quantize_pool_params(model.pool_params())
    assert set(qp) == set(jax_qparams)
    for k, want in jax_qparams.items():
        got = qp[k].numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k, got in qparams_from_jax(jax_qparams).items():
        assert got.dtype == qp[k].dtype
        torch.testing.assert_close(got, qp[k], rtol=0, atol=0)


def test_quantize_pool_params_ungated_raises():
    model = ToadMIL(ModelConfig(in_dim=DIM, gate=False))
    with torch.no_grad(), pytest.raises(ValueError, match="gated"):
        quantize.quantize_pool_params(model.pool_params())


def _pool_cases():
    # odd B: the JAX side takes K2; even B: K2b in classification mode
    yield "odd_b", *_bag(3, 256, seed=1)
    yield "even_b", *_bag(4, 512, seed=2)
    x, mask = _bag(2, 256, seed=3)
    mask[1] = 0.0  # a fully-masked bag sharing a pair with a live one
    yield "masked_pair", x, mask


POOL_CASES = list(_pool_cases())


def _plain(jax_qparams, x, mask, scored):
    xq, sx = _quantized(x)
    m, s = quantize.plain_int8_pool(qparams_from_jax(jax_qparams), torch.from_numpy(xq), torch.from_numpy(sx),
                                    torch.from_numpy(mask), with_scores=scored)
    return (xq, sx), m.numpy(), (None if s is None else s.transpose(1, 2).numpy())


def _check_pool(m, s, m_ref, s_ref, mask):
    m_ref = np.asarray(m_ref)
    rel = np.abs(m - m_ref).max() / (np.abs(m_ref).max() + 1e-9)
    assert rel < TOL_M_REL, rel
    if s_ref is not None:
        assert np.abs(s - np.asarray(s_ref)).max() < TOL_S
    dead = mask.sum(1) == 0
    assert np.all(m[dead] == 0.0) and np.isfinite(m).all()


@pytest.mark.parametrize("scored", [True, False], ids=["scored", "classification"])
@pytest.mark.parametrize("case", POOL_CASES, ids=[c[0] for c in POOL_CASES])
def test_plain_int8_pool_matches_pallas_interpret(jax_qparams, case, scored):
    _, x, mask = case
    (xq, sx), m, s = _plain(jax_qparams, x, mask, scored)
    out = pallas_pool_int8(jax_qparams, jnp.asarray(xq), jnp.asarray(sx), jnp.asarray(mask),
                           return_scores=scored, with_attention=scored, interpret=True)
    if scored:
        _check_pool(m, s, out[0], out[2], mask)
    else:
        assert s is None and out[1] is None
        _check_pool(m, None, out[0], None, mask)


@pytest.mark.parametrize("case", POOL_CASES, ids=[c[0] for c in POOL_CASES])
def test_plain_int8_pool_matches_xla_oracle(jax_qparams, case):
    _, x, mask = case
    (xq, sx), m, s = _plain(jax_qparams, x, mask, True)
    m_ref, s_ref = jax_quantize.xla_int8_pool(jax_qparams, jnp.asarray(xq), jnp.asarray(sx), jnp.asarray(mask))
    _check_pool(m, s, m_ref, s_ref, mask)


@pytest.mark.parametrize("mode", ["attention", "classification", "attention_only"])
def test_forward_int8_matches_apply_int8(jax_params, jax_qparams, mode):
    x, mask = _bag(4, 256, seed=4)
    sex = np.array([0, 1, 0, 1], np.int32)
    xq, sx = _quantized(x)
    kw = dict(need_attention=mode != "classification", attention_only=mode == "attention_only")
    ref = JaxToadMIL(JaxModelConfig(in_dim=DIM, n_classes=N_CLASSES, use_pallas=False)).apply_int8(
        jax_params, jax_qparams, jnp.asarray(xq), jnp.asarray(sx), jnp.asarray(mask), jnp.asarray(sex), **kw)
    model = _model(jax_params)  # outside inference mode: its weights must track versions
    with torch.inference_mode():
        got = model.forward_int8(torch.from_numpy(xq), torch.from_numpy(sx), torch.from_numpy(mask),
                                              torch.from_numpy(sex), **kw)
    if mode == "attention_only":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL_LOGITS)
        return
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits), **TOL_LOGITS)
    np.testing.assert_allclose(got.y_prob.numpy(), np.asarray(ref.y_prob), **TOL_P)
    np.testing.assert_allclose(got.site_prob.numpy(), np.asarray(ref.site_prob), **TOL_P)
    np.testing.assert_array_equal(got.y_hat.numpy(), np.asarray(ref.y_hat))
    if mode == "attention":
        np.testing.assert_allclose(got.attention.numpy(), np.asarray(ref.attention), **TOL_LOGITS)
        assert np.all(np.isneginf(got.attention.numpy()[np.broadcast_to(mask[:, None] == 0, got.attention.shape)]))
    else:
        assert got.attention is None


def test_int8_operands_quantize_once_and_follow_the_weights(jax_params):
    model = _model(jax_params)
    with torch.no_grad():
        qp, packed = model.int8_operands()
        assert packed is None  # off CUDA nothing is packed for the kernel
        assert model.int8_operands()[0] is qp
        model.trunk.fc1.weight.mul_(2.0)
        fresh, _ = model.int8_operands()
        assert fresh is not qp
        torch.testing.assert_close(fresh["sw1"], qp["sw1"] * 2, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(fresh["w1q"].numpy(), qp["w1q"].numpy())


def test_pack_qparams_layout(jax_qparams):
    qp = qparams_from_jax(jax_qparams)
    ops = cuda_pool_int8.pack_qparams(qp)
    a_dim = qp["wc"].shape[0]
    g = cuda_pool.GATE_GROUP
    np.testing.assert_array_equal(ops.w1.numpy(), jax_qparams["w1q"].T)
    np.testing.assert_array_equal(ops.w2.numpy(), jax_qparams["w2q"].T)
    for grp in range(a_dim // g):
        u, v = slice(grp * g, (grp + 1) * g), slice(a_dim + grp * g, a_dim + (grp + 1) * g)
        rows = slice(2 * g * grp, 2 * g * (grp + 1))
        np.testing.assert_array_equal(ops.wab[rows].numpy(), np.concatenate([jax_qparams["wabq"][:, u].T,
                                                                              jax_qparams["wabq"][:, v].T]))
        for name in ("swab", "bab"):
            np.testing.assert_array_equal(getattr(ops, name)[rows].numpy(),
                                          np.concatenate([jax_qparams[name][u], jax_qparams[name][v]]))
    assert ops.wc.dtype == torch.bfloat16 and ops.wc.shape == (a_dim, 2)
    np.testing.assert_array_equal(ops.wc.float().numpy(), jnp.asarray(jax_qparams["wc"], jnp.bfloat16).astype(np.float32))
    assert all(t.is_contiguous() for t in ops)
    assert {t.dtype for t in (ops.w1, ops.w2, ops.wab)} == {torch.int8}


def test_int8_wrapper_refuses_cpu_tensors_and_other_devices(jax_qparams):
    x, mask = _bag(1, 64, seed=5)
    xq, sx = (torch.from_numpy(a) for a in _quantized(x))
    qp = qparams_from_jax(jax_qparams)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_pool_int8.pool_int8(cuda_pool_int8.pack_qparams(qp), xq, sx, torch.from_numpy(mask), True)
    assert not _build.is_loaded()
    with pytest.raises(ValueError, match="no int8 pooling path"):
        fused_int8_pool(qp, xq.to("meta"), sx, torch.from_numpy(mask))
    m, s = fused_int8_pool(qp, xq, sx, torch.from_numpy(mask))  # a CPU tensor: the plain version
    assert s is None and m.shape == (1, 2, 512)


def _cfg():
    return ModelConfig(in_dim=DIM, n_classes=N_CLASSES)


def _bags(count, seed, lo=20, hi=300):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((int(rng.integers(lo, hi)), DIM)).astype(np.float32), int(rng.integers(0, 2)))
            for _ in range(count)]


def _jax_int8_preds(jax_params, bags, attention):
    cfg = JaxModelConfig(**dataclasses.asdict(_cfg()))
    sc = JaxServeConfig(max_batch=8, max_wait_ms=50, bucket_sizes=BUCKETS, need_attention=attention, int8=True)
    with JaxBatcher(jax_params, cfg, sc) as b:
        return [f.result(timeout=120) for f in [b.submit(x, s) for x, s in bags]]


def _check_pred(got, ref):
    np.testing.assert_allclose(np.asarray(got["y_prob"] if isinstance(got, dict) else got.y_prob), ref.y_prob, **TOL_P)
    site = got["site_prob"] if isinstance(got, dict) else got.site_prob
    np.testing.assert_allclose(np.asarray(site), ref.site_prob, **TOL_P)
    assert (got["y_hat"] if isinstance(got, dict) else got.y_hat) == ref.y_hat


@pytest.mark.parametrize("attention", [True, False], ids=["attention", "classification"])
def test_int8_batcher_matches_jax_int8_batcher(jax_params, attention):
    bags = _bags(9, seed=6, hi=400)  # some longer than the top bucket: head-truncated
    assert any(len(x) > BUCKETS[-1] for x, _ in bags)
    ref = _jax_int8_preds(jax_params, bags, attention)
    sc = ServeConfig(max_batch=8, max_wait_ms=50, bucket_sizes=BUCKETS, need_attention=attention, int8=True)
    with DynamicBatcher(params_from_jax(jax_params), _cfg(), sc, device="cpu") as b:
        got = [f.result(timeout=120) for f in [b.submit(x, s) for x, s in bags]]
    for (x, _), g, r in zip(bags, got, ref):
        _check_pred(g, r)
        assert g.attention.shape == r.attention.shape == ((min(len(x), BUCKETS[-1]),) if attention else (0,))
        if attention:
            np.testing.assert_allclose(g.attention, r.attention, **TOL_LOGITS)
            np.testing.assert_allclose(g.site_attention, r.site_attention, **TOL_LOGITS)


def test_int8_batcher_submit_quantized_checks_and_warmup(jax_params):
    x = np.random.default_rng(8).standard_normal((100, DIM)).astype(np.float32)
    xq, sx = quantize.quantize_rows_np(x)
    sc = ServeConfig(max_batch=4, max_wait_ms=5, bucket_sizes=BUCKETS, int8=True)
    with DynamicBatcher(params_from_jax(jax_params), _cfg(), sc, device="cpu") as b:
        # pre-quantized rows are exactly what the handler thread would make
        np.testing.assert_array_equal(b.predict(x, 1).y_prob, b.submit_quantized(xq, sx, 1).result().y_prob)
        with pytest.raises(TypeError, match="int8"):
            b.submit_quantized(x, sx, 0)
        with pytest.raises(ValueError, match="scales"):
            b.submit_quantized(xq, sx[:-1], 0)
        with pytest.raises(ValueError, match="int8"):
            b.submit_quantized(xq[:, :-1], sx, 0)
        with pytest.raises(ValueError, match="empty"):
            b.submit_quantized(xq[:0], sx[:0], 0)
        assert b.warmup(batch_sizes=(1, 4)) == 6
        assert b.stats().requests == 2
    with DynamicBatcher(params_from_jax(jax_params), _cfg(), ServeConfig(bucket_sizes=BUCKETS), device="cpu") as bf:
        with pytest.raises(ValueError, match="int8=True"):
            bf.submit_quantized(xq, sx, 0)


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


@pytest.fixture(scope="module")
def int8_service(jax_params, tmp_path_factory):
    root = tmp_path_factory.mktemp("int8_bags")
    svc = InferenceService(params_from_jax(jax_params), _cfg(),
                           ServeConfig(max_batch=8, max_wait_ms=20, bucket_sizes=BUCKETS, int8=True),
                           bag_root=root, device="cpu")
    server, port = serve_in_thread(svc)
    yield svc, port, root
    server.shutdown()
    server.server_close()
    svc.close()


def _int8_json(xq, sx, sex):
    return json.dumps({"features_int8_b64": base64.b64encode(xq.tobytes()).decode(),
                       "scales_b64": base64.b64encode(sx.tobytes()).decode(),
                       "shape": list(xq.shape), "sex": sex, "attention": True})


def _octet(body, n, sex, dtype):
    return body, {"Content-Type": "application/octet-stream", "X-Toad-Shape": f"{n},{DIM}",
                  "X-Toad-Sex": str(sex), "X-Toad-Dtype": dtype, "X-Toad-Attention": "1"}


def test_http_int8_routes_match_jax(int8_service, jax_params):
    svc, port, root = int8_service
    bags = _bags(5, seed=9)
    ref = _jax_int8_preds(jax_params, bags, attention=True)
    quant = [quantize.quantize_rows_np(x) for x, _ in bags]
    jax_bags.save_int8_bag(root / "slide2.npz", bags[2][0])  # a store written by the JAX package
    save_int8_bag(root / "slide3.npz", bags[3][0])  # and one written by the port
    (x0, s0), (x1, s1), _, (_, s3), (x4, s4) = bags
    answers = [
        _post(port, _int8_json(*quant[0], s0), {"Content-Type": "application/json"}),
        _post(port, *_octet(quant[1][0].tobytes() + quant[1][1].tobytes(), len(x1), s1, "int8")),
        _post(port, json.dumps({"bag_path": "slide2.npz", "sex": bags[2][1], "attention": True}), {}),
        _post(port, json.dumps({"bag_path": "slide3.npz", "sex": s3, "attention": True}), {}),
        _post(port, *_octet(x4.tobytes(), len(x4), s4, "float32")),  # quantized on the handler thread
    ]
    for (status, out), r in zip(answers, ref):
        assert status == 200, out
        _check_pred(out, r)
        np.testing.assert_allclose(out["attention"], r.attention, **TOL_LOGITS)
    status, stats = _get(port, "/stats")
    assert status == 200 and stats["config"]["int8"] is True
    assert stats["int8_kernel_launches"] == 0  # the CPU serves through the plain version


def test_http_int8_errors(int8_service, jax_params):
    _, port, _ = int8_service
    xq, sx = quantize.quantize_rows_np(np.ones((10, DIM), np.float32))
    doc = json.loads(_int8_json(xq, sx, 0))
    assert _post(port, json.dumps({**doc, "scales_b64": base64.b64encode(sx[:-1].tobytes()).decode()}), {})[0] == 400
    assert _post(port, json.dumps({k: v for k, v in doc.items() if k != "scales_b64"}), {})[0] == 400
    assert _post(port, json.dumps({**doc, "shape": [11, DIM]}), {})[0] == 400
    assert _post(port, *_octet(xq.tobytes() + sx[:-1].tobytes(), 10, 0, "int8"))[0] == 400
    # a server not in int8 mode answers an int8 payload with 400
    svc = InferenceService(params_from_jax(jax_params), _cfg(), ServeConfig(bucket_sizes=BUCKETS), device="cpu")
    server, float_port = serve_in_thread(svc)
    try:
        for body, hdr in ((json.dumps(doc), {}), _octet(xq.tobytes() + sx.tobytes(), 10, 0, "int8")):
            status, out = _post(float_port, body, hdr)
            assert status == 400 and "int8" in out["error"]
        assert _get(float_port, "/stats")[1]["config"]["int8"] is False
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_int8_bag_store_interop(tmp_path):
    x = np.random.default_rng(10).standard_normal((37, DIM)).astype(np.float32)
    coords = np.arange(74).reshape(37, 2)
    save_int8_bag(tmp_path / "port.npz", x, coords)
    jax_bags.save_int8_bag(tmp_path / "jax.npz", x, coords)
    for name in ("port.npz", "jax.npz"):
        for got, want in zip(load_bag_quantized(tmp_path / name), jax_bags.load_bag_quantized(tmp_path / "jax.npz")):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(load_bag(tmp_path / name), jax_bags.load_bag(tmp_path / name))
    np.save(tmp_path / "plain.npy", x)
    assert load_bag_quantized(tmp_path / "plain.npy") is None
    np.savez(tmp_path / "float.npz", features=x)
    assert load_bag_quantized(tmp_path / "float.npz") is None
    with pytest.raises(ValueError, match="npz"):
        save_int8_bag(tmp_path / "bad.npy", x)


def test_write_bag_formats_read_back_in_both_packages(tmp_path):
    x = np.random.default_rng(11).standard_normal((20, DIM)).astype(np.float32)
    coords = np.arange(40).reshape(20, 2)
    for ext in (".npy", ".npz", ".pt"):
        write_bag(tmp_path / f"b{ext}", x, coords)
        feats, got_coords = load_bag(tmp_path / f"b{ext}", with_coords=True)
        np.testing.assert_array_equal(feats, x)
        np.testing.assert_array_equal(got_coords, coords)
        np.testing.assert_array_equal(jax_bags.load_bag(tmp_path / f"b{ext}"), x)
    try:
        import h5py  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="h5py"):
            write_bag(tmp_path / "b.h5", x)
    else:
        write_bag(tmp_path / "b.h5", x, coords)
        np.testing.assert_array_equal(jax_bags.load_bag(tmp_path / "b.h5"), x)
    with pytest.raises(ValueError, match="npz"):
        write_bag(tmp_path / "c.npy", x, int8=True)
    with pytest.raises(ValueError, match="unsupported"):
        write_bag(tmp_path / "c.txt", x)


def test_convert_cli_int8_matches_jax_save_int8_bag(tmp_path, capsys):
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(12)
    bags = {f"slide_{i}": rng.standard_normal((int(rng.integers(5, 80)), DIM)).astype(np.float32) for i in range(3)}
    for name, x in bags.items():
        torch.save(torch.from_numpy(x), src / f"{name}.pt")
    convert.main(["--data_dir", str(src), "--out_dir", str(tmp_path / "q")])
    assert "converted 3 bags" in capsys.readouterr().out
    for name, x in bags.items():
        jax_bags.save_int8_bag(tmp_path / "ref" / f"{name}.npz", x)
        got, want = np.load(tmp_path / "q" / f"{name}.npz"), np.load(tmp_path / "ref" / f"{name}.npz")
        for key in ("features_int8", "scales"):
            assert got[key].dtype == want[key].dtype and got[key].tobytes() == want[key].tobytes()
    convert.main(["--data_dir", str(src), "--out_dir", str(tmp_path / "q"), "--skip_done"])
    out = capsys.readouterr().out
    assert "converted 0 bags" in out and "skipped 3" in out
    with pytest.raises(SystemExit):
        convert.main(["--data_dir", str(src), "--out_dir", str(src)])


def test_serve_int8_cli_on_cpu_serves_a_converted_store(jax_params, tmp_path):
    """convert then ``serve --int8`` end to end on the CPU: the int8 store is
    served as stored and agrees with the JAX int8 batcher."""
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    ckpt = tmp_path / "s_0_checkpoint.pt"
    torch.save(reference_state_dict(params_from_jax(jax_params)), ckpt)
    (tmp_path / "src").mkdir()
    x = np.random.default_rng(13).standard_normal((90, DIM)).astype(np.float32)
    np.save(tmp_path / "src" / "slide.npy", x)
    subprocess.run([sys.executable, "-m", "toad_tpu_torch", "convert", "--data_dir", str(tmp_path / "src"),
                    "--out_dir", str(tmp_path / "store")], check=True, env=env, cwd=tmp_path, timeout=120,
                   capture_output=True)
    proc = subprocess.Popen(
        [sys.executable, "-m", "toad_tpu_torch", "serve", "--ckpt", str(ckpt), "--device", "cpu", "--port", "0",
         "--int8", "--encoding_size", str(DIM), "--n_classes", str(N_CLASSES), "--buckets", "64,128,256",
         "--bag_root", str(tmp_path / "store")],
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
        assert "int8" in line
        port = int(line.split()[2].rsplit(":", 1)[1])
        status, out = _post(port, json.dumps({"bag_path": "slide.npz", "sex": "F"}), {})
        assert status == 200, out
        _check_pred(out, _jax_int8_preds(jax_params, [(x, 0)], attention=False)[0])
        assert _get(port, "/stats")[1]["config"]["int8"] is True
        proc.terminate()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.cuda
def test_int8_kernel_matches_plain_on_card(jax_qparams, cuda_device):
    """Runs only on a CUDA machine: the int8 kernel against its plain version
    at H=512 (the kernel's width), a ragged N, a fully-masked bag."""
    x, mask = _bag(3, 1000, seed=14)
    mask[1] = 0.0
    xq, sx = (torch.from_numpy(a).to(cuda_device) for a in _quantized(x))
    mt = torch.from_numpy(mask).to(cuda_device)
    qp = {k: v.to(cuda_device) for k, v in qparams_from_jax(jax_qparams).items()}
    with torch.inference_mode():
        mk, sk = cuda_pool_int8.pool_int8(cuda_pool_int8.pack_qparams(qp), xq, sx, mt, True)
        mp, sp = quantize.plain_int8_pool(qp, xq, sx, mt, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(mk, mp, rtol=5e-3, atol=5e-3)
    torch.testing.assert_close(sk, sp, rtol=5e-3, atol=5e-3)
    assert mk[1].abs().max().item() == 0.0
