"""The ``/heatmap`` route of the PyTorch port's server, on the CPU.

An in-process port server (device="cpu": the plain pooling path) renders
the attention heatmap of a coordinate-bearing bag; its PNG must equal, byte
for byte, the port's own ``encode_png(render_heatmap(...))`` of
SlideInference's attention on the same bag (the same forward at B = 1 in
the same bucket), and the JAX server's PNG on the same weights. Every error
case is run against both servers and must get the JAX route's status code.
Inputs are numpy from a seed; weights the JAX init through params_from_jax.
"""

import dataclasses
import http.client
import json
import threading

import jax
import numpy as np
import pytest

from toad_tpu.config import ModelConfig as JaxModelConfig
from toad_tpu.models.toad_mil import ToadMIL as JaxToadMIL
from toad_tpu.serve import InferenceService as JaxService
from toad_tpu.serve import ServeConfig as JaxServeConfig
from toad_tpu.serve import make_http_server as jax_make_http_server
from toad_tpu_torch.config import ModelConfig
from toad_tpu_torch.models.interop import params_from_jax
from toad_tpu_torch.pipeline.featurize import write_bag
from toad_tpu_torch.pipeline.heatmap import encode_png, render_heatmap
from toad_tpu_torch.pipeline.infer import SlideInference
from toad_tpu_torch.serve import InferenceService, ServeConfig, make_http_server

DIM = 64
BUCKETS = (32, 64, 128)
CFG = ModelConfig(in_dim=DIM, n_classes=6)


def _grid(n, side, step=256):
    i = np.arange(n)
    return np.stack([step * (i % side), step * (i // side)], axis=1).astype(np.int64)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JaxToadMIL(JaxModelConfig(**dataclasses.asdict(CFG))).init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    """A bag root: 24 rows with coords as .h5 and as .npy + sidecar, a bag
    past the top bucket, and a .npy without coords."""
    root = tmp_path_factory.mktemp("heatmap_bags")
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((24, DIM)).astype(np.float32)
    coords = _grid(24, 6)
    write_bag(root / "hm.h5", feats, coords)
    write_bag(root / "hm.npy", feats, coords)
    long = rng.standard_normal((200, DIM)).astype(np.float32)
    write_bag(root / "long.npy", long, _grid(200, 15, 512))
    np.save(root / "bare.npy", feats)
    return root


def _start(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server.server_address[1]


@pytest.fixture(scope="module")
def servers(jax_params, bags):
    """{kind: (port of the rooted loopback server, port of an exposed server
    without a bag root)} for the port ("torch") and the JAX package ("jax")."""
    sc = dict(max_batch=8, max_wait_ms=5, bucket_sizes=BUCKETS)
    services = {
        "torch": InferenceService(params_from_jax(jax_params), CFG, ServeConfig(**sc), bag_root=bags, device="cpu"),
        "jax": JaxService(jax_params, JaxModelConfig(**dataclasses.asdict(CFG)), JaxServeConfig(**sc), bag_root=bags),
    }
    exposed_services = {
        "torch": InferenceService(params_from_jax(jax_params), CFG, ServeConfig(**sc), device="cpu"),
        "jax": JaxService(jax_params, JaxModelConfig(**dataclasses.asdict(CFG)), JaxServeConfig(**sc)),
    }
    make = {"torch": make_http_server, "jax": jax_make_http_server}
    started, ports = [], {}
    for kind in services:
        rooted = make[kind](services[kind], "127.0.0.1", 0)
        exposed = make[kind](exposed_services[kind], "0.0.0.0", 0)
        started += [rooted, exposed]
        ports[kind] = (_start(rooted), _start(exposed))
    yield ports
    for server in started:
        server.shutdown()
        server.server_close()
    for svc in (*services.values(), *exposed_services.values()):
        svc.close()


def _post(port, body, ctype="application/json"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/heatmap", body if isinstance(body, bytes) else json.dumps(body), {"Content-Type": ctype})
    r = conn.getresponse()
    out = (r.status, r.getheader("Content-Type"), r.read())
    conn.close()
    return out


@pytest.mark.parametrize("fmt", ["h5", "npy"])
@pytest.mark.parametrize("task", ["origin", "site"])
def test_heatmap_png_is_the_renderers(servers, jax_params, bags, fmt, task):
    status, ctype, png = _post(servers["torch"][0], {"bag_path": f"hm.{fmt}", "sex": "F", "task": task})
    assert (status, ctype) == (200, "image/png"), png[:200]
    feats = np.load(bags / "hm.npy")
    pred = SlideInference(params_from_jax(jax_params), CFG, bucket_sizes=BUCKETS, device="cpu").predict(feats, 0)
    scores = pred.attention if task == "origin" else pred.site_attention
    assert png == encode_png(render_heatmap(_grid(24, 6), scores))
    # the JAX server answers the same bytes (its attention agrees to ~1e-6, far inside every rank gap)
    assert _post(servers["jax"][0], {"bag_path": f"hm.{fmt}", "sex": "F", "task": task})[2] == png


def test_heatmap_patch_size_downscale_and_head_truncation(servers, jax_params, bags):
    """A bag past the top bucket is head-truncated, its coords with it."""
    status, _, png = _post(servers["torch"][0], {"bag_path": str(bags / "long.npy"), "sex": 1,
                                                 "patch_size": 512, "downscale": 16})
    assert status == 200
    feats, coords = np.load(bags / "long.npy"), np.load(bags / "long.coords.npy")
    pred = SlideInference(params_from_jax(jax_params), CFG, bucket_sizes=BUCKETS, device="cpu").predict(feats, 1)
    assert len(pred.attention) == BUCKETS[-1]
    assert png == encode_png(render_heatmap(coords[: BUCKETS[-1]], pred.attention, patch_size=512, downscale=16))


def test_heatmap_int8_goes_through_the_quantized_path(jax_params, bags):
    svc = InferenceService(params_from_jax(jax_params), CFG, ServeConfig(bucket_sizes=BUCKETS, int8=True),
                           bag_root=bags, device="cpu")
    try:
        png = svc.heatmap_png("hm.npy", 0)
    finally:
        svc.close()
    pred = SlideInference(params_from_jax(jax_params), CFG, bucket_sizes=BUCKETS, int8=True,
                          device="cpu").predict(np.load(bags / "hm.npy"), 0)
    assert png == encode_png(render_heatmap(_grid(24, 6), pred.attention))


def test_heatmap_of_an_ensemble(jax_params, bags):
    """An ensemble's heatmap renders the mean of the members' softmaxed weights."""
    other = params_from_jax(jax.tree.map(np.asarray, JaxToadMIL(JaxModelConfig(**dataclasses.asdict(CFG))).init(
        jax.random.PRNGKey(7))))
    svc = InferenceService([params_from_jax(jax_params), other], CFG, ServeConfig(bucket_sizes=BUCKETS),
                           bag_root=bags, device="cpu")
    try:
        png = svc.heatmap_png("hm.h5", 1, task="site")
        pred = svc.batcher.predict(np.load(bags / "hm.npy"), 1, attention=True)
    finally:
        svc.close()
    np.testing.assert_allclose(pred.site_attention.sum(), 1.0, atol=1e-5)
    assert png == encode_png(render_heatmap(_grid(24, 6), pred.site_attention))


def test_heatmap_png_validates_before_reading(jax_params, bags):
    svc = InferenceService(params_from_jax(jax_params), CFG, ServeConfig(bucket_sizes=BUCKETS), bag_root=bags,
                           device="cpu")
    try:
        for kw, match in ((dict(task="banana"), "origin"), (dict(patch_size=0), ">= 1"), (dict(downscale=-1), ">= 1")):
            with pytest.raises(ValueError, match=match):
                svc.heatmap_png("missing.npy", 0, **kw)  # raises before the path is looked at
        with pytest.raises(PermissionError):
            svc.heatmap_png("../outside.npy", 0)
        with pytest.raises(FileNotFoundError):
            svc.heatmap_png("missing.npy", 0)
        with pytest.raises(ValueError, match="coordinates"):
            svc.heatmap_png("bare.npy", 0)
        assert svc.stats()["requests"] == 0  # nothing reached the batcher
    finally:
        svc.close()


# (body, which server: 0 rooted on loopback, 1 bound beyond loopback without a root, status, words in the body)
ERRORS = {
    "no_bag_path": ({"sex": "F"}, 0, 400, b"bag_path"),
    "beyond_loopback_without_root": ({"bag_path": "hm.npy", "sex": "F"}, 1, 403, b"--bag_root"),
    "outside_the_root": ({"bag_path": "../hm.npy", "sex": "F"}, 0, 403, b"outside"),
    "missing_bag": ({"bag_path": "nowhere/missing.npy", "sex": "F"}, 0, 404, b"not found"),
    "octet_stream": (b"\0" * 64, 0, 400, b"octet-stream"),
    "no_coordinates": ({"bag_path": "bare.npy", "sex": "F"}, 0, 400, b"coordinates"),
    "bad_task": ({"bag_path": "hm.npy", "sex": "F", "task": "banana"}, 0, 400, b"origin"),
    "zero_downscale": ({"bag_path": "hm.npy", "sex": 0, "downscale": 0}, 0, 400, b">= 1"),
    "zero_patch_size": ({"bag_path": "hm.npy", "sex": 0, "patch_size": 0}, 0, 400, b">= 1"),
    "bad_sex": ({"bag_path": "hm.npy", "sex": "X"}, 0, 400, b"error"),
    "malformed_json": (b"{not json", 0, 400, b"error"),
}


@pytest.mark.parametrize("kind", ["torch", "jax"])
@pytest.mark.parametrize("case", ERRORS)
def test_heatmap_errors_get_the_jax_status(servers, case, kind):
    body, which, want, words = ERRORS[case]
    ctype = "application/octet-stream" if case == "octet_stream" else "application/json"
    status, got_type, data = _post(servers[kind][which], body, ctype)
    assert (status, got_type) == (want, "application/json"), data
    assert words in data
    assert b"nowhere" not in data  # a missing bag's path is not echoed
