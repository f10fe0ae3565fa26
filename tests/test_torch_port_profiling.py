"""The port's profiling tools (utils/profiling.py) and the ops flags of its
CLIs, against the JAX package's, on the CPU.

``StepTracer`` starts and stops its trace at the same calls as the JAX
class (both profilers replaced by recorders); a real trace on the CPU is a
Chrome trace JSON holding the ``record_function`` names; ``host_rss_gb``
reads what the JAX function reads. The CLIs: ``train --profile`` writes a
trace of at most ten steps, ``--rss_restart_gb`` needs ``--resume`` (JAX's
text) and, at a watermark, snapshots and re-execs with the same arguments
into a run whose ``summary.csv`` is the uninterrupted run's;
``featurize --profile`` puts each batch's embed under one
``toad.featurize.embed_dispatch`` span; ``serve --max_rss_gb`` under the
start-up RSS is refused at start (the JAX CLI serves nothing and exits 42
there), and a watermark crossed after start drains and exits 42 with JAX's
lines.
"""

import json
import os
import signal
import threading
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from toad_tpu.utils import profiling as jax_profiling
from toad_tpu_torch.utils import profiling

D = 32


def _trace_events(log_dir: Path) -> list[dict]:
    files = sorted(Path(log_dir).glob("*.pt.trace.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


def _names(events, prefix: str) -> list[str]:
    return [e["name"] for e in events if e.get("name", "").startswith(prefix) and e.get("ph") == "X"]


# -- the tools ----------------------------------------------------------------------


class _Recorder:
    def __init__(self, events):
        self.events = events

    def step(self):
        self.events.append("step")


@pytest.mark.parametrize("calls", [1, 3, 10, 25])
def test_step_tracer_starts_and_stops_as_the_jax_tracer(calls, monkeypatch, capsys, tmp_path):
    theirs, ours = [], []
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: theirs.append("start"))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: theirs.append("stop"))
    monkeypatch.setattr(profiling, "_start", lambda: ours.append("start") or _Recorder(ours))
    monkeypatch.setattr(profiling, "_write", lambda prof, log_dir, device=None: ours.append("stop"))
    out = {}
    for name, cls in (("jax", jax_profiling.StepTracer), ("port", profiling.StepTracer)):
        tracer = cls(str(tmp_path), n_steps=10)
        for _ in range(calls):
            tracer.step()
        tracer.stop()  # the trainer's end of epoch
        tracer.stop()  # twice is harmless
        tracer.step()  # a stopped tracer stays off
        out[name] = capsys.readouterr().out
    assert [e for e in ours if e != "step"] == theirs == ["start", "stop"]
    assert ours.count("step") == min(calls, 10) - 1  # one ProfilerStep span a call, closed by the next
    assert out["port"] == out["jax"] == f"[profile] trace of {min(calls, 10)} steps written to {tmp_path}\n"


def test_a_failed_start_turns_the_tracer_off_as_in_jax(monkeypatch, capsys, tmp_path):
    def boom(*a):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(jax.profiler, "start_trace", boom)
    monkeypatch.setattr(profiling, "_start", boom)
    out = {}
    for name, cls in (("jax", jax_profiling.StepTracer), ("port", profiling.StepTracer)):
        tracer = cls(str(tmp_path), n_steps=3)
        for _ in range(5):
            tracer.step()
        tracer.stop()
        assert tracer.log_dir is None
        out[name] = capsys.readouterr().out
    assert out["port"] == out["jax"] == "[profile] trace unavailable: no profiler here\n"
    with profiling.profile_trace(tmp_path / "never"):
        pass  # a profiler that cannot start never breaks the run
    assert capsys.readouterr().out == "[profile] trace unavailable: no profiler here\n"


def test_profile_trace_disabled_writes_nothing(tmp_path):
    ran = []
    with profiling.profile_trace(None):
        ran.append(1)
    with profiling.profile_trace(tmp_path / "off", enabled=False):
        ran.append(2)
    assert ran == [1, 2] and not (tmp_path / "off").exists()
    tracer = profiling.StepTracer(None)
    tracer.step()
    tracer.stop()
    assert list(tmp_path.iterdir()) == []


def test_a_cpu_trace_parses_and_holds_the_annotations(tmp_path, capsys):
    x = torch.randn(64, 64)
    with profiling.profile_trace(tmp_path / "run"):
        with profiling.annotate("toad.test.outer"):
            for _ in range(2):
                with profiling.annotate("toad.test.inner"):
                    x = torch.tanh(x @ x)
    assert capsys.readouterr().out == f"[profile] trace written to {tmp_path / 'run'}\n"
    events = _trace_events(tmp_path / "run")
    assert _names(events, "toad.test.") == ["toad.test.outer", "toad.test.inner", "toad.test.inner"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert profiling.count_kernel_events(next((tmp_path / "run").glob("*.json"))) == 0  # no device here

    tracer = profiling.StepTracer(tmp_path / "steps", n_steps=3)
    for _ in range(5):
        x = torch.tanh(x @ x)
        tracer.step()
    assert capsys.readouterr().out == f"[profile] trace of 3 steps written to {tmp_path / 'steps'}\n"
    assert sorted(_names(_trace_events(tmp_path / "steps"), "ProfilerStep#")) == [f"ProfilerStep#{k}" for k in range(3)]


def test_host_rss_gb_reads_what_the_jax_function_reads():
    ours, theirs = profiling.host_rss_gb(), jax_profiling.host_rss_gb()
    assert ours > 0 and abs(ours - theirs) <= 0.05 * theirs


# -- train --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A tiny cohort with one split file, made by the port's own CLIs."""
    from toad_tpu_torch.cli import create_splits, make_dummy

    root = tmp_path_factory.mktemp("profile_cohort")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        make_dummy.main(["--out_dir", ".", "--n_patients", "40", "--max_slides_per_patient", "2", "--dim", str(D),
                         "--min_patches", "20", "--max_patches", "200"])
        create_splits.main(["--task", "tasks/dummy_mtl_concat.json", "--k", "1", "--val_frac", "0.25",
                            "--test_frac", "0.25"])
    finally:
        os.chdir(cwd)
    return root


def _train_args(exp_code, *extra):
    return ["--task", "tasks/dummy_mtl_concat.json", "--data_root_dir", "bags", "--exp_code", exp_code, "--k", "1",
            "--max_epochs", "1", "--batch_size", "2", "--encoding_size", str(D), "--buckets", "256", "--lr", "1e-3",
            "--device", "cpu", *extra]


def test_train_profile_writes_a_trace_of_at_most_ten_steps(cohort, monkeypatch, capsys):
    from toad_tpu_torch.cli import train as cli_train

    monkeypatch.chdir(cohort)
    cli_train.main(_train_args("profiled", "--profile", "trace"))
    out = capsys.readouterr().out
    with open(cohort / "splits" / "dummy_mtl_concat_100" / "splits_0.csv") as f:
        n_train = sum(1 for line in f.readlines()[1:] if line.split(",")[1].strip())
    traced = min(10, -(-n_train // 2))
    assert f"[profile] trace of {traced} steps written to trace\n" in out
    assert sorted(_names(_trace_events(cohort / "trace"), "ProfilerStep#"), key=lambda s: int(s[13:])) == \
        [f"ProfilerStep#{k}" for k in range(traced)]
    assert traced == 10  # the epoch has more steps than the tracer takes


def test_rss_restart_needs_resume_with_the_jax_text(tmp_path):
    from toad_tpu.cli import train as jax_cli_train
    from toad_tpu_torch.cli import train as cli_train

    args = ["--task", "t", "--exp_code", "e", "--rss_restart_gb", "4"]
    with pytest.raises(SystemExit) as theirs:
        jax_cli_train.main(args)
    with pytest.raises(SystemExit) as ours:
        cli_train.main(args)
    assert str(ours.value) == str(theirs.value) == "--rss_restart_gb requires --resume (restart would lose all progress)"
    from toad_tpu_torch import config
    from toad_tpu_torch.train.loop import FoldTrainer

    with pytest.raises(ValueError, match="rss_restart_gb requires resume=True"):
        FoldTrainer(config.TrainConfig(rss_restart_gb=4.0, model=config.ModelConfig(in_dim=D)), 0, tmp_path,
                    device="cpu").train([], [], [])


def test_a_crossed_watermark_snapshots_raises_and_reexecs_into_the_same_result(cohort, monkeypatch, capsys):
    from toad_tpu_torch.cli import train as cli_train

    monkeypatch.chdir(cohort)
    rss = iter([100.0])  # the first epoch's end crosses the watermark, then the process is fresh
    monkeypatch.setattr(profiling, "host_rss_gb", lambda: next(rss, 0.5))
    reexecs = []

    def reexec(argv):  # stands in for os.execv: a fresh run of the same command line
        reexecs.append(list(argv))
        cli_train.main(argv)

    monkeypatch.setattr(cli_train, "_reexec", reexec)
    args = _train_args("watermark", "--max_epochs", "3", "--resume", "--rss_restart_gb", "8")
    cli_train.main(args)
    out = capsys.readouterr().out
    assert reexecs == [args]
    assert "[fold 0] host RSS 100.0 GiB >= 8.0 — snapshotting for restart" in out
    assert ("host RSS 100.0 GiB >= rss_restart_gb 8.0 after epoch 0; resume snapshot saved — re-exec this process and "
            "resume — re-exec to reclaim the process's memory") in out
    assert "[fold 0] resumed from epoch 0" in out
    cli_train.main(_train_args("straight", "--max_epochs", "3", "--resume"))
    results = cohort / "results"
    assert (results / "watermark_s1" / "summary.csv").read_text() == (results / "straight_s1" / "summary.csv").read_text()
    assert not (results / "watermark_s1" / "s_0_resume.pt").exists()


# -- featurize ------------------------------------------------------------------------


def test_featurize_profile_holds_one_embed_dispatch_span_per_batch(tmp_path, monkeypatch, capsys):
    from toad_tpu_torch.cli import featurize as cli_featurize
    from toad_tpu_torch.models.vit_encoder import ViTConfig, ViTEncoder

    tiny = ViTConfig(patch_size=8, width=64, depth=2, heads=1, pretrain_img_size=32, compute_dtype="float32")
    torch.save(ViTEncoder(tiny, torch.Generator().manual_seed(0)).state_dict(), tmp_path / "tiny.bin")
    rng = np.random.default_rng(0)
    (tmp_path / "patches").mkdir()
    np.savez(tmp_path / "patches" / "s1.npz", imgs=rng.integers(0, 256, (10, 32, 32, 3), dtype=np.uint8),
             coords=rng.integers(0, 5000, (10, 2)))
    monkeypatch.chdir(tmp_path)
    cli_featurize.main(["--device", "cpu", "--encoder", "vit", "--weights", "tiny.bin", "--no_bf16", "--patch_dir",
                        "patches", "--feat_dir", "feats", "--format", "npy", "--batch_size", "4", "--profile", "trace"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "[profile] trace written to trace"  # after the run's JSON line, as in the JAX CLI
    assert json.loads(out[-2])["batches"] == 3
    events = _trace_events(tmp_path / "trace")
    assert _names(events, "toad.featurize.") == ["toad.featurize.slide"] + ["toad.featurize.embed_dispatch"] * 3
    assert np.load(tmp_path / "feats" / "s1.npy").shape == (10, 64)


# -- serve ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from toad_tpu_torch.config import ModelConfig
    from toad_tpu_torch.models.interop import reference_state_dict
    from toad_tpu_torch.models.toad_mil import ToadMIL

    path = tmp_path_factory.mktemp("serve_ckpt") / "s_0_checkpoint.pt"
    model = ToadMIL(ModelConfig(in_dim=D, n_classes=6), torch.Generator().manual_seed(0))
    torch.save(reference_state_dict(model.state_dict()), path)
    return path


def _serve_args(ckpt, max_rss):
    return ["--ckpt", str(ckpt), "--port", "0", "--encoding_size", str(D), "--n_classes", "6",
            "--max_rss_gb", str(max_rss)]


def test_serve_max_rss_under_the_start_up_rss_is_refused_at_start(checkpoint, monkeypatch, capsys):
    """The JAX CLI starts, serves nothing and exits 42 at its first poll
    (ADVICE.md); a supervisor would restart it for ever. The port refuses
    such a watermark at start, naming both figures, and exits 1."""
    from toad_tpu.cli import serve as jax_serve
    from toad_tpu_torch.cli import serve

    monkeypatch.setattr(signal, "signal", lambda *a: None)  # the CLIs' handlers stay out of the test process
    with pytest.raises(SystemExit) as theirs:
        jax_serve.main(_serve_args(checkpoint, 0.01))
    jax_out = capsys.readouterr().out
    assert theirs.value.code == jax_serve.RESTART_EXIT_CODE == serve.RESTART_EXIT_CODE == 42
    assert "serving on" in jax_out and "draining for supervisor restart (exit 42)" in jax_out
    with pytest.raises(SystemExit) as ours:
        serve.main([*_serve_args(checkpoint, 0.01), "--device", "cpu"])
    rss = profiling.host_rss_gb()
    said = str(ours.value)
    assert said.startswith("error: --max_rss_gb 0.01 is at or under this server's RSS with its model loaded, ")
    assert float(said.split("loaded, ")[1].split(" GiB")[0]) == pytest.approx(rss, rel=0.05)
    assert "serving on" not in capsys.readouterr().out


def test_serve_watermark_crossed_after_start_drains_and_exits_42(checkpoint, monkeypatch, capsys):
    import toad_tpu_torch.serve as serve_pkg
    from toad_tpu_torch.cli import serve

    crossed = threading.Event()
    monkeypatch.setattr(profiling, "host_rss_gb", lambda: 9.25 if crossed.is_set() else 0.5)
    monkeypatch.setattr(serve, "RSS_POLL_S", 0.05)
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    servers = []
    real = serve_pkg.make_http_server
    monkeypatch.setattr(serve_pkg, "make_http_server", lambda *a, **k: servers.append(real(*a, **k)) or servers[-1])
    answers = []

    def client():
        while not servers:
            threading.Event().wait(0.02)
        port = servers[0].server_address[1]
        body = json.dumps({"features": np.ones((12, D)).tolist(), "sex": "F"}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answers.append(json.loads(r.read()))
        crossed.set()

    t = threading.Thread(target=client, daemon=True)
    t.start()
    with pytest.raises(SystemExit) as e:
        serve.main([*_serve_args(checkpoint, 4), "--device", "cpu"])
    t.join(timeout=60)
    assert not t.is_alive() and e.value.code == 42
    assert len(answers) == 1 and len(answers[0]["y_prob"]) == 6  # it served before the watermark
    out = capsys.readouterr().out.splitlines()
    # the JAX CLI's lines (toad_tpu/cli/serve.py), with these figures
    assert f"host RSS {9.25:.1f} GiB >= --max_rss_gb {4.0:.1f}: draining for supervisor restart (exit 42)" in out
    assert out[-1] == "server stopped; in-flight requests drained"
