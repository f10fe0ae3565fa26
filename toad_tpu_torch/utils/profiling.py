"""Profiling hooks: torch.profiler traces viewable in Perfetto or chrome://tracing.

PyTorch counterpart of :mod:`toad_tpu.utils.profiling`, with the same names
and printed lines:

- training captures a bounded trace of its first steps via :class:`StepTracer`
  (``TrainConfig.profile_dir`` / ``train --profile``);
- featurization wraps whole runs in :func:`profile_trace`
  (``featurize --profile``) with :func:`annotate` scopes on the embed
  dispatch, so that kernels attribute to pipeline stages.

A trace is one Chrome trace JSON file (``*.pt.trace.json``) in the
directory given. It records host activity, and device activity (CUPTI
activity records: kernels, copies, annotations) where CUDA is available.
Kineto only warns when CUPTI records nothing, so a CUDA trace with no
device kernel event says so on a ``[profile]`` line of its own.
"""

from __future__ import annotations

import json
import os
import socket
import time
from contextlib import contextmanager
from pathlib import Path

import torch


def _start():
    """A running profiler: host activity, plus CUDA activity where there is
    CUDA. Every step is recorded (the schedule), so that each ``step()``
    marks a ``ProfilerStep#k`` span."""
    from torch.profiler import ProfilerAction, ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, schedule=lambda step: ProfilerAction.RECORD)
    prof.start()
    return prof


def _write(prof, log_dir, device=None) -> Path:
    """Wait for the device, stop the profiler and write its trace into
    ``log_dir``, named as ``torch.profiler.tensorboard_trace_handler`` names
    its files. Prints a line when a CUDA trace holds no device kernel event."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize(device)  # the last kernels' records are in the file
    prof.stop()
    path = Path(log_dir) / f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    if cuda:
        n = count_kernel_events(path)
        if n == 0:
            print(f"[profile] trace {path} holds {n} device kernel events: CUPTI recorded no device activity")
    return path


def count_kernel_events(path: str | os.PathLike) -> int:
    """Device kernel events (``"cat": "kernel"``) in a written trace."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return sum(1 for e in events if e.get("cat") == "kernel")


@contextmanager
def profile_trace(log_dir: str | os.PathLike | None, enabled: bool = True):
    """Capture a torch.profiler trace into ``log_dir`` for the ``with`` body.
    No-op when disabled or log_dir is None; never lets a profiler failure
    break the run."""
    if not enabled or log_dir is None:
        yield
        return
    prof = None
    try:
        prof = _start()
    except Exception as e:  # pragma: no cover - environment-dependent
        print(f"[profile] trace unavailable: {e}")
    try:
        yield
    finally:
        if prof is not None:
            try:
                _write(prof, log_dir)
                print(f"[profile] trace written to {log_dir}")
            except Exception as e:  # pragma: no cover
                print(f"[profile] stop_trace failed: {e}")


def annotate(name: str):
    """Scope annotation that shows up on the trace timeline: a
    ``user_annotation`` span on the host and a ``gpu_user_annotation`` span
    over the device work launched inside it."""
    return torch.profiler.record_function(name)


class StepTracer:
    """Trace the first `n_steps` calls, then stop — bounded profile captures
    inside long epoch loops without restructuring them.

    The first ``step()`` starts the trace and opens ``ProfilerStep#0``; each
    later one closes the open span and opens the next; the ``n_steps``-th
    waits for ``device``, closes its span and stops. So with ``step()`` called
    after each train step, spans ``#0`` .. ``#n_steps-2`` each hold one whole
    step (launches and device work) and ``#n_steps-1`` is empty."""

    def __init__(self, log_dir: str | os.PathLike | None, n_steps: int = 10, device=None):
        self.log_dir = log_dir
        self.n_steps = n_steps
        self.device = device
        self._count = 0
        self._active = False
        self._prof = None

    def step(self) -> None:
        if self.log_dir is None:
            return
        if self._count == 0:
            try:
                self._prof = _start()
                self._active = True
            except Exception as e:  # pragma: no cover
                print(f"[profile] trace unavailable: {e}")
                self.log_dir = None
                return
        else:
            if self._count + 1 >= self.n_steps and torch.cuda.is_available():
                torch.cuda.synchronize(self.device)  # the last step's device work inside its span
            self._prof.step()
        self._count += 1
        if self._count >= self.n_steps:
            self.stop()

    def stop(self) -> None:
        if self._active:
            try:
                _write(self._prof, self.log_dir, self.device)
                print(f"[profile] trace of {self._count} steps written to {self.log_dir}")
            except Exception as e:  # pragma: no cover
                print(f"[profile] stop_trace failed: {e}")
            self._active = False
            self._prof = None
            self.log_dir = None


def host_rss_gb() -> float:
    """This process's resident set size in GiB (Linux ``/proc/self/status``).

    Used by the trainer's memory watermark (``TrainConfig.rss_restart_gb``)
    and the server's ``--max_rss_gb`` watchdog. Returns 0.0 where /proc is
    unavailable (non-Linux), which disables both checks gracefully."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / (1024 * 1024)
    except OSError:
        pass
    return 0.0
