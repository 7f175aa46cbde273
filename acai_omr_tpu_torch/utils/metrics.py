"""Training observability: a CSV scalar sink, step timing and a profiler
trace (the twin of the JAX package's ``utils/metrics.py`` without its
TensorBoard writer, which needs a package the GPU machine does not carry;
the trace is ``torch.profiler``'s, not JAX's)."""

from __future__ import annotations

import contextlib
import csv
import os
import time
from pathlib import Path

import torch


class MetricsWriter:
    """Buffers (step, tag, value) rows and appends them to a CSV on flush."""

    def __init__(self, csv_path: str | None = None):
        self.csv_path = Path(csv_path) if csv_path else None
        self._rows = []

    def scalar(self, tag: str, value, step: int) -> None:
        if self.csv_path:
            self._rows.append({"step": step, "tag": tag,
                               "value": float(value)})

    def scalars(self, prefix: str, values: dict, step: int) -> None:
        for k, v in values.items():
            self.scalar(f"{prefix}/{k}", v, step)

    def flush(self) -> None:
        if not (self.csv_path and self._rows):
            return
        self.csv_path.parent.mkdir(parents=True, exist_ok=True)
        exists = self.csv_path.exists()
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["step", "tag", "value"])
            if not exists:
                w.writeheader()
            w.writerows(self._rows)
        self._rows = []


class StepTimer:
    """Host seconds between ticks (the first from construction)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.count = 0

    def tick(self) -> float:
        t = time.perf_counter()
        dt = t - self.t0
        self.t0 = t
        self.count += 1
        return dt


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the block (host ops, and the CUDA
    kernels where a card is present), written on exit as a Chrome trace
    ``trace_<pid>_<ns>.json`` under ``log_dir``; yields the profiler. A
    no-op yielding None when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))
