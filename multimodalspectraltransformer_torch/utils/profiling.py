"""Tracing and profiling utilities.

Counterpart of the JAX package's ``utils/profiling.py``:

- ``device_trace``: a ``torch.profiler`` context over the block, CPU and
  (where a card is present) CUDA activity, written as a Chrome trace,
- ``PhaseTimer``: wall-clock phase spans with a SimpleProfiler-style report
  (host-side stages: chemistry, IO, filters),
- ``annotate``: a named region that shows in the trace (``record_function``).

CUDA work is asynchronous: a phase around device work should end in a sync
(``torch.cuda.synchronize()`` or reading a result back) to time its execution
rather than its enqueue.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[profile]:
    """Profile the block and write ``<log_dir>/trace.json`` (Chrome trace
    format: chrome://tracing, Perfetto). Yields the profiler, whose
    ``key_averages()`` the caller may read after the block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region that shows up in device traces."""
    return record_function(name)


class PhaseTimer:
    """Accumulating wall-clock spans per phase name.

    >>> t = PhaseTimer()
    >>> with t.phase("encode"): ...
    >>> t.report()
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        """SimpleProfiler-style table sorted by total time."""
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        width = max((len(n) for n, _ in rows), default=5)
        lines = [f"{'phase'.ljust(width)}  {'total_s':>9}  {'calls':>6}  {'mean_ms':>9}"]
        for name, total in rows:
            n = self.counts[name]
            lines.append(
                f"{name.ljust(width)}  {total:9.3f}  {n:6d}  {total / n * 1000:9.2f}"
            )
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            name: {"total_s": self.totals[name], "calls": self.counts[name]}
            for name in self.totals
        }
