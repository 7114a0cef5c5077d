"""Solve-time recording and device traces (car_racing_tpu/utils/profiling.py).

:class:`SolveTimer` records named wall-clock samples and summarises them as
percentiles (the p50/p99 solve latency); the policies record every solve in
:data:`GLOBAL_TIMER`, each sample ending with the solve's result on the
host.  :func:`device_trace` is a ``torch.profiler`` trace of the CPU and,
where there is one, the GPU.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np


class SolveTimer:
    """Named wall-clock recorder with percentile summaries."""

    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append((time.perf_counter() - t0) * 1e3)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "count": int(a.size),
                "p50_ms": float(np.percentile(a, 50)),
                "p99_ms": float(np.percentile(a, 99)),
                "mean_ms": float(a.mean()),
                "max_ms": float(a.max()),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:32s} n={s['count']:5d} p50={s['p50_ms']:8.3f}ms "
                f"p99={s['p99_ms']:8.3f}ms max={s['max_ms']:8.3f}ms"
            )
        return "\n".join(lines)


GLOBAL_TIMER = SolveTimer()


@contextlib.contextmanager
def device_trace(log_dir: str | None = "build/torch-trace"):
    """``torch.profiler`` trace of the CPU and, where there is one, the GPU;
    yields the profiler, whose ``events()`` hold the trace.  With a
    ``log_dir`` the trace is also written there for TensorBoard."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handler = tensorboard_trace_handler(log_dir) if log_dir else None
    with profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof
