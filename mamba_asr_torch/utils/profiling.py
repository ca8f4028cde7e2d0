"""Tracing and the step-time and RTFx meters (port of
mamba_asr_tpu/utils/profiling.py).

- `profile_trace(logdir)`: a context manager around `torch.profiler` that
  writes a Chrome / Perfetto trace (`trace.json`) into logdir: the
  host's operators and, when a CUDA card is present, its kernels (CUDA
  activity through CUPTI) and, with `with_memory`, the allocations.
  Open it in Perfetto (ui.perfetto.dev) or chrome://tracing. The JAX
  package's writes a TensorBoard device trace of XLA's ops.
- `StepTimer`: a running mean and percentile meter of step times that
  skips its warmup steps (a copy of JAX's).
- `rtfx(audio_seconds, wall_seconds)`: audio seconds per wall second.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(logdir: str, with_memory: bool = True) -> Iterator[None]:
    """Trace the block into <logdir>/trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, profile_memory=with_memory) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class StepTimer:
    """Step-time meter; call mark() after each blocking step."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._last: Optional[float] = None
        self._count = 0

    def start(self) -> None:
        self._last = time.perf_counter()

    def mark(self) -> float:
        now = time.perf_counter()
        dt = now - (self._last if self._last is not None else now)
        self._last = now
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return dt

    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def percentile(self, p: float) -> float:
        if not self.times:
            return 0.0
        s = sorted(self.times)
        return s[min(int(len(s) * p / 100.0), len(s) - 1)]

    def summary(self) -> dict:
        return {
            "steps": len(self.times),
            "mean_s": self.mean(),
            "p50_s": self.percentile(50),
            "p95_s": self.percentile(95),
        }


def rtfx(audio_seconds: float, wall_seconds: float) -> float:
    """Audio seconds processed per wall-clock second (RTFx = 1 / RTF)."""
    return audio_seconds / max(wall_seconds, 1e-9)
