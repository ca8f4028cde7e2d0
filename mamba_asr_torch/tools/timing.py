"""Timing shared by the measurement tools and chip_smoke.py.

On a card a launch is timed with CUDA events (the device's clock) and the
result is reported as `ms`; on the CPU (the plain versions, for tests) with
the host's clock and reported as `cpu_ms`, so that no CPU number appears
under a device metric's name.

Events recorded around one call of a Python wrapper also time the host's
enqueue of the call (argument checks, allocation, the ctypes call),
during which the card waits, so a short kernel reads too long that way
(chip_smoke.py's kernel phase reports both). `median_ms` first queues a spin
kernel long enough for the host to enqueue `reps` calls behind it, then
times the calls back to back: per call, the card's time alone (for a
wrapper of several kernels, all of them). A function whose host time
exceeds its device time (the plain versions' many small launches) still
reads its host-bound time.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List

import torch


SPIN_CYCLES = 20_000_000  # ~10 ms at 1.98 GHz: the queue the host fills
ROUNDS = 3


def median_ms(fn: Callable[[], object], reps: int, device: torch.device) -> float:
    """Milliseconds per call of fn(), after one warm-up call. On a card:
    the median over ROUNDS rounds of `reps` calls queued back to back
    behind a spin kernel, each round's time over reps. On the CPU: the
    median of `reps` host-clock timings."""
    fn()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)
    per_call = []
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def time_key(device: torch.device) -> str:
    """The name a time is reported under: `ms` on a card, `cpu_ms` else."""
    return "ms" if device.type == "cuda" else "cpu_ms"


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def device_kernel_times(prof) -> Dict[str, List]:
    """{name: [device us, calls]} of a finished torch.profiler trace's
    device events (kernels, copies, sets), summed from the trace's own
    events: `key_averages()` gives the same sums but first builds a Python
    event tree, which takes seconds for a trace of 10^4 to 10^5 kernels."""
    out: Dict[str, List] = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            row = out.setdefault(ev.name(), [0.0, 0])
            row[0] += ev.duration_ns() / 1e3
            row[1] += 1
    return out
