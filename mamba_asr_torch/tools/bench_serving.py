"""Slot-scaling benchmark of the serving engine (the port's counterpart of
scripts/bench_serving.py).

    python -m mamba_asr_torch.tools.bench_serving <hparams.yaml> \\
        [--slots 1 8 32 64] [--chunk_frames 64] [--ticks 20] [--seed 0] \\
        [--device cpu] [--key value ...]

Builds the YAML's model with seeded weights (the JAX package's init
rules) and, for each slot count, a `serving.engine.StreamingServer` whose
every slot holds a stream of N(0, 0.1) noise. After each stream's first
chunk (the batch-1 bootstrap) and two warm-up ticks, it times `ticks`
steady ticks through the public API (feed every slot one chunk, then
`tick()`: host bookkeeping, H2D, the tick, the argmax's D2H, the
collapse). Per slot count, one JSON line:

- wall_ms_median, wall_ms_p95, wall_spread_pct ((max - min) / median)
  of those ticks on the host's clock;
- per_stream_ms: the median over n_slots;
- capacity_streams: n_slots * chunk seconds / median tick seconds, the
  real-time streams one device serves at this chunk;
- tick_fn_queued_ms: the tick function alone (no host bookkeeping),
  called back to back behind a spin kernel (`tools/timing.py:median_ms`):
  the card's time per tick when the card is the bound, else the host's
  issue time (`tick_fn_queued_cpu_ms` on the CPU);
- device_ms_per_tick: the card's kernel time per tick over PROFILED_TICKS
  ticks under torch.profiler (card activity only), and idle_share = 1 -
  device_ms_per_tick / wall_ms_median (None on the CPU);
- k1_launches_per_tick (the selective-scan kernel's wrapper count; 0 on
  the CPU, where the plain version runs) and peak_mem_bytes (the card's
  peak allocation, None on the CPU).

All rows come from one process, so they compare with each other. Runs on
the CUDA card unless --device names another.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from mamba_asr_torch.configs.loader import load_config, parse_overrides
from mamba_asr_torch.kernels import selective_scan as k1
from mamba_asr_torch.models.asr import ASRModel, init_params_
from mamba_asr_torch.serving.engine import StreamingServer
from mamba_asr_torch.tools.timing import device_kernel_times, median_ms, time_key
from mamba_asr_torch.utils.device import resolve_device

WARMUP_TICKS = 2
KERNEL_REPS = 5
PROFILED_TICKS = 3


def percentile(xs, q):
    """Nearest-rank percentile."""
    xs = sorted(xs)
    return xs[max(0, int(np.ceil(q / 100.0 * len(xs))) - 1)]


def seeded_model(cfg, seed: int, device: torch.device) -> ASRModel:
    model = init_params_(ASRModel(cfg), torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def device_ms_per_call(fn, calls: int) -> float:
    """The card's kernel time per call of fn() over `calls` calls, traced
    by torch.profiler (the card's activity only)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(us for us, _ in device_kernel_times(prof).values())
    if total_us <= 0:
        raise RuntimeError("the profile recorded no device time")
    return total_us / 1e3 / calls


def filled_engine(model, frontend, n_slots: int, chunk_frames: int, seed: int, devices=None):
    """An engine (over `devices`, default the model's) with every slot
    holding a promoted noise stream, and a feed() that hands every stream
    its next chunk."""
    engine = StreamingServer(model, frontend, None, n_slots=n_slots, chunk_frames=chunk_frames,
                             devices=devices)
    sids = [engine.attach() for _ in range(n_slots)]
    rng = np.random.default_rng(seed)

    def feed():
        for sid in sids:
            engine.feed(sid, rng.normal(0.0, 0.1, engine.chunk_samples).astype(np.float32))

    feed()
    engine.tick()  # every stream's bootstrap chunk
    for _ in range(WARMUP_TICKS):
        feed()
        engine.tick()
    return engine, feed


def bench_slots(model, frontend, n_slots: int, chunk_frames: int, ticks: int, seed: int,
                device: torch.device) -> dict:
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    engine, feed = filled_engine(model, frontend, n_slots, chunk_frames, seed)
    wall, launches = [], 0
    for _ in range(ticks):
        feed()
        before = k1.LAUNCHES
        t0 = time.perf_counter()
        engine.tick()  # returns after the argmax's copy to the host
        wall.append(1e3 * (time.perf_counter() - t0))
        launches += k1.LAUNCHES - before
    audio = torch.zeros(n_slots, engine.chunk_samples, device=device)
    mask = torch.ones(n_slots, dtype=torch.bool, device=device)
    with torch.no_grad():
        rep = engine._replicas[0]  # one replica: all the slots
        tick_fn_ms = median_ms(lambda: engine._tick_fn(rep, rep.state, audio, mask),
                               KERNEL_REPS, device)
    med = statistics.median(wall)
    device_ms = None
    if cuda:
        device_ms = device_ms_per_call(lambda: (feed(), engine.tick()), PROFILED_TICKS)
    chunk_s = chunk_frames * frontend.hop / frontend.sample_rate
    return {
        "n_slots": n_slots, "chunk_frames": chunk_frames, "ticks": ticks,
        "wall_ms_median": med, "wall_ms_p95": percentile(wall, 95),
        "wall_ms_min": min(wall), "wall_ms_max": max(wall),
        "wall_spread_pct": 100.0 * (max(wall) - min(wall)) / med,
        "per_stream_ms": med / n_slots, "capacity_streams": n_slots * chunk_s / (med / 1e3),
        f"tick_fn_queued_{time_key(device)}": tick_fn_ms,
        "device_ms_per_tick": device_ms,
        "idle_share": None if device_ms is None else 1.0 - device_ms / med,
        "k1_launches_per_tick": launches / ticks,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
    }


def run(cfg, frontend, slots, chunk_frames: int = 64, ticks: int = 20, seed: int = 0,
        device=None) -> List[dict]:
    """One row per slot count (see the module docstring)."""
    device = resolve_device(device)
    model = seeded_model(cfg, seed, device)
    return [bench_slots(model, frontend, n, chunk_frames, ticks, seed + n, device)
            for n in slots]


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(prog="python -m mamba_asr_torch.tools.bench_serving")
    p.add_argument("config")
    p.add_argument("--slots", type=int, nargs="+", default=[1, 8, 32, 64])
    p.add_argument("--chunk_frames", type=int, default=64)
    p.add_argument("--ticks", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args, extra = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    exp = load_config(args.config, parse_overrides(extra))
    rows = run(exp.model, exp.frontend, args.slots, args.chunk_frames, args.ticks, args.seed,
               device)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
