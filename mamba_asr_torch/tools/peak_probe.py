"""Measure the attainable float32 FMA and exp2 rates of the card (P2).

    python -m mamba_asr_torch.tools.peak_probe [--k 64] [--independent | --exp2]
        [--b 32] [--t 751] [--d 288]

The port of scripts/vpu_peak.py: each element of a (B, T, D) float32 array
runs a chain of k data-dependent steps (`ops/peak_probe.py`): FMAs, one
chain (default) or four independent ones (`--independent`), or exp2 calls
(`--exp2`), the special function whose rate bounds the selective scan.
The time per step is the difference of two chain lengths, k and 16 k,
each timed by `tools/timing.py:median_ms` over REPS launches, so that the
launch and the memory traffic cancel. The input is drawn from SEED. The default shape is the
scan's main path, B32 x 751 frames x 288 channels.

One JSON line per mode: times, the attained rate (TFLOP/s at 2 FLOP per
FMA, or exp2 results per second) against the published peak (67 TFLOP/s
float32; 16 special-function results per clock per SM at the card's
maximum SM clock), and the card's name. Runs on the card unless `--device
cpu` (the plain loop, timed on the host's clock, no rates); raises without
a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import List, Optional, Sequence

import numpy as np
import torch

from mamba_asr_torch.ops.peak_probe import MODES, peak_probe
from mamba_asr_torch.tools.timing import device_name, median_ms, time_key
from mamba_asr_torch.utils.device import resolve_device

FP32_FLOP_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
SFU_PER_CLOCK_PER_SM = 16    # Hopper: special-function results per clock per SM
K2_PER_K = 16                # the second chain length is 16 k
REPS = 20                    # launches per timing
SEED = 0


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0].split()[0]) * 1e6


def steps_per_element(mode: str, k: int) -> int:
    """FMAs (or exp2 calls) per element of a chain of length k."""
    return k // 4 * 4 if mode == "independent" else k


def probe_input(b: int, t: int, d: int, seed: int, device) -> torch.Tensor:
    """x ~ U(0.1, 0.9) (B, T, D) float32, as the script draws it."""
    x = np.random.default_rng(seed).uniform(0.1, 0.9, size=(b, t, d)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def run(modes: Sequence[str] = ("dependent",), k: int = 64, b: int = 32, t: int = 751,
        d: int = 288, device=None) -> List[dict]:
    """Time each mode at chain lengths k and K2_PER_K k and return one
    record each."""
    dev = resolve_device(device)
    if k < 1:
        raise ValueError(f"need k >= 1, got {k}")
    k2 = K2_PER_K * k
    x = probe_input(b, t, d, SEED, dev)
    key = time_key(dev)
    peaks = None
    if dev.type == "cuda":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        peaks = {"flop": FP32_FLOP_PER_S,
                 "exp2": SFU_PER_CLOCK_PER_SM * sms * max_sm_clock_hz()}
    records = []
    for mode in modes:
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
        out = peak_probe(x, k, mode)
        t1 = median_ms(lambda: peak_probe(x, k, mode), REPS, dev)
        t2 = median_ms(lambda: peak_probe(x, k2, mode), REPS, dev)
        steps = steps_per_element(mode, k2) - steps_per_element(mode, k)
        per_step_ms = (t2 - t1) / steps
        rec = {"tool": "peak_probe", "mode": mode, "k": k, "k2": k2, "shape": [b, t, d],
               key: t1, key + "_k2": t2, "per_step_" + key: per_step_ms,
               "finite": bool(torch.isfinite(out).all()), "card": device_name(dev)}
        if peaks is not None:
            per_s = x.numel() / (per_step_ms / 1e3)
            if mode == "exp2":
                rec.update(attained_exp2_per_s=per_s, published_exp2_per_s=peaks["exp2"],
                           fraction_of_published=per_s / peaks["exp2"])
            else:
                rec.update(attained_tflops=2 * per_s / 1e12,
                           published_tflops=peaks["flop"] / 1e12,
                           fraction_of_published=2 * per_s / peaks["flop"])
        records.append(rec)
    return records


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--b", type=int, default=32)
    ap.add_argument("--t", type=int, default=751)
    ap.add_argument("--d", type=int, default=288)
    ap.add_argument("--k", type=int, default=64, help="steps per element")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--independent", action="store_true",
                      help="4 independent FMA chains instead of 1 dependent")
    mode.add_argument("--exp2", action="store_true", help="a chain of exp2 calls")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    chosen = "independent" if args.independent else "exp2" if args.exp2 else "dependent"
    for rec in run((chosen,), args.k, args.b, args.t, args.d, args.device):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
