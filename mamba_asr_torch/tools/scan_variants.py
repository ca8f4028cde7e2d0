"""Attribute the selective-scan kernels' time piece by piece (P1).

    python -m mamba_asr_torch.tools.scan_variants [--bwd] [--variants base,noexp,...]
        [--b 32] [--t 751] [--d 288] [--n 16]

The port of scripts/exp_scan_variants.py. Each variant is K1 (or, with
`--bwd`, K2) with one piece of work removed (`ops/scan_variants.py` lists
them); its time per launch against `base` attributes that piece's cost.
The default shape is the main path's: B32 x 30 s (751 encoder frames),
d_inner 288, d_state 16, bf16; with `--bwd` the training shape, B32 x 25 s
(626 frames). The adjoint variants start from K1's own chunk states (the
training form) and take an N(0, 1) cotangent.

One JSON line per variant: time per launch (`tools/timing.py:median_ms`
over REPS launches), its delta to base, whether the output is finite, the
card's name; `fusedy` notes that it launches base's kernel (on this card
it is base by construction, `csrc/selective_scan_fwd.cuh`). Inputs are
drawn from SEED in bfloat16. Runs on the card unless `--device cpu` (the
plain versions, timed on the host's clock); raises without a card. A
variant that fails raises: the script this replaces printed FAILED and
went on.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

import torch

from mamba_asr_torch.ops import scan_variants as sv
from mamba_asr_torch.tools.timing import device_name, median_ms, time_key
from mamba_asr_torch.utils.device import resolve_device

FWD_FRAMES = 751   # 30 s at 40 ms per encoder frame
BWD_FRAMES = 626   # 25 s, the training cell
DTYPE = torch.bfloat16  # the model's compute dtype
REPS = 20          # launches per timing
SEED = 0           # inputs; the adjoint's cotangent from SEED + 1


def chunk_states(inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The forward's state after every CHUNK steps (B, ceil(L / CHUNK), D,
    N): K1's training form on a card, the plain prefixes on the CPU."""
    from mamba_asr_torch.kernels.selective_scan import CHUNK
    from mamba_asr_torch.ops.selective_scan import selective_scan_ref

    if inputs["u"].device.type == "cuda":
        from mamba_asr_torch.kernels import selective_scan as k1

        return k1.selective_scan_fwd_train(**inputs, delta_softplus=True)[2]
    length = inputs["u"].shape[1]
    per_step = ("u", "delta", "B", "C", "z")
    return torch.stack([
        selective_scan_ref(**{k: v[:, :end] if k in per_step else v for k, v in inputs.items()},
                           delta_softplus=True, return_last_state=True)[1]
        for end in range(CHUNK, length + CHUNK, CHUNK)], 1)


def run(variants: Optional[Sequence[str]] = None, bwd: bool = False, b: int = 32,
        t: Optional[int] = None, d: int = 288, n: int = 16, device=None) -> List[dict]:
    """Time each variant (base first, for the deltas) and return one record
    each. Inputs from `ops.scan_variants.variant_inputs(SEED)`."""
    dev = resolve_device(device)
    names = sv.BWD_VARIANTS if bwd else sv.FWD_VARIANTS
    variants = list(names if variants is None else variants)
    for v in variants:
        if v not in names:
            raise ValueError(f"unknown {'bwd' if bwd else 'fwd'} variant {v!r}; one of {names}")
    order = ["base"] + [v for v in variants if v != "base"]
    length = t if t is not None else (BWD_FRAMES if bwd else FWD_FRAMES)
    inputs = sv.variant_inputs(b, length, d, n, DTYPE, SEED, dev)
    if bwd:
        extra = dict(h0=None, h_chunks=chunk_states(inputs),
                     dout=sv.variant_dout(inputs, SEED + 1), dh_last=None)

        def call(v):
            return sv.scan_variant_bwd(v, **inputs, **extra)
    else:
        def call(v):
            return sv.scan_variant_fwd(v, **inputs)

    key = time_key(dev)
    records, base_ms = [], None
    for v in order:
        outs = call(v)
        finite = all(bool(torch.isfinite(o).all()) for o in outs if o is not None)
        ms = median_ms(lambda: call(v), REPS, dev)
        base_ms = ms if v == "base" else base_ms
        if v in variants:
            rec = {"tool": "scan_variants", "pass": "bwd" if bwd else "fwd",
                   "variant": v, "shape": [b, length, d, n], "dtype": "bfloat16",
                   key: ms, "delta_" + key: ms - base_ms, "finite": finite,
                   "card": device_name(dev)}
            if not bwd and v in sv.FWD_SAME_KERNEL:
                rec["kernel_of"] = sv.FWD_SAME_KERNEL[v]
            records.append(rec)
    return records


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bwd", action="store_true", help="the adjoint's variants (K2)")
    ap.add_argument("--variants", default=None, help="comma-separated; default: all")
    ap.add_argument("--b", type=int, default=32)
    ap.add_argument("--t", type=int, default=None,
                    help=f"default {FWD_FRAMES}, {BWD_FRAMES} with --bwd")
    ap.add_argument("--d", type=int, default=288)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    variants = None if args.variants is None else args.variants.split(",")
    for rec in run(variants, args.bwd, args.b, args.t, args.d, args.n, args.device):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
