"""Measure the attainable float32 FMA and exp2 rates of the card (P2).

    python -m mamba_asr_torch.tools.peak_probe [--k 64] [--independent | --exp2]
        [--b 32] [--t 751] [--d 288] [--sweep] [--sass]

The port of scripts/vpu_peak.py: each element of a (B, T, D) float32 array
runs a chain of k data-dependent steps (`ops/peak_probe.py`): FMAs, one
chain (default) or four independent ones (`--independent`), or exp2 calls
(`--exp2`), the special function whose rate bounds the selective scan.
The time per step is the difference of two chain lengths, k and 16 k,
each timed by `tools/timing.py:median_ms` over REPS launches, so that the
launch and the memory traffic cancel. The input is drawn from SEED. The
default shape is the scan's main path, B32 x 751 frames x 288 channels.

One JSON line per mode, on the card:
- the times and the attained rate (TFLOP/s at 2 FLOP per FMA, or exp2
  results per second) against the published peak (67 TFLOP/s float32; 16
  special-function results per clock per SM at the card's maximum SM
  clock) and against the peak at the SM clock held during one more launch
  at 16 k (block 0's `clock64` cycles over its `%globaltimer`
  nanoseconds);
- `whole_k2`: the same rates from the whole 16 k launch over its steps,
  with no difference taken. Where the launch at k is bound by its stream
  rather than its chains (the FMA modes at k 64), the difference takes the
  stream's time away too and overstates the rate; the whole launch is then
  the floor under it;
- the time at k 0 (the stream alone) beside a torch copy of x, the
  launch's bound (`probe_bound_ms`) and the share of it reached at k, the
  launch geometry and the card's name.
`--device cpu` runs the plain loop, timed on the host's clock, and reports
none of the card's fields; without a card the tool raises.

The card-only reports, one JSON line per entry:
  --sweep   the FMA modes' per-step rates between k SWEEP_K and 16 SWEEP_K
            (both launches bound by their chains) at 2 to 16 resident
            warps per SM sub-partition (SWEEP_POINTS);
  --sass    each kernel's chain loop in the built library's SASS
            (cuobjdump): FFMAs or MUFUs against all other instructions,
            and the steps that read two registers from one bank.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mamba_asr_torch.ops.peak_probe import MODES, peak_probe
from mamba_asr_torch.tools.timing import device_name, median_ms, time_key
from mamba_asr_torch.utils.device import resolve_device

HBM_BYTES_PER_S = 3.35e12    # H100 SXM (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
FP32_LANES_PER_SM = 128      # Hopper: FP32 FMA results per clock per SM
SFU_PER_CLOCK_PER_SM = 16    # Hopper: special-function results per clock per SM
K2_PER_K = 16                # the second chain length is 16 k
REPS = 20                    # launches per timing
SEED = 0
SWEEP_K = 1024               # the sweep's k: both lengths bound by the chains
# (blocks per SM, warps per block) of the sweep: 2, 4, 8, 12 and 16
# resident warps per SM sub-partition (4 per SM).
SWEEP_POINTS = ((1, 8), (1, 16), (1, 32), (2, 24), (2, 32))


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0].split()[0]) * 1e6


def steps_per_element(mode: str, k: int) -> int:
    """FMAs (or exp2 calls) per element of a chain of length k."""
    return k // 4 * 4 if mode == "independent" else k


def probe_bound_ms(numel: int, k: int, mode: str, clock_hz: float, sms: int):
    """(ms, "bytes" or "operations"): least time for the probe's work, x
    read and out written once against 2 FLOP per FMA at the float32 peak,
    or one exp2 per step on the SFUs at clock_hz."""
    steps = steps_per_element(mode, k) * numel
    bytes_s = 8.0 * numel / HBM_BYTES_PER_S
    if mode == "exp2":
        ops_s = steps / (SFU_PER_CLOCK_PER_SM * sms * clock_hz)
    else:
        ops_s = 2.0 * steps / FP32_FLOP_PER_S
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s else "operations")


def probe_input(b: int, t: int, d: int, seed: int, device) -> torch.Tensor:
    """x ~ U(0.1, 0.9) (B, T, D) float32, as the script draws it."""
    x = np.random.default_rng(seed).uniform(0.1, 0.9, size=(b, t, d)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def held_clock_hz(x: torch.Tensor, k: int, mode: str, blocks_per_sm: int, warps: int) -> float:
    """The SM clock block 0 held through one launch of the timed kernel at
    this geometry: its clock64 cycles over its %globaltimer nanoseconds."""
    from mamba_asr_torch.kernels import peak_probe as p2

    _, rec = p2.peak_probe_at(x, k, mode, blocks_per_sm, warps, clock=True)
    cycles, ns = rec.tolist()
    return 1e9 * cycles / ns


def _rates(mode: str, numel: int, per_step_ms: float, sms: int, clock_hz: float,
           held_hz: float) -> dict:
    """The attained rate of one per-step time against the published peak
    and the peak at the held clock."""
    per_s = numel / (per_step_ms / 1e3)
    if mode == "exp2":
        published = SFU_PER_CLOCK_PER_SM * sms * clock_hz
        return {"attained_exp2_per_s": per_s, "published_exp2_per_s": published,
                "fraction_of_published": per_s / published,
                "fraction_of_held_peak": per_s / (SFU_PER_CLOCK_PER_SM * sms * held_hz)}
    return {"attained_tflops": 2 * per_s / 1e12, "published_tflops": FP32_FLOP_PER_S / 1e12,
            "fraction_of_published": 2 * per_s / FP32_FLOP_PER_S,
            "fraction_of_held_peak": per_s / (FP32_LANES_PER_SM * sms * held_hz)}


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
    if dev.type == "cuda":
        from mamba_asr_torch.kernels import peak_probe as p2

        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        clock_hz = max_sm_clock_hz()
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
        if dev.type == "cuda":
            blocks, warps = p2.GEOMETRY[mode]
            held_hz = held_clock_hz(x, k2, mode, blocks, warps)
            bound_ms, bound_by = probe_bound_ms(x.numel(), k, mode, clock_hz, sms)
            rec.update(_rates(mode, x.numel(), per_step_ms, sms, clock_hz, held_hz))
            rec["whole_k2"] = _rates(mode, x.numel(), t2 / steps_per_element(mode, k2), sms,
                                     clock_hz, held_hz)
            out0 = torch.empty_like(x)
            rec.update(held_clock_mhz=held_hz / 1e6, max_sm_clock_mhz=clock_hz / 1e6,
                       bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / t1,
                       geometry={"blocks_per_sm": blocks, "warps": warps},
                       stream_ms=median_ms(lambda: peak_probe(x, 0, mode), REPS, dev),
                       copy_ms=median_ms(lambda: out0.copy_(x), REPS, dev))
        records.append(rec)
    return records


def sweep(modes: Sequence[str] = ("dependent", "independent"), k: int = SWEEP_K,
          points=SWEEP_POINTS, b: int = 32, t: int = 751, d: int = 288) -> List[dict]:
    """Each mode's per-step rate (k to K2_PER_K k) at each (blocks per SM,
    warps per block) point, all blocks resident, with the SM clock held
    at K2_PER_K k."""
    from mamba_asr_torch.kernels import peak_probe as p2

    dev = resolve_device(None)
    x = probe_input(b, t, d, SEED, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = max_sm_clock_hz()
    k2 = K2_PER_K * k
    records = []
    for mode in modes:
        for blocks, warps in points:
            def at(kk):
                return p2.peak_probe_at(x, kk, mode, blocks, warps)

            rec = {"tool": "peak_probe", "sweep": mode, "k": k, "k2": k2,
                   "blocks_per_sm": blocks, "warps": warps,
                   "warps_per_subpartition": blocks * warps / 4}
            t1, t2 = median_ms(lambda: at(k), REPS, dev), median_ms(lambda: at(k2), REPS, dev)
            per_step_ms = (t2 - t1) / (steps_per_element(mode, k2) - steps_per_element(mode, k))
            held_hz = held_clock_hz(x, k2, mode, blocks, warps)
            rec.update(ms=t1, ms_k2=t2, per_step_ms=per_step_ms, held_clock_mhz=held_hz / 1e6,
                       **_rates(mode, x.numel(), per_step_ms, sms, clock_hz, held_hz))
            records.append(rec)
    return records


# -- The kernels' SASS --------------------------------------------------------

_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA\s+(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_KERNEL = re.compile(r"peak_probe_kernelILi(\d)E(?:Lb([01])E)?")


def _words(text: str) -> List[str]:
    """One SASS instruction's opcode and operands, without its predicate."""
    words = text.replace(",", " ").split()
    return words[1:] if words and words[0].startswith("@") else words


def _opcode(text: str) -> str:
    """The base opcode of one SASS instruction: no predicate, no suffixes."""
    words = _words(text)
    return words[0].split(".")[0] if words else ""


def _bank_conflict(text: str) -> bool:
    """Whether two of an instruction's register sources read from the
    register file (not the operand reuse cache, `.reuse`) fall in one of
    the two register banks (register number mod 2)."""
    regs = [int(m.group(1)) for w in _words(text)[2:]
            for m in [re.fullmatch(r"R(\d+)", w)] if m]
    return len({r % 2 for r in regs}) < len(regs)


def sass_loops(sass: str) -> List[dict]:
    """For each probe kernel in cuobjdump's output, its chain loop: the
    innermost loop (a backward branch with no other inside) holding the
    most FFMAs (modes 0, 1) or MUFUs (mode 2), its opcode counts, the other
    instructions per step, and how many steps read two source registers
    from one bank."""
    out = []
    for part in re.split(r"(?=\bFunction\s*:)", sass):
        name = _FUNCTION.search(part)
        kernel = _KERNEL.search(name.group(1)) if name else None
        if kernel is None:
            continue
        mode = int(kernel.group(1))
        instrs, labels, pending = [], {}, []
        for line in part.splitlines():
            label = _LABEL.match(line)
            if label:
                pending.append(label.group(1))
                continue
            m = _INSTR.match(line)
            if m:
                addr = int(m.group(1), 16)
                labels.update((lab, addr) for lab in pending)
                pending = []
                instrs.append((addr, m.group(2)))
        branches = []
        for addr, text in instrs:
            b = _BRANCH.search(text)
            if b:
                target = b.group(1)
                target = int(target, 16) if target.startswith("0x") else labels.get(target)
                if target is not None:
                    branches.append((addr, target))
        key = "MUFU" if mode == 2 else "FFMA"
        best = None
        for addr, target in branches:
            if target > addr or any(target <= t <= a < addr for a, t in branches):
                continue
            body = [text for a, text in instrs if target <= a <= addr]
            ops: Dict[str, int] = {}
            for text in body:
                ops[_opcode(text)] = ops.get(_opcode(text), 0) + 1
            if best is None or ops.get(key, 0) > best["opcodes"].get(key, 0):
                best = {"opcodes": ops, "instructions": len(body), "steps": ops.get(key, 0),
                        "bank_conflicts": sum(_opcode(t) == key and _bank_conflict(t)
                                              for t in body)}
        if best is None:
            continue
        arith = best["steps"] + (best["opcodes"].get("FMUL", 0) if mode == 2 else 0)
        best.update(function=name.group(1), mode=MODES[mode],
                    timed=kernel.group(2) == "1",
                    other_per_step=(best["instructions"] - arith) / max(best["steps"], 1))
        out.append(best)
    return out


def sass_report(library: Path) -> List[dict]:
    """`sass_loops` of a built probe library (cuobjdump beside nvcc)."""
    from mamba_asr_torch.kernels import build

    cuobjdump = str(Path(build.nvcc()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(library)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    return sass_loops(text)


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
    ap.add_argument("--sweep", action="store_true",
                    help=f"the FMA modes' rates against resident warps at k {SWEEP_K} "
                         "(card only)")
    ap.add_argument("--sass", action="store_true",
                    help="each kernel's chain loop in SASS (card machine only)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    chosen = "independent" if args.independent else "exp2" if args.exp2 else "dependent"
    records = run((chosen,), args.k, args.b, args.t, args.d, args.device)
    if args.sweep:
        records += sweep(b=args.b, t=args.t, d=args.d)
    if args.sass:
        from mamba_asr_torch.kernels import build

        records += sass_report(build.build_all()["peak_probe"])
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
