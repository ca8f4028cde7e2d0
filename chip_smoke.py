#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing one JSON line (any failure raises and the script
exits non-zero; it prints no result without a CUDA card):

  build      compile the CUDA kernels from mamba_asr_torch/csrc (nvcc, sm_90a)
  kernel     the selective-scan kernel against its plain version on the
             card: the full-width shape in bf16, and an fp32 case with h0
             in, h_last out and ragged L and D; times and bound
  parity     the full-width ConMamba-Small CTC model (hparams/CTC/
             conmamba_small.yaml, seeded weights, fp32, TF32 off) on the
             card against the same model on the CPU
  recognize  Recognizer(device="cuda", batch=4) in bf16 answers 6 requests
             of 3-30 s; then bench.py's throughput block (B32 x 30 s of
             N(0, 0.1) noise) through Recognizer(batch=32): RTFx as the
             median of 5 blocks
  profile    one B32 x 30 s forward under torch.profiler: device time by
             kernel

then the kernels line, the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG = "hparams/CTC/conmamba_small.yaml"
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12     # H100 SXM, float32 outside the tensor cores
SFU_PER_CLOCK_PER_SM = 16   # Hopper: 16 special-function results / clock / SM
BF16_TOL = (1e-2, 1e-2)     # (atol, rtol): one bf16 ulp of the output is <= 0.78 % of it
FP32_TOL = (2e-4, 2e-4)     # exp2 vs exp and FMA contraction over L steps
PARITY_TOL = 1e-3           # CTC log-probs after 12 fp32 layers, card vs CPU


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median of `reps` CUDA-event timings of fn(), after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_close(name, got, ref, atol, rtol) -> float:
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{name}: max|d| {err.max().item():.3e}, {int(bad.sum())} of "
            f"{bad.numel()} outside atol {atol} + rtol {rtol}"
        )
    return err.max().item()


def scan_inputs(bsz, length, d, n, dtype, gen, h0=False):
    """Inputs of the scale the model gives the scan: S4D A, dt_bias from
    the Mamba init rule, unit D."""
    from mamba_asr_torch.models.mamba import MambaConfig, init_dt_bias_

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).cuda()

    dt_bias = torch.empty(d)
    init_dt_bias_(dt_bias, MambaConfig(), gen)
    a = -torch.arange(1, n + 1, dtype=torch.float32).repeat(d, 1)
    return dict(
        u=randn(bsz, length, d).to(dtype), delta=randn(bsz, length, d, scale=0.5).to(dtype),
        A=a.cuda(), B=randn(bsz, length, n).to(dtype), C=randn(bsz, length, n).to(dtype),
        D=torch.ones(d, device="cuda"), z=randn(bsz, length, d).to(dtype),
        delta_bias=dt_bias.cuda(), h0=randn(bsz, d, n) if h0 else None,
    )


def scan_bound_ms(inp, clock_hz: float, sms: int):
    """Least time for the scan's work: each input read and the output
    written once, against the exp2 (one per state element) and the
    softplus/silu special functions (~4 per channel step) on the SFUs and
    ~6 fp32 FLOP per state element."""
    b, length, d = inp["u"].shape
    n = inp["A"].shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in inp.values() if t is not None)
    nbytes += inp["u"].numel() * inp["u"].element_size()  # out
    sfu_s = b * length * d * (n + 4) / (SFU_PER_CLOCK_PER_SM * sms * clock_hz)
    flop_s = 6.0 * b * length * d * n / FP32_FLOP_PER_S
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = max(sfu_s, flop_s)
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s else "operations")


def phase_build():
    from mamba_asr_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for name in libs for ln in build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds, "libraries": sorted(libs),
          "ptxas": ptxas})


def phase_kernel(cfg, clock_hz, sms):
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.ops.selective_scan import selective_scan_ref

    gen = torch.Generator().manual_seed(SEED)
    cases = []
    # The main path's shape: B32 x 30 s -> 751 encoder frames, d_inner 288.
    d_inner = cfg.mamba.expand * cfg.d_model
    full = scan_inputs(32, 751, d_inner, cfg.mamba.d_state, torch.bfloat16, gen)
    ragged = scan_inputs(3, 333, 200, cfg.mamba.d_state, torch.float32, gen, h0=True)
    for name, inp, tol in (("full_width_bf16", full, BF16_TOL),
                           ("ragged_fp32_h0", ragged, FP32_TOL)):
        out, h_last = kernel.selective_scan_fwd(
            **inp, delta_softplus=True, return_last_state=True)
        torch.cuda.synchronize()
        ref, h_ref = selective_scan_ref(
            **inp, delta_softplus=True, return_last_state=True)
        err = check_close(name, out, ref, *tol)
        h_err = check_close(name + " h_last", h_last, h_ref, *FP32_TOL)
        cases.append({"case": name, "shape": list(inp["u"].shape) + [inp["A"].shape[1]],
                      "dtype": str(inp["u"].dtype), "max_abs_err": err,
                      "h_last_max_abs_err": h_err, "tol": tol})
    kernel_ms = cuda_ms(lambda: kernel.selective_scan_fwd(**full, delta_softplus=True), 20)
    plain_ms = cuda_ms(lambda: selective_scan_ref(**full, delta_softplus=True), 5)
    bound_ms, bound_by = scan_bound_ms(full, clock_hz, sms)
    result = {"phase": "kernel", "name": "selective_scan_fwd", "cases": cases,
              "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": None,
              "launches_in_phase": kernel.LAUNCHES}
    emit(result)
    return result


def seeded_state(cfg):
    from mamba_asr_torch.models.asr import ASRModel, init_params_

    model = init_params_(ASRModel(cfg), torch.Generator().manual_seed(SEED))
    return model.state_dict()


def noise(seconds, seed, sr=16000):
    return np.random.default_rng(seed).normal(0.0, 0.1, int(seconds * sr)).astype(np.float32)


def phase_parity(cfg, frontend, state):
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.serving.recognizer import Recognizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    wav = np.zeros((2, 64000), np.float32)
    wav[0] = noise(4.0, 1)
    wav[1, :49600] = noise(3.1, 2)
    lens = torch.tensor([64000, 49600], dtype=torch.int32)
    outs = {}
    for dev in ("cuda", "cpu"):
        rec = Recognizer(cfg32, frontend, state, device=dev, batch=2)
        kernel.LAUNCHES = 0
        outs[dev] = rec.eval_step(torch.from_numpy(wav), lens)
        launches = kernel.LAUNCHES
        if dev == "cuda":
            torch.cuda.synchronize()
            if launches != 2 * cfg.num_encoder_layers:
                raise AssertionError(f"parity forward launched the scan {launches} times")
    lp_gpu = outs["cuda"]["ctc_log_probs"].cpu()
    lp_cpu = outs["cpu"]["ctc_log_probs"]
    err = check_close("parity ctc_log_probs", lp_gpu, lp_cpu, PARITY_TOL, 0.0)
    enc_lens = outs["cpu"]["enc_lengths"]
    valid = torch.arange(lp_cpu.shape[1])[None, :] < enc_lens[:, None]

    def agreement(lp):
        return (lp.argmax(-1) == lp_cpu.argmax(-1))[valid].float().mean().item()

    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
    torch.backends.cudnn.allow_tf32 = True  # back to PyTorch's defaults
    # The served dtype against the same fp32 reference: reported, not
    # held to a limit (bf16 activations over 12 layers).
    lp_bf16 = Recognizer(cfg, frontend, state, device="cuda", batch=2).eval_step(
        torch.from_numpy(wav), lens)["ctc_log_probs"].cpu()
    if not torch.isfinite(lp_bf16).all():
        raise AssertionError("bf16 log-probs are not finite")
    emit({"phase": "parity", "shape": list(lp_cpu.shape), "max_abs_err": err,
          "tol": PARITY_TOL, "argmax_agreement": agreement(lp_gpu),
          "allow_tf32": tf32,
          "bf16_vs_fp32_cpu": {"max_abs_diff": (lp_bf16 - lp_cpu).abs().max().item(),
                               "argmax_agreement": agreement(lp_bf16)}})


def phase_recognize(cfg, frontend, state):
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.serving.recognizer import Recognizer

    per_forward = 2 * cfg.num_encoder_layers
    rec = Recognizer(cfg, frontend, state, device="cuda", batch=4)
    requests = [noise(s, 10 + i) for i, s in enumerate((3.0, 7.5, 12.25, 18.0, 24.6, 30.0))]
    rec.transcribe(requests[:1])  # warm-up
    kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    ids = rec.transcribe(requests)
    seconds = time.perf_counter() - t0
    main_launches = kernel.LAUNCHES
    forwards = -(-len(requests) // rec.batch)
    if main_launches != per_forward * forwards:
        raise AssertionError(f"{main_launches} scan launches for {forwards} forwards")

    rec32 = Recognizer(cfg, frontend, state, device="cuda", batch=32)
    batch = [noise(30.0, 100 + i) for i in range(32)]
    out = rec32.eval_step(torch.from_numpy(np.stack(batch)),
                          torch.full((32,), 480000, dtype=torch.int32))
    lp = out["ctc_log_probs"]
    if tuple(lp.shape) != (32, 751, cfg.vocab_size) or not torch.isfinite(lp).all():
        raise AssertionError(f"bad log-probs {tuple(lp.shape)}")
    iters = 10
    rec32.transcribe(batch)  # warm-up
    kernel.LAUNCHES = 0
    blocks = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(iters):
            rec32.transcribe(batch)
        blocks.append(32 * 30.0 * iters / (time.perf_counter() - t0))
    if kernel.LAUNCHES != per_forward * 5 * iters:
        raise AssertionError(f"{kernel.LAUNCHES} scan launches in the throughput blocks")
    rtfx = statistics.median(blocks)
    emit({"phase": "recognize", "requests_s": [len(r) / 16000 for r in requests],
          "tokens": [len(x) for x in ids], "seconds": seconds,
          "scan_launches": main_launches, "forwards": forwards,
          "throughput": {"batch": 32, "seconds_each": 30.0, "iters_per_block": iters,
                         "rtfx": rtfx, "spread_pct": 100.0 * (max(blocks) - min(blocks)) / rtfx,
                         "blocks": blocks, "compute_dtype": cfg.compute_dtype}})
    return main_launches, rec32, batch


def phase_profile(rec32, batch):
    from torch.profiler import ProfilerActivity, profile

    wav = torch.from_numpy(np.stack(batch))
    lens = torch.full((32,), 480000, dtype=torch.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec32.eval_step(wav, lens)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    emit({"phase": "profile", "wall_ms": wall_ms, "device_kernel_ms": total_ms,
          "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": c} for us, k, c in rows[:12]]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from mamba_asr_torch.configs.loader import load_config

    card = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    emit({"phase": "device", "nvidia_smi": card, "max_sm_clock_mhz": clock_mhz,
          "sms": props.multi_processor_count, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    exp = load_config(CONFIG)
    cfg, frontend = exp.model, exp.frontend

    phase_build()
    k = phase_kernel(cfg, clock_mhz * 1e6, props.multi_processor_count)
    state = seeded_state(cfg)
    phase_parity(cfg, frontend, state)
    launches, rec32, batch = phase_recognize(cfg, frontend, state)
    phase_profile(rec32, batch)

    full = k["cases"][0]
    emit({"kernels": [{
        "name": "selective_scan_fwd", "route": "cuda",
        "source": "mamba_asr_torch/csrc/selective_scan_fwd.cu",
        "replaces": "mamba_asr_tpu/ops/pallas/scan.py:320",
        "launches": launches, "max_abs_err": full["max_abs_err"],
        "ms": k["kernel_ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
