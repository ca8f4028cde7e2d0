#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing one JSON line (any failure raises and the script
exits non-zero; it prints no result without a CUDA card):

  build      compile the CUDA kernels from mamba_asr_torch/csrc (nvcc, sm_90a)
  peak_probe the probe (P2) against its plain loop at a small size in its
             three modes, then the tools.peak_probe entry point at its
             defaults (B32 x 751 x 288): the attained FFMA rate (dependent
             and 4 independent chains) and exp2 rate against the
             published peaks; the probe against its plain loop again at
             that shape and the tool's two chain lengths (64, 1,024);
             time, plain time and bound of one launch
  kernel     the selective-scan kernel (K1) against its plain version on
             the card: the full-width shape in bf16, an fp32 case with h0
             in, h_last out and ragged L and D, and B1 L751 bf16; times,
             the published-peak bound and the bound at peak_probe's
             measured rates; a batch sweep (B1 to B32 at L751 bf16, each
             against its plain version) timing the time segments chosen
             for several blocks-per-SM targets beside the unsplit form
  parity     the full-width ConMamba-Small CTC model (hparams/CTC/
             conmamba_small.yaml, seeded weights, fp32, TF32 off) on the
             card against the same model on the CPU
  recognize  Recognizer(device="cuda", batch=4) in bf16 answers 6 requests
             of 3-30 s; then bench.py's throughput block (B32 x 30 s of
             N(0, 0.1) noise) through Recognizer(batch=32): RTFx as the
             median of 5 blocks
  profile    one B32 x 30 s forward under torch.profiler: device time by
             kernel
  kernel_bwd the selective-scan adjoint (K2) against its plain version at
             the training shape (B32 x 25 s -> L626, D288, N16, bf16) and
             on a ragged fp32 case with h0 and d(h_last); K1's training
             form against its inference form and the plain chunk states;
             K2's time alone (its C entry) and through the wrapper (with
             the torch sums of its partials), bounds, and the registers,
             stack and spills ptxas reported for each K2 instantiation
  scan_variants  each forward and adjoint variant (P1) against its plain
             version at B2 L200 D280 N16 fp32 (ragged), then the
             tools.scan_variants entry point at its defaults (B32 L751,
             and L626 for the adjoint, D288 N16 bf16): ms per launch and
             delta to base; each variant against its plain version again
             on the tool's own inputs; base's plain time and bound
  train_parity  one Trainer.train_step of the full-width model (fp32,
             TF32 and cuDNN off, dropout 0, SpecAugment off, B2 x 4 s)
             on the card against the CPU: loss and every parameter's
             gradient (the cuDNN-on difference is reported)
  train      Trainer(device="cuda") with the YAML's settings (bf16,
             dropout 0.1, SpecAugment, accumulation 4) on B32 x 25 s of
             noise with ~300-token targets: 8 checked micro-steps, then
             training throughput (audio-s per wall-s, median of 3 blocks
             of 4 micro-steps) and peak memory
  train_profile  one such micro-step under torch.profiler
  kernel_ctc_dp  the CTC prefix DP (K3) against its plain loop at T 751
             (30 s) with N 66 and 528 hypotheses, ragged N 66 and 528,
             T 1, T 2, N 1 and N 33; time, bound, the chain of dependent
             logaddexps, and the time per 768-frame segment (T 768
             against 9 x 768)
  kernel_beam_attn  the beam attention (K4) against the plain gather at
             the S2S-Small decoder's H 4, dh 36, S 320, N 66 and 528,
             bf16, pos 0, 31, 32, 63, 64, 255, on a beam-shaped ancestor
             table, at forced splits 1 to 16, at pos 1,023 (S 1,024), and
             at the Large decoder's 8 heads of 64 in fp32 and bf16; times
             at pos 63, 127, 255 on a random and a beam-shaped table with
             bounds (distinct rows, and their 32-byte sectors) and the
             gather + scaled_dot_product_attention yardstick; a sweep of
             the position split at N 66 and 528
  s2s_parity the full-width ConMamba-Small S2S model (hparams/S2S/
             conmamba_small.yaml, seeded, fp32, TF32 and cuDNN off, B2 x
             4 s), card against CPU on the same encoder output: 8 cached
             decode steps through shuffled ancestor tables, 4 scorer
             steps, and the whole search at beam 10 (best scores held;
             tokens reported)
  s2s_recognize  Recognizer(search="s2s") in bf16 with the decode stanza
             (beam 66, CTC 0.4, 96 candidates): 3 requests of 3-30 s at
             batch=1; then B8 x 30 s of noise at batch=8, S2S RTFx as the
             median of 5 searches (the seeded decoder rarely emits eos, so
             each search runs all 256 steps: the worst case)
  s2s_profile  one B8 x 30 s search under torch.profiler, with K3's and
             K4's device ms

Each phase also prints its wall seconds. Then the kernels line, the
card's name and power limit, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import re
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
# K2 vs its plain version: (rtol, fraction of the largest |value| as atol).
# bf16: du, ddelta, dz, dB, dC round to bf16 on both sides (one ulp is
# 0.78 %); fp32: exp2 vs exp and partial sums in other orders.
BWD_BF16_TOL = (2e-2, 2e-2)
BWD_FP32_TOL = (1e-3, 1e-4)
# One fp32 train step, card vs CPU, cuDNN off: the loss, and each
# parameter's gradient after 12 layers forward and back (sums in other
# orders, torch's CTC against the plain recursion). With cuDNN on, its
# convolution backward differs from the CPU's by up to ~1e-2 of the
# largest value on the front end's weight gradients even with TF32 off,
# and by a different amount in each run: that is reported, not held.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = (1e-2, 1e-3)
TRAIN_SECONDS = 25.0        # 626 encoder frames; B32 x 25 s = 800 s < max_batch_seconds 850
S2S_CONFIG = "hparams/S2S/conmamba_small.yaml"
# K3 vs its plain loop: expf/log1pf against torch's exp/log1p over 751
# dependent steps (values reach -1e3; 1e-5 relative is ~80 float32 ulps).
CTC_DP_TOL = (1e-4, 1e-5)
# The S2S model in fp32, card vs CPU: decoder log-probs after 4 layers,
# the scorer's psi (a 5000-wide matmul over 101 frames in another order)
# and the DP; the searches' best length-normalized scores.
S2S_PARITY_TOL = 1e-3
GRAD_NAMES = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias", "h0")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(phase, *args):
    """Run one phase and print its wall seconds on a line of its own."""
    t0 = time.perf_counter()
    result = phase(*args)
    emit({"phase_seconds": phase.__name__[len("phase_"):],
          "seconds": time.perf_counter() - t0})
    return result


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Device milliseconds per call of fn(): `reps` calls back to back
    behind a queue-filling spin kernel, median of rounds
    (mamba_asr_torch/tools/timing.py:median_ms)."""
    from mamba_asr_torch.tools.timing import median_ms

    return median_ms(fn, reps, torch.device("cuda"))


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


def scan_bound_ms(inp, clock_hz: float, sms: int, rates=None):
    """Least time for the scan's work: each input read and the output
    written once, against the exp2 (one per state element) and the
    softplus/silu special functions (~4 per channel step) on the SFUs and
    ~6 fp32 FLOP per state element. `rates` (exp2 per s, FLOP per s)
    replaces the published peaks with the ones peak_probe measured."""
    b, length, d = inp["u"].shape
    n = inp["A"].shape[1]
    sfu_rate, flop_rate = rates or (SFU_PER_CLOCK_PER_SM * sms * clock_hz, FP32_FLOP_PER_S)
    nbytes = sum(t.numel() * t.element_size() for t in inp.values() if t is not None)
    nbytes += inp["u"].numel() * inp["u"].element_size()  # out
    sfu_s = b * length * d * (n + 4) / sfu_rate
    flop_s = 6.0 * b * length * d * n / flop_rate
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = max(sfu_s, flop_s)
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s else "operations")


def scan_bwd_bound_ms(inp, clock_hz: float, sms: int):
    """Least time for the adjoint's work: its inputs (the forward's, dout
    and the chunk states) read once and its outputs (du, ddelta, dz in
    u's dtype; dB, dC, dA, dD, ddelta_bias in fp32) written once, against
    an exp2 per state element and ~5 special functions per channel step
    (softplus, its derivative, the sigmoid of z) on the SFUs and ~15 fp32
    FLOP per state element."""
    b, length, d = inp["u"].shape
    n = inp["A"].shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in inp.values()
                 if torch.is_tensor(t))
    nbytes += 3 * inp["u"].numel() * inp["u"].element_size()  # du, ddelta, dz
    nbytes += 4 * (2 * b * length * n + d * n + 2 * d)         # dB, dC, dA, dD, ddb
    if inp.get("h0") is not None:
        nbytes += inp["h0"].numel() * 4                        # dh0
    sfu_s = b * length * d * (n + 5) / (SFU_PER_CLOCK_PER_SM * sms * clock_hz)
    flop_s = 15.0 * b * length * d * n / FP32_FLOP_PER_S
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = max(sfu_s, flop_s)
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s else "operations")


def check_grads(name, got, ref, rtol, atol_frac):
    """Each gradient within atol_frac * max|ref| + rtol * |ref|; returns
    the largest error relative to its tensor's largest value, and the
    largest absolute error."""
    worst = worst_abs = 0.0
    for key, g, r in zip(GRAD_NAMES, got, ref):
        if r is None:
            if g is not None:
                raise AssertionError(f"{name} {key}: expected no gradient")
            continue
        if g.dtype != r.dtype or g.shape != r.shape:
            raise AssertionError(f"{name} {key}: {g.dtype} {tuple(g.shape)} vs "
                                 f"{r.dtype} {tuple(r.shape)}")
        scale = r.float().abs().max().item()
        err = check_close(f"{name} {key}", g, r, atol_frac * scale, rtol)
        worst = max(worst, err / max(scale, 1e-30))
        worst_abs = max(worst_abs, err)
    return worst, worst_abs


def plain_chunk_states(inp, chunk):
    """The plain states after steps chunk, 2*chunk, ... and L:
    selective_scan_ref on each prefix (B, n_chunks, D, N)."""
    from mamba_asr_torch.ops.selective_scan import selective_scan_ref

    length = inp["u"].shape[1]
    per_step = ("u", "delta", "B", "C", "z")
    states = []
    for end in range(chunk, length + chunk, chunk):
        part = {k: (v[:, :min(end, length)] if k in per_step else v)
                for k, v in inp.items()}
        states.append(selective_scan_ref(**part, delta_softplus=True,
                                         return_last_state=True)[1])
    return torch.stack(states, 1)


def phase_build():
    from mamba_asr_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for name in libs for ln in build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds, "libraries": sorted(libs),
          "ptxas": ptxas})


# Blocks-per-SM targets of K1's time segments timed in the batch sweep
# (kernels/selective_scan.py:time_segments), whatever the batch; 0 is the
# unsplit form.
K1_SPLIT_TARGETS = (0, 1, 2, 4, 8)


def k1_at(kernel, inp, sms, blocks_per_sm):
    """(segments, device ms per launch) of K1 on `inp` with the time split
    for `blocks_per_sm` blocks per SM."""
    saved = kernel.FWD_SPLIT_BELOW, kernel.FWD_BLOCKS_PER_SM
    kernel.FWD_SPLIT_BELOW, kernel.FWD_BLOCKS_PER_SM = float("inf"), blocks_per_sm
    try:
        segments = kernel.time_segments(*inp["u"].shape, sms)[0]
        return segments, cuda_ms(lambda: kernel.selective_scan_fwd(**inp, delta_softplus=True),
                                 20)
    finally:
        kernel.FWD_SPLIT_BELOW, kernel.FWD_BLOCKS_PER_SM = saved


def phase_kernel(cfg, clock_hz, sms, rates):
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.ops.selective_scan import selective_scan_ref

    gen = torch.Generator().manual_seed(SEED)
    cases = []
    # The main path's shape: B32 x 30 s -> 751 encoder frames, d_inner 288.
    d_inner = cfg.mamba.expand * cfg.d_model
    full = scan_inputs(32, 751, d_inner, cfg.mamba.d_state, torch.bfloat16, gen)
    ragged = scan_inputs(3, 333, 200, cfg.mamba.d_state, torch.float32, gen, h0=True)
    single = scan_inputs(1, 751, d_inner, cfg.mamba.d_state, torch.bfloat16, gen)
    for name, inp, tol in (("full_width_bf16", full, BF16_TOL),
                           ("ragged_fp32_h0", ragged, FP32_TOL),
                           ("b1_bf16", single, BF16_TOL)):
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
    measured_ms, measured_by = scan_bound_ms(full, clock_hz, sms, rates)
    # The time segments against batch: each batch against its plain
    # version, and timed with the segments chosen for each blocks-per-SM
    # target (0: unsplit), the evidence for kernel.FWD_SPLIT_BELOW and
    # FWD_BLOCKS_PER_SM; `segments` is what the wrapper chooses.
    by_batch = {}
    for bsz in (1, 2, 4, 8, 16, 32):
        inp = (single if bsz == 1 else full if bsz == 32 else
               scan_inputs(bsz, 751, d_inner, cfg.mamba.d_state, torch.bfloat16, gen))
        out = kernel.selective_scan_fwd(**inp, delta_softplus=True)
        torch.cuda.synchronize()
        err = check_close(f"b{bsz}_bf16", out, selective_scan_ref(**inp, delta_softplus=True),
                          *BF16_TOL)
        swept = {t: k1_at(kernel, inp, sms, t) for t in K1_SPLIT_TARGETS}
        by_batch[bsz] = {
            "max_abs_err": err, "bound_ms": scan_bound_ms(inp, clock_hz, sms)[0],
            "segments": kernel.time_segments(bsz, 751, d_inner, sms)[0],
            "swept": {t: {"segments": seg, "kernel_ms": ms} for t, (seg, ms) in swept.items()}}
    result = {"phase": "kernel", "name": "selective_scan_fwd", "cases": cases,
              "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "bound_measured_ms": measured_ms,
              "bound_measured_by": measured_by,
              "measured_rates": {"exp2_per_s": rates[0], "flop_per_s": rates[1]},
              "library_ms": None, "split_below": kernel.FWD_SPLIT_BELOW,
              "blocks_per_sm": kernel.FWD_BLOCKS_PER_SM,
              "by_batch": by_batch, "launches_in_phase": kernel.LAUNCHES}
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


def device_profile(fn, top: int, named=()):
    """One call of fn() under torch.profiler: (wall ms, device kernel ms,
    the `top` kernels by device time as {kernel, ms, calls}, followed by
    any other kernel whose name holds one of `named`). Only the
    card's activity is traced: recording the host's operators as well made
    the S2S search's profile take 67 s instead of 22 s on an H100 host."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, ev.key, ev.count))
    if not rows:
        raise AssertionError("the profile recorded no device time")
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    return wall_ms, total_ms, [{"kernel": k[:80], "ms": us / 1e3, "calls": c}
                               for i, (us, k, c) in enumerate(rows)
                               if i < top or any(name in k for name in named)]


def phase_profile(rec32, batch):
    wav = torch.from_numpy(np.stack(batch))
    lens = torch.full((32,), 480000, dtype=torch.int32)
    wall_ms, total_ms, top = device_profile(lambda: rec32.eval_step(wav, lens), 12)
    emit({"phase": "profile", "wall_ms": wall_ms, "device_kernel_ms": total_ms,
          "top": top})


# "bwd_kernel<V, NS, T>" in a mangled name: variant, states per lane, dtype.
PTXAS_BWD = re.compile(r"scan_bwd10bwd_kernelILi(\d+)ELi(\d+)E(13__nv_bfloat16|f)")


def bwd_ptxas(log: str):
    """Registers, stack frame and spill bytes of each K2 body
    instantiation in a build log ('-Xptxas -v'): {"V0 NS2 bf16": {...}}."""
    out, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            m = PTXAS_BWD.search(line)
            name = None if m is None else (
                f"V{m[1]} NS{m[2]} {'bf16' if m[3] != 'f' else 'fp32'}")
            if name:
                out[name] = {}
        elif name and "stack frame" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[name].update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif name and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
            name = None
    return out


def phase_kernel_bwd(cfg, clock_hz, sms):
    from mamba_asr_torch.kernels import build
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.ops.selective_scan import selective_scan_bwd_ref

    gen = torch.Generator().manual_seed(SEED + 1)
    d_inner = cfg.mamba.expand * cfg.d_model
    frames = -(-(int(TRAIN_SECONDS * 100) + 1) // cfg.downsample)
    train = scan_inputs(32, frames, d_inner, cfg.mamba.d_state, torch.bfloat16, gen)
    ragged = scan_inputs(3, 333, 200, cfg.mamba.d_state, torch.float32, gen, h0=True)
    cases, cots = [], {}
    for name, inp, tol in (("train_bf16", train, BWD_BF16_TOL),
                           ("ragged_fp32_h0_dhlast", ragged, BWD_FP32_TOL)):
        b, length, d = inp["u"].shape
        n = inp["A"].shape[1]
        dout = torch.randn(b, length, d, generator=gen).cuda().to(inp["u"].dtype)
        dhl = torch.randn(b, d, n, generator=gen).cuda() if inp["h0"] is not None else None
        cots[name] = (dout, dhl)
        out_inf = kernel.selective_scan_fwd(**inp, delta_softplus=True)
        out, _, h_chunks = kernel.selective_scan_fwd_train(**inp, delta_softplus=True)
        got = kernel.selective_scan_bwd(**inp, delta_softplus=True, h_chunks=h_chunks,
                                        dout=dout, dh_last=dhl)
        torch.cuda.synchronize()
        if not torch.equal(out, out_inf):
            raise AssertionError(f"{name}: K1's training form changed out")
        states_err = check_close(f"{name} chunk states", h_chunks,
                                 plain_chunk_states(inp, kernel.CHUNK), *FP32_TOL)
        ref = selective_scan_bwd_ref(*(inp[k] for k in GRAD_NAMES[:8]), True,
                                     inp["h0"], dout, dhl)
        worst, worst_abs = check_grads(name, got, ref, *tol)
        cases.append({"case": name, "shape": [b, length, d, n],
                      "dtype": str(inp["u"].dtype), "max_rel_err": worst,
                      "max_abs_err": worst_abs,
                      "chunk_states_max_abs_err": states_err, "tol": tol})
    dout, _ = cots["train_bf16"]
    _, _, h_chunks = kernel.selective_scan_fwd_train(**train, delta_softplus=True)
    bwd_args = dict(train, delta_softplus=True, h_chunks=h_chunks, dout=dout)
    launch = kernel._bwd_launcher()
    c_args, _ = kernel.bwd_launch_args(kernel.BWD_CHANNELS, **bwd_args)
    kernel_ms = cuda_ms(lambda: launch(*c_args), 20)
    wrapper_ms = cuda_ms(lambda: kernel.selective_scan_bwd(**bwd_args), 20)
    plain_ms = cuda_ms(lambda: selective_scan_bwd_ref(
        *(train[k] for k in GRAD_NAMES[:8]), True, None, dout), 3)
    fwd_train_ms = cuda_ms(lambda: kernel.selective_scan_fwd_train(
        **train, delta_softplus=True), 20)
    fwd_ms = cuda_ms(lambda: kernel.selective_scan_fwd(**train, delta_softplus=True), 20)
    bound_ms, bound_by = scan_bwd_bound_ms(dict(train, dout=dout, h_chunks=h_chunks),
                                           clock_hz, sms)
    fwd_bound_ms, fwd_bound_by = scan_bound_ms(train, clock_hz, sms)
    fwd_bound_ms = max(fwd_bound_ms, 1e3 * h_chunks.numel() * 4 / HBM_BYTES_PER_S)
    ptxas = bwd_ptxas(build.build_log("selective_scan_bwd"))
    if not ptxas:
        raise AssertionError("no K2 instantiation in the selective_scan_bwd build log")
    result = {"phase": "kernel_bwd", "name": "selective_scan_bwd", "cases": cases,
              "kernel_ms": kernel_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
              "ptxas": ptxas,
              "fwd_train": {"kernel_ms": fwd_train_ms, "inference_form_ms": fwd_ms,
                            "bound_ms": fwd_bound_ms, "bound_by": fwd_bound_by,
                            "chunk_states_mb": h_chunks.numel() * 4 / 1e6}}
    emit(result)
    return result


# -- The scan-attribution tools: P2, the peak probe; P1, the variants --------

# P2 vs its plain loop: FMA against a separate multiply and add, exp2f
# against torch.exp2, over 64 steps of contracting chains.
PROBE_TOL = (1e-6, 1e-5)
VARIANT_SHAPE = (2, 200, 280, 16)  # ragged against the 32-step tile and 16 channels


def probe_bound_ms(numel, k, mode, clock_hz, sms):
    """Least time for the probe's work: x read and out written once,
    against 2 FLOP per FMA at the float32 peak, or one exp2 per step on the
    SFUs."""
    from mamba_asr_torch.tools.peak_probe import steps_per_element

    steps = steps_per_element(mode, k) * numel
    bytes_s = 8.0 * numel / HBM_BYTES_PER_S
    if mode == "exp2":
        ops_s = steps / (SFU_PER_CLOCK_PER_SM * sms * clock_hz)
    else:
        ops_s = 2.0 * steps / FP32_FLOP_PER_S
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s else "operations")


def phase_peak_probe(clock_hz, sms):
    from mamba_asr_torch.kernels import peak_probe as p2
    from mamba_asr_torch.ops.peak_probe import MODES, peak_probe_ref
    from mamba_asr_torch.tools import peak_probe as tool

    small = tool.probe_input(2, 37, 100, SEED + 7, "cuda")
    errs = {}
    for mode in MODES:
        got = p2.peak_probe(small, 64, mode)
        torch.cuda.synchronize()
        errs[mode] = check_close(f"peak_probe {mode}", got, peak_probe_ref(small, 64, mode),
                                 *PROBE_TOL)
    # The entry point, at its defaults (the scan's B32 x 751 x 288, k 64 and 1024).
    p2.LAUNCHES = 0
    records = tool.run(MODES)
    launches = p2.LAUNCHES
    if launches == 0:
        raise AssertionError("the peak_probe tool launched no probe kernel")
    if not all(r["finite"] for r in records):
        raise AssertionError(f"peak_probe produced non-finite values: {records}")
    by_mode = {r["mode"]: r for r in records}
    # The tool's own input and chain lengths, against the plain loop: the
    # kernel's grid-stride loop runs past one pass of its grid here.
    x = tool.probe_input(32, 751, 288, tool.SEED, "cuda")
    main_errs = {}
    for mode in MODES:
        for k in (64, 64 * tool.K2_PER_K):
            got = p2.peak_probe(x, k, mode)
            torch.cuda.synchronize()
            main_errs[f"{mode}_k{k}"] = check_close(
                f"peak_probe {mode} k {k} at {tuple(x.shape)}", got,
                peak_probe_ref(x, k, mode), *PROBE_TOL)
    bound_ms, bound_by = probe_bound_ms(x.numel(), 64, "dependent", clock_hz, sms)
    flop_per_s = 1e12 * max(by_mode[m]["attained_tflops"] for m in ("dependent", "independent"))
    result = {"phase": "peak_probe", "name": "peak_probe", "records": records,
              "small_max_abs_err": errs, "main_max_abs_err": main_errs,
              "max_abs_err": max(list(errs.values()) + list(main_errs.values())),
              "tol": PROBE_TOL, "launches": launches,
              "ms": by_mode["dependent"]["ms"],
              "plain_ms": cuda_ms(lambda: peak_probe_ref(x, 64, "dependent"), 5),
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
              "rates": (by_mode["exp2"]["attained_exp2_per_s"], flop_per_s)}
    emit(result)
    return result


def phase_scan_variants(clock_hz, sms):
    from mamba_asr_torch.kernels import scan_variants as p1
    from mamba_asr_torch.kernels import selective_scan as k1
    from mamba_asr_torch.ops import scan_variants as sv
    from mamba_asr_torch.tools import scan_variants as tool

    b, length, d, n = VARIANT_SHAPE
    inp = sv.variant_inputs(b, length, d, n, torch.float32, SEED + 8, "cuda")
    dout = sv.variant_dout(inp, SEED + 9)
    gen = torch.Generator().manual_seed(SEED + 10)
    h0 = torch.randn(b, d, n, generator=gen).cuda()
    dhl = torch.randn(b, d, n, generator=gen).cuda()
    _, _, h_chunks = k1.selective_scan_fwd_train(**inp, delta_softplus=True, h0=h0)
    tiles = -(-d // k1.BWD_CHANNELS)
    fwd_err, bwd_err = {}, {}
    for v in sv.FWD_VARIANTS:
        out, h_last = p1.scan_variant_fwd(v, **inp, h0=h0)
        torch.cuda.synchronize()
        ref, h_ref = sv.selective_scan_variant_ref(v, **inp, h0=h0)
        atol, rtol = sv.FWD_CARD_TOL.get(v, sv.FWD_CARD_TOL_DEFAULT)
        fwd_err[v] = max(check_close(f"scan_variants fwd {v}", out, ref, atol, rtol),
                         check_close(f"scan_variants fwd {v} h_last", h_last, h_ref, atol, rtol))
    for v in sv.BWD_VARIANTS:
        got = p1.scan_variant_bwd(v, **inp, h0=h0, h_chunks=h_chunks, dout=dout, dh_last=dhl)
        torch.cuda.synchronize()
        ref = sv.selective_scan_bwd_variant_ref(v, **inp, h0=h0, h_chunks=h_chunks, dout=dout,
                                                dh_last=dhl, chunk=k1.CHUNK, tiles=tiles)
        bwd_err[v] = check_grads(f"scan_variants bwd {v}", got, ref, *sv.BWD_CARD_TOL)[1]
    # The entry point, at its defaults: the main path's B32 L751 (L626 with
    # --bwd) D288 N16 bf16, every variant.
    p1.FWD_LAUNCHES = p1.BWD_LAUNCHES = 0
    fwd = tool.run()
    bwd = tool.run(bwd=True)
    launches = {"fwd": p1.FWD_LAUNCHES, "bwd": p1.BWD_LAUNCHES}
    if min(launches.values()) == 0:
        raise AssertionError(f"the scan_variants tool launched {launches}")
    bad = [r["variant"] for r in fwd + bwd if not r["finite"]]
    if bad:
        raise AssertionError(f"scan variants with non-finite outputs: {bad}")
    # Each variant again on the tool's own inputs (the kernels are
    # deterministic: these are the tool's outputs), against its plain
    # version: out within BF16_TOL or the variant's own tolerance, if
    # larger; h_last (float32 arithmetic on the same values) within the
    # variant's; the adjoint within K2's bf16 tolerance.
    main_in = sv.variant_inputs(32, tool.FWD_FRAMES, 288, 16, tool.DTYPE, tool.SEED, "cuda")
    train_in = sv.variant_inputs(32, tool.BWD_FRAMES, 288, 16, tool.DTYPE, tool.SEED, "cuda")
    train_hc = tool.chunk_states(train_in)
    train_dout = sv.variant_dout(train_in, tool.SEED + 1)
    train_tiles = -(-288 // k1.BWD_CHANNELS)
    main_fwd_err, main_bwd_err = {}, {}
    for v in sv.FWD_VARIANTS:
        out, h_last = p1.scan_variant_fwd(v, **main_in)
        torch.cuda.synchronize()
        ref, h_ref = sv.selective_scan_variant_ref(v, **main_in)
        vtol = sv.FWD_CARD_TOL.get(v, sv.FWD_CARD_TOL_DEFAULT)
        main_fwd_err[v] = max(
            check_close(f"scan_variants fwd {v} bf16", out, ref,
                        *(max(a, b) for a, b in zip(BF16_TOL, vtol))),
            check_close(f"scan_variants fwd {v} bf16 h_last", h_last, h_ref, *vtol))
    for v in sv.BWD_VARIANTS:
        got = p1.scan_variant_bwd(v, **train_in, h0=None, h_chunks=train_hc, dout=train_dout)
        torch.cuda.synchronize()
        ref = sv.selective_scan_bwd_variant_ref(v, **train_in, h0=None, h_chunks=train_hc,
                                                dout=train_dout, chunk=k1.CHUNK,
                                                tiles=train_tiles)
        main_bwd_err[v] = check_grads(f"scan_variants bwd {v} bf16", got, ref,
                                      *BWD_BF16_TOL)[1]
    fwd_bound = scan_bound_ms(main_in, clock_hz, sms)
    bwd_bound = scan_bwd_bound_ms(dict(train_in, dout=train_dout, h_chunks=train_hc),
                                  clock_hz, sms)
    plain_fwd_ms = cuda_ms(lambda: sv.selective_scan_variant_ref("base", **main_in), 3)
    plain_bwd_ms = cuda_ms(lambda: sv.selective_scan_bwd_variant_ref(
        "base", **train_in, h0=None, h_chunks=train_hc, dout=train_dout, chunk=k1.CHUNK,
        tiles=train_tiles), 1)

    def table(records, errs, main_errs):
        return [{"variant": r["variant"], "ms": r["ms"], "delta_ms": r["delta_ms"],
                 "max_abs_err": errs[r["variant"]],
                 "main_max_abs_err": main_errs[r["variant"]],
                 **({"kernel_of": r["kernel_of"]} if "kernel_of" in r else {})}
                for r in records]

    result = {"phase": "scan_variants", "check_shape": list(VARIANT_SHAPE),
              "check_dtype": "float32", "launches": launches,
              "fwd": {"shape": fwd[0]["shape"], "dtype": fwd[0]["dtype"],
                      "variants": table(fwd, fwd_err, main_fwd_err), "ms": fwd[0]["ms"],
                      "plain_ms": plain_fwd_ms, "bound_ms": fwd_bound[0],
                      "bound_by": fwd_bound[1],
                      "max_abs_err": max(list(fwd_err.values()) + list(main_fwd_err.values()))},
              "bwd": {"shape": bwd[0]["shape"], "dtype": bwd[0]["dtype"],
                      "variants": table(bwd, bwd_err, main_bwd_err), "ms": bwd[0]["ms"],
                      "plain_ms": plain_bwd_ms, "bound_ms": bwd_bound[0],
                      "bound_by": bwd_bound[1],
                      "max_abs_err": max(list(bwd_err.values()) + list(main_bwd_err.values()))},
              "tol": {"fwd": sv.FWD_CARD_TOL_DEFAULT, "fwd_except": sv.FWD_CARD_TOL,
                      "bwd": sv.BWD_CARD_TOL, "main_fwd_out": BF16_TOL,
                      "main_bwd": BWD_BF16_TOL}}
    emit(result)
    return result


def char_batch(bsz, seconds, tokens, seed, vocab):
    """B x seconds of N(0, 0.1) noise with random character targets of
    about `tokens` ids in 1..vocab-1 (the last row 5 % shorter)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    wav_lens = np.full(bsz, n, np.int32)
    wav_lens[-1] = int(0.95 * n)
    wav = rng.normal(0.0, 0.1, (bsz, n)).astype(np.float32)
    wav[-1, wav_lens[-1]:] = 0.0
    token_lens = rng.integers(int(0.9 * tokens), tokens + 1, size=bsz).astype(np.int32)
    return {"wav": torch.from_numpy(wav), "wav_lens": torch.from_numpy(wav_lens),
            "tokens": torch.from_numpy(rng.integers(1, vocab, (bsz, tokens)).astype(np.int64)),
            "token_lens": torch.from_numpy(token_lens),
            "weight": torch.ones(bsz)}


def phase_train_parity(exp, state):
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(exp.model, compute_dtype="float32", dropout=0.0)
    spec = dataclasses.replace(exp.specaug, enabled=False)
    batch = char_batch(2, 4.0, 20, 3, exp.model.vocab_size)
    res = {}
    for dev, cudnn in (("cuda", False), ("cuda", True), ("cpu", True)):
        torch.backends.cudnn.enabled = cudnn
        tr = Trainer(cfg32, exp.frontend, exp.train, spec, state_dict=state, device=dev)
        kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
        m = tr.train_step(batch)
        launches = (kernel.LAUNCHES, kernel.BWD_LAUNCHES)
        if dev == "cuda":
            torch.cuda.synchronize()
            want = (2 * cfg32.num_encoder_layers,) * 2
            if launches != want:
                raise AssertionError(f"train_parity launched K1, K2 {launches} times, want {want}")
        names = [n for n, _ in tr.model.named_parameters()]
        res[dev, cudnn] = (m["loss"].item(),
                           dict(zip(names, (a.cpu() for a in tr.optimizer.acc))))
    torch.backends.cudnn.enabled = True
    torch.backends.cudnn.allow_tf32 = True  # back to PyTorch's defaults
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = res["cuda", False], res["cpu", True]
    g_cudnn = res["cuda", True][1]
    cudnn_err = max(((g_cudnn[n] - r).abs().max() / r.abs().max()).item()
                    for n, r in g_cpu.items())
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train_parity loss {loss_gpu} vs {loss_cpu}")
    worst, worst_name = 0.0, ""
    for name, ref in g_cpu.items():
        scale = ref.abs().max().item()
        err = check_close(f"train_parity grad {name}", g_gpu[name], ref,
                          TRAIN_GRAD_TOL[1] * scale, TRAIN_GRAD_TOL[0])
        if err / max(scale, 1e-30) > worst:
            worst, worst_name = err / max(scale, 1e-30), name
    emit({"phase": "train_parity", "loss_cuda": loss_gpu, "loss_cpu": loss_cpu,
          "loss_rel_err": loss_err, "params": len(g_cpu),
          "grad_max_rel_err": worst, "grad_worst_param": worst_name,
          "cudnn_on_grad_max_rel_err": cudnn_err,
          "tol": {"loss_rtol": TRAIN_LOSS_RTOL, "grad": TRAIN_GRAD_TOL},
          "scan_launches": {"K1": 2 * cfg32.num_encoder_layers,
                            "K2": 2 * cfg32.num_encoder_layers}})


def phase_train(exp, state):
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.training.trainer import Trainer

    cfg = exp.model
    per_step = 2 * cfg.num_encoder_layers
    tr = Trainer(cfg, exp.frontend, exp.train, exp.specaug, state_dict=state, device="cuda")
    batch = char_batch(32, TRAIN_SECONDS, 300, 4, cfg.vocab_size)
    k = exp.train.grad_accumulation_factor
    steps = []
    kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    for i in range(2 * k):
        before = [p.detach().clone() for p in tr.model.parameters()]
        m = tr.train_step(batch)
        changed = sum(not torch.equal(a, p) for a, p in zip(before, tr.model.parameters()))
        loss = m["loss"].item()
        if not np.isfinite(loss):
            raise AssertionError(f"micro-step {i}: loss {loss}")
        emit_step = i % k == k - 1
        if bool(m["updated"]) != emit_step or (changed > 0) != emit_step:
            raise AssertionError(f"micro-step {i}: {changed} parameters changed, "
                                 f"updated={bool(m['updated'])}, emit step {emit_step}")
        steps.append({"loss": loss, "grad_norm": m["grad_norm"].item(),
                      "params_changed": changed})
    seconds = time.perf_counter() - t0
    launches = {"K1": kernel.LAUNCHES, "K2": kernel.BWD_LAUNCHES}
    if launches != {"K1": per_step * 2 * k, "K2": per_step * 2 * k}:
        raise AssertionError(f"{launches} scan launches in {2 * k} micro-steps")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blocks = []
    audio = float(batch["wav_lens"].sum()) / 16000
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            tr.train_step(batch)
        torch.cuda.synchronize()
        blocks.append(4 * audio / (time.perf_counter() - t0))
    rate = statistics.median(blocks)
    emit({"phase": "train", "batch": 32, "seconds_each": TRAIN_SECONDS,
          "audio_s_per_step": audio, "micro_steps": steps,
          "checked_seconds": seconds, "launches": launches,
          "accumulation": k, "compute_dtype": cfg.compute_dtype,
          "dropout": cfg.dropout, "specaug": exp.specaug.enabled,
          "throughput": {"audio_s_per_s": rate, "blocks": blocks,
                         "spread_pct": 100.0 * (max(blocks) - min(blocks)) / rate,
                         "micro_steps_per_block": 4},
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, tr, batch


def phase_train_profile(tr, batch):
    wall_ms, total_ms, top = device_profile(lambda: tr.train_step(batch), 15)
    emit({"phase": "train_profile", "wall_ms": wall_ms, "device_kernel_ms": total_ms,
          "idle_share": 1.0 - total_ms / wall_ms, "top": top})


# -- S2S joint CTC/attention beam recognition (K3, K4) -------------------------


def sentinel_close(name, got, ref, atol, rtol) -> float:
    """|got - ref| <= atol + rtol * |ref| where ref is above -1e29; where
    either side is at or below -1e29 (the -1e30 stand-in for -inf) the
    other must be too. Returns the largest error over the finite part."""
    got, ref = got.float().cpu(), ref.float().cpu()
    dead_g, dead_r = got <= -1e29, ref <= -1e29
    if not torch.equal(dead_g, dead_r):
        raise AssertionError(f"{name}: {int((dead_g ^ dead_r).sum())} entries at -1e30 "
                             "on one side only")
    live = ~dead_r
    if not live.any():  # e.g. r_b at T 1: every entry at -1e30
        return 0.0
    return check_close(name, got[live], ref[live], atol, rtol)


def dp_planes(frames, n, seed, ragged):
    """K3's four (T, N) planes as the scorer builds them: token and blank
    log-probs of noise, a prefix state of realistic scale; ragged: per-row
    lengths, a quarter of the rows valid at frame 0 only."""
    from mamba_asr_torch.ops.ctc_dp import NEG

    rng = np.random.default_rng(seed)
    lens = np.full(n, frames)
    if ragged:
        lens = rng.integers(1, frames + 1, n)
        lens[::4] = 1
    valid = np.arange(frames)[:, None] < lens[None, :]
    lp_tok = np.log(rng.dirichlet(np.ones(50), (frames, n))[:, :, 0])
    phi = -np.cumsum(rng.uniform(0.0, 1.0, (frames, n)), axis=0)
    lpb = np.where(valid, np.log(rng.uniform(0.3, 0.99, (frames, n))), 0.0)
    planes = (np.where(valid, lp_tok, 0.0), np.where(valid, phi + lp_tok, NEG), lpb,
              valid)
    return [torch.from_numpy(x.astype(np.float32)).cuda() for x in planes]


def ctc_dp_bound_ms(frames, n, clock_hz, sms):
    """Least time for K3's work: four (T, N) float32 planes read and two
    written once, against two logaddexps per (t, n), each an exp and a
    log1p on the special-function units."""
    bytes_s = 24.0 * frames * n / HBM_BYTES_PER_S
    sfu_s = 4.0 * frames * n / (SFU_PER_CLOCK_PER_SM * sms * clock_hz)
    return 1e3 * max(bytes_s, sfu_s), ("bytes" if bytes_s >= sfu_s else "operations")


def ctc_dp_chain_steps(frames):
    """Dependent logaddexps of one K3 thread (both recurrences, every
    segment): per recurrence, compose and walk a chunk (2 x frames per
    chunk), the lane's own chunk maps and their carries (2 x (C / 32 - 1)),
    5 shuffle rounds and the lane's entering state."""
    from mamba_asr_torch.kernels.ctc_dp import CHUNKS as chunks, MOST as most

    steps = 0
    for s0 in range(0, frames, chunks * most):
        length = -(-min(chunks * most, frames - s0) // chunks)
        steps += 2 * (2 * length + 2 * (chunks // 32 - 1) + 5 + 1)
    return steps


def phase_kernel_ctc_dp(clock_hz, sms):
    from mamba_asr_torch.kernels import ctc_dp as k3
    from mamba_asr_torch.ops.ctc_dp import ctc_dp_ref

    frames = 751  # 30 s
    cases, timing = [], {}
    for name, t, n, ragged in (("n66", frames, 66, False), ("n528", frames, 528, False),
                               ("ragged_n66", frames, 66, True),
                               ("ragged_n528", frames, 528, True), ("t1", 1, 66, False),
                               ("t2", 2, 66, True), ("n1", frames, 1, False),
                               ("n33", frames, 33, True)):
        planes = dp_planes(t, n, 31 + n + t, ragged)
        ref = ctc_dp_ref(*planes)
        got = k3.ctc_dp_fwd(*planes)
        torch.cuda.synchronize()
        err = max(sentinel_close(f"ctc_dp {name} {part}", g, r, *CTC_DP_TOL)
                  for part, g, r in zip(("r_nb", "r_b"), got, ref))
        cases.append({"case": name, "shape": [t, n], "max_abs_err": err, "tol": CTC_DP_TOL})
        if name in ("n66", "n528"):
            bound_ms, bound_by = ctc_dp_bound_ms(t, n, clock_hz, sms)
            timing[name] = {
                "kernel_ms": cuda_ms(lambda: k3.ctc_dp_fwd(*planes), 50),
                "plain_ms": cuda_ms(lambda: ctc_dp_ref(*planes), 3),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "chain_steps": ctc_dp_chain_steps(t)}
    # The time per 768-frame segment (one chain of both recurrences) from
    # T 768 and 9 x 768 at N 66, and the launch floor at T 1.
    seg = {}
    for t in (1, 768, 9 * 768):
        planes = dp_planes(t, 66, 7, False)
        seg[t] = cuda_ms(lambda: k3.ctc_dp_fwd(*planes), 50)
    per_segment = (seg[9 * 768] - seg[768]) / 8
    steps = ctc_dp_chain_steps(768)
    result = {"phase": "kernel_ctc_dp", "name": "ctc_dp", "block": [k3.HYPS, k3.CHUNKS, k3.MOST],
              "cases": cases, "timing": timing, "library_ms": None,
              "t1_ms": seg[1], "t768_ms": seg[768], "t6912_ms": seg[9 * 768],
              "ms_per_segment": per_segment, "chain_steps_per_segment": steps,
              "cycles_per_chain_step": per_segment * 1e-3 * clock_hz / steps,
              **timing["n528"]}
    emit(result)
    return result


def anc_table(s, n, pos, rng):
    """A random ancestor table with row pos the identity."""
    anc = rng.integers(0, n, (s, n)).astype(np.int32)
    anc[pos] = np.arange(n)
    return torch.from_numpy(anc).cuda()


def beam_table(s, n, pos, rng, beam=66):
    """An ancestor table as the search builds it (decoding/s2s_beam.py): at
    each step row s is the identity, then every hypothesis draws its parent
    among its utterance's `beam` rows and takes the parent's column."""
    anc = np.zeros((s, n), np.int32)
    base = np.arange(n) // beam * beam
    for step in range(pos + 1):
        anc[step] = np.arange(n)
        if step < pos:
            anc[:step + 1] = anc[:step + 1][:, base + rng.integers(0, beam, n)]
    return torch.from_numpy(anc).cuda()


def beam_attn_bound_ms(h, dh, anc, pos, elem_bytes, clock_hz, sms):
    """Least time for K4's work on this ancestor table: each distinct K and
    V row (j, anc[j, n]) with j <= pos read once, the ancestor column and q
    read once, out written once, against 4 * H * N * (pos + 1) * dh FLOP
    and one exp per score. Also the least time at the memory's 32-byte
    sector: the distinct sectors those rows touch (a row of 72 bytes spans
    3 or 4), and the share of (position, hypothesis) pairs that are
    distinct rows."""
    rows, n = pos + 1, anc.shape[1]
    col = anc[:rows].long()
    keys = torch.unique(torch.arange(rows, device=col.device)[:, None] * n + col)
    distinct = keys.numel()
    row_bytes = dh * elem_bytes
    start = keys * row_bytes  # one head's plane; every head's is a whole number of sectors
    span = (row_bytes + 31) // 32 + 1
    sec = (start[:, None] // 32 + torch.arange(span, device=col.device)[None, :])
    sec = sec[sec * 32 < start[:, None] + row_bytes]
    sectors = torch.unique(sec).numel()
    small = rows * n * 4 + 2 * n * h * dh * elem_bytes
    nbytes = 2 * h * distinct * row_bytes + small
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = max(4.0 * h * n * rows * dh / FP32_FLOP_PER_S,
                h * n * rows / (SFU_PER_CLOCK_PER_SM * sms * clock_hz))
    sector_ms = 1e3 * max((2 * h * sectors * 32 + small) / HBM_BYTES_PER_S, ops_s)
    return (1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s else "operations"),
            sector_ms, distinct / (rows * n))


def sdpa_on_gathered(q, k_buf, v_buf, anc, pos):
    """The library yardstick for K4: gather each hypothesis' rows, then
    one scaled_dot_product_attention call."""
    h, _, n, dh = k_buf.shape
    idx = anc[:pos + 1].long()[None, :, :, None].expand(h, pos + 1, n, dh)
    k_sel = torch.gather(k_buf[:, :pos + 1], 2, idx).permute(2, 0, 1, 3)
    v_sel = torch.gather(v_buf[:, :pos + 1], 2, idx).permute(2, 0, 1, 3)
    out = torch.nn.functional.scaled_dot_product_attention(q[:, :, None], k_sel, v_sel)
    return out[:, :, 0]


def beam_attn_inputs(gen, n, h, s, dh, dtype):
    """q (N, H, dh) and K, V buffers (H, S, N, dh) of N(0, 1) values, drawn
    on the card from the generator `gen`."""
    def draw(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    return draw(n, h, dh), [draw(h, s, n, dh) for _ in range(2)]


def phase_kernel_beam_attn(s2s_cfg, clock_hz, sms):
    from mamba_asr_torch.kernels import beam_attention as k4
    from mamba_asr_torch.ops.beam_attention import beam_attention_ref

    h = s2s_cfg.nhead
    dh = s2s_cfg.d_model // h
    s = 320  # 256 steps + 1, rounded up to 64
    rng = np.random.default_rng(SEED + 4)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases, timing, sweep = [], {}, {}

    def check(name, q, kv, anc, pos, tol, splits=None):
        got = k4.beam_attention_fwd(q, *kv, anc, pos, splits=splits)
        torch.cuda.synchronize()
        ref = beam_attention_ref(q, *kv, anc, pos)
        err = check_close(f"beam_attn {name}", got, ref, *tol)
        cases.append({"case": name, "shape": list(kv[0].shape), "pos": pos,
                      "dtype": str(q.dtype)[6:], "splits": splits, "max_abs_err": err,
                      "tol": tol})
        return ref

    for n in (66, 528):
        q, kv = beam_attn_inputs(gen, n, h, s, dh, torch.bfloat16)
        for pos in (0, 31, 32, 63, 64, 255):
            anc = anc_table(s, n, pos, rng)
            ref = check(f"n{n}_pos{pos}", q, kv, anc, pos, BF16_TOL)
            lib_err = (sdpa_on_gathered(q, *kv, anc, pos).float() - ref.float()).abs().max().item()
            cases[-1]["library_max_abs_diff"] = lib_err
        for table in ("random", "beam"):
            for pos in (63, 127, 255):
                anc = (anc_table if table == "random" else beam_table)(s, n, pos, rng)
                if table == "beam":
                    check(f"n{n}_pos{pos}_beam", q, kv, anc, pos, BF16_TOL)
                bound_ms, bound_by, sector_ms, distinct = beam_attn_bound_ms(
                    h, dh, anc, pos, 2, clock_hz, sms)
                timing[f"n{n}_pos{pos}_{table}"] = {
                    "kernel_ms": cuda_ms(lambda: k4.beam_attention_fwd(q, *kv, anc, pos), 50),
                    "plain_ms": cuda_ms(lambda: beam_attention_ref(q, *kv, anc, pos), 5),
                    "library_ms": cuda_ms(lambda: sdpa_on_gathered(q, *kv, anc, pos), 20),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_sector_ms": sector_ms, "distinct_rows": distinct,
                    "split_rule": k4.split_rule(n, h, pos, sms)}
        anc = anc_table(s, n, 255, rng)
        for splits in (1, 2, 4, 8, 16):
            check(f"n{n}_pos255_splits{splits}", q, kv, anc, 255, BF16_TOL, splits)
            sweep[f"n{n}_pos255_splits{splits}"] = cuda_ms(
                lambda: k4.beam_attention_fwd(q, *kv, anc, 255, splits=splits), 50)
        del q, kv
    # past the old shared-memory ceiling (pos above ~760 at dh 36)
    q, kv = beam_attn_inputs(gen, 528, h, 1024, dh, torch.bfloat16)
    check("n528_pos1023_s1024", q, kv, anc_table(1024, 528, 1023, rng), 1023, BF16_TOL)
    # the Large decoder's width: d_model 512, 8 heads of 64
    for dtype, tol in ((torch.float32, (2e-5, 2e-5)), (torch.bfloat16, BF16_TOL)):
        q, kv = beam_attn_inputs(gen, 528, 8, s, 64, dtype)
        check(f"n528_h8_dh64_pos255_{str(dtype)[6:]}", q, kv, anc_table(s, 528, 255, rng),
              255, tol)
    del q, kv
    result = {"phase": "kernel_beam_attn", "name": "beam_attention", "cases": cases,
              "timing": timing, "split_sweep_ms": sweep, **timing["n528_pos255_random"]}
    emit(result)
    return result


def s2s_recognizer(cfg, frontend, state, device, batch, beam):
    from mamba_asr_torch.configs.loader import DecodeConfig
    from mamba_asr_torch.serving.recognizer import Recognizer

    return Recognizer(cfg, frontend, state, device=device, batch=batch,
                      decode=DecodeConfig(s2s_test_beam_size=beam), search="s2s")


def first_difference(a, b) -> int:
    """The first step at which two token rows differ (-1: equal)."""
    diff = (a != b).nonzero()
    return -1 if len(diff) == 0 else int(diff[0])


def phase_s2s_parity(s2s_cfg, frontend, state):
    from mamba_asr_torch.decoding.ctc_prefix_scorer import CTCPrefixScorer
    from mamba_asr_torch.kernels import beam_attention as k4
    from mamba_asr_torch.kernels import ctc_dp as k3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = False
    cfg32 = dataclasses.replace(s2s_cfg, compute_dtype="float32")
    beam, n, vocab = 10, 20, s2s_cfg.vocab_size
    recs = {dev: s2s_recognizer(cfg32, frontend, state, dev, 2, beam)
            for dev in ("cuda", "cpu")}
    wav = np.zeros((2, 64000), np.float32)
    wav[0] = noise(4.0, 21)
    wav[1, :49600] = noise(3.1, 22)
    out = recs["cpu"].eval_step(torch.from_numpy(wav), torch.tensor([64000, 49600]))
    enc, enc_lens, lp = out["enc_out"], out["enc_lengths"], out["ctc_log_probs"]
    rng = np.random.default_rng(SEED + 5)
    dec_toks = rng.integers(3, vocab, (8, n))
    perms = rng.integers(0, n, (8, n))
    sel_toks = rng.integers(3, vocab, (4, n))
    sel_toks[:, ::7] = 2  # eos
    sel_toks[1:, 1::5] = sel_toks[:-1, 1::5]  # the same token again
    reorders = rng.integers(0, beam, (4, n)) + np.repeat(np.arange(2) * beam, beam)

    def decode_chain(rec):
        model, dev = rec.model, rec.device
        cache = model.prime_decoder_cache(enc.to(dev), model.init_decoder_cache(n, 64),
                                          enc_lens.to(dev))
        anc = np.tile(np.arange(n, dtype=np.int32), (64, 1))
        outs = []
        for s in range(8):
            anc[s] = np.arange(n)
            logits, cache = model.decode_step(torch.from_numpy(dec_toks[s]).to(dev), s,
                                              cache, torch.from_numpy(anc).to(dev))
            outs.append(torch.log_softmax(logits, -1).cpu())
            anc = np.ascontiguousarray(anc[:, perms[s]])
        return torch.stack(outs)

    def scorer_chain(rec):
        dev = rec.device
        sc = CTCPrefixScorer(lp.to(dev), enc_lens.to(dev), beam)
        state_ = sc.init_state()
        outs = []
        for s in range(4):
            scores, aux = sc.score(state_)
            state_ = sc.select(state_, aux, torch.from_numpy(sel_toks[s]).to(dev),
                               torch.from_numpy(reorders[s]).to(dev))
            outs.append((scores.cpu(), state_.r_nb.cpu(), state_.r_b.cpu()))
        return outs

    k3.LAUNCHES = k4.LAUNCHES = 0
    dec = {name: decode_chain(rec) for name, rec in recs.items()}
    chain = {name: scorer_chain(rec) for name, rec in recs.items()}
    launches = {"K3": k3.LAUNCHES, "K4": k4.LAUNCHES}
    if launches != {"K3": 4, "K4": 8 * cfg32.num_decoder_layers}:
        raise AssertionError(f"s2s_parity teacher-forced launches {launches}")
    dec_err = check_close("s2s_parity decode_step log-probs", dec["cuda"], dec["cpu"],
                          S2S_PARITY_TOL, 0.0)
    sel_err = 0.0
    for s, (got, ref) in enumerate(zip(chain["cuda"], chain["cpu"])):
        for part, g, r in zip(("scores", "r_nb", "r_b"), got, ref):
            sel_err = max(sel_err, sentinel_close(f"s2s_parity step {s} {part}", g, r,
                                                  S2S_PARITY_TOL, 1e-5))
    found = {}
    for name, rec in recs.items():
        dev = rec.device
        found[name] = [x.cpu() for x in rec.searcher(enc.to(dev), enc_lens.to(dev),
                                                     lp.to(dev))]
    score_err = check_close("s2s_parity search scores", found["cuda"][2], found["cpu"][2],
                            S2S_PARITY_TOL, 0.0)
    torch.backends.cudnn.enabled = True
    torch.backends.cudnn.allow_tf32 = True  # back to PyTorch's defaults
    emit({"phase": "s2s_parity", "batch": 2, "seconds_each": [4.0, 3.1], "beam": beam,
          "decode_step_max_abs_err": dec_err, "select_max_abs_err": sel_err,
          "search_score_max_abs_err": score_err, "tol": S2S_PARITY_TOL,
          "search": {dev: {"scores": f[2].tolist(), "lengths": f[1].tolist()}
                     for dev, f in found.items()},
          "tokens_equal": bool(torch.equal(found["cuda"][0], found["cpu"][0])),
          "first_token_difference": [first_difference(a, b) for a, b in
                                     zip(found["cuda"][0], found["cpu"][0])],
          "teacher_forced_launches": launches})


def phase_s2s_recognize(s2s_cfg, frontend, state):
    from mamba_asr_torch.kernels import beam_attention as k4
    from mamba_asr_torch.kernels import ctc_dp as k3
    from mamba_asr_torch.kernels import selective_scan as k1

    beam = 66
    layers = s2s_cfg.num_decoder_layers
    torch.cuda.reset_peak_memory_stats()
    rec = s2s_recognizer(s2s_cfg, frontend, state, "cuda", 1, beam)
    requests = [noise(s, 40 + i) for i, s in enumerate((3.0, 12.25, 30.0))]
    steps = []
    k3.LAUNCHES = k4.LAUNCHES = 0
    t0 = time.perf_counter()
    ids = []
    for wav in requests:
        ids += rec.transcribe([wav])
        steps.append(rec.searcher.last_steps)
    seconds = time.perf_counter() - t0
    if (k3.LAUNCHES, k4.LAUNCHES) != (sum(steps), layers * sum(steps)):
        raise AssertionError(f"K3 {k3.LAUNCHES}, K4 {k4.LAUNCHES} launches for steps {steps}")

    rec8 = s2s_recognizer(s2s_cfg, frontend, state, "cuda", 8, beam)
    batch = [noise(30.0, 200 + i) for i in range(8)]
    wav = torch.from_numpy(np.stack(batch))
    lens = torch.full((8,), 480000, dtype=torch.int32)
    out = rec8.eval_step(wav, lens)
    toks, tlens, scores = rec8.searcher(out["enc_out"], out["enc_lengths"], out["ctc_log_probs"])
    s_max = min(256, out["ctc_log_probs"].shape[1] + 1)  # 256 at 30 s
    if (tuple(toks.shape) != (8, s_max) or not torch.isfinite(scores).all()
            or int(toks.min()) < 0 or int(toks.max()) >= s2s_cfg.vocab_size):
        raise AssertionError(f"bad search result {tuple(toks.shape)} {scores.tolist()}")
    blocks, per_search = [], None
    for i in range(5):
        k1.LAUNCHES = k3.LAUNCHES = k4.LAUNCHES = 0
        t0 = time.perf_counter()
        rec8.transcribe(batch)
        blocks.append(8 * 30.0 / (time.perf_counter() - t0))
        if i == 0:
            per_search = {"K1": k1.LAUNCHES, "K3": k3.LAUNCHES, "K4": k4.LAUNCHES,
                          "steps": rec8.searcher.last_steps}
    st = per_search["steps"]
    if per_search != {"K1": 2 * s2s_cfg.num_encoder_layers, "K3": st, "K4": layers * st,
                      "steps": st}:
        raise AssertionError(f"launches per search {per_search}")
    rtfx = statistics.median(blocks)
    emit({"phase": "s2s_recognize", "beam": beam, "requests_s": [len(r) / 16000 for r in requests],
          "tokens": [len(x) for x in ids], "steps": steps, "seconds": seconds,
          "launches": {"K3": sum(steps), "K4": layers * sum(steps)},
          "throughput": {"batch": 8, "seconds_each": 30.0, "rtfx": rtfx, "blocks": blocks,
                         "spread_pct": 100.0 * (max(blocks) - min(blocks)) / rtfx,
                         "searches_per_block": 1, "compute_dtype": s2s_cfg.compute_dtype,
                         "best_lengths": tlens.tolist(), "launches_per_search": per_search},
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    return per_search, rec8, batch


def phase_s2s_profile(rec8, batch):
    wav = torch.from_numpy(np.stack(batch))
    lens = torch.full((8,), 480000, dtype=torch.int32)
    wall_ms, total_ms, top = device_profile(lambda: rec8.decode_batch(wav, lens), 15,
                                            ("ctc_dp_kernel", "beam_attention_kernel"))
    emit({"phase": "s2s_profile", "wall_ms": wall_ms, "device_kernel_ms": total_ms,
          "idle_share": 1.0 - total_ms / wall_ms, "steps": rec8.searcher.last_steps,
          "K3_ms": sum(r["ms"] for r in top if "ctc_dp_kernel" in r["kernel"]),
          "K4_ms": sum(r["ms"] for r in top if "beam_attention_kernel" in r["kernel"]),
          "top": top})


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

    clock_hz, sms = clock_mhz * 1e6, props.multi_processor_count
    timed(phase_build)
    probe = timed(phase_peak_probe, clock_hz, sms)
    k = timed(phase_kernel, cfg, clock_hz, sms, probe["rates"])
    kb = timed(phase_kernel_bwd, cfg, clock_hz, sms)
    variants = timed(phase_scan_variants, clock_hz, sms)
    state = seeded_state(cfg)
    timed(phase_parity, cfg, frontend, state)
    launches, rec32, batch = timed(phase_recognize, cfg, frontend, state)
    timed(phase_profile, rec32, batch)
    timed(phase_train_parity, exp, state)
    train_launches, tr, train_batch = timed(phase_train, exp, state)
    timed(phase_train_profile, tr, train_batch)
    del tr, train_batch, rec32, batch
    s2s = load_config(S2S_CONFIG)
    k3 = timed(phase_kernel_ctc_dp, clock_hz, sms)
    k4 = timed(phase_kernel_beam_attn, s2s.model, clock_hz, sms)
    s2s_state = seeded_state(s2s.model)
    timed(phase_s2s_parity, s2s.model, s2s.frontend, s2s_state)
    per_search, rec8, s2s_batch = timed(phase_s2s_recognize, s2s.model, s2s.frontend,
                                        s2s_state)
    timed(phase_s2s_profile, rec8, s2s_batch)

    full = k["cases"][0]
    fwd_train = kb["fwd_train"]
    emit({"kernels": [{
        "name": "selective_scan_fwd", "route": "cuda",
        "source": "mamba_asr_torch/csrc/selective_scan_fwd.cu",
        "replaces": "mamba_asr_tpu/ops/pallas/scan.py:320",
        "launches": launches, "max_abs_err": full["max_abs_err"],
        "ms": k["kernel_ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        "bound_measured_ms": k["bound_measured_ms"],
    }, {
        "name": "selective_scan_fwd_train", "route": "cuda",
        "source": "mamba_asr_torch/csrc/selective_scan_fwd.cu",
        "replaces": "mamba_asr_tpu/ops/pallas/scan.py:320",
        "launches": train_launches["K1"],
        "max_abs_err": kb["cases"][0]["chunk_states_max_abs_err"],
        "ms": fwd_train["kernel_ms"], "plain_ms": k["plain_ms"],
        "bound_ms": fwd_train["bound_ms"], "bound_by": fwd_train["bound_by"],
        "library_ms": None,
    }, {
        "name": "selective_scan_bwd", "route": "cuda",
        "source": "mamba_asr_torch/csrc/selective_scan_bwd.cu",
        "replaces": "mamba_asr_tpu/ops/pallas/scan.py:387",
        "launches": train_launches["K2"], "max_abs_err": kb["cases"][0]["max_abs_err"],
        "ms": kb["kernel_ms"], "plain_ms": kb["plain_ms"], "bound_ms": kb["bound_ms"],
        "bound_by": kb["bound_by"], "library_ms": None, "wrapper_ms": kb["wrapper_ms"],
    }, {
        "name": "ctc_dp", "route": "cuda", "source": "mamba_asr_torch/csrc/ctc_dp.cu",
        "replaces": "mamba_asr_tpu/ops/pallas/log_scan.py:75",
        "launches": per_search["K3"],
        "max_abs_err": max(c["max_abs_err"] for c in k3["cases"]),
        "ms": k3["kernel_ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": None,
    }, {
        "name": "beam_attention", "route": "cuda",
        "source": "mamba_asr_torch/csrc/beam_attention.cu",
        "replaces": "mamba_asr_tpu/ops/pallas/beam_attention.py:88",
        "launches": per_search["K4"],
        "max_abs_err": max(c["max_abs_err"] for c in k4["cases"]),
        "ms": k4["kernel_ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"], "library_ms": k4["library_ms"],
    }] + [{
        "name": f"scan_variants_{part}", "route": "cuda",
        "source": "mamba_asr_torch/csrc/scan_variants.cu",
        "replaces": f"scripts/exp_scan_variants.py:{line}",
        "launches": variants["launches"][part],
        "max_abs_err": variants[part]["max_abs_err"], "ms": variants[part]["ms"],
        "plain_ms": variants[part]["plain_ms"], "bound_ms": variants[part]["bound_ms"],
        "bound_by": variants[part]["bound_by"], "library_ms": None,
    } for part, line in (("fwd", 283), ("bwd", 601))] + [{
        "name": "peak_probe", "route": "cuda", "source": "mamba_asr_torch/csrc/peak_probe.cu",
        "replaces": "scripts/vpu_peak.py:68", "launches": probe["launches"],
        "max_abs_err": probe["max_abs_err"], "ms": probe["ms"],
        "plain_ms": probe["plain_ms"], "bound_ms": probe["bound_ms"],
        "bound_by": probe["bound_by"], "library_ms": None,
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
