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
             TF32 and cuDNN off, dropout 0, SpecAugment off, B2 x 4 s,
             one row zero-padded) on the card against the CPU: loss and
             every parameter's gradient; then every parameter's gradient
             against the same step in float64 on the CPU, for the CPU in
             fp32 and the card with cuDNN off, on (both held: no more
             than 10x the CPU's error where above 1e-3) and on with TF32
             (PyTorch's default; reported). Where an fp32 step put a
             front-end leaky_relu input on the other side of 0 than the
             float64 step, its reference is the float64 step on the fp32
             step's sides (the flips are reported)
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
             median of S2S_SEARCHES searches (the seeded decoder rarely emits eos, so
             each search runs all 256 steps: the worst case)
  s2s_profile  one B8 x 30 s search under torch.profiler, with K3's and
             K4's device ms
  data       the CTC recipe's input pipeline: a 30 s FLAC file through the
             port's C++ decoder (exact against its 16-bit samples), the C++
             windowed-sinc speed perturbation against its numpy version at
             0.95 and 1.05, and two bucketed loaders from one seed (speed
             perturbation on) giving the same batches for epochs 0 and 1,
             over the train-to-floor tone corpus (32 / 8 / 8 utterances)
  ctc_beam   the CTC prefix beam search (beam 100, the YAML's pruning) on
             B8 x T751 x V31 log-probs, card against CPU: tokens equal,
             best totals within BEAM_TOL; card time, CPU time, and the
             device's idle share in a profiled search
  recipe     `python -m mamba_asr_torch.train_ctc` (cli.run_training) at
             full ConMamba-Small width (the YAML's model, bf16) with
             train_to_floor's data and training settings, RECIPE_EPOCHS
             epochs on the tone corpus, then averaged evaluation with the
             beam search: per-epoch seconds, loss and valid WER, test WER
             and CER, training audio-s per s, K1 and K2 launches; one more
             epoch profiled (idle share); then the CLI again with one more
             epoch, which must resume from the last
  train_to_floor  mamba_asr_torch.tools.train_to_floor at the JAX
             script's settings (60 epochs): test WER <= 2.0 %
  bf16       the train-to-floor test set decoded with its averaged
             checkpoint, the card in bf16 against the CPU in fp32: greedy
             tokens equal; the log-probs' largest difference
  s2s_train_parity  one Trainer.train_step of the full-width S2S model
             (hparams/S2S/conmamba_small.yaml, seeded, fp32, TF32 off,
             dropout 0, B2 x 4 s, one row zero-padded), SpecAugment's
             drops off and its bicubic time warp on with fixed draws: the
             card (cuDNN off) against the CPU, every loss and gradient;
             the CPU and the card (cuDNN off and on) against the float64
             step, held as in train_parity
  s2s_train  Trainer(device="cuda") with the S2S YAML's settings (bf16,
             dropout 0.1, SpecAugment with the bicubic warp, accumulation
             8, ctc_weight 0.3, Noam stepped twice, vocab 5000) on B32 x
             25 s of noise with 60 to 80 random targets: 8 checked
             micro-steps, S2S training throughput (median of 3 blocks of 8
             micro-steps), peak memory and one profiled micro-step
  s2s_recipe `python -m mamba_asr_torch.train_s2s` (cli.run_training) at
             full ConMamba-Small S2S width (bf16, vocab 5000) with
             train_to_floor's data and training settings for
             S2S_RECIPE_EPOCHS epochs, the joint search validating every
             S2S_SEARCH_INTERVAL epochs (beam 10) and decoding the test
             set with the averaged checkpoints (beam 66): per-epoch
             seconds, loss and valid ACC, test WER and CER, the loop's
             audio-s per s, K1 to K4 launches; the keep set (the best by
             ACC and the newest); the last validation search against a
             fresh searcher on the same weights; one more epoch profiled;
             then the CLI again with one more epoch, which must resume
  s2s_train_to_floor  mamba_asr_torch.tools.train_to_floor --mode s2s with
             --s2s-config hparams/S2S/conmamba_small.yaml (the Transformer
             decoder; the JAX script's S2S settings, 180 epochs): test WER
             <= 2.0 %
  mamba_dec_kernels  the Mamba decoder's scans (hparams/S2S/
             conmambamamba_small.yaml) against their plain versions: K1's
             h_last form at the search's prime (N 528 = B8 x beam 66, L751,
             D288, bf16), K1's training form and K2 at B32 L81 (self-Mamba)
             and L707 (cross-Mamba over 626 memory frames and the targets,
             dout zero over the memory; du there held on its own scale);
             times, plain times and bounds
  mamba_dec_parity  the full-width ConMambaMamba-Small in fp32 (TF32 and
             cuDNN off, B2 x 4 s), card against CPU: teacher-forced seq
             log-probs, the primed cross-Mamba states (4 K1 launches) and 8
             decode steps through shuffled reorders; one S2S train step's
             losses and gradients, held as in s2s_train_parity
  mamba_dec_recognize  Recognizer(search="s2s") with the YAML's decode
             stanza (beam 66) answers 3 requests of 3-30 s; S2S RTFx at B8
             x 30 s (median of S2S_SEARCHES searches), K1 and K3 launches per search,
             one profiled search
  mamba_dec_train  Trainer(device="cuda") with the Mamba YAML's settings
             (bf16, dropout 0.1, bicubic warp, accumulation 8, vocab 5000)
             on B32 x 25 s, 60 to 80 random targets: 8 checked micro-steps
             (K1 train and K2 32 each), audio-s per s (median of 3 blocks),
             peak memory, one profiled micro-step
  mamba_dec_recipe  as s2s_recipe, on hparams/S2S/conmambamamba_small.yaml
             for MAMBA_RECIPE_EPOCHS epochs (K4 must not launch)
  mamba_dec_train_to_floor  tools.train_to_floor --mode s2s at its default
             config (the Mamba decoder) on 160 / 16 / 16 tone utterances,
             --epochs 30 (90; the JAX regime proof's 150, cut in PR 12):
             test WER <= 2.0 %
  lm_kernels  (after mamba_dec_train) K4 at the TransformerLM's heads (H 12,
             dh 64, S 320, N 528, bf16, pos 255 on a random and a
             beam-shaped table; fp32; pos 1,023 at S 1,024) against its
             plain gather; time, bound, the gather + SDPA call
  lm_parity  the full-width LM (the decode stanza's 12 x 768, vocab 5000,
             seeded) in fp32 with TF32 off, card against CPU: full-pass
             logits, 8 cached steps through two reorders (each against its
             own full pass), rescore_nbest's scores and choice; the fused
             joint search at beam 4 for both decoders: tokens equal, scores
             within S2S_PARITY_TOL
  lm_recognize  Recognizer(search="s2s") with the S2S YAML's decode stanza
             and decode.lm_path at a seeded LM (.pt; bf16 at load): S2S+LM
             RTFx at B8 x 30 s (median of LM_SEARCHES searches), launches
             per search (K4 (4 + 12) per step), one profiled search;
             s2s_recognize's no-LM RTFx and one Mamba-decoder + LM search
             beside it
  train_lm   (after mamba_dec_train_to_floor) mamba_asr_torch.train_lm's
             loop at full LM width in fp32 on the 160-utterance tone
             training transcripts, vocab 5000, LM_TRAIN settings: tokens
             per s, ms per step, ppl per log line (the last below
             LM_PPL_TARGET and below half the stream's unigram ppl);
             writes lm.pt
  lm_floor   the S2S floor run (Transformer decoder) again through the CLI
             with --decode.lm_path <that lm.pt>: it resumes, only tests, and
             fuses the LM; test WER <= 2.0 % beside the WER without it
  conformer_kernels  (after lm_recognize) K4 at the Conformer-Large
             decoder's heads (hparams/S2S/conformer_large.yaml: H 8, dh 64,
             S 320, N 528, bf16 and fp32 at pos 255 on a random and a
             beam-shaped table; bf16 at pos 1,023 on both) against its
             plain gather; time, bound, the gather + SDPA call
  conformer_parity  fp32 with TF32 and cuDNN off, seeded weights, full
             width and depth, B2 x 4 s with row 1 at 3.1 s: CTC log-probs
             of CTC/conformer_large, conformer_large_hypermixing and
             branchformer_large and of S2S/conformer_small, card against
             CPU; for S2S/conformer_small 8 decode steps through shuffled
             ancestor tables and the joint search at beam 4 (tokens equal)
  conformer_recognize  bf16 through Recognizer: CTC RTFx of Conformer-Large
             at B32 x 30 s (5 blocks of 10 calls; one profiled call), one
             block each for the hypermixing and Branchformer YAMLs; S2S
             RTFx of Conformer-Small at B8 x 30 s with its decode stanza
             (beam 66, median of S2S_SEARCHES searches, K3 256 and K4 1,024
             per search, one profiled search) and one Conformer-Large
             search (K4 1,536)
  streaming  (after conformer_recognize) K1 at the streaming shapes (B1
             and B4, L 1, 2, 3, 16, D288 N16, bf16 and fp32, h0 in, h_last
             out) against its plain version, timed at B1 L16; a causal
             ConMamba-Small (fp32) streamed at 3,000, 2,999 and 2,997
             frames: tokens equal to the card's offline forward on the
             canonically padded features; card against CPU (600 frames);
             the YAML's bidirectional ConMamba-Small, Conformer-Large and
             Branchformer-Large streams, card against CPU (the chunk-local
             compromise's divergence from offline reported); per-chunk
             latency, streaming RTFx, K1 launches per chunk and the idle
             share of 30 s bf16 streams (ConMamba-Small, Conformer-Large);
             StreamingS2SSession on ConMambaMamba-Small: feed + extend ms,
             decode_greedy(32) ms, extended against primed cross states
  recognize_cli  (last) `python -m mamba_asr_torch.recognize` on the CTC
             floor run's test files and save dir: --beam 100 tokens equal
             to the trainer's CTC-beam test pass, --timestamps word times,
             --streaming transcripts; --s2s on the S2S floor run: tokens
             equal to its test pass; `python -m mamba_asr_torch.evaluate`
             reproduces the CTC floor's test WER

Each phase also prints its wall seconds. Then the kernels line, the
card's name and power limit, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# orders, torch's CTC against the plain recursion).
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
# The whole fp32 step's gradients on the card against the same step in
# float64 on the CPU: a fault where a parameter's error is more than
# CUDNN_FAULT_RATIO times the CPU's fp32 error and above CUDNN_FAULT_FRAC
# of its largest value.
CUDNN_FAULT_RATIO = 10.0
CUDNN_FAULT_FRAC = 1e-3
# The CTC recipe: its epochs at full width on the tone corpus (40 until
# the Mamba decoder's phases joined the script, 10 until the LM's; 5 keeps
# the whole run inside its time limit), the best
# beam totals card vs CPU (float32 logaddexp chains over 751 frames in two
# libraries), the speed perturbation's C++ against numpy in float64
# (float32 output rounding) and the train-to-floor target (% WER, the JAX
# script's --target).
RECIPE_EPOCHS = 5
BEAM_TOL = 1e-3
RESAMPLE_TOL = 2e-6
FLOOR_TARGET = 2.0
# The S2S recipe: the warp's fixed draws in s2s_train_parity (centre and
# target frame of 401), the full-width recipes' epochs (each decoder's 20,
# the Transformer decoder's cut to 10 when the Mamba decoder's phases
# joined the script, both to 6 when the LM's did: one more than
# train_to_floor's keep_checkpoints 5, so that the ACC ranking drops an
# epoch) and validation search interval (one search, at the last epoch),
# the train-to-floor tool's --epochs (S2S trains 3x).
S2S_WARP_DRAWS = (200, 197)
S2S_RECIPE_EPOCHS = 6
MAMBA_RECIPE_EPOCHS = 6
S2S_SEARCH_INTERVAL = 6
FLOOR_EPOCHS = 60
# The Mamba decoder (ConMambaMamba-Small): the search's batch and beam
# (K1's h_last form primes N = 8 x 66 rows), the decoder's training
# lengths at B32 x 25 s (S 81 targets with bos; the cross-Mamba scans the
# 626 memory frames and them), and the floor run on the JAX regime proof's
# corpus (scripts/falsify_s2s_residual.py --part b: 160 / 16 / 16
# utterances) for 90 epochs = 3 x 30: the proof's 150 cut to make room
# for the streaming phases (PR 11's call 3 read valid WER 0.00 from epoch
# 30 and ACC 0.93 to 0.95 from epoch 60 to 150; PR 12's 105-epoch run
# test WER 0.00).
MAMBA_CONFIG = "hparams/S2S/conmambamamba_small.yaml"
MAMBA_SEARCH = (8, 66)
MAMBA_TRAIN_S = 81
MAMBA_FLOOR_EPOCHS = 30
MAMBA_FLOOR_CORPUS = (160, 16, 16)
# Timed searches of s2s_recognize, mamba_dec_recognize and
# conformer_recognize (5 until the LM's phases joined the script, 3 until
# the other encoders' did).
S2S_SEARCHES = 2
# The LM (slice 3b item 4): the timed fused searches at B8 x 30 s, the
# LM's training run on the 160-utterance tone transcripts (at full width,
# vocab 5000, fp32; the JAX script's flags but steps, batch and logging)
# and its criterion (the char tokenizer uses 11 of the 5000 ids). The
# warmup is the script's 4000: with 50 to 300 steps of warmup (peak lr
# 1e-3 or 1e-4) the 12 post-LN layers stayed at the unigram ppl ~8.8 for
# 300 steps on an H100, with 4000 they reached ppl ~3. 900 steps bring the
# tone floor run's held-out transcripts to ppl ~1.2 (300: ~2.8, an LM that
# still turned one test word of that run from AB into FAB).
LM_SEARCHES = 2  # 3 until the other encoders' phases joined the script
LM_TRAIN = dict(steps=900, batch_size=16, seq_len=128, lr=1e-3, warmup=4000,
                log_every=100, save_every=900)
LM_PPL_TARGET = 10.0
LM_PPL_OF_UNIGRAM = 0.5  # and below half the stream's unigram ppl
# The other encoders (slice 4 item 1): the CTC YAMLs (Conformer-Large with
# RelPosMHAXL and with hypermixing, Branchformer-Large) and the Conformer
# S2S YAMLs (Small and Large, the Transformer decoder). The CTC RTFx
# blocks: the recognize phase's 5 of 10 calls for Conformer-Large, one
# block each for the others.
CONFORMER_CTC = ("hparams/CTC/conformer_large.yaml",
                 "hparams/CTC/conformer_large_hypermixing.yaml",
                 "hparams/CTC/branchformer_large.yaml")
CONFORMER_S2S = ("hparams/S2S/conformer_small.yaml", "hparams/S2S/conformer_large.yaml")
STREAM_CHUNK_FRAMES = 64  # recognize --chunk_frames: 640 ms of audio per feed
# Total fbank frames of the causal parity streams: 3,000 is a multiple of
# the front end's 4, 2,999 and 2,997 take the canonical padding's odd
# branches.
STREAM_PARITY_FRAMES = (3000, 2999, 2997)
STREAM_ENCODER_FRAMES = 600  # the card-vs-CPU streams' fbank frames (6 s)


def scans_per_step(cfg) -> int:
    """Selective scans of one forward (K1) or backward (K2): two per
    bidirectional encoder layer, and with the Mamba decoder two per decoder
    layer (self- and cross-Mamba)."""
    mamba = cfg.num_decoder_layers if cfg.decoder_module == "mamba" else 0
    return 2 * (cfg.num_encoder_layers + mamba)


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


def scan_bound_ms(inp, clock_hz: float, sms: int, rates=None, h_last=False):
    """Least time for the scan's work: each input read and the output
    (with h_last, the final state too) written once, against the exp2 (one
    per state element) and the softplus/silu special functions (~4 per
    channel step) on the SFUs and ~6 fp32 FLOP per state element. `rates`
    (exp2 per s, FLOP per s) replaces the published peaks with the ones
    peak_probe measured."""
    b, length, d = inp["u"].shape
    n = inp["A"].shape[1]
    sfu_rate, flop_rate = rates or (SFU_PER_CLOCK_PER_SM * sms * clock_hz, FP32_FLOP_PER_S)
    nbytes = sum(t.numel() * t.element_size() for t in inp.values() if t is not None)
    nbytes += inp["u"].numel() * inp["u"].element_size()  # out
    nbytes += 4 * b * d * n if h_last else 0
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


class in_float64(torch.overrides.TorchFunctionMode):
    """Within the block every torch call computes in float64: float32
    tensor arguments are promoted, a float32 dtype argument (and `.float()`)
    becomes float64, and factories default to float64. Only for a step on
    the CPU whose model, normaliser and inputs are already float64: an
    in-place op on a float32 tensor made outside the block writes a copy
    (the optimizer's accumulators; the check reads `.grad` instead)."""

    def __enter__(self):
        self.default = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        return super().__enter__()

    def __exit__(self, *exc):
        torch.set_default_dtype(self.default)
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        def up(x):
            if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
                return x.double()
            if x is torch.float32:
                return torch.float64
            if isinstance(x, (list, tuple)) and type(x) in (list, tuple):
                return type(x)(up(v) for v in x)
            return x

        if func is torch.Tensor.float:
            func = torch.Tensor.double
        return func(*(up(a) for a in args), **{k: up(v) for k, v in (kwargs or {}).items()})


class leaky_relu_sides:
    """Within the block, F.leaky_relu (the front end's activation, the
    step's one kink) records which side of 0 each input element lies on,
    call by call; given `follow` (such a record), it takes those sides
    instead of its input's. A float64 step that follows an fp32 step's
    sides differentiates the same linear piece: an input within rounding
    of 0 that an fp32 step puts on the other side changes the front end's
    gradients by a whole slope (1 against 0.01), not by rounding."""

    def __init__(self, follow=None):
        self.follow, self.sides = follow, []

    def __enter__(self):
        import torch.nn.functional as F

        self.saved, self.busy = F.leaky_relu, False

        def leaky_relu(x, negative_slope=0.01, inplace=False):
            # F.leaky_relu hands a call under a torch function mode (the
            # float64 step's) back to the name it is bound to: this wrapper.
            if self.busy:
                return self.saved(x, negative_slope, inplace)
            self.busy = True
            try:
                if self.follow is None:
                    self.sides.append((x > 0).cpu())
                    return self.saved(x, negative_slope, inplace)
                side = self.follow[len(self.sides)].to(x.device)
                self.sides.append(side)
                return torch.where(side, x, x * negative_slope)
            finally:
                self.busy = False

        F.leaky_relu = leaky_relu
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F

        F.leaky_relu = self.saved
        return False


def step_grads(exp, spec, cfg32, state, batch, device, float64=False, follow=None):
    """One Trainer.train_step on `device`: ({loss, loss_ctc[, loss_att]},
    each parameter's gradient on the CPU, the leaky_relu sides). float64:
    the whole step in float64 on the CPU; follow: the sides its leaky_relu
    takes."""
    from mamba_asr_torch.training.normalizer import NormalizerState
    from mamba_asr_torch.training.trainer import Trainer

    tr = Trainer(cfg32, exp.frontend, exp.train, spec, state_dict=state, device=device)
    if exp.train.grad_accumulation_factor < 2:
        raise AssertionError("the check reads .grad, which the first micro-step of "
                             "an accumulation leaves in place")
    with leaky_relu_sides(follow) as sides:
        if float64:
            tr.model.double()
            tr.normalizer = NormalizerState(*(t.double() for t in tr.normalizer))
            with in_float64():
                m = tr.train_step(dict(batch, wav=batch["wav"].double()))
        else:
            m = tr.train_step(batch)
    grads = {n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()}
    if float64 and any(g.dtype != torch.float64 for g in grads.values()):
        raise AssertionError("the float64 step computed a gradient in another dtype")
    if not sides.sides:
        raise AssertionError("the step ran no leaky_relu: the front end changed")
    losses = {k: v.item() for k, v in m.items() if k.startswith("loss")}
    return losses, grads, sides.sides


def grad_errs(grads, ref):
    """Each parameter's max |g - ref| over ref's largest |value|."""
    return {n: ((g.double() - r).abs().max() / r.abs().max()).item()
            for n, r in ref.items() for g in (grads[n],)}


def against_float64(name, exp, spec, cfg32, state, batch, runs):
    """Each of `runs` ((label, device, cuDNN on, its TF32 on); the first is
    the CPU in fp32) takes one step, held against the same step in float64
    on the CPU (on the step's own leaky_relu sides). Raises where a card
    run with TF32 off is a fault: more than 10x the CPU's error and above
    1e-3 of the largest value. Returns (the float64 step's losses, each
    run's {losses, grads}, each run's summary)."""
    from mamba_asr_torch.kernels import selective_scan as kernel

    loss64, g64, sides64 = step_grads(exp, spec, cfg32, state, batch, "cpu", float64=True)
    res = {}
    for label, dev, cudnn, tf32 in runs:
        torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32 = cudnn, tf32
        kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
        losses, grads, sides = step_grads(exp, spec, cfg32, state, batch, dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            want = (scans_per_step(cfg32),) * 2
            if (kernel.LAUNCHES, kernel.BWD_LAUNCHES) != want:
                raise AssertionError(f"{name} {label} launched K1, K2 "
                                     f"{(kernel.LAUNCHES, kernel.BWD_LAUNCHES)} times, want {want}")
        flips = sum(int((a != b).sum()) for a, b in zip(sides, sides64))
        ref = g64 if flips == 0 else step_grads(exp, spec, cfg32, state, batch, "cpu",
                                                float64=True, follow=sides)[1]
        res[label] = {"losses": losses, "grads": grads, "flips": flips,
                      "errs": grad_errs(grads, ref), "errs_unfollowed": grad_errs(grads, g64)}
    torch.backends.cudnn.enabled = True
    torch.backends.cudnn.allow_tf32 = True  # back to PyTorch's defaults

    cpu_errs = res[runs[0][0]]["errs"]

    def summary(label):
        r = res[label]
        e, faults = r["errs"], sorted(n for n, v in r["errs"].items()
                                      if v > CUDNN_FAULT_RATIO * cpu_errs[n]
                                      and v > CUDNN_FAULT_FRAC)
        worst = max(e, key=e.get)
        return {"loss": r["losses"]["loss"], "leaky_relu_flips": r["flips"],
                "max_rel_err": e[worst], "worst_param": worst,
                "median_rel_err": statistics.median(e.values()),
                "faults": len(faults), "fault_params": faults[:4],
                "max_rel_err_unfollowed": max(r["errs_unfollowed"].values())}

    against64 = {label: summary(label) for label in res}
    held = [label for label, dev, _, tf32 in runs if dev == "cuda" and not tf32]
    if any(against64[label]["faults"] for label in held):
        raise AssertionError(f"{name} against float64: {against64}")
    return loss64, res, against64


def card_vs_cpu(name, card, cpu):
    """The card's step against the CPU's at TRAIN_LOSS_RTOL (every loss)
    and TRAIN_GRAD_TOL (every gradient): (each loss's relative error, the
    worst gradient's relative error and name)."""
    loss_errs = {}
    for key, ref in cpu["losses"].items():
        loss_errs[key] = abs(card["losses"][key] - ref) / abs(ref)
        if not loss_errs[key] <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"{name} {key} {card['losses'][key]} vs {ref}")
    worst, worst_name = 0.0, ""
    for pname, ref in cpu["grads"].items():
        scale = ref.abs().max().item()
        err = check_close(f"{name} grad {pname}", card["grads"][pname], ref,
                          TRAIN_GRAD_TOL[1] * scale, TRAIN_GRAD_TOL[0])
        if err / max(scale, 1e-30) > worst:
            worst, worst_name = err / max(scale, 1e-30), pname
    return loss_errs, worst, worst_name


def phase_train_parity(exp, state):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(exp.model, compute_dtype="float32", dropout=0.0)
    spec = dataclasses.replace(exp.specaug, enabled=False)
    batch = char_batch(2, 4.0, 20, 3, exp.model.vocab_size)
    # (label, device, cuDNN on, its TF32 on): the CPU in fp32, the card
    # with cuDNN off, on (TF32 off) and on at PyTorch's default (TF32 on).
    runs = (("cpu", "cpu", True, False), ("cudnn_off", "cuda", False, False),
            ("cudnn_on", "cuda", True, False), ("cudnn_on_tf32", "cuda", True, True))
    loss64, res, against64 = against_float64("train_parity", exp, spec, cfg32, state,
                                             batch, runs)
    loss_errs, worst, worst_name = card_vs_cpu("train_parity", res["cudnn_off"], res["cpu"])
    emit({"phase": "train_parity", "loss_cuda": res["cudnn_off"]["losses"]["loss"],
          "loss_cpu": res["cpu"]["losses"]["loss"], "loss_float64": loss64["loss"],
          "loss_rel_err": loss_errs["loss"], "params": len(res["cpu"]["grads"]),
          "grad_max_rel_err": worst, "grad_worst_param": worst_name,
          "against_float64": against64,
          "tol": {"loss_rtol": TRAIN_LOSS_RTOL, "grad": TRAIN_GRAD_TOL,
                  "fault": {"ratio": CUDNN_FAULT_RATIO, "frac": CUDNN_FAULT_FRAC}},
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


def decode_steps(rec, enc, enc_lens, toks, perms):
    """Cached decode steps of the Transformer decoder of `rec`'s model over
    the memory enc (B, T, D): row s of toks (steps, n) is step s's tokens,
    and after it the ancestor table's columns are shuffled by perms[s].
    The steps' log-probs (steps, n, V) on the CPU."""
    model, dev = rec.model, rec.device
    n = toks.shape[1]
    cache = model.prime_decoder_cache(enc.to(dev), model.init_decoder_cache(n, 64),
                                      enc_lens.to(dev))
    anc = np.tile(np.arange(n, dtype=np.int32), (64, 1))
    outs = []
    for s in range(len(toks)):
        anc[s] = np.arange(n)
        logits, cache = model.decode_step(torch.from_numpy(toks[s]).to(dev), s,
                                          cache, torch.from_numpy(anc).to(dev))
        outs.append(torch.log_softmax(logits, -1).cpu())
        anc = np.ascontiguousarray(anc[:, perms[s]])
    return torch.stack(outs)


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
    dec = {name: decode_steps(rec, enc, enc_lens, dec_toks, perms) for name, rec in recs.items()}
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
    for i in range(S2S_SEARCHES):
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
    throughput = {"batch": 8, "seconds_each": 30.0, "rtfx": rtfx, "blocks": blocks,
                  "spread_pct": 100.0 * (max(blocks) - min(blocks)) / rtfx,
                  "searches_per_block": 1, "compute_dtype": s2s_cfg.compute_dtype,
                  "best_lengths": tlens.tolist(), "launches_per_search": per_search}
    emit({"phase": "s2s_recognize", "beam": beam, "requests_s": [len(r) / 16000 for r in requests],
          "tokens": [len(x) for x in ids], "steps": steps, "seconds": seconds,
          "launches": {"K3": sum(steps), "K4": layers * sum(steps)}, "throughput": throughput,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    return throughput, rec8, batch


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


# -- the CTC recipe: data pipeline, beam search, CLI, train to floor -----------


def same_batches(a, b) -> bool:
    """Two loader epochs' batches equal key for key (arrays exactly)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        for key, v in x.items():
            same = (np.array_equal(v, y[key]) and v.dtype == y[key].dtype
                    if isinstance(v, np.ndarray) else v == y[key])
            if not same:
                return False
    return True


def phase_data(work):
    from mamba_asr_torch.data import audio, augment, dataset
    from mamba_asr_torch.data.librispeech import load_manifest, prepare_librispeech
    from mamba_asr_torch.data.tokenizer import CharTokenizer
    from mamba_asr_torch.tools.train_to_floor import build_corpus

    from mamba_asr_torch.native.build import flac_lib

    t0 = time.perf_counter()
    flac_lib()  # g++ builds the decoder and resamplers at first use
    native_build_s = time.perf_counter() - t0
    corpus = os.path.join(work, "corpus")
    t0 = time.perf_counter()
    build_corpus(corpus)
    corpus_s = time.perf_counter() - t0

    wav = noise(30.0, 7)
    path = os.path.join(work, "noise.flac")
    audio.write_flac(path, wav, 16000)
    t0 = time.perf_counter()
    got, sr = audio.read_audio(path)
    flac_ms = 1e3 * (time.perf_counter() - t0)
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16).astype(np.float32) / 32768.0
    if sr != 16000 or not np.array_equal(got, pcm):
        raise AssertionError("FLAC decode differs from the file's samples")

    resample = {}
    for factor in (0.95, 1.05):
        t0 = time.perf_counter()
        native = augment.speed_perturb(got, factor)
        native_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        plain = augment.sinc_resample_np(got, factor)
        plain_ms = 1e3 * (time.perf_counter() - t0)
        err = np.abs(native - plain).max() / np.abs(plain).max()
        if len(native) != len(plain) or not err <= RESAMPLE_TOL:
            raise AssertionError(f"speed_perturb {factor}: {err:.3e} of the largest sample")
        resample[str(factor)] = {"max_rel_err": float(err), "native_ms": native_ms,
                                 "plain_ms": plain_ms}

    man = os.path.join(work, "manifests")
    prepare_librispeech(corpus, man, tr_splits=["train-clean-100"])
    csv_path = os.path.join(man, "train-clean-100.csv")
    tok = CharTokenizer.fit(u.words for u in load_manifest(csv_path))
    epochs, epoch_s = [], []
    for _ in range(2):
        loader = dataset.BucketedLoader(dataset.ASRDataset.from_csv(csv_path, tok),
                                        num_buckets=2, max_batch_seconds=24.0,
                                        speed_perturb=True, seed=SEED)
        for epoch in (0, 1):
            t0 = time.perf_counter()
            epochs.append(list(loader.epoch(epoch)))
            epoch_s.append(time.perf_counter() - t0)
        loader.close()
    if not (same_batches(epochs[0], epochs[2]) and same_batches(epochs[1], epochs[3])):
        raise AssertionError("two loaders from one seed gave different batches")
    if same_batches(epochs[0], epochs[1]):
        raise AssertionError("epochs 0 and 1 gave the same batches")
    emit({"phase": "data", "native_build_s": native_build_s, "corpus_s": corpus_s,
          "flac_30s_ms": flac_ms,
          "speed_perturb": resample, "resample_tol": RESAMPLE_TOL,
          "loader": {"batches_per_epoch": len(epochs[0]), "epoch_s": epoch_s,
                     "utterances": len(load_manifest(csv_path))}})
    return corpus


def ctc_like_log_probs(bsz, frames, vocab, seed):
    """(B, T, V) log-probs shaped like a CTC model's: N(0, 1) logits with a
    +4 peak on the blank in 70 % of the frames and on a random token in
    the rest; ragged lengths (the last row 60 % long)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 1.0, (bsz, frames, vocab)).astype(np.float32)
    peak = np.where(rng.random((bsz, frames)) < 0.7, 0, rng.integers(1, vocab, (bsz, frames)))
    logits[np.arange(bsz)[:, None], np.arange(frames)[None, :], peak] += 4.0
    lens = np.full(bsz, frames, np.int32)
    lens[-1] = int(0.6 * frames)
    return torch.log_softmax(torch.from_numpy(logits), -1), torch.from_numpy(lens)


def phase_ctc_beam(exp):
    from mamba_asr_torch.decoding.ctc_beam import _beam_search_full

    d = exp.decode
    lp, lens = ctc_like_log_probs(8, 751, exp.model.vocab_size, 21)

    def search(x, n):
        return _beam_search_full(x, n, d.test_beam_size, d.blank_index, d.beam_prune_logp,
                                 d.token_prune_min_logp, x.shape[1])

    def best(toks, lns, total):
        i = total.argmax(1)
        rows = torch.arange(toks.shape[0], device=toks.device)
        return toks[rows, i].cpu(), lns[rows, i].cpu(), total.max(1).values.cpu()

    t0 = time.perf_counter()
    cpu = best(*search(lp, lens))
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    lp_gpu, lens_gpu = lp.cuda(), lens.cuda()
    search(lp_gpu, lens_gpu)  # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = search(lp_gpu, lens_gpu)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    gpu = best(*out)
    if not (torch.equal(gpu[0], cpu[0]) and torch.equal(gpu[1], cpu[1])):
        raise AssertionError("ctc_beam: the card's best prefixes differ from the CPU's")
    err = (gpu[2] - cpu[2]).abs().max().item()
    if not err <= BEAM_TOL:
        raise AssertionError(f"ctc_beam: best totals differ by {err:.3e}")
    wall_ms, device_ms, top = device_profile(lambda: search(lp_gpu, lens_gpu), 6)
    emit({"phase": "ctc_beam", "shape": list(lp.shape), "beam": d.test_beam_size,
          "prune": [d.beam_prune_logp, d.token_prune_min_logp],
          "tokens": [int(n) for n in cpu[1]], "best_total_max_abs_err": err,
          "tol": BEAM_TOL, "ms": statistics.median(times), "ms_runs": times,
          "cpu_ms": cpu_ms, "profile": {"wall_ms": wall_ms, "device_kernel_ms": device_ms,
                                        "idle_share": 1.0 - device_ms / wall_ms, "top": top}})


def recipe_args(corpus, out, epochs):
    """The CLI's arguments for the full-width recipe: the YAML's model with
    train_to_floor's data and training overrides (not its model ones)."""
    from mamba_asr_torch.tools.train_to_floor import ctc_overrides

    flat = ctc_overrides(corpus, out, epochs)
    pairs = [flat[i:i + 2] for i in range(0, len(flat), 2)]
    return [CONFIG] + [a for key, value in pairs
                       if not key.startswith(("--model.", "--frontend.")) for a in (key, value)]


def epoch_rows(trainer):
    return [{"epoch": e["epoch"], "epoch_s": e["epoch_sec"], "train_s": e["train_sec"],
             "train_audio_s": e["train_audio_s"], "loss": e["train"]["loss"],
             "valid_wer": e["valid"].get("WER")} for e in trainer.epoch_log]


def audio_rate(rows):
    """Audio seconds trained per wall second of the training passes."""
    if not rows:
        return None
    return sum(r["train_audio_s"] for r in rows) / sum(r["train_s"] for r in rows)


def phase_recipe(work, corpus):
    from mamba_asr_torch import cli
    from mamba_asr_torch.kernels import selective_scan as kernel

    out = os.path.join(work, "recipe")
    kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    tr = cli.run_training(recipe_args(corpus, out, RECIPE_EPOCHS))
    wall = time.perf_counter() - t0
    launches = {"K1": kernel.LAUNCHES, "K2": kernel.BWD_LAUNCHES}
    cfg = tr.cfg
    per_step = 2 * cfg.model.num_encoder_layers
    if launches["K2"] != per_step * tr.micro_steps or launches["K1"] <= launches["K2"]:
        raise AssertionError(f"recipe: {launches} scan launches for {tr.micro_steps} steps")
    if cfg.model.d_model != 144 or cfg.model.compute_dtype != "bfloat16":
        raise AssertionError("recipe: not the YAML's full-width model")
    rows = epoch_rows(tr)
    test = tr.test_stats["test-clean"]
    if [r["epoch"] for r in rows] != list(range(1, RECIPE_EPOCHS + 1)):
        raise AssertionError(f"recipe: epochs {[r['epoch'] for r in rows]}")
    if not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError("recipe: a non-finite training loss")

    steps_saved = tr.micro_steps  # the last checkpoint's; the profiled epoch adds more
    train_csv = os.path.join(cfg.output_folder, "manifests", cfg.data.train_csv)
    loader = cli.train_loader(cfg, train_csv, tr.tokenizer)
    wall_ms, device_ms, top = device_profile(
        lambda: tr.train_epoch(loader, RECIPE_EPOCHS + 1), 10)

    wer_file = os.path.join(cfg.output_folder, "wer_test-clean.txt")
    before = os.path.getmtime(wer_file)
    kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
    again = cli.run_training(recipe_args(corpus, out, RECIPE_EPOCHS + 1))
    resume_launches = {"K1": kernel.LAUNCHES, "K2": kernel.BWD_LAUNCHES}
    if again.start_epoch != RECIPE_EPOCHS + 1 or \
            [e["epoch"] for e in again.epoch_log] != [RECIPE_EPOCHS + 1]:
        raise AssertionError(f"recipe: did not resume from epoch {RECIPE_EPOCHS}")
    if again.micro_steps <= steps_saved or os.path.getmtime(wer_file) < before:
        raise AssertionError("recipe: the resumed run trained no step or wrote no wer file")
    emit({"phase": "recipe", "config": CONFIG, "d_model": cfg.model.d_model,
          "layers": cfg.model.num_encoder_layers, "compute_dtype": cfg.model.compute_dtype,
          "epochs": rows, "test": test, "wall_s": wall, "micro_steps": steps_saved,
          "train_audio_s_per_s": audio_rate(rows),
          "train_audio_s_per_s_after_epoch_1": audio_rate(rows[1:]),
          "launches": launches,
          "epoch_profile": {"wall_ms": wall_ms, "device_kernel_ms": device_ms,
                            "idle_share": 1.0 - device_ms / wall_ms, "top": top},
          "resume": {"start_epoch": again.start_epoch, "epochs": epoch_rows(again),
                     "test": again.test_stats["test-clean"], "launches": resume_launches}})
    return launches


def phase_train_to_floor(work, corpus):
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.tools import train_to_floor

    kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
    res, tr = train_to_floor.run_mode("ctc", corpus, os.path.join(work, "floor"), FLOOR_EPOCHS)
    launches = {"K1": kernel.LAUNCHES, "K2": kernel.BWD_LAUNCHES}
    if launches["K2"] != 2 * tr.cfg.model.num_encoder_layers * tr.micro_steps:
        raise AssertionError(f"train_to_floor: {launches} scan launches")
    if not res["test_wer"] <= FLOOR_TARGET:
        raise AssertionError(f"train_to_floor: test WER {res['test_wer']} > {FLOOR_TARGET}")
    rows = epoch_rows(tr)
    emit({"phase": "train_to_floor", **res, "target": FLOOR_TARGET,
          "test": tr.test_stats["test-clean"], "launches": launches,
          "epoch_s": [r["epoch_s"] for r in rows],
          "first_zero_valid_wer_epoch": next((r["epoch"] for r in rows
                                              if r["valid_wer"] == 0.0), None),
          "loss": [r["loss"] for r in rows[::10]] + [rows[-1]["loss"]],
          "train_audio_s_per_s": audio_rate(rows)})
    return tr


def phase_bf16(tr):
    from mamba_asr_torch.data.audio import read_audio
    from mamba_asr_torch.data.librispeech import load_manifest
    from mamba_asr_torch.serving.recognizer import Recognizer

    state = tr.ckpt.restore("averaged_test-clean")
    norm = tuple(state["normalizer"][k] for k in ("count", "mean", "m2"))
    cfg32 = tr.cfg.model
    cfg16 = dataclasses.replace(cfg32, compute_dtype="bfloat16")
    utts = load_manifest(os.path.join(tr.cfg.output_folder, "manifests", "test-clean.csv"))
    wavs = [read_audio(u.path)[0] for u in utts]
    recs = {"cpu": Recognizer(cfg32, tr.cfg.frontend, state["model"], normalizer=norm,
                              device="cpu", batch=len(wavs)),
            "cuda": Recognizer(cfg16, tr.cfg.frontend, state["model"], normalizer=norm,
                               device="cuda", batch=len(wavs))}
    tokens = {dev: rec.transcribe(wavs) for dev, rec in recs.items()}
    if tokens["cuda"] != tokens["cpu"]:
        diff = [i for i, (a, b) in enumerate(zip(tokens["cuda"], tokens["cpu"])) if a != b]
        raise AssertionError(f"bf16: greedy tokens differ from fp32 in utterances {diff}")
    n = max(len(w) for w in wavs)
    mat = np.zeros((len(wavs), n), np.float32)
    for i, w in enumerate(wavs):
        mat[i, :len(w)] = w
    lens = torch.tensor([len(w) for w in wavs], dtype=torch.int32)
    outs = {dev: rec.eval_step(torch.from_numpy(mat), lens) for dev, rec in recs.items()}
    valid = (torch.arange(outs["cpu"]["ctc_log_probs"].shape[1])[None, :]
             < outs["cpu"]["enc_lengths"][:, None])
    diff = (outs["cuda"]["ctc_log_probs"].float().cpu() - outs["cpu"]["ctc_log_probs"]).abs()
    refs = [u.words for u in utts]
    hyps = [tr.tokenizer.decode(t) for t in tokens["cuda"]]
    emit({"phase": "bf16", "utterances": len(wavs), "greedy_tokens_equal": True,
          "log_prob_max_abs_diff": diff[valid].max().item(),
          "greedy_exact_transcripts": sum(h == r for h, r in zip(hyps, refs)),
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})


# -- S2S training: joint CTC/attention, the recipe, train to floor -------------


def s2s_batch(batch):
    """A char_batch with the decoder's targets: tokens_bos (bos, tokens),
    tokens_eos (tokens, eos) and eos_lens, padded with 0."""
    tokens, lens = batch["tokens"], batch["token_lens"]
    bsz, s = tokens.shape
    bos = torch.zeros(bsz, s + 1, dtype=tokens.dtype)
    eos = torch.zeros(bsz, s + 1, dtype=tokens.dtype)
    for i, n in enumerate(lens.tolist()):
        bos[i, 0], bos[i, 1:n + 1] = 1, tokens[i, :n]
        eos[i, :n], eos[i, n] = tokens[i, :n], 2
        tokens[i, n:] = 0
    return dict(batch, tokens=tokens, tokens_bos=bos, tokens_eos=eos, eos_lens=lens + 1)


class fixed_warp:
    """Within the block SpecAugment's time warp takes S2S_WARP_DRAWS
    (centre, target) on every device, so the card's step and the CPU's
    warp alike."""

    def __enter__(self):
        from mamba_asr_torch.data import augment

        self.saved = augment.draw_time_warp

        def draws(generator, length, window, batch, mode="bicubic"):
            if mode != "bicubic":
                raise AssertionError("fixed_warp fixes the bicubic warp's draws")
            return tuple(torch.tensor(v, device=generator.device) for v in S2S_WARP_DRAWS)

        augment.draw_time_warp = draws
        return self

    def __exit__(self, *exc):
        from mamba_asr_torch.data import augment

        augment.draw_time_warp = self.saved
        return False


def phase_s2s_train_parity(s2s, state):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(s2s.model, compute_dtype="float32", dropout=0.0)
    spec = dataclasses.replace(s2s.specaug, num_time_drops=0, num_freq_drops=0)
    if not (spec.enabled and spec.apply_time_warp and spec.time_warp_mode == "bicubic"):
        raise AssertionError("s2s_train_parity: the YAML's SpecAugment has no bicubic warp")
    batch = s2s_batch(char_batch(2, 4.0, 20, 3, s2s.model.vocab_size))
    runs = (("cpu", "cpu", True, False), ("cudnn_off", "cuda", False, False),
            ("cudnn_on", "cuda", True, False))
    with fixed_warp():
        loss64, res, against64 = against_float64("s2s_train_parity", s2s, spec, cfg32, state,
                                                 batch, runs)
    loss_errs, worst, worst_name = card_vs_cpu("s2s_train_parity", res["cudnn_off"],
                                               res["cpu"])
    emit({"phase": "s2s_train_parity", "config": S2S_CONFIG,
          "losses_cuda": res["cudnn_off"]["losses"], "losses_cpu": res["cpu"]["losses"],
          "losses_float64": loss64, "loss_rel_errs": loss_errs,
          "params": len(res["cpu"]["grads"]), "grad_max_rel_err": worst,
          "grad_worst_param": worst_name, "against_float64": against64,
          "warp_draws": S2S_WARP_DRAWS, "ctc_weight": s2s.train.ctc_weight,
          "tol": {"loss_rtol": TRAIN_LOSS_RTOL, "grad": TRAIN_GRAD_TOL,
                  "fault": {"ratio": CUDNN_FAULT_RATIO, "frac": CUDNN_FAULT_FRAC}}})


def s2s_train_batch(bsz, seconds, vocab, seed):
    """B x seconds of N(0, 0.1) noise (the last row 5 % shorter) with
    random targets of 60 to 80 tokens drawn from [4, vocab)."""
    rng = np.random.default_rng(seed)
    batch = char_batch(bsz, seconds, 80, seed, vocab)
    batch["token_lens"] = torch.from_numpy(rng.integers(60, 81, bsz).astype(np.int32))
    batch["tokens"] = torch.from_numpy(rng.integers(4, vocab, (bsz, 80)).astype(np.int64))
    return s2s_batch(batch)


def phase_s2s_train(s2s, state):
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.training.schedule import noam_schedule
    from mamba_asr_torch.training.trainer import Trainer

    cfg, tc = s2s.model, s2s.train
    if (cfg.compute_dtype, cfg.dropout, tc.grad_accumulation_factor, tc.ctc_weight,
            tc.scheduler_steps_per_update, cfg.vocab_size) != ("bfloat16", 0.1, 8, 0.3, 2, 5000):
        raise AssertionError("s2s_train: not the S2S YAML's settings")
    if not (s2s.specaug.enabled and s2s.specaug.apply_time_warp):
        raise AssertionError("s2s_train: the YAML's SpecAugment has no time warp")
    per_step = 2 * cfg.num_encoder_layers
    tr = Trainer(cfg, s2s.frontend, tc, s2s.specaug, state_dict=state, device="cuda")
    batch = s2s_train_batch(32, TRAIN_SECONDS, cfg.vocab_size, 5)
    k = tc.grad_accumulation_factor
    steps = []
    kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
    for i in range(k):
        before = [p.detach().clone() for p in tr.model.parameters()]
        m = tr.train_step(batch)
        changed = sum(not torch.equal(a, p) for a, p in zip(before, tr.model.parameters()))
        row = {key: m[key].item() for key in ("loss", "loss_ctc", "loss_att", "grad_norm")}
        if not all(np.isfinite(row[key]) for key in ("loss", "loss_ctc", "loss_att")):
            raise AssertionError(f"s2s_train micro-step {i}: {row}")
        emit_step = i % k == k - 1
        if bool(m["updated"]) != emit_step or (changed > 0) != emit_step:
            raise AssertionError(f"s2s_train micro-step {i}: {changed} parameters changed, "
                                 f"updated={bool(m['updated'])}, emit step {emit_step}")
        steps.append({**row, "params_changed": changed})
    launches = {"K1": kernel.LAUNCHES, "K2": kernel.BWD_LAUNCHES}
    if launches != {"K1": per_step * k, "K2": per_step * k}:
        raise AssertionError(f"s2s_train: {launches} scan launches in {k} micro-steps")
    lr_now = tr.optimizer.optimizer.param_groups[0]["lr"]
    if lr_now != noam_schedule(tc.lr, tc.warmup_steps, tc.scheduler_steps_per_update)(1):
        raise AssertionError(f"s2s_train: lr {lr_now} after one update is not Noam's "
                             "count stepped twice per update")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blocks = []
    audio = float(batch["wav_lens"].sum()) / 16000
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            tr.train_step(batch)
        torch.cuda.synchronize()
        blocks.append(k * audio / (time.perf_counter() - t0))
    rate = statistics.median(blocks)
    memory_gb = torch.cuda.max_memory_allocated() / 1e9
    wall_ms, device_ms, top = device_profile(lambda: tr.train_step(batch), 15,
                                             named=("scan_fwd", "scan_bwd"))
    emit({"phase": "s2s_train", "config": S2S_CONFIG, "batch": 32, "seconds_each": TRAIN_SECONDS,
          "audio_s_per_step": audio, "target_tokens": batch["token_lens"].tolist(),
          "micro_steps": steps, "accumulation": k, "compute_dtype": cfg.compute_dtype,
          "dropout": cfg.dropout, "time_warp": s2s.specaug.time_warp_mode,
          "launches_per_micro_step": {key: v // k for key, v in launches.items()},
          "throughput": {"audio_s_per_s": rate, "blocks": blocks,
                         "spread_pct": 100.0 * (max(blocks) - min(blocks)) / rate,
                         "micro_steps_per_block": k},
          "max_memory_allocated_gb": memory_gb,
          "profile": {"wall_ms": wall_ms, "device_kernel_ms": device_ms,
                      "idle_share": 1.0 - device_ms / wall_ms, "top": top}})
    return launches


def s2s_recipe_args(corpus, out, epochs, config=S2S_CONFIG):
    """The S2S CLI's arguments for the full-width recipe: the YAML's model
    with train_to_floor's data and training overrides (not its model
    ones), and the validation search every S2S_SEARCH_INTERVAL epochs."""
    from mamba_asr_torch.tools.train_to_floor import ctc_overrides

    flat = ctc_overrides(corpus, out, epochs)
    pairs = [flat[i:i + 2] for i in range(0, len(flat), 2)]
    return [config] + [a for key, value in pairs
                           if not key.startswith(("--model.", "--frontend.")) for a in (key, value)] + [
        "--decode.valid_search_interval", str(S2S_SEARCH_INTERVAL)]


def s2s_launch_counters():
    from mamba_asr_torch.kernels import beam_attention as k4
    from mamba_asr_torch.kernels import ctc_dp as k3
    from mamba_asr_torch.kernels import selective_scan as k12

    def reset():
        k12.LAUNCHES = k12.BWD_LAUNCHES = k3.LAUNCHES = k4.LAUNCHES = 0

    def read():
        return {"K1": k12.LAUNCHES, "K2": k12.BWD_LAUNCHES, "K3": k3.LAUNCHES,
                "K4": k4.LAUNCHES}

    return reset, read


def phase_s2s_recipe(work, corpus):
    return s2s_recipe("s2s_recipe", S2S_CONFIG, S2S_RECIPE_EPOCHS, work, corpus)


def s2s_recipe(name, config, epochs, work, corpus):
    """The S2S recipe at full width on `config` (either decoder) for
    `epochs` epochs: the checks and the JSON line of phases s2s_recipe and
    mamba_dec_recipe."""
    from mamba_asr_torch import cli
    from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher, strip_special
    from mamba_asr_torch.training import loop

    class Recording(loop.Trainer):
        """The recipe's Trainer, keeping the last validation search's batch,
        encoder outputs, hypotheses and epoch."""

        last_search = None

        def validate(self, loader, epoch=1):
            self.epoch_now = epoch
            return super().validate(loader, epoch)

        def s2s_decoder(self, test=True):
            decode = super().s2s_decoder(test)

            def record(model, batch, out):
                hyps = decode(model, batch, out)
                if not test:
                    self.last_search = {"epoch": self.epoch_now, "out": out, "hyps": hyps}
                return hyps

            return record

    reset, read = s2s_launch_counters()
    out = os.path.join(work, name)
    saved = cli.Trainer
    cli.Trainer = Recording
    try:
        reset()
        t0 = time.perf_counter()
        tr = cli.run_training(s2s_recipe_args(corpus, out, epochs, config))
        wall = time.perf_counter() - t0
        launches = read()
    finally:
        cli.Trainer = saved
    cfg, d = tr.cfg, tr.cfg.decode
    if (cfg.model.d_model, cfg.model.num_encoder_layers, cfg.model.num_decoder_layers,
            cfg.model.d_ffn, cfg.model.nhead, cfg.model.compute_dtype, cfg.model.vocab_size) \
            != (144, 12, 4, 1024, 4, "bfloat16", 5000) or d.s2s_test_beam_size != 66:
        raise AssertionError(f"{name}: not the YAML's full-width model and test beam")
    # K4 runs the Transformer decoder's attention: the Mamba decoder has none.
    k4_ok = (launches["K4"] == 0) == (cfg.model.decoder_module == "mamba")
    if launches["K2"] != scans_per_step(cfg.model) * tr.micro_steps or \
            launches["K1"] <= launches["K2"] or not launches["K3"] or not k4_ok:
        raise AssertionError(f"{name}: launches {launches} for {tr.micro_steps} steps")
    rows = epoch_rows(tr)
    if [r["epoch"] for r in rows] != list(range(1, epochs + 1)):
        raise AssertionError(f"{name}: epochs {[r['epoch'] for r in rows]}")
    if not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"{name}: a non-finite training loss")
    accs = {e["epoch"]: e["valid"]["ACC"] for e in tr.epoch_log}

    # The ACC-ranked keep set: the best keep_checkpoints and the newest.
    if epochs <= cfg.train.keep_checkpoints:
        raise AssertionError(f"{name}: {epochs} epochs keep every one of them "
                             f"(keep_checkpoints {cfg.train.keep_checkpoints})")
    kept = sorted(e["metrics"]["epoch"] for e in tr.ckpt._entries())
    keep, newest = cfg.train.keep_checkpoints, epochs
    ranked = kept if len(kept) == keep else [e for e in kept if e != newest]
    if newest not in kept or len(ranked) != keep or \
            sorted(accs[e] for e in ranked) != sorted(accs.values())[-keep:]:
        raise AssertionError(f"{name}: kept epochs {kept}, ACC {accs}")
    if "averaged_test-clean" not in {e["name"] for e in tr.ckpt._entries(include_averaged=True)}:
        raise AssertionError(f"{name}: no averaged_test-clean checkpoint")

    # The last epoch's validation search decoded with that epoch's weights.
    rec = tr.last_search
    if rec is None or rec["epoch"] != epochs:
        raise AssertionError(f"{name}: last validation search {rec and rec['epoch']}")
    model = tr.step.model.eval()
    fresh = S2SBeamSearcher(
        model, beam_size=d.valid_beam_size, ctc_weight=d.ctc_weight_decode,
        ctc_candidates=d.ctc_candidates, temperature=d.temperature,
        length_normalization=d.length_normalization, max_decode_ratio=d.max_decode_ratio,
        min_decode_ratio=d.min_decode_ratio)
    o = rec["out"]
    toks, lens, _ = fresh(o["enc_out"], o["enc_lengths"], o["ctc_log_probs"])
    if strip_special(toks.cpu().numpy(), lens.cpu().numpy()) != rec["hyps"]:
        raise AssertionError(f"{name}: epoch {epochs}'s validation search is not a fresh "
                             "searcher's on that epoch's weights")
    model.train()

    steps_saved = tr.micro_steps
    train_csv = os.path.join(cfg.output_folder, "manifests", cfg.data.train_csv)
    loader = cli.train_loader(cfg, train_csv, tr.tokenizer)
    wall_ms, device_ms, top = device_profile(
        lambda: tr.train_epoch(loader, epochs + 1), 10)

    reset()
    again = cli.run_training(s2s_recipe_args(corpus, out, epochs + 1, config))
    resume_launches = read()
    if again.start_epoch != epochs + 1 or \
            [e["epoch"] for e in again.epoch_log] != [epochs + 1]:
        raise AssertionError(f"{name}: did not resume from epoch {epochs}")
    if again.micro_steps <= steps_saved:
        raise AssertionError(f"{name}: the resumed run trained no step")
    emit({"phase": name, "config": config, "d_model": cfg.model.d_model,
          "layers": [cfg.model.num_encoder_layers, cfg.model.num_decoder_layers],
          "vocab": cfg.model.vocab_size, "compute_dtype": cfg.model.compute_dtype,
          "tokenizer": tr.tokenizer.vocab_size, "epochs": rows, "valid_acc": accs,
          "last_valid_acc": accs[epochs], "test": tr.test_stats["test-clean"],
          "wall_s": wall, "micro_steps": steps_saved, "kept_epochs": kept,
          "search_interval": S2S_SEARCH_INTERVAL, "valid_beam": d.valid_beam_size,
          "test_beam": d.s2s_test_beam_size, "last_search_equals_fresh": True,
          "loop_audio_s_per_s": audio_rate(rows),
          "loop_audio_s_per_s_after_epoch_1": audio_rate(rows[1:]),
          "launches": launches,
          "epoch_profile": {"wall_ms": wall_ms, "device_kernel_ms": device_ms,
                            "idle_share": 1.0 - device_ms / wall_ms, "top": top},
          "resume": {"start_epoch": again.start_epoch, "epochs": epoch_rows(again),
                     "valid": again.epoch_log[0]["valid"],
                     "test": again.test_stats["test-clean"], "launches": resume_launches}})
    return launches


def phase_s2s_train_to_floor(work, corpus):
    from mamba_asr_torch.tools import train_to_floor

    reset, read = s2s_launch_counters()
    reset()
    epochs = 3 * FLOOR_EPOCHS  # the tool's S2S rule
    # The Transformer decoder: the tool's default S2S config is the Mamba
    # decoder's (phase mamba_dec_train_to_floor).
    res, tr = train_to_floor.run_mode("s2s", corpus, os.path.join(work, "floor"), epochs,
                                      s2s_config=S2S_CONFIG)
    launches = read()
    if launches["K2"] != 2 * tr.cfg.model.num_encoder_layers * tr.micro_steps or \
            not launches["K3"] or not launches["K4"]:
        raise AssertionError(f"s2s_train_to_floor: launches {launches}")
    rows = epoch_rows(tr)
    result = {"phase": "s2s_train_to_floor", **res, "target": FLOOR_TARGET,
              "config": S2S_CONFIG, "test": tr.test_stats["test-clean"],
              "launches": launches, "epoch_s": [r["epoch_s"] for r in rows],
              "valid": {e["epoch"]: e["valid"] for e in tr.epoch_log
                        if e["epoch"] % (epochs // 2) == 0 or e["epoch"] % 30 == 0},
              "loss": [r["loss"] for r in rows[::10]] + [rows[-1]["loss"]],
              "train_audio_s_per_s": audio_rate(rows)}
    emit(result)
    if not res["test_wer"] <= FLOOR_TARGET:
        raise AssertionError(f"s2s_train_to_floor: test WER {res['test_wer']} > {FLOOR_TARGET}")
    return {**res, "vocab": tr.cfg.model.vocab_size}


# -- The Mamba decoder (ConMambaMamba-Small) ------------------------------------


def phase_mamba_dec_kernels(mcfg, clock_hz, sms):
    """K1's h_last form at the search's prime (N 528 L751), and K1's
    training form + K2 at the decoder's training lengths (self-Mamba L81,
    cross-Mamba L707 with dout zero over the 626 memory frames), each
    against its plain version; times and bounds."""
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.ops.selective_scan import selective_scan_bwd_ref, selective_scan_ref

    gen = torch.Generator().manual_seed(SEED + 20)
    d_inner, n = mcfg.mamba.expand * mcfg.d_model, mcfg.mamba.d_state
    frames = -(-(int(TRAIN_SECONDS * 100) + 1) // mcfg.downsample)  # 626
    rows = MAMBA_SEARCH[0] * MAMBA_SEARCH[1]
    prime = scan_inputs(rows, 751, d_inner, n, torch.bfloat16, gen)
    out, h_last = kernel.selective_scan_fwd(**prime, delta_softplus=True,
                                            return_last_state=True)
    torch.cuda.synchronize()
    ref, h_ref = selective_scan_ref(**prime, delta_softplus=True, return_last_state=True)
    prime_bound = scan_bound_ms(dict(prime, h_last=h_last), clock_hz, sms)
    result = {"phase": "mamba_dec_kernels", "prime": {
        "shape": [rows, 751, d_inner, n], "dtype": "bfloat16",
        "max_abs_err": check_close("mamba prime out", out, ref, *BF16_TOL),
        "h_last_max_abs_err": check_close("mamba prime h_last", h_last, h_ref, *FP32_TOL),
        "tol": {"out": BF16_TOL, "h_last": FP32_TOL},
        "ms": cuda_ms(lambda: kernel.selective_scan_fwd(
            **prime, delta_softplus=True, return_last_state=True), 10),
        "plain_ms": cuda_ms(lambda: selective_scan_ref(
            **prime, delta_softplus=True, return_last_state=True), 1),
        "bound_ms": prime_bound[0], "bound_by": prime_bound[1],
        "gb": sum(t.numel() * t.element_size() for t in prime.values()
                  if t is not None) / 1e9}}
    del prime, out, h_last, ref, h_ref
    launch = kernel._bwd_launcher()
    for name, length, memory in (("self", MAMBA_TRAIN_S, 0),
                                 ("cross", frames + MAMBA_TRAIN_S, frames)):
        inp = scan_inputs(32, length, d_inner, n, torch.bfloat16, gen)
        dout = torch.randn(32, length, d_inner, generator=gen).cuda().bfloat16()
        dout[:, :memory] = 0.0  # the tail slice: no cotangent over the memory
        out_inf = kernel.selective_scan_fwd(**inp, delta_softplus=True)
        out, _, h_chunks = kernel.selective_scan_fwd_train(**inp, delta_softplus=True)
        got = kernel.selective_scan_bwd(**inp, delta_softplus=True, h_chunks=h_chunks,
                                        dout=dout)
        torch.cuda.synchronize()
        if not torch.equal(out, out_inf):
            raise AssertionError(f"mamba {name}: K1's training form changed out")
        states_err = check_close(f"mamba {name} chunk states", h_chunks,
                                 plain_chunk_states(inp, kernel.CHUNK), *FP32_TOL)
        plain = selective_scan_bwd_ref(*(inp[k] for k in GRAD_NAMES[:8]), True, None, dout)
        worst, worst_abs = check_grads(f"mamba {name}", got, plain, *BWD_BF16_TOL)
        case = {"shape": [32, length, d_inner, n], "dtype": "bfloat16",
                "max_rel_err": worst, "max_abs_err": worst_abs,
                "chunk_states_max_abs_err": states_err, "tol": BWD_BF16_TOL}
        if memory:
            # du over the memory frames: the decoder's only gradient into
            # the encoder, held on its own scale.
            du, du_ref = got[0][:, :memory], plain[0][:, :memory]
            scale = du_ref.float().abs().max().item()
            if not scale > 0:
                raise AssertionError("mamba cross: du is zero over the memory")
            case["memory_du"] = {"max_abs": scale, "max_abs_err": check_close(
                "mamba cross du over the memory", du, du_ref,
                BWD_BF16_TOL[1] * scale, BWD_BF16_TOL[0])}
        c_args, _ = kernel.bwd_launch_args(kernel.BWD_CHANNELS, **inp, delta_softplus=True,
                                           h_chunks=h_chunks, dout=dout)
        fwd_bound = scan_bound_ms(dict(inp, h_chunks=h_chunks), clock_hz, sms)
        bwd_bound = scan_bwd_bound_ms(dict(inp, dout=dout, h_chunks=h_chunks), clock_hz, sms)
        case.update({
            "fwd_train_ms": cuda_ms(lambda: kernel.selective_scan_fwd_train(
                **inp, delta_softplus=True), 20),
            "fwd_train_bound_ms": fwd_bound[0], "fwd_train_bound_by": fwd_bound[1],
            "fwd_plain_ms": cuda_ms(lambda: selective_scan_ref(**inp, delta_softplus=True), 2),
            "bwd_ms": cuda_ms(lambda: launch(*c_args), 20),
            "bwd_wrapper_ms": cuda_ms(lambda: kernel.selective_scan_bwd(
                **inp, delta_softplus=True, h_chunks=h_chunks, dout=dout), 20),
            "bwd_bound_ms": bwd_bound[0], "bwd_bound_by": bwd_bound[1],
            "bwd_plain_ms": cuda_ms(lambda: selective_scan_bwd_ref(
                *(inp[k] for k in GRAD_NAMES[:8]), True, None, dout), 1)})
        result[name] = case
    emit(result)
    return result


def phase_mamba_dec_parity(m, state):
    """The full-width ConMambaMamba-Small in fp32 (TF32 and cuDNN off), B2
    x 4 s, card against CPU: teacher-forced seq log-probs, the primed
    states and 8 decode steps through shuffled reorders; then one S2S
    train step's losses and gradients, as s2s_train_parity holds them."""
    from mamba_asr_torch.kernels import selective_scan as k1
    from mamba_asr_torch.serving.recognizer import eval_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = False
    cfg32 = dataclasses.replace(m.model, compute_dtype="float32")
    beam, vocab = 10, m.model.vocab_size
    n = 2 * beam
    recs = {dev: s2s_recognizer(cfg32, m.frontend, state, dev, 2, beam)
            for dev in ("cuda", "cpu")}
    wav = np.zeros((2, 64000), np.float32)
    wav[0] = noise(4.0, 31)
    wav[1, :49600] = noise(3.1, 32)
    wav_t, lens = torch.from_numpy(wav), torch.tensor([64000, 49600])
    rng = np.random.default_rng(SEED + 6)
    bos = torch.from_numpy(rng.integers(3, vocab, (2, 21))).long()
    bos[:, 0] = 1
    bos[1, 15:] = 0  # a padded target: scanned, as in the JAX package
    seq = {}
    with torch.no_grad():
        for dev, rec in recs.items():
            out = eval_step(rec.model, m.frontend, rec.normalizer, wav_t, lens, bos)
            seq[dev] = out["seq_log_probs"].cpu()
    seq_err = check_close("mamba_dec_parity seq_log_probs", seq["cuda"], seq["cpu"],
                          S2S_PARITY_TOL, 0.0)
    out = recs["cpu"].eval_step(wav_t, lens)
    enc_rep = out["enc_out"].repeat_interleave(beam, dim=0)
    toks = rng.integers(3, vocab, (8, n))
    reorders = rng.integers(0, beam, (8, n)) + np.repeat(np.arange(2) * beam, beam)

    def chain(rec):
        model, dev = rec.model, rec.device
        with torch.no_grad():
            cache = model.prime_decoder_cache(enc_rep.to(dev), model.init_decoder_cache(n))
            primed = [x.cpu() for layer in cache for x in layer["cross"]]
            steps = []
            for s in range(8):
                logits, cache = model.decode_step(torch.from_numpy(toks[s]).to(dev), s, cache)
                steps.append(torch.log_softmax(logits, -1).cpu())
                cache = model.decoder.reorder_cache(cache, torch.from_numpy(reorders[s]).to(dev))
        final = [x.cpu() for layer in cache for part in ("self", "cross") for x in layer[part]]
        return primed, torch.stack(steps), final

    k1.LAUNCHES = 0
    card = chain(recs["cuda"])
    torch.cuda.synchronize()
    prime_launches = k1.LAUNCHES
    if prime_launches != m.model.num_decoder_layers:
        raise AssertionError(f"mamba_dec_parity: the prime launched K1 {prime_launches} times")
    cpu = chain(recs["cpu"])
    primed_err = max(check_close(f"mamba_dec_parity primed state {i}", g, r, S2S_PARITY_TOL,
                                 S2S_PARITY_TOL) for i, (g, r) in enumerate(zip(card[0], cpu[0])))
    step_err = check_close("mamba_dec_parity decode_step log-probs", card[1], cpu[1],
                           S2S_PARITY_TOL, 0.0)
    final_err = max(check_close(f"mamba_dec_parity state {i} after 8 steps", g, r,
                                S2S_PARITY_TOL, S2S_PARITY_TOL)
                    for i, (g, r) in enumerate(zip(card[2], cpu[2])))
    del recs

    spec = dataclasses.replace(m.specaug, num_time_drops=0, num_freq_drops=0)
    if not (spec.enabled and spec.apply_time_warp and spec.time_warp_mode == "bicubic"):
        raise AssertionError("mamba_dec_parity: the YAML's SpecAugment has no bicubic warp")
    batch = s2s_batch(char_batch(2, 4.0, 20, 3, vocab))
    runs = (("cpu", "cpu", True, False), ("cudnn_off", "cuda", False, False),
            ("cudnn_on", "cuda", True, False))
    train32 = dataclasses.replace(cfg32, dropout=0.0)
    with fixed_warp():
        loss64, res, against64 = against_float64("mamba_dec_parity", m, spec, train32, state,
                                                 batch, runs)
    loss_errs, worst, worst_name = card_vs_cpu("mamba_dec_parity", res["cudnn_off"], res["cpu"])
    torch.backends.cudnn.enabled = True
    torch.backends.cudnn.allow_tf32 = True  # back to PyTorch's defaults
    emit({"phase": "mamba_dec_parity", "config": MAMBA_CONFIG, "batch": 2,
          "seconds_each": [4.0, 3.1], "tol": S2S_PARITY_TOL,
          "seq_log_probs_max_abs_err": seq_err, "primed_state_max_abs_err": primed_err,
          "decode_step_max_abs_err": step_err, "state_after_8_steps_max_abs_err": final_err,
          "prime_launches": prime_launches,
          "train": {"losses_cuda": res["cudnn_off"]["losses"],
                    "losses_cpu": res["cpu"]["losses"], "losses_float64": loss64,
                    "loss_rel_errs": loss_errs, "params": len(res["cpu"]["grads"]),
                    "grad_max_rel_err": worst, "grad_worst_param": worst_name,
                    "against_float64": against64, "warp_draws": S2S_WARP_DRAWS,
                    "tol": {"loss_rtol": TRAIN_LOSS_RTOL, "grad": TRAIN_GRAD_TOL,
                            "fault": {"ratio": CUDNN_FAULT_RATIO,
                                      "frac": CUDNN_FAULT_FRAC}}}})


def phase_mamba_dec_recognize(m, state):
    """Recognizer(search="s2s") with the YAML's decode stanza: requests of
    3 to 30 s at batch=1, then S2S RTFx at B8 x 30 s (median of
    S2S_SEARCHES searches) and one profiled search."""
    from mamba_asr_torch.kernels import beam_attention as k4
    from mamba_asr_torch.kernels import ctc_dp as k3
    from mamba_asr_torch.kernels import selective_scan as k1
    from mamba_asr_torch.serving.recognizer import Recognizer

    cfg, dec = m.model, m.decode
    if dec.s2s_test_beam_size != MAMBA_SEARCH[1] or dec.lm_path:
        raise AssertionError("mamba_dec_recognize: not the YAML's decode stanza")
    per_forward = scans_per_step(dataclasses.replace(cfg, num_decoder_layers=0))
    layers = cfg.num_decoder_layers
    torch.cuda.reset_peak_memory_stats()
    rec = Recognizer(cfg, m.frontend, state, device="cuda", batch=1, decode=dec, search="s2s")
    requests = [noise(s, 50 + i) for i, s in enumerate((3.0, 12.25, 30.0))]
    steps, ids = [], []
    k1.LAUNCHES = k3.LAUNCHES = k4.LAUNCHES = 0
    t0 = time.perf_counter()
    for wav in requests:
        ids += rec.transcribe([wav])
        steps.append(rec.searcher.last_steps)
    seconds = time.perf_counter() - t0
    launches = {"K1": k1.LAUNCHES, "K3": k3.LAUNCHES, "K4": k4.LAUNCHES}
    if launches != {"K1": len(requests) * (per_forward + layers), "K3": sum(steps), "K4": 0}:
        raise AssertionError(f"mamba_dec_recognize: launches {launches} for steps {steps}")

    bsz = MAMBA_SEARCH[0]
    rec8 = Recognizer(cfg, m.frontend, state, device="cuda", batch=bsz, decode=dec,
                      search="s2s")
    batch = [noise(30.0, 300 + i) for i in range(bsz)]
    wav = torch.from_numpy(np.stack(batch))
    lens = torch.full((bsz,), 480000, dtype=torch.int32)
    out = rec8.eval_step(wav, lens)
    toks, tlens, scores = rec8.searcher(out["enc_out"], out["enc_lengths"],
                                        out["ctc_log_probs"])
    s_max = min(256, out["ctc_log_probs"].shape[1] + 1)
    if (tuple(toks.shape) != (bsz, s_max) or not torch.isfinite(scores).all()
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size):
        raise AssertionError(f"mamba_dec_recognize: bad search {tuple(toks.shape)}")
    blocks, per_search = [], None
    for i in range(S2S_SEARCHES):
        k1.LAUNCHES = k3.LAUNCHES = k4.LAUNCHES = 0
        t0 = time.perf_counter()
        rec8.transcribe(batch)
        blocks.append(bsz * 30.0 / (time.perf_counter() - t0))
        if i == 0:
            per_search = {"K1": k1.LAUNCHES, "K3": k3.LAUNCHES, "K4": k4.LAUNCHES,
                          "steps": rec8.searcher.last_steps}
    st = per_search["steps"]
    if per_search != {"K1": per_forward + layers, "K3": st, "K4": 0, "steps": st}:
        raise AssertionError(f"mamba_dec_recognize: launches per search {per_search}")
    rtfx = statistics.median(blocks)
    memory_gb = torch.cuda.max_memory_allocated() / 1e9
    wall_ms, device_ms, top = device_profile(lambda: rec8.decode_batch(wav, lens), 15,
                                             ("scan_fwd", "ctc_dp_kernel"))
    emit({"phase": "mamba_dec_recognize", "config": MAMBA_CONFIG, "beam": dec.s2s_test_beam_size,
          "requests_s": [len(r) / 16000 for r in requests], "tokens": [len(x) for x in ids],
          "steps": steps, "seconds": seconds, "launches": launches,
          "throughput": {"batch": bsz, "seconds_each": 30.0, "rtfx": rtfx, "blocks": blocks,
                         "spread_pct": 100.0 * (max(blocks) - min(blocks)) / rtfx,
                         "compute_dtype": cfg.compute_dtype, "best_lengths": tlens.tolist(),
                         "launches_per_search": per_search},
          "max_memory_allocated_gb": memory_gb,
          "profile": {"wall_ms": wall_ms, "device_kernel_ms": device_ms,
                      "idle_share": 1.0 - device_ms / wall_ms,
                      "K1_ms": sum(r["ms"] for r in top if "scan_fwd" in r["kernel"]),
                      "K3_ms": sum(r["ms"] for r in top if "ctc_dp_kernel" in r["kernel"]),
                      "top": top}})
    return per_search


def phase_mamba_dec_train(m, state):
    """Trainer(device="cuda") with the Mamba YAML's settings on B32 x 25 s
    with 60 to 80 random targets: 8 checked micro-steps, audio-s per s
    (median of 3 blocks), peak memory, one profiled micro-step."""
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.training.trainer import Trainer

    cfg, tc = m.model, m.train
    if (cfg.decoder_module, cfg.compute_dtype, cfg.dropout, tc.grad_accumulation_factor,
            tc.ctc_weight, cfg.vocab_size) != ("mamba", "bfloat16", 0.1, 8, 0.3, 5000):
        raise AssertionError("mamba_dec_train: not the Mamba YAML's settings")
    if not (m.specaug.enabled and m.specaug.apply_time_warp):
        raise AssertionError("mamba_dec_train: the YAML's SpecAugment has no time warp")
    per_step = scans_per_step(cfg)
    tr = Trainer(cfg, m.frontend, tc, m.specaug, state_dict=state, device="cuda")
    batch = s2s_train_batch(32, TRAIN_SECONDS, cfg.vocab_size, 6)
    k = tc.grad_accumulation_factor
    steps = []
    kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
    for i in range(k):
        before = [p.detach().clone() for p in tr.model.parameters()]
        mt = tr.train_step(batch)
        changed = sum(not torch.equal(a, p) for a, p in zip(before, tr.model.parameters()))
        row = {key: mt[key].item() for key in ("loss", "loss_ctc", "loss_att", "grad_norm")}
        if not all(np.isfinite(row[key]) for key in ("loss", "loss_ctc", "loss_att")):
            raise AssertionError(f"mamba_dec_train micro-step {i}: {row}")
        emit_step = i == k - 1
        if bool(mt["updated"]) != emit_step or (changed > 0) != emit_step:
            raise AssertionError(f"mamba_dec_train micro-step {i}: {changed} parameters "
                                 f"changed, updated={bool(mt['updated'])}")
        steps.append({**row, "params_changed": changed})
    launches = {"K1": kernel.LAUNCHES, "K2": kernel.BWD_LAUNCHES}
    if launches != {"K1": per_step * k, "K2": per_step * k}:
        raise AssertionError(f"mamba_dec_train: {launches} scan launches in {k} micro-steps")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blocks = []
    audio = float(batch["wav_lens"].sum()) / 16000
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            tr.train_step(batch)
        torch.cuda.synchronize()
        blocks.append(k * audio / (time.perf_counter() - t0))
    rate = statistics.median(blocks)
    memory_gb = torch.cuda.max_memory_allocated() / 1e9
    wall_ms, device_ms, top = device_profile(lambda: tr.train_step(batch), 15,
                                             named=("scan_fwd", "scan_bwd"))
    emit({"phase": "mamba_dec_train", "config": MAMBA_CONFIG, "batch": 32,
          "seconds_each": TRAIN_SECONDS, "audio_s_per_step": audio,
          "target_tokens": batch["token_lens"].tolist(), "micro_steps": steps,
          "accumulation": k, "compute_dtype": cfg.compute_dtype, "dropout": cfg.dropout,
          "launches_per_micro_step": {key: v // k for key, v in launches.items()},
          "throughput": {"audio_s_per_s": rate, "blocks": blocks,
                         "spread_pct": 100.0 * (max(blocks) - min(blocks)) / rate,
                         "micro_steps_per_block": k},
          "max_memory_allocated_gb": memory_gb,
          "profile": {"wall_ms": wall_ms, "device_kernel_ms": device_ms,
                      "idle_share": 1.0 - device_ms / wall_ms, "top": top}})
    return launches


def phase_mamba_dec_recipe(work, corpus):
    return s2s_recipe("mamba_dec_recipe", MAMBA_CONFIG, MAMBA_RECIPE_EPOCHS, work, corpus)


def phase_mamba_dec_train_to_floor(work):
    """tools.train_to_floor --mode s2s at its default config (the Mamba
    decoder) on the JAX regime proof's corpus: 160 / 16 / 16 utterances,
    --epochs MAMBA_FLOOR_EPOCHS (x 3), test WER <= 2.0 %."""
    from mamba_asr_torch.tools import train_to_floor

    corpus = os.path.join(work, "corpus160")
    n_train, n_dev, n_test = MAMBA_FLOOR_CORPUS
    train_to_floor.build_corpus(corpus, n_train=n_train, n_dev=n_dev, n_test=n_test)
    reset, read = s2s_launch_counters()
    reset()
    epochs = 3 * MAMBA_FLOOR_EPOCHS  # the tool's S2S rule
    res, tr = train_to_floor.run_mode("s2s", corpus, os.path.join(work, "floor160"), epochs)
    launches = read()
    model = tr.cfg.model
    if model.decoder_module != "mamba" or train_to_floor.S2S_CONFIG != MAMBA_CONFIG:
        raise AssertionError("mamba_dec_train_to_floor: the tool's default is not the Mamba "
                             "decoder")
    if launches["K2"] != scans_per_step(model) * tr.micro_steps or not launches["K3"] \
            or launches["K4"]:
        raise AssertionError(f"mamba_dec_train_to_floor: launches {launches}")
    rows = epoch_rows(tr)
    result = {"phase": "mamba_dec_train_to_floor", **res, "target": FLOOR_TARGET,
              "config": MAMBA_CONFIG, "corpus": list(MAMBA_FLOOR_CORPUS),
              "test": tr.test_stats["test-clean"], "launches": launches,
              "epoch_s": [r["epoch_s"] for r in rows],
              "valid": {e["epoch"]: e["valid"] for e in tr.epoch_log
                        if e["epoch"] % (epochs // 2) == 0 or e["epoch"] % 30 == 0},
              "loss": [r["loss"] for r in rows[::10]] + [rows[-1]["loss"]],
              "train_audio_s_per_s": audio_rate(rows)}
    emit(result)
    if not res["test_wer"] <= FLOOR_TARGET:
        raise AssertionError(f"mamba_dec_train_to_floor: test WER {res['test_wer']} > "
                             f"{FLOOR_TARGET}")
    return launches


# -- The Transformer LM and shallow fusion ------------------------------------------


def seeded_lm(decode, vocab, seed=SEED):
    """The decode stanza's TransformerLM at full width, float32 weights
    from models.lm.init_params_ (seeded), on the CPU, in eval mode."""
    from mamba_asr_torch.models.lm import TransformerLM, init_params_

    lm = TransformerLM(vocab, decode.lm_d_model, decode.lm_nhead, decode.lm_layers,
                       decode.lm_d_ffn)
    return init_params_(lm, torch.Generator().manual_seed(seed)).eval()


def k4_at_shape(phase, h, dh, seed, clock_hz, sms):
    """K4 at H heads of dh, S 320, N 528 (B8 x beam 66) against its plain
    gather: bf16 and fp32 at pos 255 on a random and a beam-shaped table,
    bf16 at pos 1,023 (S 1,024) on both. Times, bounds and the gather +
    SDPA call at pos 255 in bf16."""
    from mamba_asr_torch.kernels import beam_attention as k4
    from mamba_asr_torch.ops.beam_attention import beam_attention_ref

    n, s = 528, 320
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases, timing = [], {}

    def check(q, kv, anc, pos, name, tol):
        got = k4.beam_attention_fwd(q, *kv, anc, pos)
        torch.cuda.synchronize()
        ref = beam_attention_ref(q, *kv, anc, pos)
        cases.append({"case": name, "max_abs_err": check_close(
            f"{phase} {name}", got, ref, *tol), "tol": tol})

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, (2e-5, 2e-5))):
        q, kv = beam_attn_inputs(gen, n, h, s, dh, dtype)
        tables = {"random": anc_table(s, n, 255, rng), "beam": beam_table(s, n, 255, rng)}
        for table, anc in tables.items():
            check(q, kv, anc, 255, f"h{h}_dh{dh}_n{n}_pos255_{table}_{str(dtype)[6:]}", tol)
            if dtype != torch.bfloat16:
                continue
            bound_ms, bound_by, sector_ms, distinct = beam_attn_bound_ms(
                h, dh, anc, 255, 2, clock_hz, sms)
            timing[table] = {
                "kernel_ms": cuda_ms(lambda: k4.beam_attention_fwd(q, *kv, anc, 255), 50),
                "plain_ms": cuda_ms(lambda: beam_attention_ref(q, *kv, anc, 255), 5),
                "library_ms": cuda_ms(lambda: sdpa_on_gathered(q, *kv, anc, 255), 20),
                "bound_ms": bound_ms, "bound_by": bound_by, "bound_sector_ms": sector_ms,
                "distinct_rows": distinct, "split_rule": k4.split_rule(n, h, 255, sms)}
        del q, kv
    q, kv = beam_attn_inputs(gen, n, h, 1024, dh, torch.bfloat16)
    for table, make in (("random", anc_table), ("beam", beam_table)):
        check(q, kv, make(1024, n, 1023, rng), 1023,
              f"h{h}_dh{dh}_n{n}_pos1023_s1024_{table}_bfloat16", BF16_TOL)
    del q, kv
    result = {"phase": phase, "name": "beam_attention", "shape": [h, s, n, dh],
              "cases": cases, "timing": timing, **timing["random"]}
    emit(result)
    return result


def phase_lm_kernels(decode, clock_hz, sms):
    """K4 at the LM's shape: H 12, dh 64 (`k4_at_shape`)."""
    return k4_at_shape("lm_kernels", decode.lm_nhead, decode.lm_d_model // decode.lm_nhead,
                       SEED + 10, clock_hz, sms)


@torch.no_grad()
def phase_lm_parity(s2s, s2s_state, mam, mam_state):
    """The full-width LM (decode stanza's widths, vocab 5000, seeded) in
    fp32 with TF32 off, card against CPU: full-pass logits; 8 cached steps
    through two reorders, each against its own full pass; the n-best
    scores and choice of rescore_nbest. Then the fused joint search at beam
    4 on a 2 s request for both decoders: tokens equal, scores within
    S2S_PARITY_TOL."""
    from mamba_asr_torch.decoding.rescore import lm_nbest_scores, rescore_nbest
    from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher
    from mamba_asr_torch.kernels import beam_attention as k4
    from mamba_asr_torch.serving.recognizer import Recognizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d, vocab = s2s.decode, s2s.model.vocab_size
    lms = {"cpu": seeded_lm(d, vocab)}
    lms["cuda"] = seeded_lm(d, vocab).to("cuda").eval()
    rng = np.random.default_rng(SEED + 11)
    toks = torch.from_numpy(rng.integers(3, vocab, (4, 32)))
    full = {dev: lm(toks.to(dev)).cpu() for dev, lm in lms.items()}
    full_err = check_close("lm_parity full pass", full["cuda"], full["cpu"],
                           S2S_PARITY_TOL, 0.0)

    n, steps, beam = 8, 8, 4
    step_toks = rng.integers(3, vocab, (steps, n))
    reorders = {2: rng.integers(0, beam, n) + np.repeat(np.arange(2) * beam, beam),
                5: rng.integers(0, beam, n) + np.repeat(np.arange(2) * beam, beam)}

    def chain(dev):
        lm, hist = lms[dev], np.zeros((n, 0), np.int64)
        cache = lm.init_cache(n, 64, dev)
        anc = np.tile(np.arange(n, dtype=np.int32), (64, 1))
        outs, errs = [], []
        for s in range(steps):
            anc[s] = np.arange(n)
            hist = np.concatenate([hist, step_toks[s][:, None]], 1)
            got = lm.step(torch.from_numpy(step_toks[s]).to(dev), s, cache,
                          torch.from_numpy(anc).to(dev)).cpu()
            ref = lm(torch.from_numpy(hist).to(dev))[:, s].cpu()
            errs.append(check_close(f"lm_parity {dev} step {s} vs full pass", got, ref,
                                    S2S_PARITY_TOL, 0.0))
            outs.append(got)
            if s in reorders:
                anc = np.ascontiguousarray(anc[:, reorders[s]])
                hist = hist[reorders[s]]
        return torch.stack(outs), max(errs)

    k4.LAUNCHES = 0
    stepped = {dev: chain(dev) for dev in lms}
    if k4.LAUNCHES != steps * d.lm_layers:
        raise AssertionError(f"lm_parity: K4 launches {k4.LAUNCHES}")
    step_err = check_close("lm_parity steps card vs CPU", stepped["cuda"][0],
                           stepped["cpu"][0], S2S_PARITY_TOL, 0.0)

    nb_toks = torch.from_numpy(rng.integers(3, vocab, (2, 6, 12)))
    nb_lens = torch.from_numpy(rng.integers(0, 13, (2, 6)))
    ctc = torch.from_numpy(rng.normal(-20.0, 2.0, (2, 6)).astype(np.float32))
    nbest = {dev: (lm_nbest_scores(lm, nb_toks.to(dev), nb_lens.to(dev), d.temperature_lm).cpu(),
                   rescore_nbest(nb_toks.to(dev), nb_lens.to(dev), ctc.to(dev), lm,
                                 d.lm_weight, d.temperature_lm)[0].cpu())
             for dev, lm in lms.items()}
    nbest_err = check_close("lm_parity n-best scores", nbest["cuda"][0], nbest["cpu"][0],
                            S2S_PARITY_TOL, 0.0)
    if not torch.equal(nbest["cuda"][1], nbest["cpu"][1]):
        raise AssertionError("lm_parity: rescore_nbest chose other hypotheses on the card")

    search, wav = {}, torch.from_numpy(noise(2.0, 23))[None]
    for name, exp, state in (("transformer", s2s, s2s_state), ("mamba", mam, mam_state)):
        cfg32 = dataclasses.replace(exp.model, compute_dtype="float32")
        found = {}
        for dev, lm in lms.items():
            rec = Recognizer(cfg32, exp.frontend, state, device=dev)
            out = rec.eval_step(wav, torch.tensor([wav.shape[1]], dtype=torch.int32))
            searcher = S2SBeamSearcher(
                rec.model, beam_size=beam, ctc_weight=d.ctc_weight_decode,
                ctc_candidates=d.ctc_candidates, lm_weight=d.lm_weight,
                temperature=d.temperature, temperature_lm=d.temperature_lm, lm_model=lm)
            found[dev] = [x.cpu() for x in searcher(out["enc_out"], out["enc_lengths"],
                                                    out["ctc_log_probs"])]
            found[dev].append(searcher.last_steps)
        if not torch.equal(found["cuda"][0], found["cpu"][0]):
            raise AssertionError(f"lm_parity {name}: fused search tokens differ, first at "
                                 f"{first_difference(found['cuda'][0][0], found['cpu'][0][0])}")
        search[name] = {"score_max_abs_err": check_close(
            f"lm_parity {name} fused search scores", found["cuda"][2], found["cpu"][2],
            S2S_PARITY_TOL, 0.0), "scores": found["cuda"][2].tolist(),
            "lengths": found["cuda"][1].tolist(), "steps": found["cuda"][3]}
    torch.backends.cudnn.allow_tf32 = True  # back to PyTorch's defaults
    emit({"phase": "lm_parity", "lm": [d.lm_layers, d.lm_d_model, d.lm_nhead, d.lm_d_ffn, vocab],
          "full_pass_max_abs_err": full_err, "steps": steps, "reorders_after": list(reorders),
          "step_vs_full_max_abs_err": {dev: v[1] for dev, v in stepped.items()},
          "steps_max_abs_err": step_err, "nbest_max_abs_err": nbest_err,
          "fused_search": search, "tol": S2S_PARITY_TOL})


@torch.no_grad()
def phase_lm_recognize(s2s, s2s_state, mam, mam_state, work, no_lm):
    """Recognizer(search="s2s") with the S2S YAML's decode stanza and
    decode.lm_path pointing at a seeded full-width LM (.pt, bf16 at load):
    S2S+LM RTFx at B8 x 30 s (median of LM_SEARCHES searches), launches
    per search, one profiled search; beside it s2s_recognize's no-LM
    throughput (`no_lm`, this run's) and one Mamba-decoder + LM search."""
    from mamba_asr_torch.kernels import beam_attention as k4
    from mamba_asr_torch.kernels import ctc_dp as k3
    from mamba_asr_torch.kernels import selective_scan as k1
    from mamba_asr_torch.serving.recognizer import Recognizer

    d = s2s.decode
    path = os.path.join(work, "seeded_lm.pt")
    torch.save(seeded_lm(d, s2s.model.vocab_size, SEED + 12).state_dict(), path)
    dec = dataclasses.replace(d, lm_path=path)
    if (dec.s2s_test_beam_size, dec.ctc_weight_decode, dec.ctc_candidates, dec.lm_weight,
            dec.temperature_lm, dec.lm_dtype) != (66, 0.4, 96, 0.6, 1.15, "bfloat16"):
        raise AssertionError(f"lm_recognize: not the YAML's decode stanza {dec}")
    bsz = 8
    batch = [noise(30.0, 400 + i) for i in range(bsz)]
    wav = torch.from_numpy(np.stack(batch))
    lens = torch.full((bsz,), 480000, dtype=torch.int32)

    def timed_searches(rec, count):
        rec.transcribe(batch)  # warm
        blocks, per_search = [], []
        for _ in range(count):
            k1.LAUNCHES = k3.LAUNCHES = k4.LAUNCHES = 0
            t0 = time.perf_counter()
            rec.transcribe(batch)
            blocks.append(bsz * 30.0 / (time.perf_counter() - t0))
            per_search.append({"K1": k1.LAUNCHES, "K3": k3.LAUNCHES, "K4": k4.LAUNCHES,
                               "steps": rec.searcher.last_steps})
        rtfx = statistics.median(blocks)
        return {"rtfx": rtfx, "blocks": blocks,
                "spread_pct": 100.0 * (max(blocks) - min(blocks)) / rtfx,
                "launches_per_search": per_search[0]}, per_search

    torch.cuda.reset_peak_memory_stats()
    rec = Recognizer(s2s.model, s2s.frontend, s2s_state, device="cuda", batch=bsz, decode=dec,
                     search="s2s")
    lm_layers, dec_layers = d.lm_layers, s2s.model.num_decoder_layers
    if rec.searcher.decode_lm.encoder.layers[0].self_att.att.in_proj_weight.dtype \
            != torch.bfloat16 or rec.searcher.decode_lm.output_proj.w.weight.dtype \
            != torch.float32:
        raise AssertionError("lm_recognize: the LM's decode weights are not bf16 with a "
                             "float32 head")
    fused, runs = timed_searches(rec, LM_SEARCHES)
    for run in runs:
        st = run["steps"]
        if run != {"K1": 2 * s2s.model.num_encoder_layers, "K3": st,
                   "K4": (dec_layers + lm_layers) * st, "steps": st}:
            raise AssertionError(f"lm_recognize: launches per search {run}")
    memory_gb = torch.cuda.max_memory_allocated() / 1e9
    out = rec.eval_step(wav, lens)
    toks, tlens, scores = rec.searcher(out["enc_out"], out["enc_lengths"], out["ctc_log_probs"])
    if not torch.isfinite(scores).all() or int(toks.max()) >= s2s.model.vocab_size:
        raise AssertionError(f"lm_recognize: bad search result {scores.tolist()}")
    wall_ms, device_ms, top = device_profile(lambda: rec.decode_batch(wav, lens), 15,
                                             ("beam_attention_kernel", "ctc_dp_kernel"))
    del rec

    mrec = Recognizer(mam.model, mam.frontend, mam_state, device="cuda", batch=bsz,
                      decode=dataclasses.replace(mam.decode, lm_path=path), search="s2s")
    mamba, runs = timed_searches(mrec, 1)
    st = runs[0]["steps"]
    per_forward = scans_per_step(dataclasses.replace(mam.model, num_decoder_layers=0))
    if runs[0] != {"K1": per_forward + mam.model.num_decoder_layers, "K3": st,
                   "K4": lm_layers * st, "steps": st}:
        raise AssertionError(f"lm_recognize: Mamba-decoder launches per search {runs[0]}")
    del mrec
    result = {"phase": "lm_recognize", "beam": dec.s2s_test_beam_size,
              "ctc": [dec.ctc_weight_decode, dec.ctc_candidates],
              "lm": [dec.lm_weight, dec.temperature_lm, dec.lm_dtype, lm_layers, dec.lm_d_model],
              "batch": bsz, "seconds_each": 30.0, "fused": fused, "no_lm": no_lm,
              "mamba_decoder_fused": mamba, "best_lengths": tlens.tolist(),
              "max_memory_allocated_gb": memory_gb,
              "profile": {"wall_ms": wall_ms, "device_kernel_ms": device_ms,
                          "idle_share": 1.0 - device_ms / wall_ms,
                          "K4_ms": sum(r["ms"] for r in top
                                       if "beam_attention_kernel" in r["kernel"]),
                          "K3_ms": sum(r["ms"] for r in top if "ctc_dp_kernel" in r["kernel"]),
                          "top": top}}
    emit(result)
    return result


# -- the other encoders: Conformer, HyperMixing, Branchformer (slice 4 item 1) ----------


def phase_conformer_kernels(large, clock_hz, sms):
    """K4 at the Conformer-Large decoder's shape: H 8, dh 64 (`k4_at_shape`)."""
    return k4_at_shape("conformer_kernels", large.nhead, large.d_model // large.nhead,
                       SEED + 13, clock_hz, sms)


def yaml_name(path):
    return path[len("hparams/"):-len(".yaml")]


@torch.no_grad()
def phase_conformer_parity(exps, states):
    """Full width and depth, fp32 with TF32 and cuDNN off, B2 x 4 s with
    row 1 at 3.1 s: the card against the CPU. CTC log-probs of the three
    CTC YAMLs and of S2S/conformer_small within PARITY_TOL; for that S2S
    model 8 cached decode steps through shuffled ancestor tables (on the
    CPU's encoder output) within S2S_PARITY_TOL, and the joint search at
    beam 4 with the YAML's stanza on each device's own forward: tokens
    equal, scores within S2S_PARITY_TOL."""
    from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher
    from mamba_asr_torch.kernels import beam_attention as k4
    from mamba_asr_torch.kernels import ctc_dp as k3
    from mamba_asr_torch.serving.recognizer import Recognizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = False
    wav = np.zeros((2, 64000), np.float32)
    wav[0] = noise(4.0, 31)
    wav[1, :49600] = noise(3.1, 32)
    lens = torch.tensor([64000, 49600], dtype=torch.int32)
    result, small = {"phase": "conformer_parity", "tol": PARITY_TOL}, CONFORMER_S2S[0]
    for path in CONFORMER_CTC + (small,):
        exp = exps[path]
        cfg32 = dataclasses.replace(exp.model, compute_dtype="float32")
        recs = {dev: Recognizer(cfg32, exp.frontend, states[path], device=dev, batch=2)
                for dev in ("cuda", "cpu")}
        outs = {dev: rec.eval_step(torch.from_numpy(wav), lens) for dev, rec in recs.items()}
        lp = {dev: o["ctc_log_probs"].cpu() for dev, o in outs.items()}
        result[yaml_name(path)] = {"shape": list(lp["cpu"].shape), "max_abs_err": check_close(
            f"conformer_parity {path} ctc_log_probs", lp["cuda"], lp["cpu"], PARITY_TOL, 0.0)}
    exp, cpu = exps[small], outs["cpu"]
    rng = np.random.default_rng(SEED + 14)
    n, vocab, d = 8, exp.model.vocab_size, exp.decode
    toks, perms = rng.integers(3, vocab, (8, n)), rng.integers(0, n, (8, n))
    k4.LAUNCHES = 0
    steps = {dev: decode_steps(rec, cpu["enc_out"][:1], cpu["enc_lengths"][:1], toks, perms)
             for dev, rec in recs.items()}
    if k4.LAUNCHES != 8 * exp.model.num_decoder_layers:
        raise AssertionError(f"conformer_parity: K4 launches {k4.LAUNCHES} in 8 steps")
    found = {}
    for dev, rec in recs.items():
        o = outs[dev]
        searcher = S2SBeamSearcher(rec.model, beam_size=4, ctc_weight=d.ctc_weight_decode,
                                   ctc_candidates=d.ctc_candidates, temperature=d.temperature)
        k3.LAUNCHES = k4.LAUNCHES = 0
        found[dev] = [x.cpu() for x in searcher(o["enc_out"], o["enc_lengths"],
                                                o["ctc_log_probs"])]
        found[dev].append((searcher.last_steps, k3.LAUNCHES, k4.LAUNCHES))
    st, l3, l4 = found["cuda"][3]
    if (l3, l4) != (st, exp.model.num_decoder_layers * st):
        raise AssertionError(f"conformer_parity: search launches K3 {l3}, K4 {l4}, steps {st}")
    if not torch.equal(found["cuda"][0], found["cpu"][0]):
        raise AssertionError("conformer_parity: search tokens differ, first at "
                             f"{first_difference(found['cuda'][0][0], found['cpu'][0][0])}")
    torch.backends.cudnn.enabled = True
    torch.backends.cudnn.allow_tf32 = True  # back to PyTorch's defaults
    result["s2s"] = {
        "decode_step_max_abs_err": check_close("conformer_parity decode steps", steps["cuda"],
                                               steps["cpu"], S2S_PARITY_TOL, 0.0),
        "search_score_max_abs_err": check_close(
            "conformer_parity search scores", found["cuda"][2], found["cpu"][2],
            S2S_PARITY_TOL, 0.0),
        "search": {"beam": 4, "scores": found["cuda"][2].tolist(),
                   "lengths": found["cuda"][1].tolist(), "steps": st, "tokens_equal": True}}
    emit(result)


@torch.no_grad()
def phase_conformer_recognize(exps, states):
    """bf16 through Recognizer. CTC RTFx at B32 x 30 s of noise: the
    recognize phase's 5 blocks of 10 calls for Conformer-Large, one block
    for the hypermixing and Branchformer YAMLs, and one profiled
    Conformer-Large call. S2S RTFx of Conformer-Small
    at B8 x 30 s with its YAML's decode stanza (beam 66, CTC 0.4, 96
    candidates; median of S2S_SEARCHES searches) and one timed
    Conformer-Large search, each holding K3 at one launch per step and K4
    at one per decoder layer and step over all 256 steps; one profiled
    Conformer-Small search."""
    from mamba_asr_torch.kernels import beam_attention as k4
    from mamba_asr_torch.kernels import ctc_dp as k3
    from mamba_asr_torch.kernels import selective_scan as k1
    from mamba_asr_torch.serving.recognizer import Recognizer

    torch.cuda.reset_peak_memory_stats()
    result = {"phase": "conformer_recognize", "ctc": {}, "s2s": {}}
    batch = [noise(30.0, 500 + i) for i in range(32)]
    iters = 10
    for path, count in zip(CONFORMER_CTC, (5, 1, 1)):
        exp = exps[path]
        rec = Recognizer(exp.model, exp.frontend, states[path], device="cuda", batch=32)
        lp = rec.eval_step(torch.from_numpy(np.stack(batch)),
                           torch.full((32,), 480000, dtype=torch.int32))["ctc_log_probs"]
        if tuple(lp.shape) != (32, 751, exp.model.vocab_size) or not torch.isfinite(lp).all():
            raise AssertionError(f"conformer_recognize {path}: bad log-probs {tuple(lp.shape)}")
        rec.transcribe(batch)  # warm-up
        k1.LAUNCHES, blocks = 0, []
        for _ in range(count):
            t0 = time.perf_counter()
            for _ in range(iters):
                rec.transcribe(batch)
            blocks.append(32 * 30.0 * iters / (time.perf_counter() - t0))
        if k1.LAUNCHES:
            raise AssertionError(f"conformer_recognize {path}: {k1.LAUNCHES} scan launches")
        rtfx = statistics.median(blocks)
        result["ctc"][yaml_name(path)] = {
            "batch": 32, "seconds_each": 30.0, "iters_per_block": iters, "rtfx": rtfx,
            "blocks": blocks, "spread_pct": 100.0 * (max(blocks) - min(blocks)) / rtfx}
        if path == CONFORMER_CTC[0]:
            wall_ms, device_ms, top = device_profile(lambda: rec.transcribe(batch), 12)
            result["ctc"][yaml_name(path)]["profile"] = {
                "wall_ms": wall_ms, "device_kernel_ms": device_ms,
                "idle_share": 1.0 - device_ms / wall_ms, "top": top}
        del rec
    bsz, s2s_batch = 8, [noise(30.0, 600 + i) for i in range(8)]
    wav = torch.from_numpy(np.stack(s2s_batch))
    lens = torch.full((bsz,), 480000, dtype=torch.int32)
    for path, count in zip(CONFORMER_S2S, (S2S_SEARCHES, 1)):
        exp = exps[path]
        layers = exp.model.num_decoder_layers
        rec = Recognizer(exp.model, exp.frontend, states[path], device="cuda", batch=bsz,
                         decode=exp.decode, search="s2s")
        if (rec.searcher.beam_size, exp.decode.ctc_weight_decode, exp.decode.ctc_candidates,
                exp.decode.lm_path) != (66, 0.4, 96, ""):
            raise AssertionError(f"conformer_recognize {path}: not the YAML's stanza")
        out = rec.eval_step(wav, lens)
        toks, tlens, scores = rec.searcher(out["enc_out"], out["enc_lengths"],
                                           out["ctc_log_probs"])
        if (tuple(toks.shape) != (bsz, 256) or not torch.isfinite(scores).all()
                or int(toks.min()) < 0 or int(toks.max()) >= exp.model.vocab_size):
            raise AssertionError(f"conformer_recognize {path}: bad search result "
                                 f"{tuple(toks.shape)} {scores.tolist()}")
        blocks = []
        for _ in range(count):
            k1.LAUNCHES = k3.LAUNCHES = k4.LAUNCHES = 0
            t0 = time.perf_counter()
            rec.transcribe(s2s_batch)
            blocks.append(bsz * 30.0 / (time.perf_counter() - t0))
            per_search = {"K1": k1.LAUNCHES, "K3": k3.LAUNCHES, "K4": k4.LAUNCHES,
                          "steps": rec.searcher.last_steps}
            if per_search != {"K1": 0, "K3": 256, "K4": 256 * layers, "steps": 256}:
                raise AssertionError(f"conformer_recognize {path}: per search {per_search}")
        rtfx = statistics.median(blocks)
        entry = {"batch": bsz, "seconds_each": 30.0, "rtfx": rtfx, "blocks": blocks,
                 "spread_pct": 100.0 * (max(blocks) - min(blocks)) / rtfx,
                 "launches_per_search": per_search, "best_lengths": tlens.tolist()}
        if path == CONFORMER_S2S[0]:
            wall_ms, device_ms, top = device_profile(
                lambda: rec.decode_batch(wav, lens), 15, ("ctc_dp_kernel", "beam_attention_kernel"))
            entry["profile"] = {
                "wall_ms": wall_ms, "device_kernel_ms": device_ms,
                "idle_share": 1.0 - device_ms / wall_ms,
                "K3_ms": sum(r["ms"] for r in top if "ctc_dp_kernel" in r["kernel"]),
                "K4_ms": sum(r["ms"] for r in top if "beam_attention_kernel" in r["kernel"]),
                "top": top}
        result["s2s"][yaml_name(path)] = entry
        del rec
    result["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(result)
    return result


def phase_train_lm(work, floor):
    """mamba_asr_torch.train_lm's loop at full LM width in fp32 on the
    transcripts of the 160-utterance tone training split (encoded with the
    S2S floor run's char tokenizer), at the decode model's vocabulary
    (5000): LM_TRAIN settings; writes lm.pt. The last logged ppl must be
    below LM_PPL_TARGET and below LM_PPL_OF_UNIGRAM times the perplexity
    of the stream's unigram frequencies."""
    from mamba_asr_torch.data.tokenizer import load_tokenizer
    from mamba_asr_torch.models.lm import TransformerLM, init_params_
    from mamba_asr_torch.train_lm import corpus_stream, train_lm

    trans = os.path.join(work, "corpus160", "train-clean-100", "1", "2", "1-2.trans.txt")
    corpus = os.path.join(work, "lm_corpus.txt")
    with open(trans) as f, open(corpus, "w") as g:
        g.writelines(line.split(" ", 1)[1] for line in f if line.strip())
    tok = load_tokenizer(os.path.join(floor["exp_dir"], "tokenizer_char.json"))
    stream = corpus_stream(corpus, tok)
    vocab = floor["vocab"]
    # The perplexity of the stream's own token frequencies: an LM that
    # learned only them ends near it.
    counts = np.bincount(stream)
    freq = counts[counts > 0] / len(stream)
    unigram_ppl = float(np.exp(-(freq * np.log(freq)).sum()))
    lm = TransformerLM(vocab, dropout=0.1)  # the script's --dropout and --seed
    init_params_(lm, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_lm(stream, lm, os.path.join(work, "lm"), device="cuda", **LM_TRAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps, log = LM_TRAIN["steps"], res["log"]
    # The first log line holds the first steps' warm-up (allocator, cuBLAS).
    steady = statistics.median(r["ms_per_step"] for r in log[1:])
    if not all(np.isfinite(res["losses"])) or not os.path.isfile(res["path"]):
        raise AssertionError("train_lm: a non-finite loss or no lm.pt")
    sd = torch.load(res["path"], weights_only=True)
    TransformerLM(vocab).load_state_dict(sd, strict=True)
    result = {"phase": "train_lm", "settings": LM_TRAIN, "vocab": vocab,
              "tokenizer_vocab": tok.vocab_size, "corpus_tokens": len(stream),
              "corpus_lines": sum(1 for _ in open(corpus)), "wall_s": wall,
              "ms_per_step": steady,
              "tokens_per_s": LM_TRAIN["batch_size"] * LM_TRAIN["seq_len"] / steady * 1e3,
              "log": log, "first_ppl": log[0]["ppl"], "last_ppl": log[-1]["ppl"],
              "target_ppl": LM_PPL_TARGET, "unigram_ppl": unigram_ppl,
              "target_ppl_of_unigram": LM_PPL_OF_UNIGRAM, "path": res["path"]}
    emit(result)
    target = min(LM_PPL_TARGET, LM_PPL_OF_UNIGRAM * unigram_ppl)
    if not log[-1]["ppl"] < target or len(res["losses"]) != steps:
        raise AssertionError(f"train_lm: last ppl {log[-1]['ppl']} >= {target} (unigram "
                             f"{unigram_ppl})")
    return res["path"]


def phase_lm_floor(work, corpus, floor, lm_path):
    """The S2S train-to-floor run (the Transformer decoder) again through
    the CLI with --decode.lm_path: its epochs are done, so it resumes and
    only tests, the joint search fusing the trained LM. Test WER <=
    FLOOR_TARGET, beside the WER without the LM."""
    from mamba_asr_torch.tools import train_to_floor

    reset, read = s2s_launch_counters()
    reset()
    res, tr = train_to_floor.run_mode("s2s", corpus, os.path.join(work, "floor"),
                                      floor["epochs"], s2s_config=S2S_CONFIG,
                                      extra=["--decode.lm_path", lm_path])
    launches = read()
    d = tr.cfg.decode
    if tr.start_epoch != floor["epochs"] + 1 or tr.epoch_log or tr.lm is None:
        raise AssertionError(f"lm_floor: trained again (start {tr.start_epoch}) or no LM")
    per_step = tr.cfg.model.num_decoder_layers + d.lm_layers
    if launches["K2"] or not launches["K3"] or launches["K4"] != per_step * launches["K3"]:
        raise AssertionError(f"lm_floor: launches {launches}")
    result = {"phase": "lm_floor", "config": S2S_CONFIG, "test_wer": res["test_wer"],
              "test_wer_without_lm": floor["test_wer"], "target": FLOOR_TARGET,
              "test": tr.test_stats["test-clean"], "wer_header": res["wer_header"],
              "lm": [d.lm_weight, d.temperature_lm, d.lm_dtype], "test_beam": d.s2s_test_beam_size,
              "wall_s": res["wall_s"], "launches": launches}
    emit(result)
    if not res["test_wer"] <= FLOOR_TARGET:
        raise AssertionError(f"lm_floor: test WER {res['test_wer']} > {FLOOR_TARGET}")
    return launches


# -- Streaming and recognition's entry points ----------------------------------


def stream_wav(n_frames, seed, hop=160):
    """N(0, 0.1) noise whose center framing gives n_frames fbank frames."""
    return np.random.default_rng(seed).normal(0.0, 0.1, (n_frames - 1) * hop).astype(np.float32)


def run_stream(model, frontend, wav, chunk_frames=STREAM_CHUNK_FRAMES, **kw):
    """One StreamingASRSession over wav in chunk_frames chunks: (token ids,
    each feed's wall ms, finish's wall ms, the session, K1 launches per
    feed)."""
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.models.streaming import StreamingASRSession

    sess = StreamingASRSession(model, frontend, chunk_frames=chunk_frames, **kw)
    step = chunk_frames * frontend.hop
    ids, lat = [], []
    before = kernel.LAUNCHES
    for off in range(0, len(wav), step):
        t0 = time.perf_counter()
        ids += sess.feed(wav[None, off:off + step])[0]
        lat.append(1e3 * (time.perf_counter() - t0))
    per_feed = (kernel.LAUNCHES - before) / len(lat)
    t0 = time.perf_counter()
    ids += sess.finish()[0]
    return ids, lat, 1e3 * (time.perf_counter() - t0), sess, per_feed


def stream_model(exp, state, device, dtype=None):
    from mamba_asr_torch.models.asr import ASRModel

    cfg = exp.model if dtype is None else dataclasses.replace(exp.model, compute_dtype=dtype)
    model = ASRModel(cfg)
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


@torch.no_grad()
def offline_padded(model, frontend, wav):
    """The offline equal of a stream: log-mel of the whole wav, zero frames
    to a multiple of the downsampling, the model: (enc_out, log-probs),
    on the model's device."""
    from mamba_asr_torch.ops.fbank import log_mel_spectrogram

    dev = model.src_proj.weight.device
    fe = frontend
    feats = log_mel_spectrogram(torch.from_numpy(wav)[None].to(dev), sample_rate=fe.sample_rate,
                                n_fft=fe.n_fft, n_mels=fe.n_mels, win_length_ms=fe.win_length_ms,
                                hop_length_ms=fe.hop_length_ms)
    pad = (-feats.shape[1]) % model.cfg.downsample
    out = model(torch.nn.functional.pad(feats, (0, 0, 0, pad)))
    return out["enc_out"], out["ctc_log_probs"]


def percentile(xs, q):
    """Nearest-rank percentile."""
    xs = sorted(xs)
    return xs[max(0, int(np.ceil(q / 100.0 * len(xs))) - 1)]


def latency_stats(lat, finish_ms, seconds):
    return {"chunks": len(lat), "median_ms": statistics.median(lat),
            "p90_ms": percentile(lat, 90), "p95_ms": percentile(lat, 95), "max_ms": max(lat),
            "first_ms": lat[0], "finish_ms": finish_ms,
            "rtfx": seconds / (1e-3 * (sum(lat) + finish_ms))}


def phase_streaming(exp, state, conf, conf_states, mam, mam_state, clock_hz, sms):
    """Chunked streaming on the card (models/streaming.py).

    Kernel: K1 at the streaming shapes (B1 and B4, L 1, 2, 3, 16, D288 N16,
    bf16 and fp32, h0 in and h_last out) against its plain version; time,
    plain time and bound at B1 L16 bf16. Parity (fp32, TF32 off): the
    YAML's ConMamba-Small made causal and unidirectional streams 3,000,
    2,999 and 2,997 frames; its tokens equal the card's offline forward on
    the canonically padded features (log-probs held within PARITY_TOL too);
    a 600-frame stream's log-probs on the card within PARITY_TOL of the
    CPU's. Encoders (fp32, 6 s): the YAML's bidirectional ConMamba-Small,
    Conformer-Large and Branchformer-Large, card against CPU of the same
    stream within PARITY_TOL; streamed against offline reported (the
    chunk-local compromise). Latency (the YAMLs' bf16, B1, 30 s of noise in
    64-frame chunks): per-chunk ms (median, p90, p95, max), streaming RTFx,
    K1 launches per chunk (24 for ConMamba-Small, none for the
    Conformer), one profiled stream's idle share; ConMamba-Small and
    Conformer-Large. S2S (ConMambaMamba-Small): feed + extend ms per
    chunk and decode_greedy(32) ms in bf16; in fp32 the cross states
    extended over a stream's encoder chunks against one prime of them all,
    within PARITY_TOL."""
    from mamba_asr_torch.decoding.ctc_greedy import ctc_greedy_decode
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.models.streaming import StreamingS2SSession
    from mamba_asr_torch.ops.selective_scan import selective_scan_ref

    result = {"phase": "streaming", "chunk_frames": STREAM_CHUNK_FRAMES, "tol": PARITY_TOL}
    cfg = exp.model
    d_inner, n = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    gen = torch.Generator().manual_seed(SEED + 40)
    cases = []
    for bsz in (1, 4):
        for length in (1, 2, 3, 16):
            for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
                inp = scan_inputs(bsz, length, d_inner, n, dtype, gen, h0=True)
                if kernel.time_segments(bsz, length, d_inner, sms)[0] != 1:
                    raise AssertionError(f"streaming: K1 splits B{bsz} L{length}")
                out, h_last = kernel.selective_scan_fwd(**inp, delta_softplus=True,
                                                        return_last_state=True)
                torch.cuda.synchronize()
                ref, h_ref = selective_scan_ref(**inp, delta_softplus=True,
                                                return_last_state=True)
                name = f"streaming k1 b{bsz} l{length} {str(dtype)[6:]}"
                cases.append({"shape": [bsz, length, d_inner, n], "dtype": str(dtype),
                              "max_abs_err": check_close(name, out, ref, *tol),
                              "h_last_max_abs_err": check_close(name + " h_last", h_last,
                                                                h_ref, *FP32_TOL)})
    k1 = scan_inputs(1, 16, d_inner, n, torch.bfloat16, gen, h0=True)
    bound_ms, bound_by = scan_bound_ms(k1, clock_hz, sms, h_last=True)
    result["kernel"] = {
        "cases": cases, "shape": [1, 16, d_inner, n], "dtype": "torch.bfloat16",
        "max_abs_err": max(c["max_abs_err"] for c in cases if c["shape"][:2] == [1, 16]),
        "ms": cuda_ms(lambda: kernel.selective_scan_fwd(**k1, delta_softplus=True,
                                                        return_last_state=True), 200),
        "plain_ms": cuda_ms(lambda: selective_scan_ref(**k1, delta_softplus=True,
                                                       return_last_state=True), 10),
        "bound_ms": bound_ms, "bound_by": bound_by}

    # Parity: a causal, unidirectional ConMamba-Small at full width and depth.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    causal = dataclasses.replace(exp, model=dataclasses.replace(
        cfg, causal=True, bidirectional=False, compute_dtype="float32"))
    cstate = seeded_state(causal.model)
    models = {dev: stream_model(causal, cstate, dev) for dev in ("cuda", "cpu")}
    fe = exp.frontend
    parity = {}
    for frames in STREAM_PARITY_FRAMES:
        wav = stream_wav(frames, SEED + frames)
        ids, _, _, sess, _ = run_stream(models["cuda"], fe, wav, collect_log_probs=True)
        lp = torch.from_numpy(np.concatenate(sess.log_probs, axis=1))
        _, off_lp = offline_padded(models["cuda"], fe, wav)
        toks, lens = ctc_greedy_decode(off_lp, torch.tensor([off_lp.shape[1]], device="cuda"))
        off_ids = toks[0, :int(lens[0])].tolist()
        if ids != off_ids:
            raise AssertionError(f"streaming: causal stream of {frames} frames: tokens differ "
                                 f"from the offline forward (first at "
                                 f"{first_difference(torch.tensor(ids), torch.tensor(off_ids))})")
        parity[frames] = {"tokens": len(ids), "offline_max_abs_err": check_close(
            f"streaming causal {frames} vs offline", lp, off_lp.cpu(), PARITY_TOL, 0.0)}
    # Card against CPU on a shorter stream: the CPU's is the phase's slowest part.
    wav = stream_wav(STREAM_ENCODER_FRAMES, SEED + 44)
    lps = [np.concatenate(run_stream(models[dev], fe, wav, collect_log_probs=True)[3].log_probs,
                          axis=1) for dev in ("cuda", "cpu")]
    parity["card_vs_cpu"] = {"frames": STREAM_ENCODER_FRAMES, "max_abs_err": check_close(
        "streaming causal card vs cpu", torch.from_numpy(lps[0]), torch.from_numpy(lps[1]),
        PARITY_TOL, 0.0)}
    result["causal_parity"] = parity

    # The bidirectional encoders: card against CPU; streamed against offline.
    encoders = {}
    wav = stream_wav(STREAM_ENCODER_FRAMES, SEED + 41)
    for name, e, st in ((yaml_name(CONFIG), exp, state),
                        *((yaml_name(p), conf[p], conf_states[p]) for p in CONFORMER_CTC[::2])):
        sinks = {}
        for dev in ("cuda", "cpu"):
            sinks[dev] = []
            run_stream(stream_model(e, st, dev, "float32"), e.frontend, wav,
                       enc_sink=sinks[dev])
        enc = torch.cat(sinks["cuda"], dim=1)
        off_enc, _ = offline_padded(stream_model(e, st, "cuda", "float32"), e.frontend, wav)
        rms = off_enc.float().pow(2).mean().sqrt().item()
        div = (enc - off_enc).abs()
        encoders[name] = {
            "frames": enc.shape[1],
            "card_vs_cpu_max_abs_err": check_close(f"streaming {name} card vs cpu", enc.cpu(),
                                                   torch.cat(sinks["cpu"], dim=1),
                                                   PARITY_TOL, 0.0),
            "streamed_vs_offline": {"max_abs": div.max().item(),
                                    "mean_abs": div.mean().item(), "offline_rms": rms}}
    result["encoders"] = encoders
    torch.backends.cudnn.allow_tf32 = True  # back to PyTorch's defaults
    del models

    # Latency at the YAMLs' bf16, B1.
    wav30 = noise(30.0, SEED + 42)
    latency = {}
    for name, e, st in ((yaml_name(CONFIG), exp, state),
                        (yaml_name(CONFORMER_CTC[0]), conf[CONFORMER_CTC[0]],
                         conf_states[CONFORMER_CTC[0]])):
        model = stream_model(e, st, "cuda")
        run_stream(model, e.frontend, wav30[:3 * 16000])  # warm-up
        kernel.LAUNCHES = 0
        ids, lat, fin, _, per_feed = run_stream(model, e.frontend, wav30)
        wall_ms, device_ms, top = device_profile(lambda: run_stream(model, e.frontend, wav30), 10)
        entry = {**latency_stats(lat, fin, 30.0), "tokens": len(ids),
                 "k1_launches_per_chunk": per_feed, "k1_launches_per_stream": kernel.LAUNCHES,
                 "profile": {"wall_ms": wall_ms, "device_kernel_ms": device_ms,
                             "idle_share": 1.0 - device_ms / wall_ms, "top": top}}
        want = scans_per_step(e.model) if e.model.encoder_module == "conmamba" else 0
        if per_feed != want:
            raise AssertionError(f"streaming: {name}: {per_feed} K1 launches per chunk")
        latency[name] = entry
        del model
    result["latency"] = latency

    # S2S: the Mamba decoder's cross states extended chunk by chunk.
    model = stream_model(mam, mam_state, "cuda")
    sess = StreamingS2SSession(model, mam.frontend, chunk_frames=STREAM_CHUNK_FRAMES)
    step = STREAM_CHUNK_FRAMES * mam.frontend.hop
    sess.feed(wav30[None, :step])  # warm-up chunk
    feed_ms = []
    kernel.LAUNCHES = 0
    for off in range(step, len(wav30), step):
        t0 = time.perf_counter()
        sess.feed(wav30[None, off:off + step])
        torch.cuda.synchronize()
        feed_ms.append(1e3 * (time.perf_counter() - t0))
    s2s_launches = kernel.LAUNCHES
    sess.finish()
    t0 = time.perf_counter()
    hyp = sess.decode_greedy(32)
    decode_ms = 1e3 * (time.perf_counter() - t0)
    model32 = stream_model(mam, mam_state, "cuda", "float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    sink = []
    run_stream(model32, mam.frontend, stream_wav(1000, SEED + 43), enc_sink=sink)
    with torch.no_grad():
        cache = model32.init_decoder_cache(1)
        for chunk in sink:
            cache = model32.extend_decoder_cache(chunk, cache)
        primed = model32.prime_decoder_cache(torch.cat(sink, dim=1), model32.init_decoder_cache(1))
    ext_err = max(check_close("streaming s2s extend vs prime", a, b, PARITY_TOL, 0.0)
                  for got, want in zip(cache, primed) for a, b in zip(got["cross"], want["cross"]))
    result["s2s"] = {"config": MAMBA_CONFIG, "feed_ms_median": statistics.median(feed_ms),
                     "feed_ms_max": max(feed_ms), "chunks": len(feed_ms),
                     "k1_launches_per_chunk": s2s_launches / len(feed_ms),
                     "decode_greedy_32_ms": decode_ms, "tokens": len(hyp[0]),
                     "extend_vs_prime_max_abs_err": ext_err, "memory_chunks": len(sink)}
    emit(result)
    return result


def cli_lines(main_fn, argv):
    """stdout lines of an entry point's main(argv), called in this process."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main_fn(argv)
    return out.getvalue().splitlines()


def capture_test_pass(trainer, loader, decoder):
    """Token ids by utterance id of trainer.evaluate with `decoder` (the
    test pass's averaged checkpoints, as the recipe decodes them)."""
    got = {}

    def capture(model, batch, out):
        ids = decoder(model, batch, out)
        for uid, row in zip(batch["ids"][:int(batch["weight"].sum())], ids):
            got[uid] = row
        return ids

    trainer.evaluate(loader, test_name="recognize_cli", decoder=capture)
    return got


def phase_recognize_cli(work, corpus, floor_tr, s2s_floor):
    """Recognition's CLIs on the card, in-process, on the floor runs'
    checkpoints and test files: `python -m mamba_asr_torch.recognize
    --ckpt_dir` with --beam 100 (tokens equal to the trainer's CTC-beam
    test pass on the same averaged checkpoints), --timestamps (word times
    increase and end within each file, one encoder frame of center padding
    allowed), --streaming (transcripts reported beside the greedy ones);
    --s2s on the S2S floor run (tokens equal to its test pass's joint
    search); `python -m mamba_asr_torch.evaluate` on the CTC floor
    experiment (its test WER)."""
    from mamba_asr_torch import cli, evaluate, recognize
    from mamba_asr_torch.configs.loader import load_config, parse_overrides
    from mamba_asr_torch.data.librispeech import load_manifest
    from mamba_asr_torch.data.tokenizer import load_tokenizer
    from mamba_asr_torch.decoding.timestamps import encoder_frame_seconds
    from mamba_asr_torch.tools import train_to_floor
    from mamba_asr_torch.training import loop

    result = {"phase": "recognize_cli"}
    ctc_over = train_to_floor.ctc_overrides(corpus, os.path.join(work, "floor", "ctc"),
                                            FLOOR_EPOCHS)
    out_dir = floor_tr.cfg.output_folder
    test_csv = os.path.join(out_dir, "manifests", "test-clean.csv")
    utts = load_manifest(test_csv)
    paths = [u.path for u in utts]
    save = ["--ckpt_dir", os.path.join(out_dir, "save"), "--device", "cuda"]
    tok = floor_tr.tokenizer

    want = capture_test_pass(floor_tr, cli.eval_loader(floor_tr.cfg, test_csv, tok),
                             floor_tr.ctc_decoder())
    t0 = time.perf_counter()
    beam = cli_lines(recognize.main, [CONFIG, *paths, *save, "--beam", "100", "--batch", "8",
                                      *ctc_over])
    beam_s = time.perf_counter() - t0
    expect = [f"{u.path}\t{tok.decode(want[u.utt_id])}" for u in utts]
    if beam != expect:
        raise AssertionError(f"recognize_cli: --beam 100 lines {beam} != the test pass's "
                             f"{expect}")
    timed_lines = cli_lines(recognize.main, [CONFIG, *paths, *save, "--timestamps",
                                             *ctc_over])
    frame_s = encoder_frame_seconds(floor_tr.cfg.frontend, floor_tr.cfg.model)
    words, cur, greedy = {}, None, {}
    for line in timed_lines:
        parts = line.split("\t")
        if parts[0] in paths:
            cur = parts[0]
            greedy[cur], words[cur] = parts[1], []
        else:
            words[cur].append((float(parts[0]), float(parts[1]), float(parts[2]), parts[3]))
    for u in utts:
        w = words[u.path]
        ok = (" ".join(x[3] for x in w) == " ".join(greedy[u.path].split())
              and all(s < e for s, e, _, _ in w)
              and all(a[1] <= b[0] for a, b in zip(w, w[1:]))
              and (not w or w[-1][1] <= u.duration + frame_s))
        if not ok:
            raise AssertionError(f"recognize_cli: word times of {u.path}: {w} "
                                 f"({u.duration} s, '{greedy[u.path]}')")
    streamed = cli_lines(recognize.main, [CONFIG, *paths, *save, "--streaming", *ctc_over])
    result["ctc"] = {
        "files": len(paths), "beam_tokens_equal_test_pass": True, "beam_s": beam_s,
        "beam_transcripts": [ln.split("\t")[1] for ln in beam],
        "greedy_transcripts": [greedy[p] for p in paths],
        "streaming_transcripts": [ln.split("\t")[1] for ln in streamed],
        "streaming_equal_greedy": sum(ln.split("\t")[1] == greedy[p]
                                      for ln, p in zip(streamed, paths)),
        "words": sum(len(w) for w in words.values()),
        "last_word_end_minus_duration_s": max(
            (words[u.path][-1][1] - u.duration for u in utts if words[u.path]), default=None)}

    # --s2s on the S2S floor run (the Transformer decoder), against its
    # test pass's joint search on the same averaged checkpoints.
    epochs = s2s_floor["epochs"]
    s2s_over = [*train_to_floor.ctc_overrides(corpus, os.path.join(work, "floor", "s2s"), epochs),
                *train_to_floor.s2s_overrides(epochs)]
    s2s_cfg = load_config(S2S_CONFIG, parse_overrides(s2s_over))
    s2s_tok = load_tokenizer(os.path.join(s2s_cfg.output_folder, "tokenizer_char.json"))
    s2s_csv = os.path.join(s2s_cfg.output_folder, "manifests", "test-clean.csv")
    s2s_tr = loop.Trainer(s2s_cfg, s2s_tok, device="cuda")
    want = capture_test_pass(s2s_tr, cli.eval_loader(s2s_cfg, s2s_csv, s2s_tok),
                             s2s_tr.s2s_decoder(test=True))
    s2s_utts = load_manifest(s2s_csv)
    t0 = time.perf_counter()
    lines = cli_lines(recognize.main, [S2S_CONFIG, *[u.path for u in s2s_utts], "--s2s",
                                       "--ckpt_dir", os.path.join(s2s_cfg.output_folder, "save"),
                                       "--device", "cuda", *s2s_over])
    s2s_s = time.perf_counter() - t0
    expect = [f"{u.path}\t{s2s_tok.decode(want[u.utt_id])}" for u in s2s_utts]
    if lines != expect:
        raise AssertionError(f"recognize_cli: --s2s lines {lines} != the test pass's {expect}")
    result["s2s"] = {"files": len(lines), "tokens_equal_test_pass": True, "s": s2s_s,
                     "beam": s2s_cfg.decode.s2s_test_beam_size,
                     "transcripts": [ln.split("\t")[1] for ln in lines]}

    t0 = time.perf_counter()
    lines = cli_lines(evaluate.main, [CONFIG, *ctc_over, "--device", "cuda"])
    want_line = f"test-clean: {floor_tr.test_stats['test-clean']}"
    if lines[-1] != want_line:
        raise AssertionError(f"recognize_cli: evaluate printed {lines[-1]!r}, the floor run "
                             f"{want_line!r}")
    result["evaluate"] = {"line": lines[-1], "s": time.perf_counter() - t0}
    emit(result)
    return result


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
    s2s_search, rec8, s2s_batch = timed(phase_s2s_recognize, s2s.model, s2s.frontend,
                                        s2s_state)
    per_search = s2s_search["launches_per_search"]
    timed(phase_s2s_profile, rec8, s2s_batch)
    del rec8, s2s_batch
    timed(phase_s2s_train_parity, s2s, s2s_state)
    s2s_train_launches = timed(phase_s2s_train, s2s, s2s_state)
    mam = load_config(MAMBA_CONFIG)
    mk = timed(phase_mamba_dec_kernels, mam.model, clock_hz, sms)
    mam_state = seeded_state(mam.model)
    timed(phase_mamba_dec_parity, mam, mam_state)
    mam_search = timed(phase_mamba_dec_recognize, mam, mam_state)
    mam_train_launches = timed(phase_mamba_dec_train, mam, mam_state)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        lmk = timed(phase_lm_kernels, s2s.decode, clock_hz, sms)
        timed(phase_lm_parity, s2s, s2s_state, mam, mam_state)
        lm_search = timed(phase_lm_recognize, s2s, s2s_state, mam, mam_state, work,
                          s2s_search)
        del s2s_state
        conf = {path: load_config(path) for path in CONFORMER_CTC + CONFORMER_S2S}
        ck = timed(phase_conformer_kernels, conf[CONFORMER_S2S[1]].model, clock_hz, sms)
        conf_states = {path: seeded_state(exp.model) for path, exp in conf.items()}
        timed(phase_conformer_parity, conf, conf_states)
        conf_search = timed(phase_conformer_recognize, conf, conf_states)
        stream = timed(phase_streaming, exp, state, conf, conf_states, mam, mam_state,
                       clock_hz, sms)
        del conf_states, mam_state
        corpus = timed(phase_data, work)
        timed(phase_ctc_beam, exp)
        recipe_launches = timed(phase_recipe, work, corpus)
        floor = timed(phase_train_to_floor, work, corpus)
        timed(phase_bf16, floor)
        s2s_recipe_launches = timed(phase_s2s_recipe, work, corpus)
        s2s_floor = timed(phase_s2s_train_to_floor, work, corpus)
        mam_recipe_launches = timed(phase_mamba_dec_recipe, work, corpus)
        mam_floor_launches = timed(phase_mamba_dec_train_to_floor, work)
        lm_path = timed(phase_train_lm, work, s2s_floor)
        lm_floor_launches = timed(phase_lm_floor, work, corpus, s2s_floor, lm_path)
        timed(phase_recognize_cli, work, corpus, floor, s2s_floor)
    finally:
        shutil.rmtree(work, ignore_errors=True)

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
        "recipe_launches": recipe_launches["K1"],
        "s2s_recipe_launches": s2s_recipe_launches["K1"],
        "mamba_dec_launches_per_search": mam_search["K1"],
        "mamba_dec_recipe_launches": mam_recipe_launches["K1"],
        "mamba_dec_floor_launches": mam_floor_launches["K1"],
        "mamba_dec_prime": {key: mk["prime"][key] for key in (
            "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        "streaming_launches_per_chunk":
            stream["latency"][yaml_name(CONFIG)]["k1_launches_per_chunk"],
        **{f"streaming_{key}": stream["kernel"][key] for key in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")},
    }, {
        "name": "selective_scan_fwd_train", "route": "cuda",
        "source": "mamba_asr_torch/csrc/selective_scan_fwd.cu",
        "replaces": "mamba_asr_tpu/ops/pallas/scan.py:320",
        "launches": train_launches["K1"],
        "max_abs_err": kb["cases"][0]["chunk_states_max_abs_err"],
        "ms": fwd_train["kernel_ms"], "plain_ms": k["plain_ms"],
        "bound_ms": fwd_train["bound_ms"], "bound_by": fwd_train["bound_by"],
        "library_ms": None, "s2s_train_launches": s2s_train_launches["K1"],
        "mamba_dec_train_launches": mam_train_launches["K1"],
        "mamba_dec": {name: {"shape": mk[name]["shape"], "ms": mk[name]["fwd_train_ms"],
                             "plain_ms": mk[name]["fwd_plain_ms"],
                             "bound_ms": mk[name]["fwd_train_bound_ms"],
                             "max_abs_err": mk[name]["chunk_states_max_abs_err"]}
                      for name in ("self", "cross")},
    }, {
        "name": "selective_scan_bwd", "route": "cuda",
        "source": "mamba_asr_torch/csrc/selective_scan_bwd.cu",
        "replaces": "mamba_asr_tpu/ops/pallas/scan.py:387",
        "launches": train_launches["K2"], "max_abs_err": kb["cases"][0]["max_abs_err"],
        "ms": kb["kernel_ms"], "plain_ms": kb["plain_ms"], "bound_ms": kb["bound_ms"],
        "bound_by": kb["bound_by"], "library_ms": None, "wrapper_ms": kb["wrapper_ms"],
        "recipe_launches": recipe_launches["K2"],
        "s2s_train_launches": s2s_train_launches["K2"],
        "s2s_recipe_launches": s2s_recipe_launches["K2"],
        "mamba_dec_train_launches": mam_train_launches["K2"],
        "mamba_dec_recipe_launches": mam_recipe_launches["K2"],
        "mamba_dec_floor_launches": mam_floor_launches["K2"],
        "mamba_dec": {name: {"shape": mk[name]["shape"], "ms": mk[name]["bwd_ms"],
                             "plain_ms": mk[name]["bwd_plain_ms"],
                             "bound_ms": mk[name]["bwd_bound_ms"],
                             "max_abs_err": mk[name]["max_abs_err"]}
                      for name in ("self", "cross")},
    }, {
        "name": "ctc_dp", "route": "cuda", "source": "mamba_asr_torch/csrc/ctc_dp.cu",
        "replaces": "mamba_asr_tpu/ops/pallas/log_scan.py:75",
        "launches": per_search["K3"],
        "max_abs_err": max(c["max_abs_err"] for c in k3["cases"]),
        "ms": k3["kernel_ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": None,
        "s2s_recipe_launches": s2s_recipe_launches["K3"],
        "mamba_dec_launches_per_search": mam_search["K3"],
        "mamba_dec_recipe_launches": mam_recipe_launches["K3"],
        "conformer_launches_per_search": {
            name: e["launches_per_search"]["K3"] for name, e in conf_search["s2s"].items()},
    }, {
        "name": "beam_attention", "route": "cuda",
        "source": "mamba_asr_torch/csrc/beam_attention.cu",
        "replaces": "mamba_asr_tpu/ops/pallas/beam_attention.py:88",
        "launches": per_search["K4"],
        "max_abs_err": max(c["max_abs_err"] for c in k4["cases"]),
        "ms": k4["kernel_ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"], "library_ms": k4["library_ms"],
        "s2s_recipe_launches": s2s_recipe_launches["K4"],
        "lm_launches_per_search": lm_search["fused"]["launches_per_search"]["K4"],
        "mamba_dec_lm_launches_per_search":
            lm_search["mamba_decoder_fused"]["launches_per_search"]["K4"],
        "lm_floor_launches": lm_floor_launches["K4"],
        "lm_shape": lmk["shape"], "lm_shape_max_abs_err": max(c["max_abs_err"]
                                                              for c in lmk["cases"]),
        "lm_shape_ms": lmk["kernel_ms"], "lm_shape_plain_ms": lmk["plain_ms"],
        "lm_shape_bound_ms": lmk["bound_ms"], "lm_shape_bound_by": lmk["bound_by"],
        "lm_shape_library_ms": lmk["library_ms"],
        "lm_shape_beam_table_ms": lmk["timing"]["beam"]["kernel_ms"],
        "conformer_launches_per_search": {
            name: e["launches_per_search"]["K4"] for name, e in conf_search["s2s"].items()},
        "conformer_large_shape": ck["shape"],
        "conformer_large_shape_max_abs_err": max(c["max_abs_err"] for c in ck["cases"]),
        "conformer_large_shape_ms": ck["kernel_ms"],
        "conformer_large_shape_plain_ms": ck["plain_ms"],
        "conformer_large_shape_bound_ms": ck["bound_ms"],
        "conformer_large_shape_bound_by": ck["bound_by"],
        "conformer_large_shape_library_ms": ck["library_ms"],
        "conformer_large_shape_beam_table_ms": ck["timing"]["beam"]["kernel_ms"],
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
