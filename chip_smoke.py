#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing one JSON line (any failure raises and the script
exits non-zero; it prints no result without a CUDA card):

  build      compile the CUDA kernels from mamba_asr_torch/csrc (nvcc, sm_90a)
  peak_probe the probe (P2) against its plain loop in its three modes at
             a small size and on ragged ends (7,474 elements, a view one
             element off a 16-byte boundary, k 0, 10, 70), then the
             tools.peak_probe entry point at its defaults (B32 x 751 x
             288): the attained FFMA rate (dependent and 4 independent
             chains) and exp2 rate against the published peaks and the
             peaks at the SM clock held in one more launch; the probe
             against its plain loop again at that shape and the tool's
             two chain lengths (64, 1,024); each mode's time, plain time,
             bound and share of it at k 64, and ptxas's lines for P2
  kernel     the selective-scan kernel (K1) against its plain version on
             the card: the full-width shape in bf16, an fp32 case with h0
             in, h_last out and ragged L and D, and B1 L751 bf16; times,
             the published-peak bound and the bound at peak_probe's
             measured rates (its whole 1,024-step launches); a batch sweep (B1 to B32 at L751 bf16, each
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
             kernel; one more through utils.profile_trace, whose Chrome
             trace must parse and hold K1's kernel once per launch
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
             step's sides (the flips are reported); then one dynamic-chunk
             micro-step (chunks of 16 encoder frames, 2 of left context),
             card (cuDNN off) against CPU, held alike
  train      Trainer(device="cuda") with the YAML's settings (bf16,
             dropout 0.1, SpecAugment, accumulation 4) on B32 x 25 s of
             noise with ~300-token targets: 8 checked micro-steps, then
             training throughput (audio-s per wall-s, median of 3 blocks
             of 4 micro-steps) and peak memory; then model.remat_layers at
             the same batch in fp32 (TF32 off, dropout 0, SpecAugment off,
             `deterministic_steps`): two plain micro-steps and one with
             remat on one Trainer, the remat step's losses and
             gradients within TRAIN_GRAD_TOL and bit-equal wherever the
             plain ones agree, K1 48 and K2 24, wall ms and peak memory
             above the state of each (the remat peak must be lower)
  train_profile  one such micro-step under torch.profiler
  distributed_train  multi-process training: (a) one NCCL rank on cuda:0,
             a micro-step through the port's all-reduces against the
             plain micro-step, bit for bit where two plain ones agree;
             then 2 gloo ranks on cuda:0 (NCCL refuses two ranks on a
             card), fp32 with TF32 off, dropout 0, SpecAugment off, on
             B32 x 25 s with the last 3 rows weighted 0: (b) data
             parallel (16 and 13 real rows), (c) sequence parallel 2
             (half of T' each), (d) pipeline parallel 2
             (model.scan_layers on, 6 layers a stage, all 32 rows in
             PP_MICROBATCHES = 4 microbatches) and (e) tensor parallel 2
             (all 32 rows, each rank holding its slices of the 98
             parameters JAX's rule shards at min_shard_elements 16,384,
             the slices' gradients gathered), loss and every gradient
             held against the single-process card step as train_parity
             holds card and CPU, the gradients both ranks hold bit-equal;
             K1 and K2 per rank per micro-step (sp 48 each: 2 passes x 2
             directions x 12 layers; pp 48 each: 4 microbatches x 6 layers
             x 2 directions; tp 24 each, the scans at full width on every
             rank; against 24 unsharded); the sp, pp and tp micro-steps'
             wall ms in bf16 with the YAML's settings, as audio-s per s
             (two ranks on one card through host-staged gloo: not a
             scaling number); after the pp and tp steps' update each
             rank's parameter and AdamW moment bytes (below the whole
             model's) and peak memory; the tp ranks' gathered state
             loaded by one process, its slices bit-equal to the ranks'
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
  distributed_recipe  (after recipe) the CTC recipe at full width in
             fp32 (dropout 0, SpecAugment off, 2 epochs, batches of 6 rows:
             one bucket plan for one process and two) through
             cli.run_training(... --distributed), what `python -m
             mamba_asr_torch.train_ctc --distributed` runs, in 2 gloo
             ranks on cuda:0, against the single-process run: per-step
             losses within 1e-4, and one save dir, train_log.txt and
             wer_test-clean.txt, written by rank 0; beside it the same
             with pipeline_stages 2 (2 microbatches, scan_layers on) in 2
             more gloo ranks, held alike, and rank 0's pp checkpoint
             resumed by a single-process loop on the card
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
  conmamba_large_parity, conformer_decoder_parity  (beside the
             chains of BESIDE: they read no time) one fp32 micro-step of each ConMamba-Large YAML
             (B2 x 4 s), card against CPU as train_parity holds it; the
             Conformer decoder in fp32 (TF32 and cuDNN off), card against
             CPU: the teacher-forced seq log-probs (B2 x 4 s), the joint
             search at beam 4 on B2 x 2 s (eos banned for the first half)
             without and with a seeded full-width LM (tokens equal; K4
             only for the LM), one S2S micro-step held alike
  mamba_dec_recipe  as s2s_recipe, on hparams/S2S/conmambamamba_small.yaml
             for MAMBA_RECIPE_EPOCHS epochs (K4 must not launch)
  mamba_dec_train_to_floor  (a chain of BESIDE, in a process of its
             own; its output printed after it) tools.
             train_to_floor --mode s2s at its default
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
  train_lm   (chain s2s_floor_lm, after the S2S floor run) train_lm's
             loop at full LM width in fp32 on the 160-utterance tone
             training transcripts, vocab 5000, LM_TRAIN settings: tokens
             per s, ms per step, ppl per log line (the last below
             LM_PPL_TARGET and below half the stream's unigram ppl);
             writes lm.pt
  lm_floor   the S2S floor run (Transformer decoder) again through the CLI
             with --decode.lm_path <that lm.pt>: it resumes, only tests, and
             fuses the LM; test WER <= 2.0 % beside the WER without it
  conformer_decoder  (after lm_recognize) S2S/conmamba_small.yaml with
             model.decoder_module=conformer, seeded: bf16 searches with
             the YAML's decode stanza at B8 x 30 s (the prefix re-score),
             a first (cold) and a second search in turn: S2S RTFx of each,
             K1 24, K3 per step, K4 0
  conformer_kernels  (after conformer_decoder) K4 at the Conformer-Large
             decoder's heads (hparams/S2S/conformer_large.yaml: H 8, dh 64,
             S 320, N 528, bf16 and fp32 at pos 255 on a random and a
             beam-shaped table; bf16 at pos 1,023 on both) against its
             plain gather; time, bound, the gather + SDPA call
  conformer_parity  fp32 with TF32 and cuDNN off, seeded weights, full
             width and depth, B2 x 4 s with row 1 at 3.1 s: CTC log-probs
             of CTC/conformer_large, conformer_large_hypermixing and
             branchformer_large and of S2S/conformer_small, card against
             CPU; for S2S/conformer_small 8 decode steps through shuffled
             ancestor tables and the joint search at beam 4 (tokens equal);
             one dynamic-chunk micro-step of conformer_large, card against
             CPU, held as train_parity holds it
  conformer_recognize  bf16 through Recognizer: CTC RTFx of Conformer-Large
             at B32 x 30 s (3 blocks of 10 calls; one profiled call), one
             block each for the hypermixing and Branchformer YAMLs; S2S
             RTFx of Conformer-Small at B8 x 30 s with its decode stanza
             (beam 66, median of S2S_SEARCHES searches, K3 256 and K4 1,024
             per search, one profiled search) and one Conformer-Large
             search (K4 1,536)
  conformer_train  (after conformer_recognize) Conformer-Large CTC
             training: one fp32 micro-step (TF32 and cuDNN off, dropout 0,
             B2 x 4 s) card against CPU as train_parity holds them; 8
             micro-steps with the YAML's settings (bf16, dropout 0.1,
             SpecAugment, accumulation 4) at B32 x 25 s: finite losses,
             updates on every 4th only, audio-s per s, peak memory
  conmamba_large  (after the chains of BESIDE) CTC/conmamba_large,
             S2S/conmamba_large and S2S/conmambamamba_large, seeded: one
             bf16 recognise each as one timed block (CTC: LARGE_CTC_CALLS
             calls at B32 x 30 s after one warm-up call; S2S: a first (cold)
             and a second search at B8 x 30 s, the YAML's decode stanza,
             each timed), RTFx, launches and peak memory; then
             CTC/conmamba_large's micro-step with the YAML's settings at
             B8 x 60 s without and with model.remat_layers (twice each,
             in turn): wall ms and peak memory above the state of the
             second of each (the remat peak must be lower), K1 36 / 72
  streaming  (after conformer_train) K1 at the streaming shapes (B1
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
  serving    (after streaming) the slot-batched StreamingServer: K1 at the
             tick's shapes (B8, B32, B64 x L16 D288 N16, bf16 and fp32, h0
             in, h_last out) against its plain version, timed at B32 bf16;
             the causal fp32 ConMamba-Small of streaming in a 4-slot engine
             (TF32 off), six staggered streams of 4 to 12 s with one more
             aborted and slots reused: every transcript equal to the single
             session's and the offline greedy decode's; the same engine
             behind AsrTcpServer on 127.0.0.1 (an abandoned client, four
             concurrent 10 s clients in 320 ms sends with ids equal to the
             engine's, the full-server error, an endpoint event with the
             signal forced, the stats op); tools/bench_serving.py on the
             YAML's bf16 ConMamba-Small at 1, 8, 32, 64 slots (tick ms,
             spread, per-stream ms, capacity, K1 24 per tick, peak memory)
             and one profiled tick at 32 slots; the final passes on a 6 s
             stream (ctc_beam at beam 8 without and with a seeded
             full-width LM, s2s on S2S/conmamba_small and on the Mamba
             decoder), each equal to its search run directly on the same
             encoder output, with finish_final ms and launches; the
             multi-replica engine (`serve --data_parallel`): the exactness
             streams over 2 replicas on cuda:0, every transcript equal to
             the single engine's, K1 per steady tick twice the single
             engine's; the bf16 32-slot tick over 2 replicas (2 x 16 rows)
             against one replica, ticks in turn (one card: not a scaling
             number); `python -m mamba_asr_torch.serve --data_parallel`
             with one card more than the machine has exits naming both
  bundles    `python -m mamba_asr_torch.export_model --device cuda` of the
             seeded full-width YAMLs (bf16), the four exports in processes
             of their own at once, started beside the chains of BESIDE; after
             conformer_decoder_parity, the checks: CTC at B32 x 30 s
             (log-probs within 1e-3 of the live Recognizer's, greedy tokens
             equal, K1 24 per forward); S2S at B8 x 30 s with the decode
             stanzas, S2S/conmamba_small with the seeded LM of lm_recognize
             and the Mamba decoder without (tokens and lengths equal to the
             live searcher's on the same padded batch, K1/K3/K4 per search);
             the streaming engine of ConMamba-Small made causal and
             unidirectional at 32 slots (8 streams of 6 s: transcripts equal
             to the live engine's); export seconds, bundle sizes, each
             program's mamba_asr::* nodes
  bundles_timed  (after the chains of BESIDE) bundle against live, in turn:
             CTC wall ms (5 calls each), one S2S+LM search each, 12 steady
             ticks each at 32 slots; K1 kernel events in a profiled bundle
             CTC call and tick; the K4 op's host us per call against its
             wrapper's
  recognize_cli  (last of chain recipes, once chain s2s_floor_lm has
             ended) `python -m mamba_asr_torch.recognize` on the CTC
             floor run's test files and save dir: --beam 100 tokens equal
             to the trainer's CTC-beam test pass, --timestamps word times,
             --streaming transcripts; --s2s on the S2S floor run: tokens
             equal to its test pass; `python -m mamba_asr_torch.evaluate`
             reproduces the CTC floor's test WER; `python -m
             mamba_asr_torch.export_torch` of each floor run's save dir,
             then recognize --torch_ckpt --torch_normalizer on the export:
             the same lines as the test pass

The phases run in three stretches. Every phase that reads time runs
alone on the card, before `data` or after the chains. From `data` on,
four chains (BESIDE) run side by side in processes of their own:
`parities` (parity, train_parity, s2s_parity, s2s_train_parity,
mamba_dec_parity, lm_parity, conformer_parity), the Mamba floor run,
`s2s_floor_lm` (s2s_train_to_floor, train_lm, lm_floor) and `recipes`
(recipe, train_to_floor, bf16, s2s_recipe, mamba_dec_recipe,
recognize_cli). Beside them this process runs distributed_recipe, the
two parity phases above and `bundles`. A chain's output is printed when
it ends; the walls of its runs are those of a shared host. Each phase
also prints its wall seconds (the script's follow the phases). Then
the kernels line, the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
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
# 30 and ACC 0.93 to 0.95 from epoch 60 to 150; PR 12's 90-epoch runs test
# WER 0.00; 60 epochs read test WER 2.00, at the limit, in PR 13).
MAMBA_CONFIG = "hparams/S2S/conmambamamba_small.yaml"
MAMBA_SEARCH = (8, 66)
MAMBA_TRAIN_S = 81
MAMBA_FLOOR_EPOCHS = 30
MAMBA_FLOOR_CORPUS = (160, 16, 16)
# Timed searches of s2s_recognize, mamba_dec_recognize and
# conformer_recognize (5 until the LM's phases joined the script, 3 until
# the other encoders' did).
S2S_SEARCHES = 1  # 2 until multi-process training joined the script
# The LM (slice 3b item 4): the timed fused searches at B8 x 30 s, the
# LM's training run on the 160-utterance tone transcripts (at full width,
# vocab 5000, fp32; the JAX script's flags but steps, batch and logging)
# and its criterion (the char tokenizer uses 11 of the 5000 ids). The
# warmup is the script's 4000: with 50 to 300 steps of warmup (peak lr
# 1e-3 or 1e-4) the 12 post-LN layers stayed at the unigram ppl ~8.8 for
# 300 steps on an H100, with 4000 they reached ppl ~3. 900 steps bring the
# tone floor run's held-out transcripts to ppl ~1.2 (300: ~2.8, an LM that
# still turned one test word of that run from AB into FAB).
LM_SEARCHES = 1  # 3 until the other encoders' phases joined, 2 until multi-process training
LM_TRAIN = dict(steps=900, batch_size=16, seq_len=128, lr=1e-3, warmup=4000,
                log_every=100, save_every=900)
LM_PPL_TARGET = 10.0
LM_PPL_OF_UNIGRAM = 0.5  # and below half the stream's unigram ppl
# The other encoders (slice 4 item 1): the CTC YAMLs (Conformer-Large with
# RelPosMHAXL and with hypermixing, Branchformer-Large) and the Conformer
# S2S YAMLs (Small and Large, the Transformer decoder). The CTC RTFx
# blocks: CONFORMER_CTC_BLOCKS of 10 calls for Conformer-Large, one block
# each for the others.
CONFORMER_CTC = ("hparams/CTC/conformer_large.yaml",
                 "hparams/CTC/conformer_large_hypermixing.yaml",
                 "hparams/CTC/branchformer_large.yaml")
CONFORMER_S2S = ("hparams/S2S/conformer_small.yaml", "hparams/S2S/conformer_large.yaml")
CONFORMER_CTC_BLOCKS = 3  # Conformer-Large's timed blocks (5 until multi-process training)
STREAM_CHUNK_FRAMES = 64  # recognize --chunk_frames: 640 ms of audio per feed
# Total fbank frames of the causal parity streams: 3,000 is a multiple of
# the front end's 4, 2,999 and 2,997 take the canonical padding's odd
# branches.
STREAM_PARITY_FRAMES = (3000, 2999, 2997)
STREAM_ENCODER_FRAMES = 600  # the card-vs-CPU streams' fbank frames (6 s)
# Dynamic-chunk training's check (train_parity, conformer_parity): chunks of
# 16 encoder frames (640 ms) with 2 of left context; 4 s rows give 101
# frames, so the last chunk is partial.
DYNCHUNK = (16, 2)
# Serving (phase serving): K1 at the tick's batch; the exactness streams
# (fp32, causal, SERVING_EXACT_SLOTS slots) with one more stream aborted
# mid-flight; bench_serving's sweep at the YAML's bf16; the final passes'
# stream; the TCP clients (count, seconds each, seconds per send).
SERVING_K1_SLOTS = (8, 32, 64)
SERVING_EXACT_SLOTS = 4
SERVING_REPLICAS = 2  # the multi-replica engine's replicas, all on cuda:0
SERVING_STREAMS_S = (4.0, 12.0, 7.0, 10.0, 5.0, 9.0)
SERVING_SLOTS = (1, 8, 32, 64)
SERVING_TICKS = 12
SERVING_PROFILE_SLOTS = 32
SERVING_FINAL_S = 6.0
SERVING_CTC_BEAM = 8
SERVING_TCP = (4, 10.0, 0.32)
SERVING_ENDPOINT_S = 1.5
# Multi-process training (distributed_train, distributed_recipe): 2 ranks on
# cuda:0 over gloo; the global batch B32 x TRAIN_SECONDS with its last 3 rows
# weighted 0 (the data ranks hold 16 and 13 real rows); timed bf16 sp
# micro-steps per rank; each spawn's timeout (also the process group's);
# the recipe's epochs, rows per batch (an even plan, so one process and
# two load the same batches) and the loss tolerance (the card's CTC
# backward adds with atomics).
DIST_BATCH = 32
DIST_PAD_ROWS = 3
DIST_TIMED_STEPS = 3
DIST_TIMEOUT_S = 300
DIST_RECIPE_EPOCHS = 2
DIST_MAX_BATCH_EX = 6
DIST_RECIPE_RTOL = 1e-4
# The pp recipe run's microbatches (3 rows each of a 6-row batch) and the
# relative norm within which each tensor of its resumed checkpoint meets
# the single-process run's: the Adam steps carry each run's rounding, which
# biases that start at zero feel most (a CPU rehearsal at d_model 16 read
# 2.2e-3 on a front-end norm's after 18 steps; the card 4.4e-3 after 18
# and 7.1e-3 after 12, on layer 0's FFN LayerNorm bias); a layer in
# another's place is off by O(1).
DIST_RECIPE_MICROBATCHES = 2
DIST_RESUME_RTOL = 5e-2
PP_MICROBATCHES = 4  # the pp step's microbatches per rank: 8 rows each of dist_batch
TP_ACCUMULATION = 2  # the tp bf16 steps' accumulation: one warm and one timed micro-step
# Conformer-Large training (conformer_train): micro-steps at the YAML's settings.
CONFORMER_TRAIN_STEPS = 8
# The Mamba floor run's timeout in its process beside the S2S floor run.
FLOOR_BESIDE_TIMEOUT_S = 600
# The Conformer decoder (no YAML sets it).
CONFORMER_DECODER = {"model.decoder_module": "conformer"}
PARITY_BEAM = 4  # conformer_decoder_parity's searches, card against CPU
# ... on a 2 s batch with eos banned for the first half of its 51 steps: the
# seeded decoders would otherwise end their best hypotheses at once.
PARITY_MIN_DECODE_RATIO = 0.5
CONMAMBA_LARGE = ("hparams/CTC/conmamba_large.yaml", "hparams/S2S/conmamba_large.yaml",
                  "hparams/S2S/conmambamamba_large.yaml")
LARGE_REMAT_BATCH = (8, 60.0)  # the Large remat pair's B8 x 60 s
LARGE_CTC_CALLS = 10  # the CTC Large YAML's one timed block


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
    the S2S search's profile take 67 s instead of 22 s on an H100 host. The
    device events are summed straight from the trace
    (`tools/timing.py:device_kernel_times`), not through
    `key_averages`, whose event tree is the slow part of a long trace."""
    from torch.profiler import ProfilerActivity, profile

    from mamba_asr_torch.tools.timing import device_kernel_times

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(us, name, calls) for name, (us, calls) in device_kernel_times(prof).items()]
    if not rows:
        raise AssertionError("the profile recorded no device time")
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    return wall_ms, total_ms, [{"kernel": k[:80], "ms": us / 1e3, "calls": c}
                               for i, (us, k, c) in enumerate(rows)
                               if i < top or any(name in k for name in named)]


def phase_profile(rec32, batch):
    """One B32 x 30 s forward under device_profile, then one more through
    the public hook `utils.profile_trace`: its Chrome trace parses and
    holds K1's kernel once per launch of that forward."""
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.utils import profile_trace
    from mamba_asr_torch.utils.profiling import TRACE_FILE

    wav = torch.from_numpy(np.stack(batch))
    lens = torch.full((32,), 480000, dtype=torch.int32)
    wall_ms, total_ms, top = device_profile(lambda: rec32.eval_step(wav, lens), 12)
    logdir = tempfile.mkdtemp(prefix="profile_trace_")
    try:
        kernel.LAUNCHES = 0
        with profile_trace(logdir):
            rec32.eval_step(wav, lens)
        launches = kernel.LAUNCHES
        path = os.path.join(logdir, TRACE_FILE)
        trace_mb = os.path.getsize(path) / 1e6
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    k1_events = sum(e.get("cat") == "kernel" and "fwd_kernel" in e.get("name", "")
                    for e in events)
    if launches != 2 * rec32.model.cfg.num_encoder_layers or k1_events != launches:
        raise AssertionError(f"profile_trace: {k1_events} K1 kernel events for {launches} "
                             "launches")
    emit({"phase": "profile", "wall_ms": wall_ms, "device_kernel_ms": total_ms,
          "top": top, "profile_trace": {"events": len(events), "k1_kernel_events": k1_events,
                                        "mb": trace_mb}})


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
# P2's ragged cases, each mode: (name, shape, k, storage offset). 2 x 37 x
# 101 = 7,474 elements end in a partial float4; an offset of one element
# puts x off a 16-byte boundary, so the kernel's head and tail both run.
PROBE_RAGGED = (("ragged", (2, 37, 101), 64, 0), ("offset", (2, 37, 101), 64, 1),
                ("k0", (2, 37, 101), 0, 1), ("k10", (2, 37, 101), 10, 1),
                ("k70", (2, 37, 101), 70, 0))


def phase_peak_probe(clock_hz, sms):
    from mamba_asr_torch.kernels import build
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
    # The ragged ends: a numel that is no multiple of 4, a view off a
    # 16-byte boundary (x.flatten()[1:]), k 0, 10 and 70 (a block of 64
    # steps and a remainder).
    for name, shape, k, offset in PROBE_RAGGED:
        whole = tool.probe_input(*shape, SEED + 11, "cuda").flatten()
        x = whole[offset:]
        if offset and x.data_ptr() % 16 == 0:
            raise AssertionError(f"peak_probe {name}: the view is 16-byte aligned")
        for mode in MODES:
            got = p2.peak_probe(x, k, mode)
            torch.cuda.synchronize()
            errs[f"{name}_{mode}"] = check_close(f"peak_probe {name} {mode} k {k}", got,
                                                 peak_probe_ref(x, k, mode), *PROBE_TOL)
    # The entry point, at its defaults (the scan's B32 x 751 x 288, k 64 and 1024).
    p2.LAUNCHES = 0
    records = tool.run(MODES)
    launches = p2.LAUNCHES
    if launches == 0:
        raise AssertionError("the peak_probe tool launched no probe kernel")
    if not all(r["finite"] for r in records):
        raise AssertionError(f"peak_probe produced non-finite values: {records}")
    by_mode = {r["mode"]: r for r in records}
    # The tool's own input and chain lengths, against the plain loop: each
    # thread of the persistent grid walks several float4s here.
    x = tool.probe_input(32, 751, 288, tool.SEED, "cuda")
    main_errs = {}
    for mode in MODES:
        for k in (64, 64 * tool.K2_PER_K):
            got = p2.peak_probe(x, k, mode)
            torch.cuda.synchronize()
            main_errs[f"{mode}_k{k}"] = check_close(
                f"peak_probe {mode} k {k} at {tuple(x.shape)}", got,
                peak_probe_ref(x, k, mode), *PROBE_TOL)
    # K1's second bound takes each rate from the whole 1,024-step launch:
    # at k 64 the FMA launches are bound by their stream, and the per-step
    # difference would take the stream's time away too.
    whole = {m: r["whole_k2"] for m, r in by_mode.items()}
    flop_per_s = 1e12 * max(whole[m]["attained_tflops"] for m in ("dependent", "independent"))
    result = {"phase": "peak_probe", "name": "peak_probe", "records": records,
              "ptxas": [ln.strip() for ln in build.build_log("peak_probe").splitlines()
                        if "peak_probe" in ln or "registers" in ln or "spill" in ln],
              "small_max_abs_err": errs, "main_max_abs_err": main_errs,
              "max_abs_err": max(list(errs.values()) + list(main_errs.values())),
              "tol": PROBE_TOL, "launches": launches,
              "held_clock_mhz": {m: r["held_clock_mhz"] for m, r in by_mode.items()},
              "bound_share": {m: r["bound_share"] for m, r in by_mode.items()},
              "by_mode": {m: dict(zip(("bound_ms", "bound_by"),
                                      tool.probe_bound_ms(x.numel(), 64, m, clock_hz, sms)),
                              ms=r["ms"],
                              plain_ms=cuda_ms(lambda: peak_probe_ref(x, 64, m), 5))
                          for m, r in by_mode.items()},
              "rates": (whole["exp2"]["attained_exp2_per_s"], flop_per_s)}
    dep = result["by_mode"]["dependent"]
    result.update(ms=dep["ms"], plain_ms=dep["plain_ms"], bound_ms=dep["bound_ms"],
                  bound_by=dep["bound_by"], library_ms=None)
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


@torch.enable_grad()  # conformer_parity runs under no_grad
def dynchunk_parity(name, exp, state):
    """One dynamic-chunk micro-step (train.dynchunk_size, dynchunk_left_context
    = DYNCHUNK) of `exp`'s model, fp32 with TF32 and cuDNN off, dropout 0,
    SpecAugment off, on train_parity's B2 x 4 s batch: the card against the
    CPU, held as train_parity holds the full pass (card_vs_cpu)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(exp.model, compute_dtype="float32", dropout=0.0)
    spec = dataclasses.replace(exp.specaug, enabled=False)
    dyn = dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, dynchunk_size=DYNCHUNK[0], dynchunk_left_context=DYNCHUNK[1]))
    batch = char_batch(2, 4.0, 20, 3, exp.model.vocab_size)
    runs = {}
    for dev in ("cuda", "cpu"):
        torch.backends.cudnn.enabled = dev != "cuda"
        runs[dev] = dict(zip(("losses", "grads"),
                             step_grads(dyn, spec, cfg32, state, batch, dev)[:2]))
    torch.backends.cudnn.enabled = True
    torch.backends.cudnn.allow_tf32 = True  # back to PyTorch's defaults
    loss_errs, worst, worst_name = card_vs_cpu(name, runs["cuda"], runs["cpu"])
    return {"chunk_size": DYNCHUNK[0], "left_context_chunks": DYNCHUNK[1],
            "loss_cuda": runs["cuda"]["losses"]["loss"], "loss_cpu": runs["cpu"]["losses"]["loss"],
            "loss_rel_err": loss_errs["loss"],
            "params": len(runs["cpu"]["grads"]), "grad_max_rel_err": worst,
            "grad_worst_param": worst_name}


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
                            "K2": 2 * cfg32.num_encoder_layers},
          "dynchunk": dynchunk_parity("train_parity dynchunk", exp, state)})


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
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    remat = remat_pair(exp, state, batch)
    launches["remat"] = remat["launches"]
    emit({"phase": "train", "batch": 32, "seconds_each": TRAIN_SECONDS,
          "audio_s_per_step": audio, "micro_steps": steps,
          "checked_seconds": seconds, "launches": launches,
          "accumulation": k, "compute_dtype": cfg.compute_dtype,
          "dropout": cfg.dropout, "specaug": exp.specaug.enabled,
          "throughput": {"audio_s_per_s": rate, "blocks": blocks,
                         "spread_pct": 100.0 * (max(blocks) - min(blocks)) / rate,
                         "micro_steps_per_block": 4},
          "max_memory_allocated_gb": peak_gb, "remat": remat})
    return launches, tr, batch


def remat_steps(exp, state, batch, order, cfg=None, spec=None):
    """Micro-steps of one Trainer (`cfg`, `spec`: exp's by default) on
    `batch`, with model.remat_layers set per step as `order` says. Only the
    first step updates the normaliser and the accumulation is longer than
    the steps, so every step sees the same weights and inputs. Per step: (wall
    ms, the peak memory above what was allocated before it in GB, its K1
    and K2 launches, its losses, its gradients)."""
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.training.trainer import Trainer

    train = dataclasses.replace(exp.train, grad_accumulation_factor=len(order) + 1)
    tr = Trainer(cfg or exp.model, exp.frontend, train, spec or exp.specaug,
                 state_dict=state, device="cuda")
    runs = []
    for i, remat in enumerate(order):
        tr.model.encoder.remat = remat
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        m = tr.train_step(batch, update_norm=i == 0)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        if bool(m["updated"]):
            raise AssertionError("remat steps: the parameters changed between steps")
        runs.append((wall_ms, (torch.cuda.max_memory_allocated() - base) / 1e9,
                     {"K1": kernel.LAUNCHES, "K2": kernel.BWD_LAUNCHES},
                     [m[k] for k in m if k.startswith("loss")],
                     [p.grad.detach().clone() for p in tr.model.parameters()]))
    del tr
    return runs


def remat_pair(exp, state, batch):
    """ConMamba-Small at `batch` (B32 x 25 s) in fp32 (TF32 off, dropout 0,
    SpecAugment off), under `deterministic_steps`: a plain micro-step, a
    second plain one and one with model.remat_layers, on one Trainer with
    the same weights. The remat step's losses and gradients within
    TRAIN_GRAD_TOL of the plain step's and bit-equal wherever the two
    plain steps agree; K1 twice per scan (forward and recompute), K2 once;
    the wall ms and the peak memory above the state of the second plain
    step and of the remat step (the first plain one pays the cold start)."""
    cfg32, spec = fp32_step_setup(exp)
    with deterministic_steps():
        runs = remat_steps(exp, state, batch, (False, False, True), cfg32, spec)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    (first_ms, _, plain_launches, ref_l, ref), (plain_ms, plain_gb, _, rep_l, repeat), \
        (ms, gb, launches, got_l, got) = runs
    per_step = scans_per_step(cfg32)
    if plain_launches != {"K1": per_step, "K2": per_step} or \
            launches != {"K1": 2 * per_step, "K2": per_step}:
        raise AssertionError(f"remat: launches {launches}, plain {plain_launches}")
    for a, b in zip(got_l, ref_l):
        if not abs(a.item() - b.item()) <= TRAIN_LOSS_RTOL * abs(b.item()):
            raise AssertionError(f"remat: loss {a.item()} against {b.item()}")
    worst = 0.0
    for a, b in zip(got, ref):
        scale = b.abs().max().item()
        err = check_close("remat grad", a, b, TRAIN_GRAD_TOL[1] * scale, TRAIN_GRAD_TOL[0])
        worst = max(worst, err / max(scale, 1e-30))
    values, equal, off = bitwise_beyond_repeat("remat", ref_l + ref, rep_l + repeat,
                                               got_l + got)
    if not plain_gb > gb:
        raise AssertionError(f"remat: peak {gb} GB not below the plain step's {plain_gb} GB")
    return {"batch": 32, "seconds_each": TRAIN_SECONDS, "compute_dtype": "float32",
            "first_plain_wall_ms": first_ms,
            "plain": {"wall_ms": plain_ms, "peak_above_state_gb": plain_gb},
            "remat": {"wall_ms": ms, "peak_above_state_gb": gb}, "launches": launches,
            "grad_max_rel_err": worst, "values": values, "bitwise_equal": equal,
            "max_abs_diff": off, "note": "CTC on the CPU and cuDNN deterministic "
            "(deterministic_steps) in all three steps; TF32 off"}


def phase_train_profile(tr, batch):
    wall_ms, total_ms, top = device_profile(lambda: tr.train_step(batch), 15)
    emit({"phase": "train_profile", "wall_ms": wall_ms, "device_kernel_ms": total_ms,
          "idle_share": 1.0 - total_ms / wall_ms, "top": top})


# -- multi-process training (distributed_train, distributed_recipe) -----------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class RankGroup:
    """`nproc` ranks of `python chip_smoke.py --rank-worker kind work ...`,
    all on cuda:0 over gloo (MASR_BACKEND: NCCL refuses two ranks on one
    card), each in a session of its own, started at once so that the
    caller can work beside them. `wait()` fails the phase, killing every
    rank's process group, when a rank fails or DIST_TIMEOUT_S passes,
    with the ranks' logs; `kill()` ends them."""

    def __init__(self, kind, work, nproc=2, args=(), timeout=None, threads=None):
        env = {k: v for k, v in os.environ.items() if not k.startswith("MASR_")}
        # the host's cores split between the ranks and this process, which
        # works beside them (torchrun gives each rank 1), unless `threads`
        threads = threads or max(1, (os.cpu_count() or 1) // (nproc + 1))
        env.update(MASR_COORDINATOR=f"localhost:{free_port()}", MASR_NUM_PROCESSES=str(nproc),
                   MASR_BACKEND="gloo", MASR_TIMEOUT_S=str(DIST_TIMEOUT_S),
                   OMP_NUM_THREADS=str(threads))
        self.kind, self.logs, self.procs = kind, [], []
        self.timeout = DIST_TIMEOUT_S if timeout is None else timeout
        self.t0 = time.perf_counter()
        # phase and recipe groups run side by side
        label = args[0] if kind in ("phase", "recipe") else kind
        for rank in range(nproc):
            path = os.path.join(work, f"{label}_rank{rank}.log")
            self.logs.append(path)
            with open(path, "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank-worker", kind, work,
                     *args], env={**env, "MASR_PROCESS_ID": str(rank)}, stdout=log,
                    stderr=subprocess.STDOUT, start_new_session=True))

    def kill(self):
        import signal

        for p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()

    def wait(self) -> float:
        """The ranks' wall seconds from their start, once all exited 0."""
        try:
            deadline = self.t0 + self.timeout
            while True:  # the first rank to fail ends every rank
                codes = [p.poll() for p in self.procs]
                failed = [f"rank {r} exited {c}" for r, c in enumerate(codes)
                          if c not in (None, 0)]
                if failed or all(c == 0 for c in codes):
                    break
                if time.perf_counter() > deadline:
                    failed = [f"timed out after {self.timeout} s"]
                    break
                time.sleep(0.2)
        finally:
            self.kill()
        if failed:
            tails = []
            for rank, path in enumerate(self.logs):
                with open(path) as f:
                    tails.append(f"--- rank {rank}\n" + f.read()[-3000:])
            raise AssertionError(f"{self.kind}: {', '.join(failed)}\n" + "\n".join(tails))
        return time.perf_counter() - self.t0


PARENT_IDLE = "parent_idle"  # written by the parent once its own card work is done


def wait_for_file(path, timeout):
    deadline = time.perf_counter() + timeout
    while not os.path.exists(path):
        if time.perf_counter() > deadline:
            raise TimeoutError(f"{path} did not appear within {timeout} s")
        time.sleep(0.1)


def dist_batch(vocab):
    """The global batch of the multi-process checks: B32 x 25 s with the
    last DIST_PAD_ROWS rows weighted 0, so the 2 data ranks hold 16 and 13
    real rows."""
    batch = char_batch(DIST_BATCH, TRAIN_SECONDS, 300, 4, vocab)
    batch["weight"][-DIST_PAD_ROWS:] = 0.0
    return batch


def fp32_step_setup(exp):
    """train_parity's fp32 settings: TF32 off, dropout 0, SpecAugment off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return (dataclasses.replace(exp.model, compute_dtype="float32", dropout=0.0),
            dataclasses.replace(exp.specaug, enabled=False))


def worker_steps(work):
    """One rank of distributed_train's steps, on cuda:0 over gloo: gloo's
    all_reduce, broadcast and all_gather on CUDA tensors; the dp step (its
    16 rows of dist_batch), the sp 2 step (all 32 rows, half of T' each),
    the pp 2 step (all 32 rows in PP_MICROBATCHES microbatches, 6 of the 12
    layers each, `model.scan_layers` on) and the tp 2 step (all 32 rows,
    this rank's slices of the parameters JAX's rule shards at the YAML's
    min_shard_elements) in fp32, each's loss and gradients (this rank's
    parameters; under tp the slices gathered whole) saved for the parent;
    K1 and K2 launches of each micro-step; the wall ms of sp 2, pp 2 and
    tp 2 micro-steps with the YAML's settings (bf16, dropout, SpecAugment),
    and after the pp and tp ones (an update each) this rank's parameter and
    AdamW moment bytes on the card and its peak memory; after the tp ones
    the gathered model and optimizer state (rank 0) and each rank's own
    slices, for the parent's one-process load."""
    import torch.distributed as dist

    from mamba_asr_torch.configs.loader import load_config
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.parallel import distributed
    from mamba_asr_torch.parallel.mesh import make_mesh
    from mamba_asr_torch.training.trainer import Trainer

    rt = distributed.initialize(device="cuda:0")
    dev, rank = rt.device, rt.rank
    probe = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(probe)
    sent = torch.full((3,), float(rank + 7), device=dev)
    dist.broadcast(sent, src=0)
    rows = [torch.empty(2, device=dev) for _ in range(2)]
    dist.all_gather(rows, torch.full((2,), float(rank), device=dev))
    if not (torch.all(probe == 3.0) and torch.all(sent == 7.0)
            and torch.equal(torch.stack(rows).cpu(), torch.tensor([[0.0, 0.0], [1.0, 1.0]]))):
        raise AssertionError(f"gloo on {dev}: all_reduce {probe.tolist()}, broadcast "
                             f"{sent.tolist()}, all_gather {[r.tolist() for r in rows]}")
    exp = load_config(CONFIG)
    state = seeded_state(exp.model)
    cfg32, spec = fp32_step_setup(exp)
    batch = dist_batch(exp.model.vocab_size)
    out = {"backend": rt.backend, "device": str(dev)}

    def step(mesh, rows, name):
        cfg = dataclasses.replace(cfg32, scan_layers=mesh.pipe.size > 1)
        tr = Trainer(cfg, exp.frontend, exp.train, spec, state_dict=state, device=dev,
                     mesh=mesh, microbatches=PP_MICROBATCHES)
        kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
        m = tr.train_step({k: v[rows] for k, v in batch.items()})
        torch.cuda.synchronize()
        out[name] = {"losses": {k: v.item() for k, v in m.items() if k.startswith("loss")},
                     "launches": {"K1": kernel.LAUNCHES, "K2": kernel.BWD_LAUNCHES},
                     "real_rows": float(batch["weight"][rows].sum())}
        grads = {n: p.grad.detach() for n, p in tr.model.named_parameters() if not p.is_meta}
        if tr.tp is not None:  # the slices made whole (collective)
            out[name]["sharded"] = len(tr.tp.shards)
            grads = tr.tp.gather_state(grads, dev)
        torch.save({n: g.cpu() for n, g in grads.items()},
                   os.path.join(work, f"{name}_grads_rank{rank}.pt"))

    dp, sp, pp = make_mesh(data=2), make_mesh(seq=2), make_mesh(pipe=2)
    tp = make_mesh(model=2)
    half = DIST_BATCH // dp.data.size
    step(dp, slice(dp.data.index * half, (dp.data.index + 1) * half), "dp")
    step(sp, slice(None), "sp")
    step(pp, slice(None), "pp")
    step(tp, slice(None), "tp")
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default
    torch.backends.cudnn.allow_tf32 = True
    tr = Trainer(exp.model, exp.frontend, exp.train, exp.specaug, state_dict=state, device=dev,
                 mesh=sp)
    # The timed block waits until the parent's own steps on the card are done.
    t0 = time.perf_counter()
    wait_for_file(os.path.join(work, PARENT_IDLE), DIST_TIMEOUT_S)
    distributed.barrier("parent idle")
    waited_s = time.perf_counter() - t0
    tr.train_step(batch)  # warm
    walls = []
    for _ in range(DIST_TIMED_STEPS):
        torch.cuda.synchronize()
        distributed.barrier("timed step")
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        if not np.isfinite(m["loss"].item()):
            raise AssertionError(f"sp bf16 step: loss {m['loss'].item()}")
    out["sp_bf16"] = {"wall_ms": walls, "waited_for_parent_s": waited_s,
                      "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del tr
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(dataclasses.replace(exp.model, scan_layers=True), exp.frontend, exp.train,
                 exp.specaug, state_dict=state, device=dev, mesh=pp,
                 microbatches=PP_MICROBATCHES)
    tr.train_step(batch)  # warm
    walls = []
    for _ in range(DIST_TIMED_STEPS):  # with the warm step: one update at accumulation 4
        torch.cuda.synchronize()
        distributed.barrier("timed step")
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        if not np.isfinite(m["loss"].item()):
            raise AssertionError(f"pp bf16 step: loss {m['loss'].item()}")
    if tr.optimizer.gradient_step != 1:
        raise AssertionError(f"pp bf16: {tr.optimizer.gradient_step} updates, want 1")

    def held_bytes(tr):
        opt = tr.optimizer
        moments = [v for st in opt.optimizer.state.values() for v in st.values()
                   if torch.is_tensor(v) and v.is_cuda]
        return {"max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                "param_bytes": sum(p.numel() * p.element_size() for p in tr.model.parameters()
                                   if not p.is_meta),
                "moment_bytes": sum(v.numel() * v.element_size() for v in moments),
                "accumulator_bytes": sum(a.numel() * a.element_size() for a in opt.acc),
                "whole_model_param_bytes": sum(v.numel() * v.element_size()
                                               for v in tr.model_state().values()
                                               if v.is_floating_point())}

    out["pp_bf16"] = {"wall_ms": walls, "stage_layers": list(tr.stage), **held_bytes(tr)}
    del tr
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    # Accumulation TP_ACCUMULATION: the warm step and the timed ones make one
    # update (the moments exist), in few of tp's slow host-staged steps.
    tr = Trainer(exp.model, exp.frontend,
                 dataclasses.replace(exp.train, grad_accumulation_factor=TP_ACCUMULATION),
                 exp.specaug, state_dict=state, device=dev, mesh=tp,
                 min_shard_elements=exp.parallel.min_shard_elements)
    tr.train_step(batch)  # warm
    walls = []
    for _ in range(TP_ACCUMULATION - 1):
        torch.cuda.synchronize()
        distributed.barrier("timed step")
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        if not np.isfinite(m["loss"].item()):
            raise AssertionError(f"tp bf16 step: loss {m['loss'].item()}")
    if tr.optimizer.gradient_step != 1:
        raise AssertionError(f"tp bf16: {tr.optimizer.gradient_step} updates, want 1")
    out["tp_bf16"] = {"wall_ms": walls, "sharded": len(tr.tp.shards), **held_bytes(tr)}
    # The whole state in a single process's layout (collective), and this
    # rank's own slices and moments, for the parent's one-process load.
    whole = {"model": tr.model_state(), "optimizer": tr.optimizer_state()}
    if rank == 0:
        torch.save(whole, os.path.join(work, "tp_state.pt"))
    torch.save({"params": {n: p.detach().cpu() for n, p in tr.model.named_parameters()},
                "moments": {n: {k: v.cpu() for k, v in st.items()}
                            for n, st in tr.optimizer.state_dict()["moments"].items()}},
               os.path.join(work, f"tp_local_rank{rank}.pt"))
    with open(os.path.join(work, f"steps_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown()


def worker_recipe(work, label, argv_json):
    """One rank of distributed_recipe's `label` run: `cli.run_training(argv
    + --distributed)`, what `python -m mamba_asr_torch.train_ctc` runs,
    with TF32 off; rank 0 writes its per-step losses to
    <label>_losses.json and the whole model's final state (gathered over
    the stages under pp) to <label>_state.pt."""
    from mamba_asr_torch.cli import run_training
    from mamba_asr_torch.parallel import distributed

    torch.backends.cudnn.allow_tf32 = False
    with open(argv_json) as f:
        argv = json.load(f)
    tr = run_training(argv + ["--distributed"])
    state = tr.step.model_state()  # collective under pp
    if distributed.is_main_process():
        torch.save(state, os.path.join(work, f"{label}_state.pt"))
        with open(os.path.join(work, f"{label}_losses.json"), "w") as f:
            json.dump({"loss": tr.loss_history, "test": tr.test_stats}, f)
    distributed.shutdown()


def rank_worker(argv) -> int:
    kind, work = argv[0], argv[1]
    if kind == "steps":
        worker_steps(work)
    elif kind == "recipe":
        worker_recipe(work, argv[2], argv[3])
    elif kind == "phase":  # a phase in a process of its own (`join_phase`)
        result = timed(globals()["phase_" + argv[2]], work)
        path = os.path.join(work, f"{argv[2]}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(result, f)
        os.replace(path + ".tmp", path)  # whole when it appears: another phase may wait for it
    else:
        raise ValueError(f"no rank worker {kind!r}")
    return 0


def join_phase(group, work, name, beside):
    """Wait for the phase `name` that `group` runs in a process of its own
    (beside the phase `beside` of this process), print its output here,
    and return its result."""
    t0 = time.perf_counter()
    group.wait()
    with open(group.logs[0]) as f:
        sys.stdout.write(f.read())
    emit({"phase_beside": name, "beside": beside, "waited_s": time.perf_counter() - t0})
    with open(os.path.join(work, f"{name}.json")) as f:
        return json.load(f)


def join_beside(groups, work, beside):
    """Wait for every phase group of `groups` ({phase name: RankGroup})
    together, joining each (`join_phase`) as it ends, so that the first to
    fail ends them all. Returns {phase name: result}."""
    results, pending = {}, dict(groups)
    try:
        while pending:
            for name, group in list(pending.items()):
                late = time.perf_counter() > group.t0 + group.timeout
                if late or all(p.poll() is not None for p in group.procs):
                    del pending[name]
                    results[name] = join_phase(group, work, name, beside)
            time.sleep(0.2)
    except BaseException:
        for group in groups.values():
            group.kill()
        raise
    return results


class deterministic_steps:
    """Within the block a micro-step on the card repeats bit for bit: the
    CTC loss runs on the CPU (the card's CTC backward adds with atomics)
    and cuDNN is deterministic."""

    def __enter__(self):
        import torch.nn.functional as F

        from mamba_asr_torch.ops import ctc

        def cpu_nll(log_probs, labels, input_lengths, label_lengths, blank_id, zero_infinity):
            nll = F.ctc_loss(log_probs.float().cpu().transpose(0, 1), labels.long().cpu(),
                             input_lengths.long().cpu(), label_lengths.long().cpu(),
                             blank=blank_id, reduction="none", zero_infinity=zero_infinity)
            return nll.to(log_probs.device)

        self.saved = ctc._nll, torch.backends.cudnn.deterministic
        ctc._nll, torch.backends.cudnn.deterministic = cpu_nll, True
        return self

    def __exit__(self, *exc):
        from mamba_asr_torch.ops import ctc

        ctc._nll, torch.backends.cudnn.deterministic = self.saved
        return False


def bitwise_beyond_repeat(name, ref, repeat, got):
    """Hold `got` (tensors) against `ref` wherever two plain runs (`ref`,
    `repeat`) agree bit for bit: no value may be further from ref than the
    plain repeat is. Returns (values, values equal, max |got - ref|)."""
    flat = [torch.cat([t.reshape(-1).float() for t in ts]) for ts in (ref, repeat, got)]
    spread = (flat[0] - flat[1]).abs()
    off = (flat[2] - flat[0]).abs()
    if bool((off > spread).any()):
        raise AssertionError(f"{name}: {int((off > spread).sum())} values off the plain step "
                             "beyond its own repeat")
    return int(spread.numel()), int((off == 0).sum()), float(off.max())


def world_of_one_nccl(exp, state):
    """(a) One NCCL rank on cuda:0: a mesh micro-step, through the port's
    all-reduces, against the plain micro-step, bit for bit wherever two
    plain micro-steps agree bit for bit (`deterministic_steps`)."""
    from mamba_asr_torch.parallel import distributed
    from mamba_asr_torch.parallel.mesh import make_mesh
    from mamba_asr_torch.training.trainer import Trainer

    cfg32, spec = fp32_step_setup(exp)
    batch = char_batch(4, 4.0, 20, 3, exp.model.vocab_size)
    batch["weight"][-1] = 0.0
    rt = distributed.initialize(f"localhost:{free_port()}", 1, 0, backend="nccl",
                                device="cuda:0", timeout_s=DIST_TIMEOUT_S)
    try:
        runs = []
        for grid in (None, None, make_mesh()):
            tr = Trainer(cfg32, exp.frontend, exp.train, spec, state_dict=state,
                         device="cuda", mesh=grid)
            with deterministic_steps():
                m = tr.train_step(batch)
            runs.append(([m[k] for k in ("loss", "loss_ctc", "grad_norm")]
                         + [p.grad.detach().clone() for p in tr.model.parameters()]
                         + list(tr.normalizer)))
        used = grid.world.group is not None
    finally:
        distributed.shutdown()
    if not used:
        raise AssertionError("world-1 nccl step: the mesh step ran no collective")
    values, equal, off = bitwise_beyond_repeat("world-1 nccl step", *runs)
    repeats = all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    return {"backend": rt.backend, "values": values, "plain_repeats_bitwise": repeats,
            "bitwise_equal": equal, "max_abs_diff": off}


def phase_distributed_train(exp, state):
    """(a) one NCCL rank; (b) 2 gloo ranks on cuda:0 data-parallel, (c)
    sequence-parallel 2, (d) pipeline-parallel 2 and (e) tensor-parallel 2
    (the YAML's min_shard_elements), each's fp32 step (dist_batch: B32 x
    25 s, 3 rows weighted 0) held against the single-process card step on
    the same global batch with train_parity's rule (card_vs_cpu; under tp
    the slices' gradients gathered whole); K1 and K2 per rank per
    micro-step; the sp, pp and tp steps' wall time in bf16 with the YAML's
    settings, the pp and tp ranks' parameter and moment bytes and peak
    memory, and the tp ranks' gathered state loaded by one process on the
    card: its slices bit-equal to each rank's parameters and moments. Two
    ranks share one card through host-staged gloo: not a scaling number."""
    from mamba_asr_torch.kernels import selective_scan as kernel

    work = tempfile.mkdtemp(prefix="dist_steps_")
    try:
        # The ranks' fp32 steps run beside (a) and the single step; their
        # timed bf16 steps wait for PARENT_IDLE.
        group = RankGroup("steps", work)
        try:
            nccl = world_of_one_nccl(exp, state)
            cfg32, spec = fp32_step_setup(exp)
            batch = dist_batch(exp.model.vocab_size)
            kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
            losses, grads, _ = step_grads(exp, spec, cfg32, state, batch, "cuda")
            single = {"losses": losses, "grads": grads}
            plain_launches = {"K1": kernel.LAUNCHES, "K2": kernel.BWD_LAUNCHES}
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            open(os.path.join(work, PARENT_IDLE), "w").close()  # the ranks may time now
        except BaseException:
            group.kill()
            raise
        wall_s = group.wait()
        ranks = []
        for r in range(2):
            with open(os.path.join(work, f"steps_rank{r}.json")) as f:
                ranks.append(json.load(f))
        tp_load = tp_state_in_one_process(exp, work)
        held = {}
        for name in ("dp", "sp", "pp", "tp"):
            g = [torch.load(os.path.join(work, f"{name}_grads_rank{r}.pt"), weights_only=True)
                 for r in range(2)]
            # Under pp each rank holds its own stage's layers: the gradients
            # both hold (replicated) must be bit-equal, the stages' join them.
            both = set(g[0]) & set(g[1])
            if any(not torch.equal(g[0][n], g[1][n]) for n in both):
                raise AssertionError(f"distributed_train {name}: the ranks' summed gradients "
                                     "differ")
            whole = {**g[1], **g[0]}
            if set(whole) != set(single["grads"]) or (name != "pp" and both != set(whole)):
                raise AssertionError(f"distributed_train {name}: the ranks hold "
                                     f"{len(g[0])} and {len(g[1])} of "
                                     f"{len(single['grads'])} gradients")
            loss_errs, worst, worst_name = card_vs_cpu(
                f"distributed_train {name}", {"losses": ranks[0][name]["losses"], "grads": whole},
                single)
            held[name] = {"loss": ranks[0][name]["losses"]["loss"],
                          "loss_rel_err": loss_errs["loss"], "grad_max_rel_err": worst,
                          "grad_worst_param": worst_name,
                          "real_rows_per_rank": [rk[name]["real_rows"] for rk in ranks],
                          "launches_per_rank": [rk[name]["launches"] for rk in ranks],
                          "grads_per_rank": [len(x) for x in g],
                          "replicated_grads_bitwise_equal": len(both)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    per_step = scans_per_step(cfg32)
    if plain_launches != {"K1": per_step, "K2": per_step}:
        raise AssertionError(f"distributed_train: the single-process step launched "
                             f"{plain_launches}")
    # pp: each rank runs its half of the layers on each of PP_MICROBATCHES
    # microbatches (bubble ticks skip the stage): 4 x 6 x 2 = 48 per rank.
    pp_want = PP_MICROBATCHES * per_step // 2
    for name, want in (("dp", per_step), ("sp", 2 * per_step), ("pp", pp_want),
                       ("tp", per_step)):
        if any(lr != {"K1": want, "K2": want} for lr in held[name]["launches_per_rank"]):
            raise AssertionError(f"distributed_train {name}: launches "
                                 f"{held[name]['launches_per_rank']}, want {want} each")
    walls = ranks[0]["sp_bf16"]["wall_ms"]
    pp_walls = ranks[0]["pp_bf16"]["wall_ms"]
    audio = DIST_BATCH * TRAIN_SECONDS
    pp_mem = [{k: rk["pp_bf16"][k] for k in ("stage_layers", "param_bytes", "moment_bytes",
                                             "accumulator_bytes", "max_memory_allocated_gb")}
              for rk in ranks]
    whole = ranks[0]["pp_bf16"]["whole_model_param_bytes"]
    if any(m["param_bytes"] >= whole or m["moment_bytes"] != 2 * m["param_bytes"]
           for m in pp_mem):
        raise AssertionError(f"distributed_train pp: per-rank bytes {pp_mem} against the "
                             f"whole model's {whole}")
    tp_walls = ranks[0]["tp_bf16"]["wall_ms"]
    tp_mem = [{k: rk["tp_bf16"][k] for k in ("sharded", "param_bytes", "moment_bytes",
                                             "accumulator_bytes", "max_memory_allocated_gb")}
              for rk in ranks]
    if (ranks[0]["tp_bf16"]["whole_model_param_bytes"] != whole
            or any(m["param_bytes"] >= whole or m["moment_bytes"] != 2 * m["param_bytes"]
                   or m["sharded"] == 0 for m in tp_mem)):
        raise AssertionError(f"distributed_train tp: per-rank bytes {tp_mem} against the "
                             f"whole model's {whole}")
    emit({"phase": "distributed_train", "note": "two ranks share one card through "
          "host-staged gloo: correctness and launch counts, not a scaling number; NCCL "
          "across cards is not verified (one card)",
          "world_of_one_nccl": nccl, "batch": DIST_BATCH, "seconds_each": TRAIN_SECONDS,
          "weight0_rows": DIST_PAD_ROWS, "single_loss": single["losses"]["loss"],
          "single_launches": plain_launches, "dp": held["dp"], "sp": held["sp"],
          "sp_launches_per_rank_per_micro_step": held["sp"]["launches_per_rank"][0],
          "sp_launch_ratio_to_unsharded": held["sp"]["launches_per_rank"][0]["K1"] / per_step,
          "sp_bf16": {"wall_ms": walls, "median_ms": statistics.median(walls),
                      "waited_for_parent_s": ranks[0]["sp_bf16"]["waited_for_parent_s"],
                      "audio_s_per_s": audio / (statistics.median(walls) / 1e3),
                      "max_memory_allocated_gb": [rk["sp_bf16"]["max_memory_allocated_gb"]
                                                  for rk in ranks]},
          "pp": held["pp"], "pp_microbatches": PP_MICROBATCHES,
          "pp_launches_per_rank_per_micro_step": held["pp"]["launches_per_rank"][0],
          "pp_bf16": {"note": "two ranks share one card: not a scaling number",
                      "wall_ms": pp_walls, "median_ms": statistics.median(pp_walls),
                      "audio_s_per_s": audio / (statistics.median(pp_walls) / 1e3),
                      "per_rank": pp_mem, "whole_model_param_bytes": whole,
                      "whole_model_moment_bytes": 2 * whole},
          "tp": held["tp"], "tp_sharded_parameters": ranks[0]["tp"]["sharded"],
          "tp_min_shard_elements": exp.parallel.min_shard_elements,
          "tp_launches_per_rank_per_micro_step": held["tp"]["launches_per_rank"][0],
          "tp_bf16": {"note": "two ranks share one card: not a scaling number",
                      "wall_ms": tp_walls, "median_ms": statistics.median(tp_walls),
                      "audio_s_per_s": audio / (statistics.median(tp_walls) / 1e3),
                      "per_rank": tp_mem, "whole_model_param_bytes": whole,
                      "whole_model_moment_bytes": 2 * whole},
          "tp_state_in_one_process": tp_load,
          "gloo": {"backend": ranks[0]["backend"], "device": ranks[0]["device"]},
          "spawn_wall_s": wall_s,
          "tol": {"loss_rtol": TRAIN_LOSS_RTOL, "grad": TRAIN_GRAD_TOL}})
    return {"sp_train_launches": held["sp"]["launches_per_rank"][0],
            "pp_train_launches": held["pp"]["launches_per_rank"][0],
            "tp_train_launches": held["tp"]["launches_per_rank"][0]}


def tp_state_in_one_process(exp, work):
    """Rank 0's gathered tp state (after its bf16 steps and one update)
    loaded by a single-process Trainer on the card: each rank's parameter
    slices and AdamW moments equal the one process's, cut by the rank's
    placement (parallel/tensor.py:plan), bit for bit."""
    from mamba_asr_torch.parallel import tensor
    from mamba_asr_torch.training.trainer import Trainer

    whole = torch.load(os.path.join(work, "tp_state.pt"), weights_only=False)
    tr = Trainer(exp.model, exp.frontend, exp.train, exp.specaug, device="cuda")
    tr.load_model_state(whole["model"])
    tr.load_optimizer_state(whole["optimizer"])
    params = {n: p.detach().cpu() for n, p in tr.model.named_parameters()}
    moments = tr.optimizer.state_dict()["moments"]
    checked = sliced = 0
    for r in range(2):
        local = torch.load(os.path.join(work, f"tp_local_rank{r}.pt"), weights_only=False)
        plan = tensor.plan(tr.model, exp.model, 2, r, exp.parallel.min_shard_elements)
        for name, got in local["params"].items():
            cut = plan[name].local if name in plan else (lambda t: t)
            want = [(cut(params[name]), got)] + [
                (cut(moments[name][k].cpu()) if v.dim() else moments[name][k].cpu(), v)
                for k, v in local["moments"].get(name, {}).items()]
            for a, b in want:
                if not torch.equal(a, b):
                    raise AssertionError(f"tp state in one process: rank {r}'s {name} differs "
                                         "from its slice of the gathered state")
                checked += 1
            sliced += name in plan
    del tr
    torch.cuda.empty_cache()
    return {"tensors_bitwise_equal": checked, "sliced_parameters_over_ranks": sliced}


def phase_distributed_recipe(work, corpus):
    """(d) The CTC recipe at full ConMamba-Small width in fp32 (TF32 off,
    dropout 0, SpecAugment off, DIST_RECIPE_EPOCHS epochs on the tone
    corpus, batches of DIST_MAX_BATCH_EX rows: the same bucket plan for one
    process and two) through `cli.run_training(... --distributed)` in 2
    gloo ranks on cuda:0 (dp), and in 2 more with pipeline_stages 2 (pp:
    DIST_RECIPE_MICROBATCHES microbatches of each batch, scan_layers on),
    against the single-process run: per-step losses within
    DIST_RECIPE_RTOL (the card's CTC backward adds with atomics), one save
    dir and one wer_test-clean.txt, written by rank 0. Then a
    single-process loop on the card resumes rank 0's last pp checkpoint
    (the stages gathered into a single process's layout): the epoch after
    the last, every tensor bit-equal to the pp ranks' final model, and
    each within DIST_RESUME_RTOL (relative norm) of the single-process
    run's last checkpoint."""
    from mamba_asr_torch import cli
    from mamba_asr_torch.training.loop import Trainer as LoopTrainer

    def argv(out):
        return recipe_args(corpus, out, DIST_RECIPE_EPOCHS) + [
            "--model.compute_dtype", "float32", "--model.dropout", "0.0",
            "--specaug.enabled", "false", "--data.max_batch_ex", str(DIST_MAX_BATCH_EX)]

    outs = {name: os.path.join(work, f"dist_{name}") for name in ("one", "dp", "pp")}
    flags = {"dp": [], "pp": ["--parallel.pipeline_stages", "2", "--model.scan_layers", "true",
                              "--parallel.pipeline_microbatches",
                              str(DIST_RECIPE_MICROBATCHES)]}
    groups = {}
    try:
        for name, extra in flags.items():  # both ranks on cuda:0 (gloo)
            args_path = os.path.join(work, f"dist_{name}_argv.json")
            with open(args_path, "w") as f:
                json.dump(argv(outs[name]) + extra + ["--device", "cuda:0"], f)
            # one thread a rank: the chains beside them are bound by the host's cores
            groups[name] = RankGroup("recipe", work, args=(f"recipe_{name}", args_path),
                                     threads=1)
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        one = cli.run_training(argv(outs["one"]))
        one_s = time.perf_counter() - t0
        torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    except BaseException:
        for group in groups.values():
            group.kill()
        raise
    try:
        walls = {name: groups[name].wait() for name in flags}
    finally:
        for group in groups.values():
            group.kill()
    cfg = one.cfg
    csv_path = os.path.join(cfg.output_folder, "manifests", cfg.data.train_csv)
    # The CLI's divisors: lcm(data x microbatches, processes), 2 for dp and pp.
    divisors = (1, 2, math.lcm(DIST_RECIPE_MICROBATCHES, 2))
    plans = [cli.train_loader(cfg, csv_path, one.tokenizer, batch_divisor=d).plan.buckets
             for d in divisors]
    if any(p != plans[0] for p in plans):
        raise AssertionError(f"distributed_recipe: the bucket plans differ: {plans}")
    want = np.array(one.loss_history)

    def files(d):
        with open(os.path.join(d, "train_log.txt")) as f:
            rows = f.read().splitlines()
        return (sorted(os.listdir(d)), len(os.listdir(os.path.join(d, "save"))),
                len(rows), sum(r.startswith("test_set") for r in rows))

    res, layout = {}, {"one": files(cfg.output_folder)}
    for name in flags:
        with open(os.path.join(work, f"recipe_{name}_losses.json")) as f:
            res[name] = json.load(f)
        got = np.array(res[name]["loss"])
        if got.shape != want.shape or not np.all(np.abs(got - want) <= DIST_RECIPE_RTOL
                                                 * np.abs(want)):
            raise AssertionError(f"distributed_recipe {name}: losses {got.tolist()} vs "
                                 f"{want.tolist()}")
        res[name]["got"] = got
        layout[name] = files(cfg.output_folder.replace(outs["one"], outs[name]))
        if layout["one"] != layout[name] or layout[name][3] != 1 or \
                "wer_test-clean.txt" not in layout[name][0]:
            raise AssertionError(f"distributed_recipe {name}: files {layout}")
    # Rank 0's pp checkpoint, resumed in one process on the card, against
    # the single-process run's last.
    states = {}
    for name in ("one", "pp"):
        resumed = LoopTrainer(dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, output_folder=outs[name])), None, device="cuda")
        resumed.init_state()
        if resumed.start_epoch != DIST_RECIPE_EPOCHS + 1:
            raise AssertionError(f"distributed_recipe {name}: resumed at epoch "
                                 f"{resumed.start_epoch}")
        states[name] = resumed.step.model_state()
        del resumed
    final = torch.load(os.path.join(work, "recipe_pp_state.pt"))
    if states["pp"].keys() != states["one"].keys() or states["pp"].keys() != final.keys():
        raise AssertionError("distributed_recipe pp: the checkpoint's keys differ")
    unequal = [k for k, v in states["pp"].items() if not torch.equal(v, final[k])]
    if unequal:
        raise AssertionError(f"distributed_recipe pp: the resumed checkpoint differs from "
                             f"the ranks' final model in {unequal[:5]}")
    resume_err = {k: float(torch.linalg.vector_norm((v - states["one"][k]).double())
                           / max(float(torch.linalg.vector_norm(states["one"][k].double())),
                                 1e-30))
                  for k, v in states["pp"].items() if v.is_floating_point()}
    worst = max(resume_err, key=resume_err.get)
    if not resume_err[worst] <= DIST_RESUME_RTOL:
        raise AssertionError(f"distributed_recipe pp: resumed {worst} off by "
                             f"{resume_err[worst]} (relative norm)")
    runs = {}
    for name in flags:
        got = res[name]["got"]
        runs[name] = {
            "loss_max_rel_err": float(np.max(np.abs(got - want) / np.abs(want))),
            "losses": got.tolist(), "test": res[name]["test"].get("test-clean"),
            "files": {"entries": layout[name][0], "checkpoints": layout[name][1],
                      "log_rows": layout[name][2], "test_rows": layout[name][3]},
            "wall_s": walls[name]}
    runs["pp"].update(microbatches=DIST_RECIPE_MICROBATCHES, resumed_in_one_process={
        "epoch": DIST_RECIPE_EPOCHS, "tensors": len(resume_err),
        "bitwise_equal_to_final": len(final),
        "max_rel_norm_err": resume_err[worst], "worst": worst, "rtol": DIST_RESUME_RTOL})
    emit({"phase": "distributed_recipe", "epochs": DIST_RECIPE_EPOCHS,
          "micro_steps": len(want), "rtol": DIST_RECIPE_RTOL,
          "losses_one": want.tolist(), "test_one": one.test_stats["test-clean"],
          "dp": runs["dp"], "pp": runs["pp"],
          "bucket_plan": [dataclasses.astuple(b) for b in plans[0]],
          "one_process_s": one_s,
          "note": "the three runs side by side on one card and host"})


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


def floor160_corpus(work):
    """The Mamba floor run's corpus (MAMBA_FLOOR_CORPUS utterances), built
    once: train_lm reads its transcripts too."""
    from mamba_asr_torch.tools.train_to_floor import build_corpus

    corpus = os.path.join(work, "corpus160")
    if not os.path.isdir(corpus):
        n_train, n_dev, n_test = MAMBA_FLOOR_CORPUS
        build_corpus(corpus, n_train=n_train, n_dev=n_dev, n_test=n_test)
    return corpus


def phase_mamba_dec_train_to_floor(work):
    """tools.train_to_floor --mode s2s at its default config (the Mamba
    decoder) on the JAX regime proof's corpus: 160 / 16 / 16 utterances,
    --epochs MAMBA_FLOOR_EPOCHS (x 3), test WER <= 2.0 %."""
    from mamba_asr_torch.tools import train_to_floor

    corpus = floor160_corpus(work)
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
    large = CONFORMER_CTC[0]
    result["dynchunk"] = {yaml_name(large): dynchunk_parity(
        "conformer_parity dynchunk", exps[large], states[large])}
    emit(result)


@torch.no_grad()
def phase_conformer_recognize(exps, states):
    """bf16 through Recognizer. CTC RTFx at B32 x 30 s of noise:
    CONFORMER_CTC_BLOCKS blocks of 10 calls for Conformer-Large, one block
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
    for path, count in zip(CONFORMER_CTC, (CONFORMER_CTC_BLOCKS, 1, 1)):
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


def phase_conformer_train(exps, states):
    """Conformer-Large CTC (hparams/CTC/conformer_large.yaml): one fp32
    micro-step (TF32 and cuDNN off, dropout 0, SpecAugment off, train
    parity's B2 x 4 s batch), card against CPU with train_parity's rule
    (card_vs_cpu); then CONFORMER_TRAIN_STEPS micro-steps with the YAML's
    settings (bf16, dropout 0.1, SpecAugment, accumulation 4) on B32 x 25 s
    of noise with ~300-token targets: finite losses, the parameters
    changing on every 4th micro-step only, audio-s per s over the
    micro-steps after the first, peak memory. Plain torch on both devices
    (JAX leaves this encoder to XLA): no kernel launches."""
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.training.trainer import Trainer

    path = CONFORMER_CTC[0]
    exp, state = exps[path], states[path]
    cfg32, spec = fp32_step_setup(exp)
    batch = char_batch(2, 4.0, 20, 3, exp.model.vocab_size)
    runs = {}
    for dev in ("cuda", "cpu"):
        torch.backends.cudnn.enabled = dev != "cuda"
        runs[dev] = dict(zip(("losses", "grads"),
                             step_grads(exp, spec, cfg32, state, batch, dev)[:2]))
    torch.backends.cudnn.enabled = True
    torch.backends.cudnn.allow_tf32 = True  # back to PyTorch's defaults
    loss_errs, worst, worst_name = card_vs_cpu("conformer_train", runs["cuda"], runs["cpu"])

    tr = Trainer(exp.model, exp.frontend, exp.train, exp.specaug, state_dict=state,
                 device="cuda")
    batch = char_batch(32, TRAIN_SECONDS, 300, 4, exp.model.vocab_size)
    k = exp.train.grad_accumulation_factor
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.LAUNCHES = kernel.BWD_LAUNCHES = 0
    steps = []
    for i in range(CONFORMER_TRAIN_STEPS):
        before = [p.detach().clone() for p in tr.model.parameters()]
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        loss = m["loss"].item()  # syncs
        wall = time.perf_counter() - t0
        changed = sum(not torch.equal(a, p) for a, p in zip(before, tr.model.parameters()))
        emit_step = i % k == k - 1
        if not np.isfinite(loss) or bool(m["updated"]) != emit_step or \
                (changed > 0) != emit_step:
            raise AssertionError(f"conformer_train micro-step {i}: loss {loss}, {changed} "
                                 f"parameters changed, emit step {emit_step}")
        steps.append({"loss": loss, "grad_norm": m["grad_norm"].item(), "wall_s": wall,
                      "params_changed": changed})
    if kernel.LAUNCHES or kernel.BWD_LAUNCHES:
        raise AssertionError("conformer_train: a ConMamba scan kernel launched")
    audio = float(batch["wav_lens"].sum()) / 16000
    rate = audio * (len(steps) - 1) / sum(s["wall_s"] for s in steps[1:])
    emit({"phase": "conformer_train", "config": path, "d_model": exp.model.d_model,
          "layers": exp.model.num_encoder_layers, "compute_dtype": exp.model.compute_dtype,
          "dropout": exp.model.dropout, "specaug": exp.specaug.enabled, "accumulation": k,
          "batch": 32, "seconds_each": TRAIN_SECONDS, "micro_steps": steps,
          "audio_s_per_s": rate,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "parity": {"loss_cuda": runs["cuda"]["losses"]["loss"],
                     "loss_cpu": runs["cpu"]["losses"]["loss"],
                     "loss_rel_err": loss_errs["loss"], "params": len(runs["cpu"]["grads"]),
                     "grad_max_rel_err": worst, "grad_worst_param": worst_name,
                     "tol": {"loss_rtol": TRAIN_LOSS_RTOL, "grad": TRAIN_GRAD_TOL}}})


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

    trans = os.path.join(floor160_corpus(work), "train-clean-100", "1", "2", "1-2.trans.txt")
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


def drive_engine(engine, wavs, seed, abort=None):
    """Streams `wavs` through `engine`'s public API: attach while a slot is
    free (the rest wait in order, so freed slots are reused), each live
    stream fed a ragged piece of 0.1 to 0.9 s per step, one tick per step,
    a stream finished once fed. abort (index, step): that stream is
    aborted at that step. Returns {index: ids} (None for the aborted)."""
    rng = np.random.default_rng(seed)
    queue, live, out, step = list(range(len(wavs))), {}, {}, 0
    while queue or live:
        while queue and engine.free_slots:
            live[engine.attach()] = [queue.pop(0), 0, []]
        for sid, st in live.items():
            n = int(rng.uniform(0.1, 0.9) * 16000)
            engine.feed(sid, wavs[st[0]][st[1]:st[1] + n])
            st[1] += n
        for sid, toks in engine.tick().items():
            live[sid][2] += toks
        for sid in [s for s, st in live.items() if st[1] >= len(wavs[st[0]])]:
            idx, _, ids = live.pop(sid)
            out[idx] = ids + engine.finish(sid)
        if abort is not None and step == abort[1]:
            sid = next(s for s, st in live.items() if st[0] == abort[0])
            engine.abort(sid)
            out[live.pop(sid)[0]] = None
        step += 1
    return out


def final_pass(name, model, frontend, final, beam, opts, seed, lm=None):
    """One SERVING_FINAL_S stream through an engine with final_decode
    `final`, fed in 320 ms pieces with a tick after each; finish_final
    timed (the flush and the search) with its K1/K3/K4 launches; the same
    search run directly on the encoder output and CTC log-probs the
    engine's pass took: ids equal."""
    from mamba_asr_torch.decoding.ctc_beam import ctc_beam_search, ctc_beam_search_nbest
    from mamba_asr_torch.decoding.rescore import rescore_nbest
    from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher
    from mamba_asr_torch.serving.engine import StreamingServer

    engine = StreamingServer(model, frontend, None, n_slots=2,
                             chunk_frames=STREAM_CHUNK_FRAMES, final_decode=final,
                             beam_size=beam, decode_opts=opts, lm_model=lm)
    seen = {}
    if final == "s2s":
        replica = engine._replicas[0]
        searcher = replica.searcher

        def record(enc, lens, ctc_log_probs):
            seen.update(enc=enc, lens=lens, lp=ctc_log_probs)
            return searcher(enc, lens, ctc_log_probs=ctc_log_probs)

        replica.searcher = record
    else:
        final_ctc = engine._final_ctc

        def record(rep, lp, lens):
            seen.update(lp=lp, lens=lens)
            return final_ctc(rep, lp, lens)

        engine._final_ctc = record
    wav = noise(SERVING_FINAL_S, seed)
    sid = engine.attach()
    for off in range(0, len(wav), 5120):
        engine.feed(sid, wav[off:off + 5120])
        engine.tick()
    reset, read = s2s_launch_counters()
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, got = engine.finish_final(sid)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = read()
    with torch.no_grad():
        if final == "s2s":
            toks, lens, _ = S2SBeamSearcher(model, beam_size=beam, **opts)(
                seen["enc"], seen["lens"], ctc_log_probs=seen["lp"])
        elif lm is None:
            toks, lens = ctc_beam_search(seen["lp"], seen["lens"], beam_size=beam)
        else:
            nb = ctc_beam_search_nbest(seen["lp"], seen["lens"], nbest=min(beam, 10),
                                       beam_size=beam)
            toks, lens = rescore_nbest(*nb, lm, lm_weight=opts["lm_weight"],
                                       temperature_lm=opts["temperature_lm"])
    direct = toks[0, :int(lens[0])].tolist()
    if got != direct:
        raise AssertionError(f"serving {name}: final ids differ from the direct search, "
                             f"first at {first_difference(torch.tensor(got), torch.tensor(direct))}")
    return {"final": final, "beam": beam, "encoder_frames": int(seen["lens"][0]),
            "padded_frames": int(seen["lp"].shape[1]), "ids": len(got),
            "finish_final_ms": ms, "launches": launches, "equal_to_direct": True}


def s2s_opts(decode):
    """The decode stanza's joint-search settings, as Recognizer passes them."""
    return dict(ctc_weight=decode.ctc_weight_decode, ctc_candidates=decode.ctc_candidates,
                temperature=decode.temperature, length_normalization=decode.length_normalization,
                max_decode_ratio=decode.max_decode_ratio, min_decode_ratio=decode.min_decode_ratio)


def tcp_round_trips(engine, want, wavs):
    """AsrTcpServer over `engine` on 127.0.0.1: an abandoned client's slot
    comes back; SERVING_TCP's clients stream `wavs` concurrently; a client
    beyond the slots gets the server-full error; every client's ids equal
    `want`; the stats op. Client 0 waits for its endpoint event first: the
    trailing-silence signal is forced to SERVING_ENDPOINT_S, as the JAX
    package's test forces it (a seeded model's argmax need not end a chunk
    on a blank; the engine's bookkeeping is held against JAX's on the
    CPU)."""
    import threading

    from mamba_asr_torch.serving.server import AsrTcpServer, StreamingClient

    before = engine.stats()
    engine.trailing_silence_s = lambda sid: SERVING_ENDPOINT_S
    server = AsrTcpServer(engine, port=0, endpoint_silence_s=SERVING_ENDPOINT_S)
    server.start()
    step = int(SERVING_TCP[2] * 16000)
    try:
        gone = StreamingClient(server.host, server.port)
        gone.send(gone.start(), wavs[0][:32000])
        gone.close()
        deadline = time.time() + 30
        while engine.free_slots < engine.n_slots and time.time() < deadline:
            time.sleep(0.01)
        if engine.free_slots != engine.n_slots:
            raise AssertionError("serving tcp: the abandoned client's slot was not reclaimed")
        clients = [StreamingClient(server.host, server.port) for _ in wavs]
        sids = [c.start() for c in clients]
        extra = StreamingClient(server.host, server.port)
        try:
            extra.start()
            raise AssertionError("serving tcp: a client beyond the slots was started")
        except RuntimeError as e:
            full = str(e)
        extra.close()
        got, endpoint = [None] * len(wavs), {}

        def run(i):
            for off in range(0, len(wavs[i]), step):
                clients[i].send(sids[i], wavs[i][off:off + step])
            if i == 0:
                endpoint["silence_s"] = clients[i].wait_endpoint(sids[i], timeout=120)
            got[i] = clients[i].end(sids[i])[0]

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(wavs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall_s = time.perf_counter() - t0
        stats = clients[0].stats()
        for c in clients:
            c.close()
    finally:
        server.stop()
        del engine.trailing_silence_s
    for i, ids in enumerate(got):
        if ids != want[i]:
            raise AssertionError(f"serving tcp: client {i}'s ids differ from the engine's")
    if endpoint.get("silence_s") != SERVING_ENDPOINT_S:
        raise AssertionError(f"serving tcp: endpoint event {endpoint}")
    counts = {k: stats[k] - before[k] for k in ("attached_total", "finished_total",
                                                 "aborted_total")}
    if counts != {"attached_total": len(wavs) + 1, "finished_total": len(wavs),
                  "aborted_total": 1} or stats["active_streams"]:
        raise AssertionError(f"serving tcp: stats {stats} after {before}")
    return {"clients": len(wavs), "seconds_each": SERVING_TCP[1], "send_s": SERVING_TCP[2],
            "wall_s": wall_s, "ids_equal": True, "full_error": full,
            "endpoint_silence_s": endpoint["silence_s"], "stats": stats}


def phase_serving(exp, state, s2s, s2s_state, mam, mam_state, clock_hz, sms):
    """The slot-batched engine (serving/engine.py) and its TCP server.

    Kernel: K1 at the tick's shapes (SERVING_K1_SLOTS x L16 x D288 x N16,
    bf16 and fp32, h0 in, h_last out) against its plain version; time,
    plain time and bound at n_slots 32 bf16. Exactness (fp32, TF32 off):
    the causal, unidirectional ConMamba-Small of phase streaming in an
    engine of SERVING_EXACT_SLOTS slots, 64-frame chunks, the
    SERVING_STREAMS_S streams staggered (ragged feeds, slots reused) with
    one more aborted mid-flight: each transcript equals the single session
    and the offline greedy decode. Capacity: tools/bench_serving.py on the
    YAML's bf16 ConMamba-Small at SERVING_SLOTS (K1 24 per tick held), and
    one profiled tick at SERVING_PROFILE_SLOTS. Final passes (bf16):
    "ctc_beam" at beam SERVING_CTC_BEAM without and with a seeded
    full-width LM (vocab 31), "s2s" on S2S/conmamba_small.yaml and on the
    Mamba decoder with their decode stanzas: each equal to its search run
    directly on the same encoder output; finish_final ms and launches.
    TCP: the exactness engine behind AsrTcpServer on 127.0.0.1, an
    abandoned client, SERVING_TCP's concurrent clients (ids equal to the
    engine's own), the full-server error, an endpoint event (the signal
    forced), the stats op. Replicas (`serve --data_parallel`'s engine):
    the exactness streams through SERVING_REPLICAS replicas on cuda:0,
    each transcript equal to the single engine's and the offline decode,
    K1 per steady tick SERVING_REPLICAS times the single engine's; the
    bf16 tick at SERVING_PROFILE_SLOTS slots over the replicas against
    one replica at as many (one card: not a scaling number); `python -m
    mamba_asr_torch.serve --data_parallel` with one card more than the
    machine has exits naming both counts."""
    from mamba_asr_torch.decoding.ctc_greedy import ctc_greedy_decode
    from mamba_asr_torch.kernels import selective_scan as kernel
    from mamba_asr_torch.ops.selective_scan import selective_scan_ref
    from mamba_asr_torch.serving.engine import StreamingServer
    from mamba_asr_torch.tools import bench_serving

    result = {"phase": "serving", "chunk_frames": STREAM_CHUNK_FRAMES}
    cards = torch.cuda.device_count()
    refused = subprocess.Popen(  # beside the phase: its torch import takes seconds
        [sys.executable, "-m", "mamba_asr_torch.serve", CONFIG, "--torch_ckpt", "model.ckpt",
         "--data_parallel", str(cards + 1)], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    cfg = exp.model
    d_inner, n = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    gen = torch.Generator().manual_seed(SEED + 70)
    cases = []
    for bsz in SERVING_K1_SLOTS:
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            inp = scan_inputs(bsz, 16, d_inner, n, dtype, gen, h0=True)
            out, h_last = kernel.selective_scan_fwd(**inp, delta_softplus=True,
                                                    return_last_state=True)
            torch.cuda.synchronize()
            ref, h_ref = selective_scan_ref(**inp, delta_softplus=True, return_last_state=True)
            name = f"serving k1 b{bsz} l16 {str(dtype)[6:]}"
            cases.append({"shape": [bsz, 16, d_inner, n], "dtype": str(dtype),
                          "time_segments": kernel.time_segments(bsz, 16, d_inner, sms)[0],
                          "max_abs_err": check_close(name, out, ref, *tol),
                          "h_last_max_abs_err": check_close(name + " h_last", h_last, h_ref,
                                                            *FP32_TOL)})
    k1 = scan_inputs(SERVING_PROFILE_SLOTS, 16, d_inner, n, torch.bfloat16, gen, h0=True)
    bound_ms, bound_by = scan_bound_ms(k1, clock_hz, sms, h_last=True)
    result["kernel"] = {
        "cases": cases, "shape": [SERVING_PROFILE_SLOTS, 16, d_inner, n],
        "dtype": "torch.bfloat16",
        "max_abs_err": max(c["max_abs_err"] for c in cases
                           if c["shape"][0] == SERVING_PROFILE_SLOTS),
        "ms": cuda_ms(lambda: kernel.selective_scan_fwd(**k1, delta_softplus=True,
                                                        return_last_state=True), 200),
        "plain_ms": cuda_ms(lambda: selective_scan_ref(**k1, delta_softplus=True,
                                                       return_last_state=True), 10),
        "bound_ms": bound_ms, "bound_by": bound_by}

    # Exactness: fp32 causal ConMamba-Small, TF32 off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    causal = dataclasses.replace(exp, model=dataclasses.replace(
        cfg, causal=True, bidirectional=False, compute_dtype="float32"))
    model32 = stream_model(causal, seeded_state(causal.model), "cuda")
    fe = exp.frontend
    wavs = [noise(sec, SEED + 80 + i) for i, sec in enumerate(SERVING_STREAMS_S)]
    engine = StreamingServer(model32, fe, None, n_slots=SERVING_EXACT_SLOTS,
                             chunk_frames=STREAM_CHUNK_FRAMES)
    kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    # Stream 1 of the drive (8 s) is aborted at its fifth step.
    got = drive_engine(engine, wavs[:1] + [noise(8.0, SEED + 79)] + wavs[1:], SEED + 81,
                       abort=(1, 4))
    drive_s = time.perf_counter() - t0
    got = [got[0]] + [got[i + 1] for i in range(1, len(wavs))]
    exact = []
    for i, wav in enumerate(wavs):
        single = run_stream(model32, fe, wav)[0]
        _, off_lp = offline_padded(model32, fe, wav)
        toks, lens = ctc_greedy_decode(off_lp, torch.tensor([off_lp.shape[1]], device="cuda"))
        off_ids = toks[0, :int(lens[0])].tolist()
        if not got[i] == single == off_ids:
            raise AssertionError(f"serving: stream {i} ({SERVING_STREAMS_S[i]} s): engine, "
                                 "single session and offline ids differ")
        exact.append(len(off_ids))
    st = engine.stats()
    result["exactness"] = {"slots": SERVING_EXACT_SLOTS, "streams_s": list(SERVING_STREAMS_S),
                           "aborted": 1, "ids": exact, "equal": True, "drive_s": drive_s,
                           "stats": st, "k1_launches": kernel.LAUNCHES}
    # TCP over the same engine: the engine-direct ids of SERVING_TCP's streams.
    tcp_wavs = [noise(SERVING_TCP[1], SEED + 90 + i) for i in range(SERVING_TCP[0])]
    want = drive_engine(engine, tcp_wavs, SEED + 91)
    result["tcp"] = tcp_round_trips(engine, [want[i] for i in range(len(tcp_wavs))], tcp_wavs)
    # The same streams over replicas on the card: the same transcripts.
    devices = ["cuda:0"] * SERVING_REPLICAS
    replicas = StreamingServer(model32, fe, None, n_slots=SERVING_EXACT_SLOTS,
                               chunk_frames=STREAM_CHUNK_FRAMES, devices=devices)
    t0 = time.perf_counter()
    got_r = drive_engine(replicas, wavs[:1] + [noise(8.0, SEED + 79)] + wavs[1:], SEED + 81,
                         abort=(1, 4))
    drive_r_s = time.perf_counter() - t0
    got_r = [got_r[0]] + [got_r[i + 1] for i in range(1, len(wavs))]
    if got_r != got:
        raise AssertionError("serving replicas: transcripts differ from the single engine's")
    per_tick = {}
    for name, over in (("single", None), ("replicas", devices)):
        filled, feed = bench_serving.filled_engine(model32, fe, SERVING_EXACT_SLOTS,
                                                   STREAM_CHUNK_FRAMES, SEED, over)
        feed()
        kernel.LAUNCHES = 0
        filled.tick()  # every row steady
        per_tick[name] = kernel.LAUNCHES
    if per_tick["replicas"] != SERVING_REPLICAS * per_tick["single"] or not per_tick["single"]:
        raise AssertionError(f"serving replicas: K1 per tick {per_tick}")
    result["replicas_exactness"] = {
        "replicas": SERVING_REPLICAS, "devices": devices, "slots": SERVING_EXACT_SLOTS,
        "rows_per_replica": [len(r.rows) for r in replicas._replicas],
        "equal_to_single_and_offline": True, "drive_s": drive_r_s,
        "k1_per_tick": per_tick, "stats": replicas.stats()}
    torch.backends.cudnn.allow_tf32 = True  # back to PyTorch's defaults
    del model32, engine, replicas

    # Capacity at the YAML's bf16.
    rows = bench_serving.run(cfg, fe, SERVING_SLOTS, STREAM_CHUNK_FRAMES, SERVING_TICKS, SEED,
                             "cuda")
    for row in rows:
        if row["k1_launches_per_tick"] != scans_per_step(cfg):
            raise AssertionError(f"serving: {row['k1_launches_per_tick']} K1 launches per tick "
                                 f"at {row['n_slots']} slots")
    model = bench_serving.seeded_model(cfg, SEED, torch.device("cuda"))
    engine, feed = bench_serving.filled_engine(model, fe, SERVING_PROFILE_SLOTS,
                                               STREAM_CHUNK_FRAMES, SEED)
    wall_ms, device_ms, top = device_profile(lambda: (feed(), engine.tick()), 10)
    result["capacity"] = {"rows": rows, "profile": {
        "slots": SERVING_PROFILE_SLOTS, "wall_ms": wall_ms, "device_kernel_ms": device_ms,
        "idle_share": 1.0 - device_ms / wall_ms, "top": top}}
    # The bf16 tick over replicas against one replica, ticks alternating.
    split, split_feed = bench_serving.filled_engine(
        model, fe, SERVING_PROFILE_SLOTS, STREAM_CHUNK_FRAMES, SEED, ["cuda:0"] * SERVING_REPLICAS)
    feeds = {"one": (engine, feed), "replicas": (split, split_feed)}
    walls, launches = {k: [] for k in feeds}, {k: 0 for k in feeds}
    for _ in range(SERVING_TICKS):
        for name, (e, f) in feeds.items():
            f()
            torch.cuda.synchronize()
            before = kernel.LAUNCHES
            t0 = time.perf_counter()
            e.tick()  # returns after the argmaxes' copy to the host
            walls[name].append(1e3 * (time.perf_counter() - t0))
            launches[name] += kernel.LAUNCHES - before
    per_tick = {k: v / SERVING_TICKS for k, v in launches.items()}
    if per_tick != {"one": scans_per_step(cfg), "replicas": SERVING_REPLICAS * scans_per_step(cfg)}:
        raise AssertionError(f"serving replicas: K1 per bf16 tick {per_tick}")
    result["replicas_tick"] = {
        "note": "replicas share one card: not a scaling number", "slots": SERVING_PROFILE_SLOTS,
        "replicas": SERVING_REPLICAS, "ticks": SERVING_TICKS,
        **{f"{k}_wall_ms_median": statistics.median(v) for k, v in walls.items()},
        **{f"{k}_wall_ms": v for k, v in walls.items()}, "k1_per_tick": per_tick}
    del engine, split, feeds

    # Final passes, bf16.
    finals = {"ctc_beam": final_pass("ctc_beam", model, fe, "ctc_beam", SERVING_CTC_BEAM, {},
                                     SEED + 100)}
    lm = seeded_lm(s2s.decode, cfg.vocab_size).to("cuda")
    finals["ctc_beam_lm"] = final_pass(
        "ctc_beam_lm", model, fe, "ctc_beam", SERVING_CTC_BEAM,
        {"lm_weight": s2s.decode.lm_weight, "temperature_lm": s2s.decode.temperature_lm},
        SEED + 100, lm=lm)
    del lm, model
    for name, e, st_ in (("s2s", s2s, s2s_state), ("s2s_mamba_decoder", mam, mam_state)):
        m = stream_model(e, st_, "cuda")
        finals[name] = final_pass(name, m, e.frontend, "s2s", e.decode.s2s_test_beam_size,
                                  s2s_opts(e.decode), SEED + 101)
        del m
    layers = s2s.model.num_decoder_layers
    fin = finals["s2s"]["launches"]
    if fin["K4"] != layers * fin["K3"] or fin["K3"] == 0:
        raise AssertionError(f"serving: s2s final pass launched K3 {fin['K3']}, K4 {fin['K4']}")
    if finals["s2s_mamba_decoder"]["launches"]["K1"] < mam.model.num_decoder_layers:
        raise AssertionError("serving: the Mamba decoder's final pass did not prime with K1")
    result["finals"] = finals
    out = refused.communicate(timeout=120)[0].decode(errors="replace")
    if refused.returncode == 0 or f"has {cards} CUDA card(s), fewer than {cards + 1}" not in out:
        raise AssertionError(f"serve --data_parallel {cards + 1} on {cards} card(s): exit "
                             f"{refused.returncode}\n{out[-2000:]}")
    result["data_parallel_refused"] = {"asked": cards + 1, "cards": cards,
                                       "exit": refused.returncode,
                                       "message": out.strip().splitlines()[-1]}
    emit(result)
    return result


# -- the Conformer decoder, ConMamba-Large -----------------------------------------


def parity_batch(seed, seconds=(4.0, 3.1)):
    """B2 of noise at `seconds` each, zero-padded (the parity phases' batch)."""
    n = [int(x * 16000) for x in seconds]
    wav = np.zeros((2, n[0]), np.float32)
    wav[0] = noise(seconds[0], seed)
    wav[1, :n[1]] = noise(seconds[1], seed + 1)
    return torch.from_numpy(wav), torch.tensor(n)


def parity_search(model, out, d, lm=None):
    """The joint search at PARITY_BEAM with the decode stanza's CTC weight,
    candidates and temperatures (and LM weight, with `lm`), eos banned for
    PARITY_MIN_DECODE_RATIO of the frames, over the encoder outputs `out`:
    ([tokens, lengths, scores] on the CPU, steps, launches {K1, K3, K4})."""
    from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher

    reset, read = s2s_launch_counters()
    searcher = S2SBeamSearcher(
        model, beam_size=PARITY_BEAM, ctc_weight=d.ctc_weight_decode,
        ctc_candidates=d.ctc_candidates, temperature=d.temperature,
        min_decode_ratio=PARITY_MIN_DECODE_RATIO,
        lm_weight=d.lm_weight if lm is not None else 0.0,
        temperature_lm=d.temperature_lm, lm_model=lm)
    reset()
    found = [x.cpu() for x in searcher(out["enc_out"], out["enc_lengths"],
                                       out["ctc_log_probs"])]
    launches = read()
    del launches["K2"]
    return found, searcher.last_steps, launches


def same_search(name, got, ref):
    """Tokens equal and best scores within S2S_PARITY_TOL; the scores' max
    |d|."""
    if not torch.equal(got[0], ref[0]):
        rows = [first_difference(a, b) for a, b in zip(got[0], ref[0])]
        raise AssertionError(f"{name}: tokens differ (first step per row {rows})")
    return check_close(f"{name} best scores", got[2], ref[2], S2S_PARITY_TOL, 0.0)


def timed_searches(rec, batch):
    """Two searches in turn of the 30 s requests `batch` through
    rec.transcribe, the first on a fresh Recognizer: {rtfx_cold, rtfx (the
    second's), launches per search, steps}. Both must launch alike."""
    reset, read = s2s_launch_counters()
    rtfx, launches = [], []
    for _ in range(2):
        reset()
        t0 = time.perf_counter()
        rec.transcribe(batch)
        rtfx.append(len(batch) * 30.0 / (time.perf_counter() - t0))
        launches.append(read())
        del launches[-1]["K2"]
    if launches[0] != launches[1]:
        raise AssertionError(f"two searches of one batch launched {launches}")
    return {"rtfx_cold": rtfx[0], "rtfx": rtfx[1], "launches_per_search": launches[1],
            "steps": rec.searcher.last_steps}


@torch.no_grad()
def phase_conformer_decoder(cd, state):
    """S2S/conmamba_small.yaml with model.decoder_module=conformer (seeded,
    full width) in bf16 with the YAML's decode stanza: two B8 x 30 s
    searches in turn (the prefix re-score, the decoder's only path), the
    S2S RTFx of each and K1 / K3 / K4 per search. Its checks against the
    CPU are `conformer_decoder_parity`'s."""
    from mamba_asr_torch.serving.recognizer import Recognizer

    d = cd.decode
    if (d.s2s_test_beam_size, d.ctc_weight_decode, d.ctc_candidates) != (66, 0.4, 96):
        raise AssertionError(f"conformer_decoder: not the YAML's decode stanza {d}")
    rec8 = Recognizer(cd.model, cd.frontend, state, device="cuda", batch=8, decode=d,
                      search="s2s")
    timed = timed_searches(rec8, [noise(30.0, 500 + i) for i in range(8)])
    st = timed["steps"]
    if timed["launches_per_search"] != {"K1": 2 * cd.model.num_encoder_layers, "K3": st,
                                        "K4": 0}:
        raise AssertionError(f"conformer_decoder launches per search {timed}")
    result = {"phase": "conformer_decoder", "config": S2S_CONFIG,
              "override": CONFORMER_DECODER, "batch": 8, "seconds_each": 30.0,
              "beam": d.s2s_test_beam_size, "ctc": [d.ctc_weight_decode, d.ctc_candidates],
              "compute_dtype": cd.model.compute_dtype, **timed}
    emit(result)
    return result


@torch.no_grad()
def phase_conformer_decoder_parity(cd, state):
    """The Conformer decoder (as `conformer_decoder`) in fp32 (TF32 off,
    cuDNN off), card against CPU: the teacher-forced seq log-probs of a
    padded B2 x 4 s batch; the joint search at beam PARITY_BEAM on a B2 x 2 s
    batch without and with a seeded full-width LM (tokens equal, scores
    within S2S_PARITY_TOL; K4 only for the LM); one S2S micro-step
    (dropout 0, SpecAugment off) held as train_parity holds it. No timing
    is read: it runs while this process waits for the Mamba floor run."""
    from mamba_asr_torch.kernels import selective_scan as k1
    from mamba_asr_torch.serving.recognizer import Recognizer, eval_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = False
    d, vocab = cd.decode, cd.model.vocab_size
    cfg32 = dataclasses.replace(cd.model, compute_dtype="float32")
    recs = {dev: Recognizer(cfg32, cd.frontend, state, device=dev) for dev in ("cuda", "cpu")}
    wav, lens = parity_batch(51)
    rng = np.random.default_rng(SEED + 13)
    bos = torch.from_numpy(rng.integers(3, vocab, (2, 21))).long()
    bos[:, 0] = 1
    bos[1, 15:] = 0
    seq = {dev: eval_step(rec.model, cd.frontend, rec.normalizer, wav, lens, bos)
           ["seq_log_probs"].cpu() for dev, rec in recs.items()}
    seq_err = check_close("conformer_decoder_parity seq_log_probs", seq["cuda"], seq["cpu"],
                          S2S_PARITY_TOL, 0.0)

    lm_cpu = seeded_lm(d, vocab, SEED + 14)
    lms = {"cpu": lm_cpu, "cuda": copy.deepcopy(lm_cpu).to("cuda")}
    req, req_lens = parity_batch(53, (2.0, 1.55))
    search = {}
    for fused in (False, True):
        found = {}
        for dev, rec in recs.items():
            out = rec.eval_step(req, req_lens)
            found[dev] = parity_search(rec.model, out, d, lms[dev] if fused else None)
        got, steps, launches = found["cuda"]
        want = {"K1": 0, "K3": steps, "K4": d.lm_layers * steps if fused else 0}
        if launches != want:
            raise AssertionError(f"conformer_decoder_parity search launches {launches}, "
                                 f"want {want}")
        name = "lm" if fused else "no_lm"
        search[name] = {"score_max_abs_err": same_search(f"conformer_decoder_parity {name}",
                                                         got, found["cpu"][0]),
                        "scores": got[2].tolist(), "lengths": got[1].tolist(),
                        "steps": steps, "launches": launches}
    del recs, lms, lm_cpu

    with torch.enable_grad():
        cfg32t, spec = fp32_step_setup(cd)
        batch = s2s_batch(char_batch(2, 4.0, 20, 3, vocab))
        runs = {}
        for dev in ("cuda", "cpu"):
            torch.backends.cudnn.enabled = dev != "cuda"
            k1.LAUNCHES = k1.BWD_LAUNCHES = 0
            runs[dev] = dict(zip(("losses", "grads"),
                                 step_grads(cd, spec, cfg32t, state, batch, dev)[:2]))
            if dev == "cuda" and (k1.LAUNCHES, k1.BWD_LAUNCHES) != (scans_per_step(cfg32t),) * 2:
                raise AssertionError(f"conformer_decoder_parity micro-step launched K1, K2 "
                                     f"{(k1.LAUNCHES, k1.BWD_LAUNCHES)} times")
    torch.backends.cudnn.enabled = True
    torch.backends.cudnn.allow_tf32 = True  # back to PyTorch's defaults
    loss_errs, worst, worst_name = card_vs_cpu("conformer_decoder_parity", runs["cuda"],
                                               runs["cpu"])
    losses = {dev: r["losses"] for dev, r in runs.items()}
    del runs

    result = {"phase": "conformer_decoder_parity", "tol": S2S_PARITY_TOL,
              "seq_log_probs_max_abs_err": seq_err, "search_beam": PARITY_BEAM, "search": search,
              "train": {"losses": losses, "loss_rel_errs": loss_errs,
                        "grad_max_rel_err": worst, "grad_worst_param": worst_name,
                        "tol": {"loss_rtol": TRAIN_LOSS_RTOL, "grad": TRAIN_GRAD_TOL}}}
    emit(result)
    return result


def large_experiments():
    """The ConMamba-Large YAMLs' configs and seeded weights (CPU)."""
    from mamba_asr_torch.configs.loader import load_config

    exps = {path: load_config(path) for path in CONMAMBA_LARGE}
    return exps, {path: seeded_state(exp.model) for path, exp in exps.items()}


@torch.no_grad()
def phase_conmamba_large(exps, states):
    """The ConMamba-Large YAMLs (CTC/conmamba_large, S2S/conmamba_large,
    S2S/conmambamamba_large), seeded at full width: one bf16 recognise
    each on the card as one timed block (CTC: LARGE_CTC_CALLS calls at
    B32 x 30 s after one warm-up call; S2S: a first and a second search
    at B8 x 30 s with the YAML's decode stanza, each timed), RTFx,
    launches and peak memory. Their
    micro-steps are `conmamba_large_parity`'s."""
    from mamba_asr_torch.kernels import selective_scan as k1
    from mamba_asr_torch.serving.recognizer import Recognizer

    result = {"phase": "conmamba_large"}
    for path in CONMAMBA_LARGE:
        cfg, exp = exps[path].model, exps[path]
        torch.cuda.reset_peak_memory_stats()
        if cfg.num_decoder_layers > 0:
            d = exp.decode
            rec = Recognizer(cfg, exp.frontend, states[path], device="cuda", batch=8, decode=d,
                             search="s2s")
            entry = timed_searches(rec, [noise(30.0, 600 + i) for i in range(8)])
            st = entry["steps"]
            mamba = cfg.decoder_module == "mamba"
            want = {"K1": 2 * cfg.num_encoder_layers + (cfg.num_decoder_layers if mamba else 0),
                    "K3": st, "K4": 0 if mamba else cfg.num_decoder_layers * st}
            if entry["launches_per_search"] != want:
                raise AssertionError(f"conmamba_large {path}: launches {entry}, want {want}")
            entry = {"batch": 8, "seconds_each": 30.0, "beam": d.s2s_test_beam_size, **entry}
        else:
            rec = Recognizer(cfg, exp.frontend, states[path], device="cuda", batch=32)
            batch = [noise(30.0, 600 + i) for i in range(32)]
            rec.transcribe(batch)  # warm-up
            k1.LAUNCHES = 0
            t0 = time.perf_counter()
            for _ in range(LARGE_CTC_CALLS):
                rec.transcribe(batch)
            rtfx = 32 * 30.0 * LARGE_CTC_CALLS / (time.perf_counter() - t0)
            if k1.LAUNCHES != 2 * cfg.num_encoder_layers * LARGE_CTC_CALLS:
                raise AssertionError(f"conmamba_large {path}: K1 {k1.LAUNCHES}")
            entry = {"batch": 32, "seconds_each": 30.0, "calls": LARGE_CTC_CALLS, "rtfx": rtfx,
                     "k1_launches_per_call": k1.LAUNCHES // LARGE_CTC_CALLS}
        del rec
        result[yaml_name(path)] = {
            "d_model": cfg.d_model, "layers": [cfg.num_encoder_layers, cfg.num_decoder_layers],
            "decoder": cfg.decoder_module if cfg.num_decoder_layers else None,
            "compute_dtype": cfg.compute_dtype, **entry,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    result["remat"] = large_remat(exps[CONMAMBA_LARGE[0]], states[CONMAMBA_LARGE[0]])
    emit(result)
    return result


@torch.enable_grad()  # phase_conmamba_large runs under no_grad
def large_remat(exp, state):
    """CTC/conmamba_large with the YAML's settings (bf16, dropout,
    SpecAugment) at LARGE_REMAT_BATCH: micro-steps of one Trainer without
    and with model.remat_layers, in turn, twice; the second of each gives
    its wall ms and its peak memory above the weights and optimizer
    state. K1 twice per scan with remat, K2 once."""
    bsz, seconds = LARGE_REMAT_BATCH
    batch = char_batch(bsz, seconds, 600, 7, exp.model.vocab_size)
    order = (False, True, False, True)
    runs = remat_steps(exp, state, batch, order)
    per_step = scans_per_step(exp.model)
    for (_, _, launches, losses, _), remat in zip(runs, order):
        if launches != {"K1": per_step * (2 if remat else 1), "K2": per_step}:
            raise AssertionError(f"conmamba_large remat={remat}: launches {launches}")
        if not all(np.isfinite(v.item()) for v in losses):
            raise AssertionError(f"conmamba_large remat={remat}: losses {losses}")
    (plain_ms, plain_gb, *_), (ms, gb, launches, *_) = runs[2], runs[3]
    if not plain_gb > gb:
        raise AssertionError(f"conmamba_large: remat peak {gb} GB not below {plain_gb} GB")
    return {"config": CONMAMBA_LARGE[0], "batch": bsz, "seconds_each": seconds,
            "compute_dtype": exp.model.compute_dtype,
            "first_walls_ms": [runs[0][0], runs[1][0]],
            "plain": {"wall_ms": plain_ms, "peak_above_state_gb": plain_gb},
            "remat": {"wall_ms": ms, "peak_above_state_gb": gb}, "launches": launches}


def phase_conmamba_large_parity(exps, states):
    """One fp32 micro-step of each ConMamba-Large YAML (TF32 and cuDNN off,
    dropout 0, SpecAugment off, B2 x 4 s), card against CPU as
    train_parity holds it. No timing is read: it runs while this process
    waits for the Mamba floor run."""
    from mamba_asr_torch.kernels import selective_scan as k1

    result = {"phase": "conmamba_large_parity",
              "tol": {"loss_rtol": TRAIN_LOSS_RTOL, "grad": TRAIN_GRAD_TOL}}
    for path in CONMAMBA_LARGE:
        exp = exps[path]
        cfg32, spec = fp32_step_setup(exp)
        batch = char_batch(2, 4.0, 20, 3, exp.model.vocab_size)
        if exp.model.num_decoder_layers > 0:
            batch = s2s_batch(batch)
        runs = {}
        for dev in ("cuda", "cpu"):
            torch.backends.cudnn.enabled = dev != "cuda"
            k1.LAUNCHES = k1.BWD_LAUNCHES = 0
            runs[dev] = dict(zip(("losses", "grads"),
                                 step_grads(exp, spec, cfg32, states[path], batch, dev)[:2]))
            want = (scans_per_step(cfg32),) * 2
            if dev == "cuda" and (k1.LAUNCHES, k1.BWD_LAUNCHES) != want:
                raise AssertionError(f"conmamba_large_parity {path}: K1, K2 "
                                     f"{(k1.LAUNCHES, k1.BWD_LAUNCHES)}, want {want}")
        torch.backends.cudnn.enabled = True
        torch.backends.cudnn.allow_tf32 = True  # back to PyTorch's defaults
        loss_errs, worst, worst_name = card_vs_cpu(f"conmamba_large_parity {path}",
                                                   runs["cuda"], runs["cpu"])
        result[yaml_name(path)] = {
            "losses": {dev: r["losses"] for dev, r in runs.items()},
            "loss_rel_errs": loss_errs, "params": len(runs["cpu"]["grads"]),
            "grad_max_rel_err": worst, "grad_worst_param": worst_name,
            "launches": {"K1": scans_per_step(cfg32), "K2": scans_per_step(cfg32)}}
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


def export_round_trip(work, name, config, save, files, overrides, expect):
    """`python -m mamba_asr_torch.export_torch` (in-process) of a save
    dir's averaged checkpoints, then `recognize --torch_ckpt
    --torch_normalizer` on the export: its lines must be `expect`."""
    from mamba_asr_torch import export_torch, recognize

    out_dir = os.path.join(work, f"export_{name}")
    t0 = time.perf_counter()
    wrote = cli_lines(export_torch.main, [config, "--ckpt_dir", save, "--out_dir", out_dir,
                                          "--device", "cuda", *overrides])
    export_s = time.perf_counter() - t0
    lines = cli_lines(recognize.main, [
        config, *files, "--torch_ckpt", os.path.join(out_dir, "model.ckpt"),
        "--torch_normalizer", os.path.join(out_dir, "normalizer.ckpt"), "--device", "cuda",
        *overrides])
    if lines != expect:
        raise AssertionError(f"recognize_cli: {name} export --torch_ckpt lines {lines} != "
                             f"the test pass's {expect}")
    return {"tokens_equal_test_pass": True, "export_s": export_s, "wrote": wrote[-1],
            "files": sorted(os.listdir(out_dir))}


def phase_recognize_cli(work, corpus, floor_tr, s2s_floor):
    """Recognition's CLIs on the card, in-process, on the floor runs'
    checkpoints and test files: `python -m mamba_asr_torch.recognize
    --ckpt_dir` with --beam 100 (tokens equal to the trainer's CTC-beam
    test pass on the same averaged checkpoints), --timestamps (word times
    increase and end within each file, one encoder frame of center padding
    allowed), --streaming (transcripts reported beside the greedy ones);
    --s2s on the S2S floor run (tokens equal to its test pass's joint
    search); `python -m mamba_asr_torch.evaluate` on the CTC floor
    experiment (its test WER); each floor run's averaged checkpoints
    exported (`export_round_trip`) and recognised from the export."""
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
    exported = {"ctc": export_round_trip(work, "ctc", CONFIG, os.path.join(out_dir, "save"),
                                         [*paths, "--beam", "100", "--batch", "8"], ctc_over,
                                         expect)}
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
    exported["s2s"] = export_round_trip(
        work, "s2s", S2S_CONFIG, os.path.join(s2s_cfg.output_folder, "save"),
        [*[u.path for u in s2s_utts], "--s2s"], s2s_over, expect)
    result["export"] = exported

    t0 = time.perf_counter()
    lines = cli_lines(evaluate.main, [CONFIG, *ctc_over, "--device", "cuda"])
    want_line = f"test-clean: {floor_tr.test_stats['test-clean']}"
    if lines[-1] != want_line:
        raise AssertionError(f"recognize_cli: evaluate printed {lines[-1]!r}, the floor run "
                             f"{want_line!r}")
    result["evaluate"] = {"line": lines[-1], "s": time.perf_counter() - t0}
    emit(result)
    return result


# -- exported bundles -------------------------------------------------------------------

BUNDLE_CTC = (32, 30.0)      # the CTC bucket: B32 x 30 s
BUNDLE_S2S = (8, 30.0)       # the S2S buckets: B8 x 30 s
BUNDLE_SLOTS = 32            # the streaming bundle's slots (its checks use 8 streams)
BUNDLE_STREAMS = (8, 6.0)    # streams of 6 s noise through both engines
BUNDLE_TICKS = 12            # steady ticks each, bundle and live engine in turn
BUNDLE_CTC_CALLS = 5         # CTC calls each, in turn
BUNDLE_LP_TOL = 1e-3         # CTC log-probs, bundle against the live forward (bf16)
BUNDLE_EXPORT_TIMEOUT_S = 400
CAUSAL = {"model.causal": True, "model.bidirectional": False}


def bundle_batch(bsz, seconds, seed):
    """Noise rows of seconds * (0.7 .. 1.0), the longest full: numpy (B, T)
    zero-padded, lengths (B,) int32."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    lens = np.sort(rng.integers(int(0.7 * n), n, bsz)).astype(np.int32)[::-1].copy()
    lens[0] = n
    wav = np.zeros((bsz, n), np.float32)
    for i, m in enumerate(lens):
        wav[i, :m] = noise(m / 16000, seed * 100 + i)
    return wav, lens


def start_export(work, name, config, state, flags, overrides=()):
    """Start `python -m mamba_asr_torch.export_model <config> --torch_ckpt
    <the seeded state> --out <work>/<name> --device cuda <flags>` in a
    process of its own: (bundle dir, the process, its log's path)."""
    ckpt = os.path.join(work, f"{name}_model.pt")
    torch.save(state, ckpt)
    out, log = os.path.join(work, name), os.path.join(work, f"{name}_export.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mamba_asr_torch.export_model", config, "--torch_ckpt",
             ckpt, "--out", out, "--device", "cuda", *flags, *overrides],
            stdout=f, stderr=subprocess.STDOUT, env={**os.environ, "OMP_NUM_THREADS": "2"})
    return out, proc, log


def finish_export(out, proc, log, timeout):
    """Wait for an export: (its seconds as the CLI printed them, MB by file)."""
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
    with open(log) as f:
        text = f.read()
    done = re.search(r"exported a \w+ bundle .* in ([0-9.]+) s", text)
    if rc != 0 or not done:
        raise AssertionError(f"bundles: export_model exited {rc}:\n{text[-3000:]}")
    sizes = {f: os.path.getsize(os.path.join(out, f)) / 1e6 for f in sorted(os.listdir(out))}
    return float(done.group(1)), sizes


def restored(config, work, name, overrides=None):
    """The model and normaliser `cli.restore_asr_state` gives from the same
    state dict the export read (on the card)."""
    from mamba_asr_torch.cli import restore_asr_state
    from mamba_asr_torch.configs.loader import load_config

    cfg = load_config(config, overrides or {})
    model, norm = restore_asr_state(cfg, torch_ckpt=os.path.join(work, f"{name}_model.pt"),
                                    device="cuda")
    return cfg, model, norm


def check_search(name, got, ref):
    toks, lens, scores = (np.asarray(x) for x in got)
    rtoks, rlens, rscores = (x.cpu().numpy() for x in ref)
    if not (np.array_equal(toks, rtoks) and np.array_equal(lens, rlens)):
        raise AssertionError(f"bundles {name}: tokens differ from the live search "
                             f"(lengths {lens.tolist()} against {rlens.tolist()})")
    return float(np.abs(scores - rscores).max())


def start_bundle_exports(work, s2s, states):
    """Start the four exports of phase `bundles` at once, a process each
    (an export is host-bound): CTC at BUNDLE_CTC, S2S/conmamba_small with
    the seeded LM of lm_recognize and the Mamba decoder at BUNDLE_S2S, the
    causal unidirectional ConMamba-Small's engine at BUNDLE_SLOTS slots.
    states: the seeded state dicts of the CTC, S2S and Mamba-decoder
    YAMLs. Returns {name: (bundle dir, process, log)}."""
    from mamba_asr_torch.configs.loader import load_config

    lm_path = os.path.join(work, "seeded_lm.pt")
    if not os.path.exists(lm_path):
        torch.save(seeded_lm(s2s.decode, s2s.model.vocab_size, SEED + 12).state_dict(),
                   lm_path)
    ctc_b, s2s_b = BUNDLE_CTC, BUNDLE_S2S
    s2s_flags = ["--s2s", "--batches", str(s2s_b[0]), "--seconds", str(s2s_b[1])]
    return {
        "ctc": start_export(work, "bundle_ctc", CONFIG, states["ctc"],
                            ["--batches", str(ctc_b[0]), "--seconds", str(ctc_b[1])]),
        "s2s_lm": start_export(work, "bundle_s2s_lm", S2S_CONFIG, states["s2s"], s2s_flags,
                               [f"--decode.lm_path={lm_path}"]),
        "s2s_mamba": start_export(work, "bundle_s2s_mamba", MAMBA_CONFIG, states["mamba"],
                                  s2s_flags),
        "streaming": start_export(
            work, "bundle_stream", CONFIG, seeded_state(load_config(CONFIG, CAUSAL).model),
            ["--streaming", "--slots", str(BUNDLE_SLOTS), "--chunk_frames",
             str(STREAM_CHUNK_FRAMES)], [f"--{k}={str(v).lower()}" for k, v in CAUSAL.items()]),
    }


def phase_bundles(work, exports):
    """The three bundles that `start_bundle_exports` exported through python
    -m mamba_asr_torch.export_model --device cuda from the full-width
    seeded YAMLs (bf16), each checked against the port's live path on the
    same inputs; no time is read here but the exports' (the exports run
    beside the floor runs, the checks after the S2S floor run)."""
    from mamba_asr_torch.decoding.ctc_greedy import ctc_greedy_decode
    from mamba_asr_torch.serving.engine import StreamingServer
    from mamba_asr_torch.serving.export import (ExportedASR, ExportedStreamingServer,
                                                program_launches)
    from mamba_asr_torch.serving.recognizer import Recognizer

    reset, read = s2s_launch_counters()
    ctx, result = {}, {"phase": "bundles"}
    try:
        done = {name: finish_export(*e, timeout=BUNDLE_EXPORT_TIMEOUT_S)
                for name, e in exports.items()}
    finally:
        for _, proc, _ in exports.values():
            if proc.poll() is None:
                proc.kill()
    lm_path = os.path.join(work, "seeded_lm.pt")

    # CTC at B32 x 30 s.
    bsz, seconds = BUNDLE_CTC
    out = exports["ctc"][0]
    export_s, sizes = done["ctc"]
    asr = ExportedASR(out)
    cfg, model, norm = restored(CONFIG, work, "bundle_ctc")
    rec = Recognizer.from_model(model, norm, cfg.frontend, batch=bsz)
    wav, lens = bundle_batch(bsz, seconds, 31)
    reset()
    lp, el = asr(wav, lens)
    ctc_launches = read()["K1"]
    live = rec.eval_step(torch.from_numpy(wav), torch.from_numpy(lens))
    err = check_close("bundles ctc log-probs", torch.from_numpy(lp), live["ctc_log_probs"].cpu(),
                      BUNDLE_LP_TOL, 0.0)
    toks, tl = ctc_greedy_decode(torch.from_numpy(lp), torch.from_numpy(el))
    rtoks, rtl = ctc_greedy_decode(live["ctc_log_probs"].cpu(), live["enc_lengths"].cpu())
    if not (torch.equal(toks, rtoks) and torch.equal(tl, rtl)):
        raise AssertionError("bundles ctc: greedy tokens differ from the live Recognizer's")
    per_forward = scans_per_step(cfg.model)
    graph = program_launches(asr)
    if ctc_launches != per_forward or list(graph.values()) != [
            {"selective_scan_fwd": per_forward}]:
        raise AssertionError(f"bundles ctc: K1 {ctc_launches}, graph {graph}")
    result["ctc"] = {"bucket": [bsz, seconds], "export_s": export_s, "mb": sizes,
                     "logprob_max_abs_err": err, "k1_launches": ctc_launches, "graph": graph}
    ctx["ctc"] = (asr, rec, wav, lens)

    # S2S at B8 x 30 s: the Transformer decoder with the seeded LM, the Mamba
    # decoder without, the YAML's decode stanzas; the same padded batch as
    # the live searcher's.
    bsz, seconds = BUNDLE_S2S
    for name, config, lm in (("s2s_lm", S2S_CONFIG, lm_path), ("s2s_mamba", MAMBA_CONFIG, "")):
        over = {"decode.lm_path": lm} if lm else {}
        out = exports[name][0]
        export_s, sizes = done[name]
        asr = ExportedASR(out)
        cfg, model, norm = restored(config, work, f"bundle_{name}", over)
        rec = Recognizer.from_model(model, norm, cfg.frontend, batch=bsz, decode=cfg.decode,
                                    search="s2s")
        wav, lens = bundle_batch(bsz, seconds, 41)
        reset()
        got = asr(wav, lens)
        launches = read()
        o = rec.eval_step(torch.from_numpy(wav), torch.from_numpy(lens))
        ref = rec.searcher(o["enc_out"], o["enc_lengths"], o["ctc_log_probs"])
        score_err = check_search(name, got, ref)
        st = asr.last_steps
        if st != rec.searcher.last_steps:
            raise AssertionError(f"bundles {name}: {st} steps against the live search's "
                                 f"{rec.searcher.last_steps}")
        lm_layers = cfg.decode.lm_layers if lm else 0
        dec = cfg.model.num_decoder_layers
        mamba = cfg.model.decoder_module == "mamba"
        want = {"K1": scans_per_step(dataclasses.replace(cfg.model, num_decoder_layers=0))
                + (dec if mamba else 0), "K2": 0, "K3": st,
                "K4": ((0 if mamba else dec) + lm_layers) * st}
        if launches != want:
            raise AssertionError(f"bundles {name}: launches {launches}, expected {want}")
        result[name] = {"bucket": [bsz, seconds], "export_s": export_s, "mb": sizes,
                        "steps": st, "launches_per_search": launches,
                        "score_max_abs_diff": score_err, "best_lengths": got[1].tolist(),
                        "graph": program_launches(asr)}
        ctx[name] = (asr, rec, wav, lens)

    # Streaming: ConMamba-Small made causal and unidirectional, BUNDLE_SLOTS
    # slots, 640 ms chunks; 8 streams of 6 s through the bundle and the
    # live engine: transcripts equal.
    out = exports["streaming"][0]
    export_s, sizes = done["streaming"]
    cfg, model, norm = restored(CONFIG, work, "bundle_stream", CAUSAL)
    live = StreamingServer(model, cfg.frontend, norm, n_slots=BUNDLE_SLOTS,
                           chunk_frames=STREAM_CHUNK_FRAMES)
    bundle = ExportedStreamingServer(out)
    count, secs = BUNDLE_STREAMS
    wavs = [noise(secs, 700 + i) for i in range(count)]
    reset()
    got = drive_engine(bundle, wavs, 17)
    stream_launches = read()["K1"]
    want = drive_engine(live, wavs, 17)
    if got != want or not any(want.values()):
        raise AssertionError(f"bundles streaming: transcripts differ {got} / {want}")
    graph = program_launches(bundle)
    if any(g != {"selective_scan_fwd": per_forward // 2} for g in graph.values()):
        raise AssertionError(f"bundles streaming: graphs {graph}")
    result["streaming"] = {"slots": BUNDLE_SLOTS, "streams": [count, secs],
                           "export_s": export_s, "mb": sizes, "k1_launches": stream_launches,
                           "ticks": bundle.stats()["ticks_total"], "graph": graph,
                           "clamped": bundle.clamped}
    ctx["streaming"] = (bundle, live)
    emit(result)
    return result, ctx


def filled(engine, seed):
    """Every slot of `engine` holding a promoted noise stream (the bootstrap
    and two ticks), and a feed() handing each stream its next chunk."""
    rng = np.random.default_rng(seed)
    sids = [engine.attach() for _ in range(engine.n_slots)]

    def feed():
        for sid in sids:
            engine.feed(sid, rng.normal(0.0, 0.1, STREAM_CHUNK_FRAMES * 160).astype(np.float32))

    for _ in range(3):
        feed()
        engine.tick()
    return feed


BUNDLE_STEP_AT = 128         # the S2S+LM steps run before the timed and profiled steps
BUNDLE_STEPS = 8             # steps timed, then steps profiled, each side


@torch.no_grad()
def s2s_steps(side, asr, rec, wav, lens):
    """The S2S+LM search of one side at step BUNDLE_STEP_AT, and a function
    that runs its next n steps: the bundle's init and step programs
    (ExportedASR's loop) or the live searcher's init and step."""
    from mamba_asr_torch.ops.beam_attention import StepPos
    from mamba_asr_torch.serving.export import _fn_file

    wav_d, lens_d = torch.from_numpy(wav).cuda(), torch.from_numpy(lens).cuda()
    if side == "bundle":
        w = asr._weights()
        state = asr.programs(_fn_file(*asr.buckets[0], "init"))(*w, wav_d, lens_d)
        program = asr.programs(_fn_file(*asr.buckets[0], "step"))

        def step(s, s_dev):
            return program(*w, state, s, s_dev)
    else:
        o = rec.eval_step(torch.from_numpy(wav), torch.from_numpy(lens))
        state = rec.searcher.init(o["enc_out"], o["enc_lengths"], o["ctc_log_probs"])

        def step(s, s_dev):
            return rec.searcher.step(state, StepPos(s, s_dev))
    on_device = torch.arange(state["tokens"].shape[1], device="cuda")
    at = [0]

    def run(n):
        for _ in range(n):
            s = at[0]
            state.update(step(torch.tensor(s), on_device[s]))
            bool(state["finished"].all())  # the loop's one sync a step
            at[0] += 1
    run(BUNDLE_STEP_AT)
    return run


def step_profile(runs):
    """runs: {side: a function that runs that side's next n steps}.
    BUNDLE_STEPS steps of each side timed on the host's clock, one step of
    each side in turn (step_ms: the median), then BUNDLE_STEPS more of
    each side under torch.profiler (the host's operators and the card).
    Per side and step: ATen and mamba_asr op calls, their self host ms, the
    rest of the step's time (Python between the ops, against the
    unprofiled step), the host's waits on the card (cudaStreamSynchronize,
    cudaDeviceSynchronize, cudaEventSynchronize, cudaMemcpy calls) and
    the card's kernel ms; the top ops by self host time."""
    from torch.profiler import ProfilerActivity, profile

    from mamba_asr_torch.tools.timing import device_kernel_times

    n = BUNDLE_STEPS
    walls = {side: [] for side in runs}
    out = {}
    with torch.no_grad():
        for _ in range(n):
            for side, run in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(1)
                walls[side].append(1e3 * (time.perf_counter() - t0))
        for side, run in runs.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run(n)
                torch.cuda.synchronize()
            ops, waits = {}, 0
            for ev in prof.profiler.kineto_results.events():
                if ev.device_type() != torch.autograd.DeviceType.CPU:
                    continue
                name = ev.name()
                if name.startswith(("aten::", "mamba_asr::")):
                    ops.setdefault(name, [0, 0.0])[0] += 1
                elif name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                              "cudaEventSynchronize", "cudaMemcpy"):
                    waits += 1
            for avg in prof.key_averages():
                if avg.key in ops:
                    ops[avg.key][1] = avg.self_cpu_time_total / 1e3
            wall = statistics.median(walls[side])
            self_ms = sum(v[1] for v in ops.values()) / n
            top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:8]
            out[side] = {
                "step_ms": wall, "steps_ms": walls[side],
                "op_calls": sum(v[0] for v in ops.values()) / n,
                "op_self_host_ms": self_ms, "other_host_ms": wall - self_ms,
                "waits": waits / n,
                "device_ms": sum(us for us, _ in device_kernel_times(prof).values()) / 1e3 / n,
                "top": [{"op": k, "calls": c / n, "self_host_ms": t / n}
                        for k, (c, t) in top]}
    return out


def phase_bundles_timed(checked, ctx):
    """(after the floor runs) The bundles' wall times against the live
    paths', each pair in turn: CTC calls at B32 x 30 s (padding, H2D, the
    forward, the log-probs' D2H on both sides); one S2S+LM search each at
    B8 x 30 s; BUNDLE_TICKS steady ticks each at BUNDLE_SLOTS slots; a
    profiled CTC call and tick (K1 kernel events per program); S2S+LM
    steps of the bundle's step program against the live searcher's step
    (`step_profile`, the host's time per op); the
    `mamba_asr::beam_attention` op's host cost per call against its
    wrapper's."""
    from mamba_asr_torch.kernels import beam_attention as k4
    from mamba_asr_torch.kernels import ops as kernel_ops

    reset, read = s2s_launch_counters()
    asr, rec, wav, lens = ctx["ctc"]
    wav_t, lens_t = torch.from_numpy(wav), torch.from_numpy(lens)
    walls = {"bundle": [], "live": []}
    for _ in range(BUNDLE_CTC_CALLS):
        for side in ("bundle", "live"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if side == "bundle":
                asr(wav, lens)
            else:
                rec.eval_step(wav_t, lens_t)["ctc_log_probs"].cpu()
            walls[side].append(1e3 * (time.perf_counter() - t0))
    ctc = {side: {"median_ms": statistics.median(v), "ms": v} for side, v in walls.items()}
    reset()
    _, ctc_device_ms, top = device_profile(lambda: asr(wav, lens), 5, ("scan_fwd",))
    ctc["profile"] = {"k1_kernel_events": sum(r["calls"] for r in top if "scan_fwd" in r["kernel"]),
                      "k1_launches": read()["K1"], "device_ms": ctc_device_ms}

    asr, rec, wav, lens = ctx["s2s_lm"]
    s2s = {}
    for side in ("bundle", "live"):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if side == "bundle":
            asr(wav, lens)
        else:
            o = rec.eval_step(torch.from_numpy(wav), torch.from_numpy(lens))
            rec.searcher(o["enc_out"], o["enc_lengths"], o["ctc_log_probs"])[0].cpu()
        s2s[side] = {"wall_ms": 1e3 * (time.perf_counter() - t0), "launches": read()}
    steps = step_profile({side: s2s_steps(side, asr, rec, wav, lens)
                          for side in ("bundle", "live")})
    for side, row in steps.items():
        s2s[side]["steps"] = row

    bundle, live = ctx["streaming"]
    feeds = {"bundle": filled(bundle, 5), "live": filled(live, 5)}
    ticks = {"bundle": [], "live": []}
    engines = {"bundle": bundle, "live": live}
    for _ in range(BUNDLE_TICKS):
        for side in ("bundle", "live"):
            feeds[side]()
            reset()
            t0 = time.perf_counter()
            engines[side].tick()
            ticks[side].append((1e3 * (time.perf_counter() - t0), read()["K1"]))
    stream = {side: {"median_ms": statistics.median(t for t, _ in v),
                     "p95_ms": percentile([t for t, _ in v], 95),
                     "k1_per_tick": sorted({k for _, k in v})} for side, v in ticks.items()}
    feeds["bundle"]()
    reset()
    _, tick_device_ms, top = device_profile(bundle.tick, 5, ("scan_fwd",))
    stream["profile"] = {"k1_kernel_events": sum(r["calls"] for r in top
                                                 if "scan_fwd" in r["kernel"]),
                         "k1_launches": read()["K1"], "device_ms": tick_device_ms}

    # The op's dispatch against the wrapper's, at the S2S decoder's K4 shape.
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, kb, vb = (torch.randn(*s, generator=g, device="cuda", dtype=torch.bfloat16)
                 for s in ((528, 4, 36), (4, 320, 528, 36), (4, 320, 528, 36)))
    anc = torch.randint(0, 528, (320, 528), generator=g, device="cuda", dtype=torch.int32)
    pos = torch.tensor(255)
    host_us = {}
    for name, fn in (("op", lambda: kernel_ops.beam_attention(q, kb, vb, anc, pos)),
                     ("wrapper", lambda: k4.beam_attention_fwd(q, kb, vb, anc, 255))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host_us[name] = 1e6 * (time.perf_counter() - t0) / 200
        torch.cuda.synchronize()
    result = {"phase": "bundles_timed", "ctc": ctc, "s2s_lm": s2s, "streaming_tick": stream,
              "k4_call_us": host_us,
              "export_s": {k: checked[k]["export_s"] for k in
                           ("ctc", "s2s_lm", "s2s_mamba", "streaming")}}
    emit(result)
    return result


# -- Phases side by side ---------------------------------------------------------
# The host-bound runs and the checks that read no time, each chain in a
# process of its own (`RankGroup("phase", ...)`, `join_beside`), beside
# this process's own checks; every timed phase runs alone.


def phase_parities(work):
    """The card-against-CPU checks of the CTC, S2S, Mamba-decoder, LM and
    Conformer paths on their YAMLs' seeded weights (`seeded_state` is the
    same in every process)."""
    from mamba_asr_torch.configs.loader import load_config

    exp = load_config(CONFIG)
    state = seeded_state(exp.model)
    timed(phase_parity, exp.model, exp.frontend, state)
    timed(phase_train_parity, exp, state)
    s2s, mam = load_config(S2S_CONFIG), load_config(MAMBA_CONFIG)
    s2s_state, mam_state = seeded_state(s2s.model), seeded_state(mam.model)
    timed(phase_s2s_parity, s2s.model, s2s.frontend, s2s_state)
    timed(phase_s2s_train_parity, s2s, s2s_state)
    timed(phase_mamba_dec_parity, mam, mam_state)
    timed(phase_lm_parity, s2s, s2s_state, mam, mam_state)
    del exp, state, s2s_state, mam_state
    conf = {path: load_config(path) for path in CONFORMER_CTC + CONFORMER_S2S}
    timed(phase_conformer_parity, conf, {path: seeded_state(e.model) for path, e in conf.items()})
    return {}


def phase_s2s_floor_lm(work):
    """The S2S floor run, then train_lm on its tokenizer and lm_floor on
    its checkpoints."""
    corpus = os.path.join(work, "corpus")
    s2s_floor = timed(phase_s2s_train_to_floor, work, corpus)
    lm_path = timed(phase_train_lm, work, s2s_floor)
    return {"s2s_floor": s2s_floor,
            "lm_floor_launches": timed(phase_lm_floor, work, corpus, s2s_floor, lm_path)}


def phase_recipes(work):
    """The CTC recipe, the CTC floor run and its bf16 check, the S2S
    recipes of both decoders; then, once phase_s2s_floor_lm has ended (its
    result file), recognition's CLIs on both floor runs."""
    corpus = os.path.join(work, "corpus")
    out = {"recipe": timed(phase_recipe, work, corpus)}
    floor = timed(phase_train_to_floor, work, corpus)
    timed(phase_bf16, floor)
    out["s2s_recipe"] = timed(phase_s2s_recipe, work, corpus)
    out["mamba_dec_recipe"] = timed(phase_mamba_dec_recipe, work, corpus)
    path = os.path.join(work, "s2s_floor_lm.json")
    wait_for_file(path, FLOOR_BESIDE_TIMEOUT_S)
    with open(path) as f:
        s2s_floor = json.load(f)["s2s_floor"]
    timed(phase_recognize_cli, work, corpus, floor, s2s_floor)
    return out


# {chain: OpenMP threads}: the parities' CPU references take the most; the
# host-bound runs are one Python thread each.
BESIDE = {"parities": 4, "mamba_dec_train_to_floor": 2, "s2s_floor_lm": 2, "recipes": 2}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from mamba_asr_torch.configs.loader import load_config

    script_t0 = time.perf_counter()
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
    launches, rec32, batch = timed(phase_recognize, cfg, frontend, state)
    timed(phase_profile, rec32, batch)
    train_launches, tr, train_batch = timed(phase_train, exp, state)
    timed(phase_train_profile, tr, train_batch)
    del tr, train_batch, rec32, batch
    dist = timed(phase_distributed_train, exp, state)
    s2s = load_config(S2S_CONFIG)
    k3 = timed(phase_kernel_ctc_dp, clock_hz, sms)
    k4 = timed(phase_kernel_beam_attn, s2s.model, clock_hz, sms)
    s2s_state = seeded_state(s2s.model)
    s2s_search, rec8, s2s_batch = timed(phase_s2s_recognize, s2s.model, s2s.frontend,
                                        s2s_state)
    per_search = s2s_search["launches_per_search"]
    timed(phase_s2s_profile, rec8, s2s_batch)
    del rec8, s2s_batch
    s2s_train_launches = timed(phase_s2s_train, s2s, s2s_state)
    mam = load_config(MAMBA_CONFIG)
    mk = timed(phase_mamba_dec_kernels, mam.model, clock_hz, sms)
    mam_state = seeded_state(mam.model)
    mam_search = timed(phase_mamba_dec_recognize, mam, mam_state)
    mam_train_launches = timed(phase_mamba_dec_train, mam, mam_state)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        lmk = timed(phase_lm_kernels, s2s.decode, clock_hz, sms)
        lm_search = timed(phase_lm_recognize, s2s, s2s_state, mam, mam_state, work,
                          s2s_search)
        cd = load_config(S2S_CONFIG, CONFORMER_DECODER)
        cd_state = seeded_state(cd.model)
        cdr = timed(phase_conformer_decoder, cd, cd_state)
        conf = {path: load_config(path) for path in CONFORMER_CTC + CONFORMER_S2S}
        ck = timed(phase_conformer_kernels, conf[CONFORMER_S2S[1]].model, clock_hz, sms)
        conf_states = {path: seeded_state(exp.model) for path, exp in conf.items()}
        conf_search = timed(phase_conformer_recognize, conf, conf_states)
        timed(phase_conformer_train, conf, conf_states)
        stream = timed(phase_streaming, exp, state, conf, conf_states, mam, mam_state,
                       clock_hz, sms)
        serving = timed(phase_serving, exp, state, s2s, s2s_state, mam, mam_state,
                        clock_hz, sms)
        del conf_states
        torch.cuda.empty_cache()  # the card's memory is shared from here on
        corpus = timed(phase_data, work)
        floor160_corpus(work)
        # The host-bound runs and the checks that read no time, side by
        # side: four chains in processes of their own (BESIDE), the
        # bundles' exports, and this process's own checks.
        beside = {name: RankGroup("phase", work, nproc=1, args=(name,), threads=threads,
                                  timeout=FLOOR_BESIDE_TIMEOUT_S)
                  for name, threads in BESIDE.items()}
        exports = start_bundle_exports(work, s2s, {"ctc": state, "s2s": s2s_state,
                                                   "mamba": mam_state})
        del mam_state, s2s_state
        try:
            timed(phase_distributed_recipe, work, corpus)
            large_exps, large_states = large_experiments()
            timed(phase_conmamba_large_parity, large_exps, large_states)
            cd_parity = timed(phase_conformer_decoder_parity, cd, cd_state)
            bundles, bundle_ctx = timed(phase_bundles, work, exports)
        except BaseException:
            for group in beside.values():
                group.kill()
            for _, proc, _ in exports.values():
                if proc.poll() is None:
                    proc.kill()
            raise
        side = join_beside(beside, work, "bundles")
        recipe_launches = side["recipes"]["recipe"]
        s2s_recipe_launches = side["recipes"]["s2s_recipe"]
        mam_recipe_launches = side["recipes"]["mamba_dec_recipe"]
        mam_floor_launches = side["mamba_dec_train_to_floor"]
        lm_floor_launches = side["s2s_floor_lm"]["lm_floor_launches"]
        # Every phase after this one reads time, alone on the card.
        bundles_timed = timed(phase_bundles_timed, bundles, bundle_ctx)
        del bundle_ctx
        large = timed(phase_conmamba_large, large_exps, large_states)
        del large_states, cd_state
        timed(phase_ctc_beam, exp)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    emit({"script_wall_s": time.perf_counter() - script_t0})
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
        "serving_replicas_launches_per_tick": serving["replicas_tick"]["k1_per_tick"],
        "serving_launches_per_tick": {
            row["n_slots"]: row["k1_launches_per_tick"] for row in serving["capacity"]["rows"]},
        **{f"serving_{key}": serving["kernel"][key] for key in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")},
        "conformer_decoder_launches_per_search":
            cdr["launches_per_search"]["K1"],
        "conmamba_large_launches": {
            name: e["launches_per_search"]["K1"] if "launches_per_search" in e
            else e["k1_launches_per_call"] for name, e in large.items()
            if name not in ("phase", "remat")},
        "bundle_launches": {
            "ctc_forward": bundles["ctc"]["k1_launches"],
            "stream_tick": bundles_timed["streaming_tick"]["bundle"]["k1_per_tick"],
            **{f"{name}_search": bundles[name]["launches_per_search"]["K1"]
               for name in ("s2s_lm", "s2s_mamba")}},
    }, {
        "name": "selective_scan_fwd_train", "route": "cuda",
        "source": "mamba_asr_torch/csrc/selective_scan_fwd.cu",
        "replaces": "mamba_asr_tpu/ops/pallas/scan.py:320",
        "launches": train_launches["K1"],
        "max_abs_err": kb["cases"][0]["chunk_states_max_abs_err"],
        "ms": fwd_train["kernel_ms"], "plain_ms": k["plain_ms"],
        "bound_ms": fwd_train["bound_ms"], "bound_by": fwd_train["bound_by"],
        "library_ms": None, "s2s_train_launches": s2s_train_launches["K1"],
        "sp_train_launches": dist["sp_train_launches"]["K1"],
        "pp_train_launches_per_rank": dist["pp_train_launches"]["K1"],
        "tp_train_launches_per_rank": dist["tp_train_launches"]["K1"],
        "remat_train_launches": train_launches["remat"]["K1"],
        "conmamba_large_remat_train_launches": large["remat"]["launches"]["K1"],
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
        "sp_train_launches": dist["sp_train_launches"]["K2"],
        "pp_train_launches_per_rank": dist["pp_train_launches"]["K2"],
        "tp_train_launches_per_rank": dist["tp_train_launches"]["K2"],
        "remat_train_launches": train_launches["remat"]["K2"],
        "conmamba_large_remat_train_launches": large["remat"]["launches"]["K2"],
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
        "serving_final_launches": {name: serving["finals"][name]["launches"]["K3"]
                                   for name in ("s2s", "s2s_mamba_decoder")},
        "conformer_decoder_launches_per_search": {
            "beam66_no_lm": cdr["launches_per_search"]["K3"],
            "beam4_lm": cd_parity["search"]["lm"]["launches"]["K3"]},
        "bundle_launches_per_search": {name: bundles[name]["launches_per_search"]["K3"]
                                       for name in ("s2s_lm", "s2s_mamba")},
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
        "serving_final_launches": {"s2s": serving["finals"]["s2s"]["launches"]["K4"]},
        "conformer_decoder_launches_per_search": {
            "beam66_no_lm": cdr["launches_per_search"]["K4"],
            "beam4_lm": cd_parity["search"]["lm"]["launches"]["K4"]},
        "bundle_launches_per_search": {name: bundles[name]["launches_per_search"]["K4"]
                                       for name in ("s2s_lm", "s2s_mamba")},
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
        **{f"{mode}_{key}": row[key] for mode, row in probe["by_mode"].items()
           if mode != "dependent" for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--rank-worker":
        sys.exit(rank_worker(sys.argv[2:]))
    sys.exit(main())
