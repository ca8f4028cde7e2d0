"""Train to floor: the port's whole CTC or S2S recipe drives test WER to
~0 on a learnable synthetic corpus (the port's copy of
scripts/train_to_floor.py).

Each letter of a small alphabet is a pure tone; utterances are words
spelled from those letters with silent gaps, in LibriSpeech's layout.
The tool builds that corpus, runs the port's CLI on it
(`cli.run_training`: manifests, char tokenizer, bucketed loading, the
training steps, top-k checkpoints, averaging, the CTC prefix beam
search or the joint beam search, the wer file) and checks the test WER
against --target.

    python -m mamba_asr_torch.tools.train_to_floor [--mode ctc|s2s]
        [--epochs 60] [--target 2.0] [--s2s-config YAML] [--device cpu]
        [--workdir DIR] [--key value ...]

Both modes share the JAX script's small fp32 model and the corpus's
settings; S2S adds its decoder overrides (`s2s_overrides`) and trains 3x
the epochs. The S2S config defaults to the JAX script's,
hparams/S2S/conmambamamba_small.yaml (the Mamba decoder);
`--s2s-config hparams/S2S/conmamba_small.yaml` runs the Transformer
decoder. It runs on the CUDA card unless --device says otherwise. Unrecognised `--key value` pairs
pass through as config overrides. Prints one `RESULT {...}` line
and exits non-zero if the WER is above the target.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from mamba_asr_torch.cli import run_training
from mamba_asr_torch.data.audio import write_wav
from mamba_asr_torch.training.loop import Trainer

REPO = Path(__file__).resolve().parents[2]
CONFIG = "hparams/CTC/conmamba_small.yaml"
S2S_CONFIG = "hparams/S2S/conmambamamba_small.yaml"
LETTERS = "ABCDEF"
WORDS = ["AB", "BA", "CAD", "DEC", "FAD", "BEEF", "CAFE", "DAB"]
SR = 16000
TONE_S = 0.14
# Inter-word gap: it must survive the encoder's 4x downsampling with
# several frames to spare, or the model cannot place the space.
GAP_S = 0.2


def _letter_tone(ch: str) -> np.ndarray:
    t = np.arange(int(TONE_S * SR)) / SR
    f = 350.0 + 180.0 * LETTERS.index(ch)
    return (np.sin(2 * np.pi * f * t) * 0.3).astype(np.float32)


def _utterance(words, rng) -> np.ndarray:
    gap = np.zeros(int(GAP_S * SR), np.float32)
    parts = [np.zeros(int(0.05 * SR), np.float32)]
    for w in words:
        parts += [_letter_tone(ch) for ch in w]
        parts.append(gap)
    wav = np.concatenate(parts)
    return wav + rng.normal(0, 0.003, size=wav.shape).astype(np.float32)


def build_corpus(root: str, n_train: int = 32, n_dev: int = 8, n_test: int = 8,
                 seed: int = 0) -> None:
    """The tone corpus under root/{train-clean-100,dev-clean,test-clean}/1/2/
    (WAV files and a trans.txt), from numpy's default_rng(seed): the same
    files as the JAX script's."""
    rng = np.random.default_rng(seed)
    for split, n in (("train-clean-100", n_train), ("dev-clean", n_dev),
                     ("test-clean", n_test)):
        d = os.path.join(root, split, "1", "2")
        os.makedirs(d, exist_ok=True)
        lines = []
        for i in range(n):
            uid = f"1-2-{i:04d}"
            words = [WORDS[rng.integers(len(WORDS))] for _ in range(int(rng.integers(2, 5)))]
            write_wav(os.path.join(d, uid + ".wav"), _utterance(words, rng), SR)
            lines.append(f"{uid} {' '.join(words)}")
        with open(os.path.join(d, "1-2.trans.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def ctc_overrides(corpus: str, out: str, epochs: int) -> list:
    """The JAX script's CTC overrides (scripts/train_to_floor.py:run_mode):
    a small fp32 model and the corpus's data and training settings."""
    return [
        "--data.data_folder", corpus,
        "--data.output_folder", out,
        "--data.train_splits", "[train-clean-100]",
        "--data.test_splits", "[test-clean]",
        "--data.speed_perturb", "false",
        "--data.tokenizer_type", "char",
        "--model.d_model", "64",
        "--model.num_encoder_layers", "2",
        "--model.d_ffn", "128",
        "--model.compute_dtype", "float32",
        "--model.mamba.d_state", "8",
        "--frontend.n_mels", "40",
        "--model.n_mels", "40",
        "--train.lr", "0.002",
        "--train.warmup_steps", "60",
        "--train.grad_accumulation_factor", "1",
        "--train.number_of_epochs", str(epochs),
        "--train.keep_checkpoints", "5",
        "--train.avg_checkpoints", "5",
        "--specaug.num_time_drops", "1",
        "--specaug.num_freq_drops", "1",
        "--data.num_buckets", "2",
        "--data.max_batch_seconds", "24.0",
    ]


def s2s_overrides(epochs: int) -> list:
    """The JAX script's S2S additions (scripts/train_to_floor.py:117-125):
    a one-layer decoder of 2 heads, CTC weight 0.3, a validation search
    at half the epochs with beam 4, and test beam 8."""
    return [
        "--model.nhead", "2",
        "--model.num_decoder_layers", "1",
        "--train.ctc_weight", "0.3",
        "--decode.valid_search_interval", str(max(epochs // 2, 1)),
        "--decode.valid_beam_size", "4",
        "--decode.s2s_test_beam_size", "8",
    ]


def run_mode(mode: str, corpus: str, out: str, epochs: int, extra: Sequence[str] = (),
             device: Optional[str] = None, s2s_config: str = S2S_CONFIG
             ) -> Tuple[dict, Trainer]:
    """Run the port's CLI on the corpus: (the test summary as a dict, the
    trainer that ran). `epochs` is the mode's own (main triples it for
    S2S)."""
    overrides = ctc_overrides(corpus, os.path.join(out, mode), epochs)
    if mode == "s2s":
        argv = [str(REPO / s2s_config), *overrides, *s2s_overrides(epochs), *extra]
    else:
        argv = [str(REPO / CONFIG), *overrides, *extra]
    if device is not None:
        argv += ["--device", device]
    t0 = time.perf_counter()
    trainer = run_training(argv)
    wall = time.perf_counter() - t0
    with open(os.path.join(trainer.cfg.output_folder, "wer_test-clean.txt")) as f:
        header = f.readline().strip()
    return {"mode": mode, "test_wer": float(header.split()[1]), "epochs": epochs,
            "wall_s": wall, "wer_header": header, "exp_dir": trainer.cfg.output_folder,
            "device": str(trainer.device)}, trainer


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["ctc", "s2s"], default="ctc")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--target", type=float, default=2.0, help="max test WER (%%)")
    ap.add_argument("--workdir", default="")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--n-train", type=int, default=32)
    ap.add_argument("--n-dev", type=int, default=8)
    ap.add_argument("--n-test", type=int, default=8)
    ap.add_argument("--s2s-config", default=S2S_CONFIG)
    args, extra = ap.parse_known_args(argv)
    work = args.workdir or tempfile.mkdtemp(prefix="train_to_floor_")
    corpus = os.path.join(work, "corpus")
    if not os.path.isdir(os.path.join(corpus, "train-clean-100")):
        build_corpus(corpus, n_train=args.n_train, n_dev=args.n_dev, n_test=args.n_test)
    # The joint objective needs ~3x the steps of pure CTC before the
    # decoder's autoregressive path is reliable (the JAX script's rule).
    epochs = args.epochs * (3 if args.mode == "s2s" else 1)
    res, _ = run_mode(args.mode, corpus, os.path.join(work, "out"), epochs, extra,
                      device=args.device, s2s_config=args.s2s_config)
    res["ok"] = res["test_wer"] <= args.target
    print("RESULT " + json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
