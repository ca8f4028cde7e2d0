"""The CTC training recipe's command line (port of mamba_asr_tpu/cli.py:
build_tokenizer and run_training, CTC only, one device).

    python -m mamba_asr_torch.train_ctc hparams/CTC/conmamba_small.yaml \\
        --data.data_folder /path/to/LibriSpeech [--device cpu] [--train.lr 0.0005 ...]

Prepare the manifests -> fit (or load) the char tokenizer -> bucketed
loaders (speed perturbation on the training set) -> `loop.Trainer.fit`
with greedy validation and top-k checkpoints -> each test split decoded
with averaged checkpoints and the CTC prefix beam search, writing
wer_<split>.txt. It runs on the CUDA card unless `--device cpu` (or
another torch device) is given, and refuses to start without a card.
`--distributed` (multi-process training) is not ported and raises.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple

from mamba_asr_torch.configs.loader import ExperimentConfig, load_config, parse_overrides
from mamba_asr_torch.data.dataset import ASRDataset, BucketedLoader
from mamba_asr_torch.data.librispeech import create_lexicon, load_manifest, prepare_librispeech
from mamba_asr_torch.data.tokenizer import CharTokenizer, load_tokenizer
from mamba_asr_torch.training.loop import Trainer
from mamba_asr_torch.utils.device import resolve_device


def build_tokenizer(cfg: ExperimentConfig, train_csv: str):
    """Load output_folder/tokenizer_<type>.json, or fit it on the training
    transcripts and save it there."""
    tok_path = os.path.join(cfg.output_folder, f"tokenizer_{cfg.data.tokenizer_type}.json")
    if os.path.isfile(tok_path):
        return load_tokenizer(tok_path)
    if cfg.data.tokenizer_type != "char":
        raise NotImplementedError(
            f"data.tokenizer_type {cfg.data.tokenizer_type!r}: subword tokenizers are "
            "not ported (ROADMAP slice 3b item 2)")
    tok = CharTokenizer.fit([u.words for u in load_manifest(train_csv)],
                            vocab_size=cfg.data.vocab_size)
    os.makedirs(cfg.output_folder, exist_ok=True)
    tok.save(tok_path)
    return tok


def _pop_device(argv: List[str]) -> Tuple[List[str], Optional[str]]:
    """argv without its `--device X` (or `--device=X`), and X (None if absent)."""
    out, device, i = [], None, 0
    while i < len(argv):
        if argv[i] == "--device":
            if i + 1 >= len(argv):
                raise ValueError("missing value for --device")
            device, i = argv[i + 1], i + 2
        elif argv[i].startswith("--device="):
            device, i = argv[i].split("=", 1)[1], i + 1
        else:
            out.append(argv[i])
            i += 1
    return out, device


def train_loader(cfg: ExperimentConfig, csv_path: str, tokenizer) -> BucketedLoader:
    """The training set's loader: shuffled, speed perturbation per the config."""
    return BucketedLoader(
        ASRDataset.from_csv(csv_path, tokenizer, cfg.data.sample_rate),
        num_buckets=cfg.data.num_buckets, max_batch_seconds=cfg.data.max_batch_seconds,
        max_batch_ex=cfg.data.max_batch_ex, shuffle=cfg.data.sorting == "random",
        speed_perturb=cfg.data.speed_perturb, seed=cfg.seed,
        num_workers=cfg.data.num_workers)


def eval_loader(cfg: ExperimentConfig, csv_path: str, tokenizer) -> BucketedLoader:
    """A validation or test set's loader: in order, not perturbed."""
    return BucketedLoader(
        ASRDataset.from_csv(csv_path, tokenizer, cfg.data.sample_rate),
        num_buckets=max(cfg.data.num_buckets // 2, 2),
        max_batch_seconds=cfg.data.valid_max_batch_seconds,
        shuffle=False, speed_perturb=False, num_workers=cfg.data.num_workers)


def run_training(argv: Optional[List[str]] = None) -> Trainer:
    argv = list(argv) if argv is not None else sys.argv[1:]
    if not argv:
        raise SystemExit("usage: python -m mamba_asr_torch.train_ctc <hparams.yaml> "
                         "[--device cpu] [--key value ...]")
    if "--distributed" in argv:
        raise NotImplementedError(
            "--distributed: multi-process training is not ported (ROADMAP slice 4 item 4)")
    argv, device = _pop_device(argv)
    device = resolve_device(device)
    cfg = load_config(argv[0], parse_overrides(argv[1:]))
    os.makedirs(cfg.output_folder, exist_ok=True)

    manifest_dir = os.path.join(cfg.output_folder, "manifests")
    prepare_librispeech(
        data_folder=cfg.data.data_folder, save_folder=manifest_dir,
        tr_splits=cfg.data.train_splits, dev_splits=cfg.data.dev_splits,
        te_splits=cfg.data.test_splits, merge_lst=cfg.data.train_splits,
        merge_name=cfg.data.train_csv, skip_prep=cfg.data.skip_prep)
    train_csv = os.path.join(manifest_dir, cfg.data.train_csv)
    if cfg.data.create_lexicon:
        create_lexicon(manifest_dir, [cfg.data.train_csv])
    tokenizer = build_tokenizer(cfg, train_csv)
    trainer = Trainer(cfg, tokenizer, device=device)

    valid_loader = None
    if cfg.data.dev_splits:
        valid_loader = eval_loader(
            cfg, os.path.join(manifest_dir, cfg.data.dev_splits[0] + ".csv"), tokenizer)
    trainer.fit(train_loader(cfg, train_csv, tokenizer), valid_loader)
    for split in cfg.data.test_splits:
        test_loader = eval_loader(cfg, os.path.join(manifest_dir, split + ".csv"), tokenizer)
        summary = trainer.evaluate(test_loader, test_name=split, decoder=trainer.ctc_decoder())
        print(f"{split}: {summary}")
    return trainer
