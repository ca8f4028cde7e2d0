"""The recipes' command line (port of mamba_asr_tpu/cli.py:
build_tokenizer and run_training, one device): the CTC recipe, and the
joint CTC/attention (S2S) recipe when the config has a decoder.

    python -m mamba_asr_torch.train_ctc hparams/CTC/conmamba_small.yaml \\
        --data.data_folder /path/to/LibriSpeech [--device cpu] [--train.lr 0.0005 ...]
    python -m mamba_asr_torch.train_s2s hparams/S2S/conmamba_small.yaml \\
        --data.data_folder /path/to/LibriSpeech [--device cpu] [--key value ...]

The S2S recipe takes either decoder: conmamba_small.yaml (Transformer) or
conmambamamba_small.yaml (Mamba).

Prepare the manifests -> fit (or load) the tokenizer (char, or bpe /
unigram through the `tokenizers` package) -> bucketed loaders (speed
perturbation on the training set) -> `loop.Trainer.fit` with validation
and top-k checkpoints -> each test split decoded with averaged
checkpoints and the CTC prefix beam search (CTC) or the joint beam
search (S2S, fusing the LM of `decode.lm_path` at test, when set),
writing wer_<split>.txt. It runs on the CUDA card unless `--device cpu`
(or another torch device) is given, and refuses to start without a card.
`--distributed` (multi-process training) is not ported and raises.

`restore_asr_state` gives recognition's entry points (recognize.py,
evaluate.py) their model and normaliser: the averaged checkpoints of an
experiment, or a reference checkpoint.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple

import torch

from mamba_asr_torch.configs.loader import ExperimentConfig, load_config, parse_overrides
from mamba_asr_torch.data.dataset import ASRDataset, BucketedLoader
from mamba_asr_torch.data.librispeech import create_lexicon, load_manifest, prepare_librispeech
from mamba_asr_torch.data.tokenizer import CharTokenizer, SubwordTokenizer, load_tokenizer
from mamba_asr_torch.models import lm as lm_module
from mamba_asr_torch.models import params_import
from mamba_asr_torch.models.asr import ASRModel
from mamba_asr_torch.training.checkpoint import CheckpointManager
from mamba_asr_torch.training.loop import Trainer
from mamba_asr_torch.training.normalizer import NormalizerState, init_normalizer
from mamba_asr_torch.utils.device import resolve_device


def build_tokenizer(cfg: ExperimentConfig, train_csv: str):
    """Load output_folder/tokenizer_<type>.json, or fit it on the training
    transcripts and save it there."""
    tok_path = os.path.join(cfg.output_folder, f"tokenizer_{cfg.data.tokenizer_type}.json")
    if os.path.isfile(tok_path):
        return load_tokenizer(tok_path)
    corpus = [u.words for u in load_manifest(train_csv)]
    if cfg.data.tokenizer_type == "char":
        tok = CharTokenizer.fit(corpus, vocab_size=cfg.data.vocab_size)
    else:
        tok = SubwordTokenizer.train(corpus, vocab_size=cfg.data.vocab_size,
                                     model_type=cfg.data.tokenizer_type)
    os.makedirs(cfg.output_folder, exist_ok=True)
    tok.save(tok_path)
    return tok


def load_lm(cfg: ExperimentConfig, device=None):
    """The decode-time TransformerLM of `cfg.decode` (JAX `cli.py:58-108`):
    None when `decode.lm_path` is empty; else the LM at `lm_*` widths and
    the model's vocabulary, its `.pt` / `.ckpt` / `.pth` state dict loaded
    with strict=True, on `device` (None: the card). A flax msgpack path
    raises (models/lm.py:load_lm)."""
    return lm_module.load_lm(cfg.decode, cfg.model.vocab_size, device)


def restore_asr_state(cfg: ExperimentConfig, ckpt_dir: str = "", torch_ckpt: str = "",
                      torch_normalizer: str = "", device=None
                      ) -> Tuple[ASRModel, NormalizerState]:
    """The model in eval mode on `device` (None: the card) and its
    normaliser (JAX `cli.py:111-187`), from one of two sources:

    - torch_ckpt: a reference `model.ckpt` (models/params_import.py:
      load_torch_asr), with the statistics of `torch_normalizer` when
      given (none otherwise: features pass through);
    - ckpt_dir: an experiment's save dir, the mean of its
      train.avg_checkpoints best checkpoints, ranked as the recipe keeps
      them (WER for CTC; ACC for S2S, where the JAX package ranks by WER
      here and by ACC in its test pass), and the best one's normaliser.
      A save dir of the JAX package (flax msgpack) is refused.
    """
    device = resolve_device(device)
    model = ASRModel(cfg.model)
    if torch_ckpt:
        model.load_state_dict(params_import.load_torch_asr(torch_ckpt, cfg.model), strict=True)
        if torch_normalizer:
            stats = params_import.import_normalizer_stats(
                torch.load(torch_normalizer, map_location="cpu", weights_only=True))
            normalizer = NormalizerState.from_arrays(*stats, device=device)
        else:
            normalizer = init_normalizer(cfg.frontend.n_mels, device)
        return model.to(device).eval(), normalizer
    if not ckpt_dir:
        raise SystemExit("need --ckpt_dir or --torch_ckpt")
    if not os.path.isdir(ckpt_dir):
        raise SystemExit(f"no checkpoints in {ckpt_dir}")
    for name in sorted(os.listdir(ckpt_dir)):
        if os.path.isfile(os.path.join(ckpt_dir, name, "state.msgpack")):
            raise SystemExit(
                f"{ckpt_dir}/{name} is a flax msgpack checkpoint of the JAX package; the "
                "port reads torch checkpoints only: export it with "
                "mamba_asr_tpu.models.torch_export.save_torch_asr (and "
                "export_normalizer_stats) and pass --torch_ckpt (--torch_normalizer)")
    rank = {"max_key": "ACC"} if cfg.model.num_decoder_layers > 0 else {"min_key": "WER"}
    restored = CheckpointManager(ckpt_dir, keep=cfg.train.keep_checkpoints).restore_averaged(
        k=cfg.train.avg_checkpoints, **rank)
    if restored is None:
        raise SystemExit(f"no checkpoints in {ckpt_dir}")
    best, avg = restored
    model.load_state_dict(avg, strict=True)
    normalizer = NormalizerState(**{k: v.to(device) for k, v in best["normalizer"].items()})
    return model.to(device).eval(), normalizer


def pop_device(argv: List[str]) -> Tuple[List[str], Optional[str]]:
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
        raise SystemExit("usage: python -m mamba_asr_torch.train_ctc|train_s2s "
                         "<hparams.yaml> [--device cpu] [--key value ...]")
    if "--distributed" in argv:
        raise NotImplementedError(
            "--distributed: multi-process training is not ported (ROADMAP slice 4 item 4)")
    argv, device = pop_device(argv)
    device = resolve_device(device)
    cfg = load_config(argv[0], parse_overrides(argv[1:]))
    lm = load_lm(cfg, device)
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
    trainer = Trainer(cfg, tokenizer, device=device, lm=lm)

    valid_loader = None
    if cfg.data.dev_splits:
        valid_loader = eval_loader(
            cfg, os.path.join(manifest_dir, cfg.data.dev_splits[0] + ".csv"), tokenizer)
    trainer.fit(train_loader(cfg, train_csv, tokenizer), valid_loader)
    for split in cfg.data.test_splits:
        test_loader = eval_loader(cfg, os.path.join(manifest_dir, split + ".csv"), tokenizer)
        decoder = trainer.s2s_decoder(test=True) if trainer.is_s2s else trainer.ctc_decoder()
        summary = trainer.evaluate(test_loader, test_name=split, decoder=decoder)
        print(f"{split}: {summary}")
    return trainer
