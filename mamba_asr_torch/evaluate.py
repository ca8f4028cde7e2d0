"""Evaluation only (the port's counterpart of evaluate.py): decode a
config's test splits and write wer_<split>.txt.

    python -m mamba_asr_torch.evaluate <hparams.yaml> --data.data_folder <LibriSpeech> \\
        [--torch_ckpt model.ckpt [--torch_normalizer normalizer.ckpt]] \\
        [--device cpu] [--key value ...]

Uses the experiment's checkpoints (the train.avg_checkpoints best,
averaged) or, with --torch_ckpt, a reference checkpoint
(cli.restore_asr_state); decodes with the recipe's test decoder, the CTC
prefix beam search or (S2S) the joint beam search fusing the LM of
decode.lm_path; prints `split: summary`. Runs on the CUDA card unless
--device names another.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    from mamba_asr_torch import cli
    from mamba_asr_torch.configs.loader import load_config, parse_overrides
    from mamba_asr_torch.data.librispeech import prepare_librispeech
    from mamba_asr_torch.training.loop import Trainer
    from mamba_asr_torch.utils.device import resolve_device

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit("usage: python -m mamba_asr_torch.evaluate <hparams.yaml> "
                         "[--torch_ckpt model.ckpt [--torch_normalizer n.ckpt]] "
                         "[--device cpu] [--key value ...]")
    argv, device = cli.pop_device(argv)
    torch_ckpt = torch_normalizer = ""
    rest, it = [], iter(argv)
    for a in it:
        if a == "--torch_ckpt":
            torch_ckpt = next(it)
        elif a == "--torch_normalizer":
            torch_normalizer = next(it)
        else:
            rest.append(a)
    device = resolve_device(device)
    cfg = load_config(rest[0], parse_overrides(rest[1:]))
    manifest_dir = os.path.join(cfg.output_folder, "manifests")
    prepare_librispeech(
        data_folder=cfg.data.data_folder, save_folder=manifest_dir,
        tr_splits=cfg.data.train_splits, te_splits=cfg.data.test_splits,
        merge_lst=cfg.data.train_splits, merge_name=cfg.data.train_csv,
        skip_prep=cfg.data.skip_prep)
    tokenizer = cli.build_tokenizer(cfg, os.path.join(manifest_dir, cfg.data.train_csv))
    trainer = Trainer(cfg, tokenizer, device=device, lm=cli.load_lm(cfg, device))
    if torch_ckpt:
        model, normalizer = cli.restore_asr_state(cfg, torch_ckpt=torch_ckpt,
                                                  torch_normalizer=torch_normalizer,
                                                  device=device)
        trainer.step.model.load_state_dict(model.state_dict(), strict=True)
        trainer.step.normalizer = normalizer
    for split in cfg.data.test_splits:
        loader = cli.eval_loader(cfg, os.path.join(manifest_dir, split + ".csv"), tokenizer)
        decoder = trainer.s2s_decoder(test=True) if trainer.is_s2s else trainer.ctc_decoder()
        summary = trainer.evaluate(loader, test_name=split, decoder=decoder,
                                   use_averaged=not torch_ckpt)
        print(f"{split}: {summary}")


if __name__ == "__main__":
    main()
