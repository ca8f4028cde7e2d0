"""Export an experiment of the port as reference-format PyTorch
checkpoints (the port's counterpart of scripts/export_torch.py).

    python -m mamba_asr_torch.export_torch hparams/CTC/conmamba_small.yaml \\
        --ckpt_dir <exp>/save --out_dir <dir> [--device cpu] [--key value ...]

Restores what evaluation decodes (cli.restore_asr_state: the
train.avg_checkpoints best checkpoints, ranked by WER for CTC and ACC for
S2S, averaged, and the best one's normaliser) and writes
<out_dir>/model.ckpt and <out_dir>/normalizer.ckpt
(models/torch_export.py), which `recognize --torch_ckpt ...
--torch_normalizer ...` and the reference's Pretrainer read. Runs on the
CUDA card unless --device names another.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    from mamba_asr_torch import cli
    from mamba_asr_torch.configs.loader import load_config, parse_overrides
    from mamba_asr_torch.models.torch_export import (
        export_normalizer_stats,
        save_torch_asr,
        torch_save,
    )

    argv, device = cli.pop_device(list(sys.argv[1:] if argv is None else argv))
    ckpt_dir = out_dir = ""
    rest, it = [], iter(argv)
    for a in it:
        if a == "--ckpt_dir":
            ckpt_dir = next(it)
        elif a == "--out_dir":
            out_dir = next(it)
        else:
            rest.append(a)
    if not rest or not ckpt_dir or not out_dir:
        raise SystemExit("usage: python -m mamba_asr_torch.export_torch <hparams.yaml> "
                         "--ckpt_dir DIR --out_dir DIR [--device cpu] [--key value ...]")
    cfg = load_config(rest[0], parse_overrides(rest[1:]))
    model, normalizer = cli.restore_asr_state(cfg, ckpt_dir=ckpt_dir, device=device)
    os.makedirs(out_dir, exist_ok=True)
    model_path = os.path.join(out_dir, "model.ckpt")
    save_torch_asr(model, cfg.model, model_path)
    norm_path = os.path.join(out_dir, "normalizer.ckpt")
    torch_save(export_normalizer_stats(normalizer), norm_path)
    print(f"wrote {model_path} and {norm_path}")


if __name__ == "__main__":
    main()
