"""Training logs (port of mamba_asr_tpu/training/logger.py): epoch rows in
train_log.txt and per-step JSON lines in steps.jsonl. The JAX package's
wandb hook is not ported: `train.use_wandb: true` raises (the loop
checks), since the card machine has no network.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class FileTrainLogger:
    """Appends one `key: value, ...` row per call (and prints it)."""

    def __init__(self, save_file: str, also_stdout: bool = True):
        self.save_file = save_file
        self.also_stdout = also_stdout
        os.makedirs(os.path.dirname(save_file) or ".", exist_ok=True)

    def log_stats(self, stats_meta: dict, train_stats: Optional[dict] = None,
                  valid_stats: Optional[dict] = None,
                  test_stats: Optional[dict] = None) -> None:
        parts = [f"{k}: {self._fmt(v)}" for k, v in stats_meta.items()]
        for prefix, stats in (("train", train_stats), ("valid", valid_stats),
                              ("test", test_stats)):
            if stats:
                parts += [f"{prefix} {k}: {self._fmt(v)}" for k, v in stats.items()]
        line = ", ".join(parts)
        with open(self.save_file, "a", encoding="utf-8") as f:
            f.write(line + "\n")
        if self.also_stdout:
            print(line, flush=True)

    @staticmethod
    def _fmt(v) -> str:
        if isinstance(v, float):
            return f"{v:.4g}" if abs(v) < 1e4 else f"{v:.4e}"
        return str(v)


class JsonlLogger:
    """Machine-readable per-step metrics, one JSON object per line."""

    def __init__(self, save_file: str):
        self.save_file = save_file
        os.makedirs(os.path.dirname(save_file) or ".", exist_ok=True)

    def log(self, **kv) -> None:
        kv.setdefault("ts", time.time())
        with open(self.save_file, "a", encoding="utf-8") as f:
            f.write(json.dumps(kv) + "\n")
