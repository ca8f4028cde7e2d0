"""Checkpoints with top-k retention by a metric, and parameter averaging
(port of mamba_asr_tpu/training/checkpoint.py:CheckpointManager).

The layout, names and `meta.json` schema are the JAX package's: one
directory per checkpoint, `ckpt_<YYYYmmdd_HHMMSS>_<count>` (the count of
checkpoints held, or the next free one) or a given name, holding the state and
`meta.json` = {metrics, time, min_keys, max_keys}. The state is a dict
of tensors and plain values written with `torch.save` as `state.pt`
(the JAX package writes a flax msgpack); `restore` reads it with
`weights_only=True`. Checkpoints whose metrics say `averaged` (written
after evaluation) are never pruned, averaged, ranked or resumed from.
Pruning keeps the newest training checkpoint besides the `keep` best,
so a run always resumes from its last epoch.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

import torch

_META = "meta.json"
_STATE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 10, create: bool = True):
        """create: make the directory now (the ranks of a multi-process run
        but rank 0 only read it; `save` makes it where it is missing)."""
        self.directory = directory
        self.keep = keep
        if create:
            os.makedirs(directory, exist_ok=True)

    def _entries(self, include_averaged: bool = False) -> List[dict]:
        """The checkpoints' metadata, by name; averaged ones left out
        unless asked for."""
        out = []
        if not os.path.isdir(self.directory):
            return out
        for name in sorted(os.listdir(self.directory)):
            meta_path = os.path.join(self.directory, name, _META)
            if os.path.isfile(meta_path):
                with open(meta_path, encoding="utf-8") as f:
                    meta = json.load(f)
                meta["name"] = name
                if include_averaged or not meta.get("metrics", {}).get("averaged"):
                    out.append(meta)
        return out

    def save(self, state: dict, metrics: Optional[dict] = None, min_keys: tuple = (),
             max_keys: tuple = (), name: Optional[str] = None) -> str:
        """Write `state`; a training checkpoint then prunes the others to
        the `keep` best by the first min or max key (by recency where an
        entry has neither), keeping itself as well."""
        if name is None:
            # JAX names by the count of checkpoints held, which can repeat
            # after pruning: within one second it would overwrite a kept
            # checkpoint. The port takes the next count that is free.
            stamp, count = time.strftime("%Y%m%d_%H%M%S"), len(self._entries())
            while os.path.exists(os.path.join(self.directory, f"ckpt_{stamp}_{count:04d}")):
                count += 1
            name = f"ckpt_{stamp}_{count:04d}"
        path = os.path.join(self.directory, name)
        os.makedirs(path, exist_ok=True)
        torch.save(state, os.path.join(path, _STATE))
        meta = {"metrics": metrics or {}, "time": time.time(),
                "min_keys": list(min_keys), "max_keys": list(max_keys)}
        with open(os.path.join(path, _META), "w", encoding="utf-8") as f:
            json.dump(meta, f)
        if not meta["metrics"].get("averaged"):
            self._prune(min_keys, max_keys, newest=name)
        return path

    @staticmethod
    def _score(entry: dict, min_keys, max_keys) -> float:
        for k in min_keys:
            if k in entry["metrics"]:
                return -float(entry["metrics"][k])
        for k in max_keys:
            if k in entry["metrics"]:
                return float(entry["metrics"][k])
        return entry.get("time", 0.0)

    def _prune(self, min_keys, max_keys, newest: str) -> None:
        """Keep the `keep` best and the newest (which resume starts from:
        the JAX package prunes it when it ranks below the best, and its
        auto-resume then repeats epochs; SpeechBrain's save_and_keep_only
        keeps it, keep_recent=True)."""
        entries = self._entries()
        if len(entries) <= self.keep:
            return
        entries.sort(key=lambda e: self._score(e, min_keys, max_keys), reverse=True)
        for e in entries[self.keep:]:
            if e["name"] != newest:
                shutil.rmtree(os.path.join(self.directory, e["name"]), ignore_errors=True)

    def restore(self, name: Optional[str] = None) -> Optional[dict]:
        """The named checkpoint's state (the most recent one by default), on
        the CPU; None when there is none."""
        if name is None:
            entries = self._entries()
            if not entries:
                return None
            name = max(entries, key=lambda e: e.get("time", 0))["name"]
        return torch.load(os.path.join(self.directory, name, _STATE),
                          map_location="cpu", weights_only=True)

    def best(self, min_key: Optional[str] = None, max_key: Optional[str] = None
             ) -> Optional[str]:
        entries = self._entries()
        if not entries:
            return None
        if min_key:
            return max(entries, key=lambda e: -e["metrics"].get(min_key, float("inf")))["name"]
        return max(entries, key=lambda e: e["metrics"].get(max_key, float("-inf")))["name"]

    def restore_averaged(self, k: Optional[int] = None, min_key: Optional[str] = None,
                         max_key: Optional[str] = None, subtree: str = "model"
                         ) -> Optional[Tuple[dict, Dict[str, torch.Tensor]]]:
        """(the best checkpoint's state, the element-wise mean of the k best
        checkpoints' `subtree`): the parameters only, in float32, summed in
        rank order; non-float entries are the best checkpoint's."""
        entries = self._entries()
        if not entries:
            return None
        if min_key:
            entries.sort(key=lambda e: e["metrics"].get(min_key, float("inf")))
        elif max_key:
            entries.sort(key=lambda e: -e["metrics"].get(max_key, float("-inf")))
        else:
            entries.sort(key=lambda e: -e.get("time", 0))
        states = [self.restore(e["name"]) for e in entries[: (k or self.keep)]]
        avg = {}
        for key, first in states[0][subtree].items():
            if not first.is_floating_point():
                avg[key] = first
                continue
            total = first.float().clone()
            for s in states[1:]:
                total += s[subtree][key].float()
            avg[key] = (total / len(states)).to(first.dtype)
        return states[0], avg
