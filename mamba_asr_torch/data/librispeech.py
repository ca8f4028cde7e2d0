"""LibriSpeech preparation: directory scan -> CSV manifests (port of
mamba_asr_tpu/data/librispeech.py).

Per split, the audio files (.flac or .wav) and the `*trans.txt`
transcripts under `<data_folder>/<split>/` become `<split>.csv` with the
schema `ID,duration,wav,spk_id,wrd`; the train splits are merged into
one CSV. Durations come from the file headers, in a thread pool. When
every CSV exists and `opt_librispeech_prepare.json` holds the same
split configuration, preparation is skipped. The CSVs are byte for byte
the JAX package's.
"""

from __future__ import annotations

import csv
import json
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

from mamba_asr_torch.data.audio import audio_duration

CSV_FIELDS = ["ID", "duration", "wav", "spk_id", "wrd"]
_OPT_FILE = "opt_librispeech_prepare.json"


@dataclass
class Utterance:
    utt_id: str
    duration: float
    path: str
    spk_id: str
    words: str


def _find_files(root: str, suffixes: Sequence[str]) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        out += [os.path.join(dirpath, f) for f in files
                if any(f.endswith(s) for s in suffixes)]
    return sorted(out)


def text_to_dict(trans_files: Iterable[str]) -> Dict[str, str]:
    """`<utt-id> TRANSCRIPT` lines of *trans.txt files -> {id: upper-case text}."""
    text = {}
    for tf in trans_files:
        with open(tf, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                utt_id, _, words = line.partition(" ")
                text[utt_id] = words.strip().upper()
    return text


def create_csv(save_csv: str, audio_files: Sequence[str], text: Dict[str, str]) -> None:
    """Write one split's manifest; audio without a transcript is left out."""

    def row(path):
        utt_id = os.path.splitext(os.path.basename(path))[0]
        if utt_id not in text:
            return None
        spk_id = "-".join(utt_id.split("-")[0:2])
        return Utterance(utt_id, audio_duration(path), path, spk_id, text[utt_id])

    with ThreadPoolExecutor(max_workers=16) as pool:
        rows = [r for r in pool.map(row, audio_files) if r is not None]
    os.makedirs(os.path.dirname(save_csv) or ".", exist_ok=True)
    with open(save_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(CSV_FIELDS)
        for r in rows:
            w.writerow([r.utt_id, f"{r.duration:.5f}", r.path, r.spk_id, r.words])


def merge_csvs(save_folder: str, csv_names: Sequence[str], merged_name: str) -> None:
    with open(os.path.join(save_folder, merged_name), "w", newline="",
              encoding="utf-8") as out:
        w = csv.writer(out)
        w.writerow(CSV_FIELDS)
        for name in csv_names:
            with open(os.path.join(save_folder, name), encoding="utf-8") as f:
                r = csv.reader(f)
                next(r)  # header
                for row in r:
                    w.writerow(row)


def _skip(save_folder: str, splits: Sequence[str], merge_name: Optional[str],
          conf: dict) -> bool:
    names = [s + ".csv" for s in splits] + ([merge_name] if merge_name else [])
    if not all(os.path.isfile(os.path.join(save_folder, n)) for n in names):
        return False
    opt_path = os.path.join(save_folder, _OPT_FILE)
    if not os.path.isfile(opt_path):
        return False
    with open(opt_path, encoding="utf-8") as f:
        return json.load(f) == conf


def prepare_librispeech(
    data_folder: str,
    save_folder: str,
    tr_splits: Sequence[str] = (),
    dev_splits: Sequence[str] = (),
    te_splits: Sequence[str] = (),
    merge_lst: Sequence[str] = (),
    merge_name: Optional[str] = None,
    skip_prep: bool = False,
) -> None:
    """Scan the LibriSpeech split directories and write the CSV manifests."""
    if skip_prep:
        return
    splits = list(tr_splits) + list(dev_splits) + list(te_splits)
    conf = {"splits": splits, "merge": list(merge_lst), "merge_name": merge_name}
    os.makedirs(save_folder, exist_ok=True)
    if _skip(save_folder, splits, merge_name, conf):
        return
    for split in splits:
        split_dir = os.path.join(data_folder, split)
        if not os.path.isdir(split_dir):
            raise FileNotFoundError(
                f"split directory not found: {split_dir} "
                "(expected LibriSpeech layout <data_folder>/<split>/...)")
        text = text_to_dict(_find_files(split_dir, ("trans.txt",)))
        create_csv(os.path.join(save_folder, split + ".csv"),
                   _find_files(split_dir, (".flac", ".wav")), text)
    if merge_lst and merge_name:
        merge_csvs(save_folder, [s + ".csv" for s in merge_lst], merge_name)
    with open(os.path.join(save_folder, _OPT_FILE), "w", encoding="utf-8") as f:
        json.dump(conf, f)


def create_lexicon(save_folder: str, csv_names: Sequence[str],
                   lexicon_name: str = "lexicon.csv") -> str:
    """The grapheme lexicon of the manifests' words: `word,chars` rows
    (the letters joined by spaces), sorted."""
    words = set()
    for name in csv_names:
        for utt in load_manifest(os.path.join(save_folder, name)):
            words.update(utt.words.split())
    out_path = os.path.join(save_folder, lexicon_name)
    with open(out_path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["word", "chars"])
        for word in sorted(words):
            w.writerow([word, " ".join(word)])
    return out_path


def load_manifest(csv_path: str) -> List[Utterance]:
    with open(csv_path, encoding="utf-8") as f:
        return [Utterance(row["ID"], float(row["duration"]), row["wav"],
                          row["spk_id"], row["wrd"])
                for row in csv.DictReader(f)]
