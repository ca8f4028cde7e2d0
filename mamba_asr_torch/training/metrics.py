"""Word and character error rates (port of mamba_asr_tpu/training/
metrics.py: edit_distance_counts, align_tokens, ErrorRateStats).

The edit distance is a pure-Python DP, the JAX package's own oracle; the
JAX package's C++ version breaks ties the same way (substitution, then
insertion, then deletion), so the counts agree. It is host code, run
once per utterance at validation and test. Token accuracy
(AccuracyStats) comes with S2S training.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, TextIO, Tuple

import numpy as np


def edit_distance_counts(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int]:
    """(substitutions, insertions, deletions) of one optimal alignment."""
    n, m = len(ref), len(hyp)
    # prev[j] = (cost, subs, ins, dels) over the first j hypothesis tokens.
    prev = [(j, 0, j, 0) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, 0, i)]
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                cur.append(prev[j - 1])
                continue
            s, a, d = prev[j - 1], cur[j - 1], prev[j]
            if s[0] <= a[0] and s[0] <= d[0]:
                cur.append((s[0] + 1, s[1] + 1, s[2], s[3]))
            elif a[0] <= d[0]:
                cur.append((a[0] + 1, a[1], a[2] + 1, a[3]))
            else:
                cur.append((d[0] + 1, d[1], d[2], d[3] + 1))
        prev = cur
    _, s, ins, d = prev[m]
    return s, ins, d


def align_tokens(ref: Sequence, hyp: Sequence
                 ) -> List[Tuple[str, Optional[object], Optional[object]]]:
    """The optimal alignment's backtrace: (op, ref_tok, hyp_tok) with op in
    "=", "S", "I" (ref_tok None), "D" (hyp_tok None)."""
    n, m = len(ref), len(hyp)
    # Rows of the DP in numpy; the insertion recurrence
    # cur[j] = min(tmp[j], cur[j-1] + 1) is a running minimum of tmp[j] - j.
    hyp_arr = np.asarray(hyp) if m else np.zeros((0,))
    ptr = np.zeros((n + 1, m + 1), np.int8)  # 0 "=", 1 S, 2 I, 3 D
    ptr[1:, 0] = 3
    ptr[0, 1:] = 2
    prev = np.arange(m + 1)
    j_idx = np.arange(m + 1)
    for i in range(1, n + 1):
        eq = hyp_arr == ref[i - 1]
        diag = prev[:-1] + (~eq)
        tmp = np.concatenate(([i], np.minimum(diag, prev[1:] + 1)))
        cur = np.minimum.accumulate(tmp - j_idx) + j_idx
        # Ties: diagonal, then insertion, then deletion (as the DP above).
        ptr[i, 1:] = np.where(cur[1:] == diag, np.where(eq, 0, 1),
                              np.where(cur[1:] == cur[:-1] + 1, 2, 3))
        prev = cur
    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        p = ptr[i, j]
        if p == 0 and i > 0 and j > 0:
            ops.append(("=", ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif p == 1:
            ops.append(("S", ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif p == 2:
            ops.append(("I", None, hyp[j - 1]))
            j -= 1
        else:
            ops.append(("D", ref[i - 1], None))
            i -= 1
    return ops[::-1]


@dataclasses.dataclass
class ErrorRateStats:
    """WER (or CER with split_tokens=True) over the utterances appended."""

    split_tokens: bool = False
    scores: List[dict] = dataclasses.field(default_factory=list)

    def _split(self, text: str) -> List[str]:
        return list(text.replace(" ", "")) if self.split_tokens else text.split()

    def append(self, ids: Sequence[str], predictions: Sequence[str],
               targets: Sequence[str]) -> None:
        for uid, hyp, ref in zip(ids, predictions, targets):
            r, h = self._split(ref), self._split(hyp)
            s, i, d = edit_distance_counts(r, h)
            self.scores.append({"id": uid, "ref": ref, "hyp": hyp, "num_ref": len(r),
                                "sub": s, "ins": i, "del": d, "err": s + i + d})

    def summarize(self) -> dict:
        n_ref = sum(s["num_ref"] for s in self.scores) or 1
        return {
            "WER": 100.0 * sum(s["err"] for s in self.scores) / n_ref,
            "num_ref_tokens": n_ref,
            "substitutions": sum(s["sub"] for s in self.scores),
            "insertions": sum(s["ins"] for s in self.scores),
            "deletions": sum(s["del"] for s in self.scores),
            "num_utterances": len(self.scores),
        }

    def write_stats(self, f: TextIO) -> None:
        """The summary, then each utterance's aligned ref / op / hyp rows
        (<eps> for the missing side), worst first (SpeechBrain's wer file)."""
        f.write("%WER {WER:.2f} [ {substitutions} sub, {insertions} ins, "
                "{deletions} del on {num_ref_tokens} ref tokens, "
                "{num_utterances} utts ]\n".format(**self.summarize()))
        f.write("=" * 70 + "\n")
        for s in sorted(self.scores, key=lambda x: -x["err"]):
            ref_row, op_row, hyp_row = [], [], []
            for op, rt, ht in align_tokens(self._split(s["ref"]), self._split(s["hyp"])):
                rt = "<eps>" if rt is None else str(rt)
                ht = "<eps>" if ht is None else str(ht)
                w = max(len(rt), len(ht), len(op))
                ref_row.append(rt.center(w))
                op_row.append(op.center(w))
                hyp_row.append(ht.center(w))
            f.write(f"{s['id']}, %WER {100.0 * s['err'] / max(s['num_ref'], 1):.2f} "
                    f"[ {s['err']} / {s['num_ref']}, {s['ins']} ins, "
                    f"{s['del']} del, {s['sub']} sub ]\n")
            f.write(" ; ".join(ref_row) + "\n")
            f.write(" ; ".join(op_row) + "\n")
            f.write(" ; ".join(hyp_row) + "\n")
