"""Word times from greedy CTC alignments (port of
mamba_asr_tpu/decoding/timestamps.py): the per-token frame spans of
`ctc_greedy_decode_with_times` become (word, start_s, end_s[, conf]).

Tokens are attributed to words by incremental decoding, decode(ids[:i+1])
minus decode(ids[:i]), which takes the char tokenizer (explicit spaces)
and word pieces alike without looking inside the tokenizer.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple


def encoder_frame_seconds(frontend_cfg, model_cfg) -> float:
    """Seconds of one encoder frame: the fbank hop times the front end's
    time downsampling."""
    ds = 1
    for s in model_cfg.frontend_strides:
        ds *= int(s)
    return frontend_cfg.hop / float(frontend_cfg.sample_rate) * ds


def token_texts(ids: Sequence[int], tokenizer) -> List[str]:
    """Each token's text by incremental decoding; one-token decodes when
    the tokenizer's decode is not prefix-monotone (decode(ids[:i+1]) does
    not extend decode(ids[:i]))."""
    texts: List[str] = []
    prev = ""
    for i in range(len(ids)):
        cur = tokenizer.decode(list(ids[: i + 1]))
        if not cur.startswith(prev):
            return [tokenizer.decode([int(t)]) for t in ids]
        texts.append(cur[len(prev):])
        prev = cur
    return texts


def word_timestamps(
    ids: Sequence[int],
    onsets: Sequence[int],
    offsets: Sequence[int],
    tokenizer,
    frame_seconds: float,
    confs: Optional[Sequence[float]] = None,
) -> List[Tuple]:
    """One utterance's words with times: [(word, start_s, end_s)], start
    the onset of the word's first token, end the frame after its last
    token's run; with `confs` (word, start_s, end_s, conf), conf the least
    of the word's tokens'. ids, onsets, offsets (and confs) are cut to the
    utterance's length."""
    ids = [int(t) for t in ids]
    words: List[list] = []
    cur_word, cur_start, cur_end, cur_conf = "", None, None, 1.0
    for tok_i, text in enumerate(token_texts(ids, tokenizer)):
        for ch in text:
            if ch.isspace():
                if cur_word:
                    words.append([cur_word, cur_start, cur_end, cur_conf])
                cur_word, cur_start, cur_end, cur_conf = "", None, None, 1.0
            else:
                if not cur_word:
                    cur_start = float(onsets[tok_i]) * frame_seconds
                cur_word += ch
                cur_end = (float(offsets[tok_i]) + 1.0) * frame_seconds
                if confs is not None:
                    cur_conf = min(cur_conf, float(confs[tok_i]))
    if cur_word:
        words.append([cur_word, cur_start, cur_end, cur_conf])
    out = []
    for w, s, e, c in words:
        if s is None or math.isnan(s):
            continue
        if confs is not None:
            out.append((w, round(s, 3), round(e, 3), round(c, 4)))
        else:
            out.append((w, round(s, 3), round(e, 3)))
    return out
