"""Greedy CTC decoding: argmax -> collapse repeats -> drop blanks (port of
mamba_asr_tpu/decoding/ctc_greedy.py). Fixed-shape token buffers and
lengths on the device; host lists only at the end.
`ctc_greedy_decode_with_times` also gives each token's frame span and
confidence (recognize --timestamps)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def ctc_greedy_collapse(
    best: torch.Tensor, input_lengths: torch.Tensor, blank_id: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T) argmax ids -> (tokens (B, T) left-packed, lengths (B,)).

    Keeps positions whose id differs from its predecessor and is not
    blank, then left-packs them with a stable sort on the drop mask.
    """
    t = best.shape[1]
    prev = F.pad(best, (1, 0), value=blank_id)[:, :t]
    pos = torch.arange(t, device=best.device)[None, :]
    valid = pos < input_lengths[:, None]
    keep = (best != blank_id) & (best != prev) & valid
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    packed = torch.gather(best, 1, order)
    lengths = keep.sum(dim=1)
    packed = torch.where(pos < lengths[:, None], packed, torch.zeros_like(packed))
    return packed, lengths


def ctc_greedy_decode(
    log_probs: torch.Tensor, input_lengths: torch.Tensor, blank_id: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, V) log probs -> (tokens (B, T), lengths (B,))."""
    return ctc_greedy_collapse(log_probs.argmax(dim=-1), input_lengths, blank_id)


def ctc_greedy_decode_with_times(
    log_probs: torch.Tensor, input_lengths: torch.Tensor, blank_id: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, T, V) log probs -> (tokens, lengths, onsets, offsets, confs),
    each (B, T) but lengths (B,) (JAX `ctc_greedy.py:50-108`): a token's
    onset is the first encoder frame of its argmax run, its offset the
    last (inclusive), its confidence exp(mean log p) of the argmax over
    the run. Padded frames count as blank, so no run passes the valid
    region. Entries past a row's length are 0."""
    b, t = log_probs.shape[:2]
    dev = log_probs.device
    idx = torch.arange(t, device=dev)[None, :].expand(b, t)
    best = log_probs.argmax(dim=-1)
    best = torch.where(idx < input_lengths[:, None], best, torch.full_like(best, blank_id))
    prev = F.pad(best, (1, 0), value=blank_id)[:, :t]
    keep = (best != blank_id) & (best != prev)
    # A run's last frame, for every frame: a reversed running minimum over
    # the indices of run ends (t elsewhere).
    nxt = F.pad(best, (0, 1), value=blank_id)[:, 1:]
    end_mark = torch.where(best != nxt, idx, torch.full_like(idx, t))
    run_end = torch.flip(torch.cummin(torch.flip(end_mark, [1]), dim=1).values, [1])
    # The argmax log-prob summed from the start: a run's mean is two gathers.
    csum = F.pad(torch.cumsum(log_probs.max(dim=-1).values, dim=1), (1, 0))
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    packed = torch.gather(best, 1, order)
    onsets = order
    offsets = torch.gather(run_end, 1, order)
    run_len = (offsets - onsets + 1).to(log_probs.dtype)
    # A trailing blank's run end is t (no token has it; JAX clamps the gather).
    seg = torch.gather(csum, 1, torch.clamp_max(offsets + 1, t)) - torch.gather(csum, 1, onsets)
    confs = torch.exp(seg / torch.clamp_min(run_len, 1.0))
    lengths = keep.sum(dim=1)
    in_range = idx < lengths[:, None]
    zero = torch.zeros_like(packed)
    return (torch.where(in_range, packed, zero), lengths,
            torch.where(in_range, onsets, zero), torch.where(in_range, offsets, zero),
            torch.where(in_range, confs, torch.zeros_like(confs)))


def tokens_to_lists(tokens: np.ndarray, lengths: np.ndarray) -> List[List[int]]:
    return [list(map(int, tokens[i, : int(lengths[i])])) for i in range(len(lengths))]
