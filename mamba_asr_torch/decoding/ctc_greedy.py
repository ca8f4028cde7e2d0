"""Greedy CTC decoding: argmax -> collapse repeats -> drop blanks (port of
mamba_asr_tpu/decoding/ctc_greedy.py). Fixed-shape token buffers and
lengths on the device; host lists only at the end."""

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


def tokens_to_lists(tokens: np.ndarray, lengths: np.ndarray) -> List[List[int]]:
    return [list(map(int, tokens[i, : int(lengths[i])])) for i in range(len(lengths))]
