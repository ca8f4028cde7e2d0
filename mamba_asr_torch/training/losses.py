"""The S2S recipes' sequence losses (port of mamba_asr_tpu/training/
losses.py): the label-smoothed KL divergence of the decoder's
teacher-forced log-probs, and the joint CTC/attention objective.

`kldiv_loss` is the true KL(smoothed one-hot || p), SpeechBrain's, with
the q log q constant when label_smoothing > 0, so loss values are the
reference's; it takes float32 log-probs and sums each utterance over its
valid tokens.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def kldiv_loss(
    log_probs: torch.Tensor,
    targets: torch.Tensor,
    target_lengths: Optional[torch.Tensor] = None,
    label_smoothing: float = 0.0,
    pad_idx: int = 0,
    reduction: str = "batchmean",
    weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """KL(smoothed one-hot || p) summed over valid tokens.

    log_probs (B, S, V); targets (B, S) int; target_lengths (B,) valid-token
    counts (without them, targets != pad_idx); weight (B,) per-utterance
    weights. "batchmean" divides the weighted sum by weight.sum() (B
    without weights), clamped at 1."""
    lp = log_probs.float()
    b, s, v = lp.shape
    if target_lengths is not None:
        valid = torch.arange(s, device=lp.device)[None, :] < target_lengths[:, None]
    else:
        valid = targets != pad_idx
    onehot_lp = torch.gather(lp, -1, targets.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        smooth = label_smoothing / (v - 1)
        confidence = 1.0 - label_smoothing
        q_logq = confidence * math.log(confidence) + (v - 1) * smooth * math.log(
            max(smooth, 1e-20))
        cross = confidence * onehot_lp + smooth * (lp.sum(-1) - onehot_lp)
        per_tok = q_logq - cross
    else:
        per_tok = -onehot_lp
    per_tok = torch.where(valid, per_tok, torch.zeros_like(per_tok))
    per_utt = per_tok.sum(-1)
    if weight is not None:
        per_utt = per_utt * weight
    if reduction == "none":
        return per_utt
    if reduction == "sum":
        return per_utt.sum()
    if reduction == "batchmean":
        denom = weight.sum() if weight is not None else torch.tensor(float(b))
        return per_utt.sum() / torch.clamp_min(denom.to(per_utt), 1.0)
    if reduction == "mean":
        tok_w = valid.float()
        if weight is not None:
            tok_w = tok_w * weight[:, None]
        return per_tok.sum() / torch.clamp_min(tok_w.sum(), 1.0)
    raise ValueError(reduction)


def joint_ctc_attention_loss(ctc: torch.Tensor, att: torch.Tensor,
                             ctc_weight: float = 0.3) -> torch.Tensor:
    """ctc_weight * CTC + (1 - ctc_weight) * attention."""
    return ctc_weight * ctc + (1.0 - ctc_weight) * att
