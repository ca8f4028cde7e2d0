"""CTC loss (port of mamba_asr_tpu/ops/ctc.py).

`ctc_forward_score` is the plain alpha recursion over the
blank-interleaved label lattice (length 2S+1), vectorised over the batch
and the lattice and looped over time, float32 in log space: the oracle,
and the CPU path. On a CUDA tensor `ctc_loss` takes the per-utterance NLL
from `torch.nn.functional.ctc_loss(reduction="none", zero_infinity=True)`
instead: the JAX package leaves CTC to XLA, so no TPU kernel is owed and
an ordinary torch op is the rule. Its targets are passed padded, as CUDA
int64, which keeps cuDNN's CTC out (cuDNN is taken only for int32 CPU
targets). Its CUDA backward adds with atomics, so the gradient is not
bit-deterministic. The tests hold it against the plain recursion.

torch's backward returns the gradient through log_softmax (it assumes
its input is one), so gradients are right with respect to the logits
before log_softmax, not with respect to `log_probs` alone.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_NEG_INF = -1e30


def _interleave_blanks(labels: torch.Tensor, blank_id: int) -> torch.Tensor:
    """(B, S) -> (B, 2S+1) lattice: blank, l1, blank, l2, ..., blank."""
    bsz, s = labels.shape
    z = torch.full((bsz, 2 * s + 1), blank_id, dtype=torch.long, device=labels.device)
    z[:, 1::2] = labels.long()
    return z


def ctc_forward_score(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int = 0,
) -> torch.Tensor:
    """(B,) float32 negative log likelihood of each utterance (the sum
    over it, torch's ctc_loss reduction="none"). log_probs (B, T, V)
    log-softmax outputs; labels (B, S) padded arbitrarily past
    label_lengths; input_lengths, label_lengths (B,). An infeasible
    utterance scores about 1e30."""
    log_probs = log_probs.float()
    bsz, t_max, _ = log_probs.shape
    s = labels.shape[1]
    dev = log_probs.device
    z = _interleave_blanks(labels, blank_id)
    zlen = 2 * label_lengths.long() + 1
    in_lens = input_lengths.long()
    width = 2 * s + 1
    neg = torch.full((bsz, 2), _NEG_INF, device=dev)
    z_prev2 = torch.cat([torch.full((bsz, 2), blank_id, dtype=torch.long, device=dev),
                         z], dim=1)[:, :width]
    allow_skip = (z != blank_id) & (z != z_prev2)
    in_lattice = torch.arange(width, device=dev)[None, :] < zlen[:, None]
    emit = torch.gather(log_probs, 2, z[:, None, :].expand(bsz, t_max, width))

    alpha = torch.full((bsz, width), _NEG_INF, device=dev)
    alpha[:, 0] = emit[:, 0, 0]
    if s > 0:
        alpha[:, 1] = torch.where(label_lengths > 0, emit[:, 0, 1],
                                  torch.full_like(emit[:, 0, 1], _NEG_INF))
    for t in range(1, t_max):
        prev1 = torch.cat([neg[:, :1], alpha], dim=1)[:, :width]
        prev2 = torch.cat([neg, alpha], dim=1)[:, :width]
        prev2 = torch.where(allow_skip, prev2, torch.full_like(prev2, _NEG_INF))
        new = torch.logsumexp(torch.stack([alpha, prev1, prev2]), dim=0) + emit[:, t]
        new = torch.where((t < in_lens)[:, None], new, alpha)  # past the end
        alpha = torch.where(in_lattice, new, torch.full_like(new, _NEG_INF))

    end_blank = torch.gather(alpha, 1, (zlen - 1)[:, None])[:, 0]
    end_label = torch.gather(alpha, 1, torch.clamp_min(zlen - 2, 0)[:, None])[:, 0]
    end_label = torch.where(label_lengths > 0, end_label,
                            torch.full_like(end_label, _NEG_INF))
    return -torch.logaddexp(end_blank, end_label)


def _nll(log_probs, labels, input_lengths, label_lengths, blank_id, zero_infinity):
    if log_probs.device.type == "cuda":
        nll = F.ctc_loss(
            log_probs.float().transpose(0, 1), labels.long(),
            input_lengths.long(), label_lengths.long(), blank=blank_id,
            reduction="none", zero_infinity=zero_infinity,
        )
        return nll if zero_infinity else torch.clamp_max(nll, -_NEG_INF)
    nll = ctc_forward_score(log_probs, labels, input_lengths, label_lengths, blank_id)
    if zero_infinity:
        nll = torch.where(nll > 0.5 * -_NEG_INF, torch.zeros_like(nll), nll)
    return nll


def ctc_loss(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int = 0,
    reduction: str = "batchmean",
    weight: Optional[torch.Tensor] = None,
    zero_infinity: bool = True,
) -> torch.Tensor:
    """CTC loss with SpeechBrain's reductions, as the JAX package's.

    zero_infinity zeroes infeasible utterances (label lattice longer than
    the input). reduction: "none" (B,) NLL; "sum"; "batchmean" sum /
    sum(weight) (or / B); "mean" mean of NLL / label_length. weight (B,)
    scales each utterance (0 drops a padding row).
    """
    nll = _nll(log_probs, labels, input_lengths, label_lengths, blank_id,
               zero_infinity)
    if weight is not None:
        nll = nll * weight.float()
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "batchmean":
        denom = weight.float().sum() if weight is not None else torch.tensor(
            float(nll.shape[0]), device=nll.device)
        return nll.sum() / torch.clamp_min(denom, 1.0)
    if reduction == "mean":
        per = nll / torch.clamp_min(label_lengths.float(), 1.0)
        if weight is not None:
            return per.sum() / torch.clamp_min(weight.float().sum(), 1.0)
        return per.mean()
    raise ValueError(f"unknown reduction: {reduction}")
