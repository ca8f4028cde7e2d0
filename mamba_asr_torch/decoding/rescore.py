"""N-best rescoring with the TransformerLM (port of
mamba_asr_tpu/decoding/rescore.py): re-rank a CTC search's final beam by

    score = ctc_score + lm_weight * lm_logp (+ length_bonus * len)

where lm_logp sums the LM's log-probabilities (at temperature_lm) of each
hypothesis' tokens after BOS, plus eos after its last token. The LM
scores every hypothesis of the batch in one full pass (models/lm.py).
Hypotheses fill the U columns of `tokens` up to their length; a
hypothesis of length U gets no eos term (`rescore.py:55-58`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mamba_asr_torch.data.tokenizer import BOS_ID, EOS_ID


@torch.no_grad()
def lm_nbest_scores(lm, tokens: torch.Tensor, lengths: torch.Tensor,
                    temperature: float = 1.0) -> torch.Tensor:
    """tokens (B, N, U), lengths (B, N) -> summed LM log-probs (B, N),
    float32, on the LM's device."""
    b, n, u = tokens.shape
    flat = tokens.reshape(b * n, u).long()
    flat_len = lengths.reshape(b * n).long()
    bos = torch.full((b * n, 1), BOS_ID, dtype=torch.long, device=flat.device)
    logits = lm(torch.cat([bos, flat], dim=1)[:, :-1])  # (BN, U, V)
    lp = torch.log_softmax(logits.float() / temperature, dim=-1)
    tok_lp = torch.gather(lp, 2, flat[..., None])[..., 0]
    valid = torch.arange(u, device=flat.device)[None, :] < flat_len[:, None]
    scores = torch.where(valid, tok_lp, torch.zeros_like(tok_lp)).sum(dim=1)
    eos_pos = torch.clamp_max(flat_len, u - 1)
    eos_lp = lp[torch.arange(b * n, device=flat.device), eos_pos, EOS_ID]
    scores = scores + torch.where(flat_len < u, eos_lp, torch.zeros_like(eos_lp))
    return scores.reshape(b, n)


def rescore_nbest(tokens: torch.Tensor, lengths: torch.Tensor, ctc_scores: torch.Tensor,
                  lm=None, lm_weight: float = 0.6, temperature_lm: float = 1.0,
                  length_bonus: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank each utterance's n-best (tokens (B, N, U), lengths (B, N),
    ctc_scores (B, N)) -> the best hypothesis' (tokens (B, U), lengths (B,))."""
    combined = ctc_scores.float()
    if lm is not None and lm_weight:
        combined = combined + lm_weight * lm_nbest_scores(lm, tokens, lengths,
                                                          temperature_lm)
    if length_bonus:
        combined = combined + length_bonus * lengths.float()
    best = combined.argmax(dim=1)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    return tokens[rows, best], lengths[rows, best]
