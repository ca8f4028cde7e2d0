"""Batched CTC prefix scorer for joint CTC/attention beam search (port of
mamba_asr_tpu/decoding/ctc_prefix_scorer.py; the ESPnet CTCPrefixScore
formulation of SpeechBrain's CTCScorer).

Per hypothesis g and next token c, in log space:

    phi(t, c) = r_b^g(t) + (c == last(g) ? -inf : r_nb^g(t))
    psi(c)    = logsumexp_t [ phi(t-1, c) + logp(t, c) ]

`score` returns the incremental psi(c) - psi(g) for every token, eos
scoring the whole prefix (r_b + r_nb at the last valid frame). Only the
same-token column needs its own sum; every other column is one
probability-space matmul over the full vocabulary,

    psi[n, v] = m[n] + log( exp(phi_sh[n, :] - m[n]) @ exp(lp[b(n)]) ),

with exp(lp) (T, V) computed once per utterance. That product runs in
true float32: `_fp32_matmul` holds torch's float32 matmul precision at
"highest" around it (no TF32 on the card, whatever the caller set), as
the JAX package asks for Precision.HIGHEST: a TF32 psi is ~1e-3 nat off,
enough to flip near-tied hypotheses. A candidate list masks the full psi
plane to NEG_INF outside it (the partial scorer's API; the product costs
the same).

`select` advances r_nb / r_b for the one token each surviving hypothesis
chose: the two frame recurrences run in `ops.ctc_dp.ctc_dp`, which is K3
on the card (one launch per beam step) and the plain loop on the CPU.
Hypotheses that chose eos keep their parent's state; their rows are
computed all the same and discarded.

Hypothesis rows index the (B, T, V) log-probs through row // beam: the
scorer holds no per-hypothesis copy of them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from mamba_asr_torch.ops.ctc_dp import ctc_dp

NEG_INF = -1e30


class CTCPrefixState(NamedTuple):
    r_nb: torch.Tensor  # (N, T) non-blank end log-prob of the prefix
    r_b: torch.Tensor   # (N, T) blank end log-prob of the prefix
    psi: torch.Tensor   # (N,) accumulated prefix score
    last: torch.Tensor  # (N,) last token of the prefix (-1 = empty)


@contextlib.contextmanager
def _fp32_matmul():
    """float32 matmuls in full float32 (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


class CTCPrefixScorer:
    """Scorer over a flattened hypothesis batch of N = B * beam rows."""

    def __init__(self, log_probs: torch.Tensor, input_lengths: torch.Tensor,
                 beam: int, blank_id: int = 0, eos_id: int = 2):
        b, t, v = log_probs.shape
        dev = log_probs.device
        self.lp = log_probs.float()
        self.beam = beam
        self.lens = input_lengths.to(dev).long().repeat_interleave(beam)
        self.blank = blank_id
        self.eos = eos_id
        self.n, self.t, self.v = b * beam, t, v
        self.bidx = torch.arange(self.n, device=dev) // beam
        self.frame_valid = torch.arange(t, device=dev)[None, :] < self.lens[:, None]
        self.lp_blank = torch.where(
            self.frame_valid, self.lp[:, :, blank_id].repeat_interleave(beam, 0), 0.0)
        self.p = torch.exp(self.lp)  # (B, T, V), for psi's product
        # Token-major copy: a hypothesis' frame row of one token is contiguous.
        self.lp_t = self.lp.transpose(1, 2).contiguous()  # (B, V, T)
        # The DP's frame-major (T, N) planes that do not change per step.
        self.lpb_tn = self.lp_blank.T.contiguous()
        self.valid_tn = self.frame_valid.T.float().contiguous()

    def init_state(self) -> CTCPrefixState:
        """The empty prefix: r_b(t) = the blanks' log-prob up to t."""
        cum_blank = torch.cumsum(self.lp_blank, dim=1)
        dev = self.lp.device
        return CTCPrefixState(
            r_nb=torch.full((self.n, self.t), NEG_INF, device=dev),
            r_b=torch.where(self.frame_valid, cum_blank, NEG_INF),
            psi=torch.zeros(self.n, device=dev),
            last=torch.full((self.n,), -1, dtype=torch.long, device=dev),
        )

    def _shifted(self, first: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """[first, rows[:, :-1]] along frames, NEG_INF past each length."""
        sh = torch.cat([first[:, None], rows[:, :-1]], dim=1)
        return torch.where(self.frame_valid, sh, NEG_INF)

    def score(self, state: CTCPrefixState, candidates: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Incremental prefix scores (N, V) of every next token, and the
        psi plane `select` reads. candidates (N, C) token ids: scores
        outside them are NEG_INF."""
        n, t, v, k = self.n, self.t, self.v, self.beam
        empty = state.last < 0
        boundary = torch.where(empty, 0.0, NEG_INF)
        phi_sh = self._shifted(boundary, torch.logaddexp(state.r_b, state.r_nb))
        m = phi_sh.max(dim=1).values
        e_phi = torch.exp(phi_sh - m[:, None])
        with _fp32_matmul():
            acc = torch.bmm(e_phi.reshape(-1, k, t), self.p).reshape(n, v)
        # Floor, don't ban (the JAX package's note): a token whose emission
        # underflows at every frame keeps a finite, very low score.
        psi = m[:, None] + torch.log(torch.clamp_min(acc, 1e-30))
        psi = torch.where(torch.isfinite(psi), psi, NEG_INF)

        # Same-token column: phi uses r_b only.
        lp_last = self.lp_t[self.bidx, state.last.clamp_min(0)]  # (N, T)
        phi_same_sh = self._shifted(boundary, state.r_b)
        psi_same = torch.logsumexp(phi_same_sh + lp_last, dim=1)
        col = torch.arange(v, device=psi.device)[None, :]
        psi = torch.where(col == state.last[:, None], psi_same[:, None], psi)

        # eos: the whole prefix at the last valid frame.
        idx = (self.lens - 1).clamp_min(0)[:, None]
        eos_psi = torch.logaddexp(state.r_b.gather(1, idx)[:, 0],
                                  state.r_nb.gather(1, idx)[:, 0])
        eos_psi = torch.where(empty, 0.0, eos_psi)

        scores = psi - state.psi[:, None]
        scores = torch.where(col == self.eos, (eos_psi - state.psi)[:, None], scores)
        scores = torch.where(col == self.blank, NEG_INF, scores)
        if candidates is not None:
            member = torch.zeros(n, v, dtype=torch.bool, device=psi.device)
            member.scatter_(1, candidates.long(), True)
            scores = torch.where(member, scores, NEG_INF)
        return scores, {"psi": psi}

    def select(self, state: CTCPrefixState, aux: Dict[str, torch.Tensor],
               tokens: torch.Tensor, reorder: torch.Tensor) -> CTCPrefixState:
        """Advance the state after beam selection. tokens (N,): the token
        each new hypothesis appended; reorder (N,): its parent's row."""
        tokens = tokens.long()
        psi = aux["psi"][reorder, tokens]
        r_b_par, r_nb_par, last_par = (x[reorder] for x in
                                       (state.r_b, state.r_nb, state.last))
        lp_tok = self.lp_t[self.bidx, tokens]  # (N, T)
        same = (tokens == last_par)[:, None]
        phi = torch.where(same, r_b_par, torch.logaddexp(r_b_par, r_nb_par))
        first = torch.where(last_par < 0, 0.0, NEG_INF)
        phi_shift = torch.cat([first[:, None], phi[:, :-1]], dim=1)
        valid = self.frame_valid
        grow = torch.where(valid, phi_shift + lp_tok, NEG_INF)
        a_nb = torch.where(valid, lp_tok, 0.0)
        r_nb_t, r_b_t = ctc_dp(a_nb.T.contiguous(), grow.T.contiguous(),
                               self.lpb_tn, self.valid_tn)
        r_nb, r_b = r_nb_t.T, r_b_t.T

        keep_old = tokens == self.eos
        old_psi = state.psi[reorder]
        return CTCPrefixState(
            r_nb=torch.where(keep_old[:, None], r_nb_par, r_nb),
            r_b=torch.where(keep_old[:, None], r_b_par, r_b),
            psi=torch.where(keep_old, old_psi, psi),
            last=torch.where(keep_old, last_par, tokens),
        )
