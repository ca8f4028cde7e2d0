"""CTC prefix beam search: the host oracle and the batched search on the
device (port of mamba_asr_tpu/decoding/ctc_beam.py).

The CTC recipes' test decoder (hparams/CTC/*.yaml `decode`: beam 100,
beam_prune_logp -12, token_prune_min_logp -1.2): the classic prefix
beam search keeping (blank, non-blank) log probabilities per prefix and
merging duplicate prefixes.

- `ctc_beam_search_ref`: plain Python over one utterance, exact merging.
- `ctc_beam_search`: the beam lives in fixed-shape tensors; each frame
  expands beam x vocab candidates, merges equal prefixes by a sort on
  their rolling hashes and a segment logsumexp, and keeps the top K. A
  Python loop over frames of torch ops, with no host sync inside it, on
  whatever device the log-probs are on. It is token-exact with the JAX
  search: the two 32-bit rolling hashes are the JAX package's uint32
  pair, computed in int64 and masked to 32 bits after every multiply-add,
  the dead beams' salts are the same, the candidates sort in the same
  order (one stable sort on h1 then h2) and the top K break ties by
  the lower index, as `jax.lax.top_k` does.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from mamba_asr_torch.decoding.ctc_greedy import tokens_to_lists
from mamba_asr_torch.decoding.s2s_beam import stable_topk

NEG_INF = -1e30
_U32 = 0xFFFFFFFF
_HASH_MULT1 = 1000003
_HASH_MULT2 = 69069


def ctc_beam_search_ref(
    log_probs: np.ndarray,
    input_length: int,
    beam_size: int = 100,
    blank_id: int = 0,
    beam_prune_logp: float = -12.0,
    token_prune_min_logp: float = -1.2,
) -> List[int]:
    """Host prefix beam search of ONE utterance; log_probs (T, V)."""
    beams = {(): (0.0, -math.inf)}  # prefix -> (p_blank, p_nonblank)
    for t in range(int(input_length)):
        lp = log_probs[t]
        new: dict = {}

        def acc(prefix, pb=None, pnb=None):
            old = new.get(prefix, (-math.inf, -math.inf))
            new[prefix] = (old[0] if pb is None else np.logaddexp(old[0], pb),
                           old[1] if pnb is None else np.logaddexp(old[1], pnb))

        for prefix, (pb, pnb) in beams.items():
            p_tot = np.logaddexp(pb, pnb)
            acc(prefix, pb=p_tot + lp[blank_id])  # a blank keeps the prefix
            if prefix:  # so does repeating its last token (non-blank path)
                acc(prefix, pnb=pnb + lp[prefix[-1]])
            for c in range(len(lp)):
                if c == blank_id or lp[c] < token_prune_min_logp:
                    continue
                contrib = (pb if prefix and c == prefix[-1] else p_tot) + lp[c]
                acc(prefix + (c,), pnb=contrib)

        best = max(np.logaddexp(*v) for v in new.values())
        pruned = {p: v for p, v in new.items()
                  if np.logaddexp(*v) >= best + beam_prune_logp}
        beams = dict(sorted(pruned.items(), key=lambda kv: -np.logaddexp(*kv[1]))[:beam_size])
    return list(max(beams.items(), key=lambda kv: np.logaddexp(*kv[1]))[0])


def ctc_beam_search(
    log_probs: torch.Tensor,
    input_lengths: torch.Tensor,
    beam_size: int = 100,
    blank_id: int = 0,
    beam_prune_logp: float = -12.0,
    token_prune_min_logp: float = -1.2,
    max_tokens: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched prefix beam search. log_probs (B, T, V), input_lengths (B,);
    max_tokens caps the emitted tokens (default T). Returns the best
    prefix per row: tokens (B, max_tokens) int32 and lengths (B,)."""
    toks, lens, total = _beam_search_full(
        log_probs, input_lengths, beam_size, blank_id, beam_prune_logp,
        token_prune_min_logp, max_tokens or log_probs.shape[1])
    best = total.argmax(dim=1)
    rows = torch.arange(toks.shape[0], device=toks.device)
    return toks[rows, best], lens[rows, best]


def ctc_beam_decode(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                    decode) -> List[List[int]]:
    """The search as the recipes' test decoder runs it: a decode stanza's
    (configs/loader.py:DecodeConfig) test_beam_size, blank_index,
    beam_prune_logp and token_prune_min_logp; token ids per row."""
    toks, lens = ctc_beam_search(
        log_probs, input_lengths, beam_size=decode.test_beam_size,
        blank_id=decode.blank_index, beam_prune_logp=decode.beam_prune_logp,
        token_prune_min_logp=decode.token_prune_min_logp)
    return tokens_to_lists(toks.cpu().numpy(), lens.cpu().numpy())


def _seg_lse(vals: torch.Tensor, seg_id: torch.Tensor) -> torch.Tensor:
    """The logsumexp of each segment of `vals` (B, n) (segments numbered
    by seg_id, contiguous), given back at every member; -1e30 where a
    segment holds no live value."""
    bsz, n = vals.shape
    seg_max = torch.full((bsz, n), NEG_INF, device=vals.device)
    seg_max = seg_max.scatter_reduce(1, seg_id, vals, reduce="amax", include_self=True)
    vmax = torch.gather(seg_max, 1, seg_id)
    expv = torch.exp(torch.clamp_min(vals - vmax, -80.0))
    expv = torch.where(vals <= NEG_INF * 0.5, torch.zeros_like(expv), expv)
    seg_sum = torch.zeros((bsz, n), device=vals.device).scatter_add(1, seg_id, expv)
    tot = torch.gather(seg_sum, 1, seg_id)
    out = vmax + torch.log(torch.clamp_min(tot, 1e-38))
    return torch.where(tot > 0, out, torch.full_like(out, NEG_INF))


def _beam_search_full(
    log_probs: torch.Tensor,
    input_lengths: torch.Tensor,
    beam_size: int,
    blank_id: int,
    beam_prune_logp: float,
    token_prune_min_logp: float,
    u_max: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The search; returns the whole final beam: tokens (B, K, U) int32,
    lengths (B, K) int32 and total log probabilities (B, K)."""
    dev = log_probs.device
    bsz, t_max, vocab = log_probs.shape
    k = beam_size
    i64 = dict(dtype=torch.int64, device=dev)
    input_lengths = input_lengths.to(dev)
    beam_idx = torch.arange(k, **i64)
    vocab_idx = torch.arange(vocab, **i64)

    # Beam state per row: pb, pnb (B, K) blank / non-blank log probs;
    # toks (B, K, U) prefixes, lens (B, K), last (B, K) last token or -1;
    # h1, h2 (B, K) the prefix's two 32-bit rolling hashes (in int64).
    pb = torch.full((bsz, k), NEG_INF, device=dev)
    pb[:, 0] = 0.0
    pnb = torch.full((bsz, k), NEG_INF, device=dev)
    toks = torch.zeros((bsz, k, u_max), dtype=torch.int32, device=dev)
    lens = torch.zeros((bsz, k), dtype=torch.int32, device=dev)
    last = torch.full((bsz, k), -1, **i64)
    # Distinct hashes, so empty dead beams do not merge with beam 0.
    h1 = ((beam_idx * 2654435761) & _U32).expand(bsz, k).clone()
    h2 = ((beam_idx * 40503 + 7) & _U32).expand(bsz, k).clone()
    h1[:, 0] = 0
    h2[:, 0] = 0

    # Each step's candidates: K "stay" (same prefix) + K * V "extend".
    n_cand = k + k * vocab
    src_beam = torch.cat([beam_idx, beam_idx.repeat_interleave(vocab)]).expand(bsz, n_cand)
    ext_tok = torch.cat([torch.full((k,), -1, **i64), vocab_idx.repeat(k)]).expand(bsz, n_cand)
    no_pb = torch.full((bsz, k * vocab), NEG_INF, device=dev)
    pos_u = torch.arange(u_max, device=dev)
    salt_base = torch.arange(k, **i64)[None, :]
    not_blank = vocab_idx[None, None, :] != blank_id

    lps = log_probs.float()
    for t in range(t_max):
        lp = lps[:, t]  # (B, V)
        active = (t < input_lengths)[:, None]  # (B, 1)
        p_tot = torch.logaddexp(pb, pnb)

        stay_pb = p_tot + lp[:, blank_id:blank_id + 1]
        rep_lp = torch.gather(lp, 1, torch.clamp_min(last, 0))
        stay_pnb = torch.where(last >= 0, pnb + rep_lp, torch.full_like(pnb, NEG_INF))

        same_as_last = vocab_idx[None, None, :] == last[..., None]
        ext = torch.where(same_as_last, pb[..., None], p_tot[..., None]) + lp[:, None, :]
        tok_ok = (not_blank & (lp[:, None, :] >= token_prune_min_logp)
                  & (lens[..., None] < u_max))
        ext = torch.where(tok_ok, ext, torch.full_like(ext, NEG_INF))

        new_h1 = (h1[..., None] * _HASH_MULT1 + vocab_idx + 1) & _U32
        new_h2 = (h2[..., None] * _HASH_MULT2 + vocab_idx + 101) & _U32
        cand_pb = torch.cat([stay_pb, no_pb], dim=1)
        cand_pnb = torch.cat([stay_pnb, ext.reshape(bsz, -1)], dim=1)
        cand_h1 = torch.cat([h1, new_h1.reshape(bsz, -1)], dim=1)
        cand_h2 = torch.cat([h2, new_h2.reshape(bsz, -1)], dim=1)

        # Sort by (h1, h2), stable: (h1 - 2^31) * 2^32 + h2 fits in int64
        # and orders as JAX's two stable argsorts (h2, then h1) do.
        key = (cand_h1 - (1 << 31)) * (1 << 32) + cand_h2
        order = torch.sort(key, dim=1, stable=True).indices
        s_h1 = torch.gather(cand_h1, 1, order)
        s_h2 = torch.gather(cand_h2, 1, order)
        s_pb = torch.gather(cand_pb, 1, order)
        s_pnb = torch.gather(cand_pnb, 1, order)
        s_src = torch.gather(src_beam, 1, order)
        s_ext = torch.gather(ext_tok, 1, order)

        is_head = torch.ones((bsz, n_cand), dtype=torch.bool, device=dev)
        is_head[:, 1:] = (s_h1[:, 1:] != s_h1[:, :-1]) | (s_h2[:, 1:] != s_h2[:, :-1])
        seg_id = torch.cumsum(is_head, dim=1) - 1
        m_pb = _seg_lse(s_pb, seg_id)
        m_pnb = _seg_lse(s_pnb, seg_id)
        dead_val = torch.full_like(m_pb, NEG_INF)
        m_tot = torch.where(is_head, torch.logaddexp(m_pb, m_pnb), dead_val)
        best = m_tot.max(dim=1, keepdim=True).values
        m_tot = torch.where(m_tot >= best + beam_prune_logp, m_tot, dead_val)

        top_val, top_idx = stable_topk(m_tot, k)
        n_pb = torch.gather(m_pb, 1, top_idx)
        n_pnb = torch.gather(m_pnb, 1, top_idx)
        n_h1 = torch.gather(s_h1, 1, top_idx)
        n_h2 = torch.gather(s_h2, 1, top_idx)
        n_src = torch.gather(s_src, 1, top_idx)
        n_ext = torch.gather(s_ext, 1, top_idx)

        src_toks = torch.gather(toks, 1, n_src[..., None].expand(bsz, k, u_max))
        src_lens = torch.gather(lens, 1, n_src)
        src_last = torch.gather(last, 1, n_src)
        extended = n_ext >= 0
        pos = torch.clamp_max(src_lens, u_max - 1)
        write = (pos_u[None, None, :] == pos[..., None]) & extended[..., None]
        new_toks = torch.where(write, n_ext[..., None].to(torch.int32), src_toks)
        n_lens = torch.where(extended, src_lens + 1, src_lens)
        n_last = torch.where(extended, n_ext, src_last)

        # Dead beams (score -1e30) take salted hashes that merge with nothing.
        dead = top_val <= NEG_INF * 0.5
        salt = (salt_base + 977 * t) & _U32
        n_h1 = torch.where(dead, (0x9E3779B9 + salt) & _U32, n_h1)
        n_h2 = torch.where(dead, (0x85EBCA6B + salt * 3) & _U32, n_h2)

        # Frames past a row's length leave its state as it was.
        pb = torch.where(active, n_pb, pb)
        pnb = torch.where(active, n_pnb, pnb)
        toks = torch.where(active[..., None], new_toks, toks)
        lens = torch.where(active, n_lens, lens)
        last = torch.where(active, n_last, last)
        h1 = torch.where(active, n_h1, h1)
        h2 = torch.where(active, n_h2, h2)
    return toks, lens, torch.logaddexp(pb, pnb)


def ctc_beam_search_nbest(
    log_probs: torch.Tensor,
    input_lengths: torch.Tensor,
    nbest: int = 10,
    beam_size: int = 100,
    blank_id: int = 0,
    beam_prune_logp: float = -12.0,
    token_prune_min_logp: float = -1.2,
    max_tokens: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The n best prefixes of the final beam, best first: tokens
    (B, n, U), lengths (B, n) and total log probabilities (B, n)."""
    toks, lens, total = _beam_search_full(
        log_probs, input_lengths, beam_size, blank_id, beam_prune_logp,
        token_prune_min_logp, max_tokens or log_probs.shape[1])
    top_val, top_idx = stable_topk(total, min(nbest, beam_size))
    nb_toks = torch.gather(toks, 1, top_idx[..., None].expand(-1, -1, toks.shape[2]))
    return nb_toks, torch.gather(lens, 1, top_idx), top_val
