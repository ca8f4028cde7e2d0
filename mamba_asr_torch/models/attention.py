"""Regular multi-head attention (port of mamba_asr_tpu/models/attention.py:
MultiheadAttention, SpeechBrain's regularMHA).

Three paths:
- `forward` without `static_kv`: self-attention of (B, L, D). Boolean
  masks (True = disallowed) replace a score by NEG_INF = -1e9, as the
  JAX package's `where` does (`attention.py:_apply_masks`).
- Cross-attention over a fixed memory: `precompute_kv(memory)` projects
  the memory once into heads-major (B, H, T, dh) K/V, and `forward(...,
  static_kv=(k, v))` reads them each step. B' may be a multiple g of B:
  query rows g*b .. g*b+g-1 then read utterance b (the beam rows of one
  utterance). The JAX package repeats the memory to B' rows first
  (`s2s_beam.py` `enc_rep`); the per-row arithmetic is the same, and the
  g queries of an utterance share one (g, dh) x (dh, T) product.
- `step_beam`: the append-only beam cache. This step's K/V are written in
  place at [:, pos, n] of (H, S, N, dh) buffers (the JAX package returns
  updated copies), and each hypothesis' single query attends through the
  ancestor table (`ops/beam_attention.py`, K4 on the card).

Dtypes follow the JAX package: projections and scores in the compute
dtype, softmax in float32 and cast back (`attention.py:203-213`). In
train() mode `forward` drops attention weights with probability
`dropout` after the softmax, as the JAX package does
(`attention.py:197, 210`); `step_beam` serves the search and has none.

State-dict names are SpeechBrain's: `att.in_proj_weight` and
`att.in_proj_bias` hold q, k and v stacked, `att.out_proj` the output
(`models/torch_export.py:_sb_mha`).

RelPosMHAXL (port of `attention.py:219-298`, SpeechBrain's RelPosMHAXL,
the Conformer's default): Transformer-XL relative-position self-attention,

    score(i, j) = ((q_i + u) . k_j + (q_i + v) . p_{j-i}) / sqrt(dh)

with no-bias q, k, v and position projections, float32 biases u and v
(cast to q's dtype) and the sinusoidal offsets of `rel_pos_encoding`.
The position scores are taken against all 2L-1 offsets and aligned by
the Transformer-XL pad-and-reshape shift (JAX's index arithmetic), or by
a gather where the query and key lengths differ. Its names are
SpeechBrain's (`torch_export.py:_relpos_mha`): `in_proj_weight`,
`out_proj`, `linear_pos.weight`, `pos_bias_u`, `pos_bias_v`.

`self_attention(attention_type, ...)` builds the attention of an encoder
layer: RelPosMHAXL, regularMHA (this module's MultiheadAttention) or
hypermixing (models/hypermixing.py). Each takes `(x, attn_mask,
key_padding_mask, pos_embs)`; regularMHA ignores pos_embs, as JAX's does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_asr_torch.models.layers import dense, dropout, write_at
from mamba_asr_torch.ops.beam_attention import beam_attention

NEG_INF = -1e9

KV = Tuple[torch.Tensor, torch.Tensor]


class _Att(nn.Module):
    """torch.nn.MultiheadAttention's parameters, as SpeechBrain nests them."""

    def __init__(self, d_model: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)


class MultiheadAttention(nn.Module):
    def __init__(self, d_model: int, nhead: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} is not a multiple of nhead {nhead}")
        self.att = _Att(d_model)
        self.nhead = nhead
        self.dtype = dtype
        self.dropout = dropout

    def _proj(self, x: torch.Tensor, first: int, count: int) -> torch.Tensor:
        """Projections first .. first+count-1 of (q, k, v), stacked on the
        last axis, in the compute dtype: (..., count * D)."""
        d = x.shape[-1]
        rows = slice(first * d, (first + count) * d)
        w = self.att.in_proj_weight[rows].to(self.dtype)
        b = self.att.in_proj_bias[rows].to(self.dtype)
        return F.linear(x.to(self.dtype), w, b)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, D) -> heads-major (B, H, L, dh)."""
        b, length, d = x.shape
        return x.reshape(b, length, self.nhead, d // self.nhead).transpose(1, 2)

    def precompute_kv(self, memory: torch.Tensor) -> KV:
        """Projected K and V of a memory (B, T, D), heads-major (B, H, T, dh)."""
        k, v = self._proj(memory, 1, 2).chunk(2, dim=-1)
        return self._heads(k).contiguous(), self._heads(v).contiguous()

    def forward(self, query: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                static_kv: Optional[KV] = None,
                pos_embs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (B', Lq, D) -> (B', Lq, D): self-attention, or with
        `static_kv` cross-attention over a projected memory. attn_mask
        (Lq, Lk) and key_padding_mask (B, Lk) are boolean, True =
        disallowed. pos_embs is ignored: the absolute-PE path adds its
        encodings to the inputs (JAX `attention.py:113`)."""
        bq, lq, d = query.shape
        if static_kv is None:
            q, k, v = self._proj(query, 0, 3).chunk(3, dim=-1)
            k, v = self._heads(k), self._heads(v)
        else:
            q = self._proj(query, 0, 1)
            k, v = static_kv
        b, h, lk, dh = k.shape
        g = bq // b
        if g * b != bq or (g > 1 and attn_mask is not None):
            raise ValueError(f"{bq} query rows over {b} memories (an attn_mask "
                             "needs one query row per memory)")
        qh = q.reshape(b, g * lq, h, dh).transpose(1, 2)  # (B, H, g*Lq, dh)
        scores = torch.matmul(qh, k.to(q.dtype).transpose(-1, -2)) / math.sqrt(dh)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask, NEG_INF)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
        attn = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        attn = dropout(attn, self.dropout, self.training)
        out = torch.matmul(attn, v.to(attn.dtype))  # (B, H, g*Lq, dh)
        out = out.transpose(1, 2).reshape(bq, lq, d)
        return dense(out, self.att.out_proj, self.dtype)

    def step_beam(self, x: torch.Tensor, cache: KV, pos,
                  anc: torch.Tensor) -> torch.Tensor:
        """One decode step of self-attention over the append-only cache.

        x (N, 1, D); cache (k_buf, v_buf), each (H, S, N, dh) in the
        compute dtype, written in place at position `pos` (a host int or a
        `ops.beam_attention.StepPos`); anc (S, N)
        int32, anc[j, n] = the buffer row that holds position j of
        hypothesis n. Returns (N, 1, D)."""
        n, _, d = x.shape
        h = self.nhead
        q, k, v = self._proj(x, 0, 3).reshape(n, 3, h, d // h).unbind(1)
        k_buf, v_buf = cache
        write_at(k_buf, 1, pos, k.transpose(0, 1))
        write_at(v_buf, 1, pos, v.transpose(0, 1))
        out = beam_attention(q.contiguous(), k_buf, v_buf, anc, pos)  # (N, H, dh)
        return dense(out.reshape(n, 1, d), self.att.out_proj, self.dtype)


def rel_pos_encoding(length: int, d_model: int, dtype: torch.dtype = torch.float32,
                     device=None) -> torch.Tensor:
    """Sinusoidal embeddings of the relative offsets r = j - i: (2L-1,
    d_model), row r + (L-1) holding offset r in [-(L-1), L-1]
    (`attention.py:39`), computed in float32 and cast to dtype."""
    positions = torch.arange(-(length - 1), length, dtype=torch.float32,
                             device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros(2 * length - 1, d_model, device=device)
    pe[:, 0::2] = torch.sin(positions * div)
    pe[:, 1::2] = torch.cos(positions * div)
    return pe.to(dtype)


def _masked(scores: torch.Tensor, attn_mask: Optional[torch.Tensor],
            key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """`attention.py:_apply_masks`: scores (B, H, Lq, Lk); attn_mask (Lq,
    Lk) and key_padding_mask (B, Lk), True = disallowed -> NEG_INF."""
    if attn_mask is not None:
        scores = scores.masked_fill(attn_mask, NEG_INF)
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    return scores


class RelPosMHAXL(nn.Module):
    """Transformer-XL relative-position multi-head self-attention."""

    def __init__(self, d_model: int, nhead: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, mask_pos_future: bool = False):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} is not a multiple of nhead {nhead}")
        dh = d_model // nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(nhead, dh))
        self.pos_bias_v = nn.Parameter(torch.empty(nhead, dh))
        self.nhead = nhead
        self.dtype = dtype
        self.dropout = dropout
        self.mask_pos_future = mask_pos_future

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        """The JAX package's zero biases u and v (the projections take
        flax's default kernel init with the other layers)."""
        self.pos_bias_u.zero_()
        self.pos_bias_v.zero_()

    def forward(self, query: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                pos_embs: Optional[torch.Tensor] = None,
                key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (B, Lq, D) -> (B, Lq, D); key and value default to query.
        pos_embs (2Lk-1, D) from `rel_pos_encoding` (built in query's
        dtype when None); masks as MultiheadAttention's."""
        key = query if key is None else key
        value = key if value is None else value
        b, lq, d = query.shape
        lk = key.shape[1]
        h, dt = self.nhead, self.dtype
        dh = d // h
        w = self.in_proj_weight.to(dt)

        def proj(x, i):
            return F.linear(x.to(dt), w[i * d:(i + 1) * d]).reshape(*x.shape[:-1], h, dh)

        q, k, v = proj(query, 0), proj(key, 1), proj(value, 2)  # (B, L, H, dh)
        if pos_embs is None:
            pos_embs = rel_pos_encoding(lk, d, query.dtype, query.device)
        p = F.linear(pos_embs.to(dt), self.linear_pos.weight.to(dt)).reshape(-1, h, dh)
        qu = (q + self.pos_bias_u.to(q.dtype)).transpose(1, 2)  # (B, H, Lq, dh)
        qv = (q + self.pos_bias_v.to(q.dtype)).transpose(1, 2)
        content = torch.matmul(qu, k.permute(0, 2, 3, 1))  # (B, H, Lq, Lk)
        # Scores against every offset: want pos[..., i, j] = all[..., i, j - i + Lk - 1].
        pos_all = torch.matmul(qv, p.permute(1, 2, 0))  # (B, H, Lq, 2Lk-1)
        if lq == lk:
            # The Transformer-XL shift: pad one column, flatten, reslice.
            x = F.pad(pos_all, (0, 1)).reshape(b, h, lq * 2 * lk)
            x = x[:, :, lk - 1:lk - 1 + lq * (2 * lk - 1)]
            pos_score = x.reshape(b, h, lq, 2 * lk - 1)[..., :lk]
        else:
            idx = (torch.arange(lk, device=query.device)[None, :]
                   - torch.arange(lq, device=query.device)[:, None] + (lk - 1))
            pos_score = torch.gather(pos_all, -1, idx.expand(b, h, lq, lk))
        scores = (content + pos_score) / math.sqrt(dh)
        if self.mask_pos_future:
            future = torch.ones(lq, lk, dtype=torch.bool, device=query.device).triu(1)
            scores = scores.masked_fill(future, NEG_INF)
        scores = _masked(scores, attn_mask, key_padding_mask)
        attn = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        attn = dropout(attn, self.dropout, self.training)
        out = torch.matmul(attn, v.transpose(1, 2).to(attn.dtype))  # (B, H, Lq, dh)
        return dense(out.transpose(1, 2).reshape(b, lq, d), self.out_proj, dt)


def self_attention(attention_type: str, d_model: int, nhead: int, hypernet_size: int,
                   dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                   mask_pos_future: bool = False) -> nn.Module:
    """An encoder layer's self-attention (JAX `conformer.py:70-90`):
    RelPosMHAXL (masking the future when `mask_pos_future`), regularMHA or
    HyperMixing (untied, `hypernet_size` hidden units, the reference's
    construction)."""
    if attention_type == "RelPosMHAXL":
        return RelPosMHAXL(d_model, nhead, dtype, dropout, mask_pos_future)
    if attention_type == "regularMHA":
        return MultiheadAttention(d_model, nhead, dtype, dropout)
    if attention_type == "hypermixing":
        from mamba_asr_torch.models.hypermixing import HyperMixing

        return HyperMixing(d_model, hypernet_size, nhead, dtype)
    raise ValueError(f"unknown attention_type {attention_type!r}")
