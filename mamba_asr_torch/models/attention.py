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
dtype, softmax in float32 and cast back (`attention.py:203-213`).

State-dict names are SpeechBrain's: `att.in_proj_weight` and
`att.in_proj_bias` hold q, k and v stacked, `att.out_proj` the output
(`models/torch_export.py:_sb_mha`). RelPosMHAXL waits for the Conformer
slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_asr_torch.models.layers import dense
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
    def __init__(self, d_model: int, nhead: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} is not a multiple of nhead {nhead}")
        self.att = _Att(d_model)
        self.nhead = nhead
        self.dtype = dtype

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
                static_kv: Optional[KV] = None) -> torch.Tensor:
        """query (B', Lq, D) -> (B', Lq, D): self-attention, or with
        `static_kv` cross-attention over a projected memory. attn_mask
        (Lq, Lk) and key_padding_mask (B, Lk) are boolean, True =
        disallowed."""
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
        out = torch.matmul(attn, v.to(attn.dtype))  # (B, H, g*Lq, dh)
        out = out.transpose(1, 2).reshape(bq, lq, d)
        return dense(out, self.att.out_proj, self.dtype)

    def step_beam(self, x: torch.Tensor, cache: KV, pos: int,
                  anc: torch.Tensor) -> torch.Tensor:
        """One decode step of self-attention over the append-only cache.

        x (N, 1, D); cache (k_buf, v_buf), each (H, S, N, dh) in the
        compute dtype, written in place at position `pos`; anc (S, N)
        int32, anc[j, n] = the buffer row that holds position j of
        hypothesis n. Returns (N, 1, D)."""
        n, _, d = x.shape
        h = self.nhead
        q, k, v = self._proj(x, 0, 3).reshape(n, 3, h, d // h).unbind(1)
        k_buf, v_buf = cache
        k_buf[:, pos] = k.transpose(0, 1)
        v_buf[:, pos] = v.transpose(0, 1)
        out = beam_attention(q.contiguous(), k_buf, v_buf, anc, pos)  # (N, H, dh)
        return dense(out.reshape(n, 1, d), self.att.out_proj, self.dtype)
