"""Ancestor-masked single-query attention over append-only beam K/V
caches (port of mamba_asr_tpu/ops/pallas/beam_attention.py).

Beam search keeps each decoder layer's self-attention K/V in buffers of
layout (H, S, N, dh): hypothesis row n writes its position-s projection
at [:, s, n] and nothing is ever moved. The searcher keeps an ancestor
table anc (S, N) int32, anc[j, n] = the row that holds position j of
hypothesis n's prefix. Attention for hypothesis n and head h is then

    out[n, h] = softmax_j( q[n, h] . k[h, j, anc[j, n]] / sqrt(dh) ) . v[h, j, anc[j, n]]

over positions j <= pos, in float32, returned in q's dtype.

- `beam_attention_ref`: the plain version, a copy of the JAX package's
  `beam_attention_gather` (`beam_attention.py:170-191`): gather each
  hypothesis' rows through the table, masked softmax over all S
  positions. Never-written rows must be finite (the caches are zero-
  filled): a masked position's zero weight times a NaN row is NaN.
- `beam_attention`: the dispatch. CUDA tensors go to K4
  (`kernels/beam_attention.py`, which replaces `_beam_attn_kernel`) at
  every N, CPU tensors to the plain version. The TPU dispatch falls back
  to the gather when its VMEM set does not fit (`_pick_h_block`); the
  Hopper kernel reads rows by gather and has no such limit.
"""

from __future__ import annotations

import math

import torch

NEG = -1e30


def beam_attention_ref(q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor,
                       anc: torch.Tensor, pos: int) -> torch.Tensor:
    """q (N, H, dh); k_buf, v_buf (H, S, N, dh); anc (S, N) int; pos: the
    last position to attend. Returns (N, H, dh) in q's dtype."""
    h, s, _, dh = k_buf.shape
    n = anc.shape[1]
    qh = q.transpose(0, 1).float()  # (H, N, dh)
    idx = anc.long()[None, :, :, None].expand(h, s, n, dh)
    k_sel = torch.gather(k_buf, 2, idx).float()  # (H, S, N, dh)
    v_sel = torch.gather(v_buf, 2, idx).float()
    scores = torch.einsum("hnd,hjnd->hnj", qh, k_sel) / math.sqrt(dh)
    j_valid = torch.arange(s, device=q.device) <= pos
    scores = torch.where(j_valid[None, None, :], scores, NEG)
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("hnj,hjnd->nhd", attn, v_sel)
    return out.to(q.dtype)


def beam_attention(q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor,
                   anc: torch.Tensor, pos: int) -> torch.Tensor:
    """The plain version on a CPU tensor, K4 on a CUDA one."""
    if q.device.type == "cpu":
        return beam_attention_ref(q, k_buf, v_buf, anc, pos)
    if q.device.type == "cuda":
        from mamba_asr_torch.kernels.beam_attention import beam_attention_fwd

        return beam_attention_fwd(q, k_buf, v_buf, anc, pos)
    raise ValueError(f"no beam attention for device {q.device}")
