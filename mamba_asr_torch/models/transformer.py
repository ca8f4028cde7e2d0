"""Transformer pieces of the S2S path (port of
mamba_asr_tpu/models/transformer.py): the sinusoidal position table, the
normalized token embedding, the mask helpers, and the pre-LN Transformer
decoder with its decode cache.

Masks are boolean, True = disallowed or padded.

TransformerDecoder (reference Transformer.py:1527-1647, always pre-LN in
the S2S recipes): per layer

    x = x + self_attn(LN1(x))      causal
    x = x + cross_attn(LN2(x), memory)
    x = x + ffn(LN3(x))

then a final LN. It has two ways in:
- `forward`: the full teacher-forced pass over (B, S) target states,
  with the look-ahead mask (the oracle of the cache in the tests);
- the decode cache: `init_cache(n, s_max)` allocates every layer's
  append-only self-attention K/V as zero-filled (H, S, N, dh) buffers
  (zeros, not `empty`: the plain beam attention multiplies masked rows by
  a zero weight, and a NaN row would leak), `prime_cache(memory)`
  projects the encoder memory into each layer's cross K/V once, and
  `step(tgt_t, pos, cache, anc)` runs one position of N hypotheses
  through the ancestor table (models/attention.py:step_beam).

The JAX package's heads-major reorder cache (`beam_gather=False`) and
the search's full-prefix re-score (`use_cache=False`) are A/B switches of
the TPU search and are not ported. The decoder runs without dropout: the
S2S training path comes with a later slice.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from mamba_asr_torch.models.attention import MultiheadAttention
from mamba_asr_torch.models.layers import (
    Activation,
    PositionalwiseFeedForward,
    SBLayerNorm,
    layer_norm,
    swish,
)

Cache = Dict[str, Any]


def sinusoidal_position_encoding(length: int, d_model: int,
                                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Absolute sinusoidal position table (length, d_model)."""
    pos = torch.arange(length, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros(length, d_model)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


class _SBEmbedding(nn.Module):
    """SpeechBrain's Embedding wrapper: the table sits under `.Embedding`."""

    def __init__(self, vocab_size: int, d_model: int):
        super().__init__()
        self.Embedding = nn.Embedding(vocab_size, d_model)


class NormalizedEmbedding(nn.Module):
    """Token embedding scaled by sqrt(d_model) (reference
    Transformer.py:1851-1860), in the compute dtype. The JAX package draws
    the table from normal(stddev 1.0); `asr.init_params_` does too."""

    def __init__(self, vocab_size: int, d_model: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.emb = _SBEmbedding(vocab_size, d_model)
        self.d_model = d_model
        self.dtype = dtype

    @property
    def weight(self) -> torch.Tensor:
        return self.emb.Embedding.weight

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.weight.to(self.dtype)[tokens] * math.sqrt(self.d_model)


def lengths_to_padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool, True = padding."""
    return torch.arange(max_len, device=lengths.device)[None, :] >= lengths[:, None]


def get_lookahead_mask(length: int, device=None) -> torch.Tensor:
    """(L, L) causal mask, True above the diagonal (disallowed)."""
    return torch.ones(length, length, dtype=torch.bool, device=device).triu(1)


class TransformerDecoderLayer(nn.Module):
    """Pre-LN causal self-attention + cross-attention + FFN. Reference
    keys: self_attn, multihead_attn, pos_ffn, norm1..3."""

    def __init__(self, d_model: int, d_ffn: int, nhead: int,
                 activation: Activation = swish, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, dtype)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dtype)
        self.pos_ffn = PositionalwiseFeedForward(d_model, d_ffn, activation, dtype)
        self.norm1 = SBLayerNorm(d_model)
        self.norm2 = SBLayerNorm(d_model)
        self.norm3 = SBLayerNorm(d_model)
        self.dtype = dtype

    def forward(self, tgt: torch.Tensor, cross_kv,
                tgt_mask: Optional[torch.Tensor] = None,
                tgt_key_padding_mask: Optional[torch.Tensor] = None,
                memory_key_padding_mask: Optional[torch.Tensor] = None,
                self_cache=None, pos: int = 0,
                anc: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tgt (B', L, D); cross_kv: this layer's projected memory
        (`multihead_attn.precompute_kv`). With `self_cache` (and anc), tgt
        is one position of each hypothesis (N, 1, D)."""
        dt = self.dtype
        x = layer_norm(tgt, self.norm1.norm, dt)
        if self_cache is None:
            sa = self.self_attn(x, attn_mask=tgt_mask,
                                key_padding_mask=tgt_key_padding_mask)
        else:
            sa = self.self_attn.step_beam(x, self_cache, pos, anc)
        tgt = tgt + sa
        x = layer_norm(tgt, self.norm2.norm, dt)
        tgt = tgt + self.multihead_attn(x, static_kv=cross_kv,
                                        key_padding_mask=memory_key_padding_mask)
        x = layer_norm(tgt, self.norm3.norm, dt)
        return tgt + self.pos_ffn(x)


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, d_ffn: int, nhead: int,
                 activation: Activation = swish, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerDecoderLayer(d_model, d_ffn, nhead, activation, dtype)
            for _ in range(num_layers)
        ])
        self.norm = SBLayerNorm(d_model)
        self.nhead = nhead
        self.dtype = dtype

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_mask: Optional[torch.Tensor] = None,
                tgt_key_padding_mask: Optional[torch.Tensor] = None,
                memory_key_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Teacher-forced: tgt (B, S, D), memory (B, T, D) -> (B, S, D)."""
        out = tgt
        for layer in self.layers:
            out = layer(out, layer.multihead_attn.precompute_kv(memory), tgt_mask,
                        tgt_key_padding_mask, memory_key_padding_mask)
        return layer_norm(out, self.norm.norm, self.dtype)

    # -- decode cache ------------------------------------------------------

    def init_cache(self, n: int, s_max: int, d_model: int,
                   device=None) -> Cache:
        """Zero-filled append-only self K/V (H, s_max, n, dh) per layer."""
        dh = d_model // self.nhead

        def zeros():
            return torch.zeros(self.nhead, s_max, n, dh, dtype=self.dtype,
                               device=device)

        layers: List[Dict[str, Any]] = [
            {"self": (zeros(), zeros()), "cross": None} for _ in self.layers
        ]
        return {"layers": layers, "mem_mask": None}

    def prime_cache(self, memory: torch.Tensor, cache: Cache,
                    memory_key_padding_mask: Optional[torch.Tensor] = None
                    ) -> Cache:
        """Project the memory (B, T, D) into every layer's cross K/V once.
        The cache's n rows may be B * beam: row n reads utterance
        n // beam."""
        for layer, c in zip(self.layers, cache["layers"]):
            c["cross"] = layer.multihead_attn.precompute_kv(memory)
        cache["mem_mask"] = memory_key_padding_mask
        return cache

    def step(self, tgt_t: torch.Tensor, pos: int, cache: Cache,
             anc: torch.Tensor):
        """One decode step: tgt_t (N, D) at position `pos` (a host int) ->
        ((N, D), cache). The self K/V buffers are written in place."""
        x = tgt_t[:, None]
        for layer, c in zip(self.layers, cache["layers"]):
            x = layer(x, c["cross"], memory_key_padding_mask=cache["mem_mask"],
                      self_cache=c["self"], pos=pos, anc=anc)
        return layer_norm(x, self.norm.norm, self.dtype)[:, 0], cache
