"""Transformer pieces of the S2S path and the LM (port of
mamba_asr_tpu/models/transformer.py): the sinusoidal position table, the
normalized token embedding, the mask helpers, the pre-LN Transformer
decoder with its decode cache, and the encoder stack the TransformerLM
(models/lm.py) is built from.

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

In train() mode the decoder drops, with probability `dropout`, at the
JAX package's four places: each sublayer's output before its residual
add (self-attention, cross-attention, FFN; `transformer.py:322, 332,
341`), the attention weights of both attentions, and the FFN's hidden
activations (`layers.py:46`). eval() has none; the search steps the
decoder in eval() mode.

TransformerEncoder (reference Transformer.py:1197-1344; JAX
`transformer.py:111-267`), the LM's stack and an ASR encoder: per layer

    pre-LN  (normalize_before):  x = x + att(LN1(x));  x = x + ffn(LN2(x))
    post-LN:                     x = LN1(x + att(x));  x = LN2(x + ffn(x))

then the stack's final LN in both modes (`transformer.py:266`). The
attention is regularMHA, RelPosMHAXL (taking the caller's `pos_embs`) or
hypermixing (`attention.py:self_attention`); the FFN is the positionwise
one or the 1-D CNN (`ffn_type: 1dcnn`, left-padded when `causal`).
Dropout sits at the decoder's places (each sublayer's output, the
attention weights, the FFN's hidden activations). In train() mode
`layerdrop` skips each layer with that probability, one Bernoulli per
layer from the `generator` the caller passes (JAX draws them from its
dropout key, `transformer.py:229-233`). `forward` is the full pass (the
caller's look-ahead and key padding masks); `init_cache` / `step` are
the decoder's append-only K/V and ancestor table, without cross
attention (regularMHA only, as in JAX).

The JAX package's heads-major reorder cache (`beam_gather=False`) and
the full-prefix re-score of a cached decoder (`use_cache=False`) are A/B
switches of the TPU search and are not ported (the Conformer decoder,
which has no cache, re-scores its prefix: decoding/s2s_beam.py).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from mamba_asr_torch.models.attention import KV, MultiheadAttention, self_attention
from mamba_asr_torch.models.layers import (
    Activation,
    CNNFeedForward,
    PositionalwiseFeedForward,
    SBLayerNorm,
    dropout,
    layer_norm,
    swish,
)

Cache = Dict[str, Any]


def sinusoidal_position_encoding(length: int, d_model: int,
                                 dtype: torch.dtype = torch.float32,
                                 device=None) -> torch.Tensor:
    """Absolute sinusoidal position table (length, d_model)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros(length, d_model, device=device)
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


def make_chunked_src_mask(length: int, chunk_size: int,
                          left_context_chunks: Optional[int] = None,
                          device=None) -> torch.Tensor:
    """Dynamic Chunk Training's attention mask (JAX `transformer.py:90-103`,
    after SpeechBrain's TransformerASR.py:305-364): (L, L) bool, True =
    disallowed. Frame i sees its own chunk and up to left_context_chunks
    chunks back (every earlier chunk when None)."""
    chunk_id = torch.arange(length, device=device) // chunk_size
    mask = chunk_id[None, :] > chunk_id[:, None]
    if left_context_chunks is not None:
        mask = mask | (chunk_id[None, :] < chunk_id[:, None] - left_context_chunks)
    return mask


def zero_kv(nhead: int, s_max: int, n: int, d_model: int, dtype: torch.dtype,
            device=None) -> KV:
    """One layer's append-only self K/V of n hypotheses: zero-filled
    (H, s_max, n, dh) buffers."""
    shape = (nhead, s_max, n, d_model // nhead)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


class TransformerDecoderLayer(nn.Module):
    """Pre-LN causal self-attention + cross-attention + FFN. Reference
    keys: self_attn, multihead_attn, pos_ffn, norm1..3."""

    def __init__(self, d_model: int, d_ffn: int, nhead: int,
                 activation: Activation = swish, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, dtype, dropout)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dtype, dropout)
        self.pos_ffn = PositionalwiseFeedForward(d_model, d_ffn, activation, dtype, dropout)
        self.norm1 = SBLayerNorm(d_model)
        self.norm2 = SBLayerNorm(d_model)
        self.norm3 = SBLayerNorm(d_model)
        self.dtype = dtype
        self.dropout = dropout

    def forward(self, tgt: torch.Tensor, cross_kv,
                tgt_mask: Optional[torch.Tensor] = None,
                tgt_key_padding_mask: Optional[torch.Tensor] = None,
                memory_key_padding_mask: Optional[torch.Tensor] = None,
                self_cache=None, pos: int = 0,
                anc: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tgt (B', L, D); cross_kv: this layer's projected memory
        (`multihead_attn.precompute_kv`). With `self_cache` (and anc), tgt
        is one position of each hypothesis (N, 1, D)."""
        dt, p, train = self.dtype, self.dropout, self.training
        x = layer_norm(tgt, self.norm1.norm, dt)
        if self_cache is None:
            sa = self.self_attn(x, attn_mask=tgt_mask,
                                key_padding_mask=tgt_key_padding_mask)
        else:
            sa = self.self_attn.step_beam(x, self_cache, pos, anc)
        tgt = tgt + dropout(sa, p, train)
        x = layer_norm(tgt, self.norm2.norm, dt)
        ca = self.multihead_attn(x, static_kv=cross_kv,
                                 key_padding_mask=memory_key_padding_mask)
        tgt = tgt + dropout(ca, p, train)
        x = layer_norm(tgt, self.norm3.norm, dt)
        return tgt + dropout(self.pos_ffn(x), p, train)


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, d_ffn: int, nhead: int,
                 activation: Activation = swish, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerDecoderLayer(d_model, d_ffn, nhead, activation, dtype, dropout)
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
        layers: List[Dict[str, Any]] = [
            {"self": zero_kv(self.nhead, s_max, n, d_model, self.dtype, device),
             "cross": None} for _ in self.layers
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


class TransformerEncoderLayer(nn.Module):
    """Self-attention + FFN, pre- or post-LN. Reference keys: self_att,
    pos_ffn, norm1, norm2."""

    def __init__(self, d_model: int, d_ffn: int, nhead: int,
                 activation: Activation = torch.relu, normalize_before: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 attention_type: str = "regularMHA", ffn_type: str = "regularFFN",
                 ffn_cnn_kernel_sizes=(3, 3), causal: bool = False):
        super().__init__()
        # hypermixing: d_ffn hidden units (the reference's construction).
        self.self_att = self_attention(attention_type, d_model, nhead, d_ffn, dtype, dropout)
        if ffn_type == "1dcnn":
            self.pos_ffn = CNNFeedForward(d_model, d_ffn, ffn_cnn_kernel_sizes, causal, dtype)
        elif ffn_type == "regularFFN":
            self.pos_ffn = PositionalwiseFeedForward(d_model, d_ffn, activation, dtype,
                                                     dropout)
        else:
            raise ValueError(f"unknown ffn_type {ffn_type!r}")
        self.norm1 = SBLayerNorm(d_model)
        self.norm2 = SBLayerNorm(d_model)
        self.normalize_before = normalize_before
        self.dtype = dtype
        self.dropout = dropout

    def forward(self, src: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
                src_key_padding_mask: Optional[torch.Tensor] = None,
                cache=None, pos: int = 0, anc: Optional[torch.Tensor] = None,
                pos_embs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """src (B, L, D); with `cache` (and anc) one position of each
        hypothesis (N, 1, D) through `MultiheadAttention.step_beam`."""
        dt, p, train, pre = self.dtype, self.dropout, self.training, self.normalize_before
        x = layer_norm(src, self.norm1.norm, dt) if pre else src
        if cache is None:
            att = self.self_att(x, attn_mask=src_mask, key_padding_mask=src_key_padding_mask,
                                pos_embs=pos_embs)
        else:
            att = self.self_att.step_beam(x, cache, pos, anc)
        src = src + dropout(att, p, train)
        if not pre:
            src = layer_norm(src, self.norm1.norm, dt)
        x = layer_norm(src, self.norm2.norm, dt) if pre else src
        src = src + dropout(self.pos_ffn(x), p, train)
        return src if pre else layer_norm(src, self.norm2.norm, dt)


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, d_ffn: int, nhead: int,
                 activation: Activation = torch.relu, normalize_before: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 layerdrop: float = 0.0, attention_type: str = "regularMHA",
                 ffn_type: str = "regularFFN", ffn_cnn_kernel_sizes=(3, 3),
                 causal: bool = False):
        super().__init__()
        if attention_type == "hypermixing" and causal:
            raise ValueError("hypermixing mixes every frame: a causal encoder cannot "
                             "take it (the JAX package mixes the future without a word)")
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(d_model, d_ffn, nhead, activation, normalize_before,
                                    dtype, dropout, attention_type, ffn_type,
                                    ffn_cnn_kernel_sizes, causal)
            for _ in range(num_layers)
        ])
        self.norm = SBLayerNorm(d_model)
        self.nhead = nhead
        self.dtype = dtype
        self.layerdrop = layerdrop

    def forward(self, src: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
                src_key_padding_mask: Optional[torch.Tensor] = None,
                pos_embs: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Full pass: src (B, L, D) -> (B, L, D). In train() mode with
        layerdrop, a layer drawn to drop leaves its input unchanged."""
        dropped = [False] * len(self.layers)
        if self.training and self.layerdrop > 0.0:
            dev = src.device if generator is None else generator.device
            draws = torch.rand(len(self.layers), generator=generator, device=dev)
            dropped = (draws < self.layerdrop).tolist()
        out = src
        for layer, drop in zip(self.layers, dropped):
            if not drop:
                out = layer(out, src_mask, src_key_padding_mask, pos_embs=pos_embs)
        return layer_norm(out, self.norm.norm, self.dtype)

    def init_cache(self, n: int, s_max: int, d_model: int, device=None) -> List[KV]:
        """Zero-filled append-only self K/V (H, s_max, n, dh) per layer."""
        return [zero_kv(self.nhead, s_max, n, d_model, self.dtype, device)
                for _ in self.layers]

    def step(self, x: torch.Tensor, pos: int, cache: List[KV],
             anc: torch.Tensor) -> torch.Tensor:
        """One position of N hypotheses: x (N, D) at `pos` -> (N, D). The
        K/V buffers are written in place."""
        out = x[:, None]
        for layer, kv in zip(self.layers, cache):
            out = layer(out, cache=kv, pos=pos, anc=anc)
        return layer_norm(out, self.norm.norm, self.dtype)[:, 0]
