"""Conformer encoder and decoder (port of mamba_asr_tpu/models/
conformer.py; reference Conformer.py:1511-1630, 1737-2175, 2178-2479).

ConformerEncoderLayer, the Macaron structure:

    x = x + 0.5 * ffn1(LN(x))
    x = x + MHA(LN1(x))            RelPosMHAXL, regularMHA or hypermixing
    x = x + ConvModule(x)          zero at padded frames
    x = LN2(x + 0.5 * ffn2(LN(x)))

In train() mode each half-FFN branch ends in dropout, as do the FFN's
hidden layer, the attention weights and the conv module; the attention's
output is added without one (JAX `conformer.py:111-141`). A causal layer
masks the future inside RelPosMHAXL (`mask_pos_future`).

ConformerEncoder: the layer stack and a final LN. Its state-dict names
are the reference's (`torch_export.py:_conformer_encoder_layer`):
ffn_module{1,2}.{0: LN, 1: FFN}, mha_layer, convolution_module,
norm1.norm, norm2.norm.

Streaming (JAX `conformer.py:143-193, 266-287`; the reference's
Conformer.py:1632-1717): each layer carries its last
LEFT_CONTEXT_FRAMES pre-MHA activations with a count of the filled
ones, and the conv module's tail. A chunk attends over [left context,
chunk] with the unfilled slots masked and `rel_pos_encoding` over that
window, and keeps the chunk's rows; the conv sees zeros to its right.

ConformerDecoderLayer (JAX `conformer.py:289-385`), the Macaron skeleton
with cross-attention over the encoder memory in the attention slot and a
causal conv module as the only mixer over the targets (no
self-attention):

    tgt = tgt + 0.5 * ffn1(LN(tgt))
    x = tgt + MHA(LN1(tgt), memory)    regularMHA, the memory's padding masked
    x = x + CausalConvModule(x)
    x = LN2(x + 0.5 * ffn2(LN(x)))

Dropout sits where the encoder layer's does. ConformerDecoder is the
stack and a final LN. It has no decode cache (JAX has none either,
`conformer.py:289, :371`): the search re-scores its prefix every step.
`export_asr_params` has no layout for it, so its names are the port's
own, the encoder layer's: ffn_module{1,2}.{0, 1}, mha_layer (a
MultiheadAttention: `att.in_proj_*`, `att.out_proj`),
convolution_module, norm1.norm, norm2.norm; the stack's `norm.norm`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from mamba_asr_torch.models.attention import (
    MultiheadAttention,
    rel_pos_encoding,
    self_attention,
)
from mamba_asr_torch.models.layers import (
    Activation,
    ConvolutionModule,
    PositionalwiseFeedForward,
    SBLayerNorm,
    dropout,
    layer_norm,
    make_layer_norm,
    run_layer,
    stream_stack,
    swish,
)

MACARON_FFN_SCALE = 0.5  # Conformer.py:156-158
LEFT_CONTEXT_FRAMES = 16  # the JAX encoders' left_context_frames default


def init_window_state(batch: int, d_model: int, dtype: torch.dtype, device) -> Dict:
    """A stream's attention window: the left context's activations and the
    count of its filled slots (0 at stream start)."""
    return {"mha_left": torch.zeros(batch, LEFT_CONTEXT_FRAMES, d_model, dtype=dtype,
                                    device=device),
            "mha_left_len": torch.zeros(batch, dtype=torch.int32, device=device)}


def attend_window(mha: nn.Module, xn: torch.Tensor, state: Dict):
    """Self-attention of a chunk's normed rows xn (B, L, D) over [left
    context, chunk], the unfilled left slots masked: (the chunk's rows of
    the output, the window's new left context and count)."""
    lc = LEFT_CONTEXT_FRAMES
    b, chunk, d = xn.shape
    window = torch.cat([state["mha_left"].to(xn.dtype), xn], dim=1)
    slots = torch.arange(lc + chunk, device=xn.device)[None, :]
    pad_mask = slots < (lc - state["mha_left_len"].to(slots.dtype)[:, None])
    pos = rel_pos_encoding(window.shape[1], d, xn.dtype, xn.device)
    out = mha(window, key_padding_mask=pad_mask, pos_embs=pos)[:, lc:]
    return out, {"mha_left": window[:, window.shape[1] - lc:],
                 "mha_left_len": torch.clamp_max(state["mha_left_len"] + chunk, lc)}


class ConformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, nhead: int, kernel_size: int = 31,
                 activation: Activation = swish, bias: bool = True, causal: bool = False,
                 attention_type: str = "RelPosMHAXL", dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.ffn_module1 = nn.ModuleDict({
            "0": make_layer_norm(d_model),
            "1": PositionalwiseFeedForward(d_model, d_ffn, activation, dtype, dropout),
        })
        self.ffn_module2 = nn.ModuleDict({
            "0": make_layer_norm(d_model),
            "1": PositionalwiseFeedForward(d_model, d_ffn, activation, dtype, dropout),
        })
        self.norm1 = SBLayerNorm(d_model)
        self.norm2 = SBLayerNorm(d_model)
        self.mha_layer = self_attention(attention_type, d_model, nhead, d_ffn, dtype,
                                        dropout, mask_pos_future=causal)
        self.convolution_module = ConvolutionModule(
            d_model, kernel_size, bias, activation, causal, dtype, dropout)
        self.dtype = dtype
        self.dropout = dropout

    def _ffn(self, ffn: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
        out = ffn["1"](layer_norm(x, ffn["0"], self.dtype))
        return dropout(out, self.dropout, self.training)

    def forward(self, x: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
                src_key_padding_mask: Optional[torch.Tensor] = None,
                pos_embs: Optional[torch.Tensor] = None,
                chunk_size: Optional[int] = None) -> torch.Tensor:
        kpm = src_key_padding_mask
        x = x + MACARON_FFN_SCALE * self._ffn(self.ffn_module1, x)
        xn = layer_norm(x, self.norm1.norm, self.dtype)
        x = self.mha_layer(xn, attn_mask=src_mask, key_padding_mask=kpm,
                           pos_embs=pos_embs) + x
        x = x + self.convolution_module(x, None if kpm is None else kpm[..., None],
                                        chunk_size)
        x = x + MACARON_FFN_SCALE * self._ffn(self.ffn_module2, x)
        return layer_norm(x, self.norm2.norm, self.dtype)

    def init_stream_state(self, batch: int, device=None) -> Dict:
        d = self.norm1.norm.normalized_shape[0]
        return {**init_window_state(batch, d, self.dtype, device),
                "conv": self.convolution_module.init_stream_state(batch, self.dtype, device)}

    def forward_chunk(self, x: torch.Tensor, state: Dict):
        """One streaming chunk (JAX `conformer.py:155-193`)."""
        x = x + MACARON_FFN_SCALE * self._ffn(self.ffn_module1, x)
        att, window = attend_window(self.mha_layer, layer_norm(x, self.norm1.norm, self.dtype),
                                    state)
        x = att + x
        c, conv_tail = self.convolution_module.forward_chunk(x, state["conv"])
        x = x + c
        x = x + MACARON_FFN_SCALE * self._ffn(self.ffn_module2, x)
        return layer_norm(x, self.norm2.norm, self.dtype), {**window, "conv": conv_tail}


class ConformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, d_ffn: int, nhead: int,
                 kernel_size: int = 31, activation: Activation = swish, bias: bool = True,
                 causal: bool = False, attention_type: str = "RelPosMHAXL",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList([
            ConformerEncoderLayer(d_model, d_ffn, nhead, kernel_size, activation, bias,
                                  causal, attention_type, dtype, dropout)
            for _ in range(num_layers)
        ])
        self.norm = SBLayerNorm(d_model)
        self.dtype = dtype

    def forward(self, src: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
                src_key_padding_mask: Optional[torch.Tensor] = None,
                pos_embs: Optional[torch.Tensor] = None,
                chunk_size: Optional[int] = None) -> torch.Tensor:
        """src_mask: dynamic-chunk training's chunked attention mask, with
        chunk_size its conv chunks (JAX `conformer.py:112-133, 251-262`)."""
        out = src
        for layer in self.layers:
            out = run_layer(layer, self.remat, out, src_mask, src_key_padding_mask,
                            pos_embs, chunk_size)
        return layer_norm(out, self.norm.norm, self.dtype)

    def init_stream_state(self, batch: int, device=None) -> list:
        return [layer.init_stream_state(batch, device) for layer in self.layers]

    def forward_chunk(self, x: torch.Tensor, state: list):
        """x (B, L, d_model), one chunk -> (its output, the new per-layer
        state)."""
        return stream_stack(self, x, state)


class ConformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, nhead: int, kernel_size: int = 31,
                 activation: Activation = swish, bias: bool = True, causal: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        if not causal:
            raise ValueError("a Conformer decoder layer must be causal: its conv "
                             "module is its only mixer over the targets")
        self.ffn_module1 = nn.ModuleDict({
            "0": make_layer_norm(d_model),
            "1": PositionalwiseFeedForward(d_model, d_ffn, activation, dtype, dropout),
        })
        self.ffn_module2 = nn.ModuleDict({
            "0": make_layer_norm(d_model),
            "1": PositionalwiseFeedForward(d_model, d_ffn, activation, dtype, dropout),
        })
        self.norm1 = SBLayerNorm(d_model)
        self.norm2 = SBLayerNorm(d_model)
        self.mha_layer = MultiheadAttention(d_model, nhead, dtype, dropout)
        self.convolution_module = ConvolutionModule(
            d_model, kernel_size, bias, activation, True, dtype, dropout)
        self.dtype = dtype
        self.dropout = dropout

    def _ffn(self, ffn: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
        out = ffn["1"](layer_norm(x, ffn["0"], self.dtype))
        return dropout(out, self.dropout, self.training)

    def forward(self, tgt: torch.Tensor, cross_kv,
                memory_key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tgt (B', S, D); cross_kv: the memory projected by
        `mha_layer.precompute_kv` (B rows; B' may be a multiple of B, the
        beam rows of each utterance)."""
        tgt = tgt + MACARON_FFN_SCALE * self._ffn(self.ffn_module1, tgt)
        x = self.mha_layer(layer_norm(tgt, self.norm1.norm, self.dtype), static_kv=cross_kv,
                           key_padding_mask=memory_key_padding_mask) + tgt
        x = x + self.convolution_module(x)
        x = x + MACARON_FFN_SCALE * self._ffn(self.ffn_module2, x)
        return layer_norm(x, self.norm2.norm, self.dtype)


class ConformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, d_ffn: int, nhead: int,
                 kernel_size: int = 31, activation: Activation = swish, bias: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([
            ConformerDecoderLayer(d_model, d_ffn, nhead, kernel_size, activation, bias,
                                  True, dtype, dropout)
            for _ in range(num_layers)
        ])
        self.norm = SBLayerNorm(d_model)
        self.dtype = dtype

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                memory_key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced: tgt (B', S, D), memory (B, T, D) -> (B', S, D)."""
        out = tgt
        for layer in self.layers:
            out = layer(out, layer.mha_layer.precompute_kv(memory), memory_key_padding_mask)
        return layer_norm(out, self.norm.norm, self.dtype)
