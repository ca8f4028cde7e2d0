"""Conformer encoder (port of mamba_asr_tpu/models/conformer.py, encoder
side; reference Conformer.py:1511-1630, 1737-2175).

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
norm1.norm, norm2.norm. Streaming (`init_stream_state`, `forward_chunk`)
waits for ROADMAP slice 4 item 2 and raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from mamba_asr_torch.models.attention import self_attention
from mamba_asr_torch.models.layers import (
    Activation,
    ConvolutionModule,
    PositionalwiseFeedForward,
    SBLayerNorm,
    dropout,
    layer_norm,
    make_layer_norm,
    swish,
)

MACARON_FFN_SCALE = 0.5  # Conformer.py:156-158


def refuse_streaming(*_args, **_kwargs):
    raise NotImplementedError(
        "streaming is not ported for this encoder (ROADMAP slice 4 item 2)")


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
                pos_embs: Optional[torch.Tensor] = None) -> torch.Tensor:
        kpm = src_key_padding_mask
        x = x + MACARON_FFN_SCALE * self._ffn(self.ffn_module1, x)
        xn = layer_norm(x, self.norm1.norm, self.dtype)
        x = self.mha_layer(xn, attn_mask=src_mask, key_padding_mask=kpm,
                           pos_embs=pos_embs) + x
        x = x + self.convolution_module(x, None if kpm is None else kpm[..., None])
        x = x + MACARON_FFN_SCALE * self._ffn(self.ffn_module2, x)
        return layer_norm(x, self.norm2.norm, self.dtype)


class ConformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, d_ffn: int, nhead: int,
                 kernel_size: int = 31, activation: Activation = swish, bias: bool = True,
                 causal: bool = False, attention_type: str = "RelPosMHAXL",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([
            ConformerEncoderLayer(d_model, d_ffn, nhead, kernel_size, activation, bias,
                                  causal, attention_type, dtype, dropout)
            for _ in range(num_layers)
        ])
        self.norm = SBLayerNorm(d_model)
        self.dtype = dtype

    def forward(self, src: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
                src_key_padding_mask: Optional[torch.Tensor] = None,
                pos_embs: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = src
        for layer in self.layers:
            out = layer(out, src_mask, src_key_padding_mask, pos_embs)
        return layer_norm(out, self.norm.norm, self.dtype)

    init_stream_state = forward_chunk = refuse_streaming
