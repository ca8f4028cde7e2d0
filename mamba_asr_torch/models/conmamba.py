"""ConMamba encoder (port of mamba_asr_tpu/models/conmamba.py, encoder side).

ConmambaEncoderLayer (reference Conmamba.py:623-650):
    x = x + 0.5 * ffn1(LN(x))
    x = x + mamba(LN(x))          # BiMamba when not causal and bidirectional
    x = x + ConvModule(x)
    x = LN(x + 0.5 * ffn2(LN(x)))
In train() mode each half-FFN branch ends in dropout, as do the FFN's
hidden layer and the conv module (models/layers.py); the Mamba block has
none (reference Conmamba.py:670). The padding mask is dropped, as the reference zeroes the conv mask.
ConmambaEncoder: the layer stack (a ModuleList; the JAX package's
`scan_layers` is a compile-time layout that the port does not need) and
a final LN. The Mamba decoder waits for the S2S slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn

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
from mamba_asr_torch.models.mamba import BiMambaBlock, MambaBlock, MambaConfig

FFN_RESIDUAL_SCALE = 0.5  # Conmamba.py ConMambaConstants.FFN_RESIDUAL_SCALE


class ConmambaEncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, kernel_size: int = 31,
                 activation: Activation = swish, bias: bool = True,
                 causal: bool = False, mamba_cfg: MambaConfig = MambaConfig(),
                 bidirectional: bool = True, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        # Reference keys: ffn_module{1,2}.0 (LN) and .1 (the FFN).
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
        block = MambaBlock if causal or not bidirectional else BiMambaBlock
        self.mamba = block(d_model, mamba_cfg, dtype)
        self.convolution_module = ConvolutionModule(
            d_model, kernel_size, bias, activation, causal, dtype, dropout
        )
        self.dtype = dtype
        self.dropout = dropout

    def _ffn(self, ffn: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
        out = ffn["1"](layer_norm(x, ffn["0"], self.dtype))
        return dropout(out, self.dropout, self.training)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x + FFN_RESIDUAL_SCALE * self._ffn(self.ffn_module1, x)
        x = self.mamba(layer_norm(x, self.norm1.norm, dt)) + x
        x = x + self.convolution_module(x)
        x = x + FFN_RESIDUAL_SCALE * self._ffn(self.ffn_module2, x)
        return layer_norm(x, self.norm2.norm, dt)


class ConmambaEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, d_ffn: int,
                 kernel_size: int = 31, activation: Activation = swish,
                 bias: bool = True, causal: bool = False,
                 mamba_cfg: MambaConfig = MambaConfig(),
                 bidirectional: bool = True, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([
            ConmambaEncoderLayer(d_model, d_ffn, kernel_size, activation, bias,
                                 causal, mamba_cfg, bidirectional, dtype, dropout)
            for _ in range(num_layers)
        ])
        self.norm = SBLayerNorm(d_model)
        self.dtype = dtype

    def forward(self, src: torch.Tensor) -> torch.Tensor:
        out = src
        for layer in self.layers:
            out = layer(out)
        return layer_norm(out, self.norm.norm, self.dtype)
