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
a final LN. Streaming: `init_stream_state` and `forward_chunk` carry
each layer's Mamba state and conv tail across chunks.

MambaDecoderLayer (reference Conmamba.py:854-934, always pre-LN and
unidirectional), with dropout on the three residual branches in train()
mode (and the FFN's hidden units):
    x = x + self_mamba(LN1(x))
    x = x + cross_mamba([memory; LN2(x)])[:, -S:]     # keep the tgt tail
    x = x + ffn(LN3(x))
MambaDecoder: the stack and a final LN. Neither masks anything: padded
memory frames and padded targets are scanned, as in the JAX package, so
a padded row's result depends on its batch. The decode cache:
`init_cache`, `prime_cache` (every layer's cross-Mamba scans the same
memory once), `extend_cache` (a further chunk of memory, for streaming),
`step` (one token of every hypothesis) and `reorder_cache` (the search's
gather).
"""

from __future__ import annotations

from typing import Dict, List

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
    stream_stack,
    swish,
)
from mamba_asr_torch.models.mamba import BiMambaBlock, Cache, MambaBlock, MambaConfig

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

    def init_stream_state(self, batch: int, device=None) -> Dict[str, object]:
        return {"mamba": self.mamba.init_stream_state(batch, self.dtype, device),
                "conv": self.convolution_module.init_stream_state(batch, self.dtype, device)}

    def forward_chunk(self, x: torch.Tensor, state: Dict[str, object]):
        """One streaming chunk (JAX `conmamba.py:132-140`)."""
        dt = self.dtype
        x = x + FFN_RESIDUAL_SCALE * self._ffn(self.ffn_module1, x)
        y, mamba_state = self.mamba.forward_chunk(layer_norm(x, self.norm1.norm, dt),
                                                  state["mamba"])
        x = y + x
        c, conv_tail = self.convolution_module.forward_chunk(x, state["conv"])
        x = x + c
        x = x + FFN_RESIDUAL_SCALE * self._ffn(self.ffn_module2, x)
        return layer_norm(x, self.norm2.norm, dt), {"mamba": mamba_state, "conv": conv_tail}


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

    def init_stream_state(self, batch: int, device=None) -> list:
        return [layer.init_stream_state(batch, device) for layer in self.layers]

    def forward_chunk(self, x: torch.Tensor, state: list):
        """x (B, L, d_model), one chunk -> (its output, the new per-layer
        state)."""
        return stream_stack(self, x, state)


LayerCache = Dict[str, Cache]  # {"self": (conv, ssm), "cross": (conv, ssm)}


class MambaDecoderLayer(nn.Module):
    """Reference keys: self_mamba, cross_mamba, pos_ffn, norm1..3."""

    def __init__(self, d_model: int, d_ffn: int, activation: Activation = swish,
                 mamba_cfg: MambaConfig = MambaConfig(),
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.self_mamba = MambaBlock(d_model, mamba_cfg, dtype)
        self.cross_mamba = MambaBlock(d_model, mamba_cfg, dtype)
        self.pos_ffn = PositionalwiseFeedForward(d_model, d_ffn, activation, dtype, dropout)
        self.norm1 = SBLayerNorm(d_model)
        self.norm2 = SBLayerNorm(d_model)
        self.norm3 = SBLayerNorm(d_model)
        self.dtype = dtype
        self.dropout = dropout

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        """Teacher-forced: tgt (B, S, D), memory (B, T, D) -> (B, S, D)."""
        dt, p, train = self.dtype, self.dropout, self.training
        tgt = tgt + dropout(self.self_mamba(layer_norm(tgt, self.norm1.norm, dt)), p, train)
        x = layer_norm(tgt, self.norm2.norm, dt)
        cross = self.cross_mamba(torch.cat([memory, x], dim=1))[:, -x.shape[1]:]
        tgt = tgt + dropout(cross, p, train)
        x = layer_norm(tgt, self.norm3.norm, dt)
        return tgt + dropout(self.pos_ffn(x), p, train)

    def step(self, tgt_t: torch.Tensor, cache: LayerCache):
        """One token: tgt_t (N, D) -> ((N, D), new cache)."""
        dt = self.dtype
        y, self_cache = self.self_mamba.step(layer_norm(tgt_t, self.norm1.norm, dt),
                                             cache["self"])
        tgt_t = tgt_t + y
        y, cross_cache = self.cross_mamba.step(layer_norm(tgt_t, self.norm2.norm, dt),
                                               cache["cross"])
        tgt_t = tgt_t + y
        tgt_t = tgt_t + self.pos_ffn(layer_norm(tgt_t, self.norm3.norm, dt))
        return tgt_t, {"self": self_cache, "cross": cross_cache}


class MambaDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, d_ffn: int,
                 activation: Activation = swish, mamba_cfg: MambaConfig = MambaConfig(),
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([
            MambaDecoderLayer(d_model, d_ffn, activation, mamba_cfg, dtype, dropout)
            for _ in range(num_layers)
        ])
        self.norm = SBLayerNorm(d_model)
        self.dtype = dtype

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        out = tgt
        for layer in self.layers:
            out = layer(out, memory)
        return layer_norm(out, self.norm.norm, self.dtype)

    def init_cache(self, n: int, device=None) -> List[LayerCache]:
        """Zero self and cross caches for n hypotheses, per layer."""
        return [{"self": layer.self_mamba.init_cache(n, self.dtype, device),
                 "cross": layer.cross_mamba.init_cache(n, self.dtype, device)}
                for layer in self.layers]

    def prime_cache(self, memory: torch.Tensor, cache: List[LayerCache]) -> List[LayerCache]:
        """Every layer's cross-Mamba scans memory (N, T, D), one row per
        hypothesis: its input is the memory itself, not the layer below."""
        return [{"self": c["self"], "cross": layer.cross_mamba.prime(memory)}
                for layer, c in zip(self.layers, cache)]

    def extend_cache(self, memory: torch.Tensor, cache: List[LayerCache]) -> List[LayerCache]:
        """Every layer's cross-Mamba state advanced over a further chunk of
        memory (long-form streaming: each new chunk extends, nothing is
        scanned again)."""
        return [{"self": c["self"], "cross": layer.cross_mamba.extend_prime(memory, c["cross"])}
                for layer, c in zip(self.layers, cache)]

    @staticmethod
    def reorder_cache(cache: List[LayerCache], reorder: torch.Tensor) -> List[LayerCache]:
        """Every state gathered by hypothesis: row i of the result is row
        reorder[i] (the search's step, JAX `s2s_beam.py:411-417`)."""
        return [{part: tuple(x.index_select(0, reorder) for x in states)
                 for part, states in layer.items()} for layer in cache]

    def step(self, tgt_t: torch.Tensor, cache: List[LayerCache]):
        """One token of N hypotheses: tgt_t (N, D) -> ((N, D), new cache)."""
        new = []
        x = tgt_t
        for layer, c in zip(self.layers, cache):
            x, c = layer.step(x, c)
            new.append(c)
        return layer_norm(x, self.norm.norm, self.dtype), new
