"""Branchformer encoder (port of mamba_asr_tpu/models/branchformer.py;
Peng et al. 2022, arXiv 2207.02971). Per layer, two branches read the
same input and merge:

    xa = Dropout(MHA(LN_mha(x)))                 global context
    xb = Dropout(cgMLP(LN_mlp(x)))               local context
    x  = x + Dropout(merge_proj([xa, xb]))

cgMLP: channel_proj1 -> exact GELU -> CSGU -> channel_proj2. The CSGU
gates half the channels r with the other half g: g = LN(g), zeroed on
padded rows before the depthwise conv (so frames next to the padding see
the zeros a shorter batch would), conv (SAME, or causal left padding),
the optional linear_after_conv, the gate activation, then dropout(r *
g). At init the conv taps are N(0, 1e-6^2) with bias 1 (and so is
linear_after_conv), so each gate starts near the identity.

A causal layer with regularMHA or hypermixing gets the look-ahead mask
(JAX `branchformer.py:308-315`); hypermixing then refuses it
(models/hypermixing.py).

Streaming (JAX `branchformer.py:175-195, 237-244, 344-394, 473-493`):
the Conformer's attention window (models/conformer.py:attend_window,
no look-ahead mask, as in JAX) and the CSGU's conv tail, which sees
zeros to its right unless causal.

No reference checkpoint can hold this encoder (the reference cannot
build it, and `export_asr_params` refuses it), so its names are the
port's own, after the JAX tree (ROADMAP Departures): norm_mha, norm_mlp,
mha_layer (the Conformer's attention names), cgmlp.channel_proj1,
cgmlp.csgu.{norm, conv, linear_after_conv}, cgmlp.channel_proj2,
merge_proj; the stack's final LN is norm.norm.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_asr_torch.models.attention import self_attention
from mamba_asr_torch.models.conformer import attend_window, init_window_state
from mamba_asr_torch.models.layers import (
    Activation,
    SBLayerNorm,
    conv_pads,
    dense,
    dropout,
    layer_norm,
    make_layer_norm,
    stream_stack,
)
from mamba_asr_torch.models.transformer import get_lookahead_mask

_GATE_ACTIVATIONS = {
    "identity": lambda x: x,
    "gelu": F.gelu,
    "tanh": torch.tanh,
    "silu": F.silu,
    "swish": F.silu,
}


class ConvolutionalSpatialGatingUnit(nn.Module):
    """(B, L, U) -> (B, L, U // 2)."""

    def __init__(self, units: int, kernel_size: int = 31, causal: bool = False,
                 use_linear_after_conv: bool = False, gate_activation: str = "identity",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        half = units // 2
        self.norm = make_layer_norm(half)
        self.conv = nn.Conv1d(half, half, kernel_size, groups=half)
        self.linear_after_conv = nn.Linear(half, half) if use_linear_after_conv else None
        self.gate = _GATE_ACTIVATIONS[gate_activation]
        self.causal = causal
        self.dtype = dtype
        self.dropout = dropout

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        """The near-identity gate: taps N(0, 1e-6^2), bias 1."""
        for lin in (self.conv, self.linear_after_conv):
            if lin is not None:
                lin.weight.normal_(0.0, 1e-6, generator=generator)
                lin.bias.fill_(1.0)

    @property
    def padding_amount(self) -> int:
        return conv_pads(self.conv.kernel_size[0], self.causal)[0]

    def _conv_gate(self, r: torch.Tensor, g: torch.Tensor, pads: tuple) -> torch.Tensor:
        dt = self.dtype
        g = F.pad(g.transpose(1, 2), pads)
        g = F.conv1d(g, self.conv.weight.to(dt), self.conv.bias.to(dt),
                     groups=g.shape[1]).transpose(1, 2)
        if self.linear_after_conv is not None:
            g = dense(g, self.linear_after_conv, dt)
        return dropout(r * self.gate(g), self.dropout, self.training)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        r, g = x.chunk(2, dim=-1)
        g = layer_norm(g, self.norm, self.dtype)
        if pad_mask is not None:
            g = g.masked_fill(pad_mask[..., None], 0.0)
        return self._conv_gate(r, g, conv_pads(self.conv.kernel_size[0], self.causal))

    def init_stream_state(self, batch: int, device=None) -> torch.Tensor:
        """The normed gate half's left tail: (B, pad, U // 2) zeros."""
        return torch.zeros(batch, self.padding_amount, self.conv.in_channels,
                           dtype=self.dtype, device=device)

    def forward_chunk(self, x: torch.Tensor, tail: torch.Tensor):
        """The conv over [tail, chunk], zeros to its right unless causal.
        Returns (out, new tail)."""
        r, g = x.chunk(2, dim=-1)
        g = layer_norm(g, self.norm, self.dtype)
        pad = self.padding_amount
        buf = torch.cat([tail.to(g.dtype), g], dim=1)
        new_tail = buf[:, buf.shape[1] - pad:] if pad else tail
        return self._conv_gate(r, buf, (0, 0 if self.causal else pad)), new_tail


class CgMLP(nn.Module):
    def __init__(self, d_model: int, csgu_linear_units: int = 3072, kernel_size: int = 31,
                 causal: bool = False, use_linear_after_conv: bool = False,
                 gate_activation: str = "identity", activation: Activation = F.gelu,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.channel_proj1 = nn.Linear(d_model, csgu_linear_units)
        self.csgu = ConvolutionalSpatialGatingUnit(
            csgu_linear_units, kernel_size, causal, use_linear_after_conv,
            gate_activation, dtype, dropout)
        self.channel_proj2 = nn.Linear(csgu_linear_units // 2, d_model)
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = self.activation(dense(x, self.channel_proj1, self.dtype))
        return dense(self.csgu(x, pad_mask), self.channel_proj2, self.dtype)

    def forward_chunk(self, x: torch.Tensor, tail: torch.Tensor):
        x = self.activation(dense(x, self.channel_proj1, self.dtype))
        x, tail = self.csgu.forward_chunk(x, tail)
        return dense(x, self.channel_proj2, self.dtype), tail


class BranchformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, kernel_size: int = 31,
                 csgu_linear_units: int = 3072, use_linear_after_conv: bool = False,
                 gate_activation: str = "identity", activation: Activation = F.gelu,
                 causal: bool = False, attention_type: str = "RelPosMHAXL",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.norm_mha = make_layer_norm(d_model)
        self.norm_mlp = make_layer_norm(d_model)
        # hypermixing: csgu_linear_units hidden units (JAX branchformer.py:273-287).
        self.mha_layer = self_attention(attention_type, d_model, nhead, csgu_linear_units,
                                        dtype, dropout, mask_pos_future=causal)
        self.cgmlp = CgMLP(d_model, csgu_linear_units, kernel_size, causal,
                           use_linear_after_conv, gate_activation, activation, dtype,
                           dropout)
        self.merge_proj = nn.Linear(2 * d_model, d_model)
        self.lookahead = causal and attention_type != "RelPosMHAXL"
        self.dtype = dtype
        self.dropout = dropout

    def forward(self, x: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
                src_key_padding_mask: Optional[torch.Tensor] = None,
                pos_embs: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt, p, train = self.dtype, self.dropout, self.training
        if self.lookahead:
            la = get_lookahead_mask(x.shape[1], x.device)
            src_mask = la if src_mask is None else src_mask | la
        xa = self.mha_layer(layer_norm(x, self.norm_mha, dt), attn_mask=src_mask,
                            key_padding_mask=src_key_padding_mask, pos_embs=pos_embs)
        xb = self.cgmlp(layer_norm(x, self.norm_mlp, dt), src_key_padding_mask)
        merged = dense(torch.cat([dropout(xa, p, train), dropout(xb, p, train)], dim=-1),
                       self.merge_proj, dt)
        return x + dropout(merged, p, train)

    def init_stream_state(self, batch: int, device=None) -> Dict:
        d = self.norm_mha.normalized_shape[0]
        return {**init_window_state(batch, d, self.dtype, device),
                "csgu": self.cgmlp.csgu.init_stream_state(batch, device)}

    def forward_chunk(self, x: torch.Tensor, state: Dict):
        """One streaming chunk (JAX `branchformer.py:358-394`)."""
        dt = self.dtype
        xa, window = attend_window(self.mha_layer, layer_norm(x, self.norm_mha, dt), state)
        xb, csgu_tail = self.cgmlp.forward_chunk(layer_norm(x, self.norm_mlp, dt),
                                                 state["csgu"])
        x = x + dense(torch.cat([xa, xb], dim=-1), self.merge_proj, dt)
        return x, {**window, "csgu": csgu_tail}


class BranchformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int, kernel_size: int = 31,
                 csgu_linear_units: int = 3072, use_linear_after_conv: bool = False,
                 gate_activation: str = "identity", activation: Activation = F.gelu,
                 causal: bool = False, attention_type: str = "RelPosMHAXL",
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([
            BranchformerEncoderLayer(d_model, nhead, kernel_size, csgu_linear_units,
                                     use_linear_after_conv, gate_activation, activation,
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

    def init_stream_state(self, batch: int, device=None) -> list:
        return [layer.init_stream_state(batch, device) for layer in self.layers]

    def forward_chunk(self, x: torch.Tensor, state: list):
        """x (B, L, d_model), one chunk -> (its output, the new per-layer
        state)."""
        return stream_stack(self, x, state)
