"""HyperMixing token mixing (port of mamba_asr_tpu/models/hypermixing.py,
SpeechBrain's `nnet.hypermixing.HyperMixing`, `attention_type:
hypermixing`).

A hypernetwork generates, per head, the weights W1, W2 (T, k) of a
token-mixing MLP from the position-encoded inputs, and each head's
(d_head, T) feature block is mixed as W2 gelu(W1^T block^T)^T: O(T k d)
instead of attention's O(T^2 d).

- The hypernetwork is two untied `ParallelMLPs` (a ReLU MLP per head over
  the head's feature slice, hidden d_model / heads, output k =
  hypernet_size / heads), fed the inputs plus the module's own absolute
  sine PE; the encoder adds no PE and passes no pos_embs.
- Padded rows (key_padding_mask True) are zeroed in the features and in
  W1 and W2, so padding neither gives nor takes mixing mass.
- Exact (erf) GELU, then a LayerNorm over the mixed features.
- Products are taken from compute-dtype operands and summed in float32
  (JAX's `preferred_element_type=float32`); the output is in the input's
  dtype.

Token mixing is global. JAX takes an `attn_mask` and drops it without a
word, so a causal or chunked model would mix the future; the port
refuses a mask here, and `models/asr.py` refuses a causal model with
hypermixing (ROADMAP Departures).

Parameter names follow the SpeechBrain structure that
tests/test_hypermixing.py replicates (`export_asr_params` has no layout
for this module): `hyper_w1_gen` and `hyper_w2_gen`, each with
`fc1_weights` (H, d_hid, d_in), `fc1_biases`, `fc2_weights` (H, k,
d_hid) and `fc2_biases`, and `layer_norm`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_asr_torch.models.layers import layer_norm, make_layer_norm
from mamba_asr_torch.models.transformer import sinusoidal_position_encoding


def _mm32(eq: str, a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """einsum of a and b rounded to `dtype`, summed in float32."""
    return torch.einsum(eq, a.to(dtype).float(), b.to(dtype).float())


class ParallelMLPs(nn.Module):
    """`num_mlps` independent two-layer ReLU MLPs, one per head, each over
    its head's slice of the features: (B, T, D) -> (B, H, T, out) float32."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 num_mlps: int = 1, keep_output_size: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h = num_mlps
        d_in, d_hid = input_size // h, hidden_size // h
        d_out = output_size if keep_output_size else output_size // h
        self.fc1_weights = nn.Parameter(torch.empty(h, d_hid, d_in))
        self.fc1_biases = nn.Parameter(torch.empty(h, d_hid))
        self.fc2_weights = nn.Parameter(torch.empty(h, d_out, d_hid))
        self.fc2_biases = nn.Parameter(torch.empty(h, d_out))
        self.num_mlps = h
        self.dtype = dtype

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        """JAX's init: weights normal(stddev fan_in^-1/2), zero biases."""
        for w in (self.fc1_weights, self.fc2_weights):
            w.normal_(0.0, w.shape[-1] ** -0.5, generator=generator)
        self.fc1_biases.zero_()
        self.fc2_biases.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h, dt = self.num_mlps, self.dtype
        xs = x.reshape(b, t, h, d // h).transpose(1, 2)  # (B, H, T, d_in)
        y = _mm32("bhti,hji->bhtj", xs, self.fc1_weights, dt) + self.fc1_biases[None, :, None]
        y = F.relu(y)
        return _mm32("bhtj,hoj->bhto", y, self.fc2_weights, dt) + self.fc2_biases[None, :, None]


class HyperMixing(nn.Module):
    """Drop-in for an encoder layer's self-attention: (x, attn_mask,
    key_padding_mask, pos_embs) -> (B, T, D)."""

    def __init__(self, input_output_dim: int, hypernet_size: int, num_heads: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = input_output_dim
        # tied=False, fix_tm_hidden_size=False: the reference's construction.
        self.hyper_w1_gen = ParallelMLPs(d, d, hypernet_size, num_heads, False, dtype)
        self.hyper_w2_gen = ParallelMLPs(d, d, hypernet_size, num_heads, False, dtype)
        self.layer_norm = make_layer_norm(d)
        self.num_heads = num_heads
        self.dtype = dtype

    def forward(self, query: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                pos_embs: Optional[torch.Tensor] = None) -> torch.Tensor:
        if attn_mask is not None:
            raise ValueError(
                "hypermixing mixes every frame: it takes no causal or chunked "
                "attn_mask (the JAX package drops the mask; the port refuses it)")
        b, t, d = query.shape
        h, dt = self.num_heads, self.dtype
        out = query
        keep = None
        if key_padding_mask is not None:
            keep = (~key_padding_mask)[..., None].to(out.dtype)  # (B, T, 1)
            out = out * keep
        hyp_in = out + sinusoidal_position_encoding(t, d, out.dtype, out.device)[None]
        w1, w2 = self.hyper_w1_gen(hyp_in), self.hyper_w2_gen(hyp_in)  # (B, H, T, k)
        if keep is not None:
            w1 = w1 * keep[:, None]
            w2 = w2 * keep[:, None]
        feats = out.reshape(b, t, h, d // h).permute(0, 2, 3, 1)  # (B, H, dh, T)
        mixed = F.gelu(_mm32("bhdt,bhtk->bhdk", feats, w1, dt))
        mixed = _mm32("bhdk,bhtk->bhdt", mixed, w2, dt)
        mixed = mixed.permute(0, 3, 1, 2).reshape(b, t, d)
        return layer_norm(mixed, self.layer_norm, dt).to(query.dtype)
