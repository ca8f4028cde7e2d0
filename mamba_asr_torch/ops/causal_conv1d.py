"""Depthwise causal 1-D convolution + optional SiLU, time-major
(port of mamba_asr_tpu/ops/causal_conv1d.py).

The reference is the `causal_conv1d` CUDA package: a depthwise conv with
left padding K-1 (output length == input length) followed by SiLU. Here
it is K shifted multiply-adds in float32 (the JAX package's form for the
model's K=4), so neither a CPU nor a TF32 convolution changes the sums.
`causal_conv1d_step` is the one-token form the decoder's cache steps.
No kernel is owed: the JAX package leaves both to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def causal_conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = "silu",
) -> torch.Tensor:
    """x (B, L, D), weight (K, D) depthwise taps (tap k multiplies
    x[t - (K-1) + k]), bias (D,). Computes in float32, returns x's dtype."""
    k = weight.shape[0]
    length = x.shape[1]
    xf = x.float()
    w = weight.float()
    out = xf * w[k - 1]
    for i in range(k - 1):
        shift = k - 1 - i
        xi = F.pad(xf, (0, 0, shift, 0))[:, :length]
        out = out + xi * w[i]
    if bias is not None:
        out = out + bias.float()
    if activation == "silu":
        out = F.silu(out)
    return out.to(x.dtype)


def causal_conv1d_step(
    conv_state: torch.Tensor,
    x_t: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of the conv for decoding (JAX `causal_conv1d_step`).

    conv_state (B, K, D) holds the last K inputs in its own dtype, the
    newest last; x_t (B, D). Rolls x_t in, dots the window with the (K, D)
    taps in float32, adds the bias, applies SiLU. Returns (y_t in x_t's
    dtype, the new state)."""
    new_state = torch.cat([conv_state[:, 1:], x_t[:, None].to(conv_state.dtype)], dim=1)
    y = torch.einsum("bkd,kd->bd", new_state.float(), weight.float())
    if bias is not None:
        y = y + bias.float()
    if activation == "silu":
        y = F.silu(y)
    return y.to(x_t.dtype), new_state
