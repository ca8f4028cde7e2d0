"""Depthwise causal 1-D convolution + optional SiLU, time-major
(port of mamba_asr_tpu/ops/causal_conv1d.py).

The reference is the `causal_conv1d` CUDA package: a depthwise conv with
left padding K-1 (output length == input length) followed by SiLU. Here
it is K shifted multiply-adds in float32 (the JAX package's form for the
model's K=4), so neither a CPU nor a TF32 convolution changes the sums.
No kernel is owed: the JAX package leaves this op to XLA.
"""

from __future__ import annotations

from typing import Optional

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
