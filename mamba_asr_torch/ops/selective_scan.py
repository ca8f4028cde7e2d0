"""Selective-scan (Mamba S6) recurrence (port of
mamba_asr_tpu/ops/selective_scan.py).

    delta = softplus(delta + delta_bias)            (optional)
    h_t   = exp(delta_t * A) * h_{t-1} + delta_t * B_t * u_t
    y_t   = <h_t, C_t> + D * u_t
    out_t = y_t * silu(z_t)                         (optional gate)

Layout is time-major (B, L, D), as in the JAX package. The scan math is
float32 for any input dtype; the output takes u's dtype.

`selective_scan` dispatches by device: a CPU tensor takes the plain
version `selective_scan_ref`; a CUDA tensor launches the Hopper kernel
(`kernels/selective_scan.py`) or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def selective_scan_ref(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
    h0: Optional[torch.Tensor] = None,
    return_last_state: bool = False,
) -> Out:
    """Sequential float32 loop over time.

    u, delta, z (B, L, D); A (D, N); B, C (B, L, N); D, delta_bias (D,);
    h0 (B, D, N). Returns out (B, L, D) in u's dtype, and the final state
    (B, D, N) float32 when `return_last_state`.
    """
    uf = u.float()
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()
    if delta_softplus:
        dt = torch.logaddexp(dt, torch.zeros_like(dt))  # jax.nn.softplus
    Af = A.float()
    Bf = B.float()
    Cf = C.float()
    bsz, length, d_in = u.shape
    h = (
        torch.zeros(bsz, d_in, A.shape[1], dtype=torch.float32, device=u.device)
        if h0 is None else h0.float()
    )
    ys = []
    for t in range(length):
        da = torch.exp(dt[:, t, :, None] * Af)  # (B, D, N)
        dbu = (dt[:, t] * uf[:, t])[:, :, None] * Bf[:, t, None, :]
        h = da * h + dbu
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + uf * D.float()
    if z is not None:
        y = y * F.silu(z.float())
    out = y.to(u.dtype)
    if return_last_state:
        return out, h
    return out


def selective_scan(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
    h0: Optional[torch.Tensor] = None,
    return_last_state: bool = False,
) -> Out:
    """CPU tensors -> `selective_scan_ref`; CUDA tensors -> the Hopper
    kernel, which raises on what it does not take."""
    args = (u, delta, A, B, C, D, z, delta_bias, delta_softplus, h0,
            return_last_state)
    if u.device.type == "cpu":
        return selective_scan_ref(*args)
    if u.device.type == "cuda":
        from mamba_asr_torch.kernels.selective_scan import selective_scan_fwd

        return selective_scan_fwd(*args)
    raise ValueError(f"no selective scan for device {u.device}")
