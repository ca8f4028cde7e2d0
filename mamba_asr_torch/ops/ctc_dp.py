"""The CTC prefix scorer's frame recurrences (port of the DP in
mamba_asr_tpu/decoding/ctc_prefix_scorer.py:select and of
mamba_asr_tpu/ops/pallas/log_scan.py).

`CTCPrefixScorer.select` advances the r_nb / r_b rows of every surviving
hypothesis with two first-order linear recurrences in the log semiring
(logaddexp, +), over frames t of (T, N) float32 planes:

    r_nb(t) = logaddexp(r_nb(t-1) + a_nb(t), grow(t))
    r_b(t)  = logaddexp(r_b(t-1) + lpb(t), valid(t) ? r_nb(t-1) + lpb(t) : NEG)

with r(-1) = -inf, so r_nb(0) = grow(0). Invalid frames carry a_nb = 0,
grow = NEG, lpb = 0, valid = 0, as the scorer builds them. NEG = -1e30 is
the scorer's finite stand-in for -inf.

- `linear_log_scan` / `ctc_dp_ref`: the plain version. The JAX package's
  CPU branch solves each recurrence with `lax.associative_scan`
  (`_linear_log_scan`); this is the same recurrence as a sequential loop
  over T. K3 composes chunks of frames (a two-level scan, as the TPU
  kernel), so the two agree to rounding in another order.
- `ctc_dp`: the dispatch. CUDA tensors go to K3 (`kernels/ctc_dp.py`,
  which replaces `_ctc_dp_kernel`), CPU tensors to the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG = -1e30


def linear_log_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve x(t) = logaddexp(x(t-1) + a(t), b(t)) with x(-1) = -inf along
    axis 0 of (T, N) planes."""
    out = torch.empty_like(b)
    x = b[0]
    out[0] = x
    for t in range(1, b.shape[0]):
        x = torch.logaddexp(x + a[t], b[t])
        out[t] = x
    return out


def ctc_dp_ref(a_nb: torch.Tensor, grow: torch.Tensor, lpb: torch.Tensor,
               valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, N) float32 planes -> (r_nb, r_b), each (T, N) float32."""
    r_nb = linear_log_scan(a_nb, grow)
    r_nb_shift = torch.cat([torch.full_like(r_nb[:1], NEG), r_nb[:-1]])
    b_b = torch.where(valid > 0, r_nb_shift + lpb, NEG)
    return r_nb, linear_log_scan(lpb, b_b)


def ctc_dp(a_nb: torch.Tensor, grow: torch.Tensor, lpb: torch.Tensor,
           valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version on CPU tensors, K3 on CUDA ones."""
    if a_nb.device.type == "cpu":
        return ctc_dp_ref(a_nb, grow, lpb, valid)
    if a_nb.device.type == "cuda":
        from mamba_asr_torch.kernels.ctc_dp import ctc_dp_fwd

        return ctc_dp_fwd(a_nb, grow, lpb, valid)
    raise ValueError(f"no CTC prefix DP for device {a_nb.device}")
