"""Mamba and bidirectional Mamba (BiMamba v2) blocks, batch path (port of
mamba_asr_tpu/models/mamba.py).

- `MambaBlock`: in_proj (d_model -> 2*d_inner), depthwise causal conv +
  SiLU, x_proj (d_inner -> dt_rank + 2*d_state), dt_proj (its bias enters
  the scan as delta_bias under softplus), A = -exp(A_log), D skip,
  out_proj.
- `BiMambaBlock`: shared in_proj/out_proj, a second set of scan
  parameters (reference suffix `_b`), and
  out = out_proj(0.5 * fwd + 0.5 * flip(bwd(flip(x)))). The flip is over
  the whole padded length, as in the JAX package.

Parameter names are the reference's (`conv1d`, `x_proj`, `dt_proj`,
`A_log`, `D`, and `conv1d_b`, `x_proj_b`, `dt_proj_b`, `A_b_log`, `D_b`).
The O(1) `step`, `forward_chunk` and `prime` paths wait for the
streaming and decoder slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn

from mamba_asr_torch.models.layers import dense
from mamba_asr_torch.ops.causal_conv1d import causal_conv1d
from mamba_asr_torch.ops.selective_scan import selective_scan


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """Hyperparameters of a Mamba mixer (reference bimamba.py:40-61).

    The JAX package's `scan_impl` and `seq_axis` are absent: the port
    picks the scan by device, and sequence parallelism is a later slice.
    """

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # None -> ceil(d_model / 16)
    dt_min: float = 0.001
    dt_max: float = 0.1
    dt_init: str = "random"
    dt_scale: float = 1.0
    dt_init_floor: float = 1e-4
    conv_bias: bool = True
    bias: bool = False

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or math.ceil(d_model / 16)


# -- init rules (mamba_asr_tpu/models/mamba.py:70-110) ----------------------


def init_dt_proj_weight_(w: torch.Tensor, dt_rank: int, cfg: MambaConfig,
                         generator: torch.Generator) -> None:
    std = dt_rank**-0.5 * cfg.dt_scale
    if cfg.dt_init == "constant":
        w.fill_(std)
    elif cfg.dt_init == "random":
        w.uniform_(-std, std, generator=generator)
    else:
        raise NotImplementedError(cfg.dt_init)


def init_dt_bias_(b: torch.Tensor, cfg: MambaConfig,
                  generator: torch.Generator) -> None:
    """softplus(bias) ~ LogUniform(dt_min, dt_max)  (bimamba.py:110-118)."""
    u = torch.rand(b.shape, generator=generator)
    dt = torch.exp(
        u * (math.log(cfg.dt_max) - math.log(cfg.dt_min)) + math.log(cfg.dt_min)
    )
    dt = torch.clamp_min(dt, cfg.dt_init_floor)
    b.copy_(dt + torch.log(-torch.expm1(-dt)))  # inverse of softplus


def init_a_log_(a: torch.Tensor) -> None:
    """S4D-real: A[d, n] = n + 1, stored as log  (bimamba.py:122-129)."""
    n = a.shape[1]
    a.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32)).expand_as(a))


# -- blocks -------------------------------------------------------------------


@dataclasses.dataclass
class _ScanHead:
    """One direction's scan parameters: conv + x_proj + dt_proj + A, D.

    A view over tensors the block owns under the reference names, so
    BiMambaBlock runs two of them around shared in/out projections."""

    conv1d: nn.Conv1d
    x_proj: nn.Linear
    dt_proj: nn.Linear
    A_log: torch.Tensor
    D: torch.Tensor
    d_state: int
    dtype: torch.dtype

    def __call__(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        # Taps (D, 1, K) -> the op's (K, D).
        x = causal_conv1d(x, self.conv1d.weight[:, 0, :].t(), self.conv1d.bias)
        dt_rank = self.dt_proj.weight.shape[1]
        x_dbl = dense(x, self.x_proj, self.dtype)
        dt, b_mat, c_mat = torch.split(
            x_dbl, [dt_rank, self.d_state, self.d_state], dim=-1
        )
        delta = dt @ self.dt_proj.weight.t().to(dt.dtype)
        # softplus(delta + dt_bias) runs inside the scan op, on the
        # compute-dtype delta (mamba_asr_tpu/models/mamba.py:191-196).
        return selective_scan(
            x, delta, -torch.exp(self.A_log.float()), b_mat.contiguous(),
            c_mat.contiguous(), D=self.D, z=z.contiguous(),
            delta_bias=self.dt_proj.bias, delta_softplus=True,
        )


def _add_scan_params(block: nn.Module, d_inner: int, dt_rank: int,
                     cfg: MambaConfig, suffix: str) -> None:
    setattr(block, f"conv1d{suffix}", nn.Conv1d(
        d_inner, d_inner, cfg.d_conv, groups=d_inner, bias=cfg.conv_bias))
    setattr(block, f"x_proj{suffix}",
            nn.Linear(d_inner, dt_rank + 2 * cfg.d_state, bias=False))
    setattr(block, f"dt_proj{suffix}", nn.Linear(dt_rank, d_inner, bias=True))
    a_name = "A_b_log" if suffix else "A_log"
    setattr(block, a_name, nn.Parameter(torch.empty(d_inner, cfg.d_state)))
    setattr(block, f"D{suffix}", nn.Parameter(torch.empty(d_inner)))


def _head(block: nn.Module, suffix: str) -> _ScanHead:
    return _ScanHead(
        getattr(block, f"conv1d{suffix}"), getattr(block, f"x_proj{suffix}"),
        getattr(block, f"dt_proj{suffix}"),
        getattr(block, "A_b_log" if suffix else "A_log"),
        getattr(block, f"D{suffix}"), block.cfg.d_state, block.dtype,
    )


class MambaBlock(nn.Module):
    """Unidirectional Mamba mixer (reference bimamba.py, type "none")."""

    def __init__(self, d_model: int, cfg: MambaConfig = MambaConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.d_inner = cfg.expand * d_model
        self.in_proj = nn.Linear(d_model, 2 * self.d_inner, bias=cfg.bias)
        _add_scan_params(self, self.d_inner, cfg.resolved_dt_rank(d_model), cfg, "")
        self.out_proj = nn.Linear(self.d_inner, d_model, bias=cfg.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, L, d_model) -> (B, L, d_model)."""
        x_in, z = dense(x, self.in_proj, self.dtype).chunk(2, dim=-1)
        return dense(_head(self, "")(x_in, z), self.out_proj, self.dtype)


class BiMambaBlock(nn.Module):
    """Bidirectional Mamba (reference bimamba.py bimamba_type="v2")."""

    def __init__(self, d_model: int, cfg: MambaConfig = MambaConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.d_inner = cfg.expand * d_model
        dt_rank = cfg.resolved_dt_rank(d_model)
        self.in_proj = nn.Linear(d_model, 2 * self.d_inner, bias=cfg.bias)
        self.out_proj = nn.Linear(self.d_inner, d_model, bias=cfg.bias)
        _add_scan_params(self, self.d_inner, dt_rank, cfg, "")
        _add_scan_params(self, self.d_inner, dt_rank, cfg, "_b")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, L, d_model) -> (B, L, d_model)."""
        x_in, z = dense(x, self.in_proj, self.dtype).chunk(2, dim=-1)
        y_f = _head(self, "")(x_in, z)
        y_b = _head(self, "_b")(x_in.flip(1), z.flip(1)).flip(1)
        return dense(0.5 * y_f + 0.5 * y_b, self.out_proj, self.dtype)
