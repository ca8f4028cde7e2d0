"""Mamba and bidirectional Mamba (BiMamba v2) blocks, batch path (port of
mamba_asr_tpu/models/mamba.py).

- `MambaBlock`: in_proj (d_model -> 2*d_inner), depthwise causal conv +
  SiLU, x_proj (d_inner -> dt_rank + 2*d_state), dt_proj (its bias enters
  the scan as delta_bias under softplus), A = -exp(A_log), D skip,
  out_proj.
- `BiMambaBlock`: shared in_proj/out_proj, a second set of scan
  parameters (reference suffix `_b`), and
  out = out_proj(0.5 * fwd + 0.5 * flip(bwd(flip(x)))). The flip is over
  the whole padded length, as in the JAX package. Under sequence
  parallelism (`forward(x, seq)`, the time axis sharded over the seq
  axis) both heads run parallel/sequence.py's halo conv and chained scan,
  the backward one with reverse=True in place of the flips.

Parameter names are the reference's (`conv1d`, `x_proj`, `dt_proj`,
`A_log`, `D`, and `conv1d_b`, `x_proj_b`, `dt_proj_b`, `A_b_log`, `D_b`).

The decoder's cache (JAX `MambaBlock.init_cache`, `step`, `prime`):
(conv_state (B, K, D) in the compute dtype, the last K raw inputs, newest
last; ssm_state (B, D, N) float32). `prime` scans a context with the
final state out (K1's h_last form on the card) and keeps its last K-1
inputs; `step` advances one token in plain torch (`causal_conv1d_step`,
`ssm_step`). Weights cast to bf16 (the search's decode weights) compute
as they are: A = -exp(A_log) in A_log's dtype, as in the JAX package,
and the scan is handed A, D and the dt bias as float32 tensors holding
those values.

Streaming (JAX `mamba.py:223-245, 294-367, 411-428`): a chunk's state is
(conv_tail (B, K-1, D) in the compute dtype, the last K-1 raw inputs;
ssm_state (B, D, N) float32). `forward_chunk` convolves [tail, chunk]
and scans the chunk from the carried state (K1 with h0 in and h_last
out on the card). BiMambaBlock carries the forward direction only; its
backward direction scans each chunk alone, the JAX package's compromise
(it would need the future). `MambaBlock.extend_prime` advances a
decoder cache over a further chunk of memory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from mamba_asr_torch.models.layers import dense
from mamba_asr_torch.ops.causal_conv1d import causal_conv1d, causal_conv1d_step
from mamba_asr_torch.ops.selective_scan import selective_scan, ssm_step
from mamba_asr_torch.parallel.mesh import Axis
from mamba_asr_torch.parallel.sequence import sp_causal_conv1d, sp_selective_scan

Cache = Tuple[torch.Tensor, torch.Tensor]  # (conv_state, ssm_state)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """Hyperparameters of a Mamba mixer (reference bimamba.py:40-61).

    The JAX package's `scan_impl` and `seq_axis` are absent: the port
    picks the scan by device, and the blocks take the seq axis of
    sequence parallelism as a forward argument.
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

    @property
    def taps(self) -> torch.Tensor:
        """The conv's taps (D, 1, K) as the op's (K, D)."""
        return self.conv1d.weight[:, 0, :].t()

    def _dt_bc(self, x: torch.Tensor):
        dt_rank = self.dt_proj.weight.shape[1]
        x_dbl = dense(x, self.x_proj, self.dtype)
        dt, b_mat, c_mat = torch.split(
            x_dbl, [dt_rank, self.d_state, self.d_state], dim=-1
        )
        return dt @ self.dt_proj.weight.t().to(dt.dtype), b_mat, c_mat

    def _a_d_bias(self):
        """A = -exp(A_log) in A_log's dtype, then A, D and the dt bias as
        float32 (the values themselves when the weights are float32)."""
        return (-torch.exp(self.A_log)).float(), self.D.float(), self.dt_proj.bias.float()

    def __call__(self, x: torch.Tensor, z: torch.Tensor,
                 return_last_state: bool = False, seq: Optional[Axis] = None,
                 reverse: bool = False):
        """seq: the time axis is sharded over it (JAX `mamba.py:167-188`):
        the halo conv and the chained scan of parallel/sequence.py, which
        with reverse run right to left on inputs in their natural order."""
        if seq is not None:
            x = sp_causal_conv1d(x, self.taps, self.conv1d.bias, axis=seq, reverse=reverse)
            delta, b_mat, c_mat = self._dt_bc(x)
            a, d, bias = self._a_d_bias()
            return sp_selective_scan(
                x, delta, a, b_mat.contiguous(), c_mat.contiguous(), D=d,
                z=z.contiguous(), delta_bias=bias, delta_softplus=True,
                return_last_state=return_last_state, axis=seq, reverse=reverse)
        if reverse:
            raise ValueError("reverse scans need a seq axis (BiMamba flips the data)")
        x = causal_conv1d(x, self.taps, self.conv1d.bias)
        delta, b_mat, c_mat = self._dt_bc(x)
        a, d, bias = self._a_d_bias()
        # softplus(delta + dt_bias) runs inside the scan op, on the
        # compute-dtype delta (mamba_asr_tpu/models/mamba.py:191-196).
        return selective_scan(
            x, delta, a, b_mat.contiguous(), c_mat.contiguous(), D=d,
            z=z.contiguous(), delta_bias=bias, delta_softplus=True,
            return_last_state=return_last_state,
        )

    def scan_chunk(self, x: torch.Tensor, z: torch.Tensor, cache: Cache):
        """Conv over [conv_tail, x], then the scan from the carried state:
        (y (B, L, D), (new conv_tail, h_last))."""
        conv_tail, h = cache
        k = self.conv1d.kernel_size[0]
        buf = torch.cat([conv_tail.to(x.dtype), x], dim=1)
        x_c = causal_conv1d(buf, self.taps, self.conv1d.bias)[:, k - 1:].contiguous()
        delta, b_mat, c_mat = self._dt_bc(x_c)
        a, d, bias = self._a_d_bias()
        y, h_new = selective_scan(
            x_c, delta, a, b_mat.contiguous(), c_mat.contiguous(), D=d,
            z=z.contiguous(), delta_bias=bias, delta_softplus=True, h0=h.float(),
            return_last_state=True,
        )
        return y, (buf[:, buf.shape[1] - (k - 1):], h_new)

    def step(self, x_t: torch.Tensor, z_t: torch.Tensor, cache: Cache):
        """One token: x_t, z_t (B, d_inner) -> (y_t, new cache)."""
        conv_state, ssm_state = cache
        x_c, conv_state = causal_conv1d_step(conv_state, x_t, self.taps, self.conv1d.bias)
        delta, b_mat, c_mat = self._dt_bc(x_c)
        a, d, bias = self._a_d_bias()
        y, ssm_state = ssm_step(ssm_state, x_c, delta, a, b_mat, c_mat, D=d, z=z_t,
                                delta_bias=bias, delta_softplus=True)
        return y, (conv_state, ssm_state)


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

    def forward(self, x: torch.Tensor, seq: Optional[Axis] = None) -> torch.Tensor:
        """x: (B, L, d_model) -> (B, L, d_model); seq: the axis the time
        axis is sharded over (sequence parallelism), or None."""
        x_in, z = dense(x, self.in_proj, self.dtype).chunk(2, dim=-1)
        return dense(_head(self, "")(x_in, z, seq=seq), self.out_proj, self.dtype)

    def init_cache(self, batch: int, dtype: torch.dtype = torch.float32,
                   device=None) -> Cache:
        """Zero (conv_state (B, K, d_inner) in dtype, ssm_state (B,
        d_inner, N) float32)."""
        return (torch.zeros(batch, self.cfg.d_conv, self.d_inner, dtype=dtype, device=device),
                torch.zeros(batch, self.d_inner, self.cfg.d_state, device=device))

    def step(self, x_t: torch.Tensor, cache: Cache):
        """One token: x_t (B, d_model) -> ((B, d_model), new cache)."""
        x_in, z = dense(x_t, self.in_proj, self.dtype).chunk(2, dim=-1)
        y, cache = _head(self, "").step(x_in, z, cache)
        return dense(y, self.out_proj, self.dtype), cache

    def prime(self, x_seq: torch.Tensor) -> Cache:
        """The cache after scanning x_seq (B, T, d_model): the scan's final
        state, and the last K-1 raw inputs behind an empty oldest slot
        (the first step rolls it off), zero-padded on the left when T <
        K-1 (JAX `MambaBlock.prime`)."""
        k = self.cfg.d_conv
        x_in, z = dense(x_seq, self.in_proj, self.dtype).chunk(2, dim=-1)
        _, h = _head(self, "")(x_in, z, return_last_state=True)
        bsz, length = x_in.shape[:2]
        pad = max(k - 1 - length, 0)
        tail = x_in[:, length - (k - 1 - pad):]
        return torch.cat([x_in.new_zeros(bsz, 1 + pad, self.d_inner), tail], dim=1), h

    def extend_prime(self, x_seq: torch.Tensor, cache: Cache) -> Cache:
        """The decoder cache advanced over a further context x_seq (B, T,
        d_model): the scan continues from the cache's state and the conv
        from its last K-1 inputs (JAX `MambaBlock.extend_prime`)."""
        conv_state, h = cache
        x_in, z = dense(x_seq, self.in_proj, self.dtype).chunk(2, dim=-1)
        _, (tail, h) = _head(self, "").scan_chunk(x_in, z, (conv_state[:, 1:], h))
        return torch.cat([torch.zeros_like(tail[:, :1]), tail], dim=1), h

    def init_stream_state(self, batch: int, dtype: torch.dtype, device=None) -> Cache:
        """Zero (conv_tail (B, K-1, d_inner) in dtype, ssm_state (B,
        d_inner, N) float32)."""
        return _stream_state(self, batch, dtype, device)

    def forward_chunk(self, x: torch.Tensor, cache: Cache):
        """One streaming chunk: x (B, L, d_model) -> ((B, L, d_model), new
        state)."""
        x_in, z = dense(x, self.in_proj, self.dtype).chunk(2, dim=-1)
        y, cache = _head(self, "").scan_chunk(x_in, z, cache)
        return dense(y, self.out_proj, self.dtype), cache


def _stream_state(block: nn.Module, batch: int, dtype: torch.dtype, device) -> Cache:
    return (torch.zeros(batch, block.cfg.d_conv - 1, block.d_inner, dtype=dtype, device=device),
            torch.zeros(batch, block.d_inner, block.cfg.d_state, device=device))


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

    def forward(self, x: torch.Tensor, seq: Optional[Axis] = None) -> torch.Tensor:
        """x: (B, L, d_model) -> (B, L, d_model). With seq (the time axis
        sharded over it) the backward direction runs through the sp ops'
        reverse flag instead of flips of the shard (JAX `mamba.py:402-406`)."""
        x_in, z = dense(x, self.in_proj, self.dtype).chunk(2, dim=-1)
        y_f = _head(self, "")(x_in, z, seq=seq)
        if seq is not None:
            y_b = _head(self, "_b")(x_in, z, seq=seq, reverse=True)
        else:
            y_b = _head(self, "_b")(x_in.flip(1), z.flip(1)).flip(1)
        return dense(0.5 * y_f + 0.5 * y_b, self.out_proj, self.dtype)

    def init_stream_state(self, batch: int, dtype: torch.dtype, device=None) -> Cache:
        """The forward direction's streaming state (MambaBlock's)."""
        return _stream_state(self, batch, dtype, device)

    def forward_chunk(self, x: torch.Tensor, cache: Cache):
        """One streaming chunk: the forward scan carries state, the
        backward scan sees this chunk alone (two K1 launches)."""
        x_in, z = dense(x, self.in_proj, self.dtype).chunk(2, dim=-1)
        y_f, cache = _head(self, "").scan_chunk(x_in, z, cache)
        y_b = _head(self, "_b")(x_in.flip(1), z.flip(1)).flip(1)
        return dense(0.5 * y_f + 0.5 * y_b, self.out_proj, self.dtype), cache
