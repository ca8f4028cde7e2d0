"""Wrapper of the Hopper selective-scan forward (`csrc/selective_scan_fwd.cu`).

Replaces `mamba_asr_tpu/ops/pallas/scan.py:_scan_kernel` (public entry
`selective_scan_pallas`). The plain version is
`mamba_asr_torch.ops.selective_scan.selective_scan_ref`; the dispatch
`selective_scan` sends CUDA tensors here and CPU tensors there.

`LAUNCHES` counts the kernel launches of this process: it grows by one
for each launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from mamba_asr_torch.kernels import build

LAUNCHES = 0
MAX_D_STATE = 32  # register-resident state; as ops/pallas/scan.py:supported
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C launcher, built and loaded at first use."""
    fn = build.library("selective_scan_fwd").mamba_selective_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def selective_scan_fwd(
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
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Launch the kernel. Arguments as `ops.selective_scan.selective_scan`:
    u, delta, z (B, L, D) and B, C (B, L, N) share one dtype (float32 or
    bfloat16); A (D, N), D and delta_bias (D,), h0 (B, D, N) are float32.
    Returns out (B, L, D) in u's dtype, and h_last (B, D, N) float32 when
    `return_last_state`."""
    global LAUNCHES
    if u.device.type != "cuda":
        raise ValueError(f"the CUDA selective scan needs CUDA tensors, got {u.device}")
    if z is None:
        raise ValueError("the selective-scan kernel requires the silu gate z")
    if u.dim() != 3 or A.dim() != 2:
        raise ValueError("u must be (B, L, D) and A (D, N)")
    bsz, length, d_in = u.shape
    n = A.shape[1]
    if not 1 <= n <= MAX_D_STATE:
        raise ValueError(f"d_state {n} is outside the kernel's 1..{MAX_D_STATE}")
    if u.dtype not in _DTYPES:
        raise ValueError(f"u has dtype {u.dtype}; the kernel takes {_DTYPES}")
    if not (1 <= bsz <= 65535 and length >= 1 and d_in >= 1):
        raise ValueError(f"shape {tuple(u.shape)}: the kernel takes 1..65535 rows, L >= 1, D >= 1")
    dev = u.device
    _check("u", u, (bsz, length, d_in), u.dtype, dev)
    _check("delta", delta, (bsz, length, d_in), u.dtype, dev)
    _check("z", z, (bsz, length, d_in), u.dtype, dev)
    _check("B", B, (bsz, length, n), u.dtype, dev)
    _check("C", C, (bsz, length, n), u.dtype, dev)
    _check("A", A, (d_in, n), torch.float32, dev)
    if D is not None:
        _check("D", D, (d_in,), torch.float32, dev)
    if delta_bias is not None:
        _check("delta_bias", delta_bias, (d_in,), torch.float32, dev)
    if h0 is not None:
        _check("h0", h0, (bsz, d_in, n), torch.float32, dev)

    launch = _launcher()
    out = torch.empty_like(u)
    h_last = (
        torch.empty((bsz, d_in, n), dtype=torch.float32, device=dev)
        if return_last_state else None
    )
    with torch.cuda.device(dev):  # the launch goes to the current context
        rc = launch(
            _ptr(u), _ptr(delta), _ptr(B), _ptr(C), _ptr(z), _ptr(A),
            _ptr(delta_bias), _ptr(D), _ptr(h0), _ptr(out), _ptr(h_last),
            bsz, length, d_in, n, int(u.dtype == torch.bfloat16),
            int(delta_softplus), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"selective-scan kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    if return_last_state:
        return out, h_last
    return out
