"""Wrapper of P2, the attainable-rate probe (`csrc/peak_probe.cu`).

It replaces the Pallas kernel of `scripts/vpu_peak.py:47-63` (launch
`:68`). The plain version is `mamba_asr_torch.ops.peak_probe.
peak_probe_ref`. `LAUNCHES` counts the launches in this process: it grows
by one for each launch and nowhere else. The wrappers raise on CPU tensors.

`peak_probe` launches at each mode's own geometry (`GEOMETRY`);
`peak_probe_at` at a chosen one (blocks per SM and warps per block, all
blocks resident or it raises), optionally through the timed kernel, in
which block 0 records its SM cycles and global-timer nanoseconds: the
measurement tool's occupancy sweep and held clock.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from mamba_asr_torch.kernels import build
from mamba_asr_torch.ops.peak_probe import MODES

LAUNCHES = 0
MAX_WARPS = 32  # csrc/peak_probe.cu:kMaxThreads / 32
# (blocks per SM, warps per block) of each mode's launch, as
# csrc/peak_probe.cu:kGeometry sets them.
GEOMETRY = {"dependent": (2, 32), "independent": (2, 32), "exp2": (1, 32)}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _entry(name: str, *argtypes):
    fn = getattr(build.library("peak_probe"), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _launcher():
    return _entry("mamba_peak_probe", _P, _P, _LL, _I, _I, _P)


def _launcher_at():
    return _entry("mamba_peak_probe_at", _P, _P, _LL, _I, _I, _I, _I, _P, _P)


def _check(x: torch.Tensor, k: int, mode: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA peak probe needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError("x must be a non-empty contiguous float32 tensor")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")


def _done(rc: int, out: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if rc != 0:
        raise RuntimeError(f"peak probe launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def peak_probe(x: torch.Tensor, k: int, mode: str = "dependent") -> torch.Tensor:
    """Launch the probe: each float32 element of x (contiguous, on a card)
    through a chain of k steps of `mode` (see `MODES` and the source)."""
    _check(x, k, mode)
    launch = _launcher()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = launch(x.data_ptr(), out.data_ptr(), x.numel(), k, MODES.index(mode),
                    torch.cuda.current_stream(x.device).cuda_stream)
    return _done(rc, out)


def peak_probe_at(x: torch.Tensor, k: int, mode: str, blocks_per_sm: int, warps: int,
                  clock: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The probe at a chosen geometry. Returns (out, clock): with `clock`,
    the timed kernel's CUDA int64 pair, block 0's SM cycles and global-timer
    nanoseconds from its start to its end, read after the launch
    completes; else None."""
    _check(x, k, mode)
    if not (1 <= warps <= MAX_WARPS and blocks_per_sm >= 1):
        raise ValueError(f"need 1 <= warps <= {MAX_WARPS} and blocks_per_sm >= 1, "
                         f"got {warps}, {blocks_per_sm}")
    launch = _launcher_at()
    out = torch.empty_like(x)
    cycles_ns = torch.zeros(2, dtype=torch.int64, device=x.device) if clock else None
    with torch.cuda.device(x.device):
        rc = launch(x.data_ptr(), out.data_ptr(), x.numel(), k, MODES.index(mode),
                    blocks_per_sm, warps, cycles_ns.data_ptr() if clock else None,
                    torch.cuda.current_stream(x.device).cuda_stream)
    return _done(rc, out), cycles_ns
