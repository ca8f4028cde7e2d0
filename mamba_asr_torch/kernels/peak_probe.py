"""Wrapper of P2, the attainable-rate probe (`csrc/peak_probe.cu`).

It replaces the Pallas kernel of `scripts/vpu_peak.py:47-63` (launch
`:68`). The plain version is `mamba_asr_torch.ops.peak_probe.
peak_probe_ref`. `LAUNCHES` counts the launches in this process: it grows
by one for each launch and nowhere else. The wrapper raises on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mamba_asr_torch.kernels import build
from mamba_asr_torch.ops.peak_probe import MODES

LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.library("peak_probe").mamba_peak_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def peak_probe(x: torch.Tensor, k: int, mode: str = "dependent") -> torch.Tensor:
    """Launch the probe: each float32 element of x (contiguous, on a card)
    through a chain of k steps of `mode` (see `MODES` and the source)."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA peak probe needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError("x must be a non-empty contiguous float32 tensor")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    launch = _launcher()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = launch(x.data_ptr(), out.data_ptr(), x.numel(), k, MODES.index(mode),
                    torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"peak probe launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
