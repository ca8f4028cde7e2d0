"""Wrappers of P1, the scan-attribution variants (`csrc/scan_variants.cu`).

They replace the Pallas launches of `scripts/exp_scan_variants.py:283`
(`run_variant`) and `:601` (`run_bwd_variant`). Each variant is K1 or K2
with one piece of work removed (or, for `nloop` and `fusedy`, done in
another exact order), instantiated from the same kernel bodies that ship
(`csrc/selective_scan_fwd.cuh`, `csrc/selective_scan_bwd.cuh`, where each
variant is described). The plain versions are `mamba_asr_torch.ops.
scan_variants.selective_scan_variant_ref` and `selective_scan_bwd_variant_ref`.

`FWD_LAUNCHES` and `BWD_LAUNCHES` count the launches in this process: each
grows by one for each launch and nowhere else. The wrappers raise on CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from mamba_asr_torch.kernels import build
from mamba_asr_torch.kernels.selective_scan import _check_inputs, _ptr, run_bwd
from mamba_asr_torch.ops.scan_variants import BWD_VARIANTS, FWD_VARIANTS

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.library("scan_variants")
    lib.mamba_scan_variant_fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.mamba_scan_variant_fwd.restype = ctypes.c_int
    lib.mamba_scan_variant_bwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 21 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.mamba_scan_variant_bwd.restype = ctypes.c_int
    for name in ("mamba_scan_variant_fwd_count", "mamba_scan_variant_bwd_count"):
        getattr(lib, name).restype = ctypes.c_int
    lib.mamba_scan_variant_bwd_channels_per_block.argtypes = [ctypes.c_int]
    lib.mamba_scan_variant_bwd_channels_per_block.restype = ctypes.c_int
    if (lib.mamba_scan_variant_fwd_count() != len(FWD_VARIANTS)
            or lib.mamba_scan_variant_bwd_count() != len(BWD_VARIANTS)):
        raise RuntimeError("scan_variants.cu and FWD_VARIANTS / BWD_VARIANTS disagree")
    return lib


def _index(variant: str, names) -> int:
    if variant not in names:
        raise ValueError(f"unknown variant {variant!r}; one of {names}")
    return names.index(variant)


def scan_variant_fwd(
    variant: str, u, delta, A, B, C, D, z, delta_bias, h0=None,
    delta_softplus: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch forward variant `variant` of K1: (out in u's dtype, h_last
    (B, D, N) float32). Inputs as `kernels.selective_scan.selective_scan_fwd`."""
    global FWD_LAUNCHES
    idx = _index(variant, FWD_VARIANTS)
    _check_inputs(u, delta, A, B, C, D, z, delta_bias, h0)
    bsz, length, d_in = u.shape
    n = A.shape[1]
    lib = _library()
    out = torch.empty_like(u)
    h_last = torch.empty((bsz, d_in, n), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        rc = lib.mamba_scan_variant_fwd(
            idx, _ptr(u), _ptr(delta), _ptr(B), _ptr(C), _ptr(z), _ptr(A),
            _ptr(delta_bias), _ptr(D), _ptr(h0), _ptr(out), _ptr(h_last), bsz,
            length, d_in, n, int(u.dtype == torch.bfloat16), int(delta_softplus),
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"scan variant {variant} launch failed: CUDA error {rc}")
    FWD_LAUNCHES += 1
    return out, h_last


def scan_variant_bwd(
    variant: str, u, delta, A, B, C, D, z, delta_bias, h0,
    h_chunks: torch.Tensor, dout: torch.Tensor,
    dh_last: Optional[torch.Tensor] = None, delta_softplus: bool = True,
) -> Tuple[Optional[torch.Tensor], ...]:
    """Launch adjoint variant `variant` of K2, started from the chunk states
    `h_chunks` (B, ceil(L / CHUNK), D, N). Returns (du, ddelta, dA, dB, dC,
    dD, dz, ddelta_bias, dh0) as `kernels.selective_scan.selective_scan_bwd`."""
    global BWD_LAUNCHES
    idx = _index(variant, BWD_VARIANTS)
    if u.device.type != "cuda":
        raise ValueError(f"the CUDA selective scan needs CUDA tensors, got {u.device}")
    lib = _library()
    grads = run_bwd(functools.partial(lib.mamba_scan_variant_bwd, idx),
                    lib.mamba_scan_variant_bwd_channels_per_block(A.shape[1]),
                    f"scan variant {variant} (adjoint)", u, delta, A, B, C, D, z,
                    delta_bias, delta_softplus, h0, h_chunks, dout, dh_last)
    BWD_LAUNCHES += 1
    return grads
