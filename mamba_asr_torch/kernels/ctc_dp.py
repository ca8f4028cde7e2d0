"""Wrapper of the Hopper CTC prefix DP kernel (`csrc/ctc_dp.cu`, K3),
which replaces `mamba_asr_tpu/ops/pallas/log_scan.py:_ctc_dp_kernel`
(public entry `ctc_dp_pallas`).

The plain version is `mamba_asr_torch.ops.ctc_dp.ctc_dp_ref`;
`ops.ctc_dp.ctc_dp` sends CUDA tensors here and CPU tensors there.

`LAUNCHES` counts the launches of K3 in this process: it grows by one for
each launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from mamba_asr_torch.kernels import build

LAUNCHES = 0
# K3's block (csrc/ctc_dp.cu: kHB, kC, kLmax): hypotheses, chunks of frames,
# frames per chunk at most; T is walked in segments of CHUNKS * MOST frames.
HYPS, CHUNKS, MOST = 8, 128, 6


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C launcher, built and loaded at first use."""
    fn = build.library("ctc_dp").mamba_ctc_dp
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ctc_dp_fwd(a_nb: torch.Tensor, grow: torch.Tensor, lpb: torch.Tensor,
               valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on four (T, N) float32 planes, contiguous, on one card
    (see `ops.ctc_dp`). Returns (r_nb, r_b), each (T, N) float32."""
    global LAUNCHES
    if a_nb.device.type != "cuda":
        raise ValueError(f"the CUDA CTC prefix DP needs CUDA tensors, got {a_nb.device}")
    if a_nb.dim() != 2 or a_nb.shape[0] < 1 or a_nb.shape[1] < 1:
        raise ValueError(f"a_nb must be (T, N) with T, N >= 1, got {tuple(a_nb.shape)}")
    for name, t in (("a_nb", a_nb), ("grow", grow), ("lpb", lpb), ("valid", valid)):
        if t.device != a_nb.device:
            raise ValueError(f"{name} is on {t.device}, expected {a_nb.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {t.dtype}, expected torch.float32")
        if t.shape != a_nb.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(a_nb.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    frames, n = a_nb.shape
    launch = _launcher()
    r_nb = torch.empty_like(a_nb)
    r_b = torch.empty_like(a_nb)
    with torch.cuda.device(a_nb.device):  # the launch goes to the current context
        rc = launch(a_nb.data_ptr(), grow.data_ptr(), lpb.data_ptr(), valid.data_ptr(),
                    r_nb.data_ptr(), r_b.data_ptr(), frames, n,
                    torch.cuda.current_stream(a_nb.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CTC prefix DP kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return r_nb, r_b
