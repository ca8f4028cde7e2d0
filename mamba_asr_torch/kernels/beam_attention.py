"""Wrapper of the Hopper beam-attention kernel (`csrc/beam_attention.cu`,
K4), which replaces `mamba_asr_tpu/ops/pallas/beam_attention.py:
_beam_attn_kernel` (public entry `beam_attention_pallas`).

The plain version is `mamba_asr_torch.ops.beam_attention.
beam_attention_ref`; `ops.beam_attention.beam_attention` sends CUDA
tensors here and CPU tensors there.

`LAUNCHES` counts the launches of K4 in this process: it grows by one for
each launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mamba_asr_torch.kernels import build

LAUNCHES = 0
MAX_DH = 128                # four values per lane
MAX_SMEM_BYTES = 48 * 1024  # a block's shared memory without opting in
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C launcher and its shared-memory sizer, built and loaded at
    first use."""
    lib = build.library("beam_attention")
    fn = lib.mamba_beam_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    smem = lib.mamba_beam_attention_smem_bytes
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_int
    return fn, smem


def _check_inputs(q, k_buf, v_buf, anc, pos) -> None:
    """Raise on what the kernel does not take: q (N, H, dh); k_buf, v_buf
    (H, S, N, dh) in q's dtype (float32 or bfloat16); anc (S, N) int32;
    0 <= pos < S; dh <= 128; all contiguous, on one card."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA beam attention needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q has dtype {q.dtype}; the kernel takes {_DTYPES}")
    if q.dim() != 3 or k_buf.dim() != 4:
        raise ValueError("q must be (N, H, dh) and k_buf (H, S, N, dh)")
    n, h, dh = q.shape
    s = k_buf.shape[1]
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"head width {dh} is outside the kernel's 1..{MAX_DH}")
    if not 0 <= pos < s:
        raise ValueError(f"pos {pos} is outside the cache's 0..{s - 1}")
    for name, t, shape, dtype in (
        ("q", q, (n, h, dh), q.dtype), ("k_buf", k_buf, (h, s, n, dh), q.dtype),
        ("v_buf", v_buf, (h, s, n, dh), q.dtype), ("anc", anc, (s, n), torch.int32),
    ):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def beam_attention_fwd(q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor,
                       anc: torch.Tensor, pos: int) -> torch.Tensor:
    """Launch K4 over positions 0..pos. Arguments as
    `ops.beam_attention.beam_attention_ref`; returns (N, H, dh) in q's
    dtype."""
    global LAUNCHES
    pos = int(pos)
    _check_inputs(q, k_buf, v_buf, anc, pos)
    n, h, dh = q.shape
    launch, smem = _launcher()
    if smem(dh, pos) > MAX_SMEM_BYTES:
        raise ValueError(f"pos {pos} needs {smem(dh, pos)} bytes of shared "
                         f"memory, above the kernel's {MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):  # the launch goes to the current context
        rc = launch(
            q.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr(), anc.data_ptr(),
            out.data_ptr(), h, k_buf.shape[1], n, dh, pos, math.sqrt(dh),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"beam-attention kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
