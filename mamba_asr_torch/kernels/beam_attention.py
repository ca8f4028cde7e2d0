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
from typing import Optional, Tuple

import torch

from mamba_asr_torch.kernels import build

LAUNCHES = 0
MAX_DH = 128
MAX_WARPS = 16       # warps per block (csrc: kMaxWarps)
ANC_TILE = 256       # positions of ancestor entries a block stages at once (kAncTile)
WARPS_PER_SM = 32    # the split rule's target: warps in flight per SM (2 blocks)
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C launcher, built and loaded at first use."""
    fn = build.library("beam_attention").mamba_beam_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_layout(dh: int, elem_bytes: int, align: int) -> Tuple[int, int]:
    """(vec_bytes, lanes_per_row) of one K or V row: the widest load (16,
    8, 4 or, for bf16, 2 bytes) that divides the row and the buffers'
    alignment, and the largest power of two (at most 32) of lanes that
    does not exceed the row's chunks, so that one load instruction reads
    runs of whole rows. dh 36 bf16: (8, 8); dh 64 bf16: (16, 8); dh 128
    fp32: (16, 32)."""
    row = dh * elem_bytes
    vec = next(v for v in (16, 8, 4, 2)
               if v >= elem_bytes and row % v == 0 and align % v == 0)
    chunks = row // vec
    lanes = 1
    while 2 * lanes <= min(32, chunks):
        lanes *= 2
    return vec, lanes


def split_rule(n: int, heads: int, pos: int, sms: int,
               splits: Optional[int] = None) -> Tuple[int, int, int]:
    """(hyps, head_block, splits) of one K4 launch: a block holds hyps x
    head_block x splits warps (at most MAX_WARPS). The positions of each
    (hypothesis, head) split over `splits` warps (a power of two, each
    with at least 32 positions) until N x H x splits warps reach
    WARPS_PER_SM per SM; then blocks shrink, fewer hypotheses first, then
    fewer heads, until the grid has a block for every SM. N 528, H 4,
    pos 255 on 132 SMs: (2, 4, 2); N 66: (1, 2, 8). `splits` forces a
    split (the chip_smoke sweep and the card tests)."""
    if splits is None:
        most = 1
        while 2 * most <= min(MAX_WARPS, -(-(pos + 1) // 32)):
            most *= 2
        splits = 1
        while splits < most and n * heads * splits < WARPS_PER_SM * sms:
            splits *= 2
    if splits < 1 or splits > MAX_WARPS or splits & (splits - 1):
        raise ValueError(f"splits must be a power of two in 1..{MAX_WARPS}, got {splits}")
    head_block = min(heads, MAX_WARPS // splits)
    hyps = max(1, MAX_WARPS // (head_block * splits))

    def blocks():
        return -(-n // hyps) * -(-heads // head_block)

    while hyps > 1 and blocks() < sms:
        hyps //= 2
    while head_block > 1 and blocks() < sms:
        head_block = -(-head_block // 2)
    return hyps, head_block, splits


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
                       anc: torch.Tensor, pos: int,
                       splits: Optional[int] = None) -> torch.Tensor:
    """Launch K4 over positions 0..pos. Arguments as
    `ops.beam_attention.beam_attention_ref`; `splits` forces the position
    split (`split_rule`). Returns (N, H, dh) in q's dtype."""
    global LAUNCHES
    pos = int(pos)
    _check_inputs(q, k_buf, v_buf, anc, pos)
    n, h, dh = q.shape
    ptrs = k_buf.data_ptr() | v_buf.data_ptr()
    vec, lanes = row_layout(dh, q.element_size(), min(16, ptrs & -ptrs))
    hyps, head_block, splits = split_rule(n, h, pos, _sms(q.device.index or 0), splits)
    launch = _launcher()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):  # the launch goes to the current context
        rc = launch(
            q.data_ptr(), k_buf.data_ptr(), v_buf.data_ptr(), anc.data_ptr(),
            out.data_ptr(), h, k_buf.shape[1], n, dh, pos, math.sqrt(dh),
            int(q.dtype == torch.bfloat16), hyps, head_block, splits, lanes, vec,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"beam-attention kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
