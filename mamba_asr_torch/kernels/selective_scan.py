"""Wrappers of the Hopper selective-scan kernels.

- `selective_scan_fwd` (`csrc/selective_scan_fwd.cu`, K1) replaces
  `mamba_asr_tpu/ops/pallas/scan.py:_scan_kernel` (public entry
  `selective_scan_pallas`). `selective_scan_fwd_train` launches the same
  kernel in its training form, which also writes the state after every
  `CHUNK` steps.
- `selective_scan_bwd` (`csrc/selective_scan_bwd.cu`, K2) replaces
  `scan.py:_scan_bwd_kernel` (via `selective_scan_bwd_pallas`).

The plain versions are `mamba_asr_torch.ops.selective_scan.
selective_scan_ref` and `selective_scan_bwd_ref`; `ops.selective_scan.
SelectiveScanFn` sends CUDA tensors here and CPU tensors there.

`LAUNCHES` counts the launches of K1 (both forms) in this process and
`BWD_LAUNCHES` those of K2: each grows by one for each launch and
nowhere else. At small batches one K1 launch is two kernels, the segment
pass and the walk (`time_segments`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from mamba_asr_torch.kernels import build

LAUNCHES = 0
BWD_LAUNCHES = 0
CHUNK = 32  # steps per boundary state: kTileT / kChunk of the two kernels
FWD_CHANNELS = 16  # channels per K1 block (selective_scan_fwd.cuh kCh)
# K1 splits time where rows x channel groups give fewer than FWD_SPLIT_BELOW
# blocks per SM, into segments that give about FWD_BLOCKS_PER_SM. On an H100
# at L751 D288 (PERF.md) splitting won at B1 to B8 (below 1.1 blocks
# per SM; 4 segments at B8 took 0.044 ms against 0.061 unsplit) and lost at
# B16 (2.2 per SM; 2 segments 0.085 against 0.076): the segment pass adds
# work that a card already half full pays for.
FWD_SPLIT_BELOW = 2
FWD_BLOCKS_PER_SM = 4
# Channels per K2 block at any d_state (selective_scan_bwd.cuh kCh): the
# width of its dB/dC channel tiles; the C entry's value is checked against it.
BWD_CHANNELS = 16
MAX_D_STATE = 32  # register-resident state; as ops/pallas/scan.py:supported
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C launcher, built and loaded at first use."""
    fn = build.library("selective_scan_fwd").mamba_selective_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    lib = build.library("selective_scan_bwd")
    fn = lib.mamba_selective_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    per_block = lib.mamba_selective_scan_bwd_channels_per_block
    per_block.argtypes = [ctypes.c_int]
    per_block.restype = ctypes.c_int
    if any(per_block(n) != BWD_CHANNELS for n in range(1, MAX_D_STATE + 1)):
        raise RuntimeError("selective_scan_bwd.cu and BWD_CHANNELS disagree")
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


def _check_inputs(u, delta, A, B, C, D, z, delta_bias, h0) -> None:
    """Raise on what the kernels do not take: u, delta, z (B, L, D) and B, C
    (B, L, N) share one dtype (float32 or bfloat16); A (D, N), D and
    delta_bias (D,), h0 (B, D, N) are float32; all contiguous, on one card."""
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


def time_segments(bsz: int, length: int, d_in: int, sms: int) -> Tuple[int, int]:
    """(segments, steps per segment) of one K1 launch. Where rows x channel
    groups give fewer than FWD_SPLIT_BELOW blocks per SM, time splits into
    segments of a whole number of CHUNKs, at least two, so that segments x
    rows x groups give about FWD_BLOCKS_PER_SM blocks per SM: B1 x 30 s at
    d_inner 288 (18 groups) runs in 12 segments of 64 steps, B8 in 4;
    B16 and B32 run unsplit."""
    chunks = -(-length // CHUNK)
    blocks = bsz * -(-d_in // FWD_CHANNELS)
    if blocks >= FWD_SPLIT_BELOW * sms:
        return 1, chunks * CHUNK
    want = -(-FWD_BLOCKS_PER_SM * sms // blocks)
    per = -(-chunks // max(1, min(want, chunks // 2)))
    return -(-chunks // per), per * CHUNK


def _launch_fwd(u, delta, A, B, C, D, z, delta_bias, delta_softplus, h0,
                want_last: bool, want_chunks: bool):
    global LAUNCHES
    _check_inputs(u, delta, A, B, C, D, z, delta_bias, h0)
    bsz, length, d_in = u.shape
    n = A.shape[1]
    dev = u.device
    launch = _launcher()
    out = torch.empty_like(u)
    f32 = dict(dtype=torch.float32, device=dev)
    h_last = torch.empty((bsz, d_in, n), **f32) if want_last else None
    h_chunks = (torch.empty((bsz, -(-length // CHUNK), d_in, n), **f32)
                if want_chunks else None)
    segments, seg_len = time_segments(
        bsz, length, d_in, torch.cuda.get_device_properties(dev).multi_processor_count)
    seg_h = seg_dt = None
    if segments > 1:
        seg_h = torch.empty((bsz, segments - 1, d_in, n), **f32)
        seg_dt = torch.empty((bsz, segments - 1, d_in), **f32)
    with torch.cuda.device(dev):  # the launch goes to the current context
        rc = launch(
            _ptr(u), _ptr(delta), _ptr(B), _ptr(C), _ptr(z), _ptr(A),
            _ptr(delta_bias), _ptr(D), _ptr(h0), _ptr(out), _ptr(h_last),
            _ptr(h_chunks), _ptr(seg_h), _ptr(seg_dt), bsz, length, d_in, n,
            int(u.dtype == torch.bfloat16), int(delta_softplus), seg_len, segments,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"selective-scan kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out, h_last, h_chunks


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
    """Launch K1 (inference form). Arguments as
    `ops.selective_scan.selective_scan`; see `_check_inputs` for what the
    kernel takes. Returns out (B, L, D) in u's dtype, and h_last (B, D, N)
    float32 when `return_last_state`."""
    out, h_last, _ = _launch_fwd(u, delta, A, B, C, D, z, delta_bias,
                                 delta_softplus, h0, return_last_state, False)
    if return_last_state:
        return out, h_last
    return out


def selective_scan_fwd_train(
    u, delta, A, B, C, D=None, z=None, delta_bias=None,
    delta_softplus: bool = False, h0=None, return_last_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Launch K1 in its training form: (out, h_last or None, h_chunks), where
    h_chunks (B, ceil(L / CHUNK), D, N) float32 holds the state after each
    chunk of CHUNK steps, the residual `selective_scan_bwd` starts from.
    `out` is bit-identical to `selective_scan_fwd`'s."""
    return _launch_fwd(u, delta, A, B, C, D, z, delta_bias, delta_softplus,
                       h0, return_last_state, True)


def bwd_launch_args(channels_per_block: int, u, delta, A, B, C, D, z, delta_bias,
                    delta_softplus: bool, h0, h_chunks: torch.Tensor, dout: torch.Tensor,
                    dh_last: Optional[torch.Tensor] = None):
    """Check K2's inputs and allocate its outputs and partials. Returns
    (the arguments of a C entry with K2's signature, the outputs (du,
    ddelta, dz, dB_part, dC_part, dA_part, dD_part, ddb_part, dh0));
    calling the entry on the arguments launches the kernel alone."""
    _check_inputs(u, delta, A, B, C, D, z, delta_bias, h0)
    bsz, length, d_in = u.shape
    n = A.shape[1]
    dev = u.device
    _check("dout", dout, (bsz, length, d_in), u.dtype, dev)
    _check("h_chunks", h_chunks, (bsz, -(-length // CHUNK), d_in, n), torch.float32, dev)
    if dh_last is not None:
        _check("dh_last", dh_last, (bsz, d_in, n), torch.float32, dev)
    tiles = -(-d_in // channels_per_block)
    f32 = dict(dtype=torch.float32, device=dev)
    du, ddelta, dz = (torch.empty_like(u) for _ in range(3))
    dB_part = torch.empty((tiles, bsz, length, n), **f32)
    dC_part = torch.empty((tiles, bsz, length, n), **f32)
    dA_part = torch.empty((bsz, d_in, n), **f32)
    dD_part = torch.empty((bsz, d_in), **f32)
    ddb_part = torch.empty((bsz, d_in), **f32)
    dh0 = torch.empty((bsz, d_in, n), **f32) if h0 is not None else None
    args = (
        _ptr(u), _ptr(delta), _ptr(B), _ptr(C), _ptr(z), _ptr(dout),
        _ptr(A), _ptr(delta_bias), _ptr(D), _ptr(h0), _ptr(dh_last),
        _ptr(h_chunks), _ptr(du), _ptr(ddelta), _ptr(dz), _ptr(dB_part),
        _ptr(dC_part), _ptr(dA_part), _ptr(dD_part), _ptr(ddb_part),
        _ptr(dh0), bsz, length, d_in, n, int(u.dtype == torch.bfloat16),
        int(delta_softplus), torch.cuda.current_stream(dev).cuda_stream,
    )
    return args, (du, ddelta, dz, dB_part, dC_part, dA_part, dD_part, ddb_part, dh0)


def run_bwd(launch, channels_per_block: int, what: str, u, delta, A, B, C, D, z,
            delta_bias, delta_softplus: bool, h0, h_chunks: torch.Tensor,
            dout: torch.Tensor, dh_last: Optional[torch.Tensor] = None):
    """Check K2's inputs, allocate its outputs and partials, call
    `launch(*pointers, *ints, stream)` (a C entry with K2's arguments) and
    sum the partials: (du, ddelta, dA, dB, dC, dD, dz, ddelta_bias, dh0)."""
    args, outs = bwd_launch_args(channels_per_block, u, delta, A, B, C, D, z, delta_bias,
                                 delta_softplus, h0, h_chunks, dout, dh_last)
    du, ddelta, dz, dB_part, dC_part, dA_part, dD_part, ddb_part, dh0 = outs
    with torch.cuda.device(u.device):
        rc = launch(*args)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
    return (
        du, ddelta, dA_part.sum(0), dB_part.sum(0).to(B.dtype),
        dC_part.sum(0).to(C.dtype), None if D is None else dD_part.sum(0),
        dz, None if delta_bias is None else ddb_part.sum(0), dh0,
    )


def selective_scan_bwd(
    u, delta, A, B, C, D, z, delta_bias, delta_softplus: bool, h0,
    h_chunks: torch.Tensor, dout: torch.Tensor,
    dh_last: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], ...]:
    """Launch K2: the adjoint of the scan that `selective_scan_fwd_train`
    ran on the same inputs (its `h_chunks`), for the cotangents dout (B, L,
    D) in u's dtype and dh_last (B, D, N) float32 (None: zero). Returns
    (du, ddelta, dA, dB, dC, dD, dz, ddelta_bias, dh0), each in its
    input's dtype, with None for an absent D, delta_bias or h0. The
    per-tile and per-row partial sums are added here, in float32."""
    global BWD_LAUNCHES
    if u.device.type != "cuda":
        raise ValueError(f"the CUDA selective scan needs CUDA tensors, got {u.device}")
    grads = run_bwd(_bwd_launcher(), BWD_CHANNELS, "selective-scan adjoint", u, delta, A,
                    B, C, D, z, delta_bias, delta_softplus, h0, h_chunks, dout, dh_last)
    BWD_LAUNCHES += 1
    return grads
