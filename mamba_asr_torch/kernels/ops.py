"""K1, K3 and K4 as registered custom ops, the one route from a graph to
the hand-written kernels.

| op | kernel (CUDA tensors) | plain version (CPU tensors) |
| --- | --- | --- |
| `mamba_asr::selective_scan_fwd` | K1's inference form, `kernels/selective_scan.py` | `ops/selective_scan.py:selective_scan_ref` |
| `mamba_asr::ctc_dp` | K3, `kernels/ctc_dp.py` | `ops/ctc_dp.py:ctc_dp_ref` |
| `mamba_asr::beam_attention` | K4, `kernels/beam_attention.py` | `ops/beam_attention.py:beam_attention_ref` |

Each op picks its implementation from the device of its tensors: on CUDA
tensors the kernel's wrapper, which launches on the current stream and
raises on what the kernel does not take (a kernel that fails to build or
launch raises too, it never gives way to the plain version); on CPU
tensors the plain version; on any other device the dispatcher raises
(NotImplementedError). A fake
implementation gives the outputs' shapes and dtypes, so `torch.export`
records one `mamba_asr::*` node per launch and an exported program reaches
the kernels through these nodes alone. Loading such a program needs this
module imported first (it registers the ops); nothing here imports the
port's models.

`ops/selective_scan.py` (without a gradient), `ops/ctc_dp.py` and
`ops/beam_attention.py` call these ops on either device, so the live path
and an exported program take the same route.

- `selective_scan_fwd` returns (out, h_last); h_last is an empty float32
  tensor unless `return_last_state`.
- `beam_attention` takes the last position to attend, `pos`, as a 0-d
  int64 tensor: the beam search's step index, which an exported step
  program takes as an input. It must be on the CPU: the kernel's launch
  reads it on the host, and a CUDA `pos` would sync the card there (the
  CUDA implementation raises on one).
"""

from __future__ import annotations

import torch


# One library of this namespace per process: the schemas, a CPU and a CUDA
# implementation each, and the fake. `torch.library.Library` dispatches
# straight to the implementation; `torch.library.custom_op` would wrap each
# call in an autograd and an aliasing check in Python, a host cost that K4's
# thousands of calls a search repeat (PERF.md §6).
_LIB = torch.library.Library("mamba_asr", "DEF")
_LIB.define("selective_scan_fwd(Tensor u, Tensor delta, Tensor A, Tensor B, Tensor C, "
            "Tensor? D, Tensor? z, Tensor? delta_bias, Tensor? h0, bool delta_softplus, "
            "bool return_last_state) -> (Tensor, Tensor)")
_LIB.define("ctc_dp(Tensor a_nb, Tensor grow, Tensor lpb, Tensor valid) -> (Tensor, Tensor)")
_LIB.define("beam_attention(Tensor q, Tensor k_buf, Tensor v_buf, Tensor anc, Tensor pos) "
            "-> Tensor")


def _scan_cpu(u, delta, A, B, C, D, z, delta_bias, h0, delta_softplus, return_last_state):
    from mamba_asr_torch.ops.selective_scan import selective_scan_ref

    out, h_last = selective_scan_ref(u, delta, A, B, C, D, z, delta_bias, delta_softplus, h0,
                                     return_last_state=True)
    return out, h_last if return_last_state else u.new_empty((0,), dtype=torch.float32)


def _scan_cuda(u, delta, A, B, C, D, z, delta_bias, h0, delta_softplus, return_last_state):
    from mamba_asr_torch.kernels import selective_scan as kernel

    res = kernel.selective_scan_fwd(u, delta, A, B, C, D, z, delta_bias, delta_softplus, h0,
                                    return_last_state=return_last_state)
    if return_last_state:
        return res
    return res, u.new_empty((0,), dtype=torch.float32)


def _scan_fake(u, delta, A, B, C, D, z, delta_bias, h0, delta_softplus, return_last_state):
    bsz, _, d_in = u.shape
    h_shape = (bsz, d_in, A.shape[1]) if return_last_state else (0,)
    return torch.empty_like(u), u.new_empty(h_shape, dtype=torch.float32)


def _dp_cpu(a_nb, grow, lpb, valid):
    from mamba_asr_torch.ops.ctc_dp import ctc_dp_ref

    return ctc_dp_ref(a_nb, grow, lpb, valid)


def _dp_cuda(a_nb, grow, lpb, valid):
    from mamba_asr_torch.kernels.ctc_dp import ctc_dp_fwd

    return ctc_dp_fwd(a_nb, grow, lpb, valid)


def _dp_fake(a_nb, grow, lpb, valid):
    return torch.empty_like(a_nb), torch.empty_like(a_nb)


def _attn_cpu(q, k_buf, v_buf, anc, pos):
    from mamba_asr_torch.ops.beam_attention import beam_attention_ref

    return beam_attention_ref(q, k_buf, v_buf, anc, int(pos))


def _attn_cuda(q, k_buf, v_buf, anc, pos):
    from mamba_asr_torch.kernels.beam_attention import beam_attention_fwd

    if pos.device.type != "cpu":
        raise ValueError("mamba_asr::beam_attention takes pos on the CPU (its launch reads "
                         f"it on the host), got {pos.device}")
    return beam_attention_fwd(q, k_buf, v_buf, anc, int(pos))


def _attn_fake(q, k_buf, v_buf, anc, pos):
    return torch.empty_like(q)


for _name, _cpu, _cuda, _fake in (
        ("selective_scan_fwd", _scan_cpu, _scan_cuda, _scan_fake),
        ("ctc_dp", _dp_cpu, _dp_cuda, _dp_fake),
        ("beam_attention", _attn_cpu, _attn_cuda, _attn_fake)):
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"mamba_asr::{_name}", _fake, lib=_LIB)

selective_scan_fwd = torch.ops.mamba_asr.selective_scan_fwd
ctc_dp = torch.ops.mamba_asr.ctc_dp
beam_attention = torch.ops.mamba_asr.beam_attention
