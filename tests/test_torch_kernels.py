"""The port's CUDA kernels against their plain versions.

The card tests skip without a CUDA card; on a machine with one (which
need not have JAX) run them with

    python -m pytest --noconftest -q tests/test_torch_kernels.py

`--noconftest` skips tests/conftest.py, which sets up JAX for the JAX
package's tests. This file imports no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mamba_asr_torch.kernels import selective_scan as kernel
from mamba_asr_torch.ops import selective_scan


def scan_inputs(seed, bsz=2, length=37, d=8, n=4):
    """Selective-scan inputs as float32 numpy arrays, from a seed."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return dict(
        u=f32(bsz, length, d), delta=f32(bsz, length, d, scale=0.5),
        A=-np.exp(f32(d, n)), B=f32(bsz, length, n), C=f32(bsz, length, n),
        D=f32(d), z=f32(bsz, length, d),
        delta_bias=np.linspace(-1.0, 1.0, d).astype(np.float32),
    )


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _on_card(inp, dtype):
    t = {k: torch.from_numpy(v).cuda() for k, v in inp.items()}
    for k in ("u", "delta", "B", "C", "z"):
        t[k] = t[k].to(dtype)
    return t


def test_wrapper_refuses_cpu_tensors():
    t = {k: torch.from_numpy(v) for k, v in scan_inputs(0).items()}
    before = kernel.LAUNCHES
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel.selective_scan_fwd(**t, delta_softplus=True)
    assert kernel.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,h0", [("bfloat16", False), ("float32", True)])
def test_scan_kernel_matches_plain_on_card(dtype, h0):
    """The dispatch sends CUDA tensors to the kernel (one launch). bf16
    within 2e-2 (the output rounds to bf16 in both), fp32 with h0 in and
    h_last out within 2e-4 (exp2 vs exp, FMA contraction); ragged L and D."""
    _card()
    dt = getattr(torch, dtype)
    t = _on_card(scan_inputs(7, bsz=3, length=77, d=200, n=16), dt)
    h = torch.randn(3, 200, 16, device="cuda") if h0 else None
    before = kernel.LAUNCHES
    out, h_last = selective_scan.selective_scan(
        **t, delta_softplus=True, h0=h, return_last_state=True
    )
    assert kernel.LAUNCHES == before + 1
    ref, h_ref = selective_scan.selective_scan_ref(
        **t, delta_softplus=True, h0=h, return_last_state=True
    )
    tol = 2e-2 if dt == torch.bfloat16 else 2e-4
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h_last, h_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_scan_kernel_refuses_what_it_does_not_take():
    _card()
    t = _on_card(scan_inputs(8, d=8, n=4), torch.float32)
    before = kernel.LAUNCHES
    bad = [
        dict(t, z=None),
        dict(t, z=t["z"].transpose(0, 1).contiguous().transpose(0, 1)),
        dict(t, delta=t["delta"].to(torch.bfloat16)),
        dict(t, A=torch.zeros(8, 33, device="cuda"),
             B=torch.zeros(2, 37, 33, device="cuda"),
             C=torch.zeros(2, 37, 33, device="cuda")),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            kernel.selective_scan_fwd(**args, delta_softplus=True)
    assert kernel.LAUNCHES == before
