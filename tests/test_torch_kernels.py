"""The port's CUDA kernels against their plain versions.

The card tests skip without a CUDA card; on a machine with one (which
need not have JAX) run them with

    python -m pytest --noconftest -q tests/test_torch_kernels.py

`--noconftest` skips tests/conftest.py, which sets up JAX for the JAX
package's tests. This file imports no JAX.
"""

from __future__ import annotations

import time

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


GRAD_NAMES = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias", "h0")


def assert_grads_close(got, ref, rtol, atol_frac):
    """Each gradient within atol_frac * max|ref| + rtol * |ref|: the
    partial sums over B, L or D add in another order than the plain loop."""
    for name, g, r in zip(GRAD_NAMES, got, ref):
        if r is None:
            assert g is None, name
            continue
        assert g.dtype == r.dtype and g.shape == r.shape, name
        g, r = g.float(), r.float()
        atol = atol_frac * r.abs().max().item()
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol, msg=name)


def test_bwd_wrapper_refuses_cpu_tensors():
    t = {k: torch.from_numpy(v) for k, v in scan_inputs(0).items()}
    before = kernel.BWD_LAUNCHES
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel.selective_scan_bwd(**t, delta_softplus=True, h0=None,
                                  h_chunks=torch.zeros(2, 2, 8, 4),
                                  dout=torch.zeros(2, 37, 8))
    assert kernel.BWD_LAUNCHES == before


# (dtype, B, L, D, N, h0): ragged L 77 and D 200 at each lane width (N 4,
# 16, 20 -> 1, 2, 4 states per lane), B1, L 1 and 33, N 1 and 32, and the
# training path's B32 L626 D288 N16 bf16.
BWD_CASES = [("bfloat16", 3, 77, 200, 16, False), ("float32", 3, 77, 200, 16, True),
             ("float32", 3, 77, 200, 4, True), ("float32", 3, 77, 200, 20, False),
             ("float32", 1, 77, 200, 16, True), ("float32", 3, 1, 200, 16, True),
             ("float32", 3, 33, 200, 16, False), ("float32", 3, 77, 200, 1, True),
             ("float32", 3, 77, 200, 32, True), ("bfloat16", 32, 626, 288, 16, False)]


def _bwd_case(dtype, bsz, length, d, n, h0):
    """K2's inputs on the card: scan inputs, h0, dout, a d(h_last)
    cotangent and K1's chunk states."""
    dt = getattr(torch, dtype)
    t = _on_card(scan_inputs(17, bsz=bsz, length=length, d=d, n=n), dt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(bsz, d, n, device="cuda", generator=gen) if h0 else None
    dout = torch.randn(bsz, length, d, device="cuda", generator=gen).to(dt)
    dhl = torch.randn(bsz, d, n, device="cuda", generator=gen)
    _, _, h_chunks = kernel.selective_scan_fwd_train(**t, delta_softplus=True, h0=h)
    return t, h, dout, dhl, h_chunks


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bsz,length,d,n,h0", BWD_CASES)
def test_scan_bwd_kernel_matches_plain_on_card(dtype, bsz, length, d, n, h0):
    """K2 (fed by K1's training form) against selective_scan_bwd_ref, with
    h0 and a d(h_last) cotangent (BWD_CASES). fp32 within 1e-3 relative +
    1e-4 of the largest value (exp2 vs exp, sums in other orders); bf16
    within 2e-2 + 2e-2 (du, ddelta, dz, dB, dC round to bf16 on both
    sides, one ulp is 0.78 %)."""
    _card()
    dt = getattr(torch, dtype)
    t, h, dout, dhl, h_chunks = _bwd_case(dtype, bsz, length, d, n, h0)
    before = kernel.BWD_LAUNCHES
    got = kernel.selective_scan_bwd(**t, delta_softplus=True, h0=h, h_chunks=h_chunks,
                                    dout=dout, dh_last=dhl)
    torch.cuda.synchronize()
    assert kernel.BWD_LAUNCHES == before + 1
    ref = selective_scan.selective_scan_bwd_ref(
        *(t[k] for k in GRAD_NAMES[:8]), True, h, dout, dhl)
    rtol, atol = (2e-2, 2e-2) if dt == torch.bfloat16 else (1e-3, 1e-4)
    assert_grads_close(got, ref, rtol, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [BWD_CASES[1], BWD_CASES[-1]])
def test_scan_bwd_kernel_is_deterministic_on_card(case):
    """K2 uses no atomics: two launches on the same inputs give
    bit-identical gradients (ragged fp32 with h0, and the training shape)."""
    _card()
    t, h, dout, dhl, h_chunks = _bwd_case(*case)
    runs = [kernel.selective_scan_bwd(**t, delta_softplus=True, h0=h, h_chunks=h_chunks,
                                      dout=dout, dh_last=dhl) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(GRAD_NAMES, *runs):
        assert (a is None) == (b is None), name
        assert a is None or torch.equal(a, b), name


@pytest.mark.cuda
def test_scan_fwd_training_form_on_card():
    """K1's training form: out bit-identical to the inference form; the
    chunk states equal the plain states after steps 32, 64, ... and L."""
    _card()
    t = _on_card(scan_inputs(18, bsz=2, length=77, d=200, n=16), torch.float32)
    out = kernel.selective_scan_fwd(**t, delta_softplus=True)
    out2, h_last, h_chunks = kernel.selective_scan_fwd_train(
        **t, delta_softplus=True, return_last_state=True)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)
    assert h_chunks.shape == (2, 3, 200, 16)
    for c, end in enumerate((32, 64, 77)):
        part = {k: (v[:, :end] if k in ("u", "delta", "B", "C", "z") else v)
                for k, v in t.items()}
        _, h_ref = selective_scan.selective_scan_ref(**part, delta_softplus=True,
                                                     return_last_state=True)
        torch.testing.assert_close(h_chunks[:, c], h_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h_chunks[:, -1], h_last, rtol=0, atol=0)


@pytest.mark.cuda
def test_scan_dispatch_with_grad_goes_through_both_kernels():
    """On CUDA with grad: one K1 (training form) launch forward, one K2
    launch backward, and the gradients of the plain path; under no_grad
    one K1 launch and no graph."""
    _card()
    t = _on_card(scan_inputs(19, bsz=2, length=50, d=40, n=16), torch.float32)
    leaves = {k: v.clone().requires_grad_() for k, v in t.items()}
    k1, k2 = kernel.LAUNCHES, kernel.BWD_LAUNCHES
    out, h_last = selective_scan.selective_scan(**leaves, delta_softplus=True,
                                                return_last_state=True)
    assert out.grad_fn is not None and kernel.LAUNCHES == k1 + 1
    dout = torch.randn_like(out)
    dhl = torch.randn_like(h_last)
    got = torch.autograd.grad((out * dout).sum() + (h_last * dhl).sum(),
                              list(leaves.values()))
    assert kernel.BWD_LAUNCHES == k2 + 1
    ref = selective_scan.selective_scan_bwd_ref(
        *(t[k] for k in GRAD_NAMES[:8]), True, None, dout, dhl)
    by_name = dict(zip(leaves, got))
    assert_grads_close([by_name.get(k) for k in GRAD_NAMES[:8]] + [None],
                       list(ref[:8]) + [None], 1e-3, 1e-4)
    with torch.no_grad():
        out = selective_scan.selective_scan(**leaves, delta_softplus=True)
    assert out.grad_fn is None and kernel.LAUNCHES == k1 + 2
    assert kernel.BWD_LAUNCHES == k2 + 1


# -- K3, the CTC prefix DP ----------------------------------------------------


def dp_inputs(seed, t=131, n=70):
    """The select DP's (T, N) float32 planes from a seed, with ragged
    validity (rows valid for 1, 40, 90 and all frames)."""
    from mamba_asr_torch.ops.ctc_dp import NEG

    rng = np.random.default_rng(seed)
    lens = np.array([t, 1, 40, 90])[np.arange(n) % 4]
    valid = np.arange(t)[:, None] < lens[None, :]
    lp_tok = np.log(rng.uniform(1e-4, 1.0, (t, n)))
    grow = np.where(valid, rng.normal(size=(t, n)) * 2 - 5 + lp_tok, NEG)
    lpb = np.where(valid, np.log(rng.uniform(0.1, 0.9, (t, n))), 0.0)
    return [x.astype(np.float32) for x in (np.where(valid, lp_tok, 0.0), grow, lpb, valid)]


def test_ctc_dp_wrapper_refuses_cpu_tensors():
    from mamba_asr_torch.kernels import ctc_dp as k3

    before = k3.LAUNCHES
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        k3.ctc_dp_fwd(*map(torch.from_numpy, dp_inputs(0, t=5, n=3)))
    assert k3.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("t,n", [(131, 70), (1, 70), (2, 5), (131, 1), (131, 33),
                                 (2000, 33)])
def test_ctc_dp_kernel_matches_plain_on_card(t, n):
    """The dispatch sends CUDA tensors to K3 (one launch) and both
    recurrences agree with the plain loop within 1e-4 + 1e-5 relative
    (ex2/lg2.approx against torch's exp/log1p, sums composed in another
    order; the -1e30 sentinels by the relative part), at T 1 and 2, N 1
    and 33, and T 2000 (three 768-frame segments)."""
    _card()
    from mamba_asr_torch.kernels import ctc_dp as k3
    from mamba_asr_torch.ops import ctc_dp

    planes = [torch.from_numpy(x).cuda() for x in dp_inputs(21, t=t, n=n)]
    before = k3.LAUNCHES
    r_nb, r_b = ctc_dp.ctc_dp(*planes)
    torch.cuda.synchronize()
    assert k3.LAUNCHES == before + 1
    ref_nb, ref_b = ctc_dp.ctc_dp_ref(*planes)
    torch.testing.assert_close(r_nb, ref_nb, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(r_b, ref_b, rtol=1e-5, atol=1e-4)


# -- K4, the beam attention ---------------------------------------------------


def test_beam_attention_wrapper_refuses_cpu_tensors():
    from mamba_asr_torch.kernels import beam_attention as k4

    before = k4.LAUNCHES
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        k4.beam_attention_fwd(torch.zeros(3, 2, 8), torch.zeros(2, 64, 3, 8),
                              torch.zeros(2, 64, 3, 8),
                              torch.zeros(64, 3, dtype=torch.int32), 5)
    assert k4.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh,pos,s,n,splits,offset", [
    ("bfloat16", 36, 0, 256, 70, None, 0), ("bfloat16", 36, 200, 256, 70, None, 0),
    ("float32", 8, 63, 256, 70, None, 0), ("float32", 100, 64, 256, 70, None, 0),
    ("bfloat16", 36, 31, 256, 70, None, 0), ("bfloat16", 36, 1023, 1024, 70, None, 0),
    ("float32", 64, 127, 256, 70, None, 0), ("bfloat16", 64, 127, 256, 70, None, 0),
    ("bfloat16", 36, 100, 256, 1, None, 0), ("bfloat16", 36, 255, 256, 70, 16, 0),
    ("float32", 128, 90, 128, 9, 4, 0), ("bfloat16", 7, 40, 64, 9, None, 0),
    ("bfloat16", 36, 77, 128, 9, None, 1),
])
def test_beam_attention_kernel_matches_plain_on_card(dtype, dh, pos, s, n, splits, offset):
    """K4 against the plain gather at H 4 with a random ancestor table (row
    pos the identity), never-written rows past pos set to NaN in the
    kernel's input (it must not read them): float32 within 2e-5, bf16
    within 1e-2 + 1e-2 relative (the output rounds to bf16). Past the old
    shared-memory ceiling (pos 1,023), the Large decoder's dh 64, N 1,
    forced splits, dh 128 over 8 lanes, odd dh 7 (2-byte loads), and K/V
    buffers `offset` elements past an aligned address (narrower loads)."""
    _card()
    from mamba_asr_torch.kernels import beam_attention as k4
    from mamba_asr_torch.ops import beam_attention as ba

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(pos + dh)
    h = 4

    def buf():
        x = torch.from_numpy(rng.normal(size=(h, s, n, dh)).astype(np.float32)).to(dt)
        flat = torch.empty(x.numel() + offset, dtype=dt, device="cuda")
        out = flat[offset:].view(h, s, n, dh)
        out.copy_(x)
        return out

    q = torch.from_numpy(rng.normal(size=(n, h, dh)).astype(np.float32)).cuda().to(dt)
    k, v = buf(), buf()
    anc = rng.integers(0, n, size=(s, n)).astype(np.int32)
    anc[pos] = np.arange(n)
    anc = torch.from_numpy(anc).cuda()
    ref = ba.beam_attention_ref(q, k, v, anc, pos)
    k[:, pos + 1:], v[:, pos + 1:] = float("nan"), float("nan")
    before = k4.LAUNCHES
    if splits is None:
        got = ba.beam_attention(q, k, v, anc, pos)
    else:
        got = k4.beam_attention_fwd(q, k, v, anc, pos, splits=splits)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + 1 and got.dtype == dt
    tol = 1e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [255, 1023])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_beam_attention_kernel_at_the_lm_shape_on_card(dtype, pos):
    """K4 at the TransformerLM's heads, H 12 of dh 64, N 528 (B8 x beam 66),
    S 320 (the search's cache) at pos 255 and S 1,024 at pos 1,023, on a
    random ancestor table with row pos the identity, rows past pos NaN:
    float32 within 2e-5, bf16 within
    1e-2 + 1e-2 relative. At H 12 the split rule's head blocks (up to 16 /
    splits heads) need not divide the heads: the kernel guards the last
    block."""
    _card()
    from mamba_asr_torch.kernels import beam_attention as k4
    from mamba_asr_torch.ops import beam_attention as ba

    dt = getattr(torch, dtype)
    h, dh, n = 12, 64, 528
    s = {255: 320, 1023: 1024}[pos]
    gen = torch.Generator(device="cuda").manual_seed(pos)
    q = torch.randn(n, h, dh, device="cuda", generator=gen).to(dt)
    k, v = (torch.randn(h, s, n, dh, device="cuda", generator=gen).to(dt) for _ in range(2))
    anc = torch.randint(0, n, (s, n), device="cuda", generator=gen, dtype=torch.int32)
    anc[pos] = torch.arange(n, device="cuda", dtype=torch.int32)
    ref = ba.beam_attention_ref(q, k, v, anc, pos)
    k[:, pos + 1:], v[:, pos + 1:] = float("nan"), float("nan")
    before = k4.LAUNCHES
    got = ba.beam_attention(q, k, v, anc, pos)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + 1 and got.dtype == dt
    tol = 1e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["random", "beam"])
@pytest.mark.parametrize("pos", [255, 1023])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_beam_attention_kernel_at_the_conformer_large_shape_on_card(dtype, pos, table):
    """K4 at the Conformer-Large decoder's heads (S2S/conformer_large.yaml:
    d_model 512, nhead 8: H 8 of dh 64), N 528 (B8 x beam 66), S 320 at pos
    255 and S 1,024 at pos 1,023, on a random ancestor table (row pos the
    identity) and on a beam-shaped one (each step's hypotheses take the
    columns of parents among their utterance's 66 rows, as the search
    does), rows past pos NaN: float32 within 2e-5, bf16 within 1e-2 +
    1e-2 relative."""
    _card()
    from mamba_asr_torch.kernels import beam_attention as k4
    from mamba_asr_torch.ops import beam_attention as ba

    dt = getattr(torch, dtype)
    h, dh, n, beam = 8, 64, 528, 66
    s = {255: 320, 1023: 1024}[pos]
    gen = torch.Generator(device="cuda").manual_seed(pos + 8)
    q = torch.randn(n, h, dh, device="cuda", generator=gen).to(dt)
    k, v = (torch.randn(h, s, n, dh, device="cuda", generator=gen).to(dt) for _ in range(2))
    rng = np.random.default_rng(pos)
    if table == "random":
        anc = rng.integers(0, n, (s, n)).astype(np.int32)
    else:
        anc = np.zeros((s, n), np.int32)
        base = np.arange(n) // beam * beam
        for step in range(pos):
            anc[step] = np.arange(n)
            anc[:step + 1] = anc[:step + 1][:, base + rng.integers(0, beam, n)]
    anc[pos] = np.arange(n)
    anc = torch.from_numpy(anc).cuda()
    ref = ba.beam_attention_ref(q, k, v, anc, pos)
    k[:, pos + 1:], v[:, pos + 1:] = float("nan"), float("nan")
    before = k4.LAUNCHES
    got = ba.beam_attention(q, k, v, anc, pos)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + 1 and got.dtype == dt
    tol = 1e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


# -- P1, the scan-attribution variants; the redesigned K1 at B1 -------------


@pytest.mark.cuda
def test_scan_kernel_full_length_at_batch_one_on_card():
    """K1 at B1 L751 D288 N16 bf16 (18 blocks: the small-batch case)
    within (1e-2, 1e-2), one bf16 ulp of the output."""
    _card()
    t = _on_card(scan_inputs(23, bsz=1, length=751, d=288, n=16), torch.bfloat16)
    out, h_last = kernel.selective_scan_fwd(**t, delta_softplus=True, return_last_state=True)
    torch.cuda.synchronize()
    ref, h_ref = selective_scan.selective_scan_ref(**t, delta_softplus=True,
                                                   return_last_state=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(h_last, h_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("length", [1, 2, 3, 16])
def test_scan_kernel_streaming_chunk_on_card(length, dtype):
    """K1 at a streaming chunk's shape (B1, L 16, or 1 to 3 at a flush;
    D288, N16) with the carried state in and h_last out, against the plain
    version: one launch; bf16 within (1e-2, 1e-2), fp32 2e-4; h_last
    2e-4."""
    _card()
    dt = getattr(torch, dtype)
    t = _on_card(scan_inputs(29 + length, bsz=1, length=length, d=288, n=16), dt)
    h0 = torch.randn(1, 288, 16, device="cuda")
    before = kernel.LAUNCHES
    out, h_last = kernel.selective_scan_fwd(**t, delta_softplus=True, h0=h0,
                                            return_last_state=True)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    ref, h_ref = selective_scan.selective_scan_ref(**t, delta_softplus=True, h0=h0,
                                                   return_last_state=True)
    tol = 1e-2 if dt == torch.bfloat16 else 2e-4
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h_last, h_ref, rtol=2e-4, atol=2e-4)


def test_time_segments_cover_the_steps():
    """Every K1 launch's segments are whole CHUNKs and cover L, the last
    one non-empty; at 30 s and d_inner 288 on 132 SMs B1 runs in 12, B8 in
    4, and B16 (2.2 blocks per SM) and B32 unsplit."""
    for bsz in (1, 2, 3, 8, 16, 32, 64):
        for length in (1, 31, 32, 77, 300, 626, 751, 3001):
            for d in (8, 200, 288):
                segs, seg_len = kernel.time_segments(bsz, length, d, 132)
                assert segs >= 1 and seg_len % kernel.CHUNK == 0
                assert (segs - 1) * seg_len < length <= segs * seg_len
    assert kernel.time_segments(32, 751, 288, 132) == (1, 768)
    assert kernel.time_segments(16, 751, 288, 132) == (1, 768)
    assert kernel.time_segments(8, 751, 288, 132) == (4, 192)
    assert kernel.time_segments(1, 751, 288, 132) == (12, 64)
    for length in (1, 2, 3, 16):  # a streaming chunk: one segment
        assert kernel.time_segments(1, length, 288, 132) == (1, 32)


@pytest.mark.cuda
def test_scan_kernel_time_segments_on_card():
    """B2 L300 D200 fp32 runs in 5 segments of 64 steps: out, h_last from h0
    and the chunk states against the plain scan (2e-4, exp2 of the summed dt
    against the product of exps), out bit-identical across the two forms."""
    _card()
    assert kernel.time_segments(2, 300, 200, torch.cuda.get_device_properties(0)
                                .multi_processor_count)[0] > 1
    t = _on_card(scan_inputs(29, bsz=2, length=300, d=200, n=16), torch.float32)
    h = torch.randn(2, 200, 16, device="cuda")
    out, h_last = kernel.selective_scan_fwd(**t, delta_softplus=True, h0=h,
                                            return_last_state=True)
    out2, _, h_chunks = kernel.selective_scan_fwd_train(**t, delta_softplus=True, h0=h)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)
    ref, h_ref = selective_scan.selective_scan_ref(**t, delta_softplus=True, h0=h,
                                                   return_last_state=True)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h_last, h_ref, rtol=2e-4, atol=2e-4)
    for c, end in enumerate(range(32, 300 + 32, 32)):
        part = {k: (v[:, :min(end, 300)] if k in ("u", "delta", "B", "C", "z") else v)
                for k, v in t.items()}
        _, h_c = selective_scan.selective_scan_ref(**part, delta_softplus=True, h0=h,
                                                   return_last_state=True)
        torch.testing.assert_close(h_chunks[:, c], h_c, rtol=2e-4, atol=2e-4)


def _variant_case(device, dtype=torch.float32):
    """B2 L200 (ragged against the 32-step tile) D280 (ragged against 16
    channels) N16, from ops.scan_variants.variant_inputs."""
    from mamba_asr_torch.ops import scan_variants as sv

    inp = sv.variant_inputs(2, 200, 280, 16, dtype, 31, device)
    return inp, sv.variant_dout(inp, 32)


def test_variant_wrappers_refuse_cpu_tensors():
    from mamba_asr_torch.kernels import scan_variants as p1

    inp, dout = _variant_case("cpu")
    before = (p1.FWD_LAUNCHES, p1.BWD_LAUNCHES)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        p1.scan_variant_fwd("noexp", **inp)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        p1.scan_variant_bwd("nogh", **inp, h0=None, h_chunks=torch.zeros(2, 7, 280, 16),
                            dout=dout)
    assert (p1.FWD_LAUNCHES, p1.BWD_LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["base", "noexp", "nosoftplus", "noscan", "nodbu", "noy",
                                     "fastexp", "bf16scan", "nloop", "fusedy"])
def test_fwd_variant_matches_plain_on_card(variant, dtype):
    """float32 within the variant's tolerance (ops/scan_variants.py); bf16
    out within 1e-2 + 1e-2 abs (one bf16 ulp is 0.78 %, as K1's) or the
    variant's own, whichever is larger, and h_last (float32 arithmetic on
    the same values) within the variant's."""
    _card()
    from mamba_asr_torch.kernels import scan_variants as p1
    from mamba_asr_torch.ops import scan_variants as sv

    inp, _ = _variant_case("cuda", getattr(torch, dtype))
    before = p1.FWD_LAUNCHES
    out, h_last = sv.scan_variant_fwd(variant, **inp)
    torch.cuda.synchronize()
    assert p1.FWD_LAUNCHES == before + 1
    ref, h_ref = sv.selective_scan_variant_ref(variant, **inp)
    atol, rtol = sv.FWD_CARD_TOL.get(variant, sv.FWD_CARD_TOL_DEFAULT)
    torch.testing.assert_close(h_last, h_ref, rtol=rtol, atol=atol)
    if dtype == "bfloat16":
        atol, rtol = max(atol, 1e-2), max(rtol, 1e-2)
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["base", "nloop", "noexp", "nosoftplus", "nofwdscan",
                                     "norevscan", "noreduce_n", "noreduce_d", "nogh"])
def test_bwd_variant_matches_plain_on_card(variant, dtype):
    """From K1's own chunk states, with h0 and a d(h_last) cotangent
    (noreduce_d's dB, dC are the channel tiles' count times B, C: the
    plain version's tile count is the kernel's). bf16 within K2's bf16
    tolerance, 2e-2 + 2e-2 of the largest."""
    _card()
    from mamba_asr_torch.kernels import scan_variants as p1
    from mamba_asr_torch.ops import scan_variants as sv

    inp, dout = _variant_case("cuda", getattr(torch, dtype))
    gen = torch.Generator(device="cuda").manual_seed(3)
    h0 = torch.randn(2, 280, 16, device="cuda", generator=gen)
    dhl = torch.randn(2, 280, 16, device="cuda", generator=gen)
    _, _, h_chunks = kernel.selective_scan_fwd_train(**inp, delta_softplus=True, h0=h0)
    before = p1.BWD_LAUNCHES
    got = sv.scan_variant_bwd(variant, **inp, h0=h0, h_chunks=h_chunks, dout=dout,
                              dh_last=dhl)
    torch.cuda.synchronize()
    assert p1.BWD_LAUNCHES == before + 1
    tiles = -(-280 // kernel.BWD_CHANNELS)
    ref = sv.selective_scan_bwd_variant_ref(variant, **inp, h0=h0, h_chunks=h_chunks,
                                            dout=dout, dh_last=dhl, chunk=kernel.CHUNK,
                                            tiles=tiles)
    assert_grads_close(got, ref, *((2e-2, 2e-2) if dtype == "bfloat16" else sv.BWD_CARD_TOL))


# -- P2, the peak probe -------------------------------------------------------


def test_probe_wrapper_refuses_cpu_tensors():
    from mamba_asr_torch.kernels import peak_probe as p2

    before = p2.LAUNCHES
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        p2.peak_probe(torch.full((4, 5), 0.5), 8)
    assert p2.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((2, 37, 100), 64), ((32, 751, 288), 1024)])
@pytest.mark.parametrize("mode", ["dependent", "independent", "exp2"])
def test_probe_matches_plain_on_card(mode, shape, k):
    """Within 1e-5 relative: FMA against separate multiply and add, exp2f
    against torch.exp2, on contracting chains. At the tool's shape each
    thread of the persistent grid walks several float4s with the next one
    in flight."""
    _card()
    from mamba_asr_torch.kernels import peak_probe as p2
    from mamba_asr_torch.ops import peak_probe as probe

    x = torch.from_numpy(np.random.default_rng(5).uniform(0.1, 0.9, shape)
                         .astype(np.float32)).cuda()
    before = p2.LAUNCHES
    got = probe.peak_probe(x, k, mode)
    torch.cuda.synchronize()
    assert p2.LAUNCHES == before + 1
    torch.testing.assert_close(got, probe.peak_probe_ref(x, k, mode), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("offset,k", [(0, 64), (1, 64), (1, 0), (1, 10), (0, 70)],
                         ids=["ragged", "offset", "k0", "k10", "k70"])
@pytest.mark.parametrize("mode", ["dependent", "independent", "exp2"])
def test_probe_ragged_ends_on_card(mode, offset, k):
    """7,474 elements (no multiple of 4); with offset 1 a view off a
    16-byte boundary, so the kernel's head and tail and its 4-byte stores
    run; k 0, 10 and 70 (a block of 64 steps and a remainder)."""
    _card()
    from mamba_asr_torch.kernels import peak_probe as p2
    from mamba_asr_torch.ops import peak_probe as probe

    whole = torch.from_numpy(np.random.default_rng(6).uniform(0.1, 0.9, 2 * 37 * 101 + offset)
                             .astype(np.float32)).cuda()
    x = whole[offset:]
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    before = p2.LAUNCHES
    got = probe.peak_probe(x, k, mode)
    torch.cuda.synchronize()
    assert p2.LAUNCHES == before + 1
    torch.testing.assert_close(got, probe.peak_probe_ref(x, k, mode), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks,warps", [(1, 1), (1, 8), (2, 32)])
def test_probe_at_a_geometry_on_card(blocks, warps):
    """The sweep's entry: any geometry computes the same chains (an
    offset view: head, tail and 4-byte stores), and the timed kernel's
    block 0 records its cycles and nanoseconds, at an SM clock between
    0.5 and 3 GHz."""
    _card()
    from mamba_asr_torch.kernels import peak_probe as p2
    from mamba_asr_torch.ops import peak_probe as probe

    x = torch.from_numpy(np.random.default_rng(7).uniform(0.1, 0.9, 40_001)
                         .astype(np.float32)).cuda()[1:]
    for mode in ("dependent", "exp2"):
        got, clock = p2.peak_probe_at(x, 70, mode, blocks, warps, clock=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, probe.peak_probe_ref(x, 70, mode), rtol=1e-5, atol=1e-6)
        cycles, ns = clock.tolist()
        assert cycles > 0 and ns > 0 and 0.5 < cycles / ns < 3.0


def test_probe_at_refuses_cpu_tensors_and_bad_geometry():
    from mamba_asr_torch.kernels import peak_probe as p2

    before = p2.LAUNCHES
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        p2.peak_probe_at(torch.full((4, 5), 0.5), 8, "dependent", 1, 8)
    if torch.cuda.is_available():
        for blocks, warps in ((1, 33), (1, 0), (0, 8)):
            with pytest.raises(ValueError, match="warps"):
                p2.peak_probe_at(torch.full((4, 5), 0.5, device="cuda"), 8, "dependent",
                                 blocks, warps)
    assert p2.LAUNCHES == before


# -- Timing -------------------------------------------------------------------


def test_median_ms_on_cpu_is_the_host_time():
    from mamba_asr_torch.tools.timing import median_ms, time_key

    assert median_ms(lambda: time.sleep(0.002), 3, torch.device("cpu")) >= 2.0
    assert time_key(torch.device("cpu")) == "cpu_ms"


@pytest.mark.cuda
def test_median_ms_excludes_the_host_enqueue_on_card():
    """A call that spends 1 ms on the host and launches one tiny kernel:
    events around the call read >= 1 ms (the fault of the
    kernel timing before median_ms); median_ms, the calls queued behind a spin kernel, reads the
    card's time alone."""
    _card()
    from mamba_asr_torch.tools.timing import median_ms

    x = torch.zeros(1024, device="cuda")

    def call():
        time.sleep(0.001)
        x.add_(1.0)

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    end.synchronize()
    assert start.elapsed_time(end) >= 1.0
    assert median_ms(call, 5, torch.device("cuda")) < 0.2


# -- the CTC prefix beam search (torch ops, no kernel of its own) -----------------


@pytest.mark.cuda
@pytest.mark.parametrize("beam", [4, 100])
def test_ctc_beam_search_on_card_matches_cpu(beam):
    """B3 x T120 x V31 CTC-shaped log-probs, ragged: the card's whole final
    beam (tokens, lengths) equals the CPU's; live totals within 1e-4."""
    from mamba_asr_torch.decoding.ctc_beam import _beam_search_full

    _card()
    rng = np.random.default_rng(beam)
    logits = rng.normal(size=(3, 120, 31)).astype(np.float32)
    peak = np.where(rng.random((3, 120)) < 0.7, 0, rng.integers(1, 31, (3, 120)))
    logits[np.arange(3)[:, None], np.arange(120)[None, :], peak] += 3.0
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    lens = torch.tensor([120, 77, 1], dtype=torch.int32)
    cpu = _beam_search_full(lp, lens, beam, 0, -12.0, -1.2, 120)
    gpu = [t.cpu() for t in _beam_search_full(lp.cuda(), lens.cuda(), beam, 0, -12.0, -1.2, 120)]
    assert torch.equal(gpu[0], cpu[0]) and torch.equal(gpu[1], cpu[1])
    live = cpu[2] > -1e29
    assert torch.equal(gpu[2] > -1e29, live)
    assert (gpu[2][live] - cpu[2][live]).abs().max().item() <= 1e-4
