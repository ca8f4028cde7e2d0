"""The PyTorch port's ops against the JAX package's, on the CPU.

Each test builds its inputs with numpy from a seed, runs the JAX function
and its counterpart in mamba_asr_torch, and holds them to the stated
tolerance. The kernel against its plain version is in
test_torch_kernels.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.decoding import ctc_greedy as jax_greedy
from mamba_asr_tpu.ops.causal_conv1d import causal_conv1d as jax_causal_conv1d
from mamba_asr_tpu.ops import fbank as jax_fbank
from mamba_asr_tpu.ops.selective_scan import selective_scan_ref as jax_scan_ref
from mamba_asr_tpu.ops.pallas.scan import _pallas_fwd_impl, selective_scan_bwd_pallas
from mamba_asr_tpu.training import normalizer as jax_norm

from mamba_asr_torch.decoding import ctc_greedy
from mamba_asr_torch.ops import causal_conv1d, fbank, selective_scan
from mamba_asr_torch.training import normalizer
from tests.test_torch_kernels import scan_inputs as _scan_inputs

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("n_fft", [400, 512])
@pytest.mark.parametrize("center", [True, False])
def test_log_mel_matches_jax(n_fft, center):
    """Hamming (symmetric) DFT, power, HTK mel, log, top_db floor. 2e-3 dB
    absolute: fp32 sums of 400 products in two orders, on values up to
    ~50 dB."""
    rng = np.random.default_rng(0)
    wav = rng.normal(0.0, 0.1, size=(2, 3210)).astype(np.float32)
    wav[1, 2000:] = 0.0  # a padded row: top_db takes its max over the row
    ref = jax_fbank.log_mel_spectrogram(jnp.asarray(wav), n_fft=n_fft,
                                        n_mels=20, center=center)
    out = fbank.log_mel_spectrogram(_t(wav), n_fft=n_fft, n_mels=20,
                                    center=center)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=0, atol=2e-3)
    np.testing.assert_array_equal(
        fbank.mel_filterbank(20, n_fft).numpy(),
        _np(jax_fbank.mel_filterbank(20, n_fft)),
    )


def test_causal_conv1d_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 11, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    for bias in (None, b):
        ref = jax_causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                None if bias is None else jnp.asarray(bias))
        out = causal_conv1d.causal_conv1d(_t(x), _t(w),
                                          None if bias is None else _t(bias))
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=2e-5, atol=2e-5)


def _as(inputs, conv):
    return {k: conv(v) for k, v in inputs.items()}


def test_selective_scan_ref_matches_jax_ref():
    """The plain scan against JAX selective_scan_ref, 2e-5, with h0 in and
    the last state out."""
    inp = _scan_inputs(2)
    h0 = np.random.default_rng(3).normal(size=(2, 8, 4)).astype(np.float32)
    ref, h_ref = jax_scan_ref(
        **_as(inp, jnp.asarray), delta_softplus=True, h0=jnp.asarray(h0),
        return_last_state=True,
    )
    out, h_last = selective_scan.selective_scan_ref(
        **_as(inp, _t), delta_softplus=True, h0=_t(h0), return_last_state=True,
    )
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(h_last.numpy(), _np(h_ref), rtol=2e-5, atol=2e-5)


def test_selective_scan_ref_matches_pallas_interpret():
    """The plain scan against the Pallas kernel (interpret mode) at the
    shapes of tests/test_selective_scan.py, 2e-4 (the kernel's two-level
    chunk scan sums in another order)."""
    inp = _scan_inputs(9, length=150, d=12)
    out_k, h_k = _pallas_fwd_impl(
        *(jnp.asarray(inp[k]) for k in ("u", "delta", "A", "B", "C", "D", "z",
                                        "delta_bias")),
        True, interpret=True,
    )
    out, h_last = selective_scan.selective_scan(
        **_as(inp, _t), delta_softplus=True, return_last_state=True
    )
    np.testing.assert_allclose(out.numpy(), _np(out_k), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h_last.numpy(), _np(h_k), rtol=2e-4, atol=2e-4)


def test_selective_scan_h0_chaining_matches_pallas_interpret():
    """Two half-length plain scans chained through h0 == one full Pallas
    kernel call (2e-4)."""
    inp = _scan_inputs(21, length=160, d=12)
    full, h_full = _pallas_fwd_impl(
        *(jnp.asarray(inp[k]) for k in ("u", "delta", "A", "B", "C", "D", "z",
                                        "delta_bias")),
        True, interpret=True,
    )
    half = 70
    t = _as(inp, _t)
    per_t = ("u", "delta", "B", "C", "z")

    def part(sl, h0=None):
        args = {k: (v[:, sl] if k in per_t else v) for k, v in t.items()}
        return selective_scan.selective_scan(
            **args, delta_softplus=True, h0=h0, return_last_state=True
        )

    o1, h1 = part(slice(None, half))
    o2, h2 = part(slice(half, None), h1)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), _np(full),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h2.numpy(), _np(h_full), rtol=2e-4, atol=2e-4)


def test_selective_scan_dispatch_refuses_other_devices():
    u = torch.zeros(1, 2, 3, device="meta")
    with pytest.raises(ValueError, match="no selective scan"):
        selective_scan.selective_scan(u, u, torch.zeros(3, 2), u, u)


@pytest.mark.parametrize("count", [0.0, 57.0])
def test_apply_normalizer_matches_jax(count):
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(2, 9, 5)).astype(np.float32)
    mean = rng.normal(size=(5,)).astype(np.float32)
    m2 = rng.uniform(1.0, 9.0, size=(5,)).astype(np.float32)
    ref = jax_norm.apply_normalizer(
        jax_norm.NormalizerState(jnp.float32(count), jnp.asarray(mean),
                                 jnp.asarray(m2)),
        jnp.asarray(feats),
    )
    out = normalizer.apply_normalizer(
        normalizer.NormalizerState.from_arrays(count, mean, m2), _t(feats)
    )
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-6, atol=1e-6)


def test_ctc_greedy_matches_jax():
    """Token ids and lengths exact, with repeats, blanks and padding."""
    rng = np.random.default_rng(5)
    best = rng.integers(0, 4, size=(3, 17)).astype(np.int32)
    lp = np.log(rng.dirichlet(np.ones(6), size=(3, 17))).astype(np.float32)
    lens = np.array([17, 9, 1], np.int32)
    for fn, arg in ((jax_greedy.ctc_greedy_collapse, best),
                    (jax_greedy.ctc_greedy_decode, lp)):
        toks_ref, lens_ref = fn(jnp.asarray(arg), jnp.asarray(lens))
        toks, n = getattr(ctc_greedy, fn.__name__)(_t(arg), _t(lens))
        np.testing.assert_array_equal(toks.numpy(), _np(toks_ref))
        np.testing.assert_array_equal(n.numpy(), _np(lens_ref))
        assert ctc_greedy.tokens_to_lists(toks.numpy(), n.numpy()) == \
            jax_greedy.tokens_to_lists(_np(toks_ref), _np(lens_ref))


SCAN_ARGS = ("u", "delta", "A", "B", "C", "D", "z", "delta_bias", "h0")
PER_STEP = ("u", "delta", "B", "C", "z")


def _adjoint_case(seed, softplus, length=77, d=12, n=4, bsz=2):
    """Scan inputs with h0 and both cotangents. Without softplus dt stays
    positive (negative dt with A < 0 compounds to inf over the sequence,
    as the JAX suite notes)."""
    inp = _scan_inputs(seed, bsz=bsz, length=length, d=d, n=n)
    rng = np.random.default_rng(seed + 100)
    if not softplus:
        inp["delta"] = (np.abs(inp["delta"]) * 0.1 + 1.05).astype(np.float32)
    inp["h0"] = rng.normal(size=(bsz, d, n)).astype(np.float32)
    dout = rng.normal(size=(bsz, length, d)).astype(np.float32)
    dhl = rng.normal(size=(bsz, d, n)).astype(np.float32)
    return inp, dout, dhl


@pytest.mark.parametrize("softplus", [True, False])
@pytest.mark.parametrize("dtype,tol", [("float32", (3e-4, 3e-5)), ("bfloat16", (2e-2, 2e-2))])
def test_selective_scan_bwd_ref_matches_pallas_adjoint(softplus, dtype, tol):
    """The plain adjoint against the Pallas adjoint (interpret mode) with
    h0 in and a d(h_last) cotangent, L 77 (not a multiple of the 64-step
    chunk) and D 12 (not a multiple of 128). fp32 at the JAX suite's
    rtol 3e-4 / atol 3e-5; bf16 inputs at 2e-2 (both sides compute in
    fp32 and round du, ddelta, dB, dC, dz to bf16)."""
    inp, dout, dhl = _adjoint_case(11, softplus)
    jdt = getattr(jnp, dtype)
    jin = {k: jnp.asarray(v, jdt if k in PER_STEP else jnp.float32) for k, v in inp.items()}
    ref = selective_scan_bwd_pallas(
        tuple(jin[k] for k in SCAN_ARGS), (jnp.asarray(dout, jdt), jnp.asarray(dhl)),
        delta_softplus=softplus, interpret=True,
    )
    tin = {k: _t(np.asarray(v, np.float32)).to(getattr(torch, dtype))
           if k in PER_STEP else _t(v) for k, v in inp.items()}
    got = selective_scan.selective_scan_bwd_ref(
        *(tin[k] for k in SCAN_ARGS[:8]), softplus, tin["h0"],
        _t(dout).to(getattr(torch, dtype)), _t(dhl),
    )
    for name, r, g in zip(SCAN_ARGS, ref, got):
        assert g.dtype == tin[name].dtype, name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32),
                                   rtol=tol[0], atol=tol[1], err_msg=name)


def test_selective_scan_bwd_ref_matches_jax_grad():
    """The plain adjoint against jax.grad of the JAX selective_scan_ref,
    with h0 and d(h_last): 3e-4 / 3e-5 in fp32."""
    inp, dout, dhl = _adjoint_case(12, True, length=40)

    def loss(*args):
        out, h_last = jax_scan_ref(*args[:8], True, args[8], True)
        return jnp.sum(out * dout) + jnp.sum(h_last * dhl)

    ref = jax.grad(loss, argnums=tuple(range(9)))(
        *(jnp.asarray(inp[k]) for k in SCAN_ARGS))
    got = selective_scan.selective_scan_bwd_ref(
        *(_t(inp[k]) for k in SCAN_ARGS[:8]), True, _t(inp["h0"]), _t(dout), _t(dhl))
    for name, r, g in zip(SCAN_ARGS, ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=3e-4, atol=3e-5,
                                   err_msg=name)


@pytest.mark.parametrize("last_state", [False, True])
def test_selective_scan_fn_matches_autograd_on_cpu(last_state):
    """`selective_scan` with grad (SelectiveScanFn: plain forward, plain
    adjoint) against autograd through `selective_scan_ref`: every input's
    gradient within 3e-4 / 3e-5, each in its input's dtype; absent D and
    delta_bias stay absent."""
    inp, dout, dhl = _adjoint_case(13, True, length=35)
    for drop in ((), ("D", "delta_bias")):
        leaves = {k: (None if k in drop else _t(v).requires_grad_()) for k, v in inp.items()}
        args = [leaves[k] for k in SCAN_ARGS]

        def run(fn):
            res = fn(*args[:8], True, args[8], last_state)
            out, h_last = res if last_state else (res, None)
            loss = (out * _t(dout)).sum()
            if last_state:
                loss = loss + (h_last * _t(dhl)).sum()
            live = [a for a in args if a is not None]
            return out, torch.autograd.grad(loss, live)

        out_ref, g_ref = run(selective_scan.selective_scan_ref)
        out, g = run(selective_scan.selective_scan)
        assert out.grad_fn is not None
        torch.testing.assert_close(out, out_ref, rtol=0, atol=0)
        for a, b in zip(g, g_ref):
            assert a.dtype == b.dtype
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-4, atol=3e-5)


def test_selective_scan_under_no_grad_is_detached():
    inp = {k: _t(v).requires_grad_() for k, v in _scan_inputs(14).items()}
    with torch.no_grad():
        out = selective_scan.selective_scan(**inp, delta_softplus=True)
    assert out.grad_fn is None
    assert selective_scan.selective_scan(**inp, delta_softplus=True).grad_fn is not None
