"""The PyTorch port's ops against the JAX package's, on the CPU.

Each test builds its inputs with numpy from a seed, runs the JAX function
and its counterpart in mamba_asr_torch, and holds them to the stated
tolerance. The kernel against its plain version is in
test_torch_kernels.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.decoding import ctc_greedy as jax_greedy
from mamba_asr_tpu.ops.causal_conv1d import causal_conv1d as jax_causal_conv1d
from mamba_asr_tpu.ops import fbank as jax_fbank
from mamba_asr_tpu.ops.selective_scan import selective_scan_ref as jax_scan_ref
from mamba_asr_tpu.ops.pallas.scan import _pallas_fwd_impl
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
