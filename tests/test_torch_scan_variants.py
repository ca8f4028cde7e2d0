"""The plain scan-attribution variants (mamba_asr_torch/ops/scan_variants.py)
against the JAX variant bodies of scripts/exp_scan_variants.py.

The script is imported by path, unedited; its `make_kernel` and
`make_bwd_kernel` run through `pl.pallas_call(..., interpret=True)`,
built as `run_variant`'s and `run_bwd_variant`'s `impl` build them (zero
start state in every chunk for the adjoint, the timing harness's choice).
B1, L 128 (two of the TPU kernel's 64-step chunks, so the carried state is
crossed), D 128, N 4, float32. The inputs keep every variant finite
(`variant_inputs`).

Tolerances:
- forward 2e-5 (the JAX suite's fp32 tolerance, tests/test_selective_scan.py):
  the TPU kernel scans each chunk in two levels, the plain loop step by step;
- adjoint 3e-4 (the JAX suite's gradient tolerance), relative to each
  output's largest value: sums over n and d in other orders;
- bf16scan 2e-2: the scan rounds to bfloat16 at every operation in JAX and
  once per step in the plain loop.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from mamba_asr_torch.ops import scan_variants as sv

REPO = Path(__file__).resolve().parents[1]
SHAPE = dict(bsz=1, length=128, d=128, n=4)
TPU_CHUNK = 64  # mamba_asr_tpu/ops/pallas/scan.py:L_CHUNK
FWD_TOL = 2e-5
BWD_TOL = 3e-4
BF16_TOL = 2e-2

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _script():
    spec = importlib.util.spec_from_file_location(
        "exp_scan_variants", REPO / "scripts" / "exp_scan_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _inputs():
    t = sv.variant_inputs(**SHAPE, dtype=torch.float32, seed=4, device="cpu")
    t["dout"] = sv.variant_dout(t, 5)
    return t


def _np(t):
    return {k: v.numpy() for k, v in t.items()}


def _jax_fwd(variant, x):
    """run_variant's impl (scripts/exp_scan_variants.py:269-308), in
    interpret mode, returning (out, h_last)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    m = _script()
    u, delta, z = (jnp.asarray(x[k]) for k in ("u", "delta", "z"))
    A, B, C, D, dtb = (jnp.asarray(x[k]) for k in ("A", "B", "C", "D", "delta_bias"))
    bsz, length, d_in = u.shape
    n = A.shape[1]
    lp = m._round_up(length, m.L_CHUNK)
    d_tile = m._d_tile(d_in, n)
    dp = m._round_up(d_in, d_tile)

    def pad_ld(v):
        return jnp.pad(v, ((0, 0), (0, lp - length), (0, dp - d_in)))

    dtb_p = jnp.pad(dtb, (0, dp - d_in))[None, :]
    delta_p = m._pad_delta_identity(delta, dtb_p, length, lp, dp, True)
    b_p = jnp.pad(B, ((0, 0), (0, lp - length), (0, 0)))
    c_p = jnp.pad(C, ((0, 0), (0, lp - length), (0, 0)))
    a_t = jnp.pad(A.T, ((0, 0), (0, dp - d_in)))
    dsk = jnp.pad(D, (0, dp - d_in))[None, :]
    h0_t = jnp.zeros((bsz, n, dp), jnp.float32)
    lc = m.L_CHUNK
    out, h_last = pl.pallas_call(
        m.make_kernel(variant, n, lc),
        grid=(bsz, dp // d_tile, lp // lc),
        in_specs=[
            pl.BlockSpec((1, lc, d_tile), lambda b, d, l: (b, l, d)),
            pl.BlockSpec((1, lc, d_tile), lambda b, d, l: (b, l, d)),
            pl.BlockSpec((1, lc, n), lambda b, d, l: (b, l, 0)),
            pl.BlockSpec((1, lc, n), lambda b, d, l: (b, l, 0)),
            pl.BlockSpec((n, d_tile), lambda b, d, l: (0, d)),
            pl.BlockSpec((1, d_tile), lambda b, d, l: (0, d)),
            pl.BlockSpec((1, d_tile), lambda b, d, l: (0, d)),
            pl.BlockSpec((1, lc, d_tile), lambda b, d, l: (b, l, d)),
            pl.BlockSpec((1, n, d_tile), lambda b, d, l: (b, 0, d)),
        ],
        out_specs=(
            pl.BlockSpec((1, lc, d_tile), lambda b, d, l: (b, l, d)),
            pl.BlockSpec((1, n, d_tile), lambda b, d, l: (b, 0, d)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((bsz, lp, dp), u.dtype),
            jax.ShapeDtypeStruct((bsz, n, dp), jnp.float32),
        ),
        scratch_shapes=[pltpu.VMEM((n, d_tile), jnp.float32)],
        interpret=True,
    )(pad_ld(u), delta_p, b_p, c_p, a_t, dtb_p, dsk, pad_ld(z), h0_t)
    return (np.asarray(out[:, :length, :d_in]),
            np.asarray(h_last[:, :, :d_in]).transpose(0, 2, 1))


def _jax_bwd(variant, x):
    """run_bwd_variant's impl (scripts/exp_scan_variants.py:581-642), in
    interpret mode, returning every output: du, ddelta, dB and dC summed
    over channel tiles, dz, dA summed over rows (D, N), dh0 (B, D, N)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from mamba_asr_tpu.ops.pallas.scan import LOG2E

    m = _script()
    u, delta, z, dout = (jnp.asarray(x[k]) for k in ("u", "delta", "z", "dout"))
    A, B, C, D, dtb = (jnp.asarray(x[k]) for k in ("A", "B", "C", "D", "delta_bias"))
    bsz, length, d_in = u.shape
    n = A.shape[1]
    lp = m._round_up(length, m.L_CHUNK)
    d_tile = m._d_tile(d_in, n)
    dp = m._round_up(d_in, d_tile)
    lc = m.L_CHUNK
    nl = lp // lc

    def pad_ld(v):
        return jnp.pad(v, ((0, 0), (0, lp - length), (0, dp - d_in)))

    dtb_p = jnp.pad(dtb, (0, dp - d_in))[None, :]
    delta_p = m._pad_delta_identity(delta, dtb_p, length, lp, dp, True)
    b_p = jnp.pad(B, ((0, 0), (0, lp - length), (0, 0)))
    c_p = jnp.pad(C, ((0, 0), (0, lp - length), (0, 0)))
    a_t = jnp.pad(A.T * LOG2E, ((0, 0), (0, dp - d_in)))
    dsk = jnp.pad(D, (0, dp - d_in))[None, :]
    h_starts = jnp.zeros((bsz, nl, n, dp), jnp.float32)
    dhl_t = jnp.zeros((bsz, n, dp), jnp.float32)
    rev = lambda b, d, l: (b, nl - 1 - l, d)  # noqa: E731
    rev_n = lambda b, d, l: (b, nl - 1 - l, 0)  # noqa: E731
    outs = pl.pallas_call(
        m.make_bwd_kernel(variant, n, lc),
        grid=(bsz, dp // d_tile, nl),
        in_specs=[
            pl.BlockSpec((1, lc, d_tile), rev),
            pl.BlockSpec((1, lc, d_tile), rev),
            pl.BlockSpec((1, lc, n), rev_n),
            pl.BlockSpec((1, lc, n), rev_n),
            pl.BlockSpec((n, d_tile), lambda b, d, l: (0, d)),
            pl.BlockSpec((1, d_tile), lambda b, d, l: (0, d)),
            pl.BlockSpec((1, d_tile), lambda b, d, l: (0, d)),
            pl.BlockSpec((1, lc, d_tile), rev),
            pl.BlockSpec((1, lc, d_tile), rev),
            pl.BlockSpec((1, 1, n, d_tile), lambda b, d, l: (b, nl - 1 - l, 0, d)),
            pl.BlockSpec((1, n, d_tile), lambda b, d, l: (b, 0, d)),
        ],
        out_specs=(
            pl.BlockSpec((1, lc, d_tile), rev),
            pl.BlockSpec((1, lc, d_tile), rev),
            pl.BlockSpec((1, 1, lc, n), lambda b, d, l: (d, b, nl - 1 - l, 0)),
            pl.BlockSpec((1, 1, lc, n), lambda b, d, l: (d, b, nl - 1 - l, 0)),
            pl.BlockSpec((1, lc, d_tile), rev),
            pl.BlockSpec((1, n, d_tile), lambda b, d, l: (b, 0, d)),
            pl.BlockSpec((1, n, d_tile), lambda b, d, l: (b, 0, d)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((bsz, lp, dp), jnp.float32),
            jax.ShapeDtypeStruct((bsz, lp, dp), jnp.float32),
            jax.ShapeDtypeStruct((dp // d_tile, bsz, lp, n), jnp.float32),
            jax.ShapeDtypeStruct((dp // d_tile, bsz, lp, n), jnp.float32),
            jax.ShapeDtypeStruct((bsz, lp, dp), jnp.float32),
            jax.ShapeDtypeStruct((bsz, n, dp), jnp.float32),
            jax.ShapeDtypeStruct((bsz, n, dp), jnp.float32),
        ),
        scratch_shapes=[pltpu.VMEM((n, d_tile), jnp.float32)],
        interpret=True,
    )(pad_ld(u), delta_p, b_p, c_p, a_t, dtb_p, dsk, pad_ld(z), pad_ld(dout),
      h_starts, dhl_t)
    du, ddt, dbm, dcm, dz, dapart, dh0 = (np.asarray(o) for o in outs)
    return {
        "du": du[:, :length, :d_in], "ddelta": ddt[:, :length, :d_in],
        "dB": dbm.sum(0)[:, :length], "dC": dcm.sum(0)[:, :length],
        "dz": dz[:, :length, :d_in], "dA": dapart.sum(0)[:, :d_in].T,
        "dh0": dh0[:, :, :d_in].transpose(0, 2, 1),
    }, dp // d_tile


def _close(name, got, ref, tol, scale_by_max=False):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert np.isfinite(ref).all() and np.isfinite(got).all(), name
    atol = tol * np.abs(ref).max() if scale_by_max else tol
    np.testing.assert_allclose(got, ref, rtol=tol, atol=atol, err_msg=name)


@pytest.mark.parametrize("variant", sv.FWD_VARIANTS)
def test_plain_fwd_variant_matches_the_jax_body(variant):
    x = _inputs()
    ref_out, ref_h = _jax_fwd(variant, _np(x))
    args = {k: v for k, v in x.items() if k != "dout"}
    out, h_last = sv.selective_scan_variant_ref(variant, **args)
    tol = BF16_TOL if variant == "bf16scan" else FWD_TOL
    _close(f"{variant} out", out.numpy(), ref_out, tol)
    _close(f"{variant} h_last", h_last.numpy(), ref_h, tol)


@pytest.mark.parametrize("variant", sv.BWD_VARIANTS)
def test_plain_bwd_variant_matches_the_jax_body(variant):
    x = _inputs()
    ref, tiles = _jax_bwd(variant, _np(x))
    args = {k: v for k, v in x.items() if k != "dout"}
    h0 = torch.zeros(1, SHAPE["d"], SHAPE["n"])
    got = sv.selective_scan_bwd_variant_ref(
        variant, **args, h0=h0, h_chunks=None, dout=x["dout"], chunk=TPU_CHUNK,
        tiles=tiles)
    named = dict(zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "ddelta_bias", "dh0"),
                     got))
    for key, want in ref.items():
        _close(f"{variant} {key}", named[key].numpy(), want, BWD_TOL, scale_by_max=True)


def test_the_chunk_and_the_start_states_are_what_the_adjoint_variants_depend_on():
    """With zero start states the base adjoint depends on the chunk (the
    harness); with the forward's own chunk states it is the true adjoint
    (selective_scan_bwd_ref) at any chunk."""
    from mamba_asr_torch.ops.selective_scan import selective_scan_bwd_ref, selective_scan_ref

    x = _inputs()
    args = {k: v[:, :70] if v.dim() == 3 else v for k, v in x.items() if k != "dout"}
    dout = x["dout"][:, :70]
    ref = selective_scan_bwd_ref(*(args[k] for k in ("u", "delta", "A", "B", "C", "D", "z",
                                                      "delta_bias")), True, None, dout)
    for chunk in (32, 64):
        states = torch.stack([
            selective_scan_ref(**{k: v[:, :end] if v.dim() == 3 else v
                                  for k, v in args.items()},
                               delta_softplus=True, return_last_state=True)[1]
            for end in range(chunk, 70 + chunk, chunk)], 1)
        got = sv.selective_scan_bwd_variant_ref("base", **args, h0=None, h_chunks=states,
                                                dout=dout, chunk=chunk)
        for g, r in zip(got[:8], ref[:8]):
            _close(f"chunk {chunk}", g.numpy(), r.numpy(), BWD_TOL, scale_by_max=True)
    harness = [sv.selective_scan_bwd_variant_ref("base", **args, h0=None, h_chunks=None,
                                                 dout=dout, chunk=c)[1] for c in (32, 64)]
    assert not torch.allclose(harness[0], harness[1])


def test_dispatch_on_cpu_takes_the_plain_versions():
    x = _inputs()
    args = {k: v for k, v in x.items() if k != "dout"}
    out, h_last = sv.scan_variant_fwd("noy", **args)
    ref = sv.selective_scan_variant_ref("noy", **args)
    assert torch.equal(out, ref[0]) and torch.equal(h_last, ref[1])
    got = sv.scan_variant_bwd("noreduce_d", **args, h0=None, h_chunks=None, dout=x["dout"],
                              dh_last=None)
    # 128 channels: 16 channels per K2 block at any N, 8 tiles.
    torch.testing.assert_close(got[3], 8 * x["B"])
    with pytest.raises(ValueError, match="unknown variant"):
        sv.scan_variant_fwd("nosuch", **args)
