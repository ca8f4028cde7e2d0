"""The scan-attribution variants (port of scripts/exp_scan_variants.py).

Each variant is the selective scan (forward) or its adjoint with one
piece of work removed, numerically wrong on purpose, so that a kernel's
time can be attributed piece by piece; `nloop` and `fusedy` are exact
alternative orders of the same arithmetic. The functions follow the
script's kernel bodies (`make_kernel`, `make_bwd_kernel`):

forward (`FWD_VARIANTS`)
    base        the scan (`selective_scan_ref`)
    noexp       da = 1 + dt A
    nosoftplus  dt = delta + delta_bias
    noscan      h_t = dt_t u_t B_t (no recurrence)
    nodbu       h_t = da h_{t-1} + u_t
    noy         y_t = u_t
    fastexp     exp(x) = 2^floor(y) * cubic(y - floor(y)), y = max(x log2e, -120)
    bf16scan    da, dt u B and h in bfloat16
    nloop, fusedy   exact: the scan
adjoint (`BWD_VARIANTS`; see `selective_scan_bwd_variant_ref`)
    base, nloop (exact), noexp, nosoftplus, nofwdscan, norevscan,
    noreduce_n, noreduce_d, nogh

`scan_variant_fwd` / `scan_variant_bwd` send CPU tensors to the plain
versions and CUDA tensors to the Hopper kernels
(`kernels/scan_variants.py`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mamba_asr_torch.ops.selective_scan import selective_scan_ref

# In the order of the variant tags of csrc/selective_scan_{fwd,bwd}.cuh.
FWD_VARIANTS = ("base", "noexp", "nosoftplus", "noscan", "nodbu", "noy",
                "fastexp", "bf16scan", "nloop", "fusedy")
BWD_VARIANTS = ("base", "nloop", "noexp", "nosoftplus", "nofwdscan",
                "norevscan", "noreduce_n", "noreduce_d", "nogh")
EXACT = ("base", "nloop", "fusedy")  # the same function as the scan
# Variants whose Hopper kernel is another variant's: on this card fusedy is
# base by construction (csrc/selective_scan_fwd.cuh), and launches base's.
FWD_SAME_KERNEL = {"fusedy": "base"}
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# The Hopper variants against these plain versions on float32 inputs: the
# forward's out and h_last within (atol, rtol); each adjoint output within
# rtol + a fraction of its largest |value|. As K1 and K2 (exp2 against exp,
# FMA contraction, sums in other orders), except bf16scan (the state rounds
# to bf16 at every step, one ulp is 0.4 %, and the kernel's one-rounding
# bf16 FMA can differ by an ulp from the plain float32-then-bf16) and
# fastexp (the cubic jumps by 0.55 % where the exponent crosses an integer,
# and a one-ulp difference in dt can put the two sides on either side).
FWD_CARD_TOL = {"bf16scan": (2e-2, 2e-2), "fastexp": (1e-2, 1e-2)}
FWD_CARD_TOL_DEFAULT = (2e-4, 2e-4)
BWD_CARD_TOL = (1e-3, 1e-4)


def _check_variant(variant: str, names) -> None:
    if variant not in names:
        raise ValueError(f"unknown variant {variant!r}; one of {names}")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _fast_exp(x: torch.Tensor) -> torch.Tensor:
    """scripts/exp_scan_variants.py:172-181."""
    y = torch.clamp_min(x * LOG2E, -120.0)
    yi = torch.floor(y)
    yf = y - yi
    p = 1.0 + yf * (0.6931471 + yf * (0.2401597 + yf * 0.0558027))
    e = ((yi.to(torch.int32) + 127) << 23).view(torch.float32)
    return e * p


def selective_scan_variant_ref(
    variant: str, u, delta, A, B, C, D, z, delta_bias, h0=None,
    delta_softplus: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward variant `variant`, a sequential float32 loop over time.
    Arguments as `selective_scan_ref` (D, z and delta_bias required).
    Returns (out in u's dtype, the state after step L (B, D, N) float32)."""
    _check_variant(variant, FWD_VARIANTS)
    if variant in EXACT:
        return selective_scan_ref(u, delta, A, B, C, D, z, delta_bias,
                                  delta_softplus, h0, return_last_state=True)
    uf, Af, Bf, Cf = u.float(), A.float(), B.float(), C.float()
    dt = delta.float() + delta_bias.float()
    if delta_softplus and variant != "nosoftplus":
        dt = _softplus(dt)
    bsz, length, d_in = u.shape
    h = (torch.zeros(bsz, d_in, A.shape[1], dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    bf16 = torch.bfloat16
    ys = []
    for t in range(length):
        x = dt[:, t, :, None] * Af
        if variant == "noexp":
            da = 1.0 + x
        elif variant == "fastexp":
            da = _fast_exp(x)
        else:
            da = torch.exp(x)
        if variant == "nodbu":
            dbu = uf[:, t, :, None].expand_as(da)
        else:
            dbu = (dt[:, t] * uf[:, t])[:, :, None] * Bf[:, t, None, :]
        if variant == "noscan":
            h = dbu
        elif variant == "bf16scan":
            h = (da.to(bf16).float() * h.to(bf16).float()
                 + dbu.to(bf16).float()).to(bf16).float()
        else:
            h = da * h + dbu
        ys.append(uf[:, t] if variant == "noy" else torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + uf * D.float()
    out = (y * F.silu(z.float())).to(u.dtype)
    return out, h


def selective_scan_bwd_variant_ref(
    variant: str, u, delta, A, B, C, D, z, delta_bias, h0,
    h_chunks: Optional[torch.Tensor], dout: torch.Tensor,
    dh_last: Optional[torch.Tensor] = None, delta_softplus: bool = True,
    chunk: int = 32, tiles: int = 1,
) -> Tuple[Optional[torch.Tensor], ...]:
    """Adjoint variant `variant`, a float32 loop over chunks of `chunk`
    steps, each recomputed forward from its start state and walked back,
    as the kernels do. The start state of chunk c is h_chunks[:, c - 1]
    (zeros when h_chunks is None) and of chunk 0 h0 (zeros when None): with
    the forward's own chunk states the base variant is the true adjoint,
    with zeros it is the TPU script's timing harness (`run_bwd_variant`).
    L is padded to a multiple of `chunk` with identity steps (dt = 0,
    dout = 0). `tiles` is the number of channel tiles whose dB, dC
    partials are summed (it matters for noreduce_d only).

    With dy = dout silu(z), a_t = exp2(dt_t A log2e):
        h_t = a_t h_{t-1} + dt_t u_t B_t        nofwdscan: h_t = dt_t u_t B_t
        g_t = dy_t C_t + a_{t+1} g_{t+1}        norevscan: g_t = dy_t C_t
              (+ the carry a_{t0} g_{t0} of the next chunk at a chunk's last step)
        gh_t = g_t a_t h_{t-1}                  nogh: gh_t = g_t
        du = dt <g, B> + D dy,  ddelta = (u <g, B> + <gh, A>) dsoftplus
        dz = dout (<h, C> + D u) silu'(z)
        noreduce_n: <g, B> -> g_0, <gh, A> -> gh_0 ln 2, <h, C> -> h_0
        dB_t = sum_d g dt u,  dC_t = sum_d h dy     noreduce_d: tiles B_t, tiles C_t
        dA = sum gh dt,  dD = sum dy u,  ddelta_bias = sum ddelta,  dh0 = the carry
        noexp: a_t = 1 + dt_t A log2e;  nosoftplus: dt = delta + bias, dsoftplus = 1
    Returns (du, ddelta, dA, dB, dC, dD, dz, ddelta_bias, dh0) as
    `selective_scan_bwd_ref` (dh0 None without h0)."""
    _check_variant(variant, BWD_VARIANTS)
    bsz, length, d_in = u.shape
    n = A.shape[1]
    n_chunks = -(-length // chunk)
    pad = n_chunks * chunk - length
    dev = u.device

    def padded(x):
        return F.pad(x.float(), (0, 0, 0, pad))

    raw = delta.float() + delta_bias.float()
    if delta_softplus and variant != "nosoftplus":
        dt, dsp = _softplus(raw), torch.sigmoid(raw)
    else:
        dt, dsp = raw, torch.ones_like(raw)
    zf, go, uf = z.float(), dout.float(), u.float()
    sig = torch.sigmoid(zf)
    dy, dzf = go * zf * sig, go * sig * (1.0 + zf * (1.0 - sig))
    dt, dsp, dy, dzf, uf, Bf, Cf = (padded(x) for x in (dt, dsp, dy, dzf, uf, B, C))
    Af, Dv = A.float(), D.float()
    a2 = Af * LOG2E

    def discretize(dt_t):
        x = dt_t[:, :, None] * a2
        return 1.0 + x if variant == "noexp" else torch.exp2(x)

    zeros = torch.zeros(bsz, d_in, n, dtype=torch.float32, device=dev)
    g = zeros if dh_last is None else dh_last.float()
    du, ddt, dz = (torch.zeros_like(dt) for _ in range(3))
    dB, dC = torch.zeros_like(Bf), torch.zeros_like(Cf)
    dA = torch.zeros_like(Af)
    for c in reversed(range(n_chunks)):
        t0 = c * chunk
        if c == 0:
            h_start = zeros if h0 is None else h0.float()
        else:
            h_start = zeros if h_chunks is None else h_chunks[:, c - 1].float()
        hs, h = [], h_start
        for t in range(t0, t0 + chunk):
            dbu = (dt[:, t] * uf[:, t])[:, :, None] * Bf[:, t, None, :]
            h = dbu if variant == "nofwdscan" else discretize(dt[:, t]) * h + dbu
            hs.append(h)
        g_carry = g
        for i in reversed(range(chunk)):
            t = t0 + i
            da = discretize(dt[:, t])
            h_prev = hs[i - 1] if i > 0 else h_start
            dyc = dy[:, t, :, None] * Cf[:, t, None, :]
            if variant == "norevscan":
                g = dyc + g_carry if i == chunk - 1 else dyc
            else:
                g = g + dyc
            gh = g if variant == "nogh" else g * da * h_prev
            dA = dA + torch.einsum("bdn,bd->dn", gh, dt[:, t])
            if variant == "noreduce_n":
                s1, s2, yp = g[..., 0], gh[..., 0] * LN2, hs[i][..., 0]
            else:
                s1 = torch.einsum("bdn,bn->bd", g, Bf[:, t])
                s2 = torch.einsum("bdn,dn->bd", gh, Af)
                yp = torch.einsum("bdn,bn->bd", hs[i], Cf[:, t])
            du[:, t] = s1 * dt[:, t] + dy[:, t] * Dv
            ddt[:, t] = (s1 * uf[:, t] + s2) * dsp[:, t]
            dz[:, t] = dzf[:, t] * (yp + Dv * uf[:, t])
            if variant == "noreduce_d":
                dB[:, t], dC[:, t] = tiles * Bf[:, t], tiles * Cf[:, t]
            else:
                dB[:, t] = torch.einsum("bdn,bd->bn", g, dt[:, t] * uf[:, t])
                dC[:, t] = torch.einsum("bdn,bd->bn", hs[i], dy[:, t])
            if variant != "norevscan" or i == 0:
                g = g * da
    du, ddt, dz, dB, dC = (x[:, :length] for x in (du, ddt, dz, dB, dC))
    dD = (dy[:, :length] * uf[:, :length]).sum((0, 1))
    return (
        du.to(u.dtype), ddt.to(delta.dtype), dA, dB.to(B.dtype), dC.to(C.dtype),
        dD, dz.to(z.dtype), ddt.sum((0, 1)), None if h0 is None else g,
    )


def scan_variant_fwd(variant: str, **inputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """CPU tensors -> `selective_scan_variant_ref`; CUDA tensors -> the
    kernel. Returns (out, h_last)."""
    dev = inputs["u"].device
    if dev.type == "cpu":
        return selective_scan_variant_ref(variant, **inputs)
    if dev.type == "cuda":
        from mamba_asr_torch.kernels import scan_variants as kernel

        return kernel.scan_variant_fwd(variant, **inputs)
    raise ValueError(f"no scan variant for device {dev}")


def scan_variant_bwd(variant: str, **inputs) -> Tuple[Optional[torch.Tensor], ...]:
    """CPU tensors -> `selective_scan_bwd_variant_ref` with the kernels'
    chunk and channel tiles; CUDA tensors -> the kernel. `inputs` are
    those of `kernels.scan_variants.scan_variant_bwd`."""
    dev = inputs["u"].device
    if dev.type == "cpu":
        from mamba_asr_torch.kernels.selective_scan import BWD_CHANNELS, CHUNK

        tiles = -(-inputs["u"].shape[2] // BWD_CHANNELS)
        return selective_scan_bwd_variant_ref(variant, **inputs, chunk=CHUNK, tiles=tiles)
    if dev.type == "cuda":
        from mamba_asr_torch.kernels import scan_variants as kernel

        return kernel.scan_variant_bwd(variant, **inputs)
    raise ValueError(f"no scan variant for device {dev}")


def variant_inputs(bsz: int, length: int, d: int, n: int, dtype: torch.dtype,
                   seed: int, device) -> Dict[str, torch.Tensor]:
    """Scan inputs from a numpy seed on which every variant stays finite:
    delta + delta_bias > 0 (so nosoftplus's raw dt is a step forward) and
    |dt A log2e| < 2 after the softplus (so noexp's 1 + dt A, and the
    adjoint's 1 + dt A log2e, keep |da| < 1).
    The script's inputs (A = -exp(N(0, 1)), delta ~ N(0, 0.09)) make both
    overflow within a few hundred steps. A (D, N), D and delta_bias
    float32; the rest in `dtype`; dout for the adjoint, N(0, 1)."""
    rng = np.random.default_rng(seed)

    def arr(x, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device=device, dtype=dt)

    f32 = torch.float32
    return dict(
        u=arr(rng.normal(size=(bsz, length, d)) * 0.5),
        delta=arr(rng.uniform(0.05, 0.3, (bsz, length, d))),
        A=arr(-rng.uniform(0.1, 1.5, (d, n)), f32),
        B=arr(rng.normal(size=(bsz, length, n))),
        C=arr(rng.normal(size=(bsz, length, n))),
        D=arr(rng.normal(size=(d,)), f32),
        z=arr(rng.normal(size=(bsz, length, d))),
        delta_bias=arr(rng.uniform(0.0, 0.05, (d,)), f32),
    )


def variant_dout(inputs, seed: int) -> torch.Tensor:
    """A cotangent of out, N(0, 1) from a numpy seed, in u's dtype."""
    u = inputs["u"]
    x = np.random.default_rng(seed).normal(size=tuple(u.shape)).astype(np.float32)
    return torch.from_numpy(x).to(device=u.device, dtype=u.dtype)

