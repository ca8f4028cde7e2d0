"""A CPU model of K2's decomposition (the selective-scan adjoint), on the CPU.

The kernel itself (`mamba_asr_torch/csrc/selective_scan_bwd.cuh`) runs only
on a card. This model restates, in torch, how it splits the work and
carries state between the pieces, so that a lane, carry or ordering
mistake in the design shows here; the card tests
(`tests/test_torch_kernels.py`) hold the kernel itself.

- Lanes: 8 lanes per channel, lane q holding states n = q + 8 j, j < NS
  (1, 2 or 4: N rounded up to 8, 16 or 32); blocks of 16 channels (the
  Python mirror `kernels/selective_scan.py:BWD_CHANNELS`), 4 channels per
  warp.
- Per chunk of 32 steps from the last: a forward walk from the chunk's
  boundary state keeping the state before each 4-step sub-tile; <h, C> of
  8 steps as a reduce-scatter across the channel's 8 lanes; then, sub-tile
  by sub-tile from the last, a_t and a_t h_{t-1} recomputed from the kept
  state and the reverse walk, g carried across sub-tiles and chunks, <g, B>
  and <g a h, A> of 4 steps as one reduce-scatter of 8 values.
- Sums over channels: 4 values per lane reduce-scattered across the
  warp's 4 channels, the 4 warps added in order, one partial per channel
  tile (summed over tiles as the wrapper does); dD and ddelta_bias per
  staging thread, then the 8 threads of a channel in order.

Held against `selective_scan_bwd_ref` in float32 within 3e-4 of each
gradient's largest value (sums in other orders), at ragged L, D not a
multiple of the channel block, every lane width and with and without h0
and d(h_last). This file imports no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mamba_asr_torch.kernels.selective_scan import BWD_CHANNELS, CHUNK, MAX_D_STATE
from mamba_asr_torch.ops.selective_scan import selective_scan_bwd_ref, selective_scan_ref

torch.set_num_threads(1)

LANES = 8  # lanes per channel (selective_scan_bwd.cuh kLanes)
SUB = 4  # steps per reverse sub-tile and reverse reduce-scatter (kSub)
WARP_CH = 32 // LANES  # channels per warp
WARPS = BWD_CHANNELS // WARP_CH
THREADS = BWD_CHANNELS * LANES
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
TOL = 3e-4  # of each gradient's largest |value|
GRADS = ("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "ddelta_bias", "dh0")


def states_per_lane(n: int) -> int:
    """NS of the kernel's instantiations: 1, 2 or 4 states per lane."""
    return 1 if n <= LANES else 2 if n <= 2 * LANES else 4


def reduce_scatter(v: torch.Tensor) -> torch.Tensor:
    """v (..., 8 lanes, 8 values) -> (..., 8 lanes): lane q gets the sum
    over the lanes of value q, in the kernel's butterfly order."""
    q = torch.arange(LANES)
    off = LANES // 2
    while off >= 1:
        upper = (q & off) != 0
        kept = []
        for j in range(off):
            send = torch.where(upper, v[..., j], v[..., j + off])
            keep = torch.where(upper, v[..., j + off], v[..., j])
            kept.append(keep + send[..., q ^ off])
        v = torch.stack(kept, -1)
        off //= 2
    return v[..., 0]


def channel_reduce_scatter(w: torch.Tensor) -> torch.Tensor:
    """w (..., 4 channels, 8 lanes, 4 values) -> (..., 4 channels, 8 lanes):
    the lane of channel cw gets the sum over the 4 channels of value cw,
    as (v_cw + v_cw^2) + (v_cw^1 + v_cw^3)."""
    cw = torch.arange(WARP_CH)[:, None]
    hi = (cw & 2) != 0
    level = []
    for j in range(2):
        send = torch.where(hi, w[..., j], w[..., j + 2])
        keep = torch.where(hi, w[..., j + 2], w[..., j])
        level.append(keep + send[..., cw[:, 0] ^ 2, :])
    odd = (cw & 1) != 0
    send = torch.where(odd, level[0], level[1])
    keep = torch.where(odd, level[1], level[0])
    return keep + send[..., cw[:, 0] ^ 1, :]


def to_lanes(x: torch.Tensor, ns: int) -> torch.Tensor:
    """(..., N) -> (..., 8, ns) with lane q, slot j holding n = q + 8 j
    (zeros past N)."""
    pad = LANES * ns - x.shape[-1]
    x = torch.nn.functional.pad(x, (0, pad))
    return x.unflatten(-1, (ns, LANES)).transpose(-1, -2)


def from_lanes(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.transpose(-1, -2).flatten(-2)[..., :n]


def channel_sums(vals: list, ns: int, bsz: int, tiles: int) -> torch.Tensor:
    """The dB or dC sums of consecutive steps: vals[s] (B, Dp, 8, ns) for
    the 4 / ns steps of one channel reduce-scatter -> (B, tiles, steps, kN),
    the 4 warps' sums added in order."""
    steps = len(vals)
    w = torch.stack(vals, -2).flatten(-2)  # (B, Dp, 8, 4): value s * ns + j
    w = w.reshape(bsz, tiles, WARPS, WARP_CH, LANES, 4)
    r = channel_reduce_scatter(w)  # (B, tiles, warps, cw, q): value cw
    out = torch.zeros(bsz, tiles, WARPS, steps, LANES * ns)
    for c in range(WARP_CH):
        s, j = c // ns, c % ns
        out[:, :, :, s, j * LANES:(j + 1) * LANES] = r[:, :, :, c]
    total = out[:, :, 0]
    for wi in range(1, WARPS):
        total = total + out[:, :, wi]
    return total


def k2_model(u, delta, A, B, C, D, z, delta_bias, h0, dout, dh_last, h_chunks):
    """K2's decomposition in torch, float32, softplus on. Returns the
    wrapper's (du, ddelta, dA, dB, dC, dD, dz, ddelta_bias, dh0)."""
    bsz, length, d_in = u.shape
    n = A.shape[1]
    ns = states_per_lane(n)
    kn = LANES * ns
    tiles = -(-d_in // BWD_CHANNELS)
    dp = tiles * BWD_CHANNELS
    chunks = -(-length // CHUNK)
    lp = chunks * CHUNK

    def pad_ld(x):  # (B, L, D) -> (B, Lp, Dp): identity steps and channels
        return torch.nn.functional.pad(x, (0, dp - d_in, 0, lp - length))

    # Staging: the per-(row, channel, step) values.
    raw = delta + delta_bias
    e = torch.exp(-raw.abs())
    dt = pad_ld(raw.clamp_min(0) + torch.log1p(e))
    dsp = pad_ld(torch.where(raw >= 0, 1 / (1 + e), e / (1 + e)))
    sig = torch.sigmoid(z)
    dy = pad_ld(dout * z * sig)
    dzf = pad_ld(dout * sig * (1 + z * (1 - sig)))
    uu = pad_ld(u)
    dtu = dt * uu
    bl = to_lanes(torch.nn.functional.pad(B, (0, 0, 0, lp - length)), ns)  # (B, Lp, 8, ns)
    cl = to_lanes(torch.nn.functional.pad(C, (0, 0, 0, lp - length)), ns)
    a2 = to_lanes(torch.nn.functional.pad(A, (0, 0, 0, dp - d_in)) * LOG2E, ns)  # (Dp, 8, ns)
    state = torch.zeros(bsz, d_in, n)

    def lanes_state(x):  # (B, D, N) -> (B, Dp, 8, ns)
        return to_lanes(torch.nn.functional.pad(x, (0, 0, 0, dp - d_in)), ns)

    g = lanes_state(dh_last if dh_last is not None else state)
    dA = torch.zeros_like(g)
    yp, s1, s2 = (torch.zeros(bsz, lp, dp) for _ in range(3))
    dB_part = torch.zeros(bsz, tiles, lp, kn)
    dC_part = torch.zeros(bsz, tiles, lp, kn)
    cstep = 4 // ns

    def step_in(t):  # per-channel values at step t, broadcast over the lanes
        return (dt[:, t, :, None, None], dtu[:, t, :, None, None], dy[:, t, :, None, None],
                bl[:, t, None], cl[:, t, None])

    for c in reversed(range(chunks)):
        t0 = c * CHUNK
        if c > 0:
            h = lanes_state(h_chunks[:, c - 1])
        else:
            h = lanes_state(h0 if h0 is not None else state)
        # Forward: keep the state before each sub-tile and the last
        # sub-tile's a_t, a_t h_{t-1}; <h, C> of 8 steps by reduce-scatter.
        kept, a_last, ah_last, vals, parts = [], [], [], [], []
        for i in range(CHUNK):
            t = t0 + i
            if i % SUB == 0:
                kept.append(h)
            dt_t, dtu_t, dy_t, b_t, c_t = step_in(t)
            a = torch.exp2(dt_t * a2)
            ah = a * h
            h = dtu_t * b_t + ah
            if i >= CHUNK - SUB:
                a_last.append(a)
                ah_last.append(ah)
            p = h[..., 0] * c_t[..., 0]
            for j in range(1, ns):
                p = p + h[..., j] * c_t[..., j]
            parts.append(p)  # (B, Dp, 8)
            vals.append(h * dy_t)
            if (i + 1) % cstep == 0:
                dC_part[:, :, t + 1 - cstep:t + 1] = channel_sums(vals, ns, bsz, tiles)
                vals = []
            if (i + 1) % LANES == 0:
                r = reduce_scatter(torch.stack(parts, -1))  # lane q: step t - 7 + q
                yp[:, t + 1 - LANES:t + 1] = r.transpose(1, 2)
                parts = []
        # Reverse, sub-tile by sub-tile from the last.
        for sub in reversed(range(CHUNK // SUB)):
            i4 = sub * SUB
            if sub == CHUNK // SUB - 1:
                ha, hah = a_last, ah_last
            else:
                ha, hah, hr = [], [], kept[sub]
                for e4 in range(SUB):
                    dt_t, dtu_t, _, b_t, _ = step_in(t0 + i4 + e4)
                    ha.append(torch.exp2(dt_t * a2))
                    hah.append(ha[-1] * hr)
                    hr = dtu_t * b_t + hah[-1]
            v1, v2 = [None] * SUB, [None] * SUB
            vals = []
            for e4 in reversed(range(SUB)):
                i = i4 + e4
                t = t0 + i
                dt_t, dtu_t, dy_t, b_t, c_t = step_in(t)
                g = dy_t * c_t + g
                gdh = g * hah[e4]
                dA = dA + gdh * dt_t
                p1 = g[..., 0] * b_t[..., 0]
                p2 = gdh[..., 0] * a2[..., 0]
                for j in range(1, ns):
                    p1 = p1 + g[..., j] * b_t[..., j]
                    p2 = p2 + gdh[..., j] * a2[..., j]
                v1[e4], v2[e4] = p1, p2
                vals.insert(0, g * dtu_t)
                g = g * ha[e4]
                if i % cstep == 0:
                    dB_part[:, :, t:t + cstep] = channel_sums(vals, ns, bsz, tiles)
                    vals = []
            r = reduce_scatter(torch.stack(v1 + v2, -1))  # lanes 0-3 <g, B>, 4-7 <g a h, A log2e>
            s1[:, t0 + i4:t0 + i4 + SUB] = r[..., :SUB].transpose(1, 2)
            s2[:, t0 + i4:t0 + i4 + SUB] = r[..., SUB:].transpose(1, 2)
    # Epilogue.
    dsk = torch.nn.functional.pad(D, (0, dp - d_in))
    s2 = s2 * LN2
    dd = (s1 * uu + s2) * dsp
    du = s1 * dt + dy * dsk
    dz = dzf * (dsk * uu + yp)
    # dD, ddelta_bias: staging thread (channel, st0) walks chunks from the
    # last, steps st0 + 8 k; then the threads of a channel in order of st0.
    acc_d = torch.zeros(bsz, dp, THREADS // BWD_CHANNELS)
    acc_b = torch.zeros_like(acc_d)
    for c in reversed(range(chunks)):
        for k in range(CHUNK // (THREADS // BWD_CHANNELS)):
            for st0 in range(THREADS // BWD_CHANNELS):
                t = c * CHUNK + st0 + k * (THREADS // BWD_CHANNELS)
                if t < length:
                    acc_d[..., st0] = acc_d[..., st0] + dy[:, t] * uu[:, t]
                    acc_b[..., st0] = acc_b[..., st0] + dd[:, t]

    def per_channel(acc):
        total = acc[..., 0]
        for st0 in range(1, acc.shape[-1]):
            total = total + acc[..., st0]
        return total.sum(0)[:d_in]

    crop = (slice(None), slice(0, length), slice(0, d_in))
    return (du[crop], dd[crop], from_lanes(dA, n)[:, :d_in].sum(0),
            dB_part.sum(1)[:, :length, :n], dC_part.sum(1)[:, :length, :n],
            per_channel(acc_d), dz[crop], per_channel(acc_b),
            None if h0 is None else from_lanes(g, n)[:, :d_in])


def inputs(seed, bsz, length, d, n, with_h0, with_dhl):
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))

    x = dict(u=f32(bsz, length, d), delta=f32(bsz, length, d, scale=0.5),
             A=-torch.exp(f32(d, n)), B=f32(bsz, length, n), C=f32(bsz, length, n),
             D=f32(d), z=f32(bsz, length, d),
             delta_bias=torch.linspace(-1.0, 1.0, d))
    h0 = f32(bsz, d, n) if with_h0 else None
    dout = f32(bsz, length, d)
    dhl = f32(bsz, d, n) if with_dhl else None
    return x, h0, dout, dhl


def chunk_states(x, h0):
    """K1's training-form residual: the plain state after every CHUNK steps
    (after step L for the last chunk)."""
    length = x["u"].shape[1]
    states = []
    for end in range(CHUNK, length + CHUNK, CHUNK):
        part = {k: (v[:, :min(end, length)] if k in ("u", "delta", "B", "C", "z") else v)
                for k, v in x.items()}
        states.append(selective_scan_ref(**part, delta_softplus=True, h0=h0,
                                         return_last_state=True)[1])
    return torch.stack(states, 1)


@pytest.mark.parametrize("length,n,with_h0,with_dhl", [
    (77, 1, True, True), (77, 4, False, True), (77, 16, True, False),
    (77, 20, True, True), (77, 32, False, False), (33, 16, True, True),
    (1, 16, False, True), (1, 32, True, False),
])
def test_k2_decomposition_matches_plain(length, n, with_h0, with_dhl):
    x, h0, dout, dhl = inputs(length * 100 + n, 2, length, 200, n, with_h0, with_dhl)
    got = k2_model(**x, h0=h0, dout=dout, dh_last=dhl, h_chunks=chunk_states(x, h0))
    ref = selective_scan_bwd_ref(*(x[k] for k in ("u", "delta", "A", "B", "C", "D", "z",
                                                  "delta_bias")), True, h0, dout, dhl)
    for name, gm, r in zip(GRADS, got, ref):
        if r is None:
            assert gm is None, name
            continue
        assert gm.shape == r.shape, name
        torch.testing.assert_close(gm, r, rtol=0, atol=TOL * r.abs().max().item(), msg=name)


def test_k2_blocks_lanes_and_sums_cover_the_work():
    """The mirror's channel tiles cover D once; a block's staging pairs
    cover its (channel, step) pairs of a chunk once; lanes cover the
    padded states once; the channel reduce-scatters of each warp cover its
    (step, n) sums of a chunk once; the reduce-scatters over n cover every
    step once."""
    for d in (1, 15, 16, 17, 200, 288, 1536):
        tiles = -(-d // BWD_CHANNELS)
        seen = np.zeros(d, int)
        for blk in range(tiles):
            lo = blk * BWD_CHANNELS
            seen[lo:min(d, lo + BWD_CHANNELS)] += 1
        assert (seen == 1).all() and (tiles - 1) * BWD_CHANNELS < d
    pairs = {(tid % BWD_CHANNELS, tid // BWD_CHANNELS + k * (THREADS // BWD_CHANNELS))
             for tid in range(THREADS) for k in range(CHUNK * BWD_CHANNELS // THREADS)}
    assert pairs == {(c, t) for c in range(BWD_CHANNELS) for t in range(CHUNK)}
    for n in range(1, MAX_D_STATE + 1):
        ns = states_per_lane(n)
        assert ns >= -(-n // LANES)
        slots = sorted(q + LANES * j for q in range(LANES) for j in range(ns))
        assert slots == list(range(LANES * ns))
        cstep = 4 // ns
        sums = [(i0 + cw // ns, q + LANES * (cw % ns)) for i0 in range(0, CHUNK, cstep)
                for cw in range(WARP_CH) for q in range(LANES)]
        assert sorted(sums) == [(t, m) for t in range(CHUNK) for m in range(LANES * ns)]
    fwd = [base + q for base in range(0, CHUNK, LANES) for q in range(LANES)]
    rev = [(base + q % SUB, q // SUB) for base in range(0, CHUNK, SUB) for q in range(LANES)]
    assert sorted(fwd) == list(range(CHUNK))
    assert sorted(rev) == [(t, s) for t in range(CHUNK) for s in (0, 1)]
