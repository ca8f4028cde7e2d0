"""CPU models of the S2S kernels' decompositions (K3, K4), on the CPU.

The kernels themselves (`mamba_asr_torch/csrc/ctc_dp.cu`,
`csrc/beam_attention.cu`) run only on a card. These models restate, in
torch, how each splits its work and carries state between the pieces, so
that a carry or sentinel mistake in the design shows here; the card tests
(`tests/test_torch_kernels.py`) hold the kernels themselves.

- K3: per segment of frames, chunk maps composed frame by frame, a warp
  scan over the chunk maps (C / 32 chunks per lane, Hillis-Steele over 32
  lanes, exclusive by one lane), each chunk walked again from its carry;
  r_b from r_nb(t - 1), the chunk's first frame taking it from the carry.
  At every block shape of the wrapper and two that force several segments,
  against `ctc_dp_ref` and the TPU kernel's two-level scan in interpret
  mode: 1e-4 + 1e-5 relative with the sentinel rule (sums composed in
  another order; the kernel's tolerance).
- K4: the split rule's position assignment covers every position exactly
  once; per-lane online softmax (base 2) with the lane and split merges,
  lanes and whole warps that own no position included, against
  `beam_attention_ref` and JAX `beam_attention_gather`: 2e-5 (float32).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.ops.pallas import beam_attention as jax_ba
from mamba_asr_tpu.ops.pallas.log_scan import ctc_dp_pallas

from mamba_asr_torch.kernels import beam_attention as k4
from mamba_asr_torch.kernels import ctc_dp as k3
from mamba_asr_torch.ops.beam_attention import beam_attention_ref
from mamba_asr_torch.ops.ctc_dp import NEG, ctc_dp_ref

LOG2E = 1.4426950408889634

# -- K3 ----------------------------------------------------------------------


def lae(a, b):
    return torch.logaddexp(a, b)


def warp_carry(maps, x0):
    """The kernel's `carry_in`: maps is a list of C (A, B) pairs, each (N,);
    returns the state entering each chunk and the segment's leaving state."""
    chunks = len(maps)
    r = chunks // 32
    lane_maps = [maps[lane * r:(lane + 1) * r] for lane in range(32)]
    ta, tb = [], []
    for own in lane_maps:
        a, b = own[0]
        for a2, b2 in own[1:]:
            b = lae(b + a2, b2)
            a = a + a2
        ta.append(a)
        tb.append(b)
    o = 1
    while o < 32:
        pa, pb = list(ta), list(tb)  # what the shuffle reads: before this round
        for lane in range(o, 32):
            tb[lane] = lae(pb[lane - o] + ta[lane], tb[lane])
            ta[lane] = pa[lane - o] + ta[lane]
        o *= 2
    carries = []
    x = None
    for lane, own in enumerate(lane_maps):
        ea, eb = ((torch.zeros_like(x0), torch.full_like(x0, NEG)) if lane == 0
                  else (ta[lane - 1], tb[lane - 1]))
        x = lae(x0 + ea, eb)
        for a, b in own:
            carries.append(x)
            x = lae(x + a, b)
    return carries, x  # lane 31's x leaves the segment


def compose(a, b):
    """One chunk's map from its frames' (cl, N) planes; (0, NEG) if empty."""
    big_a = torch.zeros(a.shape[1])
    big_b = torch.full((a.shape[1],), NEG)
    for k in range(a.shape[0]):
        big_b = lae(big_b + a[k], b[k])
        big_a = big_a + a[k]
    return big_a, big_b


def k3_model(a_nb, grow, lpb, valid, chunks, most):
    """K3's decomposition at `chunks` chunks of at most `most` frames."""
    frames, n = a_nb.shape
    r_nb, r_b = torch.empty_like(a_nb), torch.empty_like(a_nb)
    seg_nb, seg_b = torch.full((n,), NEG), torch.full((n,), NEG)
    for s0 in range(0, frames, chunks * most):
        seg = min(chunks * most, frames - s0)
        length = -(-seg // chunks)
        spans = [(s0 + c * length, max(0, min(length, seg - c * length)))
                 for c in range(chunks)]
        assert all(cl <= most for _, cl in spans)
        assert sum(cl for _, cl in spans) == seg
        sl = [slice(f0, f0 + cl) for f0, cl in spans]
        nb_in, seg_nb = warp_carry([compose(a_nb[s], grow[s]) for s in sl], seg_nb)
        bb = []
        for s, x in zip(sl, nb_in):
            prev = []
            for t in range(s.start, s.stop):
                prev.append(x)
                x = lae(x + a_nb[t], grow[t])
                r_nb[t] = x
            rows = torch.stack(prev) if prev else torch.empty(0, n)
            bb.append(torch.where(valid[s] > 0, rows + lpb[s], NEG))
        b_in, seg_b = warp_carry([compose(lpb[s], b) for s, b in zip(sl, bb)], seg_b)
        for s, b, y in zip(sl, bb, b_in):
            for k, t in enumerate(range(s.start, s.stop)):
                y = lae(y + lpb[t], b[k])
                r_b[t] = y
    return r_nb, r_b


def ragged_planes(seed, frames, n):
    """The select DP's planes with rows valid for all frames, 1 frame, a
    third and two thirds of them."""
    rng = np.random.default_rng(seed)
    lens = np.array([frames, 1, max(1, frames // 3), max(1, 2 * frames // 3)])[np.arange(n) % 4]
    valid = np.arange(frames)[:, None] < lens[None, :]
    lp_tok = np.log(rng.uniform(1e-4, 1.0, (frames, n)))
    grow = np.where(valid, rng.normal(size=(frames, n)) * 2 - 5 + lp_tok, NEG)
    lpb = np.where(valid, np.log(rng.uniform(0.1, 0.9, (frames, n))), 0.0)
    return [x.astype(np.float32) for x in (np.where(valid, lp_tok, 0.0), grow, lpb, valid)]


def sentinel_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    live = want > -1e29
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("frames", [1, 2, 131])
def test_k3_two_level_scan_matches_plain_and_pallas(frames):
    """At N 1, 33 and 70 (the first columns of one 70-wide draw: the
    recurrences are independent per hypothesis, so one Pallas call serves
    all three)."""
    planes = ragged_planes(frames, frames, 70)
    pal = [np.asarray(x) for x in ctc_dp_pallas(*map(jnp.asarray, planes), interpret=True)]
    # the kernel's block, and two that walk T 131 in 3 and 2 segments
    shapes = [(k3.CHUNKS, k3.MOST), (32, 2), (64, 1)]
    for n in (1, 33, 70):
        tp = [torch.from_numpy(np.ascontiguousarray(x[:, :n])) for x in planes]
        ref = ctc_dp_ref(*tp)
        for chunks, most in shapes:
            got = k3_model(*tp, chunks, most)
            for g, r, p in zip(got, ref, pal):
                sentinel_close(g, r)
                sentinel_close(g, p[:, :n])
    if frames > 1:
        assert (ref[1].numpy()[1:, 1] <= -1e29).all()  # a row valid at frame 0 only


# -- K4 ----------------------------------------------------------------------


def lane_positions(split, slot, pos, splits, lanes_per_row):
    """The positions lane slot `slot` of split `split`'s warp walks, in the
    order of the kernel's loops (ANC_TILE tiles, then block steps of
    splits x 32 / lanes_per_row positions)."""
    slots = 32 // lanes_per_row
    out = []
    for t0 in range(0, pos + 1, k4.ANC_TILE):
        tl = min(k4.ANC_TILE, pos + 1 - t0)
        out += [t0 + jj for jj in range(split * slots + slot, tl, splits * slots)]
    return out


SWEEP = [(n, pos) for n in (66, 528) for pos in (0, 31, 32, 63, 127, 255, 1023)]


@pytest.mark.parametrize("dh,elem", [(36, 2), (64, 2), (64, 4), (100, 2), (128, 4), (7, 2)])
def test_k4_split_rule_covers_every_position_once(dh, elem):
    vec, lanes = k4.row_layout(dh, elem, 16)
    chunks = dh * elem // vec
    assert chunks * vec == dh * elem and lanes <= chunks < 2 * lanes or lanes == 32
    assert -(-chunks // lanes) <= (4 if vec <= 4 else 2)  # csrc: chunks_per_lane
    for n, pos in SWEEP:
        for forced in (None, 1, 2, 4, 8, 16):
            hyps, head_block, splits = k4.split_rule(n, 4, pos, 132, forced)
            assert hyps * head_block * splits <= k4.MAX_WARPS
            assert forced is None or splits == forced
            owned = sorted(j for p in range(splits) for sl in range(32 // lanes)
                           for j in lane_positions(p, sl, pos, splits, lanes))
            assert owned == list(range(pos + 1))
    assert k4.split_rule(528, 4, 255, 132) == (2, 4, 2)
    assert k4.split_rule(66, 4, 255, 132) == (1, 2, 8)


def k4_model(q, k_buf, v_buf, anc, pos, splits, lanes):
    """Per lane an online softmax in base 2 over its positions, then the
    warp's lanes merged, then the splits."""
    h, _, n, dh = k_buf.shape
    qh = q.transpose(0, 1).float()  # (H, N, dh)
    scale = LOG2E / dh ** 0.5
    warps = []
    for p in range(splits):
        lanes_state = []
        for sl in range(32 // lanes):
            m = torch.full((h, n), -float("inf"))
            l = torch.zeros(h, n)
            acc = torch.zeros(h, n, dh)
            for j in lane_positions(p, sl, pos, splits, lanes):
                rows = anc[j].long()
                kr = k_buf[:, j, rows].float()  # (H, N, dh)
                vr = v_buf[:, j, rows].float()
                s = (qh * kr).sum(-1) * scale
                mn = torch.maximum(m, s)
                c0 = torch.exp2(m - mn)
                e = torch.exp2(s - mn)
                l = l * c0 + e
                acc = acc * c0[..., None] + e[..., None] * vr
                m = mn
            lanes_state.append((m, l, acc))
        mw = torch.stack([st[0] for st in lanes_state]).amax(0)
        l_w, acc_w = torch.zeros(h, n), torch.zeros(h, n, dh)
        for m, l, acc in lanes_state:
            c0 = torch.where(m == -float("inf"), 0.0, torch.exp2(m - mw))
            l_w = l_w + l * c0
            acc_w = acc_w + acc * c0[..., None]
        warps.append((mw, l_w, acc_w))
    mx = torch.stack([w[0] for w in warps]).amax(0)
    wsum, out = torch.zeros(h, n), torch.zeros(h, n, dh)
    for m, l, acc in warps:
        c0 = torch.where(m == -float("inf"), 0.0, torch.exp2(m - mx))
        wsum = wsum + l * c0
        out = out + acc * c0[..., None]
    return (out / wsum[..., None]).transpose(0, 1).to(q.dtype)


@pytest.mark.parametrize("pos", [0, 5, 31, 32, 100, 300])
def test_k4_online_softmax_merge_matches_plain_and_jax(pos):
    rng = np.random.default_rng(pos + 3)
    h, s, n, dh = 2, 320, 5, 8
    q = rng.normal(size=(n, h, dh)).astype(np.float32)
    k = rng.normal(size=(h, s, n, dh)).astype(np.float32)
    v = rng.normal(size=(h, s, n, dh)).astype(np.float32)
    anc = rng.integers(0, n, size=(s, n)).astype(np.int32)
    anc[pos] = np.arange(n)
    tq, tk, tv, ta = map(torch.from_numpy, (q, k, v, anc))
    ref = beam_attention_ref(tq, tk, tv, ta, pos).numpy()
    want = np.asarray(jax_ba.beam_attention_gather(*map(jnp.asarray, (q, k, v, anc)), pos))
    for splits, lanes in ((1, 1), (4, 1), (16, 1), (2, 2), (8, 8)):
        got = k4_model(tq, tk, tv, ta, pos, splits, lanes).numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
