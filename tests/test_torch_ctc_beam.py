"""The port's CTC prefix beam search against the JAX package's, on the CPU.

Seeded log-probs at B 3, T 40, V 31 (the char vocabulary) with ragged
lengths, at beams 8 and 100 with the CTC YAMLs' pruning (-12, -1.2):
the whole final beam (tokens and lengths) is token-exact with JAX's
`_beam_search_full`, and live totals agree to 2e-5 (float32 logaddexp
chains in two libraries); the best prefix also equals the host oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.decoding import ctc_beam as jax_beam

from mamba_asr_torch.decoding import ctc_beam

torch.set_num_threads(1)

PRUNE = dict(beam_prune_logp=-12.0, token_prune_min_logp=-1.2)


def _log_probs(seed, bsz=3, t=40, v=31, peaky=2.0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(bsz, t, v)).astype(np.float32) * peaky
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))
    lens = np.array([t, t - 9, t // 3][:bsz], np.int32)
    return lp, lens


@functools.lru_cache(maxsize=None)
def _jax_full(beam):
    """JAX's whole search at B3 x T40 x V31, compiled once per beam."""
    return jax.jit(lambda a, b: jax_beam._beam_search_full(
        a, b, beam, 0, PRUNE["beam_prune_logp"], PRUNE["token_prune_min_logp"], 40))


@pytest.mark.parametrize("beam", [8, 100])
@pytest.mark.parametrize("seed", [0, 1])
def test_full_beam_matches_jax(beam, seed):
    lp, lens = _log_probs(seed)
    jt, jl, jtot = map(np.asarray, _jax_full(beam)(jnp.asarray(lp), jnp.asarray(lens)))
    pt, pl, ptot = ctc_beam._beam_search_full(
        torch.from_numpy(lp), torch.from_numpy(lens), beam, 0,
        PRUNE["beam_prune_logp"], PRUNE["token_prune_min_logp"], 40)
    np.testing.assert_array_equal(pt.numpy(), jt)
    np.testing.assert_array_equal(pl.numpy(), jl)
    live = jtot > -1e29
    np.testing.assert_array_equal(ptot.numpy() > -1e29, live)
    np.testing.assert_allclose(ptot.numpy()[live], jtot[live], rtol=0, atol=2e-5)


@pytest.mark.parametrize("beam", [8, 100])
def test_best_prefix_matches_jax_and_the_oracle(beam):
    """ctc_beam_search's tokens and lengths equal JAX's (exact) and the
    host oracle's prefix per row."""
    lp, lens = _log_probs(2, peaky=1.5)
    jt, jl, jtot = map(np.asarray, _jax_full(beam)(jnp.asarray(lp), jnp.asarray(lens)))
    best = jtot.argmax(1)  # as jax_beam.ctc_beam_search picks
    pt, pl = ctc_beam.ctc_beam_search(torch.from_numpy(lp), torch.from_numpy(lens),
                                      beam_size=beam, **PRUNE)
    assert pt.dtype == torch.int32 and tuple(pt.shape) == (3, 40)
    np.testing.assert_array_equal(pt.numpy(), jt[np.arange(3), best])
    np.testing.assert_array_equal(pl.numpy(), jl[np.arange(3), best])
    for b in range(3):
        ref = ctc_beam.ctc_beam_search_ref(lp[b], lens[b], beam_size=beam, **PRUNE)
        assert ref == jax_beam.ctc_beam_search_ref(lp[b], lens[b], beam_size=beam, **PRUNE)
        assert list(pt[b, :pl[b]].numpy()) == ref


def test_nbest_matches_jax():
    """The 5 best prefixes, best first, with max_tokens 12: tokens and
    lengths exact, scores to 2e-5."""
    lp, lens = _log_probs(3, peaky=1.0)
    kw = dict(nbest=5, beam_size=16, max_tokens=12, beam_prune_logp=-12.0,
              token_prune_min_logp=-3.0)
    jt, jl, js = map(np.asarray, jax_beam.ctc_beam_search_nbest(
        jnp.asarray(lp), jnp.asarray(lens), **kw))
    pt, pl, ps = ctc_beam.ctc_beam_search_nbest(torch.from_numpy(lp),
                                                torch.from_numpy(lens), **kw)
    np.testing.assert_array_equal(pt.numpy(), jt)
    np.testing.assert_array_equal(pl.numpy(), jl)
    np.testing.assert_allclose(ps.numpy(), js, rtol=0, atol=2e-5)


def test_beam_reduces_to_greedy_when_peaky():
    from mamba_asr_torch.decoding.ctc_greedy import ctc_greedy_decode

    lp, lens = _log_probs(5, peaky=8.0)
    lp_t, lens_t = torch.from_numpy(lp), torch.from_numpy(lens)
    bt, bl = ctc_beam.ctc_beam_search(lp_t, lens_t, beam_size=8)
    gt, gl = ctc_greedy_decode(lp_t, lens_t)
    for b in range(3):
        assert bt[b, :bl[b]].tolist() == gt[b, :gl[b]].tolist()
