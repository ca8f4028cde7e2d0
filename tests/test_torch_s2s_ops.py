"""The S2S path's modules in the PyTorch port against the JAX package, on
the CPU, at a tiny size (d_model 16, nhead 2, 1 encoder and 2 decoder
layers, d_ffn 16, vocab 12, d_state 4, n_mels 20, float32).

- The plain beam attention (K4's plain version) against the JAX gather
  and the Pallas kernel in interpret mode: 2e-5 (float32), 2e-2 (bf16).
- The plain CTC prefix DP (K3's plain version) against the JAX
  associative scans and the Pallas kernel in interpret mode: 1e-5
  relative and absolute (a sequential sum against a tree of sums; the
  -1e30 sentinels compare by the relative part).
- CTCPrefixScorer's init / score / select against JAX: 1e-5.
- The decoder: the teacher-forced `decode` and a chain of cached
  `decode_step`s through shuffled ancestor tables: 2e-5.
- import_asr_params for an S2S model equals export_asr_params key by key.
- stable_topk against jax.lax.top_k on values with ties: equal.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.decoding import ctc_prefix_scorer as jax_scorer
from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.models import mamba as jax_mamba
from mamba_asr_tpu.models.torch_export import export_asr_params
from mamba_asr_tpu.ops.pallas import beam_attention as jax_ba
from mamba_asr_tpu.ops.pallas.log_scan import ctc_dp_pallas

from mamba_asr_torch.decoding.ctc_prefix_scorer import CTCPrefixScorer
from mamba_asr_torch.decoding.s2s_beam import stable_topk
from mamba_asr_torch.models import asr, mamba
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.ops.beam_attention import beam_attention, beam_attention_ref
from mamba_asr_torch.ops.ctc_dp import NEG, ctc_dp, ctc_dp_ref

torch.set_num_threads(1)

JAX_MAMBA = jax_mamba.MambaConfig(d_state=4, d_conv=4, expand=2, dt_rank=2)
VOCAB = 12


@pytest.fixture(autouse=True)
def _no_grad():
    prev = torch.is_grad_enabled()
    torch.set_grad_enabled(False)
    yield
    torch.set_grad_enabled(prev)


def s2s_cfg(**kw):
    base = dict(
        vocab_size=VOCAB, n_mels=20, d_model=16, nhead=2, num_encoder_layers=1,
        num_decoder_layers=2, d_ffn=16, dropout=0.0, activation="gelu",
        encoder_module="conmamba", decoder_module="transformer", kernel_size=7,
        frontend_channels=(4, 6), mamba=JAX_MAMBA, compute_dtype="float32",
    )
    base.update(kw)
    return jax_asr.ASRConfig(**base)


def port_cfg(c: jax_asr.ASRConfig) -> asr.ASRConfig:
    kw = {f.name: getattr(c, f.name) for f in dataclasses.fields(asr.ASRConfig)}
    kw["mamba"] = mamba.MambaConfig(**{
        f.name: getattr(c.mamba, f.name) for f in dataclasses.fields(mamba.MambaConfig)
    })
    return asr.ASRConfig(**kw)


def s2s_model(seed=0):
    """(jax cfg, jax model, params, port model): params from init, each
    leaf nudged by seeded noise, carried into the port."""
    jcfg = s2s_cfg()
    model = jax_asr.ASRModel(jcfg)
    rng = np.random.default_rng(seed)
    feats = jnp.asarray(rng.normal(size=(2, 45, 20)).astype(np.float32))
    toks = jnp.asarray(rng.integers(0, VOCAB, (2, 5)).astype(np.int32))
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), feats,
                                 jnp.array([45, 31]), toks)["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32),
        params)
    pcfg = port_cfg(jcfg)
    pm = asr.ASRModel(pcfg)
    pm.load_state_dict(pi.import_asr_params(params, pcfg), strict=True)
    return jcfg, model, params, pm.eval()


@pytest.fixture(scope="module")
def tiny():
    return s2s_model()


def encode(model, params, seed, frames=45):
    """The JAX model's outputs for seeded features of B2 (frames, 20)."""
    rng = np.random.default_rng(seed)
    feats = jnp.asarray(rng.normal(size=(2, frames, 20)).astype(np.float32))
    lengths = jnp.array([frames, frames * 2 // 3])
    out = jax.jit(lambda p, f, n: model.apply({"params": p}, f, n))(params, feats, lengths)
    return {k: np.array(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def encoded(tiny):
    _, model, params, _ = tiny
    return encode(model, params, 1)


# -- K4's plain version ------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 5, 63, 64, 100])
def test_beam_attention_ref_matches_jax(pos, dtype):
    rng = np.random.default_rng(pos)
    h, s, n, dh = 2, 128, 5, 8
    q = rng.normal(size=(n, h, dh)).astype(np.float32)
    k = rng.normal(size=(h, s, n, dh)).astype(np.float32)
    v = rng.normal(size=(h, s, n, dh)).astype(np.float32)
    anc = rng.integers(0, n, size=(s, n)).astype(np.int32)
    anc[pos] = np.arange(n)
    jdt = jnp.dtype(dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    want_gather = np.asarray(jax_ba.beam_attention_gather(jq, jk, jv, jnp.asarray(anc), pos)
                             .astype(jnp.float32))
    want_pallas = np.asarray(jax_ba.beam_attention_pallas(
        jq, jk, jv, jnp.asarray(anc), pos, interpret=True).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    got = beam_attention(tq, tk, tv, torch.from_numpy(anc), pos)
    assert got.dtype == tdt and got.shape == (n, h, dh)
    assert torch.equal(got, beam_attention_ref(tq, tk, tv, torch.from_numpy(anc), pos))
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want_gather, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.float().numpy(), want_pallas, rtol=tol, atol=tol)


# -- K3's plain version ------------------------------------------------------


def _dp_inputs(seed=7, t=300, n=6):
    """The select DP's (T, N) planes with ragged validity: a full row, a
    row valid for frame 0 only, rows ending mid-way."""
    rng = np.random.default_rng(seed)
    lens = np.array([300, 215, 1, 300, 77, 150])[:n]
    valid = np.arange(t)[None, :] < lens[:, None]  # (N, T)
    lp_tok = np.log(rng.dirichlet(np.ones(4), size=(n, t))[:, :, 0] + 1e-9)
    phi = rng.normal(size=(n, t)) * 2 - 5
    lpb = np.where(valid, np.log(rng.uniform(0.1, 0.9, size=(n, t))), 0.0)
    grow = np.where(valid, phi + lp_tok, NEG)
    a_nb = np.where(valid, lp_tok, 0.0)
    return [np.ascontiguousarray(x.T.astype(np.float32))
            for x in (a_nb, grow, lpb, valid.astype(np.float32))]


def test_ctc_dp_ref_matches_jax():
    a_nb, grow, lpb, valid = _dp_inputs()
    r_nb = jax_scorer._linear_log_scan(jnp.asarray(a_nb), jnp.asarray(grow))
    r_nb_shift = jnp.concatenate([jnp.full((1, a_nb.shape[1]), NEG), r_nb[:-1]])
    b_b = jnp.where(jnp.asarray(valid) > 0, r_nb_shift + lpb, NEG)
    r_b = jax_scorer._linear_log_scan(jnp.asarray(lpb), b_b)
    p_nb, p_b = ctc_dp_pallas(*map(jnp.asarray, (a_nb, grow, lpb, valid)),
                              interpret=True)
    got_nb, got_b = ctc_dp(*map(torch.from_numpy, (a_nb, grow, lpb, valid)))
    ref_nb, ref_b = ctc_dp_ref(*map(torch.from_numpy, (a_nb, grow, lpb, valid)))
    assert torch.equal(got_nb, ref_nb) and torch.equal(got_b, ref_b)
    for got, want in ((got_nb, r_nb), (got_b, r_b), (got_nb, p_nb), (got_b, p_b)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (got_b.numpy()[1:, 2] <= -1e29).all()  # the row valid at frame 0 only


# -- CTCPrefixScorer ---------------------------------------------------------


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _states_close(p_state, j_state):
    for name in ("r_nb", "r_b", "psi"):
        _close(getattr(p_state, name).numpy(), getattr(j_state, name))
    assert (p_state.last.numpy() == np.asarray(j_state.last)).all()


@pytest.mark.parametrize("with_candidates", [False, True])
def test_ctc_prefix_scorer_matches_jax(with_candidates):
    """Three steps at B2 x beam 3 over ragged lengths: the first from the
    empty prefix, then eos, repeated tokens (the same-token column) and
    reorders that cross beams."""
    rng = np.random.default_rng(3)
    b, beam, t = 2, 3, 20
    logits = rng.normal(size=(b, t, VOCAB)).astype(np.float32) * 2
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    lens = np.array([20, 13], np.int32)
    js = jax_scorer.CTCPrefixScorer(jnp.asarray(lp), jnp.asarray(lens), beam)
    ps = CTCPrefixScorer(torch.from_numpy(lp), torch.from_numpy(lens), beam)
    j_state, p_state = js.init_state(), ps.init_state()
    _states_close(p_state, j_state)
    steps = [  # (tokens, reorder) per step; eos is 2
        ([3, 3, 5, 4, 2, 7], [0, 0, 0, 3, 3, 3]),
        ([3, 2, 6, 4, 4, 9], [0, 1, 1, 3, 5, 4]),
        ([8, 3, 2, 4, 11, 1], [2, 0, 1, 3, 4, 4]),
    ]
    for tokens, reorder in steps:
        cand = None
        if with_candidates:
            cand = rng.integers(3, VOCAB, (b * beam, 5)).astype(np.int32)
            cand[:, 0] = 2
        j_scores, j_aux = js.score(j_state, None if cand is None else jnp.asarray(cand))
        p_scores, p_aux = ps.score(p_state, None if cand is None else torch.from_numpy(cand))
        _close(p_scores.numpy(), j_scores)
        _close(p_aux["psi"].numpy(), j_aux["psi"])
        tok, reo = np.array(tokens, np.int32), np.array(reorder, np.int32)
        j_state = js.select(j_state, j_aux, jnp.asarray(tok), jnp.asarray(reo))
        p_state = ps.select(p_state, p_aux, torch.from_numpy(tok), torch.from_numpy(reo).long())
        _states_close(p_state, j_state)


# -- decoder -------------------------------------------------------------------


def test_decoder_decode_matches_jax(tiny, encoded):
    jcfg, model, params, pm = tiny
    out = encoded
    toks = np.random.default_rng(5).integers(0, VOCAB, (2, 7)).astype(np.int32)
    decode = jax.jit(lambda p, *a: model.apply({"params": p}, *a,
                                               method=jax_asr.ASRModel.decode))
    want = decode(params, jnp.asarray(toks), jnp.asarray(out["enc_out"]),
                  jnp.asarray(out["enc_lengths"]))
    got = pm.decode(torch.from_numpy(toks).long(), torch.from_numpy(out["enc_out"]),
                    torch.from_numpy(out["enc_lengths"]))
    _close(got.numpy(), want, 2e-5)


def test_decode_step_chain_matches_jax(tiny, encoded):
    """Eight cached steps of 2 utterances x beam 3 through ancestor tables
    shuffled after every step (row s the identity, as the search sets it):
    the JAX side primes a beam-repeated memory, the port one per
    utterance."""
    jcfg, model, params, pm = tiny
    out = encoded
    beam, s_cache = 3, 64
    n = 2 * beam
    rng = np.random.default_rng(11)
    enc_rep = jnp.repeat(jnp.asarray(out["enc_out"]), beam, axis=0)
    lens_rep = jnp.repeat(jnp.asarray(out["enc_lengths"]), beam, axis=0)
    jcache = model.apply({"params": params}, n, s_cache, beam_gather=True,
                         method=jax_asr.ASRModel.init_decoder_cache)
    jcache = model.apply({"params": params}, enc_rep, jcache, lens_rep,
                         method=jax_asr.ASRModel.prime_decoder_cache)
    pcache = pm.prime_decoder_cache(torch.from_numpy(out["enc_out"]),
                                    pm.init_decoder_cache(n, s_cache),
                                    torch.from_numpy(out["enc_lengths"]))
    anc = np.tile(np.arange(n, dtype=np.int32), (s_cache, 1))
    for s in range(8):
        anc[s] = np.arange(n)
        tok = rng.integers(0, VOCAB, n).astype(np.int32)
        want, jcache = model.apply({"params": params}, jnp.asarray(tok), s, jcache,
                                   anc=jnp.asarray(anc), method=jax_asr.ASRModel.decode_step)
        got, pcache = pm.decode_step(torch.from_numpy(tok).long(), s, pcache,
                                     torch.from_numpy(anc))
        _close(got.numpy(), want, 2e-5)
        anc = anc[:, rng.integers(0, n, n)]


def test_import_s2s_params_equals_export(tiny):
    jcfg, _, params, _ = tiny
    ours = pi.import_asr_params(params, port_cfg(jcfg))
    theirs = export_asr_params(params, jcfg)
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    model = asr.ASRModel(port_cfg(jcfg))
    model.load_state_dict(ours, strict=True)
    assert model.ctc_head is model._modules["3"].w
    assert model.seq_head is model._modules["2"].w


def test_seeded_init_draws_the_embedding_from_a_unit_normal():
    """The JAX NormalizedEmbedding draws from normal(stddev 1.0); the
    heads and attention kernels keep lecun-normal."""
    cfg = port_cfg(s2s_cfg(vocab_size=400))
    model = asr.init_params_(asr.ASRModel(cfg), torch.Generator().manual_seed(0))
    emb = model.tgt_embed.weight
    assert abs(emb.std().item() - 1.0) < 0.05 and abs(emb.mean().item()) < 0.05
    w = model.decoder.layers[0].self_attn.att.in_proj_weight
    assert w.abs().max().item() <= 2 * (1.0 / 16) ** 0.5 / 0.8796 + 1e-6
    assert model.decoder.layers[0].self_attn.att.in_proj_bias.abs().max() == 0


# -- stable top-k ------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 7, 30])
def test_stable_topk_matches_jax_top_k(k):
    rng = np.random.default_rng(k)
    x = rng.integers(0, 5, (4, 60)).astype(np.float32)
    x[1] = -1e30 + rng.normal(size=60).astype(np.float32)  # rounds to -1e30: all tie
    x[2, ::3] = -1e30
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = stable_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
