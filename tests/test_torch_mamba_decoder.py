"""The Mamba decoder (ConMambaMamba) in the PyTorch port against the JAX
package, on the CPU, at the tiny S2S size of tests/test_torch_s2s_ops.py
with `decoder_module="mamba"` (d_model 16, one ConMamba layer, two Mamba
decoder layers, d_ffn 16, vocab 12, d_state 4, n_mels 20, float32).
Weights go through `models.params_import`.

- The step ops: `causal_conv1d_step` and `ssm_step` in fp32 (2e-5) and
  bf16 (one bf16 ulp of the output; the states exact or 2e-5).
- `MambaBlock.step` run L times equals its `forward` and JAX's steps;
  `prime` (h and conv state) against JAX at T 2 (JAX's zero-padding
  branch) and T 37: 2e-5.
- `MambaDecoderLayer` / `MambaDecoder` teacher-forced against JAX
  `train=False` (2e-5); `ASRModel` seq log-probs on a ragged batch
  (2e-4): padded frames and targets are scanned, as in JAX.
- The decode cache: `prime_decoder_cache` and 8 `decode_step`s through
  shuffled reorders against JAX's (2e-4).
- The import key by key against `export_asr_params`; the seeded init of
  the decoder's Mamba parameters.
- The search: `S2SBeamSearcher` token-exact with the JAX searcher, scores
  within 1e-4 (CTC weight 0.4, beam 3, a ragged B2);
  `Recognizer(search="s2s", device="cpu")` against recognize.py --s2s;
  a bf16 searcher's decoder holds bf16-rounded values and hands the scan
  float32 A, D and dt bias.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.decoding.s2s_beam import S2SBeamSearcher as JaxSearcher
from mamba_asr_tpu.decoding.s2s_beam import strip_special as jax_strip
from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.models import conmamba as jax_conmamba
from mamba_asr_tpu.models import mamba as jax_mamba
from mamba_asr_tpu.models.torch_export import export_asr_params
from mamba_asr_tpu.ops.causal_conv1d import causal_conv1d_step as jax_conv_step
from mamba_asr_tpu.ops.selective_scan import ssm_step as jax_ssm_step
from mamba_asr_tpu.training import trainer as jax_trainer
from mamba_asr_tpu.training.normalizer import NormalizerState

from mamba_asr_torch.configs.loader import DecodeConfig, FrontendConfig
from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher, cast_decode_weights, strip_special
from mamba_asr_torch.models import asr, conmamba, mamba
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.ops.causal_conv1d import causal_conv1d_step
from mamba_asr_torch.ops.selective_scan import ssm_step
from mamba_asr_torch.serving.recognizer import Recognizer
from tests.test_torch_models import _sub_state
from tests.test_torch_s2s_ops import JAX_MAMBA, VOCAB, port_cfg, s2s_cfg

torch.set_num_threads(1)

PORT_MAMBA = mamba.MambaConfig(d_state=4, d_conv=4, expand=2, dt_rank=2)


@pytest.fixture(autouse=True)
def _no_grad():
    prev = torch.is_grad_enabled()
    torch.set_grad_enabled(False)
    yield
    torch.set_grad_enabled(prev)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol, err_msg=what)


def _nudged(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)


def mamba_model(seed=0, **kw):
    """(jax cfg, jax model, params, port model) of the tiny ConMambaMamba:
    params from init, each leaf nudged by seeded noise, carried into the
    port."""
    jcfg = s2s_cfg(decoder_module="mamba", **kw)
    model = jax_asr.ASRModel(jcfg)
    rng = np.random.default_rng(seed)
    feats = jnp.asarray(rng.normal(size=(2, 45, 20)).astype(np.float32))
    toks = jnp.asarray(rng.integers(0, VOCAB, (2, 5)).astype(np.int32))
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), feats,
                                 jnp.array([45, 31]), toks)["params"]
    params = _nudged(params, seed)
    pcfg = port_cfg(jcfg)
    pm = asr.ASRModel(pcfg)
    pm.load_state_dict(pi.import_asr_params(params, pcfg), strict=True)
    return jcfg, model, params, pm.eval()


@pytest.fixture(scope="module")
def tiny():
    return mamba_model()


def _bf16(x):
    """float32 numpy -> the same bf16 values as a JAX and a torch array."""
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _inputs(dtype, arrays):
    if dtype == "float32":
        return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]
    pairs = [_bf16(a) for a in arrays]
    return [p[0] for p in pairs], [p[1] for p in pairs]


# -- the step ops ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_step_matches_jax(dtype):
    rng = np.random.default_rng(1)
    b, k, d = 3, 4, 10
    state, x_t = (rng.normal(size=s).astype(np.float32) for s in ((b, k, d), (b, d)))
    w, bias = rng.normal(size=(k, d)).astype(np.float32), rng.normal(size=d).astype(np.float32)
    (j_state, j_x), (t_state, t_x) = _inputs(dtype, [state, x_t])
    want_y, want_state = jax_conv_step(j_state, j_x, jnp.asarray(w), jnp.asarray(bias))
    y, new_state = causal_conv1d_step(t_state, t_x, torch.from_numpy(w), torch.from_numpy(bias))
    assert y.dtype == t_x.dtype and new_state.dtype == t_state.dtype
    np.testing.assert_array_equal(new_state.float().numpy(),
                                  np.asarray(want_state.astype(jnp.float32)))
    tol = 2e-5 if dtype == "float32" else 1e-2
    _close(y.float().numpy(), want_y.astype(jnp.float32), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_step_matches_jax(dtype):
    rng = np.random.default_rng(2)
    b, d, n = 3, 10, 4
    h = rng.normal(size=(b, d, n)).astype(np.float32)
    u, delta, z = (rng.normal(size=(b, d)).astype(np.float32) for _ in range(3))
    bm, cm = (rng.normal(size=(b, n)).astype(np.float32) for _ in range(2))
    a = -np.exp(rng.normal(size=(d, n))).astype(np.float32)
    dd, bias = rng.normal(size=d).astype(np.float32), rng.normal(size=d).astype(np.float32)
    (ju, jdelta, jz, jb, jc), (tu, tdelta, tz, tb, tc) = _inputs(dtype, [u, delta, z, bm, cm])
    want_y, want_h = jax_ssm_step(jnp.asarray(h), ju, jdelta, jnp.asarray(a), jb, jc,
                                  D=jnp.asarray(dd), z=jz, delta_bias=jnp.asarray(bias))
    y, h_new = ssm_step(torch.from_numpy(h), tu, tdelta, torch.from_numpy(a), tb, tc,
                        D=torch.from_numpy(dd), z=tz, delta_bias=torch.from_numpy(bias))
    assert y.dtype == tu.dtype and h_new.dtype == torch.float32
    _close(h_new.numpy(), want_h, 2e-5, "h")
    _close(y.float().numpy(), want_y.astype(jnp.float32),
           2e-5 if dtype == "float32" else 1e-2, "y")


# -- MambaBlock's cache -----------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    """(JAX MambaBlock, its nudged params, the port's block with them)."""
    m = jax_mamba.MambaBlock(16, JAX_MAMBA)
    x = jnp.asarray(np.random.default_rng(3).normal(size=(2, 9, 16)).astype(np.float32))
    params = _nudged(jax.jit(m.init)(jax.random.PRNGKey(3), x)["params"], 3)
    port = mamba.MambaBlock(16, PORT_MAMBA)
    port.load_state_dict(_sub_state(pi._mamba, params), strict=True)
    return m, params, port


def test_mamba_block_step_equals_forward_and_jax(block):
    m, params, port = block
    x = np.random.default_rng(4).normal(size=(2, 11, 16)).astype(np.float32)
    full = port(torch.from_numpy(x))
    cache = port.init_cache(2)
    assert cache[0].shape == (2, 4, 32) and cache[1].shape == (2, 32, 4)
    jcache = m.init_cache(2)
    outs = []
    for t in range(x.shape[1]):
        y, cache = port.step(torch.from_numpy(x[:, t]), cache)
        want, jcache = m.apply({"params": params}, jnp.asarray(x[:, t]), jcache,
                               method=jax_mamba.MambaBlock.step)
        _close(y.numpy(), want, 2e-5, f"step {t}")
        outs.append(y)
    _close(torch.stack(outs, 1).numpy(), full.numpy(), 2e-5, "steps vs forward")
    _close(cache[0].numpy(), jcache[0], 2e-5, "conv state")
    _close(cache[1].numpy(), jcache[1], 2e-5, "ssm state")


@pytest.mark.parametrize("length", [2, 37])
def test_prime_matches_jax(block, length):
    """T 2 < K-1 takes JAX's zero-padding branch; then a step from the
    primed cache continues the forward over [context; token]."""
    m, params, port = block
    x = np.random.default_rng(length).normal(size=(2, length + 1, 16)).astype(np.float32)
    ctx = x[:, :length]
    want = m.apply({"params": params}, jnp.asarray(ctx), method=jax_mamba.MambaBlock.prime)
    conv_state, h = port.prime(torch.from_numpy(ctx))
    _close(conv_state.numpy(), want[0], 2e-5, "conv state")
    _close(h.numpy(), want[1], 2e-5, "h")
    if length == 2:
        assert not conv_state[:, :2].any()
    y, _ = port.step(torch.from_numpy(x[:, length]), (conv_state, h))
    _close(y.numpy(), port(torch.from_numpy(x))[:, -1].numpy(), 2e-5, "step after prime")


# -- the decoder ------------------------------------------------------------------


def test_mamba_decoder_layer_and_stack_match_jax(tiny):
    jcfg, _, params, pm = tiny
    rng = np.random.default_rng(6)
    tgt, mem = rng.normal(size=(2, 7, 16)).astype(np.float32), rng.normal(
        size=(2, 13, 16)).astype(np.float32)
    layer = jax_conmamba.MambaDecoderLayer(16, 16, activation=jax_asr._gelu_exact,
                                           normalize_before=True, mamba_cfg=JAX_MAMBA)
    lp = params["decoder"]["layer_1"]
    want = layer.apply({"params": lp}, jnp.asarray(tgt), jnp.asarray(mem), train=False)
    port = conmamba.MambaDecoderLayer(16, 16, asr._gelu_exact, PORT_MAMBA)
    port.load_state_dict(_sub_state(pi._mamba_decoder_layer, lp), strict=True)
    _close(port(torch.from_numpy(tgt), torch.from_numpy(mem)).numpy(), want, 2e-5, "layer")

    stack = jax_conmamba.MambaDecoder(2, 16, 16, activation=jax_asr._gelu_exact,
                                      normalize_before=True, mamba_cfg=JAX_MAMBA)
    want = stack.apply({"params": params["decoder"]}, jnp.asarray(tgt), jnp.asarray(mem))
    got = pm.decoder(torch.from_numpy(tgt), torch.from_numpy(mem))
    _close(got.numpy(), want, 2e-5, "stack")


@pytest.mark.parametrize("train", [False, True])
def test_asr_model_seq_log_probs_match_jax_on_a_ragged_batch(tiny, train):
    """Padded frames and padded targets: both packages scan them (JAX
    `asr.py:406`), so the padded rows agree too; in train mode at dropout 0
    nothing is masked either."""
    jcfg, model, params, pm = tiny
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(3, 61, 20)).astype(np.float32)
    flens = np.array([61, 40, 25], np.int32)
    bos = np.zeros((3, 8), np.int32)
    for i, n in enumerate((7, 4, 2)):
        bos[i, 0], bos[i, 1:n + 1] = 1, rng.integers(3, VOCAB, n)
    ref = jax.jit(lambda p, *a: model.apply({"params": p}, *a, train=train))(
        params, jnp.asarray(feats), jnp.asarray(flens), jnp.asarray(bos))
    pm.train(train)
    got = pm(torch.from_numpy(feats), torch.from_numpy(flens), torch.from_numpy(bos))
    pm.eval()
    for key in ("seq_log_probs", "ctc_log_probs"):
        _close(got[key].numpy(), ref[key], 2e-4, key)
    # A padded row's result depends on its batch (the reference's semantics).
    alone = pm(torch.from_numpy(feats[2:, :25]), torch.from_numpy(flens[2:]),
               torch.from_numpy(bos[2:]))["seq_log_probs"]
    assert not torch.allclose(alone[0], got["seq_log_probs"][2], atol=1e-4)


def test_decode_cache_chain_matches_jax(tiny):
    """prime_decoder_cache on the beam-repeated memory of a ragged B2 x beam
    3, then 8 decode_steps, the states gathered by a shuffled reorder after
    every step on both sides: logits within 2e-4."""
    jcfg, model, params, pm = tiny
    rng = np.random.default_rng(8)
    beam, n = 3, 6
    enc = rng.normal(size=(2, 20, 16)).astype(np.float32)
    rep = np.repeat(enc, beam, axis=0)
    jcache = model.apply({"params": params}, n, method=jax_asr.ASRModel.init_decoder_cache)
    jcache = model.apply({"params": params}, jnp.asarray(rep), jcache,
                         method=jax_asr.ASRModel.prime_decoder_cache)
    pcache = pm.prime_decoder_cache(torch.from_numpy(rep), pm.init_decoder_cache(n))
    step = jax.jit(lambda p, tok, s, c: model.apply({"params": p}, tok, s, c,
                                                    method=jax_asr.ASRModel.decode_step))
    for s in range(8):
        tok = rng.integers(0, VOCAB, n).astype(np.int32)
        want, jcache = step(params, jnp.asarray(tok), jnp.int32(s), jcache)
        got, pcache = pm.decode_step(torch.from_numpy(tok).long(), s, pcache)
        _close(got.numpy(), want, 2e-4, f"step {s}")
        reorder = rng.integers(0, beam, n) + np.repeat(np.arange(2) * beam, beam)
        jcache = jax.tree_util.tree_map(lambda x: x[jnp.asarray(reorder)], jcache)
        pcache = pm.decoder.reorder_cache(pcache, torch.from_numpy(reorder))
    for c, jc in zip(pcache, jcache):
        for part in ("self", "cross"):
            for got, want in zip(c[part], jc[part]):
                _close(got.numpy(), want, 2e-4, part)


def test_import_equals_export_key_by_key(tiny):
    jcfg, _, params, _ = tiny
    ours = pi.import_asr_params(params, port_cfg(jcfg))
    theirs = export_asr_params(params, jcfg)
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    names = set(ours)
    for i in range(2):
        for part in ("self_mamba", "cross_mamba"):
            assert f"1.decoder.layers.{i}.{part}.A_log" in names
        assert f"1.decoder.layers.{i}.norm3.norm.weight" in names
        assert f"1.decoder.layers.{i}.pos_ffn.ffn.3.bias" in names
    assert "1.decoder.norm.norm.weight" in names


def test_seeded_init_covers_the_decoder_mamba():
    """The decoder's Mamba blocks start as the encoder's: S4D A_log, unit
    D, the dt bias log-uniform in [dt_min, dt_max] under softplus."""
    cfg = port_cfg(s2s_cfg(decoder_module="mamba"))
    model = asr.init_params_(asr.ASRModel(cfg), torch.Generator().manual_seed(0))
    for layer in model.decoder.layers:
        for block in (layer.self_mamba, layer.cross_mamba):
            want = torch.log(torch.arange(1, 5, dtype=torch.float32)).expand(32, 4)
            assert torch.equal(block.A_log, want) and torch.equal(block.D, torch.ones(32))
            dt = torch.nn.functional.softplus(block.dt_proj.bias)
            assert (dt >= 1e-3 * 0.999).all() and (dt <= 0.1 * 1.001).all()
            assert block.dt_proj.weight.abs().max() <= 2 ** -0.5


# -- the search ---------------------------------------------------------------------


def _encode(model, params, seed, frames=60):
    rng = np.random.default_rng(seed)
    feats = jnp.asarray(rng.normal(size=(2, frames, 20)).astype(np.float32))
    out = jax.jit(lambda p, f, n: model.apply({"params": p}, f, n))(
        params, feats, jnp.array([frames, frames * 2 // 3]))
    return {k: np.array(v) for k, v in out.items()}


@pytest.mark.parametrize("candidates", [0, 5])
def test_s2s_searcher_matches_jax(tiny, candidates):
    jcfg, model, params, pm = tiny
    out = _encode(model, params, 4)
    kw = dict(beam_size=3, ctc_weight=0.4, ctc_candidates=candidates, temperature=1.15,
              max_steps_cap=8)
    j_toks, j_lens, j_scores = JaxSearcher(model, **kw)(
        {"params": params}, jnp.asarray(out["enc_out"]), jnp.asarray(out["enc_lengths"]),
        ctc_log_probs=jnp.asarray(out["ctc_log_probs"]))
    searcher = S2SBeamSearcher(pm, **kw)
    toks, lens, scores = searcher(torch.from_numpy(out["enc_out"]),
                                  torch.from_numpy(out["enc_lengths"]),
                                  torch.from_numpy(out["ctc_log_probs"]))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(j_toks))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(j_lens))
    np.testing.assert_allclose(scores.numpy(), np.asarray(j_scores), rtol=1e-4, atol=1e-4)
    ids = strip_special(toks.numpy(), lens.numpy())
    assert ids == jax_strip(np.asarray(j_toks), np.asarray(j_lens))
    assert any(len(x) > 1 for x in ids), f"degenerate hypotheses {ids}"


def _norm():
    rng = np.random.default_rng(7)
    return (np.float32(120.0), rng.normal(size=20).astype(np.float32),
            rng.uniform(50.0, 200.0, size=20).astype(np.float32))


def test_recognizer_s2s_matches_jax_recognize_flow(tiny):
    """recognize.py --s2s: each request alone through make_eval_step and
    the searcher of the decode stanza; the port's Recognizer at batch=1."""
    jcfg, model, params, _ = tiny
    eval_step = jax_trainer.make_eval_step(model, jax_trainer.FrontendConfig(n_fft=400, n_mels=20))
    searcher = JaxSearcher(model, beam_size=3, ctc_weight=0.4, ctc_candidates=5,
                           temperature=1.15, length_normalization=True,
                           max_decode_ratio=1.0, min_decode_ratio=0.0)
    norm = NormalizerState(*map(jnp.asarray, _norm()))
    rng = np.random.default_rng(9)
    wavs = [rng.normal(0.0, 0.1, size=14500).astype(np.float32) for _ in range(2)]
    expected = []
    for wav in wavs:
        out = eval_step(params, norm, {"wav": jnp.asarray(wav)[None],
                                       "wav_lens": jnp.array([len(wav)], jnp.int32),
                                       "tokens_bos": jnp.zeros((1, 4), jnp.int32)})
        toks, lens, _ = searcher({"params": params}, out["enc_out"], out["enc_lengths"],
                                 ctc_log_probs=out["ctc_log_probs"])
        expected.append(jax_strip(np.array(toks), np.array(lens))[0])
    assert any(expected), "the searches gave only empty hypotheses: the test is vacuous"
    pcfg = port_cfg(jcfg)
    decode = DecodeConfig(s2s_test_beam_size=3, ctc_weight_decode=0.4, ctc_candidates=5,
                          temperature=1.15)
    rec = Recognizer(pcfg, FrontendConfig(n_fft=400, n_mels=20),
                     pi.import_asr_params(params, pcfg), normalizer=_norm(), device="cpu",
                     decode=decode, search="s2s")
    assert rec.transcribe(wavs) == expected


def test_bf16_searcher_hands_the_scan_float32_bf16_values(tiny, monkeypatch):
    """The cast decoder holds bf16 weights (A_log, D, dt bias and conv taps
    too, as JAX's cast_tree); priming hands the scan A = -exp(A_log) taken
    in bf16, D and the dt bias as float32 tensors of those bf16 values; the
    search runs (finite scores)."""
    _, _, _, pm = tiny
    cfg16 = dataclasses.replace(pm.cfg, compute_dtype="bfloat16")
    m16 = asr.ASRModel(cfg16)
    m16.load_state_dict(pm.state_dict(), strict=True)
    cast = cast_decode_weights(m16.eval())
    assert all(p.dtype == torch.bfloat16 for p in cast.decoder.parameters())
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    seen = []
    plain = mamba.selective_scan

    def record(u, delta, A, B, C, D=None, z=None, delta_bias=None, **kw):
        seen.append((u.dtype, A, D, delta_bias))
        return plain(u, delta, A, B, C, D=D, z=z, delta_bias=delta_bias, **kw)

    monkeypatch.setattr(mamba, "selective_scan", record)
    rng = np.random.default_rng(0)
    enc = torch.from_numpy(rng.normal(size=(1, 20, 16)).astype(np.float32)).bfloat16()
    lp = torch.log_softmax(torch.from_numpy(rng.normal(size=(1, 20, 12)).astype(np.float32)), -1)
    searcher = S2SBeamSearcher(m16, beam_size=3, ctc_weight=0.4, max_steps_cap=5)
    toks, lens, scores = searcher(enc, torch.tensor([20]), lp)
    assert toks.shape == (1, 5) and torch.isfinite(scores).all()
    layers = zip(searcher.decode_model.decoder.layers, m16.decoder.layers)
    blocks = [(cast_l.cross_mamba, orig_l.cross_mamba) for cast_l, orig_l in layers]
    assert len(seen) == len(blocks) == 2
    for (u_dtype, a, d, bias), (blk, orig) in zip(seen, blocks):
        assert u_dtype == torch.bfloat16 and blk.A_log.dtype == torch.bfloat16
        assert a.dtype == d.dtype == bias.dtype == torch.float32
        assert torch.equal(a, (-torch.exp(blk.A_log)).float())
        assert torch.equal(a, (-torch.exp(orig.A_log.bfloat16())).float())
        assert not torch.equal(a, -torch.exp(orig.A_log))  # the float32 values differ
        assert torch.equal(d, orig.D.bfloat16().float())
        assert torch.equal(bias, orig.dt_proj.bias.bfloat16().float())
