"""The port's joint CTC/attention beam search and the Recognizer's S2S
mode against the JAX package, on the CPU, at the tiny S2S size of
tests/test_torch_s2s_ops.py (float32).

- S2SBeamSearcher against the JAX searcher, with the CTC scorer over the
  full vocabulary and with candidates (beam + 2): tokens and lengths
  equal, length-normalized scores within 1e-4.
- Recognizer(device="cpu", search="s2s") at batch=1 against
  recognize.py --s2s (make_eval_step + the JAX searcher on each request
  unpadded): tokens equal. At batch=2 the requests are grouped and padded
  as in the CTC mode.
- What is not ported raises: an unknown decoder, a flax msgpack
  `decode.lm_path`, a search other than "ctc", "beam" and "s2s";
  search="beam" gives the CTC recipe's test decoder's tokens.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.decoding.s2s_beam import S2SBeamSearcher as JaxSearcher
from mamba_asr_tpu.decoding.s2s_beam import strip_special as jax_strip
from mamba_asr_tpu.training import trainer as jax_trainer
from mamba_asr_tpu.training.normalizer import NormalizerState

from mamba_asr_torch.configs.loader import DecodeConfig, FrontendConfig
from mamba_asr_torch.decoding.s2s_beam import (
    S2SBeamSearcher,
    cast_decode_weights,
    strip_special,
)
from mamba_asr_torch.models import asr
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.serving.recognizer import Recognizer
from mamba_asr_torch.training import loop
from tests.test_torch_s2s_ops import encode, port_cfg, s2s_cfg, s2s_model

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_grad():
    prev = torch.is_grad_enabled()
    torch.set_grad_enabled(False)
    yield
    torch.set_grad_enabled(prev)


@pytest.fixture(scope="module")
def tiny():
    return s2s_model(seed=2)


@pytest.mark.parametrize("candidates", [0, 6])
def test_s2s_searcher_matches_jax(tiny, candidates):
    jcfg, model, params, pm = tiny
    out = encode(model, params, 4, frames=60)
    kw = dict(beam_size=4, ctc_weight=0.4, ctc_candidates=candidates,
              temperature=1.15, max_steps_cap=8)
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
    assert searcher.last_steps == 8


def _norm():
    rng = np.random.default_rng(7)
    return (np.float32(120.0), rng.normal(size=20).astype(np.float32),
            rng.uniform(50.0, 200.0, size=20).astype(np.float32))


def _wavs():
    """Two requests of one length (not a whole second: the CTC mode would
    pad them), so the JAX searcher compiles once."""
    rng = np.random.default_rng(9)
    return [rng.normal(0.0, 0.1, size=14500).astype(np.float32) for _ in range(2)]


def _recognizer(tiny, **kw):
    jcfg, _, params, _ = tiny
    pcfg = port_cfg(jcfg)
    decode = DecodeConfig(s2s_test_beam_size=3, ctc_weight_decode=0.4,
                          ctc_candidates=5, temperature=1.15)
    return Recognizer(pcfg, FrontendConfig(n_fft=400, n_mels=20),
                      pi.import_asr_params(params, pcfg), normalizer=_norm(),
                      device="cpu", decode=decode, search="s2s", **kw)


def test_recognizer_s2s_matches_jax_recognize_flow(tiny):
    """recognize.py --s2s: each file alone through make_eval_step and the
    searcher built from the decode stanza (its max_steps_cap of 256 is
    above the encoder's 37 frames here)."""
    jcfg, model, params, _ = tiny
    eval_step = jax_trainer.make_eval_step(model, jax_trainer.FrontendConfig(n_fft=400, n_mels=20))
    searcher = JaxSearcher(model, beam_size=3, ctc_weight=0.4, ctc_candidates=5,
                           temperature=1.15, length_normalization=True,
                           max_decode_ratio=1.0, min_decode_ratio=0.0)
    norm = NormalizerState(*map(jnp.asarray, _norm()))
    expected = []
    for wav in _wavs():
        out = eval_step(params, norm, {"wav": jnp.asarray(wav)[None],
                                       "wav_lens": jnp.array([len(wav)], jnp.int32),
                                       "tokens_bos": jnp.zeros((1, 4), jnp.int32)})
        toks, lens, _ = searcher({"params": params}, out["enc_out"], out["enc_lengths"],
                                 ctc_log_probs=out["ctc_log_probs"])
        expected.append(jax_strip(np.array(toks), np.array(lens))[0])
    assert any(expected), "the searches gave only empty hypotheses: the test is vacuous"
    assert _recognizer(tiny).transcribe(_wavs()) == expected


def test_recognizer_s2s_groups_and_pads_like_the_ctc_mode(tiny):
    """batch=2: duration-sorted groups padded to 1 s, with wav_len-1 rows;
    each request's tokens are those of the search on its padded group."""
    rec = _recognizer(tiny, batch=2)
    wavs = _wavs() + [np.random.default_rng(3).normal(0.0, 0.1, 5000).astype(np.float32)]
    got = rec.transcribe(wavs)
    order = [2, 0, 1]  # by duration
    want = [None] * 3
    for group in (order[:2], order[2:]):
        mat = np.zeros((2, 16000), np.float32)
        lens = np.ones(2, np.int32)
        for r, i in enumerate(group):
            mat[r, :len(wavs[i])] = wavs[i]
            lens[r] = len(wavs[i])
        ids = rec.decode_batch(torch.from_numpy(mat), torch.from_numpy(lens))
        for r, i in enumerate(group):
            want[i] = ids[r]
    assert got == want
    assert rec.search == "s2s" and rec.searcher.beam_size == 3


def test_what_is_not_ported_raises(tiny):
    _, _, _, pm = tiny
    # The Conformer decoder is ported (tests/test_torch_conformer_decoder.py):
    # an unknown decoder is what the model refuses now.
    with pytest.raises(ValueError, match="decoder_module"):
        asr.ASRModel(port_cfg(s2s_cfg(decoder_module="lstm")))
    with pytest.raises(ValueError, match="save_torch_lm"):
        Recognizer(pm.cfg, FrontendConfig(n_mels=20), pm.state_dict(), device="cpu",
                   decode=DecodeConfig(lm_path="lm.msgpack"), search="s2s")
    with pytest.raises(ValueError, match="search"):
        Recognizer(pm.cfg, FrontendConfig(n_mels=20), pm.state_dict(), device="cpu",
                   search="greedy")
    # search="beam" is ported: the CTC prefix beam search of the CTC
    # recipe's test decoder (loop.Trainer.ctc_decoder) on the same forward.
    decode = DecodeConfig(test_beam_size=4)
    rec = Recognizer(pm.cfg, FrontendConfig(n_mels=20), pm.state_dict(), device="cpu",
                     batch=2, decode=decode, search="beam")
    wav = torch.from_numpy(np.random.default_rng(9).normal(0, 0.1, (2, 16000)).astype(np.float32))
    lens = torch.tensor([16000, 12000], dtype=torch.int32)
    hook = loop.Trainer.ctc_decoder(SimpleNamespace(cfg=SimpleNamespace(decode=decode)))
    assert rec.decode_batch(wav, lens) == hook(rec.model, None, rec.eval_step(wav, lens))


def test_bf16_search_casts_the_decode_weights_once(tiny):
    """bf16: the embedding and decoder weights become bf16 in a copy, the
    float32 heads and the caller's model stay float32, the encoder and the
    heads are the caller's own (not copied), and the search runs (finite
    scores)."""
    _, _, _, pm = tiny
    cfg16 = dataclasses.replace(pm.cfg, compute_dtype="bfloat16")
    m16 = asr.ASRModel(cfg16)
    m16.load_state_dict(pm.state_dict(), strict=True)
    cast = cast_decode_weights(m16.eval())
    assert cast is not m16
    assert cast.tgt_embed.weight.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in cast.decoder.parameters())
    assert cast.seq_head.weight.dtype == cast.ctc_head.weight.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    assert cast.encoder is m16.encoder and cast.frontend is m16.frontend
    assert cast.seq_head is m16.seq_head and cast.ctc_head is m16.ctc_head
    assert {n for n, _ in cast.named_parameters()} == {n for n, _ in m16.named_parameters()}
    assert cast_decode_weights(pm) is pm
    rng = np.random.default_rng(0)
    enc = torch.from_numpy(rng.normal(size=(1, 20, 16)).astype(np.float32)).bfloat16()
    lp = torch.log_softmax(torch.from_numpy(rng.normal(size=(1, 20, 12)).astype(np.float32)), -1)
    toks, lens, scores = S2SBeamSearcher(m16, beam_size=3, ctc_weight=0.4,
                                         max_steps_cap=5)(enc, torch.tensor([20]), lp)
    assert toks.shape == (1, 5) and torch.isfinite(scores).all()
