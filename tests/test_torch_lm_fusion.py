"""LM shallow fusion, n-best rescoring and LM training in the PyTorch port
against the JAX package, on the CPU, at tiny sizes: the S2S model of
tests/test_torch_s2s_ops.py (d_model 16, vocab 12) with the Transformer
and with the Mamba decoder, and the LM of tests/test_torch_lm.py at that
vocabulary (d_model 16, 2 layers); params drawn from seeds
(`test_torch_lm.seeded_params`).

- The fused searcher against JAX's `S2SBeamSearcher(lm_model=...)`, both
  decoders, the CTC scorer over the full vocabulary and over 5
  candidates (the LM term enters before the candidates are picked): tokens
  and lengths equal, scores within 1e-4. The LM moves the scores.
- One bf16 search (model and LM in bf16): tokens equal, scores within
  2e-2.
- `Recognizer(search="s2s")` with `decode.lm_path` (a `.pt` written by
  JAX's `save_torch_lm`) against recognize.py --s2s's flow (the `.pt`
  read by `load_torch_lm`, as JAX's `cli.load_lm` reads it;
  make_eval_step; the searcher with the LM).
- `rescore_nbest` and `lm_nbest_scores` against JAX, a hypothesis of
  length U (no eos term) and one of length 0 among them.
- `train_lm`: 5 steps in lockstep with the JAX script `train_lm.py` run
  on the same corpus and seed, from the script's own init (imported),
  dropout 0: the port's losses within 1e-4 of the script's printed ones
  (4 decimals). Then the port's CLI writes an lm.pt that `cli.load_lm`
  reads.
"""

from __future__ import annotations

import dataclasses
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.configs import loader as jax_loader
from mamba_asr_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
from mamba_asr_tpu.decoding import rescore as jax_rescore
from mamba_asr_tpu.decoding.s2s_beam import S2SBeamSearcher as JaxSearcher
from mamba_asr_tpu.decoding.s2s_beam import strip_special as jax_strip
from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.models import lm as jax_lm
from mamba_asr_tpu.models.torch_export import save_torch_lm
from mamba_asr_tpu.models.torch_import import load_torch_lm
from mamba_asr_tpu.training import trainer as jax_trainer
from mamba_asr_tpu.training.normalizer import NormalizerState

from mamba_asr_torch import cli
from mamba_asr_torch import train_lm as port_train_lm
from mamba_asr_torch.configs.loader import DecodeConfig, ExperimentConfig, FrontendConfig
from mamba_asr_torch.decoding import rescore
from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher
from mamba_asr_torch.models import asr
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.serving.recognizer import Recognizer
from tests.test_torch_lm import D, FFN, H, LAYERS, jax_lm_params, port_of, seeded_params
from tests.test_torch_s2s_ops import VOCAB, encode, port_cfg, s2s_cfg

torch.set_num_threads(1)

FUSION = dict(lm_weight=0.6, temperature_lm=1.15)
SEARCH = dict(beam_size=3, ctc_weight=0.4, temperature=1.15, max_steps_cap=8, **FUSION)


@pytest.fixture(autouse=True)
def _no_grad():
    prev = torch.is_grad_enabled()
    torch.set_grad_enabled(False)
    yield
    torch.set_grad_enabled(prev)


def seeded_model(decoder, seed=2):
    """(jax cfg, jax model, params, port model): the tiny S2S model with the
    given decoder, its params drawn from the seed (`seeded_params`),
    carried into the port."""
    jcfg = s2s_cfg(decoder_module=decoder)
    model = jax_asr.ASRModel(jcfg)
    params = seeded_params(model, seed, jnp.zeros((2, 45, 20)), jnp.array([45, 31]),
                           jnp.zeros((2, 5), jnp.int32))
    pcfg = port_cfg(jcfg)
    pm = asr.ASRModel(pcfg)
    pm.load_state_dict(pi.import_asr_params(params, pcfg), strict=True)
    return jcfg, model, params, pm.eval()


@pytest.fixture(scope="module")
def models():
    return {decoder: seeded_model(decoder) for decoder in ("transformer", "mamba")}


@pytest.fixture(scope="module")
def lm():
    model, params = jax_lm_params(seed=5, vocab=VOCAB)
    return model, params, port_of(params, vocab=VOCAB)


def _search(jax_side, port_side, out, **kw):
    """(JAX's best tokens, lengths, scores), (the port's)."""
    (model, params), (jlm, jlm_params) = jax_side
    pm, plm = port_side
    got = JaxSearcher(model, lm_model=jlm, **kw)(
        {"params": params}, jnp.asarray(out["enc_out"]), jnp.asarray(out["enc_lengths"]),
        ctc_log_probs=jnp.asarray(out["ctc_log_probs"]),
        lm_params=None if jlm is None else {"params": jlm_params})
    want = [np.asarray(x) for x in got]
    found = S2SBeamSearcher(pm, lm_model=plm, **kw)(
        torch.from_numpy(np.asarray(out["enc_out"], np.float32)).to(pm.cfg.dtype),
        torch.from_numpy(out["enc_lengths"]), torch.from_numpy(out["ctc_log_probs"]))
    return want, [x.float().numpy() if x.is_floating_point() else x.numpy() for x in found]


@pytest.mark.parametrize("candidates", [0, 5])
@pytest.mark.parametrize("decoder", ["transformer", "mamba"])
def test_fused_searcher_matches_jax(models, lm, decoder, candidates):
    _, model, params, pm = models[decoder]
    jlm, jlm_params, plm = lm
    out = encode(model, params, 4, frames=60)
    kw = dict(SEARCH, ctc_candidates=candidates)
    want, got = _search(((model, params), (jlm, jlm_params)), (pm, plm), out, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)
    ids = jax_strip(want[0], want[1])
    assert any(len(x) > 1 for x in ids), f"degenerate hypotheses {ids}"
    plain = S2SBeamSearcher(pm, **dict(kw, lm_weight=0.0))(
        torch.from_numpy(out["enc_out"]), torch.from_numpy(out["enc_lengths"]),
        torch.from_numpy(out["ctc_log_probs"]))
    assert not np.allclose(plain[2].numpy(), got[2], atol=1e-3), "the LM changed nothing"


def test_fused_bf16_search_matches_jax(models, lm):
    """The Transformer decoder and the LM in bf16: the decode weights of
    both cast once, `output_proj` in float32."""
    jcfg, _, params, pm = models["transformer"]
    jcfg16 = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    model16 = jax_asr.ASRModel(jcfg16)
    pm16 = asr.ASRModel(dataclasses.replace(pm.cfg, compute_dtype="bfloat16"))
    pm16.load_state_dict(pm.state_dict(), strict=True)
    _, jlm_params, plm = lm
    jlm16 = jax_lm.TransformerLM(vocab_size=VOCAB, d_model=D, nhead=H, num_layers=LAYERS,
                                 d_ffn=FFN, dtype=jnp.bfloat16)
    plm16 = port_of(jlm_params, vocab=VOCAB, dtype=torch.bfloat16)
    out = encode(model16, params, 4, frames=60)
    want, got = _search(((model16, params), (jlm16, jlm_params)), (pm16.eval(), plm16), out,
                        **dict(SEARCH, ctc_candidates=5))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=2e-2, atol=2e-2)
    assert all(p.dtype == torch.float32 for p in plm16.parameters())


def _norm():
    rng = np.random.default_rng(7)
    return (np.float32(120.0), rng.normal(size=20).astype(np.float32),
            rng.uniform(50.0, 200.0, size=20).astype(np.float32))


def test_recognizer_fuses_the_lm_like_recognize_py(models, lm, tmp_path):
    """recognize.py --s2s with decode.lm_path: JAX's cli.load_lm reads the
    .pt, the searcher fuses it at lm_weight / temperature_lm; each request
    alone. The port's Recognizer loads the same file."""
    jcfg, model, params, _ = models["transformer"]
    _, jlm_params, _ = lm
    path = str(tmp_path / "lm.pt")
    save_torch_lm(jlm_params, path, num_layers=LAYERS)
    lm_fields = dict(lm_path=path, lm_d_model=D, lm_nhead=H, lm_layers=LAYERS,
                     lm_d_ffn=FFN, lm_dtype="float32")
    # min_decode_ratio: eos is banned for the first 4 of 24 steps (the
    # seeded model would end every hypothesis at once).
    search = dict(s2s_test_beam_size=3, ctc_weight_decode=0.4, ctc_candidates=5,
                  temperature=1.15, temperature_lm=1.15, lm_weight=0.6,
                  min_decode_ratio=0.2)
    d = jax_loader.DecodeConfig(**search, **lm_fields)
    # JAX's cli.load_lm for a .pt: load_torch_lm into the decode stanza's LM.
    jlm = jax_lm.TransformerLM(vocab_size=VOCAB, d_model=D, nhead=H, num_layers=LAYERS,
                               d_ffn=FFN)
    jparams = {"params": load_torch_lm(path, LAYERS)}
    searcher = JaxSearcher(model, beam_size=d.s2s_test_beam_size, ctc_weight=d.ctc_weight_decode,
                           ctc_candidates=d.ctc_candidates, lm_weight=d.lm_weight,
                           temperature=d.temperature, temperature_lm=d.temperature_lm,
                           length_normalization=d.length_normalization,
                           max_decode_ratio=d.max_decode_ratio,
                           min_decode_ratio=d.min_decode_ratio, lm_model=jlm)
    eval_step = jax_trainer.make_eval_step(model, jax_trainer.FrontendConfig(n_fft=400,
                                                                             n_mels=20))
    norm = NormalizerState(*map(jnp.asarray, _norm()))
    rng = np.random.default_rng(9)
    wavs = [rng.normal(0.0, 0.1, size=14500).astype(np.float32) for _ in range(2)]
    expected = []
    for wav in wavs:
        out = eval_step(params, norm, {"wav": jnp.asarray(wav)[None],
                                       "wav_lens": jnp.array([len(wav)], jnp.int32),
                                       "tokens_bos": jnp.zeros((1, 4), jnp.int32)})
        toks, lens, _ = searcher({"params": params}, out["enc_out"], out["enc_lengths"],
                                 ctc_log_probs=out["ctc_log_probs"], lm_params=jparams)
        expected.append(jax_strip(np.array(toks), np.array(lens))[0])
    assert any(expected), "the searches gave only empty hypotheses: the test is vacuous"
    pcfg = port_cfg(jcfg)
    rec = Recognizer(pcfg, FrontendConfig(n_fft=400, n_mels=20),
                     pi.import_asr_params(params, pcfg), normalizer=_norm(), device="cpu",
                     decode=DecodeConfig(**search, **lm_fields), search="s2s")
    assert rec.searcher.lm_model is not None and rec.searcher.lm_weight == 0.6
    assert rec.transcribe(wavs) == expected


def test_rescore_nbest_matches_jax(lm):
    jlm, jlm_params, plm = lm
    rng = np.random.default_rng(11)
    b, n, u = 2, 4, 5
    toks = rng.integers(3, VOCAB, (b, n, u)).astype(np.int32)
    lens = np.array([[5, 3, 0, 2], [1, 5, 4, 3]], np.int32)
    ctc = rng.normal(-5.0, 1.0, (b, n)).astype(np.float32)
    want = jax_rescore.lm_nbest_scores(jlm, {"params": jlm_params}, jnp.asarray(toks),
                                       jnp.asarray(lens), temperature=1.15)
    got = rescore.lm_nbest_scores(plm, torch.from_numpy(toks), torch.from_numpy(lens), 1.15)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for bonus in (0.0, 0.5):
        w_toks, w_lens = jax_rescore.rescore_nbest(
            jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(ctc), jlm, {"params": jlm_params},
            lm_weight=0.6, temperature_lm=1.15, length_bonus=bonus)
        g_toks, g_lens = rescore.rescore_nbest(
            torch.from_numpy(toks), torch.from_numpy(lens), torch.from_numpy(ctc), plm,
            lm_weight=0.6, temperature_lm=1.15, length_bonus=bonus)
        np.testing.assert_array_equal(g_toks.numpy(), np.asarray(w_toks))
        np.testing.assert_array_equal(g_lens.numpy(), np.asarray(w_lens))
    g_toks, _ = rescore.rescore_nbest(torch.from_numpy(toks), torch.from_numpy(lens),
                                      torch.from_numpy(ctc))
    np.testing.assert_array_equal(g_toks.numpy(), toks[np.arange(b), ctc.argmax(1)])


LM_FLAGS = ["--d_model", str(D), "--nhead", str(H), "--layers", str(LAYERS),
            "--d_ffn", str(FFN), "--seq_len", "8", "--batch_size", "4", "--steps", "5",
            "--lr", "0.001", "--warmup", "2", "--dropout", "0.0", "--log_every", "1",
            "--seed", "0"]


def test_train_lm_in_lockstep_with_the_jax_script(tmp_path, monkeypatch, capsys):
    lines = ["AB BA CAD", "DEC FAD", "BEEF CAFE DAB AB", "CAD BA", "FAD DAB BEEF"] * 3
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(lines) + "\n")
    tok_path = str(tmp_path / "tok.json")
    JaxCharTokenizer.fit(lines).save(tok_path)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--corpus", str(corpus), "--tokenizer",
                                      tok_path, "--output", str(tmp_path / "jax"), *LM_FLAGS])
    inits = []  # the script's own init, which the port starts from

    def init(self, *args, **kwargs):
        out = jax_init(self, *args, **kwargs)
        inits.append(out["params"])
        return out

    jax_init = jax_lm.TransformerLM.init
    monkeypatch.setattr(jax_lm.TransformerLM, "init", init)
    runpy.run_path("train_lm.py", run_name="__main__")
    printed = capsys.readouterr().out
    jax_losses = [float(x) for x in re.findall(r"^step \d+ loss ([0-9.]+)", printed, re.M)]
    assert len(jax_losses) == 5

    tok = port_train_lm.load_tokenizer(tok_path)
    vocab = tok.vocab_size
    (init,) = inits
    with torch.enable_grad():
        lm = port_train_lm.TransformerLM(vocab, D, H, LAYERS, FFN, dropout=0.0)
        lm.load_state_dict(pi.import_lm_params(init, LAYERS), strict=True)
        res = port_train_lm.train_lm(
            port_train_lm.corpus_stream(str(corpus), tok), lm, str(tmp_path / "port"),
            seq_len=8, batch_size=4, steps=5, lr=1e-3, warmup=2, log_every=1, seed=0,
            device="cpu")
    np.testing.assert_allclose(res["losses"], jax_losses, rtol=0, atol=1e-4)

    with torch.enable_grad():
        port_train_lm.main(["--corpus", str(corpus), "--tokenizer", tok_path, "--output",
                            str(tmp_path / "cli"), *LM_FLAGS, "--device", "cpu"])
    exp = ExperimentConfig(model=dataclasses.replace(ExperimentConfig().model,
                                                     vocab_size=vocab),
                           decode=DecodeConfig(lm_path=str(tmp_path / "cli" / "lm.pt"),
                                               lm_d_model=D, lm_nhead=H, lm_layers=LAYERS,
                                               lm_d_ffn=FFN))
    loaded = cli.load_lm(exp, "cpu")
    assert loaded.vocab_size == vocab and loaded.dtype == torch.bfloat16
    assert cli.load_lm(ExperimentConfig(), "cpu") is None
