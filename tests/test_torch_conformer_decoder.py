"""The Conformer decoder (`decoder_module: conformer`) in the PyTorch port
against the JAX package, on the CPU, at the tiny size of
tests/test_torch_search_paths.py (d_model 32, 2 encoder and 2 decoder
layers, kernel 5, vocab 40, float32, seeded params).

- The teacher-forced seq log-probs of a padded batch: 2e-5.
- One S2S training micro-step (dropout 0, SpecAugment off, CTC weight
  0.3, label smoothing 0.1) against the losses of JAX `make_train_step`,
  composed forward-only from the functions its `loss_fn` calls: loss,
  loss_ctc and loss_att within 1e-4.
- The joint search at beam 3 (CTC weight 0.4, 8 candidates), without and
  with a tiny LM fused: tokens and lengths equal, scores within 1e-4; the
  searcher takes the full-prefix path by itself.
- The decoder is causal (a later target changes no earlier output) and
  refuses a decode cache; the Recognizer's S2S mode takes the model as
  it is.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.training import normalizer as jax_norm
from mamba_asr_tpu.training import trainer as jax_trainer

from mamba_asr_torch.configs.loader import DecodeConfig, FrontendConfig
from mamba_asr_torch.models.conformer import ConformerDecoder, ConformerDecoderLayer
from mamba_asr_torch.serving.recognizer import Recognizer
from mamba_asr_torch.training import trainer
from tests.test_torch_search_paths import (
    FEATS,
    FLENS,
    FUSION,
    SEARCH,
    VOCAB,
    assert_same_search,
    lm,  # noqa: F401  (module fixture)
    run_jax,
    run_port,
    tiny_model,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def conf():
    return tiny_model("conformer", seed=4)


def test_teacher_forced_log_probs_match_jax(conf):
    """A padded batch (enc_lengths 15 and 10): the memory's padding masked."""
    model, params, pm, out = conf
    want = jax.jit(lambda p, f, n, t: model.apply({"params": p}, f, n, t))(
        params, FEATS, FLENS, out["tokens_bos"])
    assert isinstance(pm.decoder, ConformerDecoder)
    for key in ("seq_log_probs", "ctc_log_probs"):
        np.testing.assert_allclose(out[key], np.asarray(want[key]), rtol=2e-5, atol=2e-5,
                                   err_msg=key)


def test_decoder_is_causal_and_has_no_cache(conf):
    _, _, pm, out = conf
    enc = torch.from_numpy(out["enc_out"].copy())
    toks = torch.from_numpy(out["tokens_bos"].copy()).long()
    changed = toks.clone()
    changed[:, 4] = (changed[:, 4] % (VOCAB - 4)) + 3
    with torch.no_grad():
        base, got = pm.decode(toks, enc), pm.decode(changed, enc)
    torch.testing.assert_close(got[:, :4], base[:, :4], rtol=0, atol=0)
    assert not torch.allclose(got[:, 4:], base[:, 4:])
    for call in (lambda: pm.init_decoder_cache(2, 8),
                 lambda: pm.prime_decoder_cache(enc, None),
                 lambda: pm.decode_step(toks[:, 0], 0, None)):
        with pytest.raises(ValueError, match="no decode cache"):
            call()
    with pytest.raises(ValueError, match="causal"):
        ConformerDecoderLayer(32, 32, 2, 5, causal=False)


def _batch(seed=8, bsz=2):
    rng = np.random.default_rng(seed)
    wav_lens = np.array([16000, 11000], np.int32)
    wav = np.zeros((bsz, 16000), np.float32)
    for i, length in enumerate(wav_lens):
        wav[i, :length] = rng.normal(0.0, 0.1, length)
    token_lens = np.array([5, 3], np.int32)
    tokens = np.zeros((bsz, 5), np.int32)
    bos, eos = np.zeros((bsz, 6), np.int32), np.zeros((bsz, 6), np.int32)
    for i, n in enumerate(token_lens):
        toks = rng.integers(3, VOCAB, size=n)
        tokens[i, :n] = toks
        bos[i, 0], bos[i, 1:n + 1] = 1, toks
        eos[i, :n], eos[i, n] = toks, 2
    return dict(wav=wav, wav_lens=wav_lens, tokens=tokens, token_lens=token_lens,
                tokens_bos=bos, tokens_eos=eos, eos_lens=token_lens + 1,
                weight=np.ones(bsz, np.float32))


def jax_step_losses(model, params, tcfg, fe, batch):
    """The losses of JAX `make_train_step`'s first micro-step (SpecAugment
    off, the normaliser updated on this batch), composed from the JAX
    functions its `loss_fn` calls and jitted forward only: the gradient's
    compile is what the step would add, and no gradient is compared
    here."""

    def losses(params, batch):
        feats = jax_trainer.compute_features(fe, batch["wav"])
        t = feats.shape[1]
        flens = jnp.minimum(jax_trainer.frame_lengths(fe, batch["wav_lens"]), t)
        fmask = (jnp.arange(t)[None, :] < flens[:, None]) & (batch["weight"][:, None] > 0)
        norm = jax_norm.update_normalizer(jax_norm.init_normalizer(fe.n_mels), feats, fmask)
        out = model.apply({"params": params}, jax_norm.apply_normalizer(norm, feats), flens,
                          batch["tokens_bos"], train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        loss_ctc = jax_trainer.ctc_loss(out["ctc_log_probs"], batch["tokens"],
                                        out["enc_lengths"], batch["token_lens"],
                                        reduction="batchmean", weight=batch["weight"])
        loss_att = jax_trainer.kldiv_loss(out["seq_log_probs"], batch["tokens_eos"],
                                          batch["eos_lens"],
                                          label_smoothing=tcfg.label_smoothing,
                                          reduction="batchmean", weight=batch["weight"])
        loss = jax_trainer.joint_ctc_attention_loss(loss_ctc, loss_att, tcfg.ctc_weight)
        return {"loss": loss, "loss_ctc": loss_ctc, "loss_att": loss_att}

    return jax.jit(losses)(params, {k: jnp.asarray(v) for k, v in batch.items()})


def test_train_step_losses_match_jax(conf):
    model, params, pm, _ = conf
    tcfg = jax_trainer.TrainConfig(lr=1e-3, warmup_steps=4, ctc_weight=0.3,
                                   label_smoothing=0.1)
    batch = _batch()
    want = jax_step_losses(model, params, tcfg,
                           jax_trainer.FrontendConfig(n_fft=400, n_mels=20), batch)
    ours = trainer.Trainer(pm.cfg, FrontendConfig(n_fft=400, n_mels=20),
                           trainer.TrainConfig(**dataclasses.asdict(tcfg)),
                           trainer.SpecAugmentConfig(enabled=False),
                           state_dict=pm.state_dict(), device="cpu")
    got = ours.train_step(batch)
    for key in ("loss", "loss_ctc", "loss_att"):
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("fused", [False, True], ids=["no_lm", "lm"])
def test_search_matches_jax(conf, lm, fused):  # noqa: F811
    model, params, pm, out = conf
    jlm, jlm_params, plm = lm
    kw = dict(SEARCH, **FUSION) if fused else dict(SEARCH)
    want = run_jax(model, params, out, (jlm, jlm_params) if fused else None, **kw)
    got = run_port(pm, out, plm if fused else None, **kw)
    assert_same_search(got, want)
    assert any(n > 2 for n in got[1]), f"degenerate hypotheses {got}"


def test_recognizer_takes_the_conformer_decoder(conf):
    _, _, pm, _ = conf
    rec = Recognizer(pm.cfg, FrontendConfig(n_fft=400, n_mels=20), pm.state_dict(),
                     device="cpu", search="s2s",
                     decode=DecodeConfig(s2s_test_beam_size=2, ctc_weight_decode=0.4,
                                         ctc_candidates=5))
    assert rec.searcher.decode_model.conformer_decoder  # the prefix re-score
    wav = np.random.default_rng(3).normal(0.0, 0.1, 12000).astype(np.float32)
    (ids,) = rec.transcribe([wav])
    assert isinstance(ids, list) and all(0 <= i < VOCAB for i in ids)
