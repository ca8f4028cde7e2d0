"""The port's joint CTC/attention (S2S) training pieces against the JAX
package's, on the CPU, at the tiny S2S size of tests/test_torch_s2s_ops.py
(d_model 16, one ConMamba layer, two decoder layers, vocab 12, float32).

- The time warps with the JAX package's own draws handed to the port
  (1e-5), including T = 2 * window + 3 and a bicubic centre at each edge
  of its range.
- `kldiv_loss` values (2e-5) and gradients (3e-4), with and without label
  smoothing and weights, a zero-weight row included.
- The teacher-forced forward in train mode (dropout 0, padded targets
  masked) and in eval mode against JAX `ASRModel` (2e-4 on
  seq_log_probs); the decoder's dropout places against JAX's.
- Ten S2S micro-steps of `Trainer.train_step` against JAX
  `make_train_step` (accumulation 2, Noam stepped twice per update):
  losses and parameters within 2e-4.
- `AccuracyStats`, `SubwordTokenizer` (where `tokenizers` imports), and a
  search that must see the decoder's current weights.
"""

from __future__ import annotations

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.data import augment as jax_augment
from mamba_asr_tpu.data import tokenizer as jax_tok
from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.training import losses as jax_losses
from mamba_asr_tpu.training import metrics as jax_metrics
from mamba_asr_tpu.training import normalizer as jax_norm
from mamba_asr_tpu.training import trainer as jax_trainer

from mamba_asr_torch.configs import loader
from mamba_asr_torch.data import augment, tokenizer
from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher
from mamba_asr_torch.models import asr, attention, layers, transformer
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.serving.recognizer import eval_step
from mamba_asr_torch.tools import train_to_floor
from mamba_asr_torch.training import losses, metrics, trainer
from mamba_asr_torch.training.normalizer import init_normalizer
from tests.test_torch_s2s_ops import VOCAB, port_cfg, s2s_cfg

torch.set_num_threads(1)

JAX_FE = jax_trainer.FrontendConfig(n_fft=400, n_mels=20)
PORT_FE = loader.FrontendConfig(n_fft=400, n_mels=20)


def _close(got, ref, rtol, atol_frac, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    atol = atol_frac * max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, jax model, init params) of the tiny S2S model."""
    jcfg = s2s_cfg()
    model = jax_asr.ASRModel(jcfg)
    rng = np.random.default_rng(0)
    feats = jnp.asarray(rng.normal(size=(1, 101, 20)).astype(np.float32))
    params = jax.jit(model.init)(jax.random.PRNGKey(1), feats, jnp.array([101]),
                                 jnp.ones((1, 4), jnp.int32))["params"]
    return jcfg, model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(jcfg, params, **kw):
    cfg = dataclasses.replace(port_cfg(jcfg), **kw)
    pm = asr.ASRModel(cfg)
    pm.load_state_dict(pi.import_asr_params(params, cfg), strict=True)
    return pm


# -- time warps ----------------------------------------------------------------


@pytest.mark.parametrize("t", [13, 40, 77])  # 13 = 2 * window + 3
@pytest.mark.parametrize("mode", ["bicubic", "linear"])
def test_time_warp_matches_jax(t, mode):
    """spec_augment's warp (no drops) under JAX keys against the port's
    warp given the draws those keys make: 1e-5. Over the keys the bicubic
    centre takes both ends of [window, T - window) at T 13."""
    window = 5
    feats = np.random.default_rng(t).normal(size=(3, t, 6)).astype(np.float32)
    centres = set()
    warp = jax.jit(functools.partial(
        jax_augment.spec_augment, num_time_drops=0, num_freq_drops=0,
        time_warp_window=window, apply_time_warp=True, time_warp_mode=mode))
    for seed in range(24):
        key = jax.random.PRNGKey(seed)
        ref = warp(jnp.asarray(feats), key)
        k_w = jax.random.split(key, 3)[2]
        if mode == "bicubic":
            k_c, k_s = jax.random.split(k_w)
            c = jax.random.randint(k_c, (), window, t - window)
            w = jax.random.randint(k_s, (), -window, window) + 1 + c
            centres.add(int(c))
            got = augment.time_warp_bicubic(torch.from_numpy(feats), torch.tensor(int(c)),
                                            torch.tensor(int(w)))
        else:
            center = jax.random.randint(k_w, (3,), window + 1, t - window - 1)
            shift = jax.random.randint(jax.random.fold_in(k_w, 1), (3,), -window, window + 1)
            got = augment.time_warp_linear(torch.from_numpy(feats),
                                           torch.tensor(np.array(center)),
                                           torch.tensor(np.array(center + shift)))
        _close(got.numpy(), ref, 1e-5, 1e-5, f"{mode} T {t} key {seed}")
    if mode == "bicubic" and t == 13:
        assert {window, t - window - 1} <= centres


def test_time_warp_draws_and_short_inputs():
    """The port's draws lie in JAX's ranges; the warp keeps shapes and
    leaves T <= 2 * window + 2 alone (as JAX does); drops come after it."""
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        c, w = augment.draw_time_warp(gen, 13, 5, 2)
        assert 5 <= int(c) < 8 and int(c) - 4 <= int(w) <= int(c) + 5
        center, target = augment.draw_time_warp(gen, 40, 5, 3, mode="linear")
        assert ((6 <= center) & (center < 34)).all()
        assert ((target - center).abs() <= 5).all()
    feats = torch.randn(2, 12, 4)
    out = augment.spec_augment(feats, gen, num_time_drops=0, num_freq_drops=0,
                               apply_time_warp=True, time_warp_window=5)
    assert torch.equal(out, feats)
    warped = augment.spec_augment(torch.randn(2, 50, 4), gen, apply_time_warp=True)
    assert warped.shape == (2, 50, 4) and torch.isfinite(warped).all()


# -- the KL loss ---------------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weights", ["none", "given", "zero_row"])
def test_kldiv_loss_matches_jax(smoothing, weights):
    """batchmean KL of log_softmax(logits) against the JAX package's: value
    2e-5, gradient with respect to the logits 3e-4 (relative + of the
    largest)."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 7, VOCAB)).astype(np.float32)
    targets = rng.integers(3, VOCAB, size=(4, 7)).astype(np.int32)
    lens = np.array([7, 3, 5, 1], np.int32)
    targets[np.arange(7)[None, :] >= lens[:, None]] = 0
    w = {"none": None, "given": np.array([1.0, 0.5, 2.0, 1.0], np.float32),
         "zero_row": np.array([1.0, 0.0, 1.0, 1.0], np.float32)}[weights]

    def jax_loss(x):
        return jax_losses.kldiv_loss(
            jax.nn.log_softmax(x), jnp.asarray(targets), jnp.asarray(lens),
            label_smoothing=smoothing, weight=None if w is None else jnp.asarray(w))

    ref, ref_grad = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = losses.kldiv_loss(torch.log_softmax(x, -1), torch.from_numpy(targets),
                            torch.from_numpy(lens), label_smoothing=smoothing,
                            weight=None if w is None else torch.from_numpy(w))
    got.backward()
    _close(got.item(), ref, 2e-5, 0.0)
    _close(x.grad.numpy(), ref_grad, 3e-4, 3e-4)
    if weights == "zero_row":
        assert not x.grad[1].any()
    joint = losses.joint_ctc_attention_loss(torch.tensor(2.0), got.detach(), 0.3)
    _close(joint.item(), jax_losses.joint_ctc_attention_loss(2.0, ref, 0.3), 2e-5, 0.0)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_kldiv_loss_reductions_match_jax(reduction):
    rng = np.random.default_rng(4)
    lp = jax.nn.log_softmax(rng.normal(size=(3, 5, VOCAB)).astype(np.float32))
    targets = rng.integers(0, VOCAB, size=(3, 5)).astype(np.int32)
    w = np.array([1.0, 0.0, 2.0], np.float32)
    ref = jax_losses.kldiv_loss(lp, jnp.asarray(targets), label_smoothing=0.1,
                                reduction=reduction, weight=jnp.asarray(w))
    got = losses.kldiv_loss(torch.from_numpy(np.asarray(lp)), torch.from_numpy(targets),
                            label_smoothing=0.1, reduction=reduction,
                            weight=torch.from_numpy(w))
    _close(got.numpy(), ref, 2e-5, 1e-6)


# -- the teacher-forced forward and dropout --------------------------------------


def _padded_targets(rng, bsz, s):
    lens = rng.integers(1, s, size=bsz).astype(np.int32)
    lens[0] = s - 1
    bos = np.zeros((bsz, s), np.int32)
    for i, n in enumerate(lens):
        bos[i, 0] = 1
        bos[i, 1:n + 1] = rng.integers(3, VOCAB, size=n)
    return bos


@pytest.mark.parametrize("train", [True, False])
def test_teacher_forced_forward_matches_jax(tiny, train):
    """seq_log_probs (and ctc_log_probs) of the full forward with padded
    targets and padded frames, train mode at dropout 0 (the targets'
    padding masked) and eval mode (not masked): 2e-4."""
    jcfg, model, params = tiny
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(3, 61, 20)).astype(np.float32)
    flens = np.array([61, 40, 25], np.int32)
    bos = _padded_targets(rng, 3, 8)
    apply = jax.jit(functools.partial(model.apply, train=train))
    ref = apply({"params": params}, jnp.asarray(feats), jnp.asarray(flens),
                jnp.asarray(bos), rngs={"dropout": jax.random.PRNGKey(0)})
    pm = _port_model(jcfg, params).train(train)
    with torch.no_grad():
        got = pm(torch.from_numpy(feats), torch.from_numpy(flens), torch.from_numpy(bos))
    for key in ("seq_log_probs", "ctc_log_probs"):
        _close(got[key].numpy(), ref[key], 2e-4, 2e-4, key)
    if not train:
        # The masks differ between the forms: train mode masks padded targets.
        pm.train()
        with torch.no_grad():
            masked = pm(torch.from_numpy(feats), torch.from_numpy(flens),
                        torch.from_numpy(bos))["seq_log_probs"]
        assert not torch.allclose(masked, got["seq_log_probs"], atol=1e-3)


def test_decoder_drops_where_jax_drops(tiny, monkeypatch):
    """Every dropout the decoder applies in train mode, as (rate, shape of
    the dropped tensor), equals the JAX decoder's list: per layer the
    residual drop of self-attention, cross-attention and the FFN, both
    attentions' weights and the FFN's hidden units (JAX's four places);
    eval mode applies none."""
    jcfg, _, params = tiny
    jcfg = dataclasses.replace(jcfg, dropout=0.25)
    jmodel = jax_asr.ASRModel(jcfg)
    rng = np.random.default_rng(6)
    enc = rng.normal(size=(2, 9, 16)).astype(np.float32)
    bos = _padded_targets(rng, 2, 6)
    seen = []
    orig = fnn.Dropout.__call__

    def record(self, inputs, deterministic=None, rng=None):
        det = fnn.merge_param("deterministic", self.deterministic, deterministic)
        if not det and self.rate > 0:
            seen.append((self.rate, tuple(inputs.shape)))
        return orig(self, inputs, deterministic=deterministic, rng=rng)

    monkeypatch.setattr(fnn.Dropout, "__call__", record)
    decode = jax.jit(functools.partial(jmodel.apply, train=True,
                                       method=jax_asr.ASRModel.decode))
    decode({"params": params}, jnp.asarray(bos), jnp.asarray(enc), jnp.array([9, 6]),
           rngs={"dropout": jax.random.PRNGKey(0)})
    monkeypatch.undo()
    jax_seen = sorted(seen)
    seen.clear()

    plain = layers.dropout

    def port_record(x, p, training):
        if training and p > 0:
            seen.append((p, tuple(x.shape)))
        return plain(x, p, training)

    for module in (transformer, attention, layers):
        monkeypatch.setattr(module, "dropout", port_record)
    pm = _port_model(jcfg, params, dropout=0.25)
    for train in (False, True):
        pm.train(train)
        pm.decode(torch.from_numpy(bos), torch.from_numpy(enc), torch.tensor([9, 6]))
        if not train:
            assert seen == []
    per_layer = {shape for _, shape in seen}
    assert len(seen) == 6 * jcfg.num_decoder_layers
    assert {(2, 6, 16), (2, 2, 6, 6), (2, 2, 6, 9), (2, 6, 16 * 1)} <= per_layer
    assert sorted(seen) == jax_seen


# -- the training step ---------------------------------------------------------------


def _s2s_batches(n, seed=8, bsz=3):
    """Padded S2S batches from a seed: one row zero-weighted in some."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        wav_lens = rng.integers(9000, 16001, size=bsz).astype(np.int32)
        wav = np.zeros((bsz, 16000), np.float32)
        for i, length in enumerate(wav_lens):
            wav[i, :length] = rng.normal(0.0, 0.1, length)
        token_lens = rng.integers(2, 7, size=bsz).astype(np.int32)
        tokens = np.zeros((bsz, 6), np.int32)
        bos = np.zeros((bsz, 7), np.int32)
        eos = np.zeros((bsz, 7), np.int32)
        for i, n_tok in enumerate(token_lens):
            toks = rng.integers(3, VOCAB, size=n_tok)
            tokens[i, :n_tok] = toks
            bos[i, 0], bos[i, 1:n_tok + 1] = 1, toks
            eos[i, :n_tok], eos[i, n_tok] = toks, 2
        weight = np.ones(bsz, np.float32)
        weight[rng.integers(bsz)] = rng.choice([0.0, 1.0])
        out.append(dict(wav=wav, wav_lens=wav_lens, tokens=tokens, token_lens=token_lens,
                        tokens_bos=bos, tokens_eos=eos, eos_lens=token_lens + 1,
                        weight=weight))
    return out


def test_s2s_training_lockstep_matches_jax(tiny):
    """10 micro-steps of the S2S Trainer (CPU) against JAX make_train_step
    from the same params and batches: fp32, dropout 0, SpecAugment off,
    ctc_weight 0.3, label smoothing 0.1, accumulation 2 and the schedule
    stepped twice per update (the S2S YAML's scheduler_steps_per_update).
    loss, loss_ctc, loss_att and grad_norm at every step, and the
    parameters after the last update, within 2e-4 (relative + of each
    tensor's largest value), save the attention key biases (see below)."""
    jcfg, model, params = tiny
    tcfg = jax_trainer.TrainConfig(lr=1e-3, warmup_steps=4, grad_accumulation_factor=2,
                                   ctc_weight=0.3, label_smoothing=0.1,
                                   scheduler_steps_per_update=2)
    tx = jax_trainer.make_optimizer(tcfg)
    state = jax_trainer.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=tx.init(params),
        normalizer=jax_norm.init_normalizer(20), step=jnp.zeros((), jnp.int32))
    step_fn = jax_trainer.make_train_step(model, tx, JAX_FE, tcfg,
                                          jax_trainer.SpecAugmentConfig(enabled=False))
    pcfg = port_cfg(jcfg)
    ours = trainer.Trainer(pcfg, PORT_FE, trainer.TrainConfig(**dataclasses.asdict(tcfg)),
                           trainer.SpecAugmentConfig(enabled=False),
                           state_dict=pi.import_asr_params(params, pcfg), device="cpu")
    rng = jax.random.PRNGKey(0)
    for i, batch in enumerate(_s2s_batches(10)):
        state, ref = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()},
                             rng, jnp.bool_(True))
        got = ours.train_step(batch)
        if i == 0:
            d, acc = pcfg.d_model, dict(zip((n for n, _ in ours.model.named_parameters()),
                                            ours.optimizer.acc))
            key_grads = {}
            for n, g in acc.items():
                if n.endswith("att.in_proj_bias"):
                    key_grads[n], key_grads[n + ".q"] = g[d:2 * d].numpy().copy(), g[:d].numpy().copy()
        assert bool(got["updated"]) == (i % 2 == 1)
        for key in ("loss", "loss_ctc", "loss_att", "grad_norm"):
            _close(got[key].item(), ref[key], 2e-4, 0.0, f"{key} @ step {i}")
    assert ours.optimizer.scheduler.last_epoch == 5
    want = pi.import_asr_params(jax.tree_util.tree_map(np.asarray, state.params), pcfg)
    d = pcfg.d_model
    for name, p in ours.model.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith("att.in_proj_bias"):
            # The key bias adds q.b_k to every score of a row, which the
            # softmax cancels: its gradient is rounding noise, and Adam at
            # eps 1e-9 turns noise into steps of up to lr whose sign follows
            # the rounding. Both packages' key biases then move by at most
            # lr per update; the query and value biases are held as the rest.
            assert np.abs(got[d:2 * d] - ref[d:2 * d]).max() <= 2 * 5 * tcfg.lr, name
            assert abs(key_grads[name]).max() < 1e-5 * abs(key_grads[name + ".q"]).max()
            got, ref = np.delete(got, np.s_[d:2 * d]), np.delete(ref, np.s_[d:2 * d])
        _close(got, ref, 2e-4, 2e-4, name)


def test_s2s_step_with_warp_dropout_and_drops_updates():
    """The S2S YAML's training settings at the tiny size (dropout 0.1,
    SpecAugment with the bicubic warp, label smoothing 0.1): finite
    losses; parameters change on emit steps only."""
    cfg = dataclasses.replace(port_cfg(s2s_cfg()), dropout=0.1)
    tr = trainer.Trainer(cfg, PORT_FE, trainer.TrainConfig(
        warmup_steps=5, grad_accumulation_factor=2, ctc_weight=0.3, label_smoothing=0.1),
        trainer.SpecAugmentConfig(apply_time_warp=True), device="cpu")
    before = [p.detach().clone() for p in tr.model.parameters()]
    for i, batch in enumerate(_s2s_batches(4, seed=9)):
        m = tr.train_step(batch)
        assert set(m) == {"loss", "loss_ctc", "loss_att", "grad_norm", "updated"}
        assert all(torch.isfinite(m[k]) for k in ("loss", "loss_ctc", "loss_att"))
        changed = any(not torch.equal(a, p) for a, p in zip(before, tr.model.parameters()))
        assert changed == (i % 2 == 1) == bool(m["updated"])
        before = [p.detach().clone() for p in tr.model.parameters()]


# -- metrics and tokenizers -----------------------------------------------------------


def test_accuracy_stats_match_jax():
    rng = np.random.default_rng(10)
    ours, theirs = metrics.AccuracyStats(), jax_metrics.AccuracyStats()
    for with_len in (True, False):
        lp = rng.normal(size=(3, 5, VOCAB)).astype(np.float32)
        targets = rng.integers(0, VOCAB, size=(3, 5)).astype(np.int32)
        targets[0] = lp[0].argmax(-1)
        lens = np.array([5, 2, 0], np.int32) if with_len else None
        weight = np.array([1.0, 1.0, 0.0], np.float32)
        ours.append(torch.from_numpy(lp), targets, lens, weight)
        theirs.append(lp, targets, lens, weight)
    assert (ours.correct, ours.total) == (theirs.correct, theirs.total)
    assert ours.summarize() == theirs.summarize() > 0.0


@pytest.mark.parametrize("model_type", ["bpe", "unigram"])
def test_subword_tokenizer_matches_jax(tmp_path, model_type):
    """Fitted on the tone corpus's transcripts, the same ids and text as the
    JAX package's; each package loads the other's file."""
    pytest.importorskip("tokenizers")
    train_to_floor.build_corpus(str(tmp_path / "c"), n_train=16, n_dev=1, n_test=1)
    with open(tmp_path / "c" / "train-clean-100" / "1" / "2" / "1-2.trans.txt") as f:
        corpus = [line.split(" ", 1)[1].strip() for line in f]
    ours = tokenizer.SubwordTokenizer.train(corpus, vocab_size=30, model_type=model_type)
    theirs = jax_tok.SubwordTokenizer.train(corpus, vocab_size=30, model_type=model_type)
    assert ours.vocab_size == theirs.vocab_size
    for text in corpus[:6] + ["CAFE FADE BEAD"]:
        ids = ours.encode(text)
        assert ids == theirs.encode(text) and min(ids) >= 3
        assert ours.decode([1] + ids + [2, 0]) == theirs.decode([1] + ids + [2, 0]) == text
    ours.save(str(tmp_path / "a.json"))
    theirs.save(str(tmp_path / "b.json"))
    a = tokenizer.load_tokenizer(str(tmp_path / "b.json"))
    b = jax_tok.load_tokenizer(str(tmp_path / "a.json"))
    assert isinstance(a, tokenizer.SubwordTokenizer)
    assert a.encode(corpus[0]) == b.encode(corpus[0]) == theirs.encode(corpus[0])


# -- the searcher sees the current weights ------------------------------------------


def test_recipe_search_uses_the_current_decoder_weights(tmp_path):
    """In bf16 a searcher casts a copy of the decode weights when it is
    built. After the decoder's weights change, the recipe's validation
    search (`loop.Trainer.s2s_decoder`) equals a searcher built now, and
    a searcher built before the change gives other hypotheses: a cached
    searcher would fail this test."""
    from mamba_asr_torch.training import loop

    exp = loader.load_config("hparams/S2S/conmamba_small.yaml", {
        "model.vocab_size": VOCAB, "model.d_model": 16, "model.nhead": 2,
        "model.num_encoder_layers": 1, "model.num_decoder_layers": 2, "model.d_ffn": 16,
        "model.mamba.d_state": 4, "model.n_mels": 20, "frontend.n_mels": 20,
        "model.compute_dtype": "bfloat16", "decode.valid_beam_size": 3,
        "data.output_folder": str(tmp_path)})
    tr = loop.Trainer(exp, tokenizer.CharTokenizer(list("ABCDEFGH")), device="cpu")
    model = tr.step.model.eval()
    batch = _s2s_batches(1, seed=11, bsz=4)[0]
    out = eval_step(model, exp.frontend, init_normalizer(20),
                    torch.from_numpy(batch["wav"]), torch.from_numpy(batch["wav_lens"]))
    stale = tr.make_s2s_searcher(model, test=False)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(12)
        for p in model.decoder.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.5)

    def run(searcher):
        toks, lens, scores = searcher(out["enc_out"], out["enc_lengths"], out["ctc_log_probs"])
        return toks.tolist(), lens.tolist(), scores.tolist()

    fresh = S2SBeamSearcher(model, beam_size=3, ctc_weight=exp.decode.ctc_weight_decode,
                            ctc_candidates=exp.decode.ctc_candidates,
                            temperature=exp.decode.temperature)
    want = run(fresh)
    assert run(stale) != want
    got = tr.s2s_decoder(test=False)(model, batch, out)
    from mamba_asr_torch.decoding.s2s_beam import strip_special

    assert got == strip_special(np.array(want[0]), np.array(want[1]))
    assert got != strip_special(*map(np.array, run(stale)[:2]))
