"""The port's CTC training step against the JAX package's, on the CPU, at
a tiny size (d_model 16, 2 layers, d_state 4, n_mels 20, float32).

Inputs and noise are made with numpy from a seed and handed to both
sides; JAX params cross into the port through `models.params_import`.
Random bits differ between the frameworks, so SpecAugment is compared
with the spans given, and the lockstep run has dropout and SpecAugment
off.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mamba_asr_tpu.configs.loader import load_config as jax_load_config
from mamba_asr_tpu.data import augment as jax_augment
from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.models import mamba as jax_mamba
from mamba_asr_tpu.ops import ctc as jax_ctc
from mamba_asr_tpu.training import normalizer as jax_norm
from mamba_asr_tpu.training import schedule as jax_schedule
from mamba_asr_tpu.training import trainer as jax_trainer

from mamba_asr_torch.configs import loader
from mamba_asr_torch.data import augment
from mamba_asr_torch.models import asr, layers, mamba
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.ops import ctc
from mamba_asr_torch.training import normalizer, optim, schedule, trainer

torch.set_num_threads(1)

JAX_CFG = jax_asr.ASRConfig(
    vocab_size=13, n_mels=20, d_model=16, nhead=2, num_encoder_layers=2,
    d_ffn=24, dropout=0.0, activation="gelu", encoder_module="conmamba",
    kernel_size=7, frontend_channels=(4, 6),
    mamba=jax_mamba.MambaConfig(d_state=4, d_conv=4, expand=2, dt_rank=2),
    compute_dtype="float32",
)
JAX_FE = jax_trainer.FrontendConfig(n_fft=400, n_mels=20)
PORT_FE = loader.FrontendConfig(n_fft=400, n_mels=20)


def _port_cfg(c: jax_asr.ASRConfig, **kw) -> asr.ASRConfig:
    fields = {f.name: getattr(c, f.name) for f in dataclasses.fields(asr.ASRConfig)}
    fields["mamba"] = mamba.MambaConfig(**{
        f.name: getattr(c.mamba, f.name) for f in dataclasses.fields(mamba.MambaConfig)})
    fields.update(kw)
    return asr.ASRConfig(**fields)


def _port_train(c: jax_trainer.TrainConfig) -> trainer.TrainConfig:
    return trainer.TrainConfig(**dataclasses.asdict(c))


@pytest.fixture(scope="module")
def jax_params():
    model = jax_asr.ASRModel(JAX_CFG)
    feats = jnp.zeros((1, 101, 20))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), feats, jnp.array([101]))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _import(tree):
    return pi.import_asr_params(tree, _port_cfg(JAX_CFG))


def _close(got, ref, rtol, atol_frac, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    atol = atol_frac * max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


# -- CTC ---------------------------------------------------------------------


def _ctc_case(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(4, 12, 6)).astype(np.float32)
    labels = rng.integers(1, 6, size=(4, 5)).astype(np.int32)
    labels[0, :3] = [2, 2, 3]  # a repeat: needs a blank between
    in_lens = np.array([12, 9, 3, 12], np.int32)
    lab_lens = np.array([3, 5, 4, 0], np.int32)  # row 2 is infeasible
    weight = np.array([1.0, 0.5, 1.0, 2.0], np.float32)
    return logits, labels, in_lens, lab_lens, weight


@pytest.mark.parametrize("reduction", ["none", "sum", "batchmean", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_ctc_loss_matches_jax(reduction, weighted):
    """Value and gradient with respect to the logits (before log_softmax),
    with a repeated label, an empty label row and an infeasible row
    (zeroed): 1e-5 relative + 1e-5 of the largest value (float32)."""
    logits, labels, in_lens, lab_lens, weight = _ctc_case()
    w = weight if weighted else None
    cot = np.random.default_rng(1).normal(size=(4,)).astype(np.float32)

    def jax_loss(x):
        out = jax_ctc.ctc_loss(jax.nn.log_softmax(x), jnp.asarray(labels),
                               jnp.asarray(in_lens), jnp.asarray(lab_lens),
                               reduction=reduction,
                               weight=None if w is None else jnp.asarray(w))
        return jnp.sum(out * cot) if reduction == "none" else out

    ref, ref_grad = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    out = ctc.ctc_loss(F.log_softmax(x, -1), torch.from_numpy(labels),
                       torch.from_numpy(in_lens), torch.from_numpy(lab_lens),
                       reduction=reduction,
                       weight=None if w is None else torch.from_numpy(w))
    loss = (out * torch.from_numpy(cot)).sum() if reduction == "none" else out
    loss.backward()
    _close(loss.item(), ref, 1e-5, 1e-5)
    _close(x.grad.numpy(), ref_grad, 1e-5, 1e-5)


def test_torch_ctc_loss_matches_plain_recursion():
    """torch's F.ctc_loss (the card's path: int64 padded targets,
    reduction none, zero_infinity) against the plain alpha recursion,
    values and logit gradients, 1e-5 relative + 1e-5 of the largest."""
    logits, labels, in_lens, lab_lens, _ = _ctc_case(2)
    cot = torch.from_numpy(np.random.default_rng(3).normal(size=(4,)).astype(np.float32))
    outs = []
    for use_torch in (True, False):
        x = torch.from_numpy(logits).requires_grad_()
        lp = F.log_softmax(x, -1)
        args = (torch.from_numpy(labels), torch.from_numpy(in_lens),
                torch.from_numpy(lab_lens))
        if use_torch:
            nll = F.ctc_loss(lp.transpose(0, 1), args[0].long(), args[1].long(),
                             args[2].long(), reduction="none", zero_infinity=True)
        else:
            nll = ctc.ctc_forward_score(lp, *args)
            nll = torch.where(nll > 5e29, torch.zeros_like(nll), nll)
        (nll * cot).sum().backward()
        outs.append((nll.detach().numpy(), x.grad.numpy()))
    assert outs[1][0][2] == 0.0  # the infeasible row
    _close(outs[0][0], outs[1][0], 1e-5, 1e-5)
    _close(outs[0][1], outs[1][1], 1e-5, 1e-5)


# -- normaliser, schedule, SpecAugment, dropout ---------------------------------


def test_update_normalizer_matches_jax():
    """Two masked Chan/Welford merges from the empty state: 1e-5."""
    rng = np.random.default_rng(4)
    j_state = jax_norm.init_normalizer(5)
    p_state = normalizer.init_normalizer(5)
    for _ in range(2):
        feats = rng.normal(3.0, 2.0, size=(3, 11, 5)).astype(np.float32)
        mask = rng.random((3, 11)) > 0.3
        j_state = jax_norm.update_normalizer(j_state, jnp.asarray(feats), jnp.asarray(mask))
        p_state = normalizer.update_normalizer(p_state, torch.from_numpy(feats),
                                               torch.from_numpy(mask))
        for a, b in zip(p_state, j_state):
            _close(a.numpy(), b, 1e-5, 1e-6)


@pytest.mark.parametrize("steps_per_update", [1, 2])
def test_noam_schedule_matches_jax(steps_per_update):
    ref = jax_schedule.noam_schedule(1e-3, 25, steps_per_update)
    ours = schedule.noam_schedule(1e-3, 25, steps_per_update)
    for count in (0, 1, 2, 10, 25, 26, 400):
        _close(ours(count), ref(jnp.int32(count)), 1e-6, 0.0, f"count {count}")


def test_spec_augment_masks_match_jax():
    """The JAX package's drop mask, rebuilt from the starts and widths its
    key draws, equals the port's `spans_mask`; masking with given masks
    equals the JAX package's `where`s."""
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    starts = jax.random.randint(k1, (3, 4), 0, 50)
    widths = jax.random.randint(k2, (3, 4), 1, 21)
    ref = jax_augment._drop_mask(key, 50, 4, 20, 3)
    ours = augment.spans_mask(torch.from_numpy(np.array(starts)),
                              torch.from_numpy(np.array(widths)), 50)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(3, 50, 8)).astype(np.float32)
    fmask = rng.random((3, 8)) > 0.7
    want = np.where(np.asarray(ref)[:, :, None], -1.0, feats)
    want = np.where(fmask[:, None, :], -1.0, want)
    got = augment.apply_drop_masks(torch.from_numpy(feats), ours,
                                   torch.from_numpy(fmask), -1.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_spec_augment_draws_bounded_spans():
    """At most num_drops spans per example, each 1..max_width wide, the
    mask value where masked and the input elsewhere."""
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn(16, 200, 40) + 10.0
    out = augment.spec_augment(feats, gen, num_time_drops=4, time_drop_width=20,
                               num_freq_drops=2, freq_drop_width=10, mask_value=0.0)
    masked = out == 0.0
    assert torch.equal(out[~masked], feats[~masked])
    trows = masked.all(dim=2)  # whole time rows dropped
    fcols = masked.all(dim=1)  # whole mel bins dropped

    def runs(mask_row):
        m = mask_row.int().tolist()
        spans, width = [], 0
        for v in m + [0]:
            if v:
                width += 1
            elif width:
                spans.append(width)
                width = 0
        return spans

    for i in range(16):
        t_spans, f_spans = runs(trows[i]), runs(fcols[i])
        assert 1 <= len(t_spans) <= 4 and sum(t_spans) <= 4 * 20
        assert 1 <= len(f_spans) <= 2 and sum(f_spans) <= 2 * 10
        assert max(f_spans) <= 2 * 10
    warped = augment.spec_augment(feats, gen, num_time_drops=0, num_freq_drops=0,
                                  apply_time_warp=True)
    assert warped.shape == feats.shape and not torch.equal(warped, feats)


def test_dropout_train_and_eval():
    """eval() is the identity at every dropout place; train() keeps about
    1 - p of the elements, scaled by 1 / (1 - p)."""
    torch.manual_seed(0)
    x = torch.ones(200, 500)
    y = layers.dropout(x, 0.1, True)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.005
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    assert layers.dropout(x, 0.1, False) is x
    cfg0 = _port_cfg(JAX_CFG)
    model0 = asr.init_params_(asr.ASRModel(cfg0), torch.Generator().manual_seed(1))
    model1 = asr.ASRModel(_port_cfg(JAX_CFG, dropout=0.3))
    model1.load_state_dict(model0.state_dict(), strict=True)
    feats = torch.randn(2, 45, 20)
    with torch.no_grad():
        ref = model0.eval()(feats)["ctc_log_probs"]
        assert torch.equal(model1.eval()(feats)["ctc_log_probs"], ref)
        a = model1.train()(feats)["ctc_log_probs"]
        b = model1.train()(feats)["ctc_log_probs"]
    assert not torch.equal(a, ref) and not torch.equal(a, b)


# -- optimizer -------------------------------------------------------------------


def _jax_decay_mask(params):
    """Which leaves the JAX optimizer decays: with zero gradients AdamW's
    update is -lr * wd * p on decayed leaves and 0 elsewhere."""
    tx = jax_trainer.make_optimizer(jax_trainer.TrainConfig(
        lr=1.0, warmup_steps=1, weight_decay=0.5, grad_accumulation_factor=1))
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    upd, _ = jax.jit(tx.update)(zeros, tx.init(params), params)
    return jax.tree_util.tree_map(lambda u: (np.asarray(u) != 0).astype(np.float32), upd)


def test_weight_decay_mask_matches_jax(jax_params):
    """Leaf by leaf through params_import: the port decays what the JAX
    optimizer decays. A_b_log (2-D, the backward head's A) is not
    decayed, as the JAX package's bwd/A_log is not."""
    _, params = jax_params
    params = jax.tree_util.tree_map(lambda p: p + 0.5, params)  # no zero leaf
    mask = {k: bool(v.any()) for k, v in _import(_jax_decay_mask(params)).items()}
    model = asr.ASRModel(_port_cfg(JAX_CFG))
    ours = {n: optim.decays(n, p) for n, p in model.named_parameters()}
    assert ours == mask
    assert not ours["1.encoder.layers.0.mamba.A_b_log"]
    assert ours["1.encoder.layers.0.mamba.in_proj.weight"]


def test_optimizer_update_matches_jax(jax_params):
    """Six micro-steps at accumulation 3 (two updates): running mean,
    clip at 5 (the gradients' norm is ~50), AdamW with the mask and the
    Noam schedule, against apply_accumulated_update. Parameters within
    1e-6 relative + 1e-6 of the largest."""
    _, params = jax_params
    rng = np.random.default_rng(7)
    tcfg = jax_trainer.TrainConfig(lr=5e-3, warmup_steps=3, weight_decay=0.05,
                                   grad_accumulation_factor=3)
    tx = jax_trainer.make_optimizer(tcfg)
    opt_state = tx.init(params)
    update = jax.jit(functools.partial(jax_trainer.apply_accumulated_update, tx))
    model = asr.ASRModel(_port_cfg(JAX_CFG))
    model.load_state_dict(_import(params), strict=True)
    opt = optim.make_optimizer(model, _port_train(tcfg))
    jparams = params
    names = dict(model.named_parameters())
    for step in range(6):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(0.0, 1.0, p.shape).astype(np.float32), params)
        jparams, opt_state = update(grads, opt_state, jparams)
        for name, g in _import(grads).items():
            names[name].grad = g
        assert opt.step() == (step % 3 == 2)
        ref = _import(jax.tree_util.tree_map(np.asarray, jparams))
        for name, p in model.named_parameters():
            _close(p.detach().numpy(), ref[name], 1e-6, 1e-6, f"{name} @ {step}")


# -- the training step -------------------------------------------------------------


def _batches(n, seed=8, bsz=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        wav_lens = rng.integers(9000, 16001, size=bsz).astype(np.int32)
        wav = np.zeros((bsz, 16000), np.float32)
        for i, length in enumerate(wav_lens):
            wav[i, :length] = rng.normal(0.0, 0.1, length)
        token_lens = rng.integers(2, 7, size=bsz).astype(np.int32)
        tokens = rng.integers(1, 13, size=(bsz, 6)).astype(np.int32)
        weight = np.ones(bsz, np.float32)
        weight[rng.integers(bsz)] = rng.choice([0.0, 1.0])
        out.append(dict(wav=wav, wav_lens=wav_lens, tokens=tokens,
                        token_lens=token_lens, weight=weight))
    return out


def test_training_lockstep_matches_jax(jax_params):
    """50 micro-steps of Trainer.train_step (CPU) against the JAX
    make_train_step from the same params and batches: fp32, dropout 0,
    SpecAugment off, warmup 10, accumulation 2 (25 AdamW updates). The
    first micro-step's gradients agree leaf by leaf (1e-4 relative + 1e-5
    of each leaf's largest); loss and grad_norm agree at every step
    within 1e-3 relative. Adam's eps of 1e-9 turns near-zero gradients
    into full-size steps whose sign follows rounding, so parameters are
    not compared one by one after the first update."""
    model, params = jax_params
    tcfg = jax_trainer.TrainConfig(lr=1e-3, warmup_steps=10, grad_accumulation_factor=2)
    spec = jax_trainer.SpecAugmentConfig(enabled=False)
    tx = jax_trainer.make_optimizer(tcfg)
    state = jax_trainer.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=tx.init(params),
        normalizer=jax_norm.init_normalizer(20), step=jnp.zeros((), jnp.int32))
    step_fn = jax_trainer.make_train_step(model, tx, JAX_FE, tcfg, spec)
    ours = trainer.Trainer(_port_cfg(JAX_CFG), PORT_FE, _port_train(tcfg),
                           trainer.SpecAugmentConfig(enabled=False),
                           state_dict=_import(params), device="cpu")
    rng = jax.random.PRNGKey(0)
    for i, batch in enumerate(_batches(50)):
        state, ref = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()},
                             rng, jnp.bool_(True))
        got = ours.train_step(batch)
        if i == 0:
            acc = _import(jax.tree_util.tree_map(np.asarray, state.opt_state.acc_grads))
            named = dict(zip((n for n, _ in ours.model.named_parameters()),
                             ours.optimizer.acc))
            for name, g in named.items():
                _close(g.numpy(), acc[name], 1e-4, 1e-5, name)
        assert bool(got["updated"]) == (i % 2 == 1)
        for key in ("loss", "grad_norm"):
            _close(got[key].item(), ref[key], 1e-3, 0.0, f"{key} @ step {i}")
        _close(got["loss_ctc"].item(), ref["loss_ctc"], 1e-3, 0.0)
    for a, b in zip(ours.normalizer, state.normalizer):
        _close(a.numpy(), b, 1e-5, 1e-6)


def test_trainer_updates_only_on_emit_steps():
    """Parameters change on every k-th micro-step and only then, with
    dropout and SpecAugment on and seeded weights. At this init the
    gradient's norm passes 1e19 (zero biases, whole frames zeroed by
    SpecAugment): it is summed in float64, so it and the update stay
    finite."""
    cfg = _port_cfg(JAX_CFG, dropout=0.1)
    tr = trainer.Trainer(cfg, PORT_FE, trainer.TrainConfig(warmup_steps=5,
                         grad_accumulation_factor=3), device="cpu")
    before = [p.detach().clone() for p in tr.model.parameters()]
    for i, batch in enumerate(_batches(6, seed=9)):
        m = tr.train_step(batch)
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
        assert all(torch.isfinite(p).all() for p in tr.model.parameters())
        changed = any(not torch.equal(a, p) for a, p in zip(before, tr.model.parameters()))
        assert changed == (i % 3 == 2) == bool(m["updated"])
        before = [p.detach().clone() for p in tr.model.parameters()]
    assert tr.optimizer.gradient_step == 2


def test_config_loader_reads_train_and_specaug_like_jax():
    path = "hparams/CTC/conmamba_small.yaml"
    overrides = {"train.warmup_steps": 10, "specaug.num_time_drops": 2}
    ours = loader.load_config(path, overrides)
    theirs = jax_load_config(path, overrides)
    assert dataclasses.asdict(ours.train) == dataclasses.asdict(theirs.train)
    assert dataclasses.asdict(ours.specaug) == dataclasses.asdict(theirs.specaug)
    assert ours.train.warmup_steps == 10 and ours.specaug.num_time_drops == 2
