"""Training the Mamba decoder (ConMambaMamba) in the PyTorch port against
the JAX package, on the CPU, at the tiny size of
tests/test_torch_mamba_decoder.py (d_model 16, one ConMamba layer, two
Mamba decoder layers, vocab 12, float32).

- Ten S2S micro-steps of `Trainer.train_step` against JAX
  `make_train_step` (dropout 0, SpecAugment's bicubic time warp on with
  the JAX step's own draws handed to the port, its drops off,
  accumulation 2, Noam stepped twice per update): losses and every
  parameter within 2e-4 (the model has no attention key biases, so no
  parameter is held apart).
- The encoder receives the cross-Mamba's gradient: with the attention
  loss alone, every encoder parameter's gradient against JAX's (2e-4).
- The decoder's dropout places against JAX's.

The recipe's tests are in tests/test_torch_mamba_decoder_recipe.py.
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

from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.training import losses as jax_losses
from mamba_asr_tpu.training import normalizer as jax_norm
from mamba_asr_tpu.training import trainer as jax_trainer

from mamba_asr_torch.configs import loader
from mamba_asr_torch.data import augment
from mamba_asr_torch.models import asr, layers
from mamba_asr_torch.models import conmamba as port_conmamba
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.training import losses, trainer
from tests.test_torch_recipe import _close
from tests.test_torch_s2s_ops import port_cfg, s2s_cfg
from tests.test_torch_s2s_training import _padded_targets, _s2s_batches

torch.set_num_threads(1)

JAX_FE = jax_trainer.FrontendConfig(n_fft=400, n_mels=20)
PORT_FE = loader.FrontendConfig(n_fft=400, n_mels=20)
WINDOW = 5


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, jax model, init params) of the tiny ConMambaMamba."""
    jcfg = s2s_cfg(decoder_module="mamba")
    model = jax_asr.ASRModel(jcfg)
    rng = np.random.default_rng(0)
    feats = jnp.asarray(rng.normal(size=(1, 101, 20)).astype(np.float32))
    params = jax.jit(model.init)(jax.random.PRNGKey(1), feats, jnp.array([101]),
                                 jnp.ones((1, 4), jnp.int32))["params"]
    return jcfg, model, jax.tree_util.tree_map(np.asarray, params)


def _jax_warp_draws(key, length):
    """The (centre, target) JAX's spec_augment draws from `key` for its
    bicubic warp (`augment.py:193-197`, after its 3-way split)."""
    k_w = jax.random.split(key, 3)[2]
    k_c, k_s = jax.random.split(k_w)
    c = int(jax.random.randint(k_c, (), WINDOW, length - WINDOW))
    return c, int(jax.random.randint(k_s, (), -WINDOW, WINDOW)) + 1 + c


def test_mamba_s2s_training_lockstep_matches_jax(tiny, monkeypatch):
    """10 micro-steps from the same params and batches: fp32, dropout 0,
    the warp on with each step's JAX draws, ctc_weight 0.3, label
    smoothing 0.1, accumulation 2, the schedule stepped twice per update.
    loss, loss_ctc, loss_att and grad_norm at every step and every
    parameter after the last update within 2e-4 (relative + of each
    tensor's largest value)."""
    jcfg, model, params = tiny
    tcfg = jax_trainer.TrainConfig(lr=1e-3, warmup_steps=4, grad_accumulation_factor=2,
                                   ctc_weight=0.3, label_smoothing=0.1,
                                   scheduler_steps_per_update=2)
    spec = dict(num_time_drops=0, num_freq_drops=0, apply_time_warp=True,
                time_warp_window=WINDOW, time_warp_mode="bicubic")
    tx = jax_trainer.make_optimizer(tcfg)
    state = jax_trainer.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=tx.init(params),
        normalizer=jax_norm.init_normalizer(20), step=jnp.zeros((), jnp.int32))
    step_fn = jax_trainer.make_train_step(model, tx, JAX_FE, tcfg,
                                          jax_trainer.SpecAugmentConfig(**spec))
    pcfg = port_cfg(jcfg)
    ours = trainer.Trainer(pcfg, PORT_FE, trainer.TrainConfig(**dataclasses.asdict(tcfg)),
                           trainer.SpecAugmentConfig(**spec),
                           state_dict=pi.import_asr_params(params, pcfg), device="cpu")
    key = {}
    drawn = []

    def draws(generator, length, window, batch, mode="bicubic"):
        assert (window, mode) == (WINDOW, "bicubic")
        drawn.append(_jax_warp_draws(key["now"], length))
        return tuple(torch.tensor(v) for v in drawn[-1])

    monkeypatch.setattr(augment, "draw_time_warp", draws)
    for i, batch in enumerate(_s2s_batches(10)):
        key["now"] = jax.random.fold_in(jax.random.PRNGKey(0), i)
        state, ref = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()},
                             key["now"], jnp.bool_(True))
        got = ours.train_step(batch)
        assert bool(got["updated"]) == (i % 2 == 1)
        for k in ("loss", "loss_ctc", "loss_att", "grad_norm"):
            _close(got[k].item(), ref[k], 2e-4, 0.0, f"{k} @ step {i}")
    assert len(drawn) == 10 and len({c for c, _ in drawn}) > 1
    assert any(c != w for c, w in drawn), "every warp was the identity"
    assert ours.optimizer.scheduler.last_epoch == 5
    want = pi.import_asr_params(jax.tree_util.tree_map(np.asarray, state.params), pcfg)
    for name, p in ours.model.named_parameters():
        _close(p.detach().numpy(), want[name].numpy(), 2e-4, 2e-4, name)


def test_encoder_receives_the_cross_mamba_gradient(tiny):
    """With the attention loss alone (no CTC), the only way into the
    encoder is the cross-Mamba's adjoint over the memory positions: every
    encoder parameter's gradient is nonzero and equals JAX's (2e-4
    relative + of each tensor's largest value)."""
    jcfg, model, params = tiny
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(2, 61, 20)).astype(np.float32)
    flens = np.array([61, 45], np.int32)
    bos = _padded_targets(rng, 2, 7)
    eos = np.zeros_like(bos)
    lens = (bos[:, 1:] > 0).sum(1).astype(np.int32)
    for i, n in enumerate(lens):
        eos[i, :n], eos[i, n] = bos[i, 1:n + 1], 2

    def jax_loss(p):
        out = model.apply({"params": p}, jnp.asarray(feats), jnp.asarray(flens),
                          jnp.asarray(bos))
        return jax_losses.kldiv_loss(out["seq_log_probs"], jnp.asarray(eos),
                                     jnp.asarray(lens + 1))

    ref = jax.jit(jax.grad(jax_loss))(jax.tree_util.tree_map(jnp.asarray, params))
    want = pi.import_asr_params(jax.tree_util.tree_map(np.asarray, ref), port_cfg(jcfg))
    pm = asr.ASRModel(port_cfg(jcfg))
    pm.load_state_dict(pi.import_asr_params(params, port_cfg(jcfg)), strict=True)
    out = pm(torch.from_numpy(feats), torch.from_numpy(flens), torch.from_numpy(bos))
    losses.kldiv_loss(out["seq_log_probs"], torch.from_numpy(eos),
                      torch.from_numpy(lens + 1)).backward()
    encoder = [n for n, _ in pm.named_parameters() if n.startswith(("0.", "1.encoder",
                                                                    "1.custom_src"))]
    assert len(encoder) > 40
    for name, p in pm.named_parameters():
        if name in encoder:
            assert p.grad.abs().max() > 0, name
        if p.grad is not None:
            _close(p.grad.numpy(), want[name].numpy(), 2e-4, 2e-4, name)
        else:
            assert name.startswith(("2.", "3.")) or not want[name].numpy().any(), name


def test_mamba_decoder_drops_where_jax_drops(tiny, monkeypatch):
    """Every dropout of the decoder in train mode as (rate, shape): per
    layer the three residual branches (self-Mamba, cross-Mamba, FFN) and
    the FFN's hidden units, as in JAX; eval mode applies none."""
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
    jax.jit(functools.partial(jmodel.apply, train=True, method=jax_asr.ASRModel.decode))(
        {"params": params}, jnp.asarray(bos), jnp.asarray(enc), jnp.array([9, 6]),
        rngs={"dropout": jax.random.PRNGKey(0)})
    monkeypatch.undo()
    jax_seen = sorted(seen)
    seen.clear()
    plain = layers.dropout

    def port_record(x, p, training):
        if training and p > 0:
            seen.append((p, tuple(x.shape)))
        return plain(x, p, training)

    for module in (port_conmamba, layers):
        monkeypatch.setattr(module, "dropout", port_record)
    cfg = dataclasses.replace(port_cfg(jcfg), dropout=0.25)
    pm = asr.ASRModel(cfg)
    pm.load_state_dict(pi.import_asr_params(params, cfg), strict=True)
    for train in (False, True):
        pm.train(train)
        pm.decode(torch.from_numpy(bos), torch.from_numpy(enc), torch.tensor([9, 6]))
        if not train:
            assert seen == []
    assert len(seen) == 4 * jcfg.num_decoder_layers
    assert sorted(seen) == jax_seen
