"""Dynamic-chunk training and the Augmenter's batch enlargement in the
PyTorch port against the JAX package, on the CPU, at
tests/test_torch_conformer.py's tiny size (d_model 16, 2 layers, kernel
7, float32).

- `make_chunked_src_mask` equals JAX's (left context none, 0, 1, 2; a
  partial last chunk).
- `dynamic_chunk_depthwise` equals JAX's at odd lengths within 2e-5.
- `ASRModel.encode(chunk_size, left_context_chunks)` within 2e-5 + 2e-4
  of JAX's for the bidirectional ConMamba, the Conformer (RelPosMHAXL)
  and the Branchformer (left context 1), on a ragged batch whose encoder length leaves a
  partial last chunk; the chunking moves the output (not the full pass).
- One Conformer train step with dynchunk_size 5, left context 1, and
  SpecAugment on with concat_original and repeat_augment 2 but no drops
  (so JAX's and the port's draws cannot differ): loss and every
  accumulated gradient within 3e-4 of JAX's make_train_step.
- The enlarged batch's structure with the drops on (the draws are the
  port's own generator's, by design): [original; two augmented copies],
  labels, lengths and weights tiled.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.models import layers as jax_layers
from mamba_asr_tpu.models import mamba as jax_mamba
from mamba_asr_tpu.models import transformer as jax_transformer
from mamba_asr_tpu.training import normalizer as jax_norm
from mamba_asr_tpu.training import trainer as jax_trainer

from mamba_asr_torch.configs import loader
from mamba_asr_torch.models import layers, transformer
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.training import trainer
from tests.test_torch_conformer import FEATS, FLENS, jax_cfg, port_cfg, port_model, seeded

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-4)
CHUNK = 5  # encoder frames: FEATS' 12 frames are chunks of 5, 5 and 2
MCFG = jax_mamba.MambaConfig(d_state=4, d_conv=4, expand=2, scan_impl="ref")


@pytest.mark.parametrize("length,chunk,left", [(12, 5, None), (12, 5, 0), (13, 4, 1),
                                               (9, 3, 2), (7, 8, None)])
def test_chunked_src_mask_matches_jax(length, chunk, left):
    want = np.asarray(jax_transformer.make_chunked_src_mask(length, chunk, left))
    got = transformer.make_chunked_src_mask(length, chunk, left).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t,chunk", [(13, 4), (3, 8)])
def test_chunked_depthwise_matches_jax(t, chunk):
    rng = np.random.default_rng(t * 10 + chunk)
    k, d, pad = 7, 6, 3
    x = rng.normal(size=(2, t, d)).astype(np.float32)
    kernel = rng.normal(size=(k, d)).astype(np.float32)
    bias = rng.normal(size=(d,)).astype(np.float32)
    want = np.asarray(jax_layers.dynamic_chunk_depthwise(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), pad, chunk))
    got = layers.dynamic_chunk_depthwise(
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(kernel.T[:, None, :])),
        torch.from_numpy(bias), pad, chunk)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


ENCODERS = {  # ConMamba takes no attention mask, so no left context
    "conmamba": (dict(encoder_module="conmamba", mamba=MCFG, bidirectional=True), None),
    "conformer": (dict(encoder_module="conformer"), 1),
    "branchformer": (dict(encoder_module="branchformer"), 1),
}


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_encode_chunked_matches_jax(encoder):
    kw, left = ENCODERS[encoder]
    jcfg = jax_cfg(**kw)
    model = jax_asr.ASRModel(jcfg)
    params = seeded(model, 3, jnp.asarray(FEATS), jnp.asarray(FLENS))
    want, want_lens = model.apply({"params": params}, jnp.asarray(FEATS), jnp.asarray(FLENS),
                                  chunk_size=CHUNK, left_context_chunks=left,
                                  method=jax_asr.ASRModel.encode)
    pm = port_model(jcfg, params)
    with torch.no_grad():
        feats, flens = torch.from_numpy(FEATS), torch.from_numpy(FLENS)
        got, got_lens = pm.encode(feats, flens, CHUNK, left)
        full, _ = pm.encode(feats, flens)
    assert got.shape[1] % CHUNK, "the last chunk must be partial"
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got - full).abs().max() > 1e-3  # the chunking moved the output


def _batch(rng, n=2):
    wav_lens = np.array([16000, 11000], np.int32)
    wav = np.zeros((n, 16000), np.float32)
    for i, m in enumerate(wav_lens):
        wav[i, :m] = rng.normal(0.0, 0.1, m)
    return dict(wav=wav, wav_lens=wav_lens, tokens=rng.integers(1, 13, (n, 6)).astype(np.int32),
                token_lens=np.array([6, 4], np.int32), weight=np.array([1.0, 0.5], np.float32))


def test_dynchunk_augmented_train_step_matches_jax():
    """tests/test_torch_conformer.py's step harness (fp32, dropout 0,
    accumulation 2 so nothing updates) with dynamic chunks and the
    enlarged batch."""
    jcfg = jax_cfg()
    model = jax_asr.ASRModel(jcfg)
    params = seeded(model, 11, jnp.asarray(FEATS), jnp.asarray(FLENS))
    tcfg = jax_trainer.TrainConfig(lr=1e-3, warmup_steps=10, grad_accumulation_factor=2,
                                   dynchunk_size=CHUNK, dynchunk_left_context=1)
    spec = jax_trainer.SpecAugmentConfig(num_time_drops=0, num_freq_drops=0,
                                         concat_original=True, repeat_augment=2)
    fe = jax_trainer.FrontendConfig(n_fft=400, n_mels=20)
    tx = jax_trainer.make_optimizer(tcfg)
    state = jax_trainer.TrainState(
        params=params, opt_state=tx.init(params), normalizer=jax_norm.init_normalizer(20),
        step=jnp.zeros((), jnp.int32))
    batch = _batch(np.random.default_rng(12))
    step = jax_trainer.make_train_step(model, tx, fe, tcfg, spec)
    state, ref = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0), jnp.bool_(True))
    ours = trainer.Trainer(port_cfg(jcfg), loader.FrontendConfig(n_fft=400, n_mels=20),
                           trainer.TrainConfig(**dataclasses.asdict(tcfg)),
                           trainer.SpecAugmentConfig(**dataclasses.asdict(spec)),
                           state_dict=pi.import_asr_params(params, port_cfg(jcfg)),
                           device="cpu")
    got = ours.train_step(batch)
    np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]), rtol=3e-4, atol=3e-4)
    acc = pi.import_asr_params(jax.tree_util.tree_map(np.array, state.opt_state.acc_grads),
                               port_cfg(jcfg))
    names = [n for n, _ in ours.model.named_parameters()]
    assert sorted(names) == sorted(acc)
    for name, g in zip(names, ours.optimizer.acc):
        want = acc[name].numpy()
        atol = 3e-4 * max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=3e-4, atol=atol, err_msg=name)


def test_enlarged_batch_structure():
    cfg = port_cfg(jax_cfg())
    spec = trainer.SpecAugmentConfig(num_time_drops=2, time_drop_width=5, num_freq_drops=2,
                                     freq_drop_width=3, concat_original=True,
                                     repeat_augment=2)
    tr = trainer.Trainer(cfg, loader.FrontendConfig(n_fft=400, n_mels=20),
                         trainer.TrainConfig(grad_accumulation_factor=2), spec, device="cpu")
    seen = {}
    forward = tr.model.forward

    def capture(feats, flens, *args, **kw):
        seen.update(feats=feats.detach().clone(), flens=flens.clone())
        return forward(feats, flens, *args, **kw)

    tr.model.forward = capture
    orig = {}
    augment = tr._augment

    def keep_input(feats, flens, b):
        orig.update(feats=feats.clone(), b=dict(b))
        out = augment(feats, flens, b)
        orig.update(out_b=out[2])
        return out

    tr._augment = keep_input
    batch = _batch(np.random.default_rng(5))
    assert np.isfinite(tr.train_step(batch)["loss"].item())
    feats, b = seen["feats"], orig["out_b"]
    n = len(batch["wav"])
    assert feats.shape[0] == 3 * n and seen["flens"].tolist() == 3 * seen["flens"][:n].tolist()
    assert torch.equal(feats[:n], orig["feats"])  # the original first
    assert not torch.equal(feats[n:2 * n], feats[2 * n:])  # two different draws
    for key in ("tokens", "token_lens", "weight"):
        assert torch.equal(b[key], orig["b"][key].repeat(3, *([1] * (b[key].dim() - 1))))
    assert torch.equal(b["wav"], orig["b"]["wav"])  # the audio is not replicated
