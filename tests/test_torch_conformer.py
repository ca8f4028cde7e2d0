"""The Conformer encoder of the PyTorch port against the JAX package, on
the CPU, at a tiny size (d_model 16, nhead 2, 2 layers, d_ffn 24, kernel
7, n_mels 20, float32 unless a case says otherwise).

JAX params come from `jax.eval_shape` and a numpy seed (`seeded`: no
compile, no bias or LayerNorm at its init value) and reach the port
through `models.params_import.import_asr_params`; both sides see the
same numpy inputs. Each config's JAX forward runs once per module.

- `rel_pos_encoding` and `RelPosMHAXL` (with a padding mask, the future
  masked or not, and the gather branch for a longer key) within 2e-5.
- `ConvolutionModule` with a padding mask on a ragged batch within 2e-5;
  its padded frames are 0.
- The Conformer's CTC log-probs (RelPosMHAXL, regularMHA, hypermixing;
  a padded row) within 2e-4, in bf16 within 2e-2 of the largest value.
- One CTC train step (dropout 0, SpecAugment off): loss and every
  gradient within 3e-4.
- The joint CTC/attention search of a Conformer-Small-shaped S2S model
  (Conformer encoder, Transformer decoder) at beam 4: tokens equal.
- `import_asr_params` equals `export_asr_params` key by key (RelPosMHAXL
  and regularMHA), and the strict load takes it.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.decoding.s2s_beam import S2SBeamSearcher as JaxSearcher
from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.models import attention as jax_att
from mamba_asr_tpu.models import conformer as jax_conformer
from mamba_asr_tpu.models import layers as jax_layers
from mamba_asr_tpu.models.torch_export import export_asr_params
from mamba_asr_tpu.training import normalizer as jax_norm
from mamba_asr_tpu.training import trainer as jax_trainer

from mamba_asr_torch.configs import loader
from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher
from mamba_asr_torch.models import asr, attention, conformer, layers, mamba
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.training import trainer

torch.set_num_threads(1)

D, H, FFN, K = 16, 2, 24, 7


def seeded(module, seed, *args):
    """A flax module's params (shapes from `jax.eval_shape`, no compile)
    filled from numpy's default_rng(seed): kernels and taps N(0, 1/fan_in),
    HyperMixing's weights N(0, 1/fan_in), embeddings N(0, 1), other leaves
    N(0, 0.05^2) (LayerNorm scales 1 + that)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]

    def fill(path, leaf):
        name, x = path[-1].key, rng.normal(size=leaf.shape).astype(np.float32)
        if name == "kernel":
            return x / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        if name in ("dw_kernel", "fc1_weights", "fc2_weights"):
            return x / np.float32(np.sqrt(leaf.shape[0 if name == "dw_kernel" else -1]))
        if name == "embedding":
            return x
        return np.float32(name == "scale") + np.float32(0.05) * x

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_cfg(**kw):
    base = dict(vocab_size=13, n_mels=20, d_model=D, nhead=H, num_encoder_layers=2,
                d_ffn=FFN, dropout=0.0, activation="gelu", encoder_module="conformer",
                kernel_size=K, frontend_channels=(4, 6), compute_dtype="float32",
                csgu_linear_units=32)
    base.update(kw)
    return jax_asr.ASRConfig(**base)


def port_cfg(c: jax_asr.ASRConfig, **kw) -> asr.ASRConfig:
    fields = {f.name: getattr(c, f.name) for f in dataclasses.fields(asr.ASRConfig)}
    fields["mamba"] = mamba.MambaConfig(**{
        f.name: getattr(c.mamba, f.name) for f in dataclasses.fields(mamba.MambaConfig)})
    fields.update(kw)
    return asr.ASRConfig(**fields)


FEATS = np.random.default_rng(4).normal(size=(2, 45, 20)).astype(np.float32)
FLENS = np.array([45, 31], np.int32)  # enc_lengths 12 and 8: row 1 padded


def jax_model(seed=1, **kw):
    """(jax cfg, model, params, outputs on FEATS / FLENS)."""
    jcfg = jax_cfg(**kw)
    model = jax_asr.ASRModel(jcfg)
    args = [jnp.asarray(FEATS), jnp.asarray(FLENS)]
    if jcfg.num_decoder_layers:
        args.append(jnp.ones((2, 5), jnp.int32))
    params = seeded(model, seed, *args)
    out = model.apply({"params": params}, jnp.asarray(FEATS), jnp.asarray(FLENS))
    return jcfg, model, params, {k: np.array(v) for k, v in out.items()}


def port_model(jcfg, params, **kw):
    pm = asr.ASRModel(port_cfg(jcfg, **kw))
    pm.load_state_dict(pi.import_asr_params(params, pm.cfg), strict=True)
    return pm.eval()


def port_forward(pm, feats=FEATS, flens=FLENS):
    with torch.no_grad():
        return pm(torch.from_numpy(feats), torch.from_numpy(flens))


@pytest.fixture(scope="module", params=["RelPosMHAXL", "regularMHA", "hypermixing"])
def model(request):
    return jax_model(attention_type=request.param)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol, err_msg=what)


def _sub_state(fn, params, *args):
    t = pi._Tree({"m": params})
    out = {}
    fn(t, "m", "k", *args, out)
    t.finish()
    return {k[2:]: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


# -- RelPosMHAXL ------------------------------------------------------------------------


@pytest.mark.parametrize("length", [1, 9])
def test_rel_pos_encoding_matches_jax(length):
    want = np.asarray(jax_att.rel_pos_encoding(length, D))
    got = attention.rel_pos_encoding(length, D)
    assert got.shape == (2 * length - 1, D)
    _close(got.numpy(), want, 2e-5)
    assert attention.rel_pos_encoding(length, D, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("causal,lk", [(False, 9), (True, 9), (False, 12)])
def test_relpos_mha_matches_jax(causal, lk):
    """q (2, 9, 16) against keys of 9 (the shift) or 12 (the gather) frames,
    the key padding mask hiding row 1's last 3 keys, the future masked or
    not; the PE built inside (the keys' length) or given."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 9, D)).astype(np.float32)
    kv = q if lk == 9 else rng.normal(size=(2, lk, D)).astype(np.float32)
    kpm = np.zeros((2, lk), bool)
    kpm[1, -3:] = True
    mha = jax_att.RelPosMHAXL(H, mask_pos_future=causal)
    params = seeded(mha, 6, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv))
    pos = jax_att.rel_pos_encoding(lk, D)
    want, _ = mha.apply({"params": params}, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                        key_padding_mask=jnp.asarray(kpm), pos_embs=pos)
    port = attention.RelPosMHAXL(D, H, mask_pos_future=causal)
    port.load_state_dict(_sub_state(pi._relpos_mha, params), strict=True)
    tq, tkv, tkpm = map(torch.from_numpy, (q, kv, kpm))
    with torch.no_grad():
        got = port(tq, key_padding_mask=tkpm, pos_embs=torch.tensor(np.asarray(pos)),
                   key=tkv, value=tkv)
        built = port(tq, key_padding_mask=tkpm, key=tkv, value=tkv)
    _close(got.numpy(), np.asarray(want), 2e-5)
    _close(built.numpy(), np.asarray(want), 2e-5)


# -- the convolution module with a mask ------------------------------------------------------


def test_conv_module_mask_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 11, D)).astype(np.float32)
    mask = np.arange(11)[None, :] >= np.array([11, 6, 1])[:, None]
    conv = jax_layers.ConvolutionModule(d_model=D, kernel_size=K)
    params = seeded(conv, 8, jnp.asarray(x))
    want = conv.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask[..., None]))
    port = layers.ConvolutionModule(D, K)
    port.load_state_dict(_sub_state(pi._conv_module, params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask[..., None]))
        unmasked = port(torch.from_numpy(x))
    _close(got.numpy(), np.asarray(want), 2e-5)
    assert (got.numpy()[mask] == 0).all() and (unmasked.numpy()[mask] != 0).all()


# -- the encoder layer and the whole model --------------------------------------------------------


@pytest.mark.parametrize("attention_type,causal", [
    ("RelPosMHAXL", False), ("RelPosMHAXL", True), ("regularMHA", False)])
def test_conformer_layer_matches_jax(attention_type, causal):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 10, D)).astype(np.float32)
    kpm = np.zeros((2, 10), bool)
    kpm[1, 7:] = True
    pos = jax_att.rel_pos_encoding(10, D)
    layer = jax_conformer.ConformerEncoderLayer(
        D, FFN, H, kernel_size=K, activation=jax_asr._gelu_exact, causal=causal,
        attention_type=attention_type)
    params = seeded(layer, 10, jnp.asarray(x), None, jnp.asarray(kpm), pos)
    want, _ = layer.apply({"params": params}, jnp.asarray(x), None, jnp.asarray(kpm), pos)
    port = conformer.ConformerEncoderLayer(D, FFN, H, K, asr._gelu_exact, causal=causal,
                                           attention_type=attention_type)
    port.load_state_dict(_sub_state(pi._conformer_layer, params, attention_type), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), None, torch.from_numpy(kpm),
                   torch.tensor(np.asarray(pos)))
    _close(got.numpy(), np.asarray(want), 2e-5)


def test_conformer_ctc_log_probs_match_jax(model):
    """The whole model, row 1 padded: log-probs at every frame within 2e-4,
    enc_lengths equal."""
    jcfg, _, params, want = model
    out = port_forward(port_model(jcfg, params))
    _close(out["ctc_log_probs"].numpy(), want["ctc_log_probs"], 2e-4)
    np.testing.assert_array_equal(out["enc_lengths"].numpy(), want["enc_lengths"])
    np.testing.assert_array_equal(out["enc_out"].shape, want["enc_out"].shape)


def test_conformer_bf16_matches_jax():
    """bf16 (the YAMLs' compute dtype) against JAX's bf16: within 2e-2 of
    the largest log-prob."""
    jcfg, _, params, out = jax_model(seed=3, compute_dtype="bfloat16")
    want = out["ctc_log_probs"]
    got = port_forward(port_model(jcfg, params))["ctc_log_probs"].float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_conformer_import_equals_export(model):
    jcfg, _, params, _ = model
    if jcfg.attention_type == "hypermixing":
        with pytest.raises(KeyError):
            export_asr_params(params, jcfg)
        return
    ours = pi.import_asr_params(params, port_cfg(jcfg))
    theirs = export_asr_params(params, jcfg)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_conformer_init_and_streaming():
    """init_params_ draws RelPosMHAXL's u and v as zeros (JAX's init), and
    streaming builds each layer's state (an empty left context, the conv
    tail) and gives JAX's chunks: two chunks of 6 frames, within 2e-5."""
    pm = asr.init_params_(asr.ASRModel(port_cfg(jax_cfg())), torch.Generator().manual_seed(0))
    mha = pm.encoder.layers[0].mha_layer
    assert not mha.pos_bias_u.any() and not mha.pos_bias_v.any()
    assert mha.in_proj_weight.std() > 0.1
    jcfg = jax_cfg()
    jm = jax_asr.ASRModel(jcfg)
    params = seeded(jm, 1, jnp.asarray(FEATS), jnp.asarray(FLENS))
    pm = port_model(jcfg, params)
    state = pm.init_streaming_state(2)
    assert len(state) == 2 and not state[0]["mha_left_len"].any()
    assert tuple(state[0]["conv"].shape) == (2, (K - 1) // 2, D)

    def chunk(m, x, s):
        return m.encoder.forward_chunk(m.src_proj(x), s)

    run = jax.jit(lambda x, s: jm.apply({"params": params}, x, s, method=chunk))
    jstate = jm.apply({"params": params}, 2, method=jax_asr.ASRModel.init_streaming_state)
    x = np.random.default_rng(8).normal(size=(2, 12, pm.cfg.frontend_output_dim))
    for lo in (0, 6):
        xc = x[:, lo:lo + 6].astype(np.float32)
        want, jstate = run(jnp.asarray(xc), jstate)
        got, state = pm.encoder.forward_chunk(
            layers.dense(torch.from_numpy(xc), pm.src_proj, torch.float32), state)
        _close(got.detach().numpy(), np.asarray(want), 2e-5, f"chunk at {lo}")


# -- training ------------------------------------------------------------------------------------


def test_conformer_train_step_matches_jax():
    """One micro-step of Trainer.train_step against JAX's make_train_step
    (fp32, dropout 0, SpecAugment off, accumulation 2 so nothing updates):
    loss and every accumulated gradient within 3e-4 (relative, and of
    each gradient's largest value)."""
    jcfg = jax_cfg()
    model = jax_asr.ASRModel(jcfg)
    params = seeded(model, 11, jnp.asarray(FEATS), jnp.asarray(FLENS))
    tcfg = jax_trainer.TrainConfig(lr=1e-3, warmup_steps=10, grad_accumulation_factor=2)
    spec = jax_trainer.SpecAugmentConfig(enabled=False)
    fe = jax_trainer.FrontendConfig(n_fft=400, n_mels=20)
    tx = jax_trainer.make_optimizer(tcfg)
    state = jax_trainer.TrainState(
        params=params, opt_state=tx.init(params), normalizer=jax_norm.init_normalizer(20),
        step=jnp.zeros((), jnp.int32))
    rng = np.random.default_rng(12)
    wav_lens = np.array([16000, 11000], np.int32)
    wav = np.zeros((2, 16000), np.float32)
    for i, n in enumerate(wav_lens):
        wav[i, :n] = rng.normal(0.0, 0.1, n)
    batch = dict(wav=wav, wav_lens=wav_lens, tokens=rng.integers(1, 13, (2, 6)).astype(np.int32),
                 token_lens=np.array([6, 4], np.int32), weight=np.ones(2, np.float32))
    step = jax_trainer.make_train_step(model, tx, fe, tcfg, spec)
    state, ref = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0), jnp.bool_(True))
    ours = trainer.Trainer(port_cfg(jcfg), loader.FrontendConfig(n_fft=400, n_mels=20),
                           trainer.TrainConfig(**dataclasses.asdict(tcfg)),
                           trainer.SpecAugmentConfig(enabled=False),
                           state_dict=pi.import_asr_params(params, port_cfg(jcfg)),
                           device="cpu")
    got = ours.train_step(batch)
    _close(got["loss"].item(), float(ref["loss"]), 3e-4)
    acc = pi.import_asr_params(jax.tree_util.tree_map(np.array, state.opt_state.acc_grads),
                               port_cfg(jcfg))
    names = [n for n, _ in ours.model.named_parameters()]
    assert sorted(names) == sorted(acc)
    for name, g in zip(names, ours.optimizer.acc):
        want = acc[name].numpy()
        atol = 3e-4 * max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=3e-4, atol=atol, err_msg=name)


# -- the joint search ------------------------------------------------------------------------


def test_conformer_s2s_search_matches_jax():
    """A Conformer-Small-shaped S2S model (RelPosMHAXL encoder, 2-layer
    Transformer decoder, vocab 12) through the joint CTC/attention search
    at beam 4 with CTC candidates: tokens and lengths equal, scores within
    1e-4. The seq head's eos bias is lowered by 4, so that the seeded
    decoder does not end every hypothesis at the first step."""
    jcfg, model, params, out = jax_model(seed=2, vocab_size=12, num_decoder_layers=2)
    params["seq_head"]["bias"] = params["seq_head"]["bias"] - 4.0 * (np.arange(12) == 2)
    kw = dict(beam_size=4, ctc_weight=0.4, ctc_candidates=6, temperature=1.15,
              max_steps_cap=8)
    j_toks, j_lens, j_scores = JaxSearcher(model, **kw)(
        {"params": params}, jnp.asarray(out["enc_out"]), jnp.asarray(out["enc_lengths"]),
        ctc_log_probs=jnp.asarray(out["ctc_log_probs"]))
    pm = port_model(jcfg, params)
    got = port_forward(pm)
    _close(got["ctc_log_probs"].numpy(), out["ctc_log_probs"], 2e-4)
    with torch.no_grad():
        toks, lens, scores = S2SBeamSearcher(pm, **kw)(
            torch.from_numpy(out["enc_out"]), torch.from_numpy(out["enc_lengths"]),
            torch.from_numpy(out["ctc_log_probs"]))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(j_toks))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(j_lens))
    _close(scores.numpy(), np.asarray(j_scores), 1e-4)
    assert (np.asarray(j_lens) > 2).any(), "degenerate hypotheses"
