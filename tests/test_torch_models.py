"""The PyTorch port's modules and the whole ConMamba CTC path against the
JAX package, on the CPU, at a tiny size (d_model 16, 2 layers, d_state 4,
n_mels 20, float32).

JAX params come from `model.init` plus seeded numpy noise (so biases and
norms are not at their trivial init), cross into the port through
`mamba_asr_torch.models.params_import`, and both sides see the same
numpy inputs. Tolerances: 2e-5 for one block (float32, sums in another
order), 2e-4 for whole-model CTC log-probs (as tests/test_torch_export.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.configs.loader import load_config as jax_load_config
from mamba_asr_tpu.decoding.ctc_greedy import ctc_greedy_decode as jax_greedy
from mamba_asr_tpu.decoding.ctc_greedy import tokens_to_lists as jax_to_lists
from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.models import conmamba as jax_conmamba
from mamba_asr_tpu.models import layers as jax_layers
from mamba_asr_tpu.models import mamba as jax_mamba
from mamba_asr_tpu.models.torch_export import export_asr_params
from mamba_asr_tpu.training import trainer as jax_trainer
from mamba_asr_tpu.training.normalizer import NormalizerState

from mamba_asr_torch.configs import loader
from mamba_asr_torch.decoding.ctc_greedy import ctc_greedy_decode
from mamba_asr_torch.models import asr, conmamba, layers, mamba
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.serving.recognizer import Recognizer

torch.set_num_threads(1)

JAX_MAMBA = jax_mamba.MambaConfig(d_state=4, d_conv=4, expand=2, dt_rank=2)


@pytest.fixture(autouse=True)
def _no_grad():
    prev = torch.is_grad_enabled()
    torch.set_grad_enabled(False)
    yield
    torch.set_grad_enabled(prev)


def _jax_cfg(**kw):
    base = dict(
        vocab_size=13, n_mels=20, d_model=16, nhead=2, num_encoder_layers=2,
        d_ffn=24, dropout=0.0, activation="gelu", encoder_module="conmamba",
        kernel_size=7, frontend_channels=(4, 6), mamba=JAX_MAMBA,
        compute_dtype="float32",
    )
    base.update(kw)
    return jax_asr.ASRConfig(**base)


def _port_mamba(m: jax_mamba.MambaConfig) -> mamba.MambaConfig:
    return mamba.MambaConfig(**{
        f.name: getattr(m, f.name) for f in dataclasses.fields(mamba.MambaConfig)
    })


def _port_cfg(c: jax_asr.ASRConfig) -> asr.ASRConfig:
    kw = {f.name: getattr(c, f.name) for f in dataclasses.fields(asr.ASRConfig)}
    kw["mamba"] = _port_mamba(c.mamba)
    return asr.ASRConfig(**kw)


def _init(module, seed, *args):
    """JAX params from init, each leaf nudged by seeded numpy noise."""
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), *args)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32),
        params,
    )


def _jax_model(scan_layers):
    """(cfg, model, params) of the tiny JAX model in one params layout."""
    jcfg = _jax_cfg(scan_layers=scan_layers)
    model = jax_asr.ASRModel(jcfg)
    feats = jnp.asarray(_feats(4, (2, 45, 20)))
    return jcfg, model, _init(model, 4, feats, jnp.array([45, 31]))


# Initialised once per module: JAX's first calls dominate the cost.
@pytest.fixture(scope="module")
def unrolled():
    return _jax_model(False)


@pytest.fixture(scope="module")
def scanned():
    return _jax_model(True)


@pytest.fixture(params=["unrolled", "scanned"])
def jax_model(request):
    return request.getfixturevalue(request.param)


def _sub_state(fn, params, *args):
    """Import a JAX sub-module's params with one of params_import's
    mappers, as a state dict of that sub-module."""
    t = pi._Tree({"m": params})
    out = {}
    fn(t, "m", "k", *args, out)
    t.finish()
    return {k[2:]: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def _feats(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("length", [12, 13])
def test_bimamba_block_matches_jax(unrolled, length):
    x = _feats(1, (2, length, 16))
    block = jax_mamba.BiMambaBlock(16, JAX_MAMBA)
    params = unrolled[2]["encoder"]["layer_0"]["mamba"]
    ref = jax.jit(block.apply)({"params": params}, jnp.asarray(x))

    port = mamba.BiMambaBlock(16, _port_mamba(JAX_MAMBA))
    port.load_state_dict(_sub_state(pi._mamba, params), strict=True)
    out = port(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("length,causal", [(12, False), (13, False), (13, True)])
def test_conmamba_encoder_layer_matches_jax(unrolled, length, causal):
    """Bidirectional (BiMamba, centred conv) and causal (MambaBlock,
    left-padded conv) layers."""
    x = _feats(2, (2, length, 16))
    layer = jax_conmamba.ConmambaEncoderLayer(
        16, 24, kernel_size=7, activation=jax_asr._gelu_exact,
        mamba_cfg=JAX_MAMBA, causal=causal,
    )
    params = (_init(layer, 2, jnp.asarray(x)) if causal
              else unrolled[2]["encoder"]["layer_1"])
    ref = jax.jit(layer.apply)({"params": params}, jnp.asarray(x))

    port = conmamba.ConmambaEncoderLayer(
        16, 24, kernel_size=7, activation=asr._gelu_exact, causal=causal,
        mamba_cfg=_port_mamba(JAX_MAMBA),
    )
    port.load_state_dict(_sub_state(pi._encoder_layer, params), strict=True)
    out = port(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("frames,mels", [(36, 20), (37, 20), (37, 19)])
def test_conv_frontend_matches_jax(unrolled, frames, mels):
    """flax SAME padding is (0, 1) at an even size and (1, 1) at an odd
    one, on both axes; LayerNorm over channels; channels-last output."""
    x = _feats(3, (2, frames, mels))
    fe = jax_layers.ConvolutionFrontEnd(out_channels=(4, 6), dropout=0.0)
    params = unrolled[2]["frontend"]
    ref = jax.jit(fe.apply)({"params": params}, jnp.asarray(x))

    port = layers.ConvolutionFrontEnd(out_channels=(4, 6))
    port.load_state_dict(_sub_state(pi._frontend, params, 2), strict=True)
    out = port(torch.from_numpy(x))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_asr_model_matches_jax(jax_model):
    """The whole model on a padded two-utterance batch, from params in
    either JAX layout: CTC log-probs within 2e-4, enc_lengths and greedy
    tokens exact."""
    jcfg, model, params = jax_model
    feats = _feats(4, (2, 45, 20))
    flens = np.array([45, 31], np.int32)
    ref = jax.jit(model.apply)({"params": params}, jnp.asarray(feats), jnp.asarray(flens))

    port = asr.ASRModel(_port_cfg(jcfg))
    port.load_state_dict(pi.import_asr_params(params, port.cfg), strict=True)
    out = port(torch.from_numpy(feats), torch.from_numpy(flens))
    np.testing.assert_allclose(out["ctc_log_probs"].numpy(),
                               np.asarray(ref["ctc_log_probs"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(out["enc_lengths"].numpy(),
                                  np.asarray(ref["enc_lengths"]))
    toks_ref, lens_ref = jax_greedy(ref["ctc_log_probs"], ref["enc_lengths"])
    toks, lens = ctc_greedy_decode(out["ctc_log_probs"], out["enc_lengths"])
    np.testing.assert_array_equal(toks.numpy(), np.asarray(toks_ref))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(lens_ref))


def test_params_import_equals_export(jax_model):
    """Key by key and value by value, the port's import equals the JAX
    package's export_asr_params."""
    jcfg, _, params = jax_model
    ours = pi.import_asr_params(params, _port_cfg(jcfg))
    theirs = export_asr_params(params, jcfg)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_params_import_rejects_unconsumed_leaves(unrolled):
    jcfg, _, params = unrolled
    params = dict(params)
    params["mystery"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="mystery"):
        pi.import_asr_params(params, _port_cfg(jcfg))


def test_recognizer_matches_jax_recognize_flow(unrolled):
    """Recognizer(device="cpu") against recognize.py's offline flow
    (make_eval_step + ctc_greedy_decode, duration-sorted groups padded to
    1 s, short groups filled with wav_len-1 rows): token-exact."""
    jcfg, model, params = unrolled
    jfe = jax_trainer.FrontendConfig(n_fft=400, n_mels=20)
    rng = np.random.default_rng(7)
    norm = (np.float32(120.0), rng.normal(size=20).astype(np.float32),
            rng.uniform(50.0, 200.0, size=20).astype(np.float32))
    wavs = [rng.normal(0.0, 0.1, size=n).astype(np.float32)
            for n in (21000, 9000, 14500)]

    eval_step = jax_trainer.make_eval_step(model, jfe)
    order = sorted(range(len(wavs)), key=lambda i: len(wavs[i]))
    expected = [None] * len(wavs)
    batch = 2
    for start in range(0, len(order), batch):
        group = order[start:start + batch]
        pad_len = -(-max(len(wavs[i]) for i in group) // 16000) * 16000
        wav_mat = np.zeros((batch, pad_len), np.float32)
        wav_lens = np.ones((batch,), np.int32)
        for r, i in enumerate(group):
            wav_mat[r, :len(wavs[i])] = wavs[i]
            wav_lens[r] = len(wavs[i])
        out = eval_step(params, NormalizerState(*map(jnp.asarray, norm)), {
            "wav": jnp.asarray(wav_mat), "wav_lens": jnp.asarray(wav_lens),
            "tokens_bos": jnp.zeros((batch, 4), jnp.int32),
        })
        toks, lens = jax_greedy(out["ctc_log_probs"], out["enc_lengths"])
        ids = jax_to_lists(np.asarray(toks), np.asarray(lens))
        for r, i in enumerate(group):
            expected[i] = ids[r]
    assert any(expected), "random weights gave only blanks: the test is vacuous"

    pcfg = _port_cfg(jcfg)
    rec = Recognizer(
        pcfg, loader.FrontendConfig(n_fft=400, n_mels=20),
        pi.import_asr_params(params, pcfg), normalizer=norm, device="cpu",
        batch=batch,
    )
    assert rec.transcribe(wavs) == expected


def test_config_loader_matches_jax():
    """hparams/CTC/conmamba_small.yaml with a dotted override loads into
    the port's dataclasses with the JAX package's values."""
    path = "hparams/CTC/conmamba_small.yaml"
    overrides = {"model.d_model": 32, "model.mamba.d_state": 8}
    ours = loader.load_config(path, overrides)
    theirs = jax_load_config(path, overrides)
    assert ours.model == _port_cfg(theirs.model)
    assert dataclasses.asdict(ours.frontend) == dataclasses.asdict(theirs.frontend)
    assert ours.model.d_model == 32 and ours.model.mamba.d_state == 8
    assert loader.parse_overrides(["--model.d_model", "32", "--frontend.n_fft=400"]) \
        == {"model.d_model": 32, "frontend.n_fft": 400}
