"""Streaming in the PyTorch port against the JAX package, on the CPU, at
a tiny size (d_model 8 or 16, 2 layers, n_mels 20, d_state 4, float32).

JAX params come from `jax.eval_shape` and a numpy seed
(tests/test_torch_conformer.py:seeded) and reach the port through
`models.params_import.import_asr_params`; both sides see the same numpy
inputs. The JAX sessions are fed equal chunks and share one prototype's
jitted closures, so each shape compiles once; the other JAX sides run
as one jitted function each.

- The causal ConMamba session (JAX tests/test_streaming.py:272-320) at
  256, 251 and 253 frames: tokens equal to JAX's and to the port's own
  offline greedy decode of the canonically padded features; each chunk's
  log-probs within 2e-5 + 2e-4 of JAX's.
- `ASRModel.forward_chunk` of the bidirectional ConMamba, the Conformer
  and the Branchformer over 3 chunks from stream start (empty left
  context): within 2e-5 + 2e-4 of JAX's, state carried.
- `StreamingFrontend` at ragged feeds: each emission equal to JAX's.
- `extend_cache` over chunks against one `prime_cache` of the whole
  memory and against JAX's; `StreamingS2SSession.decode_greedy`'s tokens
  equal to JAX's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.models import mamba as jax_mamba
from mamba_asr_tpu.models import streaming as jax_streaming
from mamba_asr_tpu.models.conmamba import MambaDecoder as JaxMambaDecoder
from mamba_asr_tpu.training.trainer import FrontendConfig as JaxFrontendConfig

from mamba_asr_torch.configs.loader import FrontendConfig
from mamba_asr_torch.decoding.ctc_greedy import ctc_greedy_decode
from mamba_asr_torch.models import asr, streaming
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.ops.fbank import log_mel_spectrogram
from tests.test_torch_conformer import port_cfg, seeded

torch.set_num_threads(1)

# The sequential lax.scan: the quickest to compile, and the port's order.
MCFG = jax_mamba.MambaConfig(d_state=4, d_conv=4, expand=2, scan_impl="ref")
FRONTEND = dict(n_fft=256, n_mels=20, win_length_ms=16.0)
TOL = dict(atol=2e-5, rtol=2e-4)


@pytest.fixture(autouse=True)
def _no_grad():
    prev = torch.is_grad_enabled()
    torch.set_grad_enabled(False)
    yield
    torch.set_grad_enabled(prev)


def jax_cfg(**kw):
    base = dict(vocab_size=9, n_mels=20, d_model=8, nhead=2, num_encoder_layers=2,
                num_decoder_layers=0, d_ffn=16, dropout=0.0, encoder_module="conmamba",
                kernel_size=7, causal=True, bidirectional=False, mamba=MCFG,
                frontend_channels=(4, 6), csgu_linear_units=16)
    base.update(kw)
    return jax_asr.ASRConfig(**base)


def models(seed=1, **kw):
    """(jax model, {"params": params}, port model in eval mode)."""
    jcfg = jax_cfg(**kw)
    model = jax_asr.ASRModel(jcfg)
    args = [jnp.zeros((1, 32, 20)), jnp.array([32])]
    if jcfg.num_decoder_layers:
        args.append(jnp.ones((1, 3), jnp.int32))
    params = seeded(model, seed, *args)
    pm = asr.ASRModel(port_cfg(jcfg))
    pm.load_state_dict(pi.import_asr_params(params, pm.cfg), strict=True)
    return model, {"params": params}, pm.eval()


@pytest.fixture(scope="module")
def causal():
    model, params, pm = models()
    proto = jax_streaming.StreamingASRSession(model, params, JaxFrontendConfig(**FRONTEND),
                                              chunk_frames=32)
    return model, params, pm, proto


@pytest.mark.parametrize("n_frames", [256, 251, 253])
def test_causal_session_matches_jax_and_offline(causal, n_frames):
    model, params, pm, proto = causal
    hop = JaxFrontendConfig(**FRONTEND).hop
    n_samples = (n_frames - 1) * hop  # center framing: S // hop + 1 frames
    wav = np.random.default_rng(7).normal(0, 0.3, size=(1, n_samples)).astype(np.float32)
    chunk = 32 * hop
    jsess = jax_streaming.StreamingASRSession(
        model, params, JaxFrontendConfig(**FRONTEND), chunk_frames=32,
        collect_log_probs=True, shared=proto)
    psess = streaming.StreamingASRSession(pm, FrontendConfig(**FRONTEND), chunk_frames=32,
                                          collect_log_probs=True)
    got, want = [], []
    for i in range(0, n_samples, chunk):
        want += jsess.feed(wav[:, i:i + chunk])[0]
        got += psess.feed(wav[:, i:i + chunk])[0]
    want += jsess.finish()[0]
    got += psess.finish()[0]
    assert got == [int(t) for t in want] and got
    assert len(psess.log_probs) == len(jsess.log_probs)
    for a, b in zip(psess.log_probs, jsess.log_probs):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)

    # The offline equal: the same features zero-padded to a multiple of 4.
    feats = log_mel_spectrogram(torch.from_numpy(wav), **FRONTEND)
    assert feats.shape[1] == n_frames
    feats = torch.nn.functional.pad(feats, (0, 0, 0, (-n_frames) % pm.cfg.downsample))
    out = pm(feats, torch.tensor([feats.shape[1]]))
    toks, lens = ctc_greedy_decode(out["ctc_log_probs"], out["enc_lengths"])
    assert got == toks[0, :int(lens[0])].tolist()


def jax_chunks(model, params, fe, size):
    """JAX's encoder outputs for each chunk of `size` frames of the front
    end's output fe (B, T, F, C), from a fresh stream; one jitted chunk."""
    def chunk(m, x, s):
        b, t, f, c = x.shape
        return m.encoder.forward_chunk(m.src_proj(x.reshape(b, t, f * c)), s)

    run = jax.jit(lambda x, s: model.apply(params, x, s, method=chunk))
    state = model.apply(params, fe.shape[0], method=jax_asr.ASRModel.init_streaming_state)
    outs = []
    for lo in range(0, fe.shape[1], size):
        y, state = run(jnp.asarray(fe[:, lo:lo + size]), state)
        outs.append(np.asarray(y))
    return outs


@pytest.mark.parametrize("encoder", ["conmamba", "conformer", "branchformer"])
def test_forward_chunk_matches_jax(encoder):
    """From stream start (every left slot empty, zero tails) over 3 chunks
    of 8 frames, B2: each chunk's encoder output."""
    kw = dict(encoder_module=encoder, causal=False, d_model=16)
    if encoder == "conmamba":
        kw["bidirectional"] = True
    model, params, pm = models(seed=3, **kw)
    fe = np.random.default_rng(5).normal(size=(2, 24, 5, 6)).astype(np.float32)
    pstate = pm.init_streaming_state(2)
    for c, want in enumerate(jax_chunks(model, params, fe, 8)):
        x = fe[:, 8 * c:8 * (c + 1)]
        got, pstate = pm.forward_chunk(torch.from_numpy(x), pstate)
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=f"chunk {c}")
    # The state carries: chunk 3 again from a fresh state differs.
    fresh, _ = pm.forward_chunk(torch.from_numpy(x), pm.init_streaming_state(2))
    assert not torch.allclose(fresh, got, atol=1e-4)


def test_init_streaming_state_refuses_the_transformer_encoder():
    pm = asr.ASRModel(port_cfg(jax_cfg(encoder_module="transformer", causal=False)))
    with pytest.raises(ValueError, match="does not stream"):
        pm.init_streaming_state(1)


def test_streaming_frontend_matches_jax(causal):
    model, params, pm, proto = causal
    feats = np.random.default_rng(2).normal(size=(1, 40, 20)).astype(np.float32)
    jfe = jax_streaming.StreamingFrontend(model, params, 1, shared=proto.fe_stream)
    pfe = streaming.StreamingFrontend(pm)
    start = 0
    for size in (5, 1, 7, 3, 12, 2, 10):
        x = feats[:, start:start + size]
        start += size
        want, got = jfe.feed(jnp.asarray(x)), pfe.feed(torch.from_numpy(x))
        assert (want is None) == (got is None)
        if got is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want, got = jfe.finish(), pfe.finish()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def s2s():
    return models(seed=4, d_model=16, num_encoder_layers=1, num_decoder_layers=2,
                  decoder_module="mamba", vocab_size=12)


def test_extend_cache_matches_prime_and_jax(s2s):
    model, params, pm = s2s
    mem = np.random.default_rng(6).normal(size=(2, 12, 16)).astype(np.float32)

    @jax.jit
    def jax_extended(mem):
        def dec(method, *args):
            return model.apply(params, *args, method=lambda m, *a: method(m.decoder, *a))

        cache = dec(JaxMambaDecoder.init_cache, 2)
        cache = dec(JaxMambaDecoder.prime_cache, mem[:, :5], cache)
        cache = dec(JaxMambaDecoder.extend_cache, mem[:, 5:9], cache)
        return dec(JaxMambaDecoder.extend_cache, mem[:, 9:], cache)

    jcache = jax_extended(jnp.asarray(mem))
    pcache = pm.decoder.prime_cache(torch.from_numpy(mem[:, :5]), pm.init_decoder_cache(2))
    for lo, hi in ((5, 9), (9, 12)):
        pcache = pm.extend_decoder_cache(torch.from_numpy(mem[:, lo:hi]), pcache)
    full = pm.decoder.prime_cache(torch.from_numpy(mem), pm.init_decoder_cache(2))
    for layer, jlayer, flayer in zip(pcache, jcache, full):
        for part in ("self", "cross"):
            for got, want, whole in zip(layer[part], jlayer[part], flayer[part]):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
                np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)


def test_s2s_session_decode_greedy_matches_jax(s2s):
    model, params, pm = s2s
    rng = np.random.default_rng(0)
    chunks = [rng.normal(0, 0.3, size=(1, 16 * 128)).astype(np.float32) for _ in range(4)]
    jsess = jax_streaming.StreamingS2SSession(model, params, JaxFrontendConfig(**FRONTEND),
                                              chunk_frames=16)
    psess = streaming.StreamingS2SSession(pm, FrontendConfig(**FRONTEND), chunk_frames=16)
    got, want = [], []
    for sess, out in ((jsess, want), (psess, got)):
        for c in chunks[:3]:
            sess.feed(c)
        out.append(sess.decode_greedy(max_new=4))
        sess.feed(chunks[3])
        out.append(sess.decode_greedy(max_new=4))
        sess.finish()
        out.append(sess.decode_greedy(max_new=4))
    assert got == want and any(hyp[0] for hyp in got)
