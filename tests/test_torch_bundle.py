"""The port's exported CTC and S2S bundles (serving/export.py) against the
JAX package and the port's live paths, on the CPU, at tests/test_export.py's
tiny size (2 causal ConMamba layers of d_model 8, kernel 7, d_state 4,
n_mels 20, float32; the S2S models add one decoder layer of 2 heads).
JAX params come from `jax.eval_shape` and a numpy seed
(tests/test_torch_streaming.py:models) and reach the port through
`models.params_import`; JAX's LM is tests/test_torch_lm.py's.

- CTC: the bundle's log-probs against JAX's eval step on the same padded
  bucket within 2e-4 and against the port's live forward within 1e-6
  (a 0.7 s row in the (2, 1 s) bucket, and an exact fit), the seeded
  normaliser baked in; bucket selection and overflow as
  tests/test_export.py:101; 4 K1 nodes per program.
- S2S: the bundle's tokens and lengths equal to JAX's S2SBeamSearcher's
  on the same padded batch, its scores within 1e-4, for the Transformer
  decoder with the LM and for the Mamba decoder; the Conformer decoder's
  bundle equal to the port's live search. The step program's K3 and K4
  nodes, the init program's K1 nodes.
- Every manifest's keys and values equal to JAX's `_manifest` for the
  same config; no `.pt2` holds a tensor payload beyond the fbank tables
  and the normaliser, and at a width where the weights dominate each
  `.pt2` is under 10 % of params.pt.

JAX's references run in a child process (tests/_beside.py) while this
one exports the bundles.
"""

from __future__ import annotations

import collections
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mamba_asr_tpu.decoding.s2s_beam import S2SBeamSearcher as JaxSearcher
from mamba_asr_tpu.serving.export import _manifest as jax_manifest
from mamba_asr_tpu.training.normalizer import NormalizerState as JaxNormalizer
from mamba_asr_tpu.training.normalizer import apply_normalizer as jax_normalize
from mamba_asr_tpu.training.normalizer import init_normalizer as jax_init_normalizer
from mamba_asr_tpu.training.trainer import FrontendConfig as JaxFrontendConfig
from mamba_asr_tpu.training.trainer import compute_features, frame_lengths, make_eval_step

from mamba_asr_torch.configs.loader import FrontendConfig
from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher
from mamba_asr_torch.serving.export import (
    ExportedASR,
    export_ctc_bundle,
    export_s2s_bundle,
    program_launches,
)
from mamba_asr_torch.serving.recognizer import eval_step
from mamba_asr_torch.training.normalizer import NormalizerState
from tests._beside import beside
from tests.test_torch_lm import jax_lm_params, port_of
from tests.test_torch_streaming import models

torch.set_num_threads(1)

FE = dict(n_fft=256, n_mels=20, win_length_ms=16.0)
SR = 16000
VOCAB = 12
SEARCH = dict(beam_size=3, ctc_weight=0.4, ctc_candidates=6, temperature=1.15,
              max_steps_cap=8, min_decode_ratio=0.3)
FUSION = dict(lm_weight=0.6, temperature_lm=1.15)
NORM = (57.0, np.linspace(-2.0, 1.0, 20).astype(np.float32),
        np.linspace(30.0, 90.0, 20).astype(np.float32))


def noise(rows, n, seed):
    return np.random.default_rng(seed).normal(0, 0.3, (rows, n)).astype(np.float32)


def pt2_payload(path):
    """Bytes of the tensors an archive holds (weights, constants, sample
    inputs)."""
    with zipfile.ZipFile(path) as z:
        return sum(i.file_size for i in z.infolist() if "/data/" in i.filename
                   and not i.filename.endswith(".json"))


def ctc_cases():
    """(wav, lens, bucket): a 0.7 s row in the (2, 1 s) bucket, an exact fit."""
    n = int(0.7 * SR)
    return [(noise(1, n, 1), [n], (2, SR)), (noise(1, SR // 2, 2), [SR // 2], (1, SR // 2))]


def padded(wav, lens, bucket):
    pad = np.zeros(bucket, np.float32)
    pad[:1, :wav.shape[1]] = wav
    lens_pad = np.ones(bucket[0], np.int32)
    lens_pad[0] = lens[0]
    return pad, lens_pad


def _jax_ctc_refs():
    """JAX's eval step on each of `ctc_cases`, padded to its bucket: its
    first row's (log-probs, encoder length)."""
    jm, jp, _ = models()
    jax_step = make_eval_step(jm, JaxFrontendConfig(**FE))
    jnorm = JaxNormalizer(*(jnp.asarray(x) for x in NORM))
    refs = []
    for wav, lens, bucket in ctc_cases():
        pad, lens_pad = padded(wav, lens, bucket)
        ref = jax_step(jp["params"], jnorm, {"wav": jnp.asarray(pad),
                                             "wav_lens": jnp.asarray(lens_pad),
                                             "tokens_bos": jnp.zeros((bucket[0], 4), jnp.int32)})
        refs.append((np.asarray(ref["ctc_log_probs"])[:1], np.asarray(ref["enc_lengths"])[:1]))
    return refs


def _jax_s2s_ref(name):
    """JAX's S2SBeamSearcher on `s2s_batch` with the model (and LM) of
    S2S_MODELS[name]: (tokens, lengths, scores)."""
    jm, jp, _ = s2s_models(name)
    jlm = jax_lm_params(seed=5, vocab=VOCAB) if name.endswith("_lm") else None
    wav, lens = s2s_batch()
    frontend = JaxFrontendConfig(**FE)

    @jax.jit  # one compile: JAX's op-by-op dispatch compiles every op apart
    def forward(params, wav, lens):
        feats = compute_features(frontend, wav)
        flens = jnp.minimum(frame_lengths(frontend, lens), feats.shape[1])
        feats = jax_normalize(jax_init_normalizer(20), feats)
        return jm.apply(params, feats, flens, None, train=False)

    mo = forward(jp, jnp.asarray(wav), jnp.asarray(lens))
    opts = dict(SEARCH, **(FUSION if jlm else {}))
    ref = JaxSearcher(jm, lm_model=None if jlm is None else jlm[0], **opts)(
        jp, mo["enc_out"], mo["enc_lengths"], ctc_log_probs=mo["ctc_log_probs"],
        lm_params=None if jlm is None else {"params": jlm[1]})
    return tuple(np.asarray(r) for r in ref[:3])


def _jax_s2s_refs():
    return {name: _jax_s2s_ref(name) for name in ("transformer_lm", "mamba")}


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """{"ctc": wait, "s2s": wait}: JAX's references of the CTC and of the
    S2S checks, which two child processes compute beside this one's
    exports (the bundle fixtures ask for this one first)."""
    work = tmp_path_factory.mktemp("jax_refs")
    return {"ctc": beside(work, "tests.test_torch_bundle", "_jax_ctc_refs"),
            "s2s": beside(work, "tests.test_torch_bundle", "_jax_s2s_refs")}


@pytest.fixture(scope="module")
def ctc(tmp_path_factory, jax_refs):
    jm, jp, pm = models()
    norm = NormalizerState.from_arrays(*NORM)
    out = str(tmp_path_factory.mktemp("ctc"))
    manifest = export_ctc_bundle(pm, norm, FrontendConfig(**FE), out, [(1, SR // 2), (2, SR)])
    return jm, jp, pm, norm, out, manifest


def test_ctc_bundle_matches_jax_and_live(ctc, jax_refs):
    jm, jp, pm, norm, out, _ = ctc
    asr = ExportedASR(out, device="cpu")
    for (wav, lens, bucket), (ref_lp, ref_el) in zip(ctc_cases(), jax_refs["ctc"]()):
        lp, el = asr(wav, lens)
        assert lp.shape[0] == 1 and lp.shape[2] == VOCAB - 3 and el.shape == (1,)
        pad, lens_pad = padded(wav, lens, bucket)
        np.testing.assert_allclose(lp, ref_lp, rtol=0, atol=2e-4)
        np.testing.assert_array_equal(el, ref_el)
        with torch.no_grad():
            live = eval_step(pm, FrontendConfig(**FE), norm, torch.from_numpy(pad),
                             torch.from_numpy(lens_pad))
        np.testing.assert_allclose(lp, live["ctc_log_probs"][:1].numpy(), rtol=0, atol=1e-6)
    assert program_launches(asr) == {
        "fn_b2_t16000.pt2": {"selective_scan_fwd": 2},
        "fn_b1_t8000.pt2": {"selective_scan_fwd": 2}}


def test_bucket_selection_and_overflow(ctc):
    """The smallest fitting bucket wins (JAX's rule over JAX's buckets);
    what fits none raises."""
    asr = ExportedASR(ctc[4], device="cpu")
    assert asr._pick(1, SR // 4) == (1, SR // 2)
    assert asr._pick(2, SR // 4) == (2, SR)
    asr.buckets = sorted([(1, SR // 2), (4, SR // 2), (1, SR)])
    assert asr._pick(1, SR // 4) == (1, SR // 2)
    assert asr._pick(2, SR // 4) == (4, SR // 2)
    assert asr._pick(1, 3 * SR // 4) == (1, SR)
    with pytest.raises(ValueError, match="no exported bucket fits"):
        asr._pick(2, SR)
    with pytest.raises(ValueError, match="no exported bucket fits"):
        ExportedASR(ctc[4], device="cpu")(noise(3, 100, 0), [100] * 3)


def test_manifests_match_jax(ctc, s2s):
    jm, _, pm, _, out, manifest = ctc
    frontend = JaxFrontendConfig(**FE)
    assert manifest == jax_manifest(jm, frontend, [[1, SR // 2], [2, SR]], ["cpu"], "ctc")
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == manifest
    for name, (jm, *_rest, manifest) in s2s.items():
        want = jax_manifest(jm, frontend, [[2, SR // 2]], ["cpu"], "s2s")
        want.update(has_lm=name == "transformer_lm", bos_id=1, eos_id=2)
        assert manifest == want, name


def test_programs_hold_no_weights(ctc, s2s, tmp_path):
    """Every program's tensors are the fbank tables, the normaliser and a
    few scalars (within 1 KB of the CTC program's, at any width); at
    d_model 384 a program is under 10 % of params.pt."""
    fe = FrontendConfig(**FE)
    tables = pt2_payload(os.path.join(ctc[4], "fn_b1_t8000.pt2"))
    bundles = [ctc[4]] + [entry[-2] for entry in s2s.values()]
    for out in bundles:
        for name in os.listdir(out):
            if name.endswith(".pt2"):
                assert pt2_payload(os.path.join(out, name)) <= tables + 1024, (out, name)
    wide = models(d_model=384, d_ffn=1536, frontend_channels=(4, 6))[2]
    out = str(tmp_path / "wide")
    export_ctc_bundle(wide, None, fe, out, [(1, SR // 2)])
    params = os.path.getsize(os.path.join(out, "params.pt"))
    assert params > 20e6
    assert os.path.getsize(os.path.join(out, "fn_b1_t8000.pt2")) < 0.1 * params


# -- S2S ----------------------------------------------------------------------------

S2S_MODELS = {
    "transformer_lm": dict(decoder_module="transformer"),
    "mamba": dict(decoder_module="mamba"),
    "conformer": dict(decoder_module="conformer"),
}


def s2s_models(name):
    """(jax model, params, port model) of S2S_MODELS[name]."""
    return models(seed=3, vocab_size=VOCAB, num_decoder_layers=1, nhead=2, activation="gelu",
                  **S2S_MODELS[name])


@pytest.fixture(scope="module")
def s2s(tmp_path_factory, jax_refs):
    """name -> (jax model, params, port model, jax LM or None, port searcher,
    bundle dir, manifest), each bundle at the (2, 0.5 s) bucket."""
    out = {}
    for name in S2S_MODELS:
        jm, jp, pm = s2s_models(name)
        jlm = plm = None
        opts = dict(SEARCH)
        if name.endswith("_lm"):
            jlm = jax_lm_params(seed=5, vocab=VOCAB)
            plm = port_of(jlm[1], vocab=VOCAB)
            opts.update(FUSION)
        searcher = S2SBeamSearcher(pm, lm_model=plm, **opts)
        d = str(tmp_path_factory.mktemp(name))
        manifest = export_s2s_bundle(pm, None, FrontendConfig(**FE), searcher, d,
                                     [(2, SR // 2)])
        out[name] = (jm, jp, pm, jlm, searcher, d, manifest)
    return out


def s2s_batch():
    wav = noise(2, SR // 2, 4)
    wav[1, 6000:] = 0.0
    return wav, np.array([SR // 2, 6000], np.int32)


@pytest.mark.parametrize("name", ["transformer_lm", "mamba"])
def test_s2s_bundle_matches_jax(s2s, jax_refs, name):
    jm, jp, pm, jlm, searcher, out, _ = s2s[name]
    asr = ExportedASR(out, device="cpu")
    wav, lens = s2s_batch()
    toks, tlens, scores = asr(wav, lens)
    ref = jax_refs["s2s"]()[name]
    np.testing.assert_array_equal(toks, ref[0])
    np.testing.assert_array_equal(tlens, ref[1])
    np.testing.assert_allclose(scores, ref[2], rtol=1e-4, atol=1e-4)
    assert any(n > 2 for n in tlens), f"degenerate hypotheses {toks}"
    step = program_launches(asr)["fn_b2_t8000_step.pt2"]
    init = program_launches(asr)["fn_b2_t8000_init.pt2"]
    if name == "transformer_lm":  # the decoder's layer and the LM's
        assert step == {"beam_attention": 1 + 2, "ctc_dp": 1} and init == {
            "selective_scan_fwd": 2}
    else:  # the encoder's 2 scans and the decoder's prime
        assert step == {"ctc_dp": 1} and init == {"selective_scan_fwd": 2 + 1}
    assert asr.last_steps == SEARCH["max_steps_cap"] or not np.all(tlens < 8)


def test_conformer_decoder_bundle_matches_live_search(s2s):
    """The step re-scores the whole padded buffer and reads column s; the
    live search re-scores the prefix: the decoder is causal."""
    _, _, pm, _, searcher, out, _ = s2s["conformer"]
    asr = ExportedASR(out, device="cpu")
    wav, lens = s2s_batch()
    got = asr(wav, lens)
    with torch.no_grad():
        o = eval_step(pm, FrontendConfig(**FE), NormalizerState.from_arrays(
            0.0, np.zeros(20, np.float32), np.zeros(20, np.float32)),
            torch.from_numpy(wav), torch.from_numpy(lens))
        want = searcher(o["enc_out"], o["enc_lengths"], o["ctc_log_probs"])
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    np.testing.assert_allclose(got[2], want[2].numpy(), rtol=1e-5, atol=1e-5)
    assert asr.last_steps == searcher.last_steps
    assert program_launches(asr)["fn_b2_t8000_step.pt2"] == {"ctc_dp": 1}


class OpCounts(TorchDispatchMode):
    """Calls of the `mamba_asr::*` ops that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "mamba_asr":
            self.n[func._opname] += 1
        return func(*args, **(kwargs or {}))


def test_live_path_goes_through_the_ops(s2s):
    """The live forward and search reach K1, K3 and K4 through the same
    `mamba_asr::*` ops an exported program holds: 2 scans per forward,
    per step one DP and a beam attention per decoder and LM layer."""
    _, _, pm, _, searcher, _, _ = s2s["transformer_lm"]
    wav, lens = s2s_batch()
    with torch.no_grad(), OpCounts() as counts:
        o = eval_step(pm, FrontendConfig(**FE), NormalizerState.from_arrays(*NORM),
                      torch.from_numpy(wav), torch.from_numpy(lens))
        searcher(o["enc_out"], o["enc_lengths"], o["ctc_log_probs"])
    steps = searcher.last_steps
    assert steps > 2
    assert counts.n == {"selective_scan_fwd": 2, "ctc_dp": steps, "beam_attention": 3 * steps}


def test_params_written_once_and_read_back(ctc):
    """The CTC bundle's weights: params.pt written once, for both buckets,
    and read back equal to the model's parameters and buffers."""
    _, _, pm, _, out, _ = ctc
    saved = torch.load(os.path.join(out, "params.pt"), weights_only=True)
    own = dict(pm.named_parameters())
    own.update(pm.named_buffers())
    assert list(saved) == list(own)
    for k, v in own.items():
        torch.testing.assert_close(saved[k], v, rtol=0, atol=0)
    assert [f for f in os.listdir(out) if f.endswith(".pt")] == ["params.pt"]
