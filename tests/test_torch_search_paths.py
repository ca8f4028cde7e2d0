"""The S2S searcher's two ways of running a decoder in the PyTorch port,
on the CPU, at a tiny size (d_model 32, nhead 2, 2 encoder and 2 decoder
layers, kernel 5, vocab 40, float32; params drawn from seeds by
`jax.eval_shape` and numpy, `tests/test_torch_lm.py:seeded_params`).
The helpers here also serve tests/test_torch_conformer_decoder.py, which
holds the Conformer decoder's search against JAX's.

- The decoder's kind picks the path, as JAX's `use_cache=None` does: the
  Transformer and the Mamba decoder step through their decode cache, the
  Conformer decoder re-scores its prefix through `decode` every step;
  the beam attention (K4's plain version) runs exactly when the ancestor
  table exists (an LM, or the Transformer decoder). Without and with a
  tiny LM.
- The prefix re-score's departure from JAX: JAX decodes the whole padded
  token buffer every step, the port the prefix tokens[:, :s+1] alone.
  Each decoder's position s from the prefix equals its position s from
  the padded buffer, with the memory's rows shared by each utterance's
  beam rows as the search passes them (1e-5).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.decoding.s2s_beam import S2SBeamSearcher as JaxSearcher
from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.models import mamba as jax_mamba

from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher
from mamba_asr_torch.models import asr, attention
from mamba_asr_torch.models import params_import as pi
from tests.test_torch_lm import jax_lm_params, port_of, seeded_params
from tests.test_torch_s2s_ops import port_cfg

torch.set_num_threads(1)

VOCAB = 40
JAX_MAMBA = jax_mamba.MambaConfig(d_state=4, d_conv=4, expand=2, dt_rank=2)
SEARCH = dict(beam_size=3, ctc_weight=0.4, ctc_candidates=8, temperature=1.15,
              max_steps_cap=8, min_decode_ratio=0.1)
FUSION = dict(lm_weight=0.6, temperature_lm=1.15)


@pytest.fixture(autouse=True)
def _no_grad():
    prev = torch.is_grad_enabled()
    torch.set_grad_enabled(False)
    yield
    torch.set_grad_enabled(prev)


def tiny_cfg(**kw):
    base = dict(
        vocab_size=VOCAB, n_mels=20, d_model=32, nhead=2, num_encoder_layers=2,
        num_decoder_layers=2, d_ffn=32, dropout=0.0, activation="gelu",
        encoder_module="conmamba", decoder_module="transformer", kernel_size=5,
        frontend_channels=(4, 6), mamba=JAX_MAMBA, compute_dtype="float32",
    )
    base.update(kw)
    return jax_asr.ASRConfig(**base)


FEATS = np.random.default_rng(1).normal(size=(2, 60, 20)).astype(np.float32)
FLENS = np.array([60, 40], np.int32)


def tiny_model(decoder, seed=3, **kw):
    """(jax model, seeded params, port model in eval mode, the port model's
    outputs on FEATS with seeded targets as numpy arrays: enc_out,
    enc_lengths, ctc_log_probs, seq_log_probs, and the targets
    tokens_bos). Both searchers take the same encoder outputs."""
    jcfg = tiny_cfg(decoder_module=decoder, **kw)
    model = jax_asr.ASRModel(jcfg)
    toks = np.random.default_rng(seed).integers(3, VOCAB, (2, 7)).astype(np.int32)
    toks[:, 0] = 1
    params = seeded_params(model, seed, jnp.asarray(FEATS), jnp.asarray(FLENS),
                           jnp.asarray(toks))
    pcfg = port_cfg(jcfg)
    pm = asr.ASRModel(pcfg)
    pm.load_state_dict(pi.import_asr_params(params, pcfg), strict=True)
    pm.eval()
    with torch.no_grad():
        out = pm(torch.from_numpy(FEATS), torch.from_numpy(FLENS),
                 torch.from_numpy(toks).long())
    out = {k: v.numpy() for k, v in out.items()}
    out["tokens_bos"] = toks
    return model, params, pm, out


def run_jax(model, params, out, lm=None, **kw):
    jlm, jlm_params = (None, None) if lm is None else lm
    got = JaxSearcher(model, lm_model=jlm, **kw)(
        {"params": params}, jnp.asarray(out["enc_out"]), jnp.asarray(out["enc_lengths"]),
        ctc_log_probs=jnp.asarray(out["ctc_log_probs"]),
        lm_params=None if jlm is None else {"params": jlm_params})
    return [np.asarray(x) for x in got]


def run_port(pm, out, lm=None, **kw):
    got = S2SBeamSearcher(pm, lm_model=lm, **kw)(
        torch.from_numpy(out["enc_out"]), torch.from_numpy(out["enc_lengths"]),
        torch.from_numpy(out["ctc_log_probs"]))
    return [x.numpy() for x in got]


def assert_same_search(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    return {decoder: tiny_model(decoder) for decoder in ("transformer", "mamba", "conformer")}


@pytest.fixture(scope="module")
def lm():
    model, params = jax_lm_params(seed=5, vocab=VOCAB)
    return model, params, port_of(params, vocab=VOCAB)


@pytest.mark.parametrize("fused", [False, True], ids=["no_lm", "lm"])
@pytest.mark.parametrize("decoder", ["transformer", "mamba", "conformer"])
def test_searcher_takes_its_path_from_the_decoder(models, lm, monkeypatch, decoder, fused):
    pm, out = models[decoder][2:]
    plm = lm[2] if fused else None
    calls = {"beam_attention": 0, "decode": 0, "decode_step": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(attention, "beam_attention",
                        counting("beam_attention", attention.beam_attention))
    for name in ("decode", "decode_step"):
        monkeypatch.setattr(asr.ASRModel, name, counting(name, getattr(asr.ASRModel, name)))
    kw = dict(SEARCH, **FUSION) if fused else dict(SEARCH)
    searcher = S2SBeamSearcher(pm, lm_model=plm, **kw)
    got = searcher(torch.from_numpy(out["enc_out"]), torch.from_numpy(out["enc_lengths"]),
                   torch.from_numpy(out["ctc_log_probs"]))
    steps = searcher.last_steps
    prefix = decoder == "conformer"
    assert calls["decode"] == (steps if prefix else 0), calls
    assert calls["decode_step"] == (0 if prefix else steps), calls
    assert (calls["beam_attention"] > 0) == (fused or decoder == "transformer"), calls
    assert any(n > 2 for n in got[1]), f"degenerate hypotheses {got}"


@pytest.mark.parametrize("decoder", ["transformer", "mamba", "conformer"])
def test_prefix_decode_equals_padded_decode(models, decoder):
    """Beam rows (B2 x beam 3) over the B2 memory, as the search decodes
    them (the Mamba decoder takes one memory row per token row)."""
    pm, out = models[decoder][2:]
    beam, s_max = 3, 9
    tokens = torch.from_numpy(
        np.random.default_rng(7).integers(3, VOCAB, (2 * beam, s_max))).long()
    tokens[:, 0] = 1
    enc = torch.from_numpy(out["enc_out"])
    lens = torch.from_numpy(out["enc_lengths"])
    if decoder == "mamba":
        enc, lens = enc.repeat_interleave(beam, 0), lens.repeat_interleave(beam, 0)
    else:
        full = pm.decode(tokens, enc.repeat_interleave(beam, 0), lens.repeat_interleave(beam, 0))
        torch.testing.assert_close(pm.decode(tokens, enc, lens), full, rtol=1e-5, atol=1e-5)
    padded = pm.decode(tokens, enc, lens)
    for s in range(s_max):
        torch.testing.assert_close(pm.decode(tokens[:, :s + 1], enc, lens)[:, s], padded[:, s],
                                   rtol=1e-5, atol=1e-5, msg=f"position {s}")
