"""The slot-batched StreamingServer of the PyTorch port against the JAX
package's, on the CPU, at tests/test_serving.py's tiny size (d_model 8,
2 causal unidirectional ConMamba layers, kernel 7, vocab 9, n_mels 20,
d_state 4, float32).

JAX params come from `jax.eval_shape` and a numpy seed
(tests/test_torch_conformer.py:seeded) and reach the port through
`models.params_import`; both engines see the same numpy audio. Two JAX
engines are built: one for a staggered scenario, one with an LM.

- The staggered scenario (attach mid-flight, ragged feeds, a finish while
  others tick, a full server, an abort, reused slots, finish_final with
  word spans): every emission, tail, final id list and span equal to
  JAX's, the trailing silence after every tick and `stats()` (but its
  wall-clock tick_ms_avg) equal to JAX's; the accumulated encoder output
  within 2e-5 + 2e-4 of JAX's; each transcript equal to the port's
  offline greedy decode of the canonically padded features.
- `"ctc_beam"` with a seeded LM (JAX's weights through the port's LM
  import): final ids equal to JAX's engine and to ctc_beam_search_nbest +
  rescore_nbest run directly.
- The port alone (its session, offline forward and searchers are held
  against JAX elsewhere): masked and full slots, exactness against the
  single session and offline with slot reuse, `"s2s"` for both decoders
  equal to S2SBeamSearcher run directly, a Conformer and a Branchformer
  engine equal to their single sessions (state rows with an int32
  leaf), and the tree helpers.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.models import lm as jax_lm
from mamba_asr_tpu.serving.engine import StreamingServer as JaxServer
from mamba_asr_tpu.training.trainer import FrontendConfig as JaxFrontendConfig

from mamba_asr_torch.configs.loader import FrontendConfig
from mamba_asr_torch.decoding.ctc_beam import ctc_beam_search_nbest
from mamba_asr_torch.decoding.ctc_greedy import ctc_greedy_decode
from mamba_asr_torch.decoding.rescore import rescore_nbest
from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher
from mamba_asr_torch.models import asr
from mamba_asr_torch.models import lm as port_lm
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.models.streaming import StreamingASRSession
from mamba_asr_torch.ops.fbank import log_mel_spectrogram
from mamba_asr_torch.serving import engine as eng
from tests.test_torch_conformer import seeded
from tests.test_torch_streaming import models

torch.set_num_threads(1)

FE = dict(n_fft=256, n_mels=20, win_length_ms=16.0)
HOP = JaxFrontendConfig(**FE).hop
CHUNK = 32
TOL = dict(atol=2e-5, rtol=2e-4)
TINY = dict(frontend_channels=(64, 32))  # tests/test_serving.py's front end


def noise(n_frames, seed):
    return np.random.default_rng(seed).normal(0, 0.3, size=n_frames * HOP).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    """(jax model, {"params": params}, port model in eval mode)."""
    return models(**TINY)


def port_engine(pm, n_slots, **kw):
    return eng.StreamingServer(pm, FrontendConfig(**FE), None, n_slots=n_slots,
                               chunk_frames=CHUNK, **kw)


@torch.no_grad()
def offline(pm, wav):
    """The port's offline forward on the canonically padded features."""
    feats = log_mel_spectrogram(torch.from_numpy(wav)[None], **FE)
    feats = torch.nn.functional.pad(feats, (0, 0, 0, (-feats.shape[1]) % pm.cfg.downsample))
    return pm(feats, torch.tensor([feats.shape[1]]))


def offline_greedy(pm, wav):
    out = offline(pm, wav)
    toks, lens = ctc_greedy_decode(out["ctc_log_probs"], out["enc_lengths"])
    return toks[0, :int(lens[0])].tolist()


def session_ids(pm, wav, chunk_samples):
    sess = StreamingASRSession(pm, FrontendConfig(**FE), chunk_frames=CHUNK)
    ids = []
    for off in range(0, len(wav), chunk_samples):
        ids += sess.feed(wav[None, off:off + chunk_samples])[0]
    return ids + sess.finish()[0]


# -- the staggered scenario, on either package's engine ------------------------------------

WAVS = {"a": noise(220, 1), "b": noise(17, 2), "c": noise(149, 3)[:-HOP // 2],
        "e": noise(120, 4), "d": noise(111, 5)}


def enc_rows(engine, sid):
    """The stream's accumulated encoder output so far, numpy (1, T, d)."""
    acc = engine._enc_acc[engine._slot_of_sid[sid]]
    return np.concatenate([np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                                      np.float32) for x in acc], axis=1)


def scenario(engine):
    """A log of everything the engine returns along one fixed script."""
    rng = np.random.default_rng(9)
    log, sids, cursor, got = [], {}, {}, {}

    def attach(name):
        sids[name] = engine.attach()
        cursor[name], got[name] = 0, []

    def tick():
        for sid, toks in sorted(engine.tick().items()):
            name = next(k for k, v in sids.items() if v == sid)
            got[name] += toks
            log.append(("tick", name, list(map(int, toks))))
        log.append(("silence", {k: engine.trailing_silence_s(v) for k, v in sids.items()}))

    for name in "abe":
        attach(name)
    with pytest.raises(RuntimeError, match="server full"):
        engine.attach()
    step = 0
    while any(cursor[k] < len(WAVS[k]) for k in sids):
        for name in list(sids):
            if cursor[name] < len(WAVS[name]):
                n = int(rng.integers(1, 40)) * HOP // 2
                engine.feed(sids[name], WAVS[name][cursor[name]:cursor[name] + n])
                cursor[name] += n
        if step == 2:  # b ends while a and e tick; c takes its slot
            tail = engine.finish(sids.pop("b"))
            log.append(("finish", "b", got["b"] + list(map(int, tail))))
            attach("c")
        if step == 4:  # e is abandoned mid-stream; d takes its slot
            engine.abort(sids.pop("e"))
            attach("d")
        tick()
        step += 1
    log.append(("enc_a", enc_rows(engine, sids["a"])))
    tail, final, spans = engine.finish_final(sids.pop("a"), want_times=True)
    log.append(("final", "a", got["a"] + list(map(int, tail)), list(map(int, final)),
                [tuple(map(int, s[:3])) for s in spans], [float(s[3]) for s in spans]))
    tail = engine.finish(sids.pop("c"))
    log.append(("finish", "c", got["c"] + list(map(int, tail))))
    tail, final = engine.finish_final(sids.pop("d"))
    log.append(("final", "d", got["d"] + list(map(int, tail)), list(map(int, final))))
    stats = engine.stats()
    assert stats["tick_ms_avg"] > 0
    log.append(("stats", {k: v for k, v in stats.items() if k != "tick_ms_avg"}))
    assert engine.free_slots == 3
    return log


@pytest.fixture(scope="module")
def logs(tiny):
    model, params, pm = tiny
    kw = dict(n_slots=3, final_decode="ctc_beam", beam_size=4)
    jax_log = scenario(JaxServer(model, params, JaxFrontendConfig(**FE), chunk_frames=CHUNK,
                                 **kw))
    return jax_log, scenario(port_engine(pm, **kw))


def test_staggered_scenario_matches_jax(logs):
    jax_log, port_log = logs
    assert [e[0] for e in port_log] == [e[0] for e in jax_log]
    for got, want in zip(port_log, jax_log):
        if got[0] == "enc_a":
            np.testing.assert_allclose(got[1], want[1], **TOL)
        elif got[0] == "final" and len(got) == 6:
            assert got[1:5] == want[1:5]
            np.testing.assert_allclose(got[5], want[5], rtol=1e-5)
        else:
            assert got == want, got[0]
    finals = [e for e in port_log if e[0] == "final"]
    assert finals[0][4], "the alignment produced no token (a degenerate input)"


def test_staggered_scenario_is_offline_exact(tiny, logs):
    _, _, pm = tiny
    ids = {e[1]: e[2] for e in logs[1] if e[0] in ("finish", "final")}
    assert set(ids) == {"a", "b", "c", "d"}
    for name, got in ids.items():
        assert got == offline_greedy(pm, WAVS[name]), name
    assert any(ids.values())


# -- the LM's final pass ---------------------------------------------------------------------

def test_final_ctc_beam_with_lm_matches_jax_and_direct(tiny):
    model, params, pm = tiny
    jlm = jax_lm.TransformerLM(vocab_size=9, d_model=16, nhead=2, num_layers=1, d_ffn=16)
    lm_params = seeded(jlm, 5, jnp.zeros((1, 4), jnp.int32))
    plm = port_lm.TransformerLM(9, 16, 2, 1, 16)
    plm.load_state_dict(pi.import_lm_params(lm_params, 1), strict=True)
    plm.eval()
    opts = {"lm_weight": 0.6, "nbest": 4}
    wav = noise(133, 43)
    finals = []
    for e in (JaxServer(model, params, JaxFrontendConfig(**FE), n_slots=1, chunk_frames=CHUNK,
                        final_decode="ctc_beam", beam_size=4, lm_model=jlm,
                        lm_params={"params": lm_params}, decode_opts=opts),
              port_engine(pm, 1, final_decode="ctc_beam", beam_size=4, lm_model=plm,
                          decode_opts=opts)):
        sid = e.attach()
        for off in range(0, len(wav), CHUNK * HOP):
            e.feed(sid, wav[off:off + CHUNK * HOP])
            e.tick()
        finals.append(list(map(int, e.finish_final(sid)[1])))
    assert finals[1] == finals[0] and finals[1]
    # Directly: the offline log-probs, padded as the engine pads.
    with torch.no_grad():
        lp = offline(pm, wav)["ctc_log_probs"]
        t = lp.shape[1]
        lp = torch.nn.functional.pad(lp, (0, 0, 0, (-t) % eng.FINAL_BUCKET))
        toks, lens, scores = ctc_beam_search_nbest(lp, torch.tensor([t]), nbest=4, beam_size=4)
        bt, bl = rescore_nbest(toks, lens, scores, plm, lm_weight=0.6)
    assert finals[1] == bt[0, :int(bl[0])].tolist()


# -- the port alone --------------------------------------------------------------------------

def test_full_server_and_masked_slots(tiny):
    """attach raises when full; a starved slot keeps its state through
    other slots' masked ticks and stays exact."""
    _, _, pm = tiny
    server = port_engine(pm, 2)
    wav_a, wav_b = noise(128, 5), noise(128, 6)
    sid_a, sid_b = server.attach(), server.attach()
    with pytest.raises(RuntimeError, match="server full"):
        server.attach()
    got = {sid_a: [], sid_b: []}
    server.feed(sid_b, wav_b[:40 * HOP])
    for i in range(0, len(wav_a), CHUNK * HOP):
        server.feed(sid_a, wav_a[i:i + CHUNK * HOP])
        for sid, toks in server.tick().items():
            got[sid] += toks
    server.feed(sid_b, wav_b[40 * HOP:])
    for sid, toks in server.tick().items():
        got[sid] += toks
    got[sid_a] += server.finish(sid_a)
    got[sid_b] += server.finish(sid_b)
    assert got[sid_a] == offline_greedy(pm, wav_a)
    assert got[sid_b] == offline_greedy(pm, wav_b)
    assert server.stats()["batched_rows_total"] > 0


def test_single_session_exact_with_slot_reuse(tiny):
    """Five streams through two slots, 48 frames fed at a time: each equals
    the single session and the offline greedy decode."""
    _, _, pm = tiny
    server = port_engine(pm, 2)
    wavs = [noise(96 + 13 * i, 11 + i) for i in range(5)]
    results, queue, live = {}, list(enumerate(wavs)), {}
    while queue or live:
        while queue and server.free_slots:
            idx, _ = queue.pop(0)
            live[server.attach()] = [idx, 0, []]
        for sid, st in live.items():
            server.feed(sid, wavs[st[0]][st[1]:st[1] + 48 * HOP])
            st[1] += 48 * HOP
        for sid, toks in server.tick().items():
            live[sid][2] += toks
        for sid in [s for s, st in live.items() if st[1] >= len(wavs[st[0]])]:
            idx, _, toks = live.pop(sid)
            results[idx] = toks + server.finish(sid)
    for idx, w in enumerate(wavs):
        assert results[idx] == session_ids(pm, w, CHUNK * HOP) == offline_greedy(pm, w), idx


@pytest.mark.parametrize("decoder", ["mamba", "transformer"])
def test_final_s2s_matches_searcher(decoder):
    cfg = asr.ASRConfig(vocab_size=9, n_mels=20, d_model=8, nhead=2, num_encoder_layers=2,
                        num_decoder_layers=1, d_ffn=16, dropout=0.0, decoder_module=decoder,
                        kernel_size=7, causal=True, bidirectional=False,
                        mamba=asr.MambaConfig(d_state=4, d_conv=4, expand=2))
    pm = asr.init_params_(asr.ASRModel(cfg), torch.Generator().manual_seed(3)).eval()
    opts = dict(ctc_weight=0.3, ctc_candidates=4, max_steps_cap=8)
    server = port_engine(pm, 2, final_decode="s2s", beam_size=3, decode_opts=opts)
    wav = noise(100, 29)
    sid = server.attach()
    for off in range(0, len(wav), CHUNK * HOP):
        server.feed(sid, wav[off:off + CHUNK * HOP])
        server.tick()
    _, final = server.finish_final(sid)
    with torch.no_grad():
        out = offline(pm, wav)
        t = out["enc_out"].shape[1]
        pad = (0, 0, 0, (-t) % eng.FINAL_BUCKET)
        toks, lens, _ = S2SBeamSearcher(pm, beam_size=3, **opts)(
            torch.nn.functional.pad(out["enc_out"], pad), out["enc_lengths"],
            ctc_log_probs=torch.nn.functional.pad(out["ctc_log_probs"], pad))
    assert final == toks[0, :int(lens[0])].tolist() and final


@pytest.mark.parametrize("encoder", ["conformer", "branchformer"])
def test_attention_encoders_match_their_session(encoder):
    """The attention window's state (an int32 fill count among the leaves)
    rides the slot rows: engine == single session."""
    _, _, pm = models(encoder_module=encoder, causal=False, frontend_channels=(4, 6))
    server = port_engine(pm, 3)
    wavs = [noise(90 + 21 * i, 50 + i) for i in range(3)]
    sids = [server.attach() for _ in wavs]
    got = {s: [] for s in sids}
    for off in range(0, max(map(len, wavs)), 40 * HOP):
        for s, w in zip(sids, wavs):
            server.feed(s, w[off:off + 40 * HOP])
        for s, toks in server.tick().items():
            got[s] += toks
    for s, w in zip(sids, wavs):
        assert got[s] + server.finish(s) == session_ids(pm, w, CHUNK * HOP)
    lens = server._replicas[0].state["enc"][0]["mha_left_len"]
    assert lens.dtype == torch.int32 and lens.shape == (3,)


def test_tree_helpers():
    state = {"a": torch.zeros(3, 2), "b": (torch.zeros(3, dtype=torch.int32),
                                          [torch.zeros(3, 1, 4)])}
    row = eng.tree_map(lambda x: torch.ones((1,) + x.shape[1:], dtype=x.dtype), state)
    new = eng.tree_insert(state, row, 1)
    assert float(state["a"].sum()) == 0  # functional
    assert eng.tree_extract(new, 1)["b"][0].tolist() == [1]
    assert eng.tree_extract(new, 0)["b"][1][0].sum() == 0
    kept = eng.tree_where(torch.tensor([True, False, False]), new, state)
    assert kept["a"].sum() == 0 and isinstance(kept["b"], tuple)
    kept = eng.tree_where(torch.tensor([False, True, False]), new, state)
    assert kept["b"][1][0][1].sum() == 4
