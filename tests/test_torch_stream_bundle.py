"""The port's streaming bundle (serving/export.py:export_streaming_bundle,
ExportedStreamingServer), the export CLI and `serve --bundle`, on the CPU,
at tests/test_torch_serving.py's tiny causal size (d_model 8, 2 causal
unidirectional ConMamba layers, kernel 7, vocab 9, n_mels 20, d_state 4,
float32), seeded weights through a state dict. The engine it is held
against is held against JAX's in tests/test_torch_serving.py.

- The bundle's transcripts equal to the port's StreamingServer's, stream
  for stream, on staggered streams of mixed lengths (JAX
  tests/test_export.py:299's script: bootstraps, steady ticks, a steady
  flush with residual audio, fresh flushes, slot reuse, streams shorter
  than one fbank window), with the trailing silence after every tick;
  each program holds 2 K1 nodes.
- The `n_out` clamp (a departure from JAX, `export.py:739`): no stream of
  0 to 3 chunks makes it bind; a stream whose frame bookkeeping drifted
  does, and its flush then emits nothing where JAX's slice would read
  from the row's start.
- Refusals: a non-causal encoder, a bundle of another device type, a JAX
  bundle, a CTC/S2S loader on a streaming bundle.
- The bundle comes from `python -m mamba_asr_torch.export_model
  --streaming`; `serve --bundle` answers a TCP client with the engine's
  ids; a subprocess that loads and runs the bundle holds no module of
  `mamba_asr_torch.models` or of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mamba_asr_torch import export_model, serve
from mamba_asr_torch.configs.loader import FrontendConfig, load_config, parse_overrides
from mamba_asr_torch.models.asr import ASRModel, init_params_
from mamba_asr_torch.serving.engine import StreamingServer
from mamba_asr_torch.serving.export import (
    ExportedASR,
    ExportedStreamingServer,
    export_streaming_bundle,
    program_launches,
)
from mamba_asr_torch.serving.server import StreamingClient
from tests.test_torch_serving import FE, HOP, TINY
from tests.test_torch_streaming import models

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CHUNK = 16


def noise(n, rng):
    return rng.normal(0, 0.3, n).astype(np.float32)


TINY_YAML = ["--model.vocab_size", "9", "--model.d_model", "8", "--model.nhead", "2",
             "--model.num_encoder_layers", "2", "--model.d_ffn", "16",
             "--model.kernel_size", "7", "--model.causal", "true",
             "--model.bidirectional", "false", "--model.compute_dtype", "float32",
             "--model.mamba.d_state", "4", "--model.n_mels", "20", "--frontend.n_mels", "20",
             "--frontend.n_fft", "256", "--frontend.win_length_ms", "16.0"]


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(the port's engine, the bundle's dir): the bundle written by
    `python -m mamba_asr_torch.export_model --streaming` from the YAML and
    a state dict of seeded weights, the engine over the same model."""
    tmp = tmp_path_factory.mktemp("stream")
    yaml = str(REPO / "hparams" / "CTC" / "conmamba_small.yaml")
    cfg = load_config(yaml, parse_overrides(TINY_YAML))
    model = init_params_(ASRModel(cfg.model), torch.Generator().manual_seed(7)).eval()
    torch.save(model.state_dict(), tmp / "model.ckpt")
    out = str(tmp / "bundle")
    manifest = export_model.main([yaml, "--torch_ckpt", str(tmp / "model.ckpt"), "--out", out,
                                  "--streaming", "--slots", "3", "--chunk_frames", str(CHUNK),
                                  "--device", "cpu", *TINY_YAML])
    assert manifest["surface"] == "streaming" and manifest["n_slots"] == 3
    assert manifest["platforms"] == ["cpu"] and manifest["chunk_frames"] == CHUNK
    engine = StreamingServer(model, cfg.frontend, None, n_slots=3, chunk_frames=CHUNK)
    return engine, out


def drive(eng):
    """JAX tests/test_export.py:299's script, with the trailing silence of
    every stream after each tick."""
    rng = np.random.default_rng(7)
    chunk = CHUNK * HOP
    wavs = [noise(3 * chunk + 5 * HOP + 3, rng), noise(chunk + HOP + 1, rng),
            noise(chunk // 2 + 7, rng)]
    tiny = [noise(5 * HOP + 9, rng), noise(100, rng), noise(0, rng)]
    sids = [eng.attach() for _ in wavs]
    texts = {i: [] for i in range(len(wavs))}
    silence = []
    pieces = [[w[j:j + 1000] for j in range(0, len(w), 1000)] for w in wavs]
    step = 0
    while any(pieces):
        for i, ps in enumerate(pieces):
            if ps:
                eng.feed(sids[i], ps.pop(0))
        step += 1
        if step % 2 == 0:
            for sid, toks in eng.tick().items():
                texts[sids.index(sid)].extend(toks)
            silence.append([eng.trailing_silence_s(s) for s in sids])
    for sid, toks in eng.tick().items():
        texts[sids.index(sid)].extend(toks)
    for i in (1, 2, 0):  # scrambled finish order
        texts[i].extend(eng.finish(sids[i]))
    sid2 = eng.attach()  # slot reuse
    eng.feed(sid2, wavs[0][: chunk + 11])
    reuse = list(eng.tick().get(sid2, []))
    reuse += eng.finish(sid2)
    for w in tiny:  # fresh flushes below one fbank window
        sid3 = eng.attach()
        eng.feed(sid3, w)
        reuse.append(tuple(eng.finish(sid3)))
    return texts, reuse, silence


def test_stream_bundle_matches_the_engine(bundle):
    engine, out = bundle
    exported = ExportedStreamingServer(out, device="cpu")
    want = drive(engine)
    got = drive(exported)
    assert got == want
    assert any(want[0].values()) and exported.clamped == 0
    assert exported.stats()["finished_total"] == 3 + 1 + 3
    assert program_launches(exported) == {
        f"stream_{name}.pt2": {"selective_scan_fwd": 2}
        for name in ("bootstrap", "tick", "flush", "flush_fresh")}


def test_n_out_clamp(bundle):
    exported = ExportedStreamingServer(bundle[1], device="cpu")
    rng = np.random.default_rng(3)
    chunk = CHUNK * HOP
    for n in range(0, 3 * chunk, 97):
        sid = exported.attach()
        exported.feed(sid, noise(n, rng))
        exported.finish(sid)
    assert exported.clamped == 0  # no stream binds it
    sid = exported.attach()
    exported.feed(sid, noise(2 * chunk + 5 * HOP, rng))
    exported.tick()
    exported.tick()
    exported._enc_done[exported._slot_of_sid[sid]] += 10 ** 6  # drifted bookkeeping
    assert exported.finish(sid) == [] and exported.clamped == 1


def test_refusals(bundle, tmp_path):
    pm = models(**dict(TINY, causal=False))[2]
    engine = StreamingServer(pm, FrontendConfig(**FE), None, n_slots=2, chunk_frames=CHUNK)
    with pytest.raises(ValueError, match="requires a causal encoder"):
        export_streaming_bundle(engine, str(tmp_path / "non_causal"))
    with pytest.raises(ValueError, match="a streaming bundle, expected ctc or s2s"):
        ExportedASR(bundle[1], device="cpu")
    other = tmp_path / "cuda_bundle"
    shutil.copytree(bundle[1], other)
    manifest = json.loads((other / "manifest.json").read_text())
    manifest["platforms"] = ["cuda"]
    (other / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="exported for 'cuda' and cannot run on 'cpu'"):
        ExportedStreamingServer(str(other), device="cpu")

    import jax

    from mamba_asr_tpu.serving.export import export_ctc_bundle as jax_export
    from mamba_asr_tpu.training.normalizer import init_normalizer
    from mamba_asr_tpu.training.trainer import FrontendConfig as JaxFrontendConfig

    jm, jp, _ = models(**TINY)
    jax_dir = str(tmp_path / "jax_bundle")
    with jax.default_device(jax.devices("cpu")[0]):
        jax_export(jm, jp["params"], init_normalizer(20), JaxFrontendConfig(**FE), jax_dir,
                   [(1, 4000)])
    assert os.path.exists(os.path.join(jax_dir, "params.msgpack"))
    for loader in (ExportedASR, ExportedStreamingServer):
        with pytest.raises(ValueError, match="JAX package"):
            loader(jax_dir, device="cpu")


RUN_BUNDLE = """
import json
import sys
import numpy as np
from mamba_asr_torch.serving.export import ExportedStreamingServer
eng = ExportedStreamingServer(sys.argv[1], device="cpu")
wav = np.random.default_rng(1).normal(0, 0.3, int(sys.argv[2])).astype(np.float32)
sid = eng.attach()
eng.feed(sid, wav)
ids = [t for toks in eng.tick().values() for t in toks] + eng.finish(sid)
bad = sorted(m for m in sys.modules
             if m.startswith("mamba_asr_torch.models") or m == "jax" or m.startswith("jax."))
print(json.dumps({"ids": ids, "bad": bad}))
"""


def test_serve_bundle_and_a_bare_worker(bundle):
    """`serve --bundle` answers a TCP client with the engine's ids; a
    worker process runs the bundle with nothing of the models or JAX."""
    engine, out = bundle

    def engine_ids(wav):
        sid = engine.attach()
        engine.feed(sid, wav)
        return [t for toks in engine.tick().values() for t in toks] + engine.finish(sid)

    wav = noise(130 * HOP, np.random.default_rng(5))
    args, extra = serve.parser().parse_known_args(["--bundle", out, "--port", "0",
                                                   "--device", "cpu"])
    server = serve.build_server(args, extra)
    server.start()
    try:
        assert isinstance(server.engine, ExportedStreamingServer)
        client = StreamingClient(server.host, server.port)
        try:
            sid = client.start()
            for off in range(0, len(wav), 40 * HOP):
                client.send(sid, wav[off:off + 40 * HOP])
            ids, _ = client.end(sid)
        finally:
            client.close()
    finally:
        server.stop()
    assert list(ids) == engine_ids(wav)

    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    n = 3 * CHUNK * HOP + 77
    res = subprocess.run([sys.executable, "-c", RUN_BUNDLE, out, str(n)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    worker = json.loads(res.stdout.strip().splitlines()[-1])
    assert worker["bad"] == [], f"the worker imported {worker['bad']}"
    assert worker["ids"] == engine_ids(
        np.random.default_rng(1).normal(0, 0.3, n).astype(np.float32))
