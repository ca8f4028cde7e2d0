"""The port's TCP server and client (serving/server.py) and `python -m
mamba_asr_torch.serve`, over loopback on port 0, on the CPU, with the tiny
causal ConMamba of tests/test_torch_serving.py (whose engine is held
against JAX's there). The transcripts are held against the port's offline
greedy decode.

- Two concurrent port clients get the offline transcripts.
- A full server sends the error event; an abandoned client's slot is
  reclaimed and the surviving stream stays exact; the stats op answers.
- An endpoint event fires, and fires again after new ids re-arm it (a
  scripted host-only engine, so the events' order is exact).
- Timestamps come back with a CharTokenizer (the offline greedy words).
- The JAX package's StreamingClient gets the same ids from the port's
  server (the wire protocol is shared).
- `python -m mamba_asr_torch.serve --connect` on a written wav prints the
  offline transcript; server mode (`serve.build_server`) from a YAML, a
  torch checkpoint and a tokenizer on the CPU serves the engine's ids.
- `tools/bench_serving.py` on the CPU at the tiny size.
"""

from __future__ import annotations

import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mamba_asr_tpu.serving.server import StreamingClient as JaxClient

from mamba_asr_torch import serve
from mamba_asr_torch.configs.loader import load_config, parse_overrides
from mamba_asr_torch.data.audio import read_audio, write_wav
from mamba_asr_torch.data.tokenizer import CharTokenizer
from mamba_asr_torch.models.asr import ASRModel, init_params_
from mamba_asr_torch.serving.engine import StreamingServer
from mamba_asr_torch.serving.server import AsrTcpServer, StreamingClient, recv_frame, send_frame
from tests.test_torch_serving import HOP, TINY, noise, offline_greedy, port_engine
from tests.test_torch_streaming import models

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pm():
    return models(**TINY)[2]


@pytest.fixture
def server_of():
    """server_of(engine, **kw) -> a started AsrTcpServer, stopped after."""
    started = []

    def make(engine, **kw):
        server = AsrTcpServer(engine, port=0, **kw)
        server.start()
        started.append(server)
        return server

    yield make
    for s in started:
        s.stop()


def stream(client, wav, piece=40 * HOP, **end_kw):
    sid = client.start()
    for off in range(0, len(wav), piece):
        client.send(sid, wav[off:off + piece])
    return client.end(sid, **end_kw)


def test_two_concurrent_clients(pm, server_of):
    engine = port_engine(pm, 2)
    server = server_of(engine)
    wavs = [noise(150 + 40 * i, 60 + i) for i in range(2)]
    results = [None, None]

    def run(i):
        c = StreamingClient(server.host, server.port)
        try:
            results[i] = stream(c, wavs[i])
        finally:
            c.close()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for i in range(2):
        ids, text = results[i]
        assert ids == offline_greedy(pm, wavs[i]) and ids, i
        assert text is None  # no tokenizer
    assert engine.free_slots == 2


def test_full_server_abandon_and_stats(pm, server_of):
    engine = port_engine(pm, 2)
    server = server_of(engine)
    c1, c2 = StreamingClient(server.host, server.port), StreamingClient(server.host, server.port)
    sid1 = c1.start()
    c2.start()
    with pytest.raises(RuntimeError, match="server full"):
        c2.start()
    c2.close()  # abandoned without end(): its slot must come back
    deadline = time.time() + 30
    while engine.free_slots < 1 and time.time() < deadline:
        time.sleep(0.02)
    assert engine.free_slots == 1
    wav = noise(120, 62)
    c1.send(sid1, wav)
    ids, _ = c1.end(sid1)
    assert ids == offline_greedy(pm, wav)
    st = c1.stats()
    assert st["aborted_total"] == 1 and st["finished_total"] == 1
    assert st["attached_total"] == 2 and st["active_streams"] == 0
    c1.close()


class ScriptedEngine:
    """A host-only engine whose ticks emit scripted ids, its trailing
    silence the chunks since the last id (0.64 s each)."""

    final_decode = None

    def __init__(self, script):
        self.script, self.chunks, self.silence = list(script), 0, 0.0

    def attach(self):
        return 0

    def feed(self, sid, samples):
        self.chunks += len(samples) // (64 * HOP)

    def ready_slots(self):
        return [0] if self.chunks else []

    def tick(self):
        self.chunks -= 1
        ids = self.script.pop(0)
        self.silence = 0.0 if ids else self.silence + 0.64
        return {0: ids}

    def trailing_silence_s(self, sid):
        return self.silence

    def finish(self, sid):
        return []


def test_endpoint_event_fires_and_rearms(server_of):
    """One endpoint event per silence run longer than the threshold, and
    another once new ids re-arm it, in order with the tokens."""
    server = server_of(ScriptedEngine([[5], [], [], [6], [], []]), endpoint_silence_s=1.0)
    with socket.create_connection((server.host, server.port)) as sock:
        send_frame(sock, {"op": "start"})
        assert recv_frame(sock)[0] == {"event": "started", "sid": 0}
        send_frame(sock, {"op": "audio", "sid": 0},
                   np.zeros(6 * 64 * HOP, np.float32).tobytes())
        events = [recv_frame(sock)[0] for _ in range(4)]
        send_frame(sock, {"op": "end", "sid": 0})
        final = recv_frame(sock)[0]
    assert events == [{"event": "tokens", "sid": 0, "ids": [5], "final": False},
                      {"event": "endpoint", "sid": 0, "silence_s": 1.28},
                      {"event": "tokens", "sid": 0, "ids": [6], "final": False},
                      {"event": "endpoint", "sid": 0, "silence_s": 1.28}]
    assert final == {"event": "tokens", "sid": 0, "ids": [], "final": True}


def test_timestamps_with_a_char_tokenizer(pm, server_of):
    tok = CharTokenizer(["A", "B", " ", "C", "D"])  # vocab 9, the model's
    engine = port_engine(pm, 2, final_decode="ctc_beam", beam_size=4)
    server = server_of(engine, tokenizer=tok)
    wav = noise(160, 64)
    want = tok.decode(offline_greedy(pm, wav)).split()
    c = StreamingClient(server.host, server.port)
    try:
        ids, text, words = stream(c, wav, timestamps=True)
    finally:
        c.close()
    assert text == tok.decode(ids)
    assert [w[0] for w in words] == want and want
    prev = 0.0
    for w, s, e, conf in words:
        assert 0.0 <= s <= e and s >= prev and 0.0 < conf <= 1.0 + 1e-6
        prev = s
    assert e <= len(wav) / 16000 + 1.0


def test_jax_client_talks_to_the_port_server(pm, server_of):
    server = server_of(port_engine(pm, 2))
    wav = noise(140, 65)
    got = []
    for client_cls in (JaxClient, StreamingClient):
        c = client_cls(server.host, server.port)
        try:
            got.append(stream(c, wav))
        finally:
            c.close()
    assert got[0] == got[1] and got[0][0] == offline_greedy(pm, wav)


def test_serve_connect_cli(pm, server_of, tmp_path):
    server = server_of(port_engine(pm, 2))
    wavs = [noise(130, 66), noise(90, 67)]
    paths = []
    for i, w in enumerate(wavs):
        paths.append(str(tmp_path / f"u{i}.wav"))
        write_wav(paths[-1], w, 16000)
    out = subprocess.run(
        [sys.executable, "-m", "mamba_asr_torch.serve", "--connect",
         f"{server.host}:{server.port}", *paths, "--client_chunk_ms", "250"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    # The wav holds 16-bit samples: the offline decode reads what was written.
    assert lines == [f"{p}\t{' '.join(map(str, offline_greedy(pm, read_audio(p)[0])))}"
                     for p in paths]


TINY_YAML = ["--model.vocab_size", "9", "--model.d_model", "8", "--model.nhead", "2",
             "--model.num_encoder_layers", "2", "--model.d_ffn", "16",
             "--model.kernel_size", "7", "--model.causal", "true",
             "--model.bidirectional", "false", "--model.compute_dtype", "float32",
             "--model.mamba.d_state", "4", "--model.n_mels", "20", "--frontend.n_mels", "20"]


def test_serve_server_mode_on_the_cpu(tmp_path):
    yaml = str(REPO / "hparams" / "CTC" / "conmamba_small.yaml")
    args, extra = serve.parser().parse_known_args(
        [yaml, "--torch_ckpt", str(tmp_path / "model.ckpt"), "--tokenizer",
         str(tmp_path / "tok.json"), "--port", "0", "--device", "cpu", "--slots", "2",
         "--chunk_frames", "32", "--final", "ctc_beam", "--final_beam_size", "4", *TINY_YAML])
    cfg = load_config(yaml, parse_overrides(TINY_YAML))
    model = init_params_(ASRModel(cfg.model), torch.Generator().manual_seed(7)).eval()
    torch.save(model.state_dict(), tmp_path / "model.ckpt")
    CharTokenizer(["A", "B", " ", "C", "D"]).save(str(tmp_path / "tok.json"))
    server = serve.build_server(args, extra)
    server.start()
    try:
        assert server.engine.final_decode == "ctc_beam" and server.engine.n_slots == 2
        wav = noise(130, 68)
        c = StreamingClient(server.host, server.port)
        try:
            ids, text = stream(c, wav)
        finally:
            c.close()
    finally:
        server.stop()
    direct = StreamingServer(model, cfg.frontend, server.engine.normalizer, n_slots=1,
                             chunk_frames=32, final_decode="ctc_beam", beam_size=4)
    sid = direct.attach()
    direct.feed(sid, wav)
    assert ids == direct.finish_final(sid)[1]
    assert text == CharTokenizer(["A", "B", " ", "C", "D"]).decode(ids)


def test_bench_serving_tool_on_the_cpu():
    """tools/bench_serving.py at the tiny size: one row per slot count."""
    from mamba_asr_torch.tools import bench_serving

    yaml = str(REPO / "hparams" / "CTC" / "conmamba_small.yaml")
    rows = bench_serving.main([yaml, "--slots", "1", "3", "--chunk_frames", "32", "--ticks",
                               "2", "--device", "cpu", *TINY_YAML])
    assert [r["n_slots"] for r in rows] == [1, 3]
    for r in rows:
        assert r["wall_ms_median"] > 0 and r["tick_fn_queued_cpu_ms"] > 0
        assert "tick_fn_queued_ms" not in r and r["device_ms_per_tick"] is None
        assert r["capacity_streams"] > 0 and r["per_stream_ms"] > 0
        assert r["k1_launches_per_tick"] == 0 and r["peak_mem_bytes"] is None
