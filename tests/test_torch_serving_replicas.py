"""Multi-device serving in the PyTorch port (`StreamingServer(devices=)`,
`serve --data_parallel N`) against the JAX package's engine with its slot
batch sharded over a 2-device "data" mesh, on the CPU at
tests/test_serving.py's tiny size (tests/test_torch_serving.py's model).

- tests/test_serving.py:194-230's scenario (8 slots, 5 streams of
  different lengths fed in 32-frame pieces, a tick after each round):
  the port's engine over 2 CPU replicas emits exactly what JAX's meshed
  engine and the port's single engine emit, every emission and final id
  list, and each transcript equals the port's offline greedy decode;
  each replica holds only its 4 rows, and replicas on one device share
  the model;
- a slot count the devices do not divide is refused with JAX's message;
- `serve --device cpu --data_parallel 2` builds a 2-replica server whose
  TCP transcript equals the single engine's; with fewer cards than N the
  card count is refused, with no fallback.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from mamba_asr_tpu.parallel.mesh import make_mesh
from mamba_asr_tpu.serving.engine import StreamingServer as JaxServer
from mamba_asr_tpu.training.trainer import FrontendConfig as JaxFrontendConfig

from mamba_asr_torch import serve
from mamba_asr_torch.configs.loader import load_config, parse_overrides
from mamba_asr_torch.data.tokenizer import CharTokenizer
from mamba_asr_torch.models.asr import ASRModel, init_params_
from mamba_asr_torch.serving.engine import StreamingServer, tree_map
from mamba_asr_torch.serving.server import StreamingClient
from tests.test_torch_server import REPO, TINY_YAML, stream
from tests.test_torch_serving import FE, HOP, TINY, noise, offline_greedy, port_engine
from tests.test_torch_streaming import models

torch.set_num_threads(1)

SLOTS, CHUNK = 8, 32


def scenario(server):
    """tests/test_serving.py:210-227: every stream's emissions and tail."""
    rng = np.random.default_rng(21)
    wavs = [rng.normal(0, 0.3, size=(100 + 17 * i) * HOP).astype(np.float32) for i in range(5)]
    sids = [server.attach() for _ in wavs]
    got = {s: [] for s in sids}
    for off in range(0, max(len(w) for w in wavs), CHUNK * HOP):
        for sid, w in zip(sids, wavs):
            server.feed(sid, w[off:off + CHUNK * HOP])
        for sid, toks in server.tick().items():
            got[sid].extend(int(t) for t in toks)
    for sid in sids:
        got[sid].extend(int(t) for t in server.finish(sid))
    return wavs, [got[s] for s in sids]


@pytest.fixture(scope="module")
def tiny():
    return models(**TINY)


def test_replicas_match_jax_mesh_and_the_single_engine(tiny):
    model, params, pm = tiny
    mesh = make_mesh(data=2, devices=jax.devices()[:2])
    jax_engine = JaxServer(model, params, JaxFrontendConfig(**FE), n_slots=SLOTS,
                           chunk_frames=CHUNK, mesh=mesh)
    _, want = scenario(jax_engine)
    wavs, single = scenario(port_engine(pm, SLOTS))
    replicas = port_engine(pm, SLOTS, devices=["cpu", "cpu"])
    _, got = scenario(replicas)
    assert got == single == want
    assert all(ids and ids == offline_greedy(pm, w) for ids, w in zip(got, wavs))
    reps = replicas._replicas
    assert [list(r.rows) for r in reps] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    for r in reps:
        leaves = []
        tree_map(leaves.append, r.state)
        assert leaves and all(a.shape[0] == SLOTS // 2 for a in leaves)
        assert r.model is pm  # one device: the replicas share its model


def test_slots_that_do_not_divide_are_refused(tiny):
    _, _, pm = tiny
    with pytest.raises(ValueError, match="must divide over the data axis"):
        port_engine(pm, 3, devices=["cpu", "cpu"])


def test_serve_data_parallel_on_the_cpu(tmp_path):
    yaml = str(REPO / "hparams" / "CTC" / "conmamba_small.yaml")
    args, extra = serve.parser().parse_known_args(
        [yaml, "--torch_ckpt", str(tmp_path / "model.ckpt"), "--tokenizer",
         str(tmp_path / "tok.json"), "--port", "0", "--device", "cpu", "--slots", "2",
         "--chunk_frames", "32", "--data_parallel", "2", *TINY_YAML])
    cfg = load_config(yaml, parse_overrides(TINY_YAML))
    model = init_params_(ASRModel(cfg.model), torch.Generator().manual_seed(7)).eval()
    torch.save(model.state_dict(), tmp_path / "model.ckpt")
    CharTokenizer(["A", "B", " ", "C", "D"]).save(str(tmp_path / "tok.json"))
    server = serve.build_server(args, extra)
    assert [r.device.type for r in server.engine._replicas] == ["cpu", "cpu"]
    wav = noise(130, 68)
    server.start()
    try:
        c = StreamingClient(server.host, server.port)
        try:
            ids, _ = stream(c, wav)
        finally:
            c.close()
    finally:
        server.stop()
    direct = StreamingServer(model, cfg.frontend, server.engine.normalizer, n_slots=1,
                             chunk_frames=32)
    sid = direct.attach()
    direct.feed(sid, wav)
    assert ids == direct.finish(sid) and ids


def test_data_parallel_refuses_fewer_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="1 CUDA card.*fewer than 2"):
        serve.serving_devices(torch.device("cuda", 0), 2)
    assert serve.serving_devices(torch.device("cpu"), 3) == [torch.device("cpu")] * 3
    assert serve.serving_devices(torch.device("cuda", 0), 1) is None
