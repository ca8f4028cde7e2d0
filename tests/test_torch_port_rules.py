"""Rules of the PyTorch port that hold without running a model.

- No file of mamba_asr_torch/, nor chip_smoke.py, imports JAX, flax,
  optax or the JAX package (a static scan of the source).
- Entry points (the recipes, recognize, evaluate, serve's server mode,
  the tools) default to the CUDA card and refuse to run without one;
  serve's client mode and the serving client run without PyTorch;
  chip_smoke.py fails, printing no result, without a card or without the
  rest of the repository.
- The kernel wrappers have no `try` that could fall back to a plain
  version on the card.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mamba_asr_torch import evaluate, recognize, serve, train_lm
from mamba_asr_torch.cli import load_lm, restore_asr_state, run_training
from mamba_asr_torch.configs.loader import DecodeConfig, ExperimentConfig, FrontendConfig
from mamba_asr_torch.data.tokenizer import CharTokenizer
from mamba_asr_torch.models.asr import ASRConfig
from mamba_asr_torch.serving.recognizer import Recognizer
from mamba_asr_torch.tools import bench_serving
from mamba_asr_torch.tools import peak_probe as peak_probe_tool
from mamba_asr_torch.tools import scan_variants as scan_variants_tool
from mamba_asr_torch.tools import train_to_floor
from mamba_asr_torch.training import loop
from mamba_asr_torch.training.trainer import Trainer
from mamba_asr_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mamba_asr_tpu"}
PORT_FILES = sorted((REPO / "mamba_asr_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_import_scan_catches_each_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom flax import linen\n"
                   "import importlib\nimportlib.import_module('mamba_asr_tpu.ops')\n")
    assert {"jax", "flax", "mamba_asr_tpu"} <= set(_imported_roots(src))


def test_entry_points_refuse_to_run_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Recognizer(ASRConfig(), FrontendConfig(), {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Recognizer(ASRConfig(num_decoder_layers=2), FrontendConfig(), {}, search="s2s")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(ASRConfig(), FrontendConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scan_variants_tool.run(["base"], b=1, t=8, d=8, n=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peak_probe_tool.run(b=1, t=2, d=8, k=4)
    exp = ExperimentConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.Trainer(dataclasses.replace(exp, data=dataclasses.replace(
            exp.data, output_folder=str(tmp_path))), CharTokenizer(list("AB")))
    # The CLI refuses before it prepares anything.
    yaml = str(REPO / "hparams" / "CTC" / "conmamba_small.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training([yaml, "--data.output_folder", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_to_floor.main(["--workdir", str(tmp_path / "ttf"), "--n-train", "1",
                             "--n-dev", "1", "--n-test", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_lm(dataclasses.replace(exp, decode=DecodeConfig(lm_path="lm.pt")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_asr_state(exp, torch_ckpt="model.ckpt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recognize.main([yaml, "a.wav", "--torch_ckpt", "model.ckpt"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main([yaml, "--data.output_folder", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm.main(["--corpus", "c.txt", "--tokenizer", "t.json", "--output",
                       str(tmp_path / "lm")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([yaml, "--torch_ckpt", "model.ckpt"])  # server mode
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_serving.main([yaml])
    assert not (tmp_path / "out").exists() and not (tmp_path / "lm").exists()
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_refuses_what_is_not_ported():
    yaml = str(REPO / "hparams" / "CTC" / "conmamba_small.yaml")
    # --bundle is ported (serving/export.py): a directory without a torch
    # bundle is refused by the loader.
    with pytest.raises(ValueError, match="not a torch.export bundle"):
        serve.main([yaml, "--bundle", "b"])
    with pytest.raises(SystemExit, match="Queue 1 item 12"):
        serve.main([yaml, "--data_parallel", "2", "--device", "cpu"])


NO_TORCH_CLIENT = """
import sys
sys.modules["torch"] = None  # any import of PyTorch now fails
import numpy as np
from mamba_asr_torch import serve
from mamba_asr_torch.data.audio import write_wav
from mamba_asr_torch.serving.server import AsrTcpServer, StreamingClient

class Engine:  # host only: every chunk of 640 ms emits id 5
    final_decode = None
    def __init__(self): self.samples = 0
    def attach(self): return 0
    def feed(self, sid, x): self.samples += len(x)
    def ready_slots(self): return [0] if self.samples >= 10240 else []
    def tick(self):
        self.samples -= 10240
        return {0: [5]}
    def trailing_silence_s(self, sid): return 0.0
    def finish(self, sid):  # drains the chunks no tick took yet
        n, self.samples = self.samples // 10240, 0
        return [5] * n + [6]
    def abort(self, sid): pass
    def stats(self): return {}

server = AsrTcpServer(Engine(), port=0)
server.start()
c = StreamingClient(server.host, server.port)
sid = c.start()
c.send(sid, np.zeros(3 * 10240, np.float32))
assert c.end(sid) == ([5, 5, 5, 6], None)
c.close()
write_wav(sys.argv[1], np.zeros(2 * 10240, np.float32), 16000)
serve.main(["--connect", f"{server.host}:{server.port}", sys.argv[1]])
server.stop()
assert "torch" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
"""


def test_serving_client_runs_without_torch(tmp_path):
    """`StreamingClient` and serve's client mode on a host with neither
    a card nor PyTorch: the import of torch is blocked in a subprocess."""
    wav = str(tmp_path / "a.wav")
    out = subprocess.run([sys.executable, "-c", NO_TORCH_CLIENT, wav], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"{wav}\t5 5 6"


def test_new_modules_are_scanned():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("serve.py", "serving/engine.py", "serving/server.py",
                "tools/bench_serving.py"):
        assert f"mamba_asr_torch/{rel}" in names


@pytest.mark.parametrize("path", sorted((REPO / "mamba_asr_torch" / "kernels").glob("*.py")),
                         ids=lambda p: p.name)
def test_kernel_wrappers_have_no_fallback(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
    assert not tries, f"{path.name} has try blocks at lines {tries}"


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=120,
    )


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)
