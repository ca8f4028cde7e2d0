"""The Mamba decoder's recipe in the PyTorch port against the JAX
package's, on the CPU.

- `python -m mamba_asr_torch.train_s2s hparams/S2S/conmambamamba_small.yaml`
  at tests/test_torch_s2s_recipe.py's TINY overrides (d_model 16, one
  ConMamba layer, one Mamba decoder layer, vocab 16, float32, dropout 0,
  SpecAugment off) against the JAX CLI (train_s2s.py) from the same
  initial params: the same files, per-step losses within 2e-4, equal
  train_log rows and wer file, the checkpoints kept by ACC and the
  averaged one (parameters 1e-5); then the port resumes at epoch 3.
- The train-to-floor tool's S2S default is the JAX script's.
"""

from __future__ import annotations

import functools
import inspect
import os

import jax
import pytest
import torch

from mamba_asr_tpu.cli import run_training as jax_run_training
from mamba_asr_tpu.parallel.mesh import make_mesh
from mamba_asr_tpu.training import checkpoint as jax_ckpt
from mamba_asr_tpu.training import loop as jax_loop

from mamba_asr_torch import cli
from mamba_asr_torch.cli import run_training
from mamba_asr_torch.configs import loader
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.tools import train_to_floor
from mamba_asr_torch.training import loop
from tests.test_torch_recipe import _close, _jax_script, _log_rows, _tree
from tests.test_torch_s2s_recipe import TINY, _close_s2s_params

torch.set_num_threads(1)

CONFIG = os.path.join("hparams", "S2S", "conmambamamba_small.yaml")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tones") / "corpus")
    train_to_floor.build_corpus(root, n_train=8, n_dev=4, n_test=4)
    return root


def _cli_args(corpus, out, epochs):
    args = [CONFIG, "--data.data_folder", corpus, "--data.output_folder", out,
            "--data.train_splits", "[train-clean-100]", "--data.test_splits", "[test-clean]",
            "--data.num_buckets", "1", "--data.max_batch_seconds", "5.0"]
    for key, value in TINY.items():
        args += [f"--{key}", str(value).lower() if isinstance(value, bool) else str(value)]
    return args + ["--train.number_of_epochs", str(epochs)]


def test_mamba_s2s_cli_matches_jax_end_to_end_and_resumes(corpus, tmp_path, monkeypatch,
                                                          capsys):
    """Two epochs of each package's S2S CLI on the Mamba-decoder YAML (the
    joint search validates epoch 2 and decodes the test set), the port
    with --device cpu from the JAX initial params: the same files; equal
    per-step losses; equal train_log rows and wer file; the checkpoints
    kept by ACC and the averaged one. Then the port resumes at epoch 3."""
    monkeypatch.setattr(jax_loop, "make_mesh",
                        lambda **kw: make_mesh(devices=jax.devices()[:1], **kw))
    init = {}
    jax_init_state = jax_loop.Trainer.init_state

    def capture_init(self, batch):
        jax_init_state(self, batch)
        init["params"] = jax.device_get(self.state.params)

    monkeypatch.setattr(jax_loop.Trainer, "init_state", capture_init)
    jtr = jax_run_training(_cli_args(corpus, str(tmp_path / "jax"), 2))
    pcfg = loader.load_config(CONFIG, dict(TINY))
    assert pcfg.model.decoder_module == "mamba"
    monkeypatch.setattr(cli, "Trainer", functools.partial(
        loop.Trainer, state_dict=pi.import_asr_params(init["params"], pcfg.model)))
    ptr = run_training(_cli_args(corpus, str(tmp_path / "torch"), 2) + ["--device", "cpu"])
    monkeypatch.undo()
    assert ptr.is_s2s and ptr.step.model.mamba_decoder
    assert _tree(ptr.cfg.output_folder) == _tree(jtr.cfg.output_folder)
    assert len(ptr.loss_history) == len(jtr.loss_history) >= 6
    _close(ptr.loss_history, jtr.loss_history, 2e-4, 0.0, "loss history")
    for name in ("train_log.txt", "wer_test-clean.txt"):
        rows = _log_rows(os.path.join(ptr.cfg.output_folder, name))
        assert rows == _log_rows(os.path.join(jtr.cfg.output_folder, name)), name

    def by_epoch(mgr):
        return {e["metrics"].get("epoch", "avg"): e for e in mgr._entries(include_averaged=True)}

    ours, theirs = by_epoch(ptr.ckpt), by_epoch(jtr.ckpt)
    assert ours.keys() == theirs.keys() == {1, 2, "avg"}
    for key, entry in ours.items():
        assert entry["metrics"] == theirs[key]["metrics"], key
        state = ptr.ckpt.restore(entry["name"])
        with open(os.path.join(jtr.ckpt.directory, theirs[key]["name"], "state.msgpack"),
                  "rb") as f:
            raw = jax_ckpt.serialization.msgpack_restore(f.read())
        _close_s2s_params(state["model"], raw["params"], pcfg, state["step"], f"ckpt {key}")
        assert state["step"] == int(raw["step"])

    capsys.readouterr()
    again = run_training(_cli_args(corpus, str(tmp_path / "torch"), 3) + ["--device=cpu"])
    assert "resumed from checkpoint at epoch 2" in capsys.readouterr().out
    assert again.start_epoch == 3 and [e["epoch"] for e in again.epoch_log] == [3]
    assert set(again.epoch_log[0]["valid"]) == {"WER", "CER", "ACC"}


def test_train_to_floor_s2s_default_is_the_jax_scripts():
    """The tool's S2S config is the JAX script's default, the Mamba
    decoder; --s2s-config still selects the Transformer decoder."""
    script = _jax_script()
    default = inspect.signature(script.run_mode).parameters["s2s_config"].default
    assert train_to_floor.S2S_CONFIG == default == "hparams/S2S/conmambamamba_small.yaml"
    cfg = loader.load_config(str(train_to_floor.REPO / train_to_floor.S2S_CONFIG))
    assert cfg.model.decoder_module == "mamba"
