"""The port's S2S recipe (`python -m mamba_asr_torch.train_s2s`) against
the JAX package's CLI (train_s2s.py), on the CPU, and the train-to-floor
tool's S2S mode.

Tiny sizes: hparams/S2S/conmamba_small.yaml with d_model 16, one
ConMamba layer, one decoder layer of 2 heads, d_state 4, 20 mels, vocab
16, float32, dropout 0 and SpecAugment off (random bits differ between
the frameworks), the char tokenizer, gradient accumulation 1, the
validation search at epoch 2 (beam 3) and test beam 4, on the
train-to-floor tone corpus (8 / 4 / 4 utterances). The port starts from
the JAX package's initial params through `models.params_import`.
Tolerances: per-step losses 2e-4 relative; parameters 1e-5 relative +
1e-5 of each tensor's largest value, as tests/test_torch_recipe.py;
train_log.txt rows (valid WER, CER and ACC) and the wer file exact.
"""

from __future__ import annotations

import functools
import os
import runpy
import sys
from pathlib import Path

import jax
import pytest
import torch

from mamba_asr_tpu.cli import run_training as jax_run_training
from mamba_asr_tpu.parallel.mesh import make_mesh
from mamba_asr_tpu.training import checkpoint as jax_ckpt
from mamba_asr_tpu.training import loop as jax_loop

from mamba_asr_torch import cli
from mamba_asr_torch.cli import run_training
from mamba_asr_torch.configs.loader import load_config
from mamba_asr_torch.models.params_import import import_asr_params
from mamba_asr_torch.tools import train_to_floor
from mamba_asr_torch.training import loop
from tests._jax_native import jax_native  # noqa: F401 (the fixture)
from tests.test_torch_recipe import _close, _jax_script, _log_rows, _tree

torch.set_num_threads(1)
# The JAX package's native libraries, built and loaded without racing its tests.
pytestmark = pytest.mark.usefixtures("jax_native")

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "hparams" / "S2S" / "conmamba_small.yaml")
TINY = {
    "model.d_model": 16, "model.num_encoder_layers": 1, "model.num_decoder_layers": 1,
    "model.nhead": 2, "model.d_ffn": 16, "model.vocab_size": 16,
    "model.compute_dtype": "float32", "model.mamba.d_state": 4,
    "frontend.n_mels": 20, "model.n_mels": 20, "model.dropout": 0.0,
    "specaug.enabled": False, "data.tokenizer_type": "char",
    "train.grad_accumulation_factor": 1, "train.lr": 0.002, "train.warmup_steps": 10,
    "train.keep_checkpoints": 2, "train.avg_checkpoints": 2,
    "decode.valid_search_interval": 2, "decode.valid_beam_size": 3,
    "decode.s2s_test_beam_size": 4, "data.num_workers": 2,
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tones") / "corpus")
    train_to_floor.build_corpus(root, n_train=8, n_dev=4, n_test=4)
    return root


def _close_s2s_params(ours, jax_params, cfg, updates, what):
    """Parameters at 1e-5 relative + 1e-5 of each tensor's largest value,
    but the attention key biases: the softmax cancels them, their
    gradients are rounding noise and AdamW at eps 1e-9 moves each by up to
    lr per update, in a direction the rounding picks (see
    tests/test_torch_s2s_training.py); they are held within 2 lr per
    update."""
    d = cfg.model.d_model
    keys = {n: t[d:2 * d].clone() for n, t in ours.items() if n.endswith("att.in_proj_bias")}
    ref = import_asr_params(jax_params, cfg.model)
    for name, k in keys.items():
        assert (k - ref[name][d:2 * d]).abs().max() <= 2 * updates * cfg.train.lr, name
    strip = {n: (torch.cat([t[:d], t[2 * d:]]) if n in keys else t) for n, t in ours.items()}
    want = {n: (torch.cat([t[:d], t[2 * d:]]) if n in keys else t) for n, t in ref.items()}
    assert strip.keys() == want.keys()
    for name, t in strip.items():
        _close(t.numpy(), want[name].numpy(), 1e-5, 1e-5, f"{what} {name}")


def _cli_args(corpus, out, epochs):
    args = [CONFIG, "--data.data_folder", corpus, "--data.output_folder", out,
            "--data.train_splits", "[train-clean-100]", "--data.test_splits", "[test-clean]",
            "--data.num_buckets", "1", "--data.max_batch_seconds", "5.0"]
    for key, value in TINY.items():
        args += [f"--{key}", str(value).lower() if isinstance(value, bool) else str(value)]
    return args + ["--train.number_of_epochs", str(epochs)]


def test_s2s_cli_matches_jax_end_to_end_and_resumes(corpus, tmp_path, monkeypatch, capsys):
    """Two epochs of each package's S2S CLI (speed perturbation on; the
    joint beam search validates epoch 2 and decodes the test set), the port
    with --device cpu from the JAX initial params: the same files; equal
    per-step losses; equal train_log rows (valid WER, CER, ACC; the test
    row) and wer file; the checkpoints kept by ACC and the averaged one
    (metrics, params, normaliser, step). Then the port resumes from epoch
    2 and trains epoch 3 only."""
    monkeypatch.setattr(jax_loop, "make_mesh",
                        lambda **kw: make_mesh(devices=jax.devices()[:1], **kw))
    init = {}
    jax_init_state = jax_loop.Trainer.init_state

    def capture_init(self, batch):
        jax_init_state(self, batch)
        init["params"] = jax.device_get(self.state.params)

    monkeypatch.setattr(jax_loop.Trainer, "init_state", capture_init)
    jtr = jax_run_training(_cli_args(corpus, str(tmp_path / "jax"), 2))
    pcfg = load_config(CONFIG, dict(TINY))
    monkeypatch.setattr(cli, "Trainer", functools.partial(
        loop.Trainer, state_dict=import_asr_params(init["params"], pcfg.model)))
    ptr = run_training(_cli_args(corpus, str(tmp_path / "torch"), 2) + ["--device", "cpu"])
    monkeypatch.undo()
    assert ptr.is_s2s and ptr.metric_key == "ACC"
    assert _tree(ptr.cfg.output_folder) == _tree(jtr.cfg.output_folder)
    assert len(ptr.loss_history) == len(jtr.loss_history) >= 6
    _close(ptr.loss_history, jtr.loss_history, 2e-4, 0.0, "loss history")
    rows = {}
    for name in ("train_log.txt", "wer_test-clean.txt"):
        rows[name] = _log_rows(os.path.join(ptr.cfg.output_folder, name))
        assert rows[name] == _log_rows(os.path.join(jtr.cfg.output_folder, name)), name
    assert all("valid ACC" in row for row in rows["train_log.txt"][:2])

    def by_epoch(mgr):
        return {e["metrics"].get("epoch", "avg"): e for e in mgr._entries(include_averaged=True)}

    ours, theirs = by_epoch(ptr.ckpt), by_epoch(jtr.ckpt)
    assert ours.keys() == theirs.keys() == {1, 2, "avg"}
    for key, entry in ours.items():
        assert entry["metrics"] == theirs[key]["metrics"], key
        if key != "avg":
            assert entry["max_keys"] == ["ACC"] and entry["min_keys"] == []
        state = ptr.ckpt.restore(entry["name"])
        with open(os.path.join(jtr.ckpt.directory, theirs[key]["name"], "state.msgpack"),
                  "rb") as f:
            raw = jax_ckpt.serialization.msgpack_restore(f.read())
        _close_s2s_params(state["model"], raw["params"], pcfg, state["step"], f"ckpt {key}")
        for field in ("count", "mean", "m2"):
            _close(state["normalizer"][field].numpy(), raw["normalizer"][field], 1e-5, 1e-6)
        assert state["step"] == int(raw["step"])

    capsys.readouterr()
    again = run_training(_cli_args(corpus, str(tmp_path / "torch"), 3) + ["--device=cpu"])
    assert "resumed from checkpoint at epoch 2" in capsys.readouterr().out
    assert again.start_epoch == 3 and [e["epoch"] for e in again.epoch_log] == [3]
    assert set(again.epoch_log[0]["valid"]) == {"WER", "CER", "ACC"}
    assert again.micro_steps == 3 * ptr.micro_steps // 2
    assert "averaged_test-clean" in {e["name"] for e in again.ckpt._entries(include_averaged=True)}


def test_s2s_entry_point_refuses_without_a_card(monkeypatch, tmp_path):
    """`python -m mamba_asr_torch.train_s2s` without --device needs a card;
    it refuses before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["train_s2s", CONFIG, "--data.output_folder",
                                      str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_module("mamba_asr_torch.train_s2s", run_name="__main__")
    assert not (tmp_path / "out").exists()


def test_train_to_floor_s2s_overrides_are_the_jax_scripts(monkeypatch):
    """The S2S CLI arguments of `run_mode("s2s")` are the JAX script's,
    config included; the S2S mode trains 3x --epochs in both."""
    script = _jax_script()

    class Captured(Exception):
        pass

    def capture(path, run_name):
        raise Captured(list(sys.argv))

    monkeypatch.setattr(runpy, "run_path", capture)
    with pytest.raises(Captured) as got:
        script.run_mode("s2s", "CORPUS", "OUT", 180, s2s_config=train_to_floor.S2S_CONFIG)
    jax_argv = got.value.args[0]
    assert jax_argv[0] == "train_s2s.py" and jax_argv[1] == train_to_floor.S2S_CONFIG
    ours = (train_to_floor.ctc_overrides("CORPUS", os.path.join("OUT", "s2s"), 180)
            + train_to_floor.s2s_overrides(180))
    assert jax_argv[2:] == ours
    assert "--decode.valid_search_interval" in ours and "90" in ours

    seen = []
    monkeypatch.setattr(train_to_floor, "run_mode", lambda mode, corpus, out, epochs, *a, **k:
                        seen.append((mode, epochs)) or ({"test_wer": 0.0}, None))
    monkeypatch.setattr(train_to_floor, "build_corpus", lambda *a, **k: None)
    for mode in ("ctc", "s2s"):
        assert train_to_floor.main(["--mode", mode, "--epochs", "7", "--workdir", "W"]) == 0
    assert seen == [("ctc", 7), ("s2s", 21)]
