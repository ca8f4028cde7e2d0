"""Recognition's entry points in the PyTorch port against the JAX package,
on the CPU, at a tiny size (hparams/CTC/conmamba_small.yaml with d_model
8, 2 layers, d_ffn 16, d_state 4, n_mels 20, float32) on the tone corpus
of tools/train_to_floor.py.

- `ctc_greedy_decode_with_times` against JAX's on seeded log-probs with
  argmax runs and ragged lengths: tokens, lengths, onsets and offsets
  equal, confidences within 1e-5; `word_timestamps` equal.
- `cli.restore_asr_state` on a save dir of three checkpoints written by
  the port's CheckpointManager: the parameters are the mean of the two
  best by WER (1e-6), the normaliser the best one's; a missing dir, an
  empty one and a JAX (msgpack) save dir raise SystemExit.
- `python -m mamba_asr_torch.recognize --torch_ckpt --torch_normalizer`
  on a reference checkpoint written by the JAX package's
  `torch_export.save_torch_asr` prints the same lines as the JAX
  package's recognize.py on it: transcripts, and with --timestamps the
  word times; --beam prints Recognizer(search="beam")'s transcripts, and
  --streaming runs.
- `python -m mamba_asr_torch.evaluate` on a tiny experiment of
  `cli.run_training` reproduces its test WER and wer file.
"""

from __future__ import annotations

import contextlib
import io
import os
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.configs.loader import load_config as jax_load_config
from mamba_asr_tpu.data.tokenizer import CharTokenizer
from mamba_asr_tpu.decoding import ctc_greedy as jax_greedy
from mamba_asr_tpu.decoding import timestamps as jax_ts
from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.models.torch_export import export_normalizer_stats, save_torch_asr
from mamba_asr_tpu.training import trainer as jax_trainer
from mamba_asr_tpu.training.normalizer import NormalizerState as JaxNormalizerState

from mamba_asr_torch import cli, evaluate, recognize
from mamba_asr_torch.configs.loader import load_config
from mamba_asr_torch.data.audio import read_audio
from mamba_asr_torch.data.tokenizer import load_tokenizer
from mamba_asr_torch.decoding.ctc_greedy import ctc_greedy_decode_with_times
from mamba_asr_torch.decoding.timestamps import word_timestamps
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.serving.recognizer import Recognizer
from mamba_asr_torch.tools import train_to_floor
from mamba_asr_torch.training.checkpoint import CheckpointManager
from tests.test_torch_conformer import seeded

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "hparams" / "CTC" / "conmamba_small.yaml")
TINY = {"model.d_model": 8, "model.num_encoder_layers": 2, "model.d_ffn": 16,
        "model.compute_dtype": "float32", "model.mamba.d_state": 4,
        "frontend.n_mels": 20, "model.n_mels": 20}
FLAGS = [a for k, v in TINY.items() for a in (f"--{k}", str(v))]


def test_greedy_times_and_words_match_jax():
    rng = np.random.default_rng(3)
    b, t, v = 4, 40, 6
    # Argmax runs of 1 to 4 frames over a few ids, blank among them.
    best = np.repeat(rng.integers(0, v, size=(b, t)), rng.integers(1, 5, size=t), axis=1)[:, :t]
    logits = rng.normal(size=(b, t, v)) + 4.0 * np.eye(v)[best]
    lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    lens = np.array([40, 33, 17, 1], np.int32)
    got = [x.numpy() for x in ctc_greedy_decode_with_times(torch.from_numpy(lp),
                                                           torch.from_numpy(lens))]
    want = [np.asarray(x) for x in jax_greedy.ctc_greedy_decode_with_times(
        jnp.asarray(lp), jnp.asarray(lens))]
    for name, g, w in zip(("tokens", "lengths", "onsets", "offsets"), got[:4], want[:4]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got[4], want[4], atol=1e-5, rtol=0)
    assert got[1].min() >= 0 and got[1][0] > 3

    tok = CharTokenizer.fit(["ab cd", "e"], vocab_size=v)
    for r in range(b):
        n = int(got[1][r])
        args = (got[0][r, :n], got[2][r, :n], got[3][r, :n], tok, 0.04)
        assert word_timestamps(*args, confs=got[4][r, :n]) == jax_ts.word_timestamps(
            *args, confs=want[4][r, :n])
        assert word_timestamps(*args) == jax_ts.word_timestamps(*args)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(work dir, the tone corpus's test wavs, a char tokenizer's path, the
    JAX model config, seeded JAX params)."""
    work = tmp_path_factory.mktemp("recognize")
    corpus = str(work / "corpus")
    train_to_floor.build_corpus(corpus, n_train=4, n_dev=2, n_test=3)
    test_dir = os.path.join(corpus, "test-clean", "1", "2")
    wavs = sorted(str(p) for p in Path(test_dir).glob("*.wav"))
    with open(os.path.join(test_dir, "1-2.trans.txt")) as f:
        texts = [line.split(" ", 1)[1].strip() for line in f]
    tok_path = str(work / "tokenizer_char.json")
    # Every id from 4 to 30 decodes to a character (or the space).
    CharTokenizer.fit(texts + ["abcdefghijklmnopqrstuvwxyz "], vocab_size=31).save(tok_path)
    jcfg = jax_load_config(CONFIG, TINY)
    model = jax_asr.ASRModel(jcfg.model)
    params = seeded(model, 11, jnp.zeros((1, 32, 20)), jnp.array([32]))
    return work, corpus, wavs, tok_path, jcfg, params


def _ckpt_state(model_sd, count, seed):
    rng = np.random.default_rng(seed)
    norm = {"count": torch.tensor(float(count)),
            "mean": torch.from_numpy(rng.normal(size=20).astype(np.float32)),
            "m2": torch.from_numpy(rng.uniform(1, 2, size=20).astype(np.float32) * count)}
    return {"model": model_sd, "normalizer": norm}


def test_restore_asr_state_averages_the_best_two(tiny, tmp_path):
    cfg = load_config(CONFIG, {**TINY, "train.avg_checkpoints": 2})
    mgr = CheckpointManager(str(tmp_path / "save"), keep=5)
    sds = []
    for i, wer in enumerate((30.0, 10.0, 20.0)):
        rng = np.random.default_rng(i)
        sd = {k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32))
              for k, v in pi.import_asr_params(tiny[5], cfg.model).items()}
        sds.append(sd)
        mgr.save(_ckpt_state(sd, 100 + i, i), metrics={"WER": wer, "epoch": i + 1},
                 min_keys=("WER",))
    model, norm = cli.restore_asr_state(cfg, ckpt_dir=str(tmp_path / "save"), device="cpu")
    assert not model.training
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ((sds[1][k] + sds[2][k]) / 2).numpy(),
                                   atol=1e-6, rtol=0, err_msg=k)
    assert float(norm.count) == 101.0  # the best checkpoint's
    with pytest.raises(SystemExit, match="no checkpoints"):
        cli.restore_asr_state(cfg, ckpt_dir=str(tmp_path / "missing"), device="cpu")
    os.makedirs(tmp_path / "empty")
    with pytest.raises(SystemExit, match="no checkpoints"):
        cli.restore_asr_state(cfg, ckpt_dir=str(tmp_path / "empty"), device="cpu")
    with pytest.raises(SystemExit, match="need --ckpt_dir"):
        cli.restore_asr_state(cfg, device="cpu")
    os.makedirs(tmp_path / "jax" / "ckpt_1")
    (tmp_path / "jax" / "ckpt_1" / "state.msgpack").write_bytes(b"")
    with pytest.raises(SystemExit, match="save_torch_asr"):
        cli.restore_asr_state(cfg, ckpt_dir=str(tmp_path / "jax"), device="cpu")


def _lines(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return out.getvalue().splitlines()


def _jax_recognize(argv):
    saved = sys.argv
    sys.argv = ["recognize.py", *argv]
    try:
        runpy.run_path(str(REPO / "recognize.py"), run_name="__main__")
    finally:
        sys.argv = saved


@pytest.fixture
def jit_jax_init(monkeypatch):
    """JAX's restore builds its template state by an eager `model.init`,
    ~250 ops each compiled alone; under one jit the template is the same
    and compiles once. The checkpoint's params replace it either way."""
    eager = jax_trainer.init_train_state

    def init_train_state(model, tx, frontend, rng, example_batch):
        return jax.jit(lambda r: eager(model, tx, frontend, r, example_batch))(rng)

    monkeypatch.setattr(jax_trainer, "init_train_state", init_train_state)


@pytest.fixture(scope="module")
def reference_ckpt(tiny):
    """A reference model.ckpt and normalizer.ckpt written by the JAX
    package from the seeded params and a seeded normaliser."""
    work, _, _, _, jcfg, params = tiny
    # A bias against blank, so that the seeded model's transcripts are not
    # empty.
    params = {**params, "ctc_head": {**params["ctc_head"],
                                     "bias": params["ctc_head"]["bias"] - 4.0 * np.eye(31)[0]}}
    save_torch_asr(params, jcfg.model, str(work / "model.ckpt"))
    rng = np.random.default_rng(5)
    norm = JaxNormalizerState(count=jnp.float32(500.0),
                              mean=jnp.asarray(rng.normal(-3, 1, 20).astype(np.float32)),
                              m2=jnp.asarray(rng.uniform(1, 4, 20).astype(np.float32) * 500))
    torch.save({k: torch.tensor(np.asarray(v))
                for k, v in export_normalizer_stats(norm).items()},
               str(work / "normalizer.ckpt"))
    return ["--torch_ckpt", str(work / "model.ckpt"),
            "--torch_normalizer", str(work / "normalizer.ckpt")]


def test_recognize_prints_what_jax_prints(tiny, reference_ckpt, jit_jax_init):
    _, _, wavs, tok_path, _, _ = tiny
    argv = [CONFIG, *wavs, *reference_ckpt, "--tokenizer", tok_path, "--batch", "3",
            "--timestamps", *FLAGS]
    want = _lines(_jax_recognize, argv)
    got = _lines(recognize.main, argv + ["--device", "cpu"])
    assert got == want
    transcripts = [ln.split("\t")[1] for ln in got if ln.startswith(tuple(wavs))]
    assert len(transcripts) == 3 and any(transcripts)
    assert len(got) > 3  # word lines


def test_recognize_beam_and_streaming(tiny, reference_ckpt):
    _, _, wavs, tok_path, _, _ = tiny
    argv = [CONFIG, *wavs, *reference_ckpt, "--tokenizer", tok_path, *FLAGS,
            "--device", "cpu"]
    got = _lines(recognize.main, argv + ["--beam", "4", "--batch", "2"])
    cfg = load_config(CONFIG, TINY)
    model, norm = cli.restore_asr_state(cfg, torch_ckpt=reference_ckpt[1],
                                        torch_normalizer=reference_ckpt[3], device="cpu")
    rec = Recognizer.from_model(model, norm, cfg.frontend, batch=2, search="beam",
                                decode=cfg.decode.__class__(**{**cfg.decode.__dict__,
                                                              "test_beam_size": 4}))
    tok = load_tokenizer(tok_path)
    ids = rec.transcribe([read_audio(p)[0] for p in wavs])
    assert got == [f"{p}\t{tok.decode(i)}" for p, i in zip(wavs, ids)]
    streamed = _lines(recognize.main, argv + ["--streaming", "--chunk_frames", "32"])
    assert [ln.split("\t")[0] for ln in streamed] == wavs


def test_evaluate_reproduces_the_recipe_test_wer(tiny):
    work, corpus, _, _, _, _ = tiny
    argv = [CONFIG, *FLAGS, "--data.data_folder", corpus,
            "--data.output_folder", str(work / "exp"),
            "--data.train_splits", "[train-clean-100]", "--data.dev_splits", "[dev-clean]",
            "--data.test_splits", "[test-clean]", "--data.speed_perturb", "false",
            "--train.number_of_epochs", "1",
            "--decode.test_beam_size", "4", "--data.num_workers", "1", "--device", "cpu",
            "--model.dropout", "0.0", "--specaug.enabled", "false", "--model.kernel_size", "7"]
    tr = cli.run_training(argv)
    wer_file = Path(tr.cfg.output_folder) / "wer_test-clean.txt"
    before = wer_file.read_text()
    lines = _lines(evaluate.main, argv)
    assert lines[-1] == f"test-clean: {tr.test_stats['test-clean']}"
    assert wer_file.read_text() == before
