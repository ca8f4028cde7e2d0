"""Export of the PyTorch port's models in the reference's checkpoint format
(mamba_asr_torch/models/torch_export.py, `python -m
mamba_asr_torch.export_torch`) against the JAX package's exporter, on the
CPU, at the tiny size of tests/test_torch_search_paths.py (params drawn by
`jax.eval_shape` and numpy, no compile).

- `export_asr_state` of the port's model equals `export_asr_params` on
  the same JAX params key by key and value by value: ConMamba CTC,
  ConMamba S2S (Transformer decoder), ConMambaMamba S2S and Conformer CTC
  with RelPosMHAXL. The Branchformer and the Conformer decoder are
  refused by both exporters.
- `export_normalizer_stats` equals JAX's, count 0 included; `save_torch_lm`
  writes what `save_torch_lm` of the JAX package writes.
- The round trip: a seeded save dir of the port exported through the CLI,
  then `recognize --torch_ckpt --torch_normalizer` prints what `recognize
  --ckpt_dir` prints. Without a card and `--device`, the CLI refuses to
  start and writes nothing.
"""

from __future__ import annotations

import contextlib
import io
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.models import torch_export as jax_export
from mamba_asr_tpu.training.normalizer import NormalizerState as JaxNormalizerState

from mamba_asr_torch import export_torch, recognize
from mamba_asr_torch.configs.loader import load_config
from mamba_asr_torch.data.tokenizer import CharTokenizer
from mamba_asr_torch.models import asr
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.models import torch_export
from mamba_asr_torch.tools import train_to_floor
from mamba_asr_torch.training.checkpoint import CheckpointManager
from mamba_asr_torch.training.normalizer import NormalizerState
from tests.test_torch_lm import LAYERS, jax_lm_params, port_of, seeded_params
from tests.test_torch_s2s_ops import port_cfg
from tests.test_torch_search_paths import FEATS, FLENS, VOCAB, tiny_cfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "hparams" / "CTC" / "conmamba_small.yaml")
TINY = {"model.d_model": 8, "model.num_encoder_layers": 2, "model.d_ffn": 16,
        "model.compute_dtype": "float32", "model.mamba.d_state": 4,
        "frontend.n_mels": 20, "model.n_mels": 20, "model.kernel_size": 5}
FLAGS = [a for k, v in TINY.items() for a in (f"--{k}", str(v))]


def jax_params(jcfg, seed=3):
    model = jax_asr.ASRModel(jcfg)
    toks = None
    if jcfg.num_decoder_layers > 0:
        toks = jnp.asarray(np.random.default_rng(seed).integers(3, VOCAB, (2, 7)), jnp.int32)
    return seeded_params(model, seed, jnp.asarray(FEATS), jnp.asarray(FLENS), toks)


CASES = {
    "conmamba_ctc": dict(num_decoder_layers=0),
    "conmamba_s2s": dict(decoder_module="transformer"),
    "conmambamamba_s2s": dict(decoder_module="mamba"),
    "conformer_ctc_relpos": dict(num_decoder_layers=0, encoder_module="conformer",
                                 attention_type="RelPosMHAXL"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_export_equals_jax_export(case):
    jcfg = tiny_cfg(**CASES[case])
    params = jax_params(jcfg)
    pcfg = port_cfg(jcfg)
    pm = asr.ASRModel(pcfg)
    pm.load_state_dict(pi.import_asr_params(params, pcfg), strict=True)
    got = torch_export.export_asr_state(pm, pcfg)
    want = jax_export.export_asr_params(params, jcfg)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("case", ["branchformer", "conformer_decoder"])
def test_both_exporters_refuse(case):
    kw = (dict(num_decoder_layers=0, encoder_module="branchformer", csgu_linear_units=64)
          if case == "branchformer" else dict(decoder_module="conformer"))
    jcfg = tiny_cfg(**kw)
    params = jax_params(jcfg)
    with pytest.raises((ValueError, KeyError)):  # JAX: a ValueError, or a missing leaf
        jax_export.export_asr_params(params, jcfg)
    pcfg = port_cfg(jcfg)
    pm = asr.ASRModel(pcfg)
    pm.load_state_dict(pi.import_asr_params(params, pcfg), strict=True)
    with pytest.raises(ValueError, match=kw["encoder_module"] if "encoder_module" in kw
                       else "decoder_module='conformer'"):
        torch_export.export_asr_state(pm, pcfg)


@pytest.mark.parametrize("count", [0.0, 750.0])
def test_normalizer_stats_equal_jax(count):
    rng = np.random.default_rng(2)
    mean = rng.normal(size=20).astype(np.float32)
    m2 = (rng.uniform(1, 3, size=20) * count).astype(np.float32)
    want = jax_export.export_normalizer_stats(
        JaxNormalizerState(count=jnp.float32(count), mean=jnp.asarray(mean),
                           m2=jnp.asarray(m2)))
    got = torch_export.export_normalizer_stats(NormalizerState.from_arrays(count, mean, m2))
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_save_torch_lm_writes_what_jax_writes(tmp_path):
    _, params = jax_lm_params(seed=5, vocab=VOCAB)
    jax_export.save_torch_lm(params, str(tmp_path / "jax.pt"), num_layers=LAYERS)
    torch_export.save_torch_lm(port_of(params, vocab=VOCAB), str(tmp_path / "port.pt"))
    want = torch.load(str(tmp_path / "jax.pt"), weights_only=True)
    got = torch.load(str(tmp_path / "port.pt"), weights_only=True)
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def _lines(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        recognize.main(argv)
    return out.getvalue().splitlines()


def test_exported_save_dir_recognises_alike(tmp_path):
    """Two seeded checkpoints in a save dir (their WER ranks them); the
    export of their average, then recognize on each source."""
    corpus = str(tmp_path / "corpus")
    train_to_floor.build_corpus(corpus, n_train=2, n_dev=1, n_test=3)
    test_dir = Path(corpus) / "test-clean" / "1" / "2"
    wavs = sorted(str(p) for p in test_dir.glob("*.wav"))
    tok_path = str(tmp_path / "tokenizer_char.json")
    CharTokenizer.fit(["abcdefghijklmnopqrstuvwxyz "], vocab_size=31).save(tok_path)
    cfg = load_config(CONFIG, {**TINY, "train.avg_checkpoints": 2})
    shapes = {k: tuple(v.shape) for k, v in asr.ASRModel(cfg.model).state_dict().items()}
    save = str(tmp_path / "save")
    mgr = CheckpointManager(save, keep=5)
    for i, wer in enumerate((30.0, 10.0)):
        rng = np.random.default_rng(i)
        sd = {k: torch.from_numpy((0.3 * rng.normal(size=s)).astype(np.float32))
              for k, s in shapes.items()}
        sd["2.w.bias"] -= 4.0 * torch.eye(31)[0]  # against blank: non-empty transcripts
        norm = {"count": torch.tensor(100.0 + i),
                "mean": torch.from_numpy(rng.normal(-3, 1, 20).astype(np.float32)),
                "m2": torch.from_numpy(rng.uniform(1, 4, 20).astype(np.float32) * 100)}
        mgr.save({"model": sd, "normalizer": norm}, metrics={"WER": wer, "epoch": i + 1},
                 min_keys=("WER",))
    out_dir = str(tmp_path / "export")
    export_torch.main([CONFIG, "--ckpt_dir", save, "--out_dir", out_dir, *FLAGS,
                       "--train.avg_checkpoints", "2", "--device", "cpu"])
    assert sorted(os.listdir(out_dir)) == ["model.ckpt", "normalizer.ckpt"]
    common = [CONFIG, *wavs, "--tokenizer", tok_path, *FLAGS, "--train.avg_checkpoints",
              "2", "--device", "cpu"]
    want = _lines(common + ["--ckpt_dir", save])
    got = _lines(common + ["--torch_ckpt", os.path.join(out_dir, "model.ckpt"),
                           "--torch_normalizer", os.path.join(out_dir, "normalizer.ckpt")])
    assert got == want
    assert len(want) == 3 and any(ln.split("\t")[1] for ln in want)
    with pytest.raises(SystemExit, match="usage"):
        export_torch.main([CONFIG, "--ckpt_dir", save])


def test_export_cli_refuses_to_run_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_torch.main([CONFIG, "--ckpt_dir", str(tmp_path / "save"),
                           "--out_dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
