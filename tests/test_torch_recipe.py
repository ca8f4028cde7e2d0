"""The port's CTC recipe against the JAX package's, on the CPU: the
checkpoint manager, the epoch loop (`loop.Trainer.fit`, validation,
averaged evaluation), the CLI and the train-to-floor tool.

Tiny sizes: d_model 16, one ConMamba layer, d_state 4, 20 mels, float32,
dropout 0 and SpecAugment off (random bits differ between the
frameworks), gradient accumulation 1; the corpus is the train-to-floor
tone corpus (8 / 4 / 4 utterances). The port starts from the JAX
package's initial params through `models.params_import`.
Tolerances: per-step losses 2e-4 relative; parameters after the
updates 1e-5 relative + 1e-5 of each tensor's largest value (a few
AdamW steps at eps 1e-9 from float32 gradients summed in other orders);
the normaliser 1e-5; averaging 1e-6; WER, CER and tokens exact.
"""

from __future__ import annotations

import functools
import glob
import importlib.util
import os
import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mamba_asr_tpu.cli import run_training as jax_run_training
from mamba_asr_tpu.configs.loader import load_config as jax_load_config
from mamba_asr_tpu.data.tokenizer import CharTokenizer
from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.parallel.mesh import make_mesh
from mamba_asr_tpu.training import checkpoint as jax_ckpt
from mamba_asr_tpu.training import loop as jax_loop

from mamba_asr_torch import cli
from mamba_asr_torch.cli import run_training
from mamba_asr_torch.configs.loader import load_config
from mamba_asr_torch.models.params_import import import_asr_params
from mamba_asr_torch.tools import train_to_floor
from mamba_asr_torch.training import checkpoint, loop
from tests._jax_native import jax_native  # noqa: F401 (the fixture)

torch.set_num_threads(1)
# The JAX package's native libraries, built and loaded without racing its tests.
pytestmark = pytest.mark.usefixtures("jax_native")

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "hparams" / "CTC" / "conmamba_small.yaml")
TINY = {
    "model.d_model": 16, "model.num_encoder_layers": 1, "model.d_ffn": 16,
    "model.compute_dtype": "float32", "model.mamba.d_state": 4,
    "frontend.n_mels": 20, "model.n_mels": 20, "model.dropout": 0.0,
    "specaug.enabled": False, "train.grad_accumulation_factor": 1,
    "train.lr": 0.002, "train.warmup_steps": 10, "train.keep_checkpoints": 2,
    "train.avg_checkpoints": 2, "decode.test_beam_size": 8, "data.num_workers": 2,
}
STEP_NAME = re.compile(r"ckpt_\d{8}_\d{6}_(\d{4})")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tones") / "corpus")
    train_to_floor.build_corpus(root, n_train=8, n_dev=4, n_test=4)
    return root


def _close(got, ref, rtol, atol_frac, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    atol = atol_frac * max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


def _close_params(ours, jax_params, model_cfg, rtol, atol_frac, what=""):
    ref = import_asr_params(jax_params, model_cfg)
    assert ours.keys() == ref.keys()
    for name, t in ours.items():
        _close(t.numpy(), ref[name].numpy(), rtol, atol_frac, f"{what} {name}")


# -- checkpoints --------------------------------------------------------------


def _jax_trees(cfg, n):
    """n params trees of the JAX model's structure, seeded noise."""
    model = jax_asr.ASRModel(cfg)
    feats = jax.numpy.zeros((1, 101, cfg.n_mels))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), feats,
                            jax.numpy.array([101]))["params"]
    rng = np.random.default_rng(0)
    return [jax.tree_util.tree_map(
        lambda x: rng.normal(0, 0.1, x.shape).astype(np.float32), shapes) for _ in range(n)]


def test_checkpoint_keep_set_and_average_match_jax(tmp_path, monkeypatch):
    """5 saves at keep 3 by min WER, each in its own second: the same
    checkpoints survive (by save count and metrics); the averaged
    parameters of the 3 best equal the JAX average, imported, to 1e-6; an
    averaged checkpoint is never pruned, ranked or counted."""
    jcfg = jax_load_config(CONFIG, TINY)
    pcfg = load_config(CONFIG, TINY)
    ours = checkpoint.CheckpointManager(str(tmp_path / "a"), keep=3)
    theirs = jax_ckpt.CheckpointManager(str(tmp_path / "b"), keep=3)
    trees = _jax_trees(jcfg.model, 5)
    for i, (wer, tree) in enumerate(zip([30.0, 10.0, 25.0, 20.0, 5.0], trees)):
        stamp = f"20260101_0000{i:02d}"
        monkeypatch.setattr("time.strftime", lambda fmt: stamp)
        metrics = {"WER": wer, "epoch": i + 1}
        ours.save({"model": import_asr_params(tree, pcfg.model)}, metrics=metrics,
                  min_keys=("WER",))
        theirs.save({"params": tree}, metrics=metrics, min_keys=("WER",))
    monkeypatch.undo()

    def kept(mgr):
        return sorted((STEP_NAME.fullmatch(e["name"]).group(1), e["metrics"]["epoch"])
                      for e in mgr._entries())

    assert kept(ours) == kept(theirs) == [("0001", 2), ("0003", 4), ("0003", 5)]
    assert ours.best(min_key="WER") == theirs.best(min_key="WER")
    best, avg = ours.restore_averaged(k=3, min_key="WER")
    _, javg = theirs.restore_averaged({"params": trees[0]}, k=3, min_key="WER",
                                      select=lambda s: s["params"])
    _close_params(avg, javg, pcfg.model, 0.0, 1e-6, "average")
    _close_params(best["model"], trees[4], pcfg.model, 0.0, 0.0, "best")
    ours.save({"model": avg}, metrics={"WER": 1.0, "averaged": True}, name="averaged_x")
    assert kept(ours) == [("0001", 2), ("0003", 4), ("0003", 5)]
    assert os.path.isdir(tmp_path / "a" / "averaged_x")
    assert "averaged_x" in {e["name"] for e in ours._entries(include_averaged=True)}


def test_the_newest_checkpoint_is_kept_for_resume(tmp_path, monkeypatch):
    """A checkpoint ranked below the keep best survives while it is the
    newest (JAX prunes it at once: its auto-resume would then go back to an
    older epoch), goes at the next save, and never counts in the average."""
    ours = checkpoint.CheckpointManager(str(tmp_path / "a"), keep=2)
    theirs = jax_ckpt.CheckpointManager(str(tmp_path / "b"), keep=2)
    for i, wer in enumerate([10.0, 20.0, 30.0]):
        monkeypatch.setattr("time.strftime", lambda fmt, i=i: f"20260101_0000{i:02d}")
        ours.save({"model": {"w": torch.full((2,), float(i))}},
                  metrics={"WER": wer, "epoch": i + 1}, min_keys=("WER",))
        theirs.save({"x": np.float32(i)}, metrics={"WER": wer, "epoch": i + 1},
                    min_keys=("WER",))
    assert sorted(e["metrics"]["epoch"] for e in theirs._entries()) == [1, 2]
    assert sorted(e["metrics"]["epoch"] for e in ours._entries()) == [1, 2, 3]
    _, avg = ours.restore_averaged(k=2, min_key="WER")
    assert avg["w"].tolist() == [0.5, 0.5]
    ours.save({"model": {"w": torch.zeros(2)}}, metrics={"WER": 40.0, "epoch": 4},
              min_keys=("WER",))
    assert sorted(e["metrics"]["epoch"] for e in ours._entries()) == [1, 2, 4]


def test_checkpoint_names_do_not_collide_within_a_second(tmp_path, monkeypatch):
    """After pruning, the count of checkpoints held repeats: JAX's name
    for the next save in the same second is a kept checkpoint's, which it
    overwrites (here epoch 3's, the second best, by epoch 4's). The port
    takes the next free count: the two best and the newest survive."""
    monkeypatch.setattr("time.strftime", lambda fmt: "20260101_000000")
    ours = checkpoint.CheckpointManager(str(tmp_path / "a"), keep=2)
    theirs = jax_ckpt.CheckpointManager(str(tmp_path / "b"), keep=2)
    for i, wer in enumerate([30.0, 10.0, 20.0, 40.0]):
        ours.save({"x": torch.tensor(float(i))}, metrics={"WER": wer, "epoch": i + 1},
                  min_keys=("WER",))
        theirs.save({"x": np.float32(i)}, metrics={"WER": wer, "epoch": i + 1},
                    min_keys=("WER",))
    assert sorted(e["metrics"]["epoch"] for e in ours._entries()) == [2, 3, 4]
    assert sorted(e["metrics"]["epoch"] for e in theirs._entries()) == [2, 4]


# -- the CLI and the epoch loop ------------------------------------------------


def _tree(root):
    """Relative paths under root, checkpoint timestamps and the state file's
    extension made neutral."""
    out = set()
    for path in glob.glob(os.path.join(root, "**"), recursive=True):
        rel = os.path.relpath(path, root)
        rel = re.sub(r"ckpt_\d{8}_\d{6}_", "ckpt_T_", rel)
        out.add(re.sub(r"state\.(pt|msgpack)$", "state.*", rel))
    return out


def _log_rows(path):
    """train_log.txt rows without the wall seconds."""
    with open(path) as f:
        return [re.sub(r"epoch_sec: [0-9.e+]+, ", "", line) for line in f]


def _cli_args(corpus, out, epochs):
    args = [CONFIG, "--data.data_folder", corpus, "--data.output_folder", out,
            "--data.train_splits", "[train-clean-100]", "--data.test_splits", "[test-clean]",
            "--data.num_buckets", "1", "--data.max_batch_seconds", "5.0"]
    for key, value in TINY.items():
        args += [f"--{key}", str(value).lower() if isinstance(value, bool) else str(value)]
    return args + ["--train.number_of_epochs", str(epochs)]


def test_cli_matches_jax_end_to_end_and_resumes(corpus, tmp_path, monkeypatch, capsys):
    """Two epochs of each package's CLI on the tone corpus with speed
    perturbation on, the JAX one on a one-device mesh and the port (with
    --device cpu) from the JAX initial params: the same files under
    output_folder; equal per-step losses, train_log rows (valid WER and
    CER, the test row), wer file, kept and averaged checkpoints (params,
    normaliser, step). A third port run with 3 epochs resumes from epoch
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
    pcfg = load_config(CONFIG, {**TINY})
    monkeypatch.setattr(cli, "Trainer", functools.partial(
        loop.Trainer, state_dict=import_asr_params(init["params"], pcfg.model)))
    ptr = run_training(_cli_args(corpus, str(tmp_path / "torch"), 2) + ["--device", "cpu"])
    monkeypatch.undo()
    assert ptr.device == torch.device("cpu")
    assert _tree(ptr.cfg.output_folder) == _tree(jtr.cfg.output_folder)
    assert len(ptr.loss_history) == len(jtr.loss_history) >= 6
    _close(ptr.loss_history, jtr.loss_history, 2e-4, 0.0, "loss history")
    for name in ("train_log.txt", "wer_test-clean.txt"):
        assert _log_rows(os.path.join(ptr.cfg.output_folder, name)) == \
            _log_rows(os.path.join(jtr.cfg.output_folder, name)), name

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
        _close_params(state["model"], raw["params"], pcfg.model, 1e-5, 1e-5, f"ckpt {key}")
        for field in ("count", "mean", "m2"):
            _close(state["normalizer"][field].numpy(), raw["normalizer"][field], 1e-5, 1e-6)
        assert state["step"] == int(raw["step"])

    capsys.readouterr()
    again = run_training(_cli_args(corpus, str(tmp_path / "torch"), 3) + ["--device=cpu"])
    assert "resumed from checkpoint at epoch 2" in capsys.readouterr().out
    assert again.start_epoch == 3 and [e["epoch"] for e in again.epoch_log] == [3]
    assert again.micro_steps == 3 * ptr.micro_steps // 2
    # All three epochs tie at WER 100: the two oldest rank best, and the
    # newest is kept besides them (JAX would prune it; see above).
    assert sorted(e["metrics"]["epoch"] for e in again.ckpt._entries()) == [1, 2, 3]
    assert {e["name"] for e in again.ckpt._entries(include_averaged=True)} >= {"averaged_test-clean"}


@pytest.mark.parametrize("rng_format", ["per_rank", "single_dict"])
def test_resumed_run_draws_what_an_uninterrupted_one_draws(corpus, tmp_path, rng_format):
    """Dropout 0.1 and SpecAugment on, speed perturbation on: 2 epochs and
    then a resumed third give the third epoch's losses and the final
    parameters of 3 epochs in one run, exactly (the same float32 ops on
    the same CPU). Without the checkpoint's random state the resumed run
    would redraw epoch 1's dropout and SpecAugment masks. single_dict
    rewrites the checkpoints' `rng` to the older single-process form (one
    dict of generator states, not a list by rank) before resuming."""
    def run(out, epochs):
        args = _cli_args(corpus, str(tmp_path / out), epochs)
        return run_training(args + ["--data.test_splits", "[]", "--model.dropout", "0.1",
                                    "--specaug.enabled", "true", "--device", "cpu"])

    whole = run("whole", 3)
    parts = run("parts", 2)
    if rng_format == "single_dict":
        for entry in parts.ckpt._entries():
            path = os.path.join(parts.ckpt.directory, entry["name"], "state.pt")
            state = torch.load(path, weights_only=True)
            assert isinstance(state["rng"], list) and len(state["rng"]) == 1
            state["rng"] = state["rng"][0]
            torch.save(state, path)
    resumed = run("parts", 3)
    assert resumed.start_epoch == 3 and resumed.micro_steps == whole.micro_steps
    n = len(resumed.loss_history)
    assert n >= 2 and resumed.loss_history == whole.loss_history[-n:]
    got = resumed.step.model.state_dict()
    for name, t in whole.step.model.state_dict().items():
        assert torch.equal(got[name], t), name


def test_cli_refuses_what_is_not_ported(corpus, tmp_path):
    # Multi-process training is ported (tests/test_torch_distributed.py):
    # --distributed now refuses only a run that names no rendezvous, and
    # pipeline parallelism is refused naming its ROADMAP item.
    with pytest.raises(RuntimeError, match="MASR_COORDINATOR"):
        run_training([CONFIG, "--distributed", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 10"):
        run_training([CONFIG, "--device", "cpu", "--parallel.pipeline_stages", "2"])
    s2s = str(REPO / "hparams" / "S2S" / "conmamba_small.yaml")
    # The Conformer decoder is ported: the loop builds with it, and an
    # unknown decoder is refused.
    tr = loop.Trainer(load_config(s2s, {"data.output_folder": str(tmp_path),
                                        "model.decoder_module": "conformer"}),
                      CharTokenizer(list("AB")), device="cpu")
    assert tr.step.model.conformer_decoder
    with pytest.raises(ValueError, match="decoder_module"):
        loop.Trainer(load_config(s2s, {"data.output_folder": str(tmp_path),
                                       "model.decoder_module": "lstm"}),
                     CharTokenizer(list("AB")), device="cpu")
    with pytest.raises(ValueError, match="decoder_module"):
        train_to_floor.run_mode("s2s", corpus, str(tmp_path), 1, device="cpu",
                                extra=["--model.decoder_module", "lstm"])
    with pytest.raises(ValueError, match="save_torch_lm"):  # a flax msgpack LM
        run_training([s2s, "--decode.lm_path", "lm.msgpack", "--device", "cpu",
                      "--data.output_folder", str(tmp_path / "lm")])
    assert not (tmp_path / "lm").exists()
    # Dynamic-chunk training and the Augmenter's concat/repeat modes are
    # ported now: the loop builds with them.
    tr = loop.Trainer(load_config(s2s, {"data.output_folder": str(tmp_path),
                                        "specaug.repeat_augment": 2,
                                        "specaug.concat_original": True,
                                        "train.dynchunk_size": 8}),
                      CharTokenizer(list("AB")), device="cpu")
    assert tr.step.specaug.repeat_augment == 2 and tr.step.train.dynchunk_size == 8


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_to_floor", REPO / "scripts" / "train_to_floor.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_to_floor_builds_the_jax_corpus_and_overrides(tmp_path, monkeypatch):
    """build_corpus writes the JAX script's files byte for byte; the CLI
    arguments of CTC mode are the script's."""
    script = _jax_script()
    train_to_floor.build_corpus(str(tmp_path / "a"), n_train=3, n_dev=2, n_test=2, seed=4)
    script.build_corpus(str(tmp_path / "b"), n_train=3, n_dev=2, n_test=2, seed=4)
    files = sorted(p.relative_to(tmp_path / "a") for p in (tmp_path / "a").rglob("*")
                   if p.is_file())
    assert len(files) == 10
    for rel in files:
        assert (tmp_path / "a" / rel).read_bytes() == (tmp_path / "b" / rel).read_bytes()

    class Captured(Exception):
        pass

    def capture(path, run_name):
        raise Captured(list(sys.argv))

    monkeypatch.setattr(runpy, "run_path", capture)
    with pytest.raises(Captured) as got:
        script.run_mode("ctc", "CORPUS", "OUT", 60)
    jax_argv = got.value.args[0]
    assert jax_argv[1] == "hparams/CTC/conmamba_small.yaml"
    assert jax_argv[2:] == train_to_floor.ctc_overrides("CORPUS", os.path.join("OUT", "ctc"), 60)


def test_train_to_floor_tool_on_cpu(tmp_path):
    """The tool end to end at a tiny size: it prints its RESULT line and
    fails the target after 1 epoch."""
    rc = train_to_floor.main([
        "--device", "cpu", "--workdir", str(tmp_path), "--epochs", "1", "--n-train", "4",
        "--n-dev", "2", "--n-test", "2", "--target", "0.0",
        *[a for k, v in TINY.items() if k.startswith(("model.", "frontend."))
          for a in (f"--{k}", str(v))]])
    assert rc == 1
    out = glob.glob(str(tmp_path / "out" / "ctc" / "**" / "wer_test-clean.txt"), recursive=True)
    assert len(out) == 1
