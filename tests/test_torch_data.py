"""The port's data pipeline against the JAX package's, on the CPU: audio
IO, the char tokenizer, the LibriSpeech manifests, speed perturbation,
bucketing and the bucketed loader; the WER/CER metrics and the training
logs; and every hparams YAML through both config loaders.

Corpora are generated from numpy seeds. Both packages' C++ resamplers
and FLAC decoders are the same source built with the same flags, so
waveforms must agree bit for bit; `sinc_resample_np` (float64 numpy on
both sides) to 1e-12.
"""

from __future__ import annotations

import dataclasses
import io
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mamba_asr_tpu.configs import loader as jax_loader
from mamba_asr_tpu.data import audio as jax_audio
from mamba_asr_tpu.data import augment as jax_augment
from mamba_asr_tpu.data import batching as jax_batching
from mamba_asr_tpu.data import dataset as jax_dataset
from mamba_asr_tpu.data import librispeech as jax_libri
from mamba_asr_tpu.data import tokenizer as jax_tok
from mamba_asr_tpu.training import logger as jax_logger
from mamba_asr_tpu.training import metrics as jax_metrics

from mamba_asr_torch.configs import loader
from mamba_asr_torch.data import audio, augment, batching, dataset, librispeech, tokenizer
from mamba_asr_torch.training import logger, metrics
from tests._jax_native import jax_native  # noqa: F401 (the fixture)

torch.set_num_threads(1)
# The JAX package's native libraries, built and loaded without racing its tests.
pytestmark = pytest.mark.usefixtures("jax_native")

REPO = Path(__file__).resolve().parents[1]
WORDS = ["HELLO", "WORLD", "GOOD", "DAY", "CAT", "DOG", "IT'S"]


def _make_corpus(root, n=6, seed=0, splits=("train-clean-100", "dev-clean")):
    """Splits of n utterances (0.4-1.6 s of tones in noise) in LibriSpeech's
    layout, odd ones as FLAC written by the JAX package, even ones WAV."""
    rng = np.random.default_rng(seed)
    for split in splits:
        d = os.path.join(root, split, "19", "198")
        os.makedirs(d, exist_ok=True)
        lines = []
        for i in range(n):
            uid = f"19-198-{i:04d}"
            length = int(rng.integers(6400, 25600))
            t = np.arange(length) / 16000
            wav = (0.3 * np.sin(2 * np.pi * rng.uniform(200, 900) * t)
                   + rng.normal(0, 0.05, length)).astype(np.float32)
            ext = ".flac" if i % 2 else ".wav"
            write = jax_audio.write_flac if i % 2 else jax_audio.write_wav
            write(os.path.join(d, uid + ext), wav, 16000)
            lines.append(f"{uid} {' '.join(rng.choice(WORDS, size=int(rng.integers(1, 4))))}")
        with open(os.path.join(d, "19-198.trans.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _make_corpus(str(tmp_path_factory.mktemp("corpus") / "LibriSpeech"))


# -- audio ------------------------------------------------------------------


def test_read_audio_matches_jax_bit_for_bit(corpus):
    """Every WAV and FLAC file: same samples (exact) and rate; the
    durations from the headers are equal."""
    files = sorted(str(p) for p in Path(corpus).rglob("*") if p.suffix in (".wav", ".flac"))
    assert any(f.endswith(".flac") for f in files) and any(f.endswith(".wav") for f in files)
    for f in files:
        ours, sr = audio.read_audio(f)
        theirs, jsr = jax_audio.read_audio(f)
        assert sr == jsr == 16000 and ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs, err_msg=f)
        assert audio.audio_duration(f) == jax_audio.audio_duration(f)


def test_flac_read_is_lossless_against_jax_wav(tmp_path):
    """FLAC is lossless: the port's read of a FLAC file equals the JAX
    package's read of the same samples written as WAV (numpy, no native
    library), and both are the samples to 16 bits (written at 32767, read
    at 1 / 32768: within two steps)."""
    wav = np.random.default_rng(4).uniform(-1.0, 1.0, 23456).astype(np.float32)
    audio.write_flac(str(tmp_path / "x.flac"), wav, 16000)
    jax_audio.write_wav(str(tmp_path / "x.wav"), wav, 16000)
    ours, sr = audio.read_audio(str(tmp_path / "x.flac"))
    theirs, jsr = jax_audio.read_audio(str(tmp_path / "x.wav"))
    assert sr == jsr == 16000
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_allclose(ours, wav, rtol=0, atol=2.0 / 32767)


def test_writers_match_jax_byte_for_byte(tmp_path):
    """write_wav and write_flac (several FLAC frames) give the JAX files."""
    wav = np.random.default_rng(3).uniform(-1.2, 1.2, 9000).astype(np.float32)
    for name, ours, theirs in (("x.wav", audio.write_wav, jax_audio.write_wav),
                               ("x.flac", audio.write_flac, jax_audio.write_flac)):
        ours(str(tmp_path / ("a" + name)), wav, 16000)
        theirs(str(tmp_path / ("b" + name)), wav, 16000)
        assert (tmp_path / ("a" + name)).read_bytes() == (tmp_path / ("b" + name)).read_bytes()
    assert audio.flac_stream_info(str(tmp_path / "ax.flac")) == (9000, 16000)


# -- tokenizer ----------------------------------------------------------------


@pytest.mark.parametrize("vocab_size", [None, 12])
def test_char_tokenizer_matches_jax(tmp_path, vocab_size):
    """fit (with and without a vocabulary cut), encode with unknown
    characters, decode skipping specials; each package loads the other's
    saved file, which is byte-identical."""
    corpus = ["HELLO WORLD", "IT'S A GOOD DAY", "ZEBRA"]
    ours = tokenizer.CharTokenizer.fit(corpus, vocab_size=vocab_size)
    theirs = jax_tok.CharTokenizer.fit(corpus, vocab_size=vocab_size)
    assert ours.id_to_tok == theirs.id_to_tok and ours.vocab_size == theirs.vocab_size
    text = "HELLO ZOO? IT'S"
    assert ours.encode(text) == theirs.encode(text)
    ids = [0, 1, 2, 3] + list(range(4, ours.vocab_size)) + [ours.vocab_size + 5]
    assert ours.decode(ids) == theirs.decode(ids)
    ours.save(str(tmp_path / "a.json"))
    theirs.save(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()
    assert tokenizer.load_tokenizer(str(tmp_path / "b.json")).id_to_tok == theirs.id_to_tok
    assert jax_tok.load_tokenizer(str(tmp_path / "a.json")).id_to_tok == ours.id_to_tok


def test_subword_tokenizer_files_are_refused(tmp_path, monkeypatch):
    """A subword tokenizer's file is refused only where the `tokenizers`
    package does not import."""
    path = tmp_path / "tok.json"
    path.write_text('{"version": "1.0", "model": {"type": "BPE"}}')
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(RuntimeError, match="tokenizers"):
        tokenizer.load_tokenizer(str(path))


# -- manifests ----------------------------------------------------------------


def test_prepare_librispeech_writes_the_jax_csvs(corpus, tmp_path):
    """Split CSVs, the merged train CSV, the option file and the lexicon
    are byte-identical; a second call with the same splits is skipped."""
    kw = dict(tr_splits=["train-clean-100"], dev_splits=["dev-clean"],
              merge_lst=["train-clean-100"], merge_name="train.csv")
    librispeech.prepare_librispeech(corpus, str(tmp_path / "a"), **kw)
    jax_libri.prepare_librispeech(corpus, str(tmp_path / "b"), **kw)
    librispeech.create_lexicon(str(tmp_path / "a"), ["train.csv"])
    jax_libri.create_lexicon(str(tmp_path / "b"), ["train.csv"])
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(os.listdir(tmp_path / "b")) == [
        "dev-clean.csv", "lexicon.csv", "opt_librispeech_prepare.json",
        "train-clean-100.csv", "train.csv"]
    for name in names:
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes(), name
    stamp = os.path.getmtime(tmp_path / "a" / "train.csv")
    librispeech.prepare_librispeech(corpus, str(tmp_path / "a"), **kw)
    assert os.path.getmtime(tmp_path / "a" / "train.csv") == stamp
    ours = librispeech.load_manifest(str(tmp_path / "a" / "train.csv"))
    theirs = jax_libri.load_manifest(str(tmp_path / "b" / "train.csv"))
    assert [dataclasses.astuple(u) for u in ours] == [dataclasses.astuple(u) for u in theirs]


# -- speed perturbation -----------------------------------------------------------


@pytest.mark.parametrize("factor", [0.95, 1.05])
@pytest.mark.parametrize("quality", ["sinc", "linear"])
def test_speed_perturb_matches_jax_bit_for_bit(factor, quality):
    """The same C++ built with the same flags: exact. The sinc output also
    matches the float64 numpy restatement to float32 rounding (2e-6 of
    the largest sample)."""
    wav = np.random.default_rng(5).normal(0, 0.2, 12345).astype(np.float32)
    ours = augment.speed_perturb(wav, factor, quality=quality)
    theirs = jax_augment.speed_perturb(wav, factor, quality=quality)
    assert ours.dtype == np.float32 and len(ours) == int(round(len(wav) / factor))
    np.testing.assert_array_equal(ours, theirs)
    if quality == "sinc":
        ref = augment.sinc_resample_np(wav, factor)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-6 * np.abs(ref).max())
    assert augment.speed_perturb(wav, 1.0) is wav


@pytest.mark.parametrize("factor", [0.95, 1.05, 1.0 / 3.0])
def test_sinc_resample_np_matches_jax(factor):
    """float64 numpy on both sides, 1e-12 absolute."""
    wav = np.random.default_rng(6).normal(0, 0.2, 3001).astype(np.float32)
    np.testing.assert_allclose(augment.sinc_resample_np(wav, factor),
                               jax_augment.sinc_resample_np(wav, factor), rtol=0, atol=1e-12)


def test_random_speed_perturb_draws_like_jax():
    wav = np.random.default_rng(7).normal(0, 0.2, 4000).astype(np.float32)
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(6):
        np.testing.assert_array_equal(augment.random_speed_perturb(wav, r1),
                                      jax_augment.random_speed_perturb(wav, r2))


# -- bucketing and the loader ----------------------------------------------------


def test_bucket_plan_and_sampler_match_jax():
    rng = np.random.default_rng(8)
    durations = rng.uniform(0.5, 17.0, 57)
    labels = rng.integers(3, 200, 57)
    for kw in (dict(num_buckets=4, max_batch_seconds=40.0),
               dict(num_buckets=8, max_batch_seconds=30.0)):
        ours = batching.make_bucket_plan(durations, labels, **kw)
        theirs = jax_batching.make_bucket_plan(durations, labels, **kw)
        assert [dataclasses.astuple(b) for b in ours.buckets] == \
            [dataclasses.astuple(b) for b in theirs.buckets]
        for shuffle in (True, False):
            s1 = batching.BucketSampler(durations, ours, shuffle=shuffle, seed=3)
            s2 = jax_batching.BucketSampler(durations, theirs, shuffle=shuffle, seed=3)
            assert s1.num_batches() == s2.num_batches()
            for epoch in (0, 1, 5):
                assert list(s1.epoch(epoch)) == list(s2.epoch(epoch))


@pytest.mark.parametrize("perturb", [False, True])
def test_bucketed_loader_matches_jax(corpus, tmp_path, perturb):
    """Epochs 0 and 1 of a shuffled loader over WAV and FLAC files, speed
    perturbation off and on, 4 decode threads: every key of every batch
    equal to the JAX loader's (wav exactly)."""
    out = str(tmp_path / "m")
    jax_libri.prepare_librispeech(corpus, out, tr_splits=["train-clean-100"])
    csv_path = os.path.join(out, "train-clean-100.csv")
    tok = jax_tok.CharTokenizer.fit(u.words for u in jax_libri.load_manifest(csv_path))
    kw = dict(num_buckets=2, max_batch_seconds=3.5, speed_perturb=perturb, seed=5,
              num_workers=4)
    ours = dataset.BucketedLoader(dataset.ASRDataset.from_csv(csv_path, tok), **kw)
    theirs = jax_dataset.BucketedLoader(jax_dataset.ASRDataset.from_csv(csv_path, tok), **kw)
    assert [dataclasses.astuple(b) for b in ours.plan.buckets] == \
        [dataclasses.astuple(b) for b in theirs.plan.buckets]
    assert ours.num_batches() == theirs.num_batches()
    n_pad = 0
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for key in a:
                if isinstance(b[key], np.ndarray):
                    assert a[key].dtype == b[key].dtype, key
                    np.testing.assert_array_equal(a[key], b[key], err_msg=key)
                else:
                    assert a[key] == b[key], key
            n_pad += int((a["weight"] == 0).sum())
    assert n_pad > 0  # partial batches were filled with weight-0 rows
    ours.close()


def test_loader_refuses_process_sharding(corpus, tmp_path):
    """Process sharding is ported (tests/test_torch_parallel.py); what the
    loader still refuses: an index outside the process count, and a batch
    that does not split over the processes."""
    out = str(tmp_path / "m")
    librispeech.prepare_librispeech(corpus, out, tr_splits=["dev-clean"])
    ds = dataset.ASRDataset.from_csv(os.path.join(out, "dev-clean.csv"),
                                     tokenizer.CharTokenizer(list("ABC")))
    with pytest.raises(ValueError, match="process_index"):
        dataset.BucketedLoader(ds, process_index=2, process_count=2)
    loader3 = dataset.BucketedLoader(ds, batch_divisor=3, num_workers=1, process_index=0,
                                     process_count=2)
    with pytest.raises(ValueError, match="not divisible"):
        list(loader3.epoch(0))


def test_prefetch_iterator_keeps_order_and_raises():
    assert list(dataset.prefetch_iterator(iter(range(7)), size=2)) == list(range(7))

    def failing():
        yield 1
        raise ValueError("decode failed")

    it = dataset.prefetch_iterator(failing())
    assert next(it) == 1
    with pytest.raises(ValueError, match="decode failed"):
        next(it)


# -- metrics and logs --------------------------------------------------------------


def _pairs(seed, n=40):
    rng = np.random.default_rng(seed)
    words = ["A", "B", "CAT", "DOG", "EGG", "IT'S"]
    out = []
    for i in range(n):
        ref = list(rng.choice(words, size=int(rng.integers(0, 8))))
        hyp = list(ref)
        for _ in range(int(rng.integers(0, 4))):
            op = rng.integers(3)
            if op == 0 and hyp:
                hyp[int(rng.integers(len(hyp)))] = str(rng.choice(words))
            elif op == 1:
                hyp.insert(int(rng.integers(len(hyp) + 1)), str(rng.choice(words)))
            elif hyp:
                del hyp[int(rng.integers(len(hyp)))]
        out.append((f"utt{i}", " ".join(hyp), " ".join(ref)))
    return out


def test_edit_distance_matches_jax_python_and_native():
    for _, hyp, ref in _pairs(1, 80):
        for r, h in ((ref.split(), hyp.split()), (list(ref), list(hyp))):
            ours = metrics.edit_distance_counts(r, h)
            assert ours == jax_metrics._edit_distance_counts_py(r, h)
            assert ours == jax_metrics.edit_distance_counts(r, h)
            assert metrics.align_tokens(r, h) == jax_metrics.align_tokens(r, h)


@pytest.mark.parametrize("split_tokens", [False, True])
def test_error_rate_stats_match_jax(split_tokens):
    """summarize() equal (exact) and write_stats' text identical."""
    ours = metrics.ErrorRateStats(split_tokens=split_tokens)
    theirs = jax_metrics.ErrorRateStats(split_tokens=split_tokens)
    for chunk in (_pairs(2)[:25], _pairs(2)[25:]):
        ids, hyps, refs = zip(*chunk)
        ours.append(ids, hyps, refs)
        theirs.append(ids, hyps, refs)
    assert ours.summarize() == theirs.summarize()
    a, b = io.StringIO(), io.StringIO()
    ours.write_stats(a)
    theirs.write_stats(b)
    assert a.getvalue() == b.getvalue()


def test_train_logs_match_jax(tmp_path, capsys):
    rows = [({"epoch": 1, "steps": 7, "epoch_sec": 1.5}, {"loss": 123.456789},
             {"WER": 100.0, "CER": 12345.678}, None),
            ({"test_set": "test-clean"}, None, None, {"WER": 1.23456, "CER": 0.5})]
    for name, cls in (("a", logger.FileTrainLogger), ("b", jax_logger.FileTrainLogger)):
        log = cls(str(tmp_path / name / "train_log.txt"))
        for meta, tr, va, te in rows:
            log.log_stats(meta, train_stats=tr, valid_stats=va, test_stats=te)
    assert (tmp_path / "a" / "train_log.txt").read_text() == \
        (tmp_path / "b" / "train_log.txt").read_text()
    js = logger.JsonlLogger(str(tmp_path / "steps.jsonl"))
    js.log(epoch=1, step=3, loss=2.5)
    assert '"epoch": 1, "step": 3, "loss": 2.5, "ts": ' in (tmp_path / "steps.jsonl").read_text()


# -- configs ---------------------------------------------------------------------


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO))
                                        for p in (REPO / "hparams").rglob("*.yaml")))
def test_every_yaml_loads_like_jax(path):
    """All 11 YAMLs, with overrides in three stanzas: every field of the
    port's stanzas equals the JAX package's, and so do name, seed and the
    output folder."""
    overrides = {"data.output_folder": "out", "seed": 7, "train.lr": 0.0005}
    ours = loader.load_config(str(REPO / path), overrides)
    theirs = jax_loader.load_config(str(REPO / path), overrides)
    for stanza in ("frontend", "train", "specaug", "data", "decode"):
        assert dataclasses.asdict(getattr(ours, stanza)) == \
            dataclasses.asdict(getattr(theirs, stanza)), stanza

    def same_fields(a, b):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if dataclasses.is_dataclass(va):
                same_fields(va, vb)
            else:
                assert va == vb, f.name

    same_fields(ours.model, theirs.model)
    assert (ours.name, ours.seed, ours.output_folder) == \
        (theirs.name, theirs.seed, theirs.output_folder)


def test_parallel_stanza_is_refused():
    with pytest.raises(NotImplementedError, match="parallel"):
        loader.load_config(str(REPO / "hparams/CTC/conmamba_small.yaml"),
                           {"parallel.tensor_parallel": 2})


def test_native_library_is_the_ports_own_build():
    """The decoder and resamplers load from the port's build directory,
    never from the JAX package's native directory."""
    from mamba_asr_torch.native import build

    path = build.library_path()
    assert path.is_relative_to(REPO / "build" / "mamba_asr_torch" / "native")
    assert build.flac_lib()._name == str(path)
