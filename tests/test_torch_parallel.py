"""The port's multi-process pieces that run in one process, against the
JAX package where it has them (no spawned ranks; those are in
tests/test_torch_distributed.py).

- make_bucket_plan(batch_divisor) and the sampler equal JAX's; each
  process shard of BucketedLoader equals JAX's row for row (ids, lengths,
  weights and the audio speed perturbation gives), the shards concatenate
  to the single loader's batch, and an indivisible process count raises
  (JAX's tests/test_multiprocess.py:130-188).
- The parallel stanza loads with JAX's keys and defaults; tensor
  parallelism with sp or pp (which JAX runs, the port not yet), sp on a
  Conformer and sp with dynamic chunks raise, and
  pipeline parallelism where JAX asserts against it: not ConMamba,
  without scan_layers, layers the stages do not divide, with sp, with
  dynamic chunks.
- The grid: make_mesh's (data, model, seq, pipe) layout and refusal (more
  stages or model ranks than ranks), initialize's refusals (no group is joined), the sp ops on a
  one-rank axis equal the plain ops.
- A world of one gloo rank: one step through the port's collectives
  equals the plain step bit for bit.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mamba_asr_tpu.configs import loader as jax_loader
from mamba_asr_tpu.data import batching as jax_batching
from mamba_asr_tpu.data import dataset as jax_dataset
from mamba_asr_tpu.data import librispeech as jax_libri
from mamba_asr_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer

from mamba_asr_torch.configs import loader
from mamba_asr_torch.data import batching, dataset
from mamba_asr_torch.data.tokenizer import CharTokenizer
from mamba_asr_torch.ops.causal_conv1d import causal_conv1d
from mamba_asr_torch.ops.selective_scan import selective_scan
from mamba_asr_torch.parallel import distributed, mesh, sequence
from mamba_asr_torch.training import trainer
from tests._jax_native import jax_native  # noqa: F401 (the fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "hparams", "CTC", "conmamba_small.yaml")

torch.set_num_threads(1)
# The JAX package's native libraries, built and loaded without racing its tests.
pytestmark = pytest.mark.usefixtures("jax_native")


# -- loader -------------------------------------------------------------------


@pytest.mark.parametrize("divisor", [1, 4, 3, 8])
def test_bucket_plan_matches_jax(divisor):
    rng = np.random.default_rng(divisor)
    durs = rng.uniform(0.5, 20.0, size=200)
    labs = rng.integers(5, 300, size=200)
    kw = dict(num_buckets=6, max_batch_seconds=60.0, max_batch_ex=16, batch_divisor=divisor)
    ours = batching.make_bucket_plan(durs, labs, **kw)
    theirs = jax_batching.make_bucket_plan(durs, labs, **kw)
    assert [dataclasses.astuple(b) for b in ours.buckets] == \
        [dataclasses.astuple(b) for b in theirs.buckets]
    assert all(b.batch_size % divisor == 0 for b in ours.buckets)


@pytest.mark.parametrize("divisor", [1, 2])
def test_bucket_sampler_matches_jax(divisor):
    durs = np.random.default_rng(1).uniform(1.0, 9.0, size=37)
    plan = batching.make_bucket_plan(durs, [10] * 37, num_buckets=3, max_batch_seconds=30.0,
                                     batch_divisor=divisor)
    ours = batching.BucketSampler(durs, plan, seed=4)
    theirs = jax_batching.BucketSampler(durs, plan, seed=4)
    assert list(ours.epoch(2)) == [tuple(b) for b in theirs.epoch(2)]
    assert ours.num_batches() == theirs.num_batches()
    # The partial batches are padded with repeats, never dropped.
    assert any(real < len(idx) for _, idx, real in ours.epoch(2))
    assert sorted({i for _, idx, _ in ours.epoch(2) for i in idx}) == list(range(37))


def _make_corpus(root):
    """6 utterances of 0.25 to 0.5 s (tests/test_multiprocess.py's)."""
    from mamba_asr_tpu.data.audio import write_wav

    rng = np.random.default_rng(0)
    words = ["HELLO", "WORLD", "GOOD", "DAY", "CAT", "DOG"]
    d = os.path.join(root, "train-clean-100", "1", "2")
    os.makedirs(d, exist_ok=True)
    lines = []
    for i in range(6):
        utt = f"1-2-{i:04d}"
        wav = rng.normal(0, 0.1, size=int(rng.integers(4000, 8000)))
        write_wav(os.path.join(d, utt + ".wav"), wav.astype(np.float32), 16000)
        lines.append(f"{utt} {' '.join(rng.choice(words, size=3))}")
    with open(os.path.join(d, "1-2.trans.txt"), "w") as f:
        f.write("\n".join(lines))


@pytest.fixture(scope="module")
def train_csv(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp_corpus")
    corpus = str(root / "LibriSpeech")
    _make_corpus(corpus)
    save = str(root / "manifests")
    jax_libri.prepare_librispeech(corpus, save, tr_splits=("train-clean-100",),
                                  merge_lst=("train-clean-100",), merge_name="train.csv")
    return os.path.join(save, "train.csv")


def _loaders(csv_path, pi, pc, divisor=4):
    kw = dict(num_buckets=2, max_batch_seconds=4.0, shuffle=True, speed_perturb=True,
              seed=5, batch_divisor=divisor, num_workers=1, process_index=pi,
              process_count=pc)
    chars = list("ABCDEFGHIJKLMNOPQRSTUVWXYZ ")
    ours = dataset.BucketedLoader(dataset.ASRDataset.from_csv(csv_path, CharTokenizer(chars)),
                                  **kw)
    theirs = jax_dataset.BucketedLoader(
        jax_dataset.ASRDataset.from_csv(csv_path, JaxCharTokenizer(chars)), **kw)
    return ours, theirs


KEYS = ("wav", "wav_lens", "tokens", "token_lens", "weight", "tokens_bos", "tokens_eos",
        "eos_lens")


def test_process_shards_match_jax_and_partition_the_batch(train_csv):
    full = list(_loaders(train_csv, 0, 1)[0].epoch(3))
    shards = []
    for pi in (0, 1):
        ours, theirs = _loaders(train_csv, pi, 2)
        got, want = list(ours.epoch(3)), list(theirs.epoch(3))
        assert len(got) == len(want) == len(full) > 0
        for a, b in zip(got, want):
            for key in KEYS:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{pi} {key}")
            assert a["ids"] == b["ids"] and a["bucket"] == b["bucket"]
        shards.append(got)
    for whole, a, b in zip(full, *shards):
        for key in KEYS:
            np.testing.assert_array_equal(np.concatenate([a[key], b[key]]), whole[key],
                                          err_msg=key)
        assert a["ids"] + b["ids"] == whole["ids"]
    # Partial batches give the two processes unequal real rows somewhere.
    assert any(a["weight"].sum() != b["weight"].sum() for a, b in zip(*shards))


def test_loader_rejects_indivisible_process_count(train_csv):
    ours, _ = _loaders(train_csv, 0, 2, divisor=3)
    with pytest.raises(ValueError, match="not divisible"):
        list(ours.epoch(0))
    with pytest.raises(ValueError, match="process_index"):
        _loaders(train_csv, 2, 2)


# -- config -------------------------------------------------------------------


def test_parallel_stanza_loads_like_jax():
    over = {"parallel.sequence_parallel": 2, "parallel.pipeline_microbatches": 8}
    ours = loader.load_config(YAML, over).parallel
    theirs = jax_loader.load_config(YAML, over).parallel
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(loader.ParallelConfig()) == \
        dataclasses.asdict(jax_loader.ParallelConfig())


@pytest.mark.parametrize("yaml,over,err,match", [
    ("CTC/conmamba_small.yaml", {"parallel.tensor_parallel": 2,
                                 "parallel.sequence_parallel": 2}, ValueError, "item 16"),
    ("CTC/conmamba_small.yaml", {"parallel.tensor_parallel": 2, "parallel.pipeline_stages": 2,
                                 "model.scan_layers": True}, ValueError, "cannot combine"),
    ("CTC/conmamba_small.yaml", {"parallel.pipeline_stages": 2}, ValueError, "scan_layers"),
    ("CTC/conformer_large.yaml", {"parallel.pipeline_stages": 2, "model.scan_layers": True},
     ValueError, "ConMamba"),
    ("CTC/conmamba_small.yaml", {"parallel.pipeline_stages": 5, "model.scan_layers": True},
     ValueError, "not divisible into 5 pipeline stages"),
    ("CTC/conmamba_small.yaml", {"parallel.pipeline_stages": 2, "model.scan_layers": True,
                                 "parallel.sequence_parallel": 2}, ValueError, "cannot combine"),
    ("CTC/conmamba_small.yaml", {"parallel.pipeline_stages": 2, "model.scan_layers": True,
                                 "train.dynchunk_size": 16}, ValueError, "dynamic-chunk"),
    ("CTC/conformer_large.yaml", {"parallel.sequence_parallel": 2}, ValueError, "ConMamba"),
    ("CTC/conmamba_small.yaml", {"parallel.sequence_parallel": 2, "train.dynchunk_size": 16},
     ValueError, "dynamic-chunk"),
])
def test_parallel_stanza_refusals(yaml, over, err, match):
    with pytest.raises(err, match=match):
        loader.load_config(os.path.join(REPO, "hparams", yaml), over)


# -- the grid, the runtime and the sp ops in one process --------------------------


def test_single_process_mesh_and_refusals():
    m = mesh.make_mesh()
    assert (m.data.size, m.seq.size, m.world.size) == (1, 1, 1)
    assert m.data.group is None and m.is_main_process()
    assert (m.pipe.size, m.pipe.index, m.pipe.group) == (1, 0, None)
    with pytest.raises(ValueError, match="does not fit"):
        mesh.make_mesh(seq=2)
    with pytest.raises(ValueError, match="does not fit"):  # more stages than ranks
        mesh.make_mesh(pipe=2)
    with pytest.raises(ValueError, match="does not fit"):  # more model ranks than ranks
        mesh.make_mesh(model=2)
    assert (m.model.size, m.model.index, m.model.group) == (1, 0, None)
    # (data, model, seq, pipe) = (2, 2, 1, 1), JAX's order: rank = data * 2 + model.
    assert mesh._lines((2, 2, 1, 1), 1) == [[0, 1], [2, 3]]
    assert mesh._lines((2, 2, 1, 1), 0) == [[0, 2], [1, 3]]
    # The data-major layout of a 2 x 3 grid.
    assert mesh._lines((2, 3), 1) == [[0, 1, 2], [3, 4, 5]]
    assert mesh._lines((2, 3), 0) == [[0, 3], [1, 4], [2, 5]]
    # (data, seq, pipe) = (2, 1, 2), pipe innermost as JAX orders its devices:
    # rank = data_index * 2 + pipe_index.
    assert mesh._lines((2, 1, 2), 2) == [[0, 1], [2, 3]]
    assert mesh._lines((2, 1, 2), 0) == [[0, 2], [1, 3]]


def test_initialize_refuses_before_joining(monkeypatch):
    for k in ("MASR_COORDINATOR", "MASR_NUM_PROCESSES", "MASR_PROCESS_ID", "MASTER_ADDR",
              "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASR_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="MASR_COORDINATOR"):
        distributed.initialize(device="cpu")
    with pytest.raises(ValueError, match="MASR_BACKEND=gloo"):
        distributed.initialize("localhost:1", 2, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="nccl or gloo"):
        distributed.initialize("localhost:1", 2, 0, backend="mpi", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="MASR_BACKEND=gloo"):
        distributed.initialize("localhost:1", 2, 0, backend="nccl", device="cuda:0")
    with pytest.raises(RuntimeError, match="does not exist"):
        distributed.initialize("localhost:1", 2, 1, backend="gloo")
    assert not distributed.is_initialized()


def test_fold_seed_keeps_rank_zero():
    assert trainer.fold_seed(3407, 0) == trainer.fold_seed(3407, 0, 0) == 3407
    seeds = {trainer.fold_seed(3407, d, s) for d in range(3) for s in range(3)}
    assert len(seeds) == 9


def test_sp_ops_on_one_rank_are_the_plain_ops():
    rng = np.random.default_rng(0)
    u, dt, z = (torch.tensor(rng.normal(size=(2, 9, 4)), dtype=torch.float32) for _ in "udz")
    a = -torch.exp(torch.tensor(rng.normal(size=(4, 3)), dtype=torch.float32))
    b, c = (torch.tensor(rng.normal(size=(2, 9, 3)), dtype=torch.float32) for _ in "bc")
    one = mesh.make_mesh().seq
    out = sequence.sp_selective_scan(u, dt, a, b, c, z=z, delta_softplus=True, axis=one,
                                     reverse=True)
    ref = selective_scan(u.flip(1), dt.flip(1), a, b.flip(1), c.flip(1), z=z.flip(1),
                         delta_softplus=True).flip(1)
    assert torch.equal(out, ref)
    w = torch.tensor(rng.normal(size=(4, 4)), dtype=torch.float32)
    assert torch.equal(sequence.sp_causal_conv1d(u, w, axis=one), causal_conv1d(u, w))
    halo = sequence.sp_halo_exchange(u, 2, 1, one)
    assert halo.shape == (2, 12, 4) and torch.equal(halo[:, 2:11], u)
    assert not halo[:, :2].any() and not halo[:, 11:].any()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_world_of_one_step_is_the_plain_step_bit_for_bit():
    """One gloo rank: the mesh step (global weight sum, the normaliser's
    gather, the flat gradient all-reduce, the metrics' reduce) equals the
    plain step exactly, over 2 micro-steps and an update."""
    exp = loader.load_config(YAML, {"model.d_model": 16, "model.num_encoder_layers": 1,
                                    "model.d_ffn": 16, "model.compute_dtype": "float32",
                                    "model.mamba.d_state": 4, "frontend.n_mels": 20,
                                    "model.n_mels": 20, "train.grad_accumulation_factor": 2})
    rng = np.random.default_rng(2)
    batch = {"wav": rng.normal(0, 0.1, (3, 16000)).astype(np.float32),
             "wav_lens": np.array([16000, 12000, 16000], np.int32),
             "tokens": rng.integers(1, 30, (3, 8)).astype(np.int32),
             "token_lens": np.array([8, 6, 7], np.int32),
             "weight": np.array([1, 1, 0], np.float32)}
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        runs = []
        for grid in (None, mesh.make_mesh()):
            tr = trainer.Trainer(exp.model, exp.frontend, exp.train, exp.specaug,
                                 device="cpu", mesh=grid)
            ms = [tr.train_step(batch) for _ in range(2)]
            runs.append((ms, [p.detach().clone() for p in tr.model.parameters()],
                         list(tr.normalizer)))
        assert grid.world.group is not None  # the collectives ran
    finally:
        dist.destroy_process_group()
    (m0, p0, n0), (m1, p1, n1) = runs
    for a, b in zip(m0, m1):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(a, b) for a, b in zip(n0, n1))
