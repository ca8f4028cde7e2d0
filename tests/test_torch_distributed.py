"""The port's multi-process training with spawned gloo ranks on the CPU,
against the JAX package's sequence parallelism and against the port's
single-process step and CLI.

Each spawn starts its ranks with MASR_COORDINATOR / MASR_NUM_PROCESSES /
MASR_PROCESS_ID set, one thread each, under a timeout; the ranks run
tests/_torch_dist_worker.py, which imports the port only. The JAX sides
run here, under jax.shard_map over 2 of conftest's 8 CPU devices; inputs
are made with numpy from a seed, JAX weights cross through
models/params_import.py, and everything reaches the ranks in one file.

- The sp ops with 2 ranks: sp_selective_scan (out, h_last and the
  gradients of every input; reverse false and true, with and without h0),
  sp_causal_conv1d at k 4 in both directions, sp_halo_exchange: within
  2e-5 (outputs) and 3e-4 (gradients) of JAX's parallel/sequence.py.
- The sp 2 train step (the tiny config of tests/test_parallel_trainer.py,
  bidirectional) at a T' that divides and at one that does not: loss and
  every gradient against JAX's make_train_step(parallel=ParallelConfig(
  sequence_parallel=2)) and against the port's single-process step.
- The dp step, 2 ranks with unequal real rows, against the single-process
  step on the whole batch (loss, gradients, normaliser).
- `python -m mamba_asr_torch.train_ctc --distributed --device cpu` in 2
  processes against 1 process on the same bucket plan: per-step losses
  and a parameter fingerprint within rtol 1e-6 (JAX's
  tests/test_multiprocess.py), every rank with the same weights, rank 0
  the only writer of the save dir and the logs, and the checkpoints
  holding both ranks' generator states.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from mamba_asr_tpu.configs.loader import ParallelConfig as JaxParallelConfig
from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.models import mamba as jax_mamba
from mamba_asr_tpu.parallel import mesh as jax_mesh
from mamba_asr_tpu.parallel import sequence as jax_seq
from mamba_asr_tpu.training import normalizer as jax_norm
from mamba_asr_tpu.training import trainer as jax_trainer

from mamba_asr_torch.configs import loader
from mamba_asr_torch.models import asr, mamba
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.training import trainer
from tests._beside import beside

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
SPAWN_TIMEOUT_S = 240
OUT_TOL, GRAD_TOL = 2e-5, 3e-4

torch.set_num_threads(1)

JAX_CFG = jax_asr.ASRConfig(
    vocab_size=9, n_mels=20, d_model=16, nhead=2, num_encoder_layers=2, num_decoder_layers=0,
    d_ffn=16, dropout=0.0, encoder_module="conmamba", kernel_size=7, bidirectional=True,
    scan_layers=True, mamba=jax_mamba.MambaConfig(d_state=4, scan_impl="xla"),
    compute_dtype="float32")
JAX_FE = jax_trainer.FrontendConfig(n_fft=256, n_mels=20)
JAX_TRAIN = jax_trainer.TrainConfig(grad_accumulation_factor=2, warmup_steps=10)
SP_WAVS = {"sp_divides": 160 * 63, "sp_pads": 160 * 74}  # T' 16 and 19 over 2 shards
SCAN_CASES = [(rev, h0) for rev in (False, True) for h0 in (False, True)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(args, nproc, cwd):
    """Run the worker in `nproc` ranks (1: a single process, no MASR_*);
    every rank must exit 0 within SPAWN_TIMEOUT_S, or all are killed."""
    return finish(start(args, nproc, cwd))


def start(args, nproc, cwd):
    env = {k: v for k, v in os.environ.items() if not k.startswith("MASR_")}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", MASR_TIMEOUT_S="120")
    port = _free_port()
    procs = []
    for rank in range(nproc):
        penv = dict(env)
        if nproc > 1:
            penv.update(MASR_COORDINATOR=f"localhost:{port}", MASR_NUM_PROCESSES=str(nproc),
                        MASR_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, WORKER, *args], env=penv, cwd=cwd,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def finish(procs):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} rc {p.returncode}\n{log[-4000:]}"
    return logs


def _close(got, ref, rtol, atol_frac, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    atol = atol_frac * max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


def _seq_mesh():
    return Mesh(np.array(jax.devices()[:2]), ("seq",))


# -- the JAX sides -------------------------------------------------------------


def _scan_case(reverse, with_h0, seed):
    rng = np.random.default_rng(seed)
    b, t, d, n = 2, 16, 8, 4

    def arr(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    inputs = {"u": arr(b, t, d, scale=0.5), "delta": arr(b, t, d, scale=0.3),
              "A": -np.exp(arr(d, n, scale=0.3)), "B": arr(b, t, n), "C": arr(b, t, n),
              "D": arr(d), "z": arr(b, t, d), "delta_bias": arr(d, scale=0.1)}
    if with_h0:
        inputs["h0"] = arr(b, d, n, scale=0.3)
    cot, cot_h = arr(b, t, d), arr(b, d, n)
    names = list(inputs)
    spec_t = P(None, "seq", None)
    in_specs = tuple(spec_t if k in ("u", "delta", "B", "C", "z") else P() for k in names)

    def loss(*vals):
        kw = dict(zip(names, vals))

        def body(*vals):
            a = dict(zip(names, vals))
            return jax_seq.sp_selective_scan(
                a["u"], a["delta"], a["A"], a["B"], a["C"], a["D"], a["z"], a["delta_bias"],
                delta_softplus=True, h0=a.get("h0"), return_last_state=True,
                axis_name="seq", reverse=reverse)

        out, h = jax.shard_map(body, mesh=_seq_mesh(), in_specs=in_specs,
                               out_specs=(spec_t, P()))(*[kw[k] for k in names])
        return jnp.sum(out * cot) + jnp.sum(h * cot_h), (out, h)

    def ref():
        grads, (out, h) = jax.jit(jax.grad(loss, argnums=tuple(range(len(names))),
                                           has_aux=True))(*[jnp.asarray(inputs[k]) for k in names])
        return {"out": np.asarray(out), "h": np.asarray(h),
                "grads": {k: np.asarray(g) for k, g in zip(names, grads)}}

    port = {"inputs": {k: torch.from_numpy(v) for k, v in inputs.items()},
            "cot": torch.from_numpy(cot), "cot_h": torch.from_numpy(cot_h), "reverse": reverse}
    return port, ref


def _conv_case(reverse, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 12, 6)).astype(np.float32)
    w = (rng.normal(size=(4, 6)) * 0.5).astype(np.float32)
    b = (rng.normal(size=(6,)) * 0.1).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    spec_t = P(None, "seq", None)

    def loss(x, w, b):
        out = jax.shard_map(
            lambda x, w, b: jax_seq.sp_causal_conv1d(x, w, b, axis_name="seq", reverse=reverse),
            mesh=_seq_mesh(), in_specs=(spec_t, P(), P()), out_specs=spec_t)(x, w, b)
        return jnp.sum(out * cot), out

    def ref():
        (gx, gw, gb), out = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(x, w, b)
        return {"out": np.asarray(out),
                "grads": {"x": np.asarray(gx), "w": np.asarray(gw), "b": np.asarray(gb)}}

    port = {"x": torch.from_numpy(x), "w": torch.from_numpy(w), "b": torch.from_numpy(b),
            "cot": torch.from_numpy(cot), "reverse": reverse}
    return port, ref


def _halo_case(seed, left=3, right=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 8, 3)).astype(np.float32)
    cot = rng.normal(size=(2, 2, left + 4 + right, 3)).astype(np.float32)  # per rank
    spec_t = P(None, "seq", None)

    def loss(x):
        out = jax.shard_map(lambda x: jax_seq.sp_halo_exchange(x, left, right, "seq"),
                            mesh=_seq_mesh(), in_specs=spec_t, out_specs=spec_t)(x)
        return jnp.sum(out * jnp.concatenate(list(cot), axis=1)), out

    def ref():
        gx, out = jax.jit(jax.grad(loss, has_aux=True))(x)
        return {"out": np.split(np.asarray(out), 2, axis=1), "x_grad": np.asarray(gx)}

    port = {"x": torch.from_numpy(x), "cot": torch.from_numpy(cot), "left": left,
            "right": right}
    return port, ref


def _seeded_params(seed=0, cfg=JAX_CFG):
    """JAX params of `cfg` from jax.eval_shape filled from numpy (no
    compile): kernels N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.05^2),
    the rest N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jax_asr.ASRModel(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 20)), jnp.array([64]))["params"]

    def fill(path, leaf):
        x = rng.normal(size=leaf.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return x / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return np.float32(path[-1].key == "scale") + np.float32(0.05) * x

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batch(bsz, wav_n, seed, wav_lens=None, weight=None):
    rng = np.random.default_rng(seed)
    lens = np.full((bsz,), wav_n, np.int32) if wav_lens is None else np.asarray(wav_lens, np.int32)
    wav = rng.normal(0, 0.1, size=(bsz, wav_n)).astype(np.float32)
    wav[np.arange(wav_n)[None, :] >= lens[:, None]] = 0.0
    return {"wav": wav, "wav_lens": lens,
            "tokens": rng.integers(3, 9, size=(bsz, 6)).astype(np.int32),
            "token_lens": np.array([6, 5, 4, 6][:bsz], np.int32),
            "weight": np.ones((bsz,), np.float32) if weight is None
            else np.asarray(weight, np.float32)}


def _port_cfg(cfg=JAX_CFG):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(asr.ASRConfig)}
    fields["mamba"] = mamba.MambaConfig(**{
        f.name: getattr(cfg.mamba, f.name) for f in dataclasses.fields(mamba.MambaConfig)})
    return asr.ASRConfig(**fields)


def _jax_sp_step(params, batch):
    """(loss, gradients in the port's names) of JAX's sp 2 step."""
    model = jax_asr.ASRModel(JAX_CFG)
    tx = jax_trainer.make_optimizer(JAX_TRAIN)
    state = jax_trainer.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=tx.init(params),
        normalizer=jax_norm.init_normalizer(20), step=jnp.zeros((), jnp.int32))
    mesh = jax_mesh.make_mesh(data=1, model=1, seq=2, pipe=1, devices=jax.devices()[:2])
    step = jax_trainer.make_train_step(
        model, tx, JAX_FE, JAX_TRAIN, jax_trainer.SpecAugmentConfig(enabled=False),
        parallel=JaxParallelConfig(sequence_parallel=2), mesh=mesh)
    state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.PRNGKey(1), jnp.bool_(True))
    acc = jax.tree_util.tree_map(np.asarray, state.opt_state.acc_grads)
    return float(m["loss"]), pi.import_asr_params(acc, _port_cfg())


def _port_plain_step(state_dict, batch, pad_to=1):
    """The port's single-process step; pad_to: the encoder stack sees T'
    padded at the end to a multiple of it and its output cropped back, as
    under sequence parallelism over pad_to ranks."""
    tr = trainer.Trainer(_port_cfg(), loader.FrontendConfig(n_fft=256, n_mels=20),
                         trainer.TrainConfig(**dataclasses.asdict(JAX_TRAIN)),
                         trainer.SpecAugmentConfig(enabled=False), state_dict=state_dict,
                         device="cpu")
    stack = tr.model.encoder.forward

    def padded(x, chunk_size=None):
        t = x.shape[1]
        return stack(torch.nn.functional.pad(x, (0, 0, 0, -t % pad_to)), chunk_size)[:, :t]

    tr.model.encoder.forward = padded
    m = tr.train_step(batch)
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.clone() for n, p in tr.model.named_parameters()},
            [t.clone() for t in tr.normalizer])


def _op_cases():
    """(the sp ops' inputs for the ranks, {name: JAX reference thunk})."""
    case, thunks = {"scan": {}, "conv": {}}, {}
    for i, (rev, h0) in enumerate(SCAN_CASES):
        name = f"scan_rev{int(rev)}_h0{int(h0)}"
        case["scan"][name], thunks[name] = _scan_case(rev, h0, seed=10 + i)
    for i, rev in enumerate((False, True)):
        name = f"conv_rev{int(rev)}"
        case["conv"][name], thunks[name] = _conv_case(rev, seed=20 + i)
    case["halo"], thunks["halo"] = _halo_case(seed=30)
    return case, thunks


def _op_refs():
    return {name: thunk() for name, thunk in _op_cases()[1].items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 2 ranks' results (one spawn), and meanwhile the JAX references
    and the port's single-process steps."""
    work = tmp_path_factory.mktemp("dist_ops")
    case = _op_cases()[0]

    params = _seeded_params()
    state_dict = pi.import_asr_params(jax.tree_util.tree_map(np.asarray, params), _port_cfg())
    case["step"] = {"cfg": _port_cfg(), "frontend": loader.FrontendConfig(n_fft=256, n_mels=20),
                    "train": trainer.TrainConfig(**dataclasses.asdict(JAX_TRAIN)),
                    "specaug": trainer.SpecAugmentConfig(enabled=False),
                    "state_dict": state_dict}
    case["sp_batches"] = {name: _batch(2, n, seed=40 + i) for i, (name, n) in
                          enumerate(SP_WAVS.items())}
    n = SP_WAVS["sp_divides"]
    # 4 rows, 3 real and unequal lengths: rank 0 holds 2 real rows, rank 1 one.
    case["dp_batch"] = _batch(4, n, seed=50, wav_lens=[n, n - 900, n - 1700, n],
                              weight=[1, 1, 1, 0])
    torch.save(case, work / "case.pt")
    procs = start(["ops", str(work / "case.pt"), str(work)], 2, REPO)
    # The references in three processes: the op cases and the sp step at
    # T' 19 each in a child, the sp step at T' 16 and the plain steps here.
    ops = beside(work, "tests.test_torch_distributed", "_op_refs")
    pads = beside(work, "tests.test_torch_distributed", "_jax_sp_step", params,
                  case["sp_batches"]["sp_pads"])
    try:
        refs = {}
        for name, batch in case["sp_batches"].items():
            refs[name] = {"jax": pads() if name == "sp_pads" else _jax_sp_step(params, batch),
                          "plain": _port_plain_step(state_dict, batch, pad_to=2)}
        refs.update(ops())
        refs["dp"] = {"plain": _port_plain_step(state_dict, case["dp_batch"])}
    finally:
        finish(procs)
    got = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert [g["world"] for g in got] == [2, 2]
    return got, refs


@pytest.mark.parametrize("rev,h0", SCAN_CASES)
def test_sp_selective_scan_matches_jax(ranks, rev, h0):
    got, refs = ranks
    name = f"scan_rev{int(rev)}_h0{int(h0)}"
    ref = refs[name]
    out = torch.cat([g[name]["out"] for g in got], dim=1)
    _close(out, ref["out"], OUT_TOL, OUT_TOL, "out")
    for g in got:
        _close(g[name]["h"], ref["h"], OUT_TOL, OUT_TOL, "h_last")
    for k, want in ref["grads"].items():
        if k in ("u", "delta", "B", "C", "z"):
            have = torch.cat([g[name]["grads"][k] for g in got], dim=1)
        else:
            have = got[0][name]["grads"][k]
            assert torch.equal(have, got[1][name]["grads"][k]), k
        _close(have, want, GRAD_TOL, GRAD_TOL, f"d{k}")


@pytest.mark.parametrize("rev", [False, True])
def test_sp_causal_conv1d_matches_jax(ranks, rev):
    got, refs = ranks
    name = f"conv_rev{int(rev)}"
    _close(torch.cat([g[name]["out"] for g in got], dim=1), refs[name]["out"], OUT_TOL,
           OUT_TOL, "out")
    _close(torch.cat([g[name]["grads"]["x"] for g in got], dim=1),
           refs[name]["grads"]["x"], GRAD_TOL, GRAD_TOL, "dx")
    for k in ("w", "b"):
        _close(got[0][name]["grads"][k], refs[name]["grads"][k], GRAD_TOL, GRAD_TOL, f"d{k}")


def test_sp_halo_exchange_matches_jax(ranks):
    got, refs = ranks
    for r, g in enumerate(got):
        _close(g["halo"]["out"], refs["halo"]["out"][r], 0.0, 0.0, f"rank {r}")
    _close(torch.cat([g["halo"]["x_grad"] for g in got], dim=1), refs["halo"]["x_grad"],
           1e-6, 1e-6, "the reverse exchange")


def _grads_close(have, want, what):
    assert set(have) == set(want), what
    for name, ref in want.items():
        _close(have[name], ref, 1e-4, 1e-5, f"{what}: {name}")


@pytest.mark.parametrize("name", list(SP_WAVS))
def test_sp_step_matches_jax_and_the_plain_step(ranks, name):
    """Both ranks hold the global loss and the same summed gradients: a
    missing 1 / n_seq would double the head's gradients, a missing sum
    would halve the stack's. At T' 19 the plain step's stack sees T'
    padded to 20, as JAX's sp step and the port's do (the bidirectional
    scans read the padded frame)."""
    got, refs = ranks
    jax_loss, jax_grads = refs[name]["jax"]
    plain_m, plain_grads, _ = refs[name]["plain"]
    for r, g in enumerate(got):
        m = g[name]["metrics"]
        _close(m["loss"], jax_loss, 1e-5, 0.0, f"rank {r} loss vs JAX")
        _close(m["loss"], plain_m["loss"], 1e-5, 0.0, f"rank {r} loss vs plain")
        _grads_close(g[name]["grads"], jax_grads, f"rank {r} vs JAX sp")
        _grads_close(g[name]["grads"], plain_grads, f"rank {r} vs the plain step")


def test_dp_step_with_unequal_rows_matches_the_plain_step(ranks):
    """Ranks holding 2 and 1 real rows: the losses divide by the global
    weight (3), not by each rank's, and the normaliser merges both ranks'
    frames."""
    got, refs = ranks
    plain_m, plain_grads, plain_norm = refs["dp"]["plain"]
    for r, g in enumerate(got):
        for key in ("loss", "loss_ctc", "grad_norm"):
            _close(g["dp"]["metrics"][key], plain_m[key], 1e-5, 0.0, f"rank {r} {key}")
        _grads_close(g["dp"]["grads"], plain_grads, f"rank {r} dp")
        for a, b in zip(g["dp"]["normalizer"], plain_norm):
            _close(a, b, 1e-5, 1e-6, f"rank {r} normaliser")


# -- the CLI, 2 processes against 1 ----------------------------------------------


CLI_OVERRIDES = [
    "--data.train_splits", "[train-clean-100]", "--data.dev_splits", "[dev-clean]",
    "--data.test_splits", "[]", "--data.speed_perturb", "true", "--model.d_model", "16",
    "--model.num_encoder_layers", "1", "--model.d_ffn", "16", "--model.compute_dtype",
    "float32", "--model.dropout", "0.0", "--model.mamba.d_state", "4", "--frontend.n_mels",
    "20", "--model.n_mels", "20", "--train.number_of_epochs", "2",
    "--train.grad_accumulation_factor", "1", "--specaug.enabled", "false",
    "--data.num_buckets", "2", "--data.max_batch_seconds", "4.0", "--data.num_workers", "1",
    "--data.max_batch_ex", "8",
]  # tests/_mp_train_worker.py's, and batches of 8 rows: an even plan for 1 process too


def _make_corpus(root):
    """6 + 6 utterances of 0.25 to 0.5 s (tests/test_multiprocess.py's)."""
    from mamba_asr_torch.data.audio import write_wav

    rng = np.random.default_rng(0)
    words = ["HELLO", "WORLD", "GOOD", "DAY", "CAT", "DOG"]
    for split in ("train-clean-100", "dev-clean"):
        d = os.path.join(root, split, "1", "2")
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
def cli_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist_cli")
    corpus = str(work / "LibriSpeech")
    _make_corpus(corpus)
    yaml = os.path.join(REPO, "hparams", "CTC", "conmamba_small.yaml")
    runs, groups = {}, {}
    for nproc in (1, 2):  # both runs at once
        results = str(work / f"res{nproc}")
        argv = [yaml, "--device", "cpu", "--data.data_folder", corpus,
                "--data.output_folder", results] + CLI_OVERRIDES
        groups[nproc] = start(["cli", str(work / f"out{nproc}.json"), json.dumps(argv)],
                              nproc, REPO)
    for nproc in (1, 2):
        logs = finish(groups[nproc])
        out = str(work / f"out{nproc}.json")
        with open(out) as f:
            runs[nproc] = json.load(f)
        if nproc == 2:
            with open(out + ".1") as f:
                runs["rank1"] = json.load(f)
        runs[f"dir{nproc}"] = runs[nproc]["output_folder"]
        runs[f"logs{nproc}"] = logs
    return runs


def test_cli_two_processes_match_one(cli_runs):
    one, two = cli_runs[1], cli_runs[2]
    assert (one["world"], two["world"]) == (1, 2)
    assert one["plan"] == two["plan"], "the two runs must load the same bucket plan"
    assert len(one["loss"]) == len(two["loss"]) > 0
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(two["fingerprint"], one["fingerprint"], rtol=1e-6, atol=1e-8)
    assert cli_runs["rank1"]["fingerprint"] == two["fingerprint"], "ranks hold other weights"
    assert cli_runs["rank1"]["loss"] == two["loss"], "ranks logged other global losses"


def test_cli_rank0_alone_writes(cli_runs):
    """A rank that wrote would double a log's rows or the checkpoints: the
    2-process run's files are the 1-process run's, row for row."""
    def listing(d):
        save = os.path.join(d, "save")
        with open(os.path.join(d, "train_log.txt")) as f:
            rows = [r.split(", epoch_sec")[0] for r in f.read().splitlines()]
        with open(os.path.join(d, "steps.jsonl")) as f:
            steps = [(s["epoch"], s["step"]) for s in map(json.loads, f)]
        return rows, steps, len(os.listdir(save)), sorted(os.listdir(d))

    one, two = listing(cli_runs["dir1"]), listing(cli_runs["dir2"])
    assert two[0] == [r for r in one[0]] and len(two[0]) == 2, (one[0], two[0])
    assert two[1] == one[1], (one[1], two[1])
    assert two[2] == one[2] == 2, (one[2], two[2])
    assert two[3] == one[3]


def test_cli_checkpoint_holds_every_ranks_generators(cli_runs):
    save = os.path.join(cli_runs["dir2"], "save")
    ckpts = [c for c in sorted(os.listdir(save)) if c.startswith("ckpt_")]
    state = torch.load(os.path.join(save, ckpts[-1], "state.pt"), weights_only=True)
    assert len(state["rng"]) == 2
    rank0, rank1 = state["rng"]
    assert set(rank0) == set(rank1) == {"dropout", "specaug"}
    # Rank 1 is seeded from its data rank: its streams are its own.
    assert not torch.equal(rank0["dropout"], rank1["dropout"])
    assert not torch.equal(rank0["specaug"], rank1["specaug"])
    one = torch.load(os.path.join(cli_runs["dir1"], "save", sorted(
        c for c in os.listdir(os.path.join(cli_runs["dir1"], "save"))
        if c.startswith("ckpt_"))[-1], "state.pt"), weights_only=True)
    assert len(one["rng"]) == 1
    assert torch.equal(one["rng"][0]["specaug"], rank0["specaug"])
