"""Pipeline parallelism in the PyTorch port (parallel/pipeline.py,
parallel/encoder_parallel.py:pp_encoder_apply, the trainer's pp branch)
with 2 spawned gloo ranks on the CPU, against the JAX package's GPipe
schedule and against the port's single-process step.

One spawn of tests/_torch_dist_worker.py (`pp`) gives:
- `pipeline_apply` on JAX's toy stack (tanh(h @ w + b), 4 layers, 2 a
  stage; tests/test_pipeline.py:45-105): the forward at 1, 2 and 4
  microbatches and the gradients at 2, against JAX's pipeline_apply under
  shard_map over a 2-device pipe axis;
- the ConMamba stack (d_model 16, 2 layers, 1 a stage, dropout 0) at 2
  microbatches against JAX's pp_encoder_apply: output within 2e-5, the
  gradients of a fixed linear functional within 3e-4;
- the full train step (4 layers, 2 a stage), 2 micro-steps (accumulation
  1, so 2 updates), with
  and without remat, against the port's single-process step (loss rtol
  1e-5, parameters rtol 2e-4 atol 1e-5, as tests/test_parallel_trainer.py
  compares JAX's); the parameters both ranks hold bit-equal; remat bit-equal
  to the plain pp step;
- checkpoints both ways: the pp ranks' whole state (single-process layout)
  resumed in one process, and one process's resumed on the pp ranks, each
  a third micro-step against the uninterrupted single-process run;
- sequence parallelism with remat (dropout 0.1) bit-equal to sp alone.
Beside it, `python -m mamba_asr_torch.train_ctc --distributed --device cpu`
with `parallel.pipeline_stages 2` and `model.scan_layers true` in 2
processes (pipe 2) and in 4 (data 2 x pipe 2) against 1 process without
pp on the same bucket plan: per-step losses and a parameter fingerprint
within rtol 1e-5, rank 0's last checkpoint (written under pp) resumed by
a single-process loop and equal to the 1-process run's.
The optimizer's reading of an index-keyed state dict, whole and a
stage's share, and the Trainer's refusal of a pipe axis without a
microbatch count run in this process.
The refusals of the stanza are in tests/test_torch_parallel.py.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from mamba_asr_tpu.parallel import encoder_parallel as jax_ep
from mamba_asr_tpu.parallel import mesh as jax_mesh
from mamba_asr_tpu.parallel import pipeline as jax_pipe

from mamba_asr_torch.configs import loader
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.training import loop, trainer
from tests.test_torch_distributed import (
    CLI_OVERRIDES,
    JAX_CFG,
    REPO,
    _batch,
    _close,
    _make_corpus,
    _port_cfg,
    _seeded_params,
    finish,
    start,
)

torch.set_num_threads(1)

OUT_TOL, GRAD_TOL = 2e-5, 3e-4
TOY_LAYERS, TOY_D, TOY_B = 4, 8, 4
FWD_MICRO, GRAD_MICRO = (1, 2, 4), 2
STACK_LAYERS, STACK_MICRO = 2, 2  # JAX's grad of its pp stack compiles for ~9 s
TRAIN_LAYERS, TRAIN_MICRO = 4, 2
JAX_STACK = dataclasses.replace(JAX_CFG, num_encoder_layers=STACK_LAYERS)
JAX_TRAIN = dataclasses.replace(JAX_CFG, num_encoder_layers=TRAIN_LAYERS)
PP_FLAGS = ["--parallel.pipeline_stages", "2", "--parallel.pipeline_microbatches", "2",
            "--model.scan_layers", "true", "--model.num_encoder_layers", "2"]


def _pipe_mesh():
    return Mesh(np.array(jax.devices()[:2]), ("pipe",))


# -- the JAX sides ---------------------------------------------------------------


def _toy_case():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.5, size=(TOY_LAYERS, TOY_D, TOY_D)).astype(np.float32)
    b = rng.normal(0, 0.1, size=(TOY_LAYERS, TOY_D)).astype(np.float32)
    x = rng.normal(size=(TOY_B, 3, TOY_D)).astype(np.float32)
    tgt = rng.normal(size=(TOY_B, 3, TOY_D)).astype(np.float32)
    stage_fn = jax_pipe.stage_from_layer_fn(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]))

    def pp(stacked, x, m):
        return jax.shard_map(lambda sp, xx: jax_pipe.pipeline_apply(stage_fn, sp, xx, m),
                             mesh=_pipe_mesh(), in_specs=(P("pipe"), P()),
                             out_specs=P())(stacked, x)

    def ref():
        stacked = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
        fwd = {m: np.asarray(jax.jit(pp, static_argnums=2)(stacked, x, m)) for m in FWD_MICRO}

        def loss(stacked, x):
            return jnp.mean((pp(stacked, x, GRAD_MICRO) - tgt) ** 2)

        v, (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(stacked, jnp.asarray(x))
        return fwd, {"loss": float(v), "w": np.asarray(gp["w"]), "b": np.asarray(gp["b"]),
                     "x": np.asarray(gx)}

    port = {"w": torch.from_numpy(w), "b": torch.from_numpy(b), "x": torch.from_numpy(x),
            "tgt": torch.from_numpy(tgt), "forward_microbatches": FWD_MICRO,
            "grad_microbatches": GRAD_MICRO}
    return port, ref


def _stack_case():
    params = _seeded_params(cfg=JAX_STACK, seed=7)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(4, 12, JAX_STACK.d_model)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    mesh = jax_mesh.make_mesh(data=1, model=1, seq=1, pipe=2, devices=jax.devices()[:2])

    def ref():
        def loss(enc, x):
            y = jax_ep.pp_encoder_apply(JAX_STACK, enc, x, mesh, STACK_MICRO)
            return jnp.sum(y * cot), y

        (g_enc, g_x), y = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(
            params["encoder"], jnp.asarray(x))
        grads = jax.tree_util.tree_map(np.asarray, dict(params, encoder=g_enc))
        named = pi.import_asr_params(grads, _port_cfg(JAX_STACK))
        return {"out": np.asarray(y), "x": np.asarray(g_x),
                "grads": {k: v for k, v in named.items() if k.startswith("1.encoder.")}}

    state_dict = pi.import_asr_params(jax.tree_util.tree_map(np.asarray, params),
                                      _port_cfg(JAX_STACK))
    port = {"cfg": _port_cfg(JAX_STACK), "state_dict": state_dict, "x": torch.from_numpy(x),
            "cot": torch.from_numpy(cot), "microbatches": STACK_MICRO}
    return port, ref


# -- the port's single-process sides ---------------------------------------------


def _train_setup():
    cfg = dataclasses.replace(_port_cfg(JAX_TRAIN), scan_layers=True)
    frontend = loader.FrontendConfig(n_fft=256, n_mels=20)
    tcfg = trainer.TrainConfig(grad_accumulation_factor=1, warmup_steps=10)
    spec = trainer.SpecAugmentConfig(enabled=False)
    state = pi.import_asr_params(jax.tree_util.tree_map(np.asarray, _seeded_params(
        cfg=JAX_TRAIN, seed=9)), cfg)
    n = 160 * 63
    batches = [_batch(4, n, seed=60 + i, wav_lens=[n, n - 900, n, n - 1700]) for i in range(3)]
    return cfg, frontend, tcfg, spec, state, batches


def _single_run(setup, resume=None):
    """The port's single-process Trainer over the 3 batches, or from
    `resume`'s state (after 2) over the third: per micro-step its metrics
    and then its model state, optimizer state and normaliser."""
    cfg, frontend, tcfg, spec, state, batches = setup
    tr = trainer.Trainer(cfg, frontend, tcfg, spec, state_dict=state, device="cpu",
                         normalizer=None if resume is None else resume["normalizer"])
    if resume is not None:
        tr.load_model_state(resume["model_state"])
        tr.load_optimizer_state(resume["optimizer_state"])
        batches = batches[2:]
    out = []
    for b in batches:
        m = tr.train_step(b)
        out.append(({k: float(v) for k, v in m.items()}, tr.model_state(), tr.optimizer_state(),
                    list(tr.normalizer)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The pp ranks' results, the pp CLI in 2 processes and the plain CLI in
    1, all spawned at once; meanwhile the JAX references and the port's
    single-process steps."""
    work = tmp_path_factory.mktemp("pp")
    case, refs = {}, {}
    case["toy"], toy_ref = _toy_case()
    case["stack"], stack_ref = _stack_case()
    setup = _train_setup()
    cfg, frontend, tcfg, spec, state, batches = setup
    case["train"] = {
        "cfgs": {"pp": cfg, "pp_remat": dataclasses.replace(cfg, remat_layers=True)},
        "frontend": frontend, "train": tcfg, "specaug": spec, "state_dict": state,
        "batches": batches, "microbatches": TRAIN_MICRO,
        "sp_cfgs": {remat: dataclasses.replace(cfg, dropout=0.1, remat_layers=remat)
                    for remat in (False, True)}}
    torch.save(case, work / "case.pt")
    corpus = str(work / "LibriSpeech")
    _make_corpus(corpus)
    yaml = os.path.join(REPO, "hparams", "CTC", "conmamba_small.yaml")
    cli = {}
    for name, nproc, flags in (("one", 1, []), ("pp", 2, PP_FLAGS), ("grid", 4, PP_FLAGS)):
        argv = [yaml, "--device", "cpu", "--data.data_folder", corpus, "--data.output_folder",
                str(work / f"res_{name}")] + CLI_OVERRIDES + flags
        if name == "one":  # the same depth as the pp run
            argv += ["--model.num_encoder_layers", "2"]
        cli[name] = (str(work / f"{name}.json"), start(["cli", str(work / f"{name}.json"),
                                                        json.dumps(argv)], nproc, REPO))
    procs = start(["pp", str(work / "case.pt"), str(work)], 2, REPO)
    try:
        refs["toy_fwd"], refs["toy_grad"] = toy_ref()
        refs["stack"] = stack_ref()
        refs["single"] = _single_run(setup)
    finally:
        finish(procs)
        for _, group in cli.values():
            finish(group)
    got = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert [g["world"] for g in got] == [2, 2]
    outs = {}
    for name, (path, _) in cli.items():
        with open(path) as f:
            outs[name] = dict(json.load(f), results=str(work / f"res_{name}"))
    for name, nproc in (("pp", 2), ("grid", 4)):
        outs[f"{name}_ranks"] = []
        for r in range(1, nproc):
            with open(f"{cli[name][0]}.{r}") as f:
                outs[f"{name}_ranks"].append(json.load(f))
    return got, refs, outs


# -- pipeline_apply ----------------------------------------------------------------


@pytest.mark.parametrize("micro", FWD_MICRO)
def test_toy_forward_matches_jax(runs, micro):
    got, refs, _ = runs
    for g in got:
        _close(g["toy_fwd"][micro], refs["toy_fwd"][micro], 1e-6, 1e-6, f"M {micro}")


def test_toy_gradients_match_jax(runs):
    got, refs, _ = runs
    ref = refs["toy_grad"]
    assert [g["stage"] for g in got] == [[0, 1], [2, 3]]
    for g in got:
        _close(g["toy_grad"]["loss"], ref["loss"], 1e-6, 0.0, "loss")
        _close(g["toy_grad"]["x"], ref["x"], 1e-5, 1e-6, "dx")
    for k in ("w", "b"):  # each stage's own layers
        have = torch.cat([g["toy_grad"][k] for g in got])
        _close(have, ref[k], 1e-5, 1e-6, f"d{k}")


# -- pp_encoder_apply ----------------------------------------------------------------


def test_conmamba_stack_matches_jax_pp_encoder_apply(runs):
    got, refs, _ = runs
    ref = refs["stack"]
    for r, g in enumerate(got):
        _close(g["stack"]["out"], ref["out"], OUT_TOL, OUT_TOL, f"rank {r} out")
        _close(g["stack"]["x"], ref["x"], GRAD_TOL, GRAD_TOL, f"rank {r} dx")
    have = {**got[1]["stack"]["grads"], **got[0]["stack"]["grads"]}
    assert set(have) == set(ref["grads"])
    for name, want in ref["grads"].items():
        _close(have[name], want, GRAD_TOL, GRAD_TOL, name)
    # Each rank read its own stage's layers and the final LN, nothing else.
    per = STACK_LAYERS // 2
    for r, g in enumerate(got):
        assert {k.split(".")[3] for k in g["stack"]["grads"] if ".layers." in k} == \
            {str(i) for i in range(r * per, (r + 1) * per)}


# -- the train step ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["pp", "pp_remat"])
def test_pp_train_steps_match_the_single_process_steps(runs, name):
    got, refs, _ = runs
    metrics = [step[0] for step in refs["single"][:2]]
    model = refs["single"][1][1]
    for r, g in enumerate(got):
        for have, want in zip(g[name]["metrics"], metrics):
            _close(have["loss"], want["loss"], 1e-5, 0.0, f"rank {r} loss")
            assert have["updated"] == want["updated"] == 1.0
        for k, p in g[name]["params"].items():
            _close(p, model[k], 2e-4, 1e-5, f"rank {r} {k}")
        whole = g[name]["model_state"]
        assert whole.keys() == model.keys()
        for k, v in whole.items():
            _close(v, model[k], 2e-4, 1e-5, f"rank {r} whole {k}")
    assert all(g[name]["moments_kept"] for g in got), "optimizer_state changed the live state"
    held = set(got[0][name]["params"]) & set(got[1][name]["params"])
    assert len(held) < len(got[0][name]["params"])  # the stages' layers are not held twice
    for k in held:
        assert torch.equal(got[0][name]["params"][k], got[1][name]["params"][k]), k
    for k, v in got[0][name]["model_state"].items():
        assert torch.equal(v, got[1][name]["model_state"][k]), k
    if name == "pp_remat":
        for k, v in got[0]["pp"]["params"].items():
            assert torch.equal(v, got[0]["pp_remat"]["params"][k]), k


def test_pp_checkpoint_resumes_in_one_process_and_back(runs):
    got, refs, _ = runs
    setup = _train_setup()
    metrics3, model3, opt3, _ = refs["single"][2]
    # Written under pp (the ranks' gather), resumed in one process.
    saved = got[0]["pp"]
    assert saved["optimizer_state"].keys() == opt3.keys()
    for key in ("moments", "acc"):  # every parameter's entries, by name
        assert saved["optimizer_state"][key].keys() == opt3[key].keys()
    ((m, model, _, _),) = _single_run(setup, resume=saved)
    _close(m["loss"], metrics3["loss"], 1e-5, 0.0, "resumed loss")
    for k, v in model.items():
        _close(v, model3[k], 2e-4, 1e-5, f"resumed in one process: {k}")
    # Written in one process, resumed on the pp ranks.
    for r, g in enumerate(got):
        _close(g["resumed"]["metrics"]["loss"], metrics3["loss"], 1e-5, 0.0, f"rank {r}")
        for k, v in g["resumed"]["model_state"].items():
            _close(v, model3[k], 2e-4, 1e-5, f"resumed under pp, rank {r}: {k}")


def test_sp_with_remat_equals_sp(runs):
    got, _, _ = runs
    for g in got:
        a, b = g["sp_remat0"], g["sp_remat1"]
        assert a["metrics"] == b["metrics"]
        for k, v in a["grads"].items():
            assert torch.equal(v, b["grads"][k]), k


# -- the CLI -------------------------------------------------------------------------


def _cli_cfg(outs, name):
    over = loader.parse_overrides(CLI_OVERRIDES + ["--model.num_encoder_layers", "2"])
    over["data.output_folder"] = outs[name]["results"]
    return loader.load_config(os.path.join(REPO, "hparams", "CTC", "conmamba_small.yaml"), over)


def test_cli_pp_two_processes_match_one(runs):
    _check_cli_run(runs, "pp", 2, (1e-5, 1e-6))


def test_cli_pp_on_a_data_grid_matches_one(runs):
    """data 2 x pipe 2 over 4 processes: the batch divisor lcm(2 x 2
    microbatches, 4), each stage's gradients summed over the data axis.
    The data split changes the order of the gradients' sums, so the
    checkpoints compare at the train step's parameter tolerance."""
    _check_cli_run(runs, "grid", 4, (2e-4, 1e-5))


def _check_cli_run(runs, name, world, state_tol):
    _, _, outs = runs
    one, two = outs["one"], outs[name]
    assert (one["world"], two["world"]) == (1, world)
    assert one["plan"] == two["plan"], "the two runs must load the same bucket plan"
    assert len(one["loss"]) == len(two["loss"]) > 0
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(two["fingerprint"], one["fingerprint"], rtol=1e-5, atol=1e-8)
    for other in outs[f"{name}_ranks"]:
        assert other["fingerprint"] == two["fingerprint"], "ranks hold other weights"
        assert other["loss"] == two["loss"]
    # Rank 0's checkpoint of the pp run is whole: a single-process loop
    # resumes from it, equal to the 1-process run's last checkpoint.
    states = []
    for run in ("one", name):
        tr = loop.Trainer(_cli_cfg(outs, run), None, device="cpu")
        tr.init_state()
        assert tr.start_epoch == 3
        states.append(tr.step.model_state())
    for k, v in states[0].items():
        _close(states[1][k], v, *state_tol, k)


# -- the optimizer state ---------------------------------------------------------------


@pytest.mark.parametrize("held", ["whole", "stage"])
def test_optimizer_reads_index_keyed_state(held):
    """A state dict keyed by index, as the optimizer wrote it before its
    state was keyed by name, loads into the whole model's optimizer and
    into one holding a stage's share (the other layers on the meta
    device): the same state as the name-keyed dict gives."""
    from mamba_asr_torch.models.asr import ASRModel
    from mamba_asr_torch.training.optim import make_optimizer

    cfg = _port_cfg(JAX_TRAIN)
    tcfg = trainer.TrainConfig(grad_accumulation_factor=2, warmup_steps=10)
    torch.manual_seed(0)
    model = ASRModel(cfg)
    opt = make_optimizer(model, tcfg)
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):  # one update, then a micro-step accumulated
        for p in opt.params:
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
    named = opt.state_dict()
    indexed = {"adamw": opt.optimizer.state_dict(), "schedule": named["schedule"],
               "acc": [a.clone() for a in opt.acc], "mini_step": opt.mini_step,
               "gradient_step": opt.gradient_step}
    torch.manual_seed(0)
    other = ASRModel(cfg)
    if held == "stage":
        for layer in other.encoder.layers[TRAIN_LAYERS // 2:]:
            layer.to("meta")
    fresh = make_optimizer(other, tcfg)
    fresh.load_state_dict(indexed)
    got = fresh.state_dict()
    assert len(fresh.names) < len(opt.names) if held == "stage" else fresh.names == opt.names
    assert got["moments"].keys() == {n for n in named["moments"] if n in fresh.names}
    assert got["acc"].keys() == set(fresh.names)
    for n in fresh.names:
        assert torch.equal(got["acc"][n], named["acc"][n]), n
        for k, v in got["moments"][n].items():
            assert torch.equal(v, named["moments"][n][k]), (n, k)
    assert got["groups"] == named["groups"] and got["schedule"] == named["schedule"]
    assert (got["mini_step"], got["gradient_step"]) == (1, 1)


def test_trainer_needs_microbatches_on_a_pipe_axis():
    from mamba_asr_torch.parallel.mesh import Axis, Mesh

    cfg, frontend, tcfg, spec, state, _ = _train_setup()
    mesh = Mesh(data=Axis(1, 0), seq=Axis(1, 0), world=Axis(2, 0), pipe=Axis(2, 0))
    with pytest.raises(ValueError, match="pipeline_microbatches"):
        trainer.Trainer(cfg, frontend, tcfg, spec, state_dict=state, device="cpu", mesh=mesh)
