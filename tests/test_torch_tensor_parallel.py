"""Tensor parallelism in the PyTorch port (parallel/tensor.py, the grid's
model axis, the trainer's tp branch) against the JAX package's
`infer_param_shardings` / `place_state` and GSPMD step, and against the
port's single-process step.

In this process:
- JAX's own rule cases (tests/test_multichip.py:141-158) through
  `shard_rule`;
- for each of the 11 YAMLs (and ConMamba-Small with scan_layers) at
  tensor_parallel 2 and the YAML's min_shard_elements, the JAX leaves of
  the parameters the port shards equal the leaves `infer_param_shardings`
  puts on "model" for `jax.eval_shape` of JAX's init (no compile). The
  rule acts leaf by leaf, so a YAML whose layers JAX does not stack is
  read at 2 layers (every layer's leaves are alike); a stacked one keeps
  its depth, which its leaves' sizes hold;
- each rank's slices equal the port import of JAX's tree with every
  sharded leaf cut to that rank's share of its last axis (the stacked q,
  k and v of attention, the stacked encoder leaves of scan_layers).
One spawn of tests/_torch_dist_worker.py `tp` in 2 gloo ranks (model 2,
min_shard_elements 64, the tiny ConMamba of tests/test_torch_distributed.py,
scan_layers on) gives:
- the step: loss within 2e-5 and every gathered gradient within 3e-4 of
  JAX's make_train_step under a (data 1, model 2) mesh with
  `place_state(min_elements=64)` (run beside in a child process), and of
  the port's single-process step; a Conformer step (RelPosMHAXL) against
  the single process;
- checkpoints both ways: 2 micro-steps on the ranks, their gathered state
  loaded by one process (its slices bit-equal to the ranks') and stepped
  once more, and one process's state after 2 loaded by the ranks and
  stepped: each against the uninterrupted single-process run.
A second spawn in 4 ranks (data 2 x model 2) runs one S2S step with the
Transformer decoder against the single process on the whole batch. Beside
them, `python -m mamba_asr_torch.train_ctc --distributed --device cpu
--parallel.tensor_parallel 2` in 2 processes against 1 process on the
same bucket plan (losses, fingerprint, rank 0's checkpoint resumed by a
single-process loop). The stanza's refusals are in
tests/test_torch_parallel.py.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mamba_asr_tpu.configs import loader as jax_loader
from mamba_asr_tpu.configs.loader import ParallelConfig as JaxParallelConfig
from mamba_asr_tpu.models import asr as jax_asr
from mamba_asr_tpu.parallel import mesh as jax_mesh
from mamba_asr_tpu.training import normalizer as jax_norm
from mamba_asr_tpu.training import trainer as jax_trainer

from mamba_asr_torch.configs import loader
from mamba_asr_torch.models import asr
from mamba_asr_torch.models import params_import as pi
from mamba_asr_torch.parallel import tensor
from mamba_asr_torch.training import loop, trainer
from tests._beside import beside
from tests.test_torch_distributed import (
    CLI_OVERRIDES,
    JAX_CFG,
    JAX_FE,
    JAX_TRAIN,
    REPO,
    _batch,
    _close,
    _grads_close,
    _make_corpus,
    _port_cfg,
    _port_plain_step,
    finish,
    start,
)

torch.set_num_threads(1)

MIN = 64
OUT_TOL, GRAD_TOL = 2e-5, 3e-4
TP_FLAGS = ["--parallel.tensor_parallel", "2", "--parallel.min_shard_elements", str(MIN)]
YAMLS = sorted(f"{kind}/{name}" for kind in ("CTC", "S2S")
               for name in os.listdir(os.path.join(REPO, "hparams", kind)))
RULE_CASES = [(y, {}) for y in YAMLS] + [("CTC/conmamba_small.yaml", {"model.scan_layers": True})]
JAX_S2S = dataclasses.replace(JAX_CFG, num_decoder_layers=1)
JAX_CONFORMER = dataclasses.replace(JAX_CFG, encoder_module="conformer",
                                    attention_type="RelPosMHAXL", scan_layers=False)


# -- the rule ---------------------------------------------------------------------


@pytest.mark.parametrize("name,shape,sharded", [
    ("big_kernel", (512, 128), True), ("small", (4, 4), False), ("bias", (1024,), False),
    ("odd", (512, 129), False)])
def test_shard_rule_takes_jax_cases(name, shape, sharded):
    mesh = jax_mesh.make_mesh(data=4, model=2)
    spec = jax_mesh.infer_param_shardings({name: jnp.zeros(shape)}, mesh, 1 << 10)[name].spec
    assert ("model" in spec) == sharded
    assert tensor.shard_rule(shape, 2, 1 << 10) == sharded
    assert not tensor.shard_rule(shape, 1, 1 << 10)


def _unrolled(path, leaf_shape, cfg):
    """A JAX leaf's paths in the unrolled tree (a stacked leaf is one per
    layer)."""
    keys = [str(getattr(p, "key", p)) for p in path]
    if keys[:2] == ["encoder", "stack"]:
        rest = "/".join(keys[4:])  # encoder/stack/layers/<scanned module>/...
        return [f"encoder/layer_{i}/{rest}" for i in range(leaf_shape[0])]
    return ["/".join(keys)]


@pytest.mark.parametrize("yaml,over", RULE_CASES, ids=[
    y.replace("/", "_") + ("_scanned" if o else "") for y, o in RULE_CASES])
def test_sharded_parameters_are_jaxs(yaml, over):
    path = os.path.join(REPO, "hparams", yaml)
    raw = jax_loader.load_config(path, over)
    if not raw.model.scan_layers:
        over = dict(over, **{"model.num_encoder_layers": 2})
        if raw.model.num_decoder_layers:
            over["model.num_decoder_layers"] = 1
    jcfg, cfg = jax_loader.load_config(path, over), loader.load_config(path, over)
    args = [jnp.zeros((1, 64, jcfg.model.n_mels)), jnp.array([64])]
    if jcfg.model.num_decoder_layers:
        args.append(jnp.ones((1, 3), jnp.int32))
    shapes = jax.eval_shape(jax_asr.ASRModel(jcfg.model).init, jax.random.PRNGKey(0),
                            *args)["params"]
    specs = jax_mesh.infer_param_shardings(shapes, jax_mesh.make_mesh(data=4, model=2),
                                           cfg.parallel.min_shard_elements)
    want = set()
    for (p, leaf), (_, sh) in zip(jax.tree_util.tree_flatten_with_path(shapes)[0],
                                  jax.tree_util.tree_flatten_with_path(specs)[0]):
        if "model" in sh.spec:
            assert sh.spec[-1] == "model"
            want.update(_unrolled(p, leaf.shape, jcfg.model))
    assert want, "the YAML shards nothing"
    with torch.device("meta"):
        model = asr.ASRModel(cfg.model)
    plan = tensor.plan(model, cfg.model, 2, 0, cfg.parallel.min_shard_elements)
    leaves = pi.jax_leaves(cfg.model, {n: tuple(p.shape) for n, p in model.named_parameters()})
    got = {leaf.path for name in plan for leaf in leaves[name]}
    assert got == want, (sorted(got - want)[:5], sorted(want - got)[:5])


def _seeded(cfg, seed):
    """JAX params of `cfg` from jax.eval_shape filled from numpy (no
    compile), as tests/test_torch_distributed.py:_seeded_params fills
    them, the decoder's leaves too."""
    rng = np.random.default_rng(seed)
    args = [jnp.zeros((1, 64, 20)), jnp.array([64])]
    if cfg.num_decoder_layers:
        args.append(jnp.ones((1, 3), jnp.int32))
    shapes = jax.eval_shape(jax_asr.ASRModel(cfg).init, jax.random.PRNGKey(0), *args)["params"]

    def fill(path, leaf):
        x = rng.normal(size=leaf.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return x / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return np.float32(path[-1].key == "scale") + np.float32(0.05) * x

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_each_rank_holds_its_share_of_jaxs_leaves():
    """Rank m's slice of every sharded tensor is the import of JAX's tree
    with each sharded leaf cut to [m L / 2, (m + 1) L / 2) of its last
    axis: attention's q, k and v each give a quarter of in_proj_weight's
    rows, the stacked encoder leaves their own share."""
    params = _seeded(JAX_S2S, 3)
    cfg = _port_cfg(JAX_S2S)
    full = pi.import_asr_params(params, cfg)
    specs = jax_mesh.infer_param_shardings(params, jax_mesh.make_mesh(data=4, model=2), MIN)
    model = asr.ASRModel(cfg)
    for m in range(2):
        def cut(x, sh):
            if "model" not in sh.spec:
                return x
            n = x.shape[-1] // 2
            return x[..., m * n:(m + 1) * n]
        want = pi.import_asr_params(jax.tree_util.tree_map(cut, params, specs), cfg)
        plan = tensor.plan(model, cfg, 2, m, MIN)
        assert any(len(s.parts) == 3 for s in plan.values())  # q, k and v
        assert any("dt_proj" in k or "A_log" in k for k in plan)  # stacked leaves
        for name, shard in plan.items():
            assert torch.equal(shard.local(full[name]), want[name]), name
        for name in set(full) - set(plan):
            assert torch.equal(full[name], want[name]), name


# -- spawned ranks ------------------------------------------------------------------


def _jax_tp_step(params, batch):
    """(loss, gradients in the port's names, sharded leaf count) of JAX's
    step at (data 1, model 2), its state placed by place_state."""
    model = jax_asr.ASRModel(JAX_CFG)
    tx = jax_trainer.make_optimizer(JAX_TRAIN)
    state = jax_trainer.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=tx.init(params),
        normalizer=jax_norm.init_normalizer(20), step=jnp.zeros((), jnp.int32))
    mesh = jax_mesh.make_mesh(data=1, model=2, devices=jax.devices()[:2])
    state = jax_mesh.place_state(state, mesh, MIN)
    sharded = sum("model" in x.sharding.spec for x in jax.tree_util.tree_leaves(state.params))
    step = jax_trainer.make_train_step(
        model, tx, JAX_FE, JAX_TRAIN, jax_trainer.SpecAugmentConfig(enabled=False),
        parallel=JaxParallelConfig(tensor_parallel=2, min_shard_elements=MIN), mesh=mesh)
    state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.PRNGKey(1), jnp.bool_(True))
    acc = jax.tree_util.tree_map(np.asarray, state.opt_state.acc_grads)
    return float(m["loss"]), pi.import_asr_params(acc, _port_cfg()), sharded


def _setup(jcfg, seed, tcfg):
    cfg = _port_cfg(jcfg)
    state = pi.import_asr_params(_seeded(jcfg, seed), cfg)
    return {"cfg": cfg, "frontend": loader.FrontendConfig(n_fft=256, n_mels=20),
            "train": tcfg, "specaug": trainer.SpecAugmentConfig(enabled=False),
            "state_dict": state, "min_shard_elements": MIN}


def _single(setup, batches, resume=None):
    """The single-process Trainer over `batches` (from `resume`'s state):
    (metrics, model state, optimizer state, normaliser) after each."""
    tr = trainer.Trainer(setup["cfg"], setup["frontend"], setup["train"], setup["specaug"],
                         state_dict=setup["state_dict"], device="cpu",
                         normalizer=None if resume is None else resume["normalizer"])
    if resume is not None:
        tr.load_model_state(resume["model_state"])
        tr.load_optimizer_state(resume["optimizer_state"])
    out = []
    for b in batches:
        m = tr.train_step(b)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "model_state": tr.model_state(),
                    # A copy: the next step updates AdamW's state in place.
                    "optimizer_state": copy.deepcopy(tr.optimizer_state()),
                    "normalizer": list(tr.normalizer),
                    "grads": {n: p.grad.clone() for n, p in tr.model.named_parameters()}})
    return out


def _s2s_batch(bsz, seed):
    b = _batch(bsz, 160 * 63, seed, wav_lens=[160 * 63, 160 * 55, 160 * 63, 160 * 50][:bsz])
    b["tokens_bos"] = np.concatenate([np.ones((bsz, 1), np.int32), b["tokens"]], axis=1)
    b["tokens_eos"] = np.concatenate([b["tokens"], np.full((bsz, 1), 2, np.int32)], axis=1)
    b["eos_lens"] = b["token_lens"] + 1
    return b


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp")
    params = _seeded(JAX_CFG, 0)
    step = _setup(JAX_CFG, 0, trainer.TrainConfig(**dataclasses.asdict(JAX_TRAIN)))
    step["batch"] = _batch(2, 160 * 63, seed=40)
    n = 160 * 63
    ckpt = _setup(JAX_CFG, 9, trainer.TrainConfig(grad_accumulation_factor=1, warmup_steps=10))
    ckpt["batches"] = [_batch(4, n, seed=60 + i, wav_lens=[n, n - 900, n, n - 1700])
                       for i in range(3)]
    single = _single(ckpt, ckpt["batches"])
    ckpt["resume"] = single[1]
    grid = _setup(JAX_S2S, 5, trainer.TrainConfig(grad_accumulation_factor=2, warmup_steps=10))
    grid["batch"] = _s2s_batch(4, seed=70)
    conformer = _setup(JAX_CONFORMER, 6, trainer.TrainConfig(grad_accumulation_factor=2,
                                                              warmup_steps=10))
    conformer["batch"] = _batch(2, n, seed=80, wav_lens=[n, n - 1200])
    torch.save({"step": step, "ckpt": ckpt, "grid": grid, "conformer": conformer},
               work / "case.pt")

    corpus = str(work / "LibriSpeech")
    _make_corpus(corpus)
    yaml = os.path.join(REPO, "hparams", "CTC", "conmamba_small.yaml")
    cli = {}
    for name, nproc, flags in (("one", 1, []), ("tp", 2, TP_FLAGS)):
        argv = [yaml, "--device", "cpu", "--data.data_folder", corpus, "--data.output_folder",
                str(work / f"res_{name}")] + CLI_OVERRIDES + flags
        cli[name] = (str(work / f"{name}.json"),
                     start(["cli", str(work / f"{name}.json"), json.dumps(argv)], nproc, REPO))
    (work / "g").mkdir()
    groups = [start(["tp", str(work / "case.pt"), str(work)], 2, REPO),
              start(["tp", str(work / "case.pt"), str(work / "g")], 4, REPO)]
    jax_ref = beside(work, "tests.test_torch_tensor_parallel", "_jax_tp_step", params,
                     step["batch"])
    try:
        refs = {"plain": _port_plain_step(step["state_dict"], step["batch"]),
                "single": single,
                "grid": _single(grid, [grid["batch"]])[0],
                "conformer": _single(conformer, [conformer["batch"]])[0]}
        refs["jax"] = jax_ref()
    finally:
        for group in groups:
            finish(group)
        for _, group in cli.values():
            finish(group)
    got = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    got_grid = [torch.load(work / "g" / f"rank{r}.pt", weights_only=False) for r in range(4)]
    outs = {}
    for name, (path, _) in cli.items():
        with open(path) as f:
            outs[name] = dict(json.load(f), results=str(work / f"res_{name}"))
    with open(cli["tp"][0] + ".1") as f:
        outs["tp_rank1"] = json.load(f)
    return got, got_grid, refs, outs, ckpt


def test_tp_step_matches_jax_and_the_plain_step(runs):
    """Both model ranks hold the global loss and, gathered, the whole
    model's gradients: a missing 1 / n would double the replicated
    parameters' gradients, a missing sum over the model axis would leave
    them partial."""
    got, _, refs, _, _ = runs
    jax_loss, jax_grads, jax_sharded = refs["jax"]
    plain_m, plain_grads, _ = refs["plain"]
    assert jax_sharded > 0
    for r, g in enumerate(got):
        assert g["world"] == 2 and g["model_index"] == r
        m = g["step"]["metrics"]
        _close(m["loss"], jax_loss, OUT_TOL, 0.0, f"rank {r} loss vs JAX")
        _close(m["loss"], plain_m["loss"], OUT_TOL, 0.0, f"rank {r} loss vs plain")
        for name, ref in jax_grads.items():
            _close(g["step"]["grads"][name], ref, GRAD_TOL, GRAD_TOL, f"rank {r} vs JAX: {name}")
        _grads_close(g["step"]["grads"], plain_grads, f"rank {r} vs the plain step")
    # Each rank holds half of every sharded tensor, and the ranks' halves differ.
    sharded = got[0]["step"]["sharded"]
    assert sharded and set(sharded) == set(got[1]["step"]["sharded"])
    for name in sharded:
        a, b = got[0]["step"]["local"][name], got[1]["step"]["local"][name]
        assert a.numel() * 2 == plain_grads[name].numel() and not torch.equal(a, b), name


def test_tp_conformer_step_matches_the_plain_step(runs):
    """RelPosMHAXL's projections and the conv modules' weights are read
    raw (gathered for the step), the FFNs and out projections through
    their own columns."""
    got, _, refs, _, _ = runs
    ref = refs["conformer"]
    for r, g in enumerate(got):
        _close(g["conformer"]["metrics"]["loss"], ref["metrics"]["loss"], OUT_TOL, 0.0,
               f"rank {r} loss")
        _grads_close(g["conformer"]["grads"], ref["grads"], f"rank {r} conformer")


def test_tp_checkpoint_resumes_in_one_process_and_back(runs):
    got, _, refs, _, ckpt = runs
    single = refs["single"]
    rank0 = got[0]["ckpt"]
    for k, v in single[1]["model_state"].items():
        _close(rank0["model_state"][k], v, 2e-4, 1e-5, k)
    # The gathered state loads into one process: its slices are the ranks'
    # bit for bit, and it steps on as the uninterrupted run does.
    tr = trainer.Trainer(ckpt["cfg"], ckpt["frontend"], ckpt["train"], ckpt["specaug"],
                         state_dict=ckpt["state_dict"], device="cpu",
                         normalizer=rank0["normalizer"])
    tr.load_model_state(rank0["model_state"])
    tr.load_optimizer_state(rank0["optimizer_state"])
    for r, g in enumerate(got):
        plan = tensor.plan(tr.model, ckpt["cfg"], 2, r, MIN)
        mine = dict(tr.model.named_parameters())
        moments = tr.optimizer.state_dict()["moments"]
        for name, local in g["ckpt"]["local"].items():
            shard = plan.get(name)
            cut = (lambda t: t) if shard is None else shard.local
            assert torch.equal(cut(mine[name].detach()), local), (r, name)
            for s, v in g["ckpt"]["local_moments"][name].items():
                assert torch.equal(cut(moments[name][s]) if v.dim() else moments[name][s],
                                   v), (r, name, s)
    m = tr.train_step(ckpt["batches"][2])
    _close(float(m["loss"]), single[2]["metrics"]["loss"], 1e-5, 0.0, "one process, resumed")
    for k, v in single[2]["model_state"].items():
        _close(tr.model_state()[k], v, 2e-4, 1e-5, f"one process, resumed: {k}")
    # One process's state resumed on the tp ranks.
    for r, g in enumerate(got):
        _close(g["resumed"]["metrics"]["loss"], single[2]["metrics"]["loss"], 1e-5, 0.0,
               f"rank {r} resumed")
        for k, v in single[2]["model_state"].items():
            _close(g["resumed"]["model_state"][k], v, 2e-4, 1e-5, f"rank {r} resumed: {k}")


def test_s2s_step_on_a_data_by_model_grid(runs):
    """data 2 x model 2: the losses divide by the global weight, the
    sharded gradients sum over the data axis, the replicated over all 4."""
    _, got, refs, _, _ = runs
    ref = refs["grid"]
    assert [(g["data_index"], g["model_index"]) for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r, g in enumerate(got):
        for key in ("loss", "loss_ctc", "loss_att"):
            _close(g["grid"]["metrics"][key], ref["metrics"][key], 1e-5, 0.0, f"rank {r} {key}")
        _grads_close(g["grid"]["grads"], ref["grads"], f"rank {r} grid")


def test_cli_tp_two_processes_match_one(runs):
    _, _, _, outs, _ = runs
    one, two = outs["one"], outs["tp"]
    assert (one["world"], two["world"]) == (1, 2)
    assert one["plan"] == two["plan"], "the two runs must load the same bucket plan"
    assert len(one["loss"]) == len(two["loss"]) > 0
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(two["fingerprint"], one["fingerprint"], rtol=1e-5, atol=1e-8)
    assert outs["tp_rank1"]["fingerprint"] == two["fingerprint"], "ranks hold other weights"
    assert outs["tp_rank1"]["loss"] == two["loss"]
    # Rank 0's checkpoint (the slices gathered) resumes in a single-process
    # loop, equal to the 1-process run's last checkpoint.
    states = []
    for run in ("one", "tp"):
        over = loader.parse_overrides(CLI_OVERRIDES)
        over["data.output_folder"] = outs[run]["results"]
        tr = loop.Trainer(loader.load_config(
            os.path.join(REPO, "hparams", "CTC", "conmamba_small.yaml"), over), None,
            device="cpu")
        tr.init_state()
        assert tr.start_epoch == 3
        states.append(tr.step.model_state())
    for k, v in states[0].items():
        _close(states[1][k], v, 2e-4, 1e-5, k)
