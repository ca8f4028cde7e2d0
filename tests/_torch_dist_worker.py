"""One rank of the port's multi-process CPU tests (gloo), started by
tests/test_torch_distributed.py with MASR_COORDINATOR,
MASR_NUM_PROCESSES and MASR_PROCESS_ID set. It imports the port only,
never JAX.

    python tests/_torch_dist_worker.py ops <case.pt> <out_dir>
        sp ops, the sp step and the dp step on the inputs of case.pt;
        writes out_dir/rank<r>.pt
    python tests/_torch_dist_worker.py pp <case.pt> <out_dir>
        pipeline parallelism over 2 ranks on the inputs of case.pt: the toy
        schedule, the ConMamba stack, the train step (with and without
        remat), a resume from a single process's state, the sp step with
        remat; writes out_dir/rank<r>.pt
    python tests/_torch_dist_worker.py tp <case.pt> <out_dir>
        tensor parallelism: over 2 ranks (model 2) the step on the inputs
        of case.pt (a ConMamba and a Conformer) and a checkpoint round
        trip; over 4 (data 2 x model 2)
        the S2S step on each data rank's half of case.pt's batch; writes
        out_dir/rank<r>.pt
    python tests/_torch_dist_worker.py cli <out.json> <argv as JSON>
        cli.run_training(argv) (with --distributed when MASR_* is set);
        writes the per-step losses, a fingerprint of the whole model's
        parameters and the world size to out.json (rank r > 0: out.json.<r>)
"""

import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)


def _grads(module):
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()
            if p.grad is not None}


def _time_shard(x, axis):
    tl = x.shape[1] // axis.size
    return x[:, axis.index * tl:(axis.index + 1) * tl]


def run_ops(case_path, out_dir):
    from mamba_asr_torch.parallel import collectives, distributed
    from mamba_asr_torch.parallel.mesh import make_mesh
    from mamba_asr_torch.parallel.sequence import (
        sp_causal_conv1d,
        sp_halo_exchange,
        sp_selective_scan,
    )
    from mamba_asr_torch.training.trainer import Trainer

    rt = distributed.initialize(device="cpu")
    sp, dp = make_mesh(seq=2), make_mesh(data=2)
    seq, n = sp.seq, sp.seq.size
    case = torch.load(case_path, weights_only=False)
    res = {}

    timed = ("u", "delta", "B", "C", "z")
    for name, c in case["scan"].items():
        args = {k: (_time_shard(v, seq) if k in timed else v).clone().requires_grad_()
                for k, v in c["inputs"].items()}
        out, h = sp_selective_scan(
            args["u"], args["delta"], args["A"], args["B"], args["C"], args["D"],
            args["z"], args["delta_bias"], True, args.get("h0"), True, axis=seq,
            reverse=c["reverse"])
        # This rank's share of the global loss: h is whole on every rank.
        ((out * _time_shard(c["cot"], seq)).sum() + (h * c["cot_h"]).sum() / n).backward()
        grads = {k: (v.grad if k in timed else collectives.reduce_(v.grad.clone(), seq))
                 for k, v in args.items()}
        res[name] = {"out": out.detach(), "h": h.detach(), "grads": grads}

    for name, c in case["conv"].items():
        x = _time_shard(c["x"], seq).clone().requires_grad_()
        w, b = c["w"].clone().requires_grad_(), c["b"].clone().requires_grad_()
        out = sp_causal_conv1d(x, w, b, axis=seq, reverse=c["reverse"])
        (out * _time_shard(c["cot"], seq)).sum().backward()
        res[name] = {"out": out.detach(), "grads": {
            "x": x.grad, "w": collectives.reduce_(w.grad.clone(), seq),
            "b": collectives.reduce_(b.grad.clone(), seq)}}

    c = case["halo"]
    x = _time_shard(c["x"], seq).clone().requires_grad_()
    out = sp_halo_exchange(x, c["left"], c["right"], seq)
    (out * c["cot"][seq.index]).sum().backward()
    res["halo"] = {"out": out.detach(), "x_grad": x.grad}

    def step(name, mesh, batch):
        s = case["step"]
        tr = Trainer(s["cfg"], s["frontend"], s["train"], s["specaug"],
                     state_dict=s["state_dict"], device="cpu", mesh=mesh)
        m = tr.train_step(batch)
        res[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "grads": _grads(tr.model),
                     "normalizer": [t.clone() for t in tr.normalizer]}

    for name, batch in case["sp_batches"].items():
        step(name, sp, batch)
    rows = len(case["dp_batch"]["weight"]) // dp.data.size
    half = {k: v[dp.data.index * rows:(dp.data.index + 1) * rows]
            for k, v in case["dp_batch"].items()}
    step("dp", dp, half)
    res["world"] = rt.world
    torch.save(res, os.path.join(out_dir, f"rank{rt.rank}.pt"))
    distributed.shutdown()


def run_pp(case_path, out_dir):
    from mamba_asr_torch.models.asr import ASRModel
    from mamba_asr_torch.parallel import collectives, distributed
    from mamba_asr_torch.parallel.encoder_parallel import pp_encoder_apply, stage_layers
    from mamba_asr_torch.parallel.mesh import make_mesh
    from mamba_asr_torch.parallel.pipeline import pipeline_apply, stage_from_layer_fn
    from mamba_asr_torch.training.trainer import Trainer

    rt = distributed.initialize(device="cpu")
    pp, sp = make_mesh(pipe=2), make_mesh(seq=2)
    pipe, n = pp.pipe, pp.pipe.size
    case = torch.load(case_path, weights_only=False)
    res = {"world": rt.world, "stage": list(stage_layers(case["toy"]["w"].shape[0], pipe))}

    # The toy stack: tanh(h @ w + b), layers split over the 2 stages.
    toy = case["toy"]
    w, b = (toy[k][res["stage"]].clone().requires_grad_() for k in ("w", "b"))
    stage = stage_from_layer_fn(lambda i, h: torch.tanh(h @ w[i] + b[i]), range(len(w)))
    res["toy_fwd"] = {m: pipeline_apply(stage, toy["x"], m, pipe).detach()
                      for m in toy["forward_microbatches"]}
    x = toy["x"].clone().requires_grad_()
    y = pipeline_apply(stage, x, toy["grad_microbatches"], pipe)
    loss = ((y - toy["tgt"]) ** 2).mean()
    (loss / n).backward()  # every rank holds the whole loss
    res["toy_grad"] = {"loss": loss.detach(), "w": w.grad, "b": b.grad,
                       "x": collectives.reduce_(x.grad.clone(), pipe)}

    # The ConMamba stack alone, dropout 0: its output and the gradients of
    # a fixed linear functional.
    st = case["stack"]
    model = ASRModel(st["cfg"])
    model.load_state_dict(st["state_dict"])
    enc = model.encoder
    x = st["x"].clone().requires_grad_()
    y = pp_encoder_apply(enc, x, pipe, st["microbatches"])
    ((y * st["cot"]).sum() / n).backward()
    mine = {f"1.encoder.{k}": p.grad for k, p in enc.named_parameters() if p.grad is not None}
    for k in ("1.encoder.norm.norm.weight", "1.encoder.norm.norm.bias"):
        mine[k] = collectives.reduce_(mine[k].clone(), pipe)
    res["stack"] = {"out": y.detach(), "grads": mine,
                    "x": collectives.reduce_(x.grad.clone(), pipe)}

    # The train step, the same rows on both ranks: 2 micro-steps, with and
    # without remat; the whole state in a single process's layout.
    tcase = case["train"]

    def trainer(name, mesh, normalizer=None):
        return Trainer(tcase["cfgs"][name], tcase["frontend"], tcase["train"],
                       tcase["specaug"], state_dict=tcase["state_dict"], normalizer=normalizer,
                       device="cpu", mesh=mesh, microbatches=tcase["microbatches"])

    for name in tcase["cfgs"]:
        tr = trainer(name, pp)
        ms = [tr.train_step(bt) for bt in tcase["batches"][:2]]
        live = {id(v) for st in tr.optimizer.optimizer.state.values() for v in st.values()}
        res[name] = {"metrics": [{k: float(v) for k, v in m.items()} for m in ms],
                     "params": {k: p.detach().clone() for k, p in tr.model.named_parameters()
                                if not p.is_meta},
                     "model_state": tr.model_state(), "optimizer_state": tr.optimizer_state(),
                     "normalizer": [t.clone() for t in tr.normalizer]}
        # The gather wrote into copies: the live moments are the same tensors.
        res[name]["moments_kept"] = live == {
            id(v) for st in tr.optimizer.optimizer.state.values() for v in st.values()}
    # A single process's state after 2 micro-steps (each rank runs one),
    # resumed here for a third.
    one = trainer("pp", None)
    for bt in tcase["batches"][:2]:
        one.train_step(bt)
    tr = trainer("pp", pp, normalizer=list(one.normalizer))
    tr.load_model_state(one.model_state())
    tr.load_optimizer_state(one.optimizer_state())
    m = tr.train_step(tcase["batches"][2])
    res["resumed"] = {"metrics": {k: float(v) for k, v in m.items()},
                      "model_state": tr.model_state()}

    # Sequence parallelism with remat against without, dropout on.
    for remat, cfg in tcase["sp_cfgs"].items():
        tr = Trainer(cfg, tcase["frontend"], tcase["train"], tcase["specaug"],
                     state_dict=tcase["state_dict"], device="cpu", mesh=sp)
        m = tr.train_step(tcase["batches"][0])
        res[f"sp_remat{int(remat)}"] = {
            "metrics": {k: float(v) for k, v in m.items()},
            "grads": {k: p.grad.clone() for k, p in tr.model.named_parameters()}}
    torch.save(res, os.path.join(out_dir, f"rank{rt.rank}.pt"))
    distributed.shutdown()


def run_tp(case_path, out_dir):
    from mamba_asr_torch.parallel import distributed
    from mamba_asr_torch.parallel.mesh import make_mesh
    from mamba_asr_torch.training.trainer import Trainer

    rt = distributed.initialize(device="cpu")
    grid = make_mesh(model=2)
    case = torch.load(case_path, weights_only=False)
    res = {"world": rt.world, "model_index": grid.model.index, "data_index": grid.data.index}

    def trainer(setup, **kw):
        return Trainer(setup["cfg"], setup["frontend"], setup["train"], setup["specaug"],
                       state_dict=setup["state_dict"], device="cpu", mesh=grid,
                       min_shard_elements=setup["min_shard_elements"], **kw)

    def step(tr, batch):
        m = tr.train_step(batch)
        grads = tr.tp.gather_state(_grads(tr.model), tr.device)
        return {"metrics": {k: float(v) for k, v in m.items()}, "grads": grads}

    if rt.world == 2:
        s = case["step"]
        tr = trainer(s)
        res["step"] = step(tr, s["batch"])
        res["step"]["sharded"] = sorted(tr.tp.shards)
        res["step"]["local"] = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
        res["conformer"] = step(trainer(case["conformer"]), case["conformer"]["batch"])
        # Checkpoints: 2 micro-steps, the whole state; then the single
        # process's state after 2 resumed here for the third.
        c = case["ckpt"]
        tr = trainer(c)
        for b in c["batches"][:2]:
            tr.train_step(b)
        res["ckpt"] = {"model_state": tr.model_state(), "optimizer_state": tr.optimizer_state(),
                       "normalizer": list(tr.normalizer),
                       "local": {n: p.detach().clone() for n, p in tr.model.named_parameters()},
                       "local_moments": {n: {k: v.clone() for k, v in st.items()}
                                         for n, st in tr.optimizer.state_dict()["moments"].items()}}
        tr = trainer(c, normalizer=c["resume"]["normalizer"])
        tr.load_model_state(c["resume"]["model_state"])
        tr.load_optimizer_state(c["resume"]["optimizer_state"])
        m = tr.train_step(c["batches"][2])
        res["resumed"] = {"metrics": {k: float(v) for k, v in m.items()},
                          "model_state": tr.model_state()}
    else:  # data 2 x model 2: the S2S step on this data rank's rows
        g = case["grid"]
        rows = len(g["batch"]["weight"]) // grid.data.size
        half = {k: v[grid.data.index * rows:(grid.data.index + 1) * rows]
                for k, v in g["batch"].items()}
        res["grid"] = step(trainer(g), half)
    torch.save(res, os.path.join(out_dir, f"rank{rt.rank}.pt"))
    distributed.shutdown()


def run_cli(out_json, argv):
    from mamba_asr_torch.cli import run_training, train_loader
    from mamba_asr_torch.parallel import distributed

    multi = bool(os.environ.get("MASR_NUM_PROCESSES"))
    trainer = run_training(argv + (["--distributed"] if multi else []))
    cfg, world = trainer.cfg, distributed.process_count()
    # The plan run_training loaded with (batch_divisor = the world, data parallel).
    csv_path = os.path.join(cfg.output_folder, "manifests", cfg.data.train_csv)
    plan = train_loader(cfg, csv_path, trainer.tokenizer, batch_divisor=world).plan
    whole = trainer.step.model_state()  # collective under pipeline parallelism
    out = {"loss": trainer.loss_history,
           "fingerprint": [float(whole[n].abs().mean())
                           for n, _ in trainer.step.model.named_parameters()],
           "world": world, "output_folder": cfg.output_folder,
           "plan": [[b.max_seconds, b.batch_size, b.max_label_len] for b in plan.buckets]}
    rank = distributed.process_index()
    with open(out_json if rank == 0 else f"{out_json}.{rank}", "w") as f:
        json.dump(out, f)
    distributed.shutdown()


if __name__ == "__main__":
    if sys.argv[1] == "ops":
        run_ops(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "pp":
        run_pp(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "tp":
        run_tp(sys.argv[2], sys.argv[3])
    else:
        run_cli(sys.argv[2], json.loads(sys.argv[3]))
