"""One rank of the port's multi-process CPU tests (gloo), started by
tests/test_torch_distributed.py with MASR_COORDINATOR,
MASR_NUM_PROCESSES and MASR_PROCESS_ID set. It imports the port only,
never JAX.

    python tests/_torch_dist_worker.py ops <case.pt> <out_dir>
        sp ops, the sp step and the dp step on the inputs of case.pt;
        writes out_dir/rank<r>.pt
    python tests/_torch_dist_worker.py cli <out.json> <argv as JSON>
        cli.run_training(argv) (with --distributed when MASR_* is set);
        writes the per-step losses, a parameter fingerprint and the
        world size to out.json (rank r > 0: out.json.<r>)
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


def run_cli(out_json, argv):
    from mamba_asr_torch.cli import run_training, train_loader
    from mamba_asr_torch.parallel import distributed

    multi = bool(os.environ.get("MASR_NUM_PROCESSES"))
    trainer = run_training(argv + (["--distributed"] if multi else []))
    cfg, world = trainer.cfg, distributed.process_count()
    # The plan run_training loaded with (batch_divisor = the world, data parallel).
    csv_path = os.path.join(cfg.output_folder, "manifests", cfg.data.train_csv)
    plan = train_loader(cfg, csv_path, trainer.tokenizer, batch_divisor=world).plan
    out = {"loss": trainer.loss_history,
           "fingerprint": [float(p.detach().abs().mean())
                           for p in trainer.step.model.parameters()],
           "world": world, "output_folder": cfg.output_folder,
           "plan": [[b.max_seconds, b.batch_size, b.max_label_len] for b in plan.buckets]}
    rank = distributed.process_index()
    with open(out_json if rank == 0 else f"{out_json}.{rank}", "w") as f:
        json.dump(out, f)
    distributed.shutdown()


if __name__ == "__main__":
    if sys.argv[1] == "ops":
        run_ops(sys.argv[2], sys.argv[3])
    else:
        run_cli(sys.argv[2], json.loads(sys.argv[3]))
