"""Train the TransformerLM of shallow fusion (the port's counterpart of
train_lm.py): next-token prediction on a text corpus, one transcript per
line.

    python -m mamba_asr_torch.train_lm --corpus corpus.txt --tokenizer tok.json \\
        --output results/lm [--d_model 768 --layers 12 ...] [--device cpu]

The corpus becomes one id stream (BOS, the line's ids, EOS per line);
each step draws `batch_size` windows of seq_len + 1 ids from
numpy.random.default_rng(seed), the windows of JAX's script. The loss is
the KL divergence of the next token, averaged over tokens
(training/losses.py:kldiv_loss, reduction "mean"); the optimizer is
JAX's chain: global-norm clipping at 5.0, then AdamW (b1 0.9, b2 0.98,
eps 1e-9, weight decay 0.01 on every parameter: the script's
optax.adamw has no mask), then the Noam schedule (lr, warmup), counted as
optax counts. `train_lm` trains the LM it is given, in float32; the CLI's
LM starts from `models.lm.init_params_` seeded with `seed`. Every
`save_every` steps and at the last it writes <output>/lm.pt, the
SpeechBrain-layout state dict that `cli.load_lm` reads (the JAX script
writes lm.msgpack). The vocabulary is the
tokenizer's, as in JAX: `cli.load_lm` builds its LM at the model's
`vocab_size`, so a tokenizer smaller than the model's head gives an LM
it cannot load (ROADMAP Queue 3). It runs on the CUDA card unless
`--device` says otherwise.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.optim.lr_scheduler import LambdaLR

from mamba_asr_torch.data.tokenizer import BOS_ID, EOS_ID, load_tokenizer
from mamba_asr_torch.models.lm import TransformerLM, init_params_
from mamba_asr_torch.training.losses import kldiv_loss
from mamba_asr_torch.training.optim import clip_by_global_norm_
from mamba_asr_torch.training.schedule import noam_schedule
from mamba_asr_torch.utils.device import resolve_device

MAX_GRAD_NORM = 5.0


def corpus_stream(path: str, tokenizer) -> np.ndarray:
    """Every non-empty line of the corpus as BOS, its ids, EOS; int32."""
    ids: List[int] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                ids.extend([BOS_ID] + tokenizer.encode(line) + [EOS_ID])
    return np.asarray(ids, np.int32)


def train_lm(stream: np.ndarray, lm: TransformerLM, output: str, seq_len: int = 128,
             batch_size: int = 64, steps: int = 100000, lr: float = 1e-3,
             warmup: int = 4000, log_every: int = 100, save_every: int = 5000,
             seed: int = 0, device=None) -> dict:
    """Train `lm` (moved to `device`) on the id stream. Returns the trained
    LM ("lm"), every step's loss ("losses", read once at the end), the log
    lines ("log": step, loss, ms per step since the last line, ppl) and the
    lm.pt path ("path")."""
    device = resolve_device(device)
    torch.manual_seed(seed)  # dropout draws from the device's default generator
    lm = lm.to(device).train()
    params = list(lm.parameters())
    opt = torch.optim.AdamW(params, lr=1.0, betas=(0.9, 0.98), eps=1e-9, weight_decay=0.01)
    sched = LambdaLR(opt, noam_schedule(lr, warmup))
    os.makedirs(output, exist_ok=True)
    path = os.path.join(output, "lm.pt")
    print(f"corpus: {len(stream)} tokens, vocab {lm.vocab_size}", flush=True)

    rng = np.random.default_rng(seed)
    n = len(stream) - seq_len - 1
    losses, log = [], []
    t_last, s_last = time.perf_counter(), 0
    for step in range(1, steps + 1):
        starts = rng.integers(0, n, size=batch_size)
        batch = torch.from_numpy(np.stack([stream[s:s + seq_len + 1] for s in starts]))
        batch = batch.to(device).long()
        lp = torch.log_softmax(lm(batch[:, :-1]), dim=-1)
        loss = kldiv_loss(lp, batch[:, 1:], reduction="mean")
        opt.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm_([p.grad for p in params], MAX_GRAD_NORM)
        opt.step()
        sched.step()
        losses.append(loss.detach())
        if step % log_every == 0:
            value = loss.item()
            now = time.perf_counter()
            ms = 1e3 * (now - t_last) / (step - s_last)
            t_last, s_last = now, step
            log.append({"step": step, "loss": value, "ms_per_step": ms,
                        "ppl": float(np.exp(value))})
            print(f"step {step} loss {value:.4f} ({ms:.1f} ms/step, "
                  f"ppl {np.exp(value):.1f})", flush=True)
        if step % save_every == 0 or step == steps:
            torch.save({k: v.detach().cpu() for k, v in lm.state_dict().items()}, path)
            print(f"saved {path}", flush=True)
    return {"lm": lm.eval(), "losses": torch.stack(losses).tolist() if losses else [],
            "log": log, "path": path}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--corpus", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--d_model", type=int, default=768)
    p.add_argument("--nhead", type=int, default=12)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--d_ffn", type=int, default=3072)
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--steps", type=int, default=100000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup", type=int, default=4000)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--save_every", type=int, default=5000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    tok = load_tokenizer(args.tokenizer)
    lm = TransformerLM(tok.vocab_size, args.d_model, args.nhead, args.layers, args.d_ffn,
                       dropout=args.dropout)
    init_params_(lm, torch.Generator().manual_seed(args.seed))
    return train_lm(corpus_stream(args.corpus, tok), lm, args.output, seq_len=args.seq_len,
                    batch_size=args.batch_size, steps=args.steps, lr=args.lr,
                    warmup=args.warmup, log_every=args.log_every,
                    save_every=args.save_every, seed=args.seed, device=device)

if __name__ == "__main__":
    main()
