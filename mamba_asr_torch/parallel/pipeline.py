"""Pipeline parallelism: the GPipe microbatch schedule over a pipe axis of
ranks (port of mamba_asr_tpu/parallel/pipeline.py:63-146).

Each rank of a pipe line holds one stage, a contiguous slice of the
encoder's layers (`stage_from_layer_fn`), and the same input rows; every
rank runs the same tick loop:

    tick t = 0 .. M+S-2   (M microbatches, S stages)
      stage 0 takes microbatch min(t, M-1), every other stage the
        activation the previous stage handed on at tick t-1
      the stage applies its layers where it holds a real microbatch
        (0 <= t - stage < M)
      stage S-1 writes its output to slot t-(S-1) (masked while t < S-1)
      the activations hop one stage forward (not after the last tick)

then the last stage's slots are handed to every rank of the line, so the
output is the same on every pipe rank, as JAX's masked psum makes it.

The hop is a gather read at the previous stage's slot, as
`parallel/sequence.py:sp_halo_exchange` reads its halos: every rank's
activation gathered over the pipe axis (`collectives.all_gather`), S
times the bytes a send/recv pair would move, in exchange for the
collectives that gloo runs on CUDA tensors of ranks sharing a card (PR
15's card check); its backward, through the gather's, is the reverse hop.
The final hand-out is a gather read at slot S-1.

Every rank issues the same collectives in the same order, forward and
backward: each tick's stage input, output slot and hop are the same
operations on every rank, with the stage index in their masks (`where`)
and never in the graph's shape. So every gather's node is reached by
the backward on every rank, in the same order (the hops last to first
after the final hand-out). On a bubble tick (fill or drain) the stage's
layers do not run: its output is its input times 0, which keeps the
hop's gather in the graph. JAX computes garbage there instead; the
result is the same, and the card launches the stage's kernels M times a
micro-step, not M+S-1 (a departure: ROADMAP Queue 3).

Microbatches are independent in every layer this repo pipelines (LN,
FFN, the scans and convolutions act per row), so the output and its
gradients equal the unsharded stack's up to the float rounding of
smaller batches.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn as nn

from mamba_asr_torch.parallel.collectives import all_gather
from mamba_asr_torch.parallel.mesh import Axis


def stage_from_layer_fn(layer_fn: Callable[[nn.Module, torch.Tensor], torch.Tensor],
                        layers: Sequence[nn.Module]) -> Callable[[torch.Tensor], torch.Tensor]:
    """A stage: `layer_fn(layer, x)` applied for each of this stage's
    `layers` in turn (JAX's local lax.scan over the stage's slice)."""

    def stage_fn(x: torch.Tensor) -> torch.Tensor:
        for layer in layers:
            x = layer_fn(layer, x)
        return x

    return stage_fn


def pipeline_apply(stage_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                   n_microbatches: int, pipe: Axis) -> torch.Tensor:
    """Run the S = pipe.size stages over x (B, ...), the same on every rank
    of the pipe line, with B % n_microbatches == 0; stage_fn is this rank's
    stage and keeps the activation's shape. Returns the last stage's
    output (B, ...) on every rank. Collective over the pipe axis: every
    rank of the line calls it with the same shapes."""
    s, m, b = pipe.size, int(n_microbatches), x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    if s == 1:
        return stage_fn(x)
    if torch.is_grad_enabled() and not x.requires_grad:
        # Every hop must reach the backward on every rank, stage 0's too.
        x = x.detach().requires_grad_()
    stage = pipe.index
    x_mb = x.reshape(m, b // m, *x.shape[1:])
    ticks = m + s - 1
    # The masks: [is stage 0, then whether tick t writes the last stage's slot].
    masks = torch.tensor([stage == 0] + [stage == s - 1 and t >= s - 1 for t in range(ticks)],
                         device=x.device)
    cur = torch.zeros_like(x_mb[0])
    out = [torch.zeros_like(x_mb[0]) for _ in range(m)]
    for t in range(ticks):
        inp = torch.where(masks[0], x_mb[min(t, m - 1)], cur)
        y = stage_fn(inp) if 0 <= t - stage < m else inp * 0
        slot = max(t - (s - 1), 0)
        out[slot] = torch.where(masks[1 + t], y, out[slot])
        if t < ticks - 1:  # the hop; stage 0's read is masked out
            cur = all_gather(y, pipe)[(stage - 1) % s]
    return all_gather(torch.cat(out), pipe)[s - 1]
