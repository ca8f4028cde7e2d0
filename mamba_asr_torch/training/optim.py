"""The optimizer of the CTC training step (port of the optimizer half of
mamba_asr_tpu/training/trainer.py: make_optimizer, cond_multi_steps,
apply_accumulated_update).

- AdamW (torch.optim.AdamW; betas, eps and weight decay from TrainConfig)
  with the JAX package's decay mask: no decay on 1-D parameters (biases,
  LayerNorms, D, the dt bias) nor on the scan's A. The JAX package names
  both directions' A `A_log`; the port keeps the reference names, where
  the backward head's is `A_b_log`, a 2-D tensor, so the mask names it.
- Global-norm clipping of the accumulated gradient, as
  optax.clip_by_global_norm: g * max_norm / norm where norm > max_norm.
  The norm is summed in float64. In float32 (optax, and torch's
  clip_grad_norm_) it overflows to inf when an element passes ~1e19,
  which the JAX package's zero-bias init reaches in the first steps
  where SpecAugment zeroes whole frames (a LayerNorm over a constant
  vector scales its gradient by 1/sqrt(eps) = 1e3, and such LayerNorms
  follow one another); the clip then zeroes every finite gradient and
  the update is lost. Where the float32 norm is finite the two agree.
- The Noam schedule through LambdaLR, counted as optax counts: update k
  uses noam(max(k - 1, 1)), so the first two updates share noam(1).
- Accumulation over k micro-steps with optax.MultiSteps semantics: a
  running mean of the micro-steps' gradients, acc += (g - acc) / n, and
  the clip and AdamW only on every k-th micro-step (the loss is not
  divided by k).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import torch
import torch.nn as nn
from torch.optim.lr_scheduler import LambdaLR

from mamba_asr_torch.training.schedule import noam_schedule

NO_DECAY = ("A_log", "A_b_log", "D", "D_b")


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, summed in float64."""
    norms = torch.stack([torch.linalg.vector_norm(t, dtype=torch.float64)
                         for t in tensors])
    return torch.linalg.vector_norm(norms)


def clip_by_global_norm_(tensors: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the tensors in place by max_norm / norm where their global
    norm passes max_norm; returns the norm (before clipping)."""
    norm = global_norm(tensors)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for t in tensors:
        t.mul_(scale.to(t.dtype))
    return norm


def decays(name: str, param: torch.Tensor) -> bool:
    """Whether weight decay applies to the parameter `name`."""
    return param.dim() >= 2 and name.rsplit(".", 1)[-1] not in NO_DECAY


class AccumulatingAdamW:
    """AdamW + clip + Noam behind gradient accumulation. `step()` reads the
    parameters' `.grad` as one micro-step's gradients and returns whether
    it updated the parameters (every `grad_accumulation_factor`-th call)."""

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]], cfg):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        self.params: List[nn.Parameter] = [p for _, p in named]
        groups = [
            {"params": [p for n, p in named if decays(n, p)],
             "weight_decay": cfg.weight_decay},
            {"params": [p for n, p in named if not decays(n, p)],
             "weight_decay": 0.0},
        ]
        # lr 1.0 scaled by the schedule: the learning rate is noam(count).
        self.optimizer = torch.optim.AdamW(groups, lr=1.0, betas=tuple(cfg.betas),
                                           eps=cfg.eps)
        self.scheduler = LambdaLR(self.optimizer, noam_schedule(
            cfg.lr, cfg.warmup_steps, cfg.scheduler_steps_per_update))
        self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.k = cfg.grad_accumulation_factor
        self.max_grad_norm = cfg.max_grad_norm
        self.mini_step = 0
        self.gradient_step = 0

    def step(self) -> bool:
        n = float(self.mini_step + 1)
        for p, acc in zip(self.params, self.acc):
            if p.grad is not None:
                acc.add_((p.grad.float() - acc) / n)
            else:
                acc.sub_(acc / n)
        emit = self.mini_step == self.k - 1
        if emit:
            for p, acc in zip(self.params, self.acc):
                p.grad = acc.to(p.dtype, copy=True)
                acc.zero_()
            clip_by_global_norm_([p.grad for p in self.params], self.max_grad_norm)
            self.optimizer.step()
            self.scheduler.step()
            self.gradient_step += 1
        self.mini_step = (self.mini_step + 1) % self.k
        return emit

    @property
    def micro_steps(self) -> int:
        """Micro-steps taken (the JAX TrainState's `step`)."""
        return self.gradient_step * self.k + self.mini_step

    def state_dict(self) -> dict:
        """AdamW's moments and step, the schedule's count, the accumulated
        gradients and the micro-step counters: what a checkpoint restores."""
        return {"adamw": self.optimizer.state_dict(), "schedule": self.scheduler.state_dict(),
                "acc": [a.detach().cpu() for a in self.acc],
                "mini_step": self.mini_step, "gradient_step": self.gradient_step}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["adamw"])
        self.scheduler.load_state_dict(state["schedule"])
        for acc, saved in zip(self.acc, state["acc"], strict=True):
            acc.copy_(saved)
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])


def make_optimizer(model: nn.Module, cfg) -> AccumulatingAdamW:
    """The optimizer of `model`'s parameters for a TrainConfig."""
    return AccumulatingAdamW(model.named_parameters(), cfg)
