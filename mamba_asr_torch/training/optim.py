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
  The norm is summed in float64 (under pipeline or tensor parallelism by
  the trainer's `norm_fn`, which adds the other stages' or slices'
  squares). In float32
  (optax, and torch's clip_grad_norm_) it overflows to inf when an
  element passes ~1e19, which the JAX package's zero-bias init reaches
  in the first steps where SpecAugment zeroes whole frames (a LayerNorm
  over a constant vector scales its gradient by 1/sqrt(eps) = 1e3, and
  such LayerNorms follow one another); the clip then zeroes every finite
  gradient and the update is lost. Where the float32 norm is finite the
  two agree.
- The Noam schedule through LambdaLR, counted as optax counts: update k
  uses noam(max(k - 1, 1)), so the first two updates share noam(1).
- Accumulation over k micro-steps with optax.MultiSteps semantics: a
  running mean of the micro-steps' gradients, acc += (g - acc) / n, and
  the clip and AdamW only on every k-th micro-step (the loss is not
  divided by k).
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Sequence, Tuple

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


def clip_by_global_norm_(tensors: Sequence[torch.Tensor], max_norm: float,
                         norm_fn: Callable[[Sequence[torch.Tensor]], torch.Tensor] = global_norm
                         ) -> torch.Tensor:
    """Scale the tensors in place by max_norm / norm where their global
    norm (`norm_fn`) passes max_norm; returns the norm (before clipping)."""
    norm = norm_fn(tensors)
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
    it updated the parameters (every `grad_accumulation_factor`-th call).
    Parameters on the meta device (other pipeline stages' layers) are left
    out; a tensor-parallel rank's parameters are its slices, and so are
    their moments and accumulators. norm_fn: the clip's global norm of
    the parameters' gradients, in their order. The state dict keys each
    parameter's state by its name, so a rank holding some of the
    parameters (or slices, which the trainer cuts) reads its share of a
    whole model's state."""

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]], cfg,
                 norm_fn: Callable[[Sequence[torch.Tensor]], torch.Tensor] = global_norm):
        every = [(n, p) for n, p in named_params if p.requires_grad]
        named = [(n, p) for n, p in every if not p.is_meta]
        self.names: List[str] = [n for n, _ in named]
        self.params: List[nn.Parameter] = [p for _, p in named]
        self.norm_fn = norm_fn
        groups = [[(n, p) for n, p in named if decays(n, p)],
                  [(n, p) for n, p in named if not decays(n, p)]]
        # AdamW's index order, and the whole model's as a state dict keyed
        # by index (written before the state was keyed by name) laid it out.
        self._order = [n for group in groups for n, _ in group]
        self._indexed_order = ([n for n, p in every if decays(n, p)]
                               + [n for n, p in every if not decays(n, p)])
        self._every = [n for n, _ in every]
        groups = [{"params": [p for _, p in groups[0]], "weight_decay": cfg.weight_decay},
                  {"params": [p for _, p in groups[1]], "weight_decay": 0.0}]
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
            clip_by_global_norm_([p.grad for p in self.params], self.max_grad_norm,
                                 self.norm_fn)
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
        """What a checkpoint restores: `moments` {name: AdamW's state (its
        moments and step)}, `groups` (AdamW's hyperparameters), the
        schedule's count, `acc` {name: accumulated gradient} and the
        micro-step counters. The dicts are new: a caller may edit them."""
        adamw = self.optimizer.state_dict()
        return {"moments": {self._order[i]: dict(st) for i, st in adamw["state"].items()},
                "groups": [{k: v for k, v in g.items() if k != "params"}
                           for g in adamw["param_groups"]],
                "schedule": self.scheduler.state_dict(),
                "acc": {n: a.detach().cpu() for n, a in zip(self.names, self.acc)},
                "mini_step": self.mini_step, "gradient_step": self.gradient_step}

    def load_state_dict(self, state: dict) -> None:
        """Load a state dict of `state_dict`'s form, taking the entries of
        this optimizer's parameters, or one keyed by index, as the port
        wrote them before (AdamW's and the accumulators' order over the
        whole model)."""
        if "adamw" in state:
            order = self._indexed_order
            state = {**state, "moments": {order[i]: st
                                          for i, st in state["adamw"]["state"].items()},
                     "groups": state["adamw"]["param_groups"],
                     "acc": dict(zip(self._every, state["acc"], strict=True))}
        index = {n: i for i, n in enumerate(self._order)}
        sizes = [len(g["params"]) for g in self.optimizer.param_groups]
        firsts = [0, sizes[0]]
        self.optimizer.load_state_dict({
            "state": {index[n]: st for n, st in state["moments"].items() if n in index},
            "param_groups": [dict({k: v for k, v in g.items() if k != "params"},
                                  params=list(range(a, a + size)))
                             for g, a, size in zip(state["groups"], firsts, sizes)]})
        self.scheduler.load_state_dict(state["schedule"])
        for n, acc in zip(self.names, self.acc):
            acc.copy_(state["acc"][n])
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])


def make_optimizer(model: nn.Module, cfg, norm_fn=global_norm) -> AccumulatingAdamW:
    """The optimizer of `model`'s parameters for a TrainConfig."""
    return AccumulatingAdamW(model.named_parameters(), cfg, norm_fn)
