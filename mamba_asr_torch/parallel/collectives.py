"""The collectives of multi-process training, written over `all_reduce`
and `all_gather` alone, which gloo on the CPU, gloo on CUDA tensors
(several ranks on one card, which gloo moves through host memory; both
checked on an H100) and NCCL all run: no send/recv, no reduce-scatter.

- `all_gather`: every rank's tensor, in axis order, differentiable.
  Backward: the cotangents summed over the axis (an all-reduce of all n
  slots, n times a reduce-scatter's bytes), this rank's slot. The
  objective is the sum of the ranks' losses, so a slot every rank uses
  gets every rank's cotangent: the transpose of the gather.
- `sp_halo_exchange` (parallel/sequence.py) is a gather read at the
  neighbour's slot; its backward, through the gather's, is the reverse
  exchange.
- `reduce_` sums a tensor over an axis in place, outside autograd (the
  weight sum and the metrics); `reduce_grads_` sums every gradient.

Sums run in float32 (a bf16 tensor is widened and narrowed back). At two
ranks the traffic per micro-step is the (B, D, N) state pairs, the conv
halos and one encoder output, each gathered forward and summed backward.
On an axis without a group (a single process, or a line of one rank)
every function is the identity.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from mamba_asr_torch.parallel.mesh import Axis


def reduce_(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum `t` (contiguous) over the axis, in place; returns it."""
    if axis.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=axis.group)
    return t


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(out, x, group=axis.group)
        return torch.stack(out)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        return reduce_(g.float().contiguous().clone(), axis)[axis.index].to(g.dtype), None


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(axis.size, *x.shape): every rank's x, in axis order (differentiable)."""
    return x[None] if axis.group is None else _AllGather.apply(x, axis)


def reduce_grads_(params: Sequence[torch.nn.Parameter], axis: Axis) -> None:
    """Sum every parameter's gradient over the axis through one flat
    float32 buffer. A parameter without a gradient gets zeros (every rank
    must send the same buffer); zeros change neither the clip nor the
    accumulation (training/optim.py)."""
    if axis.group is None:
        return
    grads: List[torch.Tensor] = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    reduce_(flat, axis)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def gather_bytes(t: torch.Tensor, axis: Axis, device: torch.device) -> List[torch.Tensor]:
    """Every rank's uint8 tensor `t` (equal sizes on every rank), as CPU
    uint8 tensors in axis order (e.g. the random generators' states for a
    checkpoint)."""
    if axis.group is None:
        return [t.clone()]
    rows = all_gather(t.to(device=device, dtype=torch.int32), axis)
    return [r.to(device="cpu", dtype=torch.uint8) for r in rows]
