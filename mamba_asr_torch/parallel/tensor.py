"""Tensor parallelism over the grid's model axis (port of
mamba_asr_tpu/parallel/mesh.py:107-193, `infer_param_shardings` and
`place_state`).

The rule is JAX's: a leaf is sharded on its last axis over the model
axis when it has at least 2 dimensions, at least `min_elements` elements
and a last dimension the axis size divides; every other leaf is
replicated. It is applied to each JAX leaf a port tensor is made from
(`models/params_import.py:jax_leaves`), with the leaf's shape as JAX has
it: under `scan_layers` the encoder's layer leaves are stacked over the
layers (JAX's `encoder/stack`), so more of them pass `min_elements`. The
port axis that is the leaf's last is the sharded one: dim 0 of a Linear
or Conv weight, dim 1 of an embedding. Attention's stacked
`in_proj_weight` is three leaves (q, k, v): a rank holds its share of
each.

`TensorParallel.shard(model)` replaces every sharded parameter by this
rank's slice, so its AdamW moments and accumulated gradient have the
slice's shape too. In the step:
- a Linear whose weight is sharded (the FFNs, the Mamba in/out
  projections, attention's projections, the heads) computes only this
  rank's output columns and all-gathers them over the model axis
  (`models/layers.py:dense`, `models/attention.py:MultiheadAttention.
  _proj`), so each rank does 1 / n of the product, as GSPMD partitions a
  product sharded on its output axis;
- any other sharded parameter (a conv's output channels, an embedding's
  features, a stacked layer's leaf, the dt projection and RelPosMHAXL's
  projections, which are read as raw weights) is all-gathered before use
  for the step's duration (`materialized`).
Every rank of a model line runs the same code on the same rows, so the
gathers are issued in one order, forward and backward. The gather's
backward sums the cotangent over the axis and keeps this rank's slot;
with each rank's copy of the loss scaled by 1 / n, a sharded parameter's
gradient is whole on its rank, and a replicated one's is whole once
summed over the model axis (training/trainer.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_asr_torch.models.params_import import JaxLeaf, jax_leaves
from mamba_asr_torch.parallel.collectives import all_gather
from mamba_asr_torch.parallel.mesh import Axis

COMBINE_ITEM = ("ROADMAP Queue 1 item 16 (tensor parallelism combined with sequence or "
                "pipeline parallelism)")
MIN_SHARD_ELEMENTS = 1 << 14  # JAX's default (ParallelConfig.min_shard_elements)
STACKED_ENCODERS = ("conmamba", "conformer", "branchformer")  # JAX scans their layers
# Linears whose weight the model reads raw, not through `dense`: they are
# gathered before use.
RAW_WEIGHTS = ("dt_proj", "dt_proj_b", "linear_pos")


def check_tensor_parallel(tensor_parallel: int, sequence_parallel: int = 1,
                          pipeline_stages: int = 1) -> None:
    """Raise where the port cannot run tensor parallelism: beside a seq or
    pipe axis (JAX runs tp with sp; the port does not yet)."""
    if tensor_parallel > 1 and (sequence_parallel > 1 or pipeline_stages > 1):
        raise ValueError("tensor_parallel cannot combine with sequence_parallel or "
                         f"pipeline_stages (yet): {COMBINE_ITEM}")


def shard_rule(shape: Sequence[int], model_size: int,
               min_elements: int = MIN_SHARD_ELEMENTS) -> bool:
    """Whether JAX shards a leaf of `shape` on its last axis over a model
    axis of `model_size` (`mesh.py:136-144`)."""
    size = 1
    for d in shape:
        size *= d
    return (model_size > 1 and len(shape) >= 2 and size >= min_elements
            and shape[-1] % model_size == 0)


def jax_shape(leaf: JaxLeaf, cfg) -> Tuple[int, ...]:
    """The leaf's shape in JAX's tree for `cfg`: stacked over the layers
    under scan_layers where JAX scans the encoder."""
    if (cfg.scan_layers and cfg.encoder_module in STACKED_ENCODERS
            and leaf.path.startswith("encoder/layer_")):
        return (cfg.num_encoder_layers,) + leaf.shape
    return leaf.shape


@dataclasses.dataclass(frozen=True)
class Shard:
    """How one port tensor is split: along `axis`, each of `parts`
    ((start, length) of one JAX leaf on that axis) in n equal slices,
    rank i holding slice i of every part, in part order."""

    axis: int
    parts: Tuple[Tuple[int, int], ...]
    n: int
    index: int

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor."""
        return torch.cat([full.narrow(self.axis, start + self.index * (length // self.n),
                                      length // self.n) for start, length in self.parts],
                         dim=self.axis)

    def local_sizes(self) -> List[int]:
        return [length // self.n for _, length in self.parts]

    def whole(self, gathered: torch.Tensor) -> torch.Tensor:
        """The whole tensor from the ranks' slices stacked on a new axis 0
        (all_gather's output): each part's slices joined in rank order."""
        return assemble(gathered, self.axis, self.local_sizes())


def assemble(gathered: torch.Tensor, axis: int, sizes: Sequence[int]) -> torch.Tensor:
    """(n, *local) -> whole: `axis` of `local` holds parts of `sizes`;
    part p of the whole is rank 0's part p, rank 1's, ... joined."""
    if axis < 0:
        axis += gathered.dim() - 1
    pieces = []
    for piece in gathered.split(list(sizes), dim=axis + 1):
        piece = piece.movedim(0, axis)
        shape = list(piece.shape)
        pieces.append(piece.reshape(shape[:axis] + [shape[axis] * shape[axis + 1]]
                                    + shape[axis + 2:]))
    return torch.cat(pieces, dim=axis)


def plan(model: nn.Module, cfg, model_size: int, index: int = 0,
         min_elements: int = MIN_SHARD_ELEMENTS) -> Dict[str, Shard]:
    """{parameter name: its Shard} for every parameter of `model` (an
    ASRModel for the config `cfg`, ASRConfig) that JAX's rule shards; the
    rest are replicated."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out = {}
    for name, leaves in jax_leaves(cfg, shapes).items():
        split = [shard_rule(jax_shape(leaf, cfg), model_size, min_elements) for leaf in leaves]
        if not any(split):
            continue
        axes = {leaf.last_axis for leaf in leaves}
        if not all(split) or len(axes) != 1:
            raise ValueError(f"{name}: its JAX leaves are placed unlike each other")
        axis = axes.pop()
        parts = tuple((0, shapes[name][axis]) if leaf.rows is None
                      else (leaf.rows[0], leaf.rows[1] - leaf.rows[0]) for leaf in leaves)
        if len(parts) > 1 and axis != 0:
            raise ValueError(f"{name}: stacked leaves sharded off their stacking axis")
        out[name] = Shard(axis, parts, model_size, index)
    return out


def column_parallel(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                    shard: Shard, axis: Axis, rows: Optional[Sequence[int]] = None
                    ) -> torch.Tensor:
    """x @ W.T + b for the whole W, of which `weight` is this rank's row
    slice (`shard`, axis 0) and `bias` the whole bias (or None): this
    rank's output columns, all-gathered over the model axis. rows: the
    parts (indices into shard.parts) to compute, default all (attention
    projects q, k and v, or one of them)."""
    sizes = shard.local_sizes()
    rows = list(range(len(sizes)) if rows is None else rows)  # consecutive parts
    first = sum(sizes[:rows[0]])
    w = weight[first:first + sum(sizes[p] for p in rows)]
    b = None
    if bias is not None:
        b = torch.cat([bias.narrow(0, shard.parts[p][0] + shard.index * sizes[p], sizes[p])
                       for p in rows])
    y = F.linear(x, w, b)
    return assemble(all_gather(y, axis), y.dim() - 1, [sizes[p] for p in rows])


class TensorParallel:
    """The tensor-parallel placement of one model on this rank (module
    doc). cfg: the model's ASRConfig; axis: the grid's model axis."""

    def __init__(self, model: nn.Module, cfg, axis: Axis,
                 min_elements: int = MIN_SHARD_ELEMENTS):
        self.axis = axis
        self.shards = plan(model, cfg, axis.size, axis.index, min_elements)
        self._gathered: List[Tuple[nn.Module, str, Shard]] = []

    def shard(self, model: nn.Module) -> None:
        """Replace each sharded parameter of `model` by this rank's slice
        and mark the Linears that compute their own columns."""
        modules = dict(model.named_modules())
        for name, shard in self.shards.items():
            owner, _, leaf = name.rpartition(".")
            module = modules[owner]
            with torch.no_grad():
                module._parameters[leaf] = nn.Parameter(shard.local(module._parameters[leaf]))
            linear = (isinstance(module, nn.Linear) and leaf == "weight"
                      and owner.rpartition(".")[2] not in RAW_WEIGHTS)
            stacked = leaf == "in_proj_weight" and hasattr(module, "in_proj_bias")
            column = shard.axis == 0 and (linear or stacked)
            if column:  # read by models/layers.py:dense and MultiheadAttention._proj
                module.tp_dense = functools.partial(column_parallel, shard=shard,
                                                    axis=self.axis)
            else:
                self._gathered.append((module, leaf, shard))

    @contextlib.contextmanager
    def materialized(self):
        """Within: every sharded parameter read raw is whole (a gather of
        the slices, differentiable back to them). The step's backward runs
        inside too, so a layer that recomputes its forward (remat) reads
        the same gathered tensors."""
        saved = []
        try:
            for module, leaf, shard in self._gathered:
                local = module._parameters[leaf]
                saved.append((module, leaf, local))
                module._parameters[leaf] = shard.whole(all_gather(local, self.axis))
            yield
        finally:
            for module, leaf, local in reversed(saved):
                module._parameters[leaf] = local

    # -- whole-model state ------------------------------------------------------

    def gather_state(self, entries: Mapping[str, torch.Tensor], device: torch.device
                     ) -> Dict[str, torch.Tensor]:
        """`entries` ({key: tensor}, the sharded keys holding this rank's
        slices; each key's Shard is `self.shards[name]` for the name
        `shard_of(key)` gives) with every slice replaced by the whole
        tensor, on the CPU, in its own dtype: one float32 gather of them
        all over the model axis. Collective: every rank of the line calls
        it with the same keys."""
        keys = [k for k in entries if self.shard_of(k) is not None]
        out = {k: v.detach().to("cpu", copy=True) for k, v in entries.items()}
        if not keys:
            return out
        with torch.no_grad():
            flat = torch.cat([entries[k].detach().reshape(-1).to(device, torch.float32)
                              for k in keys])
            rows = all_gather(flat, self.axis).cpu()
        offset = 0
        for k in keys:
            like = entries[k]
            n = like.numel()
            part = rows[:, offset:offset + n].reshape((rows.shape[0],) + tuple(like.shape))
            out[k] = self.shard_of(k).whole(part).to(like.dtype)
            offset += n
        return out

    def local_state(self, entries: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """`entries` (whole tensors) with the sharded keys cut to this
        rank's slices."""
        out = dict(entries)
        for k, v in entries.items():
            shard = self.shard_of(k)
            if shard is not None:
                out[k] = shard.local(v).clone()
        return out

    def shard_of(self, key) -> Optional[Shard]:
        """The Shard of a state key: a parameter name, or (name, ...) for
        an optimizer entry of that parameter (its moment or accumulator)."""
        name = key[0] if isinstance(key, tuple) else key
        shard = self.shards.get(name)
        if shard is not None and isinstance(key, tuple) and key[-1] == "step":
            return None
        return shard
