"""The process grid (port of mamba_asr_tpu/parallel/mesh.py:31-50,
104-105): the ranks of the world laid out on a (data, seq) grid.

Rank r sits at (data index, seq index) = divmod(r, seq), data-major as
the JAX mesh's device order is. Ranks on one data index hold the same
rows of a global batch and split their time axis (sequence parallelism);
ranks on one seq index hold different rows (data parallelism). Each axis
carries the torch.distributed group of this rank's line along it, which
the collectives (`parallel/collectives.py`) reduce over.

The JAX mesh's "model" and "pipe" axes (tensor and pipeline parallelism)
are not ported: the config loader refuses them (`check_parallel`) before
any grid is made. GSPMD's placement hints
(`constrain_batch`, `activation_mesh`, `scoped_to_mesh`, `shard_batch`)
have no counterpart: each rank holds its own rows and the whole state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

from mamba_asr_torch.parallel import distributed

@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the grid, seen from this rank: its size, this rank's
    index on it, and the process group of this rank's line along it (None
    in a single process, or on a line of one rank in a larger world: no
    collective runs then)."""

    size: int
    index: int
    group: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: Axis
    seq: Axis
    world: Axis

    def is_main_process(self) -> bool:
        return self.world.index == 0


def _lines(size_outer: int, size_inner: int, along_inner: bool):
    """The rank lists of every line of a (outer, inner) data-major grid,
    along the inner axis (fixed outer index) or along the outer one."""
    if along_inner:
        return [[o * size_inner + i for i in range(size_inner)] for o in range(size_outer)]
    return [[o * size_inner + i for o in range(size_outer)] for i in range(size_inner)]


def make_mesh(data: Optional[int] = None, seq: int = 1) -> Mesh:
    """The (data, seq) grid over the world (a single process when no
    process group is initialized): data defaults to world // seq, and
    data * seq must equal the world. Collective: in a multi-process world
    every rank must call it, in the same order, with the same sizes."""
    world, rank = distributed.process_count(), distributed.process_index()
    if data is None:
        data = world // seq
    if data < 1 or seq < 1 or data * seq != world:
        raise ValueError(f"a {data} x {seq} (data x seq) grid does not fit {world} rank(s)")
    d_idx, s_idx = divmod(rank, seq)
    everyone = list(range(world))

    def axis(size, index, lines):
        if not distributed.is_initialized():
            return Axis(size, index)
        groups = []
        for line in lines:  # every rank creates every group, in one order
            if line == everyone:
                groups.append(dist.group.WORLD)
            elif len(line) == 1:
                groups.append(None)
            else:
                groups.append(dist.new_group(line, timeout=distributed.timeout()))
        mine = next(i for i, line in enumerate(lines) if rank in line)
        return Axis(size, index, groups[mine])

    return Mesh(data=axis(data, d_idx, _lines(data, seq, along_inner=False)),
                seq=axis(seq, s_idx, _lines(data, seq, along_inner=True)),
                world=axis(world, rank, [everyone]))
