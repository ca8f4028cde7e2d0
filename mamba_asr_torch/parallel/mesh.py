"""The process grid (port of mamba_asr_tpu/parallel/mesh.py:31-50,
104-105): the ranks of the world laid out on a (data, seq, pipe) grid.

Rank r sits at (data index, seq index, pipe index), pipe innermost and
data outermost, as the JAX mesh orders its devices on ("data", "model",
"seq", "pipe"): r = (data_index * seq + seq_index) * pipe + pipe_index.
Ranks on one seq line hold the same rows of a global batch and split
their time axis (sequence parallelism); ranks on one pipe line hold the
same rows and split the encoder's layers into stages (pipeline
parallelism, parallel/pipeline.py); ranks on one data line hold
different rows and the same seq shard or stage (data parallelism). Each
axis carries the torch.distributed group of this rank's line along it,
which the collectives (`parallel/collectives.py`) reduce over.

The JAX mesh's "model" axis (tensor parallelism) is not ported: the
config loader refuses it (`check_parallel`) before any grid is made.
GSPMD's placement hints (`constrain_batch`, `activation_mesh`,
`scoped_to_mesh`, `shard_batch`) have no counterpart: each rank holds
its own rows, and the whole state but for other stages' layers
(training/trainer.py).
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
    pipe: Axis = Axis(1, 0)

    def is_main_process(self) -> bool:
        return self.world.index == 0


def _lines(sizes, along: int):
    """The rank lists of every line of a grid of `sizes` (outermost first,
    rank = the row-major index) along the axis `along`: one list per
    setting of the other axes, ranks in the axis's order."""
    n = 1
    for size in sizes:
        n *= size
    inner = 1
    for size in sizes[along + 1:]:
        inner *= size
    step = sizes[along] * inner
    return [[base + i * inner for i in range(sizes[along])]
            for base in range(n) if base % step < inner]


def make_mesh(data: Optional[int] = None, seq: int = 1, pipe: int = 1) -> Mesh:
    """The (data, seq, pipe) grid over the world (a single process when no
    process group is initialized): data defaults to world // (seq * pipe),
    and data * seq * pipe must equal the world. Collective: in a
    multi-process world every rank must call it, in the same order, with
    the same sizes."""
    world, rank = distributed.process_count(), distributed.process_index()
    if data is None:
        data = world // (seq * pipe)
    if data < 1 or seq < 1 or pipe < 1 or data * seq * pipe != world:
        raise ValueError(f"a {data} x {seq} x {pipe} (data x seq x pipe) grid does not fit "
                         f"{world} rank(s)")
    sizes = (data, seq, pipe)
    d_idx, rest = divmod(rank, seq * pipe)
    s_idx, p_idx = divmod(rest, pipe)
    everyone = list(range(world))

    def axis(index, along):
        lines = _lines(sizes, along) if along is not None else [everyone]
        size = len(lines[0])
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

    return Mesh(data=axis(d_idx, 0), seq=axis(s_idx, 1), world=axis(rank, None),
                pipe=axis(p_idx, 2))
