"""The process grid (port of mamba_asr_tpu/parallel/mesh.py:31-50,
104-105): the ranks of the world laid out on a (data, model, seq, pipe)
grid.

Rank r sits at (data index, model index, seq index, pipe index), pipe
innermost and data outermost, in the JAX mesh's axis order ("data",
"model", "seq", "pipe"): r = ((d * model + m) * seq + s) * pipe + p.
Ranks on one model line hold the same rows of a global batch and each
holds its slice of the large parameters (tensor parallelism,
parallel/tensor.py); ranks on one seq line hold the same rows and split
their time axis (sequence parallelism); ranks on one pipe line hold the
same rows and split the encoder's layers into stages (pipeline
parallelism, parallel/pipeline.py); ranks on one data line hold
different rows and the same parameter shard, seq shard or stage (data
parallelism). Each axis carries the torch.distributed group of this
rank's line along it, which the collectives (`parallel/collectives.py`)
reduce over.

GSPMD's placement hints (`constrain_batch`, `activation_mesh`,
`scoped_to_mesh`, `shard_batch`) have no counterpart: each rank holds
its own rows, and the whole state but for other stages' layers and other
model ranks' parameter slices (training/trainer.py).
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
    model: Axis = Axis(1, 0)

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


def make_mesh(data: Optional[int] = None, seq: int = 1, pipe: int = 1,
              model: int = 1) -> Mesh:
    """The (data, model, seq, pipe) grid over the world (a single process
    when no process group is initialized): data defaults to world //
    (model * seq * pipe), and data * model * seq * pipe must equal the
    world. Collective: in a multi-process world every rank must call it,
    in the same order, with the same sizes."""
    world, rank = distributed.process_count(), distributed.process_index()
    inner = model * seq * pipe
    if data is None:
        data = world // inner if inner > 0 else 0
    if min(data, model, seq, pipe) < 1 or data * inner != world:
        raise ValueError(f"a {data} x {model} x {seq} x {pipe} (data x model x seq x pipe) "
                         f"grid does not fit {world} rank(s)")
    sizes = (data, model, seq, pipe)
    d_idx, rest = divmod(rank, inner)
    m_idx, rest = divmod(rest, seq * pipe)
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

    return Mesh(data=axis(d_idx, 0), seq=axis(s_idx, 2), world=axis(rank, None),
                pipe=axis(p_idx, 3), model=axis(m_idx, 1))
