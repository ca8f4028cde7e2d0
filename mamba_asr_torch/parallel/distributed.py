"""Multi-process runtime (port of mamba_asr_tpu/parallel/distributed.py):
one process per rank, joined by `torch.distributed`.

Reference capability matched: multi-GPU data-parallel training launched
with torchrun (`ddp_init_group`, train_CTC.py:1062). `initialize()` joins
the process group; `parallel/mesh.py` lays the ranks out on a (data, seq)
grid; each rank loads its own rows of every global batch
(`data/dataset.py:BucketedLoader(process_index=, process_count=)`), and
the step sums its gradients over the world (`training/trainer.py`).
Logs and checkpoints are written by rank 0 (`is_main_process`), with a
`barrier` after each write, as the reference's `run_on_main`.

Where the JAX package's processes meet:
- the address, count and index come from the arguments, else JAX's
  MASR_COORDINATOR ("host:port"), MASR_NUM_PROCESSES and MASR_PROCESS_ID,
  else torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK;
- the local rank (which card a rank takes by default) is LOCAL_RANK, else
  the process index.

The backend is explicit and never switches by itself: NCCL for ranks on
CUDA cards, gloo for ranks on the CPU. Ranks that share one card ask for
gloo (`backend="gloo"` or MASR_BACKEND=gloo): NCCL refuses two ranks on
one device, and `initialize` raises naming MASR_BACKEND when NCCL is
asked for more ranks than there are cards. gloo reduces CUDA tensors
through host memory. The process group has a timeout (`timeout_s`, else
MASR_TIMEOUT_S, else 1,800 s), so a collective that never completes
fails the run instead of holding it.

The JAX package's `fetch_global` / `tree_fetch_global` have no
counterpart here: the trainer gathers the pipeline stages and the
tensor-parallel slices it holds into a single process's layout itself
(training/trainer.py:model_state, optimizer_state).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

ENV_COORD = "MASR_COORDINATOR"
ENV_NPROC = "MASR_NUM_PROCESSES"
ENV_PID = "MASR_PROCESS_ID"
ENV_BACKEND = "MASR_BACKEND"
ENV_TIMEOUT = "MASR_TIMEOUT_S"
DEFAULT_TIMEOUT_S = 1800.0

_timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)  # the group's, for sub-groups


@dataclasses.dataclass(frozen=True)
class Runtime:
    """What `initialize` set up: this process's rank and local rank, the
    world size, the backend and the device this rank computes on."""

    rank: int
    world: int
    local_rank: int
    backend: str
    device: torch.device


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def rank_device(device: Optional[Union[str, torch.device]], local_rank: int) -> torch.device:
    """The device of a rank: `device` as given (a bare "cuda" is the card
    of this local rank), else the card cuda:<local rank>. A CUDA device
    that does not exist raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to train "
                           "with gloo on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", local_rank)
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank device {dev} does not exist ({torch.cuda.device_count()} card(s)); "
            f"ranks that share a card pass --device cuda:0 and {ENV_BACKEND}=gloo")
    return dev


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
    timeout_s: Optional[float] = None,
) -> Runtime:
    """Join the process group. Explicit arguments win, then the MASR_*
    variables, then torchrun's. `backend`: "nccl" or "gloo" (default:
    MASR_BACKEND, else nccl for a CUDA device and gloo for the CPU).
    `device`: as `rank_device`. Sets the current CUDA device to the
    rank's card, which NCCL's collectives use."""
    if coordinator_address is None:
        coordinator_address = os.environ.get(ENV_COORD) or None
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = _env_int(ENV_NPROC, "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int(ENV_PID, "RANK")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise RuntimeError(
            "--distributed needs the coordinator address, the process count and this "
            f"process's index: set {ENV_COORD}, {ENV_NPROC} and {ENV_PID} (or launch "
            "with torchrun)")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = process_id if local_rank is None else local_rank
    dev = rank_device(device, local_rank)
    backend = (backend or os.environ.get(ENV_BACKEND)
               or ("nccl" if dev.type == "cuda" else "gloo")).lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: use nccl or gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs CUDA devices, not {dev}; "
                             f"{ENV_BACKEND}=gloo trains on the CPU")
        cards = torch.cuda.device_count()
        ranks_here = _env_int("LOCAL_WORLD_SIZE") or num_processes  # MASR_*: one host
        if ranks_here > cards:
            raise RuntimeError(
                f"nccl with {ranks_here} ranks and {cards} card(s): NCCL refuses two "
                f"ranks on one card; set {ENV_BACKEND}=gloo (and --device cuda:0) to "
                "share a card")
    if timeout_s is None:
        timeout_s = float(os.environ.get(ENV_TIMEOUT, DEFAULT_TIMEOUT_S))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    global _timeout
    _timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=_timeout)
    return Runtime(process_id, num_processes, local_rank, backend, dev)


def timeout() -> datetime.timedelta:
    """The process group's timeout (sub-groups take the same)."""
    return _timeout


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def barrier(name: str) -> None:
    """Every rank waits here (nothing in a single process). Orders rank
    0's file writes (manifests, tokenizer, kernels, checkpoints) before
    the other ranks read them; `name` tells a timed-out barrier apart."""
    if process_count() > 1:
        try:
            dist.barrier()
        except RuntimeError as e:
            raise RuntimeError(f"barrier {name!r}: {e}") from e


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if is_initialized():
        dist.destroy_process_group()
