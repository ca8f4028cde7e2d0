"""The ConMamba encoder stack with its time axis sharded over a seq axis
(port of mamba_asr_tpu/parallel/encoder_parallel.py:81-117).

The training step splits the model at `ASRModel.encode_pre` (front end
and projection, run whole on every rank of a seq line, which holds the
same rows) -> `sp_encoder_apply` (each rank runs every layer on its time
shard; the Mamba blocks and conv modules reach the neighbouring shards
through parallel/sequence.py) -> `ASRModel.forward_from_enc` (heads and
losses, on the gathered output). As in the JAX package, T' is padded at
the end to a multiple of the shard count, and the bidirectional scans
read those frames as they read bucket padding.

Only ConMamba takes it (JAX asserts the same, `:52-56`): the attention
encoders mix every frame. The pipeline half of the JAX module (`:120-205`,
the stacked layer layout run on the GPipe schedule) waits for ROADMAP
Queue 1 item 10.

The gather's backward sums each shard's cotangent over the seq ranks. A
loss that every seq rank computes whole therefore comes back n_seq times:
the trainer scales each rank's copy by 1 / n_seq (training/trainer.py).

Dropout inside the stack draws from a stream of its own per (data rank,
seq rank) (`DeviceRngStream`), as the JAX package folds the shard index
into the stack's key (`:101-104`); draws outside it are the same on every
rank of a seq line.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_asr_torch.parallel.collectives import all_gather
from mamba_asr_torch.parallel.mesh import Axis


def check_sequence_parallel(encoder_module: str, dynchunk_size=None) -> None:
    """Raise where sequence parallelism cannot apply: an encoder other than
    ConMamba (JAX `encoder_parallel.py:52-56`), or dynamic-chunk training,
    whose chunks would straddle shards (JAX `trainer.py:350-354`)."""
    if encoder_module != "conmamba":
        raise ValueError(
            f"sequence_parallel needs the ConMamba encoder (got {encoder_module!r}): "
            "attention encoders need time-global ops the sp schedule does not provide")
    if dynchunk_size is not None:
        raise ValueError("dynamic-chunk training cannot take sequence parallelism")


def sp_encoder_apply(encoder: nn.Module, x: torch.Tensor, seq: Axis) -> torch.Tensor:
    """x (B, T', d_model), the same on every rank of the seq line -> the
    stack's output (B, T', d_model): T' padded to a multiple of seq.size,
    this rank's shard through `encoder(shard, seq=seq)`, the shards
    gathered over time and cropped to T'."""
    n, t = seq.size, x.shape[1]
    tp = -(-t // n) * n
    if tp != t:
        x = F.pad(x, (0, 0, 0, tp - t))
    tl = tp // n
    y = encoder(x[:, seq.index * tl:(seq.index + 1) * tl].contiguous(), seq=seq)
    return torch.cat(list(all_gather(y, seq)), dim=1)[:, :t]


class DeviceRngStream:
    """A second stream of the device's default generator (the one dropout
    draws from), seeded on its own: `swapped()` makes it the default within
    the block and keeps where it got to. `state` is a CPU byte tensor, as
    the generators' states a checkpoint holds."""

    def __init__(self, device: torch.device, seed: int):
        self.device = device
        self.state = torch.Generator(device=device).manual_seed(seed).get_state()

    def _get(self) -> torch.Tensor:
        if self.device.type == "cuda":
            return torch.cuda.get_rng_state(self.device)
        return torch.get_rng_state()

    def _set(self, state: torch.Tensor) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_rng_state(state, self.device)
        else:
            torch.set_rng_state(state)

    @contextlib.contextmanager
    def swapped(self):
        outer = self._get()
        self._set(self.state)
        try:
            yield
        finally:
            self.state = self._get()
            self._set(outer)
