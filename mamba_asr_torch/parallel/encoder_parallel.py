"""The ConMamba encoder stack with its time axis sharded over a seq axis,
or its layers split into stages over a pipe axis (port of
mamba_asr_tpu/parallel/encoder_parallel.py:81-205).

The training step splits the model at `ASRModel.encode_pre` (front end
and projection, run whole on every rank of a seq or pipe line, which
holds the same rows) -> the stack under `sp_encoder_apply` or
`pp_encoder_apply` -> `ASRModel.forward_from_enc` (heads and losses, on
the whole output, on every rank of the line).

Sequence parallelism (`sp_encoder_apply`): each rank runs every layer on
its time shard; the Mamba blocks and conv modules reach the neighbouring
shards through parallel/sequence.py. As in the JAX package, T' is padded
at the end to a multiple of the shard count, and the bidirectional scans
read those frames as they read bucket padding.

Pipeline parallelism (`pp_encoder_apply`): stage s runs layers [s L/S,
(s+1) L/S) of the stack on the GPipe schedule (parallel/pipeline.py);
the stack's final LayerNorm runs outside the pipeline, on every rank
(JAX `:202-205`). With `remat_layers` each layer is recomputed in the
backward (JAX `:172-180`).

Only ConMamba takes either (JAX asserts the same, `:52-56`, and
pipelines ConMamba's layers alone, `:145-160`): the attention encoders
mix every frame. The loader's checks are `check_sequence_parallel` and
`check_pipeline_parallel`.

The gathers' backward sums each rank's cotangent over the axis. A loss
that every rank of the line computes whole therefore comes back n times:
the trainer scales each rank's copy by 1 / n (training/trainer.py).

Dropout inside the stack draws from a stream of its own per (data rank,
seq or pipe rank) (`DeviceRngStream`), as the JAX package folds the
shard index into the stack's key (`:101-104`); draws outside it are the
same on every rank of the line. Under pp each (layer, microbatch) draws
its own mask from the stage's stream: JAX's pp hands each layer one key
for every tick and data row (`:163-167, :201`), which repeats the mask
across microbatches and data rows (ROADMAP Queue 3); the port does not
copy that.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from mamba_asr_torch.models.layers import layer_norm, run_layer
from mamba_asr_torch.parallel.collectives import all_gather
from mamba_asr_torch.parallel.mesh import Axis
from mamba_asr_torch.parallel.pipeline import pipeline_apply, stage_from_layer_fn


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


def check_pipeline_parallel(encoder_module: str, scan_layers: bool, num_layers: int,
                            stages: int, sequence_parallel: int = 1,
                            dynchunk_size=None) -> None:
    """Raise where pipeline parallelism over `stages` cannot apply, in the
    JAX package's words where it has them (`trainer.py:341-354`,
    `encoder_parallel.py:134-144`)."""
    if encoder_module != "conmamba":
        raise ValueError(
            f"pipeline_stages needs the ConMamba encoder (got {encoder_module!r}): "
            "the pipelined stack is ConMamba's layer stack")
    if not scan_layers:
        raise ValueError("pipeline_stages > 1 needs model.scan_layers=true (stacked "
                         "per-layer params are the stage assignment)")
    if num_layers % stages:
        raise ValueError(f"{num_layers} layers not divisible into {stages} pipeline stages")
    if sequence_parallel > 1:
        raise ValueError("sequence_parallel and pipeline_stages cannot combine (yet): "
                         "both re-wire the same encoder stack")
    if dynchunk_size is not None:
        raise ValueError("dynamic-chunk training is not wired through the sp/pp encoder path")


def stage_layers(num_layers: int, pipe: Axis) -> range:
    """The indices of the encoder layers this pipe rank's stage holds."""
    per = num_layers // pipe.size
    return range(pipe.index * per, (pipe.index + 1) * per)


def pp_encoder_apply(encoder: nn.Module, x: torch.Tensor, pipe: Axis,
                     n_microbatches: int) -> torch.Tensor:
    """x (B, T', d_model), the same on every rank of the pipe line -> the
    stack's output (B, T', d_model) on every rank: this rank's stage of
    `encoder.layers` on the GPipe schedule over n_microbatches, then the
    final LayerNorm. Only this stage's layers are read."""
    layers = [encoder.layers[i] for i in stage_layers(len(encoder.layers), pipe)]
    stage_fn = stage_from_layer_fn(lambda layer, h: run_layer(layer, encoder.remat, h), layers)
    y = pipeline_apply(stage_fn, x, n_microbatches, pipe)
    return layer_norm(y, encoder.norm.norm, encoder.dtype)


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
