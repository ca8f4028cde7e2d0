"""The training step (port of mamba_asr_tpu/training/trainer.py:
make_train_step and init_train_state, with its sequence- and
pipeline-parallel branches).

    fbank -> masked normaliser update -> normalise -> SpecAugment (time
    warp, time and frequency drops) -> model in train mode (dropout) ->
    CTC loss (batchmean, weights); with a decoder also the teacher-forced
    KL loss, joined as ctc_weight * CTC + (1 - ctc_weight) * KL ->
    backward (the scan's adjoint is K2 on the card) -> running-mean
    accumulation over k micro-steps -> clip 5.0 -> AdamW with Noam

`Trainer` holds the model, the optimizer and the normaliser on its
device; `train_step(batch)` takes one micro-step (the eval form is
`serving.recognizer.eval_step`). Random bits: dropout draws from torch's
default generator for the device, SpecAugment (the warp's draws too) from
the Trainer's own `torch.Generator`; both are seeded from
`TrainConfig.seed`. They are not the JAX package's bits. The epoch loop
(`training/loop.py`) drives it.

Given a mesh (`parallel/mesh.py`, one process per rank), a micro-step
takes this rank's rows of the global batch:
- the ranks' batch statistics are merged over the data axis in rank
  order before they enter the normaliser (JAX updates it from the whole
  batch; `update_normalizer` is a Chan merge, so this is the same up to
  rounding);
- the batchmean losses divide by the weight summed over the data axis,
  not by each rank's own (ranks of a partial batch hold unequal real
  rows, where an average of the ranks' means would be wrong);
- with a seq axis of n > 1 ranks (`parallel.sequence_parallel`), the
  ConMamba stack runs on this rank's time shard (`encode_pre` ->
  `parallel/encoder_parallel.py:sp_encoder_apply` -> `forward_from_enc`)
  and each rank's copy of the loss is scaled by 1 / n, since every
  gather's backward sums over the ranks;
- with a pipe axis of n > 1 ranks (`parallel.pipeline_stages`), the
  ConMamba stack runs as n stages on the GPipe schedule (`encode_pre` ->
  `parallel/encoder_parallel.py:pp_encoder_apply` -> `forward_from_enc`),
  each rank's copy of the loss scaled by 1 / n alike. Each rank holds on
  its device only its own stage's layers (the others' sit on the meta
  device) and their AdamW moments; the front end, the projection, the
  stack's final LN, the heads and any decoder are held by every rank
  (JAX's `place_state(pipeline_layers=)`);
- with a model axis of n > 1 ranks (`parallel.tensor_parallel`), each
  rank holds its slice of every parameter JAX's rule shards
  (parallel/tensor.py, at `min_shard_elements`) and the moments and
  accumulator of that slice; the sharded Linears compute their own
  output columns and gather them, the other sharded parameters are
  gathered before use, and each rank's copy of the loss is scaled by
  1 / n alike (tensor parallelism does not combine with sp or pp);
- after the backward the gradients are summed: the parameters every rank
  holds over the world, a stage's layers or a parameter's slice over the
  data axis (the ranks holding that stage or slice), before the global
  norm and the clip; under pp or tp the norm adds the stages' or slices'
  squares over the pipe or model axis in float64, so every rank clips by
  the whole model's norm; the returned losses are the global ones.
`model_state`, `optimizer_state` and `eval_model` give the whole model
and its optimizer state in a single process's layout (under pp or tp,
collectives that gather the stages over the pipe axis or the slices over
the model axis), and `load_model_state` / `load_optimizer_state` take
that layout back.
The port sums with its own flat all-reduce (parallel/collectives.py), not
DDP: the loss is normalised by the global weight, so the gradients must
be summed, not averaged; the sp forward is split around a module call DDP
would wrap; and one world-size-1 step is bit-equal to the plain one.
Random draws: the dropout and SpecAugment generators are seeded from the
data rank (rank 0's are a single process's), so the ranks of a seq,
pipe or model line, which hold the same rows, draw the same masks outside
the stack; inside it dropout draws from a stream that also folds in the
seq or pipe rank (never the model rank: a model line's ranks compute the
same activations, and their masks must agree everywhere).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from mamba_asr_torch.data.augment import spec_augment
from mamba_asr_torch.models.asr import ASRConfig, ASRModel, init_params_, xavier_reinit_
from mamba_asr_torch.ops.ctc import ctc_loss
from mamba_asr_torch.ops.fbank import log_mel_spectrogram
from mamba_asr_torch.parallel import collectives
from mamba_asr_torch.parallel.encoder_parallel import (
    DeviceRngStream,
    check_pipeline_parallel,
    check_sequence_parallel,
    pp_encoder_apply,
    sp_encoder_apply,
    stage_layers,
)
from mamba_asr_torch.parallel.mesh import Mesh
from mamba_asr_torch.parallel.tensor import (
    MIN_SHARD_ELEMENTS,
    TensorParallel,
    check_tensor_parallel,
)
from mamba_asr_torch.training.normalizer import (
    NormalizerState,
    apply_normalizer,
    batch_stats,
    init_normalizer,
    merge_stats,
    update_normalizer,
)
from mamba_asr_torch.training.losses import joint_ctc_attention_loss, kldiv_loss
from mamba_asr_torch.training.optim import global_norm, make_optimizer
from mamba_asr_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    """hparams/CTC/conmamba_large.yaml:273-320 (a copy of the JAX package's
    SpecAugmentConfig, so every YAML loads): the time warps, the time and
    frequency drops, and the Augmenter's batch enlargement
    (`concat_original`, `repeat_augment`: [the original batch?; that many
    augmented copies], labels and weights replicated)."""

    enabled: bool = True
    num_time_drops: int = 4
    time_drop_width: int = 20
    num_freq_drops: int = 4
    freq_drop_width: int = 10
    apply_time_warp: bool = False
    time_warp_window: int = 5
    time_warp_mode: str = "bicubic"
    concat_original: bool = False
    repeat_augment: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """A copy of the JAX package's TrainConfig. `rng_impl`, `use_wandb`
    and `wandb_project` change nothing here; `ctc_weight` and
    `label_smoothing` act only with a decoder; `dynchunk_size` (encoder
    frames) and `dynchunk_left_context` (chunks) train the encoder on
    chunked attention and convolution (models/asr.py:ASRModel.encode)."""

    lr: float = 1e-3
    warmup_steps: int = 7500
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-9
    weight_decay: float = 5e-4
    grad_accumulation_factor: int = 4
    max_grad_norm: float = 5.0
    ctc_weight: float = 1.0
    label_smoothing: float = 0.0
    normalizer_update_epochs: int = 4
    number_of_epochs: int = 500
    keep_checkpoints: int = 10
    avg_checkpoints: int = 10
    seed: int = 3407
    scheduler_steps_per_update: int = 1
    dynchunk_size: Optional[int] = None
    dynchunk_left_context: Optional[int] = None
    use_wandb: bool = False
    wandb_project: str = "mamba-asr-tpu"
    rng_impl: str = "threefry2x32"


REPLICATED_KEYS = ("tokens", "token_lens", "tokens_bos", "tokens_eos", "eos_lens", "weight")


def fold_seed(seed: int, *keys) -> int:
    """A seed for the coordinates `keys` (e.g. the data rank): `seed`
    itself where every key is 0, so rank 0 draws what one process draws;
    otherwise a hash of (seed, keys)."""
    if not any(keys):
        return seed
    digest = hashlib.sha256(repr((seed,) + tuple(keys)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class Trainer:
    """One ConMamba model (CTC, or CTC + Transformer decoder) in training
    on its device.

    cfg, frontend, train, specaug: the YAML's `model`, `frontend`, `train`
    and `specaug` stanzas (`configs.loader.load_config`). state_dict: the
    port's ASRModel state dict (e.g. from `models.params_import`), or None
    for seeded weights (the JAX package's init rules, from train.seed).
    normalizer: (count, mean, m2) to start from, or None for empty
    statistics. device: None means the CUDA card (raises without one);
    "cpu" runs the plain versions. mesh: this rank's place in a
    multi-process run (see the module doc), or None for one process.
    microbatches: the pipeline's per-rank microbatch count
    (`parallel.pipeline_microbatches`), required when the mesh has a pipe
    axis and read only then. min_shard_elements: the tensor-parallel
    rule's size threshold (`parallel.min_shard_elements`), read only when
    the mesh has a model axis.
    """

    def __init__(
        self,
        cfg: ASRConfig,
        frontend,
        train: TrainConfig = TrainConfig(),
        specaug: SpecAugmentConfig = SpecAugmentConfig(),
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        normalizer: Optional[Sequence] = None,
        device: Optional[Union[str, torch.device]] = None,
        mesh: Optional[Mesh] = None,
        microbatches: Optional[int] = None,
        min_shard_elements: int = MIN_SHARD_ELEMENTS,
    ):
        self.device = resolve_device(device)
        self.mesh, self.cfg, self.microbatches = mesh, cfg, microbatches
        self.n_seq = 1 if mesh is None else mesh.seq.size
        self.n_pipe = 1 if mesh is None else mesh.pipe.size
        self.n_model = 1 if mesh is None else mesh.model.size
        check_tensor_parallel(self.n_model, self.n_seq, self.n_pipe)
        if self.n_seq > 1:
            check_sequence_parallel(cfg.encoder_module, train.dynchunk_size)
        if self.n_pipe > 1:
            check_pipeline_parallel(cfg.encoder_module, cfg.scan_layers, cfg.num_encoder_layers,
                                    self.n_pipe, self.n_seq, train.dynchunk_size)
            if microbatches is None:
                raise ValueError("a pipe axis needs the microbatch count "
                                 "(parallel.pipeline_microbatches)")
        d, s, p = (0, 0, 0) if mesh is None else (mesh.data.index, mesh.seq.index,
                                                  mesh.pipe.index)
        torch.manual_seed(fold_seed(train.seed, d))  # dropout masks
        model = ASRModel(cfg)
        if state_dict is None:
            init = torch.Generator().manual_seed(train.seed)
            init_params_(model, init)
            if cfg.xavier_parity_init:  # JAX's init_train_state: fresh weights only
                xavier_reinit_(model, init)
        else:
            model.load_state_dict(state_dict, strict=True)
        self.stage = (range(cfg.num_encoder_layers) if self.n_pipe == 1
                      else stage_layers(cfg.num_encoder_layers, mesh.pipe))
        for i in range(cfg.num_encoder_layers):
            if i not in self.stage:  # another stage's: no storage on this rank
                model.encoder.layers[i].to("meta")
        self.tp = None
        if self.n_model > 1:  # this rank's slices, cut before the move
            self.tp = TensorParallel(model, cfg, mesh.model, min_shard_elements)
            self.tp.shard(model)
        self.model = model._apply(lambda t: t if t.is_meta else t.to(self.device)).train()
        self.optimizer = make_optimizer(self.model, train, self._global_norm)
        # Each stack layer's name in the model, and for each optimizer
        # parameter whether only part of the world holds it: this stage's
        # own layers (pp) or this rank's slice (tp), summed over the data
        # axis alone.
        names = {id(m): n for n, m in self.model.named_modules()}
        self.layer_names = [names[id(layer)] for layer in self.model.encoder.layers]
        own = {id(p) for i in self.stage for p in self.model.encoder.layers[i].parameters()}
        sliced = set() if self.tp is None else set(self.tp.shards)
        self.partial = [(self.n_pipe > 1 and id(p) in own) or n in sliced
                        for n, p in zip(self.optimizer.names, self.optimizer.params)]
        if normalizer is None:
            self.normalizer = init_normalizer(frontend.n_mels, self.device)
        else:
            self.normalizer = NormalizerState.from_arrays(*normalizer, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            fold_seed(train.seed + 1, d))
        # Dropout inside the sharded stack: its own stream per (data, seq or
        # pipe) rank (sp and pp do not combine).
        self.stack_rng = (DeviceRngStream(self.device, fold_seed(train.seed + 2, d, s + p + 1))
                          if self.n_seq * self.n_pipe > 1 else None)
        self.frontend, self.specaug, self.train = frontend, specaug, train

    def rng_state(self) -> Dict[str, torch.Tensor]:
        """The random state of the dropout masks (the device's default
        generator) and of SpecAugment (`self.generator`), as CPU byte
        tensors: a checkpoint holds it so that a resumed run draws what an
        uninterrupted one would."""
        if self.device.type == "cuda":
            dropout = torch.cuda.get_rng_state(self.device)
        else:
            dropout = torch.get_rng_state()
        out = {"dropout": dropout, "specaug": self.generator.get_state()}
        if self.stack_rng is not None:
            out["stack"] = self.stack_rng.state.clone()
        return out

    def set_rng_state(self, state: Mapping[str, torch.Tensor]) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_rng_state(state["dropout"], self.device)
        else:
            torch.set_rng_state(state["dropout"])
        self.generator.set_state(state["specaug"])
        if self.stack_rng is not None and "stack" in state:
            self.stack_rng.state = state["stack"].clone()

    def _features(self, wav: torch.Tensor, wav_lens: torch.Tensor):
        fe = self.frontend
        feats = log_mel_spectrogram(
            wav, sample_rate=fe.sample_rate, n_fft=fe.n_fft, n_mels=fe.n_mels,
            win_length_ms=fe.win_length_ms, hop_length_ms=fe.hop_length_ms,
        )
        flens = torch.clamp_max(wav_lens // fe.hop + 1, feats.shape[1])
        return feats, flens

    def _augment(self, feats: torch.Tensor, flens: torch.Tensor, b: Dict[str, torch.Tensor]):
        """SpecAugment; with concat_original or repeat_augment > 1 the
        Augmenter's enlarged batch (JAX `trainer.py:405-429`): [feats?;
        repeat_augment augmented copies], each copy's draws following the
        last's from `self.generator` (JAX folds a key per copy), flens and
        the REPLICATED_KEYS tiled to match."""
        sa = self.specaug

        def aug(f):
            return spec_augment(
                f, self.generator, num_time_drops=sa.num_time_drops,
                time_drop_width=sa.time_drop_width, num_freq_drops=sa.num_freq_drops,
                freq_drop_width=sa.freq_drop_width, apply_time_warp=sa.apply_time_warp,
                time_warp_window=sa.time_warp_window, time_warp_mode=sa.time_warp_mode)

        reps = max(sa.repeat_augment, 1)
        if not sa.concat_original and reps == 1:
            return aug(feats), flens, b
        parts = ([feats] if sa.concat_original else []) + [aug(feats) for _ in range(reps)]
        n = len(parts)
        b = {k: (v.repeat(n, *([1] * (v.dim() - 1))) if k in REPLICATED_KEYS else v)
             for k, v in b.items()}
        return torch.cat(parts), flens.repeat(n), b

    def train_step(self, batch: Mapping[str, object], update_norm: bool = True
                   ) -> Dict[str, torch.Tensor]:
        """One micro-step on batch = {wav (B, T) float32, wav_lens (B,),
        tokens (B, S), token_lens (B,), weight (B,)}, with a decoder also
        tokens_bos, tokens_eos (B, S+1) and eos_lens (B,) (arrays or
        tensors). update_norm: merge this batch into the normaliser's
        statistics first (the JAX loop does while epoch <=
        normalizer_update_epochs). Returns 0-d tensors on the device:
        loss, loss_ctc (and loss_att with a decoder), grad_norm (the global
        norm of this micro-step's gradients) and updated (whether the
        parameters changed)."""
        dev, mesh = self.device, self.mesh
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        weight = b["weight"].float()
        with torch.no_grad():
            feats, flens = self._features(b["wav"].float(), b["wav_lens"])
            if update_norm:
                t = feats.shape[1]
                fmask = ((torch.arange(t, device=dev)[None, :] < flens[:, None])
                         & (weight[:, None] > 0))
                if mesh is None:
                    self.normalizer = update_normalizer(self.normalizer, feats, fmask)
                else:
                    self.normalizer = merge_stats(self.normalizer,
                                                  self._global_stats(feats, fmask))
            feats = apply_normalizer(self.normalizer, feats)
            if self.specaug.enabled:
                feats, flens, b = self._augment(feats, flens, b)
        weight = b["weight"].float()
        self.model.train()
        n_line = self.n_seq * self.n_pipe * self.n_model  # the ranks that hold these rows
        self.model.zero_grad(set_to_none=True)
        with self._materialized():
            metrics, loss = self._forward(feats, flens, b, weight)
            (loss / n_line if n_line > 1 else loss).backward()
        if mesh is not None:
            params, partial = self.optimizer.params, self.partial
            collectives.reduce_grads_([p for p, part in zip(params, partial) if not part],
                                      mesh.world)
            if self.n_pipe * self.n_model > 1:  # over the ranks holding the stage or slice
                collectives.reduce_grads_([p for p, part in zip(params, partial) if part],
                                          mesh.data)
            metrics = self._global_metrics(metrics)
        grad_norm = self._global_norm([p.grad for p in self.optimizer.params]).float()
        updated = self.optimizer.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        return {**metrics, "grad_norm": grad_norm, "updated": torch.tensor(updated)}

    def _materialized(self):
        """The step's context: under tp the sharded parameters read raw are
        whole within (parallel/tensor.py)."""
        return contextlib.nullcontext() if self.tp is None else self.tp.materialized()

    def _forward(self, feats, flens, b, weight):
        """The model and the losses: ({loss, loss_ctc[, loss_att]}, loss)."""
        mesh, tc = self.mesh, self.train
        use_decoder = self.model.has_decoder
        tokens_bos = b["tokens_bos"] if use_decoder else None
        if self.n_seq * self.n_pipe > 1:
            x, enc_lengths = self.model.encode_pre(feats, flens)
            with self.stack_rng.swapped():
                if self.n_seq > 1:
                    enc = sp_encoder_apply(self.model.encoder, x, mesh.seq)
                else:
                    enc = pp_encoder_apply(self.model.encoder, x, mesh.pipe, self.microbatches)
            out = self.model.forward_from_enc(enc, enc_lengths, tokens_bos)
        else:
            out = self.model(feats, flens, tokens_bos, chunk_size=tc.dynchunk_size,
                             left_context_chunks=tc.dynchunk_left_context)
        if mesh is None:
            reduction, denom = "batchmean", None
        else:  # this rank's share of the global batchmean
            reduction = "sum"
            denom = torch.clamp_min(collectives.reduce_(weight.sum(), mesh.data), 1.0)
        loss_ctc = ctc_loss(out["ctc_log_probs"], b["tokens"], out["enc_lengths"],
                            b["token_lens"], reduction=reduction, weight=weight)
        if denom is not None:
            loss_ctc = loss_ctc / denom
        metrics = {"loss_ctc": loss_ctc}
        if use_decoder:
            loss_att = kldiv_loss(out["seq_log_probs"], b["tokens_eos"], b["eos_lens"],
                                  label_smoothing=self.train.label_smoothing,
                                  reduction=reduction, weight=weight)
            if denom is not None:
                loss_att = loss_att / denom.to(loss_att)
            loss = joint_ctc_attention_loss(loss_ctc, loss_att, self.train.ctc_weight)
            metrics["loss_att"] = loss_att
        else:
            loss = loss_ctc
        return {"loss": loss, **metrics}, loss

    def _global_stats(self, feats: torch.Tensor, fmask: torch.Tensor) -> NormalizerState:
        """The batch statistics of the data axis's ranks, merged in rank
        order (rank 0's as they are)."""
        mine = batch_stats(feats, fmask)
        rows = collectives.all_gather(torch.cat([mine.count[None], mine.mean, mine.m2]),
                                      self.mesh.data)
        f = mine.mean.shape[0]
        stats = None
        for row in rows:
            part = NormalizerState(row[0], row[1:1 + f], row[1 + f:])
            stats = part if stats is None else merge_stats(stats, part)
        return stats

    def _global_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each rank's losses summed over the world: the global batch's
        (each rank of a seq, pipe or model line holds the whole loss, hence
        the 1 / n)."""
        vals = torch.stack([v.detach().float() for v in metrics.values()])
        n_line = self.n_seq * self.n_pipe * self.n_model
        if n_line > 1:
            vals = vals / n_line
        vals = collectives.reduce_(vals, self.mesh.world)
        return dict(zip(metrics, vals.unbind()))

    # -- pipeline stages and parameter slices: the norm and the whole state ----------

    def _global_norm(self, grads: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        """The float64 global norm of the optimizer parameters' gradients
        (None counts as zeros); under pp the stages' squares are summed over
        the pipe axis, under tp the slices' over the model axis, so every
        rank has the whole model's norm."""
        if self.n_pipe * self.n_model == 1:
            return global_norm([g for g in grads if g is not None])
        partial = self.partial
        held = [g for g, part in zip(grads, partial) if g is not None and not part]
        mine = [g for g, part in zip(grads, partial) if g is not None and part]
        zero = torch.zeros((), dtype=torch.float64, device=self.device)
        sq_part = (global_norm(mine) ** 2 if mine else zero).reshape(1)
        sq_part = collectives.reduce_(sq_part, self.mesh.pipe if self.n_pipe > 1
                                      else self.mesh.model)[0]
        sq_held = global_norm(held) ** 2 if held else zero
        return torch.sqrt(sq_held + sq_part)

    def _gather_stages(self, mine: Sequence[Mapping[object, torch.Tensor]]
                       ) -> Dict[int, Dict[object, torch.Tensor]]:
        """{layer index: its entries (CPU tensors)} for every stack layer,
        from `mine`, the entries of this stage's layers in stage order (every
        layer has the same keys): one float32 gather over the pipe axis,
        each stage's row read at its own layers (`stage_layers`)."""
        pipe = self.mesh.pipe
        keys = [sorted(entries) for entries in mine]
        with torch.no_grad():
            flat = torch.cat([entries[k].detach().reshape(-1).to(self.device, torch.float32)
                              for entries, ks in zip(mine, keys) for k in ks])
            rows = collectives.all_gather(flat, pipe).cpu()
        out = {}
        for stage, row in enumerate(rows):
            offset = 0
            layers = stage_layers(self.cfg.num_encoder_layers,
                                  dataclasses.replace(pipe, index=stage))
            for i, entries, ks in zip(layers, mine, keys, strict=True):
                out[i] = {}
                for k in ks:
                    like = entries[k]
                    out[i][k] = row[offset:offset + like.numel()].view(like.shape).to(like.dtype)
                    offset += like.numel()
        return out

    def model_state(self) -> Dict[str, torch.Tensor]:
        """A copy of the whole model's state dict on the CPU, in a single
        process's layout. Collective under pp and tp: every rank of the world
        calls it."""
        sd = self.model.state_dict()
        if self.tp is not None:
            return self.tp.gather_state(sd, self.device)
        if self.n_pipe > 1:
            layers = self.model.encoder.layers
            gathered = self._gather_stages([layers[i].state_dict() for i in self.stage])
            for i, entries in gathered.items():
                sd.update({f"{self.layer_names[i]}.{k}": v for k, v in entries.items()})
        return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}

    def load_model_state(self, sd: Mapping[str, torch.Tensor]) -> None:
        """Load a single process's state dict (every key, as strict
        loading demands); under pp this rank keeps its own stage's layers,
        under tp its own slices."""
        mine = self.model.state_dict()
        if set(sd) != set(mine):
            raise KeyError(f"state dict keys differ: missing {sorted(set(mine) - set(sd))[:5]}, "
                           f"unexpected {sorted(set(sd) - set(mine))[:5]}")
        if self.tp is not None:
            sd = self.tp.local_state(sd)
        self.model.load_state_dict({k: v for k, v in sd.items() if not mine[k].is_meta},
                                   strict=False)

    def optimizer_state(self) -> dict:
        """The optimizer's state dict (keyed by parameter name) for the
        whole model. Collective under pp and tp: the stages' (or slices')
        AdamW moments and accumulated gradients are gathered over the pipe
        (or model) axis."""
        sd = self.optimizer.state_dict()
        if self.tp is not None:
            return self._gather_slices(sd)
        if self.n_pipe == 1:
            return sd
        moments, acc, layers = sd["moments"], sd["acc"], self.model.encoder.layers
        mine = []
        for i in self.stage:
            entries = {}
            for k, _ in layers[i].named_parameters():
                name = f"{self.layer_names[i]}.{k}"
                entries.update({("moment", k, s): v for s, v in moments.get(name, {}).items()})
                entries[("acc", k)] = acc[name]
            mine.append(entries)
        for i, entries in self._gather_stages(mine).items():
            for (kind, k, *s), v in entries.items():
                name = f"{self.layer_names[i]}.{k}"
                if kind == "acc":
                    acc[name] = v
                else:
                    moments.setdefault(name, {})[s[0]] = v
        return sd

    def _gather_slices(self, sd: dict) -> dict:
        """An optimizer state dict of this rank's slices made whole: every
        sliced parameter's moments and accumulator gathered over the model
        axis in one collective."""
        entries = {(name, s): v for name, st in sd["moments"].items() for s, v in st.items()
                   if torch.is_tensor(v)}
        entries.update({(name, "acc"): v for name, v in sd["acc"].items()})
        whole = self.tp.gather_state(entries, self.device)
        moments = {name: dict(st) for name, st in sd["moments"].items()}
        for (name, s), v in whole.items():
            if s == "acc":
                sd["acc"][name] = v
            else:
                moments[name][s] = v
        return {**sd, "moments": moments}

    def load_optimizer_state(self, sd: dict) -> None:
        """Load an optimizer state dict of the whole model; under pp this
        rank takes its own parameters' entries, under tp its own slices."""
        if self.tp is not None:
            local = self.tp.local_state
            moments = {}
            for name, st in sd["moments"].items():
                cut = local({(name, s): v for s, v in st.items()})
                moments[name] = {s: cut[(name, s)] for s in st}
            acc = local({(name, "acc"): v for name, v in sd["acc"].items()})
            sd = {**sd, "moments": moments,
                  "acc": {name: acc[(name, "acc")] for name in sd["acc"]}}
        self.optimizer.load_state_dict(sd)

    def eval_model(self) -> ASRModel:
        """The whole model for evaluation: the trained one, or under pp or
        tp a copy on the device with every stage's layers and every slice
        (collective)."""
        if self.n_pipe * self.n_model == 1:
            return self.model
        with torch.random.fork_rng(devices=[]):  # its torch init draws nothing of ours
            model = ASRModel(self.cfg)
        model.load_state_dict(self.model_state(), strict=True)
        return model.to(self.device)
