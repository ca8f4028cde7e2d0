"""The CTC training step (port of mamba_asr_tpu/training/trainer.py:
make_train_step and init_train_state, without the sequence- and
pipeline-parallel branches).

    fbank -> masked normaliser update -> normalise -> SpecAugment ->
    model in train mode (dropout) -> CTC loss (batchmean, weights) ->
    backward (the scan's adjoint is K2 on the card) -> running-mean
    accumulation over k micro-steps -> clip 5.0 -> AdamW with Noam

`Trainer` holds the model, the optimizer and the normaliser on its
device; `train_step(batch)` takes one micro-step. Random bits: dropout
draws from torch's default generator for the device, SpecAugment from
the Trainer's own `torch.Generator`; both are seeded from
`TrainConfig.seed`. They are not the JAX package's bits.

The data pipeline, checkpoints, the epoch loop and the CLI wait for
slice 2b (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from mamba_asr_torch.data.augment import spec_augment
from mamba_asr_torch.models.asr import ASRConfig, ASRModel, init_params_
from mamba_asr_torch.ops.ctc import ctc_loss
from mamba_asr_torch.ops.fbank import log_mel_spectrogram
from mamba_asr_torch.training.normalizer import (
    NormalizerState,
    apply_normalizer,
    init_normalizer,
    update_normalizer,
)
from mamba_asr_torch.training.optim import global_norm, make_optimizer
from mamba_asr_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    """hparams/CTC/conmamba_large.yaml:273-320 (a copy of the JAX package's
    SpecAugmentConfig, so every YAML loads). The port runs the time and
    frequency drops; the warps and the Augmenter's concat/repeat modes
    wait for the S2S slice and raise."""

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
    `label_smoothing` act only with a decoder (not ported: ASRModel
    raises); dynamic-chunk training is not ported and raises."""

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


def _refuse_unported(train: TrainConfig, specaug: SpecAugmentConfig) -> None:
    if train.dynchunk_size is not None:
        raise NotImplementedError("dynamic-chunk training is not ported")
    if specaug.enabled and (specaug.concat_original or specaug.repeat_augment > 1):
        raise NotImplementedError("the Augmenter's concat/repeat modes are not ported")


class Trainer:
    """One ConMamba CTC model in training on its device.

    cfg, frontend, train, specaug: the YAML's `model`, `frontend`, `train`
    and `specaug` stanzas (`configs.loader.load_config`). state_dict: the
    port's ASRModel state dict (e.g. from `models.params_import`), or None
    for seeded weights (the JAX package's init rules, from train.seed).
    normalizer: (count, mean, m2) to start from, or None for empty
    statistics. device: None means the CUDA card (raises without one);
    "cpu" runs the plain versions.
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
    ):
        self.device = resolve_device(device)
        _refuse_unported(train, specaug)
        torch.manual_seed(train.seed)  # dropout masks
        model = ASRModel(cfg)
        if state_dict is None:
            init_params_(model, torch.Generator().manual_seed(train.seed))
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).train()
        self.optimizer = make_optimizer(self.model, train)
        if normalizer is None:
            self.normalizer = init_normalizer(frontend.n_mels, self.device)
        else:
            self.normalizer = NormalizerState.from_arrays(*normalizer, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(train.seed + 1)
        self.frontend, self.specaug = frontend, specaug

    def rng_state(self) -> Dict[str, torch.Tensor]:
        """The random state of the dropout masks (the device's default
        generator) and of SpecAugment (`self.generator`), as CPU byte
        tensors: a checkpoint holds it so that a resumed run draws what an
        uninterrupted one would."""
        if self.device.type == "cuda":
            dropout = torch.cuda.get_rng_state(self.device)
        else:
            dropout = torch.get_rng_state()
        return {"dropout": dropout, "specaug": self.generator.get_state()}

    def set_rng_state(self, state: Mapping[str, torch.Tensor]) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_rng_state(state["dropout"], self.device)
        else:
            torch.set_rng_state(state["dropout"])
        self.generator.set_state(state["specaug"])

    def _features(self, wav: torch.Tensor, wav_lens: torch.Tensor):
        fe = self.frontend
        feats = log_mel_spectrogram(
            wav, sample_rate=fe.sample_rate, n_fft=fe.n_fft, n_mels=fe.n_mels,
            win_length_ms=fe.win_length_ms, hop_length_ms=fe.hop_length_ms,
        )
        flens = torch.clamp_max(wav_lens // fe.hop + 1, feats.shape[1])
        return feats, flens

    def train_step(self, batch: Mapping[str, object], update_norm: bool = True
                   ) -> Dict[str, torch.Tensor]:
        """One micro-step on batch = {wav (B, T) float32, wav_lens (B,),
        tokens (B, S), token_lens (B,), weight (B,)} (arrays or tensors).
        update_norm: merge this batch into the normaliser's statistics
        first (the JAX loop does while epoch <= normalizer_update_epochs).
        Returns 0-d tensors on the device: loss, loss_ctc, grad_norm (the
        global norm of this micro-step's gradients) and updated (whether
        the parameters changed)."""
        dev = self.device
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        weight = b["weight"].float()
        with torch.no_grad():
            feats, flens = self._features(b["wav"].float(), b["wav_lens"])
            if update_norm:
                t = feats.shape[1]
                fmask = ((torch.arange(t, device=dev)[None, :] < flens[:, None])
                         & (weight[:, None] > 0))
                self.normalizer = update_normalizer(self.normalizer, feats, fmask)
            feats = apply_normalizer(self.normalizer, feats)
            sa = self.specaug
            if sa.enabled:
                feats = spec_augment(
                    feats, self.generator, num_time_drops=sa.num_time_drops,
                    time_drop_width=sa.time_drop_width,
                    num_freq_drops=sa.num_freq_drops,
                    freq_drop_width=sa.freq_drop_width,
                    apply_time_warp=sa.apply_time_warp,
                    time_warp_window=sa.time_warp_window,
                    time_warp_mode=sa.time_warp_mode,
                )
        self.model.train()
        out = self.model(feats, flens)
        loss_ctc = ctc_loss(out["ctc_log_probs"], b["tokens"], out["enc_lengths"],
                            b["token_lens"], reduction="batchmean", weight=weight)
        loss = loss_ctc
        self.model.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = global_norm([p.grad for p in self.optimizer.params
                                 if p.grad is not None]).float()
        updated = self.optimizer.step()
        return {"loss": loss.detach(), "loss_ctc": loss_ctc.detach(),
                "grad_norm": grad_norm, "updated": torch.tensor(updated)}
