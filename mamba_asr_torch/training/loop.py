"""The epoch loop of the CTC recipes (port of mamba_asr_tpu/training/
loop.py:Trainer, CTC only, one device).

- Each training epoch runs the step `training.trainer.Trainer.train_step`
  over the loader's batches, with the normaliser updated while
  epoch <= train.normalizer_update_epochs. The losses stay on the device
  until the epoch ends and are read once then; steps.jsonl gets a line
  every 50 steps (that line reads the loss and grad norm).
- Each epoch validates by greedy CTC (WER and CER), writes a train_log.txt
  row and saves a checkpoint kept among the best by WER.
- `init_state` resumes from the training checkpoint of the highest epoch.
- `evaluate` averages the best checkpoints' parameters, decodes a test
  set (with `ctc_decoder`, the CTC prefix beam search, or greedily), saves
  the averaged model as `averaged_<split>` and writes `wer_<split>.txt`.

Configurations with a decoder (S2S training) raise until ROADMAP slice
3b item 2; `train.use_wandb` raises (no network on the card machine).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from mamba_asr_torch.configs.loader import ExperimentConfig
from mamba_asr_torch.data.dataset import BucketedLoader, prefetch_iterator
from mamba_asr_torch.decoding.ctc_beam import ctc_beam_search
from mamba_asr_torch.decoding.ctc_greedy import ctc_greedy_decode, tokens_to_lists
from mamba_asr_torch.models.asr import ASRModel
from mamba_asr_torch.serving.recognizer import eval_step
from mamba_asr_torch.training.checkpoint import CheckpointManager
from mamba_asr_torch.training.logger import FileTrainLogger, JsonlLogger
from mamba_asr_torch.training.metrics import ErrorRateStats
from mamba_asr_torch.training.normalizer import NormalizerState
from mamba_asr_torch.training.trainer import Trainer as StepTrainer

STEP_KEYS = ("wav", "wav_lens", "tokens", "token_lens", "weight")
Decoder = Callable[[Dict[str, np.ndarray], Dict[str, torch.Tensor]], List[List[int]]]


class Trainer:
    """Trains, validates, checkpoints and evaluates one CTC experiment.

    cfg: the whole experiment config; tokenizer: the char tokenizer;
    device: None means the CUDA card (raises without one), "cpu" the plain
    versions; state_dict: initial weights in the port's names (None:
    seeded from cfg.seed, as the JAX package seeds its init).
    """

    def __init__(self, cfg: ExperimentConfig, tokenizer,
                 device: Optional[Union[str, torch.device]] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None):
        if cfg.model.num_decoder_layers > 0:
            raise NotImplementedError(
                "training with a decoder (S2S) is not ported (ROADMAP slice 3b item 2)")
        if cfg.train.use_wandb:
            raise NotImplementedError("train.use_wandb: the wandb logger is not ported")
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.step = StepTrainer(cfg.model, cfg.frontend,
                                dataclasses.replace(cfg.train, seed=cfg.seed),
                                cfg.specaug, state_dict=state_dict, device=device)
        self.device = self.step.device
        out_dir = cfg.output_folder
        self.ckpt = CheckpointManager(os.path.join(out_dir, "save"),
                                      keep=cfg.train.keep_checkpoints)
        self.logger = FileTrainLogger(os.path.join(out_dir, "train_log.txt"))
        self.steps_logger = JsonlLogger(os.path.join(out_dir, "steps.jsonl"))
        self.start_epoch = 1
        self.initialized = False
        self.loss_history: List[float] = []
        # One dict per epoch of fit(): the train_log.txt row, plus the
        # training pass's seconds and audio seconds (weight > 0 rows).
        self.epoch_log: List[dict] = []
        self.test_stats: Dict[str, Dict[str, float]] = {}  # evaluate()'s, by split

    # -- state ----------------------------------------------------------------

    @property
    def micro_steps(self) -> int:
        return self.step.optimizer.micro_steps

    def state(self) -> dict:
        """What a checkpoint holds (with the epoch, which fit adds): the
        model's state dict, the optimizer's state, the normaliser (count,
        mean, m2), the micro-step count and the dropout and SpecAugment
        random state (JAX derives each step's key from the seed, the epoch
        and the step, so its resume is exact; restoring the generators
        makes the port's so)."""
        tr = self.step
        return {"model": {k: v.detach().cpu() for k, v in tr.model.state_dict().items()},
                "optimizer": tr.optimizer.state_dict(),
                "normalizer": {k: v.cpu() for k, v in tr.normalizer._asdict().items()},
                "step": self.micro_steps, "rng": tr.rng_state()}

    def load_state(self, state: dict) -> None:
        tr = self.step
        tr.model.load_state_dict(state["model"], strict=True)
        tr.optimizer.load_state_dict(state["optimizer"])
        tr.normalizer = NormalizerState(**{k: v.to(self.device)
                                           for k, v in state["normalizer"].items()})
        tr.set_rng_state(state["rng"])

    def init_state(self) -> None:
        """Resume from the training checkpoint of the highest epoch, if any
        (averaged checkpoints carry no epoch and are never candidates)."""
        candidates = [e for e in self.ckpt._entries() if "epoch" in e.get("metrics", {})]
        if candidates:
            meta = max(candidates, key=lambda e: e["metrics"]["epoch"])
            self.load_state(self.ckpt.restore(meta["name"]))
            self.start_epoch = int(meta["metrics"]["epoch"]) + 1
            print(f"resumed from checkpoint at epoch {self.start_epoch - 1}")
        self.initialized = True

    # -- training -------------------------------------------------------------

    def train_epoch(self, loader: BucketedLoader, epoch: int) -> Tuple[List[float], float]:
        """One pass over the loader's epoch: (the micro-steps' losses, read
        from the device once at the end; the seconds of audio in the
        batches' rows of weight > 0)."""
        update_norm = epoch <= self.cfg.train.normalizer_update_epochs
        losses, samples = [], 0
        for i, batch in enumerate(prefetch_iterator(loader.epoch(epoch),
                                                    size=self.cfg.data.prefetch_batches)):
            m = self.step.train_step({k: batch[k] for k in STEP_KEYS}, update_norm=update_norm)
            losses.append(m["loss"])
            samples += int(batch["wav_lens"][batch["weight"] > 0].sum())
            if i % 50 == 0:
                self.steps_logger.log(epoch=epoch, step=self.micro_steps,
                                      loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
        losses = torch.stack(losses).tolist() if losses else []
        return losses, samples / self.cfg.data.sample_rate

    def fit(self, train_loader: BucketedLoader, valid_loader: Optional[BucketedLoader] = None,
            epochs: Optional[int] = None) -> None:
        epochs = epochs or self.cfg.train.number_of_epochs
        if not self.initialized:
            self.init_state()
        for epoch in range(self.start_epoch, epochs + 1):
            t0 = time.time()
            losses, audio_s = self.train_epoch(train_loader, epoch)
            train_sec = time.time() - t0
            train_stats = {"loss": float(np.mean(losses)) if losses else 0.0}
            self.loss_history.extend(losses)
            valid_stats = self.validate(valid_loader) if valid_loader is not None else {}
            meta = {"epoch": epoch, "steps": self.micro_steps,
                    "epoch_sec": round(time.time() - t0, 1)}
            self.logger.log_stats(meta, train_stats=train_stats, valid_stats=valid_stats)
            if valid_stats:
                self.ckpt.save({**self.state(), "epoch": epoch},
                               metrics={**valid_stats, "epoch": epoch}, min_keys=("WER",))
            self.epoch_log.append({
                **meta, "epoch_sec": time.time() - t0, "train_sec": train_sec,
                "train_audio_s": audio_s, "train": train_stats, "valid": valid_stats})

    # -- validation and test --------------------------------------------------

    def _decode_set(self, model: ASRModel, normalizer: NormalizerState,
                    loader: BucketedLoader, decoder: Optional[Decoder]):
        """(WER stats, CER stats) of the model over the loader's epoch 0;
        greedy CTC unless a decoder is given. Pad rows are left out."""
        wer, cer = ErrorRateStats(), ErrorRateStats(split_tokens=True)
        was_training = model.training
        model.eval()
        for batch in prefetch_iterator(loader.epoch(0), size=self.cfg.data.prefetch_batches):
            out = eval_step(model, self.cfg.frontend, normalizer,
                            torch.from_numpy(batch["wav"]), torch.from_numpy(batch["wav_lens"]))
            real = int(batch["weight"].sum())
            if decoder is None:
                toks, lens = ctc_greedy_decode(out["ctc_log_probs"], out["enc_lengths"])
                hyp_ids = tokens_to_lists(toks.cpu().numpy(), lens.cpu().numpy())
            else:
                hyp_ids = decoder(batch, out)
            hyps = [self.tokenizer.decode(t) for t in hyp_ids][:real]
            refs = [self.tokenizer.decode(list(batch["tokens"][i, :batch["token_lens"][i]]))
                    for i in range(real)]
            wer.append(batch["ids"][:real], hyps, refs)
            cer.append(batch["ids"][:real], hyps, refs)
        model.train(was_training)
        return wer, cer

    def validate(self, loader: BucketedLoader) -> Dict[str, float]:
        """Greedy-CTC WER and CER of the current model."""
        wer, cer = self._decode_set(self.step.model, self.step.normalizer, loader, None)
        return {"WER": wer.summarize()["WER"], "CER": cer.summarize()["WER"]}

    def ctc_decoder(self) -> Decoder:
        """The CTC recipes' test decoder: the prefix beam search with the
        decode stanza's beam (100) and pruning, on the model's device."""
        d = self.cfg.decode

        def decode(batch, out):
            toks, lens = ctc_beam_search(
                out["ctc_log_probs"], out["enc_lengths"], beam_size=d.test_beam_size,
                blank_id=d.blank_index, beam_prune_logp=d.beam_prune_logp,
                token_prune_min_logp=d.token_prune_min_logp)
            return tokens_to_lists(toks.cpu().numpy(), lens.cpu().numpy())

        return decode

    def evaluate(self, loader: BucketedLoader, test_name: str = "test",
                 decoder: Optional[Decoder] = None) -> Dict[str, float]:
        """Decode a test set with the average of the train.avg_checkpoints
        best checkpoints (by WER; the current model when there is none);
        the optimizer and normaliser are the best checkpoint's. Saves that
        state as `averaged_<test_name>` and writes the per-utterance
        alignments to wer_<test_name>.txt."""
        model, normalizer = self.step.model, self.step.normalizer
        restored = self.ckpt.restore_averaged(k=self.cfg.train.avg_checkpoints,
                                              min_key="WER")
        if restored is None:
            state = self.state()
        else:
            best, avg = restored
            state = {**best, "model": avg}
            model = ASRModel(self.cfg.model)
            model.load_state_dict(avg, strict=True)
            model = model.to(self.device)
            normalizer = NormalizerState(**{k: v.to(self.device)
                                            for k, v in best["normalizer"].items()})
        wer, cer = self._decode_set(model, normalizer, loader, decoder)
        summary = {"WER": wer.summarize()["WER"], "CER": cer.summarize()["WER"]}
        self.ckpt.save(state, metrics={**summary, "averaged": True},
                       name=f"averaged_{test_name}")
        out_path = os.path.join(self.cfg.output_folder, f"wer_{test_name}.txt")
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as f:
            wer.write_stats(f)
        self.logger.log_stats({"test_set": test_name}, test_stats=summary)
        self.test_stats[test_name] = summary
        return summary

