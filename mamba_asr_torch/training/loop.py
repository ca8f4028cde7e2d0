"""The epoch loop of the recipes (port of mamba_asr_tpu/training/
loop.py:Trainer, one device): CTC, and joint CTC/attention (S2S) when
the config has a decoder.

- Each training epoch runs the step `training.trainer.Trainer.train_step`
  over the loader's batches, with the normaliser updated while
  epoch <= train.normalizer_update_epochs. The losses stay on the device
  until the epoch ends and are read once then; steps.jsonl gets a line
  every 50 steps (that line reads the loss and grad norm).
- Each epoch validates: greedy-CTC WER and CER; for S2S also the token
  accuracy (ACC) of the teacher-forced decoder, and every
  `decode.valid_search_interval` epochs the joint beam search
  (`valid_beam_size`) in place of greedy CTC for WER and CER. It writes a
  train_log.txt row and saves a checkpoint kept among the best by WER
  (CTC) or by ACC (S2S).
- `init_state` resumes from the training checkpoint of the highest epoch.
- `evaluate` averages the best checkpoints' parameters, decodes a test
  set (with `ctc_decoder`, the CTC prefix beam search; `s2s_decoder`, the
  joint beam search at `s2s_test_beam_size`; or greedily), saves the
  averaged model as `averaged_<split>` and writes `wer_<split>.txt`.

A decoder hook takes the model it decodes with: the S2S hook builds its
searcher at each call, so a bf16 searcher's cast copy of the decode
weights (`decoding/s2s_beam.py:cast_decode_weights`) is always the
current epoch's, or the averaged model's. An LM given to the Trainer
(`cli.load_lm`, from `decode.lm_path`) is fused into the test search
only, at lm_weight and temperature_lm; the validation search has none
(JAX `loop.py:121-127, 189`). Its bf16 copy is made once per Trainer:
the LM does not change during training. `train.use_wandb` raises (no
network on the card machine).

Multi-process (`mesh`, one process per rank; cli.py `--distributed`):
the training loader is process-sharded by the caller, the evaluation
loaders are not, and every rank validates and tests on them (as every
JAX process does), so each holds the same metrics. Rank 0 alone writes
train_log.txt, steps.jsonl, the checkpoints (it alone creates save/) and
wer_<split>.txt, with a barrier after each write; a checkpoint holds
every rank's generator states (`rng`, by world rank), and each rank
resumes from the same checkpoint with its own. Under pipeline
parallelism each rank holds one stage's layers, under tensor parallelism
its slices of the large parameters: a checkpoint holds the whole model
and optimizer state in a single process's layout (the stages gathered
over the pipe axis, the slices over the model axis: JAX's
`tree_fetch_global`), so it resumes in one process and one process's
resumes under pp or tp; validation and the test pass decode with the
whole model, gathered onto every rank
(`training.trainer.Trainer.eval_model`), not through the pipeline or the
slices.
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
from mamba_asr_torch.decoding.ctc_beam import ctc_beam_decode
from mamba_asr_torch.decoding.ctc_greedy import ctc_greedy_decode, tokens_to_lists
from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher, strip_special
from mamba_asr_torch.models.asr import ASRModel
from mamba_asr_torch.models.lm import TransformerLM, cast_lm_weights
from mamba_asr_torch.parallel.collectives import gather_bytes
from mamba_asr_torch.parallel.distributed import barrier
from mamba_asr_torch.parallel.mesh import Mesh
from mamba_asr_torch.serving.recognizer import eval_step
from mamba_asr_torch.training.checkpoint import CheckpointManager
from mamba_asr_torch.training.logger import FileTrainLogger, JsonlLogger
from mamba_asr_torch.training.metrics import AccuracyStats, ErrorRateStats
from mamba_asr_torch.training.normalizer import NormalizerState
from mamba_asr_torch.training.trainer import Trainer as StepTrainer

STEP_KEYS = ("wav", "wav_lens", "tokens", "token_lens", "weight")
S2S_KEYS = ("tokens_bos", "tokens_eos", "eos_lens")
# decode(model, batch, eval_step's outputs) -> token ids per row
Decoder = Callable[[ASRModel, Dict[str, np.ndarray], Dict[str, torch.Tensor]],
                   List[List[int]]]


class Trainer:
    """Trains, validates, checkpoints and evaluates one experiment.

    cfg: the whole experiment config; tokenizer: its tokenizer;
    device: None means the CUDA card (raises without one), "cpu" the plain
    versions; state_dict: initial weights in the port's names (None:
    seeded from cfg.seed, as the JAX package seeds its init); lm: the
    TransformerLM the test search fuses (on the same device), or None;
    mesh: this rank's place in a multi-process run, or None.
    """

    def __init__(self, cfg: ExperimentConfig, tokenizer,
                 device: Optional[Union[str, torch.device]] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 lm: Optional[TransformerLM] = None, mesh: Optional[Mesh] = None):
        if cfg.train.use_wandb:
            raise NotImplementedError("train.use_wandb: the wandb logger is not ported")
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main_process()
        self.step = StepTrainer(cfg.model, cfg.frontend,
                                dataclasses.replace(cfg.train, seed=cfg.seed),
                                cfg.specaug, state_dict=state_dict, device=device, mesh=mesh,
                                microbatches=cfg.parallel.pipeline_microbatches,
                                min_shard_elements=cfg.parallel.min_shard_elements)
        self.device = self.step.device
        self.is_s2s = cfg.model.num_decoder_layers > 0
        self.lm = None if lm is None else cast_lm_weights(lm)
        self.metric_key = "ACC" if self.is_s2s else "WER"
        self.step_keys = STEP_KEYS + (S2S_KEYS if self.is_s2s else ())
        out_dir = cfg.output_folder
        self.ckpt = CheckpointManager(os.path.join(out_dir, "save"),
                                      keep=cfg.train.keep_checkpoints, create=self.is_main)
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
        makes the port's so): `rng` lists every rank's, by world rank.
        Collective in a multi-process run: every rank calls it."""
        tr = self.step
        return {"model": tr.model_state(), "optimizer": tr.optimizer_state(),
                "normalizer": {k: v.cpu() for k, v in tr.normalizer._asdict().items()},
                "step": self.micro_steps, "rng": self._all_rng_states()}

    def _all_rng_states(self) -> List[Dict[str, torch.Tensor]]:
        mine = self.step.rng_state()
        if self.mesh is None:
            return [mine]
        by_key = {k: gather_bytes(v, self.mesh.world, self.device) for k, v in mine.items()}
        return [{k: rows[r] for k, rows in by_key.items()} for r in range(self.mesh.world.size)]

    def load_state(self, state: dict) -> None:
        """Restore a checkpoint; this rank's generators from its own entry
        of `rng` (a run resumed on more ranks than it saved seeds the
        others' anew). A checkpoint of a single-process port before
        multi-process training holds one rank's generators as a dict."""
        tr = self.step
        tr.load_model_state(state["model"])
        tr.load_optimizer_state(state["optimizer"])
        tr.normalizer = NormalizerState(**{k: v.to(self.device)
                                           for k, v in state["normalizer"].items()})
        rank = 0 if self.mesh is None else self.mesh.world.index
        rngs = [state["rng"]] if isinstance(state["rng"], dict) else state["rng"]
        if rank < len(rngs):
            tr.set_rng_state(rngs[rank])

    def init_state(self) -> None:
        """Resume from the training checkpoint of the highest epoch, if any
        (averaged checkpoints carry no epoch and are never candidates)."""
        barrier("resume")
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
            m = self.step.train_step({k: batch[k] for k in self.step_keys},
                                     update_norm=update_norm)
            losses.append(m["loss"])
            samples += int(batch["wav_lens"][batch["weight"] > 0].sum())
            if i % 50 == 0 and self.is_main:
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
            valid_stats = self.validate(valid_loader, epoch) if valid_loader is not None else {}
            meta = {"epoch": epoch, "steps": self.micro_steps,
                    "epoch_sec": round(time.time() - t0, 1)}
            if self.is_main:
                self.logger.log_stats(meta, train_stats=train_stats, valid_stats=valid_stats)
            if valid_stats:
                rank = "max_keys" if self.is_s2s else "min_keys"
                state = {**self.state(), "epoch": epoch}
                if self.is_main:
                    self.ckpt.save(state, metrics={**valid_stats, "epoch": epoch},
                                   **{rank: (self.metric_key,)})
                barrier("checkpoint")
            self.epoch_log.append({
                **meta, "epoch_sec": time.time() - t0, "train_sec": train_sec,
                "train_audio_s": audio_s, "train": train_stats, "valid": valid_stats})

    # -- validation and test --------------------------------------------------

    def _decode_set(self, model: ASRModel, normalizer: NormalizerState,
                    loader: BucketedLoader, decoder: Optional[Decoder],
                    accuracy: Optional[AccuracyStats] = None):
        """(WER stats, CER stats) of the model over the loader's epoch 0;
        greedy CTC unless a decoder is given. Pad rows are left out. With
        `accuracy`, the teacher-forced decoder's token accuracy is added
        to it."""
        wer, cer = ErrorRateStats(), ErrorRateStats(split_tokens=True)
        was_training = model.training
        model.eval()
        for batch in prefetch_iterator(loader.epoch(0), size=self.cfg.data.prefetch_batches):
            bos = None if accuracy is None else torch.from_numpy(batch["tokens_bos"])
            out = eval_step(model, self.cfg.frontend, normalizer,
                            torch.from_numpy(batch["wav"]), torch.from_numpy(batch["wav_lens"]),
                            bos)
            real = int(batch["weight"].sum())
            if decoder is None:
                toks, lens = ctc_greedy_decode(out["ctc_log_probs"], out["enc_lengths"])
                hyp_ids = tokens_to_lists(toks.cpu().numpy(), lens.cpu().numpy())
            else:
                hyp_ids = decoder(model, batch, out)
            hyps = [self.tokenizer.decode(t) for t in hyp_ids][:real]
            refs = [self.tokenizer.decode(list(batch["tokens"][i, :batch["token_lens"][i]]))
                    for i in range(real)]
            wer.append(batch["ids"][:real], hyps, refs)
            cer.append(batch["ids"][:real], hyps, refs)
            if accuracy is not None:
                accuracy.append(out["seq_log_probs"], batch["tokens_eos"], batch["eos_lens"],
                                batch["weight"])
        model.train(was_training)
        return wer, cer

    def validate(self, loader: BucketedLoader, epoch: int = 1) -> Dict[str, float]:
        """WER and CER of the current model by greedy CTC; for S2S also
        ACC, and WER and CER by the joint beam search when epoch is a
        multiple of decode.valid_search_interval."""
        decoder, acc = None, None
        if self.is_s2s:
            acc = AccuracyStats()
            if epoch % self.cfg.decode.valid_search_interval == 0:
                decoder = self.s2s_decoder(test=False)
        wer, cer = self._decode_set(self.step.eval_model(), self.step.normalizer, loader,
                                    decoder, acc)
        stats = {"WER": wer.summarize()["WER"], "CER": cer.summarize()["WER"]}
        if acc is not None:
            stats["ACC"] = acc.summarize()
        return stats

    def ctc_decoder(self) -> Decoder:
        """The CTC recipes' test decoder: the prefix beam search with the
        decode stanza's beam (100) and pruning, on the model's device."""
        d = self.cfg.decode

        def decode(model, batch, out):
            return ctc_beam_decode(out["ctc_log_probs"], out["enc_lengths"], d)

        return decode

    def make_s2s_searcher(self, model: ASRModel, test: bool = True) -> S2SBeamSearcher:
        """A joint beam searcher over `model` per the decode stanza: beam
        s2s_test_beam_size (test) or valid_beam_size (validation), CTC
        weight ctc_weight_decode, ctc_candidates, temperature, length
        normalization and the decode ratios; the test search fuses the
        Trainer's LM, if any. Its decode weights are cast from the model's
        as they are now."""
        d = self.cfg.decode
        return S2SBeamSearcher.from_decode(
            model, d, self.lm if test else None,
            d.s2s_test_beam_size if test else d.valid_beam_size)

    def s2s_decoder(self, test: bool = True) -> Decoder:
        """The S2S recipes' decoder hook: the joint beam search (test or
        validation settings), its searcher built anew at each call from the
        model it is given; hypotheses up to eos."""

        def decode(model, batch, out):
            searcher = self.make_s2s_searcher(model, test)
            toks, lens, _ = searcher(out["enc_out"], out["enc_lengths"], out["ctc_log_probs"])
            return strip_special(toks.cpu().numpy(), lens.cpu().numpy(), searcher.eos_id)

        return decode

    def evaluate(self, loader: BucketedLoader, test_name: str = "test",
                 decoder: Optional[Decoder] = None, use_averaged: bool = True
                 ) -> Dict[str, float]:
        """Decode a test set with the average of the train.avg_checkpoints
        best checkpoints (by WER, or ACC for S2S; the current model when
        there is none, or with use_averaged False);
        the optimizer and normaliser are the best checkpoint's. With
        use_averaged, saves that state as `averaged_<test_name>`. Writes the
        per-utterance alignments to wer_<test_name>.txt."""
        normalizer = self.step.normalizer
        rank = "max_key" if self.is_s2s else "min_key"
        restored = None
        if use_averaged:
            restored = self.ckpt.restore_averaged(k=self.cfg.train.avg_checkpoints,
                                                  **{rank: self.metric_key})
        if restored is None:
            state = self.state()
            model = self.step.eval_model()
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
        if self.is_main:
            if use_averaged:
                self.ckpt.save(state, metrics={**summary, "averaged": True},
                               name=f"averaged_{test_name}")
            out_path = os.path.join(self.cfg.output_folder, f"wer_{test_name}.txt")
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            with open(out_path, "w", encoding="utf-8") as f:
                wer.write_stats(f)
            self.logger.log_stats({"test_set": test_name}, test_stats=summary)
        barrier("evaluate")
        self.test_stats[test_name] = summary
        return summary
