"""CSV-manifest dataset and the bucketed batch loader (port of
mamba_asr_tpu/data/dataset.py).

Each batch is a dict of numpy arrays, key for key and dtype for dtype
the JAX loader's:
  wav (B, Lb) float32, wav_lens (B,) int32 (samples after perturbation),
  tokens (B, Sb) int32 (no bos/eos), token_lens (B,) int32,
  tokens_bos, tokens_eos (B, Sb+1) int32, eos_lens (B,) int32,
  weight (B,) float32 (0 for the repeated pad rows of a partial batch),
  ids (list of utterance ids) and bucket (int).
Decoding and perturbation run in a thread pool (the C++ calls release
the interpreter lock), and `prefetch_iterator` keeps whole batches ready
in a background thread, so neither runs on the training step's thread.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

from mamba_asr_torch.data.audio import read_audio
from mamba_asr_torch.data.augment import SPEED_FACTORS, speed_perturb
from mamba_asr_torch.data.batching import BucketSampler, make_bucket_plan
from mamba_asr_torch.data.librispeech import Utterance, load_manifest
from mamba_asr_torch.data.tokenizer import BOS_ID, EOS_ID, PAD_ID


def prefetch_iterator(it: Iterator, size: int = 2) -> Iterator:
    """Run `it` in a background thread, keeping up to `size` items ready.
    An exception in the thread is raised here, in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()

    def worker():
        try:
            for item in it:
                q.put((True, item))
        except BaseException as e:  # handed to the consumer, raised there
            q.put((False, e))
        finally:
            q.put((True, done))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        ok, item = q.get()
        if not ok:
            raise item
        if item is done:
            break
        yield item


@dataclasses.dataclass
class ASRDataset:
    utterances: List[Utterance]
    tokenizer: object
    sample_rate: int = 16000

    @classmethod
    def from_csv(cls, csv_path: str, tokenizer, sample_rate: int = 16000):
        return cls(load_manifest(csv_path), tokenizer, sample_rate)

    def __len__(self):
        return len(self.utterances)

    @property
    def durations(self) -> List[float]:
        return [u.duration for u in self.utterances]

    @property
    def label_lengths(self) -> List[int]:
        return [len(self.tokenizer.encode(u.words)) for u in self.utterances]


class BucketedLoader:
    """Static-shape batches of a dataset; speed perturbation on training
    epochs. num_workers: decode/perturb threads (0: one per CPU). Partial
    batches are padded (their repeats weighted 0), never dropped.
    batch_divisor: every batch size a multiple of it.

    Multi-process training (process_count > 1): every process builds the
    same plan and sampler (same seed, same manifest) and keeps rows
    [index * shard, (index + 1) * shard) of each global batch, shard =
    batch / process_count; a batch that does not divide raises. The
    perturbation factors are drawn for the whole global batch before the
    slice, so the shards concatenate to the single process's batch."""

    def __init__(
        self,
        dataset: ASRDataset,
        num_buckets: int = 8,
        max_batch_seconds: float = 850.0,
        max_batch_ex: int = 128,
        shuffle: bool = True,
        speed_perturb: bool = False,
        seed: int = 0,
        batch_divisor: int = 1,
        num_workers: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} of {process_count}")
        self.ds = dataset
        self.speed_perturb = speed_perturb
        self.seed = seed
        self.process_index, self.process_count = process_index, process_count
        self.num_workers = num_workers if num_workers > 0 else (os.cpu_count() or 1)
        self._pool: Optional[ThreadPoolExecutor] = None
        # Speed perturbation can lengthen audio by 1/0.95: plan with headroom.
        durations = np.asarray(dataset.durations)
        plan_durations = durations / 0.95 if speed_perturb else durations
        self.plan = make_bucket_plan(
            plan_durations, dataset.label_lengths, num_buckets=num_buckets,
            max_batch_seconds=max_batch_seconds, max_batch_ex=max_batch_ex,
            sample_rate=dataset.sample_rate, batch_divisor=batch_divisor)
        self.sampler = BucketSampler(plan_durations, self.plan, shuffle=shuffle, seed=seed)

    def num_batches(self) -> int:
        return self.sampler.num_batches()

    def close(self) -> None:
        """Stop the decode threads (a later epoch starts new ones)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed * 7919 + epoch)
        pc, pi = self.process_count, self.process_index
        for bucket_idx, indices, real in self.sampler.epoch(epoch):
            # The whole (global) batch's factors are drawn in index order
            # before any row is loaded or sliced, so they depend neither on
            # thread scheduling nor on the process count.
            if self.speed_perturb:
                factors = [SPEED_FACTORS[rng.integers(len(SPEED_FACTORS))]
                           for _ in indices]
            else:
                factors = [1.0] * len(indices)
            if pc > 1:
                bsz = len(indices)
                if bsz % pc != 0:
                    raise ValueError(
                        f"batch size {bsz} not divisible by process count {pc}: "
                        "construct the loader with batch_divisor = data-axis size")
                shard = bsz // pc
                lo = pi * shard
                indices, factors = indices[lo:lo + shard], factors[lo:lo + shard]
                # The pad rows are the global batch's trailing ones.
                real = min(max(real - lo, 0), shard)
            yield self._collate(bucket_idx, indices, real, factors)

    def __iter__(self):
        return self.epoch(0)

    def _load_one(self, idx: int, factor: float, n_samples: int, s_max: int):
        """Decode, perturb and tokenize one utterance (the pool's work)."""
        utt = self.ds.utterances[idx]
        audio, sr = read_audio(utt.path)
        if sr != self.ds.sample_rate:
            raise ValueError(f"{utt.path}: sample rate {sr} != {self.ds.sample_rate}")
        if factor != 1.0:
            audio = speed_perturb(audio, factor)
        toks = self.ds.tokenizer.encode(utt.words)[:s_max]
        return utt.utt_id, audio[:n_samples], toks

    def _collate(self, bucket_idx, indices, real, factors) -> Dict[str, np.ndarray]:
        n_samples = self.plan.padded_samples(bucket_idx)
        s_max = self.plan.buckets[bucket_idx].max_label_len
        bsz = len(indices)
        if self.num_workers > 1 and bsz > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(self.num_workers)
            rows = list(self._pool.map(self._load_one, indices, factors,
                                       [n_samples] * bsz, [s_max] * bsz))
        else:
            rows = [self._load_one(i, f, n_samples, s_max) for i, f in zip(indices, factors)]

        wav = np.zeros((bsz, n_samples), np.float32)
        wav_lens = np.zeros((bsz,), np.int32)
        tokens = np.full((bsz, s_max), PAD_ID, np.int32)
        token_lens = np.zeros((bsz,), np.int32)
        tokens_bos = np.full((bsz, s_max + 1), PAD_ID, np.int32)
        tokens_eos = np.full((bsz, s_max + 1), PAD_ID, np.int32)
        ids = []
        for i, (utt_id, audio, toks) in enumerate(rows):
            n = len(audio)
            wav[i, :n] = audio
            wav_lens[i] = n
            tokens[i, :len(toks)] = toks
            token_lens[i] = len(toks)
            tokens_bos[i, 0] = BOS_ID
            tokens_bos[i, 1:len(toks) + 1] = toks
            tokens_eos[i, :len(toks)] = toks
            tokens_eos[i, len(toks)] = EOS_ID
            ids.append(utt_id)
        weight = np.zeros((bsz,), np.float32)
        weight[:real] = 1.0
        return {"wav": wav, "wav_lens": wav_lens, "tokens": tokens,
                "token_lens": token_lens, "tokens_bos": tokens_bos,
                "tokens_eos": tokens_eos, "eos_lens": token_lens + 1,
                "weight": weight, "ids": ids, "bucket": bucket_idx}
