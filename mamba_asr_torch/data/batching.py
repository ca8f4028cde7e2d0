"""Duration buckets with static batch shapes (port of
mamba_asr_tpu/data/batching.py).

Utterances go to a fixed set of duration buckets (quantiles of the
durations); every batch of a bucket has the same (batch_size,
padded_samples) shape, and each bucket's batch size aims at
`max_batch_seconds` of audio. `BucketSampler` draws the same numpy
permutations as the JAX package's, so both give the same batches.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Bucket:
    max_seconds: float  # padded length of every utterance in this bucket
    batch_size: int
    max_label_len: int  # static label padding for this bucket


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    buckets: List[Bucket]
    sample_rate: int

    def bucket_for(self, duration: float) -> int:
        for i, b in enumerate(self.buckets):
            if duration <= b.max_seconds:
                return i
        return len(self.buckets) - 1

    def padded_samples(self, bucket_idx: int) -> int:
        return int(round(self.buckets[bucket_idx].max_seconds * self.sample_rate))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_bucket_plan(
    durations: Sequence[float],
    label_lengths: Sequence[int],
    num_buckets: int = 8,
    max_batch_seconds: float = 850.0,
    max_batch_ex: int = 128,
    sample_rate: int = 16000,
    batch_divisor: int = 1,
) -> BucketPlan:
    """Bucket bounds at the durations' quantiles (bounds within 1 % of the
    previous one merged), each with a batch size of about
    `max_batch_seconds` of audio (at most max_batch_ex), rounded up to a
    multiple of batch_divisor (so that a batch splits evenly over the data
    ranks), and labels padded to a multiple of 16."""
    durations = np.asarray(durations, np.float64)
    label_lengths = np.asarray(label_lengths, np.int64)
    bounds = np.quantile(durations, np.linspace(0, 1, num_buckets + 1)[1:])
    bounds[-1] = durations.max()
    uniq: List[float] = []
    for b in bounds:
        if not uniq or b > uniq[-1] * 1.01:
            uniq.append(float(b))
    buckets = []
    for b in uniq:
        bs = int(np.clip(max_batch_seconds // max(b, 0.1), 1, max_batch_ex))
        bs = _round_up(bs, batch_divisor)
        in_bucket = label_lengths[durations <= b]
        max_lab = int(in_bucket.max()) if in_bucket.size else 16
        buckets.append(Bucket(max_seconds=math.ceil(b * 10) / 10,
                              batch_size=bs,
                              max_label_len=_round_up(max(max_lab, 1), 16)))
    return BucketPlan(buckets=buckets, sample_rate=sample_rate)


class BucketSampler:
    """Yields (bucket_idx, example_indices, real) with static per-bucket
    sizes; `real` counts the leading indices that are not repeats. The
    last partial batch of each bucket is filled by repeating its indices
    (the loader gives the repeats weight 0); none is dropped."""

    def __init__(self, durations: Sequence[float], plan: BucketPlan,
                 shuffle: bool = True, seed: int = 0):
        self.plan = plan
        self.shuffle = shuffle
        self.seed = seed
        self.assignments = [plan.bucket_for(d) for d in durations]
        self.num_examples = len(self.assignments)

    def __iter__(self) -> Iterator[tuple]:
        return self.epoch(0)

    def epoch(self, epoch: int) -> Iterator[tuple]:
        # The draws and their order are the JAX package's: one shuffle of
        # the examples, then one of the batches, from default_rng(seed + epoch).
        rng = np.random.default_rng(self.seed + epoch)
        by_bucket: List[List[int]] = [[] for _ in self.plan.buckets]
        order = np.arange(self.num_examples)
        if self.shuffle:
            rng.shuffle(order)
        batches = []
        for idx in order:
            b = self.assignments[idx]
            by_bucket[b].append(int(idx))
            if len(by_bucket[b]) == self.plan.buckets[b].batch_size:
                batches.append((b, by_bucket[b], len(by_bucket[b])))
                by_bucket[b] = []
        for b, rest in enumerate(by_bucket):
            if rest:
                bs = self.plan.buckets[b].batch_size
                padded = rest + rest * ((bs - len(rest)) // len(rest) + 1)
                batches.append((b, padded[:bs], len(rest)))
        if self.shuffle:
            rng.shuffle(batches)
        yield from batches

    def num_batches(self) -> int:
        counts = [0] * len(self.plan.buckets)
        for b in self.assignments:
            counts[b] += 1
        return sum(-(-c // b.batch_size) for c, b in zip(counts, self.plan.buckets))
