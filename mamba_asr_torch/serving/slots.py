"""The host side of a slot-batched streaming engine, one class for the
live engine (serving/engine.py:StreamingServer) and the exported one
(serving/export.py:ExportedStreamingServer): stream ids and slots, the
per-stream PCM buffers, the steady tick's batching, the end of a stream,
endpointing and the counters. Each engine gives the device surface:

    _open(slot)                      a stream starts in `slot`
    _bootstrap(slot, audio (chunk,)) -> ids
                                     its first chunk; after it the
                                     stream's state is the slot's row
    _steady(audio (S, chunk), mask (S,)) -> best (S, E) numpy
                                     one tick of every slot; rows not in
                                     mask keep their state
    _emit(slot, best (E,)) -> ids    a steady row's new ids
    _flush(slot, rest (n,)) -> ids   the end of the stream: its last
                                     samples and the flush
    _close(slot)                     the slot freed (finish or abort)

Nothing here imports the port's models, so a worker that runs a bundle
takes this module alone. Every public method that reaches the device runs
under torch.no_grad and with the engine's device current (both are per
thread in PyTorch, and a server calls the engine from several threads).
"""

from __future__ import annotations

import contextlib
import functools
import time as _time
from typing import Dict, List, Optional

import numpy as np
import torch


class _SlotBuffer:
    """Host-side per-stream PCM buffer (float32 mono samples)."""

    def __init__(self):
        self.parts: List[np.ndarray] = []
        self.size = 0

    def push(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, np.float32).reshape(-1)
        if samples.size:
            self.parts.append(samples)
            self.size += samples.size

    def pop(self, n: int) -> np.ndarray:
        assert n <= self.size
        out, got = [], 0
        while got < n:
            p = self.parts[0]
            take = min(p.size, n - got)
            out.append(p[:take])
            if take == p.size:
                self.parts.pop(0)
            else:
                self.parts[0] = p[take:]
            got += take
        self.size -= n
        return np.concatenate(out) if len(out) != 1 else out[0]

    def pop_all(self) -> np.ndarray:
        if not self.parts:
            return np.zeros((0,), np.float32)
        out = np.concatenate(self.parts)
        self.parts, self.size = [], 0
        return out


def _engine_call(fn):
    """A public engine method: no autograd and the engine's device current,
    in whatever thread calls it."""
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        with torch.no_grad(), self._device_context():
            return fn(self, *args, **kwargs)
    return wrapped


class SlotEngine:
    """Fixed-capacity slot bookkeeping over a device surface (module
    docstring). n_slots streams at once, each advancing chunk_samples
    samples (enc_frames encoder frames) a tick; sample_rate converts
    the audio counter; frame_seconds (a subclass property) the silence."""

    def __init__(self, n_slots: int, chunk_samples: int, enc_frames: int,
                 sample_rate: int, device: torch.device):
        self.n_slots = n_slots
        self.chunk_samples = chunk_samples
        self._enc_frames = enc_frames
        self._sample_rate = sample_rate
        self.device = device
        self._bufs: List[_SlotBuffer] = [_SlotBuffer() for _ in range(n_slots)]
        self._fed = [0] * n_slots  # samples each slot's stream was fed
        self._promoted = [False] * n_slots
        self._sid_of_slot: List[Optional[int]] = [None] * n_slots
        self._slot_of_sid: Dict[int, int] = {}
        self._next_sid = 0
        self._pending: Dict[int, List[int]] = {}
        # Endpointing: the trailing blank run per slot (host bookkeeping over
        # the argmax rows the tick already returns).
        self._silence_frames: List[int] = [0] * n_slots
        # Aggregate counters (host only; see stats()).
        self._n_ticks = 0
        self._n_batched_rows = 0
        self._n_attached = 0
        self._n_finished = 0
        self._n_aborted = 0
        self._audio_samples_in = 0
        self._tokens_out = 0
        self._tick_seconds = 0.0

    def _device_context(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # -- session lifecycle ---------------------------------------------
    @property
    def free_slots(self) -> int:
        return sum(s is None for s in self._sid_of_slot)

    @_engine_call
    def attach(self) -> int:
        """Open a stream; returns its stream id. Raises when full."""
        for slot, owner in enumerate(self._sid_of_slot):
            if owner is None:
                sid = self._next_sid
                self._next_sid += 1
                self._bufs[slot] = _SlotBuffer()
                self._fed[slot] = 0
                self._promoted[slot] = False
                self._silence_frames[slot] = 0
                self._open(slot)
                self._sid_of_slot[slot] = sid
                self._slot_of_sid[sid] = slot
                self._n_attached += 1
                return sid
        raise RuntimeError(f"server full ({self.n_slots} slots)")

    def feed(self, sid: int, samples: np.ndarray) -> None:
        """Buffer PCM float32 samples for stream `sid` (host only)."""
        slot = self._slot_of_sid[sid]
        n = int(np.asarray(samples).size)
        self._audio_samples_in += n
        self._fed[slot] += n
        self._bufs[slot].push(samples)

    def ready_slots(self) -> List[int]:
        return [slot for slot, owner in enumerate(self._sid_of_slot)
                if owner is not None and self._bufs[slot].size >= self.chunk_samples]

    @_engine_call
    def tick(self) -> Dict[int, List[int]]:
        """Advance every stream that has a full chunk buffered; returns the
        newly emitted ids by stream id (with any a concurrent finish left
        pending)."""
        for sid, toks in self._tick_once().items():
            self._pending.setdefault(sid, []).extend(toks)
        out = self._pending
        self._pending = {}
        self._tokens_out += sum(len(t) for t in out.values())
        return out

    def _tick_once(self) -> Dict[int, List[int]]:
        emitted: Dict[int, List[int]] = {}
        steady = []
        for slot in self.ready_slots():
            if self._promoted[slot]:
                steady.append(slot)
                continue
            toks = self._bootstrap(slot, self._bufs[slot].pop(self.chunk_samples))
            self._promoted[slot] = True
            # The bootstrap counts its silence by emission: the live engine's
            # batch-1 session exposes no per-frame argmax.
            self._silence_frames[slot] = (0 if toks else
                                          self._silence_frames[slot] + self._enc_frames)
            if toks:
                emitted[self._sid_of_slot[slot]] = toks

        if steady:
            t0 = _time.perf_counter()
            audio = np.zeros((self.n_slots, self.chunk_samples), np.float32)
            mask = np.zeros((self.n_slots,), bool)
            for slot in steady:
                audio[slot] = self._bufs[slot].pop(self.chunk_samples)
                mask[slot] = True
            best = self._steady(audio, mask)
            for slot in steady:
                row = best[slot]
                nz = np.nonzero(row != 0)[0]
                if nz.size:
                    self._silence_frames[slot] = len(row) - 1 - int(nz[-1])
                else:
                    self._silence_frames[slot] += len(row)
                toks = self._emit(slot, row)
                if toks:
                    emitted.setdefault(self._sid_of_slot[slot], []).extend(toks)
            self._n_ticks += 1
            self._n_batched_rows += len(steady)
            self._tick_seconds += _time.perf_counter() - t0
        return emitted

    @_engine_call
    def finish(self, sid: int) -> List[int]:
        """Flush stream `sid` exactly (its buffered audio, the offline
        center frames, the canonical padding), free its slot and return its
        last new ids. Ids other streams emit meanwhile wait for the next
        tick()."""
        slot = self._slot_of_sid[sid]
        # This stream's full chunks go through ticks (other ready streams
        # advance too; their ids go pending).
        while self._bufs[slot].size >= self.chunk_samples:
            for s2, toks in self._tick_once().items():
                self._pending.setdefault(s2, []).extend(toks)
        out = list(self._pending.pop(sid, []))
        out.extend(self._flush(slot, self._bufs[slot].pop_all()))
        self._free(slot, sid)
        self._n_finished += 1
        return out

    def abort(self, sid: int) -> None:
        """Drop stream `sid` and free its slot, on the host alone: the slot's
        row goes stale until the next stream's bootstrap overwrites it."""
        slot = self._slot_of_sid[sid]
        self._bufs[slot] = _SlotBuffer()
        self._promoted[slot] = False
        self._pending.pop(sid, None)
        self._free(slot, sid)
        self._n_aborted += 1

    def _free(self, slot: int, sid: int) -> None:
        self._close(slot)
        self._sid_of_slot[slot] = None
        del self._slot_of_sid[sid]

    def trailing_silence_s(self, sid: int) -> float:
        """Seconds of trailing CTC silence on stream `sid`: its current run of
        blank argmax frames (the bootstrap chunk counts by emission). A
        server ends a stream once this passes its threshold. It advances
        by whole chunks."""
        return self._silence_frames[self._slot_of_sid[sid]] * self.frame_seconds

    def stats(self) -> Dict[str, float]:
        """Aggregate counters (host bookkeeping, no device work): tick_ms_avg
        covers the batched steady ticks, their sync included."""
        return {
            "slots": self.n_slots,
            "active_streams": self.n_slots - self.free_slots,
            "attached_total": self._n_attached,
            "finished_total": self._n_finished,
            "aborted_total": self._n_aborted,
            "ticks_total": self._n_ticks,
            "batched_rows_total": self._n_batched_rows,
            "audio_seconds_in": self._audio_samples_in / self._sample_rate,
            "tokens_out": self._tokens_out,
            "tick_ms_avg": (self._tick_seconds / self._n_ticks * 1000
                            if self._n_ticks else 0.0),
        }
