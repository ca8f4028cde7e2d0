"""Slot-batched streaming recognition (port of mamba_asr_tpu/serving/
engine.py): many independent real-time audio streams on one device.

- One fixed-shape tick over `n_slots` stacked streams runs fbank ->
  the frozen normaliser -> each front-end level over [carry, new] ->
  `ASRModel.forward_chunk` -> the CTC head and argmax for every slot at
  once. The batch never changes shape, so a later change can capture the
  tick in a CUDA graph.
- Every slot's state lives on the device as n_slots rows: the fbank
  framing tail, the per-level front-end carries and the encoder's
  `init_streaming_state(n_slots)`. A slot with no chunk ready is computed
  on zero audio and keeps its old state through `torch.where`.
- A stream's irregular ends run through the exact batch-1
  `StreamingASRSession` (models/streaming.py): its first chunk (center
  framing, empty carries) is fed there and the session's state promoted
  into the slot row; at `finish` the row is demoted back and the session
  flushes. Steady ticks are the session's op sequence over stacked rows,
  so a causal model's transcripts equal the single session's and the
  offline greedy decode's.

`feed` buffers audio on the host, `tick` consumes one chunk from every
stream that has one and returns the new ids per stream id, `finish`
flushes a stream and frees its slot, `finish_final` adds a whole-
utterance pass over the stream's accumulated encoder output: the CTC
prefix beam ("ctc_beam"; with an LM, its n-best rescored,
decoding/rescore.py) or the joint CTC/attention search ("s2s").

Every public method runs under torch.no_grad and on the engine's device
(both are per thread in PyTorch, and a server calls the engine from
several threads). Multi-device serving (JAX's `mesh`) is not ported:
ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import contextlib
import functools
import time as _time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mamba_asr_torch.configs.loader import FrontendConfig
from mamba_asr_torch.decoding.ctc_beam import ctc_beam_search, ctc_beam_search_nbest
from mamba_asr_torch.decoding.ctc_greedy import ctc_greedy_decode_with_times
from mamba_asr_torch.decoding.rescore import rescore_nbest
from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher
from mamba_asr_torch.decoding.timestamps import encoder_frame_seconds
from mamba_asr_torch.models.asr import ASRModel
from mamba_asr_torch.models.layers import dense
from mamba_asr_torch.models.streaming import StreamingASRSession
from mamba_asr_torch.ops.fbank import log_mel_spectrogram
from mamba_asr_torch.training.normalizer import NormalizerState, apply_normalizer

FINAL_BUCKET = 128  # finish_final pads the encoder output to a multiple of this


# -- the slot state: nested dicts, lists and tuples of (n_slots, ...) tensors --

def tree_map(fn, *trees):
    head = trees[0]
    if isinstance(head, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def tree_where(mask: torch.Tensor, new, old):
    """Row r of each leaf from `new` where mask[r], else from `old`."""
    def keep(a, b):
        return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    return tree_map(keep, new, old)


def tree_insert(state, row, idx: int):
    """`state` with row idx of every leaf replaced by `row`'s (batch 1)."""
    def put(a, b):
        out = a.clone()
        out[idx:idx + 1] = b.to(a.dtype)
        return out
    return tree_map(put, state, row)


def tree_extract(state, idx: int):
    """Row idx of every leaf, as batch-1 copies."""
    return tree_map(lambda a: a[idx:idx + 1].clone(), state)


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


class StreamingServer:
    """Fixed-capacity slot-batched streaming recognizer.

    model: a streaming ASRModel (ConMamba, Conformer, Branchformer) in
    eval mode on its device, where the engine runs; `causal: true` gives
    offline-exact transcripts. frontend: the fbank settings it was trained
    with. normalizer: frozen statistics on that device, or None.
    n_slots: concurrent streams (the tick's batch). chunk_frames: fbank
    frames each stream advances per tick, a multiple of the front end's
    downsampling (64 = 640 ms at a 10 ms hop). final_decode: None,
    "ctc_beam" or "s2s" (`finish_final`), with beam_size and decode_opts
    (the CTC search's pruning, or the S2SBeamSearcher's fields; with
    lm_model, a TransformerLM on the model's device, the n-best rescoring's
    lm_weight (0.6), temperature_lm (1.0) and nbest (min(beam_size, 10))).
    """

    def __init__(
        self,
        model: ASRModel,
        frontend: FrontendConfig,
        normalizer: Optional[NormalizerState] = None,
        n_slots: int = 8,
        chunk_frames: int = 64,
        final_decode: Optional[str] = None,
        beam_size: int = 8,
        decode_opts: Optional[dict] = None,
        lm_model=None,
    ):
        if final_decode not in (None, "ctc_beam", "s2s"):
            raise ValueError(f"final_decode {final_decode!r}: None, 'ctc_beam' or 's2s'")
        if chunk_frames % model.cfg.downsample:
            raise ValueError("chunk_frames must be a multiple of the front end's "
                             f"downsampling factor {model.cfg.downsample}")
        self.model = model
        self.frontend = frontend
        self.normalizer = normalizer
        self.n_slots = n_slots
        self.chunk_frames = chunk_frames
        self.device = model.src_proj.weight.device
        self.hop = frontend.hop
        self.chunk_samples = chunk_frames * self.hop
        win = int(round(frontend.sample_rate * frontend.win_length_ms / 1000))
        self.win = min(win, frontend.n_fft)
        if self.chunk_samples < self.win:
            raise ValueError("a chunk must cover at least one fbank window")

        with torch.no_grad(), self._device_context():
            # The steady template: zero chunks through a batch-1 session,
            # whose state shapes must then stay fixed (every stream lands
            # there after its first chunk, so one tick shape serves all).
            tmpl = StreamingASRSession(model, frontend, normalizer, chunk_frames)
            zeros = np.zeros((1, self.chunk_samples), np.float32)
            tmpl.feed(zeros)
            shapes = self._state_shapes(tmpl)
            for _ in range(2):
                tmpl.feed(zeros)
                assert self._state_shapes(tmpl) == shapes, (
                    "streaming state did not reach a fixed point after one chunk: "
                    f"{shapes} vs {self._state_shapes(tmpl)}")
            self._template = shapes
            self._tail_len = tmpl.audio_tail.shape[1]
            carries = tmpl.fe_stream.carry

            def tile(x):
                return torch.zeros((n_slots,) + tuple(x.shape[1:]), dtype=x.dtype,
                                   device=self.device)

            self._state = {
                "tail": torch.zeros(n_slots, self._tail_len, device=self.device),
                "carry": tuple(tile(c) for c in carries),
                "enc": model.init_streaming_state(n_slots),
            }
            bad = [tuple(a.shape) for a in _leaves(self._state)
                   if a.dim() == 0 or a.shape[0] != n_slots]
            assert not bad, f"state leaves without the slot dimension: {bad}"
        self._emits = self._emission_schedule([c.shape[1] for c in carries])

        # Host-side slot bookkeeping.
        self._sessions: List[Optional[StreamingASRSession]] = [None] * n_slots
        self._bufs: List[_SlotBuffer] = [_SlotBuffer() for _ in range(n_slots)]
        self._promoted = [False] * n_slots
        self._sid_of_slot: List[Optional[int]] = [None] * n_slots
        self._slot_of_sid: Dict[int, int] = {}
        self._next_sid = 0
        self._pending: Dict[int, List[int]] = {}

        # Final pass: every stream's encoder output, kept on the device.
        self.final_decode = final_decode
        self.beam_size = beam_size
        self._decode_opts = dict(decode_opts or {})
        self._enc_acc: List[Optional[List[torch.Tensor]]] = [None] * n_slots
        self.lm_model = lm_model
        self._s2s_searcher = None
        if final_decode == "s2s":
            self._s2s_searcher = S2SBeamSearcher(model, beam_size=beam_size,
                                                 **self._decode_opts)

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

    # ------------------------------------------------------------------
    def _device_context(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    @staticmethod
    def _state_shapes(sess: StreamingASRSession):
        carries = sess.fe_stream.carry
        assert all(c is not None for c in carries), "a front-end level has no carry yet"
        return (tuple(sess.audio_tail.shape), tuple(tuple(c.shape) for c in carries))

    def _emission_schedule(self, carry_lens: List[int]) -> List[int]:
        """Outputs per tick of each front-end level: a VALID conv over
        [carry, x] consumes e * s inputs and leaves the carry's length
        unchanged (asserted)."""
        fe = self.model.frontend
        emits, m = [], self.chunk_frames
        for c, k, s in zip(carry_lens, fe.kernel_sizes, fe.strides):
            e = (c + m - k) // s + 1
            assert c + m - e * s == c, "front-end carry not steady at this chunk size"
            emits.append(e)
            m = e
        return emits

    def _tick_fn(self, state, audio: torch.Tensor, mask: torch.Tensor):
        """audio (n_slots, chunk_samples) float32, mask (n_slots,) bool ->
        (best ids (n_slots, T'), enc (n_slots, T', d_model), new state)."""
        model, fe = self.model, self.frontend
        window = torch.cat([state["tail"], audio], dim=1)
        feats = log_mel_spectrogram(
            window, sample_rate=fe.sample_rate, n_fft=fe.n_fft, n_mels=fe.n_mels,
            win_length_ms=fe.win_length_ms, hop_length_ms=fe.hop_length_ms, center=False)
        if self.normalizer is not None:
            feats = apply_normalizer(self.normalizer, feats)
        assert feats.shape[1] == self.chunk_frames, feats.shape
        new_tail = window[:, self.chunk_frames * self.hop:]
        x = feats[..., None]
        new_carries = []
        for i, (e, s) in enumerate(zip(self._emits, model.frontend.strides)):
            buf = torch.cat([state["carry"][i], x], dim=1)
            x = model.frontend.apply_level(i, buf, (0, 0))
            assert x.shape[1] == e, (x.shape, e)
            new_carries.append(buf[:, e * s:])
        enc, new_enc = model.forward_chunk(x, state["enc"])
        logits = dense(enc.float(), model.ctc_head, torch.float32)
        best = F.log_softmax(logits, dim=-1).argmax(dim=-1)
        new_state = {"tail": new_tail, "carry": tuple(new_carries), "enc": new_enc}
        return best, enc, tree_where(mask, new_state, state)

    # -- session lifecycle ---------------------------------------------
    @property
    def free_slots(self) -> int:
        return sum(s is None for s in self._sessions)

    @_engine_call
    def attach(self) -> int:
        """Open a stream; returns its stream id. Raises when full."""
        for slot, s in enumerate(self._sessions):
            if s is None:
                sid = self._next_sid
                self._next_sid += 1
                acc = [] if self.final_decode is not None else None
                self._enc_acc[slot] = acc
                self._sessions[slot] = StreamingASRSession(
                    self.model, self.frontend, self.normalizer, self.chunk_frames,
                    enc_sink=acc)
                self._bufs[slot] = _SlotBuffer()
                self._promoted[slot] = False
                self._sid_of_slot[slot] = sid
                self._slot_of_sid[sid] = slot
                self._silence_frames[slot] = 0
                self._n_attached += 1
                return sid
        raise RuntimeError(f"server full ({self.n_slots} slots)")

    def feed(self, sid: int, samples: np.ndarray) -> None:
        """Buffer PCM float32 samples for stream `sid` (host only)."""
        self._audio_samples_in += int(np.asarray(samples).size)
        self._bufs[self._slot_of_sid[sid]].push(samples)

    def ready_slots(self) -> List[int]:
        return [slot for slot, sess in enumerate(self._sessions)
                if sess is not None and self._bufs[slot].size >= self.chunk_samples]

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
        enc_frames = self.chunk_frames // self.model.cfg.downsample
        steady = []
        for slot in self.ready_slots():
            sess = self._sessions[slot]
            if self._promoted[slot]:
                steady.append(slot)
                continue
            # A fresh stream's first chunk: the exact batch-1 session, then
            # its state promoted into the slot row.
            toks = sess.feed(self._bufs[slot].pop(self.chunk_samples)[None])[0]
            # The bootstrap exposes no per-frame argmax: silence by emission.
            self._silence_frames[slot] = 0 if toks else self._silence_frames[slot] + enc_frames
            if toks:
                emitted[self._sid_of_slot[slot]] = toks
            assert self._state_shapes(sess) == self._template, (
                "bootstrap did not land on the steady template")
            self._promote(slot)

        if steady:
            t0 = _time.perf_counter()
            audio = np.zeros((self.n_slots, self.chunk_samples), np.float32)
            mask = np.zeros((self.n_slots,), bool)
            for slot in steady:
                audio[slot] = self._bufs[slot].pop(self.chunk_samples)
                mask[slot] = True
            best, enc, self._state = self._tick_fn(
                self._state, torch.from_numpy(audio).to(self.device),
                torch.from_numpy(mask).to(self.device))
            best = best.cpu().numpy()
            for slot in steady:
                sess = self._sessions[slot]
                sess._samples_fed += self.chunk_samples
                sess._frames_done += self.chunk_frames
                if self._enc_acc[slot] is not None:
                    # A copy: a view would keep the whole tick's output alive.
                    self._enc_acc[slot].append(enc[slot:slot + 1].clone())
                row = best[slot]
                nz = np.nonzero(row != 0)[0]
                if nz.size:
                    self._silence_frames[slot] = len(row) - 1 - int(nz[-1])
                else:
                    self._silence_frames[slot] += len(row)
                toks = sess._collapse(best[slot:slot + 1])[0]
                if toks:
                    emitted.setdefault(self._sid_of_slot[slot], []).extend(toks)
            self._n_ticks += 1
            self._n_batched_rows += len(steady)
            self._tick_seconds += _time.perf_counter() - t0
        return emitted

    def _promote(self, slot: int) -> None:
        sess = self._sessions[slot]
        row = {"tail": torch.from_numpy(sess.audio_tail.astype(np.float32)).to(self.device),
               "carry": tuple(sess.fe_stream.carry), "enc": sess.enc_state}
        self._state = tree_insert(self._state, row, slot)
        self._promoted[slot] = True

    def _demote(self, slot: int) -> None:
        row = tree_extract(self._state, slot)
        sess = self._sessions[slot]
        sess.audio_tail = row["tail"].cpu().numpy()
        sess.fe_stream.carry = list(row["carry"])
        sess.enc_state = row["enc"]
        self._promoted[slot] = False

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
        sess = self._sessions[slot]
        if self._promoted[slot]:
            self._demote(slot)
        rest = self._bufs[slot].pop_all()
        if rest.size:
            out.extend(sess.feed(rest[None])[0])
        out.extend(sess.finish()[0])
        self._sessions[slot] = None
        self._sid_of_slot[slot] = None
        del self._slot_of_sid[sid]
        self._n_finished += 1
        return out

    def _ctc_log_probs(self, enc: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(dense(enc.float(), self.model.ctc_head, torch.float32), dim=-1)

    def _final_ctc(self, lp: torch.Tensor, lens: torch.Tensor):
        opts = self._decode_opts
        prune = {k: opts[k] for k in ("beam_prune_logp", "token_prune_min_logp") if k in opts}
        if self.lm_model is None:
            return ctc_beam_search(lp, lens, beam_size=self.beam_size, **prune)
        toks, lens_n, scores = ctc_beam_search_nbest(
            lp, lens, nbest=opts.get("nbest", min(self.beam_size, 10)),
            beam_size=self.beam_size, **prune)
        return rescore_nbest(toks, lens_n, scores, self.lm_model,
                             lm_weight=opts.get("lm_weight", 0.6),
                             temperature_lm=opts.get("temperature_lm", 1.0))

    @_engine_call
    def finish_final(self, sid: int, want_times: bool = False):
        """Flush stream `sid` as finish() does, then run the final pass over
        the stream's whole encoder output: (greedy tail ids, final ids), and
        with want_times the greedy alignment's token spans [(id, onset
        frame, offset frame, confidence)] over the same output (they follow
        the greedy path, which can differ from the beam's near ties;
        `frame_seconds` converts frames). The output is zero-padded to a
        multiple of FINAL_BUCKET frames with its true length passed apart,
        as JAX pads to share compiles: the padded rows reach the searcher's
        memory, so the results stay JAX's."""
        if self.final_decode is None:
            raise ValueError("engine built without final_decode")
        slot = self._slot_of_sid[sid]
        acc = self._enc_acc[slot]
        tail = self.finish(sid)  # the session's enc_sink takes the flush chunks
        self._enc_acc[slot] = None
        if not acc:
            return (tail, [], []) if want_times else (tail, [])
        enc = torch.cat(acc, dim=1)  # (1, T, d_model), compute dtype
        t = enc.shape[1]
        enc_p = F.pad(enc, (0, 0, 0, (-t) % FINAL_BUCKET))
        lens = torch.tensor([t], dtype=torch.int32, device=self.device)
        lp = self._ctc_log_probs(enc_p)
        if self.final_decode == "ctc_beam":
            toks, out_lens = self._final_ctc(lp, lens)
        else:
            toks, out_lens, _ = self._s2s_searcher(enc_p, lens, ctc_log_probs=lp)
        final = toks[0, :int(out_lens[0])].tolist()
        if not want_times:
            return tail, final
        ids, n, ons, offs, confs = (x.cpu() for x in ctc_greedy_decode_with_times(lp, lens))
        spans = [(int(ids[0, i]), int(ons[0, i]), int(offs[0, i]), float(confs[0, i]))
                 for i in range(int(n[0]))]
        return tail, final, spans

    @property
    def frame_seconds(self) -> float:
        """Seconds of one encoder output frame."""
        return encoder_frame_seconds(self.frontend, self.model.cfg)

    def trailing_silence_s(self, sid: int) -> float:
        """Seconds of trailing CTC silence on stream `sid`: its current run of
        blank argmax frames (the bootstrap chunk counts by emission). A
        server ends a stream once this passes its threshold. It advances
        by whole chunks."""
        return self._silence_frames[self._slot_of_sid[sid]] * self.frame_seconds

    def abort(self, sid: int) -> None:
        """Drop stream `sid` and free its slot, on the host alone: the slot's
        row goes stale until the next stream's promote overwrites it."""
        slot = self._slot_of_sid.pop(sid)
        self._sessions[slot] = None
        self._sid_of_slot[slot] = None
        self._bufs[slot] = _SlotBuffer()
        self._promoted[slot] = False
        self._enc_acc[slot] = None
        self._pending.pop(sid, None)
        self._n_aborted += 1

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
            "audio_seconds_in": self._audio_samples_in / self.frontend.sample_rate,
            "tokens_out": self._tokens_out,
            "tick_ms_avg": (self._tick_seconds / self._n_ticks * 1000
                            if self._n_ticks else 0.0),
        }


def _leaves(tree) -> List:
    out: List = []
    tree_map(out.append, tree)
    return out
