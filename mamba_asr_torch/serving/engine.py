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
flushes a stream and frees its slot (the host side of these is
serving/slots.py's, which the exported engine shares), `finish_final`
adds a whole-utterance pass over the stream's accumulated encoder output: the CTC
prefix beam ("ctc_beam"; with an LM, its n-best rescored,
decoding/rescore.py) or the joint CTC/attention search ("s2s").

Every public method runs under torch.no_grad and on the engine's device
(both are per thread in PyTorch, and a server calls the engine from
several threads).

Multi-device serving (JAX's `mesh`, engine.py:131-152): given `devices`,
the slots split into one contiguous block of rows per device, each held
by a replica of the model on its device with its block's state (replicas
on one device share the model). The tick has no cross-slot operation, so
each replica ticks its own rows: `_steady` launches every replica's tick
back to back with no wait between them and then copies all the argmaxes
to the host at once. A stream's batch-1 session, its row's insert and
extract, and its final pass run on its slot's replica.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import List, Optional, Sequence, Union

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
from mamba_asr_torch.serving.slots import SlotEngine, _engine_call
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


@dataclasses.dataclass
class _Replica:
    """One device's share of the engine: its model, its block of slot
    rows (`rows`, global slot indices) and their state, the last tick's
    encoder output of those rows, and the final pass's searcher."""

    device: torch.device
    model: ASRModel
    normalizer: Optional[NormalizerState]
    rows: range
    state: Optional[dict] = None
    last_enc: Optional[torch.Tensor] = None
    searcher: Optional[S2SBeamSearcher] = None
    lm_model: object = None

    def current(self):
        """This replica's device made current (its kernels launch there)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()


class StreamingServer(SlotEngine):
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
    devices: the devices to spread the slots over (JAX's `mesh`), one
    replica each, in order, n_slots / len(devices) rows apiece; default
    the model's device alone.
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
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
    ):
        home = model.src_proj.weight.device
        devices = [home] if devices is None else [_indexed(d) for d in devices]
        if not devices or n_slots % len(devices):
            raise ValueError(f"n_slots {n_slots} must divide over the data axis "
                             f"({len(devices)} devices)")
        if final_decode not in (None, "ctc_beam", "s2s"):
            raise ValueError(f"final_decode {final_decode!r}: None, 'ctc_beam' or 's2s'")
        if chunk_frames % model.cfg.downsample:
            raise ValueError("chunk_frames must be a multiple of the front end's "
                             f"downsampling factor {model.cfg.downsample}")
        super().__init__(n_slots, chunk_frames * frontend.hop,
                         chunk_frames // model.cfg.downsample, frontend.sample_rate,
                         devices[0])
        self.model = model
        self.frontend = frontend
        self.normalizer = normalizer
        self.chunk_frames = chunk_frames
        self.hop = frontend.hop
        win = int(round(frontend.sample_rate * frontend.win_length_ms / 1000))
        self.win = min(win, frontend.n_fft)
        if self.chunk_samples < self.win:
            raise ValueError("a chunk must cover at least one fbank window")

        # One model per device (the caller's on its own), with its normaliser.
        models, norms = {str(home): model}, {str(home): normalizer}
        for dev in devices:
            if str(dev) not in models:
                models[str(dev)] = copy.deepcopy(model).to(dev)
                norms[str(dev)] = (None if normalizer is None else
                                   NormalizerState(*(t.to(dev) for t in normalizer)))
        per = n_slots // len(devices)
        self._replicas = [_Replica(dev, models[str(dev)], norms[str(dev)],
                                   range(i * per, (i + 1) * per))
                          for i, dev in enumerate(devices)]
        first = self._replicas[0]
        with torch.no_grad(), self._device_context():
            # The steady template: zero chunks through a batch-1 session,
            # whose state shapes must then stay fixed (every stream lands
            # there after its first chunk, so one tick shape serves all).
            tmpl = StreamingASRSession(first.model, frontend, first.normalizer, chunk_frames)
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
            for r in self._replicas:
                with r.current():
                    r.state = {
                        "tail": torch.zeros(per, self._tail_len, device=r.device),
                        "carry": tuple(torch.zeros((per,) + tuple(c.shape[1:]), dtype=c.dtype,
                                                   device=r.device) for c in carries),
                        "enc": r.model.init_streaming_state(per),
                    }
                bad = [tuple(a.shape) for a in _leaves(r.state)
                       if a.dim() == 0 or a.shape[0] != per]
                assert not bad, f"state leaves without the slot dimension: {bad}"
        self._emits = self._emission_schedule([c.shape[1] for c in carries])

        # Each stream's batch-1 session (its first chunk and its flush).
        self._sessions: List[Optional[StreamingASRSession]] = [None] * n_slots

        # Final pass: every stream's encoder output, kept on the device.
        self.final_decode = final_decode
        self.beam_size = beam_size
        self._decode_opts = dict(decode_opts or {})
        self._enc_acc: List[Optional[List[torch.Tensor]]] = [None] * n_slots
        self.lm_model = lm_model
        lms = {str(home): lm_model}
        for r in self._replicas:
            if lm_model is not None and str(r.device) not in lms:
                lms[str(r.device)] = copy.deepcopy(lm_model).to(r.device)
            r.lm_model = lms.get(str(r.device))
            if final_decode == "s2s":
                with r.current():
                    r.searcher = S2SBeamSearcher(r.model, beam_size=beam_size,
                                                 **self._decode_opts)

    # ------------------------------------------------------------------

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

    def _replica(self, slot: int) -> _Replica:
        return self._replicas[slot // len(self._replicas[0].rows)]

    def _tick_fn(self, rep: _Replica, state, audio: torch.Tensor, mask: torch.Tensor):
        """One replica's tick over its rows R: audio (R, chunk_samples)
        float32, mask (R,) bool -> (best ids (R, T'), enc (R, T', d_model),
        new state)."""
        model, fe = rep.model, self.frontend
        window = torch.cat([state["tail"], audio], dim=1)
        feats = log_mel_spectrogram(
            window, sample_rate=fe.sample_rate, n_fft=fe.n_fft, n_mels=fe.n_mels,
            win_length_ms=fe.win_length_ms, hop_length_ms=fe.hop_length_ms, center=False)
        if rep.normalizer is not None:
            feats = apply_normalizer(rep.normalizer, feats)
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

    # -- the device surface (serving/slots.py) ---------------------------
    def _open(self, slot: int) -> None:
        acc = [] if self.final_decode is not None else None
        self._enc_acc[slot] = acc
        rep = self._replica(slot)
        self._sessions[slot] = StreamingASRSession(
            rep.model, self.frontend, rep.normalizer, self.chunk_frames, enc_sink=acc)

    def _bootstrap(self, slot: int, audio: np.ndarray) -> List[int]:
        """A fresh stream's first chunk: the exact batch-1 session, then its
        state promoted into the slot row, on the slot's replica."""
        sess, rep = self._sessions[slot], self._replica(slot)
        with rep.current():
            toks = sess.feed(audio[None])[0]
            assert self._state_shapes(sess) == self._template, (
                "bootstrap did not land on the steady template")
            row = {"tail": torch.from_numpy(sess.audio_tail.astype(np.float32)).to(rep.device),
                   "carry": tuple(sess.fe_stream.carry), "enc": sess.enc_state}
            rep.state = tree_insert(rep.state, row, slot - rep.rows.start)
        return toks

    def _steady(self, audio: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Every replica's tick launched back to back, then one copy of all
        the argmaxes to the host. The inputs go to the devices first: a copy
        from pageable memory waits for the work queued before it."""
        inputs = [(torch.from_numpy(audio[r.rows.start:r.rows.stop]).to(r.device),
                   torch.from_numpy(mask[r.rows.start:r.rows.stop]).to(r.device))
                  for r in self._replicas]
        bests = []
        for rep, (chunk, rows) in zip(self._replicas, inputs):
            with rep.current():
                best, rep.last_enc, rep.state = self._tick_fn(rep, rep.state, chunk, rows)
            bests.append(best)
        if len(bests) > 1:
            bests = [torch.cat([b.to(self.device, non_blocking=True) for b in bests])]
        return bests[0].cpu().numpy()

    def _emit(self, slot: int, best: np.ndarray) -> List[int]:
        sess = self._sessions[slot]
        sess._samples_fed += self.chunk_samples
        sess._frames_done += self.chunk_frames
        if self._enc_acc[slot] is not None:
            # A copy: a view would keep the whole tick's output alive.
            rep = self._replica(slot)
            row = slot - rep.rows.start
            self._enc_acc[slot].append(rep.last_enc[row:row + 1].clone())
        return sess._collapse(best[None])[0]

    def _flush(self, slot: int, rest: np.ndarray) -> List[int]:
        """The row demoted back into the session, which takes the rest of
        the audio and flushes."""
        sess, rep = self._sessions[slot], self._replica(slot)
        with rep.current():
            if self._promoted[slot]:
                row = tree_extract(rep.state, slot - rep.rows.start)
                sess.audio_tail = row["tail"].cpu().numpy()
                sess.fe_stream.carry = list(row["carry"])
                sess.enc_state = row["enc"]
                self._promoted[slot] = False
            out = list(sess.feed(rest[None])[0]) if rest.size else []
            return out + list(sess.finish()[0])

    def _close(self, slot: int) -> None:
        self._sessions[slot] = None
        self._enc_acc[slot] = None

    def _final_ctc(self, rep: _Replica, lp: torch.Tensor, lens: torch.Tensor):
        opts = self._decode_opts
        prune = {k: opts[k] for k in ("beam_prune_logp", "token_prune_min_logp") if k in opts}
        lm = rep.lm_model
        if lm is None:
            return ctc_beam_search(lp, lens, beam_size=self.beam_size, **prune)
        toks, lens_n, scores = ctc_beam_search_nbest(
            lp, lens, nbest=opts.get("nbest", min(self.beam_size, 10)),
            beam_size=self.beam_size, **prune)
        return rescore_nbest(toks, lens_n, scores, lm,
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
        acc, rep = self._enc_acc[slot], self._replica(slot)
        tail = self.finish(sid)  # the session's enc_sink takes the flush chunks
        if not acc:
            return (tail, [], []) if want_times else (tail, [])
        with rep.current():  # the search runs on the slot's replica
            enc = torch.cat(acc, dim=1)  # (1, T, d_model), compute dtype
            t = enc.shape[1]
            enc_p = F.pad(enc, (0, 0, 0, (-t) % FINAL_BUCKET))
            lens = torch.tensor([t], dtype=torch.int32, device=rep.device)
            lp = F.log_softmax(dense(enc_p.float(), rep.model.ctc_head, torch.float32), dim=-1)
            if self.final_decode == "ctc_beam":
                toks, out_lens = self._final_ctc(rep, lp, lens)
            else:
                toks, out_lens, _ = rep.searcher(enc_p, lens, ctc_log_probs=lp)
            final = toks[0, :int(out_lens[0])].tolist()
            if not want_times:
                return tail, final
            times = ctc_greedy_decode_with_times(lp, lens)
        ids, n, ons, offs, confs = (x.cpu() for x in times)
        spans = [(int(ids[0, i]), int(ons[0, i]), int(offs[0, i]), float(confs[0, i]))
                 for i in range(int(n[0]))]
        return tail, final, spans

    @property
    def frame_seconds(self) -> float:
        """Seconds of one encoder output frame."""
        return encoder_frame_seconds(self.frontend, self.model.cfg)


def _indexed(device) -> torch.device:
    """A device with its index ("cuda" is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _leaves(tree) -> List:
    out: List = []
    tree_map(out.append, tree)
    return out
