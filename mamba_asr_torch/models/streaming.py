"""Streaming recognition over chunked audio (port of
mamba_asr_tpu/models/streaming.py).

- `StreamingFrontend`: the Conv2d front end streamed exactly. Offline SAME
  padding at an even length is (0, 1) per level, one zero frame of look
  ahead, so each level buffers its inputs that no output has used yet,
  runs VALID over [carry, new] (`ConvolutionFrontEnd.apply_level`) and
  emits only outputs whose window is real; `finish` feeds each level its
  one trailing zero.
- `StreamingASRSession`: greedy CTC over chunks. It carries the audio
  tail for fbank framing (center=False), the frozen normaliser, the
  encoder's per-layer state (ASRModel.init_streaming_state) and the last
  frame's id for the collapse across chunks. `finish` emits the frames
  that offline center padding adds, pads the feature frames with zeros
  to a multiple of the front end's downsampling and flushes the front
  end: the streamed tokens then equal the offline greedy decode of the
  same zero-padded features, for a causal model exactly
  (`_canonical_pad_frames` says why the padding is needed).
- `StreamingS2SSession`: the ConMambaMamba model's long-form stream. Each
  chunk of encoder output extends every decoder layer's cross-Mamba
  state (ASRModel.extend_decoder_cache); `decode_greedy` emits tokens
  from the state so far and keeps the decoder's self state.

The host protocol is the JAX package's: numpy audio in, token id lists
out. The encoder state stays on the model's device; each chunk syncs
once, to read its argmax ids. Every call runs under torch.no_grad, and
the model must be in eval mode.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mamba_asr_torch.configs.loader import FrontendConfig
from mamba_asr_torch.models.asr import ASRModel
from mamba_asr_torch.models.layers import dense
from mamba_asr_torch.ops.fbank import log_mel_spectrogram
from mamba_asr_torch.training.normalizer import NormalizerState, apply_normalizer


class StreamingFrontend:
    """The front end of `model`, fed feature chunks: per-level carries,
    VALID levels mid-stream, one trailing zero per level at `finish`."""

    def __init__(self, model: ASRModel):
        self.fe = model.frontend
        self.carry: List[Optional[torch.Tensor]] = [None] * len(self.fe.strides)

    def _feed_level(self, i: int, x: torch.Tensor) -> Optional[torch.Tensor]:
        """x (B, T, F, C) new inputs of level i -> its emitted outputs, or
        None when no window is complete; updates the carry."""
        buf = x if self.carry[i] is None else torch.cat([self.carry[i], x], dim=1)
        k, s = self.fe.kernel_sizes[i], self.fe.strides[i]
        emitted = max(0, (buf.shape[1] - k) // s + 1)
        if emitted == 0:
            self.carry[i] = buf
            return None
        out = self.fe.apply_level(i, buf, (0, 0))
        self.carry[i] = buf[:, emitted * s:]
        return out

    def feed(self, feats: torch.Tensor) -> Optional[torch.Tensor]:
        """feats (B, T, n_mels) -> emitted (B, T', F', C), or None."""
        x = feats[..., None]
        for i in range(len(self.carry)):
            x = self._feed_level(i, x)
            if x is None:
                return None
        return x

    def finish(self) -> Optional[torch.Tensor]:
        """Each level takes the level above's flush output and its own
        trailing zero frame (the offline SAME right padding); returns the
        last level's output, or None."""
        x = None
        for i in range(len(self.carry)):
            template = self.carry[i] if self.carry[i] is not None else x
            if template is None:
                continue  # the level never received a frame
            zero = torch.zeros_like(template[:, :1])
            x = self._feed_level(i, zero if x is None else torch.cat([x, zero], dim=1))
        return x


class StreamingASRSession:
    """Greedy streaming CTC over chunked audio.

    model: an ASRModel in eval mode whose encoder streams (ConMamba,
    Conformer, Branchformer), on its device. normalizer: frozen statistics
    on that device, or None (features pass through). chunk_frames: the fbank
    frames of audio one `feed` usually brings (recognize's --chunk_frames).
    collect_log_probs: keep each chunk's CTC log-probs (numpy, (B, T',
    V)) in `log_probs`. enc_sink: a list that receives each chunk's
    encoder output (B, T', d_model), on the device.
    """

    def __init__(self, model: ASRModel, frontend: FrontendConfig,
                 normalizer: Optional[NormalizerState] = None, chunk_frames: int = 64,
                 batch: int = 1, collect_log_probs: bool = False,
                 enc_sink: Optional[list] = None):
        self.model = model
        self.frontend = frontend
        self.normalizer = normalizer
        self.batch = batch
        self.device = model.src_proj.weight.device
        win = int(round(frontend.sample_rate * frontend.win_length_ms / 1000))
        self.win = min(win, frontend.n_fft)
        self.hop = frontend.hop
        self.chunk_samples = chunk_frames * self.hop
        self.enc_state = model.init_streaming_state(batch)
        # The fbank framing tail: the first chunk gets the center padding.
        self.audio_tail = np.zeros((batch, self.win // 2), np.float32)
        self.last_frame_tok = np.zeros((batch,), np.int64)
        self.fe_stream = StreamingFrontend(model)
        self.collect_log_probs = collect_log_probs
        self.log_probs: List[np.ndarray] = []
        self.enc_sink = enc_sink
        # Center framing gives S // hop + 1 frames for S samples; finish()
        # pads zeros to emit exactly the remainder.
        self._samples_fed = 0
        self._frames_done = 0

    def _frame_window(self, audio_chunk: np.ndarray) -> Tuple[np.ndarray, int]:
        """The [tail, chunk] window of whole frames and their count; the
        samples not yet framed become the next tail."""
        buf = np.concatenate([self.audio_tail.astype(np.float32),
                              audio_chunk.astype(np.float32)], axis=1)
        if buf.shape[1] < self.win:
            self.audio_tail = buf
            return buf, 0
        n_frames = 1 + (buf.shape[1] - self.win) // self.hop
        self.audio_tail = buf[:, n_frames * self.hop:]
        self._frames_done += n_frames
        return buf[:, : self.win + (n_frames - 1) * self.hop], n_frames

    def _feats(self, window: np.ndarray) -> torch.Tensor:
        fe = self.frontend
        feats = log_mel_spectrogram(
            torch.from_numpy(np.ascontiguousarray(window)).to(self.device),
            sample_rate=fe.sample_rate, n_fft=fe.n_fft, n_mels=fe.n_mels,
            win_length_ms=fe.win_length_ms, hop_length_ms=fe.hop_length_ms, center=False)
        if self.normalizer is not None:
            feats = apply_normalizer(self.normalizer, feats)
        return feats

    def _encode(self, fe_out: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Emitted front-end output through the encoder's chunk; advances
        the encoder state. Returns the chunk's encoder output or None."""
        if fe_out is None or fe_out.shape[1] == 0:
            return None
        enc, self.enc_state = self.model.forward_chunk(fe_out, self.enc_state)
        return enc

    def _advance(self, fe_out: Optional[torch.Tensor]) -> Optional[np.ndarray]:
        """Encoder and CTC argmax: the chunk's best id per frame (B, T'),
        or None when nothing was emitted."""
        enc = self._encode(fe_out)
        if enc is None:
            return None
        logits = dense(enc.float(), self.model.ctc_head, torch.float32)
        lp = F.log_softmax(logits, dim=-1)
        if self.collect_log_probs:
            self.log_probs.append(lp.cpu().numpy())
        if self.enc_sink is not None:
            self.enc_sink.append(enc)
        return lp.argmax(dim=-1).cpu().numpy()

    def _collapse(self, best: Optional[np.ndarray]) -> List[List[int]]:
        out: List[List[int]] = [[] for _ in range(self.batch)]
        if best is None:
            return out
        for b in range(self.batch):
            prev = self.last_frame_tok[b]
            for t in best[b]:
                if t != 0 and t != prev:
                    out[b].append(int(t))
                prev = t
            self.last_frame_tok[b] = prev
        return out

    def _front(self, audio_chunk: np.ndarray) -> Optional[torch.Tensor]:
        """A chunk of audio through fbank, the normaliser and the streamed
        front end: the emitted output, or None."""
        if audio_chunk.ndim == 1:
            audio_chunk = audio_chunk[None]
        self._samples_fed += audio_chunk.shape[1]
        window, n_frames = self._frame_window(audio_chunk)
        if n_frames <= 0:
            return None
        return self.fe_stream.feed(self._feats(window))

    @torch.no_grad()
    def feed(self, audio_chunk: np.ndarray) -> List[List[int]]:
        """Audio (B, samples) or (samples,) -> the token ids newly emitted
        per stream (greedy CTC, collapsed across chunks)."""
        return self._collapse(self._advance(self._front(audio_chunk)))

    def _flush_frames(self) -> Optional[torch.Tensor]:
        """The frames offline center padding adds at the end, through
        fbank and the front end: the emitted output, or None."""
        rem = self._samples_fed // self.hop + 1 - self._frames_done
        if rem <= 0:
            return None
        need = self.win + (rem - 1) * self.hop
        z = max(0, need - self.audio_tail.shape[1])
        window, n_frames = self._frame_window(np.zeros((self.batch, z), np.float32))
        if n_frames <= 0:
            return None
        return self.fe_stream.feed(self._feats(window))

    def _canonical_pad_frames(self) -> Optional[torch.Tensor]:
        """Zero feature frames (normalised domain) that round the frame
        count up to a multiple of the front end's downsampling. Offline
        SAME padding splits by each level's parity (an odd count gets a
        leading zero, which a stream cannot know in time); at a multiple
        of the strides' product every level is even, where the flush of
        `StreamingFrontend.finish` is offline SAME exactly. The offline
        equal pads the same: feats -> normalise -> zeros to the multiple
        -> model."""
        extra = (-self._frames_done) % self.model.cfg.downsample
        if extra == 0:
            return None
        self._frames_done += extra
        return torch.zeros(self.batch, extra, self.frontend.n_mels, device=self.device)

    def _finish_outputs(self):
        """The front-end outputs that end the stream, in order: the
        center-padding frames, the canonical padding, the front end's
        flush."""
        yield self._flush_frames()
        pad = self._canonical_pad_frames()
        if pad is not None:
            yield self.fe_stream.feed(pad)
        yield self.fe_stream.finish()

    @torch.no_grad()
    def finish(self) -> List[List[int]]:
        """End of stream: the last token ids per stream."""
        out: List[List[int]] = [[] for _ in range(self.batch)]
        for fe_out in self._finish_outputs():
            out = [a + b for a, b in zip(out, self._collapse(self._advance(fe_out)))]
        return out


class StreamingS2SSession:
    """Long-form streaming with the Mamba decoder (ConMambaMamba): `feed`
    advances the encoder and every layer's cross-Mamba state; `finish`
    flushes the stream's end into them; `decode_greedy(max_new)` emits up
    to max_new tokens from the current state, keeping the decoder's self
    state (transducer-style)."""

    def __init__(self, model: ASRModel, frontend: FrontendConfig,
                 normalizer: Optional[NormalizerState] = None, chunk_frames: int = 64,
                 batch: int = 1, bos_id: int = 1, eos_id: int = 2):
        if not model.mamba_decoder:
            raise ValueError("StreamingS2SSession needs the Mamba decoder")
        self.inner = StreamingASRSession(model, frontend, normalizer, chunk_frames, batch)
        self.model = model
        self.batch = batch
        self.eos_id = eos_id
        self.dec_cache = model.init_decoder_cache(batch)
        self.last_token = torch.full((batch,), bos_id, dtype=torch.long,
                                     device=self.inner.device)
        self.pos = 0

    def _extend_with(self, fe_out: Optional[torch.Tensor]) -> None:
        enc = self.inner._encode(fe_out)
        if enc is not None:
            self.dec_cache = self.model.extend_decoder_cache(enc, self.dec_cache)

    @torch.no_grad()
    def feed(self, audio_chunk: np.ndarray) -> None:
        """Advance the encoder and the decoder's memory state with audio."""
        self._extend_with(self.inner._front(audio_chunk))

    @torch.no_grad()
    def finish(self) -> None:
        for fe_out in self.inner._finish_outputs():
            self._extend_with(fe_out)

    @torch.no_grad()
    def decode_greedy(self, max_new: int = 32) -> List[List[int]]:
        """Up to max_new greedy tokens per stream, each stream up to its
        eos."""
        out: List[List[int]] = [[] for _ in range(self.batch)]
        tok = self.last_token
        done = np.zeros(self.batch, bool)
        for _ in range(max_new):
            logits, self.dec_cache = self.model.decode_step(tok, self.pos, self.dec_cache)
            tok = logits.argmax(dim=-1)
            self.pos += 1
            tok_np = tok.cpu().numpy()
            for b in range(self.batch):
                if not done[b]:
                    if tok_np[b] == self.eos_id:
                        done[b] = True
                    else:
                        out[b].append(int(tok_np[b]))
            if done.all():
                break
        self.last_token = tok
        return out
