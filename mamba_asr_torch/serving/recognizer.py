"""Offline recognition, the port's entry point (the offline paths of
recognize.py, with training/trainer.py's make_eval_step).

    search="ctc" (default):
        waveform -> log-mel -> normaliser -> ASRModel -> greedy CTC collapse
    search="beam" (recognize.py --beam N):
        ... -> the CTC prefix beam search (decoding/ctc_beam.py) with the
        `decode` stanza's test_beam_size, beam_prune_logp and
        token_prune_min_logp, as the CTC recipe's test decoder
    search="s2s" (recognize.py --s2s):
        waveform -> log-mel -> normaliser -> ASRModel encoder + CTC
        log-probs -> joint CTC/attention beam search over the decoder
        (decoding/s2s_beam.py) -> the best hypothesis up to eos

The S2S search takes its settings from the `decode` stanza
(configs/loader.py:DecodeConfig): beam s2s_test_beam_size, CTC weight
ctc_weight_decode, ctc_candidates, temperature, length normalization and
the decode ratios, with at most 256 steps. With `lm_path` set it fuses
the TransformerLM that `models.lm.load_lm` builds from the stanza's
`lm_*` fields at the model's vocabulary (recognize.py:101-124):
lm_weight, temperature_lm. The CTC mode ignores the LM, as
recognize.py's does.

`transcribe` groups requests as recognize.py --batch does: sorted by
duration (stable), `batch` at a time, each group padded to a multiple
of 1 s and short groups filled with rows of wav_len 1, so a padded
request sees the same padding, and gives the same tokens, as there. In
S2S mode `batch=1` feeds each request unpadded, as recognize.py --s2s
does. With `times=True` each request also gets its greedy CTC alignment
(tokens, onsets, offsets, confidences; recognize.py --timestamps) from
the same forward.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from mamba_asr_torch.configs.loader import DecodeConfig, FrontendConfig
from mamba_asr_torch.decoding.ctc_beam import ctc_beam_decode
from mamba_asr_torch.decoding.ctc_greedy import (
    ctc_greedy_decode,
    ctc_greedy_decode_with_times,
    tokens_to_lists,
)
from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher, strip_special
from mamba_asr_torch.models.asr import ASRConfig, ASRModel
from mamba_asr_torch.models.lm import load_lm
from mamba_asr_torch.ops.fbank import log_mel_spectrogram
from mamba_asr_torch.training.normalizer import NormalizerState, apply_normalizer
from mamba_asr_torch.utils.device import resolve_device


@torch.no_grad()
def eval_step(model: ASRModel, frontend: FrontendConfig, normalizer: NormalizerState,
              wav: torch.Tensor, wav_lens: torch.Tensor,
              tokens_bos: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The forward of make_eval_step, on the normaliser's device (the
    model's): wav (B, T) float32, wav_lens (B,) int -> log-mel features,
    normalised -> model -> ctc_log_probs, enc_lengths, enc_out; with a
    decoder and tokens_bos (B, S) also the teacher-forced seq_log_probs
    (no target padding mask). The model must be in eval mode."""
    dev = normalizer.mean.device
    fe = frontend
    wav_lens = wav_lens.to(dev)
    feats = log_mel_spectrogram(
        wav.to(dev), sample_rate=fe.sample_rate, n_fft=fe.n_fft, n_mels=fe.n_mels,
        win_length_ms=fe.win_length_ms, hop_length_ms=fe.hop_length_ms,
    )
    flens = torch.clamp_max(wav_lens // fe.hop + 1, feats.shape[1])
    if tokens_bos is not None:
        tokens_bos = tokens_bos.to(dev)
    return model(apply_normalizer(normalizer, feats), flens, tokens_bos)


SEARCHES = ("ctc", "beam", "s2s")


class Recognizer:
    """Holds the model on its device and answers transcription requests.

    state_dict: the port's ASRModel state dict (reference names; e.g.
    from `models.params_import.import_asr_params`). normalizer: (count,
    mean, m2) of the JAX package's NormalizerState, or None for no
    statistics (features pass through). device: None means the CUDA card
    (raises without one); "cpu" runs the plain versions. search: "ctc"
    (greedy), "beam" (the CTC prefix beam search) or "s2s" (the joint
    beam search, with `decode`'s settings and its LM when `decode.lm_path`
    is set; the config needs a Transformer or Mamba decoder).
    `from_model` takes a model already built and restored
    (cli.restore_asr_state).
    """

    def __init__(
        self,
        cfg: ASRConfig,
        frontend: FrontendConfig,
        state_dict: Mapping[str, torch.Tensor],
        normalizer: Optional[Sequence] = None,
        device: Optional[Union[str, torch.device]] = None,
        batch: int = 1,
        decode: DecodeConfig = DecodeConfig(),
        search: str = "ctc",
    ):
        device = resolve_device(device)
        model = ASRModel(cfg)
        model.load_state_dict(state_dict, strict=True)
        if normalizer is None:
            zeros = np.zeros((frontend.n_mels,), np.float32)
            normalizer = (0.0, zeros, zeros)
        self._setup(model.to(device), NormalizerState.from_arrays(*normalizer, device=device),
                    frontend, batch, decode, search)

    @classmethod
    def from_model(cls, model: ASRModel, normalizer: NormalizerState,
                   frontend: FrontendConfig, batch: int = 1,
                   decode: DecodeConfig = DecodeConfig(), search: str = "ctc") -> "Recognizer":
        """A Recognizer over `model` as it is (its device, put in eval
        mode) and a NormalizerState on that device."""
        rec = cls.__new__(cls)
        rec._setup(model, normalizer, frontend, batch, decode, search)
        return rec

    def _setup(self, model: ASRModel, normalizer: NormalizerState, frontend: FrontendConfig,
               batch: int, decode: DecodeConfig, search: str) -> None:
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if search not in SEARCHES:
            raise ValueError(f"search must be one of {SEARCHES}, got {search!r}")
        self.model = model.eval()
        self.device = model.src_proj.weight.device
        self.normalizer = normalizer
        self.cfg, self.frontend, self.batch = model.cfg, frontend, batch
        self.decode, self.search = decode, search
        self.searcher = None
        if search == "s2s":
            lm = load_lm(decode, self.cfg.vocab_size, self.device)
            self.searcher = S2SBeamSearcher.from_decode(self.model, decode, lm)

    def eval_step(self, wav: torch.Tensor, wav_lens: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        """wav (B, T) float32, wav_lens (B,) int -> ctc_log_probs,
        enc_lengths, enc_out (make_eval_step without a decoder)."""
        return eval_step(self.model, self.frontend, self.normalizer, wav, wav_lens)

    def _search(self, out: Dict[str, torch.Tensor]) -> List[List[int]]:
        lp, lens = out["ctc_log_probs"], out["enc_lengths"]
        if self.search == "beam":
            return ctc_beam_decode(lp, lens, self.decode)
        if self.search == "s2s":
            toks, tlens, _ = self.searcher(out["enc_out"], lens, lp)
            return strip_special(toks.cpu().numpy(), tlens.cpu().numpy(),
                                 self.searcher.eos_id)
        toks, lens = ctc_greedy_decode(lp, lens)
        return tokens_to_lists(toks.cpu().numpy(), lens.cpu().numpy())

    def decode_batch(self, wav: torch.Tensor, wav_lens: torch.Tensor, times: bool = False):
        """One padded batch -> token ids per row, by the Recognizer's
        search; with `times`, (ids, alignment) per row, the alignment the
        greedy one: (tokens, onsets, offsets, confidences), cut to length."""
        out = self.eval_step(wav, wav_lens)
        ids = self._search(out)
        if not times:
            return ids
        toks, lens, ons, offs, confs = (x.cpu().numpy() for x in ctc_greedy_decode_with_times(
            out["ctc_log_probs"], out["enc_lengths"]))
        return [(row, tuple(a[r, :lens[r]] for a in (toks, ons, offs, confs)))
                for r, row in enumerate(ids)]

    def transcribe(self, wavs: Sequence[np.ndarray], times: bool = False) -> list:
        """1-D float32 waveforms -> token ids, in the order given; with
        `times`, (ids, greedy alignment) per request."""
        wavs = [np.asarray(w, dtype=np.float32) for w in wavs]
        if self.searcher is not None and self.batch == 1:
            return [self.decode_batch(torch.from_numpy(w)[None],
                                      torch.tensor([len(w)], dtype=torch.int32), times)[0]
                    for w in wavs]
        order = sorted(range(len(wavs)), key=lambda i: len(wavs[i]))
        bucket = self.frontend.sample_rate  # 1 s
        results: list = [None] * len(wavs)
        for start in range(0, len(order), self.batch):
            group = order[start:start + self.batch]
            max_len = max(len(wavs[i]) for i in group)
            pad_len = -(-max_len // bucket) * bucket
            wav_mat = np.zeros((self.batch, pad_len), np.float32)
            wav_lens = np.ones((self.batch,), np.int32)  # padded rows: 1
            for r, i in enumerate(group):
                wav_mat[r, : len(wavs[i])] = wavs[i]
                wav_lens[r] = len(wavs[i])
            rows = self.decode_batch(torch.from_numpy(wav_mat), torch.from_numpy(wav_lens),
                                     times)
            for r, i in enumerate(group):
                results[i] = rows[r]
        return results
