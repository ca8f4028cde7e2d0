"""Offline recognition, the port's entry point (the offline paths of
recognize.py, with training/trainer.py's make_eval_step).

    search="ctc" (default):
        waveform -> log-mel -> normaliser -> ASRModel -> greedy CTC collapse
    search="s2s" (recognize.py --s2s):
        waveform -> log-mel -> normaliser -> ASRModel encoder + CTC
        log-probs -> joint CTC/attention beam search over the decoder
        (decoding/s2s_beam.py) -> the best hypothesis up to eos

The S2S search takes its settings from the `decode` stanza
(configs/loader.py:DecodeConfig): beam s2s_test_beam_size, CTC weight
ctc_weight_decode, ctc_candidates, temperature, length normalization and
the decode ratios, with at most 256 steps. No YAML configures an LM
(`lm_path` is empty) and LM fusion is not ported: a non-empty `lm_path`
raises.

`transcribe` groups requests as recognize.py --batch does: sorted by
duration (stable), `batch` at a time, each group padded to a multiple
of 1 s and short groups filled with rows of wav_len 1, so a padded
request sees the same padding, and gives the same tokens, as there. In
S2S mode `batch=1` feeds each request unpadded, as recognize.py --s2s
does.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from mamba_asr_torch.configs.loader import DecodeConfig, FrontendConfig
from mamba_asr_torch.decoding.ctc_greedy import ctc_greedy_decode, tokens_to_lists
from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher, strip_special
from mamba_asr_torch.models.asr import ASRConfig, ASRModel
from mamba_asr_torch.ops.fbank import log_mel_spectrogram
from mamba_asr_torch.training.normalizer import NormalizerState, apply_normalizer
from mamba_asr_torch.utils.device import resolve_device


@torch.no_grad()
def eval_step(model: ASRModel, frontend: FrontendConfig, normalizer: NormalizerState,
              wav: torch.Tensor, wav_lens: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The forward of make_eval_step without a decoder, on the
    normaliser's device (the model's): wav (B, T) float32, wav_lens (B,)
    int -> log-mel features, normalised -> model -> ctc_log_probs,
    enc_lengths, enc_out. The model must be in eval mode."""
    dev = normalizer.mean.device
    fe = frontend
    wav_lens = wav_lens.to(dev)
    feats = log_mel_spectrogram(
        wav.to(dev), sample_rate=fe.sample_rate, n_fft=fe.n_fft, n_mels=fe.n_mels,
        win_length_ms=fe.win_length_ms, hop_length_ms=fe.hop_length_ms,
    )
    flens = torch.clamp_max(wav_lens // fe.hop + 1, feats.shape[1])
    return model(apply_normalizer(normalizer, feats), flens)


class Recognizer:
    """Holds the model on its device and answers transcription requests.

    state_dict: the port's ASRModel state dict (reference names; e.g.
    from `models.params_import.import_asr_params`). normalizer: (count,
    mean, m2) of the JAX package's NormalizerState, or None for no
    statistics (features pass through). device: None means the CUDA card
    (raises without one); "cpu" runs the plain versions. search: "ctc"
    (greedy) or "s2s" (the joint beam search, with `decode`'s settings;
    the config needs a Transformer decoder).
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
        self.device = resolve_device(device)
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if search not in ("ctc", "s2s"):
            raise ValueError(f"search must be 'ctc' or 's2s', got {search!r}")
        model = ASRModel(cfg)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        if normalizer is None:
            zeros = np.zeros((frontend.n_mels,), np.float32)
            normalizer = (0.0, zeros, zeros)
        self.normalizer = NormalizerState.from_arrays(*normalizer, device=self.device)
        self.cfg, self.frontend, self.batch = cfg, frontend, batch
        self.search = search
        self.searcher = None
        if search == "s2s":
            if decode.lm_path:
                raise NotImplementedError(
                    "decode.lm_path is set: LM fusion is not ported (ROADMAP slice 3b)")
            self.searcher = S2SBeamSearcher(
                self.model, beam_size=decode.s2s_test_beam_size,
                ctc_weight=decode.ctc_weight_decode,
                ctc_candidates=decode.ctc_candidates,
                temperature=decode.temperature,
                length_normalization=decode.length_normalization,
                max_decode_ratio=decode.max_decode_ratio,
                min_decode_ratio=decode.min_decode_ratio,
            )

    def eval_step(self, wav: torch.Tensor, wav_lens: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        """wav (B, T) float32, wav_lens (B,) int -> ctc_log_probs,
        enc_lengths, enc_out (make_eval_step without a decoder)."""
        return eval_step(self.model, self.frontend, self.normalizer, wav, wav_lens)

    def decode_batch(self, wav: torch.Tensor, wav_lens: torch.Tensor) -> List[List[int]]:
        """One padded batch -> token ids per row, by the Recognizer's search."""
        out = self.eval_step(wav, wav_lens)
        if self.searcher is None:
            toks, lens = ctc_greedy_decode(out["ctc_log_probs"], out["enc_lengths"])
            return tokens_to_lists(toks.cpu().numpy(), lens.cpu().numpy())
        toks, lens, _ = self.searcher(out["enc_out"], out["enc_lengths"],
                                      out["ctc_log_probs"])
        return strip_special(toks.cpu().numpy(), lens.cpu().numpy(),
                             self.searcher.eos_id)

    def transcribe(self, wavs: Sequence[np.ndarray]) -> List[List[int]]:
        """1-D float32 waveforms -> token ids, in the order given."""
        wavs = [np.asarray(w, dtype=np.float32) for w in wavs]
        if self.searcher is not None and self.batch == 1:
            return [self.decode_batch(torch.from_numpy(w)[None],
                                      torch.tensor([len(w)], dtype=torch.int32))[0]
                    for w in wavs]
        order = sorted(range(len(wavs)), key=lambda i: len(wavs[i]))
        bucket = self.frontend.sample_rate  # 1 s
        results: List[List[int]] = [[] for _ in wavs]
        for start in range(0, len(order), self.batch):
            group = order[start:start + self.batch]
            max_len = max(len(wavs[i]) for i in group)
            pad_len = -(-max_len // bucket) * bucket
            wav_mat = np.zeros((self.batch, pad_len), np.float32)
            wav_lens = np.ones((self.batch,), np.int32)  # padded rows: 1
            for r, i in enumerate(group):
                wav_mat[r, : len(wavs[i])] = wavs[i]
                wav_lens[r] = len(wavs[i])
            ids = self.decode_batch(torch.from_numpy(wav_mat), torch.from_numpy(wav_lens))
            for r, i in enumerate(group):
                results[i] = ids[r]
        return results
