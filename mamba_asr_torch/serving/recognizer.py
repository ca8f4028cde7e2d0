"""Offline CTC recognition, the port's entry point (the offline path of
recognize.py, with training/trainer.py's make_eval_step).

    waveform -> log-mel -> normaliser -> ASRModel -> greedy CTC collapse

`transcribe` groups requests as recognize.py --batch does: sorted by
duration (stable), `batch` at a time, each group padded to a multiple
of 1 s and short groups filled with rows of wav_len 1, so a padded
request sees the same padding, and gives the same tokens, as there.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from mamba_asr_torch.configs.loader import FrontendConfig
from mamba_asr_torch.decoding.ctc_greedy import ctc_greedy_decode, tokens_to_lists
from mamba_asr_torch.models.asr import ASRConfig, ASRModel
from mamba_asr_torch.ops.fbank import log_mel_spectrogram
from mamba_asr_torch.training.normalizer import NormalizerState, apply_normalizer
from mamba_asr_torch.utils.device import resolve_device


class Recognizer:
    """Holds the model on its device and answers transcription requests.

    state_dict: the port's ASRModel state dict (reference names; e.g.
    from `models.params_import.import_asr_params`). normalizer: (count,
    mean, m2) of the JAX package's NormalizerState, or None for no
    statistics (features pass through). device: None means the CUDA card
    (raises without one); "cpu" runs the plain versions.
    """

    def __init__(
        self,
        cfg: ASRConfig,
        frontend: FrontendConfig,
        state_dict: Mapping[str, torch.Tensor],
        normalizer: Optional[Sequence] = None,
        device: Optional[Union[str, torch.device]] = None,
        batch: int = 1,
    ):
        self.device = resolve_device(device)
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        model = ASRModel(cfg)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        if normalizer is None:
            zeros = np.zeros((frontend.n_mels,), np.float32)
            normalizer = (0.0, zeros, zeros)
        self.normalizer = NormalizerState.from_arrays(*normalizer, device=self.device)
        self.cfg, self.frontend, self.batch = cfg, frontend, batch

    @torch.no_grad()
    def eval_step(self, wav: torch.Tensor, wav_lens: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        """wav (B, T) float32, wav_lens (B,) int -> ctc_log_probs,
        enc_lengths, enc_out (make_eval_step without a decoder)."""
        fe = self.frontend
        wav = wav.to(self.device)
        wav_lens = wav_lens.to(self.device)
        feats = log_mel_spectrogram(
            wav, sample_rate=fe.sample_rate, n_fft=fe.n_fft, n_mels=fe.n_mels,
            win_length_ms=fe.win_length_ms, hop_length_ms=fe.hop_length_ms,
        )
        flens = torch.clamp_max(wav_lens // fe.hop + 1, feats.shape[1])
        feats = apply_normalizer(self.normalizer, feats)
        return self.model(feats, flens)

    def transcribe(self, wavs: Sequence[np.ndarray]) -> List[List[int]]:
        """1-D float32 waveforms -> token ids, in the order given."""
        wavs = [np.asarray(w, dtype=np.float32) for w in wavs]
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
            out = self.eval_step(torch.from_numpy(wav_mat), torch.from_numpy(wav_lens))
            toks, lens = ctc_greedy_decode(out["ctc_log_probs"], out["enc_lengths"])
            ids = tokens_to_lists(toks.cpu().numpy(), lens.cpu().numpy())
            for r, i in enumerate(group):
                results[i] = ids[r]
        return results
