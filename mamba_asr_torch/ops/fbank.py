"""Log-mel filterbank features (port of mamba_asr_tpu/ops/fbank.py).

Power spectrum of a Hamming-windowed real DFT, HTK-mel triangular
filters (f_min 0, f_max sr/2), 10*log10(max(mel, eps)) and a per-utterance
top_db floor, as SpeechBrain's Filterbank(log_mel=True). The framing and
windowed DFT run as one strided conv1d whose kernel is the windowed
cos/sin bases, so no (B, frames, win) tensor is gathered.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def _mel_matrix_np(
    n_mels: int, n_fft: int, sample_rate: int, f_min: float, f_max: float
) -> np.ndarray:
    """Triangular mel filterbank matrix, (n_fft//2 + 1, n_mels). Cached:
    callers must not write to it."""
    n_bins = n_fft // 2 + 1
    freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_bins, n_mels), dtype=np.float32)
    for m in range(n_mels):
        left, center, right = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - left) / max(center - left, 1e-10)
        down = (right - freqs) / max(right - center, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def mel_filterbank(
    n_mels: int = 80,
    n_fft: int = 512,
    sample_rate: int = 16000,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
    device=None,
) -> torch.Tensor:
    """Mel filterbank matrix, (n_fft//2 + 1, n_mels) float32."""
    if f_max is None:
        f_max = sample_rate / 2.0
    fb = _mel_matrix_np(n_mels, n_fft, sample_rate, f_min, f_max)
    return torch.tensor(fb, device=device)


@functools.lru_cache(maxsize=8)
def _dft_bases_np(n_fft: int, win_samples: int) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases (win_samples, n_bins) for cos and -sin.

    The window is np.hamming, the SYMMETRIC Hamming window (SpeechBrain's
    STFT default); torch.hamming_window defaults to the periodic one.
    Cached: callers must not write to the arrays.
    """
    n_bins = n_fft // 2 + 1
    window = np.hamming(win_samples).astype(np.float64)
    t = np.arange(win_samples)[:, None]  # window is zero-padded to n_fft
    k = np.arange(n_bins)[None, :]
    angle = -2.0 * np.pi * t * k / n_fft
    cos_b = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_b = (np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


def log_mel_spectrogram(
    wav: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 512,
    n_mels: int = 80,
    win_length_ms: float = 25.0,
    hop_length_ms: float = 10.0,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
    top_db: Optional[float] = 80.0,
    eps: float = 1e-10,
    center: bool = True,
) -> torch.Tensor:
    """Waveform (B, T) -> log-mel features (B, num_frames, n_mels) float32.

    num_frames = T // hop + 1 with center=True (win//2 zeros padded on both
    sides); with center=False (streaming), 1 + (T - win) // hop. The top_db
    floor takes the max over each whole (padded) row.
    """
    win_samples = int(round(sample_rate * win_length_ms / 1000.0))
    hop = int(round(sample_rate * hop_length_ms / 1000.0))
    win_samples = min(win_samples, n_fft)
    n_bins = n_fft // 2 + 1

    cos_b, sin_b = _dft_bases_np(n_fft, win_samples)
    # conv1d kernel (2*n_bins, 1, win): [cos | sin] bases.
    kernel = torch.tensor(
        np.concatenate([cos_b, sin_b], axis=1).T[:, None, :], device=wav.device
    )
    pad = win_samples // 2 if center else 0
    spec = F.conv1d(wav.float()[:, None, :], kernel, stride=hop, padding=pad)
    spec = spec.transpose(1, 2)  # (B, frames, 2*n_bins)
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    power = re * re + im * im

    mel = power @ mel_filterbank(n_mels, n_fft, sample_rate, f_min, f_max, wav.device)
    log_mel = 10.0 * torch.log10(torch.clamp_min(mel, eps))
    if top_db is not None:
        floor = log_mel.amax(dim=(1, 2), keepdim=True) - top_db
        log_mel = torch.maximum(log_mel, floor)
    return log_mel

