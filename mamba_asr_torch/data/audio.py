"""Audio IO (port of mamba_asr_tpu/data/audio.py): WAV through the
standard library, FLAC through the port's C++ decoder
(`native/flac_decode.cpp`), durations from the file headers.

The JAX package falls back to soundfile or torchaudio when its decoder
does not build; the port has no fallback: a failed build raises
(`native.build`).
"""

from __future__ import annotations

import ctypes
import os
import wave
from typing import Tuple

import numpy as np

from mamba_asr_torch.native.build import flac_lib


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono waveform in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (a[:, 0].astype(np.int32) | (a[:, 1].astype(np.int32) << 8)
                | (a[:, 2].astype(np.int32) << 16))
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV sample width {width} in {path}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 [-1, 1] to 16-bit PCM WAV."""
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def _utf8_code(n: int) -> bytes:
    """FLAC frame-number coding (standard UTF-8 of the integer)."""
    if n < 0x80:
        return bytes([n])
    if n < 0x800:
        return bytes([0xC0 | (n >> 6), 0x80 | (n & 0x3F)])
    if n < 0x10000:
        return bytes([0xE0 | (n >> 12), 0x80 | ((n >> 6) & 0x3F), 0x80 | (n & 0x3F)])
    raise ValueError(f"frame number too large: {n}")


def write_flac(path: str, wav: np.ndarray, sample_rate: int, block: int = 4096) -> None:
    """Write mono float32 [-1, 1] as 16-bit FLAC with verbatim subframes
    (raw big-endian PCM, every field on a byte boundary), for test and
    benchmark corpora."""
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    n = len(pcm)
    si = 0
    for val, w in [(block, 16), (block, 16), (0, 24), (0, 24),
                   (sample_rate, 20), (0, 3), (15, 5), (n, 36), (0, 128)]:
        si = (si << w) | val
    parts = [b"fLaC", bytes([0x80, 0, 0, 34]), si.to_bytes(34, "big")]
    # Frame header: sync(14) 0 0 | blocksize-code 0111, rate-code 0000 |
    # channels 0000, bps 100, 0  ->  FF F8 70 08.
    fixed = bytes([0xFF, 0xF8, 0x70, 0x08])
    for frame_no, idx in enumerate(range(0, max(n, 1), block)):
        chunk = pcm[idx: idx + block]
        parts.append(
            fixed + _utf8_code(frame_no) + (len(chunk) - 1).to_bytes(2, "big")
            + b"\x00"            # crc8 (the decoder skips it)
            + b"\x02"            # subframe: pad 0, type VERBATIM, wasted 0
            + chunk.astype(">i2").tobytes()
            + b"\x00\x00"        # crc16 (the decoder skips it)
        )
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def flac_stream_info(path: str) -> Tuple[int, int]:
    """(total_samples, sample_rate) from the FLAC STREAMINFO header."""
    with open(path, "rb") as f:
        if f.read(4) != b"fLaC":
            raise ValueError(f"not a FLAC file: {path}")
        header = f.read(4)
        block_type = header[0] & 0x7F
        length = int.from_bytes(header[1:4], "big")
        if block_type != 0:
            raise ValueError(f"STREAMINFO not first metadata block: {path}")
        info = f.read(length)
    # 16+16+24+24 bits, then 20 bits sample rate, 3 bits channels-1,
    # 5 bits bps-1, 36 bits total samples.
    bits = int.from_bytes(info[10:18], "big")
    return bits & ((1 << 36) - 1), bits >> 44


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file with the port's C++ decoder -> (float32 mono
    waveform, sample_rate)."""
    lib = flac_lib()
    total, _ = flac_stream_info(path)
    if total == 0:  # length unknown in STREAMINFO: ask the decoder
        total = lib.flac_decode_file(path.encode(), None, 0,
                                     ctypes.byref(ctypes.c_int32()))
        if total < 0:
            raise ValueError(f"FLAC decode failed: {path}")
    out = np.zeros(int(total), np.float32)
    sr = ctypes.c_int32(0)
    n = lib.flac_decode_file(path.encode(),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             out.size, ctypes.byref(sr))
    if n < 0:
        raise ValueError(f"FLAC decode failed: {path}")
    return out[:n], int(sr.value)


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Read WAV or FLAC -> (float32 mono waveform, sample_rate)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return read_wav(path)
    if ext == ".flac":
        return read_flac(path)
    raise ValueError(f"unsupported audio format: {path}")


def audio_duration(path: str) -> float:
    """Duration in seconds from the file header (no decode)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".flac":
        total, sr = flac_stream_info(path)
        return total / sr
    if ext == ".wav":
        with wave.open(path, "rb") as w:
            return w.getnframes() / w.getframerate()
    raise ValueError(f"unsupported audio format: {path}")
