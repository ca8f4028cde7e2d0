"""Build the port's host C++ (`native/flac_decode.cpp`) at first use.

The source compiles with the JAX package's flags
(`g++ -O3 -shared -fPIC -std=c++17`, mamba_asr_tpu/native/__init__.py),
so the port's copy decodes and resamples to the same bits. No
`-ffast-math` or `-march=native`: either would change the resampler's
sums. The library goes to `build/mamba_asr_torch/native/<hash>/` at the
root of the checkout, where the hash covers the source, the flags and
the compiler's version. A failed build raises: there is no other FLAC
decoder and no plain resampler to fall back to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "flac_decode.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "mamba_asr_torch" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    """Compile the source if not yet built; returns the library's path."""
    version = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                             check=True).stdout
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(version.encode())  # a checkout moved to another machine builds anew
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libflac_decode.so"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libflac_decode.so.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {SOURCE.name} "
                               f"(rc {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def flac_lib() -> ctypes.CDLL:
    """The loaded library, with the argument and result types of its three
    entries: flac_decode_file, linear_resample and sinc_resample."""
    lib = ctypes.CDLL(str(library_path()))
    fp = ctypes.POINTER(ctypes.c_float)
    lib.flac_decode_file.restype = ctypes.c_int64
    lib.flac_decode_file.argtypes = [ctypes.c_char_p, fp, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_int32)]
    lib.linear_resample.restype = ctypes.c_int64
    lib.linear_resample.argtypes = [fp, ctypes.c_int64, ctypes.c_double, fp,
                                    ctypes.c_int64]
    lib.sinc_resample.restype = ctypes.c_int64
    lib.sinc_resample.argtypes = [fp, ctypes.c_int64, ctypes.c_double, fp,
                                  ctypes.c_int64, ctypes.c_int32]
    return lib
