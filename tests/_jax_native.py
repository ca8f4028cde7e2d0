"""The JAX package's native libraries for the port's tests, without racing
the JAX package's own tests.

`mamba_asr_tpu/native/__init__.py` builds `lib<name>.so` with g++ at
first use, in place in its package directory, under a thread lock only.
A process that dlopens the file while another process's g++ is still
writing it gets None, caches it, and every FLAC, resampling or native
edit-distance call in that process then fails or falls back
(tests/test_native.py's FLAC tests have failed so). So the port's tests
that reach those libraries take the `jax_native` fixture: under an
`fcntl` lock it builds each library with the JAX package's flags to a
temporary name in the same directory, dlopens that complete file, hands
it to the JAX package's cache (`native._LIBS`) and `os.replace`s it onto
the library's name. This process then never opens a file another process
is writing, nor writes one in place. The JAX package is not changed.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import tempfile

import pytest

from mamba_asr_tpu import native

LIBS = ("flac_decode", "edit_distance")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")  # native/__init__.py:_build_and_load's


def load_jax_native() -> None:
    lock = os.path.join(tempfile.gettempdir(), "mamba_asr_tpu_native.lock")
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        for name in LIBS:
            if native._LIBS.get(name) is not None:
                continue
            src = os.path.join(native._DIR, f"{name}.cpp")
            tmp = os.path.join(native._DIR, f".lib{name}.{os.getpid()}.so")
            subprocess.run(["g++", *FLAGS, src, "-o", tmp], check=True, capture_output=True)
            lib = ctypes.CDLL(tmp)
            os.replace(tmp, os.path.join(native._DIR, f"lib{name}.so"))
            native._LIBS[name] = lib


@pytest.fixture(scope="module")
def jax_native():
    load_jax_native()
