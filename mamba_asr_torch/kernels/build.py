"""Build the port's CUDA kernels from `mamba_asr_torch/csrc` at first use.

Each `csrc/<name>.cu` compiles with nvcc, for sm_90a, into its own shared
library with a plain C interface, which `library(name)` loads with
ctypes. The build goes to `build/mamba_asr_torch/<hash>/` at the root of
the checkout, where the hash covers every source and the flags, so a
changed source builds anew and an unchanged one is reused. `build_all`
starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "mamba_asr_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "--split-compile=0",  # optimise a source's kernels in parallel (scan_variants.cu)
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> its .cu source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def build_all() -> Dict[str, Path]:
    """Compile every source not yet built, in parallel. Returns name ->
    library path. The compiler's output (ptxas register and spill
    report) is kept beside each library as `<name>.log`."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in sources()}
    todo = {n: src for n, src in sources().items() if not libs[n].exists()}
    procs = {}
    for name, src in todo.items():
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        log = open(out_dir / f"{name}.log", "w", encoding="utf-8")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (rc {rc}):\n{build_log(name)}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def build_log(name: str) -> str:
    path = build_dir() / f"{name}.log"
    return path.read_text(encoding="utf-8") if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        _LOADED[name] = lib
    return lib
