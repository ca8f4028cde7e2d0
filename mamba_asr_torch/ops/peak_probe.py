"""The attainable-rate probe (port of the kernel in scripts/vpu_peak.py).

For each float32 element x, a chain of k steps (`mode`):

    dependent:    acc = x;  k times acc = acc * x + 0.5
    independent:  acc_j = x (1 + 0.125 j), j < 4;  k // 4 times
                  acc_j = acc_j * x + (0.25 + 0.125 j);  out = sum_j acc_j
    exp2:         acc = x;  k times acc = exp2(acc * x) * 0.5

`peak_probe` sends CPU tensors to the plain loop `peak_probe_ref` and CUDA
tensors to the Hopper kernel (`kernels/peak_probe.py`).
"""

from __future__ import annotations

import torch

MODES = ("dependent", "independent", "exp2")


def peak_probe_ref(x: torch.Tensor, k: int, mode: str = "dependent") -> torch.Tensor:
    """The chain as a loop of torch ops, in float32."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    x = x.float()
    if mode == "independent":
        accs = [x * (1.0 + 0.125 * i) for i in range(4)]
        for _ in range(k // 4):
            accs = [a * x + (0.25 + 0.125 * j) for j, a in enumerate(accs)]
        return accs[0] + accs[1] + accs[2] + accs[3]
    acc = x
    for _ in range(k):
        acc = acc * x + 0.5 if mode == "dependent" else torch.exp2(acc * x) * 0.5
    return acc


def peak_probe(x: torch.Tensor, k: int, mode: str = "dependent") -> torch.Tensor:
    """CPU tensors -> `peak_probe_ref`; CUDA tensors -> the kernel."""
    if x.device.type == "cpu":
        return peak_probe_ref(x, k, mode)
    if x.device.type == "cuda":
        from mamba_asr_torch.kernels import peak_probe as kernel

        return kernel.peak_probe(x, k, mode)
    raise ValueError(f"no peak probe for device {x.device}")
