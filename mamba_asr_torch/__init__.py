"""mamba_asr_torch: the PyTorch / CUDA (H100) port of mamba_asr_tpu.

The JAX package `mamba_asr_tpu` is the reference; this package mirrors
its module layout and names. It imports neither JAX nor that package.
Entry points run on the CUDA card unless given `device="cpu"`. Every TPU
kernel on a ported path is a hand-written Hopper kernel under `csrc/`,
bound in `kernels/`, with its plain PyTorch version beside it in `ops/`.

Ported so far: offline ConMamba CTC recognition
(`serving.recognizer.Recognizer`), the CTC training step
(`training.trainer.Trainer`), and S2S recognition with the joint
CTC/attention beam search over the Transformer decoder
(`Recognizer(..., search="s2s")`, `decoding.s2s_beam`), and the
scan-attribution tools (`tools.scan_variants`, `tools.peak_probe`).
Later slices: the recipes, the other encoders and the LM, recognition's
entry points and streaming, serving (`serving.engine`,
`serving.server`, `python -m mamba_asr_torch.serve`), and multi-process
training with sequence parallelism (`parallel`, `--distributed`).
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # Imported on first use, so that the package's numpy-only modules (the
    # serving client, serve.py's client mode) import without PyTorch.
    if name == "resolve_device":
        from mamba_asr_torch.utils.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
