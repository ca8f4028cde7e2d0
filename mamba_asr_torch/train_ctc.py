"""CTC training entry point of the port (the counterpart of train_ctc.py).

    python -m mamba_asr_torch.train_ctc hparams/CTC/conmamba_small.yaml \\
        --data.data_folder /path/to/LibriSpeech [--device cpu] [--key value ...]

Runs on the CUDA card; `--device cpu` runs the plain versions on the CPU.
`--distributed` trains with one process per rank (cli.py says how).
"""

from mamba_asr_torch.cli import run_training
from mamba_asr_torch.parallel.distributed import shutdown

if __name__ == "__main__":
    try:
        run_training()
    finally:
        shutdown()
