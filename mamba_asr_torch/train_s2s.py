"""Joint CTC/attention (S2S) training entry point of the port (the
counterpart of train_s2s.py).

    python -m mamba_asr_torch.train_s2s hparams/S2S/conmamba_small.yaml \
        --data.data_folder /path/to/LibriSpeech [--device cpu] [--key value ...]

Runs on the CUDA card; `--device cpu` runs the plain versions on the CPU.
"""

from mamba_asr_torch.cli import run_training

if __name__ == "__main__":
    run_training()
