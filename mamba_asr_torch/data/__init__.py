"""The recipes' data pipeline: audio I/O, LibriSpeech manifests,
tokenizers, bucketed loading, speed perturbation and SpecAugment."""
