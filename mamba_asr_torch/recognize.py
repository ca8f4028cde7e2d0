"""Transcribe audio files with a trained checkpoint (the port's
counterpart of recognize.py).

    python -m mamba_asr_torch.recognize <hparams.yaml> audio1.wav audio2.flac \\
        (--ckpt_dir results/.../save | --torch_ckpt model.ckpt
         [--torch_normalizer normalizer.ckpt]) [--tokenizer tok.json]
        [--beam N] [--streaming [--chunk_frames 64]] [--s2s] [--timestamps]
        [--batch B] [--device cpu] [--key value ...]

Decodes with greedy CTC (--beam 0), the CTC prefix beam search (--beam
N), chunked streaming greedy CTC (--streaming: models/streaming.py), or
the joint CTC/attention beam search of an S2S config (--s2s; beam N, or
the decode stanza's s2s_test_beam_size, with the LM of decode.lm_path
fused when set). Prints `<path>\\t<transcript>` per file, in the order
given; with --timestamps (the offline CTC paths) also one
`start\\tend\\tconf\\tword` line per word of the greedy alignment. The
offline CTC path decodes duration-sorted groups of --batch files. Runs
on the CUDA card unless --device names another.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m mamba_asr_torch.recognize")
    p.add_argument("config")
    p.add_argument("audio", nargs="+")
    p.add_argument("--ckpt_dir", default="", help="experiment save dir (top-k averaged)")
    p.add_argument("--torch_ckpt", default="", help="reference model.ckpt instead of --ckpt_dir")
    p.add_argument("--torch_normalizer", default="",
                   help="reference normalizer.ckpt (glob_mean/glob_std) beside --torch_ckpt")
    p.add_argument("--tokenizer", default="")
    p.add_argument("--beam", type=int, default=0)
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--s2s", action="store_true",
                   help="joint CTC/attention beam search (an S2S config)")
    p.add_argument("--chunk_frames", type=int, default=64)
    p.add_argument("--timestamps", action="store_true",
                   help="also print greedy-aligned word times (offline CTC paths)")
    p.add_argument("--batch", type=int, default=1,
                   help="offline CTC paths: files per duration-sorted batch")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args, extra = parser().parse_known_args(sys.argv[1:] if argv is None else argv)

    from mamba_asr_torch.cli import restore_asr_state
    from mamba_asr_torch.configs.loader import load_config, parse_overrides
    from mamba_asr_torch.data.audio import read_audio
    from mamba_asr_torch.data.tokenizer import load_tokenizer
    from mamba_asr_torch.decoding.timestamps import encoder_frame_seconds, word_timestamps
    from mamba_asr_torch.models.streaming import StreamingASRSession
    from mamba_asr_torch.serving.recognizer import Recognizer
    from mamba_asr_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = load_config(args.config, parse_overrides(extra))
    tokenizer = load_tokenizer(
        args.tokenizer or f"{cfg.output_folder}/tokenizer_{cfg.data.tokenizer_type}.json")
    if args.s2s and cfg.model.num_decoder_layers <= 0:
        raise SystemExit("--s2s needs a config with decoder layers")
    model, normalizer = restore_asr_state(cfg, ckpt_dir=args.ckpt_dir,
                                          torch_ckpt=args.torch_ckpt,
                                          torch_normalizer=args.torch_normalizer,
                                          device=device)
    wavs = [read_audio(path)[0] for path in args.audio]

    if args.streaming:
        step = args.chunk_frames * cfg.frontend.hop
        for path, wav in zip(args.audio, wavs):
            sess = StreamingASRSession(model, cfg.frontend, normalizer, args.chunk_frames)
            ids = []
            for off in range(0, len(wav), step):
                ids += sess.feed(wav[None, off:off + step])[0]
            # The stream's end: the streamed transcript equals the offline
            # greedy decode of the canonically padded features (causal).
            ids += sess.finish()[0]
            print(f"{path}\t{tokenizer.decode(ids)}")
        return

    d = cfg.decode
    if args.s2s:
        rec = Recognizer.from_model(
            model, normalizer, cfg.frontend, batch=1, search="s2s",
            decode=dataclasses.replace(d, s2s_test_beam_size=args.beam or d.s2s_test_beam_size))
        for path, ids in zip(args.audio, rec.transcribe(wavs)):
            print(f"{path}\t{tokenizer.decode(ids)}")
        return

    rec = Recognizer.from_model(
        model, normalizer, cfg.frontend, batch=args.batch,
        search="beam" if args.beam > 0 else "ctc",
        decode=dataclasses.replace(d, test_beam_size=args.beam) if args.beam > 0 else d)
    frame_s = encoder_frame_seconds(cfg.frontend, cfg.model)
    for path, res in zip(args.audio, rec.transcribe(wavs, times=args.timestamps)):
        ids, align = res if args.timestamps else (res, None)
        print(f"{path}\t{tokenizer.decode(ids)}")
        if align is not None:
            toks, ons, offs, confs = align
            for word, start, end, conf in word_timestamps(toks, ons, offs, tokenizer, frame_s,
                                                          confs=confs):
                print(f"{start:.3f}\t{end:.3f}\t{conf:.3f}\t{word}")


if __name__ == "__main__":
    main()
