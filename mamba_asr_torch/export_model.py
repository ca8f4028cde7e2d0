"""Export a trained model as a torch.export inference bundle (the port's
counterpart of scripts/export_model.py).

    python -m mamba_asr_torch.export_model <hparams.yaml> --out <dir> \\
        (--ckpt_dir <exp>/save | --torch_ckpt model.ckpt
         [--torch_normalizer normalizer.ckpt])
        [--batches 1,8] [--seconds 10,20,30] [--s2s [--beam N]]
        [--streaming [--slots 8] [--chunk_frames 64]]
        [--device cpu] [--key value ...]

CTC (default): one program per (batch, seconds) bucket, the Recognizer's
forward. --s2s: the joint CTC/attention beam search with the decode
stanza's settings, fusing the LM of `decode.lm_path` when it is set.
--streaming: the slot engine (serving/engine.py) at --slots and
--chunk_frames, for `python -m mamba_asr_torch.serve --bundle`; it needs a
causal config. See mamba_asr_torch/serving/export.py for the layout. A
worker then runs the bundle with no model code:

    from mamba_asr_torch.serving.export import ExportedASR
    asr = ExportedASR("<dir>")                  # on the card
    ctc_log_probs, enc_lengths = asr(wav, wav_lens)

The bundle runs on the device type it was exported on: the CUDA card
unless --device names another.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mamba_asr_torch.export_model",
        epilog="JAX's --platforms is --device here (one device type per bundle), and "
               "--allow_custom_calls has no counterpart: K1, K3 and K4 run inside the "
               "programs as registered torch.library custom ops (mamba_asr::*), not as "
               "custom calls.")
    p.add_argument("config")
    p.add_argument("--out", required=True, help="the bundle's directory")
    p.add_argument("--ckpt_dir", default="", help="experiment save dir (top-k averaged)")
    p.add_argument("--torch_ckpt", default="", help="reference model.ckpt")
    p.add_argument("--torch_normalizer", default="")
    p.add_argument("--batches", default="1,8", help="comma-separated batch sizes")
    p.add_argument("--seconds", default="10,20,30",
                   help="comma-separated most audio seconds per bucket")
    p.add_argument("--s2s", action="store_true",
                   help="export the joint CTC/attention beam search (S2S configs; with "
                        "the fusion LM when decode.lm_path is set)")
    p.add_argument("--beam", type=int, default=0,
                   help="--s2s beam size (default: the config's test beam)")
    p.add_argument("--streaming", action="store_true",
                   help="export the slot-batched streaming engine (a causal config)")
    p.add_argument("--slots", type=int, default=8, help="--streaming: the tick's batch")
    p.add_argument("--chunk_frames", type=int, default=64,
                   help="--streaming: fbank frames per stream per tick")
    p.add_argument("--device", default=None,
                   help="torch device the bundle runs on (default: the CUDA card)")
    return p


def main(argv: Optional[List[str]] = None) -> dict:
    args, extra = parser().parse_known_args(sys.argv[1:] if argv is None else argv)
    if args.s2s and args.streaming:
        raise SystemExit("--s2s and --streaming export different surfaces: pick one")

    from mamba_asr_torch import cli
    from mamba_asr_torch.configs.loader import load_config, parse_overrides
    from mamba_asr_torch.serving import export
    from mamba_asr_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = load_config(args.config, parse_overrides(extra))
    model, normalizer = cli.restore_asr_state(
        cfg, ckpt_dir=args.ckpt_dir, torch_ckpt=args.torch_ckpt,
        torch_normalizer=args.torch_normalizer, device=device)
    sr = cfg.frontend.sample_rate
    buckets = [(int(b), int(float(s) * sr))
               for b in args.batches.split(",") for s in args.seconds.split(",")]
    t0 = time.perf_counter()
    if args.streaming:
        from mamba_asr_torch.serving.engine import StreamingServer

        engine = StreamingServer(model, cfg.frontend, normalizer, n_slots=args.slots,
                                 chunk_frames=args.chunk_frames)
        manifest = export.export_streaming_bundle(engine, args.out)
    elif args.s2s:
        if cfg.model.num_decoder_layers <= 0:
            raise SystemExit("--s2s needs a config with decoder layers")
        from mamba_asr_torch.decoding.s2s_beam import S2SBeamSearcher

        searcher = S2SBeamSearcher.from_decode(model, cfg.decode, cli.load_lm(cfg, device),
                                               args.beam or None)
        manifest = export.export_s2s_bundle(model, normalizer, cfg.frontend, searcher,
                                            args.out, buckets)
    else:
        manifest = export.export_ctc_bundle(model, normalizer, cfg.frontend, args.out,
                                            buckets)
    print(f"exported a {manifest['surface']} bundle ({len(manifest['buckets'])} buckets) "
          f"to {args.out} in {time.perf_counter() - t0:.2f} s", flush=True)
    return manifest


if __name__ == "__main__":
    main()
