"""Streaming recognition server and client (the port's counterpart of
serve.py): many concurrent real-time streams on one card.

Server (owns the card):

    python -m mamba_asr_torch.serve <hparams.yaml> \\
        (--ckpt_dir results/.../save | --torch_ckpt model.ckpt
         [--torch_normalizer normalizer.ckpt]) [--tokenizer tok.json]
        [--host 127.0.0.1] [--port 7353] [--slots 8] [--chunk_frames 64]
        [--final none|ctc_beam|s2s] [--final_beam_size 8]
        [--endpoint_silence S] [--data_parallel N] [--device cpu]
        [--key value ...]

Client (numpy and sockets only, on any host; streams PCM over TCP and
prints `<path>\\t<transcript>` per file, with --timestamps also one
`start\\tend\\tconf\\tword` line per word):

    python -m mamba_asr_torch.serve --connect HOST:PORT a.wav b.flac \\
        [--realtime] [--client_chunk_ms 320] [--timestamps]

Serving an exported bundle (no model code; slots and chunk fixed at export
by `python -m mamba_asr_torch.export_model --streaming`):

    python -m mamba_asr_torch.serve --bundle <dir> [--tokenizer tok.json]
        [--host ...] [--port ...] [--endpoint_silence S] [--device cpu]

The server is `serving.engine.StreamingServer` behind
`serving.server.AsrTcpServer`: one fixed-shape tick advances every ready
stream. For a causal config the transcripts equal the offline greedy
decode. `--data_parallel N` spreads the slots over the cards cuda:0 ..
cuda:N-1, one model replica each (`--slots` must divide over them); with
fewer cards it refuses to start, and with `--device cpu` it builds N
replicas on the CPU. `--final ctc_beam` with `decode.lm_path` set rescores the CTC
n-best with that LM. The wire protocol is the JAX package's, so either
package's client talks to either server. With --bundle it is
`serving.export.ExportedStreamingServer` instead. The server runs on the
CUDA card unless --device names another, and refuses to start without
one.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

def run_client(addr: str, paths, realtime: bool, chunk_ms: float,
               timestamps: bool = False) -> None:
    from mamba_asr_torch.data.audio import read_audio
    from mamba_asr_torch.serving.server import StreamingClient

    host, port = addr.rsplit(":", 1)
    client = StreamingClient(host, int(port))
    try:
        for path in paths:
            wav, sr = read_audio(path)
            sid = client.start()
            step = max(1, int(sr * chunk_ms / 1000))
            for off in range(0, len(wav), step):
                client.send(sid, wav[off:off + step])
                if realtime:
                    time.sleep(chunk_ms / 1000)
            words = None
            if timestamps:
                ids, text, words = client.end(sid, timestamps=True)
            else:
                ids, text = client.end(sid)
            print(f"{path}\t{text if text is not None else ' '.join(map(str, ids))}",
                  flush=True)
            for w, s, e, conf in words or []:
                print(f"{s:.3f}\t{e:.3f}\t{conf:.3f}\t{w}", flush=True)
    finally:
        client.close()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m mamba_asr_torch.serve")
    p.add_argument("config", nargs="?", default="",
                   help="hparams yaml (server mode) or first audio file (client mode)")
    p.add_argument("--connect", default="", help="HOST:PORT: run as a client")
    p.add_argument("--realtime", action="store_true",
                   help="client: pace the audio at real time")
    p.add_argument("--client_chunk_ms", type=float, default=320.0)
    p.add_argument("--timestamps", action="store_true",
                   help="client: also print word times (a server with a final pass)")
    p.add_argument("--ckpt_dir", default="", help="experiment save dir (top-k averaged)")
    p.add_argument("--bundle", default="",
                   help="serve a streaming bundle (python -m mamba_asr_torch.export_model "
                        "--streaming) with no model code; its slots and chunk are fixed "
                        "at export")
    p.add_argument("--torch_ckpt", default="", help="reference model.ckpt")
    p.add_argument("--torch_normalizer", default="")
    p.add_argument("--tokenizer", default="")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7353)
    p.add_argument("--slots", type=int, default=8, help="concurrent streams (the tick's batch)")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="spread the slots over N cards, cuda:0 .. cuda:N-1 (N CPU replicas "
                        "with --device cpu; 0 or 1: one device); not with --bundle")
    p.add_argument("--chunk_frames", type=int, default=64,
                   help="fbank frames per stream per tick (64 = 640 ms)")
    p.add_argument("--final", choices=["none", "ctc_beam", "s2s"], default="none",
                   help="a whole-utterance pass at each stream's end")
    p.add_argument("--final_beam_size", type=int, default=8)
    p.add_argument("--endpoint_silence", type=float, default=0.0,
                   help="send an endpoint event after this many s of trailing CTC "
                        "silence (0: off)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return p


def build_server(args: argparse.Namespace, extra: List[str]):
    """The AsrTcpServer of server mode, not yet started."""
    if args.bundle:
        if args.data_parallel > 1:  # as JAX's bundle path, one device
            raise SystemExit("--data_parallel: a bundle serves on one device")
        # Serving from a bundle: Python and numpy over its four programs.
        from mamba_asr_torch.data.tokenizer import load_tokenizer
        from mamba_asr_torch.serving.export import ExportedStreamingServer
        from mamba_asr_torch.serving.server import AsrTcpServer

        engine = ExportedStreamingServer(args.bundle, args.device)
        tokenizer = load_tokenizer(args.tokenizer) if args.tokenizer else None
        return AsrTcpServer(engine, tokenizer=tokenizer, host=args.host, port=args.port,
                            endpoint_silence_s=args.endpoint_silence)
    if not args.config:
        raise SystemExit("server mode needs an hparams yaml (or --connect for client mode)")

    from mamba_asr_torch.cli import load_lm, restore_asr_state
    from mamba_asr_torch.configs.loader import load_config, parse_overrides
    from mamba_asr_torch.data.tokenizer import load_tokenizer
    from mamba_asr_torch.serving.engine import StreamingServer
    from mamba_asr_torch.serving.server import AsrTcpServer
    from mamba_asr_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    devices = serving_devices(device, args.data_parallel)
    cfg = load_config(args.config, parse_overrides(extra))
    tokenizer = load_tokenizer(
        args.tokenizer or f"{cfg.output_folder}/tokenizer_{cfg.data.tokenizer_type}.json")
    model, normalizer = restore_asr_state(cfg, ckpt_dir=args.ckpt_dir,
                                          torch_ckpt=args.torch_ckpt,
                                          torch_normalizer=args.torch_normalizer,
                                          device=device)
    if not cfg.model.causal:
        print("warning: non-causal config — streamed transcripts are chunk-approximate, "
              "not offline-exact (use causal: true for the exactness contract)",
              file=sys.stderr)
    lm = None
    if args.final == "ctc_beam" and cfg.decode.lm_path:
        lm = load_lm(cfg, device)  # the CTC n-best rescored with the decode-time LM
    engine = StreamingServer(
        model, cfg.frontend, normalizer, n_slots=args.slots, chunk_frames=args.chunk_frames,
        final_decode=None if args.final == "none" else args.final,
        beam_size=args.final_beam_size, lm_model=lm, devices=devices,
        decode_opts=({"lm_weight": cfg.decode.lm_weight,
                      "temperature_lm": cfg.decode.temperature_lm} if lm is not None else None))
    return AsrTcpServer(engine, tokenizer=tokenizer, host=args.host, port=args.port,
                        endpoint_silence_s=args.endpoint_silence)


def serving_devices(device, n: int):
    """The devices of `--data_parallel n` for the resolved `device`: the
    cards cuda:0 .. cuda:n-1 (refused when fewer are present: no fallback),
    or n replicas on the CPU; None for one device (n <= 1)."""
    import torch

    if n <= 1:
        return None
    if device.type == "cpu":
        return [device] * n
    have = torch.cuda.device_count()
    if have < n:
        raise SystemExit(f"--data_parallel {n}: this machine has {have} CUDA card(s), "
                         f"fewer than {n}")
    return [torch.device("cuda", i) for i in range(n)]


def main(argv: Optional[List[str]] = None) -> None:
    args, extra = parser().parse_known_args(sys.argv[1:] if argv is None else argv)
    if args.connect:
        # Client mode: every remaining positional is an audio file.
        paths = ([args.config] if args.config else []) + [
            a for a in extra if not a.startswith("-")]
        if not paths:
            raise SystemExit("client mode needs audio files")
        run_client(args.connect, paths, args.realtime, args.client_chunk_ms,
                   timestamps=args.timestamps)
        return
    server = build_server(args, extra)
    server.start()
    print(f"serving {server.engine.n_slots} slots on {server.host}:{server.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
