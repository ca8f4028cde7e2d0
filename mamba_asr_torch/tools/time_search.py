"""Wall time and host syncs of the live S2S beam search, with and without
the LM, on the card.

    python -m mamba_asr_torch.tools.time_search <hparams.yaml> [--batch 8]
        [--seconds 30] [--reps 3] [--seed 0] [--out FILE] [--key value ...]

Builds the YAML's model with seeded weights (`models.asr.init_params_`)
and its decode stanza's TransformerLM with seeded weights
(`models.lm.init_params_`), a Recognizer with `search="s2s"` over each
(the LM fused at the stanza's lm_weight, or no LM), and one encoder pass
over a batch of N(0, 0.1) noise rows of 0.7 to 1.0 x `seconds` (the
longest full). Then, for each searcher, on the same encoder output:

- wall_ms: the median of `reps` searches after one warm-up (host clock,
  the card synchronized before and after), and each search's time;
- steps (the searcher's last_steps) and the K3 and K4 launches a search
  makes (the wrappers' counts);
- syncs: the host's waits on the card in one search, counted as the
  warnings of `torch.cuda.set_sync_debug_mode("warn")` (a copy to or
  from pageable memory, `.item()`, `bool()` of a card tensor);
- tokens_digest: a digest of the best hypotheses' tokens and lengths, so
  two versions of the searcher can be held equal on the same inputs.

It uses only the Recognizer and searcher API that every version of the
port since the S2S search has, so it can time an older checkout of the
package beside this one: run this file with that checkout first on
PYTHONPATH. One JSON line per searcher, on the card only.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import statistics
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

def noise_batch(batch: int, seconds: float, seed: int):
    """(B, T) float32 rows of N(0, 0.1) noise zero-padded past lengths
    drawn in 0.7 .. 1.0 x seconds, the first full; lengths (B,) int32."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    lens = np.sort(rng.integers(int(0.7 * n), n, batch)).astype(np.int32)[::-1].copy()
    lens[0] = n
    wav = np.zeros((batch, n), np.float32)
    for i, m in enumerate(lens):
        wav[i, :m] = rng.normal(0.0, 0.1, m)
    return torch.from_numpy(wav), torch.from_numpy(lens)


def launch_counts():
    from mamba_asr_torch.kernels import beam_attention, ctc_dp

    return {"K3": ctc_dp.LAUNCHES, "K4": beam_attention.LAUNCHES}


def syncs_of(fn) -> int:
    """The host's waits on the card during fn(): sync debug mode's warnings."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def time_searcher(name: str, rec, out, reps: int) -> dict:
    searcher = rec.searcher

    def search():
        return searcher(out["enc_out"], out["enc_lengths"], out["ctc_log_probs"])

    toks, lens, _ = search()  # warm-up
    before = launch_counts()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, lens, _ = search()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    after = launch_counts()
    digest = hashlib.sha256(toks.cpu().numpy().tobytes() + lens.cpu().numpy().tobytes())
    return {
        "searcher": name, "wall_ms": statistics.median(walls), "walls_ms": walls,
        "steps": searcher.last_steps,
        "launches_per_search": {k: (after[k] - before[k]) // reps for k in after},
        "syncs": syncs_of(search), "tokens_digest": digest.hexdigest()[:16],
        "best_lengths": lens.cpu().tolist(),
    }


def main(argv=None) -> int:
    from mamba_asr_torch.configs.loader import load_config, parse_overrides
    from mamba_asr_torch.models.asr import ASRModel, init_params_
    from mamba_asr_torch.models.lm import TransformerLM
    from mamba_asr_torch.models.lm import init_params_ as init_lm_
    from mamba_asr_torch.serving.recognizer import Recognizer
    from mamba_asr_torch.training.normalizer import NormalizerState

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config", help="an S2S YAML, e.g. hparams/S2S/conmamba_small.yaml")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="", help="also append the JSON lines to this file")
    args, extra = p.parse_known_args(argv)
    if not torch.cuda.is_available():
        print("time_search: no CUDA device is available", file=sys.stderr)
        return 2
    exp = load_config(args.config, parse_overrides(extra))
    decode = exp.decode
    model = init_params_(ASRModel(exp.model), torch.Generator().manual_seed(args.seed))
    model = model.to("cuda").eval()
    zeros = np.zeros((exp.frontend.n_mels,), np.float32)
    norm = NormalizerState.from_arrays(0.0, zeros, zeros, device="cuda")
    lm = TransformerLM(exp.model.vocab_size, decode.lm_d_model, decode.lm_nhead,
                       decode.lm_layers, decode.lm_d_ffn)
    lm = init_lm_(lm, torch.Generator().manual_seed(args.seed + 1))
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        lm_path = os.path.join(tmp, "lm.pt")
        torch.save(lm.state_dict(), lm_path)
        wav, lens = noise_batch(args.batch, args.seconds, args.seed)
        out = None
        for name, path in (("s2s", ""), ("s2s_lm", lm_path)):
            dec = dataclasses.replace(decode, lm_path=path)
            rec = Recognizer.from_model(model, norm, exp.frontend, batch=args.batch,
                                        decode=dec, search="s2s")
            with torch.no_grad():
                if out is None:
                    out = rec.eval_step(wav, lens)
                row = time_searcher(name, rec, out, args.reps)
            row.update(config=args.config, batch=args.batch, seconds=args.seconds,
                       card=torch.cuda.get_device_name(0), torch=torch.__version__)
            lines.append(json.dumps(row))
            print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
