"""Joint CTC/attention beam search over the Transformer, the Mamba or the
Conformer decoder, with optional LM shallow fusion (port of
mamba_asr_tpu/decoding/s2s_beam.py; SpeechBrain's
S2STransformerBeamSearcher with its ScorerBuilder).

Each step, for N = B * beam hypotheses:

    total  = log_softmax(seq_head(decoder step) / temperature)
             + lm_weight * log_softmax(LM step / temperature_lm)   (an LM)
             + ctc_weight * CTC prefix score        (ctc_weight > 0)
    scores = top beam of (score + total) over (beam * vocab) per utterance

- The LM term enters before the CTC candidates are picked (`s2s_beam.py:
  317-347`): CTC prefix scores (`ctc_prefix_scorer.py`) are kept for the
  top ctc_candidates - 1 tokens by the decoder's (+ LM's) score plus eos;
  a token whose CTC score is NEG_INF is banned.
- eos is banned before min_decode_ratio * T frames' worth of steps; a
  finished hypothesis extends only by eos at no cost. The search stops
  after min(max_steps_cap, max_decode_ratio * T + 1) steps, or earlier
  when every hypothesis has finished; unfinished ones count the full
  length. With length normalization the final score is divided by the
  length (eos included), and the best hypothesis of each utterance wins.
- The decoder's kind picks its way (JAX's `use_cache=None`,
  `s2s_beam.py:120-124`). The Transformer and Mamba decoders step
  through their decode cache, one position a step. The Conformer decoder
  has no cache, so each step re-scores the prefix (`s2s_beam.py:298-313`):
  `model.decode` of tokens[:, :s+1], position s through seq_head. JAX
  decodes the whole padded buffer; the decoder is causal, so position s
  reads nothing past it and the prefix alone gives the same logits.
- The Transformer decoder's and the LM's self-attention K/V are
  append-only buffers read through the ancestor table anc (S, N)
  (`models/attention.py:step_beam`, K4 on the card): row s is reset to
  the identity before step s, and after the selection the table's
  columns follow the chosen parents, one (S, N) int32 gather. The table
  exists whenever an LM is present or the decoder is the Transformer
  (`s2s_beam.py:128-132`). The cache length is s_max + 1 rounded up to
  64, as in the JAX package. The cross K/V are projected once per search;
  the LM's K/V (12 layers of (H, S, N, dh)) are allocated once per search.
  JAX's A/B switches, `use_cache=False` for the cached decoders and
  `beam_gather=False` (heads-major caches gathered after each selection),
  are not ported (ROADMAP, departures).
- The Mamba decoder's cache is a (conv, ssm) state per Mamba block and
  hypothesis: every layer's cross-Mamba is primed once per search from
  the memory repeated to N rows (K1's h_last form on the card), and
  after each step's selection every state is gathered by `reorder`, one
  `index_select` each (`s2s_beam.py:411-417`).
- `stable_topk` ranks equal values lower index first, as jax.lax.top_k
  does; ties are real (a dead beam's candidates all sum to exactly
  -1e30 at step 0, finished rows give planes of NEG_INF).
- bf16 models: the decode weights (embedding and decoder) are cast to
  bf16 once, when the searcher is built, in a copy of those two
  submodules; the encoder and the float32 heads stay shared with the
  model (the JAX package's cast at `s2s_beam.py:143-173`, there once per
  search). Every floating parameter of the two is cast, the Mamba
  decoder's A_log, D, dt bias and conv taps too, as `cast_tree` does.
  A bf16 LM's weights are cast likewise, all but `output_proj`
  (`models/lm.py:cast_lm_weights`; an LM already cast is used as given).
  Build a new searcher after changing the decoder's or the LM's weights.

The JAX search is one `lax.while_loop` on the device. Here the loop runs
on the host: each step's kernels are launched from Python, and the early
exit reads `finished.all()` once per step (one device-to-host sync per
step).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from mamba_asr_torch.decoding.ctc_prefix_scorer import CTCPrefixScorer
from mamba_asr_torch.models.layers import cast_copy
from mamba_asr_torch.models.lm import cast_lm_weights

NEG_INF = -1e30
ANC_CHUNK = 64  # cache length granularity (ops/pallas/beam_attention.py J_CHUNK)


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last axis and their indices, equal
    values lower index first (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def cast_decode_weights(model):
    """`model` with its decode weights (token embedding and decoder) in its
    compute dtype; the model itself if that is float32. Only those two
    submodules are copied: the encoder, the front end and the float32
    heads stay the model's own."""
    if model.cfg.dtype == torch.float32:
        return model
    out = copy.copy(model)
    out._modules = dict(model._modules)
    out._modules["1"] = cast_copy(model._modules["1"], ("custom_tgt_module", "decoder"),
                                   model.cfg.dtype)
    return out


@dataclasses.dataclass
class S2SBeamSearcher:
    """Beam search over an ASRModel's Transformer, Mamba or Conformer
    decoder, with an optional TransformerLM fused at lm_weight."""

    model: object               # models.asr.ASRModel with a decoder
    beam_size: int = 10
    bos_id: int = 1
    eos_id: int = 2
    blank_id: int = 0
    min_decode_ratio: float = 0.0
    max_decode_ratio: float = 1.0
    ctc_weight: float = 0.0
    lm_weight: float = 0.0
    temperature: float = 1.0
    temperature_lm: float = 1.0
    length_normalization: bool = True
    lm_model: Optional[object] = None  # models.lm.TransformerLM, on the model's device
    max_steps_cap: int = 256
    ctc_candidates: int = 0     # 0: CTC-score the full vocabulary

    def __post_init__(self):
        cfg = self.model.cfg
        if cfg.num_decoder_layers <= 0:
            raise ValueError("the S2S search needs a model with a decoder")
        self.decode_model = cast_decode_weights(self.model)
        self.decode_lm = None if self.lm_model is None else cast_lm_weights(self.lm_model)
        self.last_steps = 0  # steps the last search ran

    @torch.no_grad()
    def __call__(self, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                 ctc_log_probs: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """enc_out (B, T, D), enc_lens (B,), ctc_log_probs (B, T, V) ->
        (tokens (B, S) without bos, lengths (B,) counting eos, scores (B,))
        of each utterance's best hypothesis."""
        model = self.decode_model
        b, t_enc = enc_out.shape[:2]
        k, eos = self.beam_size, self.eos_id
        n = b * k
        dev = enc_out.device
        s_max = min(self.max_steps_cap, int(self.max_decode_ratio * t_enc) + 1)
        min_steps = int(self.min_decode_ratio * t_enc)
        mamba, lm, prefix = model.mamba_decoder, self.decode_lm, model.conformer_decoder
        transformer = not (mamba or prefix)
        enc_lens = enc_lens.to(dev)

        scorer = state = None
        if self.ctc_weight > 0.0 and ctc_log_probs is not None:
            scorer = CTCPrefixScorer(ctc_log_probs, enc_lens, k, self.blank_id, eos)
            state = scorer.init_state()
        rows = torch.arange(n, dtype=torch.int32, device=dev)
        anc = lm_cache = cache = None
        s_cache = -(-(s_max + 1) // ANC_CHUNK) * ANC_CHUNK
        if lm is not None or transformer:
            anc = rows.repeat(s_cache, 1)  # (S, N): anc[j, n] = row holding position j
        if mamba:
            cache = model.prime_decoder_cache(enc_out.repeat_interleave(k, dim=0),
                                              model.init_decoder_cache(n))
        elif transformer:
            cache = model.prime_decoder_cache(
                enc_out, model.init_decoder_cache(n, s_cache), enc_lens)
        if lm is not None:
            lm_cache = lm.init_cache(n, s_cache, dev)
        tokens = torch.zeros(n, s_max + 1, dtype=torch.long, device=dev)
        tokens[:, 0] = self.bos_id
        scores = torch.full((b, k), NEG_INF, device=dev)
        scores[:, 0] = 0.0
        scores = scores.reshape(n)
        finished = torch.zeros(n, dtype=torch.bool, device=dev)
        lengths = torch.zeros(n, dtype=torch.long, device=dev)
        parent_base = torch.arange(b, device=dev)[:, None] * k
        v = model.cfg.vocab_size
        is_eos = torch.arange(v, device=dev) == eos
        eos_col = torch.full((n, 1), eos, dtype=torch.long, device=dev)

        s = 0
        while s < s_max and not bool(finished.all()):
            if anc is not None:
                anc[s] = rows
            if prefix:
                logits = model.seq_logits(model.decode(tokens[:, :s + 1], enc_out,
                                                       enc_lens)[:, s])
            else:
                logits, cache = model.decode_step(tokens[:, s], s, cache,
                                                  anc if transformer else None)
            total = torch.log_softmax(logits / self.temperature, dim=-1)
            if lm is not None:
                lm_logits = lm.step(tokens[:, s], s, lm_cache, anc)
                total = total + self.lm_weight * torch.log_softmax(
                    lm_logits / self.temperature_lm, dim=-1)
            aux = None
            if scorer is not None:
                cand = None
                if 0 < self.ctc_candidates < v:
                    cand = torch.cat(
                        [stable_topk(total, self.ctc_candidates - 1)[1], eos_col], dim=1)
                ctc_scores, aux = scorer.score(state, cand)
                total = torch.where(ctc_scores <= NEG_INF * 0.5, NEG_INF,
                                    total + self.ctc_weight * ctc_scores)
            if s < min_steps:
                total[:, eos] = NEG_INF
            total = torch.where(finished[:, None],
                                torch.where(is_eos, 0.0, NEG_INF), total)

            top_val, top_idx = stable_topk((scores[:, None] + total).reshape(b, k * v), k)
            reorder = (top_idx // v + parent_base).reshape(n)
            tok = (top_idx % v).reshape(n)
            scores = top_val.reshape(n)
            tokens = tokens[reorder]
            tokens[:, s + 1] = tok
            was_finished = finished[reorder]
            finished = was_finished | (tok == eos)
            lengths = torch.where(was_finished, lengths[reorder], s + 1)
            if scorer is not None:
                state = scorer.select(state, aux, tok, reorder)
            if mamba:
                cache = model.decoder.reorder_cache(cache, reorder)
            if anc is not None:
                anc = anc[:, reorder]
            s += 1
        self.last_steps = s

        lengths = torch.where(finished, lengths, s_max)
        final = scores
        if self.length_normalization:
            final = scores / lengths.clamp_min(1).float()
        best = final.reshape(b, k).argmax(dim=1)
        best_rows = torch.arange(b, device=dev) * k + best
        return tokens[best_rows, 1:], lengths[best_rows], final[best_rows]


def strip_special(tokens: np.ndarray, lengths: np.ndarray, eos_id: int = 2
                  ) -> List[List[int]]:
    """(B, S) padded hypotheses -> lists of ids up to (not including) eos."""
    out = []
    for i in range(tokens.shape[0]):
        seq = []
        for t in tokens[i, : int(lengths[i])]:
            if t == eos_id:
                break
            seq.append(int(t))
        out.append(seq)
    return out
