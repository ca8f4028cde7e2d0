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
  has no cache, so each step re-scores (`s2s_beam.py:298-313`):
  `model.decode` of the token buffer, position s through seq_head. JAX
  decodes the whole padded buffer, as an exported step does; the host
  loop passes the prefix tokens[:, :s+1]. The decoder is causal, so
  position s reads nothing past it and both give the same logits.
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
step). `__call__` is `init` (the state: a dict of tensors), `step` (one
beam step at a `StepPos`, the index on the host and on the device; the
caches and the table written in place, the replaced entries returned)
until s_max or every hypothesis finished, then `final`: the exported S2S bundle (serving/export.py) runs
the same three functions as programs, so the two cannot drift.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mamba_asr_torch.decoding.ctc_prefix_scorer import CTCPrefixScorer, CTCPrefixState
from mamba_asr_torch.models.layers import cast_copy
from mamba_asr_torch.models.lm import cast_lm_weights
from mamba_asr_torch.ops.beam_attention import StepPos

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

    @classmethod
    def from_decode(cls, model, decode, lm_model=None,
                    beam_size: Optional[int] = None) -> "S2SBeamSearcher":
        """A searcher per a decode stanza (configs/loader.py:DecodeConfig):
        beam `beam_size` (default s2s_test_beam_size), CTC weight
        ctc_weight_decode, ctc_candidates, temperature, length
        normalization and the decode ratios; lm_model fused at lm_weight /
        temperature_lm when given."""
        d = decode
        return cls(model, beam_size=beam_size or d.s2s_test_beam_size,
                   ctc_weight=d.ctc_weight_decode, ctc_candidates=d.ctc_candidates,
                   lm_weight=d.lm_weight if lm_model is not None else 0.0,
                   temperature=d.temperature, temperature_lm=d.temperature_lm,
                   length_normalization=d.length_normalization,
                   max_decode_ratio=d.max_decode_ratio, min_decode_ratio=d.min_decode_ratio,
                   lm_model=lm_model)

    @torch.no_grad()
    def __call__(self, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                 ctc_log_probs: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """enc_out (B, T, D), enc_lens (B,), ctc_log_probs (B, T, V) ->
        (tokens (B, S) without bos, lengths (B,) counting eos, scores (B,))
        of each utterance's best hypothesis."""
        state = self.init(enc_out, enc_lens, ctc_log_probs)
        s_max = state["tokens"].shape[1] - 1
        # Each step's device index is a view of this: no copy to the card.
        on_device = torch.arange(s_max + 1, device=enc_out.device)
        s = 0
        while s < s_max and not bool(state["finished"].all()):
            pos = StepPos(torch.tensor(s), on_device[s])
            state.update(self.step(state, pos, prefix=s + 1))
            s += 1
        self.last_steps = s
        return self.final(state)

    @torch.no_grad()
    def init(self, enc_out: torch.Tensor, enc_lens: torch.Tensor,
             ctc_log_probs: Optional[torch.Tensor] = None) -> Dict[str, object]:
        """A search's state before its first step: a dict of tensors (and
        lists and dicts of them) that `step` advances. tokens (N, s_max +
        1) with bos in column 0, scores, finished, lengths (N,); `const`,
        what every step reads: eos_ban (s_max, V) (eos at the steps before
        min_decode_ratio * T), done_row (V,) (a finished hypothesis' scores:
        0 for eos), parents (B, 1) (each utterance's first row), rows (N,),
        eos_col (N, 1); with the table, anc (S, N); the decoder's cache (`cache`), or, for the
        Conformer decoder, enc_out and enc_lens; the LM's K/V (`lm_cache`);
        with CTC, the scorer's tensors (`ctc`) and its state
        (`ctc_state`)."""
        model = self.decode_model
        b, t_enc = enc_out.shape[:2]
        k = self.beam_size
        n = b * k
        dev = enc_out.device
        s_max = min(self.max_steps_cap, int(self.max_decode_ratio * t_enc) + 1)
        s_cache = -(-(s_max + 1) // ANC_CHUNK) * ANC_CHUNK
        enc_lens = enc_lens.to(dev)
        mamba, lm = model.mamba_decoder, self.decode_lm
        transformer = not (mamba or model.conformer_decoder)

        state: Dict[str, object] = {}
        tokens = torch.zeros(n, s_max + 1, dtype=torch.long, device=dev)
        tokens[:, 0] = self.bos_id
        scores = torch.full((b, k), NEG_INF, device=dev)
        scores[:, 0] = 0.0
        is_eos = torch.arange(model.cfg.vocab_size, device=dev) == self.eos_id
        early = torch.arange(s_max, device=dev) < int(self.min_decode_ratio * t_enc)
        state.update(
            tokens=tokens, scores=scores.reshape(n),
            finished=torch.zeros(n, dtype=torch.bool, device=dev),
            lengths=torch.zeros(n, dtype=torch.long, device=dev),
            const={"eos_ban": early[:, None] & is_eos,
                   "done_row": torch.where(is_eos, 0.0, NEG_INF),
                   "parents": torch.arange(b, device=dev)[:, None] * k,
                   "rows": torch.arange(n, dtype=torch.int32, device=dev),
                   "eos_col": torch.full((n, 1), self.eos_id, dtype=torch.long, device=dev)})
        if self.ctc_weight > 0.0 and ctc_log_probs is not None:
            scorer = CTCPrefixScorer(ctc_log_probs, enc_lens, k, self.blank_id, self.eos_id)
            state["ctc"] = scorer.tensors()
            state["ctc_state"] = scorer.init_state()._asdict()
        if lm is not None or transformer:
            # (S, N): anc[j, n] = the row that holds position j of hypothesis n.
            state["anc"] = state["const"]["rows"].repeat(s_cache, 1)
        if mamba:
            state["cache"] = model.prime_decoder_cache(enc_out.repeat_interleave(k, dim=0),
                                                       model.init_decoder_cache(n))
        elif transformer:
            state["cache"] = model.prime_decoder_cache(
                enc_out, model.init_decoder_cache(n, s_cache), enc_lens)
        else:
            state["enc_out"], state["enc_lens"] = enc_out, enc_lens
        if lm is not None:
            state["lm_cache"] = lm.init_cache(n, s_cache, dev)
            # The position table, made here: a step that made it would copy
            # it to the card and wait there.
            lm.position_table(s_cache, dev)
        return state

    @torch.no_grad()
    def step(self, state: Dict[str, object], s: StepPos,
             prefix: Optional[int] = None) -> Dict[str, object]:
        """Beam step `s` (ops.beam_attention.StepPos) of a search's
        state: returns the entries it replaces (tokens, scores, finished,
        lengths; anc, ctc_state and the Mamba decoder's cache when
        present), for `state.update`. The ancestor table's row s and the
        K/V caches are written in place. prefix: the token columns the
        Conformer decoder re-scores, s + 1 from the host loop; None (an
        exported step, which has no host int) the whole buffer: the
        decoder is causal, so column s reads the same logits."""
        model, lm = self.decode_model, self.decode_lm
        tokens, const = state["tokens"], state["const"]
        n = tokens.shape[0]
        k, eos, v = self.beam_size, self.eos_id, model.cfg.vocab_size
        b = n // k
        s_dev = s.dev.reshape(1)
        mamba, conformer = model.mamba_decoder, model.conformer_decoder
        anc = state.get("anc")
        if anc is not None:
            anc.index_copy_(0, s_dev, const["rows"][None])
        token_s = tokens.index_select(1, s_dev)[:, 0]
        out: Dict[str, object] = {}
        if conformer:
            dec = model.decode(tokens if prefix is None else tokens[:, :prefix],
                               state["enc_out"], state["enc_lens"])
            logits = model.seq_logits(dec.index_select(1, s_dev)[:, 0])
        else:
            logits, cache = model.decode_step(token_s, s, state["cache"],
                                              None if mamba else anc)
        total = torch.log_softmax(logits / self.temperature, dim=-1)
        if lm is not None:
            lm_logits = lm.step(token_s, s, state["lm_cache"], anc)
            total = total + self.lm_weight * torch.log_softmax(
                lm_logits / self.temperature_lm, dim=-1)
        scorer = aux = None
        if "ctc" in state:
            scorer = CTCPrefixScorer.from_tensors(state["ctc"], k, self.blank_id, eos)
            cand = None
            if 0 < self.ctc_candidates < v:
                cand = torch.cat([stable_topk(total, self.ctc_candidates - 1)[1],
                                  const["eos_col"]], dim=1)
            ctc_scores, aux = scorer.score(CTCPrefixState(**state["ctc_state"]), cand)
            total = torch.where(ctc_scores <= NEG_INF * 0.5, NEG_INF,
                                total + self.ctc_weight * ctc_scores)
        total = torch.where(const["eos_ban"].index_select(0, s_dev), NEG_INF, total)
        finished = state["finished"]
        total = torch.where(finished[:, None], const["done_row"], total)

        top_val, top_idx = stable_topk((state["scores"][:, None] + total).reshape(b, k * v), k)
        reorder = (top_idx // v + const["parents"]).reshape(n)
        tok = (top_idx % v).reshape(n)
        tokens = tokens[reorder]
        length = s_dev + 1
        tokens.index_copy_(1, length, tok[:, None])
        was_finished = finished[reorder]
        out.update(tokens=tokens, scores=top_val.reshape(n),
                   finished=was_finished | (tok == eos),
                   lengths=torch.where(was_finished, state["lengths"][reorder], length))
        if scorer is not None:
            out["ctc_state"] = scorer.select(CTCPrefixState(**state["ctc_state"]), aux, tok,
                                             reorder)._asdict()
        if mamba:
            out["cache"] = model.decoder.reorder_cache(cache, reorder)
        if anc is not None:
            out["anc"] = anc[:, reorder]
        return out

    @torch.no_grad()
    def final(self, state: Dict[str, object]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Each utterance's best hypothesis of a state: (tokens (B, S)
        without bos, lengths (B,) counting eos, scores (B,)); unfinished
        hypotheses count the full s_max."""
        tokens, scores, finished = state["tokens"], state["scores"], state["finished"]
        n, dev = tokens.shape[0], tokens.device
        b = n // self.beam_size
        lengths = torch.where(finished, state["lengths"], tokens.shape[1] - 1)
        final = scores
        if self.length_normalization:
            final = scores / lengths.clamp_min(1).float()
        best = final.reshape(b, self.beam_size).argmax(dim=1)
        best_rows = torch.arange(b, device=dev) * self.beam_size + best
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
