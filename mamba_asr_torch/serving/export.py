"""Exported inference bundles (port of mamba_asr_tpu/serving/export.py):
the port's three deployment surfaces saved by `torch.export`, which a
worker loads and runs with no model code.

- CTC (`export_ctc_bundle`): (wav, wav_lens) -> (ctc_log_probs,
  enc_lengths), the Recognizer's forward, one program per (batch,
  samples) bucket.
- S2S (`export_s2s_bundle`): waveform -> the joint CTC/attention beam
  search, LM fusion included -> (tokens (B, S) without bos/eos framing,
  lengths (B,), scores (B,)). The search loop runs on the host, as the
  port's live search does, so each bucket has three programs over the
  searcher's own `init`, `step` and `final` (decoding/s2s_beam.py):
  init (waveform -> encoder, CTC log-probs, the scorer's tensors and
  state, the primed caches), step (one beam step: the state and the step
  index s as two 0-d int64 tensors, one on the CPU for K4's launch and
  one on the device for the writes, in; the entries it replaces out, the
  K/V caches and the ancestor table's row written in place) and final
  (the best hypothesis of each utterance). `ExportedASR` runs `while s <
  s_max and not finished.all()` over the step, as the live searcher does.
- Streaming (`export_streaming_bundle`): the slot engine's static-shape
  device functions over its state as a flat list of leaves: tick
  (serving/engine.py:_tick_fn), bootstrap, flush and flush_fresh (JAX's
  `_streaming_fns`, `export.py:263-429`); `ExportedStreamingServer` is
  the live engine's host side (serving/slots.py) over them, with the
  state on the device.

Design (JAX's, `export.py:12-31`, in torch terms):
- Weights are INPUTS of every program, never constants: each program
  takes the flat list of its module's parameters and buffers
  (`torch.func.functional_call`), written once in `params.pt` (a
  `weights_only` state dict; an LM's in `lm_params.pt`). A `.pt2` holds
  the graph and small constants only: the frozen normaliser's 2 x n_mels
  floats (baked in, as JAX's are) and the fbank's DFT and mel tables.
- K1, K3 and K4 run inside the programs as the `mamba_asr::*` custom ops
  (kernels/ops.py): their CUDA implementations on a card, their plain
  versions on the CPU. Loading imports `mamba_asr_torch.kernels.ops`
  (which registers them) and nothing of `mamba_asr_torch.models`.
- A bundle runs on the device type it was exported on (manifest
  `platforms`): the loaders refuse another, and a JAX bundle (flax
  msgpack params with StableHLO programs), with ValueError. The programs
  run through `ExportedProgram.module()`, under no_grad.

Bundle layout (a directory):
    manifest.json          JAX's keys: format, surface, buckets,
                           platforms (the torch device type), sample_rate,
                           n_mels, vocab_size, downsample (+ has_lm, bos_id,
                           eos_id for S2S; the engine's dims for streaming)
    params.pt              the weights, once (lm_params.pt: the LM's)
    fn_b{B}_t{T}.pt2       CTC: one program per bucket
    fn_b{B}_t{T}_{init,step,final}.pt2   S2S: three per bucket
    stream_{tick,bootstrap,flush,flush_fresh}.pt2, state_init.pt
                           streaming: four programs, the slots' initial
                           state leaves
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mamba_asr_torch.kernels import ops  # noqa: F401 (registers mamba_asr::*)
from mamba_asr_torch.serving.slots import SlotEngine

FORMAT_VERSION = 1
MANIFEST = "manifest.json"
PARAMS_FILE = "params.pt"
LM_PARAMS_FILE = "lm_params.pt"
STATE_FILE = "state_init.pt"
STREAM_PROGRAMS = ("tick", "bootstrap", "flush", "flush_fresh")


def _fn_file(batch: int, samples: int, part: str = "") -> str:
    return f"fn_b{batch}_t{samples}{'_' + part if part else ''}.pt2"


# -- export ------------------------------------------------------------------


def named_tensors(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of `module` by name (non-persistent
    buffers too): what a program takes as its weights."""
    out = dict(module.named_parameters())
    out.update(module.named_buffers())
    return {k: v.detach() for k, v in out.items()}


class _Program(torch.nn.Module):
    """fn(*args) over `modules`, whose tensors arrive as one flat list per
    module ahead of args. The modules are held outside the module tree,
    so `torch.export` lifts none of their tensors into the program."""

    def __init__(self, fn, modules: Sequence[torch.nn.Module]):
        super().__init__()
        self.fn = fn
        holder = torch.nn.Module()
        for i, m in enumerate(modules):
            holder.add_module(str(i), m)
        holder.forward = fn
        self.__dict__["holder"] = holder
        self.names = [list(named_tensors(m)) for m in modules]

    def forward(self, *args):
        n = len(self.names)
        flat = {f"{i}.{name}": t for i, (names, weights) in enumerate(zip(self.names, args[:n]))
                for name, t in zip(names, weights)}
        return torch.func.functional_call(self.holder, flat, tuple(args[n:]))


def _lean(graph) -> None:
    """Drop what the eager code does not run: export's dtype assertions
    (`aten._assert_tensor_metadata`, one per `.to`) and the `.to(dtype)`
    casts to a tensor's own dtype, which return the tensor itself. Each
    node is a host dispatch per call of the program (PERF.md §6)."""
    assert_meta = torch.ops.aten._assert_tensor_metadata.default
    to_dtype = torch.ops.aten.to.dtype
    for node in list(graph.nodes):
        if node.target is assert_meta:
            graph.erase_node(node)
        elif (node.target is to_dtype and len(node.args) == 2 and not node.kwargs
              and all(user.op != "output" for user in node.users)):  # outputs keep names
            val = getattr(node.args[0], "meta", {}).get("val")
            if isinstance(val, torch.Tensor) and val.dtype == node.args[1]:
                node.replace_all_uses_with(node.args[0])
                graph.erase_node(node)
    graph.lint()


def _export(fn, modules: Sequence[torch.nn.Module], args: tuple, path: str):
    """Export fn over the modules' weights and args (example inputs) to
    `path`, without its assertions and no-op casts (`_lean`); returns the
    ExportedProgram."""
    weights = [list(named_tensors(m).values()) for m in modules]
    with torch.no_grad():
        program = torch.export.export(_Program(fn, modules), (*weights, *args), strict=False)
    _lean(program.graph_module.graph)
    program.graph_module.recompile()
    program.example_inputs = None  # else the archive keeps them: the weights among them
    torch.export.save(program, path)
    return program


def _manifest(model, frontend, buckets, device, surface: str) -> dict:
    return {
        "format": FORMAT_VERSION,
        "surface": surface,
        "buckets": buckets,
        "platforms": [torch.device(device).type],
        "sample_rate": int(frontend.sample_rate),
        "n_mels": int(frontend.n_mels),
        "vocab_size": int(model.cfg.vocab_size),
        "downsample": int(model.cfg.downsample),
    }


def _write(out_dir: str, manifest: dict, params: Dict[str, torch.Tensor],
           lm_params: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    torch.save(params, os.path.join(out_dir, PARAMS_FILE))
    if lm_params is not None:
        torch.save(lm_params, os.path.join(out_dir, LM_PARAMS_FILE))
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _normalizer(normalizer, n_mels: int, device):
    from mamba_asr_torch.training.normalizer import init_normalizer

    return init_normalizer(n_mels, device) if normalizer is None else normalizer


def _example_wav(batch: int, samples: int, device):
    return (torch.zeros(batch, samples, device=device),
            torch.ones(batch, dtype=torch.int32, device=device))


def export_ctc_bundle(model, normalizer, frontend, out_dir: str,
                      buckets: Sequence[Tuple[int, int]]) -> dict:
    """Save `(wav (B, T) float32, wav_lens (B,) int32) -> (ctc_log_probs,
    enc_lengths)` (the Recognizer's forward: fbank, the frozen normaliser,
    the model) for every (batch, samples) bucket into `out_dir`, on the
    model's device. model: an ASRModel in eval mode; normalizer: a
    NormalizerState on that device, or None (features pass through).
    Returns the manifest."""
    from mamba_asr_torch.serving.recognizer import eval_step

    device = model.src_proj.weight.device
    norm = _normalizer(normalizer, frontend.n_mels, device)
    os.makedirs(out_dir, exist_ok=True)

    def fwd(wav, wav_lens):
        out = eval_step(model, frontend, norm, wav, wav_lens)
        return out["ctc_log_probs"], out["enc_lengths"]

    written = []
    for batch, samples in buckets:
        _export(fwd, [model], _example_wav(batch, samples, device),
                os.path.join(out_dir, _fn_file(batch, samples)))
        written.append([int(batch), int(samples)])
    manifest = _manifest(model, frontend, written, device, "ctc")
    return _write(out_dir, manifest, named_tensors(model))


def export_s2s_bundle(model, normalizer, frontend, searcher, out_dir: str,
                      buckets: Sequence[Tuple[int, int]]) -> dict:
    """Save the whole S2S transcription (waveform -> joint CTC/attention
    beam search with the searcher's LM fused when it has one -> (tokens
    (B, S), lengths (B,), scores (B,)), as `S2SBeamSearcher.__call__`
    returns them) for every bucket: the searcher's init, step and final as
    three programs. The weights are the searcher's decode copy of the
    model (bf16 decode weights for a bf16 model) in params.pt, and its
    LM's in lm_params.pt. Returns the manifest."""
    from mamba_asr_torch.ops.beam_attention import StepPos
    from mamba_asr_torch.serving.recognizer import eval_step

    model = searcher.decode_model
    lm = searcher.decode_lm
    device = model.src_proj.weight.device
    norm = _normalizer(normalizer, frontend.n_mels, device)
    os.makedirs(out_dir, exist_ok=True)
    modules = [model] + ([lm] if lm is not None else [])

    def init(wav, wav_lens):
        out = eval_step(model, frontend, norm, wav, wav_lens)
        return searcher.init(out["enc_out"], out["enc_lengths"], out["ctc_log_probs"])

    def step(state, s, s_dev):
        return searcher.step(state, StepPos(s, s_dev))

    written = []
    for batch, samples in buckets:
        wav = _example_wav(batch, samples, device)
        with torch.no_grad():
            state = init(*wav)  # with an LM, its position table: a buffer the programs take
        _export(init, modules, wav, os.path.join(out_dir, _fn_file(batch, samples, "init")))
        _export(step, modules, (state, torch.tensor(0), torch.tensor(0, device=device)),
                os.path.join(out_dir, _fn_file(batch, samples, "step")))
        _export(searcher.final, [], (state,),
                os.path.join(out_dir, _fn_file(batch, samples, "final")))
        written.append([int(batch), int(samples)])
    manifest = _manifest(model, frontend, written, device, "s2s")
    manifest.update(has_lm=lm is not None, bos_id=int(searcher.bos_id),
                    eos_id=int(searcher.eos_id))
    return _write(out_dir, manifest, named_tensors(model),
                  None if lm is None else named_tensors(lm))


def _streaming_fns(server):
    """The slot engine's device surface as functions over flat state
    leaves (the loader needs no structure):

      tick([leaves], audio (S, chunk), mask (S,)) -> (best (S, E_tick),
          [new leaves])
      bootstrap(audio (1, chunk)) -> (best (1, E_boot), [row leaves])
      flush([row leaves], audio (1, A), rem, extra) -> best (1, E)
      flush_fresh(audio (1, A_f), rem, extra) -> best (1, E_f)

    tick is the engine's `_tick_fn`. bootstrap, flush and flush_fresh
    reproduce the batch-1 session's first chunk and finish
    (models/streaming.py) with static shapes, as JAX's do
    (`export.py:344-426`): rem (mel frames still to emit) and extra (the
    canonical zero frames) are 0-d int64 tensors, and between-level masks
    zero everything past each level's valid emission count, so every
    position a valid output reads equals the session's. One encoder call
    per flush needs a causal encoder (`export_streaming_bundle` checks)."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from mamba_asr_torch.models.layers import dense
    from mamba_asr_torch.ops.fbank import log_mel_spectrogram
    from mamba_asr_torch.training.normalizer import apply_normalizer

    (replica,) = server._replicas  # a bundle is one device's
    model, fe, normalizer = server.model, server.frontend, server.normalizer
    front = model.frontend
    hop, win = server.hop, server.win
    chunk = server.chunk_samples
    ds = model.cfg.downsample
    tail_len = server._tail_len
    carry_lens = [c.shape[1] for c in replica.state["carry"]]
    spec = tree_flatten(replica.state)[1]
    dev = server.device

    def fbank_norm(window):
        feats = log_mel_spectrogram(
            window, sample_rate=fe.sample_rate, n_fft=fe.n_fft, n_mels=fe.n_mels,
            win_length_ms=fe.win_length_ms, hop_length_ms=fe.hop_length_ms, center=False)
        return feats if normalizer is None else apply_normalizer(normalizer, feats)

    def enc_ctc_best(x, enc_state):
        enc, new_state = model.forward_chunk(x, enc_state)
        logits = dense(enc.float(), model.ctc_head, torch.float32)
        return torch.log_softmax(logits, dim=-1).argmax(dim=-1), new_state

    def tick(leaves, audio, mask):
        best, _enc, new_state = server._tick_fn(replica, tree_unflatten(leaves, spec), audio,
                                                mask)
        return best, tree_flatten(new_state)[0]

    def bootstrap(audio):
        buf = torch.cat([torch.zeros(1, win // 2, device=audio.device), audio], dim=1)
        n_frames = 1 + (buf.shape[1] - win) // hop
        window = buf[:, : win + (n_frames - 1) * hop]
        new_tail = buf[:, n_frames * hop:]
        assert new_tail.shape[1] == tail_len, "bootstrap tail off the steady template"
        x = fbank_norm(window)[..., None]
        carries = []
        for i, (k, s) in enumerate(zip(front.kernel_sizes, front.strides)):
            e = (x.shape[1] - k) // s + 1
            out = front.apply_level(i, x, (0, 0))
            carries.append(x[:, e * s:])
            assert carries[-1].shape[1] == carry_lens[i], "bootstrap carry off the template"
            x = out
        best, new_enc = enc_ctc_best(x, model.init_streaming_state(1))
        row = {"tail": new_tail, "carry": tuple(carries), "enc": new_enc}
        return best, tree_flatten(row)[0]

    # Static flush sizes: M mel frames cover the most remaining real frames
    # + the canonical pad + each level's flush zero, for the steady
    # (promoted) and the fresh (never promoted) tails.
    def flush_sizes(t_len):
        m = (t_len + chunk - 1) // hop + 1 + ds + 1
        a = win + (m - 1) * hop - t_len
        assert a >= chunk - 1
        return m, a

    def flush_body(m, tail, carries, enc_state, audio, rem, extra):
        buf = torch.cat([tail, audio], dim=1)
        feats = fbank_norm(buf[:, : win + (m - 1) * hop])
        pos = torch.arange(m, device=feats.device)
        x = (feats * (pos < rem)[None, :, None])[..., None]
        vin = rem + extra + 1  # + the level-0 SAME flush zero
        for i, (k, s) in enumerate(zip(front.kernel_sizes, front.strides)):
            c = 0 if carries is None else carries[i].shape[1]
            bufi = x if carries is None else torch.cat([carries[i].to(x.dtype), x], dim=1)
            e = torch.clamp_min((c + vin - k) // s + 1, 0)
            out = front.apply_level(i, bufi, (0, 0))
            opos = torch.arange(out.shape[1], device=out.device)
            x = out * (opos < e)[None, :, None, None].to(out.dtype)
            vin = e + 1
        return enc_ctc_best(x, enc_state)[0]

    m_s, a_s = flush_sizes(tail_len)
    m_f, a_f = flush_sizes(win // 2)

    def flush(leaves, audio, rem, extra):
        row = tree_unflatten(leaves, spec)
        return flush_body(m_s, row["tail"], row["carry"], row["enc"], audio, rem, extra)

    def flush_fresh(audio, rem, extra):
        tail = torch.zeros(1, win // 2, device=audio.device)
        return flush_body(m_f, tail, None, model.init_streaming_state(1), audio, rem, extra)

    dims = {"flush_frames": m_s, "flush_samples": a_s,
            "flush_fresh_frames": m_f, "flush_fresh_samples": a_f}
    return {"tick": tick, "bootstrap": bootstrap, "flush": flush,
            "flush_fresh": flush_fresh}, dims, dev


def export_streaming_bundle(server, out_dir: str) -> dict:
    """Save the slot engine's device surface (`serving/engine.py:
    StreamingServer`): steady `tick`, first-chunk `bootstrap`,
    end-of-stream `flush` / `flush_fresh`, the slots' initial state leaves
    and the weights, so `ExportedStreamingServer` serves streams with no
    model code. Needs a causal encoder (`model.cfg.causal`): the flush
    consolidates the session's piecewise finish into one static-shape
    encoder call, exact only when chunking cannot change outputs. Greedy
    streaming only: a final pass is a separate offline bundle. The
    port's engine has no mesh, so there is none to refuse."""
    from torch.utils._pytree import tree_flatten

    model = server.model
    if not model.cfg.causal:
        raise ValueError("export_streaming_bundle requires a causal encoder config (the "
                         "exported flush consolidates chunked encoder calls)")
    os.makedirs(out_dir, exist_ok=True)
    fns, dims, dev = _streaming_fns(server)
    leaves = [x.detach().clone() for x in tree_flatten(server._replicas[0].state)[0]]
    rows = [x[:1].clone() for x in leaves]
    n_slots, chunk = server.n_slots, server.chunk_samples

    def scalar():
        return torch.tensor(0, device=dev)

    def audio(n):
        return torch.zeros(1, n, device=dev)

    examples = {
        "tick": (leaves, torch.zeros(n_slots, chunk, device=dev),
                 torch.zeros(n_slots, dtype=torch.bool, device=dev)),
        "bootstrap": (audio(chunk),),
        "flush": (rows, audio(dims["flush_samples"]), scalar(), scalar()),
        "flush_fresh": (audio(dims["flush_fresh_samples"]), scalar(), scalar()),
    }
    with torch.no_grad(), server._device_context():
        for name in STREAM_PROGRAMS:
            _export(fns[name], [model], examples[name],
                    os.path.join(out_dir, f"stream_{name}.pt2"))
    torch.save(leaves, os.path.join(out_dir, STATE_FILE))
    manifest = _manifest(model, server.frontend, [], dev, "streaming")
    manifest.update({
        "n_slots": n_slots, "chunk_samples": chunk, "chunk_frames": server.chunk_frames,
        "hop": server.hop, "win": server.win, "tail_len": server._tail_len,
        "boot_frames": 1 + (server.win // 2 + chunk - server.win) // server.hop,
        "n_state_leaves": len(leaves), **dims,
    })
    return _write(out_dir, manifest, named_tensors(model))


# -- load --------------------------------------------------------------------


def _open(bundle_dir: str, device, surfaces: Tuple[str, ...]) -> Tuple[dict, torch.device]:
    """The manifest of a torch bundle, checked against the device it is to
    run on; a JAX bundle and a device of another type raise ValueError."""
    from mamba_asr_torch.utils.device import resolve_device

    if (os.path.exists(os.path.join(bundle_dir, "params.msgpack"))
            or not os.path.exists(os.path.join(bundle_dir, PARAMS_FILE))):
        raise ValueError(
            f"{bundle_dir} is not a torch.export bundle (no {PARAMS_FILE}): a bundle of the "
            "JAX package (flax msgpack params with StableHLO programs) is not read; export "
            "the model with python -m mamba_asr_torch.export_model")
    with open(os.path.join(bundle_dir, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["format"] != FORMAT_VERSION:
        raise ValueError(f"bundle format {manifest['format']} != {FORMAT_VERSION}")
    if manifest["surface"] not in surfaces:
        raise ValueError(f"a {manifest['surface']} bundle, expected {' or '.join(surfaces)}")
    dev = resolve_device(device)
    exported = manifest["platforms"][0]
    if dev.type != exported:
        raise ValueError(f"the bundle was exported for {exported!r} and cannot run on "
                         f"{dev.type!r}: export it again on that device")
    return manifest, dev


def _weights(bundle_dir: str, name: str, dev) -> List[torch.Tensor]:
    state = torch.load(os.path.join(bundle_dir, name), map_location=dev, weights_only=True)
    return list(state.values())


class _Programs:
    """The bundle's programs, loaded at first use. Their inputs come from
    the loaders alone, so the modules skip `torch.export`'s per-call input
    validation (a flatten and check of every weight and state tensor, on
    every call; PERF.md §6)."""

    def __init__(self, bundle_dir: str):
        self.dir = bundle_dir
        self.loaded: Dict[str, object] = {}
        self.graphs: Dict[str, object] = {}

    def __call__(self, name: str):
        if name not in self.loaded:
            program = torch.export.load(os.path.join(self.dir, name))
            self.graphs[name] = program.graph
            module = program.module()
            module.validate_inputs = False
            self.loaded[name] = module
        return self.loaded[name]


class ExportedASR:
    """Load a bundle and transcribe with NO model code.

    CTC bundles: `__call__(wav (B, T) float32, wav_lens (B,) int) ->
    (ctc_log_probs (B, T', V), enc_lengths (B,))`. S2S bundles: `->
    (tokens (B, S), lengths (B,), scores (B,))` from the exported search
    (the LM's weights fed when bundled). numpy in and out. The smallest
    bucket that fits is padded with zeros (padded rows of length 1) and
    its padded rows stripped; nothing fits -> ValueError. device: where it
    runs, the card unless given; it must be the device type the bundle was
    exported on."""

    def __init__(self, bundle_dir: str, device=None):
        self.dir = bundle_dir
        self.manifest, self.device = _open(bundle_dir, device, ("ctc", "s2s"))
        self.surface = self.manifest["surface"]
        self.params = _weights(bundle_dir, PARAMS_FILE, self.device)
        self.lm_params = (_weights(bundle_dir, LM_PARAMS_FILE, self.device)
                          if self.manifest.get("has_lm") else None)
        # Sorted so "smallest fitting bucket" is the first match.
        self.buckets = sorted(tuple(b) for b in self.manifest["buckets"])
        self.programs = _Programs(bundle_dir)
        self.last_steps = 0  # beam steps of the last S2S call

    def _pick(self, batch: int, samples: int) -> Tuple[int, int]:
        fits = [(bs * ts, (bs, ts)) for bs, ts in self.buckets
                if bs >= batch and ts >= samples]
        if not fits:
            raise ValueError(f"no exported bucket fits (batch={batch}, samples={samples}); "
                             f"have {self.buckets}")
        return min(fits)[1]

    def _weights(self):
        return [self.params] + ([self.lm_params] if self.lm_params is not None else [])

    def _search(self, bucket, wav, lens):
        fn = self.programs
        w = self._weights()
        state = fn(_fn_file(*bucket, "init"))(*w, wav, lens)
        step = fn(_fn_file(*bucket, "step"))
        s_max = state["tokens"].shape[1] - 1
        # Each step's device index is a view of this: no copy to the card.
        on_device = torch.arange(s_max + 1, device=self.device)
        s = 0
        while s < s_max and not bool(state["finished"].all()):
            state.update(step(*w, state, torch.tensor(s), on_device[s]))
            s += 1
        self.last_steps = s
        return fn(_fn_file(*bucket, "final"))(state)

    @torch.no_grad()
    def __call__(self, wav, wav_lens):
        wav = np.asarray(wav, np.float32)
        wav_lens = np.asarray(wav_lens, np.int32)
        b, t = wav.shape
        bucket = self._pick(b, t)
        wav_pad, lens_pad = wav, wav_lens
        if (b, t) != bucket:
            wav_pad = np.zeros(bucket, np.float32)
            wav_pad[:b, :t] = wav
            lens_pad = np.ones((bucket[0],), np.int32)
            lens_pad[:b] = wav_lens
        wav_d = torch.from_numpy(wav_pad).to(self.device)
        lens_d = torch.from_numpy(lens_pad).to(self.device)
        if self.surface == "s2s":
            outs = self._search(bucket, wav_d, lens_d)
        else:
            outs = self.programs(_fn_file(*bucket))(self.params, wav_d, lens_d)
        return tuple(o[:b].cpu().numpy() for o in outs)


class ExportedStreamingServer(SlotEngine):
    """The slot-batched streaming engine driven by a bundle from
    `export_streaming_bundle` alone: serving/slots.py's host side, the
    live engine's own, over the four programs (tests/test_torch_stream_
    bundle.py holds the transcripts and the trailing silence equal to
    `serving.engine.StreamingServer`'s stream for stream). The slot state
    is a list of leaves with n_slots rows on the device. device: the card
    unless given, of the bundle's device type.

    One departure from JAX (`export.py:739`): the flush's count of new
    encoder frames is clamped to [0, E], E the flush's emitted width."""

    # The engine protocol AsrTcpServer drives: no final pass here.
    final_decode = None

    def __init__(self, bundle_dir: str, device=None):
        self.dir = bundle_dir
        m, dev = _open(bundle_dir, device, ("streaming",))
        self.m = m
        super().__init__(m["n_slots"], m["chunk_samples"], m["chunk_frames"] // m["downsample"],
                         m["sample_rate"], dev)
        self.params = _weights(bundle_dir, PARAMS_FILE, dev)
        self.state = torch.load(os.path.join(bundle_dir, STATE_FILE), map_location=dev,
                                weights_only=True)
        self.programs = _Programs(bundle_dir)
        self.hop, self.ds = m["hop"], m["downsample"]
        n = self.n_slots
        self._frames = [0] * n     # mel frames each stream has emitted
        self._enc_done = [0] * n   # encoder frames each stream has emitted
        self._last_tok = [0] * n   # the collapse's previous argmax id
        self.clamped = 0  # finishes whose frame count the clamp changed

    @property
    def frame_seconds(self) -> float:
        return (self.hop / self.m["sample_rate"]) * self.ds

    def _run(self, name: str, *args):
        return self.programs(f"stream_{name}.pt2")(self.params, *args)

    def _audio(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(rows)).to(self.device)  # a copy: feeds may be read-only

    def _collapse(self, slot: int, best: np.ndarray) -> List[int]:
        """The greedy CTC collapse of a row of argmax ids, carried across
        chunks."""
        out = []
        prev = self._last_tok[slot]
        for t in best.tolist():
            if t != 0 and t != prev:
                out.append(t)
            prev = t
        self._last_tok[slot] = prev
        return out

    # -- the device surface (serving/slots.py) ---------------------------
    def _open(self, slot: int) -> None:
        self._frames[slot] = self._enc_done[slot] = self._last_tok[slot] = 0

    def _bootstrap(self, slot: int, audio: np.ndarray) -> List[int]:
        best, row = self._run("bootstrap", self._audio(audio[None]))
        for leaf, r in zip(self.state, row):
            leaf[slot:slot + 1] = r
        self._frames[slot] = self.m["boot_frames"]
        best = best.cpu().numpy()[0]
        self._enc_done[slot] = best.shape[0]
        return self._collapse(slot, best)

    def _steady(self, audio: np.ndarray, mask: np.ndarray) -> np.ndarray:
        best, self.state = self._run("tick", self.state, self._audio(audio), self._audio(mask))
        return best.cpu().numpy()

    def _emit(self, slot: int, best: np.ndarray) -> List[int]:
        self._frames[slot] += self.m["chunk_frames"]
        self._enc_done[slot] += best.shape[0]
        return self._collapse(slot, best)

    def _flush(self, slot: int, rest: np.ndarray) -> List[int]:
        """flush (a promoted stream, from its row) or flush_fresh (a stream
        shorter than one chunk) over the rest of the audio, zero-padded to
        the program's width; rem, extra and n_out as JAX's finish
        (`export.py:730-761`)."""
        total_frames = self._fed[slot] // self.hop + 1
        extra = (-total_frames) % self.ds
        rem = max(total_frames - self._frames[slot], 0)
        n_out = (total_frames + extra) // self.ds - self._enc_done[slot]
        fresh = not self._promoted[slot]
        audio = np.zeros((1, self.m["flush_fresh_samples" if fresh else "flush_samples"]),
                         np.float32)
        audio[0, : rest.size] = rest
        scalars = (torch.tensor(rem, device=self.device),
                   torch.tensor(extra, device=self.device))
        if fresh:
            best = self._run("flush_fresh", self._audio(audio), *scalars)
        else:
            row = [leaf[slot:slot + 1] for leaf in self.state]
            best = self._run("flush", row, self._audio(audio), *scalars)
        best = best.cpu().numpy()[0]
        clamped = min(max(n_out, 0), best.shape[0])
        self.clamped += clamped != n_out
        return self._collapse(slot, best[:clamped])

    def _close(self, slot: int) -> None:
        pass


def program_launches(bundle) -> Dict[str, Dict[str, int]]:
    """`mamba_asr::*` nodes of each program a loaded bundle (ExportedASR
    or ExportedStreamingServer) has run, by file and op name: the kernel
    launches one run of the program makes."""
    out: Dict[str, Dict[str, int]] = {}
    for name, graph in bundle.programs.graphs.items():
        counts = out.setdefault(name, {})
        for node in graph.nodes:
            op = getattr(node.target, "namespace", None) == "mamba_asr" and node.target._opname
            if op:
                counts[op] = counts.get(op, 0) + 1
    return out
