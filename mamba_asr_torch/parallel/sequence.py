"""Sequence parallelism for the selective scan and the causal conv (port
of mamba_asr_tpu/parallel/sequence.py:65-251).

The time axis of the activations is split over the ranks of a seq axis
(`parallel/mesh.py`), each holding a contiguous shard. Everything in a
ConMamba layer but the scan and the two convolutions is pointwise in
time and runs on the shard as it is; these three need their neighbours:

- `sp_halo_exchange` extends a shard with `left` frames of its
  predecessor and `right` frames of its successor (zeros at the ends of
  the sequence, as the unsharded padding), through an all-gather
  (`parallel/collectives.py`);
- `sp_causal_conv1d` is the Mamba block's depthwise causal conv over a
  (K-1)-frame halo (`reverse`: anti-causal, the halo from the successor);
- `sp_selective_scan` chains the recurrence across shards in two passes
  of the fused scan. Pass 1 scans the shard from zero and returns its
  last state h_loc (K1's training form with h_last out on the card). The
  shard's transition is exp(A * sum_t dt_t): A is diagonal and constant
  in time, so the product of the steps' transitions is one exponential
  of the summed dt. Every rank gathers the (a_k, h_loc) pairs, combines
  them in shard order (reverse: from the last shard back) into the state
  entering its own shard, h0_k, and pass 2 scans the shard again from
  h0_k. Both passes go through `ops/selective_scan.py:SelectiveScanFn`,
  so the backward is K2's, taking d(h_last) in pass 1 and giving dh0 in
  pass 2; the gather's backward sums the h0_k cotangents over the ranks.

Exact up to float associativity: tests/test_torch_parallel.py holds it
against the JAX functions under shard_map.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from mamba_asr_torch.ops.causal_conv1d import causal_conv1d
from mamba_asr_torch.ops.selective_scan import selective_scan
from mamba_asr_torch.parallel.collectives import all_gather
from mamba_asr_torch.parallel.mesh import Axis

Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def sp_halo_exchange(x: torch.Tensor, left: int, right: int, axis: Axis) -> torch.Tensor:
    """x (B, L_local, D) -> (B, left + L_local + right, D): `left` frames
    of the predecessor shard before it, `right` of the successor after it,
    zeros beyond the sequence's ends."""
    if max(left, right) > x.shape[1]:
        raise ValueError(f"a halo of {left}/{right} frames exceeds the shard's "
                         f"{x.shape[1]}: use fewer shards or longer sequences")
    n, idx = axis.size, axis.index
    parts = [x]
    if n == 1:
        if left:
            parts.insert(0, torch.zeros_like(x[:, :left]))
        if right:
            parts.append(torch.zeros_like(x[:, :right]))
        return torch.cat(parts, dim=1) if len(parts) > 1 else x
    length = x.shape[1]
    # The end shards take a neighbour's slot times 0, not fresh zeros: the
    # gather must stay in every rank's graph, or its backward (a
    # collective) would run on some ranks only.
    if left:
        tails = all_gather(x[:, length - left:], axis)
        parts.insert(0, tails[(idx - 1) % n] * float(idx > 0))
    if right:
        heads = all_gather(x[:, :right], axis)
        parts.append(heads[(idx + 1) % n] * float(idx < n - 1))
    return torch.cat(parts, dim=1) if len(parts) > 1 else x


def sp_causal_conv1d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     activation: Optional[str] = "silu", axis: Optional[Axis] = None,
                     reverse: bool = False) -> torch.Tensor:
    """`ops.causal_conv1d` over a time shard x (B, L_local, D) with taps
    (K, D): the (K-1)-frame halo comes from the predecessor; with reverse
    the conv is anti-causal in global time, flip(causal_conv1d(flip(x))),
    with the halo from the successor."""
    k = weight.shape[0]
    if axis is None or axis.size == 1 or k <= 1:
        if reverse:
            return causal_conv1d(x.flip(1), weight, bias, activation).flip(1)
        return causal_conv1d(x, weight, bias, activation)
    if not reverse:
        buf = sp_halo_exchange(x, k - 1, 0, axis)
        return causal_conv1d(buf, weight, bias, activation)[:, k - 1:].contiguous()
    buf = sp_halo_exchange(x, 0, k - 1, axis).flip(1)
    return causal_conv1d(buf, weight, bias, activation)[:, k - 1:].flip(1)


def _softplus_sum_dt(delta: torch.Tensor, delta_bias: Optional[torch.Tensor],
                     delta_softplus: bool) -> torch.Tensor:
    """sum_t dt (B, D) float32, dt prepared as the scan prepares it."""
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()
    if delta_softplus:
        dt = torch.logaddexp(dt, torch.zeros_like(dt))  # the scan's softplus
    return dt.sum(1)


def sp_selective_scan(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
    h0: Optional[torch.Tensor] = None,
    return_last_state: bool = False,
    axis: Optional[Axis] = None,
    reverse: bool = False,
) -> Out:
    """`ops.selective_scan` over a time shard: u, delta, B, C, z hold this
    rank's (B, L_local, ...) frames; h0 (B, D, N) is the state before the
    whole sequence. Returns this shard's output, and with
    return_last_state the state after the whole sequence, the same on
    every rank (a loss over it counts once per rank). reverse scans
    global time right to left; inputs and output keep their order."""
    if reverse:
        u, delta, B, C = u.flip(1), delta.flip(1), B.flip(1), C.flip(1)
        z = None if z is None else z.flip(1)
    if axis is None or axis.size == 1:
        out = selective_scan(u, delta, A, B, C, D, z, delta_bias, delta_softplus, h0,
                             return_last_state)
        if not reverse:
            return out
        if return_last_state:
            return out[0].flip(1), out[1]
        return out.flip(1)

    _, h_loc = selective_scan(u, delta, A, B, C, D, z, delta_bias, delta_softplus,
                              None, True)  # pass 1: (B, D, N) float32
    a_k = torch.exp(_softplus_sum_dt(delta, delta_bias, delta_softplus)[:, :, None]
                    * A.float()[None])
    pairs = all_gather(torch.stack([a_k, h_loc]), axis)  # (n, 2, B, D, N)
    order = range(axis.size - 1, -1, -1) if reverse else range(axis.size)
    state = torch.zeros_like(h_loc) if h0 is None else h0.float()
    prefix = [None] * axis.size  # the state entering each shard
    for j in order:
        prefix[j] = state
        state = pairs[j, 0] * state + pairs[j, 1]
    # A one-hot sum, not prefix[index]: the first shard's state does not
    # depend on the gather, which must stay in every rank's graph (its
    # backward is a collective).
    h0_k = sum(p * float(j == axis.index) for j, p in enumerate(prefix))
    out = selective_scan(u, delta, A, B, C, D, z, delta_bias, delta_softplus,
                         h0_k, False)  # pass 2, from the chained state
    if reverse:
        out = out.flip(1)
    return (out, state) if return_last_state else out
