"""Selective-scan (Mamba S6) recurrence (port of
mamba_asr_tpu/ops/selective_scan.py).

    delta = softplus(delta + delta_bias)            (optional)
    h_t   = exp(delta_t * A) * h_{t-1} + delta_t * B_t * u_t
    y_t   = <h_t, C_t> + D * u_t
    out_t = y_t * silu(z_t)                         (optional gate)

Layout is time-major (B, L, D), as in the JAX package. The scan math is
float32 for any input dtype; the output takes u's dtype.

`selective_scan` picks by device: on CPU tensors the plain versions,
`selective_scan_ref` forward and `selective_scan_bwd_ref` backward; on
CUDA tensors the Hopper kernels (`kernels/selective_scan.py`) or an
error. Under `torch.no_grad()` (or when no input needs a gradient) a call
is one `mamba_asr::selective_scan_fwd` op (`kernels/ops.py`): on the card
one inference launch of K1, and the node an exported program holds. With
a gradient it runs through `SelectiveScanFn`: K1's training form, which
keeps the per-chunk states, and K2 in the backward.

`ssm_step` is one token's update, for the decoder's cache.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from mamba_asr_torch.kernels import ops as kernel_ops

Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def selective_scan_ref(
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
) -> Out:
    """Sequential float32 loop over time.

    u, delta, z (B, L, D); A (D, N); B, C (B, L, N); D, delta_bias (D,);
    h0 (B, D, N). Returns out (B, L, D) in u's dtype, and the final state
    (B, D, N) float32 when `return_last_state`.
    """
    uf = u.float()
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()
    if delta_softplus:
        dt = torch.logaddexp(dt, torch.zeros_like(dt))  # jax.nn.softplus
    Af = A.float()
    Bf = B.float()
    Cf = C.float()
    bsz, length, d_in = u.shape
    h = (
        torch.zeros(bsz, d_in, A.shape[1], dtype=torch.float32, device=u.device)
        if h0 is None else h0.float()
    )
    ys = []
    for t in range(length):
        da = torch.exp(dt[:, t, :, None] * Af)  # (B, D, N)
        dbu = (dt[:, t] * uf[:, t])[:, :, None] * Bf[:, t, None, :]
        h = da * h + dbu
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + uf * D.float()
    if z is not None:
        y = y * F.silu(z.float())
    out = y.to(u.dtype)
    if return_last_state:
        return out, h
    return out


def selective_scan_bwd_ref(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor],
    z: Optional[torch.Tensor],
    delta_bias: Optional[torch.Tensor],
    delta_softplus: bool,
    h0: Optional[torch.Tensor],
    dout: torch.Tensor,
    dh_last: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], ...]:
    """The analytic adjoint of `selective_scan_ref`, a sequential float32
    loop: the math of the JAX package's `selective_scan_vjp`
    (mamba_asr_tpu/ops/selective_scan.py) with the h0 and d(h_last) terms of
    its Pallas adjoint (ops/pallas/scan.py:_scan_bwd_kernel):

        g_t = dy_t C_t + a_{t+1} g_{t+1},  g_{L-1} += dh_last,  dh0 = a_0 g_0
        du_t = dt_t <g_t, B_t> + D dy_t
        ddt_t = u_t <g_t, B_t> + <g_t a_t h_{t-1}, A>

    with dy = dout * silu(z). Returns (du, ddelta, dA, dB, dC, dD, dz,
    ddelta_bias, dh0), each in its input's dtype, None for an absent
    input. The forward's states are kept for every step (B, L, D, N):
    this is the oracle, not the fast path.
    """
    uf = u.float()
    raw = delta.float()
    if delta_bias is not None:
        raw = raw + delta_bias.float()
    if delta_softplus:
        dt = torch.logaddexp(raw, torch.zeros_like(raw))
        dsp = torch.sigmoid(raw)
    else:
        dt, dsp = raw, torch.ones_like(raw)
    Af, Bf, Cf = A.float(), B.float(), C.float()
    go = dout.float()
    if z is not None:
        zf = z.float()
        sig = torch.sigmoid(zf)
        dy = go * zf * sig
    else:
        dy = go
    bsz, length, d_in = u.shape
    h = (torch.zeros(bsz, d_in, A.shape[1], dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    hs = [h]  # hs[t + 1] is the state after step t
    for t in range(length):
        da = torch.exp(dt[:, t, :, None] * Af)
        h = da * h + (dt[:, t] * uf[:, t])[:, :, None] * Bf[:, t, None, :]
        hs.append(h)
    g = torch.zeros_like(h) if dh_last is None else dh_last.float().clone()
    du, ddt, dB, dC = (torch.empty_like(x) for x in (uf, uf, Bf, Cf))
    dA = torch.zeros_like(Af)
    for t in reversed(range(length)):
        da = torch.exp(dt[:, t, :, None] * Af)
        g = g + dy[:, t, :, None] * Cf[:, t, None, :]
        gb = torch.einsum("bdn,bn->bd", g, Bf[:, t])
        gdh = g * da * hs[t]
        du[:, t] = gb * dt[:, t]
        ddt[:, t] = gb * uf[:, t] + torch.einsum("bdn,dn->bd", gdh, Af)
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dt[:, t] * uf[:, t])
        dC[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dy[:, t])
        dA = dA + torch.einsum("bdn,bd->dn", gdh, dt[:, t])
        g = g * da
    dD = dz = None
    if D is not None:
        du = du + dy * D.float()
        dD = (dy * uf).sum((0, 1)).to(D.dtype)
    if z is not None:
        y_pre = torch.einsum("lbdn,bln->bld", torch.stack(hs[1:]), Cf)
        if D is not None:
            y_pre = y_pre + uf * D.float()
        dz = (go * y_pre * sig * (1.0 + zf * (1.0 - sig))).to(z.dtype)
    ddelta = ddt * dsp
    ddb = None if delta_bias is None else ddelta.sum((0, 1)).to(delta_bias.dtype)
    return (
        du.to(u.dtype), ddelta.to(delta.dtype), dA.to(A.dtype), dB.to(B.dtype),
        dC.to(C.dtype), dD, dz, ddb, None if h0 is None else g.to(h0.dtype),
    )


class SelectiveScanFn(torch.autograd.Function):
    """The scan with its analytic adjoint, for calls that need a gradient.
    Forward: `selective_scan_ref` on the CPU; on the card K1's training
    form (the per-chunk states are the one extra residual). Backward: on
    the CPU `selective_scan_bwd_ref`, on the card K2, given the cotangent
    of out and, when the forward returned it, of h_last. Each gradient
    comes back in its input's dtype; absent D, z, delta_bias or h0 get
    None."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias, h0,
                delta_softplus: bool, return_last_state: bool):
        args = (u, delta, A, B, C, D, z, delta_bias, delta_softplus, h0)
        h_chunks = None
        if u.device.type == "cpu":
            out, h_last = selective_scan_ref(*args, return_last_state=True)
        elif u.device.type == "cuda":
            from mamba_asr_torch.kernels import selective_scan as kernels

            out, h_last, h_chunks = kernels.selective_scan_fwd_train(
                *args, return_last_state=return_last_state)
        else:
            raise ValueError(f"no selective scan for device {u.device}")
        ctx.save_for_backward(u, delta, A, B, C, D, z, delta_bias, h0, h_chunks)
        ctx.delta_softplus = delta_softplus
        ctx.set_materialize_grads(False)
        if return_last_state:
            return out, h_last
        return out

    @staticmethod
    def backward(ctx, dout, dh_last=None):
        u, delta, A, B, C, D, z, delta_bias, h0, h_chunks = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(u)
        if u.device.type == "cuda":
            from mamba_asr_torch.kernels import selective_scan as kernels

            grads = kernels.selective_scan_bwd(
                u, delta, A, B, C, D, z, delta_bias, ctx.delta_softplus, h0,
                h_chunks, dout.to(u.dtype).contiguous(),
                None if dh_last is None else dh_last.float().contiguous(),
            )
        else:
            grads = selective_scan_bwd_ref(
                u, delta, A, B, C, D, z, delta_bias, ctx.delta_softplus, h0,
                dout, dh_last,
            )
        return (*grads, None, None)


def selective_scan(
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
) -> Out:
    """CPU tensors -> the plain versions; CUDA tensors -> the Hopper
    kernels, which raise on what they do not take. When grad mode is on
    and an input needs a gradient, `SelectiveScanFn` (K1's training form,
    K2 in the backward); else the `mamba_asr::selective_scan_fwd` op."""
    tensors = (u, delta, A, B, C, D, z, delta_bias, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return SelectiveScanFn.apply(*tensors, delta_softplus, return_last_state)
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no selective scan for device {u.device}")
    out, h_last = kernel_ops.selective_scan_fwd(*tensors, delta_softplus, return_last_state)
    return (out, h_last) if return_last_state else out


def ssm_step(
    h: torch.Tensor,
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token's state update for decoding (JAX `ssm_step`), plain torch
    on any device: the JAX package leaves it to XLA.

    h (B, D, N) float32; u, delta, z (B, D); B, C (B, N); A (D, N); D and
    delta_bias (D,). Returns (y (B, D) in u's dtype, the new h in
    float32)."""
    uf = u.float()
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()
    if delta_softplus:
        dt = torch.logaddexp(dt, torch.zeros_like(dt))  # jax.nn.softplus
    da = torch.exp(dt[..., None] * A.float())
    db = dt[..., None] * B.float()[:, None, :]
    h_new = h.float() * da + uf[..., None] * db
    y = torch.einsum("bdn,bn->bd", h_new, C.float())
    if D is not None:
        y = y + D.float() * uf
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(u.dtype), h_new
