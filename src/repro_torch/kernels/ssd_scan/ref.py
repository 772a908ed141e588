"""Plain PyTorch versions of the Mamba-2 SSD (state-space duality) scan.

Sequential recurrence (ground truth):
    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * (B_t outer x_t)     h: (H, P, N)
    y_t = C_t . h_t + D_h * x_t

Shapes (single group G=1, B/C shared across heads):
    x  (B, S, H, P)    dt (B, S, H)    A (H,)  negative
    Bm (B, S, N)       Cm (B, S, N)    D (H,)
Return y (B, S, H, P) in x's dtype and the final state (B, H, P, N) in fp32.
Every function here computes in fp32 (float64 when x is float64, for the
gradient checks of the CPU tests).

`ssd_chunked_bwd_ref` is the backward of the chunked form, written out in
chunks as the CUDA backward computes it; with `ssd_chunked_ref(...,
return_states=True)` it is the plain pair that `ops.SSDScanFn` runs on the
CPU and that the kernels are held against on the card.

D-skip order: every function here (and the CUDA kernel) adds D * x in fp32
to the fp32 scan output and casts to x's dtype once. `repro`'s Pallas path
casts first and adds D afterwards; in fp32 the two agree exactly, in bf16
they differ by one rounding.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _wide(x: torch.Tensor) -> torch.dtype:
    """The dtype the plain versions compute in: fp32, or float64 for x float64."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _add_skip(y: torch.Tensor, x: torch.Tensor, D: torch.Tensor):
    wide = _wide(x)
    return (y + D.to(wide)[None, None, :, None] * x.to(wide)).to(x.dtype)


def _chunks(t: torch.Tensor, pad: int, Q: int, wide: torch.dtype) -> torch.Tensor:
    """(B, S, ...) in `wide`, padded with zero rows to a multiple of Q and
    split into (B, nc, Q, ...)."""
    t = t.to(wide)
    if pad:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape(t.shape[0], -1, Q, *t.shape[2:])


def ssd_ref(x, dt, A, Bm, Cm, D) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token recurrence (the oracle)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    wide = _wide(x)
    xf, dtf, Af, Bf, Cf = (t.to(wide) for t in (x, dt, A, Bm, Cm))
    h = torch.zeros(Bsz, H, P, N, dtype=wide, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None, :])                   # (B,H)
        dbx = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        h = h * decay[:, :, None, None] + dbx
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, 1)
    return _add_skip(y, x, D), h


def ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk: int = 128, return_states: bool = False):
    """Chunk-parallel SSD, the algorithm the CUDA kernel implements:
    intra-chunk quadratic form plus the inter-chunk state recurrence, over
    chunks of Q = min(chunk, S) tokens. A ragged S is padded with dt = 0,
    which changes nothing (decay exp(0) = 1, zero contribution). With
    `return_states` it also returns the state entering each chunk, h_prev
    (B, nc, H, P, N), which the backward takes.

    exp(L_t - L_s) is taken over the whole Q x Q square and masked to s <= t
    afterwards, as `repro`'s version does: where |dt A| summed over a chunk
    passes ~88 the masked-out entries overflow to inf, which the values
    survive and autograd through this function does not (0 * inf).
    `ssd_chunked_bwd_ref` masks before exp."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    wide = _wide(x)
    xf, dtf, Bf, Cf = (_chunks(t, pad, Q, wide) for t in (x, dt, Bm, Cm))
    nc = xf.shape[1]
    Af = A.to(wide)

    cum = torch.cumsum(dtf * Af, dim=2)                    # (B,nc,Q,H) L_t
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Q,Q,H) L_t-L_s
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    decay_m = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                          torch.zeros((), dtype=wide, device=x.device))

    # intra-chunk: y[t] = sum_{s<=t} (C_t.B_s) exp(L_t-L_s) dt_s x_s
    cb = torch.einsum("bctn,bcsn->bcts", Cf, Bf)
    m = cb[..., None] * decay_m * dtf[:, :, None, :, :]
    y = torch.einsum("bctsh,bcshp->bcthp", m, xf)

    # per-chunk state contribution: sum_s exp(L_Q - L_s) dt_s x_s B_s^T
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dtf        # (B,nc,Q,H)
    chunk_state = torch.einsum("bcqh,bcqn,bcqhp->bchpn", tail, Bf, xf)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B,nc,H)

    h = torch.zeros(Bsz, H, P, N, dtype=wide, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)                                  # state before chunk c
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_prev = torch.stack(h_prevs, 1)                       # (B,nc,H,P,N)

    # inter-chunk: y[t] += exp(L_t) * C_t . h_prev
    y = y + torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cf, h_prev, torch.exp(cum))
    y = _add_skip(y.reshape(Bsz, nc * Q, H, P)[:, :S], x, D)
    return (y, h, h_prev) if return_states else (y, h)


def ssd_chunked_bwd_ref(x, dt, A, Bm, Cm, D, h_prev, dy, dhT=None, chunk: int = 128):
    """Gradients of `ssd_chunked_ref`'s (y, final state) with respect to
    (x, dt, A, Bm, Cm, D), given the forward's `h_prev` (B, nc, H, P, N),
    y's gradient `dy` (B, S, H, P) and the final state's `dhT` (B, H, P, N;
    None: the state is unused). Returns (dx, ddt, dA, dB, dC, dD) in fp32
    (float64 for float64 x), computed in chunks as the CUDA backward does.
    Per (b, h), chunk c, with L the inclusive cumsum of dt A over the chunk,
    w_s = exp(L_Q - L_s) dt_s and dH_c the gradient of the state after
    chunk c:
      dH_c   = exp(L_Q,c+1) dH_c+1 + sum_t exp(L_t) dy_t^T C_t  (chunk c+1),
               dH_last = dhT
      dx_s   = dt_s sum_{t>=s} (C_t.B_s) exp(L_t-L_s) dy_t + w_s dH_c B_s + D dy_s
      dS_ts  = sum_h (dy_t.x_s) exp(L_t-L_s) dt_s on s <= t
      dC_t   = sum_s dS_ts B_s + sum_h exp(L_t) dy_t h_prev
      dB_s   = sum_t dS_ts C_t + sum_h w_s x_s dH_c
    and dL_t, the gradient of L_t, collects the intra-chunk terms (through
    the forward's intra y and the dx above), the inter-chunk term, the
    state term and the chunk decay exp(L_Q) h_prev; ddt is the direct term
    plus A times the reverse cumsum of dL, dA sums dt times that cumsum.
    The exponent is masked before exp, so no entry overflows."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    wide = _wide(x)
    xf, dtf, Bf, Cf, dyf = (_chunks(t, pad, Q, wide) for t in (x, dt, Bm, Cm, dy))
    nc = xf.shape[1]
    Af, Df, hp = A.to(wide), D.to(wide), h_prev.to(wide)

    cum = torch.cumsum(dtf * Af, dim=2)                    # (B,nc,Q,H) L_t
    lq = cum[:, :, -1]                                     # (B,nc,H) L_Q
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,t,s,H) L_t-L_s
    decay = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                  torch.full((), -torch.inf, dtype=wide, device=x.device)))
    el = torch.exp(cum)                                    # exp(L_t)
    tail = torch.exp(lq[:, :, None] - cum)                 # exp(L_Q - L_s)
    w = tail * dtf

    # the reverse state pass: dhn[:, c] is the gradient of the state after chunk c
    u = torch.einsum("bcth,bcthp,bctn->bchpn", el, dyf, Cf)
    g = (torch.zeros(Bsz, H, P, N, dtype=wide, device=x.device) if dhT is None
         else dhT.to(wide))
    dhn = []
    for c in reversed(range(nc)):
        dhn.append(g)
        g = torch.exp(lq[:, c])[..., None, None] * g + u[:, c]
    dhn = torch.stack(dhn[::-1], 1)                        # (B,nc,H,P,N)

    # dx: the intra-chunk, state and skip terms
    mprime = torch.einsum("bctn,bcsn->bcts", Cf, Bf)[..., None] * decay
    dxi = torch.einsum("bctsh,bcthp->bcshp", mprime, dyf)  # sum_t M'_ts dy_t
    dxs = torch.einsum("bchpn,bcsn->bcshp", dhn, Bf)       # dH_c B_s
    dx = dtf[..., None] * dxi + w[..., None] * dxs + Df[:, None] * dyf

    # dB and dC: through dS (summed over heads) and the inter and state terms
    dS = torch.einsum("bcthp,bcshp,bctsh,bcsh->bcts", dyf, xf, decay, dtf)
    dC = (torch.einsum("bcts,bcsn->bctn", dS, Bf)
          + torch.einsum("bcth,bcthp,bchpn->bctn", el, dyf, hp))
    dB = (torch.einsum("bcts,bctn->bcsn", dS, Cf)
          + torch.einsum("bcsh,bcshp,bchpn->bcsn", w, xf, dhn))

    # dL, then ddt and dA through the reverse cumsum of dL
    yi = torch.einsum("bctsh,bcsh,bcshp->bcthp", mprime, dtf, xf)   # the forward's intra y
    yh = torch.einsum("bctn,bchpn->bcthp", Cf, hp)                   # C_t h_prev^T
    xds = (xf * dxs).sum(-1)
    direct = (xf * dxi).sum(-1) + tail * xds               # d/d dt_s at fixed L
    dL = (dyf * yi).sum(-1) + el * (dyf * yh).sum(-1) - dtf * direct
    dL[:, :, -1] += (w * xds).sum(2) + torch.exp(lq) * (hp * dhn).sum((-2, -1))
    da = dL.flip(2).cumsum(2).flip(2)                      # sum_{t>=u} dL_t
    ddt = direct + Af * da
    dA = (dtf * da).sum((0, 1, 2))
    dD = (dyf * xf).sum((0, 1, 2, 4))

    def rows(t):
        return t.reshape(Bsz, nc * Q, *t.shape[3:])[:, :S]
    return rows(dx), rows(ddt), dA, rows(dB), rows(dC), dD


def ssd_decode_step_ref(state, x, dt, A, Bm, Cm, D
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent update (decode path). state (B,H,P,N) fp32,
    x (B,H,P), dt (B,H), Bm/Cm (B,N)."""
    wide = _wide(x)
    xf, dtf = x.to(wide), dt.to(wide)
    decay = torch.exp(dtf * A.to(wide)[None, :])
    dbx = torch.einsum("bh,bhp,bn->bhpn", dtf, xf, Bm.to(wide))
    state = state * decay[:, :, None, None] + dbx
    y = torch.einsum("bhpn,bn->bhp", state, Cm.to(wide))
    y = y + D.to(wide)[None, :, None] * xf
    return y.to(x.dtype), state
