"""Plain PyTorch versions of the Mamba-2 SSD (state-space duality) scan.

Sequential recurrence (ground truth):
    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * (B_t outer x_t)     h: (H, P, N)
    y_t = C_t . h_t + D_h * x_t

Shapes (single group G=1, B/C shared across heads):
    x  (B, S, H, P)    dt (B, S, H)    A (H,)  negative
    Bm (B, S, N)       Cm (B, S, N)    D (H,)
Return y (B, S, H, P) in x's dtype and the final state (B, H, P, N) in fp32.

D-skip order: every function here (and the CUDA kernel) adds D * x in fp32
to the fp32 scan output and casts to x's dtype once. `repro`'s Pallas path
casts first and adds D afterwards; in fp32 the two agree exactly, in bf16
they differ by one rounding.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _add_skip(y: torch.Tensor, x: torch.Tensor, D: torch.Tensor):
    return (y + D.float()[None, None, :, None] * x.float()).to(x.dtype)


def ssd_ref(x, dt, A, Bm, Cm, D) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token recurrence (the oracle)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = Bm.float(), Cm.float()
    h = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None, :])                   # (B,H)
        dbx = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        h = h * decay[:, :, None, None] + dbx
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, 1)
    return _add_skip(y, x, D), h


def ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk: int = 128
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel SSD, the algorithm the CUDA kernel implements:
    intra-chunk quadratic form plus the inter-chunk state recurrence, over
    chunks of Q = min(chunk, S) tokens. A ragged S is padded with dt = 0,
    which changes nothing (decay exp(0) = 1, zero contribution)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    xf, dtf = x.float(), dt.float()
    Bf, Cf = Bm.float(), Cm.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    nc = (S + pad) // Q
    xf = xf.reshape(Bsz, nc, Q, H, P)
    dtf = dtf.reshape(Bsz, nc, Q, H)
    Bf = Bf.reshape(Bsz, nc, Q, N)
    Cf = Cf.reshape(Bsz, nc, Q, N)
    Af = A.float()

    cum = torch.cumsum(dtf * Af, dim=2)                    # (B,nc,Q,H) L_t
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Q,Q,H) L_t-L_s
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    decay_m = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                          torch.zeros((), device=x.device))

    # intra-chunk: y[t] = sum_{s<=t} (C_t.B_s) exp(L_t-L_s) dt_s x_s
    cb = torch.einsum("bctn,bcsn->bcts", Cf, Bf)
    m = cb[..., None] * decay_m * dtf[:, :, None, :, :]
    y = torch.einsum("bctsh,bcshp->bcthp", m, xf)

    # per-chunk state contribution: sum_s exp(L_Q - L_s) dt_s x_s B_s^T
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dtf        # (B,nc,Q,H)
    chunk_state = torch.einsum("bcqh,bcqn,bcqhp->bchpn", tail, Bf, xf)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B,nc,H)

    h = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)                                  # state before chunk c
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_prev = torch.stack(h_prevs, 1)                       # (B,nc,H,P,N)

    # inter-chunk: y[t] += exp(L_t) * C_t . h_prev
    y = y + torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cf, h_prev, torch.exp(cum))
    y = y.reshape(Bsz, nc * Q, H, P)[:, :S]
    return _add_skip(y, x, D), h


def ssd_decode_step_ref(state, x, dt, A, Bm, Cm, D
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent update (decode path). state (B,H,P,N) fp32,
    x (B,H,P), dt (B,H), Bm/Cm (B,N)."""
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(dtf * A.float()[None, :])
    dbx = torch.einsum("bh,bhp,bn->bhpn", dtf, xf, Bm.float())
    state = state * decay[:, :, None, None] + dbx
    y = torch.einsum("bhpn,bn->bhp", state, Cm.float())
    y = y + D.float()[None, :, None] * xf
    return y.to(x.dtype), state
