"""Public SSD entry points. A CUDA tensor always goes to the hand-written
kernel (which launches or raises); a CPU tensor goes to the plain chunked
version. There is no switch and no fallback between the two. K2 has no
backward pass yet: on the card, `ssd` refuses inputs that need a gradient
instead of returning outputs without one."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_decode_step_ref


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, D: torch.Tensor, *, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (B,S,H,P) in x's dtype and the final state (B,H,P,N) fp32."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm, D)):
        # the kernel's outputs would carry no grad_fn: gradients would be
        # dropped without an error
        raise NotImplementedError(
            "the SSD-scan kernel has no backward yet (ROADMAP queue 2, K2's backward "
            "pass, and item 11's SSM/hybrid training): run it under torch.no_grad() "
            "or train the ssm and hybrid families on the CPU")
    # x, Bm, Cm go in as they are (the bf16 kernels read strided views)
    return ssd_scan(x, dt.float().contiguous(), A.float().contiguous(),
                    Bm, Cm, D.float().contiguous(), chunk=chunk)


ssd_decode_step = ssd_decode_step_ref
