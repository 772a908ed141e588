#!/usr/bin/env python3
"""K2's backward on one NVIDIA card against the plain versions, gradient by
gradient, from the `repro_torch` of the tree it is run from.

    cd <a checkout of the repo> && python3 <path>/scripts/k2_grad_accuracy.py LABEL

At the card tests' cases (tests/test_torch_cuda.py's inputs and y
gradient), fp32 and bf16, prints for each of dx, ddt, dA, dB, dC, dD the
largest |d| / max|ref| of the kernels (forward with its states, then the
backward) against the fp32 plain pair (`ssd_chunked_ref`,
`ssd_chunked_bwd_ref`), of the kernels against the float64 plain pair, and
of the fp32 plain pair against float64.
"""
import sys
from pathlib import Path

TREE = Path.cwd()
sys.path[:0] = [str(TREE / "src"), str(Path(__file__).resolve().parent.parent / "tests")]

CASES = [(2, 300, 4, 64, 128, 128), (1, 37, 4, 64, 128, 128), (2, 300, 4, 64, 64, 128)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k2_grad_accuracy: torch finds no CUDA device", file=sys.stderr)
        return 1
    import test_torch_cuda as tc
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_bwd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd_ref, ssd_chunked_ref
    label = sys.argv[1] if len(sys.argv) > 1 else TREE.name
    cuda = torch.device("cuda")
    for case in CASES:
        for dname in ("fp32", "bf16"):
            args = [a.to(cuda) for a in tc._inputs(case, tc.DTYPES[dname][0])]
            g = torch.Generator(cuda).manual_seed(1)
            dy = torch.randn(args[0].shape, generator=g, device=cuda).to(args[0].dtype)
            _, _, h_prev = ssd_scan(*args, chunk=case[-1], return_states=True)
            got = ssd_scan_bwd(*args, h_prev, dy, None, chunk=case[-1])
            hp32 = ssd_chunked_ref(*args, chunk=case[-1], return_states=True)[2]
            ref32 = ssd_chunked_bwd_ref(*args, hp32, dy, None, chunk=case[-1])
            a64 = [a.double() for a in args]
            hp64 = ssd_chunked_ref(*a64, chunk=case[-1], return_states=True)[2]
            ref64 = ssd_chunked_bwd_ref(*a64, hp64, dy.double(), None, chunk=case[-1])

            def rel(a, r):
                return ((a.double() - r.double()).abs().max() / r.double().abs().max()).item()
            print(f"{label} {case} {dname}: " + "; ".join(
                f"{n} {rel(k, r32):.2e} / {rel(k, r64):.2e} / {rel(r32, r64):.2e}"
                for n, k, r32, r64 in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, ref32,
                                          ref64)) + "  (kernel vs fp32 plain / vs float64 / "
                  "fp32 plain vs float64)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
