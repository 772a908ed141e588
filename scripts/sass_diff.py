#!/usr/bin/env python3
"""Compare the SASS of two versions of a CUDA source, kernel by kernel.

    python3 scripts/sass_diff.py A.cu B.cu [--sub PATTERN REPLACEMENT ...]

Compiles both with the port's nvcc flags (`repro_torch.kernels._build`),
in parallel, into a temporary directory, disassembles each with
`cuobjdump -sass` and names each kernel by its demangled name without the
parameter list (`cu++filt` writes a template's parameter types as T1, T2,
...). Each `--sub` is a regular-expression substitution applied to those
names on both sides, so that a kernel whose template parameters were
renamed or dropped is matched with its old self (for example
`--sub '(flash_tf32_bwd_\\w+)<float, ' '\\1<'`). Prints, for every kernel
the two have in common, "same" when their SASS text (instructions and
encodings) is identical line for line, else the count of lines that
differ; then the kernels that only one side has. Exits 1 when a common
kernel differs. Needs the CUDA toolkit, not a card.
"""
import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def without_params(name):
    """A demangled function name without its trailing parameter list."""
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i] if name.endswith(")") else name
    return name


def sass_by_kernel(lib, tooldir, subs):
    """{demangled, substituted kernel name: [SASS lines]} of a library."""
    sass = subprocess.run([str(tooldir / "cuobjdump"), "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=600).stdout
    blocks, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            blocks[name] = []
        elif name is not None and line.strip():
            blocks[name].append(line.strip())
    mangled = list(blocks)
    names = subprocess.run([str(tooldir / "cu++filt")], input="\n".join(mangled), check=True,
                           capture_output=True, text=True, timeout=60).stdout.splitlines()
    out = {}
    for m, n in zip(mangled, names):
        n = without_params(n)
        for pat, rep in subs:
            n = re.sub(pat, rep, n)
        out[n] = blocks[m]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--sub", nargs=2, action="append", default=[],
                    metavar=("PATTERN", "REPLACEMENT"))
    args = ap.parse_args()
    from repro_torch.kernels import _build
    nvcc = Path(_build.nvcc())
    with tempfile.TemporaryDirectory() as tmp:
        libs = [Path(tmp) / f"{side}.so" for side in ("a", "b")]
        procs = [subprocess.Popen([str(nvcc), *_build.NVCC_FLAGS, "-o", str(lib), str(src)])
                 for lib, src in zip(libs, (args.a, args.b))]
        if any(p.wait() for p in procs):
            print("sass_diff: nvcc failed", file=sys.stderr)
            return 2
        a, b = (sass_by_kernel(lib, nvcc.parent, args.sub) for lib in libs)
    differ = 0
    for name in sorted(set(a) & set(b)):
        n = sum(x != y for x, y in zip(a[name], b[name])) + abs(len(a[name]) - len(b[name]))
        differ += n > 0
        print(f"{'same' if n == 0 else f'{n} lines differ'}: {name} ({len(b[name])} lines)")
    for side, mine, other in (("a", a, b), ("b", b, a)):
        for name in sorted(set(mine) - set(other)):
            print(f"only in {side}: {name}")
    print(f"{len(set(a) & set(b))} kernels in common, {differ} differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
