"""The port's CUDA build on the CPU: no nvcc runs here, only the naming of
the libraries, which decides when a source is rebuilt."""
import shutil
import tempfile
from pathlib import Path

from repro_torch.kernels import _build


def test_an_edited_header_changes_the_library():
    """A library is named by every file of its source's csrc/ directory and
    of kernels/common/: editing the shared header (hopper.cuh, which both
    sources include) gives both libraries other names (a rebuild), editing
    a file of one source's csrc/ renames that library only, an unchanged
    tree keeps the names."""
    srcs = {s.stem: s for s in _build.sources()}
    assert {"flash_attention", "ssd_scan"} <= set(srcs)
    with tempfile.TemporaryDirectory() as tmp:
        common = Path(tmp) / "common"
        shutil.copytree(_build.COMMON_DIR, common)
        copies = {}
        for name in ("flash_attention", "ssd_scan"):
            csrc = Path(tmp) / name / "csrc"
            shutil.copytree(srcs[name].parent, csrc)
            copies[name] = csrc / srcs[name].name

        def names():
            return {k: _build._lib_path(p, common) for k, p in copies.items()}
        before = names()
        assert before == {k: _build._lib_path(srcs[k]) for k in copies}
        header = common / "hopper.cuh"
        header.write_text(header.read_text() + "\n// edited\n")
        shared = names()
        for k in copies:
            assert shared[k] != before[k], k
            assert shared[k].name.startswith(k + "-")
        own = copies["ssd_scan"].parent / "ssd_scan.cu"
        own.write_text(own.read_text() + "\n// edited\n")
        after = names()
        assert after["flash_attention"] == shared["flash_attention"]
        assert after["ssd_scan"] != shared["ssd_scan"]
        (Path(tmp) / "unrelated.txt").write_text("outside csrc/ and common/")
        assert names() == after
