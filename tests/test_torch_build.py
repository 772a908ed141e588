"""The port's CUDA build on the CPU: no nvcc runs here, only the naming of
the libraries, which decides when a source is rebuilt."""
import shutil
import tempfile
from pathlib import Path

from repro_torch.kernels import _build


def test_an_edited_header_changes_the_library():
    """A library is named by every file of its source's csrc/ directory:
    editing a header that the source includes gives another library (a
    rebuild), an unchanged tree the same one."""
    src = next(s for s in _build.sources() if s.stem == "flash_attention")
    with tempfile.TemporaryDirectory() as tmp:
        csrc = Path(tmp) / "flash_attention" / "csrc"
        shutil.copytree(src.parent, csrc)
        copy = csrc / src.name
        assert _build._lib_path(copy) == _build._lib_path(src)
        header = csrc / "hopper.cuh"
        header.write_text(header.read_text() + "\n// edited\n")
        edited = _build._lib_path(copy)
        assert edited != _build._lib_path(src)
        assert edited.name.startswith("flash_attention-")
        (Path(tmp) / "unrelated.txt").write_text("outside csrc/")
        assert _build._lib_path(copy) == edited
