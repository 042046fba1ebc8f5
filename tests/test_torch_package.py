"""Rules the port's package keeps: it imports neither JAX nor cutie_tpu,
chip_smoke.py imports neither those nor tools/, no module-level import of
the JAX package's optional dependencies (PIL, cv2, yaml), and the CUDA
sources include no PyTorch header (a plain-C library built by nvcc in
seconds, not torch.utils.cpp_extension)."""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "cutie_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cutie_tpu", "tools")
NOT_AT_MODULE_LEVEL = ("PIL", "cv2", "yaml")


def _imports(path: Path):
    """(top-level module name, is at module level) for every import."""
    tree = ast.parse(path.read_text())
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0], id(node) in top


PY_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", PY_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports(path):
    for name, module_level in _imports(path):
        assert name not in FORBIDDEN, f"{path} imports {name}"
        if module_level:
            assert name not in NOT_AT_MODULE_LEVEL, f"{path} imports {name}"


def test_cuda_sources_are_plain_c():
    sources = sorted((PORT / "csrc").glob("*.cu*"))
    names = {src.name for src in sources}
    assert {"radix_topk_readout.cu", "fused_topk_readout.cu",
            "read_common.cuh"} <= names, names
    for src in sources:
        text = src.read_text()
        for header in ("torch/", "ATen/", "c10/", "pybind11"):
            assert f"#include <{header}" not in text, (src, header)
        if src.suffix == ".cu":
            # a library of its own with a plain-C interface, sharing the
            # similarity and order key of both kernels
            assert 'extern "C"' in text, src
            assert '#include "read_common.cuh"' in text, src
    for path in PY_FILES:
        assert "cpp_extension" not in path.read_text(), path


def test_chip_smoke_imports_nothing_of_cutie_tpu():
    imported = {name for name, _ in _imports(REPO / "chip_smoke.py")}
    assert not imported & {"jax", "jaxlib", "flax", "cutie_tpu", "tools"}, imported
    assert "cutie_tpu_torch" in imported


def test_build_key_covers_every_csrc_file(tmp_path, monkeypatch):
    """A change to any file under csrc/, the shared header included, gives
    every library a new name, so each is rebuilt."""
    import shutil

    from cutie_tpu_torch.ops import cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(PORT / "csrc", csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    sources = ("radix_topk_readout.cu", "fused_topk_readout.cu")
    before = {s: cuda_build.library_path(s).name for s in sources}
    assert len(set(before.values())) == 2
    header = csrc / "read_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: cuda_build.library_path(s).name for s in sources}
    assert all(before[s] != after[s] for s in sources), (before, after)
