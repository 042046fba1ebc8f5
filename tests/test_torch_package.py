"""Rules the port's package keeps: it imports neither JAX nor cutie_tpu,
chip_smoke.py imports neither those nor tools/, no module-level import of
the JAX package's optional dependencies (PIL, cv2, yaml), and the CUDA
sources include no PyTorch header (a plain-C library built by nvcc in
seconds, not torch.utils.cpp_extension)."""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

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
    assert sources
    for src in sources:
        text = src.read_text()
        for header in ("torch/", "ATen/", "c10/", "pybind11"):
            assert f"#include <{header}" not in text, (src, header)
        assert 'extern "C"' in text
    for path in PY_FILES:
        assert "cpp_extension" not in path.read_text(), path
