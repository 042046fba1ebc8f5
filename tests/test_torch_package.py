"""Rules the port's package keeps: it imports neither JAX nor cutie_tpu,
chip_smoke.py imports neither those nor tools/, no module-level import of
the JAX package's optional dependencies (PIL, cv2, hickle, yaml), checked in
the source and by importing every module with them blocked, and the CUDA
sources include no PyTorch header (a plain-C library built by nvcc in
seconds, not torch.utils.cpp_extension)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "cutie_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cutie_tpu", "tools")
NOT_AT_MODULE_LEVEL = ("PIL", "cv2", "hickle", "yaml")


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


def test_every_module_imports_without_optional_packages():
    """A fresh interpreter with PIL, cv2, hickle and yaml blocked (None in
    sys.modules, so that importing them raises) imports every module of the
    port and chip_smoke.py: the card's machine has none of them."""
    modules = [".".join(p.relative_to(REPO).with_suffix("").parts)
               for p in PY_FILES]
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = (f"import importlib, sys\n"
            f"sys.modules.update(dict.fromkeys({NOT_AT_MODULE_LEVEL!r}))\n"
            f"for name in {modules!r}:\n"
            f"    importlib.import_module(name)\n"
            f"print(len({modules!r}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, timeout=300,
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == str(len(modules))
    assert {"cutie_tpu_torch.eval_vos", "cutie_tpu_torch.scripting_demo",
            "cutie_tpu_torch.utils.results", "chip_smoke",
            "cutie_tpu_torch.train", "cutie_tpu_torch.models.aux_modules",
            "cutie_tpu_torch.ops.point_features",
            "cutie_tpu_torch.training.losses",
            "cutie_tpu_torch.training.train_forward",
            "cutie_tpu_torch.training.trainer",
            "cutie_tpu_torch.utils.log_integrator", "cutie_tpu_torch.utils.logger",
            "cutie_tpu_torch.utils.time_estimator",
            "cutie_tpu_torch.utils.image_saver", "cutie_tpu_torch.data.augment",
            "cutie_tpu_torch.data.static_dataset", "cutie_tpu_torch.data.vos_dataset",
            "cutie_tpu_torch.data.loader", "cutie_tpu_torch.data.setup_training_data",
            "cutie_tpu_torch.scripts.convert_burst_to_vos_train",
            "cutie_tpu_torch.ritm.utils", "cutie_tpu_torch.ritm.brs"} <= set(modules)


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
