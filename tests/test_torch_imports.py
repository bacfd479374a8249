"""The port stands alone: celestia_tpu_torch and chip_smoke.py import
neither jax nor any module of celestia_tpu, and no entry runs on the CPU
unless asked to."""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from celestia_tpu_torch import da, device
from celestia_tpu_torch.ops import extend

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "celestia_tpu_torch"


def _forbidden(module: str) -> bool:
    """jax, jaxlib and celestia_tpu with their submodules — not
    celestia_tpu_torch, whose name starts with the same letters."""
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "celestia_tpu")


def test_forbidden_matches_exact_package_names():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert _forbidden("celestia_tpu") and _forbidden("celestia_tpu.ops.rs_tpu")
    assert not _forbidden("celestia_tpu_torch")
    assert not _forbidden("celestia_tpu_torch.ops.extend")


def test_importing_every_module_loads_no_jax_and_no_celestia_tpu():
    script = (
        "import importlib, json, pkgutil, sys\n"
        "import celestia_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "celestia_tpu_torch.__path__, 'celestia_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps({'modules': names, 'loaded': sorted(sys.modules)}))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert "celestia_tpu_torch.ops.extend" in doc["modules"]
    assert "celestia_tpu_torch.da" in doc["modules"]
    bad = [m for m in doc["loaded"] if _forbidden(m)]
    assert not bad, f"the port loaded {bad}"


def _imports(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_no_source_file_imports_jax_or_celestia_tpu():
    build = PACKAGE / "_build"  # generated at run time, not source
    files = [p for p in sorted(PACKAGE.rglob("*.py")) if build not in p.parents]
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        bad = [n for n in _imports(path) if _forbidden(n)]
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"


SQUARE = np.zeros((1, 1, 512), np.uint8)
EDS = np.zeros((2, 2, 512), np.uint8)
ENTRIES = {
    "resolve": lambda: device.resolve(None),
    "roots_device": lambda: extend.roots_device(SQUARE),
    "extend_roots_device": lambda: extend.extend_roots_device(SQUARE),
    "extend_roots_device_resident": lambda: extend.extend_roots_device_resident(SQUARE),
    "extend_and_root_device": lambda: extend.extend_and_root_device(SQUARE),
    "eds_roots_device": lambda: extend.eds_roots_device(EDS),
    "eds_row_levels_device": lambda: extend.eds_row_levels_device(EDS),
    "extend_shares": lambda: da.extend_shares(SQUARE.reshape(1, 512)),
    "min_data_availability_header": lambda: da.min_data_availability_header(),
}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entries_refuse_to_fall_back_to_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device, so device=None is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRIES[name]()


def test_resolve_gives_the_cpu_only_when_asked():
    assert device.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device.resolve("meta")
