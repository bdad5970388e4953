"""Import hygiene of the port: no module of ``isubgvqa_tpu_torch/`` and
not ``chip_smoke.py`` imports JAX, Flax, Optax, Orbax or the JAX package
(whose ``__init__`` pulls in jax), and every port module imports on a
machine without CUDA."""

import ast
import importlib
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "isubgvqa_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "isubgvqa_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_every_port_module_imports_without_cuda():
    pkg = importlib.import_module("isubgvqa_tpu_torch")
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   "isubgvqa_tpu_torch.")]
    assert "isubgvqa_tpu_torch.ops.gat_kernel" in names
    for name in names:
        importlib.import_module(name)


def test_port_modules_import_without_loading_jax():
    """Importing every module of the port (the training ones included)
    in a fresh interpreter leaves ``jax`` and the JAX package out of
    ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import isubgvqa_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'isubgvqa_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'isubgvqa_tpu_torch.train.steps' in names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)
