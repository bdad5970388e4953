"""Compile-on-first-use loader of the port's native (C++) host code.

``csrc/<name>.cpp`` compiles with ``g++ -O3 -std=c++17 -shared -fPIC``
the first time it is asked for, into ``isubgvqa_tpu_torch/_build/`` under
a name that carries a hash of the source, and loads through
:mod:`ctypes`.  The shared object is written under a temporary name and
renamed into place, so several processes (pytest's workers, a
``torchrun`` job's ranks) that build at once race harmlessly.

There is no silent fallback: a failed build or a failed ``dlopen``
raises :class:`NativeBuildError` with the compiler's output.  The one
switch to the Python fill is ``ISUBGVQA_NATIVE=0`` (or ``false`` /
``off``), the JAX package's own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


class NativeBuildError(RuntimeError):
    """The native source did not compile or its library did not load."""


def native_disabled() -> bool:
    """``ISUBGVQA_NATIVE=0`` selects the Python fill."""
    return os.environ.get("ISUBGVQA_NATIVE", "1").lower() in (
        "0", "false", "off")


def build_and_load(name: str) -> Optional[ctypes.CDLL]:
    """Compile ``csrc/<name>.cpp`` unless its hash-named library is
    built, and load it; ``None`` when ``ISUBGVQA_NATIVE=0``.  Raises
    :class:`NativeBuildError` when the compiler fails or is missing, or
    the library does not load."""
    if native_disabled():
        return None
    src_path = os.path.join(CSRC, f"{name}.cpp")
    with open(src_path, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"{name}-{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [CXX, *CXX_FLAGS, "-o", tmp, src_path]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except (OSError, subprocess.SubprocessError) as exc:
            err = (getattr(exc, "stderr", b"") or b"").decode(
                errors="replace")
            raise NativeBuildError(
                f"building {src_path} failed ({' '.join(cmd)}): {exc}\n"
                f"{err}") from exc
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    try:
        return ctypes.CDLL(so_path)
    except OSError as exc:
        raise NativeBuildError(f"loading {so_path} failed: {exc}") from exc
