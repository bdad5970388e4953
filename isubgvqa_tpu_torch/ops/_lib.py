"""Build and load the port's CUDA kernel library.

The sources under ``isubgvqa_tpu_torch/csrc/`` compile with ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, loaded
with :mod:`ctypes` (no PyTorch headers, so a build takes seconds).  The
build happens on first use, into ``isubgvqa_tpu_torch/_build/``, and
again whenever a hash of the sources changes.  Each ``.cu`` file is
compiled by its own ``nvcc`` process, all started together, then linked.

Nothing here runs at import time: the CPU tests import every module of
the port on machines with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None     # wall time of the last build
build_log: str = ""                       # nvcc output of the last build

P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
_SIGNATURES = {
    "isg_gemm": [P, P, I, I] * 3 + [I, P, I, P, P, P, P, P, I, I, I, I, I,
                                    I, P],
    "isg_gemm_gather": [P, P, I, I] * 3 + [I, P, I, P, P, P, P, P, I, I, I,
                                           I, P],
    "isg_gemm_sm90": [P, I, P, I, P, P, P, I, I, I, I, I, P],
    "isg_gemm_ln_sm90": [P, I, P, I, P, P, I] + [P] * 8 + [I, I, I, I, F, P],
    "isg_gemm_any": [P, I, I, P, P, I, I, P, I, I, I, I, I, P, P, I, P],
    "isg_gemm_bwd": [ctypes.c_char_p, I, I, P],
    "isg_reduce_rows": [P, P, I, I, I, I, I, P],
    "isg_colsum": [P, I, I, I, P, I, P, I, P],
    "isg_attention": [P, I, P, I, P, I, P, P, P, P, I, I, I, I, I, I, F, I,
                      P],
    "isg_attention_mma": [P, I, P, I, P, I, P, P, P, P, I, I, I, I, I, F,
                          P],
    "isg_attention_bwd": [P, I, P, I, P, I, P, P, P, I, P, I, P, I, P, I, I,
                          I, I, I, I, F, I, P],
    "isg_residual_ln": [P, I, P, P, P, P, P, P, P, P, P, I, I, I, F, P],
    "isg_ln_bwd": [P, I, P, P, P, P, P, P, P, P, I, I, I, F, P],
    "isg_relu_bwd": [P, P, I, P, P, L, P],
    "isg_scatter_mean": [P, P, P, P, I, I, I, I, I, P],
    "isg_graph_index": [P, P, P, P, P, I, I, I, P],
    "isg_scatter_mean_bwd": [P, P, P, P, I, I, I, I, P],
    "isg_scatter_rows": [P, P, P, P, P, P, P, I, I, I, I, I, P],
    "isg_graph_norm": [P, P, P, P, P, I, P, P, P, P, I, I, I, I, F, P],
    "isg_graph_norm_bwd": [P, I, P, P, P, P, P, P, I, I, I, F, P],
    "isg_instr_gelu": [P, P, P, I, I, I, I, P],
    "isg_gat_edge": [P, P, I, P, I, P, P, P, P, P, P, P, P, I, I, I, I, I,
                     P],
    "isg_gat_edge_train": [P, P, P, I, P, P, P, P, P, P, P, P, I, I, I, I, I,
                           P],
    "isg_gat_edge_bwd": [P, P, P, I] + [P] * 13 + [I] * 6 + [P],
}


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libisg-{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library for the current sources is
    missing; returns its path.  ``verbose`` adds ``-Xptxas -v`` (register
    and shared-memory use per kernel) to :data:`build_log`."""
    global build_seconds, build_log
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cus = [p for p in _sources() if p.endswith(".cu")]
        objs = [os.path.join(tmp, os.path.basename(p) + ".o") for p in cus]
        procs = [subprocess.Popen([nvcc, *flags, "-I", CSRC, "-c", src,
                                   "-o", obj],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(cus, objs)]
        logs = []
        failed = []
        for src, p in zip(cus, procs):
            text, _ = p.communicate()
            logs.append(f"== {os.path.basename(src)}\n{text}")
            if p.returncode != 0:
                failed.append(src)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, "-shared", *objs, "-o", tmp_lib],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


_INVALID_VALUE = 1          # cudaErrorInvalidValue: arguments refused


def call(name: str, *args, invalid: Optional[str] = None) -> None:
    """Launch ``name`` on the current stream; raise on a CUDA error (a
    ``ValueError`` saying ``invalid`` where the kernel refused its
    arguments and the caller gave the reason)."""
    # the current stream's raw handle: torch.cuda.current_stream() builds
    # a Stream object first, several microseconds of host time a launch
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    err = getattr(_lib or lib(), name)(*args, stream)
    if err != 0:
        if err == _INVALID_VALUE and invalid:
            raise ValueError(f"{name}: {invalid}")
        raise RuntimeError(f"{name} failed with CUDA error {err}")


def dt(t: torch.Tensor) -> int:
    """Dtype code of the C interface: 0 float32, 1 bfloat16."""
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


MAX_ELEMENTS = 2 ** 31 - 1   # the kernels' element offsets are 32-bit


def check_cuda(*tensors) -> None:
    """Every tensor lies on the card, is contiguous and has fewer than
    2^31 elements (a larger one would wrap a 32-bit element offset)."""
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError("mixed devices: expected a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError("kernels take contiguous tensors")
        if t.numel() > MAX_ELEMENTS:
            raise ValueError(f"kernels take tensors under 2^31 elements, "
                             f"got {tuple(t.shape)}")
