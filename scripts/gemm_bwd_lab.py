#!/usr/bin/env python3
"""Lab measurements of the staged backward GEMM of the PyTorch port
(``isubgvqa_tpu_torch/csrc/gemm_bwd.cu``, bf16x3 core) on one NVIDIA H100.

    python3 scripts/gemm_bwd_lab.py

Builds the port's library and, beside it, variants of ``gemm_bwd.cu`` with
one part of the kernel taken out (each a separate shared library loaded in
place of the library's ``isg_gemm_bwd``; a variant computes garbage, only
its time counts), and times each on three problems of the MetaLayer's and
the decoder layer's backward (CUDA events, median of 10, after 3 warm-up
calls):

* ``as built``;
* ``no wgmma``: the products taken out;
* ``no S copies``: S's ``cp.async`` copies taken out;
* ``no G planes``: G's loads and the planes' split and stores taken out;
* ``products only``: all three loads and conversions taken out;
* ``no fresh tile``: each slice's products accumulated straight into the
  running sum (with its error against f64 at K = 98,304, beside the
  built kernel's).

Then the rate of bare ``wgmma`` chains (``scripts/wgmma_rate.cu``).  Prints
the card's name and power limit first.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def replace(code: str, old: str, new: str) -> str:
    if old not in code:
        raise SystemExit(f"gemm_bwd_lab: the kernel source no longer holds "
                         f"{old[:60]!r}; update the variant")
    return code.replace(old, new)


def variants(src: str) -> dict:
    wgmma = """        wgmma_m64n152k16<1>(
            fresh, wgmma_desc(a + p * X_PLANE + kk * 32),
            wgmma_desc_mn(b + kk * 16 * 128, X_MN_LBO, X_MN_SBO),
            p == 2 && kk == 0 ? 0 : 1);"""
    copies = ("    if (n < P.N) {\n      const BwdSeg& g",
              "    if (false) {\n      const BwdSeg& g")
    planes = [("      write_planes(P, planes_g + (pb ^ 1) * X_PLANES, gv);\n",
               ""),
              ("    if (kt + 2 < KT) load_g(P, m0, kbeg + (kt + 2) * XBK, "
               "kend, gv);\n", "")]
    no_copies = replace(src, *copies)
    no_planes = src
    for old, new in planes:
        no_planes = replace(no_planes, old, new)
    only = no_copies
    for old, new in planes:
        only = replace(only, old, new)
    start = src.index("    wgmma_fence();\n    fence_regs(fresh);")
    end = src.index("    __syncthreads();                // stage s and planes pb")
    loop = src[start:end]
    no_fresh = src.replace(loop, replace(
        loop.replace("fresh", "acc").replace(
            "p == 2 && kk == 0 ? 0 : 1",
            "kt == 0 && p == 2 && kk == 0 ? 0 : 1"),
        "#pragma unroll\n    for (int i = 0; i < XWN / 2; ++i) acc[i] += "
        "acc[i];\n", ""))
    return {"no wgmma": replace(src, wgmma, "        fresh[kk] += 1.f;"),
            "no S copies": no_copies, "no G planes": no_planes,
            "products only": only, "no fresh tile": no_fresh}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gemm_bwd_lab: no CUDA device", file=sys.stderr)
        return 2
    from isubgvqa_tpu_torch.ops import _lib, gemm
    from isubgvqa_tpu_torch.ops.gemm import Out, stage_dgrad, stage_wgrad

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    built = _lib.lib()
    src = open(os.path.join(_lib.CSRC, "gemm_bwd.cu")).read()
    tmp = tempfile.mkdtemp(prefix="gemm_bwd_lab")
    libs = {}
    procs = {}
    for name, code in variants(src).items():
        path = os.path.join(tmp, name.replace(" ", "_"))
        with open(path + ".cu", "w") as f:
            f.write(code)
        procs[name] = (path, subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", _lib.CSRC, "-shared",
             "-o", path + ".so", path + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for name, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"gemm_bwd_lab: {name} did not build:\n{out}")
        handle = ctypes.CDLL(path + ".so")
        fn = handle.isg_gemm_bwd
        fn.argtypes = _lib._SIGNATURES["isg_gemm_bwd"]
        fn.restype = ctypes.c_int
        libs[name] = type("Variant", (), {"isg_gemm_bwd": fn})()

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)
    e = 256 * 384
    g1, w1 = rnd(e, 300), rnd(300, 300).bfloat16()
    x1 = rnd(e, 300).bfloat16()
    o1 = torch.empty(e, 300, device=dev)
    dw, db = torch.empty(300, 300, device=dev), torch.empty(300, device=dev)
    g2, w2 = rnd(8192, 2048), rnd(2048, 512).bfloat16()
    o2 = torch.empty(8192, 512, device=dev)
    cases = {
        "dgrad [98304, 300] x [300, 300]": (
            2.0 * e * 300 * 300,
            lambda: gemm.bwd_stage(stage_dgrad(g1, w1, [Out(o1)]))),
        "wgrad [300, 98304] x [98304, 300] + bias": (
            2.0 * e * 300 * 300,
            lambda: gemm.bwd_stage(stage_wgrad(g1, [(x1, None)], dw, db))),
        "dgrad [8192, 2048] x [2048, 512]": (
            2.0 * 8192 * 2048 * 512,
            lambda: gemm.bwd_stage(stage_dgrad(g2, w2, [Out(o2)]))),
    }

    def time_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    ga = torch.Generator(device=dev).manual_seed(7)
    a = torch.rand(e, 64, device=dev, generator=ga)
    xb = torch.rand(e, 40, device=dev, generator=ga).bfloat16()
    want = a.double().t() @ xb.double()
    for name, lib in [("as built", built)] + list(libs.items()):
        _lib._lib = lib
        for case, (flop, fn) in cases.items():
            ms = time_ms(fn)
            print(f"{name}: {case}: {ms:.4f} ms, {flop / ms / 1e9:.1f} "
                  f"TFLOP/s effective", flush=True)
        if name in ("as built", "no fresh tile"):
            out = torch.empty(64, 40, device=dev)
            gemm.bwd_stage(stage_wgrad(a, [(xb, None)], out))
            err = ((out.double() - want).abs().max()
                   / want.abs().max()).item()
            print(f"{name}: K = {e} same-sign product against f64: "
                  f"{err:.3g} of its max abs", flush=True)
    _lib._lib = built

    rate = os.path.join(tmp, "wgmma_rate")
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", _lib.CSRC,
                    "-shared", "-o", rate + ".so",
                    os.path.join(ROOT, "scripts", "wgmma_rate.cu")],
                   check=True)
    res = (ctypes.c_float * 6)()
    iters = 20000
    err = ctypes.CDLL(rate + ".so").wgbench(res, iters)
    if err:
        raise SystemExit(f"gemm_bwd_lab: wgmma_rate failed ({err})")
    for i, (n, wait) in enumerate([(128, 0), (152, 0), (256, 0), (128, 1),
                                   (152, 1), (256, 1)]):
        flop = 2.0 * 64 * n * 16 * 12 * iters * 2 * 132
        print(f"wgmma m64n{n}k16 chains of 12, wait_group {wait}: "
              f"{res[i]:.3f} ms, {flop / res[i] / 1e9:.1f} TFLOP/s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
