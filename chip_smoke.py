#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``isubgvqa_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure raises and the
script exits non-zero):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the CUDA kernels from ``isubgvqa_tpu_torch/csrc/``, with
   ptxas's registers and spills of every kernel;
3. kernels: each of the four fused layers against its plain PyTorch
   version on the card, at the main path's shapes (every node bucket for
   the graph layers, L = 16 and 32 for the text layers), in f32 (TF32
   off) and bf16, with timings, the bound, the attention core against
   ``F.scaled_dot_product_attention``, each text layer (bf16, no final
   LayerNorm) against the one PyTorch call that computes it
   (``nn.Transformer{Encoder,Decoder}Layer``, the MHA fast path off), and
   device time by kernel at the largest shapes with the layers' products'
   effective TFLOP/s on the Hopper GEMMs (``gemm_sm90`` for the text
   layers, ``gemm_gather`` for the graph layers) and the port's launches
   per call; the graph layers' bf16 products on the graph-layer GEMM
   alone, each against its plain twin (the MetaLayer's three-segment
   gathered product among them), timed beside ``F.linear`` (cuBLAS) on
   the same operands with the gathered rows made beforehand;
4. serving: ``Predictor.predict`` at the full width of the config of
   record (gumbel, k = 3, masks (1, 1, 1, 0.15), bf16, seeded random
   weights) on 64 questions of the GQA-like synthetic mix, then the same
   call under the profiler (device busy share, time by kernel);
5. whole forward: kernel path against plain path on one batch, same
   weights and noise, f32 (and the bf16 top-1 agreement);
6. launch counts of the serving run;
7. train kernels: each of the four training layers (GAT conv, MetaLayer,
   encoder and decoder layer), forward and backward, against autograd of
   its plain version at the training path's shapes (B = 256 graphs at
   (N, E) = (16, 64) and (128, 384); B = 256 questions at L = 16 and 32),
   in f32 (TF32 off) and bf16, with fwd+bwd timings, the bound, the
   port's attention core forward+backward beside SDPA's on the same q,
   k, v, bias and cotangent, the text layers' fwd+bwd beside the
   ``nn.Transformer{Encoder,Decoder}Layer`` call's (bf16), and device
   time by kernel at the largest shapes with the backward GEMMs'
   effective TFLOP/s (``gemm_any`` for the GAT conv and the encoder
   layer, the staged ``gemm_bwd`` for the MetaLayer and the decoder
   layer) and, for the MetaLayer and the decoder layer, the CUDA kernels
   of one forward and of one backward; both backward GEMMs (and the
   staged one's bias column) against an f64 product at the main path's
   longest reduction; each staged backward launch of the MetaLayer and
   the decoder layer against its plain twin at their largest shapes, f32
   and bf16; and, for the f32 encoder layer at L = 32, the FFN
   pre-activations whose sign differs between the kernel's and the plain
   forward with ``linear1``'s gradient error over the units that hold no
   flip;
8. training: ``train_step`` of the full-width config of record (bf16,
   dropouts on) at batch 256 on the GQA-like synthetic mix through the
   bucketed collators, one warm-up step and 5 counted steps over two
   node buckets, each step's loss, grad norm and ms, launches per step
   and direction, and one profiled step (device time by kernel, busy
   share);
9. train step, kernels against plain: one f32 step on one batch through
   both paths from the same weights, masks and noise (loss, grad norm,
   node mask, every gradient), and the same in bf16 (loss, grad norm);
10. bench: the port's bench (``isubgvqa_tpu_torch.bench``) as its users
    run it: first the whole forward, kernel path against plain path, on
    one B = 2048 batch of the (128, 32) bucket (f32: logits within 1e-4,
    node mask identical; bf16: no top-1 disagreement where the plain
    path's margin exceeds twice the logit difference); then
    ``bench_inference`` at B = 2048 over all eight buckets (at least 4
    timed batches each; one more chunk of each profiled for the device's
    busy share and time by kernel), one epoch of ``bench_e2e`` and
    ``bench_train_step`` at 256, each result's JSON and the launch counts
    of its run (every kernel of the path at least once), the host's
    waits on the device in one forward and one train step, and the
    phase's seconds;
11. samplers: for each of imle, aimle and simple, at the full width of
    the config of record with only ``sampler_type`` changed: (a)
    ``Predictor.predict`` on 64 questions (bf16; aimle's state
    untouched); (b) the whole eval forward, kernel path against plain
    path, same weights and noise, on one B = 256 batch of the largest
    bucket (f32: logits within 1e-4, node mask identical; bf16: logits
    within 1e-2, top-1 agreement at least 99.5 %); (c) one f32 train
    step, kernel path against plain path, from the same weights, masks
    and noise under phase 9's bounds, and for aimle the three state
    tensors after the step within 1e-6 (both paths start at beta 5); (d)
    the host's waits on the device in one train step, no more than
    gumbel's in phase 10; (e) ``bench_inference`` at B = 2048 and
    ``bench_train_step`` at 256 (fewer timed chunks than phase 10: a
    fixture of 4 x 2048 samples), each with its launch counts (all four
    eval kernels, all four training kernels); then the sampler alone
    (eval at 2048, forward + backward at 256, each node cap) and its
    share of the bench's batch and step; last, simple's marginals DP
    alone (the log-depth scan beside the step-by-step DP) and its share;
12. entry points: at the full width of the config of record (gumbel,
    bf16, batch 256, the GQA-like synthetic mix of 4,096 training
    questions, 8 or more steps an epoch over two or more node buckets),
    ``isubgvqa_tpu_torch.cli.main`` trains 2 epochs (finite losses, the
    checkpoints the policy writes), resumes from ``checkpoint`` for a
    third (it starts at epoch 2 with the optimizer's count restored: the
    printed learning rate is the schedule's at that count), and validates
    ``checkpoint_lowest_val_loss`` with ``-e``; the ``run_token_coo``
    entry explains 4 batches and prints the five metric lines; their
    launch counts (every kernel at least once).  Then the Trainer's
    checkpoint through ``Predictor.from_checkpoint`` against the Trainer's
    model in f32 on one batch with the same noise (logits within 1e-6,
    node mask identical); an epoch's wall time, ms a step, the host's
    waits a step (at most 3 ``cudaStreamSynchronize``) and the validation
    rate; ``run_token_coo_exp`` in f32 with the imle sampler through the
    kernels and through the plain versions (equal sums; the smallest
    top-1 logit gap beside the largest logit difference); the explain
    bench at B = 2048 (8,192 dev questions) and the device's busy share
    of one profiled explain batch;
13. config variants: each of ``use_all_instrs``, ``concat_instr``,
    ``use_global_mask``, ``interpretable_mode``, ``node_classification``,
    ``use_topk`` off, masks (0.3, 1, 0.5, 0.15), ``text_sampling`` and
    ``use_instruction`` off, at the full width of the config of record
    with only its own fields changed (bf16, seeded random weights),
    serves 256 questions of the GQA-like mix through ``Predictor``; then
    its eval forward through the kernels against the plain versions on
    the same questions and noise (f32: logits within 1e-5, node mask and
    ``mask_text`` identical; bf16: the top-1 agreement); the explainer
    bypass at stages 0 and 2 likewise; ``concat_instr``,
    ``interpretable_mode`` and ``text_sampling`` each take one bf16 train
    step at 256 through ``make_train_step`` and one f32 step kernel
    against plain (all gradients within 1.4e-4 of their RMS);
    ``run_token_coo_exp`` explains 8 batches under ``text_sampling``
    (five metric lines; the commonest of 8 answers lifted so that the
    text co-occurrence is counted; every sum equal to the per-sample
    oracle's); the launch counts of these paths (every kernel at least
    once, each counted from 0 just before its call); last #1 with
    ``apply_mask_to_h`` and a 600-wide input and #5 forward + backward
    at a 600-wide input, against their plain versions in f32 and bf16,
    timed beside their bounds (#5's f32 gradients also against an f64
    evaluation, with the leaky-ReLU inputs whose sign differs counted),
    and #1's x_l / x_r product with ``[h | instr]`` built against read as
    two GEMM segments;
14. the native collate fill and data parallelism: over the bench's mix
    (22 x 2048 samples, 8 buckets) every batch of the native C++ fill
    equals the Python fill's (``ISUBGVQA_NATIVE=0``) bit for bit,
    truncation counts included, and lies in pinned memory; each fill's
    rate; ``bench_e2e`` (the median of 3 epochs) with each fill beside
    ``bench_inference`` in the same run; serving 64 questions with each
    fill, in turns (wall, the device's busy share); ``cli.main`` trains
    an epoch of 2,048 questions at 256 without a process group, then that
    Trainer's epoch with each fill (ms a step, host waits a step) and a
    train step without and with a one-rank NCCL group, each profiled
    once; last ``torchrun --standalone --nproc_per_node=1 -m
    isubgvqa_tpu_torch.cli`` with the same flags (NCCL), whose metric
    lines and checkpoint equal the run without a group's (bitwise, or
    within ``DDP_ATOL``), beside a second run without a group;
15. checkpoints (the port's half of the JAX -> port bridge; this
    machine has no JAX): the seeded full-width training model's state
    through ``convert.state_dict_to_jax`` and, with seeded Adam moments,
    count 37 and step 41, through ``convert.train_payload_from_jax`` into
    a file beside its meta; ``Trainer.resume`` on the card reads every
    weight, moment and count back bitwise, then three steps at 256
    (finite, the count 37 to 40, each step's ms); ``Predictor.
    from_checkpoint`` of the file serves 64 questions bitwise equal to a
    ``Predictor`` of the source state dict; the same weights as an
    upstream ``.pth``, the answer head's bias lifted at the four most
    frequent dev answers so that the report's metrics count some right
    answers, load
    with no config (derived from its ``args``, equal to the source's
    field by field) and go through ``python -m
    isubgvqa_tpu_torch.parity_report --synthetic`` at B = 2048 in f32,
    through the kernels and through the plain versions (logits within
    1e-5, masks equal, every metric equal, the accuracy above 0 and a
    co-occurrence metric finite; both reports' metrics and wall
    times); last every library op (segment, dense, dense-graph, top-k
    ratio, rewiring, the flat node -> edge mask forward and backward) on
    the card against the same call on the CPU at B = 256, N = 128,
    E = 384 (masks, indices and integers exact, f32 within 1e-6 of the
    output's scale); the launch counts of its paths;
then the per-kernel JSON line (all eight kernels, with the bench's
launches, phase 11's, 12's, 13's, 14's and 15's among them, beside the
main path's, and #1's and #5's times at the variants' shapes) and the
final ``{"ok": true, ...}`` line.  Phase 7 runs right after phase 3, before
the serving model is built.

It needs one CUDA device and the CUDA toolkit; without them it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

GRAPH_BUCKETS = ((16, 64), (32, 128), (64, 256), (128, 384))
TEXT_LENS = (16, 32)
GRAPH_B = 256                # graphs per kernel-check batch
TEXT_B = 512                 # questions per kernel-check batch
F32_TOL = 1e-3
# bf16: kernel and plain version round at the same points, but f32 sums
# taken in another order can flip a bf16 rounding (one ulp = 2^-8
# relative) that later products and norms carry on
BF16_TOL = 3e-2
# one product of the graph-layer GEMM against its plain twin: the same
# bf16 products summed in f32 in another order (an f32 output), and at
# most one rounding to bf16 apart (2^-9 of the value, a bf16 output)
GATHER_TOL = {"float32": 2e-5, "bfloat16": 8e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(statistics.median(times))


def host_ms(fn, iters: int = 5) -> float:
    """Median host time to issue ``fn`` from an idle device (Python,
    autograd and launch calls; the device's work is not waited for)."""
    import torch

    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(statistics.median(times))


def nbytes(*objs) -> int:
    import torch

    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, dict):
            total += nbytes(*o.values())
        elif isinstance(o, (tuple, list)):
            total += nbytes(*o)
    return total


def bound(flops, byts, dtype):
    """The least time for ``flops`` operations at ``dtype``'s peak and
    ``byts`` bytes at the memory rate, in ms, and which of the two binds."""
    from isubgvqa_tpu_torch.ops.flops import PEAK_BYTES, peak_flops

    peak = peak_flops(dtype)
    t_ops, t_bytes = flops / peak * 1e3, byts / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def compare(name, got, want, tol):
    import torch

    worst_abs, worst_rel = 0.0, 0.0
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        scale = max(1.0, w.float().abs().max().item())
        if not (err <= tol * scale and torch.isfinite(g.float()).all()):
            raise AssertionError(f"{name}: max abs err {err:.3g} > "
                                 f"{tol} x {scale:.3g}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / scale)
    return worst_abs, worst_rel


# ------------------------------------------------------------- inputs

def random_graphs(rng, b, n, e, device):
    import torch

    node_mask = np.zeros((b, n), bool)
    edge_mask = np.zeros((b, e), bool)
    src = np.zeros((b, e), np.int32)
    dst = np.zeros((b, e), np.int32)
    for g in range(b):
        nn_ = int(rng.integers(n // 2 + 1, n + 1))
        ne = int(rng.integers(min(nn_, e), e + 1))
        node_mask[g, :nn_] = True
        edge_mask[g, :ne] = True
        src[g, :ne] = rng.integers(0, nn_, ne)
        dst[g, :ne] = rng.integers(0, nn_, ne)
    t = lambda a: torch.from_numpy(a).to(device)
    return t(node_mask), t(edge_mask), t(src), t(dst)


def ship(params, dtype):
    """Weights (2-D) at ``dtype``, vectors f32: how the model holds them."""
    return {k: (v.to(dtype) if v.dim() == 2 and k != "att" else v.float())
            for k, v in params.items()}


# ------------------------------------------------------------- phases

def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[1 device] torch: {name}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    return name, smi


def phase_build():
    from isubgvqa_tpu_torch.ops import _lib

    t0 = time.perf_counter()
    path = _lib.build(verbose=True)
    _lib.lib()
    # ptxas's registers and spills of each kernel, by its mangled name
    # (template arguments after "kernel": If float, 13__nv_bfloat16, Lb1 true)
    regs, name, spill = [], "", ""
    for ln in _lib.build_log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill stores" in ln:
            spill = ln.split(",", 1)[1].strip()
        elif "registers" in ln and name:
            short = name[name.find("isg") + 5:].split("Ev")[0]
            regs.append(f"{short}: {ln.split('Used')[1].split(',')[0].strip()}"
                        f", {spill}")
            name = ""
    log(f"[2 build] {path} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_lib.build_seconds or 0:.1f} s); ptxas: {'; '.join(regs)}")


def phase_kernels(model, device):
    """Each kernel against its plain version; returns the JSON entries."""
    import torch
    import torch.nn.functional as F
    from isubgvqa_tpu_torch import ops
    from isubgvqa_tpu_torch.ops import flops as FL
    from isubgvqa_tpu_torch.ops import gat_kernel as G
    from isubgvqa_tpu_torch.ops import metalayer_kernel as M
    from isubgvqa_tpu_torch.ops import text_kernel as T

    rng = np.random.default_rng(0)
    entries = {}

    def record(key, info, dtype, fn, plain, flops, inputs, outputs,
               gemm_flops=None, gemm_family="gemm_sm90", launches=None):
        got, want = fn(), plain()
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        err, rel = compare(f"{key} {info}", got, want, tol)
        ms, plain_ms = time_ms(fn), time_ms(plain)
        b_ms, b_by = bound(flops, nbytes(inputs, outputs), dtype)
        log(f"[3 kernels] {key} {info} {str(dtype)[6:]}: max abs {err:.3g} "
            f"(rel {rel:.3g}); {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   shape=info)
        if dtype == torch.bfloat16 and info.endswith(("E=384", "L=32")):
            _, fam = device_profile(fn)
            out["device_ms"] = sum(fam.values())
            out["host_ms"] = host_ms(fn)
            log(f"[3 kernels] {key} {info} bfloat16 device time by kernel: "
                f"{by_kernel(fam) or 'not measured (no CUDA events)'}; "
                f"host issue from an idle device {out['host_ms']:.3f} ms")
            # launches counted over two calls: the profiler may miss the
            # first kernel of its window, which leaves one family odd
            counts = {}
            device_profile(lambda: (fn(), fn()), counts)
            port = {k: -(-v // 2) for k, v in counts.items() if k != OTHER}
            out["port_launches"] = sum(port.values())
            log(f"[3 kernels] {key} {info} bfloat16 port kernel launches a "
                f"call: {out['port_launches']} {json.dumps(port)}")
            if launches is not None and counts and \
                    out["port_launches"] != launches:
                raise AssertionError(f"{key}: {out['port_launches']} port "
                                     f"launches a call, expected {launches}")
            if gemm_flops and fam.get(gemm_family):
                out["gemm_tflops"] = gemm_flops / fam[gemm_family] / 1e9
                log(f"[3 kernels] {key} {info} products on {gemm_family}: "
                    f"{gemm_flops:.4g} FLOP in {fam[gemm_family]:.4f} device "
                    f"ms = {out['gemm_tflops']:.1f} TFLOP/s effective")
            if "gemm" in fam and gemm_family == "gemm_gather":
                raise AssertionError(f"{key}: bf16 products on gemm.cu")
        return out

    def graph_products(key, info, prods):
        """The layer's bf16 products on the graph-layer GEMM alone, each
        against its plain twin on the same operands, then all of them
        timed beside ``F.linear`` (cuBLAS) on the same operands with the
        gathered rows made beforehand: the products' library yardstick,
        which the port never calls.  ``prods``: (segments, weight, bias,
        act, out dtype) as the layer issues them."""
        from isubgvqa_tpu_torch.ops import gemm as GM

        flops = 0.0
        for i, (segs, w, bias, act, odt) in enumerate(prods):
            rows = segs[0][1] if segs[0][1] is not None else segs[0][0]
            flops += 2.0 * rows.shape[0] * w.shape[0] * w.shape[1]
            got = GM.gemm_gather(segs, w, bias, act, odt)
            want = GM.gemm_gather_plain(segs, w, bias, act, odt)
            err, _ = compare(f"{key} product {i} ({len(segs)} segments)",
                             (got,), (want,), GATHER_TOL[str(odt)[6:]])
            log(f"[3 kernels] {key} {info} product {i}: {len(segs)} "
                f"segment(s), {sum(int(x is not None) for _, x in segs)} "
                f"gathered, [{rows.shape[0]}, {w.shape[1]}] x "
                f"[{w.shape[1]}, {w.shape[0]}] -> {str(odt)[6:]}: max abs "
                f"{err:.3g} against the plain twin")
        dense = [(GM.gather_segments(segs), w,
                  None if b is None else b.to(torch.bfloat16))
                 for segs, w, b, _, _ in prods]
        ms = time_ms(lambda: [GM.gemm_gather(*p) for p in prods])
        lib_ms = time_ms(lambda: [F.linear(*d) for d in dense])
        log(f"[3 kernels] {key} {info} bf16 products alone: graph-layer "
            f"GEMM {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), F.linear "
            f"(cuBLAS) on the same operands {lib_ms:.4f} ms "
            f"({flops / lib_ms / 1e9:.1f} TFLOP/s), factor "
            f"{ms / lib_ms:.3f}")
        return dict(products_ms=ms, products_cublas_ms=lib_ms,
                    products_factor=ms / lib_ms, products_flops=flops,
                    products_tflops=flops / ms / 1e9)

    def layer_library(key, info, fn, library):
        """The port's layer without the final LayerNorm beside the one
        PyTorch call that computes the same function
        (``nn.Transformer{Encoder,Decoder}Layer``, MHA fast path off), on
        the same arguments: the layer's library yardstick."""
        with torch.no_grad():
            err, _ = compare(f"{key} library {info}", (fn(),), (library(),),
                             BF16_TOL)
            ms, lib_ms = time_ms(fn), time_ms(library)
        log(f"[3 kernels] {key} {info} bfloat16 without the final LN: port "
            f"{ms:.4f} ms, library layer {lib_ms:.4f} ms (max abs {err:.3g}"
            f" apart), factor {ms / lib_ms:.3f}")
        return dict(layer_ms=ms, library_ms=lib_ms, factor=ms / lib_ms)

    def attention_core(info, dtype, kernel, library, b, lq, lk):
        """The attention kernel alone against SDPA on the same operands
        (``sdpa_ms``; the whole layer's library call is
        :func:`layer_library`'s)."""
        got = kernel().view(b, lq, 8, 64).transpose(1, 2)
        # BF16_TOL in both types: the kernel rounds the probabilities to
        # the model dtype before P.V and SDPA does not, and SDPA's f32
        # path may run in TF32 (about three decimal digits)
        err, _ = compare(f"attention {info}", (got,), (library(),), BF16_TOL)
        ms, lib_ms = time_ms(kernel), time_ms(library)
        log(f"[3 kernels] attention core {info} {str(dtype)[6:]}: max abs "
            f"{err:.3g} vs SDPA; kernel {ms:.4f} ms, SDPA {lib_ms:.4f} ms")
        return dict(attention_ms=ms, sdpa_ms=lib_ms)

    gat_p = model.gat_seq.layer_params(0)
    meta_p = model.scene_graph_encoder.kernel_params()
    enc_p = model.question_encoder.transformer_encoder.layers[0].kernel_params()
    dec_p = model.program_decoder.coarse_decoder.layers[0].kernel_params()
    c, heads = 300, 4

    for dtype in (torch.float32, torch.bfloat16):
        gp, mp = ship(gat_p, dtype), ship(meta_p, dtype)
        ep, dp = ship(enc_p, dtype), ship(dec_p, dtype)
        for n, e in GRAPH_BUCKETS:
            nm, em, src, dst = random_graphs(rng, GRAPH_B, n, e, device)
            # FLOPs over the valid nodes and edges: padding is not needed work
            nv, ev = int(nm.sum()), int(em.sum())
            h = torch.randn(GRAPH_B, n, c, device=device).to(dtype)
            ea = torch.randn(GRAPH_B, e, c, device=device).to(dtype)
            ins = (0.5 * torch.randn(GRAPH_B, c, device=device)).to(dtype)
            gate = torch.ones(GRAPH_B, n, 1, device=device, dtype=dtype)
            args = (h, h, ins, gate, src, dst, em, nm, ea, gp)
            rn, re_ = GRAPH_B * n, GRAPH_B * e    # every row, padding counted
            hc = heads * c
            r = record("fused_gat_layer", f"B={GRAPH_B} N={n} E={e}", dtype,
                       lambda: G.fused_gat_layer(*args, fuse_instr=True),
                       lambda: G.fused_gat_layer_plain(*args, fuse_instr=True),
                       flops=FL.gat_layer_flops(nv, ev, c, heads, True),
                       inputs=(h, ins, gate, src, dst, em, nm, ea, gp),
                       outputs=(h, torch.empty(GRAPH_B, e, heads)),
                       gemm_flops=FL.gat_layer_products(rn, re_, c, heads),
                       gemm_family="gemm_gather", launches=7)
            if dtype == torch.bfloat16 and (n, e) == GRAPH_BUCKETS[-1]:
                bf = torch.bfloat16
                w_lr, b_lr = G.stacked_lr(gp)
                conv = torch.randn(rn, hc, device=device).to(bf)
                q = torch.randn(rn, hc // 2, device=device).to(bf)
                r.update(graph_products(
                    "fused_gat_layer", f"B={GRAPH_B} N={n} E={e}",
                    [([(h.reshape(rn, c), None)], w_lr, b_lr, None, bf),
                     ([(ea.reshape(re_, c), None)], gp["we"], None, None, bf),
                     ([(conv, None)], gp["w1"], gp["b1"], "gelu", bf),
                     ([(q, None)], gp["w2"], gp["b2"], "gelu",
                      torch.float32)]))
            entries[("fused_gat_layer", dtype)] = r
            if n == 32:   # the masked layer's path: a sampled gate, no fusion
                xf = torch.nn.functional.gelu(h * ins[:, None, :])
                g2 = (torch.rand(GRAPH_B, n, 1, device=device) > 0.6).to(dtype)
                a2 = (h, xf, ins, g2, src, dst, em, nm, ea, gp)
                record("fused_gat_layer", f"masked B={GRAPH_B} N={n} E={e}",
                       dtype, lambda: G.fused_gat_layer(*a2),
                       lambda: G.fused_gat_layer_plain(*a2),
                       flops=FL.gat_layer_flops(nv, ev, c, heads),
                       inputs=a2, outputs=(h, torch.empty(GRAPH_B, e, heads)))
            margs = (h, ea, src, dst, em, nm, mp)
            r = record("fused_metalayer", f"B={GRAPH_B} N={n} E={e}", dtype,
                       lambda: M.fused_metalayer(*margs),
                       lambda: M.fused_metalayer_plain(*margs),
                       flops=FL.metalayer_flops(nv, ev, c),
                       inputs=margs, outputs=(h, ea),
                       gemm_flops=FL.metalayer_products(rn, re_, c),
                       gemm_family="gemm_gather", launches=9)
            if dtype == torch.bfloat16 and (n, e) == GRAPH_BUCKETS[-1]:
                # the edge MLP's three segments, two gathered by the
                # graphs' own row index (-1 on padding edges)
                xt, et = h.reshape(rn, c), ea.reshape(re_, c)
                gs, gd = M.graph_index(src, dst, em, n)
                o1 = torch.randn(rn, c, device=device).to(torch.bfloat16)
                bf, f32 = torch.bfloat16, torch.float32
                r.update(graph_products(
                    "fused_metalayer", f"B={GRAPH_B} N={n} E={e}",
                    [([(xt, gs), (xt, gd), (et, None)], mp["ew1"], mp["eb1"],
                      "gelu", bf),
                     ([(et, None)], mp["ew2"], mp["eb2"], None, bf),
                     ([(xt, gs), (et, None)], mp["n1w1"], mp["n1b1"], "gelu",
                      bf),
                     ([(et, None)], mp["n1w2"], mp["n1b2"], None, f32),
                     ([(xt, None), (o1, None)], mp["n2w1"], mp["n2b1"],
                      "gelu", bf),
                     ([(o1, None)], mp["n2w2"], mp["n2b2"], None, f32)]))
            entries[("fused_metalayer", dtype)] = r
        for l in TEXT_LENS:
            x = torch.randn(TEXT_B, l, 512, device=device).to(dtype)
            lens = torch.randint(6, l + 1, (TEXT_B,), device=device)
            km = (torch.arange(l, device=device)[None] < lens[:, None]).float()
            fl = (ep["n1s"], ep["n1b"])
            r = record("fused_encoder_layer", f"B={TEXT_B} L={l}", dtype,
                       lambda: (T.fused_encoder_layer(x, km, ep, 8, fl),),
                       lambda: (T.fused_encoder_layer_plain(x, km, ep, 8, fl),),
                       flops=FL.encoder_layer_flops(TEXT_B, l, final_ln=True),
                       inputs=(x, km, ep, fl), outputs=(x,),
                       gemm_flops=(FL.encoder_products(TEXT_B, l)
                                   - FL.attention_products(TEXT_B, l, l)))
            if dtype == torch.bfloat16:
                elib = T.encoder_layer_library(ep, 8, dtype)
                r.update(layer_library(
                    "fused_encoder_layer", f"B={TEXT_B} L={l}",
                    lambda: T.fused_encoder_layer(x, km, ep, 8),
                    lambda: elib(x, km)))
            # the attention core alone against F.scaled_dot_product_attention
            # on the same q, k, v: the one library call for part of the layer
            qkv = torch.randn(TEXT_B * l, 3 * 512, device=device).to(dtype)
            q, k, v = qkv.view(TEXT_B, l, 3, 8, 64).permute(2, 0, 3, 1, 4)
            r.update(attention_core(
                f"self B={TEXT_B} L={l}", dtype,
                lambda: T._attention(qkv, 0, 1536, qkv, 512, 1024, 1536, km,
                                     TEXT_B, l, l, 512, 8),
                lambda: T.attention_library(q, k, v, km), TEXT_B, l, l))
            entries[("fused_encoder_layer", dtype)] = r
            tgt = torch.randn(TEXT_B, 4, 512, device=device).to(dtype)
            r = record("fused_decoder_layer", f"B={TEXT_B} T=4 L={l}", dtype,
                       lambda: (T.fused_decoder_layer(tgt, x, dp, 8, fl),),
                       lambda: (T.fused_decoder_layer_plain(tgt, x, dp, 8, fl),),
                       flops=FL.decoder_layer_flops(TEXT_B, 4, l,
                                                    final_ln=True),
                       inputs=(tgt, x, dp, fl), outputs=(tgt,),
                       gemm_flops=(FL.decoder_products(TEXT_B, 4, l)
                                   - FL.attention_products(TEXT_B, 4, 4)
                                   - FL.attention_products(TEXT_B, 4, l)))
            if dtype == torch.bfloat16:
                dlib = T.decoder_layer_library(dp, 8, dtype)
                r.update(layer_library(
                    "fused_decoder_layer", f"B={TEXT_B} T=4 L={l}",
                    lambda: T.fused_decoder_layer(tgt, x, dp, 8),
                    lambda: dlib(tgt, x)))
            q4 = torch.randn(TEXT_B * 4, 512, device=device).to(dtype)
            kv = qkv[:, 512:].contiguous()
            r.update(attention_core(
                f"cross B={TEXT_B} T=4 L={l}", dtype,
                lambda: T._attention(q4, 0, 512, kv, 0, 512, 1024, None,
                                     TEXT_B, 4, l, 512, 8),
                lambda: T.attention_library(
                    q4.view(TEXT_B, 4, 8, 64).transpose(1, 2), k, v, None),
                TEXT_B, 4, l))
            entries[("fused_decoder_layer", dtype)] = r
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    return entries


def serving_config():
    from isubgvqa_tpu_torch.config import Config

    return Config(sampler_type="gumbel", sample_k=3,
                  mgat_masks=(1.0, 1.0, 1.0, 0.15), compute_dtype="bfloat16",
                  bucket_question_lens=(16,), meta_dir="")


def phase_serving():
    import torch
    from isubgvqa_tpu_torch import ops
    from isubgvqa_tpu_torch.data import SyntheticGQA
    from isubgvqa_tpu_torch.serve import Predictor

    cfg = serving_config()
    pred = Predictor.from_seed(cfg, device="cuda")
    ds = SyntheticGQA(pred.vocab, pred.answers, size=64, seed=0,
                      shape_mix="gqa")
    questions = [ds.samples[i][2] for i in range(len(ds))]
    graphs = [ds.store.scene_graphs[ds.samples[i][1]] for i in range(len(ds))]
    pred.predict(questions[:8], graphs[:8], batch_size=32)     # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = pred.predict(questions, graphs, batch_size=32, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts(ops.EVAL_WRAPPERS)
    if len(results) != 64 or any(r is None for r in results):
        raise AssertionError("serving returned the wrong number of answers")
    for r, g in zip(results, graphs):
        n_real = min(len(g["objects"]), cfg.max_nodes_per_graph)
        if r.node_mask.shape != (n_real,):
            raise AssertionError(f"node_mask length {r.node_mask.shape} "
                                 f"for {n_real} nodes")
        if np.round(r.node_mask).sum() > cfg.sample_k:
            raise AssertionError("more than k selected nodes")
        if not (np.isfinite(r.confidence) and np.isfinite(r.gate).all()):
            raise AssertionError("non-finite output")
    shapes = sorted(set(pred.last_batch_shapes))
    node_caps = {s[0][1] for s in shapes}
    q_caps = {s[1][1] for s in shapes}
    if len(node_caps) < 2 or len(q_caps) < 2:
        raise AssertionError(f"buckets not exercised: {shapes}")
    log(f"[4 serving] 64 answers in {wall * 1e3:.1f} ms over "
        f"{len(pred.last_batch_shapes)} batches; node caps "
        f"{sorted(node_caps)}, question caps {sorted(q_caps)}; first answer "
        f"{results[0].answer!r} ({results[0].confidence:.4f}), kept "
        f"{results[0].subgraph_nodes}")
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel never launched: {counts}")
    profile_serving(pred, questions, graphs)
    return pred, ds, counts


def device_profile(fn, launches=None):
    """Run ``fn`` once under torch.profiler (CUPTI); returns the host wall
    time in ms and the device time in ms by kernel family (the port's
    kernels by name, everything else as "other (PyTorch)"); ``launches``,
    a dict, receives the count of device events by family."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = {}
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).endswith("CUDA") \
                and ev.device_time_total > 0:
            fam = next((k for k in KERNEL_FAMILIES if k in ev.name), OTHER)
            families[fam] = families.get(fam, 0.0) + ev.device_time_total / 1e3
            if launches is not None:
                launches[fam] = launches.get(fam, 0) + 1
    return wall_ms, families


# the port's kernels by name, the most specific first
KERNEL_FAMILIES = ("gemm_any", "gemm_bwd", "gemm_sm90", "gemm_gather",
                   "gemm", "reduce_rows", "colsum",
                   "gat_edge_bwd", "gat_edge", "graph_norm_bwd", "graph_norm",
                   "graph_index",
                   "attention_bwd", "attention_mma", "attention", "ln_bwd",
                   "residual_ln",
                   "relu_bwd", "scatter_mean_bwd", "scatter_mean",
                   "scatter_rows", "instr_gelu")


OTHER = "other (PyTorch)"


def by_kernel(families) -> str:
    return ", ".join(f"{k} {v:.3f} ms" for k, v in
                     sorted(families.items(), key=lambda kv: -kv[1]))


def profile_serving(pred, questions, graphs):
    """Where the serving call's time goes: device time by kernel family
    and the device's busy share of the call.  Informational; prints "not
    measured" when the profiler records no device time."""
    wall, families = device_profile(
        lambda: pred.predict(questions, graphs, batch_size=32, seed=1))
    busy = sum(families.values())
    if busy == 0:
        log("[4 serving] profile: device time not measured (no CUDA events)")
        return
    log(f"[4 serving] profile: wall {wall:.1f} ms, device busy "
        f"{busy:.2f} ms ({busy / wall:.1%}); by kernel: {by_kernel(families)}")


@contextlib.contextmanager
def eval_layers(plain):
    """Inside, the model's eval forward runs the four fused layers' plain
    versions when ``plain`` is true, else their kernels."""
    from isubgvqa_tpu_torch import ops
    from isubgvqa_tpu_torch.models import (mgat, question_decoder,
                                           question_encoder,
                                           scene_graph_encoder)

    sites = [(question_encoder, "fused_encoder_layer"),
             (question_decoder, "fused_decoder_layer"),
             (scene_graph_encoder, "fused_metalayer"),
             (mgat, "fused_gat_layer")]
    saved = [getattr(m, n) for m, n in sites]
    try:
        if plain:
            for m, n in sites:
                setattr(m, n, getattr(ops, n + "_plain"))
        yield
    finally:
        for (m, n), fn in zip(sites, saved):
            setattr(m, n, fn)


def forward_path(model, batch, noise, plain, aimle_states=None):
    """One eval forward through the kernels, or with ``plain`` through the
    fused layers' plain versions, with the sampler's ``noise`` given."""
    import torch

    with eval_layers(plain), torch.no_grad():
        return model(batch, noise=noise, aimle_states=aimle_states)


def whole_forward_parity(model, vocab, batch, aimle_states=None):
    """Kernel path against plain path on ``batch`` (on the card), same
    weights and noise: in f32 (TF32 off) the logits within 1e-4 and the
    node mask identical; in the model's bf16 the top-1 agreement.
    Returns ``(f32 logits max abs, logits std, bf16 agreement, agreeing,
    real, bf16 logits max abs, bf16 disagreements where the plain path's
    top-1 leads its second answer by more than twice the largest logit
    difference)``: no difference that small can reorder those, so any is
    a fault."""
    import torch
    from isubgvqa_tpu_torch.models.build import build_model

    dev = batch.node_mask.device
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = -torch.log(-torch.log(torch.rand(
        batch.node_mask.shape, generator=gen, device=dev).clamp_min(1e-30)))
    sd = {k: v.float() for k, v in model.state_dict().items()}
    cfg32 = dataclasses.replace(model.cfg, compute_dtype="float32")
    m32 = build_model(cfg32, vocab, dev, state_dict=sd)
    k32 = forward_path(m32, batch, noise, False, aimle_states)
    p32 = forward_path(m32, batch, noise, True, aimle_states)
    del m32
    err = (k32.logits - p32.logits).abs().max().item()
    std = p32.logits.std().item()
    # random weights leave the logits nearly uniform (spread ~0.1), so the
    # bound sits far below that spread: the paths differ only in f32
    # summation order
    if not err <= 1e-4:
        raise AssertionError(f"whole forward f32: logits differ by {err}")
    if not torch.equal(k32.node_mask.round(), p32.node_mask.round()):
        raise AssertionError("whole forward f32: node_mask differs")
    del k32, p32
    k16 = forward_path(model, batch, noise, False, aimle_states).logits
    p16 = forward_path(model, batch, noise, True, aimle_states).logits
    real = batch.sample_mask > 0
    same = k16.argmax(-1) == p16.argmax(-1)
    err16 = (k16 - p16).abs().max().item()
    top2 = p16.topk(2, dim=-1).values
    resolved = real & (top2[:, 0] - top2[:, 1] > 2 * err16)
    agree = same[real]
    return (err, std, agree.float().mean().item(), int(agree.sum()),
            int(real.sum()), err16, int((resolved & ~same).sum()))


def phase_whole_forward(pred, ds):
    """Kernel path vs plain path on one batch of the serving mix."""
    from isubgvqa_tpu_torch.data import build_bucket_collators

    colls = build_bucket_collators(pred.cfg, pred.tokenizer, pred.vocab,
                                   batch_size=32)
    batch, _ = colls[(32, 16)].collate([ds[i] for i in range(32)])
    err, std, frac, agree, real, err16, _ = whole_forward_parity(
        pred.model, pred.vocab, batch.to(pred.device))
    log(f"[5 whole forward] f32 (TF32 off): logits max abs {err:.3g} "
        f"(bound 1e-4, logits std {std:.3g}), node_mask identical; bf16: "
        f"top-1 agreement {frac:.4f} ({agree}/{real}), logits max abs "
        f"{err16:.3g}")


KERNELS = {
    "fused_gat_layer": ("isubgvqa_tpu_torch/csrc/gemm_gather_sm90.cu",
                        "isubgvqa_tpu/ops/pallas/gat_kernel.py:229"),
    "fused_encoder_layer": ("isubgvqa_tpu_torch/csrc/gemm_sm90.cu",
                            "isubgvqa_tpu/ops/pallas/text_kernel.py:255"),
    "fused_decoder_layer": ("isubgvqa_tpu_torch/csrc/gemm_sm90.cu",
                            "isubgvqa_tpu/ops/pallas/text_kernel.py:387"),
    "fused_metalayer": ("isubgvqa_tpu_torch/csrc/gemm_gather_sm90.cu",
                        "isubgvqa_tpu/ops/pallas/metalayer_kernel.py:143"),
    "fused_gatconv": ("isubgvqa_tpu_torch/csrc/gat_train.cu",
                      "isubgvqa_tpu/ops/pallas/gat_train.py:484"),
    "fused_metalayer_train": ("isubgvqa_tpu_torch/csrc/gemm_bwd.cu",
                              "isubgvqa_tpu/ops/pallas/metalayer_train.py:265"),
    "fused_encoder_layer_train": ("isubgvqa_tpu_torch/csrc/text_train.cu",
                                  "isubgvqa_tpu/ops/pallas/text_train.py:622"),
    "fused_decoder_layer_train": ("isubgvqa_tpu_torch/csrc/gemm_bwd.cu",
                                  "isubgvqa_tpu/ops/pallas/text_train.py:742"),
}

# The staged training layers' other sources (their first is the staged
# backward GEMM's; the forward is the eval layer's).
STAGED_SOURCES = {
    "fused_metalayer_train": ["isubgvqa_tpu_torch/csrc/metalayer_train.cu",
                              "isubgvqa_tpu_torch/csrc/gemm_gather_sm90.cu",
                              "isubgvqa_tpu_torch/csrc/metalayer_kernel.cu"],
    "fused_decoder_layer_train": ["isubgvqa_tpu_torch/csrc/text_train.cu",
                                  "isubgvqa_tpu_torch/csrc/gemm_sm90.cu",
                                  "isubgvqa_tpu_torch/csrc/text_kernel.cu"],
}
STAGED_TOL = {"float32": 2e-5, "bfloat16": 8e-3}

# The eval graph layers' other sources (their first is the GEMM's).
GRAPH_SOURCES = {
    "fused_gat_layer": ["isubgvqa_tpu_torch/csrc/gat_kernel.cu",
                        "isubgvqa_tpu_torch/csrc/metalayer_kernel.cu"],
    "fused_metalayer": ["isubgvqa_tpu_torch/csrc/metalayer_kernel.cu"],
}

# The one PyTorch call that computes each text layer (``library_ms``);
# SDPA on the attention core alone stays on its own key (``sdpa_ms``).
LIBRARY_LAYERS = {
    "fused_encoder_layer": "nn.TransformerEncoderLayer, MHA fast path off, "
                           "against the port's layer without the final LN",
    "fused_decoder_layer": "nn.TransformerDecoderLayer, against the port's "
                           "layer without the final LN",
    "fused_encoder_layer_train": "nn.TransformerEncoderLayer fwd+bwd, train "
                                 "mode, dropout 0.1",
    "fused_decoder_layer_train": "nn.TransformerDecoderLayer fwd+bwd, train "
                                 "mode, dropout 0.1",
}

TRAIN_B = 256
TRAIN_GRAPH_SHAPES = ((16, 64), (128, 384))
# Each gradient's RMS error over its RMS (the relative Frobenius error),
# the RMS floored at 1 % of the layer's largest (a gradient that is zero
# in exact arithmetic, such as that of the bias just before GraphNorm,
# holds only rounding noise of terms at that scale).  RMS, not max abs:
# kernel and plain version sum in another order, which can flip the sign
# of an FFN pre-activation within rounding of 0 (f32 or, more often, a
# bf16 rounding of the forward), and one flipped ReLU moves a whole row of
# linear1's gradient by about 1 % of its max abs, but its RMS by about
# 1 / sqrt(rows * 2048): 3.5e-4 at B*L = 4096.  f32 (TF32 off): 1e-3,
# room for a few flips and summation order; bf16: 3e-2, the forward's
# roundings at the same points as the plain version, one ulp 2^-8 apart
TRAIN_GRAD_TOL = {"float32": 1e-3, "bfloat16": 3e-2}
TRAIN_STEPS = 5
PER_STEP = {"fused_gatconv": 4, "fused_metalayer_train": 1,
            "fused_encoder_layer_train": 4, "fused_decoder_layer_train": 3}


def fwd_bwd(fn, inputs, params, cots):
    """``fn(*inputs, params)`` and the gradients of ``sum(out * cot)``
    with respect to the inputs that require them and every parameter."""
    import torch

    leaves = [t for t in inputs if t.requires_grad] + list(params.values())
    cast = {}        # the cotangents at the outputs' dtype, cast once

    def run():
        outs = fn(*inputs, params)
        outs = outs if isinstance(outs, tuple) else (outs,)
        grads = torch.autograd.grad(
            outs, leaves, [cast.setdefault(i, c.to(o.dtype))
                           for i, (o, c) in enumerate(zip(outs, cots))])
        return outs, grads
    return run


def compare_grads(name, got, want, dtype, tol=None):
    """Worst gradient error by the metric of :data:`TRAIN_GRAD_TOL` (or
    ``tol``)."""
    import torch

    tol = tol or TRAIN_GRAD_TOL[str(dtype)[6:]]
    rms = lambda t: t.float().square().mean().sqrt().item()
    floor = 1e-2 * max(rms(w) for w in want)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        err = rms(g.float() - w.float()) / max(rms(w), floor, 1e-12)
        if not (err <= tol and torch.isfinite(g.float()).all()):
            raise AssertionError(f"{name}: gradient {i}: error {err:.3g} > "
                                 f"{tol}")
        worst = max(worst, err)
    return worst


def phase_train_kernels(model, device):
    """Each training layer's forward and backward kernels against autograd
    of its plain version; returns the JSON entries."""
    import torch
    import torch.nn.functional as F
    from isubgvqa_tpu_torch.models.layers import keep_mask
    from isubgvqa_tpu_torch.ops import flops as FL
    from isubgvqa_tpu_torch.ops import gat_train as G
    from isubgvqa_tpu_torch.ops import metalayer_kernel as MK
    from isubgvqa_tpu_torch.ops import metalayer_train as M
    from isubgvqa_tpu_torch.ops import text_kernel as TK
    from isubgvqa_tpu_torch.ops import text_train as T

    rng = np.random.default_rng(1)
    entries = {}
    c, heads, d, b = 300, 4, 512, TRAIN_B

    def masters(params):
        return {k: v.detach().float().clone().requires_grad_(True)
                for k, v in params.items()}

    def record(key, info, dtype, fn, plain, inputs, params, cots, flops,
               largest, gemm_flops=None, gemm_family="gemm_any",
               forward=None):
        run, run_plain = (fwd_bwd(f, inputs, params, cots)
                          for f in (fn, plain))
        (outs, grads), (outs_p, grads_p) = run(), run_plain()
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        err, _ = compare(f"{key} {info}", outs, outs_p, tol)
        gerr = compare_grads(f"{key} {info}", grads, grads_p, dtype)
        ms, plain_ms = time_ms(run, iters=5), time_ms(run_plain, iters=5)
        host = host_ms(run)
        b_ms, b_by = bound(flops, nbytes(inputs, params, cots, outs, grads),
                           dtype)
        log(f"[7 train kernels] {key} {info} {str(dtype)[6:]}: out max abs "
            f"{err:.3g}, gradients RMS error of RMS <= {gerr:.3g}; fwd+bwd "
            f"{ms:.3f} ms (host issue {host:.3f} ms), plain {plain_ms:.3f} "
            f"ms, bound {b_ms:.4f} ms ({b_by})")
        out = dict(max_abs_err=err, grad_err=gerr, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=info,
                   host_ms=host)
        if largest and dtype == torch.bfloat16:
            _, fam = device_profile(run)
            log(f"[7 train kernels] {key} {info} bfloat16 device time by "
                f"kernel: {by_kernel(fam) or 'not measured (no CUDA events)'}")
            if gemm_flops and fam.get(gemm_family):
                out[f"{gemm_family}_tflops"] = (gemm_flops / fam[gemm_family]
                                                / 1e9)
                log(f"[7 train kernels] {key} {info} backward GEMM "
                    f"({gemm_family}): {gemm_flops:.4g} FLOP (padding rows "
                    f"counted) in {fam[gemm_family]:.3f} device ms = "
                    f"{out[f'{gemm_family}_tflops']:.1f} TFLOP/s effective")
            if forward is not None:
                # CUDA kernels of one call, counted over three calls (the
                # profiler may miss the first kernel of its window)
                per = {}
                for name, f in (("fwd", forward), ("fwd+bwd", run)):
                    counts = {}
                    device_profile(lambda: (f(), f(), f()), counts)
                    per[name] = round(sum(counts.values()) / 3)
                out["kernels_fwd"] = per["fwd"]
                out["kernels_bwd"] = per["fwd+bwd"] - per["fwd"]
                log(f"[7 train kernels] {key} {info} bfloat16 CUDA kernels "
                    f"a call: forward {out['kernels_fwd']}, backward "
                    f"{out['kernels_bwd']} (device profile)")
        return out

    def core_fwd_bwd(name, lq, lk, dtype, bias):
        """The attention core's forward + backward, like for like: the
        port's kernels (``isg_attention`` saving the probabilities, then
        ``isg_attention_bwd``) and F.scaled_dot_product_attention forward
        + backward, on the same q, k, v, key bias and output cotangent.
        Returns ``(port ms, SDPA ms)``; SDPA is the library yardstick."""
        from isubgvqa_tpu_torch.ops.text_kernel import _attention

        q_rows = torch.randn(b * lq, d, device=device).to(dtype)
        kv = torch.randn(b * lk, 2 * d, device=device).to(dtype)
        dout = torch.randn(b * lq, d, device=device)
        heads = lambda t, l: t.view(b, l, 8, 64).transpose(1, 2)
        q = heads(q_rows, lq).detach().requires_grad_(True)
        k = heads(kv[:, :d], lk).detach().requires_grad_(True)
        v = heads(kv[:, d:], lk).detach().requires_grad_(True)
        cot = heads(dout, lq).to(dtype)
        mask = None if bias is None else bias[:, None, None, :].to(dtype)

        def port():
            probs = torch.empty(b, 8, lq, lk, device=device)
            _attention(q_rows, 0, d, kv, 0, d, 2 * d, bias, b, lq, lk, d, 8,
                       None, probs)
            dq = torch.empty(b * lq, d, device=device)
            dkv = torch.empty(b * lk, 2 * d, device=device)
            T.attention_bwd(q_rows, 0, d, kv, 0, d, 2 * d, probs, None, dout,
                            dq, 0, d, dkv, 0, d, 2 * d, b, lq, lk, d, 8)

        ms = time_ms(port, iters=5)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
            (q, k, v), cot), iters=5)
        log(f"[7 train kernels] attention core fwd+bwd {name} B={b} "
            f"Lq={lq} Lk={lk} {str(dtype)[6:]}, same q/k/v/bias/cotangent: "
            f"port {ms:.4f} ms, SDPA {lib_ms:.4f} ms")
        return ms, lib_ms

    def library_fwd_bwd(key, info, library, inputs):
        """Forward + backward of the one PyTorch call that computes the
        training layer (``nn.Transformer{Encoder,Decoder}Layer`` in train
        mode, dropout 0.1 drawn inside the call, bf16 parameters), the
        gradients of every parameter and of the inputs that require them:
        the layer's library yardstick."""
        out = library(*inputs)
        leaves = [t for t in inputs if t.requires_grad]
        leaves += [p for p in library.layer.parameters()]
        cot = torch.randn_like(out)
        ms = time_ms(lambda: torch.autograd.grad(library(*inputs), leaves,
                                                 cot), iters=5)
        log(f"[7 train kernels] {key} {info} bfloat16: library layer fwd+bwd "
            f"{ms:.3f} ms")
        return dict(library_ms=ms)

    def gemm_accuracy():
        """The backward GEMM (``wgrad``: transposed A, split-K, the slices
        summed by each tile's last block) against an f64 product on
        same-sign operands, where a truncating accumulation would drift,
        at K = B * 384, the longest reduction of the main path (#5's
        lin_edge weight gradient over the batch's edge rows); torch's f32
        product with TF32 off beside it."""
        from isubgvqa_tpu_torch.ops import gemm

        gen = torch.Generator(device=device).manual_seed(7)
        k = b * 384
        a = torch.rand(k, 64, device=device, generator=gen)
        x = torch.rand(k, 40, device=device, generator=gen)
        rel = lambda got, want: ((got.double() - want).abs().max()
                                 / want.abs().max()).item()
        errs = [rel(gemm.wgrad(a, xb), a.double().t() @ xb.double())
                for xb in (x, x.to(torch.bfloat16))]
        f32 = rel(a.t() @ x, a.double().t() @ x.double())
        # the staged GEMM: bf16x3 on wgmma (bf16 B), 3xTF32 (f32 B); its
        # bias column is the sum of A over the same k
        staged = []
        for xb in (x.to(torch.bfloat16), x):
            out = torch.empty(64, 40, device=device)
            bias = torch.empty(64, device=device)
            gemm.bwd_stage(gemm.stage_wgrad(a, [(xb, None)], out, bias))
            staged += [rel(out, a.double().t() @ xb.double()),
                       rel(bias, a.double().sum(0))]
        log(f"[7 train kernels] backward GEMMs against f64, same-sign "
            f"operands, K={k}: max abs error over max abs: gemm_any f32 B "
            f"{errs[0]:.3g}, bf16 B {errs[1]:.3g}; staged gemm_bwd bf16x3 "
            f"{staged[0]:.3g} (bias {staged[1]:.3g}), 3xTF32 {staged[2]:.3g}"
            f" (bias {staged[3]:.3g}); torch f32 product {f32:.3g}")
        if not max(errs + staged) <= 4e-6:
            raise AssertionError(f"backward GEMM error "
                                 f"{max(errs + staged):.3g} > 4e-6")

    def staged_launches(key, info, dtype, run_backward):
        """Each staged backward launch of one layer against its plain
        twin (``gemm.bwd_stage_checked``) on the forward's saved tensors:
        f32 outputs within STAGED_TOL["float32"] of their scale, bf16
        ones within STAGED_TOL["bfloat16"]."""
        from isubgvqa_tpu_torch.ops import gemm

        errs = []
        run_backward(lambda *pr: errs.append(gemm.bwd_stage_checked(*pr)))
        torch.cuda.synchronize()
        worst = {k: max(e[k] for e in errs) for k in STAGED_TOL}
        log(f"[7 train kernels] {key} {info} {str(dtype)[6:]}: {len(errs)} "
            f"staged backward launches against their plain twins, worst "
            f"f32 output {worst['float32']:.3g}, bf16 output "
            f"{worst['bfloat16']:.3g} of scale; by launch (f32, bf16): "
            + ", ".join(f"{e['float32']:.2g}/{e['bfloat16']:.2g}"
                        for e in errs))
        for k, tol in STAGED_TOL.items():
            if not worst[k] <= tol:
                raise AssertionError(f"{key} staged launch: {k} output "
                                     f"error {worst[k]:.3g} > {tol}")

    def ffn_flips(info, x, km, masks, params):
        """Where the f32 encoder layer's gradients part from the plain
        version's: the FFN pre-activations whose sign differs between the
        kernel's forward and the plain one (on the kept units), and
        linear1's weight gradient error over all its rows (one row an FFN
        unit) and over the rows that hold no flip, from one cotangent."""
        from isubgvqa_tpu_torch.ops.text_kernel import (
            _mul, encoder_launch, ln_plain, masks_at, mha_plain)

        ps = T.ship_params(params, x.dtype)
        with torch.no_grad():
            _, saved = encoder_launch(x, km, ps, 8, None, masks, save=True)
            m = masks_at(masks, x.dtype)
            xf = x.float()
            attn = mha_plain(xf, xf, km, ps["in_w"], ps["in_b"], ps["out_w"],
                             ps["out_b"], 8, x.dtype, m.get("attn"))
            x1 = ln_plain(xf + _mul(attn, m.get("post_attn")), ps["n1s"],
                          ps["n1b"])
            pre = (x1 @ ps["w1"].t() + ps["b1"]).reshape(-1, ps["w1"].shape[0])
        kept = masks["ffn"].reshape(pre.shape) > 0
        flips = ((saved["hid"].float() > 0) != (pre > 0)) & kept
        units = flips.any(0)
        gen = torch.Generator(device=device).manual_seed(5)
        cot = torch.randn(x.shape, device=device, generator=gen)
        w1 = {}
        for name, f in (("kernel", T.fused_encoder_layer_train),
                        ("plain", T.fused_encoder_layer_train_plain)):
            p = masters(params)
            w1[name] = torch.autograd.grad(f(x, km, masks, p, 8), p["w1"],
                                           cot)[0]
        rms = lambda t: t.square().mean().sqrt().item()
        diff = w1["kernel"] - w1["plain"]
        whole = rms(diff) / rms(w1["plain"])
        clean = rms(diff[~units]) / rms(w1["plain"][~units])
        log(f"[7 train kernels] fused_encoder_layer_train {info} float32 "
            f"FFN: {int(flips.sum())} of {int(kept.sum())} kept "
            f"pre-activations change sign between kernel and plain forward, "
            f"in {int(units.sum())} of {units.numel()} units; linear1 "
            f"gradient RMS error of RMS {whole:.3g} over all rows, "
            f"{clean:.3g} over the {int((~units).sum())} rows with no flip")
        return dict(ffn_flips=int(flips.sum()), ffn_flip_units=int(units.sum()),
                    w1_grad_err=whole, w1_grad_err_unflipped=clean)

    gemm_accuracy()
    gp = model.gat_seq.layer_params(3)
    conv_p = {k: gp[k] for k in G.CONV_KEYS}
    meta_p = model.scene_graph_encoder.kernel_params()
    enc_p = model.question_encoder.transformer_encoder.layers[0].kernel_params()
    dec_p = model.program_decoder.coarse_decoder.layers[0].kernel_params()
    draw = lambda *shape: keep_mask(shape, 0.1, None, device)
    for dtype in (torch.float32, torch.bfloat16):
        for n, e in TRAIN_GRAPH_SHAPES:
            nm, em, src, dst = random_graphs(rng, b, n, e, device)
            nv, ev = int(nm.sum()), int(em.sum())
            info = f"B={b} N={n} E={e}"
            largest = (n, e) == TRAIN_GRAPH_SHAPES[-1]
            xf = torch.randn(b, n, c, device=device).to(dtype)
            ea = torch.randn(b, e, c, device=device).to(dtype)
            gate = (torch.rand(b, n, 1, device=device) > 0.6).to(dtype)
            inputs = [t.clone().requires_grad_(True) for t in (xf, gate, ea)]
            wrap = lambda f: (lambda x, g, a, p: f(x, g, src, dst, em, a, p))
            r = record("fused_gatconv", info, dtype, wrap(G.fused_gatconv),
                       wrap(G.fused_gatconv_plain), inputs, masters(conv_p),
                       (torch.randn(b, n, heads * c, device=device),
                        torch.randn(b, e, heads, device=device)),
                       FL.gatconv_train_flops(nv, ev, c, heads), largest,
                       gemm_flops=2 * FL.gat_conv_products(b * n, b * e, c,
                                                           heads))
            entries[("fused_gatconv", dtype)] = r
            inputs = [t.clone().requires_grad_(True) for t in (xf, ea)]
            wrap = lambda f: (lambda x, a, p: f(x, a, src, dst, em, nm, p))
            mp = masters(meta_p)
            r = record("fused_metalayer_train", info, dtype,
                       wrap(M.fused_metalayer_train),
                       wrap(M.fused_metalayer_train_plain), inputs, mp,
                       (torch.randn(b, n, c, device=device),
                        torch.randn(b, e, c, device=device)),
                       FL.metalayer_train_flops(nv, ev, c), largest,
                       gemm_flops=2 * FL.metalayer_products(b * n, b * e, c),
                       gemm_family="gemm_bwd",
                       forward=lambda: M.fused_metalayer_train(
                           xf, ea, src, dst, em, nm, mp))
            if largest:
                ps = T.ship_params(meta_p, dtype)
                _, _, saved = MK.metalayer_launch(xf, ea, src, dst, em, nm,
                                                  ps, save=True)
                staged_launches(
                    "fused_metalayer_train", info, dtype,
                    lambda stage: M.metalayer_backward(
                        torch.randn(b, n, c, device=device).to(dtype),
                        torch.randn(b, e, c, device=device).to(dtype), saved,
                        ps, (dtype, dtype), stage=stage))
                del saved
            entries[("fused_metalayer_train", dtype)] = r
        for l in TEXT_LENS:
            info = f"B={b} L={l}"
            largest = l == TEXT_LENS[-1]
            x = torch.randn(b, l, d, device=device).to(dtype)
            lens = torch.randint(6, l + 1, (b,), device=device)
            km = (torch.arange(l, device=device)[None] < lens[:, None]).float()
            masks = {"attn": draw(b, 8, l, l), "post_attn": draw(b, l, d),
                     "ffn": draw(b, l, 2048), "post_ffn": draw(b, l, d)}
            r = record("fused_encoder_layer_train", info, dtype,
                       lambda x, p: T.fused_encoder_layer_train(x, km, masks,
                                                                p, 8),
                       lambda x, p: T.fused_encoder_layer_train_plain(
                           x, km, masks, p, 8),
                       [x.clone().requires_grad_(True)], masters(enc_p),
                       (torch.randn(b, l, d, device=device),),
                       FL.encoder_layer_train_flops(b, l), largest,
                       gemm_flops=2 * (FL.encoder_products(b, l, d)
                                       - FL.attention_products(b, l, l, d)))
            r["attention_ms"], r["sdpa_ms"] = core_fwd_bwd("self", l, l,
                                                           dtype, km)
            if dtype == torch.float32 and largest:
                r.update(ffn_flips(info, x, km, masks, enc_p))
            if dtype == torch.bfloat16:
                r.update(library_fwd_bwd(
                    "fused_encoder_layer_train", info,
                    TK.encoder_layer_library(masters(enc_p), 8, dtype, 0.1),
                    [x.clone().requires_grad_(True), km]))
            entries[("fused_encoder_layer_train", dtype)] = r
            tgt = torch.randn(b, 4, d, device=device).to(dtype)
            dmasks = {"self_attn": draw(b, 8, 4, 4), "post_sa": draw(b, 4, d),
                      "cross_attn": draw(b, 8, 4, l), "post_ca": draw(b, 4, d),
                      "ffn": draw(b, 4, 2048), "post_ffn": draw(b, 4, d)}
            info = f"B={b} T=4 L={l}"
            dpm = masters(dec_p)
            r = record("fused_decoder_layer_train", info, dtype,
                       lambda t, m, p: T.fused_decoder_layer_train(
                           t, m, dmasks, p, 8),
                       lambda t, m, p: T.fused_decoder_layer_train_plain(
                           t, m, dmasks, p, 8),
                       [tgt.clone().requires_grad_(True),
                        x.clone().requires_grad_(True)], dpm,
                       (torch.randn(b, 4, d, device=device),),
                       FL.decoder_layer_train_flops(b, 4, l), largest,
                       gemm_flops=2 * (FL.decoder_products(b, 4, l, d)
                                       - FL.attention_products(b, 4, 4, d)
                                       - FL.attention_products(b, 4, l, d)),
                       gemm_family="gemm_bwd",
                       forward=lambda: T.fused_decoder_layer_train(
                           tgt, x, dmasks, dpm, 8))
            if largest:
                ps = T.ship_params(dec_p, dtype)
                _, saved = TK.decoder_launch(tgt, x, ps, 8, None,
                                             TK.masks_at(dmasks, dtype),
                                             save=True)
                staged_launches(
                    "fused_decoder_layer_train", info, dtype,
                    lambda stage: T.decoder_backward(
                        torch.randn(b, 4, d, device=device).to(dtype), saved,
                        ps, 8, (dtype, dtype), stage=stage))
                del saved
            r["attention_ms"], r["sdpa_ms"] = core_fwd_bwd("cross", 4, l,
                                                           dtype, None)
            if dtype == torch.bfloat16:
                r.update(library_fwd_bwd(
                    "fused_decoder_layer_train", info,
                    TK.decoder_layer_library(masters(dec_p), 8, dtype, 0.1),
                    [tgt.clone().requires_grad_(True),
                     x.clone().requires_grad_(True)]))
            entries[("fused_decoder_layer_train", dtype)] = r
    torch.cuda.synchronize()
    return entries


def train_config():
    from isubgvqa_tpu_torch.config import Config

    return Config(sampler_type="gumbel", sample_k=3,
                  mgat_masks=(1.0, 1.0, 1.0, 0.15), compute_dtype="bfloat16",
                  bucket_question_lens=(16,), meta_dir="", batch_size=TRAIN_B)


def training_batches(cfg, vocab, answers, n_batches):
    """``n_batches`` full batches of the GQA-like synthetic mix through the
    bucketed collators, alternating over the node buckets that fill a
    batch (at least two)."""
    from isubgvqa_tpu_torch.data import (SyntheticGQA,
                                         build_bucket_collators,
                                         build_tokenizer, route_to_buckets)

    tok = build_tokenizer(None, max_len=cfg.question_len,
                          vocab_size=cfg.text_vocab_size)
    ds = SyntheticGQA(vocab, answers, size=2048, seed=1, shape_mix="gqa")
    colls = build_bucket_collators(cfg, tok, vocab, batch_size=TRAIN_B)
    per = route_to_buckets(ds, colls)
    full = {}
    for key in sorted(per):          # the fullest question bucket per node cap
        if len(per[key]) >= TRAIN_B and (key[0] not in full or len(per[key])
                                         > len(per[full[key[0]]])):
            full[key[0]] = key
    keys = [full[n] for n in sorted(full)]
    if len(keys) < 2:
        raise AssertionError(f"fewer than two node buckets fill a batch: "
                             f"{ {k: len(v) for k, v in per.items()} }")
    out = []
    for i in range(n_batches):
        key = keys[i % len(keys)]
        start = (i // len(keys)) * TRAIN_B % (len(per[key]) - TRAIN_B + 1)
        batch, _ = colls[key].collate([ds[j] for j in
                                       per[key][start:start + TRAIN_B]])
        out.append((key, batch))
    return ds, out


def phase_training(device):
    """The training path at full width: warm-up, then TRAIN_STEPS counted
    steps and one profiled step.  Returns the launch counts, the state and
    a batch for phase 9."""
    import torch
    from isubgvqa_tpu_torch import ops
    from isubgvqa_tpu_torch.data import AnswerMap, SceneGraphVocab
    from isubgvqa_tpu_torch.train import create_train_state, make_train_step

    cfg = train_config()
    vocab = SceneGraphVocab.build("", seed=cfg.seed)
    answers = AnswerMap.build("", cfg.num_answers)
    cfg = dataclasses.replace(cfg, num_answers=len(answers))
    t0 = time.perf_counter()
    ds, batches = training_batches(cfg, vocab, answers, TRAIN_STEPS + 2)
    batches = [(k, b.to(device)) for k, b in batches]
    log(f"[8 training] data: {len(ds)} samples of the GQA-like mix, "
        f"{len(batches)} batches of {TRAIN_B} over buckets "
        f"{sorted({k for k, _ in batches})} in "
        f"{time.perf_counter() - t0:.1f} s")
    state = create_train_state(cfg, vocab, steps_per_epoch=len(ds) // TRAIN_B,
                               device=device)
    n_params = sum(p.numel() for p in state.model.parameters())
    step = make_train_step(state.model, state.optimizer, cfg)
    t0 = time.perf_counter()
    state, m = step(state, batches[0][1])           # warm-up
    torch.cuda.synchronize()
    log(f"[8 training] {n_params} parameters (f32 masters, bf16 compute); "
        f"warm-up step {(time.perf_counter() - t0) * 1e3:.1f} ms, loss "
        f"{float(m['loss_sum'] / m['count']):.4f}")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for key, batch in batches[1:TRAIN_STEPS + 1]:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss_sum"] / m["count"])
        norm = float(m["grad_norm"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not (np.isfinite(loss) and np.isfinite(norm)):
            raise AssertionError(f"non-finite training step: loss {loss}, "
                                 f"grad norm {norm}")
        log(f"[8 training] step {state.step} bucket {key}: loss {loss:.5f}, "
            f"grad norm {norm:.5f}, {times[-1]:.1f} ms")
    counts = ops.launch_counts(ops.TRAIN_WRAPPERS)
    for name, per in PER_STEP.items():
        for k in (name, name + "_bwd"):
            if counts[k] != per * TRAIN_STEPS:
                raise AssertionError(f"{k}: {counts[k]} launches in "
                                     f"{TRAIN_STEPS} steps, expected "
                                     f"{per} per step")
    log(f"[8 training] launches in {TRAIN_STEPS} steps: {json.dumps(counts)}"
        f"; step ms median {statistics.median(times):.1f}; peak device "
        f"memory over the steps "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    wall, fam = device_profile(lambda: step(state, batches[-1][1]))
    busy = sum(fam.values())
    if busy:
        log(f"[8 training] profiled step: wall {wall:.1f} ms, device busy "
            f"{busy:.2f} ms ({busy / wall:.1%}); by kernel: {by_kernel(fam)}")
    else:
        log("[8 training] profile: device time not measured (no CUDA events)")
    return counts, state, vocab, batches[0][1], statistics.median(times)


def phase_train_step_parity(state, vocab, batch, tag="[9 train step]",
                            aimle_beta=None, bf16=True, whole_tol=None):
    """One step's loss and gradients through the kernels and through the
    plain versions, same weights, masks and noise.  With the aimle sampler
    each path starts from its own fresh AIMLE states at ``aimle_beta``,
    and the states after the backward agree within 1e-6.  ``whole_tol``
    bounds the RMS error of all the gradients together over their RMS;
    ``bf16=False`` leaves out the bf16 step."""
    import torch
    from isubgvqa_tpu_torch.models import (question_decoder,
                                           question_encoder,
                                           scene_graph_encoder)
    from isubgvqa_tpu_torch.models.build import (build_model,
                                                 make_aimle_states)
    from isubgvqa_tpu_torch.ops import gat_train, metalayer_train, text_train
    from isubgvqa_tpu_torch.train.steps import cross_entropy_loss

    sites = [(question_encoder, "fused_encoder_layer_train",
              text_train.fused_encoder_layer_train_plain),
             (question_decoder, "fused_decoder_layer_train",
              text_train.fused_decoder_layer_train_plain),
             (scene_graph_encoder, "fused_metalayer_train",
              metalayer_train.fused_metalayer_train_plain),
             (gat_train, "fused_gatconv", gat_train.fused_gatconv_plain)]
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}

    def run(dtype, plain):
        cfg = dataclasses.replace(state.model.cfg, compute_dtype=dtype)
        model = build_model(cfg, vocab, batch.node_mask.device,
                            state_dict=sd, train=True)
        states = make_aimle_states(cfg, batch.node_mask.device)
        for st in (states or {}).values():
            st.beta.fill_(aimle_beta)
        saved = [getattr(m, n) for m, n, _ in sites]
        try:
            if plain:
                for m, n, f in sites:
                    setattr(m, n, f)
            gen = torch.Generator(device=batch.node_mask.device)
            gen.manual_seed(11)
            out = model(batch, generator=gen, train=True,
                        aimle_states=states)
            loss = cross_entropy_loss(out.logits, batch.labels,
                                      batch.sample_mask)
            loss.backward()
        finally:
            for (m, n, _), f in zip(sites, saved):
                setattr(m, n, f)
        # a parameter that the loss does not reach (the node head) has
        # no gradient: a zero one, as the optimizer takes it
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in model.named_parameters()}
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
        after = [[float(getattr(st, f)) for f in
                  ("beta", "grad_norm", "prev_update")]
                 for st in (states or {}).values()]
        return float(loss.detach()), float(norm), out.node_mask, grads, after

    lk, nk, mk, gk, sk = run("float32", False)
    lp, np_, mp, gp, sp = run("float32", True)
    if not np.allclose(sk, sp, rtol=0, atol=1e-6):
        raise AssertionError(f"train step f32: AIMLE state {sk} against "
                             f"plain {sp}")
    if not abs(lk - lp) <= 1e-5 * abs(lp):
        raise AssertionError(f"train step f32: loss {lk} vs plain {lp}")
    if not abs(nk - np_) <= 1e-3 * np_:
        raise AssertionError(f"train step f32: grad norm {nk} vs {np_}")
    if not torch.equal(mk, mp):
        raise AssertionError("train step f32: node mask differs")
    # every leaf's RMS error within 3e-3 of its RMS, floored at 1e-3 of the
    # largest leaf's RMS (a leaf whose exact gradient is zero, such as the
    # bias just before GraphNorm, holds noise).  RMS, not max abs: the
    # paths sum in another order, which can flip the sign of an FFN
    # pre-activation within f32 rounding of 0.  One flipped ReLU of the
    # B*L x 2048 in an encoder layer moves one row of linear1's gradient
    # by about 1 % of its max abs, and its RMS by about
    # 1 / sqrt(B*L * 2048) (3e-4 at B*L = 4096); the bound allows a few
    rms = lambda t: t.square().mean().sqrt().item()
    floor = 1e-3 * max(rms(g) for g in gp.values())
    errs = sorted(((rms(gk[k] - g) / max(rms(g), floor), k, rms(g))
                   for k, g in gp.items()), reverse=True)
    worst = errs[0][0]
    log(f"{tag} f32 worst gradient leaves (RMS error of RMS, leaf, "
        "RMS): " + "; ".join(f"{e:.3g} {k} {r:.3g}" for e, k, r in errs[:4]))
    if not worst <= 3e-3:
        raise AssertionError(f"train step f32: {errs[0][1]} differs by "
                             f"{worst} of its RMS")
    flat = lambda g: torch.cat([t.flatten() for t in g.values()])
    whole = rms(flat(gk) - flat(gp)) / rms(flat(gp))
    if whole_tol is not None and not whole <= whole_tol:
        raise AssertionError(f"train step f32: the gradients differ by "
                             f"{whole:.3g} of their RMS (> {whole_tol})")
    if not bf16:
        log(f"{tag} f32 (TF32 off): loss {lk:.6f} vs plain {lp:.6f}, grad "
            f"norm {nk:.6f} vs {np_:.6f}, node mask identical, all "
            f"gradients' RMS error {whole:.3g} of their RMS, worst leaf "
            f"{worst:.3g} of its RMS ({len(gk)} leaves)")
        return whole, worst
    l16k, n16k, _, _, _ = run("bfloat16", False)
    l16p, n16p, _, _, _ = run("bfloat16", True)
    # bf16: the two paths round the forward at the same points, but a
    # flipped rounding moves the loss (~7.5) by far less than 1 %
    if not (abs(l16k - l16p) <= 1e-2 * abs(l16p)
            and abs(n16k - n16p) <= 5e-2 * n16p):
        raise AssertionError(f"train step bf16: loss {l16k} vs {l16p}, grad "
                             f"norm {n16k} vs {n16p}")
    log(f"{tag} f32 (TF32 off): loss {lk:.6f} vs plain {lp:.6f}, "
        f"grad norm {nk:.6f} vs {np_:.6f}, node mask identical, worst "
        f"gradient leaf {worst:.3g} of its RMS ({len(gk)} leaves); bf16: "
        f"loss {l16k:.5f} vs {l16p:.5f}, grad norm {n16k:.5f} vs {n16p:.5f}"
        + (f"; AIMLE state (beta, grad_norm, prev_update) {sk} in both, "
           f"within 1e-6" if sk else ""))


BENCH_B = 2048               # the bench's inference batch
BENCH_TRAIN_B = 256          # its training batch
PARITY_BUCKET = (128, 32)    # the largest shapes reach the kernels at B = 2048
# bf16 kernel path against bf16 plain path at B = 2048: the logits' max
# abs difference (a fixed bound, not scaled by what it measures; the
# paths round to bf16 at the same points and read 1.5e-3 against a logits
# std of 0.044) and the share of real rows whose top-1 answer agrees
BENCH_BF16_LOGITS_TOL = 1e-2
BENCH_TOP1_FLOOR = 0.995
SYNC_EVENTS = ("Synchronize", "cudaMemcpy")


def host_syncs(fn) -> dict:
    """Run ``fn`` under the host profiler; returns the count, by name, of
    the CUDA runtime calls by which the host waits on the device or
    copies with it (``cudaStreamSynchronize``, behind ``.item()`` and
    ``bool()`` of a CUDA tensor, the other ``*Synchronize`` calls,
    ``cudaMemcpy*``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    torch.cuda.synchronize()
    found = {}
    for ev in prof.events():
        if any(k in ev.name for k in SYNC_EVENTS):
            found[ev.name] = found.get(ev.name, 0) + 1
    return found


def phase_bench():
    """Phase 10: the port's bench (``isubgvqa_tpu_torch.bench``) at its own
    batch: the kernel path against the plain path on one B = 2048 batch of
    the largest bucket, then ``bench_inference`` at B = 2048 over every
    bucket (at least 4 timed batches each), one chunk of each bucket's
    batches profiled for the device's busy share and time by kernel, one
    epoch of ``bench_e2e``, and
    ``bench_train_step`` at 256, each with the launch counts of its run
    and the host's waits on the device in one forward and one step.
    Returns the launch counts and the host's waits in one train step."""
    import torch
    from isubgvqa_tpu_torch import bench, ops

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    setup = bench.build_bench_setup(bench._cfg("gumbel", BENCH_B,
                                               "bfloat16"),
                                    num_batches=12, device=dev)
    log(f"[10 bench] fixture: {len(setup.ds)} samples of the GQA-like mix, "
        f"batches per bucket "
        f"{ {str(k): len(v) for k, v in setup.bucket_batches.items()} } in "
        f"{time.perf_counter() - t_phase:.1f} s")
    batch = setup.bucket_batches[PARITY_BUCKET][0].to(dev)
    err, std, frac, agree, real, err16, bad = whole_forward_parity(
        setup.model, setup.vocab, batch)
    if not (err16 <= BENCH_BF16_LOGITS_TOL and frac >= BENCH_TOP1_FLOOR
            and not bad):
        raise AssertionError(
            f"bench B={BENCH_B} bf16: logits max abs {err16:.3g} (bound "
            f"{BENCH_BF16_LOGITS_TOL}), top-1 agreement {frac:.4f} (floor "
            f"{BENCH_TOP1_FLOOR}), {bad} answers differ where the margin "
            f"exceeds twice the logit difference")
    log(f"[10 bench] kernel against plain, B={BENCH_B} bucket "
        f"{PARITY_BUCKET}: f32 (TF32 off) logits max abs {err:.3g} (bound "
        f"1e-4, logits std {std:.3g}), node_mask identical; bf16 logits max "
        f"abs {err16:.3g} (bound {BENCH_BF16_LOGITS_TOL}), top-1 agreement "
        f"{frac:.4f} ({agree}/{real}, floor {BENCH_TOP1_FLOOR}), no "
        f"disagreement where the margin exceeds twice the logit difference")
    gen = torch.Generator(device=dev).manual_seed(0)

    def forward():
        with torch.inference_mode():       # as bench_inference runs it
            setup.model(batch, generator=gen)

    syncs = host_syncs(forward)
    log(f"[10 bench] host waits on the device in one B={BENCH_B} forward: "
        f"{json.dumps(syncs)}")
    del batch
    torch.cuda.empty_cache()

    def busy(key):
        """One chunk of the bucket's timed batches, as bench_inference
        runs them: its wall time, then under the profiler the device's
        busy share of it (the profiler's host cost can lengthen the
        profiled wall where the host is slow)."""
        batches = [b.to(dev) for b in
                   setup.bucket_batches[key][1:bench.CHUNK + 1]]

        def chunk():
            with torch.inference_mode():
                for b in batches:
                    setup.model(b, generator=gen)

        chunk()                                   # warm-up, unprofiled
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        plain_wall = (time.perf_counter() - t0) * 1e3
        wall, fam = device_profile(chunk)
        busy_ms = sum(fam.values())
        log(f"[10 bench] busy {key}: " + json.dumps({
            "batches": len(batches), "wall_ms": plain_wall,
            "profiled_wall_ms": wall, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall if busy_ms else None,
            "device_ms_by_kernel": fam}))

    counts = {}

    def counted(name, wrappers, fn):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = ops.launch_counts(wrappers)
        if min(got.values()) == 0:
            raise AssertionError(f"{name}: a kernel never launched: {got}")
        counts[name] = got
        log(f"[10 bench] {name}: {json.dumps(out)}")
        log(f"[10 bench] {name} launches: {json.dumps(got)}")
        return out

    counted("bench_inference", ops.EVAL_WRAPPERS,
            lambda: bench.bench_inference(setup=setup))
    for key in sorted(setup.bucket_batches):
        busy(key)
    counted("bench_e2e", ops.EVAL_WRAPPERS,
            lambda: bench.bench_e2e(setup=setup, epochs=1))
    del setup
    torch.cuda.empty_cache()
    train = counted("bench_train_step", ops.TRAIN_WRAPPERS,
                    lambda: bench.bench_train_step(
                        "gumbel", BENCH_TRAIN_B, device=dev))
    log(f"[10 bench] train ms/step at {BENCH_TRAIN_B}: "
        f"{train['ms_per_step']:.2f} (median over chunks, blended)")
    tsetup = bench.build_bench_setup(
        bench._cfg("gumbel", BENCH_TRAIN_B, "bfloat16"), num_batches=2,
        min_timed=1, device=dev, train=True)
    step = bench.make_train_step(tsetup.state.model, tsetup.state.optimizer,
                                 tsetup.cfg)
    tb = next(iter(tsetup.bucket_batches.values()))[0].to(dev)
    step(tsetup.state, tb)
    train_syncs = host_syncs(lambda: step(tsetup.state, tb))
    log(f"[10 bench] host waits on the device in one train step at "
        f"{BENCH_TRAIN_B}: {json.dumps(train_syncs)}")
    log(f"[10 bench] phase {time.perf_counter() - t_phase:.1f} s")
    return counts, train_syncs


SAMPLERS = ("imle", "aimle", "simple")
AIMLE_BETA = 5.0             # the train-step check's starting beta: at the
# init's 0 the target equals theta and aimle's gradient is zero
NODE_CAPS = (16, 32, 64, 128)


def serve_sampler(sampler):
    """(a): ``Predictor.predict`` of 64 questions with ``sampler``; returns
    the wall ms and the eval launch counts."""
    import torch
    from isubgvqa_tpu_torch import ops
    from isubgvqa_tpu_torch.data import SyntheticGQA
    from isubgvqa_tpu_torch.serve import Predictor

    cfg = dataclasses.replace(serving_config(), sampler_type=sampler)
    pred = Predictor.from_seed(cfg, device="cuda")
    ds = SyntheticGQA(pred.vocab, pred.answers, size=64, seed=0,
                      shape_mix="gqa")
    questions = [ds.samples[i][2] for i in range(len(ds))]
    graphs = [ds.store.scene_graphs[ds.samples[i][1]] for i in range(len(ds))]
    pred.predict(questions[:8], graphs[:8], batch_size=32)     # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = pred.predict(questions, graphs, batch_size=32, seed=0)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts(ops.EVAL_WRAPPERS)
    if len(results) != 64 or any(r is None for r in results):
        raise AssertionError(f"{sampler} serving: wrong number of answers")
    # imle's eval is the plain top-k of the bf16 gate scores, where ties
    # select every node at the k-th value (the reference's ">=" solver);
    # the noisy samplers break ties
    ties = 0
    for r in results:
        kept = np.round(r.node_mask).sum()
        ties += int(kept > cfg.sample_k)
        if not (np.isfinite(r.confidence) and np.isfinite(r.gate).all()
                and set(np.unique(r.node_mask)) <= {0.0, 1.0}
                and (kept <= cfg.sample_k or sampler == "imle")):
            raise AssertionError(f"{sampler} serving: bad answer {r}")
    if min(counts.values()) == 0:
        raise AssertionError(f"{sampler} serving: a kernel never launched: "
                             f"{counts}")
    if pred.aimle_states is not None:
        st = pred.aimle_states[3]
        if (float(st.beta), float(st.grad_norm)) != (0.0, 1.0):
            raise AssertionError("serving changed the AIMLE state")
    log(f"[11 samplers] {sampler} (a) serving: 64 answers in {wall:.1f} ms "
        f"over {len(pred.last_batch_shapes)} batches, {ties} keeping more "
        f"than k nodes (tied scores); first "
        f"{results[0].answer!r} ({results[0].confidence:.4f}), kept "
        f"{results[0].subgraph_nodes}; launches {json.dumps(counts)}")


def sampler_ms(sampler, b, n, train):
    """The sampler alone on ``[b, n]`` gate scores (a quarter of them
    zero-filled padding slots), as the mask head calls it: eval under
    ``torch.inference_mode()``, or training forward + backward.  Returns
    the median ms by CUDA events (alone, the device waits on the host's
    launches), its CUDA kernels and their device ms from the profile."""
    import torch
    from isubgvqa_tpu_torch.models.masking import MaskingModel
    from isubgvqa_tpu_torch.sampling import init_aimle_state

    head = MaskingModel(8, 8, 3, sampler_type=sampler).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    scores = torch.randn(b, n, device="cuda")
    scores[:, 3 * n // 4:] = 0.0
    dy = torch.randn(b, n, device="cuda")
    st = init_aimle_state("cuda", initial_beta=AIMLE_BETA)

    def call():
        if not train:
            with torch.inference_mode():
                return head.sample(scores, False, gen, None, st)
        x = scores.clone().requires_grad_()
        return torch.autograd.grad(head.sample(x, True, gen, None, st), x,
                                   dy)

    ms = time_ms(call)
    launches = {}
    _, fam = device_profile(call, launches)
    return ms, sum(launches.values()), sum(fam.values())


def simple_dp_ms():
    """Simple's marginals DP alone (``exact_k_marginals``, k = 3) at each
    node cap: the log-depth scan at B = 2048 (eval) and its forward +
    backward at B = 256 (training), with its CUDA kernels; the
    step-by-step DP (``esp_sequential``) beside it at B = 2048."""
    import torch
    from isubgvqa_tpu_torch.sampling import simple

    out = {}
    for n in NODE_CAPS:
        s = torch.randn(2048, n, device="cuda")
        s[:, 3 * n // 4:] = 0.0
        x = torch.randn(256, n, device="cuda", requires_grad=True)
        w = torch.randn(256, n, device="cuda")

        def fwd():
            with torch.inference_mode():
                return simple.exact_k_marginals(s, 3)

        def seq():
            with torch.inference_mode():
                return simple.exact_k_marginals(s, 3,
                                                esp=simple.esp_sequential)

        def fwd_bwd():
            return torch.autograd.grad(simple.exact_k_marginals(x, 3), x, w)

        err = (fwd() - seq()).abs().max().item()
        if not err <= 1e-5:
            raise AssertionError(f"simple DP at N={n}: log-depth against "
                                 f"step-by-step {err}")
        row = {"eval_ms": time_ms(fwd), "seq_eval_ms": time_ms(seq, iters=3),
               "train_ms": time_ms(fwd_bwd), "max_abs_vs_seq": err}
        for name, fn in (("eval", fwd), ("train", fwd_bwd), ("seq_eval", seq)):
            launches = {}
            _, fam = device_profile(fn, launches)
            row[name + "_kernels"] = sum(launches.values())
            row[name + "_device_ms"] = sum(fam.values())
        out[n] = row
    return out


def shares(cost_by_n, per_bucket, weights, key):
    """Per bucket ``cost / bucket time`` and the mix-weighted blend
    ``sum w * cost / sum w * time``."""
    by, num, den = {}, 0.0, 0.0
    for bkey, entry in per_bucket.items():
        n = int(bkey.strip("()").split(",")[0])
        by[bkey] = cost_by_n[n] / entry[key]
        num += weights[bkey] * cost_by_n[n]
        den += weights[bkey] * entry[key]
    return by, num / den


def phase_samplers(gumbel_train_syncs):
    """Phase 11: the imle, aimle and simple samplers through serving, the
    whole forward, the train step and the bench.  Returns each sampler's
    bench launch counts."""
    import torch
    from isubgvqa_tpu_torch import bench, ops

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    inf = bench.build_bench_setup(bench._cfg("imle", BENCH_B, "bfloat16"),
                                  num_batches=4, device=dev)
    trn = bench.build_bench_setup(
        bench._cfg("imle", BENCH_TRAIN_B, "bfloat16"), num_batches=8,
        device=dev, train=True)
    log(f"[11 samplers] fixtures: {len(inf.ds)} samples for B={BENCH_B}, "
        f"{len(trn.ds)} for B={BENCH_TRAIN_B}, in "
        f"{time.perf_counter() - t_phase:.1f} s")
    weights = {str(k): w for k, w in inf.bucket_weight.items()}
    tweights = {str(k): w for k, w in trn.bucket_weight.items()}
    parity_key = max(trn.bucket_batches)         # (128, 32): the largest
    parity_batch = trn.bucket_batches[parity_key][0].to(dev)
    sync_batch = next(iter(trn.bucket_batches.values()))[0].to(dev)
    gumbel_waits = sum(v for k, v in gumbel_train_syncs.items()
                       if "Synchronize" in k)
    counts, rows = {}, {}

    def counted(name, wrappers, fn):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = ops.launch_counts(wrappers)
        if min(got.values()) == 0:
            raise AssertionError(f"{name}: a kernel never launched: {got}")
        counts[name] = got
        log(f"[11 samplers] {name}: {json.dumps(out)}")
        log(f"[11 samplers] {name} launches: {json.dumps(got)}")
        return out

    for sampler in SAMPLERS:
        t0 = time.perf_counter()
        serve_sampler(sampler)

        # (b) the whole eval forward, kernel path against plain path
        isetup = bench.for_sampler(trn, sampler)
        err, std, frac, agree, real, err16, bad = whole_forward_parity(
            isetup.model, isetup.vocab, parity_batch, isetup.aimle_states)
        if not (err16 <= BENCH_BF16_LOGITS_TOL and frac >= BENCH_TOP1_FLOOR):
            raise AssertionError(
                f"{sampler} B={BENCH_TRAIN_B} bf16: logits max abs "
                f"{err16:.3g} (bound {BENCH_BF16_LOGITS_TOL}), top-1 "
                f"agreement {frac:.4f} (floor {BENCH_TOP1_FLOOR})")
        log(f"[11 samplers] {sampler} (b) kernel against plain, "
            f"B={BENCH_TRAIN_B} bucket {parity_key}: f32 (TF32 off) "
            f"logits max abs {err:.3g} (bound 1e-4, logits std {std:.3g}), "
            f"node_mask identical; bf16 logits max abs {err16:.3g} (bound "
            f"{BENCH_BF16_LOGITS_TOL}), top-1 agreement {frac:.4f} "
            f"({agree}/{real}, floor {BENCH_TOP1_FLOOR}), {bad} "
            f"disagreements where the margin exceeds twice the difference")
        del isetup

        # (c) one f32 train step, kernel path against plain path
        tsetup = bench.for_sampler(trn, sampler, train=True)
        phase_train_step_parity(tsetup.state, tsetup.vocab, parity_batch,
                                tag=f"[11 samplers] {sampler} (c)",
                                aimle_beta=AIMLE_BETA)

        # (d) the host's waits on the device in one train step
        step = bench.make_train_step(tsetup.state.model,
                                     tsetup.state.optimizer, tsetup.cfg)
        step(tsetup.state, sync_batch)
        syncs = host_syncs(lambda: step(tsetup.state, sync_batch))
        waits = sum(v for k, v in syncs.items() if "Synchronize" in k)
        if waits > gumbel_waits:
            raise AssertionError(f"{sampler}: {waits} host waits in a train "
                                 f"step against gumbel's {gumbel_waits}")
        log(f"[11 samplers] {sampler} (d) host waits on the device in one "
            f"train step at {BENCH_TRAIN_B}: {json.dumps(syncs)} (gumbel "
            f"{json.dumps(gumbel_train_syncs)})")
        del tsetup, step
        torch.cuda.empty_cache()

        # (e) the bench's rows, with their launches
        row = counted(f"{sampler} bench_inference", ops.EVAL_WRAPPERS,
                      lambda: bench.bench_inference(
                          setup=bench.for_sampler(inf, sampler)))
        train = counted(f"{sampler} bench_train_step", ops.TRAIN_WRAPPERS,
                        lambda: bench.bench_train_step(
                            setup=bench.for_sampler(trn, sampler,
                                                    train=True)))
        rows[sampler] = row, train
        torch.cuda.empty_cache()

        # the sampler's own share of a batch and of a step
        eval_ms = {n: sampler_ms(sampler, BENCH_B, n, False)
                   for n in NODE_CAPS}
        train_ms = {n: sampler_ms(sampler, BENCH_TRAIN_B, n, True)
                    for n in NODE_CAPS}
        by_bucket, blended = shares({n: v[0] for n, v in eval_ms.items()},
                                    row["per_bucket"], weights,
                                    "ms_per_batch")
        tby_bucket, tblended = shares({n: v[0] for n, v in train_ms.items()},
                                      train["per_bucket"], tweights,
                                      "ms_per_step")
        _, dev_blended = shares({n: v[2] for n, v in eval_ms.items()},
                                row["per_bucket"], weights, "ms_per_batch")
        _, tdev_blended = shares({n: v[2] for n, v in train_ms.items()},
                                 train["per_bucket"], tweights,
                                 "ms_per_step")
        log(f"[11 samplers] {sampler} sampler alone: " + json.dumps({
            "eval_ms_kernels_device_ms_at_2048": eval_ms,
            "train_fwd_bwd_ms_kernels_device_ms_at_256": train_ms,
            "share_of_batch": by_bucket, "blended_share_of_batch": blended,
            "share_of_step": tby_bucket, "blended_share_of_step": tblended,
            "blended_device_share_of_batch": dev_blended,
            "blended_device_share_of_step": tdev_blended}))
        log(f"[11 samplers] {sampler} in "
            f"{time.perf_counter() - t0:.1f} s")

    dp = simple_dp_ms()
    row, train = rows["simple"]
    eval_share, eval_blend = shares({n: v["eval_ms"] for n, v in dp.items()},
                                    row["per_bucket"], weights,
                                    "ms_per_batch")
    train_share, train_blend = shares(
        {n: v["train_ms"] for n, v in dp.items()}, train["per_bucket"],
        tweights, "ms_per_step")
    _, eval_dev = shares({n: v["eval_device_ms"] for n, v in dp.items()},
                         row["per_bucket"], weights, "ms_per_batch")
    _, train_dev = shares({n: v["train_device_ms"] for n, v in dp.items()},
                          train["per_bucket"], tweights, "ms_per_step")
    log("[11 samplers] simple's marginals DP alone: " + json.dumps({
        "by_node_cap": dp, "share_of_batch": eval_share,
        "blended_share_of_batch": eval_blend, "share_of_step": train_share,
        "blended_share_of_step": train_blend,
        "blended_device_share_of_batch": eval_dev,
        "blended_device_share_of_step": train_dev}))
    log(f"[11 samplers] phase {time.perf_counter() - t_phase:.1f} s")
    return counts


ENTRY_SIZE = 4096            # phase 12's train questions: 8 or more steps of
# 256 an epoch over two or more node buckets of the GQA-like mix
EXPLAIN_B = 2048             # the explain bench's batch
EXPLAIN_DEV = 8192           # its dev questions (a pass of 10 batches)
MAX_SYNCS_PER_STEP = 3       # the optimizer's two bool() and one metric read


def captured(fn, *args):
    """``fn(*args)`` with its standard output kept; the output is echoed
    and returned beside the result."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    text = buf.getvalue()
    sys.stdout.write(text)
    sys.stdout.flush()
    return out, text


def quiet(fn, *args):
    """``fn(*args)`` with its standard output dropped."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def phase_entry_points():
    """Phase 12: the port's entry points as a user runs them, on the card
    at the full width of the config of record (bf16, batch 256, the
    GQA-like synthetic mix): ``cli.main`` trains 2 epochs, resumes for a
    third, and validates a checkpoint with ``-e``; the ``run_token_coo``
    entry explains 4 batches.  Their launch counts, every kernel at least
    once.  Then the Trainer's checkpoint in ``Predictor`` against the
    Trainer's model in f32; an epoch's wall time, ms a step, the host's
    waits a step and the validation rate; explanation through the kernels
    and through the plain versions (imle, f32), whose sums must agree;
    the explain rate at B = 2048 and the device's busy share of one
    profiled explain batch.  Returns the entry points' launch counts."""
    import torch
    from isubgvqa_tpu_torch import bench, cli, ops, run_token_coo
    from isubgvqa_tpu_torch.data import iterate_batches_bucketed
    from isubgvqa_tpu_torch.explain import run_token_coo_exp
    from isubgvqa_tpu_torch.models.build import build_model
    from isubgvqa_tpu_torch.serve import Predictor

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    out = os.path.join(root, "out")
    argv = ["--synthetic", "--synthetic_shape_mix", "gqa",
            "--synthetic_size", str(ENTRY_SIZE), "--sampler_type", "gumbel",
            "--sample_k", "3", "--mgat_masks", "1", "1", "1", "0.15",
            "--compute_dtype", "bfloat16", "--batch-size", str(TRAIN_B),
            "--meta_dir", "", "--output_dir", out]
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        # 1. train 2 epochs
        t0 = time.perf_counter()
        first, text = captured(cli.main, argv + ["--epochs", "2"])
        train_s = time.perf_counter() - t0
        losses = [float(v) for v in re.findall(
            r"^Epoch: \[\d+\]\[.*\tLoss (\S+) ", text, re.M)]
        val = re.findall(r"^Val epoch \[(\d+)\] dev: Acc@Short (\S+) "
                         r"Loss (\S+)$", text, re.M)
        if not (losses and len(val) == 2 and np.isfinite(losses).all()
                and all(np.isfinite(float(v[2])) for v in val)):
            raise AssertionError(f"training: losses {losses}, val {val}")
        top = float(re.findall(r"so far was (\S+)", text)[-1])
        names = set(os.listdir(out))
        want = {"checkpoint", "checkpoint.meta.json",
                "checkpoint_lowest_val_loss",
                "checkpoint_lowest_val_loss.meta.json"}
        if not want <= names or ("checkpoint_top_res" in names) != (top > 0):
            raise AssertionError(f"checkpoints {sorted(names)} (top "
                                 f"validation accuracy {top})")
        count1 = first.state.optimizer.count
        sched = first.state.optimizer.schedule
        log(f"[12 entry] cli.main 2 epochs in {train_s:.1f} s: optimizer "
            f"count {count1}, checkpoints {sorted(names)}")
        del first
        # 2. resume for a third epoch, then validate the lowest-loss one
        resumed, text = captured(cli.main, argv + ["--epochs", "3",
                                                   "--resume", "checkpoint"])
        got = re.search(r"^=> step (\d+), optimizer count (\d+), learning "
                        r"rate (\S+)$", text, re.M)
        if not (got and int(got.group(2)) == count1
                and float(got.group(3)) == sched(count1)
                and "Epoch: [2][" in text and "Epoch: [1][" not in text):
            raise AssertionError(f"resume: {got and got.group(0)}")
        log(f"[12 entry] resumed at epoch 2: optimizer count {count1}, "
            f"learning rate {got.group(3)} = schedule({count1}) "
            f"{sched(count1)!r}")
        evaluated, text = captured(cli.main, argv + [
            "-e", "--resume", "checkpoint_lowest_val_loss"])
        if not (re.search(r"^Val epoch \[-1\] dev: ", text, re.M)
                and evaluated.state.optimizer.count == 0):
            raise AssertionError("-e did not validate the model only")
        del evaluated
        res, _ = captured(run_token_coo.main, [
            "--ckpt", os.path.join(out, "checkpoint_lowest_val_loss"),
            "--max_batches", "4"])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if min(counts.values()) == 0:
            raise AssertionError(f"entry points: a kernel never launched: "
                                 f"{counts}")
        log(f"[12 entry] launches of cli.main x 3 and run_token_coo: "
            f"{json.dumps(counts)}")

        # 3. the Trainer's checkpoint in Predictor, f32, same noise
        trainer, data = resumed, resumed.data
        cfg32 = dataclasses.replace(trainer.cfg, compute_dtype="float32")
        pred = Predictor.from_checkpoint(os.path.join(out, "checkpoint"),
                                         cfg=cfg32, device="cuda")
        batch, _ = next(iter(iterate_batches_bucketed(
            data.datasets["dev"], data.bucket_collators["dev"])))
        batch = batch.to("cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        noise = -torch.log(-torch.log(torch.rand(
            batch.node_mask.shape, generator=gen,
            device="cuda").clamp_min(1e-30)))
        served = forward_path(pred.model, batch, noise, False)
        model = trainer.state.model
        saved_cfg, model.cfg = model.cfg, cfg32
        try:
            own = forward_path(model, batch, noise, False)
        finally:
            model.cfg = saved_cfg
        err = (served.logits - own.logits).abs().max().item()
        if not (err <= 1e-6 and torch.equal(served.node_mask,
                                            own.node_mask)):
            raise AssertionError(f"Predictor from the checkpoint: logits "
                                 f"{err} from the Trainer's model")
        log(f"[12 entry] Predictor.from_checkpoint against the Trainer's "
            f"model, f32, B={batch.num_graphs}: logits max abs {err:.3g} "
            f"(bound 1e-6), node mask identical")
        del pred, served, own, batch

        # the train epoch's wall, its steps and the host's waits a step
        marks, shapes = [], set()
        step = trainer.train_step

        def marked(state, b):
            marks.append(time.perf_counter())
            shapes.add(tuple(b.node_tokens.shape[1:2]))
            return step(state, b)

        trainer.train_step = marked
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quiet(trainer.train_epoch, 3)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        n_steps = len(marks)
        step_ms = statistics.median(np.diff(marks) * 1e3)
        if n_steps < 8 or len(shapes) < 2:
            raise AssertionError(f"an epoch of {n_steps} steps over node "
                                 f"caps {shapes}")
        marks.clear()
        syncs = host_syncs(lambda: quiet(trainer.train_epoch, 4))
        per_step = {k: v / len(marks) for k, v in syncs.items()}
        if per_step.get("cudaStreamSynchronize", 0) > MAX_SYNCS_PER_STEP:
            raise AssertionError(f"host waits a step: {per_step}")
        trainer.train_step = step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quiet(trainer.validate_epoch, 4)
        val_s = time.perf_counter() - t0
        n_dev = len(data.datasets["dev"])
        log(f"[12 entry] train epoch ({n_steps} steps of {TRAIN_B}, node "
            f"caps {sorted(s[0] for s in shapes)}): {epoch_s:.2f} s, "
            f"{step_ms:.1f} ms a step (median, host clock between steps); "
            f"host calls a step {json.dumps(per_step)}; validation "
            f"{n_dev} questions in {val_s:.2f} s, {n_dev / val_s:.0f} q/s")

        # 4. explanation through the kernels and the plain versions
        weights = torch.load(os.path.join(out, "checkpoint_lowest_val_loss"),
                             map_location="cpu",
                             weights_only=True)["state_dict"]
        cfg16 = trainer.cfg
        cfg_i = dataclasses.replace(cfg16, sampler_type="imle",
                                    compute_dtype="float32")
        model_i = build_model(cfg_i, data.vocab, "cuda", state_dict=weights)
        del trainer, resumed
        gap, diff = float("inf"), 0.0
        for b, meta in iterate_batches_bucketed(
                data.datasets["dev"], data.bucket_collators["dev"]):
            b = b.to("cuda")
            k = forward_path(model_i, b, None, False).logits[:meta.num_real]
            p = forward_path(model_i, b, None, True).logits[:meta.num_real]
            diff = max(diff, (k - p).abs().max().item())
            top2 = p.topk(2, dim=-1).values
            gap = min(gap, (top2[:, 0] - top2[:, 1]).min().item())
        sums = []
        for plain in (False, True):
            with eval_layers(plain):
                sums.append(quiet(lambda: run_token_coo_exp(model_i, data,
                                                            cfg_i)))
        if sums[0].sums != sums[1].sums:
            raise AssertionError(f"explain sums: kernels {sums[0].sums}, "
                                 f"plain {sums[1].sums}")
        log(f"[12 entry] explain, imle f32, {n_dev} questions: sums equal "
            f"through the kernels and the plain versions "
            f"{json.dumps(sums[0].sums)}; smallest top-1 logit gap "
            f"{gap:.3g}, largest logit difference {diff:.3g}")
        del model_i
        torch.cuda.empty_cache()

        # the explain rate at 2048, and one profiled explain batch
        row = bench.bench_explain(batch_size=EXPLAIN_B, dev_size=EXPLAIN_DEV,
                                  passes=3, device="cuda")
        log(f"[12 entry] bench_explain: {json.dumps(row)}")
        model = build_model(cfg16, data.vocab, "cuda", state_dict=weights)

        def one_batch():
            quiet(lambda: run_token_coo_exp(model, data, cfg16,
                                            max_batches=1))

        one_batch()                                   # warm-up, unprofiled
        wall, fam = device_profile(one_batch)
        busy = sum(fam.values())
        log(f"[12 entry] one profiled explain batch (B="
            f"{cfg16.batch_size * cfg16.eval_batch_factor}, bf16, the "
            f"checkpoint's weights, collate included): wall {wall:.1f} ms, "
            f"device busy {busy:.2f} ms "
            + (f"({busy / wall:.1%}); by kernel: {by_kernel(fam)}" if busy
               else "(not measured: no CUDA events)"))
        del res
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[12 entry] phase {time.perf_counter() - t_phase:.1f} s")
    return counts


# Phase 13: the config variants, each at the full width of the config of
# record with only its own fields changed.
VARIANTS = {
    "use_all_instrs": dict(use_all_instrs=True),
    "concat_instr": dict(concat_instr=True),
    "use_global_mask": dict(use_global_mask=True),
    "interpretable_mode": dict(interpretable_mode=True),
    "node_classification": dict(node_classification=True),
    "use_topk=0": dict(use_topk=False),
    "masks (0.3, 1, 0.5, 0.15)": dict(mgat_masks=(0.3, 1.0, 0.5, 0.15)),
    "text_sampling": dict(text_sampling=True),
    "use_instruction=0": dict(use_instruction=False),
}
TRAIN_VARIANTS = ("concat_instr", "interpretable_mode", "text_sampling")
VARIANT_QUESTIONS = 256      # served by each variant
VARIANT_B = 128              # its serving batch
VARIANT_LOGITS_TOL = 1e-5    # f32 kernel path against plain path
# run_token_coo_exp under text_sampling: 1024 dev questions over 8
# answers, the commonest of which every question is given
EXPLAIN_BATCHES = 8
EXPLAIN_ANSWERS = 8
# all of one f32 train step's gradients: RMS error over RMS (phase 7's
# per-layer bound; each leaf alone keeps phase 9's 3e-3)
VARIANT_GRAD_TOL = 1.4e-4
# #5 at ci = 600 in f32, each gradient's RMS error over its RMS against an
# f64 evaluation of the same formula: the kernel's within phase 7's f32
# bound; the plain f32 path's, and kernel against plain, within phase
# 9's per-leaf bound.  A leaky-ReLU input on the other side of 0 from
# f64's takes the other slope and moves its gradients by O(1) of
# themselves (one such input of 1.2e7 read 1.9e-4 of the RMS), and some
# draws gave the plain f32 path several; preact_flips counts them
VARIANT_CONV_GRAD_TOL = 3e-3


def site_noise(cfg, batch, gen):
    """A standard Gumbel draw for each sampling site of ``cfg`` (gumbel
    sampler): text sampling ``[1, B, L]``, each masked layer ``[B, N]``."""
    import torch

    dev = batch.node_mask.device
    draw = lambda *shape: -torch.log(-torch.log(torch.rand(
        shape, generator=gen, device=dev).clamp_min(1e-30)))
    b, n = batch.node_mask.shape
    noise = {i: draw(b, n) for i, t in enumerate(cfg.mgat_masks)
             if float(t) != 1.0}
    if cfg.text_sampling:
        noise["text"] = draw(1, b, batch.qst_tokens.shape[1])
    return noise


def variant_parity(model, vocab, batches):
    """The variant's eval forward through the kernels and through the
    plain versions on ``batches`` with the same noise: f32 (TF32 off)
    logits within VARIANT_LOGITS_TOL, the node mask and ``mask_text``
    identical; bf16 top-1 agreement, with the rows whose node mask differs
    and the disagreements where the plain path's top-1 leads by more than
    twice the largest logit difference.  Returns ``(f32 logits max abs,
    node head max abs, bf16 agreeing, real, bf16 rows with another node
    mask, resolved disagreements)``."""
    import torch
    from isubgvqa_tpu_torch.models.build import build_model

    sd = {k: v.float() for k, v in model.state_dict().items()}
    cfg32 = dataclasses.replace(model.cfg, compute_dtype="float32")
    dev = batches[0].node_mask.device
    m32 = build_model(cfg32, vocab, dev, state_dict=sd)
    gen = torch.Generator(device=dev).manual_seed(3)
    err = head = 0.0
    agree = real = masks16 = resolved = 0
    for batch in batches:
        noise = site_noise(model.cfg, batch, gen)
        k, p = (forward_path(m32, batch, noise, plain) for plain in (0, 1))
        err = max(err, (k.logits - p.logits).abs().max().item())
        if not err <= VARIANT_LOGITS_TOL:
            raise AssertionError(f"f32 logits differ by {err}")
        if not torch.equal(k.node_mask.round(), p.node_mask.round()):
            raise AssertionError("f32 node mask differs")
        if (k.mask_text is None) != (p.mask_text is None) or (
                k.mask_text is not None
                and not torch.equal(k.mask_text.round(), p.mask_text.round())):
            raise AssertionError("f32 mask_text differs")
        for a, c in zip(k.node_logits_layers, p.node_logits_layers):
            head = max(head, (a - c).abs().max().item())
        k16, p16 = (forward_path(model, batch, noise, plain)
                    for plain in (0, 1))
        rows = batch.sample_mask > 0
        same = k16.logits.argmax(-1) == p16.logits.argmax(-1)
        agree += int(same[rows].sum())
        real += int(rows.sum())
        masks16 += int((k16.node_mask.round() != p16.node_mask.round())
                       .any(1)[..., 0][rows].sum())
        top2 = p16.logits.topk(2, dim=-1).values
        gap = 2 * (k16.logits - p16.logits).abs().max().item()
        resolved += int((rows & ~same & (top2[:, 0] - top2[:, 1] > gap))
                        .sum())
    del m32
    return err, head, agree, real, masks16, resolved


def add_launches(acc, fn, *args, **kw):
    """``fn(*args, **kw)`` with every launch count set to 0 just before it
    and read just after; the counts are added to ``acc``."""
    import torch
    from isubgvqa_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    for k, v in ops.launch_counts().items():
        acc[k] = acc.get(k, 0) + v
    return out


def preact_flips(xf, gate, src, dst, em, ea, masters):
    """#5's leaky-ReLU inputs ``m1 = (x_l[src] + x_r[dst] + eproj) * egate``
    whose sign differs from an f64 evaluation's, over the valid edges with
    both gates on, for f32 inputs: ``(kernel's, plain f32 path's, elements
    counted)``.  The kernel's ``m1`` is formed from its own products (the
    3xTF32 GEMM of ``csrc/gemm.cu``), summed in its order
    (``csrc/gat_kernel.cu``), so it equals the edge kernel's."""
    import torch
    from isubgvqa_tpu_torch.ops.gemm import gemm, plain_product, product

    b, n, ci = xf.shape
    e = src.shape[1]
    w = {k: v.detach() for k, v in masters.items()}
    xw = xf.detach().reshape(b * n, ci).contiguous()
    et = ea.detach().reshape(b * e, -1).contiguous()
    s, d = src.long(), dst.long()

    def m1(x_l, x_r, ep, acc):
        g = gate.detach().reshape(b, n).to(acc)
        pick = lambda t, i: torch.gather(
            t.to(acc).reshape(b, n, -1), 1,
            i[..., None].expand(-1, -1, t.shape[-1]))
        eg = (torch.gather(g, 1, s) * torch.gather(g, 1, d))[..., None]
        return ((pick(x_l, s) + pick(x_r, d))
                + ep.to(acc).reshape(b, e, -1)) * eg, eg

    def plain(acc):
        lin = lambda x, k: plain_product(x.to(acc), w[k].to(acc).t())
        return m1(lin(xw, "wl") + w["bl"].to(acc),
                  lin(xw, "wr") + w["br"].to(acc), lin(et, "we"), acc)

    with torch.no_grad():
        f32 = lambda k: w[k].float().contiguous()
        kern, _ = m1(gemm([(xw, None)], f32("wl"), f32("bl")),
                     gemm([(xw, None)], f32("wr"), f32("br")),
                     product([(et, None)], f32("we"), None), torch.float32)
        ref, eg = plain(torch.float64)
        valid = em.bool()[..., None] & (eg != 0)
        flips = lambda t: int((((t >= 0) != (ref >= 0)) & valid).sum())
        return (flips(kern), flips(plain(torch.float32)[0]),
                int(valid.sum()) * ref.shape[-1])


def variant_kernel_times(model, device):
    """#1 with ``apply_mask_to_h`` at a 600-wide input as a ``concat_instr``
    layer runs it (``[h | instr]`` built, then read as one ``xf``), and
    #5 forward + backward at a 600-wide input, each against its plain
    version at B = 256, (N, E) = (128, 384), f32 (TF32 off) and bf16,
    timed (CUDA events, median of 10) beside its bound; and #1's x_l / x_r
    product alone, ``[h | instr]`` built and read as one ``xf`` against
    read as two segments of the GEMM (``h``, then the instruction rows
    gathered by each node's graph: the design #1 does not use), each
    timed twice in turn.  Returns ``{kernel: [entries]}``."""
    import torch
    from isubgvqa_tpu_torch.ops import flops as FL
    from isubgvqa_tpu_torch.ops import gat_kernel as G
    from isubgvqa_tpu_torch.ops import gat_train as GT
    from isubgvqa_tpu_torch.ops.gemm import product

    rng = np.random.default_rng(13)
    gen = torch.Generator(device=device).manual_seed(13)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)
    c, heads, b = model.cfg.general_hidden_dim, model.cfg.gat_heads, GRAPH_B
    n, e = GRAPH_BUCKETS[-1]
    nm, em, src, dst = random_graphs(rng, b, n, e, device)
    nv, ev = int(nm.sum()), int(em.sum())
    out = {"fused_gat_layer": [], "fused_gatconv": []}
    gp = model.gat_seq.layer_params(3)        # the masked layer: 2C-wide
    masters = {k: v.detach().float().clone().requires_grad_(True)
               for k, v in gp.items() if k in GT.CONV_KEYS}
    rows = torch.arange(b * n, device=device, dtype=torch.int32)
    graph_of_row = torch.div(rows, n, rounding_mode="floor")
    for dtype in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        p = ship(gp, dtype)
        h = rnd(b, n, c).to(dtype)
        ea = rnd(b, e, c).to(dtype)
        ins = (0.5 * rnd(b, c)).to(dtype)
        gate = (torch.rand(b, n, 1, generator=gen, device=device) > 0.6).to(
            dtype)
        xf = G.concat_instr_features(h, ins)
        args = lambda: (h, G.concat_instr_features(h, ins), ins, gate, src,
                        dst, em, nm, ea, p)
        fn = lambda: G.fused_gat_layer(*args(), apply_mask_to_h=True)
        plain = lambda: G.fused_gat_layer_plain(*args(), apply_mask_to_h=True)
        err, _ = compare("fused_gat_layer concat_instr", fn(), plain(), tol)
        ms, plain_ms = time_ms(fn), time_ms(plain)
        b_ms, b_by = bound(
            FL.gat_layer_flops(nv, ev, c, heads, ci=2 * c,
                               apply_mask_to_h=True),
            nbytes(h, ins, gate, src, dst, em, nm, ea, p, h,
                   torch.empty(b, e, heads)), dtype)
        shape = (f"B={b} N={n} E={e} apply_mask_to_h, [h | instr] built, "
                 f"one {2 * c}-wide xf")
        log(f"[13 variants] fused_gat_layer {shape} {str(dtype)[6:]}: "
            f"max abs {err:.3g}; {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        out["fused_gat_layer"].append(dict(
            shape=shape, dtype=str(dtype)[6:], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        # the x_l / x_r product alone: [h | instr] built and read as one
        # xf, against read as two segments
        w_lr, b_lr = G.stacked_lr(p)
        one = lambda: product(
            [(G.concat_instr_features(h, ins).reshape(b * n, -1), None)],
            w_lr, b_lr, out_dtype=dtype)
        two = lambda: product([(h.reshape(b * n, c), None),
                               (ins, graph_of_row)], w_lr, b_lr,
                              out_dtype=dtype)
        err, _ = compare("x_l / x_r product, one xf against two segments",
                         (one(),), (two(),), tol)
        turns = [(time_ms(one), time_ms(two)) for _ in range(2)]
        log(f"[13 variants] x_l / x_r product at K = {2 * c} "
            f"{str(dtype)[6:]}: one xf (the concatenation built) "
            f"{turns[0][0]:.4f} / {turns[1][0]:.4f} ms, two segments "
            f"{turns[0][1]:.4f} / {turns[1][1]:.4f} ms (one, two, one, two); "
            f"max abs {err:.3g} between them")
        out["fused_gat_layer"].append(dict(
            shape=f"B={b} N={n} x_l / x_r product at K = {2 * c}",
            dtype=str(dtype)[6:], one_xf_ms=[t[0] for t in turns],
            segments_ms=[t[1] for t in turns], max_abs_err=err))
        inputs = [t.clone().requires_grad_(True) for t in (xf, gate, ea)]
        wrap = lambda f: (lambda x, g, a, q: f(x, g, src, dst, em, a, q))
        cots = (rnd(b, n, heads * c), rnd(b, e, heads))
        run, run_plain = (fwd_bwd(wrap(f), inputs, masters, cots)
                          for f in (GT.fused_gatconv, GT.fused_gatconv_plain))
        (o, g), (op, gp_) = run(), run_plain()
        shape = f"B={b} N={n} E={e} ci={2 * c}"
        err, _ = compare(f"fused_gatconv {shape}", o, op, tol)
        exact, extra = "", {}
        if dtype == torch.float32:
            # the same formula in f64 (the plain version, unrounded)
            f64 = lambda ts: [t.detach().double().requires_grad_(True)
                              for t in ts]
            _, g64 = fwd_bwd(wrap(GT.fused_gatconv_plain), f64(inputs),
                             dict(zip(masters, f64(masters.values()))),
                             [t.double() for t in cots])()
            k64 = compare_grads(f"fused_gatconv {shape} kernel vs f64", g,
                                g64, dtype)
            p64 = compare_grads(f"fused_gatconv {shape} plain vs f64", gp_,
                                g64, dtype, VARIANT_CONV_GRAD_TOL)
            kf, pf, total = preact_flips(xf, gate, src, dst, em, ea, masters)
            exact = (f" (against the f64 evaluation: kernel {k64:.3g}, "
                     f"plain {p64:.3g}; leaky-ReLU inputs on the other side "
                     f"of 0 from f64's: kernel {kf}, plain {pf} of {total})")
            extra = dict(grad_err_vs_f64={"kernel": k64, "plain": p64},
                         preact_sign_flips={"kernel": kf, "plain": pf,
                                            "of": total})
        gerr = compare_grads(f"fused_gatconv {shape}", g, gp_, dtype,
                             VARIANT_CONV_GRAD_TOL
                             if dtype == torch.float32 else None)
        ms, plain_ms = time_ms(run), time_ms(run_plain)
        b_ms, b_by = bound(FL.gatconv_train_flops(nv, ev, c, heads, ci=2 * c),
                           nbytes(inputs, masters, o, g), dtype)
        log(f"[13 variants] fused_gatconv {shape} {str(dtype)[6:]}: out max "
            f"abs {err:.3g}, gradients RMS error of RMS <= {gerr:.3g}{exact}"
            f"; fwd+bwd {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        out["fused_gatconv"].append(dict(
            shape=shape, dtype=str(dtype)[6:], max_abs_err=err,
            grad_err=gerr, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, **extra))
        del run, run_plain, o, g, op, gp_, inputs
    return out


def phase_variants(dev):
    """Phase 13: the config variants at full width on the card.  Each
    variant (bf16, seeded random weights) serves VARIANT_QUESTIONS
    questions of the GQA-like mix through ``Predictor``, then its eval
    forward runs through the kernels and through the plain versions on
    the same questions and noise (f32 logits within VARIANT_LOGITS_TOL,
    masks identical; bf16 top-1 agreement); the explainer bypass at
    stages 0 and 2 likewise.  ``concat_instr``, ``interpretable_mode``
    and ``text_sampling`` each take one train step at 256 through
    ``make_train_step`` and one f32 step kernel against plain;
    ``run_token_coo_exp`` explains EXPLAIN_BATCHES batches under
    ``text_sampling`` and counts the text co-occurrence.
    Then #1 and #5 at the variants' shapes, timed.  Returns ``(launch
    counts of the variants' paths, timed entries)``."""
    import torch
    from isubgvqa_tpu_torch import ops
    from isubgvqa_tpu_torch.data import (AnswerMap, SceneGraphVocab,
                                         SyntheticGQA, build_bucket_collators,
                                         build_datasets, build_tokenizer,
                                         iterate_batches_bucketed)
    from isubgvqa_tpu_torch.explain import run_token_coo_exp
    from isubgvqa_tpu_torch.models.build import build_model
    from isubgvqa_tpu_torch.serve import Predictor
    from isubgvqa_tpu_torch.train import create_train_state, make_train_step

    t_phase = time.perf_counter()
    base = serving_config()
    vocab = SceneGraphVocab.build("", seed=base.seed)
    answers = AnswerMap.build("", base.num_answers)
    base = dataclasses.replace(base, num_answers=len(answers))
    ds = SyntheticGQA(vocab, answers, size=VARIANT_QUESTIONS, seed=2,
                      shape_mix="gqa")
    questions = [ds.samples[i][2] for i in range(len(ds))]
    graphs = [ds.store.scene_graphs[ds.samples[i][1]] for i in range(len(ds))]
    counts = {}
    for name, over in VARIANTS.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(base, **over)
        pred = Predictor(cfg, vocab, answers, device=dev)
        res = add_launches(counts, pred.predict, questions, graphs,
                      batch_size=VARIANT_B, seed=0)
        torch.cuda.synchronize()
        if len(res) != len(questions) or not all(
                np.isfinite(r.confidence) for r in res):
            raise AssertionError(f"{name}: serving returned {len(res)} "
                                 f"answers or a non-finite one")
        colls = build_bucket_collators(cfg, pred.tokenizer, vocab,
                                       batch_size=VARIANT_B)
        batches = [bt.to(dev) for bt, _ in iterate_batches_bucketed(ds,
                                                                    colls)]
        err, head, agree, real, masks16, resolved = variant_parity(
            pred.model, vocab, batches)
        kept = np.mean([len(r.subgraph_nodes) for r in res])
        log(f"[13 variants] {name}: {len(res)} answers over {len(batches)} "
            f"batches, {kept:.2f} nodes kept a question; f32 logits max abs "
            f"{err:.3g} (bound {VARIANT_LOGITS_TOL})"
            + (f", node head max abs {head:.3g}" if cfg.node_classification
               else "") + ", node mask"
            + (" and mask_text" if cfg.text_sampling else "")
            + f" identical; bf16 top-1 agreement {agree}/{real} ("
            f"{masks16} rows with another node mask, {resolved} "
            f"disagreements where the plain top-1 leads by more than twice "
            f"the logit difference) ({time.perf_counter() - t0:.1f} s)")
        del pred, batches
    # the explainer bypass on the config of record: stage 0 feeds the
    # token sum (the plain forward's logits), stage 2 GAT layer 1's input
    m32 = build_model(dataclasses.replace(base, compute_dtype="float32"),
                      vocab, dev)
    coll = build_bucket_collators(
        base, build_tokenizer(None, max_len=base.question_len,
                              vocab_size=base.text_vocab_size),
        vocab, batch_size=VARIANT_B)
    batch = next(iterate_batches_bucketed(
        [ds[i] for i in range(VARIANT_B)], coll))[0].to(dev)
    noise = site_noise(base, batch, torch.Generator(device=dev).manual_seed(5))
    emb = m32.scene_graph_encoder.sg_vocab_embedding.weight
    b, n = batch.node_mask.shape
    for stage, x in ((0, emb[batch.node_tokens.long()].sum(-2)),
                     (2, torch.randn(b, n, base.general_hidden_dim,
                                 device=dev))):
        kw = dict(explainer=True, explainer_stage=stage, expl_bypass_x=x)
        with torch.no_grad():
            k = add_launches(counts, m32, batch, noise=noise, **kw)
            with eval_layers(True):
                p = m32(batch, noise=noise, **kw)
            want = m32(batch, noise=noise).logits if stage == 0 else p
        err = max((k - p).abs().max().item(), (k - want).abs().max().item())
        if not (isinstance(k, torch.Tensor) and err <= VARIANT_LOGITS_TOL):
            raise AssertionError(f"explainer stage {stage}: {err}")
        log(f"[13 variants] explainer stage {stage}: bare logits "
            f"{tuple(k.shape)}, kernel against plain"
            + (" and against the forward without the bypass" if stage == 0
               else "") + f" max abs {err:.3g}")
    del m32
    # the train step of three variants at 256
    _, tbatches = training_batches(dataclasses.replace(
        train_config(), num_answers=len(answers)), vocab, answers, 1)
    tbatch = tbatches[0][1].to(dev)
    for name in TRAIN_VARIANTS:
        cfg = dataclasses.replace(train_config(), num_answers=len(answers),
                                  **VARIANTS[name])
        state = create_train_state(cfg, vocab, steps_per_epoch=8, device=dev)
        step = make_train_step(state.model, state.optimizer, cfg)
        state, m = add_launches(counts, step, state, tbatch)
        loss = float(m["loss_sum"] / m["count"])
        if not np.isfinite(loss):
            raise AssertionError(f"{name}: train step loss {loss}")
        log(f"[13 variants] {name}: train step at {TRAIN_B}, bf16: loss "
            f"{loss:.5f}, grad norm {float(m['grad_norm']):.5f}")
        phase_train_step_parity(state, vocab, tbatch,
                                tag=f"[13 variants] {name} train step",
                                bf16=False, whole_tol=VARIANT_GRAD_TOL)
        del state, step
    torch.cuda.empty_cache()
    # explanation under text_sampling
    ecfg = dataclasses.replace(
        base, text_sampling=True, synthetic=True, synthetic_size=4096,
        synthetic_shape_mix="gqa", eval_batch_factor=1, batch_size=VARIANT_B,
        num_answers=EXPLAIN_ANSWERS)
    data = build_datasets(ecfg)
    ecfg = dataclasses.replace(ecfg, num_answers=len(data.answers))
    model = build_model(ecfg, data.vocab, dev)
    # the text co-occurrence is counted over right answers whose explained
    # words match a node label: lift the commonest dev answer's logit so
    # that every question gets it (random weights answer nothing right;
    # with EXPLAIN_ANSWERS answers it is right for about one in seven),
    # and decode the hash tokenizer's ids (it has no inverse) by a table
    # of the dev questions' words
    dev_set = data.datasets["dev"]
    common = int(np.bincount([dev_set[i].label
                              for i in range(len(dev_set))]).argmax())
    with torch.no_grad():
        model.logit_fc.bias[common] += 100.0
    tok = data.tokenizer
    table = {tok._token_id(w): w for s in dev_set.samples
             for w in tok.tokenize(s[2])}
    tok.decode_token = lambda i: table.get(i, f"<tok{i}>")
    res, text = captured(lambda: add_launches(
        counts, run_token_coo_exp, model, data, ecfg, split="dev",
        max_batches=EXPLAIN_BATCHES))
    lines = [ln.split(":")[0] for ln in text.strip().splitlines()[-5:]]
    if lines != ["Accuracy", "Accuracy AT", "Ans. Tok. Coo", "Qst. Tok. Coo",
                 "Qst. Text Tok. Coo"] or res.num_samples <= 0:
        raise AssertionError(f"run_token_coo_exp printed {lines}")
    if not (res.sums["text_n"] > 0 and np.isfinite(res.text_token_coo)):
        raise AssertionError(f"text co-occurrence not counted: text_n "
                             f"{res.sums['text_n']}, Qst. Text Tok. Coo "
                             f"{res.text_token_coo}")
    oracle, _ = captured(lambda: run_token_coo_exp(
        model, data, ecfg, split="dev", max_batches=EXPLAIN_BATCHES,
        fast_metrics=False))
    off = {k: (v, oracle.sums[k]) for k, v in res.sums.items()
           if not abs(v - oracle.sums[k]) <= 1e-9}
    if off:
        raise AssertionError(f"run_token_coo_exp's pass against its "
                             f"per-sample oracle: {off}")
    log(f"[13 variants] run_token_coo_exp, text_sampling: "
        f"{res.num_samples} questions, {int(res.sums['acc_sum'])} right; "
        f"text explanations counted in {int(res.sums['text_n'])}, Qst. Text "
        f"Tok. Coo {res.text_token_coo:.6g}; every sum equal to the "
        f"per-sample oracle's")
    del model, data
    torch.cuda.empty_cache()
    missing = [k for k in ops.launch_counts() if not counts.get(k)]
    if missing:
        raise AssertionError(f"phase 13 never launched {missing}: {counts}")
    log(f"[13 variants] launches of the variants' paths: {json.dumps(counts)}")
    times = variant_kernel_times(build_model(
        dataclasses.replace(base, compute_dtype="float32", concat_instr=True),
        vocab, dev), dev)
    log(f"[13 variants] phase {time.perf_counter() - t_phase:.1f} s")
    return counts, times


# Phase 14: the native collate fill and data parallelism.
FILL_BATCHES = 22            # the bench's mix: 22 x 2048 samples, 8 buckets
DDP_SIZE = 2048              # the CLI runs' train questions: a few steps
DDP_TIMEOUT = 300            # s, the torchrun job
# torchrun against no group: a tensor may differ by the f32 rounding of
# its gradient, which Adam turns into a share of one update (the first
# epoch's learning rate is 1e-6, so a step moves an element by about
# 1e-6); the bound is a tenth of that, where a fault (a wrong sum or
# count) moves whole tensors by updates and the metric lines with them
DDP_ATOL = 1e-7


@contextlib.contextmanager
def python_fill():
    """Inside, collators built select the Python fill
    (``ISUBGVQA_NATIVE=0``)."""
    saved = os.environ.get("ISUBGVQA_NATIVE")
    os.environ["ISUBGVQA_NATIVE"] = "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("ISUBGVQA_NATIVE", None)
        else:
            os.environ["ISUBGVQA_NATIVE"] = saved


def silent(fn, *args):
    """``fn(*args)`` with its standard output kept and not echoed:
    ``(result, text)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def metric_lines(text):
    """The CLI's metric lines without their times: each epoch line's
    loss, grad norm and accuracy fields, the validation lines and the
    best-accuracy lines."""
    out = []
    for line in text.splitlines():
        if line.startswith("Epoch: ["):
            out.append(" ".join(f for f in line.split("\t")
                                if not f.startswith(("Time", "Data"))))
        elif line.startswith(("Val epoch", "Top validation")):
            out.append(line)
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def step_ms(step, state, batch, n=6):
    """Median host ms of ``n`` train steps on one batch, each ended by a
    synchronize, after one warm-up step."""
    import torch

    step(state, batch)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(statistics.median(times))


def phase_native_ddp(smi):
    """Phase 14: the native C++ collate fill and data-parallel training.
    (a) Over the bench's mix (22 x 2048 samples, 8 buckets) every batch
    of the native fill equals the Python fill's (``ISUBGVQA_NATIVE=0``)
    bit for bit, the truncation counts too; each fill's rate. (b)
    ``bench_e2e`` (gumbel, B = 2048, the median of 3 epochs) with each
    fill beside ``bench_inference``'s device-only rate. (c) Serving 64
    questions with each fill: wall ms and the device's busy share. (d)
    ``cli.main`` trains one epoch of 2,048 questions without a process
    group; that Trainer's epoch with each fill: ms a step and the host's
    waits a step; a train step's ms without and with a one-rank NCCL
    group (the all-reduces), each with one profiled step. (e) ``torchrun
    --standalone --nproc_per_node=1 -m isubgvqa_tpu_torch.cli`` (NCCL)
    with the same flags: its metric lines equal the run without a
    group's, and its parameters and BatchNorm buffers too, bitwise or
    within ``DDP_ATOL``; a second run without a group shows how far two
    runs differ at all.  Any failure raises."""
    import torch
    from isubgvqa_tpu_torch import bench, cli, ops, parallel
    from isubgvqa_tpu_torch.data import (SyntheticGQA, build_bucket_collators,
                                         build_datasets,
                                         iterate_batches_bucketed,
                                         route_to_buckets)
    from isubgvqa_tpu_torch.serve import Predictor

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    counts = {}

    def zero_counts():
        torch.cuda.synchronize()
        ops.reset_launch_counts()

    def read_counts(name, wrappers):
        """The launches since :func:`zero_counts`; every kernel of
        ``wrappers`` must have launched."""
        torch.cuda.synchronize()
        got = ops.launch_counts(wrappers)
        if min(got.values()) == 0:
            raise AssertionError(f"{name}: a kernel never launched: {got}")
        counts[name] = got

    def counted(name, wrappers, fn):
        """``fn()`` with the launch counts set to 0 just before and read
        just after."""
        zero_counts()
        out = fn()
        read_counts(name, wrappers)
        return out

    setup = bench.build_bench_setup(bench._cfg("gumbel", BENCH_B, "bfloat16"),
                                    num_batches=FILL_BATCHES, device=dev)
    cfg, ds = setup.cfg, setup.ds
    tok = next(iter(setup.collators.values())).tokenizer
    log(f"[14 native] fixture: {len(ds)} samples in "
        f"{time.perf_counter() - t_phase:.1f} s; {smi}")

    # (a) every batch of the mix through both fills
    def fill_set(python):
        with python_fill() if python else contextlib.nullcontext():
            return build_bucket_collators(cfg, tok, setup.vocab,
                                          batch_size=BENCH_B,
                                          pin_memory=not python)

    native, py = fill_set(False), fill_set(True)
    if not (all(c.native for c in native.values())
            and not any(c.native for c in py.values())):
        raise AssertionError("ISUBGVQA_NATIVE did not select the fill")
    chunks = [(key, [ds[j] for j in members[i:i + BENCH_B]])
              for key, members in route_to_buckets(ds, native).items()
              for i in range(0, len(members), BENCH_B)]
    n = sum(len(c) for _, c in chunks)

    def fill(colls):
        t0 = time.perf_counter()
        out = [colls[key].collate(samples)[0] for key, samples in chunks]
        return out, time.perf_counter() - t0

    got, first_s = fill(native)          # packs every graph, then fills
    del got
    got, native_s = fill(native)
    want, python_s = fill(py)
    for i, (a, b) in enumerate(zip(got, want)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if not (x.dtype == y.dtype and torch.equal(x, y)):
                raise AssertionError(f"batch {i} {f.name}: native != python")
    if not all(b.is_pinned() for b in got):
        raise AssertionError("the native fill's batches are not pinned")
    trunc = [(sum(c.truncated_nodes for c in colls.values()),
              sum(c.truncated_edges for c in colls.values()))
             for colls in (native, py)]
    if trunc[0] != (2 * trunc[1][0], 2 * trunc[1][1]):  # native filled twice
        raise AssertionError(f"truncation counts {trunc}")
    del got, want
    log(f"[14 native] {n} samples in {len(chunks)} batches over "
        f"{len(native)} buckets: native fill bit-exact against the Python "
        f"fill, truncated nodes / edges {trunc[1][0]} / {trunc[1][1]} in "
        f"both; native {n / native_s:,.0f} samples/s ({native_s * 1e3:.1f} "
        f"ms; first pass with packing {n / first_s:,.0f}), Python "
        f"{n / python_s:,.0f} samples/s ({python_s * 1e3:.1f} ms); {smi}")

    # (b) the pipeline with each fill, beside the device-only rate
    inf = bench.bench_inference(setup=setup)
    rows = {"native": counted("e2e_native", ops.EVAL_WRAPPERS,
                              lambda: bench.bench_e2e(setup=setup, epochs=3)),
            "python": counted("e2e_python", ops.EVAL_WRAPPERS,
                              lambda: bench.bench_e2e(
                                  setup=dataclasses.replace(
                                      setup, collators=py), epochs=3))}
    for fill_kind, row in rows.items():
        if row["fill"] != fill_kind:
            raise AssertionError(f"bench_e2e ran the {row['fill']} fill")
        log(f"[14 native] bench_e2e ({fill_kind} fill): "
            f"{row['e2e_qps_per_chip']:,.0f} q/s (best "
            f"{row['e2e_qps_best']:,.0f}; epochs {row['epoch_seconds']}), "
            f"{row['e2e_qps_per_chip'] / inf['qps_per_chip']:.3f} of "
            f"bench_inference's {inf['qps_per_chip']:,.0f} q/s in this run; "
            f"{smi}")
    del setup, native, py, chunks, rows
    torch.cuda.empty_cache()

    # (c) serving 64 questions with each fill
    pred = Predictor.from_seed(serving_config(), device="cuda")
    sds = SyntheticGQA(pred.vocab, pred.answers, size=64, seed=0,
                       shape_mix="gqa")
    questions = [sds.samples[i][2] for i in range(len(sds))]
    graphs = [sds.store.scene_graphs[sds.samples[i][1]]
              for i in range(len(sds))]

    def serve():
        return pred.predict(questions, graphs, batch_size=32, seed=0)

    answers = {}
    zero_counts()
    for fill_kind in ("native", "python", "native", "python"):
        with python_fill() if fill_kind == "python" else \
                contextlib.nullcontext():
            serve()                                        # warm-up
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = serve()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            wall, fam = device_profile(serve)
        answers.setdefault(fill_kind, [r.answer for r in res])
        busy = sum(fam.values())
        log(f"[14 native] serving 64 questions ({fill_kind} fill): wall "
            f"{statistics.median(walls):.1f} ms (median of 5; "
            f"{', '.join(f'{w:.1f}' for w in walls)}), profiled {wall:.1f} "
            f"ms, device busy " + (f"{busy:.2f} ms ({busy / wall:.1%})"
                                   if busy else "not measured") + f"; {smi}")
    if answers["native"] != answers["python"]:
        raise AssertionError("serving answers differ between the fills")
    read_counts("serving_fills", ops.EVAL_WRAPPERS)
    del pred
    torch.cuda.empty_cache()

    # (d) the CLI without a process group, then its Trainer per fill
    root = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    argv = ["--synthetic", "--synthetic_shape_mix", "gqa",
            "--synthetic_size", str(DDP_SIZE), "--sampler_type", "gumbel",
            "--sample_k", "3", "--mgat_masks", "1", "1", "1", "0.15",
            "--compute_dtype", "bfloat16", "--batch-size", str(TRAIN_B),
            "--meta_dir", "", "--epochs", "1"]
    outs = {k: os.path.join(root, k) for k in ("plain", "again", "ddp")}
    try:
        t0 = time.perf_counter()
        trainer, plain_text = counted("cli_main", ops.WRAPPERS, lambda: silent(
            cli.main, argv + ["--output_dir", outs["plain"]]))
        plain_s = time.perf_counter() - t0
        data_native = trainer.data
        with python_fill():
            data_py = build_datasets(trainer.cfg)
        if any(c.native for c in data_py.bucket_collators["train"].values()):
            raise AssertionError("the Python fill's Trainer data is native")
        marks = []
        step = trainer.train_step

        def marked(state, b):
            marks.append(time.perf_counter())
            return step(state, b)

        def two_steps():
            """Two steps of the epoch's loop: prefetch of this fill's
            batches, the step, the metric read."""
            it = trainer._iter_split("train", shuffle=True, seed=0,
                                     drop_last=True)
            for i, (b, _) in enumerate(it):
                _, m = step(trainer.state, b)
                torch.stack([m["loss_sum"], m["count"]]).tolist()
                if i == 1:
                    break

        zero_counts()
        for epoch, (fill_kind, data) in enumerate(
                (("native", data_native), ("python", data_py),
                 ("native", data_native), ("python", data_py))):
            trainer.data = data
            marks.clear()
            trainer.train_step = marked
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            quiet(trainer.train_epoch, 1 + epoch)
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t0
            trainer.train_step = step
            syncs = {k: v / 2 for k, v in host_syncs(two_steps).items()}
            log(f"[14 native] Trainer epoch ({fill_kind} fill, "
                f"{len(marks)} steps of {TRAIN_B}): {epoch_s:.2f} s, "
                f"{statistics.median(np.diff(marks) * 1e3):.1f} ms a step "
                f"(median, host clock between steps); host calls a step "
                f"(two steps of the loop) {json.dumps(syncs)}; {smi}")
            if syncs.get("cudaStreamSynchronize", 0) > MAX_SYNCS_PER_STEP:
                raise AssertionError(f"host waits a step: {syncs}")
        read_counts("trainer_fills", ops.TRAIN_WRAPPERS)
        trainer.data = data_native
        batch, _ = next(iter(iterate_batches_bucketed(
            data_native.datasets["train"],
            data_native.bucket_collators["train"])))
        batch = batch.to(dev)
        alone = step_ms(step, trainer.state, batch)
        alone_prof = device_profile(lambda: step(trainer.state, batch))
        env = {k: os.environ.get(k) for k in (
            "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
        try:
            parallel.init_distributed(dev)
            grouped = counted("step_nccl", ops.TRAIN_WRAPPERS, lambda: step_ms(
                step, trainer.state, batch))
            grouped_prof = device_profile(lambda: step(trainer.state, batch))
            grouped_syncs = host_syncs(lambda: step(trainer.state, batch))
        finally:
            parallel.shutdown()
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        after = step_ms(step, trainer.state, batch)
        log(f"[14 ddp] train step at {TRAIN_B} ({tuple(batch.node_tokens.shape)}"
            f"): {alone:.2f} / {after:.2f} ms without a process group (before "
            f"/ after), {grouped:.2f} ms in a one-rank NCCL group (the "
            f"gradients' flat all-reduce, the BatchNorm sums; "
            f"{grouped - (alone + after) / 2:+.2f} ms); host calls of the "
            f"grouped step {json.dumps(grouped_syncs)}; {smi}")
        for tag, (wall, fam) in (("alone", alone_prof),
                                 ("grouped", grouped_prof)):
            log(f"[14 ddp] one profiled step, {tag}: wall {wall:.1f} ms, "
                f"device busy {sum(fam.values()):.2f} ms; by kernel: "
                f"{by_kernel(fam)}")
        del trainer, data_native, data_py, batch
        torch.cuda.empty_cache()

        # (e) the same run under torchrun (NCCL, one rank), and a second
        # run without a group: the floor of what two runs can differ by
        runner = shutil.which("torchrun")
        cmd = ([runner] if runner else
               [sys.executable, "-m", "torch.distributed.run"])
        cmd += ["--standalone", "--nproc_per_node=1", "-m",
                "isubgvqa_tpu_torch.cli", *argv, "--output_dir", outs["ddp"]]
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=here + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                              text=True, timeout=DDP_TIMEOUT)
        ddp_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"torchrun exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        _, again_text = counted("cli_main_again", ops.WRAPPERS, lambda: silent(
            cli.main, argv + ["--output_dir", outs["again"]]))
        lines = metric_lines(proc.stdout)
        if not lines or not (lines == metric_lines(plain_text)
                             == metric_lines(again_text)):
            raise AssertionError(f"metric lines differ:\n{lines}\n"
                                 f"{metric_lines(plain_text)}")
        sd = {k: torch.load(os.path.join(v, "checkpoint"), map_location="cpu",
                            weights_only=True)["state_dict"]
              for k, v in outs.items()}
        if not set(sd["plain"]) == set(sd["ddp"]) == set(sd["again"]):
            raise AssertionError("the checkpoints hold other tensors")

        def differ(other):
            return {k: float((sd["plain"][k].float()
                              - sd[other][k].float()).abs().max())
                    for k in sd["plain"]
                    if not torch.equal(sd["plain"][k], sd[other][k])}

        ddp_diff, floor = differ("ddp"), differ("again")
        worst = max(ddp_diff.values(), default=0.0)
        n_all = len(sd["plain"])
        buffers = sum("running" in k for k in sd["plain"])
        log(f"[14 ddp] torchrun --standalone --nproc_per_node=1 -m "
            f"isubgvqa_tpu_torch.cli (NCCL, {DDP_SIZE} questions, 1 epoch "
            f"at {TRAIN_B}) in {ddp_s:.1f} s against {plain_s:.1f} s "
            f"without a group: {len(lines)} metric lines equal; of the "
            f"checkpoint's {n_all} tensors ({buffers} BatchNorm running "
            f"statistics) {n_all - len(ddp_diff)} bitwise equal, the rest "
            f"within {worst:.3g} (bound {DDP_ATOL}) {json.dumps(ddp_diff)}; "
            f"a second run without a group differs from the first in "
            f"{len(floor)} tensors {json.dumps(floor)}; {smi}")
        if worst > DDP_ATOL:
            raise AssertionError(f"torchrun against no group: {ddp_diff}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[14 native+ddp] launches of its paths (each counted from 0): "
        f"{json.dumps(counts)}")
    log(f"[14 native+ddp] phase {time.perf_counter() - t_phase:.1f} s")
    return counts


# Phase 15: checkpoints across the packages (the port's half: the machine
# with the card has no JAX), the upstream .pth, the port's parity report
# and the library ops.
CKPT_COUNT, CKPT_STEP = 37, 41   # the exported state's Adam count and step
CKPT_STEPS = 3                   # resumed steps at TRAIN_B
CKPT_TRAIN = 1024                # the resuming Trainer's training questions
PARITY_B = 2048                  # the parity report's batch
PARITY_DEV = 2048                # its dev questions (synthetic_size / 4)
PARITY_LIFTED = 4                # dev answers the .pth's answer bias lifts
# f32 logits, kernels against plain versions over the report's batches:
# the whole forward's bound of phase 13 (recorded: 1e-7 to 5e-7)
PARITY_F32_TOL = 1e-5
LIB_B, LIB_N, LIB_E = 256, 128, 384
LIB_REL = 1e-6                   # f32 library op, card against CPU


def like_tree(tree, fn):
    """A nested dict of arrays with ``fn`` applied to each leaf."""
    return {k: like_tree(v, fn) if isinstance(v, dict) else fn(np.asarray(v))
            for k, v in tree.items()}


def library_cases(rng):
    """The library ops (``ops/segment.py``, ``ops/dense.py``,
    ``ops/dense_graph.py``, ``ops/topk_ratio.py``, ``sampling/rewiring.py``
    and the flat ``node_mask_to_edge_mask``) at B = 256 graphs of N = 128
    nodes and E = 384 edges: ``(name, fn, inputs)`` with CPU inputs, where
    ``fn(*inputs)`` returns a tensor or a tuple of them.  The flat segment
    ids include ids out of range, which the reductions drop."""
    import torch
    from isubgvqa_tpu_torch import ops, sampling
    from isubgvqa_tpu_torch.ops import dense_graph as DG
    from isubgvqa_tpu_torch.ops import segment as SEG
    from isubgvqa_tpu_torch.ops.topk_ratio import topk_per_graph

    b, n, e = LIB_B, LIB_N, LIB_E
    t = torch.from_numpy
    sizes = rng.integers(n // 4, n + 1, b)
    node_mask = np.arange(n)[None] < sizes[:, None]                # [B, N]
    edge_mask = rng.random((b, e)) < 0.85
    src = (rng.random((b, e)) * sizes[:, None]).astype(np.int64)
    dst = (rng.random((b, e)) * sizes[:, None]).astype(np.int64)
    x = rng.standard_normal((b, n, 64)).astype(np.float32)
    scores = np.round(rng.standard_normal((b, n)), 1).astype(np.float32)
    logits = rng.standard_normal((b, e, 4)).astype(np.float32)
    # the flat layout: nodes b * n + i, edges into them, some ids out
    flat_dst = (dst + np.arange(b)[:, None] * n).reshape(-1)
    flat_src = (src + np.arange(b)[:, None] * n).reshape(-1)
    flat_dst[::997] = -1
    flat_dst[5::991] = b * n + 3
    graph_ids = np.repeat(np.arange(b), n)
    pos = np.tile(np.arange(n), b)
    oh_dst = ((dst[..., None] == np.arange(n)) * edge_mask[..., None]
              ).astype(np.float32)
    msg = rng.standard_normal((b, e, 64)).astype(np.float32)
    w, bias, ms = (rng.standard_normal(64).astype(np.float32)
                   for _ in range(3))
    em_flat = t(edge_mask.reshape(-1))
    nm_flat = t(node_mask.reshape(-1))
    xf = t(x.reshape(b * n, 64))
    ef = t(logits.reshape(b * e, 4))

    def node_edge(mask, s, d):
        mask = mask.clone().requires_grad_(True)
        out = sampling.node_mask_to_edge_mask(mask, s, d, b * n)
        out.backward(torch.ones_like(out))
        return out.detach(), mask.grad

    seg_args = (ef, t(flat_dst), b * n, em_flat)
    return [
        ("segment_sum", SEG.segment_sum, seg_args),
        ("segment_count", SEG.segment_count, (t(flat_dst), b * n, em_flat)),
        ("segment_mean", SEG.segment_mean, seg_args),
        ("segment_max", SEG.segment_max, seg_args),
        ("segment_min", SEG.segment_min, seg_args),
        ("segment_softmax", SEG.segment_softmax, seg_args),
        ("segment_normalize", SEG.segment_normalize,
         (xf, t(graph_ids), b, nm_flat, t(ms))),
        ("to_dense_batch", ops.to_dense_batch,
         (xf[nm_flat], t(graph_ids)[nm_flat], t(pos)[nm_flat], b, n)),
        ("from_dense_batch", ops.from_dense_batch,
         (t(x), t(graph_ids), t(pos), nm_flat)),
        ("dense_topk_mask", ops.dense_topk_mask, (t(scores), 3)),
        ("edge_onehot", DG.edge_onehot, (t(dst), n, t(edge_mask))),
        ("gather_nodes", DG.gather_nodes, (t(x), t(src))),
        ("gather_nodes_onehot", lambda a, p: DG.gather_nodes(a, p, "onehot"),
         (t(x), t(src))),
        ("gather_nodes_oh", DG.gather_nodes_oh, (t(x), t(oh_dst))),
        ("aggregate_edges", DG.aggregate_edges, (t(msg), t(oh_dst))),
        ("edge_softmax", DG.edge_softmax,
         (t(logits), t(dst), t(oh_dst), t(edge_mask))),
        ("node_softmax", DG.node_softmax, (t(scores), t(node_mask))),
        ("masked_mean", DG.masked_mean, (t(x), t(node_mask))),
        ("graph_norm_dense", DG.graph_norm_dense,
         (t(x), t(node_mask), t(w), t(bias), t(ms))),
        ("topk_per_graph_ratio", topk_per_graph, (t(scores), 0.5,
                                                  t(node_mask))),
        ("topk_per_graph_k", topk_per_graph, (t(scores), 3, t(node_mask))),
        ("rewire_global_directed", sampling.rewire_global_directed,
         (t(scores[:, :, None, None] + scores[:, None, :, None]), 3,
          t(rng.random((b, n, n)) < 0.05))),
        ("rewire_global_undirected", sampling.rewire_global_undirected,
         (t(scores[:, :, None, None] * scores[:, None, :, None]), 3, None)),
        ("masked_softmax", sampling.masked_softmax,
         (t(scores), t(node_mask.astype(np.float32)))),
        ("weighted_cross_entropy", sampling.weighted_cross_entropy,
         (t(rng.standard_normal((b, 1842)).astype(np.float32)),
          t(rng.integers(0, 1842, b)), t(rng.random(b).astype(np.float32)))),
        ("batched_edge_index_to_batched_adj",
         sampling.batched_edge_index_to_batched_adj,
         (t(src), t(dst), t(edge_mask), t(node_mask))),
        ("non_merge_coalesce", sampling.non_merge_coalesce,
         (t(src.astype(np.int32)), t(dst.astype(np.int32)), t(msg[..., :2]),
          t(logits[..., 0]), n, t(edge_mask))),
        ("batch_repeat_edge_index", sampling.batch_repeat_edge_index,
         (t(np.stack([flat_src[:e], flat_dst[:e]]).clip(0)), b * n, 3)),
        ("node_mask_to_edge_mask", node_edge,
         (t(rng.random((b * n, 1)).astype(np.float32)), t(flat_src),
          t(flat_dst))),
    ]


def same_outputs(name, got, want):
    """Card outputs against CPU outputs: masks, indices and integers
    exact, floats within ``LIB_REL`` of the output's scale (the sentinel
    1e30 of an empty segment left out of the scale).  Returns the worst
    relative error."""
    import torch

    if isinstance(want, (tuple, list)):
        return max([same_outputs(name, g, w) for g, w in zip(got, want)
                    if w is not None], default=0.0)
    got = got.cpu()
    if not want.is_floating_point() or want.dtype == torch.bfloat16:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: the card's output differs")
        return 0.0
    finite = want.abs() < 1e29
    if not torch.equal(finite, got.abs() < 1e29):
        raise AssertionError(f"{name}: sentinels differ")
    scale = max(want[finite].abs().max().item() if finite.any() else 0.0,
                torch.finfo(torch.float32).tiny)
    err = (got[finite] - want[finite]).abs().max().item() \
        if finite.any() else 0.0
    if not err <= LIB_REL * scale:
        raise AssertionError(f"{name}: {err:.3g} from the CPU's, scale "
                             f"{scale:.3g}")
    return err / scale


def logits_hook(records):
    """A global forward hook that keeps each whole-model forward's f32
    logits and node mask (on the host) in ``records``; returns its
    handle."""
    import torch
    from isubgvqa_tpu_torch.models.isubgvqa import ISubGVQA

    def hook(module, args, out):
        if isinstance(module, ISubGVQA):
            records.append((out.logits.detach().float().cpu(),
                            out.node_mask.detach().cpu()))

    return torch.nn.modules.module.register_module_forward_hook(hook)


def phase_checkpoints(smi):
    """Phase 15: checkpoints across the two packages, on the port's side
    (this machine has no JAX: the orbax half runs in the CPU tests).
    (a) The seeded full-width training model's state through
    ``convert.state_dict_to_jax``, with seeded non-zero Adam moments,
    count 37, step 41, through ``convert.train_payload_from_jax`` into a
    file and its meta; ``Trainer.resume`` reads every weight, moment and
    count back bitwise; three steps at 256 (kernels #5-#8), finite, Adam's
    count 37 to 40.  (b) ``Predictor.from_checkpoint`` of that file
    serves 64 questions with logits bitwise equal to a ``Predictor`` of
    the source state dict (kernels #1-#4).  (c) The same weights as an
    upstream ``.pth`` (``module.`` prefixes, an ``argparse.Namespace``
    ``args``, ``epoch``), the answer head's bias lifted by 5 at the
    ``PARITY_LIFTED`` most frequent dev answers (random weights answer no
    dev question right, which leaves the co-occurrence metrics NaN):
    ``Predictor.from_checkpoint`` with no config derives the
    source's config field by field; ``python -m
    isubgvqa_tpu_torch.parity_report --synthetic`` on it at B = 2048 in
    f32 through the kernels and through the plain versions: logits
    within ``PARITY_F32_TOL``, the same masks, every metric the same
    (NaN where both are), the accuracy above 0 and a co-occurrence metric
    finite.  (d) Every
    library op on the card against the same call on the CPU.  Returns
    the launch counts of (a)-(c), each counted from 0."""
    import argparse
    import collections

    import torch
    from isubgvqa_tpu_torch import convert, ops, parity_report
    from isubgvqa_tpu_torch.data import (AnswerMap, SceneGraphVocab,
                                         SyntheticGQA, build_bucket_collators,
                                         build_datasets,
                                         iterate_batches_bucketed)
    from isubgvqa_tpu_torch.serve import Predictor
    from isubgvqa_tpu_torch.train import create_train_state
    from isubgvqa_tpu_torch.train.checkpoint import write_checkpoint
    from isubgvqa_tpu_torch.train.loop import Trainer

    t_phase = time.perf_counter()
    counts = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # (a) the train state exported and resumed
        cfg = dataclasses.replace(train_config(), synthetic=True,
                                  synthetic_size=CKPT_TRAIN,
                                  synthetic_shape_mix="gqa",
                                  output_dir=os.path.join(root, "out"))
        data = build_datasets(cfg, pin_memory=True)
        cfg = dataclasses.replace(cfg, num_answers=len(data.answers))
        spe = max(len(data.datasets["train"]) // cfg.batch_size, 1)
        source = create_train_state(cfg, data.vocab, spe, device="cuda")
        sd = {k: v.detach().float().cpu()
              for k, v in source.model.state_dict().items()}
        del source
        t0 = time.perf_counter()
        params, stats = convert.state_dict_to_jax(sd)
        rng = np.random.default_rng(15)
        mu = like_tree(params, lambda a: (
            1e-3 * rng.standard_normal(a.shape)).astype(np.float32))
        nu = like_tree(params, lambda a: (
            1e-6 * rng.standard_normal(a.shape) ** 2).astype(np.float32))
        payload = convert.train_payload_from_jax(
            params, stats, cfg.to_json(), mu=mu, nu=nu, count=CKPT_COUNT,
            notfinite_count=0, step=CKPT_STEP, epoch=3)
        path = os.path.join(root, "exported")
        write_checkpoint(payload, path)
        export_s = time.perf_counter() - t0
        mu_sd = convert.state_dict_from_jax(mu, stats)
        nu_sd = convert.state_dict_from_jax(nu, stats)
        del params, stats, mu, nu, payload
        trainer = Trainer(cfg, data, device="cuda")
        t0 = time.perf_counter()
        epoch, _ = trainer.resume(path)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        st, opt = trainer.state, trainer.state.optimizer
        bad = [k for k, v in st.model.state_dict().items()
               if not torch.equal(v.cpu(), sd[k])]
        for n, p in st.model.named_parameters():
            s = opt.adam.state[p]
            if not (torch.equal(s["exp_avg"].cpu(), mu_sd[n])
                    and torch.equal(s["exp_avg_sq"].cpu(), nu_sd[n])
                    and float(s["step"]) == CKPT_COUNT):
                bad.append(f"adam[{n}]")
        if bad or (epoch, opt.count, opt.notfinite_count, st.step) != (
                4, CKPT_COUNT, 0, CKPT_STEP):
            raise AssertionError(f"resume: {bad[:5]} differ; epoch {epoch}, "
                                 f"count {opt.count}, step {st.step}")
        n_moments = sum(v.numel() for v in mu_sd.values())
        log(f"[15 ckpt] export of the full-width train state ({n_moments} "
            f"parameters, Adam count {CKPT_COUNT}, step {CKPT_STEP}) in "
            f"{export_s:.1f} s, file {os.path.getsize(path) / 2 ** 30:.2f} "
            f"GiB; Trainer.resume on the card in {resume_s:.1f} s: every "
            f"weight, buffer, moment and count bitwise equal")
        del mu_sd, nu_sd
        _, batches = training_batches(cfg, data.vocab, data.answers,
                                      CKPT_STEPS)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        step_ms, losses = [], []
        for _, batch in batches:
            t0 = time.perf_counter()
            trainer.state, m = trainer.train_step(trainer.state,
                                                  batch.to("cuda"))
            losses.append(float(m["loss_sum"] / m["count"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts["checkpoints.resume"] = ops.launch_counts(ops.TRAIN_WRAPPERS)
        if not (np.isfinite(losses).all() and opt.count == CKPT_COUNT
                + CKPT_STEPS and trainer.state.step == CKPT_STEP + CKPT_STEPS
                and min(counts["checkpoints.resume"].values()) > 0):
            raise AssertionError(f"resumed steps: losses {losses}, count "
                                 f"{opt.count}, launches "
                                 f"{counts['checkpoints.resume']}")
        log(f"[15 ckpt] {CKPT_STEPS} resumed steps at {TRAIN_B}: losses "
            f"{[round(v, 5) for v in losses]}, ms "
            f"{[round(v, 1) for v in step_ms]} (the first a fresh state's); "
            f"Adam's count {CKPT_COUNT} -> {opt.count}; launches "
            f"{json.dumps(counts['checkpoints.resume'])}")
        del trainer, st, opt, batches
        torch.cuda.empty_cache()

        # (b) serving the exported file against the source weights
        served = Predictor.from_checkpoint(path, device="cuda")
        own = Predictor(served.cfg, served.vocab, served.answers,
                        state_dict=sd, device="cuda")
        ds = SyntheticGQA(served.vocab, served.answers, size=64, seed=0,
                          shape_mix="gqa")
        colls = build_bucket_collators(served.cfg, served.tokenizer,
                                       served.vocab, batch_size=32)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        n_q = 0
        for b_idx, (batch, meta) in enumerate(
                iterate_batches_bucketed(ds, colls)):
            batch = batch.to("cuda")
            got = [p._forward(batch, torch.Generator(device="cuda")
                              .manual_seed(b_idx))
                   for p in (served, own)]
            for what, a, b in zip(("logits", "node mask", "gate"), *got):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"served {what} differ by "
                        f"{(a.float() - b.float()).abs().max().item()}")
            n_q += meta.num_real
        counts["checkpoints.serve"] = ops.launch_counts(ops.EVAL_WRAPPERS)
        if n_q != 64 or min(counts["checkpoints.serve"].values()) == 0:
            raise AssertionError(f"serving: {n_q} questions, launches "
                                 f"{counts['checkpoints.serve']}")
        answers = [r.answer for r in served.predict(
            [ds.samples[i][2] for i in range(8)],
            [ds.store.scene_graphs[ds.samples[i][1]] for i in range(8)])]
        log(f"[15 ckpt] Predictor.from_checkpoint(exported): 64 questions, "
            f"logits, node masks and gates bitwise equal to a Predictor of "
            f"the source state dict; launches "
            f"{json.dumps(counts['checkpoints.serve'])}; first answers "
            f"{answers[:3]}")
        del served, own

        # (c) an upstream .pth, its config, and the port's parity report
        args = argparse.Namespace(
            mgat_layers=cfg.mgat_layers, sampler_type=cfg.sampler_type,
            sample_k=cfg.sample_k, nb_samples=cfg.nb_samples,
            alpha=cfg.alpha, beta=cfg.beta, tau=cfg.tau,
            use_topk=cfg.use_topk, interpretable_mode=cfg.interpretable_mode,
            concat_instr=cfg.concat_instr, use_all_instrs=cfg.use_all_instrs,
            use_global_mask=cfg.use_global_mask,
            text_sampling=cfg.text_sampling,
            general_hidden_dim=cfg.general_hidden_dim,
            mgat_masks=list(cfg.mgat_masks), lr=cfg.lr, epochs=100)
        # random weights answer near-uniformly over 1842 labels, and the
        # dev answers span ~1,200 of them: lift the most frequent few
        # above the rest, so that the report answers among them, the
        # argmax among them rests on the forward, and some answers are
        # right for the accuracy and the co-occurrence metrics to count
        dev = build_datasets(dataclasses.replace(
            train_config(), synthetic=True, synthetic_size=4 * PARITY_DEV,
            synthetic_shape_mix="gqa")).datasets["dev"]
        labels = [label for label, _ in collections.Counter(
            dev.answers.label_of(q[3]) for q in dev.samples).most_common(
                PARITY_LIFTED)]
        lifted = dict(sd, **{"logit_fc.bias": sd["logit_fc.bias"].clone()})
        lifted["logit_fc.bias"][labels] += 5.0
        pth = os.path.join(root, "upstream.pth")
        torch.save({"model": {f"module.{k}": v for k, v in lifted.items()},
                    "args": args, "epoch": 3}, pth)
        del dev, lifted
        pred = Predictor.from_checkpoint(pth, device="cuda")
        want = dataclasses.replace(train_config(),
                                   num_answers=len(pred.answers))
        diff = {f.name: (getattr(pred.cfg, f.name), getattr(want, f.name))
                for f in dataclasses.fields(want)
                if getattr(pred.cfg, f.name) != getattr(want, f.name)}
        if diff:
            raise AssertionError(f"config from the .pth's args: {diff}")
        del pred
        argv = ["--torch_ckpt", pth, "--synthetic", "--synthetic_size",
                str(4 * PARITY_DEV), "--work_dir", root,
                "--set", f"batch_size={PARITY_B}",
                "--set", "eval_batch_factor=1",
                "--set", 'compute_dtype="float32"',
                "--set", 'synthetic_shape_mix="gqa"']
        reports, records, walls = {}, {}, {}
        for plain in (False, True):
            name = "plain" if plain else "kernels"
            records[name] = []
            handle = logits_hook(records[name])
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                with eval_layers(plain):
                    reports[name], _ = captured(parity_report.main, argv + [
                        "--out", os.path.join(root, f"report_{name}")])
            finally:
                handle.remove()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            if not plain:
                counts["checkpoints.parity_report"] = ops.launch_counts(
                    ops.EVAL_WRAPPERS)
        k_rec, p_rec = records["kernels"], records["plain"]
        err = max((a[0] - b[0]).abs().max().item()
                  for a, b in zip(k_rec, p_rec))
        same_masks = len(k_rec) == len(p_rec) and all(
            torch.equal(a[1], b[1]) for a, b in zip(k_rec, p_rec))
        mk, mp = reports["kernels"]["metrics"], reports["plain"]["metrics"]
        same_metrics = set(mk) == set(mp) and all(
            mk[k] == mp[k] or (np.isnan(mk[k]) and np.isnan(mp[k]))
            for k in mk)
        counted = mk["accuracy"] > 0 and any(
            np.isfinite(v) for k, v in mk.items() if k.endswith("_coo"))
        if not (same_masks and err <= PARITY_F32_TOL and same_metrics
                and counted
                and reports["kernels"]["num_samples"] == PARITY_DEV
                and min(counts["checkpoints.parity_report"].values()) > 0):
            raise AssertionError(
                f"parity report: logits {err}, masks equal {same_masks}, "
                f"metrics {mk} / {mp}, launches "
                f"{counts['checkpoints.parity_report']}")
        log(f"[15 ckpt] upstream .pth: Predictor.from_checkpoint with no "
            f"config derives the source's config field by field; "
            f"parity_report --synthetic, {PARITY_DEV} dev questions at "
            f"B={PARITY_B}, f32: kernels {json.dumps(mk)} in "
            f"{walls['kernels']:.1f} s, plain {json.dumps(mp)} in "
            f"{walls['plain']:.1f} s (the answer bias lifted at the "
            f"{PARITY_LIFTED} most frequent dev answers; every metric "
            f"equal); {len(k_rec)} forwards, logits "
            f"max abs {err:.3g} (bound {PARITY_F32_TOL}), node masks "
            f"identical; "
            f"launches {json.dumps(counts['checkpoints.parity_report'])}")
        del records, k_rec, p_rec
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (d) the library ops on the card against the CPU
    t0 = time.perf_counter()
    worst = {}
    for name, fn, inputs in library_cases(np.random.default_rng(16)):
        want = fn(*inputs)
        got = fn(*(x.to("cuda") if isinstance(x, torch.Tensor) else x
                   for x in inputs))
        torch.cuda.synchronize()
        worst[name] = same_outputs(name, got, want)
    log(f"[15 ckpt] {len(worst)} library ops at B={LIB_B}, N={LIB_N}, "
        f"E={LIB_E} on the card against the CPU in "
        f"{time.perf_counter() - t0:.1f} s: masks, indices and integers "
        f"equal, f32 within {LIB_REL} of scale (worst "
        f"{max(worst.values()):.3g}, {max(worst, key=worst.get)})")
    log(f"[15 ckpt] phase {time.perf_counter() - t_phase:.1f} s; {smi}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    from isubgvqa_tpu_torch.models.build import build_model
    from isubgvqa_tpu_torch.data import SceneGraphVocab

    t0 = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    cfg = serving_config()
    ref_model = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                            SceneGraphVocab.build(""), "cuda")
    entries = phase_kernels(ref_model, torch.device("cuda"))
    entries.update(phase_train_kernels(ref_model, torch.device("cuda")))
    del ref_model
    pred, ds, counts = phase_serving()
    phase_whole_forward(pred, ds)
    log(f"[6 launches] kernels {json.dumps(counts)}")
    del pred
    train_counts, state, vocab, batch, step_ms = phase_training(
        torch.device("cuda"))
    counts.update(train_counts)
    phase_train_step_parity(state, vocab, batch)
    del state, batch
    torch.cuda.empty_cache()
    bench_counts, gumbel_train_syncs = phase_bench()
    bench_counts.update(phase_samplers(gumbel_train_syncs))
    torch.cuda.empty_cache()
    bench_counts["entry_points"] = phase_entry_points()
    torch.cuda.empty_cache()
    bench_counts["variants"], variant_times = phase_variants(
        torch.device("cuda"))
    torch.cuda.empty_cache()
    bench_counts.update({f"native_ddp.{k}": v
                         for k, v in phase_native_ddp(smi).items()})
    torch.cuda.empty_cache()
    bench_counts.update(phase_checkpoints(smi))
    line = []
    for k, (src, replaces) in KERNELS.items():
        r = entries[(k, torch.bfloat16)]
        row = {"name": k, "route": "cuda", "source": src,
               "replaces": replaces, "launches": counts[k],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"],
               "shape": r["shape"], "dtype": "bfloat16",
               "bench_launches": {n: c[k] for n, c in bench_counts.items()
                                  if k in c}}
        text = k in LIBRARY_LAYERS    # factor: the port's ms over the library's
        row.update(library_call=LIBRARY_LAYERS.get(k),
                   sdpa_ms=r.get("sdpa_ms"), attention_ms=r.get("attention_ms"))
        if k in PER_STEP:
            row.update(bwd_launches=counts[k + "_bwd"],
                       launches_per_step=PER_STEP[k],
                       ms_covers="forward + backward",
                       grad_err=r["grad_err"], host_ms=r["host_ms"])
            if k in STAGED_SOURCES:
                row.update(sources=[src] + STAGED_SOURCES[k],
                           gemm_bwd_tflops=r.get("gemm_bwd_tflops"),
                           kernels_fwd=r.get("kernels_fwd"),
                           kernels_bwd=r.get("kernels_bwd"))
            else:
                row.update(gemm_any_tflops=r.get("gemm_any_tflops"))
            if text:
                row["factor"] = r["ms"] / r["library_ms"]
        elif text:     # the bf16 layer: the Hopper GEMM and the mma core
            row.update(sources=[src, "isubgvqa_tpu_torch/csrc/text_kernel.cu"],
                       layer_ms=r["layer_ms"], factor=r["factor"],
                       gemm_tflops=r.get("gemm_tflops"),
                       device_ms=r.get("device_ms"))
        else:          # the bf16 graph layer: the graph-layer GEMM
            row.update(sources=[src] + GRAPH_SOURCES[k],
                       gemm_tflops=r.get("gemm_tflops"),
                       device_ms=r.get("device_ms"),
                       port_launches_per_call=r.get("port_launches"),
                       **{f: r.get(f) for f in (
                           "products_ms", "products_tflops",
                           "products_cublas_ms", "products_factor")})
        if k in variant_times:
            row["variant_shapes"] = variant_times[k]
        line.append(row)
    log(f"train step median {step_ms:.1f} ms at batch {TRAIN_B}")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
