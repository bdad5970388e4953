#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``isubgvqa_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure raises and the
script exits non-zero):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the CUDA kernels from ``isubgvqa_tpu_torch/csrc/``;
3. kernels: each of the four fused layers against its plain PyTorch
   version on the card, at the main path's shapes (every node bucket for
   the graph layers, L = 16 and 32 for the text layers), in f32 (TF32
   off) and bf16, with timings, the bound, the attention core against
   ``F.scaled_dot_product_attention``, each text layer (bf16, no final
   LayerNorm) against the one PyTorch call that computes it
   (``nn.Transformer{Encoder,Decoder}Layer``, the MHA fast path off), and
   device time by kernel at the largest shapes with the text layers'
   products' effective TFLOP/s on the Hopper GEMM;
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
   time by kernel at the largest shapes with the backward GEMM's
   effective TFLOP/s, and the backward GEMM against an f64 product at the
   main path's longest reduction;
8. training: ``train_step`` of the full-width config of record (bf16,
   dropouts on) at batch 256 on the GQA-like synthetic mix through the
   bucketed collators, one warm-up step and 5 counted steps over two
   node buckets, each step's loss, grad norm and ms, launches per step
   and direction, and one profiled step (device time by kernel, busy
   share);
9. train step, kernels against plain: one f32 step on one batch through
   both paths from the same weights, masks and noise (loss, grad norm,
   node mask, every gradient), and the same in bf16 (loss, grad norm);
then the per-kernel JSON line (all eight kernels) and the final
``{"ok": true, ...}`` line.  Phase 7 runs right after phase 3, before
the serving model is built.

It needs one CUDA device and the CUDA toolkit; without them it exits
non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
GRAPH_BUCKETS = ((16, 64), (32, 128), (64, 256), (128, 384))
TEXT_LENS = (16, 32)
GRAPH_B = 256                # graphs per kernel-check batch
TEXT_B = 512                 # questions per kernel-check batch
F32_TOL = 1e-3
# bf16: kernel and plain version round at the same points, but f32 sums
# taken in another order can flip a bf16 rounding (one ulp = 2^-8
# relative) that later products and norms carry on
BF16_TOL = 3e-2


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
    import torch

    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
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
    from isubgvqa_tpu_torch import ops
    from isubgvqa_tpu_torch.ops import gat_kernel as G
    from isubgvqa_tpu_torch.ops import metalayer_kernel as M
    from isubgvqa_tpu_torch.ops import text_kernel as T

    rng = np.random.default_rng(0)
    entries = {}

    def record(key, info, dtype, fn, plain, flops, inputs, outputs,
               gemm_flops=None):
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
            log(f"[3 kernels] {key} {info} bfloat16 device time by kernel: "
                f"{by_kernel(fam) or 'not measured (no CUDA events)'}")
            if gemm_flops and fam.get("gemm_sm90"):
                out["gemm_tflops"] = gemm_flops / fam["gemm_sm90"] / 1e9
                log(f"[3 kernels] {key} {info} products on the Hopper GEMM: "
                    f"{gemm_flops:.4g} FLOP in {fam['gemm_sm90']:.4f} device "
                    f"ms = {out['gemm_tflops']:.1f} TFLOP/s effective")
        return out

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
            r = record("fused_gat_layer", f"B={GRAPH_B} N={n} E={e}", dtype,
                       lambda: G.fused_gat_layer(*args, fuse_instr=True),
                       lambda: G.fused_gat_layer_plain(*args, fuse_instr=True),
                       flops=G.gat_layer_flops(nv, ev, c, heads, True),
                       inputs=(h, ins, gate, src, dst, em, nm, ea, gp),
                       outputs=(h, torch.empty(GRAPH_B, e, heads)))
            entries[("fused_gat_layer", dtype)] = r
            if n == 32:   # the masked layer's path: a sampled gate, no fusion
                xf = torch.nn.functional.gelu(h * ins[:, None, :])
                g2 = (torch.rand(GRAPH_B, n, 1, device=device) > 0.6).to(dtype)
                a2 = (h, xf, ins, g2, src, dst, em, nm, ea, gp)
                record("fused_gat_layer", f"masked B={GRAPH_B} N={n} E={e}",
                       dtype, lambda: G.fused_gat_layer(*a2),
                       lambda: G.fused_gat_layer_plain(*a2),
                       flops=G.gat_layer_flops(nv, ev, c, heads),
                       inputs=a2, outputs=(h, torch.empty(GRAPH_B, e, heads)))
            margs = (h, ea, src, dst, em, nm, mp)
            r = record("fused_metalayer", f"B={GRAPH_B} N={n} E={e}", dtype,
                       lambda: M.fused_metalayer(*margs),
                       lambda: M.fused_metalayer_plain(*margs),
                       flops=M.metalayer_flops(nv, ev, c),
                       inputs=margs, outputs=(h, ea))
            entries[("fused_metalayer", dtype)] = r
        for l in TEXT_LENS:
            x = torch.randn(TEXT_B, l, 512, device=device).to(dtype)
            lens = torch.randint(6, l + 1, (TEXT_B,), device=device)
            km = (torch.arange(l, device=device)[None] < lens[:, None]).float()
            fl = (ep["n1s"], ep["n1b"])
            r = record("fused_encoder_layer", f"B={TEXT_B} L={l}", dtype,
                       lambda: (T.fused_encoder_layer(x, km, ep, 8, fl),),
                       lambda: (T.fused_encoder_layer_plain(x, km, ep, 8, fl),),
                       flops=T.encoder_layer_flops(TEXT_B, l, final_ln=True),
                       inputs=(x, km, ep, fl), outputs=(x,),
                       gemm_flops=2.0 * TEXT_B * l * 512 * (4 * 512 + 2 * 2048))
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
                       flops=T.decoder_layer_flops(TEXT_B, 4, l, final_ln=True),
                       inputs=(tgt, x, dp, fl), outputs=(tgt,),
                       gemm_flops=2.0 * 512 * (TEXT_B * 4 * (6 * 512 + 2 * 2048)
                                               + TEXT_B * l * 2 * 512))
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


def device_profile(fn):
    """Run ``fn`` once under torch.profiler (CUPTI); returns the host wall
    time in ms and the device time in ms by kernel family (the port's
    kernels by name, everything else as "other (PyTorch)")."""
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
            fam = next((k for k in KERNEL_FAMILIES if k in ev.name),
                       "other (PyTorch)")
            families[fam] = families.get(fam, 0.0) + ev.device_time_total / 1e3
    return wall_ms, families


# the port's kernels by name, the most specific first
KERNEL_FAMILIES = ("gemm_any", "gemm_sm90", "gemm", "reduce_rows", "colsum",
                   "gat_edge_bwd", "gat_edge", "graph_norm_bwd", "graph_norm",
                   "attention_bwd", "attention_mma", "attention", "ln_bwd",
                   "residual_ln",
                   "relu_bwd", "gelu_bwd", "scatter_mean_bwd", "scatter_mean",
                   "scatter_rows", "instr_gelu")


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


def phase_whole_forward(pred, ds):
    """Kernel path vs plain path on one batch of the serving mix."""
    import torch
    from isubgvqa_tpu_torch import ops
    from isubgvqa_tpu_torch.data import build_bucket_collators
    from isubgvqa_tpu_torch.models import (mgat, question_decoder,
                                           question_encoder,
                                           scene_graph_encoder)
    from isubgvqa_tpu_torch.models.build import build_model

    sites = [(question_encoder, "fused_encoder_layer"),
             (question_decoder, "fused_decoder_layer"),
             (scene_graph_encoder, "fused_metalayer"),
             (mgat, "fused_gat_layer")]

    def run(model, batch, noise, plain):
        saved = [getattr(m, n) for m, n in sites]
        try:
            if plain:
                for m, n in sites:
                    setattr(m, n, getattr(ops, n + "_plain"))
            with torch.no_grad():
                return model(batch, noise=noise)
        finally:
            for (m, n), fn in zip(sites, saved):
                setattr(m, n, fn)

    colls = build_bucket_collators(pred.cfg, pred.tokenizer, pred.vocab,
                                   batch_size=32)
    batch, _ = colls[(32, 16)].collate([ds[i] for i in range(32)])
    dev = pred.device
    batch = batch.to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = -torch.log(-torch.log(torch.rand(
        batch.node_mask.shape, generator=gen, device=dev).clamp_min(1e-30)))
    sd = {k: v.float() for k, v in pred.model.state_dict().items()}
    cfg32 = dataclasses.replace(pred.cfg, compute_dtype="float32")
    m32 = build_model(cfg32, pred.vocab, dev, state_dict=sd)
    k32, p32 = run(m32, batch, noise, False), run(m32, batch, noise, True)
    err = (k32.logits - p32.logits).abs().max().item()
    # random weights leave the logits nearly uniform (spread ~0.1), so the
    # bound sits far below that spread: the paths differ only in f32
    # summation order
    if not err <= 1e-4:
        raise AssertionError(f"whole forward f32: logits differ by {err}")
    if not torch.equal(k32.node_mask.round(), p32.node_mask.round()):
        raise AssertionError("whole forward f32: node_mask differs")
    k16, p16 = (run(pred.model, batch, noise, False),
                run(pred.model, batch, noise, True))
    real = batch.sample_mask > 0
    agree = (k16.logits.argmax(-1) == p16.logits.argmax(-1))[real]
    err16 = (k16.logits - p16.logits).abs().max().item()
    log(f"[5 whole forward] f32 (TF32 off): logits max abs {err:.3g} "
        f"(bound 1e-4, logits std {p32.logits.std().item():.3g}), "
        f"node_mask identical; bf16: top-1 agreement "
        f"{agree.float().mean().item():.4f} ({int(agree.sum())}/"
        f"{int(real.sum())}), logits max abs {err16:.3g}")


KERNELS = {
    "fused_gat_layer": ("isubgvqa_tpu_torch/csrc/gat_kernel.cu",
                        "isubgvqa_tpu/ops/pallas/gat_kernel.py:229"),
    "fused_encoder_layer": ("isubgvqa_tpu_torch/csrc/gemm_sm90.cu",
                            "isubgvqa_tpu/ops/pallas/text_kernel.py:255"),
    "fused_decoder_layer": ("isubgvqa_tpu_torch/csrc/gemm_sm90.cu",
                            "isubgvqa_tpu/ops/pallas/text_kernel.py:387"),
    "fused_metalayer": ("isubgvqa_tpu_torch/csrc/metalayer_kernel.cu",
                        "isubgvqa_tpu/ops/pallas/metalayer_kernel.py:143"),
    "fused_gatconv": ("isubgvqa_tpu_torch/csrc/gat_train.cu",
                      "isubgvqa_tpu/ops/pallas/gat_train.py:484"),
    "fused_metalayer_train": ("isubgvqa_tpu_torch/csrc/metalayer_train.cu",
                              "isubgvqa_tpu/ops/pallas/metalayer_train.py:265"),
    "fused_encoder_layer_train": ("isubgvqa_tpu_torch/csrc/text_train.cu",
                                  "isubgvqa_tpu/ops/pallas/text_train.py:622"),
    "fused_decoder_layer_train": ("isubgvqa_tpu_torch/csrc/text_train.cu",
                                  "isubgvqa_tpu/ops/pallas/text_train.py:742"),
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

    def run():
        outs = fn(*inputs, params)
        outs = outs if isinstance(outs, tuple) else (outs,)
        grads = torch.autograd.grad(
            outs, leaves, [c.to(o.dtype) for o, c in zip(outs, cots)])
        return outs, grads
    return run


def compare_grads(name, got, want, dtype):
    """Worst gradient error by the metric of :data:`TRAIN_GRAD_TOL`."""
    import torch

    tol = TRAIN_GRAD_TOL[str(dtype)[6:]]
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
    from isubgvqa_tpu_torch.ops import gat_train as G
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
               largest, gemm_flops=None):
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
            if gemm_flops and fam.get("gemm_any"):
                out["gemm_any_tflops"] = gemm_flops / fam["gemm_any"] / 1e9
                log(f"[7 train kernels] {key} {info} backward GEMM: "
                    f"{gemm_flops:.4g} FLOP (padding rows counted) in "
                    f"{fam['gemm_any']:.3f} device ms = "
                    f"{out['gemm_any_tflops']:.1f} TFLOP/s effective")
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
        log(f"[7 train kernels] backward GEMM against f64, same-sign "
            f"operands, K={k}: max abs error over max abs: f32 B "
            f"{errs[0]:.3g}, bf16 B {errs[1]:.3g}; torch f32 product "
            f"{f32:.3g}")
        if not max(errs) <= 4e-6:
            raise AssertionError(f"backward GEMM error {max(errs):.3g} "
                                 f"> 4e-6")

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
                       G.gatconv_train_flops(nv, ev, c, heads), largest,
                       gemm_flops=4.0 * heads * c * c * (2 * b * n + b * e))
            entries[("fused_gatconv", dtype)] = r
            inputs = [t.clone().requires_grad_(True) for t in (xf, ea)]
            wrap = lambda f: (lambda x, a, p: f(x, a, src, dst, em, nm, p))
            r = record("fused_metalayer_train", info, dtype,
                       wrap(M.fused_metalayer_train),
                       wrap(M.fused_metalayer_train_plain), inputs,
                       masters(meta_p),
                       (torch.randn(b, n, c, device=device),
                        torch.randn(b, e, c, device=device)),
                       M.metalayer_train_flops(nv, ev, c), largest)
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
                       T.encoder_layer_train_flops(b, l), largest,
                       gemm_flops=4.0 * b * l * (4 * d * d + 2 * d * 2048))
            r["attention_ms"], r["sdpa_ms"] = core_fwd_bwd("self", l, l,
                                                           dtype, km)
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
            r = record("fused_decoder_layer_train", info, dtype,
                       lambda t, m, p: T.fused_decoder_layer_train(
                           t, m, dmasks, p, 8),
                       lambda t, m, p: T.fused_decoder_layer_train_plain(
                           t, m, dmasks, p, 8),
                       [tgt.clone().requires_grad_(True),
                        x.clone().requires_grad_(True)], masters(dec_p),
                       (torch.randn(b, 4, d, device=device),),
                       T.decoder_layer_train_flops(b, 4, l), largest,
                       gemm_flops=4.0 * (b * 4 * (6 * d * d + 2 * d * 2048)
                                         + b * l * 2 * d * d))
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


def phase_train_step_parity(state, vocab, batch):
    """One step's loss and gradients through the kernels and through the
    plain versions, same weights, masks and noise."""
    import torch
    from isubgvqa_tpu_torch.models import (question_decoder,
                                           question_encoder,
                                           scene_graph_encoder)
    from isubgvqa_tpu_torch.models.build import build_model
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
        saved = [getattr(m, n) for m, n, _ in sites]
        try:
            if plain:
                for m, n, f in sites:
                    setattr(m, n, f)
            gen = torch.Generator(device=batch.node_mask.device)
            gen.manual_seed(11)
            out = model(batch, generator=gen, train=True)
            loss = cross_entropy_loss(out.logits, batch.labels,
                                      batch.sample_mask)
            loss.backward()
        finally:
            for (m, n, _), f in zip(sites, saved):
                setattr(m, n, f)
        grads = {n: p.grad for n, p in model.named_parameters()}
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
        return float(loss.detach()), float(norm), out.node_mask, grads

    lk, nk, mk, gk = run("float32", False)
    lp, np_, mp, gp = run("float32", True)
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
    log("[9 train step] f32 worst gradient leaves (RMS error of RMS, leaf, "
        "RMS): " + "; ".join(f"{e:.3g} {k} {r:.3g}" for e, k, r in errs[:4]))
    if not worst <= 3e-3:
        raise AssertionError(f"train step f32: {errs[0][1]} differs by "
                             f"{worst} of its RMS")
    l16k, n16k, _, _ = run("bfloat16", False)
    l16p, n16p, _, _ = run("bfloat16", True)
    # bf16: the two paths round the forward at the same points, but a
    # flipped rounding moves the loss (~7.5) by far less than 1 %
    if not (abs(l16k - l16p) <= 1e-2 * abs(l16p)
            and abs(n16k - n16p) <= 5e-2 * n16p):
        raise AssertionError(f"train step bf16: loss {l16k} vs {l16p}, grad "
                             f"norm {n16k} vs {n16p}")
    log(f"[9 train step] f32 (TF32 off): loss {lk:.6f} vs plain {lp:.6f}, "
        f"grad norm {nk:.6f} vs {np_:.6f}, node mask identical, worst "
        f"gradient leaf {worst:.3g} of its RMS ({len(gk)} leaves); bf16: "
        f"loss {l16k:.5f} vs {l16p:.5f}, grad norm {n16k:.5f} vs {n16p:.5f}")


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
    name, _ = phase_device()
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
    line = []
    for k, (src, replaces) in KERNELS.items():
        r = entries[(k, torch.bfloat16)]
        row = {"name": k, "route": "cuda", "source": src,
               "replaces": replaces, "launches": counts[k],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"],
               "shape": r["shape"], "dtype": "bfloat16"}
        text = k in LIBRARY_LAYERS    # factor: the port's ms over the library's
        row.update(library_call=LIBRARY_LAYERS.get(k),
                   sdpa_ms=r.get("sdpa_ms"), attention_ms=r.get("attention_ms"))
        if k in PER_STEP:
            row.update(bwd_launches=counts[k + "_bwd"],
                       launches_per_step=PER_STEP[k],
                       ms_covers="forward + backward",
                       grad_err=r["grad_err"],
                       gemm_any_tflops=r.get("gemm_any_tflops"))
            if text:
                row["factor"] = r["ms"] / r["library_ms"]
        elif text:     # the bf16 layer: the Hopper GEMM and the mma core
            row.update(sources=[src, "isubgvqa_tpu_torch/csrc/text_kernel.cu"],
                       layer_ms=r["layer_ms"], factor=r["factor"],
                       gemm_tflops=r.get("gemm_tflops"),
                       device_ms=r.get("device_ms"))
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
