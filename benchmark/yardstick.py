"""The benchmark's arithmetic, frozen: the model's products and the fused
layers' work at given sizes, the H100's peaks, the port's kernel
families, and the reduction of a profiler trace to busy time, kernel
families, idle gaps and module device time.

The product and work formulas are copies of the port's
``ops/flops.py`` (its ``forward_flops`` at padded shapes, and the work
functions that ``chip_smoke.py`` bounds its kernels by); the kernel
families are ``profile_breakdown.KERNEL_FAMILIES``.  Byte counts are the
benchmark's own: each input byte once, each output byte once.
"""

from __future__ import annotations

import bisect
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12                                   # H100 SXM HBM3
FFN_DIM = 4 * 512

KERNEL_FAMILIES = ("gemm_any", "gemm_bwd", "gemm_sm90", "gemm_gather",
                   "gemm", "reduce_rows", "colsum",
                   "gat_edge_bwd", "gat_edge", "graph_norm_bwd", "graph_norm",
                   "graph_index",
                   "attention_bwd", "attention_mma", "attention", "ln_bwd",
                   "residual_ln",
                   "relu_bwd", "scatter_mean_bwd", "scatter_mean",
                   "scatter_rows", "instr_gelu")
OTHER = "other (PyTorch)"


def kernel_family(name: str) -> str:
    return next((k for k in KERNEL_FAMILIES if k in name), OTHER)


# ------------------------------------------------------------- products

def linear_products(rows, k, n):
    return 2.0 * rows * k * n


def gat_conv_products(nodes, edges, c=300, heads=4):
    hc = heads * c
    return 2 * linear_products(nodes, c, hc) + linear_products(edges, c, hc)


def gat_layer_products(nodes, edges, c=300, heads=4):
    hc = heads * c
    return (gat_conv_products(nodes, edges, c, heads)
            + linear_products(nodes, hc, hc // 2)
            + linear_products(nodes, hc // 2, c))


def metalayer_products(nodes, edges, c=300):
    return 2.0 * c * c * (7 * edges + 3 * nodes)


def attention_products(b, lq, lk, d=512):
    return 4.0 * b * lq * lk * d


def mha_products(rq, rk, lq, lk, b, d):
    return (linear_products(rq, d, d) + linear_products(rk, d, 2 * d)
            + attention_products(b, lq, lk, d) + linear_products(rq, d, d))


def ffn_products(rows, d, f):
    return linear_products(rows, d, f) + linear_products(rows, f, d)


def encoder_products(b, l, d=512, f=FFN_DIM):
    r = b * l
    return mha_products(r, r, l, l, b, d) + ffn_products(r, d, f)


def decoder_products(b, t, l, d=512, f=FFN_DIM):
    rt, rm = b * t, b * l
    return (mha_products(rt, rt, t, t, b, d) + mha_products(rt, rm, t, l, b, d)
            + ffn_products(rt, d, f))


def text_products(cfg: dict, b, l):
    """The question encoder's and the program decoder's products."""
    d, t = cfg["text_emb_dim"], cfg["mgat_layers"]
    return (cfg["encoder_layers"] * encoder_products(b, l, d)
            + cfg["decoder_layers"] * decoder_products(b, t, l, d))


def graph_products(cfg: dict, b, nodes, edges):
    """The scene-graph encoder's and the GAT stack's products (the mask
    head's included) over ``nodes`` and ``edges`` rows of ``b`` graphs."""
    c, t = cfg["general_hidden_dim"], cfg["mgat_layers"]
    masked = sum(1 for m in cfg["mgat_masks"] if float(m) != 1.0)
    fl = linear_products(nodes, 4, 16) + linear_products(nodes, 16, 32)
    fl += linear_products(nodes, c + 32, c)
    fl += metalayer_products(nodes, edges, c)
    fl += t * gat_layer_products(nodes, edges, c, cfg["gat_heads"])
    fl += masked * (linear_products(nodes, c, c) + linear_products(b, c, c)
                    + 2.0 * nodes * c)
    return fl


def forward_flops(cfg: dict, b, n, e, l):
    """The port's ``forward_flops`` for the config of record: the matrix
    products of one eval forward of ``b`` questions at ``(n, e, l)``
    node, edge and token rows each."""
    c, d, t = cfg["general_hidden_dim"], cfg["text_emb_dim"], cfg["mgat_layers"]
    rn, re_ = float(b) * n, float(b) * e
    fl = text_products(cfg, b, l)
    fl += linear_products(b * t, d, c) + linear_products(b, t * d, c)
    fl += graph_products(cfg, b, rn, re_)
    fl += 2 * linear_products(rn, c, c) + 2 * linear_products(b, c, c)
    fl += 2.0 * rn * c
    fl += linear_products(b, 3 * c, 512) + linear_products(
        b, 512, cfg["num_answers"])
    return fl


def real_forward_flops(cfg: dict, sizes) -> float:
    """:func:`forward_flops` summed over questions at their own
    ``(nodes, edges, tokens)`` (the rows of ``sizes``)."""
    s = np.asarray(sizes, dtype=np.float64).reshape(-1, 3)
    return float(np.sum(forward_flops(cfg, 1, s[:, 0], s[:, 1], s[:, 2])))


# --------------------------------------------------- fused layers' work

def gat_layer_flops(nodes, edges, c=300, heads=4, fuse_instr=False):
    n, e = float(nodes), float(edges)
    hc, pd = heads * c, heads * c // 2
    fl = gat_layer_products(n, e, c, heads)
    fl += 12.0 * n * c if fuse_instr else 0.0
    fl += 2 * n * hc + 2.0 * e * hc + e + 4.0 * e * hc + 2.0 * e * hc
    fl += 8.0 * e * heads + 2.0 * e * hc + n * hc
    fl += 12.0 * n * pd + 12.0 * n * c + 2.0 * n * c + 4.0 * n + 10.0 * n * c
    return fl


def metalayer_flops(nodes, edges, c=300):
    n, e = float(nodes), float(edges)
    fl = metalayer_products(n, e, c)
    fl += 24.0 * e * c + e * c + e * c + n * c + 12.0 * n * c + 10.0 * n * c
    return fl


def encoder_layer_flops(b, l, d=512, f=FFN_DIM, heads=8, final_ln=False):
    r = b * l
    fl = encoder_products(b, l, d, f)
    fl += 3 * r * d + 2.0 * r * l + 4.0 * r * l * heads + r * d
    fl += r * d + 6.0 * r * d + 2.0 * r * f + r * d + r * d + 6.0 * r * d
    return fl + (6.0 * r * d if final_ln else 0.0)


def decoder_layer_flops(b, t, l, d=512, f=FFN_DIM, heads=8, final_ln=False):
    rt, rm = b * t, b * l
    fl = decoder_products(b, t, l, d, f)
    fl += 3 * rt * d + 7.0 * rt * t * heads + rt * d + 7.0 * rt * d
    fl += rt * d + 2 * rm * d + 7.0 * rt * l * heads + rt * d + 7.0 * rt * d
    fl += 2.0 * rt * f + rt * d + 7.0 * rt * d
    return fl + (6.0 * rt * d if final_ln else 0.0)


def _matrix_bytes(names: Sequence[Tuple[int, int]], b=2):
    return sum(b * i * o for i, o in names)


def graph_work(cfg: dict, b, nodes, edges) -> Tuple[float, float]:
    """``(flops, bytes)`` of ``scene_graph_encoder`` + ``gat_seq`` over
    ``b`` graphs of ``nodes`` and ``edges`` rows in all: the bbox MLP and
    reduction, the MetaLayer, the GAT layers (instruction fused on the
    unmasked ones) and the mask head.  Bytes: the node tokens, boxes and
    edge arrays read, the bf16 weights read, the node states and masks
    written, each once."""
    c, t, h = cfg["general_hidden_dim"], cfg["mgat_layers"], cfg["gat_heads"]
    masked = sum(1 for m in cfg["mgat_masks"] if float(m) != 1.0)
    fl = (linear_products(nodes, 4, 16) + linear_products(nodes, 16, 32)
          + linear_products(nodes, c + 32, c) + 20.0 * nodes * (c + 48))
    fl += metalayer_flops(nodes, edges, c)
    fl += sum(gat_layer_flops(nodes, edges, c, h,
                              fuse_instr=float(m) == 1.0)
              for m in cfg["mgat_masks"])
    fl += masked * (linear_products(nodes, c, c) + linear_products(b, c, c)
                    + 2.0 * nodes * c + 40.0 * nodes)
    weights = _matrix_bytes([(4, 16), (16, 32), (c + 32, c), (3 * c, c),
                                  (c, c), (2 * c, c), (c, c), (2 * c, c),
                                  (c, c)])
    weights += t * _matrix_bytes([(c, h * c)] * 3 + [
        (h * c, h * c // 2), (h * c // 2, c)])
    weights += masked * _matrix_bytes([(c, c), (c, c)])
    inputs = nodes * (4 * 4 + 4 * 4 + 1) + edges * (4 * 4 + 1) + b * t * c * 2
    outputs = nodes * (c * 2 + 2) + edges * h * 4 * t
    return fl, weights + inputs + outputs


def text_work(cfg: dict, b, tokens, l_cap) -> Tuple[float, float]:
    """``(flops, bytes)`` of ``question_encoder`` + ``program_decoder`` for
    ``b`` questions of ``tokens`` tokens in all (their mean length for the
    attention terms).  Bytes: token states in and instruction states out,
    and the bf16 weights, once."""
    d, t = cfg["text_emb_dim"], cfg["mgat_layers"]
    l = tokens / max(b, 1)
    fl = sum(encoder_layer_flops(b, l, d, final_ln=i == cfg["encoder_layers"] - 1)
             for i in range(cfg["encoder_layers"]))
    fl += sum(decoder_layer_flops(b, t, l, d,
                                  final_ln=i == cfg["decoder_layers"] - 1)
              for i in range(cfg["decoder_layers"]))
    per_layer = 2 * (4 * d * d + 2 * d * FFN_DIM)
    weights = (cfg["encoder_layers"] * per_layer
               + cfg["decoder_layers"] * (per_layer + 2 * 4 * d * d))
    return fl, weights + tokens * d * 2 * 2 + b * t * d * 2


def least_seconds(flops: float, nbytes: float,
                  dtype: str = "bfloat16") -> float:
    """The larger of the operations' and the bytes' time at the peaks."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


# --------------------------------------------------------------- traces

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by ``(start, end)`` intervals (overlaps once)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


class Trace:
    """A Chrome trace of ``torch.profiler`` reduced to what the metric
    readers need (times in seconds)."""

    def __init__(self, events: List[dict], window_name: str):
        win = [e for e in events if e.get("name") == window_name
               and e.get("ph") == "X"]
        if not win:
            raise ValueError(f"the trace has no {window_name!r} range")
        self.lo = win[0]["ts"] * 1e-6
        self.hi = (win[0]["ts"] + win[0]["dur"]) * 1e-6
        self.host_tid = win[0].get("tid")
        self.device: List[Tuple[float, float, str, Optional[int]]] = []
        self.launch: Dict[int, float] = {}
        self.ranges: List[Tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args") or {}
            s, d = e["ts"] * 1e-6, e.get("dur", 0) * 1e-6
            if cat in DEVICE_CATS:
                self.device.append((s, s + d, e["name"],
                                    args.get("correlation")))
            elif "correlation" in args and cat in ("cuda_runtime",
                                                    "cuda_driver"):
                self.launch[args["correlation"]] = s
            elif cat == "user_annotation" and e.get("tid") == self.host_tid:
                self.ranges.append((s, s + d, e["name"]))

    @classmethod
    def load(cls, path: str, window_name: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events, window_name)

    def clipped(self):
        return [(max(s, self.lo), min(e, self.hi), n, c)
                for s, e, n, c in self.device if e > self.lo and s < self.hi]

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        return union_length((s, e) for s, e, _, _ in self.clipped())

    def families(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s, e, n, _ in self.clipped():
            f = kernel_family(n)
            out[f] = out.get(f, 0.0) + (e - s)
        return out

    def phase_at(self, t: float, prefix: str) -> str:
        """The innermost host range named ``prefix...`` open at ``t``."""
        best = None
        for s, e, n in self.ranges:
            if s <= t < e and n.startswith(prefix):
                if best is None or s >= best[0]:
                    best = (s, n[len(prefix):])
        return best[1] if best else "harness loop"

    def idle_gaps(self, prefix: str, top: int = 10):
        """The ``top`` longest stretches with nothing on the device, each
        named by the host phase open when it began."""
        gs = gaps(((s, e) for s, e, _, _ in self.clipped()), self.lo, self.hi)
        gs.sort(key=lambda g: g[1] - g[0], reverse=True)
        return [[self.phase_at(s, prefix), e - s] for s, e in gs[:top]]

    def device_by_range(self, prefix: str) -> Dict[str, float]:
        """Device seconds of the operations launched inside each host range
        named ``prefix...`` (by the launch's correlation)."""
        spans = sorted((s, e, n) for s, e, n in self.ranges
                       if n.startswith(prefix))
        starts = [s for s, _, _ in spans]
        out: Dict[str, float] = {}
        for s, e, _, corr in self.device:
            t = self.launch.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            while i >= 0 and not (spans[i][0] <= t < spans[i][1]):
                i -= 1
            if i >= 0:
                name = spans[i][2][len(prefix):]
                out[name] = out.get(name, 0.0) + (e - s)
        return out
