"""One masked GATv2 layer (eval), on the card.

Replaces ``isubgvqa_tpu/ops/pallas/gat_kernel.py:fused_gat_layer``
(``_fused_gat_call``, body ``_kernel``).

Design on the H100, a fixed sequence of hand-written launches:

1. with ``fuse_instr``: ``csrc/gat_kernel.cu:isg_instr_gelu``,
   ``xf = gelu(h * instr)``;
2. the graph-layer GEMM (:func:`.gemm.product`: for bf16
   ``csrc/gemm_gather_sm90.cu``, wgmma fed by cp.async; for f32
   ``csrc/gemm.cu``'s 3xTF32 form): ``x_l`` and ``x_r`` as one product
   against the stacked ``[2 H*C, C_in]`` weight and bias (``xf`` read
   once; each column's sum is unchanged), then the layer's lin_edge
   projection of the edge features, each rounded to the model dtype as
   the Pallas kernel rounds them (``:124-140``).  A ``concat_instr``
   layer's input is ``xf = [h | instr[graph]]`` (``C_in = 2C``,
   ``gat_kernel.py:331-333``), built by :func:`concat_instr_features`
   (read instead as two segments of the GEMM, ``h`` and the instruction
   rows gathered by each node's graph, the layer was no faster on the
   H100 in bf16 and slower in f32: ``PERF.md`` section 6);
3. ``isg_gat_edge``, one block per graph: edge gate, leaky-ReLU message,
   4-head logits, per-destination softmax, ``alpha``, and the
   aggregation ``conv = sum x_l[src] * alpha * egate + bias`` over
   incoming-edge lists built in shared memory (edges are not sorted by
   destination);
4. the same GEMM for ``x_proj`` 1200 -> 600 -> 300, GELU after both;
5. ``csrc/metalayer_kernel.cu:isg_graph_norm``: the instruction SDP
   softmax over valid nodes, GraphNorm, the residual and, with
   ``apply_mask_to_h``, the node gate's multiply after it
   (``gat_kernel.py:224-225``).

The TPU's graph packing (``gat_kernel.py:278-317``) fed its 128-row MXU
and is not carried over: one block per graph is natural here.

Bound: the lin_edge and x_l/x_r/x_proj products (about 0.7 MFLOP per
edge and 3.2 MFLOP per node at C = 300, H = 4) make the layer
operation-bound at the main path's shapes; the edge kernel itself is
bound by reading x_l, x_r and the projected edges once per edge.  The
``[B, E, H*C]`` projected edges do go through device memory here (the
TPU kept them in VMEM); fusing them into the edge kernel is later work.
Seven launches a call (six without ``fuse_instr``).

On a CPU tensor the wrapper runs :func:`fused_gat_layer_plain`; on a
CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _lib
from .gemm import cached, linear_plain, product
from .metalayer_kernel import GN_EPS, NEG, graph_norm_plain

KEYS = ("wl", "bl", "wr", "br", "we", "att", "cbias", "w1", "b1", "w2",
        "b2", "gn_w", "gn_b", "gn_a")
NEGATIVE_SLOPE = 0.2        # GATv2's leaky-ReLU


def fused_gat_layer_plain(h, xf, instr, gate, src, dst, edge_mask, node_mask,
                          e_attr, params, fuse_instr: bool = False,
                          apply_mask_to_h: bool = False):
    p = params
    dtype = h.dtype
    b, n, c = h.shape
    e = src.shape[1]
    att = p["att"].float().reshape(-1, c)
    heads = att.shape[0]
    hf = h.float()
    ins = instr.to(dtype).float()
    if fuse_instr:
        xf = F.gelu(hf * ins[:, None, :])
    xf = xf.to(dtype)
    x_l = linear_plain(xf, p["wl"], p["bl"]).to(dtype).float()
    x_r = linear_plain(xf, p["wr"], p["br"]).to(dtype).float()
    eproj = linear_plain(e_attr.to(dtype), p["we"]).to(dtype).float()

    em = edge_mask.float()[..., None]                          # [B, E, 1]
    oh_src = F.one_hot(src.long(), n).float() * em             # [B, E, N]
    oh_dst = F.one_hot(dst.long(), n).float() * em
    g = gate.reshape(b, n, 1).to(dtype).float()
    xs = oh_src @ x_l
    m = xs + oh_dst @ x_r + eproj
    egate = (oh_src @ g) * (oh_dst @ g)                        # [B, E, 1]
    m = m * egate
    m = torch.where(m >= 0, m, m * NEGATIVE_SLOPE)
    m = m * egate
    logits = (m.reshape(b, e, heads, c) * att).sum(-1)         # [B, E, H]
    logits = torch.where(em > 0, logits, torch.full_like(logits, NEG))
    inc = (oh_dst > 0)[..., None]                              # [B, E, N, 1]
    max_n = torch.where(inc, logits[:, :, None, :],
                        torch.full_like(logits[:, :, None, :], NEG)).amax(1)
    max_e = oh_dst @ max_n
    expv = torch.exp(logits - torch.clamp(max_e, min=NEG)) * em
    denom = oh_dst @ (oh_dst.transpose(1, 2) @ expv)
    alpha = expv / torch.where(denom > 1e-12, denom, torch.ones_like(denom))
    w = alpha * egate
    weighted = (xs.reshape(b, e, heads, c) * w[..., None]).reshape(b, e, -1)
    conv = oh_dst.transpose(1, 2) @ weighted.to(dtype).float()
    conv = (conv + p["cbias"].float()).to(dtype)

    q = linear_plain(conv, p["w1"], p["b1"], "gelu").to(dtype)
    q = linear_plain(q, p["w2"], p["b2"], "gelu")
    out = graph_norm_plain(q, node_mask, p["gn_w"], p["gn_b"], p["gn_a"],
                           instr=ins) + hf
    if apply_mask_to_h:
        out = out * g
    return out.to(dtype), alpha


def concat_instr_features(h, instr):
    """``[h | instr[graph]]``, ``[B, N, 2C]`` at ``h``'s dtype: the input
    of a ``concat_instr`` layer (``mgat.py:179-184``)."""
    ins = instr.to(h.dtype)[:, None, :].expand(h.shape)
    return torch.cat([h, ins], dim=-1)


def stacked_lr(params):
    """``(weight [2 H*C, C_in], f32 bias [2 H*C])``: x_l's over x_r's,
    made once while the four tensors stand (:func:`.gemm.cached`)."""
    wl, wr, bl, br = (params[k] for k in ("wl", "wr", "bl", "br"))
    return cached(wl, "x_lr", (wr, bl, br), lambda: (
        torch.cat([wl, wr]).contiguous(),
        torch.cat([bl, br]).to(torch.float32).contiguous()))


def fused_gat_layer(h, xf, instr, gate, src, dst, edge_mask, node_mask,
                    e_attr, params, fuse_instr: bool = False,
                    apply_mask_to_h: bool = False):
    """One eval MGAT layer; returns ``(out [B, N, C], alpha [B, E, H])``.

    ``h [B, N, C]`` layer input (residual), ``xf [B, N, C_in]`` the
    instruction-fused features (``[h | instr]`` on a ``concat_instr``
    layer; ignored with ``fuse_instr``, which computes
    ``gelu(h * instr)`` itself), ``instr [B, C]``,
    ``gate [B, N, 1]`` (ones on unmasked layers; with ``apply_mask_to_h``
    it also multiplies the output), ``src/dst/edge_mask [B, E]``,
    ``node_mask [B, N]``, ``e_attr [B, E, C]`` the encoded edges.
    ``params``: :data:`KEYS` — ``wl/wr [H*C, C_in]``, ``we [H*C, C]``,
    ``w1 [H*C/2, H*C]``, ``w2 [C, H*C/2]`` as torch Linear weights at the
    model dtype; ``att [H, C]`` and the vectors f32.
    """
    if not h.is_cuda:
        return fused_gat_layer_plain(h, xf, instr, gate, src, dst, edge_mask,
                                     node_mask, e_attr, params, fuse_instr,
                                     apply_mask_to_h)
    p = params
    b, n, c = h.shape
    e = src.shape[1]
    if n > 256 or e > 1024:
        raise ValueError(f"fused_gat_layer takes N <= 256 and E <= 1024 "
                         f"(got N={n}, E={e})")
    dtype = h.dtype
    att = p["att"].to(torch.float32).reshape(-1).contiguous()
    heads = att.shape[0] // c
    hc = heads * c
    if b * e * hc > _lib.MAX_ELEMENTS:     # the projected edges [B*E, H*C]
        raise ValueError(f"fused_gat_layer takes B*E*H*C < 2^31 (got B={b}, "
                         f"E={e}, H*C={hc})")
    ht = h.reshape(b * n, c).contiguous()
    it = instr.to(dtype).contiguous()
    _lib.check_cuda(ht, it, att)
    if fuse_instr:
        xft = torch.empty_like(ht)
        _lib.call("isg_instr_gelu", ht.data_ptr(), it.data_ptr(),
                  xft.data_ptr(), _lib.dt(ht), b, n, c)
        segments = [(xft, None)]
    else:
        segments = [(xf.to(dtype).reshape(b * n, -1).contiguous(), None)]
    w_lr, b_lr = stacked_lr(p)
    x_lr = product(segments, w_lr, b_lr, out_dtype=dtype)
    et = e_attr.to(dtype).reshape(b * e, c).contiguous()
    eproj = product([(et, None)], p["we"], None, out_dtype=dtype)

    g = gate.reshape(b, n).to(dtype).to(torch.float32).contiguous()
    em = edge_mask.to(torch.float32).contiguous()
    nm = node_mask.to(torch.float32).contiguous()
    src32 = src.to(torch.int32).contiguous()
    dst32 = dst.to(torch.int32).contiguous()
    cbias = p["cbias"].to(torch.float32).contiguous()
    _lib.check_cuda(g, em, nm, src32, dst32, cbias)
    alpha = torch.empty((b, e, heads), dtype=torch.float32, device=h.device)
    conv = torch.empty((b * n, hc), dtype=dtype, device=h.device)
    _lib.call("isg_gat_edge", x_lr.data_ptr(),
              x_lr.data_ptr() + hc * x_lr.element_size(), 2 * hc,
              eproj.data_ptr(), _lib.dt(x_lr), g.data_ptr(), src32.data_ptr(),
              dst32.data_ptr(), em.data_ptr(), att.data_ptr(),
              cbias.data_ptr(), alpha.data_ptr(), conv.data_ptr(), b, n, e,
              heads, c)

    q = product([(conv, None)], p["w1"], p["b1"], act="gelu",
                out_dtype=dtype)
    q = product([(q, None)], p["w2"], p["b2"], act="gelu")
    out = torch.empty((b * n, c), dtype=dtype, device=h.device)
    _lib.check_cuda(p["gn_w"], p["gn_b"], p["gn_a"])
    _lib.call("isg_graph_norm", q.data_ptr(), nm.data_ptr(), it.data_ptr(),
              ht.data_ptr(), g.data_ptr() if apply_mask_to_h else None,
              _lib.dt(ht), p["gn_w"].data_ptr(),
              p["gn_b"].data_ptr(), p["gn_a"].data_ptr(), out.data_ptr(),
              _lib.dt(out), b, n, c, GN_EPS)
    fused_gat_layer.launches += 1
    return out.reshape(b, n, c), alpha


fused_gat_layer.launches = 0
