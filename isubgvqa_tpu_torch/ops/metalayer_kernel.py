"""Scene-graph MetaLayer round + GraphNorm, on the card.

Replaces ``isubgvqa_tpu/ops/pallas/metalayer_kernel.py:fused_metalayer``
(``_kernel``).

Design on the H100, a fixed sequence of hand-written launches (nine):

0. ``csrc/metalayer_kernel.cu:isg_graph_index``: each edge's src and dst
   row in the flattened node rows (-1 on padding) and the f32 edge
   mask, in one launch;
1. edge MLP ``[x_src, x_dst, e]`` 900 -> 300 (GELU) as one launch of
   the graph-layer GEMM (:func:`.gemm.product`: for bf16
   ``csrc/gemm_gather_sm90.cu``, wgmma fed by cp.async gathers; for f32
   ``csrc/gemm.cu``'s 3xTF32 form) whose A operand is three segments,
   two of them gathered by row index, against the ``[C, 3C]`` weight
   split by columns — the ``[E, 900]`` concat never exists
   (``metalayer_kernel.py:63-77``);
2. edge MLP 300 -> 300 gives ``e_out``;
3. node MLP1 on ``[x_src, e_out]`` (GELU), then 300 -> 300 times the
   edge mask;
4. ``csrc/metalayer_kernel.cu:isg_scatter_mean``: the mean over each
   node's incoming edges, degree clamped to >= 1;
5. node MLP2 on ``[x, agg]`` (GELU), then 300 -> 300;
6. ``isg_graph_norm``: GraphNorm over each graph's valid nodes.

Bound: the MLP products dominate (about 14 C^2 FLOPs per edge), so the
round is operation-bound and waits on the GEMM's speed.  Padding
edges gather zero rows (their one-hot rows are zero on the TPU), so
``e_out`` of a padding edge is the MLP of its edge features alone,
exactly as in the JAX kernel.

On a CPU tensor the wrapper runs :func:`fused_metalayer_plain`; on a
CUDA tensor it launches the kernels or raises.  :func:`metalayer_launch`
can keep what the training backward reads (:mod:`.metalayer_train`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _lib
from .gemm import linear_plain, product, ste

GN_EPS = 1e-5
NEG = -1.0e30

KEYS = ("ew1", "eb1", "ew2", "eb2", "n1w1", "n1b1", "n1w2", "n1b2",
        "n2w1", "n2b1", "n2w2", "n2b2", "gn_w", "gn_b", "gn_a")


def graph_norm_plain(p, node_mask, w, b, a, instr=None):
    """GraphNorm over each graph's valid nodes (f32), optionally after
    the instruction SDP softmax ``softmax_nodes(p . instr / sqrt(C))``
    that scales ``p`` (the GAT layer's node half)."""
    p = p.float()
    nm = node_mask.float()[..., None]
    if instr is not None:
        lg = (p * instr.float()[:, None, :]).sum(-1) / math.sqrt(p.shape[-1])
        lg = torch.where(node_mask, lg, torch.full_like(lg, NEG))
        ex = torch.exp(lg - lg.amax(1, keepdim=True)) * nm[..., 0]
        den = ex.sum(1, keepdim=True)
        p = p * (ex / torch.where(den > 1e-12, den, torch.ones_like(den)))[..., None]
    count = torch.clamp(nm.sum(1, keepdim=True), min=1.0)
    mean = (p * nm).sum(1, keepdim=True) / count
    shifted = p - a.float() * mean
    var = (shifted * shifted * nm).sum(1, keepdim=True) / count
    normed = shifted * torch.rsqrt(var + GN_EPS) * nm
    return normed * w.float() + b.float()


def gather_rows(x, idx, valid):
    """``x [B, N, C]`` rows ``idx [B, E]``, zero where not ``valid``."""
    g = torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))
    return g * valid.float()[..., None]


def fused_metalayer_plain(x, e_attr, src, dst, edge_mask, node_mask, params):
    """Plain version of the round; with f32 master ``params`` and a grad
    enabled it is also the training layer's plain version (every rounding
    to the model dtype ``x.dtype`` goes through :func:`.gemm.ste`)."""
    p = params
    dtype = x.dtype
    c = x.shape[-1]
    n = x.shape[1]
    lin = lambda a, w, b=None: linear_plain(a, w, b, dtype=dtype)
    xf = x.float()
    ef = ste(e_attr, dtype)
    xs = gather_rows(xf, src, edge_mask)
    xd = gather_rows(xf, dst, edge_mask)
    w1 = p["ew1"]
    h = F.gelu(lin(xs, w1[:, :c]) + lin(xd, w1[:, c:2 * c])
               + lin(ef, w1[:, 2 * c:]) + p["eb1"].float())
    e_out = ste(lin(h, p["ew2"], p["eb2"]), dtype)
    n1 = p["n1w1"]
    m = F.gelu(lin(xs, n1[:, :c]) + lin(e_out, n1[:, c:]) + p["n1b1"].float())
    m = lin(m, p["n1w2"], p["n1b2"])
    m = m * edge_mask.float()[..., None]
    oh_dst = F.one_hot(dst.long(), n).float() * edge_mask.float()[..., None]
    agg = torch.einsum("ben,bec->bnc", oh_dst, m)
    deg = torch.clamp(oh_dst.sum(1), min=1.0)[..., None]
    agg = ste(agg / deg, dtype)
    n2 = p["n2w1"]
    out = F.gelu(lin(xf, n2[:, :c]) + lin(agg, n2[:, c:]) + p["n2b1"].float())
    out = lin(out, p["n2w2"], p["n2b2"])
    x_out = graph_norm_plain(out, node_mask, p["gn_w"], p["gn_b"], p["gn_a"])
    return x_out.to(dtype), e_out.to(dtype)


def graph_index(src, dst, edge_mask, n: int):
    """Per-edge row indices of ``src`` and ``dst`` into the flattened
    ``[B * N, C]`` node rows, ``[2, B * E]`` int32; -1 (a zero row) on
    padding edges and on an index outside the graph, so that the gather
    never reads another graph's rows: the plain version of
    ``csrc/metalayer_kernel.cu:isg_graph_index``."""
    pos = torch.stack([src, dst]).to(torch.int32)              # [2, B, E]
    base = torch.arange(0, pos.shape[1] * n, n, dtype=torch.int32,
                        device=pos.device)[:, None]
    inside = edge_mask & (pos >= 0) & (pos < n)
    return (pos + base).masked_fill_(~inside, -1).reshape(2, -1)


def graph_index_launch(src32, dst32, edge_mask, n: int):
    """:func:`graph_index` and the edge mask as f32 ``[B, E]``, on the card
    in one launch (``isg_graph_index``); ``src32`` / ``dst32`` int32."""
    b, e = src32.shape
    emb = edge_mask.to(torch.bool).contiguous()
    gidx = torch.empty((2, b * e), dtype=torch.int32, device=src32.device)
    em = torch.empty((b, e), dtype=torch.float32, device=src32.device)
    _lib.check_cuda(src32, dst32, emb)
    _lib.call("isg_graph_index", src32.data_ptr(), dst32.data_ptr(),
              emb.data_ptr(), gidx.data_ptr(), em.data_ptr(), b, e, n)
    return gidx, em


def metalayer_launch(x, e_attr, src, dst, edge_mask, node_mask, params,
                     save: bool = False):
    """The round's launches on CUDA tensors, ``params`` shipped.  Returns
    ``(x_out, e_out, saved)``; with ``save`` the GEMMs also write their
    f32 pre-activations and ``saved`` keeps what the backward reads."""
    p = params
    b, n, c = x.shape
    e = src.shape[1]
    if n > 512:     # the aggregation holds [N, 64] f32 in shared memory
        raise ValueError(f"fused_metalayer takes N <= 512 (got {n})")
    dtype = x.dtype
    xt = x.reshape(b * n, c).contiguous()
    et = e_attr.to(dtype).reshape(b * e, c).contiguous()
    src32 = src.to(torch.int32).contiguous()
    dst32 = dst.to(torch.int32).contiguous()
    (gsrc, gdst), em = graph_index_launch(src32, dst32, edge_mask, n)
    pre = ((lambda rows: torch.empty((rows, c), dtype=torch.float32,
                                     device=x.device))
           if save else (lambda rows: None))
    h1, m1p, o1p = pre(b * e), pre(b * e), pre(b * n)
    h = product([(xt, gsrc), (xt, gdst), (et, None)], p["ew1"], p["eb1"],
                act="gelu", out_dtype=dtype, pre=h1)
    e_out = product([(h, None)], p["ew2"], p["eb2"], out_dtype=dtype)
    m1 = product([(xt, gsrc), (e_out, None)], p["n1w1"], p["n1b1"],
                 act="gelu", out_dtype=dtype, pre=m1p)
    m = product([(m1, None)], p["n1w2"], p["n1b2"],
                row_scale=em.reshape(-1))
    agg = torch.empty((b * n, c), dtype=dtype, device=x.device)
    _lib.call("isg_scatter_mean", m.data_ptr(), dst32.data_ptr(),
              em.data_ptr(), agg.data_ptr(), _lib.dt(agg), b, n, e, c)
    o1 = product([(xt, None), (agg, None)], p["n2w1"], p["n2b1"],
                 act="gelu", out_dtype=dtype, pre=o1p)
    o2 = product([(o1, None)], p["n2w2"], p["n2b2"])
    x_out = torch.empty((b * n, c), dtype=dtype, device=x.device)
    nm = node_mask.to(torch.float32).contiguous()
    _lib.check_cuda(p["gn_w"], p["gn_b"], p["gn_a"])
    _lib.call("isg_graph_norm", o2.data_ptr(), nm.data_ptr(), None, None,
              None, _lib.dt(x), p["gn_w"].data_ptr(), p["gn_b"].data_ptr(),
              p["gn_a"].data_ptr(), x_out.data_ptr(), _lib.dt(x_out), b, n,
              c, GN_EPS)
    saved = (dict(xt=xt, et=et, em=em, nm=nm, gsrc=gsrc, gdst=gdst,
                  src32=src32, dst32=dst32, h1=h1, h=h, e_out=e_out, m1p=m1p,
                  m1=m1, agg=agg, o1p=o1p, o1=o1, o2=o2)
             if save else None)
    return x_out.reshape(b, n, c), e_out.reshape(b, e, c), saved


def fused_metalayer(x, e_attr, src, dst, edge_mask, node_mask, params):
    """``x [B, N, C]``, ``e_attr [B, E, C]`` at the model dtype ->
    ``(x_out [B, N, C], e_out [B, E, C])``.  ``params``: :data:`KEYS`,
    weights as torch Linear ``[out, in]`` (the edge MLP's first weight
    is ``[C, 3C]``), vectors f32."""
    if not x.is_cuda:
        return fused_metalayer_plain(x, e_attr, src, dst, edge_mask,
                                     node_mask, params)
    x_out, e_out, _ = metalayer_launch(x, e_attr, src, dst, edge_mask,
                                       node_mask, params)
    fused_metalayer.launches += 1
    return x_out, e_out


fused_metalayer.launches = 0
