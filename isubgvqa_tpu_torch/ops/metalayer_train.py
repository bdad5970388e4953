"""Training MetaLayer round + GraphNorm: forward and backward on the card.

Replaces ``isubgvqa_tpu/ops/pallas/metalayer_train.py:
fused_metalayer_train`` (the custom VJP whose forward is
``fused_metalayer`` and whose backward is ``_metalayer_bwd_call`` /
``_bwd_kernel``).

A :class:`torch.autograd.Function`:

* forward — the eval round's launches (:func:`.metalayer_kernel.
  metalayer_launch`), which also write the three GELU pre-activations
  (f32, from the graph-layer GEMM's epilogue) and keep the products'
  operands.  The TPU recomputes the round in VMEM from its inputs
  instead; here the largest saved tensors at B = 256 graphs, E = 384
  edges are the f32 edge pre-activations (about 0.12 GB each), small
  beside the card's 80 GB;
* backward — ten launches (:func:`metalayer_backward`):
  ``isg_graph_norm_bwd`` (one block per graph) and one ``isg_reduce_rows``
  for its three parameter gradients; six stages of the staged backward
  GEMM (:func:`.gemm.bwd_stage`, ``csrc/gemm_bwd.cu``), one per MLP
  product, each taking the product's weight gradient with its bias
  gradient (a virtual ones column) and its input gradient with GELU's
  derivative, the accumulation into the ``e_out`` gradient or the cast of
  ``de`` in the epilogue; the gathered ``x[src]`` / ``x[dst]`` rows read
  through the forward's row index and the concatenated first-layer
  weights taken whole, so no ``[E, 3C]`` concat and no weight slice
  exists in either direction; ``isg_scatter_mean_bwd`` (a gather) and
  ``isg_scatter_rows``, which sends the gradients of the gathered rows
  back to their nodes deterministically and writes ``dx`` at its dtype.

Bound on the H100: the backward's products, about 2.8e11 FLOP at B = 256
graphs, N = 128, E = 384, padding rows counted; they are f32-accurate by
design, which the tensor cores reach in split form.  In a bf16 model the
stage GEMM runs bf16x3 on wgmma (a 330 TFLOP/s ceiling; the 3xTF32 form
of ``csrc/gemm_any.cu`` tops out at 248 with a bf16 operand), and the
elementwise and column-sum work rides in its epilogue; an f32 model keeps
the 3xTF32 core behind the same stages.

The plain version is :func:`.metalayer_kernel.fused_metalayer_plain`
(f32 masters, roundings through :func:`.gemm.ste`) differentiated by
autograd.  On a CPU tensor the wrapper runs it; on a CUDA tensor it
launches the kernels or raises.  :func:`metalayer_backward` runs on CPU
tensors too, through each launch's plain twin
(:func:`metalayer_saved_plain` makes the forward's saved tensors there),
so its orchestration is tested without the card.
"""

from __future__ import annotations

import torch

from . import _lib
from .gemm import (Out, bwd_stage, gemm_gather_plain, reduce_rows,
                   stage_dgrad, stage_wgrad)
from .metalayer_kernel import (GN_EPS, KEYS, fused_metalayer_plain,
                               graph_index, graph_norm_plain,
                               metalayer_launch)
from .text_train import ship_params


# the eval round's plain version, differentiated by autograd
fused_metalayer_train_plain = fused_metalayer_plain


def graph_norm_bwd(dout, p, nm, w, a):
    """``(dp, d w, d b, d a)`` of GraphNorm over ``p [B*N, C]`` f32 with
    the node mask ``nm [B, N]`` (f32): ``isg_graph_norm_bwd`` and one
    ``isg_reduce_rows`` over its per-graph partials (autograd of
    :func:`.metalayer_kernel.graph_norm_plain` on CPU tensors)."""
    b, n = nm.shape
    c = p.shape[1]
    if not p.is_cuda:
        leaves = [t.detach().float().requires_grad_(True)
                  for t in (p.reshape(b, n, c), w, torch.zeros_like(w), a)]
        with torch.enable_grad():
            y = graph_norm_plain(leaves[0], nm > 0, leaves[1], leaves[2],
                                 leaves[3])
            dp, dw, db, da = torch.autograd.grad(
                y, leaves, dout.reshape(b, n, c).float())
        return dp.reshape(b * n, c), dw, db, da
    dout = dout.reshape(b * n, c).contiguous()
    dp = torch.empty_like(p)
    part = torch.empty((b, 3, c), dtype=torch.float32, device=p.device)
    _lib.check_cuda(dout, p, nm, w, a)
    _lib.call("isg_graph_norm_bwd", dout.data_ptr(), _lib.dt(dout),
              p.data_ptr(), nm.data_ptr(), w.data_ptr(), a.data_ptr(),
              dp.data_ptr(), part.data_ptr(), b, n, c, GN_EPS)
    return (dp, *reduce_rows(part))


def _valid_rows(idx, em, n):
    """Each edge's row in its graph (clamped) and whether it counts: a
    valid edge whose index lies in the graph."""
    return idx.long().clamp(0, n - 1), (em > 0) & (idx >= 0) & (idx < n)


def scatter_mean_bwd(d_agg, dst32, em, n: int):
    """The mean aggregation's backward, ``d_m [B*E, C]`` f32: each valid
    edge takes its destination's gradient over the destination's degree
    (``isg_scatter_mean_bwd``)."""
    b, e = dst32.shape
    c = d_agg.shape[1]
    if not d_agg.is_cuda:
        d, ok = _valid_rows(dst32, em, n)
        deg = torch.zeros(b, n).scatter_add_(1, d, ok.float())
        rows = d_agg.reshape(b, n, c).gather(1, d[..., None].expand(-1, -1, c))
        scale = ok.float() / deg.gather(1, d).clamp(min=1.0)
        return (rows * scale[..., None]).reshape(b * e, c)
    d_m = torch.empty((b * e, c), dtype=torch.float32, device=d_agg.device)
    _lib.call("isg_scatter_mean_bwd", d_agg.data_ptr(), dst32.data_ptr(),
              em.data_ptr(), d_m.data_ptr(), b, n, e, c)
    return d_m


def scatter_rows(ds, dd, s, base, dtype):
    """``base + `` the gradients of the gathered ``x[src]`` rows ``ds``
    and ``x[dst]`` rows ``dd`` (f32 ``[B*E, C]``) summed into their nodes
    over the valid edges, ``[B*N, C]`` at ``dtype``
    (``isg_scatter_rows``)."""
    b, e = s["src32"].shape
    n = base.shape[0] // b
    c = base.shape[1]
    if not base.is_cuda:
        si, ok_s = _valid_rows(s["src32"], s["em"], n)
        di, ok_d = _valid_rows(s["dst32"], s["em"], n)
        ok = (ok_s & ok_d).float()[..., None]
        acc = torch.zeros(b, n, c)
        for idx, rows in ((si, ds), (di, dd)):
            acc.scatter_add_(1, idx[..., None].expand(-1, -1, c),
                             rows.reshape(b, e, c) * ok)
        return (base.reshape(b, n, c) + acc).reshape(b * n, c).to(dtype)
    out = torch.empty((b * n, c), dtype=dtype, device=base.device)
    _lib.call("isg_scatter_rows", ds.data_ptr(), dd.data_ptr(),
              s["src32"].data_ptr(), s["dst32"].data_ptr(),
              s["em"].data_ptr(), base.data_ptr(), out.data_ptr(),
              _lib.dt(out), b, n, e, c)
    return out


def metalayer_backward(dxo, deo, s, p, dtypes, stage=bwd_stage):
    """Gradients of the round from the output gradients ``dxo [B, N, C]``
    and ``deo [B, E, C]`` (or None), the forward's ``saved`` ``s`` and the
    shipped params ``p``: ``(dx [B*N, C], de [B*E, C])`` at ``dtypes``
    (x's and e_attr's) and the f32 parameter gradients.  ``stage`` runs
    each product stage (:func:`.gemm.bwd_stage`; a check may wrap it)."""
    xt = s["xt"]
    c = xt.shape[1]
    rn, re_ = xt.shape[0], s["et"].shape[0]
    f32 = dict(dtype=torch.float32, device=xt.device)
    new = lambda rows, width=c, **kw: torch.empty((rows, width),
                                                  **{**f32, **kw})
    g = {k: new(c, w) for k, w in (("n2w2", c), ("n2w1", 2 * c),
                                   ("n1w2", c), ("n1w1", 2 * c), ("ew2", c),
                                   ("ew1", 3 * c))}
    g.update({k: torch.empty(c, **f32) for k in ("n2b2", "n2b1", "n1b2",
                                                 "n1b1", "eb2", "eb1")})
    d_o2, g["gn_w"], g["gn_b"], g["gn_a"] = graph_norm_bwd(
        dxo, s["o2"], s["nm"], p["gn_w"], p["gn_a"])
    d_o1 = new(rn)
    stage(stage_wgrad(d_o2, [(s["o1"], None)], g["n2w2"], g["n2b2"]),
          stage_dgrad(d_o2, p["n2w2"], [Out(d_o1, act="gelu",
                                            pre=s["o1p"])]))
    dx, d_agg = new(rn), new(rn)
    stage(stage_wgrad(d_o1, [(xt, None), (s["agg"], None)], g["n2w1"],
                      g["n2b1"]),
          stage_dgrad(d_o1, p["n2w1"], [Out(dx), Out(d_agg)]))
    d_m = scatter_mean_bwd(d_agg, s["dst32"], s["em"], rn // s["nm"].shape[0])
    d_m1 = new(re_)
    stage(stage_wgrad(d_m, [(s["m1"], None)], g["n1w2"], g["n1b2"]),
          stage_dgrad(d_m, p["n1w2"], [Out(d_m1, act="gelu",
                                           pre=s["m1p"])]))
    d_xs, d_eout = new(re_), new(re_)
    deo = None if deo is None else deo.reshape(re_, c).contiguous()
    stage(stage_wgrad(d_m1, [(xt, s["gsrc"]), (s["e_out"], None)],
                      g["n1w1"], g["n1b1"]),
          stage_dgrad(d_m1, p["n1w1"], [Out(d_xs), Out(d_eout, add=deo)]))
    d_h1 = new(re_)
    stage(stage_wgrad(d_eout, [(s["h"], None)], g["ew2"], g["eb2"]),
          stage_dgrad(d_eout, p["ew2"], [Out(d_h1, act="gelu",
                                             pre=s["h1"])]))
    d_xd, de = new(re_), new(re_, dtype=dtypes[1])
    stage(stage_wgrad(d_h1, [(xt, s["gsrc"]), (xt, s["gdst"]),
                             (s["et"], None)], g["ew1"], g["eb1"]),
          stage_dgrad(d_h1, p["ew1"], [Out(d_xs, add=d_xs), Out(d_xd),
                                       Out(de)]))
    return scatter_rows(d_xs, d_xd, s, dx, dtypes[0]), de, g


def metalayer_saved_plain(x, e_attr, src, dst, edge_mask, node_mask, p):
    """What :func:`.metalayer_kernel.metalayer_launch` saves with
    ``save=True``, in plain PyTorch (the same products through
    :func:`.gemm.gemm_gather_plain`, the same roundings): the CPU twin
    that :func:`metalayer_backward` runs on there."""
    b, n, c = x.shape
    e = src.shape[1]
    dtype = x.dtype
    xt = x.reshape(b * n, c)
    et = e_attr.to(dtype).reshape(b * e, c)
    src32, dst32 = src.to(torch.int32), dst.to(torch.int32)
    gsrc, gdst = graph_index(src32, dst32, edge_mask.bool(), n)
    em = edge_mask.float()
    pre = lambda rows: torch.empty((rows, c))
    h1, m1p, o1p = pre(b * e), pre(b * e), pre(b * n)
    h = gemm_gather_plain([(xt, gsrc), (xt, gdst), (et, None)], p["ew1"],
                          p["eb1"], "gelu", dtype, pre=h1)
    e_out = gemm_gather_plain([(h, None)], p["ew2"], p["eb2"],
                              out_dtype=dtype)
    m1 = gemm_gather_plain([(xt, gsrc), (e_out, None)], p["n1w1"],
                           p["n1b1"], "gelu", dtype, pre=m1p)
    m = gemm_gather_plain([(m1, None)], p["n1w2"], p["n1b2"],
                          row_scale=em.reshape(-1))
    d, ok = _valid_rows(dst32, em, n)
    tot = torch.zeros(b, n, c).scatter_add_(
        1, d[..., None].expand(-1, -1, c), m.reshape(b, e, c) * ok[..., None])
    deg = torch.zeros(b, n).scatter_add_(1, d, ok.float()).clamp(min=1.0)
    agg = (tot / deg[..., None]).to(dtype).reshape(b * n, c)
    o1 = gemm_gather_plain([(xt, None), (agg, None)], p["n2w1"], p["n2b1"],
                           "gelu", dtype, pre=o1p)
    o2 = gemm_gather_plain([(o1, None)], p["n2w2"], p["n2b2"])
    return dict(xt=xt, et=et, em=em, nm=node_mask.float(), gsrc=gsrc,
                gdst=gdst, src32=src32, dst32=dst32, h1=h1, h=h,
                e_out=e_out, m1p=m1p, m1=m1, agg=agg, o1p=o1p, o1=o1, o2=o2)


class _MetaLayerTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, e_attr, src, dst, edge_mask, node_mask, *params):
        p = ship_params(dict(zip(KEYS, params)), x.dtype)
        x_out, e_out, saved = metalayer_launch(
            x, e_attr, src, dst, edge_mask, node_mask, p, save=True)
        ctx.saved, ctx.p = saved, p
        ctx.shape = (x.shape[0], x.shape[1], src.shape[1])
        ctx.dtypes = (x.dtype, e_attr.dtype)
        ctx.param_dtypes = [t.dtype for t in params]
        ctx.set_materialize_grads(False)
        fused_metalayer_train.launches += 1
        return x_out, e_out

    @staticmethod
    def backward(ctx, dxo, deo):
        b, n, e = ctx.shape
        if dxo is None:
            dxo = torch.zeros((b, n, ctx.saved["xt"].shape[1]),
                              dtype=ctx.dtypes[0],
                              device=ctx.saved["xt"].device)
        dx, de, g = metalayer_backward(dxo, deo, ctx.saved, ctx.p,
                                       ctx.dtypes)
        fused_metalayer_train.bwd_launches += 1
        del ctx.saved, ctx.p
        return (dx.reshape(b, n, -1), de.reshape(b, e, -1), None, None, None,
                None, *(g[k].to(dt) for k, dt in zip(KEYS, ctx.param_dtypes)))


def fused_metalayer_train(x, e_attr, src, dst, edge_mask, node_mask, params):
    """The MetaLayer round + GraphNorm, differentiable: ``x [B, N, C]``,
    ``e_attr [B, E, C]`` at the model dtype, ``params`` keyed by
    :data:`.metalayer_kernel.KEYS` (f32 masters; weights shipped at the
    model dtype on every call) -> ``(x_out, e_out)``.  Gradients reach
    ``x``, ``e_attr`` and the 15 parameters."""
    if not x.is_cuda:
        return fused_metalayer_train_plain(x, e_attr, src, dst, edge_mask,
                                           node_mask, params)
    return _MetaLayerTrain.apply(x, e_attr, src, dst, edge_mask, node_mask,
                                 *(params[k] for k in KEYS))


fused_metalayer_train.launches = 0
fused_metalayer_train.bwd_launches = 0
