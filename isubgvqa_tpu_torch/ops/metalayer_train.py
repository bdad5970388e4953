"""Training MetaLayer round + GraphNorm: forward and backward on the card.

Replaces ``isubgvqa_tpu/ops/pallas/metalayer_train.py:
fused_metalayer_train`` (the custom VJP whose forward is
``fused_metalayer`` and whose backward is ``_metalayer_bwd_call`` /
``_bwd_kernel``).

A :class:`torch.autograd.Function`:

* forward — the eval round's launches (:func:`.metalayer_kernel.
  metalayer_launch`), which also write the three GELU pre-activations
  (f32, from the shared GEMM's epilogue) and keep the products'
  operands.  The TPU recomputes the round in VMEM from its inputs
  instead; here the largest saved tensors at B = 256 graphs, E = 384
  edges are the f32 edge pre-activations (about 0.12 GB each), small
  beside the card's 80 GB;
* backward — ``isg_graph_norm_bwd`` (one block per graph), the shared
  GEMM's dgrad / wgrad forms (the gathered ``x[src]`` / ``x[dst]`` rows
  read through the same row index as the forward, so the ``[E, 3C]``
  concat never exists in either direction), ``isg_gelu_bwd``,
  ``isg_scatter_mean_bwd`` (a gather) and ``isg_scatter_rows``, which
  sends the gradients of the gathered rows back to their nodes
  deterministically.  Parameter gradients are reduced in f32 and
  returned at the parameters' dtype.

Bound on the H100: the MLP products (about 3 x 14 C^2 FLOPs per edge for
forward and backward) make the round operation-bound; the backward
products run on f32 FMA tiles today.

The plain version is :func:`.metalayer_kernel.fused_metalayer_plain`
(f32 masters, roundings through :func:`.gemm.ste`) differentiated by
autograd.  On a CPU tensor the wrapper runs it; on a CUDA tensor it
launches the kernels or raises.
"""

from __future__ import annotations

import torch

from . import _lib
from .gemm import colsum, dgrad, reduce_rows, wgrad
from .metalayer_kernel import (GN_EPS, KEYS, fused_metalayer_plain,
                               metalayer_launch)
from .text_train import ship_params


# the eval round's plain version, differentiated by autograd
fused_metalayer_train_plain = fused_metalayer_plain


def graph_norm_bwd(dout, p, nm, w, a):
    """``(dp, d w, d b, d a)`` of GraphNorm over ``p [B*N, C]`` f32."""
    b, n = nm.shape
    c = p.shape[1]
    dout = dout.reshape(b * n, c).contiguous()
    dp = torch.empty_like(p)
    part = torch.empty((3, b, c), dtype=torch.float32, device=p.device)
    _lib.check_cuda(dout, p, nm, w, a)
    _lib.call("isg_graph_norm_bwd", dout.data_ptr(), _lib.dt(dout),
              p.data_ptr(), nm.data_ptr(), w.data_ptr(), a.data_ptr(),
              dp.data_ptr(), part.data_ptr(), b, n, c, GN_EPS)
    return dp, reduce_rows(part[0]), reduce_rows(part[1]), reduce_rows(part[2])


def gelu_bwd(dy, pre):
    """``dy * gelu'(pre)`` (exact GELU)."""
    dx = torch.empty_like(dy)
    _lib.check_cuda(dy, pre)
    _lib.call("isg_gelu_bwd", dy.data_ptr(), pre.data_ptr(), dx.data_ptr(),
              dy.numel())
    return dx


def metalayer_backward(dxo, deo, s, p, b, n, e):
    """Gradients of the round from the output gradients ``dxo [B, N, C]``
    and ``deo [B, E, C]`` (or None), the forward's ``saved`` ``s`` and
    the shipped params ``p``; returns ``(dx, de, grads)`` (f32 rows)."""
    c = s["xt"].shape[1]
    g = {}
    f32 = dict(dtype=torch.float32, device=s["xt"].device)
    d_o2, g["gn_w"], g["gn_b"], g["gn_a"] = graph_norm_bwd(
        dxo, s["o2"], s["nm"], p["gn_w"], p["gn_a"])
    g["n2w2"] = wgrad(d_o2, s["o1"])
    g["n2b2"] = colsum(d_o2)
    d_o1 = gelu_bwd(dgrad(d_o2, p["n2w2"]), s["o1p"])
    g["n2w1"] = torch.empty((c, 2 * c), **f32)
    wgrad(d_o1, s["xt"], out=g["n2w1"][:, :c])
    wgrad(d_o1, s["agg"], out=g["n2w1"][:, c:])
    g["n2b1"] = colsum(d_o1)
    dx = dgrad(d_o1, p["n2w1"][:, :c])
    d_agg = dgrad(d_o1, p["n2w1"][:, c:])

    d_m = torch.empty((b * e, c), **f32)
    _lib.call("isg_scatter_mean_bwd", d_agg.data_ptr(), s["dst32"].data_ptr(),
              s["em"].data_ptr(), d_m.data_ptr(), b, n, e, c)
    g["n1w2"] = wgrad(d_m, s["m1"])
    g["n1b2"] = colsum(d_m)
    d_m1 = gelu_bwd(dgrad(d_m, p["n1w2"]), s["m1p"])
    g["n1w1"] = torch.empty((c, 2 * c), **f32)
    wgrad(d_m1, s["xt"], idx=s["gsrc"], out=g["n1w1"][:, :c])
    wgrad(d_m1, s["e_out"], out=g["n1w1"][:, c:])
    g["n1b1"] = colsum(d_m1)
    d_xs = dgrad(d_m1, p["n1w1"][:, :c])
    # a fresh buffer: the accumulation below must not write into the
    # caller's gradient
    d_eout = (torch.zeros((b * e, c), **f32) if deo is None
              else deo.reshape(b * e, c).to(torch.float32, copy=True))
    dgrad(d_m1, p["n1w1"][:, c:], out=d_eout, accumulate=True)

    g["ew2"] = wgrad(d_eout, s["h"])
    g["eb2"] = colsum(d_eout)
    d_h1 = gelu_bwd(dgrad(d_eout, p["ew2"]), s["h1"])
    g["ew1"] = torch.empty((c, 3 * c), **f32)
    wgrad(d_h1, s["xt"], idx=s["gsrc"], out=g["ew1"][:, :c])
    wgrad(d_h1, s["xt"], idx=s["gdst"], out=g["ew1"][:, c:2 * c])
    wgrad(d_h1, s["et"], out=g["ew1"][:, 2 * c:])
    g["eb1"] = colsum(d_h1)
    dgrad(d_h1, p["ew1"][:, :c], out=d_xs, accumulate=True)
    d_xd = dgrad(d_h1, p["ew1"][:, c:2 * c])
    de = dgrad(d_h1, p["ew1"][:, 2 * c:])
    _lib.call("isg_scatter_rows", d_xs.data_ptr(), d_xd.data_ptr(),
              s["src32"].data_ptr(), s["dst32"].data_ptr(),
              s["em"].data_ptr(), dx.data_ptr(), b, n, e, c)
    return dx, de, g


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
        dx, de, g = metalayer_backward(dxo, deo, ctx.saved, ctx.p, b, n, e)
        fused_metalayer_train.bwd_launches += 1
        del ctx.saved, ctx.p
        return (dx.reshape(b, n, -1).to(ctx.dtypes[0]),
                de.reshape(b, e, -1).to(ctx.dtypes[1]), None, None, None,
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


def metalayer_train_flops(nodes: int, edges: int, c: int = 300) -> float:
    """FLOPs of one round's forward and backward over ``nodes`` valid
    nodes and ``edges`` valid edges (summed over the batch): the forward
    of :func:`.metalayer_kernel.metalayer_flops` plus the backward chain
    of ``metalayer_train.metalayer_bwd_flops`` without its recompute and
    one-hot terms (gathers and scatters are index reads and adds)."""
    from .metalayer_kernel import metalayer_flops

    n, e = float(nodes), float(edges)
    fl = metalayer_flops(nodes, edges, c)
    fl += 17 * n * c                          # GraphNorm backward
    fl += 2 * (2 * n * c * c) + n * c         # d og, d n2w2 (+ d n2b2)
    fl += 13 * n * c                          # gelu'
    fl += 4 * (2 * n * c * c) + n * c         # dx, d agg, d n2w1 halves
    fl += e * c                               # scatter-mean backward
    fl += 2 * (2 * e * c * c) + e * c         # d mg, d n1w2 (+ d n1b2)
    fl += 13 * e * c                          # gelu'
    fl += 4 * (2 * e * c * c) + 2 * e * c     # d xs, d e_out, d n1w1 halves
    fl += 2 * (2 * e * c * c) + e * c         # d hg, d ew2 (+ d eb2)
    fl += 13 * e * c                          # gelu'
    fl += 6 * (2 * e * c * c) + e * c         # d xs+, d xd, de, d ew1
    fl += 2 * e * c                           # row scatters
    return fl
