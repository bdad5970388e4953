"""Training GATv2 conv (the edge half of an MGAT layer), forward and
backward on the card, and the training MGAT layer around it.

Replaces ``isubgvqa_tpu/ops/pallas/gat_train.py:fused_gatconv`` (the
custom VJP over ``_gatconv_pallas_fwd`` / ``_fwd_kernel`` and
``_gatconv_pallas_bwd`` / ``_bwd_kernel``) and
``fused_gat_layer_train``.

:func:`fused_gatconv` is a :class:`torch.autograd.Function`:

* forward — the f32 GEMM (``csrc/gemm.cu``, 3xTF32) for ``x_l``,
  ``x_r`` (f32 weights, as the Pallas training kernel keeps them:
  ``gat_train.py:_prep``) and the graph-layer GEMM (:func:`.gemm.product`;
  bf16: ``csrc/gemm_gather_sm90.cu``) for the lin_edge projection (weight
  and edges at the model dtype, the result rounded to it), then ``csrc/gat_kernel.cu:isg_gat_edge_train``: edge
  gate, message, 4-head logits, per-destination softmax, ``alpha`` and
  ``conv = sum x_l[src] * alpha * egate + bias``, all f32.  ``x_l``,
  ``x_r`` and the projected edges are saved for the backward (the TPU
  recomputes them; see ``csrc/gat_train.cu``);
* backward — ``csrc/gat_train.cu:isg_gat_edge_bwd`` (one block per
  graph and head: the softmax, leaky-ReLU and gate backward, ``d x_l``,
  ``d x_r``, ``d eproj``, per-head shares of the dst-only ``d gate``,
  summed in head order, and per-graph ``d att``), then the shared GEMM's
  dgrad / wgrad forms (3xTF32 on the tensor cores) for ``d xf``,
  ``d e_attr`` and the lin_l / lin_r / lin_edge weights, and column sums
  for the biases.

The node-gate -> edge-gate step keeps the reference's backward quirk
(``sampling/node_edge_masks.py:13-19``): the edge gate's cotangent is
summed to destination nodes only.  The plain version routes the gate
through :func:`~isubgvqa_tpu_torch.sampling.node_edge.
dense_node_gate_to_edge_gate` for the same reason.

Bound on the H100: the x_l / x_r / lin_edge products and their backward
(about 3 x 2 x C x H*C FLOPs per node and per edge) make the conv
operation-bound.  x_l / x_r and every backward product are f32 by
design; they run in the 3xTF32 form on the TF32 tensor cores
(``csrc/gemm.cu``, ``csrc/gemm_any.cu``), whose ceiling for f32-accurate
products is a third of the 495 TFLOP/s TF32 peak.

:func:`fused_gat_layer_train` composes the conv with the node-space head
(:func:`gat_head_plain`, the port of ``gat_kernel.gat_head_reference``),
plain differentiable PyTorch in f32 as the JAX package runs it in XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _lib
from .gemm import (colsum, dgrad, gemm, plain_product, product, reduce_rows,
                   ste, wgrad)
from .metalayer_kernel import GN_EPS, NEG, gather_rows
from ..sampling.node_edge import dense_node_gate_to_edge_gate

CONV_KEYS = ("wl", "bl", "wr", "br", "att", "cbias", "we")
NEGATIVE_SLOPE = 0.2


def fused_gatconv_plain(xf, gate, src, dst, edge_mask, e_attr, params):
    """``(conv [B, N, H*C] f32, alpha [B, E, H] f32)``; ``xf``, ``gate``
    and ``e_attr`` are used at ``xf.dtype`` (the model dtype), ``wl`` /
    ``wr`` / ``att`` / biases in f32, ``we`` at the model dtype with the
    projected edges rounded to it (``gat_train.py:_prep`` / ``:95-96``).
    An f64 ``xf`` evaluates the same formula in f64 with no rounding at
    all: the exact reference that ``chip_smoke.py`` holds the kernel and
    the f32 path against."""
    p = params
    dtype = xf.dtype
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    rnd = (lambda t: t.to(acc)) if acc == torch.float64 else (
        lambda t: ste(t, dtype))
    b, n, _ = xf.shape
    e = src.shape[1]
    heads, c = p["att"].shape[-2:]
    att = p["att"].to(acc).reshape(-1)
    x = rnd(xf)
    x_l = plain_product(x, p["wl"].to(acc).t()) + p["bl"].to(acc)
    x_r = plain_product(x, p["wr"].to(acc).t()) + p["br"].to(acc)
    eproj = rnd(plain_product(rnd(e_attr), rnd(p["we"]).t()))
    em = edge_mask.to(acc)[..., None]
    egate = dense_node_gate_to_edge_gate(rnd(gate).reshape(b, n),
                                         src, dst, edge_mask)[..., None]
    xs = gather_rows(x_l, src, edge_mask)
    m0 = xs + gather_rows(x_r, dst, edge_mask) + eproj
    m1 = m0 * egate
    m3 = torch.where(m1 >= 0, m1, m1 * NEGATIVE_SLOPE) * egate
    logits = (m3.reshape(b, e, heads, c) * att.reshape(heads, c)).sum(-1)
    logits = torch.where(em > 0, logits, torch.full_like(logits, NEG))
    oh_dst = F.one_hot(dst.long(), n).to(acc) * em              # [B, E, N]
    inc = (oh_dst > 0)[..., None]
    # the per-destination max only shifts the softmax: no gradient
    max_n = torch.where(inc, logits.detach()[:, :, None, :],
                        torch.full_like(logits[:, :, None, :], NEG)).amax(1)
    expv = torch.exp(logits - torch.clamp(oh_dst @ max_n, min=NEG)) * em
    denom = oh_dst @ (oh_dst.transpose(1, 2) @ expv)
    alpha = expv / torch.where(denom > 1e-12, denom, torch.ones_like(denom))
    w = (alpha * egate).repeat_interleave(c, dim=-1)            # [B, E, HC]
    conv = oh_dst.transpose(1, 2) @ (xs * w) + p["cbias"].to(acc)
    return conv, alpha


class _GatConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xf, gate, src, dst, edge_mask, e_attr, *params):
        p = dict(zip(CONV_KEYS, params))
        dtype = xf.dtype
        b, n, ci = xf.shape
        e = src.shape[1]
        heads, c = p["att"].shape[-2:]
        hc = heads * c
        att = p["att"].detach().float().reshape(-1).contiguous()
        if n > 256 or e > 1024:
            raise ValueError(f"fused_gatconv takes N <= 256 and E <= 1024 "
                             f"(got N={n}, E={e})")
        if b * e * hc > _lib.MAX_ELEMENTS:    # the projected edges
            raise ValueError(f"fused_gatconv takes B*E*H*C < 2^31 (got "
                             f"B={b}, E={e}, H*C={hc})")
        wl = p["wl"].detach().float().contiguous()
        wr = p["wr"].detach().float().contiguous()
        wlr = torch.cat([wl, wr])             # d x_l, d x_r share one dgrad
        we = p["we"].detach().to(dtype).contiguous()
        # xf at its own dtype: a bf16 operand is exact in TF32, so the f32
        # products (x_l / x_r, their weight gradients) take two tensor-core
        # products, not three, with the same result
        xw = xf.reshape(b * n, ci).contiguous()
        et = e_attr.to(dtype).reshape(b * e, -1).contiguous()
        x_l = gemm([(xw, None)], wl, p["bl"].detach().float().contiguous())
        x_r = gemm([(xw, None)], wr, p["br"].detach().float().contiguous())
        eproj = product([(et, None)], we, None, out_dtype=dtype)
        g = gate.reshape(b, n).to(dtype).float().contiguous()
        em = edge_mask.to(torch.float32).contiguous()
        src32 = src.to(torch.int32).contiguous()
        dst32 = dst.to(torch.int32).contiguous()
        cbias = p["cbias"].detach().float().contiguous()
        _lib.check_cuda(g, em, src32, dst32, att, cbias)
        alpha = torch.empty((b, e, heads), dtype=torch.float32,
                            device=xf.device)
        conv = torch.empty((b * n, hc), dtype=torch.float32, device=xf.device)
        _lib.call("isg_gat_edge_train", x_l.data_ptr(), x_r.data_ptr(),
                  eproj.data_ptr(), _lib.dt(eproj), g.data_ptr(),
                  src32.data_ptr(), dst32.data_ptr(), em.data_ptr(),
                  att.data_ptr(), cbias.data_ptr(), alpha.data_ptr(),
                  conv.data_ptr(), b, n, e, heads, c)
        ctx.saved = dict(xw=xw, et=et, x_l=x_l, x_r=x_r, eproj=eproj, g=g,
                         em=em, src32=src32, dst32=dst32, att=att, alpha=alpha,
                         wlr=wlr, we=we)
        ctx.shape = (b, n, e, heads, c, ci)
        ctx.dtypes = (xf.dtype, gate.dtype, e_attr.dtype)
        ctx.param_dtypes = [t.dtype for t in params]
        ctx.att_shape = p["att"].shape
        ctx.set_materialize_grads(False)      # alpha's is usually unused
        fused_gatconv.launches += 1
        return conv.reshape(b, n, hc), alpha

    @staticmethod
    def backward(ctx, dconv, dalpha):
        s = ctx.saved
        b, n, e, heads, c, ci = ctx.shape
        hc = heads * c
        dev = s["xw"].device
        f32 = dict(dtype=torch.float32, device=dev)
        dconv = (torch.zeros((b * n, hc), **f32) if dconv is None
                 else dconv.reshape(b * n, hc).float().contiguous())
        dalpha = (None if dalpha is None
                  else dalpha.float().contiguous())
        dx = torch.empty((b * n, 2 * hc), **f32)      # [d x_l | d x_r]
        dep = torch.empty((b * e, hc), **f32)
        dgate = torch.empty((heads, b, n), **f32)     # per-head shares
        datt = torch.empty((b, hc), **f32)
        _lib.check_cuda(dalpha)
        _lib.call("isg_gat_edge_bwd", s["x_l"].data_ptr(), s["x_r"].data_ptr(),
                  s["eproj"].data_ptr(), _lib.dt(s["eproj"]), s["g"].data_ptr(),
                  s["src32"].data_ptr(), s["dst32"].data_ptr(),
                  s["em"].data_ptr(), s["att"].data_ptr(),
                  s["alpha"].data_ptr(), dconv.data_ptr(), _lib.ptr(dalpha),
                  dx.data_ptr(), dx.data_ptr() + hc * dx.element_size(),
                  dep.data_ptr(), dgate.data_ptr(), datt.data_ptr(), 2 * hc,
                  b, n, e, heads, c)
        dgate = reduce_rows(dgate)                     # in head order
        dwlr, dblr = wgrad(dx, s["xw"]), colsum(dx)
        g = {"cbias": colsum(dconv), "att": reduce_rows(datt),
             "wl": dwlr[:hc], "bl": dblr[:hc], "wr": dwlr[hc:],
             "br": dblr[hc:], "we": wgrad(dep, s["et"])}
        dxf = dgrad(dx, s["wlr"])
        de = dgrad(dep, s["we"])
        g["att"] = g["att"].reshape(ctx.att_shape)
        fused_gatconv.bwd_launches += 1
        del ctx.saved
        return (dxf.reshape(b, n, ci).to(ctx.dtypes[0]),
                dgate.reshape(b, n, 1).to(ctx.dtypes[1]), None, None, None,
                de.reshape(b, e, -1).to(ctx.dtypes[2]),
                *(g[k].to(dt) for k, dt in zip(CONV_KEYS, ctx.param_dtypes)))


def fused_gatconv(xf, gate, src, dst, edge_mask, e_attr, params):
    """The GATv2 conv for training: ``xf [B, N, C_in]`` (instruction-fused
    node features, ``C_in = 2C`` under ``concat_instr``), ``gate
    [B, N, 1]``, ``src/dst/edge_mask [B, E]``, ``e_attr [B, E, C]`` at the
    model dtype; ``params`` keyed by :data:`CONV_KEYS` (``wl/wr
    [H*C, C_in]``, ``we [H*C, C]``, ``att [H, C]``, f32 masters)
    -> ``(conv [B, N, H*C] f32, alpha [B, E, H] f32)``.  Gradients reach
    ``xf``, ``gate`` (destination nodes only), ``e_attr`` and every
    parameter."""
    if not xf.is_cuda:
        return fused_gatconv_plain(xf, gate, src, dst, edge_mask, e_attr,
                                   params)
    return _GatConv.apply(xf, gate, src, dst, edge_mask, e_attr,
                          *(params[k] for k in CONV_KEYS))


fused_gatconv.launches = 0
fused_gatconv.bwd_launches = 0


def gat_head_plain(h, conv, instr, node_mask, params, gate=None):
    """Node-space half of the layer in f32 (the port of
    ``gat_kernel.gat_head_reference``): x_proj MLP with GELUs, the
    instruction SDP softmax over valid nodes, GraphNorm, the residual
    and, where ``gate [B, N, 1]`` is given (``apply_mask_to_h``), its
    multiply.  Plain differentiable PyTorch; returns ``[B, N, C]`` at
    ``h.dtype``."""
    p = params
    q = F.gelu(conv.float() @ p["w1"].float().t() + p["b1"].float())
    q = F.gelu(q @ p["w2"].float().t() + p["b2"].float())
    lg = (q * instr.float()[:, None, :]).sum(-1) / math.sqrt(q.shape[-1])
    lg = torch.where(node_mask, lg, torch.full_like(lg, NEG))
    lg = lg - lg.amax(1, keepdim=True)
    ex = torch.exp(lg) * node_mask.float()
    den = ex.sum(1, keepdim=True)
    q = q * (ex / torch.where(den > 1e-12, den, torch.ones_like(den)))[..., None]
    nm = node_mask.float()[..., None]
    count = torch.clamp(nm.sum(1, keepdim=True), min=1.0)
    mean = (q * nm).sum(1, keepdim=True) / count
    shifted = q - p["gn_a"].float() * mean
    var = (shifted * shifted * nm).sum(1, keepdim=True) / count
    normed = shifted * torch.rsqrt(var + GN_EPS) * nm
    out = normed * p["gn_w"].float() + p["gn_b"].float() + h.float()
    if gate is not None:
        out = out * gate.float()
    return out.to(h.dtype)


def fused_gat_layer_train(h, xf, instr, gate, src, dst, edge_mask,
                          node_mask, e_attr, params,
                          apply_mask_to_h: bool = False):
    """One MGAT layer for training: :func:`fused_gatconv` + the plain
    head.  ``params`` as ``MGAT.layer_params`` (f32 masters); ``xf`` is
    ``[B, N, 2C]`` on a ``concat_instr`` layer.  With ``apply_mask_to_h``
    the gate also multiplies the output, so its cotangent is the edge
    gate's (destination nodes only) plus that multiply's, as in
    ``jax.grad`` of ``gat_layer_reference``.  Returns
    ``(out [B, N, C], alpha [B, E, H])``."""
    conv, alpha = fused_gatconv(xf, gate, src, dst, edge_mask, e_attr,
                                {k: params[k] for k in CONV_KEYS})
    return gat_head_plain(h, conv, instr, node_mask, params,
                          gate if apply_mask_to_h else None), alpha


def fused_gat_layer_train_plain(h, xf, instr, gate, src, dst, edge_mask,
                                node_mask, e_attr, params,
                                apply_mask_to_h: bool = False):
    """:func:`fused_gat_layer_train` with the conv's plain version."""
    conv, alpha = fused_gatconv_plain(xf, gate, src, dst, edge_mask, e_attr,
                                      {k: params[k] for k in CONV_KEYS})
    return gat_head_plain(h, conv, instr, node_mask, params,
                          gate if apply_mask_to_h else None), alpha
