"""FLOP counts of the port: every formula in one place.

Two kinds of count live here, and the second is built from the first's
product terms, so no product has two formulas:

* **The model's products per batch** (:func:`forward_flops`,
  :func:`train_step_flops`), which the bench divides by time for
  TFLOP/s and MFU.  Each matrix product of the ISubGVQA forward counts
  once, ``2 * rows * in * out``, at the batch's padded shapes (every
  graph's ``N`` node and ``E`` edge rows, every question's ``L``
  tokens): the padding is work the batch asks for.  Gathers and scatters
  by index count nothing; attention is per question (``lq * lk`` scores
  of each question, never a packed block-diagonal matrix); a product
  that a kernel computes as bf16x3 or 3xTF32 counts once.  Elementwise
  work (activations, softmax, norms, the GAT logits' dot with ``att``)
  and the Adam update are not counted.  The number is a property of the
  model and the shapes, so it is the same whether the fused layers run
  as kernels or as their plain versions: it equals the matrix-product
  FLOPs that ``torch.utils.flop_counter.FlopCounterMode`` sees over the
  plain eval forward with the one-hot incidence products (the plain
  versions' gathers and scatters) counted as nothing
  (``tests/test_torch_port_bench.py``).  One training step counts three
  times the forward: each product's backward is two products of its
  size, the gradients of both operands (every operand of the model's
  products depends on a parameter).

  The JAX bench counts the Pallas kernels' implementation FLOPs instead
  (``isubgvqa_tpu/ops/pallas/gat_kernel.py:fused_gat_layer_flops``,
  ``metalayer_kernel_flops``, ``text_kernel.py``'s packed attention),
  which include the TPU's one-hot incidence matmuls, broadcasts and the
  head-expand matmul.  For one graph at (N, E) = (128, 384) that is
  1,060 MFLOP a GAT layer and 645 MFLOP a MetaLayer round, against
  :func:`gat_layer_products` 691.2 (lin_l, lin_r, lin_edge and x_proj)
  and :func:`metalayer_products` 553.0 here.

* **The work of one fused layer** over its valid nodes and edges
  (:func:`gat_layer_flops` ... :func:`decoder_layer_train_flops`),
  elementwise terms included, from which ``chip_smoke.py`` computes
  each kernel's least time (``bound_ms``).  These are the port's copies
  of the Pallas kernels' FLOP models without the TPU's one-hot, packing
  and recompute terms.

:data:`PEAK_FLOPS` holds the H100 SXM data sheet's dense peaks by
compute dtype; :func:`peak_flops` looks one up.
"""

from __future__ import annotations

from typing import Optional

import torch

PEAK_FLOPS = {
    "bfloat16": 989e12,     # H100 SXM dense bf16 on the tensor cores
    "float32": 67e12,       # H100 SXM float32 outside the tensor cores
}
PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes a second
FFN_DIM = 4 * 512           # the text layers' FFN width (models/isubgvqa.py)
NODE_CLASSES = 2577         # the node head's width (models/mgat.py)
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}


def peak_flops(dtype) -> float:
    """:data:`PEAK_FLOPS` for a compute dtype, given as a ``torch.dtype``
    or by its ``Config.compute_dtype`` name."""
    return PEAK_FLOPS[_DTYPE_NAMES.get(dtype, dtype)]


# ------------------------------------------------------------- products

def linear_products(rows: float, k: int, n: int) -> float:
    """``[rows, k] @ [k, n]``."""
    return 2.0 * rows * k * n


def gat_conv_products(nodes: float, edges: float, c: int = 300,
                      heads: int = 4, ci: Optional[int] = None) -> float:
    """lin_l and lin_r over the nodes (input width ``ci``: ``2c`` under
    ``concat_instr``, else ``c``), lin_edge over the edges."""
    hc = heads * c
    return (2 * linear_products(nodes, ci or c, hc)
            + linear_products(edges, c, hc))


def gat_layer_products(nodes: float, edges: float, c: int = 300,
                       heads: int = 4, ci: Optional[int] = None) -> float:
    """One GAT layer: the conv's products and x_proj's two."""
    hc = heads * c
    return (gat_conv_products(nodes, edges, c, heads, ci)
            + linear_products(nodes, hc, hc // 2)
            + linear_products(nodes, hc // 2, c))


def metalayer_products(nodes: float, edges: float, c: int = 300) -> float:
    """One MetaLayer round: the edge MLP (3c -> c -> c) and node MLP 1
    (2c -> c -> c) over the edges, node MLP 2 (2c -> c -> c) over the
    nodes."""
    return 2.0 * c * c * (7 * edges + 3 * nodes)


def attention_products(b: float, lq: int, lk: int, d: int = 512) -> float:
    """Each of ``b`` questions' ``lq x lk`` scores and P.V over all heads
    (``d`` = heads x head width)."""
    return 4.0 * b * lq * lk * d


def mha_products(rq: float, rk: float, lq: int, lk: int, b: float,
                 d: int) -> float:
    """One attention block: the q projection over ``rq`` query rows, k
    and v over ``rk`` key rows, the attention core, the out projection."""
    return (linear_products(rq, d, d) + linear_products(rk, d, 2 * d)
            + attention_products(b, lq, lk, d) + linear_products(rq, d, d))


def ffn_products(rows: float, d: int, f: int) -> float:
    return linear_products(rows, d, f) + linear_products(rows, f, d)


def encoder_products(b: float, l: int, d: int = 512,
                     f: int = FFN_DIM) -> float:
    r = b * l
    return mha_products(r, r, l, l, b, d) + ffn_products(r, d, f)


def decoder_products(b: float, t: int, l: int, d: int = 512,
                     f: int = FFN_DIM) -> float:
    rt, rm = b * t, b * l
    return (mha_products(rt, rt, t, t, b, d) + mha_products(rt, rm, t, l, b, d)
            + ffn_products(rt, d, f))


def forward_flops(cfg, b: int, n: int, e: int, l: int) -> float:
    """The matrix products of one eval forward of ``b`` questions at the
    padded shape ``(n, e, l)``: the question encoder, text sampling's key
    and query MLPs and scores (``text_sampling``), the decoder, the
    instruction and language MLPs, the bbox MLP and feature reduction,
    the MetaLayer, the GAT layers (``2c``-wide inputs under
    ``concat_instr``), the mask head of each masked layer, the node head
    after each layer (``node_classification``), the pooling and the fusion
    classifier."""
    c, d, t = cfg.general_hidden_dim, cfg.text_emb_dim, cfg.mgat_layers
    rn, re_ = float(b) * n, float(b) * e
    ci = 2 * c if cfg.concat_instr else c
    fl = cfg.encoder_layers * encoder_products(b, l, d)
    if cfg.text_sampling:
        # keys and queries; each position's key against the summed queries
        fl += 2 * linear_products(b * l, d, d) + 2.0 * b * l * d
    fl += cfg.decoder_layers * decoder_products(b, t, l, d)
    fl += linear_products(b * t, d, c)                   # instr_reduction
    fl += linear_products(b, t * d, c)                   # qsts_reduction
    fl += linear_products(rn, 4, 16) + linear_products(rn, 16, 32)  # bbox
    fl += linear_products(rn, c + 32, c)                 # feat_reduc
    fl += metalayer_products(rn, re_, c)
    fl += cfg.mgat_layers * gat_layer_products(rn, re_, c, cfg.gat_heads, ci)
    masked = sum(1 for m in cfg.mgat_masks if float(m) != 1.0)
    # mask head: node_nn, then ques_nn and each node's score against its
    # question, or (use_all_instrs) each instruction's scores
    fl += masked * linear_products(rn, ci, c)
    if cfg.use_all_instrs:
        fl += masked * 2.0 * rn * c * t
    else:
        fl += masked * (linear_products(b, c, c) + 2.0 * rn * c)
    if cfg.node_classification:
        fl += t * (linear_products(rn, c, 512)
                   + linear_products(rn, 512, NODE_CLASSES))
    # pooling: node_nn and ques_nn (two layers each), the gate scores
    fl += 2 * linear_products(rn, c, c) + 2 * linear_products(b, c, c)
    fl += 2.0 * rn * c
    fl += linear_products(b, 3 * c, 512) + linear_products(b, 512,
                                                           cfg.num_answers)
    return fl


def train_step_flops(cfg, b: int, n: int, e: int, l: int) -> float:
    """One training step's products: the forward's and, for each, the
    two operand gradients of its size."""
    return 3.0 * forward_flops(cfg, b, n, e, l)


def batch_shape(batch):
    """``(b, n, e, l)`` of a :class:`~isubgvqa_tpu_torch.data.GraphBatch`."""
    b, n = batch.node_tokens.shape[:2]
    return b, n, batch.edge_src.shape[1], batch.qst_tokens.shape[1]


# ------------------------------------------------------ fused layers' work

def gat_layer_flops(nodes: int, edges: int, c: int = 300, heads: int = 4,
                    fuse_instr: bool = False, ci: Optional[int] = None,
                    apply_mask_to_h: bool = False) -> float:
    """FLOPs of one eval GAT layer over ``nodes`` valid nodes and
    ``edges`` valid edges (summed over the batch's graphs): the port's
    copy of ``gat_kernel.fused_gat_layer_flops`` without the TPU's
    one-hot and packing terms (incidence compares; the x_l[src] /
    x_r[dst] / gate gathers, the per-destination max and sum broadcasts
    and the conv scatter as [E, N] matmuls; the block-diagonal att and
    head-expand matmuls; the packed-graph one-hot reduces).  Here a
    gather is an index read, the scatter one add per element, and the
    logits ``2 * E * H * C``.  ``ci`` is the input's width (``2c`` under
    ``concat_instr``); ``apply_mask_to_h`` adds the gate's multiply."""
    n, e = float(nodes), float(edges)
    hc = heads * c
    pd = hc // 2
    fl = gat_layer_products(n, e, c, heads, ci)
    fl += n * c if apply_mask_to_h else 0.0
    fl += 12.0 * n * c if fuse_instr else 0.0      # gelu(h * instr)
    fl += 2 * n * hc                               # x_l, x_r biases
    fl += 2.0 * e * hc + e                         # m = xs + xd + eproj, gate
    fl += 4.0 * e * hc                             # gate x2, leaky relu x2
    fl += 2.0 * e * hc                             # logits
    fl += 8.0 * e * heads                          # softmax + alpha * gate
    fl += 2.0 * e * hc + n * hc                    # weighted sum + bias
    fl += 12.0 * n * pd + 12.0 * n * c             # x_proj gelus
    fl += 2.0 * n * c + 4.0 * n                    # sdp logits + softmax
    fl += 10.0 * n * c                             # GraphNorm + residual
    return fl


def gatconv_train_flops(nodes: int, edges: int, c: int = 300,
                        heads: int = 4, ci: Optional[int] = None) -> float:
    """FLOPs of the conv's forward and backward over ``nodes`` valid nodes
    and ``edges`` valid edges (summed over the batch): the port's model of
    ``gat_train.fused_gatconv_{fwd,bwd}_flops`` without the backward's
    recompute and the one-hot / block-diagonal terms (gathers and
    scatters are index reads and adds; the logits ``2 E H C``); ``ci``
    the input's width (``2c`` under ``concat_instr``)."""
    n, e = float(nodes), float(edges)
    hc = heads * c
    fl = 3 * gat_conv_products(n, e, c, heads, ci)  # forward, dgrads, wgrads
    fl += 2 * n * hc                         # x_l, x_r biases
    fl += 2.0 * e * hc + e                   # message, edge gate
    fl += 4.0 * e * hc + 2.0 * e * hc        # gates, leaky relu, logits
    fl += 8.0 * e * heads                    # softmax, alpha * gate
    fl += 2.0 * e * hc + n * hc              # weighted sum + bias
    # backward
    fl += n * hc                             # d cbias
    fl += 2.0 * e * hc                       # d w per edge and head
    fl += 6.0 * e * hc                       # S1, S2
    fl += 6.0 * e * heads                    # softmax backward, d egate
    fl += 6.0 * e * hc                       # d m0
    fl += 3.0 * e * hc                       # d x_l, d x_r scatters
    fl += 3.0 * e * hc                       # d att
    fl += 2 * n * hc                         # d bl, d br
    fl += e                                  # d gate (dst only)
    return fl


def metalayer_flops(nodes: int, edges: int, c: int = 300) -> float:
    """FLOPs of one MetaLayer round over ``nodes`` valid nodes and
    ``edges`` valid edges (summed over the batch's graphs): the port's
    copy of ``gat_kernel.metalayer_kernel_flops`` without the TPU's
    one-hot terms (incidence compares, the x_src/x_dst gathers and the
    aggregation as [E, N] matmuls, the degree matmul); the gather is an
    index read and the aggregation one add per message element."""
    n, e = float(nodes), float(edges)
    fl = metalayer_products(n, e, c)
    fl += 12.0 * e * c + 12.0 * e * c              # edge MLP, mlp1 gelus
    fl += e * c                                    # mlp1 out mask
    fl += e * c + n * c                            # scatter-add + divide
    fl += 12.0 * n * c                             # mlp2 gelu
    fl += 10.0 * n * c                             # GraphNorm
    return fl


def metalayer_train_flops(nodes: int, edges: int, c: int = 300) -> float:
    """FLOPs of one round's forward and backward over ``nodes`` valid
    nodes and ``edges`` valid edges (summed over the batch): the forward
    of :func:`metalayer_flops` plus the backward chain of
    ``metalayer_train.metalayer_bwd_flops`` without its recompute and
    one-hot terms (gathers and scatters are index reads and adds)."""
    n, e = float(nodes), float(edges)
    fl = metalayer_flops(nodes, edges, c)
    fl += 2 * metalayer_products(n, e, c)     # dgrads and wgrads
    fl += 17 * n * c                          # GraphNorm backward
    fl += n * c + 13 * n * c + n * c          # d n2b2, gelu', d n2b1
    fl += e * c                               # scatter-mean backward
    fl += e * c + 13 * e * c + 2 * e * c      # d n1b2, gelu', d n1b1
    fl += e * c + 13 * e * c + e * c          # d eb2, gelu', d eb1
    fl += 2 * e * c                           # row scatters
    return fl


def encoder_layer_flops(b: int, l: int, d: int = 512, f: int = FFN_DIM,
                        heads: int = 8, final_ln: bool = False) -> float:
    """FLOPs of one encoder layer for ``b`` questions of ``l`` tokens:
    the port's copy of ``text_kernel.fused_encoder_layer_flops`` with
    the TPU's packing terms dropped (block-diagonal mask construction and
    the cross-question scores of the packed [R, R] attention: each
    question attends over its own ``l`` keys only)."""
    r = b * l
    fl = encoder_products(b, l, d, f)
    fl += 3 * r * d + 2.0 * r * l                    # QKV bias, scale + bias
    fl += 4.0 * r * l * heads                        # softmax
    fl += r * d                                      # out projection bias
    fl += r * d + 6.0 * r * d                        # residual + LN1
    fl += 2.0 * r * f + r * d                        # FFN biases + relu
    fl += r * d + 6.0 * r * d                        # residual + LN2
    if final_ln:
        fl += 6.0 * r * d
    return fl


def decoder_layer_flops(b: int, t: int, l: int, d: int = 512,
                        f: int = FFN_DIM, heads: int = 8,
                        final_ln: bool = False) -> float:
    """FLOPs of one decoder layer (the port's copy of
    ``fused_decoder_layer_flops`` without the packing terms)."""
    rt, rm = b * t, b * l
    fl = decoder_products(b, t, l, d, f)
    fl += 3 * rt * d + 7.0 * rt * t * heads          # self bias, softmax
    fl += rt * d + 7.0 * rt * d                      # out bias, res + LN1
    fl += rt * d + 2 * rm * d                        # cross q, k, v biases
    fl += 7.0 * rt * l * heads                       # cross softmax
    fl += rt * d + 7.0 * rt * d                      # out bias, res + LN2
    fl += 2.0 * rt * f                               # FFN in bias + relu
    fl += rt * d + 7.0 * rt * d                      # FFN out, res + LN3
    if final_ln:
        fl += 6.0 * rt * d
    return fl


def _mha_train_flops(rq, rk, lq, lk, b, d, heads, masked):
    """Forward and backward of one attention block (projections, scores,
    softmax and P.V) without the TPU's packing terms."""
    fl = 3 * mha_products(rq, rk, lq, lk, b, d)       # forward, dgrads, wgrads
    fl += (rq + 2.0 * rk) * d + 7.0 * b * heads * lq * lk + rq * d
    fl += rq * d + 6.0 * b * heads * lq * lk          # out bias, softmax bwd
    fl += (rq + 2.0 * rk) * d                         # bias gradients
    if masked:
        fl += 3.0 * b * heads * lq * lk
    return fl


def _ffn_ln_train_flops(r, d, f, masked):
    fl = 3 * ffn_products(r, d, f) + 4.0 * r * f + 2.0 * r * d  # fwd + bwd
    fl += 2 * (8.0 * r * d) + 2 * (10.0 * r * d)                # 2 LN fwd+bwd
    if masked:
        fl += 2 * (2.0 * r * d + 2.0 * r * f)
    return fl


def encoder_layer_train_flops(b: int, l: int, d: int = 512,
                              f: int = FFN_DIM, heads: int = 8,
                              masked: bool = True) -> float:
    """FLOPs of one encoder layer's forward and backward for ``b``
    questions of ``l`` tokens (the port's model of
    ``text_train.encoder_layer_train_{fwd,bwd}_flops`` without the
    backward's recompute, which the port does not do, and without the
    packing terms)."""
    r = b * l
    return (_mha_train_flops(r, r, l, l, b, d, heads, masked)
            + _ffn_ln_train_flops(r, d, f, masked))


def decoder_layer_train_flops(b: int, t: int, l: int, d: int = 512,
                              f: int = FFN_DIM, heads: int = 8,
                              masked: bool = True) -> float:
    rt, rm = b * t, b * l
    fl = _mha_train_flops(rt, rt, t, t, b, d, heads, masked)
    fl += _mha_train_flops(rt, rm, t, l, b, d, heads, masked)
    fl += 2 * (8.0 * rt * d) + 2 * (10.0 * rt * d)   # the third LN
    return fl + _ffn_ln_train_flops(rt, d, f, masked)
