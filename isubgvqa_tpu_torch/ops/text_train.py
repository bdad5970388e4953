"""Training layers of the question stack: the encoder and decoder layer
with live dropout, forward and backward on the card.

Replaces ``isubgvqa_tpu/ops/pallas/text_train.py:fused_encoder_layer_train``
(``_enc_call``: ``_make_enc_fwd`` / ``_make_enc_bwd``) and
``fused_decoder_layer_train`` (``_dec_call``).

Each is a :class:`torch.autograd.Function`:

* forward — the eval layer's launches (:func:`.text_kernel.encoder_launch`)
  with the dropout keep masks applied where the Pallas kernel applies
  them (the attention probabilities inside ``isg_attention``, the two
  residual branches inside ``isg_residual_ln``, the FFN activation in the
  shared GEMM's epilogue), keeping what the backward reads: q, k, v at
  the model dtype, the softmax probabilities, the pre-LN sums, the FFN
  activation.  The TPU recomputes those in VMEM instead; on the H100 the
  largest saved tensor of a layer at B = 256 questions, L = 32 is the
  FFN activation (16 MB in bf16), so saving is cheap;
* backward — hand-written launches only: ``isg_ln_bwd`` (one warp per
  row), the shared GEMM's dgrad and wgrad forms (split-K, the slices
  summed in order by each tile's last block), ``isg_colsum`` for the
  biases, ``isg_relu_bwd`` and ``isg_attention_bwd`` (one block per
  question and head).  Gradients are f32 throughout, as in the Pallas
  backward.

Bound on the H100: the products (about 3 x 2 x 12 D^2 FLOPs per token
for forward and backward) make the layer operation-bound; the backward's
products are f32 by design and run in the 3xTF32 form on the TF32
tensor cores (``csrc/gemm_any.cu``), so they, not bytes, set its time.

The plain version is the eval plain (:func:`.text_kernel.
fused_encoder_layer_plain`) with the masks, differentiated by autograd;
its roundings go through :func:`.gemm.ste`, so its gradients are f32
like the kernels'.  On a CPU tensor the wrapper runs it; on a CUDA
tensor it launches the kernels or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _lib
from .gemm import colsum, dgrad, reduce_rows, wgrad
from .text_kernel import (DEC_KEYS, ENC_KEYS, LN_EPS, decoder_launch,
                          encoder_launch, fused_decoder_layer_plain,
                          fused_encoder_layer_plain, masks_at)


def ship_params(params: dict, dtype: torch.dtype) -> dict:
    """Weights (2-D) at the model dtype, vectors f32, detached: what the
    kernels read (flax ``Dense(dtype=...)`` rounds weights on every
    call)."""
    return {k: (v.detach().to(dtype) if v.dim() == 2 else v.detach().float())
            .contiguous() for k, v in params.items()}


def fused_encoder_layer_train_plain(x, key_mask, masks, params,
                                    num_heads: int = 8):
    return fused_encoder_layer_plain(x, key_mask, params, num_heads,
                                     masks=masks)


def fused_decoder_layer_train_plain(tgt, memory, masks, params,
                                    num_heads: int = 8):
    return fused_decoder_layer_plain(tgt, memory, params, num_heads,
                                     masks=masks)


# ------------------------------------------------------------ backward

def ln_bwd(g, z, scale, ymask=None):
    """Backward of ``LN(z)`` with ``z = x + y * ymask``: returns
    ``(dz, dy, d scale, d bias)`` (``dy`` is ``dz`` without a mask)."""
    m, d = z.shape
    g = g.reshape(m, d).contiguous()
    dz = torch.empty((m, d), dtype=torch.float32, device=z.device)
    dy = torch.empty_like(dz) if ymask is not None else None
    blocks = max(1, min(264, -(-m // 8)))
    part = torch.empty((2, blocks, d), dtype=torch.float32, device=z.device)
    _lib.check_cuda(g, z, scale, ymask)
    _lib.call("isg_ln_bwd", g.data_ptr(), _lib.dt(g), z.data_ptr(),
              scale.data_ptr(), _lib.ptr(ymask), dz.data_ptr(),
              _lib.ptr(dy), part.data_ptr(), blocks, m, d, LN_EPS)
    return (dz, dy if dy is not None else dz, reduce_rows(part[0]),
            reduce_rows(part[1]))


def relu_bwd(dy, act, keep=None):
    """``dy * keep * (act > 0)`` (``act`` the saved ReLU output)."""
    dx = torch.empty_like(dy)
    _lib.check_cuda(dy, act, keep)
    _lib.call("isg_relu_bwd", dy.data_ptr(), act.data_ptr(), _lib.dt(act),
              _lib.ptr(keep), dx.data_ptr(), dy.numel())
    return dx


def attention_bwd(q, q_off, q_rs, kv, k_off, v_off, kv_rs, probs, keep,
                  dout, dq, dq_off, dq_rs, dkv, dk_off, dv_off, dkv_rs, b,
                  lq, lk, d, num_heads):
    """Gradients of one attention core, written into the f32 buffers
    ``dq`` / ``dkv`` at the given column offsets (the layouts of
    :func:`.text_kernel._attention`)."""
    es, fs = q.element_size(), 4
    dh = d // num_heads
    _lib.check_cuda(probs, keep, dout, dq, dkv)
    _lib.call("isg_attention_bwd", q.data_ptr() + q_off * es, q_rs,
              kv.data_ptr() + k_off * es, kv_rs, kv.data_ptr() + v_off * es,
              kv_rs, probs.data_ptr(), _lib.ptr(keep), dout.data_ptr(), d,
              dq.data_ptr() + dq_off * fs, dq_rs,
              dkv.data_ptr() + dk_off * fs, dkv_rs,
              dkv.data_ptr() + dv_off * fs, dkv_rs, b, lq, lk, num_heads, dh,
              1.0 / math.sqrt(dh), _lib.dt(q))


def _ffn_bwd(g, z_out, scale_key, s, p, hid, x_in, mf, m_out, grads):
    """The FFN block's backward from the gradient of its LN output.
    Returns the f32 gradient of the block input (the residual and the
    FFN's input)."""
    n = scale_key[1]
    dz, dy, grads[f"n{n}s"], grads[f"n{n}b"] = ln_bwd(g, z_out, p[scale_key],
                                                      m_out)
    grads["w2"] = wgrad(dy, hid)
    grads["b2"] = colsum(dy)
    df1 = relu_bwd(dgrad(dy, p["w2"]), hid, mf)
    grads["w1"] = wgrad(df1, x_in)
    grads["b1"] = colsum(df1)
    return dgrad(df1, p["w1"], out=dz, accumulate=True)


def encoder_backward(g, s, p, num_heads):
    """Gradients of one encoder layer from ``g`` (the output's), the
    forward's ``saved`` ``s`` and the shipped params ``p``; returns
    ``(dx f32 [B*L, D], grads)``."""
    grads = {}
    r, d = s["xt"].shape
    b, l = s["kb"].shape
    dh1 = _ffn_bwd(g, s["z2"], "n2s", s, p, s["hid"], s["x1t"], s["mf"],
                   s["m2"], grads)
    dz1, dattn, grads["n1s"], grads["n1b"] = ln_bwd(dh1, s["z1"], p["n1s"],
                                                    s["m1"])
    grads["out_w"] = wgrad(dattn, s["o"])
    grads["out_b"] = colsum(dattn)
    do = dgrad(dattn, p["out_w"])
    dqkv = torch.empty((r, 3 * d), dtype=torch.float32, device=dz1.device)
    attention_bwd(s["qkv"], 0, 3 * d, s["qkv"], d, 2 * d, 3 * d, s["probs"],
                  s["keep"], do, dqkv, 0, 3 * d, dqkv, d, 2 * d, 3 * d, b, l,
                  l, d, num_heads)
    grads["in_w"] = wgrad(dqkv, s["xt"])
    grads["in_b"] = colsum(dqkv)
    return dgrad(dqkv, p["in_w"], out=dz1, accumulate=True), grads


def decoder_backward(g, s, p, num_heads):
    """Gradients of one decoder layer; returns ``(d tgt, d memory,
    grads)``, f32 ``[B*T, D]`` and ``[B*L, D]``."""
    grads = {}
    rt, d = s["tt"].shape
    rm = s["mt"].shape[0]
    b, _, t, l = s["pc"].shape
    dt2 = _ffn_bwd(g, s["z3"], "n3s", s, p, s["hid"], s["t2t"], s["mf"],
                   s["m3"], grads)
    dz2, dca, grads["n2s"], grads["n2b"] = ln_bwd(dt2, s["z2"], p["n2s"],
                                                  s["m2"])
    grads["c_out_w"] = wgrad(dca, s["o_c"])
    grads["c_out_b"] = colsum(dca)
    do_c = dgrad(dca, p["c_out_w"])
    dq = torch.empty((rt, d), dtype=torch.float32, device=dz2.device)
    dkv = torch.empty((rm, 2 * d), dtype=torch.float32, device=dz2.device)
    attention_bwd(s["q"], 0, d, s["kv"], 0, d, 2 * d, s["pc"], s["kc"], do_c,
                  dq, 0, d, dkv, 0, d, 2 * d, b, t, l, d, num_heads)
    dwc = torch.empty((3 * d, d), dtype=torch.float32, device=dz2.device)
    wgrad(dq, s["t1t"], out=dwc[:d])
    wgrad(dkv, s["mt"], out=dwc[d:])
    grads["c_in_w"] = dwc
    grads["c_in_b"] = torch.cat([colsum(dq), colsum(dkv)])
    dmem = dgrad(dkv, p["c_in_w"][d:])
    dt1 = dgrad(dq, p["c_in_w"][:d], out=dz2, accumulate=True)
    dz1, dsa, grads["n1s"], grads["n1b"] = ln_bwd(dt1, s["z1"], p["n1s"],
                                                  s["m1"])
    grads["s_out_w"] = wgrad(dsa, s["o_s"])
    grads["s_out_b"] = colsum(dsa)
    do_s = dgrad(dsa, p["s_out_w"])
    dqkv = torch.empty((rt, 3 * d), dtype=torch.float32, device=dz2.device)
    attention_bwd(s["qkv"], 0, 3 * d, s["qkv"], d, 2 * d, 3 * d, s["ps"],
                  s["ks"], do_s, dqkv, 0, 3 * d, dqkv, d, 2 * d, 3 * d, b, t,
                  t, d, num_heads)
    grads["s_in_w"] = wgrad(dqkv, s["tt"])
    grads["s_in_b"] = colsum(dqkv)
    dtgt = dgrad(dqkv, p["s_in_w"], out=dz1, accumulate=True)
    return dtgt, dmem, grads


# ------------------------------------------------------------ functions

class _EncoderLayerTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key_mask, masks, num_heads, *params):
        p = ship_params(dict(zip(ENC_KEYS, params)), x.dtype)
        out, saved = encoder_launch(x, key_mask, p, num_heads, None, masks,
                                    save=True)
        ctx.saved = saved
        ctx.p = p
        ctx.num_heads = num_heads
        ctx.x_dtype = x.dtype
        ctx.param_dtypes = [t.dtype for t in params]
        fused_encoder_layer_train.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        dx, grads = encoder_backward(g, ctx.saved, ctx.p, ctx.num_heads)
        fused_encoder_layer_train.bwd_launches += 1
        del ctx.saved, ctx.p
        b, l = g.shape[:2]
        return (dx.reshape(b, l, -1).to(ctx.x_dtype), None, None, None,
                *(grads[k].to(dt) for k, dt in zip(ENC_KEYS,
                                                    ctx.param_dtypes)))


class _DecoderLayerTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tgt, memory, masks, num_heads, *params):
        p = ship_params(dict(zip(DEC_KEYS, params)), memory.dtype)
        out, saved = decoder_launch(tgt, memory, p, num_heads, None, masks,
                                    save=True)
        ctx.saved = saved
        ctx.p = p
        ctx.num_heads = num_heads
        ctx.dtypes = (tgt.dtype, memory.dtype)
        ctx.param_dtypes = [t.dtype for t in params]
        fused_decoder_layer_train.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        dtgt, dmem, grads = decoder_backward(g, ctx.saved, ctx.p,
                                             ctx.num_heads)
        fused_decoder_layer_train.bwd_launches += 1
        b, l = ctx.saved["pc"].shape[0], ctx.saved["pc"].shape[3]
        del ctx.saved, ctx.p
        return (dtgt.reshape(g.shape).to(ctx.dtypes[0]),
                dmem.reshape(b, l, -1).to(ctx.dtypes[1]), None, None,
                *(grads[k].to(dt) for k, dt in zip(DEC_KEYS,
                                                    ctx.param_dtypes)))


def fused_encoder_layer_train(x, key_mask, masks: Optional[dict], params,
                              num_heads: int = 8):
    """One post-LN encoder layer with live dropout, differentiable.

    ``x [B, L, D]`` at the model dtype; ``key_mask [B, L]`` float (added
    to the key logits); ``masks`` None or the keep masks ``attn
    [B, H, L, L]``, ``post_attn [B, L, D]``, ``ffn [B, L, F]``,
    ``post_ffn [B, L, D]`` (values ``{0, 1/(1-p)}``, used at the model
    dtype); ``params`` keyed by :data:`ENC_KEYS`, f32
    masters (or any dtype; gradients come back at each one's dtype)."""
    if not x.is_cuda:
        return fused_encoder_layer_train_plain(x, key_mask, masks, params,
                                               num_heads)
    return _EncoderLayerTrain.apply(
        x, key_mask, masks_at(masks, x.dtype), num_heads,
        *(params[k] for k in ENC_KEYS))


fused_encoder_layer_train.launches = 0
fused_encoder_layer_train.bwd_launches = 0


def fused_decoder_layer_train(tgt, memory, masks: Optional[dict], params,
                              num_heads: int = 8):
    """One post-LN decoder layer with live dropout, differentiable:
    ``tgt [B, T, D]``, ``memory [B, L, D]``, ``masks`` None or the keep
    masks ``self_attn [B, H, T, T]``, ``post_sa``, ``cross_attn
    [B, H, T, L]``, ``post_ca``, ``ffn``, ``post_ffn`` (``[B, T, ·]``);
    ``params`` keyed by :data:`DEC_KEYS`.
    Gradients reach ``tgt``, ``memory`` and every parameter."""
    if not memory.is_cuda:
        return fused_decoder_layer_train_plain(tgt, memory, masks, params,
                                               num_heads)
    return _DecoderLayerTrain.apply(
        tgt, memory, masks_at(masks, memory.dtype), num_heads,
        *(params[k] for k in DEC_KEYS))


fused_decoder_layer_train.launches = 0
fused_decoder_layer_train.bwd_launches = 0


# ------------------------------------------------------------ FLOP models

def _mha_train_flops(rq, rk, lq, lk, b, d, heads, masked):
    """Forward and backward of one attention block (projections, scores,
    softmax and P.V) without the TPU's packing terms."""
    fwd = 2.0 * rq * d * d + 2.0 * rk * d * 2 * d + (rq + 2.0 * rk) * d
    fwd += 4.0 * b * lq * lk * d + 7.0 * b * heads * lq * lk
    fwd += 2.0 * rq * d * d + rq * d
    bwd = 2 * (2.0 * rq * d * d) + rq * d             # out proj dgrad, wgrad
    bwd += 8.0 * b * lq * lk * d + 6.0 * b * heads * lq * lk  # dV dP dQ dK
    bwd += 2 * (2.0 * rq * d * d + 2.0 * rk * d * 2 * d)      # in proj
    bwd += (rq + 2.0 * rk) * d                        # bias gradients
    if masked:
        fwd += b * heads * lq * lk
        bwd += 2.0 * b * heads * lq * lk
    return fwd + bwd


def _ffn_ln_train_flops(r, d, f, masked):
    fl = 3 * (2.0 * r * d * f) * 2 + 4.0 * r * f + 2.0 * r * d  # fwd + bwd
    fl += 2 * (8.0 * r * d) + 2 * (10.0 * r * d)                # 2 LN fwd+bwd
    if masked:
        fl += 2 * (2.0 * r * d + 2.0 * r * f)
    return fl


def encoder_layer_train_flops(b: int, l: int, d: int = 512, f: int = 2048,
                              heads: int = 8, masked: bool = True) -> float:
    """FLOPs of one encoder layer's forward and backward for ``b``
    questions of ``l`` tokens (the port's model of
    ``text_train.encoder_layer_train_{fwd,bwd}_flops`` without the
    backward's recompute, which the port does not do, and without the
    packing terms)."""
    r = b * l
    return (_mha_train_flops(r, r, l, l, b, d, heads, masked)
            + _ffn_ln_train_flops(r, d, f, masked))


def decoder_layer_train_flops(b: int, t: int, l: int, d: int = 512,
                              f: int = 2048, heads: int = 8,
                              masked: bool = True) -> float:
    rt, rm = b * t, b * l
    fl = _mha_train_flops(rt, rt, t, t, b, d, heads, masked)
    fl += _mha_train_flops(rt, rm, t, l, b, d, heads, masked)
    fl += 2 * (8.0 * rt * d) + 2 * (10.0 * rt * d)   # the third LN
    return fl + _ffn_ln_train_flops(rt, d, f, masked)
